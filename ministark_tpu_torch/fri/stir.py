"""STIR low-degree test (fast mode): shift-and-quotient FRI with
geometrically decreasing query counts.

Port of ``ministark_tpu/fri/stir.py``: the same protocol, transcript and
proof bytes (tests/test_torch_stir.py holds them to the JAX package's).
Construction after Arnon-Chiesa-Fenzi-Yogev 2024 ("STIR: Reed-Solomon
proximity testing with fewer queries"):

Per round, instead of FRI's fold-only step (which keeps the rate fixed and
so needs the full ~lambda/log(1/rho) queries at EVERY round), STIR
re-evaluates the k-fold of the current function on a domain only HALF the
size: the rate improves by 2/k per round, so round i needs only
~lambda/log2(1/rho_i) queries.

Round i (functions f_0..f_R, committed evaluations C_0..C_R):
  1. fold randomness r:   g_i = Fold_k(f_{i-1}, r)  (coefficient space,
     ops/poly.fold_factor);
  2. commit C_i = evals of g_i over L_i, a coset of size N_i = N_{i-1}/2
     (offsets chosen per round so L_i is disjoint from the quotient point
     set, asserted at schedule build);
  3. out-of-domain sample z_i, answer beta_i = g_i(z_i);
  4. stir queries: t_{i-1} row indices into C_{i-1}'s k-coset rows; the
     VERIFIER computes v_j = Fold_k(f_{i-1}, r)(y_j) itself from the opened
     rows (size-k inverse DFT);
  5. next function by quotient + degree correction:
       f_i = DegCor(Quotient(g_i, G_i), r_cor, d_i),
     G_i = {(z_i, beta_i)} U {(y_j, v_j)}; Quotient(g, G) = (g - Ans_G)/V_G
     with Ans_G the interpolation through G and V_G its vanishing
     polynomial (|G_i| synthetic divisions, ops/poly.synth_div_suffix);
     DegCor multiplies by sum_{l<=e} (r_cor x)^l (e + 1 shifted products).
Final: p = Fold_k(f_R, r_R) ships in the clear; t_R spot checks bind it to
C_R through the same quotient relation.

The prover's polynomials are (n, d) extension tensors on the prover's
device; every coset FFT is the port's NTT (ops/ntt.py, ``ntt_backend``),
every round's tree the index tree's SHA-256 kernels. The verifier is pure
host (hashlib and host field ops).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..commit.index_tree import IndexMerklePath, IndexMerkleTree
from ..ops.field import get_ops
from ..ops.poly import field_sum, fold_factor, mix_columns, powers, synth_div_suffix
from .batched import (
    BatchedFri,
    BatchedFriConfig,
    FastTranscript,
    _row_values,
    _scalar_bytes,
)


# --------------------------------------------------------------- config
@dataclass
class StirConfig:
    """``field`` is the (extension) field the polynomials live in."""

    field: object
    k: int = 4                 # per-round folding factor (>= 4: rate must improve)
    blowup: int = 2            # initial inverse rate
    security_bits: int = 32    # per-round query soundness target
    final_len: int = 32        # ship the final fold in the clear at this length
    arity: int = 4             # Merkle tree fan-in
    grinding_bits: int = 0     # PoW before each query sampling: buys
                               # grinding_bits of the target without queries

    def __post_init__(self):
        assert self.k in (4, 8, 16), "k must exceed the per-round domain shrink (2)"
        assert self.blowup >= 2 and self.blowup & (self.blowup - 1) == 0
        assert self.arity >= 2 and self.arity & (self.arity - 1) == 0
        assert self.final_len >= 1 and self.final_len & (self.final_len - 1) == 0
        assert self.security_bits >= 1
        assert 0 <= self.grinding_bits <= 32
        assert self.grinding_bits < self.security_bits


@dataclass
class StirResult:
    """Truthy verification result carrying the authenticated C_0 query rows
    for outer protocols (stark/fast.py) to impose their own row relations:
    per query, (index, vals) where vals[t][b] is polynomial b's value at
    coset point t of the queried row (same shape as BatchedFriResult)."""

    rows: List

    def __bool__(self) -> bool:
        return True


@dataclass
class StirProof:
    group_sizes: List[int]     # polynomials per C_0 commitment group
    n: int                     # per-polynomial coefficient length (d_0)
    group_roots: List[bytes]   # C_0: one coset-row tree per group
    round_roots: List[bytes]   # C_1 .. C_R
    betas: List                # R out-of-domain answers
    final_coeffs: List         # p = Fold_k(f_R, r_R), in the clear
    batch_openings: List[List[IndexMerklePath]]   # [query][group], idxs_0
    round_openings: List[List[IndexMerklePath]]   # [i-1][query]: C_i rows
    pow_nonces: List[bytes] = None                # per-query-phase grinding

    @property
    def b(self) -> int:
        return sum(self.group_sizes)

    def size_bytes(self, field) -> int:
        sc = 8 * field.extension_degree
        paths = [p for q in self.batch_openings for p in q]
        paths += [p for per_round in self.round_openings for p in per_round]
        return (
            32 * (len(self.group_roots) + len(self.round_roots))
            + sum(len(p.row) + sum(len(g) for g in p.groups) for p in paths)
            + sc * (len(self.betas) + len(self.final_coeffs))
        )


# ------------------------------------------------------------- host helpers
def _newton_interp(ext, pts):
    """Coefficients (low-to-high, len == len(pts)) of the unique polynomial
    through ``pts`` = [(x, y)] — Newton divided differences, O(m^2)."""
    m = len(pts)
    xs = [p[0] for p in pts]
    coef = [p[1] for p in pts]          # divided-difference table, in place
    for j in range(1, m):
        for i in range(m - 1, j - 1, -1):
            num = ext.sub(coef[i], coef[i - 1])
            den = ext.sub(xs[i], xs[i - j])
            coef[i] = ext.mul(num, ext.inv(den))
    # expand the Newton form sum_i coef[i] * prod_{l<i} (x - xs[l])
    out = [ext.zero()] * m
    basis = [ext.one()]                 # prod so far, low-to-high
    for i in range(m):
        for d, c in enumerate(basis):
            out[d] = ext.add(out[d], ext.mul(coef[i], c))
        if i + 1 < m:
            nxt = [ext.zero()] * (len(basis) + 1)
            negx = ext.neg(xs[i])
            for d, c in enumerate(basis):
                nxt[d] = ext.add(nxt[d], ext.mul(c, negx))
                nxt[d + 1] = ext.add(nxt[d + 1], c)
            basis = nxt
    return out


def _eval_poly(ext, coeffs, x):
    acc = ext.zero()
    for c in reversed(coeffs):
        acc = ext.add(ext.mul(acc, x), c)
    return acc


def _geom_eval(ext, r, x, e):
    """sum_{l=0}^{e} (r*x)^l."""
    rx = ext.mul(r, x)
    acc = ext.one()
    term = ext.one()
    for _ in range(e):
        term = ext.mul(term, rx)
        acc = ext.add(acc, term)
    return acc


# ------------------------------------------------------------- device ops
def eval_points(ke, coeffs, pts):
    """ONE polynomial (n, *elem) at m points (m, *elem) -> (m, *elem), in one
    batched pass: the powers of every point, one product, one sum
    (``_eval_points_jit``, a vmap of ``eval_many``)."""
    n = coeffs.shape[0]
    pw = powers(ke, pts, n)                                  # (m, n, *elem)
    return field_sum(ke, ke.mul(pw, coeffs.unsqueeze(0)), axis=1)


def quot_degcor(ke, coeffs, ans, roots, scales, rcor_pows):
    """f = DegCor(Quotient(g, G), r_cor) at fixed length d
    (``_quot_degcor_jit``): subtract Ans_G from the head, divide by each
    (x - root) with the suffix-scan synthetic division (re-padded to d after
    each), then multiply by sum_l (r_cor x)^l as |G| + 1 shifted products.

    coeffs (d, *elem); ans, roots, scales (m, *elem) with scales[j] =
    roots[j]^-1; rcor_pows (m + 1, *elem), the powers of r_cor."""
    d = coeffs.shape[0]
    m = roots.shape[0]
    head = ke.sub(coeffs[: ans.shape[0]], ans)
    cur = torch.cat([head, coeffs[ans.shape[0]:]], 0)
    zpad = torch.zeros_like(cur[:1])
    for j in range(m):
        cur = torch.cat([synth_div_suffix(ke, cur, roots[j], scales[j]), zpad], 0)
    out = torch.zeros_like(cur)
    for l in range(rcor_pows.shape[0]):
        # the term is cur shifted up by l with zero fill: out[l:] only
        term = ke.mul(cur[: d - l], rcor_pows[l].expand_as(cur[: d - l]))
        out = torch.cat([out[:l], ke.add(out[l:], term)], 0)
    return out


class CosetRowLdt:
    """What STIR and WHIR share: the fast mode's commitment helpers (the
    component NTT's coset form, coset rows, the index tree), the commitment
    of a group over L_0, the binding LDE and the transcript. A subclass
    sets ``LABEL`` and ``_schedule``."""

    def __init__(self, config, ntt_backend: str = "radix2", mesh=None):
        """``ntt_backend``: the NTT kernels of every coset FFT (ops/ntt.py);
        not part of the config or the transcript, it changes no proof byte.
        ``mesh``: a ``parallel.Mesh``, handed to the ``BatchedFri`` whose
        coset FFTs and trees then shard over it."""
        self.cfg = config
        self.ext = config.field
        self.ke = get_ops(self.ext)
        self._bf = BatchedFri(
            BatchedFriConfig(
                config.field, blowup=config.blowup, queries=1,
                arity=config.arity, fold_factor=config.k, final_len=1,
            ),
            ntt_backend=ntt_backend, mesh=mesh,
        )
        self.prime = self._bf._ntt_base

    def _transcript(self, b: int, n: int) -> FastTranscript:
        tr = FastTranscript(self.LABEL)
        cfg = self.cfg
        tr.absorb(b"%d/%d/%d/%d/%d/%d/%d/%d" % (
            b, n, cfg.k, cfg.blowup, cfg.security_bits, cfg.final_len,
            cfg.arity, cfg.grinding_bits,
        ))
        return tr

    def _commit(self, coeffs_2d, N: int, offset: int) -> IndexMerkleTree:
        """coeffs (B, m, d) -> coset-row index tree over offset*<w_N>."""
        ev = self._bf._fft_batched(coeffs_2d, N, offset)
        return self._bf._tree(self._bf._coset_rows(ev, self.cfg.k))

    def _ood_ok(self, z) -> bool:
        """z must lie outside the prime field (domains and quotient points
        are prime-field cosets); negligible failure probability."""
        comps = self.ext.base_coeffs(z)
        return any(int(c) != 0 for c in comps[1:])

    @staticmethod
    def _dedupe(idxs: List[int]) -> List[int]:
        return sorted(set(idxs))

    def commit(self, polys) -> IndexMerkleTree:
        """Commitment of one polynomial group over L_0 (coset-row tree).
        The CALLER absorbs the root into its transcript at the protocol
        point where the group is bound (stark/fast.py)."""
        n = int(polys.shape[1])
        d, N, off, t, R = self._schedule(n)
        return self._commit(polys, N[0], off[0])

    def binding_lde(self, ext_coeffs):
        """(N_0, k, evals over L_0) for outer-protocol row binding — same
        contract as BatchedFri.binding_lde, over THIS backend's coset."""
        n = int(ext_coeffs.shape[1])
        d, N, off, t, R = self._schedule(n)
        return N[0], self.cfg.k, self._bf._fft_batched(ext_coeffs, N[0], off[0])

    def _start(self, polys, transcript, groups, trees):
        """(group_sizes, n, schedule, trees, transcript, f_0 coefficients):
        the start both provers share. Standalone (``polys``) commits and
        absorbs the one group on a fresh transcript; an outer protocol
        passes groups it committed and absorbed itself."""
        ext, ke = self.ext, self.ke
        if groups is None:
            assert polys is not None
            groups = [polys]
        n = int(groups[0].shape[1])
        group_sizes = [int(g.shape[0]) for g in groups]
        b = sum(group_sizes)
        assert n & (n - 1) == 0
        assert all(int(g.shape[1]) == n for g in groups)
        sched = self._schedule(n)
        if trees is None:
            assert transcript is None and len(groups) == 1
            tr = self._transcript(b, n)
            trees = [self.commit(groups[0])]
            tr.absorb(trees[0].root())
        else:
            assert transcript is not None and len(trees) == len(groups)
            tr = transcript
        dev = groups[0].device
        rho = tr.challenge_scalar(ext)
        weights = ke.pack([ext.pow(rho, j) for j in range(b)], dev)
        allp = groups[0] if len(groups) == 1 else torch.cat(groups, 0)
        cur = mix_columns(ke, allp, weights)          # f_0 coeffs (n, d)
        return group_sizes, n, sched, trees, tr, cur

    @staticmethod
    def _openings(trees, round_trees, all_idxs):
        """(batch_openings [query][group], round_openings [i-1][query])."""
        per_group = [tree.open_many(all_idxs[0]) for tree in trees]
        batch_openings = [
            [per_group[g][qi] for g in range(len(trees))]
            for qi in range(len(all_idxs[0]))
        ]
        round_openings = [
            round_trees[i - 1].open_many(all_idxs[i])
            for i in range(1, len(round_trees) + 1)
        ]
        return batch_openings, round_openings


# round-schedule cache keyed by every parameter _schedule reads; holds only
# plain int tuples (never protocol instances)
_SCHEDULE_CACHE: dict = {}


# --------------------------------------------------------------- protocol
class Stir(CosetRowLdt):
    """``Stir(StirConfig(...), ntt_backend="radix2", mesh=None)``."""

    LABEL = b"stir"

    # -------------------------------------------------------- schedule
    def _schedule(self, n: int):
        """(d, N, off, t, R): degrees d_i, domain sizes N_i, coset offsets
        off_i, per-function query counts t_i, for rounds i = 0..R.

        Cached module-level by the parameters it reads (an lru_cache on the
        method would pin every Stir instance for process lifetime)."""
        cfg = self.cfg
        key = (self.prime.p, self.prime.generator, cfg.k, cfg.blowup,
               cfg.security_bits, cfg.grinding_bits, cfg.final_len, n)
        cached = _SCHEDULE_CACHE.get(key)
        if cached is not None:
            return cached
        k = cfg.k
        p = self.prime.p
        g = self.prime.generator
        d = [n]
        N = [cfg.blowup * n]
        while d[-1] // k > cfg.final_len:
            d.append(d[-1] // k)
            N.append(N[-1] // 2)
        R = len(d) - 1
        off = [pow(g, i + 1, p) for i in range(R + 1)]
        for i in range(1, R + 1):
            # L_i must avoid the round-i quotient points L_{i-1}^k: cosets
            # a*H_i and b*H' (H' subset H_i) intersect iff (a/b)^{N_i} == 1
            c = off[i] * pow(pow(off[i - 1], k, p), p - 2, p) % p
            assert pow(c, N[i], p) != 1, "coset offsets collide — pick new ones"
        t = []
        lam = cfg.security_bits - cfg.grinding_bits
        for i in range(R + 1):
            rate_log = (N[i] // d[i]).bit_length() - 1
            t.append(min(max(1, -(-lam // rate_log)), N[i] // k))
        assert d[R] >= k and N[R] >= k
        for i in range(1, R + 1):
            assert t[i - 1] + 1 < d[i], (
                f"round {i}: |G|={t[i-1]+1} must stay below degree {d[i]}"
            )
        _SCHEDULE_CACHE[key] = (d, N, off, t, R)
        return d, N, off, t, R

    # ----------------------------------------------------------- prove
    def prove(self, polys=None, transcript: FastTranscript = None,
              groups=None, trees=None) -> StirProof:
        """Standalone: ``prove(polys)`` — one group, committed and absorbed
        internally on a fresh transcript.

        Multi-group (outer protocols): ``prove(groups=[...], trees=[...],
        transcript=tr)`` — the caller committed each group via ``commit``
        and absorbed every root BEFORE any challenge; STIR continues from
        rho (same contract as BatchedFri.prove)."""
        cfg = self.cfg
        ext, ke = self.ext, self.ke
        k = cfg.k
        group_sizes, n, (d, N, off, t, R), trees, tr, cur = self._start(
            polys, transcript, groups, trees)
        dev = cur.device

        round_trees: List[IndexMerkleTree] = []
        betas: List = []
        all_idxs: List[List[int]] = []
        pow_nonces: List[bytes] = []
        for i in range(1, R + 1):
            r = tr.challenge_scalar(ext)
            cur = fold_factor(ke, cur, ke.pack_scalar(r, dev), k)
            tree = self._commit(cur[None], N[i], off[i])
            round_trees.append(tree)
            tr.absorb(tree.root())

            z = tr.challenge_scalar(ext)
            assert self._ood_ok(z), "out-of-domain sample hit the prime field"
            beta = ke.unpack(eval_points(ke, cur, ke.pack([z], dev)))[0]
            betas.append(beta)
            tr.absorb(_scalar_bytes(ext, beta))

            pow_nonces.append(tr.grind(cfg.grinding_bits))
            idxs = self._dedupe(tr.challenge_indices(t[i - 1], N[i - 1] // k))
            all_idxs.append(idxs)
            r_cor = tr.challenge_scalar(ext)

            # quotient point set G_i: the honest g_i(y_j) equal the
            # verifier's fold values by construction
            w_prev = self.prime.get_root_of_unity(N[i - 1])
            ys = [
                ext.from_int(
                    pow(off[i - 1] * pow(int(w_prev), j, self.prime.p)
                        % self.prime.p, k, self.prime.p)
                )
                for j in idxs
            ]
            vs = ke.unpack(eval_points(ke, cur, ke.pack(ys, dev)))
            G = [(z, beta)] + list(zip(ys, vs))
            cur = self._apply_quot_degcor(cur, G, r_cor)

        r_fin = tr.challenge_scalar(ext)
        cur = fold_factor(ke, cur, ke.pack_scalar(r_fin, dev), k)
        final_coeffs = ke.unpack(cur[: d[R] // k])
        tr.absorb(b"".join(_scalar_bytes(ext, s) for s in final_coeffs))
        pow_nonces.append(tr.grind(cfg.grinding_bits))
        idxs_fin = self._dedupe(tr.challenge_indices(t[R], N[R] // k))
        all_idxs.append(idxs_fin)

        batch_openings, round_openings = self._openings(trees, round_trees,
                                                        all_idxs)
        return StirProof(
            group_sizes=group_sizes, n=n,
            group_roots=[tree.root() for tree in trees],
            round_roots=[tree.root() for tree in round_trees],
            betas=betas, final_coeffs=final_coeffs,
            batch_openings=batch_openings, round_openings=round_openings,
            pow_nonces=pow_nonces,
        )

    def _apply_quot_degcor(self, cur, G, r_cor):
        """cur (d_i, d) g_i coeffs -> f_i coeffs, on cur's device."""
        ext, ke = self.ext, self.ke
        dev = cur.device
        m = len(G)
        pts = [x for (x, _) in G]
        return quot_degcor(
            ke, cur,
            ke.pack(_newton_interp(ext, G), dev),
            ke.pack(pts, dev),
            ke.pack([ext.inv(x) for x in pts], dev),
            ke.pack([ext.pow(r_cor, l) for l in range(m + 1)], dev),
        )

    # ----------------------------------------------------------- verify
    def verify(self, proof: StirProof,
               transcript: FastTranscript = None) -> "StirResult":
        cfg = self.cfg
        ext = self.ext
        k = cfg.k
        b, n = proof.b, proof.n
        d, N, off, t, R = self._schedule(n)
        assert len(proof.round_roots) == R
        assert len(proof.betas) == R
        assert len(proof.round_openings) == R
        assert len(proof.final_coeffs) <= d[R] // k
        pow_nonces = proof.pow_nonces or [b""] * (R + 1)
        assert len(pow_nonces) == R + 1

        if transcript is None:
            assert len(proof.group_sizes) == 1
            tr = self._transcript(b, n)
            tr.absorb(proof.group_roots[0])
        else:
            # outer protocols absorb every group root themselves BEFORE rho
            tr = transcript
        rho = tr.challenge_scalar(ext)
        rho_pows = [ext.pow(rho, j) for j in range(b)]

        p_mod = self.prime.p
        w = [self.prime.get_root_of_unity(Ni) for Ni in N]
        inv_k = ext.inv(ext.from_int(k))
        # k-th root of unity inside each domain + inverse powers
        mu_inv = []
        for i in range(R + 1):
            mu = pow(int(w[i]), N[i] // k, p_mod)
            mui = ext.inv(ext.from_int(mu))
            mu_inv.append([ext.pow(mui, tt) for tt in range(k)])

        def row_xs(i: int, idx: int):
            """The k coset x-values of row ``idx`` of C_i."""
            x0 = off[i] * pow(int(w[i]), idx, p_mod) % p_mod
            mu = pow(int(w[i]), N[i] // k, p_mod)
            return [ext.from_int(x0 * pow(mu, tt, p_mod) % p_mod)
                    for tt in range(k)]

        def fold_from_row(i: int, idx: int, fvals, r):
            """Fold_k(f_i, r)(y) from f_i's values on row idx's coset:
            f_j(y) = (1/k) x0^{-j} sum_t mu^{-jt} fvals[t]."""
            x0 = ext.from_int(off[i] * pow(int(w[i]), idx, p_mod) % p_mod)
            x_inv = ext.inv(x0)
            acc = ext.zero()
            r_pow = ext.one()
            xj = ext.one()
            for j in range(k):
                s = ext.zero()
                for tt in range(k):
                    s = ext.add(s, ext.mul(mu_inv[i][(tt * j) % k], fvals[tt]))
                fj = ext.mul(ext.mul(s, inv_k), xj)
                acc = ext.add(acc, ext.mul(r_pow, fj))
                r_pow = ext.mul(r_pow, r)
                xj = ext.mul(xj, x_inv)
            return acc

        # params[i] lets us evaluate f_i at a point of L_i given C_i's value:
        # None for i=0 (f_0 = rho-mix of the committed batch), else
        # (ans_coeffs, quotient points, r_cor, e)
        params: List = [None]

        def f_value(i: int, x, committed):
            if i == 0:
                acc = ext.zero()
                for bj in range(b):
                    acc = ext.add(acc, ext.mul(rho_pows[bj], committed[bj]))
                return acc
            ans, pts, r_cor, e = params[i]
            v = ext.one()
            for ptx in pts:
                v = ext.mul(v, ext.sub(x, ptx))
            q = ext.mul(ext.sub(committed, _eval_poly(ext, ans, x)),
                        ext.inv(v))
            return ext.mul(q, _geom_eval(ext, r_cor, x, e))

        result_rows: List = []      # authenticated C_0 rows for outer checks

        def open_rows(i: int, idxs):
            """Verify paths of C_i's openings at ``idxs``; decode values.
            rows[qi][t] is a list of b values for i == 0, [value] else."""
            rows = []
            if i == 0:
                for qi, idx in enumerate(idxs):
                    per_t = [[] for _ in range(k)]
                    for gi, gsize in enumerate(proof.group_sizes):
                        path = proof.batch_openings[qi][gi]
                        assert IndexMerkleTree.verify_path(
                            proof.group_roots[gi], N[0] // k, cfg.arity,
                            idx, path,
                        ), f"batch path group {gi}"
                        flat = _row_values(ext, path.row, gsize * k)
                        for tt in range(k):
                            per_t[tt].extend(
                                flat[bj * k + tt] for bj in range(gsize)
                            )
                    rows.append(per_t)
                    result_rows.append((idx, per_t))
                return rows
            for qi, idx in enumerate(idxs):
                path = proof.round_openings[i - 1][qi]
                assert IndexMerkleTree.verify_path(
                    proof.round_roots[i - 1], N[i] // k, cfg.arity, idx, path
                ), f"round {i} path"
                flat = _row_values(ext, path.row, k)
                rows.append([[v] for v in flat])
            return rows

        for i in range(1, R + 1):
            r = tr.challenge_scalar(ext)
            tr.absorb(proof.round_roots[i - 1])
            z = tr.challenge_scalar(ext)
            assert self._ood_ok(z), "out-of-domain sample hit the prime field"
            beta = proof.betas[i - 1]
            tr.absorb(_scalar_bytes(ext, beta))
            tr.check_grind(cfg.grinding_bits, pow_nonces[i - 1])
            idxs = self._dedupe(tr.challenge_indices(t[i - 1], N[i - 1] // k))
            if i - 1 == 0:
                assert len(proof.batch_openings) == len(idxs)
            else:
                assert len(proof.round_openings[i - 2]) == len(idxs)
            r_cor = tr.challenge_scalar(ext)

            rows = open_rows(i - 1, idxs)
            G = [(z, beta)]
            for qi, idx in enumerate(idxs):
                xs = row_xs(i - 1, idx)
                fvals = [
                    f_value(i - 1, xs[tt],
                            rows[qi][tt] if i - 1 == 0 else rows[qi][tt][0])
                    for tt in range(k)
                ]
                y = ext.from_int(
                    pow(off[i - 1] * pow(int(w[i - 1]), idx, p_mod) % p_mod,
                        k, p_mod)
                )
                G.append((y, fold_from_row(i - 1, idx, fvals, r)))
            pts = [x for (x, _) in G]
            assert len(set(pts)) == len(pts), "degenerate quotient point set"
            params.append((_newton_interp(ext, G), pts, r_cor, len(G)))

        r_fin = tr.challenge_scalar(ext)
        tr.absorb(b"".join(_scalar_bytes(ext, s) for s in proof.final_coeffs))
        tr.check_grind(cfg.grinding_bits, pow_nonces[R])
        idxs_fin = self._dedupe(tr.challenge_indices(t[R], N[R] // k))
        if R == 0:
            assert len(proof.batch_openings) == len(idxs_fin)
        else:
            assert len(proof.round_openings[R - 1]) == len(idxs_fin)

        rows = open_rows(R, idxs_fin)
        for qi, idx in enumerate(idxs_fin):
            xs = row_xs(R, idx)
            fvals = [f_value(R, xs[tt], rows[qi][tt][0] if R else rows[qi][tt])
                     for tt in range(k)]
            expected = fold_from_row(R, idx, fvals, r_fin)
            y = ext.from_int(
                pow(off[R] * pow(int(w[R]), idx, p_mod) % p_mod, k, p_mod)
            )
            assert _eval_poly(ext, proof.final_coeffs, y) == expected, (
                "final polynomial mismatch"
            )
        return StirResult(rows=result_rows)
