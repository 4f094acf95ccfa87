"""WHIR low-degree test (fast mode): sumcheck-constrained folding where
the folding randomness IS the sumcheck randomness.

Port of ``ministark_tpu/fri/whir.py``: the same protocol, transcript and
proof bytes (tests/test_torch_whir.py holds them to the JAX package's).
Construction after Arnon-Chiesa-Fenzi-Yogev 2024 ("WHIR: Reed-Solomon
proximity testing with super-fast verification"):

A degree-<2^m univariate f corresponds to an m-variate MULTILINEAR f-hat via
x -> (x, x^2, x^4, ..., x^(2^(m-1))); the even/odd fold with alpha
(coefficient space: c'_i = c_{2i} + alpha*c_{2i+1}) is exactly "fix the
first multilinear variable to alpha". WHIR maintains a CONSTRAINED claim

    sum_c lambda_c * f-hat(q_c, q_c^2, q_c^4, ...) = sigma

over a growing list of (multiplier, scalar point) constraints — every
constraint point here is GEOMETRIC (powers of one scalar), so each
multilinear evaluation is a plain univariate evaluation and each sumcheck
message needs only two half-array evaluations per constraint
(``sumcheck_evals``, one batched pass over every constraint).

Iteration i (f_0 = rho-mix of the committed batch; one initial OOD
constraint binds it):
  1. kappa = log2(k) SUMCHECK rounds: prover ships the quadratic
       h_l(X) = sum_c lambda_c * E_c * eq(q_c^(2^(l-1)), X)
                          * (e0_c + X*e1_c),
     (e0/e1 = even/odd-half evaluations at q_c^(2^l)); verifier checks
     h_l(0)+h_l(1) == sigma, replies alpha_l, sets sigma = h_l(alpha_l);
     prover folds cur <- fold_even_odd(cur, alpha_l). After kappa rounds
     g_i = Fold_k(f_{i-1}, alphas).
  2. commit g_i over L_i = L_{i-1}^(2) (the SQUARED domain: offset
     off^2, size N/2);
  3. out-of-domain sample z_i, answer beta_i = g-hat(z_i vector);
  4. t_{i-1} shift queries: row indices into C_{i-1}'s k-coset fibers;
     the VERIFIER computes v_j = Fold_k(f_{i-1}, alphas)(y_j) itself from
     the opened fiber by kappa pairwise (f(x)+f(-x))/2, (f(x)-f(-x))/2x
     levels (``_fold_fiber``);
  5. combination randomness gamma folds everything into the next claim:
       sigma' = sigma + gamma*beta_i + sum_j gamma^(1+j) v_j,
     constraints' <- {(lambda_c*E_c, q_c^k)} U {(gamma, z_i)}
                     U {(gamma^(1+j), y_j)}.
Final: kappa more sumcheck rounds, then p = Fold_k(f_R, alphas) ships in
the clear; the verifier checks the residual claim
sum_c lambda_c*E_c*p(q_c^k) == sigma directly and binds p to C_R by t_R
fiber spot-checks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..commit.index_tree import IndexMerklePath, IndexMerkleTree
from ..ops.poly import field_sum, fold_even_odd, powers
from .batched import FastTranscript, _row_values, _scalar_bytes
from .stir import CosetRowLdt, StirResult, eval_points


# --------------------------------------------------------------- config
@dataclass
class WhirConfig:
    """``field`` is the (extension) field the polynomials live in.

    ``k`` is the per-iteration fold ARITY (2^kappa with kappa sumcheck
    rounds per iteration); must be >= 4 so the rate improves (domain
    halves, degree divides by k)."""

    field: object
    k: int = 4                 # fold arity per iteration (4/8/16)
    blowup: int = 2            # initial inverse rate
    security_bits: int = 32    # per-round query soundness target
    final_len: int = 32        # ship the final fold in the clear at this length
    arity: int = 4             # Merkle tree fan-in
    grinding_bits: int = 0     # PoW before each query sampling

    def __post_init__(self):
        assert self.k in (4, 8, 16), "k must exceed the per-round domain shrink (2)"
        assert self.blowup >= 2 and self.blowup & (self.blowup - 1) == 0
        assert self.arity >= 2 and self.arity & (self.arity - 1) == 0
        assert self.final_len >= 1 and self.final_len & (self.final_len - 1) == 0
        assert self.security_bits >= 1
        assert 0 <= self.grinding_bits <= 32
        assert self.grinding_bits < self.security_bits

    @property
    def kappa(self) -> int:
        return self.k.bit_length() - 1


@dataclass
class WhirProof:
    group_sizes: List[int]     # polynomials per C_0 commitment group
    n: int                     # per-polynomial coefficient length (d_0)
    group_roots: List[bytes]   # C_0: one coset-row tree per group
    round_roots: List[bytes]   # C_1 .. C_R
    betas: List                # R+1 OOD answers (initial + per iteration)
    sumcheck: List[List[List]]  # [iter 0..R][round 0..kappa-1][3 coeffs]
    final_coeffs: List         # p = Fold_k(f_R, alphas_fin), in the clear
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
        n_sum = sum(3 * len(it) for it in self.sumcheck)
        return (
            32 * (len(self.group_roots) + len(self.round_roots))
            + sum(len(p.row) + sum(len(g) for g in p.groups) for p in paths)
            + sc * (len(self.betas) + len(self.final_coeffs) + n_sum)
        )


# ------------------------------------------------------------- device ops
def sumcheck_evals(ke, cur, pts):
    """Even/odd-half evaluations for one sumcheck round
    (``_sumcheck_evals_jit``), every point in one batched pass.

    cur: (L, *elem) coefficients, L even; pts: (m, *elem) packed points
    (q_c^(2^l) per constraint). Returns (m, 2, *elem): for each point,
    [even-half eval, odd-half eval]."""
    both = torch.stack([cur[0::2], cur[1::2]])               # (2, L/2, *elem)
    pw = powers(ke, pts, both.shape[1])                      # (m, L/2, *elem)
    return field_sum(ke, ke.mul(pw.unsqueeze(1), both.unsqueeze(0)), axis=2)


# iteration-schedule cache keyed by every parameter _schedule reads; holds
# only plain int tuples (never protocol instances)
_SCHEDULE_CACHE: dict = {}


# --------------------------------------------------------------- protocol
class Whir(CosetRowLdt):
    """``Whir(WhirConfig(...), ntt_backend="radix2", mesh=None)``."""

    LABEL = b"whir"

    # -------------------------------------------------------- schedule
    def _schedule(self, n: int):
        """(d, N, off, t, R): degrees d_i, domain sizes N_i, coset offsets
        off_i, per-function query counts t_i, for iterations i = 0..R.
        L_i is the SQUARED previous domain (off_i = off_{i-1}^2) — WHIR
        needs no disjointness between rounds (no quotienting).

        Cached module-level by the parameters it reads (an lru_cache on the
        method would pin every Whir instance for process lifetime)."""
        cfg = self.cfg
        key = (self.prime.p, self.prime.generator, cfg.k, cfg.blowup,
               cfg.security_bits, cfg.grinding_bits, cfg.final_len, n)
        cached = _SCHEDULE_CACHE.get(key)
        if cached is not None:
            return cached
        k = cfg.k
        p = self.prime.p
        g = self.prime.generator
        assert n >= k, f"need at least {k} coefficients"
        d = [n]
        N = [cfg.blowup * n]
        off = [g % p]
        while d[-1] // k > cfg.final_len:
            d.append(d[-1] // k)
            N.append(N[-1] // 2)
            off.append(off[-1] * off[-1] % p)
        R = len(d) - 1
        t = []
        lam = cfg.security_bits - cfg.grinding_bits
        for i in range(R + 1):
            rate_log = (N[i] // d[i]).bit_length() - 1
            t.append(min(max(1, -(-lam // rate_log)), N[i] // k))
        assert d[R] >= k and N[R] >= k
        _SCHEDULE_CACHE[key] = (d, N, off, t, R)
        return d, N, off, t, R

    # ------------------------------------------------- sumcheck (shared)
    def _sumcheck_round_poly(self, constraints, evals):
        """Expand h_l(X) = sum_c A_c * eq(q_c, X) * (e0_c + X*e1_c) into
        quadratic coefficients [h0, h1, h2].

        constraints: [(lam, E, q_pows)] with q_pows = (q^(2^(l-1)), ...)
        current-component-first; evals: [(e0, e1)] per constraint."""
        ext = self.ext
        h = [ext.zero(), ext.zero(), ext.zero()]
        for (lam, E, q), (e0, e1) in zip(constraints, evals):
            A = ext.mul(lam, E)
            lin0 = ext.sub(ext.one(), q)           # eq(q, X) = (1-q) + (2q-1)X
            lin1 = ext.sub(q, lin0)
            h[0] = ext.add(h[0], ext.mul(A, ext.mul(lin0, e0)))
            h[1] = ext.add(h[1], ext.mul(A, ext.add(
                ext.mul(lin0, e1), ext.mul(lin1, e0))))
            h[2] = ext.add(h[2], ext.mul(A, ext.mul(lin1, e1)))
        return h

    @staticmethod
    def _poly2_eval(ext, h, x):
        return ext.add(h[0], ext.mul(x, ext.add(h[1], ext.mul(x, h[2]))))

    # ----------------------------------------------------------- prove
    def _prover_sumcheck_block(self, cur, state, tr):
        """Run kappa sumcheck rounds: ship h_l, draw alpha_l, fold.

        state: dict with 'sigma' and 'constraints' [(lam, E, q_scalar)]
        where q_scalar is the CURRENT first component (q^(2^0) relative to
        cur's variables). Returns (folded cur, alphas, [h coeff triples]);
        mutates state: sigma updated, constraints' E accumulated and
        q advanced by 2^kappa squarings."""
        ext, ke = self.ext, self.ke
        dev = cur.device
        cons = state["constraints"]
        qs = [q for (_, _, q) in cons]          # current components
        Es = [E for (_, E, _) in cons]
        lams = [lam for (lam, _, _) in cons]
        alphas = []
        triples = []
        for _l in range(self.cfg.kappa):
            q_next = [ext.mul(q, q) for q in qs]   # suffix base = q^2
            flat = ke.unpack(sumcheck_evals(ke, cur, ke.pack(q_next, dev)))
            evals = [(flat[2 * ci], flat[2 * ci + 1]) for ci in range(len(cons))]
            h = self._sumcheck_round_poly(
                [(lams[ci], Es[ci], qs[ci]) for ci in range(len(cons))],
                evals,
            )
            tr.absorb(b"".join(_scalar_bytes(ext, c) for c in h))
            alpha = tr.challenge_scalar(ext)
            alphas.append(alpha)
            triples.append(h)
            state["sigma"] = self._poly2_eval(ext, h, alpha)
            # E_c *= eq(q_c, alpha); advance to the next component
            for ci in range(len(cons)):
                q = qs[ci]
                eq_l = ext.add(
                    ext.mul(ext.sub(ext.one(), q), ext.sub(ext.one(), alpha)),
                    ext.mul(q, alpha),
                )
                Es[ci] = ext.mul(Es[ci], eq_l)
            qs = q_next
            cur = fold_even_odd(ke, cur, ke.pack_scalar(alpha, dev))
        state["constraints"] = [
            (lams[ci], Es[ci], qs[ci]) for ci in range(len(cons))
        ]
        return cur, alphas, triples

    def prove(self, polys=None, transcript: FastTranscript = None,
              groups=None, trees=None) -> WhirProof:
        """Standalone: ``prove(polys)`` — one group, committed and absorbed
        internally on a fresh transcript.

        Multi-group (outer protocols): ``prove(groups=[...], trees=[...],
        transcript=tr)`` — the caller committed each group via ``commit``
        and absorbed every root BEFORE any challenge (same contract as
        BatchedFri.prove / Stir.prove)."""
        cfg = self.cfg
        ext, ke = self.ext, self.ke
        k = cfg.k
        group_sizes, n, (d, N, off, t, R), trees, tr, cur = self._start(
            polys, transcript, groups, trees)
        dev = cur.device

        # initial out-of-domain constraint binds f_0 before any folding
        z0 = tr.challenge_scalar(ext)
        assert self._ood_ok(z0), "out-of-domain sample hit the prime field"
        beta0 = ke.unpack(eval_points(ke, cur, ke.pack([z0], dev)))[0]
        tr.absorb(_scalar_bytes(ext, beta0))
        betas = [beta0]
        state = {
            "sigma": beta0,
            "constraints": [(ext.one(), ext.one(), z0)],
        }

        round_trees: List[IndexMerkleTree] = []
        sumcheck: List[List[List]] = []
        all_idxs: List[List[int]] = []
        pow_nonces: List[bytes] = []
        p_mod = self.prime.p
        for i in range(1, R + 1):
            cur, _alphas, triples = self._prover_sumcheck_block(cur, state, tr)
            sumcheck.append(triples)

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
            gamma = tr.challenge_scalar(ext)

            # shift-query points y_j = x0_j^k in the squared-out domain
            w_prev = self.prime.get_root_of_unity(N[i - 1])
            ys = [
                ext.from_int(
                    pow(off[i - 1] * pow(int(w_prev), j, p_mod) % p_mod,
                        k, p_mod)
                )
                for j in idxs
            ]
            vs = ke.unpack(eval_points(ke, cur, ke.pack(ys, dev))) if ys else []
            sigma = ext.add(state["sigma"], ext.mul(gamma, beta))
            g_pow = gamma
            new_cons = [(gamma, ext.one(), z)]
            for y, v in zip(ys, vs):
                g_pow = ext.mul(g_pow, gamma)
                sigma = ext.add(sigma, ext.mul(g_pow, v))
                new_cons.append((g_pow, ext.one(), y))
            state["sigma"] = sigma
            # previous constraints: fold E into lambda, point advanced by
            # the kappa squarings already applied in the sumcheck block
            state["constraints"] = [
                (ext.mul(lam, E), ext.one(), q)
                for (lam, E, q) in state["constraints"]
            ] + new_cons

        # final block: kappa sumcheck rounds, ship the fold in the clear
        cur, _alphas_fin, triples_fin = self._prover_sumcheck_block(
            cur, state, tr
        )
        sumcheck.append(triples_fin)
        final_coeffs = ke.unpack(cur[: d[R] // k])
        tr.absorb(b"".join(_scalar_bytes(ext, s) for s in final_coeffs))
        pow_nonces.append(tr.grind(cfg.grinding_bits))
        idxs_fin = self._dedupe(tr.challenge_indices(t[R], N[R] // k))
        all_idxs.append(idxs_fin)

        batch_openings, round_openings = self._openings(trees, round_trees,
                                                        all_idxs)
        return WhirProof(
            group_sizes=group_sizes, n=n,
            group_roots=[tree.root() for tree in trees],
            round_roots=[tree.root() for tree in round_trees],
            betas=betas, sumcheck=sumcheck, final_coeffs=final_coeffs,
            batch_openings=batch_openings, round_openings=round_openings,
            pow_nonces=pow_nonces,
        )

    # ----------------------------------------------------------- verify
    def verify(self, proof: WhirProof,
               transcript: FastTranscript = None) -> "StirResult":
        cfg = self.cfg
        ext = self.ext
        k = cfg.k
        kappa = cfg.kappa
        b, n = proof.b, proof.n
        d, N, off, t, R = self._schedule(n)
        assert len(proof.round_roots) == R
        assert len(proof.betas) == R + 1
        assert len(proof.sumcheck) == R + 1
        assert all(len(it) == kappa for it in proof.sumcheck)
        assert all(len(h) == 3 for it in proof.sumcheck for h in it)
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

        z0 = tr.challenge_scalar(ext)
        assert self._ood_ok(z0), "out-of-domain sample hit the prime field"
        beta0 = proof.betas[0]
        tr.absorb(_scalar_bytes(ext, beta0))
        sigma = beta0
        constraints = [(ext.one(), ext.one(), z0)]   # (lam, E, current q)

        p_mod = self.prime.p
        w = [self.prime.get_root_of_unity(Ni) for Ni in N]
        inv2 = ext.inv(ext.from_int(2))

        def verifier_sumcheck_block(it: int):
            """Check kappa rounds of iteration ``it``; returns the alpha
            challenges; mutates sigma/constraints (E accumulation + point
            squaring) exactly like the prover."""
            nonlocal sigma, constraints
            alphas = []
            for l in range(kappa):
                h = proof.sumcheck[it][l]
                s01 = ext.add(
                    self._poly2_eval(ext, h, ext.zero()),
                    self._poly2_eval(ext, h, ext.one()),
                )
                assert s01 == sigma, f"sumcheck round {it}/{l}"
                tr.absorb(b"".join(_scalar_bytes(ext, c) for c in h))
                alpha = tr.challenge_scalar(ext)
                alphas.append(alpha)
                sigma = self._poly2_eval(ext, h, alpha)
                nxt = []
                for (lam, E, q) in constraints:
                    eq_l = ext.add(
                        ext.mul(ext.sub(ext.one(), q),
                                ext.sub(ext.one(), alpha)),
                        ext.mul(q, alpha),
                    )
                    nxt.append((lam, ext.mul(E, eq_l), ext.mul(q, q)))
                constraints = nxt
            return alphas

        def f0_value(committed_row):
            acc = ext.zero()
            for bj in range(b):
                acc = ext.add(acc, ext.mul(rho_pows[bj], committed_row[bj]))
            return acc

        def _fold_fiber(i: int, idx: int, fvals, alphas):
            """Fold_k(f_i, alphas)(x0^k) from f_i's values on fiber
            {x0 * mu^t}: kappa levels of even/odd pairing; at each level
            point s pairs with s + half (mu^half == -1)."""
            x0 = off[i] * pow(int(w[i]), idx, p_mod) % p_mod
            mu = pow(int(w[i]), N[i] // k, p_mod)
            vals = list(fvals)
            for alpha in alphas:
                half = len(vals) // 2
                new = []
                for s in range(half):
                    xs = ext.from_int(x0 * pow(mu, s, p_mod) % p_mod)
                    a, c = vals[s], vals[s + half]
                    even = ext.mul(ext.add(a, c), inv2)
                    odd = ext.mul(ext.sub(a, c),
                                  ext.inv(ext.mul(ext.from_int(2), xs)))
                    new.append(ext.add(even, ext.mul(alpha, odd)))
                vals = new
                x0 = x0 * x0 % p_mod
                mu = mu * mu % p_mod
            assert len(vals) == 1
            return vals[0]

        result_rows: List = []      # authenticated C_0 rows for outer checks

        def open_rows(i: int, idxs):
            """Verify paths of C_i's openings at ``idxs``; decode values.
            rows[qi][t] is a list of b values for i == 0, a value else."""
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
                rows.append(_row_values(ext, path.row, k))
            return rows

        for i in range(1, R + 1):
            alphas = verifier_sumcheck_block(i - 1)
            tr.absorb(proof.round_roots[i - 1])
            z = tr.challenge_scalar(ext)
            assert self._ood_ok(z), "out-of-domain sample hit the prime field"
            beta = proof.betas[i]
            tr.absorb(_scalar_bytes(ext, beta))
            tr.check_grind(cfg.grinding_bits, pow_nonces[i - 1])
            idxs = self._dedupe(tr.challenge_indices(t[i - 1], N[i - 1] // k))
            if i - 1 == 0:
                assert len(proof.batch_openings) == len(idxs)
            else:
                assert len(proof.round_openings[i - 2]) == len(idxs)
            gamma = tr.challenge_scalar(ext)

            rows = open_rows(i - 1, idxs)
            sigma = ext.add(sigma, ext.mul(gamma, beta))
            new_cons = [(gamma, ext.one(), z)]
            g_pow = gamma
            for qi, idx in enumerate(idxs):
                fvals = (
                    [f0_value(rows[qi][tt]) for tt in range(k)]
                    if i - 1 == 0 else rows[qi]
                )
                v = _fold_fiber(i - 1, idx, fvals, alphas)
                y = ext.from_int(
                    pow(off[i - 1] * pow(int(w[i - 1]), idx, p_mod) % p_mod,
                        k, p_mod)
                )
                g_pow = ext.mul(g_pow, gamma)
                sigma = ext.add(sigma, ext.mul(g_pow, v))
                new_cons.append((g_pow, ext.one(), y))
            constraints = [
                (ext.mul(lam, E), ext.one(), q)
                for (lam, E, q) in constraints
            ] + new_cons

        alphas_fin = verifier_sumcheck_block(R)
        tr.absorb(b"".join(_scalar_bytes(ext, s) for s in proof.final_coeffs))
        tr.check_grind(cfg.grinding_bits, pow_nonces[R])
        idxs_fin = self._dedupe(tr.challenge_indices(t[R], N[R] // k))
        if R == 0:
            assert len(proof.batch_openings) == len(idxs_fin)
        else:
            assert len(proof.round_openings[R - 1]) == len(idxs_fin)

        def p_eval(x):
            acc = ext.zero()
            for c in reversed(proof.final_coeffs):
                acc = ext.add(ext.mul(acc, x), c)
            return acc

        # residual sumcheck claim: sum_c lam_c*E_c * p-hat(q_c suffix) == sigma
        resid = ext.zero()
        for (lam, E, q) in constraints:
            resid = ext.add(resid, ext.mul(ext.mul(lam, E), p_eval(q)))
        assert resid == sigma, "final sumcheck claim"

        # bind the shipped p to C_R by fiber spot-checks
        rows = open_rows(R, idxs_fin)
        for qi, idx in enumerate(idxs_fin):
            fvals = (
                [f0_value(rows[qi][tt]) for tt in range(k)]
                if R == 0 else rows[qi]
            )
            got = _fold_fiber(R, idx, fvals, alphas_fin)
            y = ext.from_int(
                pow(off[R] * pow(int(w[R]), idx, p_mod) % p_mod, k, p_mod)
            )
            assert p_eval(y) == got, "final polynomial mismatch"
        return StirResult(rows=result_rows)
