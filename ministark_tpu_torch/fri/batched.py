"""Batched multi-polynomial FRI over wide-arity Merkle trees (fast mode).

Port of ``ministark_tpu/fri/batched.py``: the same protocol, transcript and
proof bytes (tests/test_torch_fast.py holds them to the JAX package's).

  1. LDE all B polynomials to the size-N evaluation domain (one batched
     component NTT, ops/ntt.py) and commit them in one wide-arity index
     tree (commit/index_tree.py) with coset-grouped rows: leaf i holds the
     B*F values {f_b(w^(i + t*N/F))}.
  2. Squeeze rho; the batch polynomial is g = sum_b rho^b f_b (one mix).
  3. Fold F-to-1 per layer with challenge alpha_r (ops/poly.fold_factor);
     each intermediate codeword is committed with F-value coset rows until
     the coefficient tail fits in the clear.
  4. Queries are by index; the verifier recovers the folded values by a
     size-F inverse DFT on host scalars.

Polynomials are (B, n, d) extension tensors (d = 2 for Goldilocks Fp2, 4
for BabyBear Fp4) on any device; the NTTs and tree
builds run where they live, sharded over a mesh when one is given
(``parallel/``, the same proof bytes). The verifier is pure host (hashlib and host
field ops). Challenges come from a ratcheted SHA-256 transcript
(``FastTranscript``), not the parity sponge.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Tuple

import torch

from ..commit.index_tree import IndexMerklePath, IndexMerkleTree
from ..ops.field import get_ops
from ..ops.ntt import check_backend
from ..ops.poly import fold_factor, mix_columns
from ..parallel.ntt_sharded import select_ntt_fns


# --------------------------------------------------------------- transcript
class FastTranscript:
    """Ratcheted SHA-256 transcript (absorb / squeeze, domain-separated)."""

    def __init__(self, label: bytes):
        self._state = hashlib.sha256(b"ministark-fast-v1/" + label).digest()

    def absorb(self, data: bytes):
        self._state = hashlib.sha256(self._state + b"\x01" + data).digest()

    def challenge_bytes(self, n: int) -> bytes:
        out = b""
        i = 0
        while len(out) < n:
            out += hashlib.sha256(
                self._state + b"\x02" + i.to_bytes(8, "little")
            ).digest()
            i += 1
        self._state = hashlib.sha256(self._state + b"\x03").digest()
        return out[:n]

    def challenge_scalar(self, field):
        d = field.extension_degree
        raw = self.challenge_bytes(16 * d)
        prime = field
        while prime.extension_degree > 1:
            prime = prime.base
        comps = tuple(
            int.from_bytes(raw[16 * i : 16 * (i + 1)], "little") % prime.p
            for i in range(d)
        )
        return field.from_base_coeffs(comps) if d > 1 else comps[0]

    def challenge_indices(self, count: int, bound: int) -> List[int]:
        raw = self.challenge_bytes(8 * count)
        return [
            int.from_bytes(raw[8 * i : 8 * (i + 1)], "little") % bound
            for i in range(count)
        ]

    def grind(self, bits: int) -> bytes:
        """Proof-of-work (prover side): find an 8-byte nonce whose hash
        against the current state has ``bits`` leading zero bits, absorb it.
        Grinding before query sampling makes grinding the query set cost
        2^bits hashes per attempt — the standard way to buy back soundness
        bits without more queries."""
        if bits == 0:
            return b""
        assert 0 < bits <= 32
        n = 0
        while True:
            nonce = n.to_bytes(8, "little")
            h = hashlib.sha256(self._state + b"\x04" + nonce).digest()
            if int.from_bytes(h[:4], "big") >> (32 - bits) == 0:
                self.absorb(nonce)
                return nonce
            n += 1

    def check_grind(self, bits: int, nonce: bytes):
        """Verifier side of grind(): check + absorb."""
        if bits == 0:
            assert nonce == b"", "unexpected grinding nonce"
            return
        assert len(nonce) == 8, "bad grinding nonce"
        h = hashlib.sha256(self._state + b"\x04" + nonce).digest()
        assert int.from_bytes(h[:4], "big") >> (32 - bits) == 0, (
            "grinding check failed"
        )
        self.absorb(nonce)


# --------------------------------------------------------------- config
@dataclass
class BatchedFriConfig:
    """``field`` is the (extension) field the polynomials live in."""

    field: object
    blowup: int = 2
    queries: int = 32
    arity: int = 4           # Merkle tree fan-in
    fold_factor: int = 4     # F-to-1 folds per FRI layer
    final_len: int = 32  # ship the tail in the clear at this coeff length
    grinding_bits: int = 0   # PoW before query sampling (adds ~bits security)

    def __post_init__(self):
        assert self.blowup >= 2 and self.blowup & (self.blowup - 1) == 0
        assert self.arity >= 2 and self.arity & (self.arity - 1) == 0
        f = self.fold_factor
        assert f in (2, 4, 8, 16)
        assert self.final_len >= 1 and self.final_len & (self.final_len - 1) == 0
        assert self.queries >= 1
        assert 0 <= self.grinding_bits <= 32


@dataclass
class BatchedFriResult:
    """Truthy verification result carrying the authenticated query rows
    for outer protocols (stark/fast.py) to impose their own row relations:
    per query, (index, vals) where vals[t][b] is polynomial b's value at
    coset point t of the queried index."""

    rows: List[Tuple[int, List]]

    def __bool__(self) -> bool:
        return True


@dataclass
class BatchedFriProof:
    group_sizes: List[int]      # polynomials per commitment group
    n: int                      # per-polynomial coefficient length
    group_roots: List[bytes]    # one coset-row tree per group
    layer_roots: List[bytes]    # layers 1..R-1
    final_coeffs: List          # layer R coefficients, in the clear
    batch_openings: List[List[IndexMerklePath]]    # [query][group]
    layer_openings: List[List[IndexMerklePath]]    # [query][layer-1]
    pow_nonce: bytes = b""                         # grinding nonce (if any)

    @property
    def b(self) -> int:
        return sum(self.group_sizes)


def _scalar_bytes(field, s) -> bytes:
    return b"".join(
        int(c).to_bytes(8, "little") for c in (
            field.base_coeffs(s) if field.extension_degree > 1 else (s,)
        )
    )


def _row_values(field, row: bytes, count: int) -> List:
    """Decode a tree row (count field values as LE u64 components)."""
    d = field.extension_degree
    vals = []
    for j in range(count):
        comps = tuple(
            int.from_bytes(row[8 * (j * d + i) : 8 * (j * d + i + 1)], "little")
            for i in range(d)
        )
        vals.append(field.from_base_coeffs(comps) if d > 1 else comps[0])
    return vals


class BatchedFri:
    def __init__(self, config: BatchedFriConfig, ntt_backend: str = "radix2",
                 mesh=None):
        """``ntt_backend``: the NTT kernels of the LDE (ops/ntt.py); not part
        of the config or the transcript, and it changes no proof byte.
        ``mesh``: a ``parallel.Mesh``; the LDE NTTs and the tree builds
        shard over it where their sizes split."""
        self.cfg = config
        self.ntt_backend = check_backend(ntt_backend)
        self.mesh = mesh
        self.ext = config.field
        self.ke = get_ops(self.ext)
        # the ext elements' components are prime-field values, so the
        # component NTT runs over the prime field (``.base`` walks the tower
        # down: BabyBear Fp4's ``base_field`` is Fp2, its ``base`` BabyBear)
        self._ntt_base = self.ext.base

    # -- batched component NTT: ext NTT = base NTT per base component
    def _fft_batched(self, coeffs: torch.Tensor, domain_size: int,
                     offset: int = None) -> torch.Tensor:
        """coeffs: (..., m, d) extension values, m <= domain_size ->
        (..., N, d) evals over the subgroup of size N, or with ``offset``
        over its coset offset * <w_N> (STIR's and WHIR's domains)."""
        lead = coeffs.dim() - 2
        m = coeffs.shape[lead]
        comp = coeffs.movedim(-1, lead)                   # (..., d, m)
        rows = comp.reshape(-1, m)
        flat = torch.zeros((rows.shape[0], domain_size), dtype=torch.int64,
                           device=coeffs.device)
        flat[:, :m] = rows
        fns = select_ntt_fns(self._ntt_base, domain_size, self.mesh, self.ntt_backend)
        ev = fns[0](flat) if offset is None else fns[2](flat, offset)
        ev = ev.reshape(comp.shape[:-1] + (domain_size,))
        return ev.movedim(lead, -1)                       # (..., N, d)

    def _tree(self, rows: torch.Tensor) -> IndexMerkleTree:
        """(N/F, ..., d) coset rows -> tree over their u64 components."""
        return IndexMerkleTree(rows.reshape(rows.shape[0], -1), self.cfg.arity,
                               self.mesh)

    def _transcript(self, b: int, n: int) -> FastTranscript:
        tr = FastTranscript(b"batched-fri")
        tr.absorb(
            b"%d/%d/%d/%d/%d/%d/%d/%d"
            % (b, n, self.cfg.blowup, self.cfg.arity, self.cfg.fold_factor,
               self.cfg.queries, self.cfg.final_len, self.cfg.grinding_bits)
        )
        return tr

    def _n_folds(self, n: int) -> int:
        """Smallest R with n / F^R <= final_len."""
        assert n > self.cfg.final_len, "nothing to fold — ship the polys"
        F, R, m = self.cfg.fold_factor, 0, n
        while m > self.cfg.final_len:
            assert m % F == 0, f"coeff length {n} not foldable by {F} down to {self.cfg.final_len}"
            m //= F
            R += 1
        return R

    @staticmethod
    def _coset_rows(evals: torch.Tensor, F: int) -> torch.Tensor:
        """codeword(s) -> contiguous coset-grouped tree rows.

        (N, d) -> (N/F, F, d); (B, N, d) -> (N/F, B, F, d). Row i holds the
        values at domain indices {i + t*N/F}."""
        d = evals.shape[-1]
        if evals.dim() == 2:
            N = evals.shape[0]
            return evals.reshape(F, N // F, d).movedim(1, 0).contiguous()
        B, N = evals.shape[0], evals.shape[1]
        a = evals.reshape(B, F, N // F, d)
        return a.permute(2, 0, 1, 3).contiguous()

    # ------------------------------------------------------------- prove
    def commit(self, polys: torch.Tensor) -> IndexMerkleTree:
        """Commitment of one polynomial group: LDE all its polynomials (one
        batched component NTT) + one wide-arity coset-row tree. The caller
        absorbs the root into its transcript where the group is bound."""
        N = self.cfg.blowup * int(polys.shape[1])
        evals0 = self._fft_batched(polys, N)        # (B, N, d)
        return self._tree(self._coset_rows(evals0, self.cfg.fold_factor))

    def binding_lde(self, ext_coeffs: torch.Tensor):
        """(N, row_group, evals over this backend's layer-0 domain) — what
        an outer protocol needs to recompute committed rows itself
        (stark/fast.py row binding); opened row idx's coset point t sits at
        domain index idx + t*(N // row_group)."""
        N = self.cfg.blowup * int(ext_coeffs.shape[1])
        return N, self.cfg.fold_factor, self._fft_batched(ext_coeffs, N)

    def prove(self, polys=None, transcript: FastTranscript = None,
              groups=None, trees=None) -> BatchedFriProof:
        """Standalone: ``prove(polys)`` — one group, committed and absorbed
        internally on a fresh transcript.

        Multi-group (outer protocols, stark/fast.py): ``prove(groups=[...],
        trees=[...], transcript=tr)`` — the caller committed each group via
        ``commit`` and absorbed every root into ``tr`` in its own protocol
        order; the FRI continues from rho."""
        cfg = self.cfg
        ext, ke = self.ext, self.ke
        F = cfg.fold_factor
        if groups is None:
            assert polys is not None
            groups = [polys]
        n = int(groups[0].shape[1])
        group_sizes = [int(g.shape[0]) for g in groups]
        b = sum(group_sizes)
        assert n & (n - 1) == 0
        assert all(int(g.shape[1]) == n for g in groups)
        N = cfg.blowup * n
        R = self._n_folds(n)
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
        cur = mix_columns(ke, allp, weights)              # g coeffs (n, d)

        layer_trees: List[IndexMerkleTree] = []
        for r in range(R):
            alpha = tr.challenge_scalar(ext)
            cur = fold_factor(ke, cur, ke.pack_scalar(alpha, dev), F)
            if r < R - 1:
                cw = self._fft_batched(cur, N // F ** (r + 1))
                t = self._tree(self._coset_rows(cw, F))
                layer_trees.append(t)
                tr.absorb(t.root())

        final_coeffs = ke.unpack(cur)
        tr.absorb(b"".join(_scalar_bytes(ext, s) for s in final_coeffs))

        pow_nonce = tr.grind(cfg.grinding_bits)
        idxs = tr.challenge_indices(cfg.queries, N // F)

        per_group = [t.open_many(idxs) for t in trees]
        batch_openings = [
            [per_group[g][qi] for g in range(len(trees))]
            for qi in range(len(idxs))
        ]
        layer_openings: List[List] = [[] for _ in idxs]
        for r, t in enumerate(layer_trees, start=1):
            half = (N // F ** r) // F
            opened = t.open_many([i % half for i in idxs])
            for qi, p in enumerate(opened):
                layer_openings[qi].append(p)

        return BatchedFriProof(
            group_sizes=group_sizes, n=n,
            group_roots=[t.root() for t in trees],
            layer_roots=[t.root() for t in layer_trees],
            final_coeffs=final_coeffs,
            batch_openings=batch_openings, layer_openings=layer_openings,
            pow_nonce=pow_nonce,
        )

    # ------------------------------------------------------------- verify
    def verify(self, proof: BatchedFriProof,
               transcript: FastTranscript = None) -> "BatchedFriResult":
        cfg = self.cfg
        ext = self.ext
        b, n = proof.b, proof.n
        F = cfg.fold_factor
        N = cfg.blowup * n
        R = self._n_folds(n)
        assert len(proof.layer_roots) == R - 1
        assert len(proof.final_coeffs) <= max(n // F ** R, 1)

        if transcript is None:
            # standalone single-group protocol: absorb the commitment here.
            # Outer protocols absorb every group root into their own
            # transcript BEFORE calling verify (stark/fast.py).
            assert len(proof.group_sizes) == 1
            tr = self._transcript(b, n)
            tr.absorb(proof.group_roots[0])
        else:
            tr = transcript
        rho = tr.challenge_scalar(ext)
        # transcript order mirrors prove: alpha_0, root_1, alpha_1, root_2, …
        alphas = []
        for r in range(R):
            alphas.append(tr.challenge_scalar(ext))
            if r < R - 1:
                tr.absorb(proof.layer_roots[r])
        tr.absorb(b"".join(_scalar_bytes(ext, s) for s in proof.final_coeffs))
        tr.check_grind(cfg.grinding_bits, proof.pow_nonce)
        idxs = tr.challenge_indices(cfg.queries, N // F)

        inv_F = ext.inv(ext.from_int(F))
        rho_pows = [ext.pow(rho, j) for j in range(b)]
        w0 = ext.get_root_of_unity(N)

        def fold_check(vals, x, wF_inv_pows, alpha):
            """vals[t] = layer(x * wF^t) -> layer_{+1}(x^F) via inverse
            F-DFT: f_j(x^F) = (1/F) x^-j sum_t wF^{-tj} vals[t]."""
            x_inv = ext.inv(x)
            acc = ext.zero()
            a_pow = ext.one()
            xj = ext.one()
            for j in range(F):
                s = ext.zero()
                for t in range(F):
                    s = ext.add(s, ext.mul(wF_inv_pows[(t * j) % F], vals[t]))
                fj = ext.mul(ext.mul(s, inv_F), xj)
                acc = ext.add(acc, ext.mul(a_pow, fj))
                a_pow = ext.mul(a_pow, alpha)
                xj = ext.mul(xj, x_inv)
            return acc

        # per-layer domain generators and F-th-root inverse powers
        w_r = [w0]
        for r in range(1, R):
            w_r.append(ext.pow(w_r[-1], F))
        wF_inv = []
        for r in range(R):
            Nr = N // F ** r
            wf = ext.pow(w_r[r], Nr // F)
            wfi = ext.inv(wf)
            wF_inv.append([ext.pow(wfi, t) for t in range(F)])

        rows = []
        for qi, idx in enumerate(idxs):
            fvals = [[] for _ in range(F)]       # [t] -> values over all polys
            for gi, gsize in enumerate(proof.group_sizes):
                p0 = proof.batch_openings[qi][gi]
                assert IndexMerkleTree.verify_path(
                    proof.group_roots[gi], N // F, cfg.arity, idx, p0
                ), f"batch path group {gi}"
                flat = _row_values(ext, p0.row, gsize * F)
                for t in range(F):
                    fvals[t].extend(flat[bj * F + t] for bj in range(gsize))
            coset = []
            for t in range(F):
                g = ext.zero()
                for bj in range(b):
                    g = ext.add(g, ext.mul(rho_pows[bj], fvals[t][bj]))
                coset.append(g)

            pos = idx                       # i_r in [0, N_r / F)
            x = ext.pow(w0, idx)
            for r in range(R):
                expected = fold_check(coset, x, wF_inv[r], alphas[r])
                q = pos                     # position in layer r+1
                x = ext.pow(x, F)           # w_{r+1}^q
                if r < R - 1:
                    Nn = N // F ** (r + 1)
                    ir = q % (Nn // F)
                    t_p = q // (Nn // F)
                    p = proof.layer_openings[qi][r]
                    assert IndexMerkleTree.verify_path(
                        proof.layer_roots[r], Nn // F, cfg.arity, ir, p
                    ), f"layer {r+1} path"
                    coset = _row_values(ext, p.row, F)
                    assert coset[t_p] == expected, f"fold mismatch at layer {r+1}"
                    # x currently = w_{r+1}^q = w_{r+1}^{ir} * wF^{t_p}
                    x = ext.mul(x, ext.pow(wF_inv[r + 1][1], t_p))
                    pos = ir
                else:
                    acc = ext.zero()
                    for c in reversed(proof.final_coeffs):
                        acc = ext.add(ext.mul(acc, x), c)
                    assert acc == expected, "final layer mismatch"
            rows.append((idx, fvals))
        return BatchedFriResult(rows=rows)
