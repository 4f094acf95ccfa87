"""Tensor-native STARK prover/verifier engine for large traces.

Port of ``ministark_tpu/stark/engine.py``. It runs the identical protocol
to stark/stark.py (the same transcript bytes, Merkle commitments and proof
values; tests/test_torch_engine.py holds it to the host prover and to the
JAX engine byte for byte), keeping every polynomial and codeword a tensor
on the engine's device:

  trace column iFFT / coset LDE          -> ops/ntt.py (CUDA kernels; the
                                            ``ntt_backend`` argument picks
                                            radix-2, four-step or pipe)
  codeword Merkle commitments            -> commit/packed_tree.py
                                            (leaf-hash and SHA-256 kernels)
  mixing / folding / division / DEEP     -> ops/poly.py (torch ops)

Only protocol-inherent sequential state (the Fiat-Shamir sponge, challenge
scalars, proof assembly) touches host scalars. The device is explicit:
``DeviceEngine(config, device="cuda")`` by default, and the constructor
raises on a host without a card (the CPU is used only when asked for with
``device="cpu"``); a tensor handed in on another device is moved there
once. ``ntt_backend`` ("radix2", "four_step" or "pipe", ops/ntt.py) chooses
the NTT kernels; it is not part of the config and changes no proof byte.

Two value-preserving deviations from the reference's algorithm, as in the
JAX engine: query-phase y values are read from the committed codeword
instead of re-running Horner, and the quotient/vanishing division whose
result the verifier discards (src/fri.rs:227) is skipped.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from ..commit.merkle import MerkleTree
from ..commit.packed_tree import PackedMerkleTree, to_leaf_comps
from ..fri.fri import Fri, FriProof, FriRound as HostFriRound
from ..ops.field import get_ops, lift_base_array, pack_u64
from ..ops.ntt import check_backend, get_ntt_fns
from ..ops.poly import (
    effective_len,
    eval_even_odd,
    eval_many,
    fold_even_odd,
    mix_columns,
    synth_div_suffix,
)
from ..poly import DensePolynomial, Radix2EvaluationDomain
from ..transcript.merlin import Arthur, Merlin
from ..utils import LeafNotFound
from .stark import StarkConfig, StarkProof

# Below this codeword size the FRI tail runs on host scalars; proof bytes
# are identical at any value (tests set it to 1 to force the tensor path).
DEVICE_MIN_SIZE = 1 << 13


@dataclass
class DeviceTrace:
    """Tensor-native TraceTable equivalent.

    ``cols``: (width, N) u64 numpy array of column evaluations over the
    trace domain (rows >= steps carry the deterministic ZK padding), OR
    ``cols_dev``: the same data as a (width, N) int64 tensor (witness built
    on the device). ``transitions`` map the (width, N) trace-polynomial
    coefficient tensor to one (N,) constraint coefficient tensor."""

    stark_field: object
    steps: int
    cols: "np.ndarray | None"
    transitions: List[Callable]
    cols_dev: "torch.Tensor | None" = None

    @property
    def width(self) -> int:
        return (self.cols if self.cols is not None else self.cols_dev).shape[0]

    @property
    def domain_size(self) -> int:
        return (self.cols if self.cols is not None else self.cols_dev).shape[1]

    def constrain_number(self) -> int:
        return self.width + len(self.transitions)


class DeviceEngine:
    def __init__(self, config: StarkConfig, device="cuda",
                 ntt_backend: str = "radix2"):
        self.config = config
        self.device = torch.device(device)
        self.ntt_backend = check_backend(ntt_backend)
        # fails here, not mid-prove, when the device does not exist
        torch.empty(0, device=self.device)
        sf = config.stark_field
        self.kb = get_ops(sf.base)
        self.ke = get_ops(sf.extension)
        self._t0 = None
        self._last_label = None
        # wall seconds per phase of the latest prove(); each boundary
        # synchronizes a CUDA device, so a phase owns its kernels' time
        self.phase_seconds: dict = {}

    def _t(self, label: str):
        """Close the previous phase, open ``label``; accumulate durations."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.time()
        if self._t0 is not None:
            dt = now - self._t0
            self.phase_seconds[self._last_label] = (
                self.phase_seconds.get(self._last_label, 0.0) + dt)
        self._t0 = now
        self._last_label = label

    # ------------------------------------------------------------------ utils
    def _cols(self, trace: DeviceTrace) -> torch.Tensor:
        """(width, N) int64 column evaluations on the engine's device."""
        if trace.cols_dev is not None:
            return trace.cols_dev.to(self.device)
        return pack_u64(trace.cols, self.device)

    def _trace_polys(self, trace: DeviceTrace) -> torch.Tensor:
        """(width, N) evaluations -> (width, N) coefficients."""
        _, ifft, _, _ = get_ntt_fns(self.config.stark_field.base,
                                    trace.domain_size, self.ntt_backend)
        return ifft(self._cols(trace))

    def constrain_coeffs(self, trace: DeviceTrace) -> torch.Tensor:
        """The out-of-band Constrains as one (w+t, N) coefficient tensor:
        trace polynomials ++ transition outputs (derive_constrains)."""
        tp = self._trace_polys(trace)
        return torch.cat([tp] + [f(tp)[None] for f in trace.transitions], 0)

    # ------------------------------------------------------------------ prove
    def prove(self, trace: DeviceTrace) -> StarkProof:
        cfg = self.config
        sf = cfg.stark_field
        base, ext = sf.base, sf.extension
        kb, ke = self.kb, self.ke
        dev = self.device
        merlin = Merlin(cfg.io)
        n = trace.domain_size

        self.phase_seconds = {}
        self._t0 = None
        self._t("trace_commit")
        # 1.1 trace commitment over the row-major trace; leafs_per_node is
        # the constraint count (6), so one leaf group spans two rows
        cols = self._cols(trace)
        trace_tree = PackedMerkleTree(
            base, cols.T.contiguous().reshape(-1), cfg.merkle_config)
        trace_commit = trace_tree.root()
        del trace_tree
        merlin.add_bytes(trace_commit)

        self._t("lde")
        # 1.2 LDE of all constraint polynomials
        lde_n = cfg.blowup_factor * n
        random_shift = merlin.challenge_scalar(base)
        _, ifft, _, _ = get_ntt_fns(base, n, self.ntt_backend)
        trace_poly = ifft(cols)                                      # (w, n)
        del cols
        all_coeffs = torch.cat(
            [trace_poly] + [f(trace_poly)[None] for f in trace.transitions], 0)
        total = all_coeffs.shape[0]
        padded = torch.zeros((total, lde_n), dtype=torch.int64, device=dev)
        padded[:, :n] = all_coeffs
        _, _, coset_fft, _ = get_ntt_fns(base, lde_n, self.ntt_backend)
        lde_evals = coset_fft(padded, random_shift)                  # (w+t, 2n)
        del padded

        self._t("constrain_tree")
        constrain_tree = PackedMerkleTree(
            base, lde_evals.T.contiguous().reshape(-1), cfg.merkle_config)
        del lde_evals
        constrain_trace_commit = constrain_tree.root()
        del constrain_tree
        merlin.add_bytes(constrain_trace_commit)

        self._t("mix")
        # 1.3 mix into the validity polynomial (remainder quirk §8.3:
        # validity == mixed since deg < domain size)
        r = merlin.challenge_scalar(base)
        weights = kb.pack([base.pow(r, i) for i in range(total)], dev)
        mixed = mix_columns(kb, all_coeffs, weights)                 # (n,)

        self._t("deep_ali")
        # 2. DEEP-ALI queries
        queries = merlin.challenge_scalars(ext, cfg.constrain_queries)
        ext_coeff_arr = lift_base_array(ke, all_coeffs)              # (w+t, n, d)
        ext_mixed = lift_base_array(ke, mixed)
        constrain_queries, validity_queries = [], []
        for q in queries:
            evals = ke.unpack(eval_many(ke, ext_coeff_arr, ke.pack_scalar(q, dev)))
            constrain_queries.append(evals)
            # validity == mixed (§8.3) => its query value is the r-weighted
            # sum of the constraint query values (identical field value)
            acc = ext.zero()
            for i, ev in enumerate(evals):
                acc = ext.add(acc, ext.mul(ext.from_base_prime_field(base.pow(r, i)), ev))
            validity_queries.append(acc)
        del ext_coeff_arr, all_coeffs

        self._t("fri")
        # 3. FRI on the extension-lifted validity polynomial
        fri_proof = self._fri_prove(merlin, ext_mixed)

        self._t("done")
        return StarkProof(
            arthur=merlin.transcript(),
            trace_commit=trace_commit,
            constrain_trace_commit=constrain_trace_commit,
            constrain_queries=constrain_queries,
            validity_queries=validity_queries,
            fri_proof=fri_proof,
        )

    # ------------------------------------------------------------------- FRI
    def _ext_fft(self, coeffs: torch.Tensor, domain_size: int) -> torch.Tensor:
        """Extension codeword (N, d) of (m, d) coefficients, m <= N, as the
        base NTT batched over the d components (2 for Fp2, 4 for Fp4)."""
        comp = torch.zeros((coeffs.shape[1], domain_size), dtype=torch.int64,
                           device=coeffs.device)
        comp[:, :coeffs.shape[0]] = coeffs.T
        fft, _, _, _ = get_ntt_fns(self.config.stark_field.base, domain_size,
                                   self.ntt_backend)
        return fft(comp).T.contiguous()

    def _fri_prove(self, merlin: Merlin, poly_coeffs) -> "DeviceFriProof":
        """Hybrid FRI: tensors for large rounds, host scalars for the
        geometric tail (< DEVICE_MIN_SIZE); identical bytes either way."""
        cfg = self.config.fri_config
        ext = self.config.stark_field.extension
        ke = self.ke

        degree = max(effective_len(poly_coeffs) - 1, 0)
        size = (degree + 1) * cfg.blowup_factor

        rounds: List[_FriRoundRepr] = [self._make_round(poly_coeffs, size)]
        cur = rounds[0]
        for ri in range(1, cfg.rounds):
            self._t(f"fri_round_{ri}_size{cur.size}")
            z = merlin.challenge_scalar(ext)
            fe_z, fo_z = self._deep_evals(cur, z)
            merlin.add_scalars(ext, [fe_z, fo_z])

            alpha = merlin.challenge_scalar(ext)
            deep_value = ext.add(fe_z, ext.mul(alpha, fo_z))
            round_coeffs = self._fold_div(cur, z, alpha, deep_value)
            cur = self._make_round(round_coeffs, cur.size // 2)
            merlin.add_bytes(cur.tree.root())
            rounds.append(cur)

        # ---- query phase
        raw = merlin.fill_challenge_bytes(8 * cfg.queries)
        betas = [int.from_bytes(raw[i * 8 : (i + 1) * 8], "little")
                 for i in range(cfg.queries)]
        points, queries, quotients = [], [], []
        for i in range(len(rounds) - 1):
            self._t(f"fri_query_round_{i}")
            prev, nxt = rounds[i], rounds[i + 1]
            assert prev.size // 2 == nxt.size
            prev_gen = ext.get_root_of_unity(prev.size)
            next_gen = ext.get_root_of_unity(nxt.size)
            red_betas = [b % prev.size if b > prev.size else b for b in betas]
            nq = len(red_betas)
            idxs_prev = ([b % prev.size for b in red_betas]
                         + [(nxt.size + b) % prev.size for b in red_betas])
            idxs_next = [b % nxt.size for b in red_betas]
            xs = [(ext.pow(prev_gen, b), ext.pow(prev_gen, nxt.size + b),
                   ext.pow(next_gen, b)) for b in red_betas]

            next_reads = nxt.read_many(idxs_next)
            if prev.device:
                reads = prev.codeword[
                    torch.tensor(idxs_prev, dtype=torch.int64, device=self.device)]
                qs, effs = self._quotients_from_reads(prev, reads, xs)
                # proof search by the y1/y2 values, interleaved per query
                # [y1_0, y2_0, y1_1, ...], in the tree's leaf layout (§8.6)
                rows = torch.stack([reads[:nq], reads[nq:]], 1).reshape(2 * nq, -1)
                sidx = [int(v) for v in prev.tree.search_rows_async(
                    to_leaf_comps(ext, rows)).cpu()]
                if any(ix >= prev.tree.n_leafs for ix in sidx):
                    # a missed search returns n_leafs: fail loudly instead
                    # of gathering past the end (a device-side fault)
                    raise LeafNotFound()
                proofs = prev.tree.proofs_finish(prev.tree.proofs_gather_async(sidx))
                prev_reads = ke.unpack(reads)
                round_quotients = self._trim_quotients(qs, effs)
            else:
                prev_reads = prev.read_many(idxs_prev)
                round_quotients = []
                for qi in range(nq):
                    (x1, x2, _), y1, y2 = xs[qi], prev_reads[qi], prev_reads[nq + qi]
                    a = ext.mul(ext.sub(y2, y1), ext.inv(ext.sub(x2, x1)))
                    b = ext.sub(y1, ext.mul(a, x1))
                    round_quotients.append(self._host_quotient(prev, a, b, x1, x2))
                proofs = [prev.tree.generate_proof(prev_reads[j])
                          for qi in range(nq) for j in (qi, nq + qi)]

            round_points, round_queries = [], []
            for qi in range(nq):
                x1, x2, x3 = xs[qi]
                # codeword entries ARE the reference's direct evaluations
                round_points.append([(x1, prev_reads[qi]), (x2, prev_reads[nq + qi]),
                                     (x3, next_reads[qi])])
                round_queries.append([proofs[2 * qi], proofs[2 * qi + 1]])
            points.append(round_points)
            queries.append(round_queries)
            quotients.append(round_quotients)

        return DeviceFriProof(ke=ke, points=points, queries=queries,
                              quotients=quotients)

    # ------------------------------------------------- hybrid round helpers
    def _make_round(self, coeffs, size: int) -> "_FriRoundRepr":
        """coeffs: a tensor zero-padded to a power-of-two length (halving
        each round), OR a trimmed host scalar list (tail rounds)."""
        ext = self.config.stark_field.extension
        mcfg = self.config.fri_config.merkle_config
        if isinstance(coeffs, list) or size < DEVICE_MIN_SIZE:
            if not isinstance(coeffs, list):
                coeffs = self.ke.unpack(coeffs[:effective_len(coeffs)])
            codeword = Radix2EvaluationDomain(ext, size).fft(coeffs)
            return _FriRoundRepr(device=False, ke=self.ke, coeffs=coeffs,
                                 codeword=codeword,
                                 tree=MerkleTree(ext, codeword, mcfg), size=size)
        codeword = self._ext_fft(coeffs[: min(size, coeffs.shape[0])], size)
        return _FriRoundRepr(device=True, ke=self.ke, coeffs=coeffs,
                             codeword=codeword,
                             tree=PackedMerkleTree(ext, codeword, mcfg), size=size)

    def _deep_evals(self, rnd: "_FriRoundRepr", z):
        ext = self.config.stark_field.extension
        if rnd.device:
            if rnd.coeffs.shape[0] == 0:
                return ext.zero(), ext.zero()
            fe, fo = eval_even_odd(self.ke, rnd.coeffs,
                                   self.ke.pack_scalar(z, self.device))
            both = self.ke.unpack(torch.stack([fe, fo]))   # one pull
            return both[0], both[1]
        parts = HostFriRound.split_poly(ext, DensePolynomial(ext, rnd.coeffs), 2)
        return parts[0].evaluate(z), parts[1].evaluate(z)

    def _fold_div(self, rnd: "_FriRoundRepr", z, alpha, deep_value):
        """One FRI round: fold even/odd, subtract the DEEP value at x^0,
        divide by (x - z), zero-pad to n/2 (``engine._fold_div_jit``)."""
        ext = self.config.stark_field.extension
        ke = self.ke
        if rnd.device and not ext.is_zero(z):
            n = rnd.coeffs.shape[0]
            pack = lambda v: ke.pack_scalar(v, self.device)  # noqa: E731
            folded = fold_even_odd(ke, rnd.coeffs, pack(alpha))
            folded[0] = ke.sub(folded[0], pack(deep_value))
            q = synth_div_suffix(ke, folded, pack(z), pack(ext.inv(z)))
            rp = torch.zeros((n // 2,) + ke.elem_axes, dtype=torch.int64,
                             device=self.device)
            rp[: q.shape[0]] = q
            # hand off to the host representation when the next round is small
            if rnd.size // 2 < DEVICE_MIN_SIZE:
                return ke.unpack(rp[: effective_len(rp)])
            return rp
        if rnd.device:
            coeffs = ke.unpack(rnd.coeffs[: effective_len(rnd.coeffs)])
        else:
            coeffs = rnd.coeffs
        parts = HostFriRound.split_poly(ext, DensePolynomial(ext, coeffs), 2)
        folded = parts[0] + parts[1].scale(alpha)
        dv_poly = DensePolynomial(ext, [deep_value])
        denominator = DensePolynomial(ext, [ext.neg(z), ext.one()])
        return ((folded - dv_poly) / denominator).to_vec()

    def _quotients_from_reads(self, prev: "_FriRoundRepr", reads, xs):
        """All of one round's query quotients (f - line) / ((x - x1)(x - x2))
        as one batch, with the lines a*x + b derived on the device from the
        codeword reads (y1 = reads[:Q], y2 = reads[Q:2Q]):
        (Q, n0 - 1, d) quotients zero-padded past their effective lengths,
        and those lengths (Q,)."""
        ext = self.config.stark_field.extension
        ke = self.ke
        pc = prev.coeffs
        if pc.shape[0] < 2:
            pc = torch.cat([pc, torch.zeros((2 - pc.shape[0],) + ke.elem_axes,
                                            dtype=pc.dtype, device=pc.device)], 0)
        Q = len(xs)

        def stack(vals):
            return ke.pack(vals, self.device)                        # (Q, d)

        x1_s = stack([x1 for (x1, _, _) in xs])
        x2_s = stack([x2 for (_, x2, _) in xs])
        dxinv_s = stack([ext.inv(ext.sub(x2, x1)) for (x1, x2, _) in xs])
        s1_s = stack([ext.inv(x1) for (x1, _, _) in xs])
        s2_s = stack([ext.inv(x2) for (_, x2, _) in xs])
        y1_s, y2_s = reads[:Q], reads[Q:2 * Q]
        a_s = ke.mul(ke.sub(y2_s, y1_s), dxinv_s)
        b_s = ke.sub(y1_s, ke.mul(a_s, x1_s))

        num = pc.unsqueeze(0).repeat(Q, 1, 1)                        # (Q, n0, d)
        num[:, 0] = ke.sub(num[:, 0], b_s)
        num[:, 1] = ke.sub(num[:, 1], a_s)
        q1 = synth_div_suffix(ke, num, x1_s, s1_s)                   # (Q, n0-1, d)
        q1 = torch.cat([q1, torch.zeros_like(q1[:, :1])], 1)
        q2 = synth_div_suffix(ke, q1, x2_s, s2_s)                    # (Q, n0-1, d)
        nz = (q2 != 0).any(-1)
        idx = torch.arange(1, q2.shape[1] + 1, device=q2.device)
        effs = torch.where(nz, idx, torch.zeros_like(idx)).amax(1)
        return q2, effs

    @staticmethod
    def _trim_quotients(qs, effs):
        """Per-query quotient tensors on the host, each trimmed to its
        effective length; one pull of the longest prefix for the batch."""
        effs = [int(e) for e in effs.cpu()]
        arr = qs[:, : max(effs + [0])].cpu()
        return [arr[qi, : effs[qi]] for qi in range(len(effs))]

    def _host_quotient(self, prev: "_FriRoundRepr", a, b, x1, x2):
        ext = self.config.stark_field.extension
        poly = DensePolynomial(ext, prev.coeffs)
        g = DensePolynomial(ext, [b, a])
        vanishing = (DensePolynomial(ext, [ext.neg(x1), ext.one()])
                     * DensePolynomial(ext, [ext.neg(x2), ext.one()]))
        return (poly - g) / vanishing

    # ----------------------------------------------------------- verifier
    def verify(self, constrain_coeffs: torch.Tensor, proof: StarkProof) -> bool:
        """Tensor verifier mirroring stark/stark.py::Stark.verify.

        ``constrain_coeffs``: (w+t, n) coefficient tensor (the out-of-band
        Constrains, as ``constrain_coeffs(trace)`` produces them)."""
        cfg = self.config
        sf = cfg.stark_field
        base, ext = sf.base, sf.extension
        ke = self.ke

        arthur = Arthur(cfg.io, proof.arthur)
        assert arthur.next_digest() == proof.trace_commit
        _shift = arthur.challenge_scalar(base)
        assert arthur.next_digest() == proof.constrain_trace_commit
        r = arthur.challenge_scalar(base)

        queries = arthur.challenge_scalars(ext, cfg.constrain_queries)
        ext_coeffs = lift_base_array(ke, constrain_coeffs.to(self.device))
        # The host verifier divides by the vanishing polynomial of
        # Radix2(degree + 1); the weighted-sum shortcut below is only valid
        # when that domain is at least the trace domain (as in the host).
        verifier_domain = Radix2EvaluationDomain(ext, cfg.degree + 1)
        assert constrain_coeffs.shape[1] <= verifier_domain.size(), (
            f"trace domain {constrain_coeffs.shape[1]} exceeds the verifier "
            f"domain {verifier_domain.size()}: the reference verifier would "
            f"reject (§8.3 divergence outside non-pow2 step counts)")
        for query, constrain_query, validity_query in zip(
                queries, proof.constrain_queries, proof.validity_queries):
            evals = ke.unpack(eval_many(ke, ext_coeffs, ke.pack_scalar(query, self.device)))
            acc = ext.zero()
            for i, (ev, claimed) in enumerate(zip(evals, constrain_query)):
                assert ev == claimed
                acc = ext.add(acc, ext.mul(ext.from_base_prime_field(base.pow(r, i)), ev))
            # §8.3: c_x has degree < domain size, so the protocol's "quotient"
            # is c_x itself and its evaluation is the weighted sum above
            assert acc == validity_query

        fri_proof = proof.fri_proof
        if isinstance(fri_proof, DeviceFriProof):
            return self._fri_verify(fri_proof, arthur)
        return Fri(ext, cfg.fri_config).verify(fri_proof, arthur)

    def _fri_verify(self, proof: "DeviceFriProof", arthur: Arthur) -> bool:
        """Mirror of fri/fri.py::Fri.verify over quotient tensors."""
        cfg = self.config.fri_config
        ext = self.config.stark_field.extension
        fri = Fri(ext, cfg)
        commits, alphas, betas, deep_queries, deep_polys = fri.read_proof_transcript(arthur)
        assert len(commits) == cfg.rounds - 1
        assert len(commits) == len(proof.points)

        domain = Radix2EvaluationDomain(ext, 1 << cfg.rounds)
        prev_x3s = [domain.element(b) for b in betas]
        for i, (round_points, round_queries) in enumerate(zip(proof.points, proof.queries)):
            for j, (pts, paths) in enumerate(zip(round_points, round_queries)):
                (x1, y1), (x2, y2), (x3, y3) = pts
                path1, path2 = paths
                assert x1 == prev_x3s[j]
                assert ext.neg(x1) == x2
                assert ext.pow(x1, 2) == x3

                q = proof.quotients[i][j]
                q_len = q.shape[0] if isinstance(q, torch.Tensor) else len(q.coeffs)
                total_degree = max(q_len - 1, 0) + 3
                assert total_degree >= 2
                assert total_degree <= 1 << (cfg.rounds - i)
                # quotient/vanishing division result is discarded by the
                # reference (§8.5): skipped entirely here

                a = ext.mul(ext.sub(y2, y1), ext.inv(ext.sub(x2, x1)))
                b = ext.sub(y1, ext.mul(a, x1))
                deep_adjusted_y = ext.add(
                    ext.mul(y3, ext.sub(x3, deep_queries[i])),
                    deep_polys[i].evaluate(alphas[i]),
                )
                g = DensePolynomial(ext, [b, a])
                assert g.evaluate(alphas[i]) == deep_adjusted_y

                assert y1 in path1.leaf_neighbours
                commits[i].check_proof(ext, path1)  # ignored (§8.5)
                assert y2 in path2.leaf_neighbours
                commits[i].check_proof(ext, path2)  # ignored (§8.5)
                prev_x3s[j] = x3
        return True


@dataclass
class _FriRoundRepr:
    device: bool
    ke: object
    coeffs: object        # device: (m, d) tensor; host: scalar list
    codeword: object      # device: (size, d) tensor; host: scalar list
    tree: object          # device: PackedMerkleTree; host: MerkleTree
    size: int

    def read_many(self, idxs):
        if self.device:
            dev = self.codeword.device
            return self.ke.unpack(
                self.codeword[torch.tensor(idxs, dtype=torch.int64, device=dev)])
        return [self.codeword[i] for i in idxs]


@dataclass
class DeviceFriProof:
    """FRI proof with quotient coefficient vectors kept as (len, d) CPU
    tensors (host-tail rounds carry DensePolynomial quotients)."""

    ke: object
    points: List
    queries: List
    quotients: List  # [round][query] -> tensor | DensePolynomial

    def to_host(self) -> FriProof:
        q = []
        for round_q in self.quotients:
            q.append([self.ke.unpack(item) if isinstance(item, torch.Tensor)
                      else item.to_vec() for item in round_q])
        return FriProof(points=self.points, queries=self.queries, quotients=q)
