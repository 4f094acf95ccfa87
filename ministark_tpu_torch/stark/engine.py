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
                                            (leaf-hash and SHA-256 kernels);
                                            host-tail FRI rounds ->
                                            commit/native.py (C++, SHA-NI)
  mixing / folding / division / DEEP     -> ops/poly.py (torch ops)

Only protocol-inherent sequential state (the Fiat-Shamir sponge, challenge
scalars, proof assembly) touches host scalars. The device is explicit:
``DeviceEngine(config, device="cuda")`` by default, and the constructor
raises on a host without a card (the CPU is used only when asked for with
``device="cpu"``); a tensor handed in on another device is moved there
once. ``ntt_backend`` ("radix2", "four_step" or "pipe", ops/ntt.py) chooses
the NTT kernels; it is not part of the config and changes no proof byte.
``mesh`` (a ``parallel.Mesh``, every rank proving the same trace) keeps
the prove row-sharded (``parallel/__init__.py``): rank r slices its block
[r*n/D, (r+1)*n/D) of the trace once and holds every stage tensor so (the
trace tree, the trace iFFT, the transitions, the LDE and the constraint
tree, the mix, every FRI round's coefficients, codeword and tree) until a
stage's size stops splitting by the JAX package's size rules
(``block_ntt_fits``, ``can_shard_tree``, ``_fri_sharded``); there the
blocks are gathered once and every rank goes on with one device's code on
the whole. A trace stage that does not split proves so from the start; the
verifier's iFFT stays sharded, replicated in and out. The query phase
reads codeword values, path digests and leaf groups from their owners and
gathers the quotients to the host in chunks. Every rank returns the proof
of one device, byte for byte.

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

from ..commit import native
from ..commit.packed_tree import BlockMerkleTree, PackedMerkleTree, to_leaf_comps
from ..fri.fri import Fri, FriProof, FriRound as HostFriRound
from ..ops.field import get_ops, lift_base_array, pack_words
from ..ops.ntt import check_backend, get_ntt_fns
from ..ops.div_scan import div_scan
from ..ops.poly import effective_len, eval_even_odd, eval_many, mix_columns
from ..parallel.fri_sharded import get_block_fri_fns
from ..parallel.merkle_sharded import can_shard_tree
from ..parallel.mesh import Rows, all_gather_rows, field_sum_over_ranks, gather_to_host
from ..parallel.mesh import max_over_ranks, owner_select
from ..parallel.ntt_sharded import block_ntt_fits, get_block_ntt_fns, select_ntt_fns
from ..poly import DensePolynomial, Radix2EvaluationDomain
from ..transcript.merlin import Arthur, Merlin
from ..utils import LeafNotFound
from .stark import StarkConfig, StarkProof

# Below this codeword size the FRI tail runs on host scalars; proof bytes
# are identical at any value (tests set it to 1 to force the tensor path).
DEVICE_MIN_SIZE = 1 << 13


def merge_query_phases(phases: dict) -> dict:
    """``phase_seconds`` with the per-round query labels summed: those of
    an engine made with ``query_split`` (``fri_query_round_<i>_<kind>``) into
    ``fri_query_host`` (index and point arithmetic, proof assembly, host-tail
    rounds), ``fri_query_device`` (gathers, quotients, the leaf search) and
    ``fri_query_copy`` (the pulls to the host), the single label per round
    of any other engine into ``fri_query``; every other label as it is."""
    out = {}
    for label, secs in phases.items():
        if label.startswith("fri_query_round_"):
            kind = label.rsplit("_", 1)[1]
            label = "fri_query" if kind.isdigit() else "fri_query_" + kind
        out[label] = out.get(label, 0.0) + secs
    return out


@dataclass
class DeviceTrace:
    """Tensor-native TraceTable equivalent.

    ``cols``: (width, N) u64 numpy array of column evaluations over the
    trace domain (rows >= steps carry the deterministic ZK padding), OR
    ``cols_dev``: the same data as a (width, N) tensor in the field's dtype (int64 Goldilocks, int32 BabyBear; witness built
    on the device). ``transitions`` map the (width, N) trace-polynomial
    coefficient tensor to one (N,) constraint coefficient tensor. Each
    takes a keyword ``rows`` (default None): the resident prove on a mesh
    calls ``f(tp, rows=rows)`` with ``rows`` a ``parallel.Rows`` and tp
    this rank's (width, N/D) block of the coefficients [rows.lo, rows.lo +
    rows.count), and wants the same block of the output. A transition that
    acts on each coefficient alone ignores ``rows``; one that does not (a
    constant at x^0, a product of evaluations) reads its block's place from
    ``rows`` and its transforms from ``get_block_ntt_fns(field, N,
    rows.mesh)`` (models/counter.py, models/mimc.py)."""

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
    # the tree of a host-tail FRI round (a codeword under DEVICE_MIN_SIZE):
    # the native engine, as the JAX engine's PackedMerkleTree.from_scalars
    # (ministark_tpu/stark/engine.py:694); any builder with MerkleTree's
    # signature gives the same bytes (scripts/torch_ab_prove.py --tail sets
    # the hashlib MerkleTree on one engine to time the two)
    tail_tree = staticmethod(native.merkle_tree)

    def __init__(self, config: StarkConfig, device="cuda",
                 ntt_backend: str = "radix2", query_split: bool = False,
                 mesh=None):
        self.config = config
        self.device = torch.device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh's ranks are on {mesh.device}, the "
                             f"engine on {self.device}")
        self.mesh = mesh
        self.ntt_backend = check_backend(ntt_backend)
        # report each query round as three phases (host, device, copy)
        # instead of one: about six more device synchronizes a round, so
        # only a measuring caller asks for it; the proof is the same bytes
        self.query_split = query_split
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

    def _tq(self, label: str, kind: str):
        """Within query round ``label``, open its ``kind`` part (``host``,
        ``device`` or ``copy``) when the engine splits the query report."""
        if self.query_split:
            self._t(f"{label}_{kind}")

    # ------------------------------------------------------------------ utils
    def _ntt(self, n: int):
        """(fft, ifft, coset_fft, coset_ifft) over the base field for size
        n on one device: the prove's whole tensors (with no mesh, or where
        a stage stops splitting and every rank holds the whole)."""
        return get_ntt_fns(self.config.stark_field.base, n, self.ntt_backend)

    def _fri_splits(self, n: int) -> bool:
        """Fold / deep / divide of n coefficients split over the mesh (the
        JAX engine's ``_fri_sharded`` rule, ``ministark_tpu/stark/engine.py:179``)."""
        n_dev = self.mesh.size
        m = n // n_dev if n % n_dev == 0 else 0
        return not (m < 2 or m % 2 or m & (m - 1))

    def _block_ntt(self, n: int):
        """(fft, ifft, coset_fft, coset_ifft) on this rank's blocks."""
        return get_block_ntt_fns(self.config.stark_field.base, n, self.mesh,
                                 self.ntt_backend)

    def _tree_splits(self, n_elems: int, k: int) -> bool:
        return (n_elems % k == 0 and n_elems // k > 1
                and can_shard_tree(n_elems, k, self.mesh.size))

    def _trace_rows(self, trace: DeviceTrace):
        """The rows of the trace domain this rank holds (``parallel.Rows``)
        when the trace stage splits over the mesh (the trace iFFT, the
        padded LDE and both trees), else None: every rank proves the whole
        with one device's code."""
        if self.mesh is None:
            return None
        cfg, D = self.config, self.mesh.size
        n, k = trace.domain_size, cfg.merkle_config.leafs_per_node
        lde_n = cfg.blowup_factor * n
        if (block_ntt_fits(n, n, D) and block_ntt_fits(lde_n, n, D)
                and self._tree_splits(n * trace.width, k)
                and self._tree_splits(lde_n * trace.constrain_number(), k)):
            return Rows(self.mesh, n)
        return None

    def _round_splits(self, m: int, size: int) -> bool:
        """A device FRI round of m coefficients and ``size`` points stays
        resident: its codeword's NTT, its tree and its fold / deep /
        divide all split over the mesh."""
        k = self.config.fri_config.merkle_config.leafs_per_node
        return (block_ntt_fits(size, m, self.mesh.size) and self._tree_splits(size, k)
                and self._fri_splits(m))

    def _tree(self, field, vals, mcfg, rows):
        if rows is None:
            return PackedMerkleTree(field, vals, mcfg)
        return BlockMerkleTree(field, vals, mcfg, self.mesh)

    def _whole(self, block, rows) -> torch.Tensor:
        """This rank's block -> the whole tensor on every rank: the one
        gather where a stage stops splitting."""
        return all_gather_rows(self.mesh, block).reshape((rows.n,) + tuple(block.shape[1:]))

    def _host_coeffs(self, coeffs, rows) -> list:
        """(m, d) coefficients (whole, or this rank's block of ``rows``)
        -> host scalars, trimmed: the handoff to the host tail, whose
        gather goes to host memory in chunks."""
        eff = effective_len(coeffs, rows)
        if rows is not None:
            coeffs = gather_to_host(self.mesh, coeffs, eff, kind="all_gather")
        return self.ke.unpack(coeffs[:eff])

    def _cols(self, trace: DeviceTrace) -> torch.Tensor:
        """(width, N) column evaluations on the engine's device, in the base
        field's dtype (a device trace of another raises)."""
        if trace.cols_dev is not None:
            if trace.cols_dev.dtype != self.kb.dtype:
                raise ValueError(f"trace columns are {trace.cols_dev.dtype}, the "
                                 f"field is held in {self.kb.dtype}")
            return trace.cols_dev.to(self.device)
        return pack_words(trace.cols, self.kb.dtype, self.device)

    def _trace_polys(self, trace: DeviceTrace) -> torch.Tensor:
        """(width, N) evaluations -> (width, N) coefficients, whole on every
        rank (the iFFT sharded over the mesh where the size splits)."""
        return select_ntt_fns(self.config.stark_field.base, trace.domain_size,
                              self.mesh, self.ntt_backend)[1](self._cols(trace))

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
        # on a mesh: this rank's rows of the trace domain, or None
        rows = self._trace_rows(trace)
        # 1.1 trace commitment over the row-major trace; leafs_per_node is
        # the constraint count (6), so one leaf group spans two rows
        cols = self._cols(trace)
        if rows is not None:
            cols = rows.take(cols, 1)                                # (w, n/D)
        trace_tree = self._tree(base, cols.T.contiguous().reshape(-1),
                                cfg.merkle_config, rows)
        trace_commit = trace_tree.root()
        del trace_tree
        merlin.add_bytes(trace_commit)

        self._t("lde")
        # 1.2 LDE of all constraint polynomials
        lde_n = cfg.blowup_factor * n
        random_shift = merlin.challenge_scalar(base)
        if rows is None:
            trace_poly = self._ntt(n)[1](cols)                       # (w, n)
            del cols
            all_coeffs = torch.cat(
                [trace_poly] + [f(trace_poly)[None] for f in trace.transitions], 0)
            del trace_poly
            padded = torch.zeros((all_coeffs.shape[0], lde_n), dtype=all_coeffs.dtype,
                                 device=dev)
            padded[:, :n] = all_coeffs
            lde_evals = self._ntt(lde_n)[2](padded, random_shift)    # (w+t, 2n)
            del padded
        else:
            # blocks: (w, n/D) coefficients, transitions on their blocks,
            # the LDE from n/D coefficients to its 2n/D points (the zero
            # padding is taken in by the block NTT, never built)
            trace_poly = self._block_ntt(n)[1](cols)
            del cols
            all_coeffs = torch.cat([trace_poly] + [
                f(trace_poly, rows=rows)[None] for f in trace.transitions], 0)
            del trace_poly
            lde_evals = self._block_ntt(lde_n)[2](all_coeffs, random_shift)
        total = all_coeffs.shape[0]

        self._t("constrain_tree")
        constrain_tree = self._tree(base, lde_evals.T.contiguous().reshape(-1),
                                    cfg.merkle_config, rows)
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
        lo = 0 if rows is None else rows.lo
        all_evals = torch.stack([eval_many(ke, ext_coeff_arr, ke.pack_scalar(q, dev), lo)
                                 for q in queries])                  # (Q, w+t, d)
        if rows is not None:        # the blocks' partial sums, added up
            all_evals = field_sum_over_ranks(ke, self.mesh, all_evals)
        constrain_queries, validity_queries = [], []
        for qi in range(len(queries)):
            evals = ke.unpack(all_evals[qi])
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
        fri_proof = self._fri_prove(merlin, ext_mixed, rows)

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
        comp = torch.zeros((coeffs.shape[1], domain_size), dtype=coeffs.dtype,
                           device=coeffs.device)
        comp[:, :coeffs.shape[0]] = coeffs.T
        return self._ntt(domain_size)[0](comp).T.contiguous()

    def _fri_prove(self, merlin: Merlin, poly_coeffs, rows=None) -> "DeviceFriProof":
        """Hybrid FRI: tensors for large rounds, host scalars for the
        geometric tail (< DEVICE_MIN_SIZE); identical bytes either way.
        ``rows``: the rows of ``poly_coeffs`` this rank holds, on a mesh."""
        cfg = self.config.fri_config
        ext = self.config.stark_field.extension
        ke = self.ke

        degree = max(effective_len(poly_coeffs, rows) - 1, 0)
        size = (degree + 1) * cfg.blowup_factor

        rounds: List[_FriRoundRepr] = [self._make_round(poly_coeffs, size, rows)]
        cur = rounds[0]
        for ri in range(1, cfg.rounds):
            self._t(f"fri_round_{ri}_size{cur.size}")
            z = merlin.challenge_scalar(ext)
            fe_z, fo_z = self._deep_evals(cur, z)
            merlin.add_scalars(ext, [fe_z, fo_z])

            alpha = merlin.challenge_scalar(ext)
            deep_value = ext.add(fe_z, ext.mul(alpha, fo_z))
            round_coeffs, rows = self._fold_div(cur, z, alpha, deep_value)
            cur = self._make_round(round_coeffs, cur.size // 2, rows)
            merlin.add_bytes(cur.tree.root())
            rounds.append(cur)

        # ---- query phase
        raw = merlin.fill_challenge_bytes(8 * cfg.queries)
        betas = [int.from_bytes(raw[i * 8 : (i + 1) * 8], "little")
                 for i in range(cfg.queries)]
        points, queries, quotients = [], [], []
        for i in range(len(rounds) - 1):
            # one label per round, or with ``query_split`` three: ``_host``
            # (index and point arithmetic, proof assembly, host-tail rounds),
            # ``_device`` (gathers, quotients and the leaf search, up to the
            # synchronize) and ``_copy`` (the pulls and their unpacking)
            label = f"fri_query_round_{i}"
            self._t(label + "_host" if self.query_split else label)
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

            self._tq(label, "copy")
            next_reads = nxt.read_many(idxs_next)
            if prev.device:
                self._tq(label, "device")
                reads = prev.read_rows(idxs_prev)
                qs, effs = self._quotients_from_reads(prev, reads, xs)
                # proof search by the y1/y2 values, interleaved per query
                # [y1_0, y2_0, y1_1, ...], in the tree's leaf layout (§8.6)
                rows = torch.stack([reads[:nq], reads[nq:]], 1).reshape(2 * nq, -1)
                found = prev.tree.search_rows_async(to_leaf_comps(ext, rows))
                self._tq(label, "copy")
                sidx = [int(v) for v in found.cpu()]
                if any(ix >= prev.tree.n_leafs for ix in sidx):
                    # a missed search returns n_leafs: fail loudly instead
                    # of gathering past the end (a device-side fault)
                    raise LeafNotFound()
                self._tq(label, "device")
                handle = prev.tree.proofs_gather_async(sidx)
                self._tq(label, "copy")
                proofs = prev.tree.proofs_finish(handle)
                prev_reads = ke.unpack(reads)
                round_quotients = self._trim_quotients(qs, effs, prev.rows)
                self._tq(label, "host")
            else:
                self._tq(label, "host")
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
    def _make_round(self, coeffs, size: int, rows=None) -> "_FriRoundRepr":
        """coeffs: a tensor zero-padded to a power-of-two length (halving
        each round), whole or this rank's block of ``rows``, OR a trimmed
        host scalar list (tail rounds)."""
        ext = self.config.stark_field.extension
        mcfg = self.config.fri_config.merkle_config
        if isinstance(coeffs, list) or size < DEVICE_MIN_SIZE:
            if not isinstance(coeffs, list):
                coeffs = self._host_coeffs(coeffs, rows)
            codeword = Radix2EvaluationDomain(ext, size).fft(coeffs)
            return _FriRoundRepr(device=False, ke=self.ke, coeffs=coeffs,
                                 codeword=codeword,
                                 tree=self.tail_tree(ext, codeword, mcfg),
                                 size=size)
        if rows is not None and not self._round_splits(rows.n, size):
            coeffs, rows = self._whole(coeffs, rows), None         # the handoff
        if rows is None:
            codeword = self._ext_fft(coeffs[: min(size, coeffs.shape[0])], size)
        else:                       # (m/D, d) -> this rank's (size/D, d) points
            codeword = self._block_ntt(size)[0](coeffs.T.contiguous()).T.contiguous()
        return _FriRoundRepr(device=True, ke=self.ke, coeffs=coeffs,
                             codeword=codeword,
                             tree=self._tree(ext, codeword, mcfg, rows),
                             size=size, rows=rows)

    def _deep_evals(self, rnd: "_FriRoundRepr", z):
        ext = self.config.stark_field.extension
        if rnd.device:
            zp = self.ke.pack_scalar(z, self.device)
            if rnd.rows is not None:
                fe, fo = get_block_fri_fns(ext, rnd.rows.n, self.mesh)["deep"](
                    rnd.coeffs, zp)
            elif rnd.coeffs.shape[0] == 0:
                return ext.zero(), ext.zero()
            else:
                fe, fo = eval_even_odd(self.ke, rnd.coeffs, zp)
            both = self.ke.unpack(torch.stack([fe, fo]))   # one pull
            return both[0], both[1]
        parts = HostFriRound.split_poly(ext, DensePolynomial(ext, rnd.coeffs), 2)
        return parts[0].evaluate(z), parts[1].evaluate(z)

    def _fold_div(self, rnd: "_FriRoundRepr", z, alpha, deep_value):
        """One FRI round: fold even/odd, subtract the DEEP value at x^0,
        divide by (x - z), zero-pad to n/2 (``engine._fold_div_jit``).
        Returns the next round's coefficients and, when they stay resident,
        the rows this rank holds (else None)."""
        ext = self.config.stark_field.extension
        ke = self.ke
        pack = lambda v: ke.pack_scalar(v, self.device)  # noqa: E731
        coeffs, rows = rnd.coeffs, rnd.rows
        if rows is not None and not self._fri_splits(rows.n // 2):
            coeffs, rows = self._whole(coeffs, rows), None  # the halves stop splitting
        if rnd.device and not ext.is_zero(z):
            # fold, DEEP value off x^0 and division in one scan
            # (ops/div_scan.py): the quotient keeps the length n/2 with its
            # trailing slot zero
            zp, zinv, head = pack(z), pack(ext.inv(z)), pack(deep_value).unsqueeze(0)
            if rows is not None:
                # a resident round (ministark_tpu/stark/engine.py:738-752):
                # this rank's block of the quotient from its block of
                # coefficients
                half = Rows(self.mesh, rows.n // 2)
                rp = get_block_fri_fns(ext, half.n, self.mesh)["divide"](
                    coeffs, zp, zinv, head=head, fold=pack(alpha))
            else:
                half = None
                rp = div_scan(ke, coeffs.unsqueeze(0), zp.unsqueeze(0), zinv.unsqueeze(0),
                              head=head.unsqueeze(0), fold=pack(alpha))[0]
            # hand off to the host representation when the next round is small
            if rnd.size // 2 < DEVICE_MIN_SIZE:
                return self._host_coeffs(rp, half), None
            return rp, half
        if rnd.device:
            coeffs = self._host_coeffs(coeffs, rows)
        parts = HostFriRound.split_poly(ext, DensePolynomial(ext, coeffs), 2)
        folded = parts[0] + parts[1].scale(alpha)
        dv_poly = DensePolynomial(ext, [deep_value])
        denominator = DensePolynomial(ext, [ext.neg(z), ext.one()])
        return ((folded - dv_poly) / denominator).to_vec(), None

    def _quotients_from_reads(self, prev: "_FriRoundRepr", reads, xs):
        """All of one round's query quotients (f - line) / ((x - x1)(x - x2))
        as one batch, with the lines a*x + b derived on the device from the
        codeword reads (y1 = reads[:Q], y2 = reads[Q:2Q]):
        (Q, n0 - 1, d) quotients zero-padded past their effective lengths,
        and those lengths (Q,). A resident round gives this rank's block
        (Q, n0/D, d) of the quotients, from the batched block divide, with
        the line subtracted at x^0 and x^1 on rank 0's block and the
        lengths the most across the ranks."""
        ext = self.config.stark_field.extension
        ke = self.ke
        pc = prev.coeffs
        if prev.rows is None and pc.shape[0] < 2:
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

        # the one polynomial against Q lines b + a x, subtracted in the scan
        num = pc.unsqueeze(0).expand((Q,) + tuple(pc.shape))        # (Q, n0, d)
        head = torch.stack([b_s, a_s], 1)                            # (Q, 2, d)
        if prev.rows is None:       # each division's trailing slot zero
            q1 = div_scan(ke, num, x1_s, s1_s, head=head)            # (Q, n0, d)
            q2 = div_scan(ke, q1, x2_s, s2_s).narrow(1, 0, pc.shape[0] - 1)
        else:                       # blocks, the head on rank 0's
            divide = get_block_fri_fns(ext, prev.rows.n, self.mesh)["divide"]
            q2 = divide(divide(num, x1_s, s1_s, head=head), x2_s, s2_s)  # (Q, n0/D, d)
        nz = (q2 != 0).any(-1)
        idx = torch.arange(1, q2.shape[1] + 1, device=q2.device)
        effs = torch.where(nz, idx, torch.zeros_like(idx)).amax(1)
        if prev.rows is not None:
            effs = max_over_ranks(self.mesh, torch.where(effs > 0, effs + prev.rows.lo, effs))
        return q2, effs

    def _trim_quotients(self, qs, effs, rows=None):
        """Per-query quotient tensors on the host, each trimmed to its
        effective length; one pull of the longest prefix for the batch
        (a resident round's: gathered to host memory in chunks)."""
        effs = [int(e) for e in effs.cpu()]
        longest = max(effs + [0])
        if rows is None:
            arr = qs[:, :longest].cpu()
        else:
            arr = gather_to_host(self.mesh, qs.transpose(0, 1), longest)
            arr = arr[:longest].transpose(0, 1).contiguous()
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
    tree: object          # device: PackedMerkleTree; host: MerkleTree (native)
    size: int
    # on a mesh, the rows of the m coefficients this rank holds: coeffs is
    # its (m/D, d) block, codeword its (size/D, d) block, tree a
    # BlockMerkleTree; None when the round is whole on every rank
    rows: "Rows | None" = None

    def read_rows(self, idxs) -> torch.Tensor:
        """(len(idxs), d) codeword values at host indices, whole on every
        rank; a resident round's come from their owners."""
        idx = torch.tensor(idxs, dtype=torch.int64, device=self.codeword.device)
        if self.rows is None:
            return self.codeword[idx]
        m = self.codeword.shape[0]
        return owner_select(self.rows.mesh, self.codeword[idx % m], idx // m)

    def read_many(self, idxs):
        if self.device:
            return self.ke.unpack(self.read_rows(idxs))
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
