"""Fast-mode STARK: the parity protocol's structure on production-style
commitments (batched multi-poly FRI, 4/8-ary index trees).

Port of ``ministark_tpu/stark/fast.py`` with its three LDE backends
(``lde_backend``: batched FRI, STIR or WHIR): the same transcripts, proofs
and verifier checks (tests/test_torch_fast.py, test_torch_stir.py and
test_torch_whir.py hold the serialized proofs to the JAX package's byte for
byte). It keeps the reference's trust model — the verifier holds
the out-of-band constraint polynomials — and swaps the commitment layer:

  * ONE low-degree test (fri/batched.py, or fri/stir.py / fri/whir.py)
    across all w+t constraint polynomials plus the validity polynomial,
    rho-mixed on the device;
  * index-addressed Merkle trees with binary row hashing
    (commit/index_tree.py: the row-leaf and inner-level kernels);
  * index-addressed query openings.

Verifier checks:
  1. point checks at ``point_queries`` random extension points z_j: the
     prover ships all w+t evaluations, the verifier re-evaluates its own
     constraint polynomials and compares;
  2. the low-degree test's chain: low degree of the rho-mix of all committed
     polynomials, Merkle paths, fold consistency;
  3. row relation: at every FRI query index the opened row must equal the
     verifier's own LDE of the constraint polynomials, and validity ==
     sum_i r^i * f_i.

The device is explicit: ``FastStark(config, device="cuda")`` by default;
without a card the constructor raises. Traces on another device are moved
to the prover's once. ``ntt_backend`` ("radix2", "four_step" or "pipe",
ops/ntt.py) chooses the NTT kernels; it is not part of ``FastStarkConfig``
or the transcript and changes no proof byte. ``mesh`` (a ``parallel.Mesh``,
every rank proving the same traces) gives the same proof bytes on every
rank. The prove is resident where the trace stage splits
(``_trace_rows``), with every low-degree test: rank r takes its block
[r*n/D, (r+1)*n/D) of the trace columns and holds every stage tensor so,
from the block iFFT through the transitions (``rows=``), both commitments
(the block LDE to coset rows and ``BlockIndexTree``), the validity mix, the
point evaluations (block partial sums, added across the ranks) and the FRI
layers, STIR rounds or WHIR iterations until one stops splitting
(``fri/batched.py``, ``fri/stir.py``, ``fri/whir.py``). A trace stage that
does not split proves on one device's code on every rank, with no
collective. The verifier's iFFT (``_constraint_polys``) and binding LDE
are replicated in and out.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import torch

from ..fri.batched import BatchedFri, BatchedFriConfig, FastTranscript, _scalar_bytes
from ..fri.stir import Stir, StirConfig
from ..fri.whir import Whir, WhirConfig
from ..ops.field import get_ops, lift_base_array
from ..ops.ntt import check_backend, get_ntt_fns
from ..ops.poly import eval_many, field_sum
from ..parallel.mesh import Rows, field_sum_over_ranks
from ..parallel.ntt_sharded import block_ntt_fits, get_block_ntt_fns, select_ntt_fns
from .engine import DeviceTrace


@dataclass
class FastStarkConfig:
    stark_field: object
    steps: int
    queries: int = 32          # FRI query indices / STIR, WHIR security bits
    point_queries: int = 2     # random-point DEEP checks (each ~|ext|^-1)
    blowup: int = 2
    arity: int = 4             # Merkle fan-in
    fold_factor: int = 4       # FRI F-to-1 folds per layer / STIR, WHIR k
    final_len: int = 32
    lde_backend: str = "fri"   # "fri" | "stir" | "whir" (fri/{batched,stir,whir}.py)
    grinding_bits: int = 0     # PoW before query sampling (every backend)


@dataclass
class FastStarkProof:
    width: int
    transitions: int
    point_evals: List[List]            # [z_j][poly i] extension evaluations
    fri_proof: object                  # BatchedFriProof | StirProof | WhirProof
    n_traces: int = 1                  # batched multi-trace proofs (prove_many)

    def size_bytes(self) -> int:
        fp = self.fri_proof
        paths = [p for q in fp.batch_openings for p in q]
        if hasattr(fp, "round_openings"):      # STIR / WHIR backends
            paths += [p for rnd in fp.round_openings for p in rnd]
            roots = len(fp.group_roots) + len(fp.round_roots)
            scalars = len(fp.final_coeffs) + len(fp.betas)
            if hasattr(fp, "sumcheck"):        # WHIR sumcheck messages
                scalars += sum(3 * len(it) for it in fp.sumcheck)
        else:
            paths += [p for q in fp.layer_openings for p in q]
            roots = len(fp.group_roots) + len(fp.layer_roots)
            scalars = len(fp.final_coeffs)
        return (
            32 * roots
            + sum(len(p.row) + sum(len(g) for g in p.groups) for p in paths)
            + 16 * scalars
            + sum(16 * len(e) for e in self.point_evals)
        )


class FastStark:
    def __init__(self, config: FastStarkConfig, device="cuda",
                 ntt_backend: str = "radix2", mesh=None):
        if config.lde_backend not in ("fri", "stir", "whir"):
            raise ValueError(f"unknown LDE backend {config.lde_backend!r}")
        self.config = config
        self.device = torch.device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh's ranks are on {mesh.device}, the "
                             f"prover on {self.device}")
        self.mesh = mesh
        self.ntt_backend = check_backend(ntt_backend)
        # fails here, not mid-prove, when the device does not exist
        torch.empty(0, device=self.device)
        sf = config.stark_field
        self.base, self.ext = sf.base, sf.extension
        self.kb = get_ops(self.base)
        self.ke = get_ops(self.ext)
        if config.lde_backend == "fri":
            self.fri = BatchedFri(BatchedFriConfig(
                self.ext, blowup=config.blowup, queries=config.queries,
                arity=config.arity, fold_factor=config.fold_factor,
                final_len=config.final_len, grinding_bits=config.grinding_bits,
            ), ntt_backend=ntt_backend, mesh=mesh)
        else:
            ldt, ldt_config = {"stir": (Stir, StirConfig),
                               "whir": (Whir, WhirConfig)}[config.lde_backend]
            self.fri = ldt(ldt_config(
                self.ext, k=config.fold_factor, blowup=config.blowup,
                security_bits=config.queries, final_len=config.final_len,
                arity=config.arity, grinding_bits=config.grinding_bits,
            ), ntt_backend=ntt_backend, mesh=mesh)
        # wall seconds per phase of the latest prove; each boundary
        # synchronizes a CUDA device, so a phase owns its kernels' time
        self.phase_seconds: dict = {}
        self._t0 = None
        self._last_label = None

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

    def _transcript(self, width: int, n_transitions: int, n: int,
                    n_traces: int = 1) -> FastTranscript:
        c = self.config
        label = (b"fast-stark" if c.lde_backend == "fri"
                 else b"fast-stark/" + c.lde_backend.encode())
        tr = FastTranscript(label)
        tr.absorb(b"%d/%d/%d/%d/%d/%d/%d/%d/%d/%d" % (
            width, n_transitions, c.steps, n, c.queries, c.point_queries,
            c.blowup, c.arity, c.final_len, n_traces,
        ))
        return tr

    def _constraint_polys(self, trace: DeviceTrace) -> torch.Tensor:
        """trace -> (w+t, n) coefficient tensor on the prover's
        device: the trace polynomials ++ the transition outputs, whole on
        every rank (the iFFT sharded over the mesh where the size splits)."""
        ifft = select_ntt_fns(self.base, trace.domain_size, self.mesh, self.ntt_backend)[1]
        return self._polys(trace, ifft)

    def _polys(self, trace: DeviceTrace, ifft, rows: Rows = None) -> torch.Tensor:
        """The constraint polynomials through ``ifft``: whole, or with
        ``rows`` this rank's (w+t, n/D) block of their coefficients (from
        its block of the trace, built alone where the trace has a build
        function)."""
        kw = {} if rows is None else {"rows": rows}
        tp = ifft(trace.evals(self.kb.dtype, self.device, rows))
        return torch.cat([tp] + [f(tp, **kw)[None] for f in trace.transitions], 0)

    def _trace_rows(self, traces: List[DeviceTrace]):
        """The rows of the trace domain this rank holds (``parallel.Rows``)
        when the prove is resident: on a mesh, the trace iFFT and the
        low-degree test's LDE to coset rows split over it (their trees then
        split too). Else None."""
        if self.mesh is None:
            return None
        n, D = traces[0].domain_size, self.mesh.size
        if block_ntt_fits(n, n, D) and self.fri.block_fits(n, D):
            return Rows(self.mesh, n)
        return None

    def _point_evals(self, ext_coeffs: torch.Tensor, z, rows: Rows = None) -> list:
        """All polynomials of (B, n, d) at one host point, pulled once; with
        ``rows`` the blocks' partial sums, added across the ranks."""
        zp = self.ke.pack_scalar(z, ext_coeffs.device)
        if rows is None:
            return self.ke.unpack(eval_many(self.ke, ext_coeffs, zp))
        part = eval_many(self.ke, ext_coeffs, zp, start=rows.lo)
        return self.ke.unpack(field_sum_over_ranks(self.ke, rows.mesh, part))

    # ---------------------------------------------------------------- prove
    def prove(self, trace: DeviceTrace) -> FastStarkProof:
        return self.prove_many([trace])

    def prove_many(self, traces: List[DeviceTrace]) -> FastStarkProof:
        """B same-shape traces in ONE proof: every NTT, Merkle build and
        the FRI chain batch over all B*(w+t)+B polynomials."""
        ext, ke = self.ext, self.ke
        self.phase_seconds = {}
        self._t0 = None
        self._t("constraint_polys")
        B = len(traces)
        n = traces[0].domain_size
        assert all(t.domain_size == n for t in traces)
        # on a mesh: this rank's rows (resident), or None: one device's code
        rows = self._trace_rows(traces)
        if rows is not None:
            ifft = get_block_ntt_fns(self.base, n, self.mesh, self.ntt_backend)[1]
        else:
            ifft = get_ntt_fns(self.base, n, self.ntt_backend)[1]
        all_b = torch.stack([self._polys(t, ifft, rows) for t in traces])
        total, n_loc = int(all_b.shape[1]), int(all_b.shape[2])
        w = traces[0].width
        assert all(t.width == w for t in traces)
        tr = self._transcript(w, total - w, n, B)

        # 1. COMMIT the constraint polynomials, absorb, THEN draw challenges
        #    (nothing may be squeezed before the witness commitment binds).
        self._t("commit_witness")
        # (B(w+t), n, d), or this rank's (B(w+t), n/D, d) block
        ext_flat = lift_base_array(ke, all_b.reshape(B * total, n_loc))
        del all_b
        tree_w = self.fri.commit(ext_flat, rows)
        tr.absorb(tree_w.root())

        self._t("point_evals")
        r = tr.challenge_scalar(ext)
        weights = ke.pack([ext.pow(r, i) for i in range(total)], self.device)
        ext_3d = ext_flat.reshape((B, total, n_loc) + ke.elem_axes)
        validities = field_sum(                               # (B, n, d)
            ke, ke.mul(ext_3d, weights[:, None].expand_as(ext_3d)), axis=1)

        point_evals = []
        for _ in range(self.config.point_queries):
            z = tr.challenge_scalar(ext)
            evals = self._point_evals(ext_flat, z, rows)
            tr.absorb(b"".join(_scalar_bytes(ext, e) for e in evals))
            point_evals.append(evals)

        # 2. commit the validities (they depend on r), absorb, run the LDT
        self._t("commit_validities")
        tree_v = self.fri.commit(validities, rows)
        tr.absorb(tree_v.root())
        self._t("lde_prove")
        fri_proof = self.fri.prove(
            groups=[ext_flat, validities], trees=[tree_w, tree_v], transcript=tr, rows=rows,
        )
        self._t("end")
        return FastStarkProof(
            width=w, transitions=total - w,
            point_evals=point_evals, fri_proof=fri_proof, n_traces=B,
        )

    # --------------------------------------------------------------- verify
    def verify(self, constrain_coeffs: torch.Tensor, proof: FastStarkProof) -> bool:
        """``constrain_coeffs``: (w+t, n) out-of-band Constrains, as
        ``_constraint_polys`` produces them."""
        return self.verify_many([constrain_coeffs], proof)

    def verify_many(self, constrain_list, proof: FastStarkProof) -> bool:
        """Batched verification: one (w+t, n) out-of-band Constrains tensor
        per trace.

        Checks (in transcript order): witness commitment -> r -> point
        evaluations against the out-of-band polynomials -> validity
        commitment -> the batched FRI chain; then (a) every opened witness
        row equals the verifier's OWN LDE of the constraint polynomials at
        the queried coset points (binding the committed codewords to the
        real polynomials), and (b) each trace's opened validity value
        satisfies validity_i == sum_j r^j f_{i,j}."""
        ext, ke = self.ext, self.ke
        cfg = self.config
        B = proof.n_traces
        assert len(constrain_list) == B
        total = proof.width + proof.transitions
        n = int(constrain_list[0].shape[1])
        for cc in constrain_list:
            assert cc.shape[0] == total and int(cc.shape[1]) == n
        fp = proof.fri_proof
        assert fp.n == n, "FRI domain size mismatch"
        assert fp.group_sizes == [B * total, B], "unexpected commitment groups"
        tr = self._transcript(proof.width, proof.transitions, n, B)

        tr.absorb(fp.group_roots[0])
        r = tr.challenge_scalar(ext)
        stacked = torch.stack([cc.to(self.device) for cc in constrain_list])
        ext_coeffs = lift_base_array(ke, stacked.reshape(B * total, n))
        r_pows = [ext.pow(r, i) for i in range(total)]

        assert len(proof.point_evals) == cfg.point_queries
        for evals in proof.point_evals:
            z = tr.challenge_scalar(ext)
            mine = self._point_evals(ext_coeffs, z)
            assert len(evals) == B * total
            for a, b in zip(mine, evals):
                assert a == b, "point evaluation mismatch"
            tr.absorb(b"".join(_scalar_bytes(ext, e) for e in evals))

        tr.absorb(fp.group_roots[1])
        res = self.fri.verify(fp, transcript=tr)

        # (a) bind committed rows to the real polynomials: recompute the LDE
        # over the backend's layer-0 domain (one batched component NTT) and
        # compare at every opened point, with one gather
        N, F, lde = self.fri.binding_lde(ext_coeffs)   # (B(w+t), N, d)
        flat_idx = []
        for idx, _ in res.rows:
            flat_idx.extend(idx + t * (N // F) for t in range(F))
        gathered = lde[:, torch.tensor(flat_idx, dtype=torch.int64,
                                       device=lde.device)].cpu()
        for qi, (_idx, fvals) in enumerate(res.rows):
            for t in range(F):
                mine_rows = ke.unpack(gathered[:, qi * F + t])
                for i in range(B * total):
                    assert mine_rows[i] == fvals[t][i], "committed row mismatch"
                # (b) per-trace validity row relation
                for bi in range(B):
                    acc = ext.zero()
                    for j in range(total):
                        acc = ext.add(acc, ext.mul(r_pows[j],
                                                   fvals[t][bi * total + j]))
                    assert acc == fvals[t][B * total + bi], (
                        "validity row relation"
                    )
        return True
