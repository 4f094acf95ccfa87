"""Rank-side runs of the sharded paths, each beside its single-device twin.

``launch.run`` pickles the function a rank runs, so the functions that the
tests (tests/test_torch_sharded*.py, the ``cuda`` cases of
tests/test_torch_cuda.py) hand to a group live here, in a module that
imports without jax. Inputs arrive as numpy uint64 arrays (the u64 bit
patterns) and results leave as numpy arrays or proof bytes; tensors live
on ``mesh.device``.

    launch.run(cases.run, 4, "gloo", device="cpu", args=([
        ("fft", "ntt", dict(field="gl", n=256, x=x)),
        ("proof", "parity", dict(field="gl", steps=1023)),
    ],))            # -> per rank {"fft": (sharded, single), "proof": ...}

(``launch.run`` puts the ranks on the card unless ``device`` says
otherwise.) The proves (``parity``, ``fast``, ``ldt``) and ``core`` also
run on one device when ``mesh`` is None, on ``device`` (the CPU unless
given): ``entry.py::dryrun_multichip`` holds each rank against them. A case
that raises fails its rank, and ``launch.run`` then raises: every rank must
call the same collectives, so no case is skipped on one rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..fields import BABYBEAR_FP, BABYBEAR_FP4, GOLDILOCKS_FP, GOLDILOCKS_FP2
from ..fields import BabyBear, Goldilocks
from ..ops.field import get_ops, pack_words, unpack_u64
from ..ops.leaf_hash import leaf_hash
from ..ops.ntt import get_ntt_fns
from ..ops import div_scan as ds
from ..ops.poly import eval_even_odd, fold_even_odd
from ..ops.sha256 import merkle_inner_levels
from . import mesh as mesh_mod
from .fri_sharded import get_sharded_fri_fns
from .fri_sharded import get_block_fri_fns
from .merkle_sharded import sharded_tree_digests
from .mesh import Rows
from .ntt_sharded import get_block_ntt_fns, get_sharded_ntt_fns, select_ntt_fns, sharded_lde

PRIME = {"gl": GOLDILOCKS_FP, "bb": BABYBEAR_FP}
EXT = {"gl": GOLDILOCKS_FP2, "bb": BABYBEAR_FP4}
STARK = {"gl": Goldilocks, "bb": BabyBear}
KINDS = ("fft", "ifft", "coset_fft", "coset_ifft")


def _t(mesh, a, field="gl") -> torch.Tensor:
    return _t_on(mesh.device, a, field)


def _t_on(device, a, field="gl") -> torch.Tensor:
    """u64 values -> a tensor in the field's dtype (int64 "gl", int32 "bb")."""
    return pack_words(np.asarray(a, dtype=np.uint64), get_ops(PRIME[field]).dtype, device)


def _np(t: torch.Tensor) -> np.ndarray:
    return unpack_u64(t).copy()


def _collectives(before: dict) -> int:
    return sum(mesh_mod.collectives.values()) - sum(before.values())


def _received(before: dict) -> dict:
    return {k: v - before[k] for k, v in mesh_mod.received.items()}


def ntt(mesh, field, n, x, kind="fft", offset=None, backend="radix2"):
    """(sharded, single-device) ``kind`` transform of (batch, n) x."""
    F = PRIME[field]
    i = KINDS.index(kind)
    args = (_t(mesh, x, field),) + (() if offset is None else (offset,))
    sharded = get_sharded_ntt_fns(F, n, mesh, backend)[i](*args)
    return _np(sharded), _np(get_ntt_fns(F, n, backend)[i](*args))


def block_ntt(mesh, field, n, x, kind="fft", offset=None):
    """(this rank's block of the block-form ``kind`` transform of size n,
    one device's whole) for (batch, n_in) x, n_in <= n: the input is zero
    past n_in (the padded LDE when n_in < n), and the rank passes its
    block [r*n_in/D, (r+1)*n_in/D) of it."""
    F = PRIME[field]
    i = KINDS.index(kind)
    xt = _t(mesh, x, field)
    extra = () if offset is None else (offset,)
    got = get_block_ntt_fns(F, n, mesh)[i](Rows(mesh, xt.shape[1]).take(xt, 1), *extra)
    padded = torch.zeros((xt.shape[0], n), dtype=xt.dtype, device=mesh.device)
    padded[:, :xt.shape[1]] = xt
    return _np(got), _np(get_ntt_fns(F, n)[i](padded, *extra))


def block_fri(mesh, field, n, coeffs, alpha, z, zs):
    """The block fold, deep and divide of (n, d) extension coefficients:
    {"fold": this rank's block of the folded, "deep": (fe, fo), "divide":
    its block of the quotient by (x - z), "batch": its block of the
    batched divide of Q = len(zs) copies, copy q by (x - zs[q])}."""
    E = EXT[field]
    k = get_ops(E)
    dev = mesh.device
    fns = get_block_fri_fns(E, n, mesh)
    c = Rows(mesh, n).take(_t(mesh, coeffs, field))
    zp = k.pack_scalar(z, dev)
    fe, fo = fns["deep"](c, zp)
    zq = k.pack(list(zs), dev)
    zq_inv = k.pack([E.inv(v) for v in zs], dev)
    return {"fold": _np(fns["fold"](c, k.pack_scalar(alpha, dev))),
            "deep": _np(torch.stack([fe, fo])),
            "divide": _np(fns["divide"](c, zp, k.pack_scalar(E.inv(z), dev))),
            "batch": _np(fns["divide"](c.unsqueeze(0).repeat(len(zs), 1, 1), zq, zq_inv))}


def block_tree(mesh, field, vals, leafs_per_node, lookups):
    """(root, first-occurrence indices of ``lookups``, their paths) of the
    ``BlockMerkleTree`` over this rank's block of (n, d) extension values,
    and the same three of one device's ``PackedMerkleTree`` over the
    whole; paths as (leaf neighbours, digests) tuples."""
    from ..commit.merkle import MerkleTreeConfig
    from ..commit.packed_tree import BlockMerkleTree, PackedMerkleTree, to_leaf_comps

    E = EXT[field]
    v = _t(mesh, vals, field)
    cfg = MerkleTreeConfig(leafs_per_node, 2)
    rows = to_leaf_comps(E, _t(mesh, lookups, field))
    out = []
    for tree in (BlockMerkleTree(E, Rows(mesh, v.shape[0]).take(v), cfg, mesh),
                 PackedMerkleTree(E, v, cfg)):
        idxs = [int(i) for i in tree.search_rows_async(rows).cpu()]
        paths = tree.proofs_finish(tree.proofs_gather_async(idxs))
        out.append((tree.root(), idxs, [(tuple(p.leaf_neighbours), p.path) for p in paths]))
    return tuple(out)


def block_mismatch(mesh, n):
    """The phrases of the errors a block form raises, on every rank and
    before any collective, for a block of the wrong width and for rows
    that do not split over the mesh."""
    out = []
    x = torch.zeros((1, n // mesh.size - 1), dtype=torch.int64, device=mesh.device)
    for make, phrase in ((lambda: get_block_ntt_fns(GOLDILOCKS_FP, n, mesh)[0](x),
                          "does not fit"),
                         (lambda: Rows(mesh, n - 1), "do not split")):
        try:
            make()
        except ValueError as e:
            out.append(phrase if phrase in str(e) else str(e))
    return out


def select_ntt(mesh, field, n, x):
    """(fft of x through ``select_ntt_fns``, the collectives it called):
    a size that does not split over the mesh runs on one device."""
    before = dict(mesh_mod.collectives)
    out = select_ntt_fns(PRIME[field], n, mesh)[0](_t(mesh, x, field))
    return _np(out), _collectives(before)


def lde(mesh, field, x, domain_size):
    """(``sharded_lde`` of (batch, m) x, one device's fft of x zero-padded)."""
    F = PRIME[field]
    xt = _t(mesh, x, field)
    padded = torch.zeros((xt.shape[0], domain_size), dtype=xt.dtype, device=mesh.device)
    padded[:, :xt.shape[1]] = xt
    return (_np(sharded_lde(F, xt, domain_size, mesh)),
            _np(get_ntt_fns(F, domain_size)[0](padded)))


def ntt_roundtrip(mesh, field, n, x, offset):
    """(ifft(fft(x)), coset_ifft(coset_fft(x, s), 1/s)), both sharded."""
    F = PRIME[field]
    fft, ifft, cfft, cifft = get_sharded_ntt_fns(F, n, mesh)
    xt = _t(mesh, x, field)
    return _np(ifft(fft(xt))), _np(cifft(cfft(xt, offset), F.inv(offset)))


def fri(mesh, field, n, coeffs, alpha, z):
    """The sharded fold / deep / divide of (n, d) extension coefficients
    and their single-device twins, as {name: (sharded, single)}: the fold
    ``ops/poly.py``'s, deep and divide the plain versions of
    ``ops/div_scan.py`` (on the card too, so the kernels' block forms are
    held against them and not against the kernels' whole forms)."""
    E = EXT[field]
    k = get_ops(E)
    fns = get_sharded_fri_fns(E, n, mesh)
    c = _t(mesh, coeffs, field)
    ap, zp = k.pack_scalar(alpha, mesh.device), k.pack_scalar(z, mesh.device)
    zinv = k.pack_scalar(E.inv(z), mesh.device)
    fe, fo = fns["deep"](c, zp)
    c1, z1 = c.unsqueeze(0), zp.unsqueeze(0)
    se, so = (ds.pow_dot_plain(k, c1, z1, stride=2, offset=o)[0] for o in (0, 1))
    q = ds.div_scan_plain(k, c1, z1, zinv.unsqueeze(0))[0]     # its last slot is 0
    return {"fold": (_np(fns["fold"](c, ap)), _np(fold_even_odd(k, c, ap))),
            "deep": (_np(torch.stack([fe, fo])), _np(torch.stack([se, so]))),
            "divide": (_np(fns["divide"](c, zp, zinv)), _np(q))}


def tree(mesh, field, comps, leafs_per_node, fmt):
    """(sharded, single-device) digests of every level of the fan-2 tree
    over (n, C) leaf components."""
    from ..ops.leaf_hash import digits_for

    md = digits_for(PRIME[field])
    c = _t(mesh, comps, field)
    leaf = leaf_hash(c, leafs_per_node, fmt, md)
    single = torch.cat([leaf, merkle_inner_levels(leaf)], 0)
    return (sharded_tree_digests(c, leafs_per_node, fmt, mesh, md).cpu().numpy(),
            single.cpu().numpy())


def index_tree(mesh, comps, arity):
    """(sharded, single-device) digests of the index tree over (n, C) rows."""
    from ..commit.index_tree import _build_digests, _build_digests_sharded

    c = _t(mesh, comps)
    return (_build_digests_sharded(c, arity, mesh, c.dtype).cpu().numpy(),
            _build_digests(c, arity, c.dtype).cpu().numpy())


def _trace(model, sf, steps, device):
    if model == "mimc":
        from ..models.mimc import mimc_device_trace

        return mimc_device_trace(sf, steps, device=device)
    if model == "counter":
        from ..models.counter import counter_device_trace

        return counter_device_trace(sf, steps, on_device=True, device=device)
    if model == "lfsr":
        from ..models.lfsr import lfsr_device_trace

        return lfsr_device_trace(sf, steps, device=device)
    from ..models.fibonacci_device import fibonacci_device_trace

    return fibonacci_device_trace(sf, steps, on_device=True, device=device)


def _device(mesh, device=None):
    if mesh is not None:
        return mesh.device
    return torch.device("cpu" if device is None else device)


def _builder(model):
    """The trace builder of ``stark/core.py`` for a model name."""
    if model == "mimc":
        from ..models.mimc import mimc_device_trace

        return mimc_device_trace
    return None                                  # Fibonacci


def core(mesh, field, n, model="fibonacci", cols=None, weights=None, device=None):
    """The prove core's (lde, mixed, folded) as numpy arrays: this rank's
    blocks of the sharded core (``make_sharded_prove_core``) over ``mesh``
    (``core_whole`` joins the ranks'), or with ``mesh`` None the single
    core with shift 1 on ``device``, the sharded core's twin. The columns
    and weights are u64 arrays, the model's own columns and 5^i unless
    given."""
    from ..stark.core import make_prove_core, make_sharded_prove_core

    sf, dev = STARK[field], _device(mesh, device)
    single, example = make_prove_core(sf, n, _builder(model), device=dev)
    c0, _, w0 = example()
    c = c0 if cols is None else _t_on(dev, cols, field)
    w = w0 if weights is None else _t_on(dev, weights, field)
    if mesh is None:
        out = single(c, 1, w)
    else:
        out = make_sharded_prove_core(sf, n, mesh, _builder(model))(c, w)
    return tuple(_np(t) for t in out)


def core_whole(blocks):
    """Every rank's ``core`` blocks, in rank order -> the whole (lde, mixed,
    folded): the LDE joined along its points, the others along their
    coefficients."""
    return tuple(np.concatenate([b[i] for b in blocks], axis)
                 for i, axis in enumerate((1, 0, 0)))


def fold_deep(mesh, field, coeffs, alpha, z, device=None):
    """(folded, f_even(z), f_odd(z)) of (n, d) extension coefficients:
    ``make_sharded_fold_fns`` over ``mesh``, or with ``mesh`` None
    ``ops/poly.py``'s fold_even_odd and eval_even_odd on ``device``."""
    from .fri_sharded import make_sharded_fold_fns

    E, dev = EXT[field], _device(mesh, device)
    k = get_ops(E)
    c = _t_on(dev, coeffs, field)
    ap, zp = k.pack_scalar(alpha, dev), k.pack_scalar(z, dev)
    if mesh is None:
        folded, (fe, fo) = fold_even_odd(k, c, ap), eval_even_odd(k, c, zp)
    else:
        fold, deep = make_sharded_fold_fns(E, c.shape[0], mesh)
        folded, (fe, fo) = fold(c, ap), deep(c, zp)
    return _np(folded), _np(fe), _np(fo)


def parity(mesh, field, steps, model="fibonacci", device=None):
    """(proof JSON of the sharded parity prove, collectives it called);
    ``mesh`` None proves on one device, ``device`` (the CPU unless given)."""
    from ..stark import StarkConfig
    from ..stark.engine import DeviceEngine
    from ..stark.proof_io import proof_to_json

    sf, dev = STARK[field], _device(mesh, device)
    trace = _trace(model, sf, steps, dev)
    cfg = StarkConfig(sf, 20, 2, steps, trace.constrain_number())
    before = dict(mesh_mod.collectives)
    proof = DeviceEngine(cfg, device=dev, mesh=mesh).prove(trace)
    return proof_to_json(sf, proof), _collectives(before)


def resident_parity(mesh, field, steps, model="fibonacci", device_min_size=None):
    """The parity prove on a mesh as the residency tests read it: (proof
    JSON, collectives it called, bytes received by kind, the row counts of
    the blocks gathered whole where a stage stopped splitting).
    ``device_min_size`` sets the engine's DEVICE_MIN_SIZE for this prove,
    so that FRI rounds too small to split run on tensors."""
    from ..stark import engine as eng

    whole, default = eng.DeviceEngine._whole, eng.DEVICE_MIN_SIZE
    handoffs = []

    def counted(self, block, rows):
        handoffs.append(rows.n)
        return whole(self, block, rows)

    eng.DeviceEngine._whole = counted
    eng.DEVICE_MIN_SIZE = device_min_size or default
    before = dict(mesh_mod.received)
    try:
        proof, collectives = parity(mesh, field, steps, model)
    finally:
        eng.DeviceEngine._whole, eng.DEVICE_MIN_SIZE = whole, default
    return proof, collectives, _received(before), handoffs


def fast(mesh, field, steps, cfg, batch=1, model="fibonacci", device=None):
    """(proof bytes of the sharded fast prove of ``batch`` traces,
    collectives it called); ``cfg``: FastStarkConfig's keywords; ``mesh``
    None proves on one device, ``device`` (the CPU unless given)."""
    from ..stark.fast import FastStark, FastStarkConfig
    from ..stark.proof_io import fast_proof_to_bytes

    sf, dev = STARK[field], _device(mesh, device)
    traces = [_trace(model, sf, steps, dev) for _ in range(batch)]
    stark = FastStark(FastStarkConfig(sf, steps, **cfg), device=dev, mesh=mesh)
    before = dict(mesh_mod.collectives)
    proof = stark.prove_many(traces)
    return fast_proof_to_bytes(sf, proof), _collectives(before)


def witness_blocks(mesh, field, steps, model="fibonacci", mode="parity", cfg=None,
                   device=None):
    """A prove of a trace whose witness is built on the device on demand
    (``DeviceTrace.build``), as the witness tests read it: (proof bytes,
    the (lo, count) of every block the prove asked ``build`` for, whether
    the whole was built). ``mode`` "parity" (``DeviceEngine``) or "fast"
    (``FastStark`` with ``cfg``, FastStarkConfig's keywords); ``mesh`` None
    proves on one device, ``device`` (the CPU unless given)."""
    from ..stark import StarkConfig
    from ..stark.engine import DeviceEngine
    from ..stark.fast import FastStark, FastStarkConfig
    from ..stark.proof_io import fast_proof_to_bytes, proof_to_json

    sf, dev = STARK[field], _device(mesh, device)
    trace = _trace(model, sf, steps, dev)
    build, built = trace.build, []

    def counted(lo, count):
        built.append((lo, count))
        return build(lo, count)

    trace.build = counted
    if mode == "parity":
        cfg = StarkConfig(sf, 20, 2, steps, trace.constrain_number())
        proof = proof_to_json(sf, DeviceEngine(cfg, device=dev, mesh=mesh).prove(trace))
        proof = proof.encode()
    else:
        stark = FastStark(FastStarkConfig(sf, steps, **cfg), device=dev, mesh=mesh)
        proof = fast_proof_to_bytes(sf, stark.prove(trace))
    return proof, built, trace._cols_dev is not None


def block_coset_lde(mesh, field, polys, N, F, offset=None):
    """(this rank's block of the coset rows of the LDE of (B, m, d)
    extension ``polys`` over N points, one device's whole coset rows), both
    (rows, B, F, d) as ``BatchedFri._coset_rows`` lays them out: the
    resident commitment's LDE (``BatchedFri._block_tree``'s) against
    ``_fft_batched``; with ``offset`` over the coset offset * <w_N>, STIR's
    and WHIR's."""
    from ..fri.batched import BatchedFri, BatchedFriConfig

    bf = BatchedFri(BatchedFriConfig(EXT[field], fold_factor=F))
    p = _t(mesh, polys, field)
    block = bf._block_coset_rows(Rows(mesh, p.shape[1]).take(p, 1), N, mesh, offset)
    return _np(block), _np(bf._coset_rows(bf._fft_batched(p, N, offset), F))


def block_ldt_ops(mesh, field, coeffs, pts, ans, roots, r_cor, start_pts):
    """STIR's and WHIR's block pieces on this rank's block of the (n, d)
    extension ``coeffs``: {"eval_points": the block partials of ``pts``
    added across the ranks (whole values), "quot_degcor": this rank's
    block of the quotient by the points ``roots`` with degree correction
    (``ans`` the interpolant's coefficients, ``r_cor`` a host scalar),
    "sumcheck_evals": the block partials of the even/odd halves at
    ``start_pts``, added across the ranks}. Points are u64 arrays (m, d)."""
    from ..fri.stir import eval_points, quot_degcor_block
    from ..fri.whir import sumcheck_evals
    from .mesh import field_sum_over_ranks

    E = EXT[field]
    k = get_ops(E)
    rows = Rows(mesh, len(coeffs))
    c = rows.take(_t(mesh, coeffs, field))
    roots_t = _t(mesh, roots, field)
    scales = k.pack([E.inv(x) for x in k.unpack(roots_t)], mesh.device)
    r = k.unpack(_t(mesh, [r_cor], field))[0]
    rpows = k.pack([E.pow(r, j) for j in range(len(roots) + 1)], mesh.device)
    ev = eval_points(k, c, _t(mesh, pts, field), start=rows.lo)
    sc = sumcheck_evals(k, c, _t(mesh, start_pts, field), start=rows.lo // 2)
    return {"eval_points": _np(field_sum_over_ranks(k, mesh, ev)),
            "quot_degcor": _np(quot_degcor_block(E, c, _t(mesh, ans, field), roots_t, scales,
                                                 rpows, rows)),
            "sumcheck_evals": _np(field_sum_over_ranks(k, mesh, sc))}


def block_index_tree(mesh, rows, arity, idxs):
    """The ``BlockIndexTree`` over this rank's block of (n, C) u64 rows
    against one device's ``IndexMerkleTree``: {"block": (root, every
    level's digests gathered in the one-device layout, the paths of
    ``idxs`` as (row, groups)), "single": the same three}."""
    from ..commit.index_tree import BlockIndexTree, IndexMerkleTree
    from .merkle_sharded import gather_levels

    c = _t(mesh, rows)
    out = {}
    block = BlockIndexTree(Rows(mesh, c.shape[0]).take(c), arity, mesh, dtype=c.dtype)
    sizes = block._local_sizes
    local = gather_levels(mesh, list(torch.split(block._local, sizes))) if sizes else []
    for key, tree, digests in (
            ("block", block, torch.cat(local + block._top, 0)),
            ("single", IndexMerkleTree(c, arity, dtype=c.dtype), None)):
        digests = tree._digests if digests is None else digests
        out[key] = (tree.root(), digests.cpu().numpy(),
                    [(p.row, tuple(p.groups)) for p in tree.open_many(list(idxs))])
    return out


def resident_fast(mesh, field, steps, cfg, batch=1):
    """The fast prove on a mesh as the residency tests read it: (proof
    bytes, collectives, bytes received by kind, the events of the prove in
    order: ("handoff", rows gathered) where a FRI layer, STIR round or
    WHIR iteration stops splitting or the final coefficients are gathered,
    ("fft", points) and ("tree", rows) for each call of
    ``BatchedFri._fft_batched`` and ``IndexMerkleTree`` on a whole
    tensor). ``cfg["lde_backend"]`` picks the low-degree test."""
    from ..commit.index_tree import IndexMerkleTree
    from ..fri.batched import BatchedFri

    whole, fft, tree = BatchedFri._whole, BatchedFri._fft_batched, IndexMerkleTree.__init__
    events = []

    def counted_whole(self, block, rows):
        events.append(("handoff", rows.n))
        return whole(self, block, rows)

    def counted_fft(self, coeffs, domain_size, offset=None):
        events.append(("fft", domain_size))
        return fft(self, coeffs, domain_size, offset)

    def counted_tree(self, comps, *args, **kw):
        events.append(("tree", int(comps.shape[0])))
        return tree(self, comps, *args, **kw)

    BatchedFri._whole, BatchedFri._fft_batched = counted_whole, counted_fft
    IndexMerkleTree.__init__ = counted_tree
    before = dict(mesh_mod.received)
    try:
        proof, collectives = fast(mesh, field, steps, cfg, batch)
    finally:
        BatchedFri._whole, BatchedFri._fft_batched = whole, fft
        IndexMerkleTree.__init__ = tree
    return proof, collectives, _received(before), events


def ldt(mesh, backend, n=1 << 10, device=None):
    """(the proof's fields, collectives it called) of a standalone STIR or
    WHIR prove (``backend``) over two random Goldilocks Fp2 polynomials of
    n coefficients from ``ark_test_rng``, in ``__graft_entry__.py:215-260``'s
    configuration (k 4, blowup 2, security 8, final length 16): resident
    on ``mesh`` (each rank proves from its block of the coefficients) where
    the L_0 commitment splits over it, else on one device, ``device`` when
    ``mesh`` is None."""
    from ..fri.stir import Stir, StirConfig
    from ..fri.whir import Whir, WhirConfig
    from ..utils.rng import ark_test_rng

    ext, dev = GOLDILOCKS_FP2, _device(mesh, device)
    rng = ark_test_rng()
    polys = get_ops(ext).pack([ext.rand(rng) for _ in range(2 * n)], dev)
    polys = polys.reshape(2, n, 2)
    cls, cfg = {"stir": (Stir, StirConfig), "whir": (Whir, WhirConfig)}[backend]
    before = dict(mesh_mod.collectives)
    prover = cls(cfg(ext, k=4, blowup=2, security_bits=8, final_len=16))
    rows = Rows(mesh, n) if mesh is not None and prover.block_fits(n, mesh.size) else None
    proof = prover.prove(polys if rows is None else rows.take(polys, 1), rows=rows)
    paths = [p for q in proof.batch_openings for p in q]
    paths += [p for rnd in proof.round_openings for p in rnd]
    fields = (proof.group_roots, proof.round_roots, proof.betas,
              getattr(proof, "sumcheck", None), proof.final_coeffs,
              [(p.row, tuple(p.groups)) for p in paths])
    return fields, _collectives(before)


def fail_on_rank(mesh, rank, hang=False):
    """Rank ``rank`` raises (or, with ``hang``, sleeps for an hour); the
    others wait in a gather it never joins."""
    if mesh.rank == rank:
        if hang:
            time.sleep(3600)
        raise ValueError(f"rank {rank} fails on purpose")
    return mesh_mod.all_gather_rows(mesh, torch.zeros(1, dtype=torch.int64,
                                                      device=mesh.device))


def run(mesh, cases):
    """[(key, case name, keywords)] -> {key: that case's result}, in order."""
    return {key: globals()[name](mesh, **kw) for key, name, kw in cases}
