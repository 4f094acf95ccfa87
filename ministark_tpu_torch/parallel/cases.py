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
from ..ops.field import get_ops, pack_u64, unpack_u64
from ..ops.leaf_hash import leaf_hash
from ..ops.ntt import get_ntt_fns
from ..ops.poly import eval_even_odd, fold_even_odd, synth_div_suffix
from ..ops.sha256 import merkle_inner_levels
from . import mesh as mesh_mod
from .fri_sharded import get_sharded_fri_fns
from .merkle_sharded import sharded_tree_digests
from .ntt_sharded import get_sharded_ntt_fns, select_ntt_fns, sharded_lde

PRIME = {"gl": GOLDILOCKS_FP, "bb": BABYBEAR_FP}
EXT = {"gl": GOLDILOCKS_FP2, "bb": BABYBEAR_FP4}
STARK = {"gl": Goldilocks, "bb": BabyBear}
KINDS = ("fft", "ifft", "coset_fft", "coset_ifft")


def _t(mesh, a) -> torch.Tensor:
    return _t_on(mesh.device, a)


def _t_on(device, a) -> torch.Tensor:
    return pack_u64(np.asarray(a, dtype=np.uint64), device)


def _np(t: torch.Tensor) -> np.ndarray:
    return unpack_u64(t).copy()


def _collectives(before: dict) -> int:
    return sum(mesh_mod.collectives.values()) - sum(before.values())


def ntt(mesh, field, n, x, kind="fft", offset=None, backend="radix2"):
    """(sharded, single-device) ``kind`` transform of (batch, n) x."""
    F = PRIME[field]
    i = KINDS.index(kind)
    args = (_t(mesh, x),) + (() if offset is None else (offset,))
    sharded = get_sharded_ntt_fns(F, n, mesh, backend)[i](*args)
    return _np(sharded), _np(get_ntt_fns(F, n, backend)[i](*args))


def select_ntt(mesh, field, n, x):
    """(fft of x through ``select_ntt_fns``, the collectives it called):
    a size that does not split over the mesh runs on one device."""
    before = dict(mesh_mod.collectives)
    out = select_ntt_fns(PRIME[field], n, mesh)[0](_t(mesh, x))
    return _np(out), _collectives(before)


def lde(mesh, field, x, domain_size):
    """(``sharded_lde`` of (batch, m) x, one device's fft of x zero-padded)."""
    F = PRIME[field]
    xt = _t(mesh, x)
    padded = torch.zeros((xt.shape[0], domain_size), dtype=torch.int64, device=mesh.device)
    padded[:, :xt.shape[1]] = xt
    return (_np(sharded_lde(F, xt, domain_size, mesh)),
            _np(get_ntt_fns(F, domain_size)[0](padded)))


def ntt_roundtrip(mesh, field, n, x, offset):
    """(ifft(fft(x)), coset_ifft(coset_fft(x, s), 1/s)), both sharded."""
    F = PRIME[field]
    fft, ifft, cfft, cifft = get_sharded_ntt_fns(F, n, mesh)
    xt = _t(mesh, x)
    return _np(ifft(fft(xt))), _np(cifft(cfft(xt, offset), F.inv(offset)))


def fri(mesh, field, n, coeffs, alpha, z):
    """The sharded fold / deep / divide of (n, d) extension coefficients
    and their single-device twins (``ops/poly.py``), as
    {name: (sharded, single)}."""
    E = EXT[field]
    k = get_ops(E)
    fns = get_sharded_fri_fns(E, n, mesh)
    c = _t(mesh, coeffs)
    ap, zp = k.pack_scalar(alpha, mesh.device), k.pack_scalar(z, mesh.device)
    zinv = k.pack_scalar(E.inv(z), mesh.device)
    fe, fo = fns["deep"](c, zp)
    se, so = eval_even_odd(k, c, zp)
    q = synth_div_suffix(k, c, zp, zinv)
    q = torch.cat([q, torch.zeros_like(q[:1])], 0)
    return {"fold": (_np(fns["fold"](c, ap)), _np(fold_even_odd(k, c, ap))),
            "deep": (_np(torch.stack([fe, fo])), _np(torch.stack([se, so]))),
            "divide": (_np(fns["divide"](c, zp, zinv)), _np(q))}


def tree(mesh, field, comps, leafs_per_node, fmt):
    """(sharded, single-device) digests of every level of the fan-2 tree
    over (n, C) leaf components."""
    from ..ops.leaf_hash import digits_for

    md = digits_for(PRIME[field])
    c = _t(mesh, comps)
    leaf = leaf_hash(c, leafs_per_node, fmt, md)
    single = torch.cat([leaf, merkle_inner_levels(leaf)], 0)
    return (sharded_tree_digests(c, leafs_per_node, fmt, mesh, md).cpu().numpy(),
            single.cpu().numpy())


def index_tree(mesh, comps, arity):
    """(sharded, single-device) digests of the index tree over (n, C) rows."""
    from ..commit.index_tree import _build_digests, _build_digests_sharded

    c = _t(mesh, comps)
    return (_build_digests_sharded(c, arity, mesh).cpu().numpy(),
            _build_digests(c, arity).cpu().numpy())


def _trace(model, sf, steps, device):
    if model == "mimc":
        from ..models.mimc import mimc_device_trace

        return mimc_device_trace(sf, steps, device=device)
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
    """The prove core's (lde, mixed, folded) as numpy arrays: sharded
    (``make_sharded_prove_core``) over ``mesh``, or with ``mesh`` None the
    single core with shift 1 on ``device``, the sharded core's twin. The
    columns and weights are u64 arrays, the model's own columns and 5^i
    unless given."""
    from ..stark.core import make_prove_core, make_sharded_prove_core

    sf, dev = STARK[field], _device(mesh, device)
    single, example = make_prove_core(sf, n, _builder(model), device=dev)
    c0, _, w0 = example()
    c = c0 if cols is None else _t_on(dev, cols)
    w = w0 if weights is None else _t_on(dev, weights)
    if mesh is None:
        out = single(c, 1, w)
    else:
        out = make_sharded_prove_core(sf, n, mesh, _builder(model))(c, w)
    return tuple(_np(t) for t in out)


def fold_deep(mesh, field, coeffs, alpha, z, device=None):
    """(folded, f_even(z), f_odd(z)) of (n, d) extension coefficients:
    ``make_sharded_fold_fns`` over ``mesh``, or with ``mesh`` None
    ``ops/poly.py``'s fold_even_odd and eval_even_odd on ``device``."""
    from .fri_sharded import make_sharded_fold_fns

    E, dev = EXT[field], _device(mesh, device)
    k = get_ops(E)
    c = _t_on(dev, coeffs)
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


def ldt(mesh, backend, n=1 << 10, device=None):
    """(the proof's fields, collectives it called) of a standalone STIR or
    WHIR prove (``backend``) over two random Goldilocks Fp2 polynomials of
    n coefficients from ``ark_test_rng``, in ``__graft_entry__.py:215-260``'s
    configuration (k 4, blowup 2, security 8, final length 16): sharded
    over ``mesh``, or on one device, ``device``, when ``mesh`` is None."""
    from ..fri.stir import Stir, StirConfig
    from ..fri.whir import Whir, WhirConfig
    from ..utils.rng import ark_test_rng

    ext, dev = GOLDILOCKS_FP2, _device(mesh, device)
    rng = ark_test_rng()
    polys = get_ops(ext).pack([ext.rand(rng) for _ in range(2 * n)], dev)
    polys = polys.reshape(2, n, 2)
    cls, cfg = {"stir": (Stir, StirConfig), "whir": (Whir, WhirConfig)}[backend]
    before = dict(mesh_mod.collectives)
    proof = cls(cfg(ext, k=4, blowup=2, security_bits=8, final_len=16),
                mesh=mesh).prove(polys)
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
