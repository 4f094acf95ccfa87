"""Carry data between the JAX package's packed layout and this package.

``ministark_tpu`` packs a Goldilocks element as two u32 words [lo, hi]: a
numpy/JAX u32 array of shape (..., 2) for the base field and (..., 2, 2)
for Fp2; a BabyBear element is one u32 word: (...) for the base field and
(..., 4) for Fp4 (``ministark_tpu/ops/registry.py``). This package holds
every element component as one int64: (...) for a base field, (..., 2) for
Goldilocks Fp2 and (..., 4) for BabyBear Fp4. Nothing here imports jax:
arrays cross as numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _limbed(field) -> bool:
    """True for Goldilocks (two u32 limbs per component in the JAX layout),
    False for BabyBear (one u32 word); other fields raise."""
    d = field.extension_degree
    if field.p > (1 << 32) and d in (1, 2):
        return True
    if field.p < (1 << 32) and d in (1, 4):
        return False
    raise ValueError(f"no JAX layout for {field!r}: Goldilocks (base, Fp2) and "
                     "BabyBear (base, Fp4) are ported")


def from_jax_packed(arr, field, device=None) -> torch.Tensor:
    """JAX packed u32 array -> int64 tensor. ``field``: a host field of
    Goldilocks (base (..., 2) input, Fp2 (..., 2, 2)) or BabyBear (base
    (...) input, Fp4 (..., 4)). The JAX ``FastStark._constraint_polys``
    output, (w+t, n, 2) in Goldilocks or (w+t, n) in BabyBear, becomes the
    (w+t, n) tensor the port's ``FastStark.verify`` takes."""
    a = np.asarray(arr, dtype=np.uint32)
    if not _limbed(field):
        if field.extension_degree == 4:
            assert a.ndim >= 1 and a.shape[-1] == 4, a.shape
        return torch.from_numpy(a.astype(np.int64)).to(device)
    assert a.shape[-1] == 2, a.shape
    if field.extension_degree == 2:
        assert a.ndim >= 2 and a.shape[-2] == 2, a.shape
    u64 = a[..., 0].astype(np.uint64) | (a[..., 1].astype(np.uint64) << np.uint64(32))
    return torch.from_numpy(np.ascontiguousarray(u64).view(np.int64)).to(device)


def to_jax_packed(t: torch.Tensor, field) -> np.ndarray:
    """int64 tensor -> the JAX package's packed numpy u32 layout."""
    if not _limbed(field):
        return t.detach().cpu().numpy().astype(np.uint32)
    u64 = t.detach().cpu().contiguous().numpy().view(np.uint64)
    lo = (u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u64 >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=-1)


def planes_to_i64(planes, device=None) -> torch.Tensor:
    """``ntt_mxu``'s Goldilocks plane tuple (lo, hi), two u32 arrays of one
    shape, -> int64 tensor of that shape."""
    lo, hi = (np.asarray(t, dtype=np.uint32).astype(np.uint64) for t in planes)
    u64 = lo | (hi << np.uint64(32))
    return torch.from_numpy(np.ascontiguousarray(u64).view(np.int64)).to(device)


def i64_to_planes(t: torch.Tensor):
    """int64 tensor -> ``ntt_mxu``'s (lo, hi) tuple of numpy u32 planes."""
    u64 = t.detach().cpu().contiguous().numpy().view(np.uint64)
    return ((u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u64 >> np.uint64(32)).astype(np.uint32))


def digits_from_jax(d, device=None) -> torch.Tensor:
    """``ntt_mxu._digitize``'s stack (NA, B, F, R) int8, digits on a new
    leading axis, -> ``ops/ntt_digit.digitize``'s (B, NA F, R) int8 layout
    (digit a of position m at row a F + m)."""
    a = np.asarray(d, dtype=np.int8)
    assert a.ndim == 4, a.shape
    NA, B, F, R = a.shape
    return torch.from_numpy(
        np.transpose(a, (1, 0, 2, 3)).reshape(B, NA * F, R).copy()).to(device)


def from_jax_trace(jax_trace, transitions, device=None):
    """A JAX ``DeviceTrace`` -> this package's ``DeviceTrace`` (Fibonacci,
    counter, LFSR or MiMC: ``transitions_inline`` stays behind).

    The stark field becomes this package's Goldilocks or BabyBear, by name;
    the columns are carried over (host ``cols`` stay numpy, device
    ``cols_dev`` become a tensor on ``device``). ``transitions`` must be
    this package's closures for the same AIR (e.g.
    ``models.fibonacci_device._fib_transitions``, or the ``transitions`` of
    ``models.mimc.mimc_device_trace``): the JAX closures act on JAX arrays."""
    from .fields import BabyBear, Goldilocks
    from .stark.engine import DeviceTrace

    fields = {sf.name: sf for sf in (Goldilocks, BabyBear)}
    name = jax_trace.stark_field.name
    if name not in fields:
        raise ValueError(f"no port of the stark field {name}: Goldilocks and "
                         "BabyBear are ported")
    sf = fields[name]
    cols_dev = None
    if jax_trace.cols_dev is not None:
        cols_dev = from_jax_packed(np.asarray(jax_trace.cols_dev), sf.base, device)
    cols = None if jax_trace.cols is None else np.asarray(jax_trace.cols, np.uint64)
    return DeviceTrace(stark_field=sf, steps=jax_trace.steps, cols=cols,
                       transitions=list(transitions), cols_dev=cols_dev)
