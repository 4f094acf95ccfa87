"""Carry data between the JAX package's packed layout and this package.

``ministark_tpu`` packs a Goldilocks element as two u32 words [lo, hi]: a
numpy/JAX u32 array of shape (..., 2) for the base field and (..., 2, 2)
for Fp2 (``ministark_tpu/ops/registry.py``). This package holds the same
element as one int64 u64 bit pattern: (...) for the base field and (..., 2)
for Fp2. Nothing here imports jax: arrays cross as numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_ext(field) -> bool:
    d = field.extension_degree
    if d not in (1, 2):
        raise ValueError(f"only Goldilocks and its Fp2 are ported, got {field!r}")
    return d == 2


def from_jax_packed(arr, field, device=None) -> torch.Tensor:
    """JAX packed u32 array -> int64 tensor. ``field``: any host field of
    degree 1 (GL base, (..., 2) input) or 2 (GL Fp2, (..., 2, 2) input).
    The JAX ``FastStark._constraint_polys`` output, (w+t, n, 2) with the
    base field, becomes the (w+t, n) tensor the port's ``FastStark.verify``
    takes."""
    a = np.asarray(arr, dtype=np.uint32)
    assert a.shape[-1] == 2, a.shape
    if _is_ext(field):
        assert a.ndim >= 2 and a.shape[-2] == 2, a.shape
    u64 = a[..., 0].astype(np.uint64) | (a[..., 1].astype(np.uint64) << np.uint64(32))
    return torch.from_numpy(np.ascontiguousarray(u64).view(np.int64)).to(device)


def to_jax_packed(t: torch.Tensor, field) -> np.ndarray:
    """int64 tensor -> the JAX package's packed numpy u32 layout."""
    _is_ext(field)
    u64 = t.detach().cpu().contiguous().numpy().view(np.uint64)
    lo = (u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u64 >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=-1)


def from_jax_trace(jax_trace, transitions, device=None):
    """A JAX ``DeviceTrace`` -> this package's ``DeviceTrace``.

    The stark field becomes this package's Goldilocks (the only one
    ported); the columns are carried over (host ``cols`` stay numpy, device
    ``cols_dev`` become a tensor on ``device``). ``transitions`` must be
    this package's closures for the same AIR (e.g.
    ``models.fibonacci_device._fib_transitions``): the JAX closures act on
    JAX arrays."""
    from .fields import Goldilocks
    from .stark.engine import DeviceTrace

    if jax_trace.stark_field.name != Goldilocks.name:
        raise ValueError(f"only Goldilocks is ported, got {jax_trace.stark_field.name}")
    sf = Goldilocks
    cols_dev = None
    if jax_trace.cols_dev is not None:
        cols_dev = from_jax_packed(np.asarray(jax_trace.cols_dev), sf.base, device)
    cols = None if jax_trace.cols is None else np.asarray(jax_trace.cols, np.uint64)
    return DeviceTrace(stark_field=sf, steps=jax_trace.steps, cols=cols,
                       transitions=list(transitions), cols_dev=cols_dev)
