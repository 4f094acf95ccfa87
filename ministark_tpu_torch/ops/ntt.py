"""Batched NTT, inverse NTT and coset transforms over Goldilocks and BabyBear.

The ``ministark_tpu/ops/ntt_device.py::make_ntt_fns`` contract: ``fft``,
``ifft``, ``coset_fft`` and ``coset_ifft`` over (batch, n) base-field
tensors in natural order, with the root ``field.get_root_of_unity(n)``
(``ntt_mxu.py:770``). An extension codeword (Goldilocks Fp2, BabyBear Fp4)
is the base transform batched over its components: the 2-adic roots lie in
the prime field. The coset offset is a host scalar (a Fiat-Shamir challenge).

``get_ntt_fns(field, n, backend)`` picks one of three implementations, each
with its CUDA kernels (one symbol per field, ``_gl`` or ``_bb``) and their
plain versions:

  "radix2"     this module: bit reversal plus radix-2 DIT stages
               (csrc/ntt.cu), every size;
  "four_step"  ops/ntt_four_step.py, two shared-memory passes
               (csrc/ntt_four_step.cu), 2^14 <= n <= 2^22;
  "pipe"       ops/ntt_pipe.py, the factor walk with one pipelined level
               kernel per factor (csrc/ntt_pipe.cu), ``fused_supports(n)``.

Any correct NTT with the same root gives the same canonical outputs, so
proofs are identical whichever backend runs, and none copies the TPU
kernels' int8 digit matmul. ``transform`` dispatches by the tensor's device:
a CPU tensor takes ``transform_plain``, a CUDA tensor launches the kernel at
every size or raises. Every function takes the prime field (``field=``,
Goldilocks unless given); the plain versions multiply with ``NttField.mul``
(``field.mul_plain`` or ``bb.mul``, torch ops), so they launch no kernel on
a CUDA tensor either. The tables are cached per field: a root of one field
is never looked up in the other's tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable

import torch

from ..fields import BABYBEAR_FP, GOLDILOCKS_FP
from . import bb, cuda
from . import field as gl
from .field import get_ops, pack_u64
from .poly import powers

# Incremented once per call that launches the CUDA NTT kernel, per field.
launches = {"gl": 0, "bb": 0}

MAX_LOG_N = 30   # the CUDA kernel indexes a row with 32-bit positions


@dataclass(frozen=True)
class NttField:
    """A prime field the NTT kernels take: the suffix of its kernels'
    symbols and counters, and the arithmetic of the plain versions (torch
    ops only, no kernel)."""

    tag: str
    add: Callable
    sub: Callable
    mul: Callable


_NTT_FIELDS = {
    id(GOLDILOCKS_FP): NttField("gl", gl.add, gl.sub, gl.mul_plain),
    id(BABYBEAR_FP): NttField("bb", bb.add, bb.sub, bb.mul),
}


def ntt_field(field) -> NttField:
    """The NTT's view of a prime field; any other field (an extension
    included: BabyBear Fp4's ``base_field`` is Fp2) raises."""
    try:
        return _NTT_FIELDS[id(field)]
    except KeyError:
        raise ValueError(f"the NTT takes Goldilocks or BabyBear, got {field!r}"
                         ) from None


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"NTT size must be a power of two, got {n}")
    log_n = n.bit_length() - 1
    if log_n > MAX_LOG_N:
        raise ValueError(f"NTT size 2^{log_n} is above 2^{MAX_LOG_N}")
    return log_n


def _roots(field, n: int, inverse: bool):
    root = field.get_root_of_unity(n)
    return field.inv(root) if inverse else root


def inv_n(field, n: int) -> int:
    """1/n in the field: the scale of an inverse transform."""
    return field.inv(field.from_int(n))


BACKENDS = ("radix2", "four_step", "pipe")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown NTT backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return backend


def powers_plain(field, s: int, n: int, device) -> torch.Tensor:
    """[s^0 .. s^(n - 1)] by doubling with the plain multiply."""
    mul = ntt_field(field).mul
    pw = pack_u64([1], device)
    step = pack_u64(s, device)
    while pw.shape[0] < n:
        pw = torch.cat([pw, mul(pw, step)])
        step = mul(step, step)
    return pw[:n]


@lru_cache(maxsize=None)
def _stage_table_host(p: int, root: int, m: int):
    """(log2(m), m // 2) twiddle table mod p as nested lists: row r holds
    root^(j << (L - 1 - r)) for j < 2^r (the stage with butterfly
    half-width 2^r), zero-padded (``ntt_pallas.py::_stage_table_host``)."""
    L = m.bit_length() - 1
    rows = []
    for r in range(L):
        step = pow(root, 1 << (L - 1 - r), p)
        row, v = [0] * (m // 2), 1
        for j in range(1 << r):
            row[j] = v
            v = v * step % p
        rows.append(row)
    return rows


_STAGE_TABLES = {}


def stage_table(field, root: int, m: int, device) -> torch.Tensor:
    """``_stage_table_host`` as a contiguous (log2 m, m // 2) tensor on
    ``device``, cached per field."""
    key = (field.p, root, m, str(device))
    if key not in _STAGE_TABLES:
        _STAGE_TABLES[key] = pack_u64(_stage_table_host(field.p, root, m), device
                                      ).reshape(m.bit_length() - 1, m // 2)
    return _STAGE_TABLES[key]


def bitrev(m: int, device) -> torch.Tensor:
    return _bitrev_cpu(m).to(device)


def dit_last(x: torch.Tensor, table: torch.Tensor, field) -> torch.Tensor:
    """Decimation-in-time stages along the last axis of (..., m) in
    bit-reversed order (natural order out), with ``stage_table``'s rows."""
    F = ntt_field(field)
    lead, m = x.shape[:-1], x.shape[-1]
    for s in range(1, m.bit_length()):
        half = 1 << (s - 1)
        xr = x.reshape(lead + (m >> s, 2, half))
        e, o = xr[..., 0, :], xr[..., 1, :]
        wv = F.mul(o, table[s - 1, :half])
        x = torch.stack([F.add(e, wv), F.sub(e, wv)], -2).reshape(lead + (m,))
    return x


def dif_last(x: torch.Tensor, table: torch.Tensor, field) -> torch.Tensor:
    """Decimation-in-frequency stages along the last axis of (..., m) in
    natural order (bit-reversed order out), with ``stage_table``'s rows."""
    F = ntt_field(field)
    lead, m = x.shape[:-1], x.shape[-1]
    for s in range(m.bit_length() - 1, 0, -1):
        half = 1 << (s - 1)
        xr = x.reshape(lead + (m >> s, 2, half))
        u, v = xr[..., 0, :], xr[..., 1, :]
        bot = F.mul(F.sub(u, v), table[s - 1, :half])
        x = torch.stack([F.add(u, v), bot], -2).reshape(lead + (m,))
    return x


_TWIDDLES = {}


def twiddles(field, root: int, n: int, device) -> torch.Tensor:
    """[root^0 .. root^(n/2 - 1)] on ``device``, cached per field."""
    key = (field.p, root, n, str(device))
    if key not in _TWIDDLES:
        r = pack_u64(root, device)
        _TWIDDLES[key] = powers(get_ops(field), r, max(n // 2, 1)).contiguous()
    return _TWIDDLES[key]


@lru_cache(maxsize=None)
def _bitrev_cpu(n: int) -> torch.Tensor:
    """The bit-reversal permutation of n positions (the same in every
    field)."""
    log_n = _log2(n)
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def offset_square_table(field, offset: int, log_n: int, device) -> torch.Tensor:
    """[s^(2^0), s^(2^1), .., s^(2^(log_n - 1))]: the kernel forms s^i from
    the bits of i."""
    out, s = [], field.from_int(offset)
    for _ in range(max(log_n, 1)):
        out.append(s)
        s = field.mul(s, s)
    return pack_u64(out, device)


def transform_plain(x: torch.Tensor, inverse: bool = False, pre=None,
                    post=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """Plain PyTorch version: (batch, n) natural order -> natural order.

    ``pre``: coset offset s multiplied in as s^i before the transform;
    ``post``: offset multiplied in as s^i after it; ``inverse`` uses the
    inverse root and scales by 1/n."""
    F = ntt_field(field)
    batch, n = x.shape
    log_n = _log2(n)
    if pre is not None:
        x = F.mul(x, powers_plain(field, pre, n, x.device))
    tw = twiddles(field, _roots(field, n, inverse), n, x.device)
    x = x[:, bitrev(n, x.device)]
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        xr = x.reshape(batch, n >> s, 2, half)
        e, o = xr[:, :, 0], xr[:, :, 1]
        wv = F.mul(o, tw[:: n >> s][:half])
        x = torch.stack([F.add(e, wv), F.sub(e, wv)], 2).reshape(batch, n)
    if inverse:
        x = F.mul(x, pack_u64(inv_n(field, n), x.device))
    if post is not None:
        x = F.mul(x, powers_plain(field, post, n, x.device))
    return x


def transform_cuda(x: torch.Tensor, inverse: bool = False, pre=None,
                   post=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """CUDA kernel (csrc/ntt.cu, ``ms_ntt_gl`` / ``ms_ntt_bb``), same
    contract as ``transform_plain``.

    Replaces the Pallas kernel ``ministark_tpu/ops/ntt_mxu.py::
    _make_fused_kernel`` (one int8-MXU NTT level per call; BabyBear through
    ``_recombine_bb``). Here one call runs the whole transform: a
    shared-memory kernel does the bit-reversed load (with the coset
    pre-multiply, s^i from a table of s^(2^b)) and the first 12 radix-2
    stages on 4096-element tiles, then one global kernel per remaining
    stage; the last launch applies 1/n and any post-multiply. Bound on this
    card: integer throughput, at both fields (the butterflies, against one
    read and one write of the batch per global stage)."""
    F = ntt_field(field)
    cuda.require(x, "ntt", torch.int64, 2)
    batch, n = x.shape
    log_n = _log2(n)
    y = torch.empty_like(x)
    tw = twiddles(field, _roots(field, n, inverse), n, x.device)
    pre_t = None if pre is None else offset_square_table(field, pre, log_n, x.device)
    post_t = None if post is None else offset_square_table(field, post, log_n,
                                                           x.device)
    if batch:
        err = getattr(cuda.library(), f"ms_ntt_{F.tag}")(
            x.data_ptr(), y.data_ptr(), batch, log_n, tw.data_ptr(),
            None if pre_t is None else pre_t.data_ptr(),
            None if post_t is None else post_t.data_ptr(),
            inv_n(field, n) if inverse else 1, cuda.stream_ptr(x),
        )
        cuda.check("ntt", err)
        launches[F.tag] += 1
    return y


def transform(x: torch.Tensor, inverse: bool = False, pre=None, post=None,
              field=GOLDILOCKS_FP):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if x.device.type == "cpu":
        return transform_plain(x, inverse, pre, post, field)
    return transform_cuda(x, inverse, pre, post, field)


def backend_transform(backend: str, n: int):
    """The transform that runs size n for ``backend``. A backend takes the
    sizes of its range and radix-2 the rest, by size, as
    ``ntt_device.make_ntt_fns`` chooses (:349-366): "four_step" runs
    2^14 <= n <= 2^22 (``ntt_four_step.supports``), "pipe" runs the sizes
    of ``ntt_pipe.fused_supports`` (n >= 2^14); "radix2" runs every size."""
    from . import ntt_four_step, ntt_pipe   # both import this module

    check_backend(backend)
    if backend == "four_step" and ntt_four_step.supports(n):
        return ntt_four_step.transform
    if backend == "pipe" and ntt_pipe.fused_supports(n):
        return ntt_pipe.transform
    return transform


def transform_fns(transform, field):
    """(fft, ifft, coset_fft, coset_ifft) over one ``transform`` in
    ``field``."""

    def fft(x):
        return transform(x, field=field)

    def ifft(x):
        return transform(x, inverse=True, field=field)

    def coset_fft(x, offset):
        return transform(x, pre=int(offset), field=field)

    def coset_ifft(x, offset_inv):
        return transform(x, inverse=True, post=int(offset_inv), field=field)

    return fft, ifft, coset_fft, coset_ifft


def get_ntt_fns(field, n: int, backend: str = "radix2"):
    """(fft, ifft, coset_fft, coset_ifft) for size n over (batch, n)
    tensors of the prime field ``field`` (Goldilocks or BabyBear; anything
    else raises). ``coset_fft(x, offset)`` evaluates over the coset
    offset * H; ``coset_ifft(x, offset_inv)`` interpolates from it (as in
    ntt_device). ``backend`` is "radix2", "four_step" or "pipe"
    (``backend_transform`` says which sizes each takes; outside its range a
    backend runs radix-2); any other name raises."""
    ntt_field(field)
    _log2(n)
    return transform_fns(backend_transform(backend, n), field)
