"""Batched Goldilocks NTT, inverse NTT and coset transforms.

The ``ministark_tpu/ops/ntt_device.py::make_ntt_fns`` contract: ``fft``,
``ifft``, ``coset_fft`` and ``coset_ifft`` over (batch, n) base-field
tensors in natural order, with the root ``field.get_root_of_unity(n)``
(``ntt_mxu.py:770``). An Fp2 codeword is the base transform batched over
its two components: the 2-adic roots lie in the base field. The coset
offset is a host scalar (a Fiat-Shamir challenge).

``transform`` dispatches by the tensor's device: a CPU tensor takes
``transform_plain`` (bit reversal plus radix-2 DIT stages in torch ops), a
CUDA tensor launches the CUDA kernel (csrc/ntt.cu) at every size or raises.
Any correct NTT with the same root gives the same canonical outputs, so
neither copies the TPU kernel's int8 digit matmul.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..fields import GOLDILOCKS_FP as F
from . import cuda
from . import field as gl
from .poly import powers

# Incremented once per call that launches the CUDA NTT kernel.
launches = 0

MAX_LOG_N = 30   # the CUDA kernel indexes a row with 32-bit positions


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"NTT size must be a power of two, got {n}")
    log_n = n.bit_length() - 1
    if log_n > MAX_LOG_N:
        raise ValueError(f"NTT size 2^{log_n} is above 2^{MAX_LOG_N}")
    return log_n


def _roots(n: int, inverse: bool):
    root = F.get_root_of_unity(n)
    return F.inv(root) if inverse else root


_TWIDDLES = {}


def twiddles(root: int, n: int, device) -> torch.Tensor:
    """[root^0 .. root^(n/2 - 1)] on ``device``, cached per (root, n, device)."""
    key = (root, n, str(device))
    if key not in _TWIDDLES:
        r = gl.pack_u64(root, device)
        _TWIDDLES[key] = powers(gl.get_ops(F), r, max(n // 2, 1)).contiguous()
    return _TWIDDLES[key]


@lru_cache(maxsize=None)
def _bitrev_cpu(n: int) -> torch.Tensor:
    log_n = _log2(n)
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _offset_square_table(offset: int, log_n: int, device) -> torch.Tensor:
    """[s^(2^0), s^(2^1), .., s^(2^(log_n - 1))]: the kernel forms s^i from
    the bits of i."""
    out, s = [], F.from_int(offset)
    for _ in range(max(log_n, 1)):
        out.append(s)
        s = F.mul(s, s)
    return gl.pack_u64(out, device)


def transform_plain(x: torch.Tensor, inverse: bool = False, pre=None,
                    post=None) -> torch.Tensor:
    """Plain PyTorch version: (batch, n) natural order -> natural order.

    ``pre``: coset offset s multiplied in as s^i before the transform;
    ``post``: offset multiplied in as s^i after it; ``inverse`` uses the
    inverse root and scales by 1/n."""
    batch, n = x.shape
    log_n = _log2(n)
    ops = gl.get_ops(F)
    if pre is not None:
        x = gl.mul(x, powers(ops, gl.pack_u64(pre, x.device), n).unsqueeze(0))
    tw = twiddles(_roots(n, inverse), n, x.device)
    x = x[:, _bitrev_cpu(n).to(x.device)]
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        xr = x.reshape(batch, n >> s, 2, half)
        e, o = xr[:, :, 0], xr[:, :, 1]
        wv = gl.mul(o, tw[:: n >> s][:half])
        x = torch.stack([gl.add(e, wv), gl.sub(e, wv)], 2).reshape(batch, n)
    if inverse:
        x = gl.mul(x, gl.pack_u64(F.inv(F.from_int(n)), x.device))
    if post is not None:
        x = gl.mul(x, powers(ops, gl.pack_u64(post, x.device), n).unsqueeze(0))
    return x


def transform_cuda(x: torch.Tensor, inverse: bool = False, pre=None,
                   post=None) -> torch.Tensor:
    """CUDA kernel (csrc/ntt.cu), same contract as ``transform_plain``.

    Replaces the Pallas kernel ``ministark_tpu/ops/ntt_mxu.py::
    _make_fused_kernel`` (one int8-MXU NTT level per call). Here one call
    runs the whole transform: a shared-memory kernel does the bit-reversed
    load (with the coset pre-multiply, s^i from a table of s^(2^b)) and the
    first 12 radix-2 stages on 4096-element tiles, then one global kernel
    per remaining stage; the last launch applies 1/n and any post-multiply.
    Bound on this card: device-memory bandwidth, one read and one write of
    the batch per global stage (9 at n = 2^21)."""
    global launches
    cuda.require(x, "ntt", torch.int64, 2)
    batch, n = x.shape
    log_n = _log2(n)
    lib = cuda.library()
    y = torch.empty_like(x)
    tw = twiddles(_roots(n, inverse), n, x.device)
    pre_t = None if pre is None else _offset_square_table(pre, log_n, x.device)
    post_t = None if post is None else _offset_square_table(post, log_n, x.device)
    scale = 1
    if inverse:
        scale = F.inv(F.from_int(n))
    if batch:
        err = lib.ms_ntt_gl(
            x.data_ptr(), y.data_ptr(), batch, log_n, tw.data_ptr(),
            None if pre_t is None else pre_t.data_ptr(),
            None if post_t is None else post_t.data_ptr(),
            scale, cuda.stream_ptr(x),
        )
        cuda.check("ntt", err)
        launches += 1
    return y


def transform(x: torch.Tensor, inverse: bool = False, pre=None, post=None):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if x.device.type == "cpu":
        return transform_plain(x, inverse, pre, post)
    return transform_cuda(x, inverse, pre, post)


def get_ntt_fns(field, n: int):
    """(fft, ifft, coset_fft, coset_ifft) for size n over (batch, n) GL
    tensors. ``coset_fft(x, offset)`` evaluates over the coset offset * H;
    ``coset_ifft(x, offset_inv)`` interpolates from it (as in ntt_device)."""
    if field.p != gl.P:
        raise ValueError(f"NTT is ported for Goldilocks only, got {field!r}")
    _log2(n)

    def fft(x):
        return transform(x)

    def ifft(x):
        return transform(x, inverse=True)

    def coset_fft(x, offset):
        return transform(x, pre=int(offset))

    def coset_ifft(x, offset_inv):
        return transform(x, inverse=True, post=int(offset_inv))

    return fft, ifft, coset_fft, coset_ifft

