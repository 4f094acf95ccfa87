"""One NTT level over Goldilocks in its digit-matmul form: digitize, int8
dot, recombine, and the three fused.

Port of the level arithmetic of ``ministark_tpu/ops/ntt_mxu.py`` as its
probe scripts run it (``scripts/tpu_fused_stage_probe.py``: ``kern_dig``,
``kern_dot``, ``kern_rec``; ``scripts/tpu_f32_pad_probe.py::kernel``). A
length-F DFT over axis 1 of (B, F, R) becomes a matrix product of signed
bytes:

  digitize   ``_digitize`` :204: a canonical v > 0x7F7F7F7F7F7F7F7F is
             centred to v - p, then written as 8 balanced bytes d_a in
             [-128, 127] with v = sum_a d_a 256^a (carry chain, the final
             carry dropped); digit a of position m goes to row a F + m:
             (B, F, R) int64 -> (B, 8F, R) int8;
  digit_dot  the ``dot_general`` of ``_make_fused_kernel`` :400: contract
             the 8F axis with the digit matrix ``Vd``, whose entry
             (a F + m, j PF + k) is digit j of centre(w^(m k) 256^a mod p):
             (B, 8F, R) x (8F, 8 PF) -> (B, R, 8 PF) int32, |entries| < 2^27;
  recombine  ``_recombine_gl`` :280: plane j is columns j PF .. j PF + F;
             sum_j (R_j + 2^27) 2^(8 j) < 2^96 reduced mod p, less the
             offsets' constant, then the optional inter-level twiddle
             W[r // K_prod, k] and trailing scalar:
             (B, R, 8 PF) int32 -> (B, R, F) int64 canonical;
  level      the three in one launch (``_make_fused_kernel`` :370):
             (B, F, R) int64 -> (B, R, F) int64, the contract of
             ``ntt_pipe.level`` without the coset pre-multiply.

PF is the column stride of a digit plane: F, or 128 for F < 64 (the TPU's
padded tables, ``_build_tables`` :729; the width stays F). Values are this
package's int64 bit patterns, not u32 planes. Each ``name`` dispatches by
the tensor's device: a CPU tensor takes ``name_plain`` (torch ops), a CUDA
tensor launches ``name_cuda`` (csrc/ntt_digit.cu) or raises.

The host tables (``_params``, ``GL_CENTER_T``, ``_balanced_digits_signed``,
``_dft_digit_matrix``, ``OFF``, ``_recombine_const``) are this package's
own copy of ``ntt_mxu.py``'s :81-196; the per-level roots, twiddle rows and
``K_prod`` are ``ntt_pipe._tables``'s (rows indexed by r // K_prod, not
expanded).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields import GOLDILOCKS_FP
from . import cuda
from . import field as gl
from . import ntt_pipe
from .field import pack_u64
from .ntt import _log2, _roots

P = GOLDILOCKS_FP.p
NA = NB = 8                      # input and matrix byte digits (``_params``)
# the exact positive capacity of 8 balanced bytes, 127 (2^64 - 1) / 255
GL_CENTER_T = 127 * ((1 << 64) - 1) // 255
# R_j + OFF is non-negative: |R_j| <= F NA 128 128 < 2^27 for F <= 512
OFF = 1 << 27
F_MAX = 512
PAD_STRIDE = 128                 # digit-plane column stride for F < 64

# Incremented once per call that launches the kernel of that name.
launches = {"digitize_gl": 0, "digit_dot_s8": 0, "recombine_gl": 0,
            "digit_level_gl": 0}


# ------------------------------------------------------------- host tables
def _params(p: int):
    """(limbs, NA input byte digits, NB matrix byte digits): centred
    Goldilocks is 8 balanced signed bytes on both sides."""
    if p != P:
        raise ValueError(f"the digit NTT takes Goldilocks, got modulus {p}")
    return 2, NA, NB


def _balanced_digits_signed(u: np.ndarray, nd: int) -> np.ndarray:
    """Centred values, given as their two's-complement uint64 patterns, ->
    (..., nd) int8 balanced base-256 digits: byte + carry truncated to 8
    bits, carry = (byte + carry > 127), the final carry dropped (it is the
    2^64 of a negative value's wrap)."""
    out = np.empty(u.shape + (nd,), dtype=np.int8)
    c = np.zeros(u.shape, dtype=np.uint64)
    for b in range(nd):
        t = ((u >> np.uint64(8 * b)) & np.uint64(255)) + c
        out[..., b] = t.astype(np.uint8).view(np.int8)
        c = (t > np.uint64(127)).astype(np.uint64)
    return out


@lru_cache(maxsize=None)
def _dft_digit_matrix(p: int, root: int, F: int) -> np.ndarray:
    """(NA F, NB F) int8: row a F + m, column j F + k holds digit j of
    centre(root^(m k) 256^a mod p); entries above the positive digit
    capacity are centred to v - p before digitizing."""
    _params(p)
    row = np.array([pow(root, k, p) for k in range(F)], dtype=object)
    tbl = np.empty((F, F), dtype=object)
    tbl[0] = 1
    for m in range(1, F):
        tbl[m] = tbl[m - 1] * row % p
    digs = np.empty((NA, F, F, NB), dtype=np.int8)
    for a in range(NA):
        scaled = tbl * pow(256, a, p) % p
        wrapped = np.where(scaled > GL_CENTER_T, scaled - p + (1 << 64), scaled)
        digs[a] = _balanced_digits_signed(wrapped.astype(np.uint64), NB)
    # (NA, F_m, F_k, NB) -> (NA, F_m, NB, F_k) -> (NA F, NB F)
    return np.ascontiguousarray(
        np.transpose(digs, (0, 1, 3, 2)).reshape(NA * F, NB * F))


@lru_cache(maxsize=None)
def _recombine_const(p: int) -> int:
    """sum_j OFF 2^(8 j) mod p, subtracted after the offset accumulate."""
    _params(p)
    return sum(OFF << (8 * j) for j in range(NB)) % p


def plane_stride(F: int) -> int:
    """PF: the column stride of a digit plane in the level's matrix."""
    return PAD_STRIDE if F < 64 else F


def pad_digit_matrix(vd: np.ndarray, F: int, PF: int) -> np.ndarray:
    """(NA F, NB F) -> (NA F, NB PF): plane j moves to columns j PF ..
    j PF + F, zeros between (``_build_tables`` :729-733)."""
    out = np.zeros((NA * F, NB, PF), dtype=np.int8)
    out[:, :, :F] = vd.reshape(NA * F, NB, F)
    return out.reshape(NA * F, NB * PF)


_MATRICES = {}


def digit_matrix(root: int, F: int, device, PF=None) -> torch.Tensor:
    """The level's (8 F, 8 PF) int8 digit matrix for the root of order F on
    ``device``, PF = ``plane_stride(F)`` unless given; cached."""
    if F < 1 or F > F_MAX:
        raise ValueError(f"the digit level takes F <= {F_MAX}, got {F}")
    PF = plane_stride(F) if PF is None else PF
    key = (root, F, PF, str(device))
    if key not in _MATRICES:
        vd = _dft_digit_matrix(P, root, F)
        if PF != F:
            vd = pad_digit_matrix(vd, F, PF)
        _MATRICES[key] = torch.from_numpy(vd).to(device)
    return _MATRICES[key]


def level_tables(n: int, inverse: bool, device):
    """Per level of the factor walk of size n: (F_i, Vd_i, W_i or None,
    K_i), with ``ntt_pipe._tables``' factors, twiddle rows and K_prod and
    the digit matrix of the level's root w^(n / F_i)."""
    root = _roots(GOLDILOCKS_FP, n, inverse)
    return [(Fi, digit_matrix(pow(root, n // Fi, P), Fi, device), W, k_prod)
            for Fi, _, W, k_prod in ntt_pipe._tables(n, inverse, device)]


# ---------------------------------------------------------------- digitize
def digitize_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, F, R) int64 -> (B, 8F, R) int8, in 32-bit halves so
    that nothing depends on int64 wraparound."""
    B, F, R = x.shape
    lo, hi = gl._split(x)
    t_lo, t_hi = GL_CENTER_T & gl.M32, GL_CENTER_T >> 32
    p_lo, p_hi = P & gl.M32, P >> 32
    big = (hi > t_hi) | ((hi == t_hi) & (lo > t_lo))
    borrow = (lo < p_lo).to(torch.int64)
    lo = torch.where(big, (lo - p_lo) & gl.M32, lo)
    hi = torch.where(big, (hi - p_hi - borrow) & gl.M32, hi)
    c = torch.zeros_like(lo)
    digs = []
    for w in (lo, hi):
        for i in range(4):
            t = ((w >> (8 * i)) & 255) + c
            digs.append((((t + 128) & 255) - 128).to(torch.int8))
            c = (t > 127).to(torch.int64)
    return torch.stack(digs, 1).reshape(B, NA * F, R)


def digitize_cuda(x: torch.Tensor) -> torch.Tensor:
    """CUDA kernel ``ms_digitize_gl``, same contract as ``digitize_plain``.
    Replaces ``scripts/tpu_fused_stage_probe.py::kern_dig`` (which stores two
    of the 8 digit planes; here all 8, the dot's input)."""
    cuda.require_aligned(x, "digitize", torch.int64, 3)
    B, F, R = x.shape
    d = torch.empty((B, NA * F, R), dtype=torch.int8, device=x.device)
    if d.numel():
        err = cuda.library().ms_digitize_gl(x.data_ptr(), d.data_ptr(), B, F, R,
                                            cuda.stream_ptr(x))
        cuda.check("digitize", err)
        launches["digitize_gl"] += 1
    return d


def digitize(x):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    return digitize_plain(x) if x.device.type == "cpu" else digitize_cuda(x)


# --------------------------------------------------------------------- dot
def digit_dot_plain(d: torch.Tensor, vd: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, K, R) int8 x (K, N) int8 -> (B, R, N) int32, as a
    float64 product (exact: every partial sum is below K 2^14 < 2^53; torch
    has no integer matmul on CUDA)."""
    out = torch.matmul(d.transpose(1, 2).to(torch.float64), vd.to(torch.float64))
    return out.to(torch.int32)


def digit_dot_cuda(d: torch.Tensor, vd: torch.Tensor) -> torch.Tensor:
    """CUDA kernel ``ms_digit_dot_s8`` (int8 tensor cores, ``mma.sync``),
    same contract as ``digit_dot_plain``; K must be a multiple of 64 and N
    of 128. Replaces ``scripts/tpu_fused_stage_probe.py::kern_dot``."""
    cuda.require_aligned(d, "digit_dot digits", torch.int8, 3)
    cuda.require_aligned(vd, "digit_dot matrix", torch.int8, 2)
    if vd.device != d.device:
        raise ValueError(f"digit_dot: matrix on {vd.device}, digits on {d.device}")
    B, K, R = d.shape
    N = vd.shape[1]
    if vd.shape[0] != K or K % 64 or N % 128:
        raise ValueError(f"digit_dot: digits {tuple(d.shape)} x matrix "
                         f"{tuple(vd.shape)}: K must match and be a multiple of "
                         "64, N a multiple of 128")
    out = torch.empty((B, R, N), dtype=torch.int32, device=d.device)
    if out.numel():
        err = cuda.library().ms_digit_dot_s8(d.data_ptr(), vd.data_ptr(),
                                             out.data_ptr(), B, K, R, N,
                                             cuda.stream_ptr(d))
        cuda.check("digit_dot", err)
        launches["digit_dot_s8"] += 1
    return out


def digit_dot(d, vd):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    return digit_dot_plain(d, vd) if d.device.type == "cpu" else digit_dot_cuda(d, vd)


# --------------------------------------------------------------- recombine
def _tail_plain(y, W, k_prod, scale):
    if W is not None:
        rows = torch.arange(y.shape[1], device=y.device) // k_prod
        y = gl.mul_plain(y, W[rows])
    if scale is not None:
        y = gl.mul_plain(y, pack_u64(scale, y.device))
    return y


def recombine_plain(Rm: torch.Tensor, F: int, W=None, k_prod: int = 1,
                    scale=None) -> torch.Tensor:
    """Plain version: (B, R, 8 PF) int32 -> (B, R, F) int64. ``W``:
    (R // k_prod, F) twiddles, row r // k_prod; ``scale``: a host scalar."""
    B, R, N = Rm.shape
    PF = N // NB
    us = [(Rm[..., j * PF:j * PF + F].to(torch.int64) + OFF) & gl.M32
          for j in range(NB)]
    lo = us[0] + (us[1] << 8) + (us[2] << 16) + (us[3] << 24)     # < 2^57
    hi = us[4] + (us[5] << 8) + (us[6] << 16) + (us[7] << 24)
    t = (lo >> 32) + hi                                           # Y = lo + hi 2^32
    x = gl._reduce128(lo & gl.M32, t & gl.M32, t >> 32, torch.zeros_like(t))
    kc = _recombine_const(P)
    kl = torch.full_like(t, kc & gl.M32)
    kh = torch.full_like(t, kc >> 32)
    y = gl._join(*gl._sub_h(*x, kl, kh))
    return _tail_plain(y, W, k_prod, scale)


def _tail_args(W, k_prod, scale, R, F, device):
    """(W pointer or None, log2 K_prod, scale or 1) for the kernels."""
    if W is not None:
        cuda.require(W, "digit level twiddles", torch.int64, 2)
        if W.device != device or tuple(W.shape) != (-(-R // k_prod), F):
            raise ValueError(f"digit level: twiddles {tuple(W.shape)} on "
                             f"{W.device} for R {R}, K_prod {k_prod}, F {F}")
    return (None if W is None else W.data_ptr(), _log2(k_prod),
            1 if scale is None else int(scale))


def recombine_cuda(Rm: torch.Tensor, F: int, W=None, k_prod: int = 1,
                   scale=None) -> torch.Tensor:
    """CUDA kernel ``ms_recombine_gl``, same contract as ``recombine_plain``.
    Replaces ``scripts/tpu_fused_stage_probe.py::kern_rec``."""
    cuda.require_aligned(Rm, "recombine", torch.int32, 3)
    B, R, N = Rm.shape
    PF = N // NB
    if N % NB or PF < F or F < 1 or F > F_MAX:
        raise ValueError(f"recombine: {N} columns do not hold 8 planes of "
                         f"width {F} <= {F_MAX}")
    w_ptr, log_kprod, sc = _tail_args(W, k_prod, scale, R, F, Rm.device)
    y = torch.empty((B, R, F), dtype=torch.int64, device=Rm.device)
    if y.numel():
        err = cuda.library().ms_recombine_gl(
            Rm.data_ptr(), y.data_ptr(), B, R, F, PF, w_ptr, log_kprod, sc,
            _recombine_const(P), cuda.stream_ptr(Rm))
        cuda.check("recombine", err)
        launches["recombine_gl"] += 1
    return y


def recombine(Rm, F, W=None, k_prod=1, scale=None):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if Rm.device.type == "cpu":
        return recombine_plain(Rm, F, W, k_prod, scale)
    return recombine_cuda(Rm, F, W, k_prod, scale)


# ------------------------------------------------------------------- level
def level_plain(x: torch.Tensor, vd: torch.Tensor, W=None, k_prod: int = 1,
                scale=None) -> torch.Tensor:
    """Plain version of the fused level: the three plain stages in turn."""
    return recombine_plain(digit_dot_plain(digitize_plain(x), vd), x.shape[1],
                           W, k_prod, scale)


def level_cuda(x: torch.Tensor, vd: torch.Tensor, W=None, k_prod: int = 1,
               scale=None) -> torch.Tensor:
    """CUDA kernel ``ms_digit_level_gl``: digitize, dot and recombine in one
    launch, the digits and the int32 planes never in device memory. Replaces
    ``scripts/tpu_f32_pad_probe.py::kernel`` (``_make_fused_kernel`` with
    padded F = 32 tables); F a power of two in [32, 512]."""
    cuda.require_aligned(x, "digit level", torch.int64, 3)
    cuda.require_aligned(vd, "digit level matrix", torch.int8, 2)
    B, F, R = x.shape
    PF = vd.shape[1] // NB
    if (vd.device != x.device or vd.shape[0] != NA * F or vd.shape[1] % NB
            or PF < F or PF % 4 or F < 32 or F > F_MAX or F & (F - 1)):
        raise ValueError(f"digit level: x {tuple(x.shape)} with matrix "
                         f"{tuple(vd.shape)} on {vd.device}")
    w_ptr, log_kprod, sc = _tail_args(W, k_prod, scale, R, F, x.device)
    y = torch.empty((B, R, F), dtype=torch.int64, device=x.device)
    if y.numel():
        err = cuda.library().ms_digit_level_gl(
            x.data_ptr(), vd.data_ptr(), y.data_ptr(), B, F, R, PF, w_ptr,
            log_kprod, sc, _recombine_const(P), cuda.stream_ptr(x))
        cuda.check("digit level", err)
        launches["digit_level_gl"] += 1
    return y


def level(x, vd, W=None, k_prod=1, scale=None):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if x.device.type == "cpu":
        return level_plain(x, vd, W, k_prod, scale)
    return level_cuda(x, vd, W, k_prod, scale)
