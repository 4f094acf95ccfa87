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
# data_ptr of a cached matrix -> (the matrix, its kernel table or None until
# the kernel first reads it); the matrices live as long as the module, so a
# pointer here is never reused by another tensor
_TABLES = {}


def digit_matrix(root: int, F: int, device, PF=None) -> torch.Tensor:
    """The level's (8 F, 8 PF) int8 digit matrix for the root of order F on
    ``device``, PF = ``plane_stride(F)`` unless given; cached, and so is
    the K-major copy the level's kernel reads (``kernel_table``)."""
    if F < 1 or F > F_MAX:
        raise ValueError(f"the digit level takes F <= {F_MAX}, got {F}")
    PF = plane_stride(F) if PF is None else PF
    key = (root, F, PF, str(device))
    if key not in _MATRICES:
        vd = _dft_digit_matrix(P, root, F)
        if PF != F:
            vd = pad_digit_matrix(vd, F, PF)
        _MATRICES[key] = torch.from_numpy(vd).to(device)
        _TABLES[_MATRICES[key].data_ptr()] = (_MATRICES[key], None)
    return _MATRICES[key]


def table_row(k, j):
    """The kernel table's row for plane j of frequency k (ints or tensors):
    in each n-tile of 256 rows (32 frequencies), group c = (k % 32) / 8 of 64
    rows holds frequencies 8 c + 2 t + e at 8 (4 e + j / 2) + 2 t + j % 2,
    so that wgmma's accumulator lane 4 g + t holds all 8 planes of
    frequencies 8 c + 2 t and 8 c + 2 t + 1 (csrc/ntt_digit.cu)."""
    return 64 * (k // 8) + 32 * (k % 2) + 8 * (j // 2) + 2 * ((k % 8) // 2) + j % 2


def kernel_table(vd: torch.Tensor, F: int) -> torch.Tensor:
    """The (8 F, 8 F) K-major copy of a level's (8 F, 8 PF) digit matrix
    that ``ms_digit_level_gl`` reads: row ``table_row(k, j)``, byte 8 m + a
    holds vd[a F + m, j PF + k]; the PF - F padding columns of a plane are
    dropped."""
    PF = vd.shape[1] // NB
    x = vd.reshape(NA, F, NB, PF)[..., :F]                  # (a, m, j, k)
    x = x.reshape(NA, F, NB // 2, 2, F // 8, 4, 2)           # (a, m, jh, jl, kh, t, e)
    return x.permute(4, 6, 2, 5, 3, 1, 0).reshape(NB * F, NA * F).contiguous()


def _level_table(vd: torch.Tensor, F: int) -> torch.Tensor:
    """The kernel table of ``vd``: made once for a matrix from
    ``digit_matrix``, made in the call (and its time counted in it) for
    any other."""
    hit = _TABLES.get(vd.data_ptr())
    if hit is None or hit[0] is not vd:
        return kernel_table(vd, F)
    if hit[1] is None:
        _TABLES[vd.data_ptr()] = (vd, kernel_table(vd, F))
    return _TABLES[vd.data_ptr()][1]


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
    """CUDA kernel ``ms_digit_dot_s8`` (int8 tensor cores, ``wgmma`` on
    K-major tiles that the block transposes from TMA copies),
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
    launch, the digits and the int32 planes never in device memory; the
    product reads ``vd``'s K-major ``kernel_table`` (cached for a matrix
    from ``digit_matrix``). Replaces ``scripts/tpu_f32_pad_probe.py::kernel``
    (``_make_fused_kernel`` with padded F = 32 tables); F a power of two in
    [32, 512]."""
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
        table = _level_table(vd, F)
        err = cuda.library().ms_digit_level_gl(
            x.data_ptr(), table.data_ptr(), y.data_ptr(), B, F, R, w_ptr,
            log_kprod, sc, _recombine_const(P), cuda.stream_ptr(x))
        cuda.check("digit level", err)
        launches["digit_level_gl"] += 1
    return y


def level(x, vd, W=None, k_prod=1, scale=None):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if x.device.type == "cpu":
        return level_plain(x, vd, W, k_prod, scale)
    return level_cuda(x, vd, W, k_prod, scale)


# ------------------------------------------- the kernels' routes, replayed
# Geometry of csrc/ntt_digit.cu and csrc/wgmma_s8.cuh. The replays below
# carry every address and register map of the two wgmma kernels in torch
# ops, so that the CPU tests hold the maps the card cannot show; their
# arithmetic is the plain versions'.
KBLOCK = 128                     # contraction bytes of a stage row
TILE_N = 256                     # accumulator columns of one m64n256k32
DOT_BM = 128                     # the dot's output rows a block


def level_block_rows(F: int) -> int:
    """BM, the positions a fused-level block digitizes: 128 (two warpgroups
    of 64 rows) for F <= 128, 64 for F = 256, 32 for F = 512 (one
    warpgroup, whose rows 32-63 run into the next k-block and are
    dropped); the tile is BM x 8F bytes, 128 KB at most."""
    return 128 if F <= 128 else 64 if F == 256 else 32


def sw128(row, col):
    """The kernels' byte offset of (row, col) in a tile of 128-byte rows
    under the 128-byte swizzle (csrc/ntt_digit.cu::sw128)."""
    return row * KBLOCK + ((((col >> 4) ^ row) & 7) << 4) + (col & 15)


def swizzled(addr):
    """Where the hardware keeps logical byte ``addr`` of a 1024-byte
    aligned region under the 128-byte swizzle (a TMA copy's destination,
    a wgmma descriptor's source): address bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def operand_addr(start, rows: int):
    """(rows, 32) logical offsets a K-major wgmma operand reads for one k32
    step whose descriptor starts at ``start`` (stride 1024 between 8-row
    groups, 128-byte rows)."""
    i = torch.arange(rows)[:, None]
    return start + (i // 8) * 1024 + (i % 8) * KBLOCK + torch.arange(32)


def acc_coord(reg):
    """(row, column) of accumulator register ``reg`` of lane 4 g + t in
    warp w of a warpgroup, as offsets: row 16 w + g + ``row``, column
    2 t + ``col`` (wgmma's D fragment of m64nNk32 with 32-bit sums)."""
    return 8 * ((reg >> 1) & 1), 8 * (reg >> 2) + (reg & 1)


def _product(a, b):
    """Exact int32 sums of int8 operands: (..., M, K) x (N, K) -> (..., M, N)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64).mT).to(torch.int64)


def _smem_read(smem, addr):
    """Bytes of ``smem`` (..., L) at the hardware's location of the logical
    offsets ``addr``."""
    return smem[..., swizzled(addr)]


def level_replay(x: torch.Tensor, vd: torch.Tensor, W=None, k_prod: int = 1,
                 scale=None) -> torch.Tensor:
    """The fused level's route (``level_plain``'s contract): per block of BM
    positions, the 16-byte digitize stores into the swizzled tile; per
    256-column n-tile, each warpgroup's descriptor reads of its 64 rows and
    of the table stages (256-row TMA boxes), the m64n256k32 sums, and the
    epilogue's gather of the 8 planes of a frequency from one thread's
    accumulators to its 16-byte stores."""
    B, F, R = x.shape
    K, BM = NA * F, level_block_rows(F)
    NC = 2 if BM == 128 else 1
    KB, nblk = K // KBLOCK, -(-R // BM)
    table = kernel_table(vd, F)
    # digitize: value m of row rl is byte 8 (m % 2) + a of chunk
    # p = (m % 16) / 2 of the row in k-block m / 16
    rl, m, a = torch.meshgrid(torch.arange(BM), torch.arange(F), torch.arange(NA),
                              indexing="ij")
    chunk = sw128(rl, 16 * ((m % 16) // 2))
    if (chunk % 16).any():
        raise AssertionError("a digitize store is not 16-byte aligned")
    waddr = (m // 16) * BM * KBLOCK + chunk + 8 * (m % 2) + a
    d = digitize_plain(x).reshape(B, NA, F, R)
    d = torch.nn.functional.pad(d, (0, nblk * BM - R)).reshape(B, NA, F, nblk, BM)
    # shared memory by physical byte: the kernel's stores name physical
    # offsets, the descriptor reads logical ones (``_smem_read``)
    smem = torch.zeros((B, nblk, BM * K + 64 * KBLOCK), dtype=torch.int8)
    smem[:, :, waddr.reshape(-1)] = d.permute(0, 3, 4, 2, 1).reshape(B, nblk, -1)
    planes = torch.zeros((B, nblk * BM, F, NB), dtype=torch.int64)
    stage = torch.zeros((TILE_N * KBLOCK,), dtype=torch.int8)
    # epilogue: lane (w, g, t), row g + 8 h, group c, frequency e, plane j
    w, g, t, h, c, e, j = torch.meshgrid(*(torch.arange(n) for n in (
        4, 8, 4, 2, 4, 2, NB)), indexing="ij")
    reg = 4 * (8 * c + 4 * e + j // 2) + 2 * h + (j & 1)
    drow, dcol = acc_coord(reg)
    row, col = 16 * w + g + drow, 2 * t + dcol
    if not torch.equal(row, 16 * w + g + 8 * h):
        raise AssertionError("the epilogue reads another row's sums")
    for nt in range(K // TILE_N):
        b_ops = []
        for kb in range(KB):                       # one TMA box a stage
            box = table[nt * TILE_N:(nt + 1) * TILE_N, kb * KBLOCK:(kb + 1) * KBLOCK]
            stage[swizzled(torch.arange(TILE_N * KBLOCK))] = box.reshape(-1)
            b_ops += [_smem_read(stage, operand_addr(32 * kk, TILE_N))
                      for kk in range(4)]
        b_ops = torch.cat(b_ops, -1)                             # (256, K)
        k = nt * 32 + 8 * c + 2 * t + e
        for wgi in range(NC):
            a_ops = torch.cat([_smem_read(smem, operand_addr(
                kb * BM * KBLOCK + wgi * 64 * KBLOCK + 32 * kk, 64))
                for kb in range(KB) for kk in range(4)], -1)     # (B, nblk, 64, K)
            D = _product(a_ops, b_ops)                           # (B, nblk, 64, 256)
            rows = wgi * 64 + row.reshape(-1)
            keep = rows < BM
            prow = (torch.arange(nblk) * BM)[:, None] + rows[keep]
            vals = D[:, :, row.reshape(-1), col.reshape(-1)]
            planes[:, prow, k.reshape(-1)[keep], j.reshape(-1)[keep]] = vals[:, :, keep]
    planes = planes[:, :R]
    Rm = planes.permute(0, 1, 3, 2).reshape(B, R, NB * F).to(torch.int32)
    return recombine_plain(Rm, F, W, k_prod, scale)


def dot_block(it: int, lane):
    """(cg, kg): the 4 x 4 byte block a dot lane moves on iteration ``it``
    (csrc/ntt_digit.cu::block_of)."""
    q, sub = it & 7, it >> 3
    a, b, z = lane & 3, (lane >> 2) & 3, lane >> 4
    a2 = (((b >> 1) ^ q) & 1) | (((z ^ (q >> 2)) & 1) << 1)
    b2 = (((a >> 1) ^ (q >> 1)) & 1) | (z << 1)
    cg = 16 * (sub & 1) + 4 * a2 + a + 32 * (sub >> 2)
    kg = 16 * ((sub >> 1) & 1) + 4 * b2 + b
    return cg, kg


def dot_offsets(w: int, lane):
    """(S, D): warp ``w``'s lane offsets for its first iteration
    (csrc/ntt_digit.cu::moves_of)."""
    a, b, z = lane & 3, (lane >> 2) & 3, lane >> 4
    cg0 = 4 * ((((b >> 1) ^ w) & 1) | (((z ^ (w >> 2)) & 1) << 1)) + a
    kg0 = 4 * ((((a >> 1) ^ (w >> 1)) & 1) | (z << 1)) + b
    S = 512 * kg0 + 16 * ((cg0 >> 2) ^ (4 * (b & 1))) + 4 * (cg0 & 3)
    D = 512 * cg0 + 16 * ((kg0 >> 2) ^ (4 * (a & 1))) + 4 * (kg0 & 3)
    return S, D


def dot_move_words(S, D, ii: int, j: int):
    """(source, destination) offsets of word j on iteration ``ii`` (``move``)."""
    src = (S ^ (16 * (j ^ (4 * (ii & 1))))) + 128 * j + 8192 * ((ii >> 1) & 1) + \
        16384 * (ii >> 2)
    dst = (D ^ (16 * (j ^ (4 * ((ii >> 1) & 1))))) + 128 * j + 8192 * (ii & 1) + \
        16384 * (ii >> 2)
    return src, dst


def dot_moves(iters: int):
    """(src, dst) byte offsets of the 4 x 4 transposes over a tile of
    ``iters`` warp iterations (32: A's 128 x 128, 64: V's 128 x 256; warp w
    takes it = w + 8 ii): byte i of source word j lands in byte j of
    destination word i."""
    lane = torch.arange(32)
    src, dst = [], []
    for it in range(iters):
        S, D = dot_offsets(it % 8, lane)
        words = [dot_move_words(S, D, it // 8, j) for j in range(4)]
        sw = torch.stack([w for w, _ in words], 1)            # (lanes, j)
        dw = torch.stack([d for _, d in words], 1)            # (lanes, i)
        src.append((sw[:, :, None] + torch.arange(4)).reshape(-1))   # (lanes, j, i)
        dst.append((dw[:, None, :] + torch.arange(4)[None, :, None]).reshape(-1))
    return torch.cat(src), torch.cat(dst)


def digit_dot_replay(d: torch.Tensor, vd: torch.Tensor) -> torch.Tensor:
    """The dot's route (``digit_dot_plain``'s contract): per block of 128
    rows x 256 columns and k-block of 128, TMA's swizzled boxes of A and
    V (zeros past R, K and N), the 8 warps' 4 x 4 transposes into the
    K-major tiles (``dot_moves``), each warpgroup's descriptor reads and
    m64n256k32 sums, and the epilogue's pair exchange into 16-byte
    stores."""
    B, K, R = d.shape
    N = vd.shape[1]
    KT, nr, nn = -(-K // KBLOCK), -(-R // DOT_BM), -(-N // TILE_N)
    a = torch.nn.functional.pad(d, (0, nr * DOT_BM - R, 0, KT * KBLOCK - K))
    v = torch.nn.functional.pad(vd, (0, nn * TILE_N - N, 0, KT * KBLOCK - K))
    # raw boxes as TMA writes them: (row k, 128 bytes) at swizzled offsets
    a_raw = a.reshape(B, KT, KBLOCK, nr, DOT_BM).permute(0, 3, 1, 2, 4)
    v_raw = v.reshape(KT, KBLOCK, nn, 2, KBLOCK).permute(2, 0, 3, 1, 4)
    a_raw = a_raw.reshape(B, nr, KT, -1)[..., swizzled(torch.arange(KBLOCK * DOT_BM))]
    v_raw = v_raw.reshape(nn, KT, -1)[..., swizzled(torch.arange(KBLOCK * TILE_N))]
    sa, da = dot_moves(32)
    sb, db = dot_moves(64)
    if sorted(da.tolist()) != list(range(KBLOCK * DOT_BM)) or \
            sorted(db.tolist()) != list(range(KBLOCK * TILE_N)):
        raise AssertionError("the transposes do not fill each K-major byte once")
    a_k = torch.zeros_like(a_raw)
    a_k[..., da] = a_raw[..., sa]
    v_k = torch.zeros_like(v_raw)
    v_k[..., db] = v_raw[..., sb]
    out = torch.zeros((B, nr * DOT_BM, nn * TILE_N), dtype=torch.int64)
    for wgi in range(2):
        a_ops = torch.cat([_smem_read(a_k[:, :, i], operand_addr(
            wgi * 64 * KBLOCK + 32 * kk, 64)) for i in range(KT) for kk in range(4)],
            -1)                                                     # (B, nr, 64, K')
        b_ops = torch.cat([_smem_read(v_k[:, i], operand_addr(32 * kk, TILE_N))
                           for i in range(KT) for kk in range(4)], -1)  # (nn, 256, K')
        D = _product(a_ops[:, :, None], b_ops)                      # (B, nr, nn, 64, 256)
        # epilogue: lane (w, g, t) and chunk i; the odd lane of a pair
        # stores row g + 8 with its partner's two sums first
        w, g, t, i = torch.meshgrid(*(torch.arange(n) for n in (4, 8, 4, 32)),
                                    indexing="ij")
        # (registers 4 i + 2 odd and + 1 of both lanes: the partner sends the
        # pair of the row this lane stores)
        odd = t & 1
        pair = 4 * i + 2 * odd
        row = 16 * w + g + 8 * odd
        col = 8 * i + 2 * (t & 2)
        if (col % 4).any():
            raise AssertionError("a dot store is not 16-byte aligned")
        regs = torch.stack([pair, pair + 1, pair, pair + 1], -1)
        first = torch.where(odd.bool(), t ^ 1, t)[..., None]
        lanes = torch.cat([first, first, first ^ 1, first ^ 1], -1)
        rr, cc = acc_coord(regs)
        src_row = 16 * w[..., None] + g[..., None] + rr
        src_col = 2 * lanes + cc
        if not (torch.equal(src_row, row[..., None].expand_as(src_row)) and
                torch.equal(src_col, col[..., None] + torch.arange(4))):
            raise AssertionError("a dot store holds sums of another row or column")
        vals = D[..., src_row.reshape(-1), src_col.reshape(-1)]
        dst_col = (col[..., None] + torch.arange(4)).reshape(-1)
        rows = (torch.arange(nr) * DOT_BM)[:, None] + wgi * 64 + row[..., None].expand_as(
            src_row).reshape(-1)
        cols = (torch.arange(nn) * TILE_N)[:, None] + dst_col
        out[:, rows[:, None, :], cols[None, :, :]] = vals
    return out[:, :R, :N].to(torch.int32)
