"""Four-step NTT (n = n1 * n2) in two passes, over Goldilocks and BabyBear.

Port of ``ministark_tpu/ops/ntt_pallas.py`` (``_make_pass1_kernel`` :190,
``_make_pass2_kernel`` :204, ``_make_passes`` :215, ``make_pallas_ntt_fns``
:297; BabyBear with ``nlimbs = 1``, :64-67). With x[i2 * n1 + i1] read as
the (n2, n1) matrix A[i2, i1], w of order n, w1 = w^n2 and w2 = w^n1:

  X[k2 + n2 * k1] = sum_i1 w1^(i1 k1) * w^(i1 k2) * [sum_i2 A[i2, i1] w2^(i2 k2)]

  pass 1: per column i1, all log2(n2) DIT stages over the bit-reversed rows
          (with the coset pre-multiply), then the twiddle w^(i1 k2):
          (batch, n) -> C (batch, n2, n1);
  pass 2: per row k2 of C, all log2(n1) DIF stages, written to
          X[k2 + n2 k1] with the bit-reversed k1, 1/n and the coset
          post-multiply folded in: C -> (batch, n).

Each pass dispatches by device: a CPU tensor takes ``pass1_plain`` /
``pass2_plain`` (torch ops with the plain multiply, ``ntt.NttField.mul``), a
CUDA tensor launches its kernel in csrc/ntt_four_step.cu (the ``_gl`` or
``_bb`` symbol) or raises. Every function takes the prime field
(``field=``, Goldilocks unless given). The TPU's limb-planar layout
and 128-lane tiles stay behind: a value is one int64 u64 pattern, and the
kernels tile by 8 columns (pass 1) and 8 rows (pass 2).
"""

from __future__ import annotations

import torch

from ..fields import GOLDILOCKS_FP
from . import cuda
from .field import pack_u64
from .ntt import (
    _log2,
    _roots,
    bitrev,
    dif_last,
    dit_last,
    inv_n,
    ntt_field,
    offset_square_table,
    powers_plain,
    stage_table,
    transform_fns,
    twiddles,
)

MIN_N = 1 << 14   # the JAX package's PALLAS_MIN
MAX_N = 1 << 22   # its PALLAS_MAX; pass 1 holds 8 columns x 2^11 rows (128 KB)

# Incremented once per call that launches each kernel, per field.
pass1_launches = {"gl": 0, "bb": 0}
pass2_launches = {"gl": 0, "bb": 0}


def _split_sizes(n: int):
    """(n1, n2) with n = n1 * n2, n2 = 2^floor(log2(n) / 2) <= n1."""
    log_n = n.bit_length() - 1
    n2 = 1 << (log_n // 2)
    return n // n2, n2


def supports(n: int) -> bool:
    return MIN_N <= n <= MAX_N and n & (n - 1) == 0


def _tables(n: int, inverse: bool, device, field=GOLDILOCKS_FP):
    """(tw1, tw2, wpow): the stage tables of w1 (length n1) and w2
    (length n2) and the column bases w^i1 for i1 < n1."""
    n1, n2 = _split_sizes(n)
    root = _roots(field, n, inverse)
    return (stage_table(field, pow(root, n2, field.p), n1, device),
            stage_table(field, pow(root, n1, field.p), n2, device),
            twiddles(field, root, 2 * n1, device))


def _pow_ladder(base: torch.Tensor, rows: int, mul) -> torch.Tensor:
    """T[k, i] = base[i]^k for k < rows (``ntt_pallas.py::_pow_ladder``):
    rows [m, 2m) are rows [0, m) times base^m."""
    T = torch.ones_like(base).unsqueeze(0)
    pm = base
    while T.shape[0] < rows:
        T = torch.cat([T, mul(T, pm)])
        pm = mul(pm, pm)
    return T[:rows]


def pass1_plain(x: torch.Tensor, tw2: torch.Tensor, wpow: torch.Tensor,
                pre=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """Plain version of pass 1: (batch, n) natural order -> C (batch, n2, n1).
    ``pre``: coset offset s multiplied in as s^i first."""
    mul = ntt_field(field).mul
    batch, n = x.shape
    n1, n2 = _split_sizes(n)
    if pre is not None:
        x = mul(x, powers_plain(field, pre, n, x.device))
    a = x.reshape(batch, n2, n1)[:, bitrev(n2, x.device)]
    c = dit_last(a.transpose(1, 2), tw2, field).transpose(1, 2)   # (batch, k2, i1)
    return mul(c, _pow_ladder(wpow, n2, mul))


def pass2_plain(c: torch.Tensor, tw1: torch.Tensor, scale=None,
                post=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """Plain version of pass 2: C (batch, n2, n1) -> (batch, n) natural
    order, times ``scale`` and then s^i for a coset offset ``post``."""
    mul = ntt_field(field).mul
    batch, n2, n1 = c.shape
    d = dif_last(c, tw1, field)[:, :, bitrev(n1, c.device)]     # (batch, k2, k1)
    y = d.transpose(1, 2).reshape(batch, n1 * n2)
    if scale is not None:
        y = mul(y, pack_u64(scale, y.device))
    if post is not None:
        y = mul(y, powers_plain(field, post, n1 * n2, y.device))
    return y


def pass1_cuda(x: torch.Tensor, tw2: torch.Tensor, wpow: torch.Tensor,
               pre=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """CUDA kernel (csrc/ntt_four_step.cu ``four_step_pass1``), same contract
    as ``pass1_plain``. Replaces ``ntt_pallas.py::_make_pass1_kernel``."""
    tag = ntt_field(field).tag
    cuda.require(x, "four_step pass 1", torch.int64, 2)
    batch, n = x.shape
    n1, n2 = _split_sizes(n)
    c = torch.empty((batch, n2, n1), dtype=torch.int64, device=x.device)
    pre_t = (None if pre is None
             else offset_square_table(field, pre, _log2(n), x.device))
    if batch:
        err = getattr(cuda.library(), f"ms_ntt_four_step_pass1_{tag}")(
            x.data_ptr(), c.data_ptr(), batch, n1.bit_length() - 1,
            n2.bit_length() - 1, tw2.data_ptr(), wpow.data_ptr(),
            None if pre_t is None else pre_t.data_ptr(), cuda.stream_ptr(x))
        cuda.check("four_step pass 1", err)
        pass1_launches[tag] += 1
    return c


def pass2_cuda(c: torch.Tensor, tw1: torch.Tensor, scale=None,
               post=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """CUDA kernel (csrc/ntt_four_step.cu ``four_step_pass2``), same contract
    as ``pass2_plain``. Replaces ``ntt_pallas.py::_make_pass2_kernel``."""
    tag = ntt_field(field).tag
    cuda.require(c, "four_step pass 2", torch.int64, 3)
    batch, n2, n1 = c.shape
    y = torch.empty((batch, n1 * n2), dtype=torch.int64, device=c.device)
    post_t = (None if post is None
              else offset_square_table(field, post, _log2(n1 * n2), c.device))
    if batch:
        err = getattr(cuda.library(), f"ms_ntt_four_step_pass2_{tag}")(
            c.data_ptr(), y.data_ptr(), batch, n1.bit_length() - 1,
            n2.bit_length() - 1, tw1.data_ptr(),
            None if post_t is None else post_t.data_ptr(),
            1 if scale is None else scale, cuda.stream_ptr(c))
        cuda.check("four_step pass 2", err)
        pass2_launches[tag] += 1
    return y


def pass1(x, tw2, wpow, pre=None, field=GOLDILOCKS_FP):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if x.device.type == "cpu":
        return pass1_plain(x, tw2, wpow, pre, field)
    return pass1_cuda(x, tw2, wpow, pre, field)


def pass2(c, tw1, scale=None, post=None, field=GOLDILOCKS_FP):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if c.device.type == "cpu":
        return pass2_plain(c, tw1, scale, post, field)
    return pass2_cuda(c, tw1, scale, post, field)


def transform(x: torch.Tensor, inverse: bool = False, pre=None, post=None,
              field=GOLDILOCKS_FP):
    """The ``ntt.transform`` contract for 2^14 <= n <= 2^22: (batch, n)
    natural order in and out; ``pre``/``post`` coset offsets multiplied in as
    s^i before / after, ``inverse`` with the inverse root and 1/n."""
    n = x.shape[1]
    if not supports(n):
        raise ValueError(f"four-step NTT takes 2^14 <= n <= 2^22, got {n}")
    tw1, tw2, wpow = _tables(n, inverse, x.device, field)
    scale = inv_n(field, n) if inverse else None
    return pass2(pass1(x, tw2, wpow, pre, field), tw1, scale, post, field)


def make_four_step_ntt_fns(field, n: int):
    """(fft, ifft, coset_fft, coset_ifft) with the ``ntt.get_ntt_fns``
    contract (``make_pallas_ntt_fns`` :297), for ``supports(n)`` sizes of
    Goldilocks or BabyBear."""
    ntt_field(field)
    if not supports(n):
        raise ValueError(f"four-step NTT takes 2^14 <= n <= 2^22, got {n}")
    return transform_fns(transform, field)
