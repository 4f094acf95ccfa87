"""The factor-walk NTT with one pipelined level kernel per factor, over
Goldilocks and BabyBear.

Port of ``ministark_tpu/ops/ntt_mxu.py``'s fused factor walk with the
pipelined level (``_make_pipe_kernel`` :486, ``_fused_level_pipe`` :566,
``_mxu_core_fused`` :640-662, ``_build_tables`` :696, ``make_mxu_ntt_fns``
:763-845 with ``MINISTARK_MXU_PIPE=1``). n = F_0 * ... * F_(k-1) with every
F in [2^5, 2^9] (``factorize``); x is read as (B, F_0, ..., F_(k-1)) and level
i takes a length-F_i DFT over axis 1 of (B, F_i, R_i), writing (B, R_i, F_i)
(the new frequency axis last):

  out[b, r, k] = (sum_m x[b, m, r] * w_i^(m k)) * W_i[r // K_i, k] * scalar

with w_i the level's root (of order F_i), W_i[i1, k2] = r_i^(i1 k2) the
inter-level twiddle over the M_i = n / (F_0 ... F_i) positions still to
transform (r_i the root of order F_i M_i), K_i = F_0 ... F_(i-1) the
frequency axes already produced, the coset pre-multiply on level 0 and 1/n on
the last level of an inverse transform. One axis-reversing permute at the
end gives natural order (``_mxu_core_fused`` :661-662).

``level`` dispatches by device: a CPU tensor takes ``level_plain`` (torch
ops with the plain multiply, ``ntt.NttField.mul``), a CUDA tensor launches
``pipe_level`` (csrc/ntt_pipe.cu, the ``_gl`` or ``_bb`` symbol) or raises.
Every function takes the prime field (``field=``, Goldilocks unless
given). The TPU's int8 digit matrices, recombination constants and F = 32
table padding stay behind: the card multiplies 64-bit integers natively, so
a level is radix-2 butterflies with the same root.
The TPU kernel's guard-free mode (``MINISTARK_MXU_PIPE=2``) gives the same
output and has no twin here.
"""

from __future__ import annotations

import torch

from ..fields import GOLDILOCKS_FP
from . import cuda
from .field import get_ops, pack_u64
from .ntt import (
    _log2,
    _roots,
    bitrev,
    dit_last,
    inv_n,
    ntt_field,
    offset_square_table,
    powers_plain,
    stage_table,
    transform_fns,
)
from .poly import powers

F_PREF = 8        # preferred log2 factor (``ntt_mxu.F_PREF``)
MIN_N = 1 << 14   # ``fused_supports``' size floor

# Incremented once per call that launches the level kernel, per field.
launches = {"gl": 0, "bb": 0}


def factorize(n: int):
    """log2 factor list for n, each in [5, 9] (prefer <= F_PREF, balanced,
    descending), as ``ntt_mxu.factorize``. None if n is unsupported."""
    L = n.bit_length() - 1
    if (1 << L) != n or L < 5:
        return None
    if L <= 9:
        return [L]
    k = -(-L // F_PREF)
    base, rem = divmod(L, k)
    return [base + 1] * rem + [base] * (k - rem)


def fused_supports(n: int) -> bool:
    """The sizes the pipelined levels take (``ntt_mxu.fused_supports``)."""
    f = factorize(n)
    return f is not None and n >= MIN_N and min(f) >= 5


def _twiddle_matrix(field, root: int, M: int, Fi: int, device) -> torch.Tensor:
    """W[i1, k2] = root^(i1 k2), (M, Fi) (``ntt_device._twiddle_matrix``):
    the powers of root^k2 by doubling over the rows."""
    ops = get_ops(field)
    row = powers(ops, pack_u64(root, device), Fi)             # root^k2
    W = torch.ones_like(row).unsqueeze(0)
    step = row
    while W.shape[0] < M:
        W = torch.cat([W, ops.mul(W, step)])
        step = ops.mul(step, step)
    return W[:M].contiguous()


_TABLES = {}


def _tables(n: int, inverse: bool, device, field=GOLDILOCKS_FP):
    """Per level: (F_i, stage table of w_i, W_i or None, K_i), cached per
    (field, n, direction, device) as ``_build_tables`` builds them."""
    key = (field.p, n, inverse, str(device))
    if key not in _TABLES:
        levels = []
        rem, r, k_prod = n, _roots(field, n, inverse), 1
        factors = [1 << lf for lf in factorize(n)]
        for i, Fi in enumerate(factors):
            M = rem // Fi
            tw = stage_table(field, pow(r, M, field.p), Fi, device)
            W = None
            if i < len(factors) - 1:
                W = _twiddle_matrix(field, r, M, Fi, device)
                r = pow(r, Fi, field.p)
            levels.append((Fi, tw, W, k_prod))
            rem = M
            k_prod *= Fi
        _TABLES[key] = levels
    return _TABLES[key]


def level_plain(x: torch.Tensor, tw: torch.Tensor, pre=None, W=None,
                k_prod: int = 1, scale=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """Plain version of one level: (B, F, R) -> (B, R, F). ``tw``: the
    level's stage table; ``pre``: coset offset s multiplied in as
    s^(m R + r) first; ``W``: (R // k_prod, F) twiddles, row r // k_prod;
    ``scale``: a trailing scalar."""
    mul = ntt_field(field).mul
    B, Fi, R = x.shape
    if pre is not None:
        x = mul(x, powers_plain(field, pre, Fi * R, x.device).reshape(Fi, R))
    y = dit_last(x[:, bitrev(Fi, x.device)].transpose(1, 2), tw, field)  # (B, R, F)
    if W is not None:
        rows = torch.arange(R, device=x.device) // k_prod
        y = mul(y, W[rows])
    if scale is not None:
        y = mul(y, pack_u64(scale, y.device))
    return y


def level_cuda(x: torch.Tensor, tw: torch.Tensor, pre=None, W=None,
               k_prod: int = 1, scale=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """CUDA kernel (csrc/ntt_pipe.cu ``pipe_level``), same contract as
    ``level_plain``. Replaces ``ntt_mxu.py::_make_pipe_kernel``."""
    tag = ntt_field(field).tag
    cuda.require(x, "pipe level", torch.int64, 3)
    B, Fi, R = x.shape
    y = torch.empty((B, R, Fi), dtype=torch.int64, device=x.device)
    pre_t = (None if pre is None
             else offset_square_table(field, pre, _log2(Fi * R), x.device))
    if B:
        err = getattr(cuda.library(), f"ms_ntt_pipe_level_{tag}")(
            x.data_ptr(), y.data_ptr(), B, _log2(Fi), _log2(R), tw.data_ptr(),
            None if pre_t is None else pre_t.data_ptr(),
            None if W is None else W.data_ptr(), _log2(k_prod),
            1 if scale is None else scale, cuda.stream_ptr(x))
        cuda.check("pipe level", err)
        launches[tag] += 1
    return y


def level(x, tw, pre=None, W=None, k_prod=1, scale=None, field=GOLDILOCKS_FP):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if x.device.type == "cpu":
        return level_plain(x, tw, pre, W, k_prod, scale, field)
    return level_cuda(x, tw, pre, W, k_prod, scale, field)


def transform(x: torch.Tensor, inverse: bool = False, pre=None, post=None,
              field=GOLDILOCKS_FP):
    """The ``ntt.transform`` contract for ``fused_supports(n)`` sizes:
    (batch, n) natural order in and out; ``pre``/``post`` coset offsets
    multiplied in as s^i before / after, ``inverse`` with the inverse root
    and 1/n (on the last level, as ``make_mxu_ntt_fns`` :813-815)."""
    B, n = x.shape
    if not fused_supports(n):
        raise ValueError(f"the pipelined NTT does not take n = {n}")
    levels = _tables(n, inverse, x.device, field)
    scale = inv_n(field, n) if inverse else None
    y = x
    for i, (Fi, tw, W, k_prod) in enumerate(levels):
        last = i == len(levels) - 1
        y = level(y.reshape(B, Fi, n // Fi), tw, pre if i == 0 else None, W,
                  k_prod, scale if last else None, field)
    k = len(levels)
    perm = (0,) + tuple(range(k, 0, -1))
    y = y.reshape((B,) + tuple(Fi for Fi, _, _, _ in levels)).permute(perm)
    y = y.reshape(B, n)
    if post is not None:
        ops = get_ops(field)
        y = ops.mul(y, powers(ops, pack_u64(post, y.device), n))
    return y


def make_pipe_ntt_fns(field, n: int):
    """(fft, ifft, coset_fft, coset_ifft) with the ``ntt.get_ntt_fns``
    contract (``make_mxu_ntt_fns`` :763 with the pipelined levels), for
    ``fused_supports(n)`` sizes of Goldilocks or BabyBear."""
    ntt_field(field)
    if not fused_supports(n):
        raise ValueError(f"the pipelined NTT does not take n = {n}")
    return transform_fns(transform, field)
