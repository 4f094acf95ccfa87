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
a level is radix-2 butterflies with the same root, run by the kernel as
radix-2's tile (csrc/ntt_stages.cuh) with a swizzled address map.
``level_replay`` replays the kernel's route in torch ops for the tests
(the tile's copy units, swizzle and store lanes are ``load_units``,
``tile_addr`` and ``store_lanes``). The TPU kernel's guard-free mode
(``MINISTARK_MXU_PIPE=2``) gives the same output and has no twin here.
"""

from __future__ import annotations

import torch

from ..fields import GOLDILOCKS_FP
from . import cuda
from .field import get_ops, pack_u64
from .ntt import (
    _coset_powers,
    _log2,
    _roots,
    bitrev,
    coset_split,
    coset_tables,
    dit_last,
    inv_n,
    ntt_field,
    powers_plain,
    stage_table,
    stages_replay,
    transform_fns,
)
from .poly import powers

F_PREF = 8        # preferred log2 factor (``ntt_mxu.F_PREF``)
MIN_N = 1 << 14   # ``fused_supports``' size floor
TILE_LOG = 11     # a kernel tile's F C values, for C >= 16 (csrc/ntt_pipe.cu)
MIN_LOG_C = 4     # at least 16 columns (fewer only where R is smaller)

# Per field, whether level 0 takes its twiddle W[i1, k] = r^(i1 k) from two
# tables of ~sqrt(n) words, else the row of W, each timed against the other
# on an H100 80GB HBM3 at 700 W (scripts/torch_ntt_probe.py --backend pipe
# --variants --rounds 5; PERF.md, row 5). Level 0's W is the whole n-word
# table (16 MB at 2^21), which each row of the batch reads again from
# device memory: BabyBear, near its byte bound, reads the split 6-18%
# faster there at every level-0 size the provers run (ifft (3, 2^20) to
# fft (24, 2^21)); Goldilocks, bound by its operations, reads the rows
# 4-7% faster. Later levels' W (n / K_prod words) stays in cache, and both
# fields read their rows 6-10% faster there.
SPLIT_W = {"gl": False, "bb": True}

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


_SPLITS = {}


def w_split_tables(n: int, inverse: bool, device, field=GOLDILOCKS_FP):
    """Per level, the tables of the SPLIT_W store: W_i[i1, k] = r_i^e for
    e = i1 k < F_i M_i is lo[e mod 2^h] * hi[e >> h] (the form of
    ``ntt.coset_tables`` for W_i's root r_i over F_i M_i exponents, h =
    ``coset_split``); None on the last level. Cached per (field, n,
    direction, device), as ``_tables``."""
    key = (field.p, n, inverse, str(device))
    if key not in _SPLITS:
        out, rem, r = [], n, _roots(field, n, inverse)
        for lf in factorize(n)[:-1]:
            log_e = _log2(rem)
            h = coset_split(log_e)
            out.append((powers_plain(field, r, 1 << h, device),
                        powers_plain(field, pow(r, 1 << h, field.p), 1 << (log_e - h),
                                     device)))
            r = pow(r, 1 << lf, field.p)
            rem >>= lf
        _SPLITS[key] = out + [None]
    return _SPLITS[key]


def level_splits(n: int, inverse: bool, device, field=GOLDILOCKS_FP):
    """Per level, the ``w_split`` that ``transform`` hands the kernel:
    level 0's split tables where ``SPLIT_W`` takes them for this field,
    else None."""
    out = [None] * len(factorize(n))
    if SPLIT_W[ntt_field(field).tag]:
        out[0] = w_split_tables(n, inverse, device, field)[0]
    return out


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
               k_prod: int = 1, scale=None, field=GOLDILOCKS_FP,
               w_split=None) -> torch.Tensor:
    """CUDA kernel (csrc/ntt_pipe.cu ``pipe_level``), same contract as
    ``level_plain``. Replaces ``ntt_mxu.py::_make_pipe_kernel``. The
    kernel reads the last row of ``tw`` (the stage roots) and, for ``pre``,
    the cached ``ntt.coset_tables`` of s over F R; ``w_split`` (W's tables
    from ``w_split_tables``) gives the two-table twiddle in place of W's
    rows."""
    tag = ntt_field(field).tag
    cuda.require_aligned(x, "pipe level", torch.int64, 3)
    B, Fi, R = x.shape
    log_f, log_r = _log2(Fi), _log2(R)
    tables = [("stage table", tw, (log_f, Fi // 2))]
    if W is not None:
        tables.append(("twiddles", W, (R // k_prod, Fi)))
    if w_split is not None:
        if W is None:
            raise ValueError("pipe level: w_split replaces the rows of a W")
        log_e = log_f + _log2(R // k_prod)
        h = coset_split(log_e)
        tables += [("twiddle split lo", w_split[0], (1 << h,)),
                   ("twiddle split hi", w_split[1], (1 << (log_e - h),))]
    for name, t, shape in tables:
        cuda.require(t, f"pipe level {name}", torch.int64, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"pipe level: expected a {shape} {name}, got "
                             f"{tuple(t.shape)}")
    y = torch.empty((B, R, Fi), dtype=torch.int64, device=x.device)
    lo, hi = (None, None) if pre is None else coset_tables(field, pre, log_f + log_r,
                                                           x.device)
    w_lo, w_hi = (None, None) if w_split is None else w_split
    if B:
        err = getattr(cuda.library(), f"ms_ntt_pipe_level_{tag}")(
            x.data_ptr(), y.data_ptr(), B, log_f, log_r,
            *(None if t is None else t.data_ptr() for t in (tw[-1], lo, hi, W, w_lo, w_hi)),
            _log2(k_prod), 1 if scale is None else scale, cuda.stream_ptr(x))
        cuda.check("pipe level", err)
        launches[tag] += 1
    return y


def level(x, tw, pre=None, W=None, k_prod=1, scale=None, field=GOLDILOCKS_FP,
          w_split=None):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise);
    ``w_split``, the kernel's other form of W, leaves the result as it is."""
    if x.device.type == "cpu":
        return level_plain(x, tw, pre, W, k_prod, scale, field)
    return level_cuda(x, tw, pre, W, k_prod, scale, field, w_split=w_split)


# ------------------------------------------------- the kernel's route, replayed
def tile_log_c(log_f: int, log_r: int) -> int:
    """log2 of the kernel tile's columns: C = max(16, 2^11 / F), at most R."""
    return min(log_r, max(MIN_LOG_C, TILE_LOG - log_f))


def swizzle(m, log_c: int):
    """The word XORed into a column of tile row m (``Swizzled``): the row's
    bits select the 16-byte chunk, so that 8 consecutive rows of one column
    (and each copy's 128-byte line) meet 8 different chunk banks."""
    if log_c >= 4:
        shift, mask = 0, 7
    else:
        shift, mask = 4 - log_c, (1 << (log_c - 1)) - 1 if log_c else 0
    return ((m >> shift) & mask) << 1


def tile_addr(m, c, log_c: int):
    """The tile's word of row m, column c."""
    return (m << log_c) + (c ^ swizzle(m, log_c))


def load_units(log_f: int, log_c: int, device="cpu"):
    """The kernel's copy units (``load_tile``), in the order the threads
    take them: unit u copies 16 bytes (columns c and c + 1; 8 bytes, column
    0, where C = 1) of source position brev(q) into the tile's words from
    ``word``. (word, q, c), one entry a unit."""
    log_unit = 1 if log_c else 0
    u = torch.arange((1 << (log_f + log_c)) >> log_unit, device=device)
    log_upr = log_c - log_unit
    q = u >> log_upr
    c = ((u & ((1 << log_upr) - 1)) << log_unit) ^ swizzle(q, log_c)
    return u << log_unit, q, c


def store_lanes(log_f: int, log_c: int, device="cpu"):
    """The store's (k, c) of element e, in the order the threads take them:
    8 consecutive k of up to 4 columns a warp."""
    lc = min(2, log_c)
    e = torch.arange(1 << (log_f + log_c), device=device)
    k = (e & 7) | (((e >> (3 + lc)) & ((1 << (log_f - 3)) - 1)) << 3)
    c = ((e >> 3) & ((1 << lc) - 1)) | ((e >> (log_f + lc)) << lc)
    return k, c


def level_replay(x: torch.Tensor, tw: torch.Tensor, pre=None, W=None,
                 k_prod: int = 1, scale=None, field=GOLDILOCKS_FP,
                 w_split=None) -> torch.Tensor:
    """The kernel's route in torch ops (``level_plain``'s contract): per
    tile of C adjacent r, the copy units into the swizzled tile, the stage
    rounds of ``ntt.stages_replay`` with the stage roots (the first round
    multiplying each value by its coset power lo * hi as it reads it), and
    the store's lanes times W's row (or, with ``w_split``, lo * hi of
    e = (r // K) k) and the scale."""
    F = ntt_field(field)
    B, Fi, R = x.shape
    log_f, log_r, dev = _log2(Fi), _log2(R), x.device
    log_c = tile_log_c(log_f, log_r)
    r0 = torch.arange(R >> log_c, device=dev) << log_c              # a tile's first r
    word, q, c = load_units(log_f, log_c, dev)
    j = torch.arange(2 if log_c else 1, device=dev)
    rev = bitrev(Fi, dev)
    src = (rev[q] << log_r)[:, None] + c[:, None] + j               # (units, width)
    s = torch.zeros((B, R >> log_c, Fi << log_c), dtype=torch.int64, device=dev)
    s[:, :, word[:, None] + j] = x.reshape(B, Fi * R)[:, src + r0[:, None, None]]

    def coset(v, pos, cols):       # v: (B, tiles, groups, 2^R, C)
        idx = ((rev[pos] << log_r) + cols)[None] + r0[:, None, None, None]
        return F.mul(v, _coset_powers(tables, idx, log_f + log_r, F.mul))

    tables = None if pre is None else coset_tables(field, pre, log_f + log_r, dev)
    s = stages_replay(s, tw[-1], log_f, log_c,
                      lambda pos, cols: tile_addr(pos[..., None], cols, log_c), F,
                      None if pre is None else coset)
    k, cs = store_lanes(log_f, log_c, dev)
    v = s[:, :, tile_addr(k, cs, log_c)]                            # (B, tiles, e)
    r = r0[:, None] + cs
    if W is not None:
        row = r // k_prod
        if w_split is None:
            w = W[row, k]
        else:
            w = _coset_powers(w_split, row * k, log_f + _log2(W.shape[0]), F.mul)
        v = F.mul(v, w)
    if scale is not None:
        v = F.mul(v, pack_u64(scale, dev))
    y = torch.empty((B, R, Fi), dtype=torch.int64, device=dev)
    y[:, r, k.expand_as(r)] = v
    return y


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
    splits = level_splits(n, inverse, x.device, field)
    scale = inv_n(field, n) if inverse else None
    y = x
    for i, ((Fi, tw, W, k_prod), w_split) in enumerate(zip(levels, splits)):
        last = i == len(levels) - 1
        y = level(y.reshape(B, Fi, n // Fi), tw, pre if i == 0 else None, W,
                  k_prod, scale if last else None, field, w_split)
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
