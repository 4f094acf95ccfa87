"""Four-step NTT (n = n1 * n2) in two passes, over Goldilocks and BabyBear.

Port of ``ministark_tpu/ops/ntt_pallas.py`` (``_make_pass1_kernel`` :190,
``_make_pass2_kernel`` :204, ``_make_passes`` :215, ``make_pallas_ntt_fns``
:297; BabyBear with ``nlimbs = 1``, :64-67). With x[i2 * n1 + i1] read as
the (n2, n1) matrix A[i2, i1], w of order n, w1 = w^n2 and w2 = w^n1:

  X[k2 + n2 * k1] = sum_i1 w1^(i1 k1) * w^(i1 k2) * [sum_i2 A[i2, i1] w2^(i2 k2)]

  pass 1: per column i1, all log2(n2) DIT stages over the bit-reversed rows
          (with the coset pre-multiply), then the twiddle w^(i1 k2):
          (batch, n) -> C (batch, n2, n1);
  pass 2: per row k2 of C, the log2(n1)-point transform, written to
          X[k2 + n2 k1] in natural k1, 1/n and the coset post-multiply
          folded in: C -> (batch, n).

Each pass dispatches by device: a CPU tensor takes ``pass1_plain`` /
``pass2_plain`` (torch ops with the plain multiply, ``ntt.NttField.mul``), a
CUDA tensor launches its kernel in csrc/ntt_four_step.cu (the ``_gl`` or
``_bb`` symbol) or raises. Every function takes the prime field
(``field=``, Goldilocks unless given). The TPU's limb-planar layout
and 128-lane tiles stay behind: a value is one word of the field's dtype
(a Goldilocks int64 u64 pattern, a BabyBear int32), and a kernel's block
holds 4 columns (pass 1) or 4 rows of C (pass 2) in shared memory, loaded
bit-reversed, and runs the stages 3 at a time in registers
(csrc/ntt_stages.cuh). ``pass1_replay`` / ``pass2_replay`` replay the
kernels' route in torch ops for the tests, as ``ntt.transform_passes_plain``
does for the radix-2 kernel.
"""

from __future__ import annotations

import torch

from ..fields import GOLDILOCKS_FP
from . import cuda
from .ntt import (
    _coset_powers,
    _log2,
    _roots,
    bitrev,
    coset_tables,
    dif_last,
    dit_last,
    inv_n,
    ntt_field,
    powers_plain,
    stage_table,
    stages_replay,
    transform_fns,
    twiddles,
)

MIN_N = 1 << 14   # the JAX package's PALLAS_MIN
MAX_N = 1 << 22   # its PALLAS_MAX; a kernel's tile holds at most 2^11 positions
LOG_COLS = 2      # a kernel block's columns (pass 1) or rows of C (pass 2)

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
        y = mul(y, ntt_field(field).pack(scale, y.device))
    if post is not None:
        y = mul(y, powers_plain(field, post, n1 * n2, y.device))
    return y


def _kernel_tables(tw, offset, log_n: int, device, field, scale=None):
    """What a pass's kernel reads beside its input and the column bases:
    the stage roots w_m^j for j < m / 2 (the last row of the stage table
    ``tw``) and the coset tables (lo, hi) of ``offset`` from
    ``ntt.coset_tables`` (cached there), with ``scale`` (1/n) folded into
    hi; (roots, None, None) without a coset."""
    roots = tw[-1]
    if offset is None:
        return roots, None, None
    lo, hi = coset_tables(field, offset, log_n, device, 1 if scale is None else scale)
    return roots, lo, hi


def _require_tables(name, tables, shapes, dtype):
    for t, shape in zip(tables, shapes):
        cuda.require(t, name, dtype, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected a table of shape {shape}, got "
                             f"{tuple(t.shape)}")


def _ptrs(*tables):
    return [None if t is None else t.data_ptr() for t in tables]


def pass1_cuda(x: torch.Tensor, tw2: torch.Tensor, wpow: torch.Tensor,
               pre=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """CUDA kernel (csrc/ntt_four_step.cu ``four_step_pass1``), same contract
    as ``pass1_plain``. Replaces ``ntt_pallas.py::_make_pass1_kernel``."""
    tag, dtype = ntt_field(field).tag, ntt_field(field).dtype
    cuda.require(x, "four_step pass 1", dtype, 2)
    batch, n = x.shape
    n1, n2 = _split_sizes(n)
    _require_tables("four_step pass 1", (tw2, wpow),
                    ((_log2(n2), n2 // 2), (n1,)), dtype)
    c = torch.empty((batch, n2, n1), dtype=x.dtype, device=x.device)
    roots, lo, hi = _kernel_tables(tw2, pre, _log2(n), x.device, field)
    if batch:
        err = getattr(cuda.library(), f"ms_ntt_four_step_pass1_{tag}")(
            x.data_ptr(), c.data_ptr(), batch, _log2(n1), _log2(n2),
            *_ptrs(roots, wpow, lo, hi), cuda.stream_ptr(x))
        cuda.check("four_step pass 1", err)
        pass1_launches[tag] += 1
    return c


def pass2_cuda(c: torch.Tensor, tw1: torch.Tensor, scale=None,
               post=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """CUDA kernel (csrc/ntt_four_step.cu ``four_step_pass2``), same contract
    as ``pass2_plain``. Replaces ``ntt_pallas.py::_make_pass2_kernel``."""
    tag, dtype = ntt_field(field).tag, ntt_field(field).dtype
    cuda.require(c, "four_step pass 2", dtype, 3)
    batch, n2, n1 = c.shape
    _require_tables("four_step pass 2", (tw1,), ((_log2(n1), n1 // 2),), dtype)
    y = torch.empty((batch, n1 * n2), dtype=c.dtype, device=c.device)
    roots, lo, hi = _kernel_tables(tw1, post, _log2(n1 * n2), c.device, field, scale)
    if batch:
        # one product at the store: the post power (1/n in hi) or 1/n alone
        err = getattr(cuda.library(), f"ms_ntt_four_step_pass2_{tag}")(
            c.data_ptr(), y.data_ptr(), batch, _log2(n1), _log2(n2),
            *_ptrs(roots, lo, hi),
            1 if scale is None or post is not None else scale, cuda.stream_ptr(c))
        cuda.check("four_step pass 2", err)
        pass2_launches[tag] += 1
    return y


# ------------------------------------------------- the kernels' route, replayed
def _tile_words(L: int) -> int:
    """Words of a kernel's tile (``tile_words``): 4 columns of 2^L padded
    rows, one padding row every 8, and 4 rows for pass 2's quarter shift."""
    return ((1 << L) + (1 << L >> 3) + 4) << LOG_COLS


def _tile_rows(m: torch.Tensor, L: int, quarter: bool) -> torch.Tensor:
    """The shared-memory row of tile position m: ``srow`` (one padding row
    every 8), shifted by one row a quarter of the tile in pass 2
    (``QuarterRows``)."""
    rows = m + (m >> 3)
    return rows + (m >> (L - 2)) if quarter else rows


def _stages_replay(s: torch.Tensor, tws: torch.Tensor, L: int, quarter: bool,
                   F) -> torch.Tensor:
    """``ntt.stages_replay`` on the 4-column tiles of padded rows."""
    def addr(pos, cols):
        return (_tile_rows(pos, L, quarter) << LOG_COLS)[..., None] + cols

    return stages_replay(s, tws, L, LOG_COLS, addr, F)


def _split_twiddle(e: torch.Tensor, wpow: torch.Tensor, roots2: torch.Tensor,
                   F) -> torch.Tensor:
    """Pass 1's w^e for e < n, split at n1 = len(wpow): w^(e mod n1) *
    w2^(e div n1), w2^j read from the stage roots (j < n2 / 2) and from
    their negatives above (w2^(n2/2) = -1), as the kernel's shared-memory
    circle holds them."""
    log_n1 = _log2(wpow.shape[0])
    circle = torch.cat([roots2, F.sub(torch.zeros_like(roots2), roots2)])
    return F.mul(wpow[e & ((1 << log_n1) - 1)], circle[e >> log_n1])


def pass1_replay(x: torch.Tensor, tw2: torch.Tensor, wpow: torch.Tensor,
                 pre=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """Pass 1's kernel route in torch ops (``pass1_plain``'s contract): per
    block of 4 columns i1, position m loaded from x[brev(m) n1 + i1] times
    the coset power lo * hi, the stage rounds of ``_stages_replay`` on the
    padded tile, and the store times ``_split_twiddle``."""
    F = ntt_field(field)
    batch, n = x.shape
    n1, n2 = _split_sizes(n)
    log_n1, L, dev = _log2(n1), _log2(n2), x.device
    roots, lo, hi = _kernel_tables(tw2, pre, _log2(n), dev, field)
    cols = torch.arange(1 << LOG_COLS, device=dev)
    i1 = (torch.arange(n1 >> LOG_COLS, device=dev) << LOG_COLS)[:, None, None] + cols
    m = torch.arange(n2, device=dev)
    addr = (_tile_rows(m, L, False) << LOG_COLS)[:, None] + cols        # (n2, 4)
    src = (bitrev(n2, dev) << log_n1)[:, None] + i1                    # (blocks, n2, 4)
    v = x[:, src]
    if lo is not None:
        v = F.mul(v, _coset_powers((lo, hi), src, _log2(n), F.mul))
    s = torch.zeros((batch, n1 >> LOG_COLS, _tile_words(L)), dtype=F.dtype,
                    device=dev)
    s[:, :, addr] = v
    s = _stages_replay(s, roots, L, False, F)
    out = F.mul(s[:, :, addr], _split_twiddle(i1 * m[:, None], wpow, roots, F))
    return out.permute(0, 2, 1, 3).reshape(batch, n2, n1)


def pass2_replay(c: torch.Tensor, tw1: torch.Tensor, scale=None, post=None,
                 field=GOLDILOCKS_FP) -> torch.Tensor:
    """Pass 2's kernel route in torch ops (``pass2_plain``'s contract): per
    block of 4 rows k2 of C, element i1 loaded to position brev(i1) of the
    tile (rows shifted a quarter), the stage rounds, and the store to
    X[k2 + n2 k1] times one product: the post power from (lo, hi) with
    ``scale`` folded into hi, or ``scale`` alone."""
    F = ntt_field(field)
    batch, n2, n1 = c.shape
    L, log_n2, dev = _log2(n1), _log2(n2), c.device
    log_n = L + log_n2
    roots, lo, hi = _kernel_tables(tw1, post, log_n, dev, field, scale)
    cols = torch.arange(1 << LOG_COLS, device=dev)
    blocks = n2 >> LOG_COLS
    s = torch.zeros((batch, blocks, _tile_words(L)), dtype=F.dtype, device=dev)
    load = (_tile_rows(bitrev(n1, dev), L, True) << LOG_COLS)[:, None] + cols
    s[:, :, load] = c.reshape(batch, blocks, 1 << LOG_COLS, n1).transpose(2, 3)
    s = _stages_replay(s, roots, L, True, F)
    k1 = torch.arange(n1, device=dev)
    v = s[:, :, (_tile_rows(k1, L, True) << LOG_COLS)[:, None] + cols]  # (.., k1, r)
    k2 = (torch.arange(blocks, device=dev) << LOG_COLS)[:, None, None] + cols
    idx = k2 + (k1 << log_n2)[:, None]                                 # (blocks, n1, 4)
    if lo is not None:
        v = F.mul(v, _coset_powers((lo, hi), idx, log_n, F.mul))
    elif scale is not None:
        v = F.mul(v, F.pack(scale, dev))
    y = torch.empty((batch, n1 * n2), dtype=F.dtype, device=dev)
    y[:, idx] = v
    return y


def transform_replay(x: torch.Tensor, inverse: bool = False, pre=None,
                     post=None, field=GOLDILOCKS_FP) -> torch.Tensor:
    """``transform`` by the kernels' route, replayed in torch ops."""
    n = x.shape[1]
    tw1, tw2, wpow = _tables(n, inverse, x.device, field)
    scale = inv_n(field, n) if inverse else None
    return pass2_replay(pass1_replay(x, tw2, wpow, pre, field), tw1, scale, post,
                        field)


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
