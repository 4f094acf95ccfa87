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

  "radix2"     this module: radix-2 DIT stages in one to three
               shared-memory passes (csrc/ntt.cu, ``pass_plan``), every size;
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

import ctypes
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
# The passes those calls launched, as csrc/ntt.cu counts them, per field.
pass_launches = {"gl": 0, "bb": 0}

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


MAX_PASS_LOG = 11  # P: the most stages a pass of the CUDA kernel runs
RADIX_LOG = 3      # stages a thread runs in registers between exchanges


@dataclass(frozen=True)
class NttPass:
    """One launch of csrc/ntt.cu: stages s0 + 1 .. s0 + log_tile of the
    decimation-in-time transform, on independent 2^log_tile-point columns
    at stride 2^s0 (the first pass gathers its columns from the input in
    bit-reversed order). A block holds 2^log_cols adjacent columns."""

    s0: int
    log_tile: int
    log_cols: int
    threads: int
    blocks: int      # per row of the batch
    smem: int        # bytes: the padded tile and the tile's root table


@lru_cache(maxsize=None)
def pass_plan(log_n: int, max_pass_log: int = MAX_PASS_LOG) -> tuple:
    """The passes of a 2^log_n transform: ceil(log_n / max_pass_log) of
    them (at least one), the stages split as evenly as they go, the larger
    parts first; blocks of 4 columns (a 32-byte run per row) and at most
    512 threads. The CUDA wrapper and ``transform_passes_plain`` both read
    it."""
    log_max_cols, max_threads = 2, 512
    k = max(1, -(-log_n // max_pass_log))
    base, extra = divmod(log_n, k)
    passes, s0 = [], 0
    for i in range(k):
        L = base + (i < extra)
        log_cols = min(log_max_cols, log_n - L if i == 0 else s0)
        elements = 1 << (L + log_cols)
        rows = (1 << L) + ((1 << L) >> 3)       # a padding row every 8
        passes.append(NttPass(
            s0, L, log_cols,
            threads=min(max_threads, max(32, elements >> RADIX_LOG)),
            blocks=(1 << log_n) // elements,
            smem=8 * ((rows << log_cols) + max(1, (1 << L) >> 1))))
        s0 += L
    return tuple(passes)


@lru_cache(maxsize=None)
def _plan_array(log_n: int):
    """``pass_plan(log_n)`` as the kernel's int64 plan: passes, the coset
    tables' split h, the tile root table's log order, then per pass s0,
    log_tile, log_cols, threads, blocks, shared bytes."""
    plan = pass_plan(log_n)
    vals = [len(plan), coset_split(log_n), plan[0].log_tile]
    for p in plan:
        vals += [p.s0, p.log_tile, p.log_cols, p.threads, p.blocks, p.smem]
    return (ctypes.c_int64 * len(vals))(*vals)


def _tile_root(field, root: int, log_n: int, plan) -> int:
    """The root of order 2^(first pass's log_tile): every pass reads its
    stage twiddles from this one table."""
    return pow(root, 1 << (log_n - plan[0].log_tile), field.p)


def coset_split(log_n: int) -> int:
    """h = ceil(log_n / 2): ``coset_tables`` splits an index at bit h."""
    return (log_n + 1) // 2


COSET_CACHE = 16   # coset table pairs kept: a prove's offset is new per trace


def coset_tables(field, offset: int, log_n: int, device, scale: int = 1):
    """(lo, hi) with s^i * scale = lo[i mod 2^h] * hi[i >> h] for i < 2^log_n,
    h = ``coset_split(log_n)``: 2^h and 2^(log_n - h) words. The kernel
    forms a coset power with one product. The COSET_CACHE most recent
    (field, offset, log_n, scale, device) are kept."""
    return _coset_tables(field, offset, log_n, str(device), scale)


@lru_cache(maxsize=COSET_CACHE)
def _coset_tables(field, offset: int, log_n: int, device: str, scale: int):
    p, h = field.p, coset_split(log_n)
    s = field.from_int(offset)
    lo, v = [], 1
    for _ in range(1 << h):
        lo.append(v)
        v = v * s % p
    hi, v, step = [], scale % p, pow(s, 1 << h, p)
    for _ in range(1 << (log_n - h)):
        hi.append(v)
        v = v * step % p
    return pack_u64(lo, device), pack_u64(hi, device)


def _coset_powers(tables, idx: torch.Tensor, log_n: int, mul) -> torch.Tensor:
    lo, hi = tables
    h = coset_split(log_n)
    return mul(lo[idx & ((1 << h) - 1)], hi[idx >> h])


def stages_replay(s: torch.Tensor, tws: torch.Tensor, L: int, log_c: int, addr,
                  F, pre=None) -> torch.Tensor:
    """csrc/ntt_stages.cuh's ``all_stages_at`` on flat tiles ``s`` (...,
    words) of 2^L positions by 2^log_c columns: rounds of 3 stages (the last
    2 or 1), each on groups of 2^R positions base + k 2^t0 of one column,
    read, transformed and written back as a thread holds them in registers,
    with the stage roots ``tws`` (2^(L-1)) read at j << (L - u).
    ``addr(pos, cols)`` gives the words of positions ``pos`` at columns
    ``cols``, shaped pos.shape + cols.shape; the first round takes the
    values as ``pre(v, pos, cols)`` (the kernel's ``Pre``), if given."""
    dev = s.device
    cols = torch.arange(1 << log_c, device=dev)
    t0 = 0
    while t0 < L:
        R = min(3, L - t0)
        g = torch.arange((1 << L) >> R, device=dev)       # one column's groups
        jlo = g & ((1 << t0) - 1)
        base = jlo | ((g >> t0) << (t0 + R))
        pos = base[:, None] + (torch.arange(1 << R, device=dev) << t0)
        words = addr(pos, cols)                           # (groups, 2^R, C)
        v = s[..., words]                                 # (..., groups, 2^R, C)
        if pre is not None and t0 == 0:
            v = pre(v, pos[..., None], cols)
        v = list(v.unbind(-2))                            # 2^R x (..., groups, C)
        for q in range(R):
            u, half = t0 + 1 + q, 1 << q
            for k in range(1 << R):
                if k & half:
                    continue
                a, b = v[k], v[k + half]
                if u > 1:   # the tile's first stage has only w^0 = 1
                    j = jlo + ((k & (half - 1)) << t0)
                    b = F.mul(b, tws[j << (L - u)][:, None])
                v[k], v[k + half] = F.add(a, b), F.sub(a, b)
        s = s.clone()
        s[..., words] = torch.stack(v, -2)
        t0 += R
    return s


def transform_passes_plain(x: torch.Tensor, inverse: bool = False, pre=None,
                           post=None, field=GOLDILOCKS_FP,
                           max_pass_log: int = MAX_PASS_LOG) -> torch.Tensor:
    """The CUDA kernel's plan replayed in torch ops, for the tests: the
    same outputs as ``transform_plain`` by the kernel's route.

    Pass 1 gathers column c of the input (x[brev_L(m) 2^(log n - L) + c],
    times the coset power from ``coset_tables``) and writes it as tile
    brev(c) of the bit-reversed array. A later pass takes the columns lo at
    stride 2^s0, multiplies position m by w^(lo brev_L(m) 2^(log n - s0 -
    L)) (the twiddles its stages carry for the column, taken out in front)
    and runs stages 1 .. L of a 2^L-point transform on each, with
    w_(2^u)^j read from the first pass's tile root table at j << (L1 - u).
    The last pass applies 1/n and the post powers (1/n folded into the hi
    table)."""
    F = ntt_field(field)
    batch, n = x.shape
    log_n = _log2(n)
    dev = x.device
    plan = pass_plan(log_n, max_pass_log)
    root = _roots(field, n, inverse)
    tw = twiddles(field, root, n, dev)
    L1 = plan[0].log_tile
    tile_tw = twiddles(field, _tile_root(field, root, log_n, plan), 1 << L1, dev)
    a = x
    for p in plan:
        L, s0 = p.log_tile, p.s0
        T, rest = 1 << L, log_n - s0 - L
        if s0 == 0:
            cols = 1 << (log_n - L)
            src = (bitrev(T, dev) << (log_n - L))[:, None] + torch.arange(cols, device=dev)
            v = x[:, src]                                   # (batch, m, column)
            if pre is not None:
                v = F.mul(v, _coset_powers(coset_tables(field, pre, log_n, dev),
                                           src, log_n, F.mul))
            # column c becomes tile brev(c): (batch, hi, m, lo), one lo
            v = v[:, :, bitrev(cols, dev)].transpose(1, 2).reshape(batch, cols, T, 1)
        else:
            v = a.reshape(batch, 1 << rest, T, 1 << s0)     # (batch, hi, m, lo)
            lo = torch.arange(1 << s0, device=dev)
            e = (bitrev(T, dev)[:, None] * lo) << rest
            half = n // 2
            w = tw[torch.where(e < half, e, e - half)]
            w = torch.where(e < half, w, F.sub(torch.zeros_like(w), w))
            v = F.mul(v, w)
        for u in range(1, L + 1):
            hw = 1 << (u - 1)
            sh = v.shape
            vr = v.reshape(sh[0], sh[1], T >> u, 2, hw, sh[3])
            ev, od = vr[:, :, :, 0], vr[:, :, :, 1]
            w = tile_tw[torch.arange(hw, device=dev) << (L1 - u)][:, None]
            wv = F.mul(od, w)
            v = torch.stack([F.add(ev, wv), F.sub(ev, wv)], 3).reshape(sh)
        a = v.reshape(batch, n)
    if post is not None:
        tables = coset_tables(field, post, log_n, dev,
                              inv_n(field, n) if inverse else 1)
        a = F.mul(a, _coset_powers(tables, torch.arange(n, device=dev), log_n, F.mul))
    elif inverse:
        a = F.mul(a, pack_u64(inv_n(field, n), dev))
    return a


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
    ``_recombine_bb``). Here one call runs the whole transform as the
    shared-memory passes of ``pass_plan`` (one launch each: 1 up to
    2^MAX_PASS_LOG, 2 up to 2^(2 MAX_PASS_LOG), 3 above), with the coset
    powers from ``coset_tables``; ``transform_passes_plain`` replays the
    same plan in torch ops. Bound on this card: integer throughput, at both
    fields (the butterflies, against one read and one write of the batch
    per pass)."""
    F = ntt_field(field)
    cuda.require(x, "ntt", torch.int64, 2)
    batch, n = x.shape
    log_n = _log2(n)
    y = torch.empty_like(x)
    if not batch:
        return y
    root = _roots(field, n, inverse)
    plan = pass_plan(log_n)
    tw = twiddles(field, root, n, x.device)
    tile_tw = twiddles(field, _tile_root(field, root, log_n, plan), 1 << plan[0].log_tile,
                       x.device)
    scale = inv_n(field, n) if inverse else 1
    pre_t = (None, None) if pre is None else coset_tables(field, pre, log_n, x.device)
    post_t = ((None, None) if post is None
              else coset_tables(field, post, log_n, x.device, scale))
    launched = ctypes.c_int64(0)
    err = getattr(cuda.library(), f"ms_ntt_{F.tag}")(
        x.data_ptr(), y.data_ptr(), batch, log_n, _plan_array(log_n),
        tw.data_ptr(), tile_tw.data_ptr(),
        *(None if t is None else t.data_ptr() for t in pre_t + post_t),
        1 if post is not None else scale, ctypes.byref(launched), cuda.stream_ptr(x),
    )
    pass_launches[F.tag] += launched.value
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
