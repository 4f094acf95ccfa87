"""The device witnesses: the Fibonacci AIR's columns by a 2x2 matrix-power
ladder and the counter AIR's in closed form, any block of rows [lo, lo +
count) of the trace.

Port of the jitted programs ``ministark_tpu/models/fibonacci_device.py:19-99``
(``fibonacci_trace_cols_on_device``, the ladder a ``fori_loop``) and
``ministark_tpu/models/counter.py:57-92`` (``_counter_cols_on_device``), each
of which XLA fuses into one program (ROADMAP X5). Row i of Fibonacci's (3,
n) columns is (a, b, a + b) with (a, b) = M^i (1, b0), M = [[0, 1], [1,
1]]; the counter's (2, n) columns are start + i step and a (start + i
step) + b. Rows i >= steps hold the padding scalar the caller passes
(``base.rand(ark_test_rng())`` in the models).

``fib_witness(out, ...)`` and ``counter_witness(out, ...)`` fill ``out``
(the field's dtype: int64 Goldilocks, int32 BabyBear; another raises) and
dispatch by its device: a CPU tensor takes ``*_plain`` (the ladder and the
closed form as torch ops on the ``*_plain`` field ops, so that they reach
no field kernel on the card either), a CUDA tensor launches
csrc/witness.cu's ``ms_fib_witness_<gl|bb>`` / ``ms_counter_witness_<gl|bb>``
once or raises. Each launch counts in ``launches`` and the rows it wrote
in ``rows``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import bb, cuda, field

launches = {"fib_witness_gl": 0, "fib_witness_bb": 0,
            "counter_witness_gl": 0, "counter_witness_bb": 0}
# rows written by each kernel's launches: a rank of a mesh writes its block
rows = dict.fromkeys(launches, 0)

THREADS = 256          # csrc/witness.cu: threads a block
# csrc/witness.cu's R: rows a thread writes at a time. Two make each
# warp's store contiguous (a Goldilocks chunk is one 16-byte store; four
# rows were two stores at a 32-byte stride and read 0.0226 ms cold at 2^20
# against 0.0144 on the H100, PERF.md §6 PR 24)
CHUNK = 2
LADDER = 32            # M^(2^b) for b < 32: row indices below 2^32
FIB_HEAD = 7           # the Fibonacci plan's scalars before its tables

_PLAIN = {"gl": (field.add_plain, field.mul_plain), "bb": (bb.add_plain, bb.mul_plain)}


def _tag(base) -> str:
    from ..fields import BABYBEAR_FP, GOLDILOCKS_FP

    if base is GOLDILOCKS_FP:
        return "gl"
    if base is BABYBEAR_FP:
        return "bb"
    raise ValueError(f"no witness kernel for {base!r}")


def _check(out, base, width, lo):
    """The field's tag; raises unless ``out`` is (width, count) of the
    field's dtype and the rows [lo, lo + count) have indices below 2^32
    (the ladder's table) and below p (the counter's row as a field
    element)."""
    tag = _tag(base)
    dtype = field.field_dtype(base)
    if out.dtype != dtype:
        raise ValueError(f"witness: expected {dtype} for {base!r}, got {out.dtype}")
    if out.dim() != 2 or out.shape[0] != width:
        raise ValueError(f"witness: expected ({width}, count), got {tuple(out.shape)}")
    if lo < 0 or lo + out.shape[1] > min(1 << LADDER, base.p):
        raise ValueError(f"witness: rows [{lo}, {lo + out.shape[1]}) out of range")
    return tag


# ------------------------------------------------------------ host tables
def _mat_mul(A, B, p):
    """2x2 matrices as (m00, m01, m10, m11) over Python ints mod p."""
    return ((A[0] * B[0] + A[1] * B[2]) % p, (A[0] * B[1] + A[1] * B[3]) % p,
            (A[2] * B[0] + A[3] * B[2]) % p, (A[2] * B[1] + A[3] * B[3]) % p)


@functools.lru_cache(maxsize=None)
def ladder(p: int) -> tuple:
    """M^(2^b) for b < LADDER, M = [[0, 1], [1, 1]] mod p."""
    m, out = (0, 1, 1, 1), []
    for _ in range(LADDER):
        out.append(m)
        m = _mat_mul(m, m, p)
    return tuple(out)


def mat_pow(e: int, p: int) -> tuple:
    """M^e mod p from the ladder (e < 2^LADDER)."""
    out = (1, 0, 0, 1)
    for b, m in enumerate(ladder(p)):
        if (e >> b) & 1:
            out = _mat_mul(out, m, p)
    return out


def pow_words(m, p) -> tuple:
    """M^k = [[F(k-1), F(k)], [F(k), F(k+1)]] as the kernel takes it:
    (F(k-2), F(k-1), F(k)), so that M^k (a, b) is three products: x = F(k)
    (a + b), (x - F(k-2) a, x + F(k-1) b)."""
    return ((m[1] - m[0]) % p, m[0], m[1])


def _i64(v: int) -> int:
    """A canonical value < 2^64 as the int64 of the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _plan(vals):
    return (ctypes.c_int64 * len(vals))(*(_i64(int(v)) for v in vals))


def grid(device, count: int) -> int:
    """Blocks of the launch: one a THREADS x CHUNK rows, at most one an SM
    of the card (each warp's ladder spread over the most rows)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-count // (THREADS * CHUNK)), sms))


def _fib_plan(base, steps, b0, pad, lo, count, blocks):
    p = base.p
    bits = max((lo + count - 1).bit_length(), 1)
    tables = ([pow_words(m, p) for m in ladder(p)]
              + [pow_words(mat_pow(CHUNK * lane, p), p) for lane in range(32)]
              + [pow_words(mat_pow(blocks * THREADS * CHUNK, p), p)])
    return _plan([lo, count, steps, blocks, bits, b0, pad]
                 + [w for t in tables for w in t])


def _counter_plan(base, steps, start, step, a, b, pad, lo, count, blocks):
    p = base.p
    return _plan([lo, count, steps, blocks, start % p, step % p, (a * start + b) % p,
                  (a * step) % p, pad])


# ------------------------------------------------------------- Fibonacci
def fib_witness_plain(out, base, steps, b0, pad, lo=0):
    """Plain version: today's torch-op ladder over ``arange(lo, lo +
    count)``, on the ``*_plain`` field ops, into ``out``."""
    _check(out, base, 3, lo)
    add, mul = _PLAIN[_tag(base)]
    count, dev, dtype = out.shape[1], out.device, out.dtype
    if count == 0:
        return out

    def scalar(v):
        return field.pack_words(int(v), dtype, dev)

    def mat_mul(A, B):
        return [[add(mul(A[r][0], B[0][c]), mul(A[r][1], B[1][c])) for c in range(2)]
                for r in range(2)]

    idx = torch.arange(lo, lo + count, device=dev)
    one = torch.ones(count, dtype=dtype, device=dev)
    zero = torch.zeros_like(one)
    Mp = [[one, zero], [zero, one]]                       # M^(idx & (2^b - 1))
    M2 = [[scalar(0), scalar(1)], [scalar(1), scalar(1)]]  # M^(2^b)
    for b in range(max((lo + count - 1).bit_length(), 1)):
        bit = ((idx >> b) & 1) == 1
        prod = mat_mul(Mp, M2)
        Mp = [[torch.where(bit, prod[r][c], Mp[r][c]) for c in range(2)] for r in range(2)]
        M2 = mat_mul(M2, M2)
    a0, b0 = scalar(1), scalar(b0)
    a = add(mul(Mp[0][0], a0), mul(Mp[0][1], b0))
    bcol = add(mul(Mp[1][0], a0), mul(Mp[1][1], b0))
    cols = torch.stack([a, bcol, add(a, bcol)])          # (3, count)
    out.copy_(torch.where(idx < steps, cols, scalar(pad)))
    return out


def fib_witness_cuda(out, base, steps, b0, pad, lo=0):
    """CUDA kernel ``ms_fib_witness_<gl|bb>``, same contract as
    ``fib_witness_plain``."""
    tag = _check(out, base, 3, lo)
    name = f"fib_witness_{tag}"
    cuda.require(out, name, out.dtype, 2)
    count = out.shape[1]
    if count == 0:
        return out
    plan = _fib_plan(base, steps, b0, pad, lo, count, grid(out.device, count))
    err = getattr(cuda.library(), "ms_" + name)(out.data_ptr(), plan, cuda.stream_ptr(out))
    cuda.check(name, err)
    launches[name] += 1
    rows[name] += count
    return out


def fib_witness(out, base, steps, b0, pad, lo=0):
    """Rows [lo, lo + count) of the (3, n) Fibonacci columns into ``out``
    (3, count): CPU -> plain version, CUDA -> kernel (or raise)."""
    if out.device.type == "cpu":
        return fib_witness_plain(out, base, steps, b0, pad, lo)
    return fib_witness_cuda(out, base, steps, b0, pad, lo)


# --------------------------------------------------------------- counter
def counter_witness_plain(out, base, steps, start, step, a, b, pad, lo=0):
    """Plain version: today's closed form over ``arange(lo, lo + count)``
    as torch ops on the ``*_plain`` field ops, into ``out``."""
    _check(out, base, 2, lo)
    add, mul = _PLAIN[_tag(base)]
    count, dev, dtype = out.shape[1], out.device, out.dtype
    if count == 0:
        return out

    def scalar(v):
        return field.pack_words(int(v) % base.p, dtype, dev)

    idx = torch.arange(lo, lo + count, dtype=dtype, device=dev)   # i < p: canonical
    col0 = add(scalar(start).expand(count), mul(idx, scalar(step)))
    col1 = add(mul(col0, scalar(a)), scalar(b).expand(count))
    out.copy_(torch.where(idx < steps, torch.stack([col0, col1]), scalar(pad)))
    return out


def counter_witness_cuda(out, base, steps, start, step, a, b, pad, lo=0):
    """CUDA kernel ``ms_counter_witness_<gl|bb>``, same contract as
    ``counter_witness_plain``."""
    tag = _check(out, base, 2, lo)
    name = f"counter_witness_{tag}"
    cuda.require(out, name, out.dtype, 2)
    count = out.shape[1]
    if count == 0:
        return out
    plan = _counter_plan(base, steps, start, step, a, b, pad, lo, count,
                         grid(out.device, count))
    err = getattr(cuda.library(), "ms_" + name)(out.data_ptr(), plan, cuda.stream_ptr(out))
    cuda.check(name, err)
    launches[name] += 1
    rows[name] += count
    return out


def counter_witness(out, base, steps, start, step, a, b, pad, lo=0):
    """Rows [lo, lo + count) of the (2, n) counter columns into ``out``
    (2, count): CPU -> plain version, CUDA -> kernel (or raise)."""
    if out.device.type == "cpu":
        return counter_witness_plain(out, base, steps, start, step, a, b, pad, lo)
    return counter_witness_cuda(out, base, steps, start, step, a, b, pad, lo)
