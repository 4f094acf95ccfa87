"""The least time the card could take for a call, and how a call is timed.

One model for every script that states a bound (``chip_smoke.py``,
``bench_kernels_torch.py``): ``bound(nbytes, ops, int8_macs)`` is the
larger of the bytes the function must move (each input read once, each
output written once) over the H100 SXM's device-memory rate, its 32-bit
integer operations over the INT32 peak, and its int8 multiply-adds over the
dense INT8 tensor-core peak. The rates are NVIDIA's data-sheet values for
the H100 SXM at its full power limit; the operation counts are lower
bounds taken from the kernels' arithmetic, so a measured time below a
bound is a fault of the count.
"""

from __future__ import annotations

import time

import torch

# H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# H100 SXM data sheet, dense INT8 tensor-core rate: 1,979 TOP/s, a
# multiply-add counting as two operations
INT8_OPS_PER_S = 1979e12
# one SHA-256 block: 64 rounds of 14 (3-input LOP3 and IADD3 fused) plus 48
# schedule steps of 10, plus the 8 feed-forward adds; a block of constant
# words needs no schedule (its words fold to immediates)
OPS_SHA_BLOCK = 64 * 14 + 48 * 10 + 8
OPS_SHA_CONST_BLOCK = 64 * 14 + 8
# Goldilocks: a product is four 32x32->64 multiplies (two instructions
# each) with 4 adds, and the reduction of gl.cuh about 17; an add 8, a sub 5
OPS_GL_PROD = 8 + 4                # the 128-bit product alone
OPS_GL_MUL = OPS_GL_PROD + 17
OPS_BUTTERFLY = OPS_GL_MUL + 8 + 5
# an Fp2 product (Karatsuba, u^2 = 7): three products, 7 v1 as three
# doublings and a sub (29, a product's worth), three adds and two subs
OPS_FP2_MUL = 4 * OPS_GL_MUL + 3 * 8 + 2 * 5
# BabyBear (bb.cuh): a product is one 32x32->64 multiply (2), the Barrett
# step's 64-bit multiply-high (four 32x32->64 multiplies and 4 adds, 12),
# one 32-bit multiply-subtract (2) and the conditional subtraction (2); an
# add or a sub is 3 (add, compare, select)
OPS_BB_MUL = 2 + 12 + 2 + 2
OPS_BB_BUTTERFLY = OPS_BB_MUL + 3 + 3
# BabyBear Fp4 (ext_field.cuh's bb4::mul, Karatsuba over Fp2), counted in
# instructions of the compiled kernel, one an operation: 9 products (three
# a Karatsuba Fp2 product, three Fp2 products) and 5 by the constant 11
# (11 v1 in each Fp2 product; the nonresidue (k + u) times (x0 + x1 u), k =
# p - 11 = -11, is (11 x1 - 11 x0) + (x0 - 11 x1) u), each the Barrett step
# of bb.cuh as compiled: about 6 IMADs (the product, the multiply-high by
# the constant M, the multiply-subtract), one ISETP and one add (8); 27
# adds and subs (5 in each Fp2 product, 2 at the nonresidue, 4 Karatsuba
# sums, 6 in the result) of an add, an ISETP and a conditional add (3).
# bb_fp4_mul_kernel<1, true, uint32_t>'s SASS (scripts/torch_sass_mix.py
# --match bb_fp4_mul on the H100) agrees: 217 integer instructions, its
# loop's addressing and set-up included, of which 90 IMAD and 43 ISETP (41
# products, adds and subs, the loop's bound and the thread's)
OPS_FP4_MUL = 14 * 8 + 27 * 3
# an extension product by the kernels' suffix: Goldilocks Fp2, BabyBear Fp4
EXT_MUL_OPS = {"gl2": OPS_FP2_MUL, "bb4": OPS_FP4_MUL}
EXT_K = {"gl2": 2, "bb4": 4}
# an elementwise op (csrc/field_ew.cu) by field and op: a Goldilocks add 8,
# a sub or a neg 5 (gl.cuh); a BabyBear add, sub or neg 3, its product
# OPS_BB_MUL (bb.cuh)
EW_OPS = {("gl", "add"): 8, ("gl", "sub"): 5, ("gl", "neg"): 5,
          ("bb", "add"): 3, ("bb", "sub"): 3, ("bb", "neg"): 3,
          ("bb", "mul"): OPS_BB_MUL}
# x + a z by a fixed z, as csrc/div_scan.cu's Fixed<X>::mac does each Horner
# and fold step: the linear map a -> a z as a matrix over the base field, its
# rows summed before one reduction each. Goldilocks Fp2: two gl_dot2 (a b +
# c d + x): two 128-bit products, two 128-bit adds with their carry out (5
# each), the reduction (17) and the carry's subtraction (a sub and a select,
# 6). BabyBear Fp4: 16 32x32->64 multiply-adds into 64-bit sums (two each)
# and four Barrett reductions (the multiply-high 12, a multiply-subtract 2,
# the conditional subtraction 2).
OPS_FP2_FIXED_MAC = 2 * (2 * OPS_GL_PROD + 2 * 5 + 17 + 6)
OPS_FP4_FIXED_MAC = 16 * 2 + 4 * (12 + 2 + 2)
FIXED_MAC_OPS = {"gl2": OPS_FP2_FIXED_MAC, "bb4": OPS_FP4_FIXED_MAC}
# (product, butterfly) operations per field, by the kernels' field suffix
FIELD_OPS = {"gl": (OPS_GL_MUL, OPS_BUTTERFLY), "bb": (OPS_BB_MUL, OPS_BB_BUTTERFLY)}
OPS_DIGIT = 4                      # one decimal digit: multiply-high, shift, multiply, sub
# the digit level (ntt_digit.cu): centring a value (compare, subtract: 4) and
# 8 balanced bytes of shift, mask, add, compare; recombining 8 planes (8
# offset adds, 6 64-bit shift-adds of 2, the 96-bit fold, reduce128 and the
# subtraction of the constant)
OPS_DIGITIZE = 4 + 8 * 4
OPS_RECOMBINE = 8 + 6 * 2 + 3 + 17 + 5


def bound(nbytes: float, ops: float, int8_macs: float = 0.0):
    """(bound_ms, bound_by): the larger of the byte time and the operation
    time (INT32 operations or int8 tensor-core multiply-adds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / INT32_OPS_PER_S, 2.0 * int8_macs / INT8_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int, device="cuda") -> float:
    """Mean ms per call over ``reps`` calls after one warm-up call: CUDA
    events around the whole run on the card, the host clock on the CPU (a
    dry run: no device metric)."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean wall ms per call of ``reps`` calls issued back to back with no
    synchronize between them, after a warm-up: the host's share of a call
    (argument checks, allocation, the launch), apart from the device's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs * 1e3 / reps


MAX_SLEEP_MS = 10_000.0


def device_ms(fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` calls run back to back on the
    card: CUDA events around the calls, all enqueued behind a device-side
    sleep (``torch.cuda._sleep``) that outlasts their enqueue, so that no
    host time falls between the events. The sleep doubles until it does;
    a call that waits for the device itself (a blocking copy) never
    outruns the sleep, and raises once the sleep passes MAX_SLEEP_MS."""
    fn()
    torch.cuda.synchronize()
    sleep_ms = 1.0 + 0.1 * reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    while True:
        torch.cuda._sleep(int(sleep_ms * 2e6))        # ~2e6 cycles a ms
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms < sleep_ms / 2:
            return start.elapsed_time(end) / reps
        sleep_ms *= 2
        if sleep_ms > MAX_SLEEP_MS:
            raise RuntimeError("device_ms: the calls do not queue behind a device "
                               f"sleep of {MAX_SLEEP_MS} ms (a call waits for the device)")


# a read of four times the H100's 50 MB L2 between calls leaves none of a
# call's operands there
L2_FLUSH_BYTES = 4 * 50 * 2**20
_flush_bufs = {}


def cold_device_ms(fn, reps: int) -> float:
    """Mean device ms per call with the call's operands in device memory and
    not in L2, as a bound by bytes counts them: before each call the card
    reads L2_FLUSH_BYTES of another buffer (clean lines: no write-back falls
    into the call), and CUDA events around each call alone time it. The
    calls are enqueued behind a device sleep, as in ``device_ms``, so that
    no host time falls between a call's events."""
    dev = torch.cuda.current_device()
    buf = _flush_bufs.get(dev)
    if buf is None:
        buf = _flush_bufs[dev] = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                                            device="cuda")
    fn()
    torch.cuda.synchronize()
    sleep_ms = 1.0 + 0.2 * reps
    while True:
        torch.cuda._sleep(int(sleep_ms * 2e6))        # ~2e6 cycles a ms
        t0 = time.perf_counter()
        events = []
        for _ in range(reps):
            buf.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms < sleep_ms / 2:
            return sum(s.elapsed_time(e) for s, e in events) / reps
        sleep_ms *= 2
        if sleep_ms > MAX_SLEEP_MS:
            raise RuntimeError("cold_device_ms: the calls do not queue behind a device "
                               f"sleep of {MAX_SLEEP_MS} ms (a call waits for the device)")


def profiler_ms(fn, reps: int):
    """(device ms per call, kernels per call) from torch.profiler's (CUPTI)
    kernel records over ``reps`` calls: the summed kernel time divided by
    ``reps``, and how many kernel records it saw per call, which tells a
    reading with records missing from a whole one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in kernels)
    return us / 1e3 / reps, len(kernels) / reps


def split_ms(fn, reps: int) -> dict:
    """A call's times apart: ``host_ms`` (the enqueue), ``device_ms`` (the
    card alone, ``device_ms()``) and ``profiler_ms`` with
    ``profiler_kernels`` (``profiler_ms()``)."""
    prof, kernels = profiler_ms(fn, reps)
    return {"host_ms": host_ms(fn, reps), "device_ms": device_ms(fn, reps),
            "profiler_ms": prof, "profiler_kernels": kernels}


def sha_blocks(msg_bytes):
    """SHA-256 blocks of messages of these byte lengths (int or tensor)."""
    return (msg_bytes + 9 + 63) // 64


def stage_muls(n, stages):
    """Products by a stage root other than 1 in ``stages`` DIT stages over
    each 2^stages-point block of n values: stage u has n / 2 butterflies,
    n / 2^u of them by w^0 = 1, which need no product."""
    return (n // 2) * stages - n + (n >> stages)


# bytes a value's component is stored in: Goldilocks int64, BabyBear int32
WIDTH = {"gl": 8, "gl2": 8, "bb": 4, "bb4": 4}


def ntt_work(batch, n, coset_mul: bool, scale_mul: bool, tag="gl"):
    """The whole transform: log2(n) stages, and per value a coset product
    (but the one by s^0 = 1) and a scale product if asked; values in and
    out, the n / 2 roots read once, each WIDTH[tag] bytes."""
    mul, butterfly = FIELD_OPS[tag]
    log_n = n.bit_length() - 1
    ops = batch * ((n // 2) * log_n * (butterfly - mul) + stage_muls(n, log_n) * mul
                   + (n * (int(coset_mul) + int(scale_mul)) - int(coset_mul)) * mul)
    return WIDTH[tag] * (2 * batch * n + n // 2), ops


def pass_work(batch, n, stages, muls, tag="gl", ones=0):
    """One pass over (batch, n): ``stages`` radix-2 stages over blocks of
    2^stages values (``stage_muls``) and ``muls`` elementwise products per
    value (coset, twiddle, scale), ``ones`` of each row's by 1 and not
    counted; each value read and written once, WIDTH[tag] bytes."""
    mul, butterfly = FIELD_OPS[tag]
    ops = batch * ((n // 2) * stages * (butterfly - mul) + stage_muls(n, stages) * mul
                   + (n * muls - ones) * mul)
    return 2 * WIDTH[tag] * batch * n, ops


def four_step_work(batch, n1, n2, pre: bool, store_mul: bool, tag="gl"):
    """(pass 1, pass 2) of the four-step over (batch, n1 n2): pass 1 has
    log2(n2) stages, the twiddle w^(i1 k2) (by 1 where i1 = 0 or k2 = 0)
    and, with ``pre``, the coset power (by 1 at i = 0); pass 2 has log2(n1)
    stages and, with ``store_mul``, one product at the store (1/n, or the
    post power with 1/n folded in)."""
    n = n1 * n2
    return (pass_work(batch, n, n2.bit_length() - 1, 1 + int(pre), tag,
                      ones=n1 + n2 - 1 + int(pre)),
            pass_work(batch, n, n1.bit_length() - 1, int(store_mul), tag))


def _same(a, b) -> bool:
    """a and b are one input (a * a): its bytes are read once."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def mul_work(a, b):
    out = a.numel() if a.numel() >= b.numel() else b.numel()
    reads = a.numel() + (0 if _same(a, b) else b.numel())
    return a.element_size() * (reads + out), out * OPS_GL_MUL


def _stored(t):
    """The elements a view reads: its numel without the stride-0 axes."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


def ext_mul_work(a, b, tag="gl2"):
    """An extension product (Fp2, or with ``tag`` "bb4" Fp4) of (..., K)
    operands: each operand's stored elements read once (an expanded operand
    only as stored), the (..., K) output written once, in the operands'
    storage width (8 bytes a Goldilocks component, 4 a BabyBear one)."""
    out = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]).numel()
    reads = _stored(a) + (0 if _same(a, b) else _stored(b))
    return a.element_size() * (reads + EXT_K[tag] * out), out * EXT_MUL_OPS[tag]


def ew_work(a, b, ops):
    """An elementwise op of broadcast operands (b None: a neg): each
    operand's stored elements read once, the output written once, ``ops``
    integer operations an output element (``EW_OPS``); each element of
    the operands' storage width."""
    shape = a.shape if b is None else torch.broadcast_shapes(a.shape, b.shape)
    out = shape.numel()
    reads = _stored(a) + (0 if b is None or _same(a, b) else _stored(b))
    return a.element_size() * (reads + out), out * ops


def _power_muls(e: int) -> int:
    """Products of x^e by square and multiply."""
    return max(e.bit_length() - 1 + bin(e).count("1") - 1, 0) if e else 0


def div_scan_work(c, m, fold: bool, tag, *small, start: int = 0, carry: bool = False,
                  scan: bool = False):
    """A division of c's B rows by (x - z) to m outputs each
    (``ops/div_scan.py::div_scan``): the stored coefficients (a row
    broadcast over the batch counted once) and the ``small`` operands (z, zinv,
    head, carry, alpha; None where absent) read once, the (B, m, K)
    quotient written once; a Horner step a product by the fixed z (the
    adds in it), the fold one more by the fixed alpha; with ``carry`` a
    row's carry zinv^(start + m), by square and multiply, and its product.
    ``scan``: the work of csrc/div_scan.cu's parallel scan instead, two
    Horner steps an output (up and down each thread's chunk)."""
    B, K = c.shape[0], c.shape[-1]
    reads = _stored(c) + sum(_stored(t) for t in small if t is not None)
    macs = B * m * (1 + int(scan) + int(fold)) * FIXED_MAC_OPS[tag]
    chain = B * (_power_muls(start + m) + 1) * EXT_MUL_OPS[tag] if carry else 0
    return WIDTH[tag] * (reads + B * m * K), macs + chain


def pow_dot_work(terms, z, tag, parts: int = 1, start: int = 0):
    """``pow_dot`` over the (B, n, K) terms it reads: each term and z read
    once, (B, parts, K) written; a Horner step a term by the fixed z (with
    ``parts=2`` the n terms are both halves' pairs), and with ``start`` each
    row's sums times z^start, by square and multiply."""
    B, n, K = terms.shape
    chain = B * (_power_muls(start) + parts) * EXT_MUL_OPS[tag] if start else 0
    return (WIDTH[tag] * (_stored(terms) + _stored(z) + B * parts * K),
            B * n * FIXED_MAC_OPS[tag] + chain)


def first_match_work(comps, rows):
    """The first-occurrence search of (q, C) rows in (n, C) components:
    each element and row read once in its storage width (8 bytes a
    Goldilocks word, 4 a BabyBear one), (q,) int64 written; each element
    against each row in one word, a 64-bit equality two INT32 compares and
    a 32-bit one one (an element that differs from a row mostly differs in
    its first word, so the least work rejects it there)."""
    n, C = comps.shape
    q = rows.shape[0]
    w = comps.element_size()
    return w * (n * C + q * C) + 8 * q, (w // 4) * n * q


def witness_work(model: str, tag: str, count: int):
    """Bytes and ops of ``count`` rows of a device witness: the columns
    written once in their storage width (nothing is read); the operations
    the function itself needs, not those of a design: Fibonacci (3
    columns) one add a row (a + b is both the third column and the next
    row's b), the counter (2 columns) two adds a row (each column an
    arithmetic progression). An add: Goldilocks 8 operations, BabyBear 3."""
    add = 8 if tag == "gl" else 3
    width = 3 if model == "fibonacci" else 2
    return width * count * WIDTH[tag], count * (width - 1) * add


def leaf_hash_work(comps, k, fmt, max_digits=20):
    """Bytes and ops of the leaf hash on these inputs: the preimage lengths
    (and so the block counts) depend on the values' decimal digits."""
    from ..ops.leaf_hash import u64_digits

    _, length = u64_digits(comps, max_digits)       # (n, comps)
    const = {0: 0, 1: 21, 2: 63}[fmt]               # "QuadExtField(" ... " * u)"
    per_elem = length.sum(1) + const
    msg = per_elem.reshape(-1, k).sum(1)
    blocks = int(sha_blocks(msg).sum())
    ops = blocks * OPS_SHA_BLOCK + int(length.sum()) * OPS_DIGIT
    return comps.numel() * comps.element_size() + msg.numel() * 32, ops


def level_work(n_parents, fan):
    ops = n_parents * ((fan // 2) * OPS_SHA_BLOCK + OPS_SHA_CONST_BLOCK)
    return n_parents * (fan + 1) * 32, ops


def tree_work(n_leaves, fan):
    """Every inner level of a fan-ary tree over ``n_leaves`` digests."""
    nbytes = ops = 0
    while n_leaves > 1:
        f = min(fan, n_leaves)
        n_leaves //= f
        b, o = level_work(n_leaves, f)
        nbytes, ops = nbytes + b, ops + o
    return nbytes, ops


def rows_work(n, C, width=8):
    """n rows of C components of ``width`` bytes read (8 Goldilocks, 4
    BabyBear), a digest each written; each component hashed as 8 bytes."""
    return n * (width * C + 32), n * sha_blocks(8 * C) * OPS_SHA_BLOCK


def stream_work(n_words):
    """x + 1 over 32-bit words: each read and written once, one add."""
    return 8 * n_words, n_words


def digitize_work(batch, F, R):
    n = batch * F * R
    return 16 * n, n * OPS_DIGITIZE


def digit_dot_work(batch, K, R, N):
    """(bytes, ops, int8 multiply-adds) of (batch, K, R) x (K, N)."""
    return batch * K * R + K * N + 4 * batch * R * N, 0, batch * R * K * N


def _tail_ops(twiddle: bool, scale: bool):
    return OPS_RECOMBINE + OPS_GL_MUL * (int(twiddle) + int(scale))


def recombine_work(batch, R, F, twiddle_rows=0, scale=False):
    """8 int32 planes of width F in (the padding between planes is not
    needed), one value out, ``twiddle_rows`` rows of F twiddles."""
    n = batch * R * F
    return 40 * n + 8 * twiddle_rows * F, n * _tail_ops(twiddle_rows > 0, scale)


def digit_level_work(batch, F, R, twiddle_rows=0, scale=False):
    """(bytes, ops, int8 multiply-adds) of the fused level: values in and
    out, the (8F, 8F) digit matrix and the twiddles once."""
    n = batch * F * R
    nbytes = 16 * n + 64 * F * F + 8 * twiddle_rows * F
    ops = n * (OPS_DIGITIZE + _tail_ops(twiddle_rows > 0, scale))
    return nbytes, ops, batch * R * 64 * F * F
