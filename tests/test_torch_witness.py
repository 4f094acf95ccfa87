"""The device witnesses of the port (ops/witness.py, csrc/witness.cu;
ROADMAP X5) on the CPU, tolerance 0: the plain Fibonacci ladder and the
counter's closed form against the JAX package's
``fibonacci_trace_cols_on_device`` and ``_counter_cols_on_device`` over
Goldilocks and BabyBear, whole and in blocks of rows (some crossing
``steps``, some not multiples of the kernel's chunk); the kernel's route
(its plan, each thread's ladder, the chunks and the jump between them)
replayed on host integers against the plain version; the dispatch (a CPU
tensor takes the plain version, the CUDA wrappers refuse it, an int64
BabyBear tensor is refused); a ``DeviceTrace`` that builds nothing until it
is read; and in CPU gloo groups of 2 and 4 ranks, parity and fast proves
in which each rank asks the trace's build function for its own block of rows only, with
proofs equal to one device's bytes. One intra-op thread; small n, the JAX
references cached."""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ministark_tpu.fields import BabyBear as J_BB
from ministark_tpu.fields import Goldilocks as J_GL
from ministark_tpu.models.counter import _counter_cols_on_device as j_counter_cols
from ministark_tpu.models.fibonacci_device import fibonacci_trace_cols_on_device as j_fib_cols
from ministark_tpu_torch.convert import from_jax_packed
from ministark_tpu_torch.fields import BabyBear, Goldilocks
from ministark_tpu_torch.models.counter import _counter_cols_on_device, counter_device_trace
from ministark_tpu_torch.models.fibonacci_device import (
    fibonacci_device_trace,
    fibonacci_trace_cols_on_device,
)
from ministark_tpu_torch.ops import witness
from ministark_tpu_torch.ops.field import unpack_u64
from ministark_tpu_torch.parallel import cases, launch
from ministark_tpu_torch.utils.rng import ark_test_rng

FIELDS = {"gl": (Goldilocks, J_GL), "bb": (BabyBear, J_BB)}
N = 1 << 10
STEPS = (N - 1, N // 2 + 3, 5)
# secret_b and (start, step, a, b) of the counter by steps: the defaults,
# then others (some at or above BabyBear's p, reduced as from_int does)
SECRET = {N - 1: 2, N // 2 + 3: 7, 5: 3_000_000_017}
COUNTER = {N - 1: (1, 3, 5, 7), N // 2 + 3: (11, 1_000_003, 9, 424_242),
           5: (2**31 + 5, 77, 2**40 + 3, 2**31 - 1)}
# (lo, count) blocks of the trace of N // 2 + 3 steps (n = N): chunk
# multiples, ones that are not, ones that cross steps, the last rows
BLOCKS = ((0, 8), (512, 8), (513, 100), (514, 2), (3, 1021), (1000, 24), (N - 1, 1),
          (0, N))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax(model, field, steps):
    """The JAX package's whole witness as a u64 numpy array."""
    sf, jsf = FIELDS[field]
    if model == "fibonacci":
        cols = j_fib_cols(jsf, steps, SECRET[steps])
    else:
        cols = j_counter_cols(jsf, steps, *COUNTER[steps])
    return unpack_u64(from_jax_packed(np.asarray(cols), sf.base))


def _port(model, field, steps, lo=0, count=None):
    sf = FIELDS[field][0]
    if model == "fibonacci":
        return fibonacci_trace_cols_on_device(sf, steps, SECRET[steps], "cpu", lo, count)
    return _counter_cols_on_device(sf, steps, *COUNTER[steps], "cpu", lo, count)


@pytest.mark.parametrize("model", ["fibonacci", "counter"])
@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("field", ["gl", "bb"])
def test_plain_witness_matches_jax(field, steps, model):
    got = _port(model, field, steps)
    assert got.dtype == (torch.int64 if field == "gl" else torch.int32)
    want = _jax(model, field, steps)
    assert got.shape == want.shape == (3 if model == "fibonacci" else 2,
                                       max(8, 1 << steps.bit_length()))
    assert np.array_equal(unpack_u64(got), want)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("model", ["fibonacci", "counter"])
@pytest.mark.parametrize("field", ["gl", "bb"])
def test_plain_blocks_match_jax_slices(field, model, block):
    lo, count = block
    steps = N // 2 + 3
    got = _port(model, field, steps, lo, count)
    assert np.array_equal(unpack_u64(got), _jax(model, field, steps)[:, lo:lo + count])


# ------------------------------------------------------- the kernel's route
def _pow_vec(m, a, b, p):
    """M^k (a, b) from the kernel's (F(k-2), F(k-1), F(k)): three products."""
    x = m[2] * (a + b) % p
    return (x - m[0] * a) % p, (x + m[1] * b) % p


def _unsigned(plan):
    return [v + (1 << 64) if v < 0 else v for v in plan]


def _replay(model, plan, p):
    """csrc/witness.cu's route on host integers: each thread of the grid
    (plan's blocks x THREADS) writes R = CHUNK consecutive rows a chunk from
    row R x its index and jumps by the stride; Fibonacci's thread starts from its
    warp's ladder over the warp's first row and its lane's table entry,
    the counter's from two products at each chunk."""
    plan = _unsigned(list(plan))
    lo, count, steps, blocks = plan[:4]
    T, R = witness.THREADS, witness.CHUNK
    width = 3 if model == "fibonacci" else 2
    out = np.zeros((width, count), dtype=np.uint64)
    if model == "fibonacci":
        bits, b0, pad = plan[4:7]
        words = plan[witness.FIB_HEAD:]
        table = [words[3 * k: 3 * k + 3] for k in range(2 * witness.LADDER + 1)]
        ladder, lanes, jump = table[:32], table[32:64], table[64]
    else:
        start, step, c1, c1_step, pad = plan[4:9]
    stride = blocks * T * R
    for g in range(blocks * T):
        i, first = g * R, (g - g % 32) * R
        if model == "fibonacci":
            if first >= count:
                break
            a, b = 1, b0
            for k in range(bits):
                if ((lo + first) >> k) & 1:
                    a, b = _pow_vec(ladder[k], a, b, p)
            a, b = _pow_vec(lanes[g % 32], a, b, p)
        while i < count:
            if model == "fibonacci":
                x, y = a, b
            else:
                x, y = (start + (lo + i) * step) % p, (c1 + (lo + i) * c1_step) % p
            for r in range(R):
                if model == "fibonacci":
                    vals, (x, y) = (x, y, (x + y) % p), (y, (x + y) % p)
                else:
                    vals, (x, y) = (x, y), ((x + step) % p, (y + c1_step) % p)
                if i + r < count:
                    out[:, i + r] = vals if lo + i + r < steps else (pad,) * width
            if model == "fibonacci":
                a, b = _pow_vec(jump, a, b, p)
            i += stride
    return out


# (steps, lo, count, blocks): several chunks a thread (one block over 2^12
# rows), a stride that does not divide the rows, a grid wider than the
# rows, a block of rows not a chunk multiple from a lo that is and from one
# that is not, and one crossing steps
ROUTES = ((4095, 0, 4096, 1), (4095, 0, 4096, 3), (4095, 0, 4096, 9),
          (2000, 1000, 1027, 1), (2000, 1001, 1027, 1), (3000, 2048, 2048, 2))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("model", ["fibonacci", "counter"])
@pytest.mark.parametrize("field", ["gl", "bb"])
def test_kernel_route_replayed_matches_plain(field, model, route):
    steps, lo, count, blocks = route
    sf = FIELDS[field][0]
    base = sf.base
    pad = base.rand(ark_test_rng())
    if model == "fibonacci":
        plan = witness._fib_plan(base, steps, 5, pad, lo, count, blocks)
        want = fibonacci_trace_cols_on_device(sf, steps, 5, "cpu", lo, count)
    else:
        consts = (7, 2**35 + 1, 12345, 99)
        plan = witness._counter_plan(base, steps, *consts, pad, lo, count, blocks)
        want = _counter_cols_on_device(sf, steps, *consts, "cpu", lo, count)
    assert np.array_equal(_replay(model, plan, base.p), unpack_u64(want))


def test_ladder_table_and_powers():
    """M^(2^b) squares the one before; a power of M in the kernel's three
    words moves a row by its exponent in three products."""
    for sf in (Goldilocks, BabyBear):
        p = sf.base.p
        table = witness.ladder(p)
        assert table[0] == (0, 1, 1, 1)
        for k in range(1, witness.LADDER):
            assert table[k] == witness._mat_mul(table[k - 1], table[k - 1], p)
        row = _port("fibonacci", "gl" if sf is Goldilocks else "bb", N - 1)
        a, b = (int(v) for v in unpack_u64(row[:2, 17]))
        for e in (0, 1, 300, 1000):
            m = witness.pow_words(witness.mat_pow(e, p), p)
            assert _pow_vec(m, a, b, p) == tuple(int(v) for v in unpack_u64(row[:2, 17 + e]))


# ---------------------------------------------------------------- dispatch
def test_dispatch_and_refusals():
    """A CPU tensor takes the plain version and launches nothing; the CUDA
    wrappers refuse a CPU tensor; an int64 BabyBear tensor, a wrong shape
    and rows out of range raise on either path."""
    base_gl, base_bb = Goldilocks.base, BabyBear.base
    before = (dict(witness.launches), dict(witness.rows))
    witness.fib_witness(torch.empty((3, 16), dtype=torch.int64), base_gl, 9, 2, 0)
    witness.counter_witness(torch.empty((2, 16), dtype=torch.int32), base_bb, 9,
                            1, 3, 5, 7, 0)
    assert (witness.launches, witness.rows) == before
    with pytest.raises(ValueError):
        witness.fib_witness_cuda(torch.empty((3, 16), dtype=torch.int64), base_gl, 9, 2, 0)
    with pytest.raises(ValueError):
        witness.counter_witness_cuda(torch.empty((2, 16), dtype=torch.int32), base_bb, 9,
                                     1, 3, 5, 7, 0)
    for call in (lambda o: witness.fib_witness(o, base_bb, 9, 2, 0),
                 lambda o: witness.fib_witness_cuda(o, base_bb, 9, 2, 0)):
        with pytest.raises(ValueError):
            call(torch.empty((3, 16), dtype=torch.int64))
    for call in (lambda o: witness.counter_witness(o, base_bb, 9, 1, 3, 5, 7, 0),
                 lambda o: witness.counter_witness_cuda(o, base_bb, 9, 1, 3, 5, 7, 0)):
        with pytest.raises(ValueError):
            call(torch.empty((2, 16), dtype=torch.int64))
    with pytest.raises(ValueError):
        witness.fib_witness(torch.empty((2, 16), dtype=torch.int64), base_gl, 9, 2, 0)
    with pytest.raises(ValueError):
        witness.counter_witness(torch.empty((2, 16), dtype=torch.int32), base_bb, 9,
                                1, 3, 5, 7, 0, lo=base_bb.p - 8)
    with pytest.raises(ValueError):
        fibonacci_trace_cols_on_device(Goldilocks, 9, 2, "cpu", 10, 8)


def test_fib_witness_fills_its_output():
    out = torch.full((3, 16), -1, dtype=torch.int64)
    got = witness.fib_witness(out, Goldilocks.base, 9, 2, int(Goldilocks.base.rand(ark_test_rng())))
    assert got is out
    assert np.array_equal(unpack_u64(out), unpack_u64(fibonacci_trace_cols_on_device(
        Goldilocks, 9, 2, "cpu"))[:, :16])


# -------------------------------------------------------------- DeviceTrace
@pytest.mark.parametrize("model", ["fibonacci", "counter"])
@pytest.mark.parametrize("field", ["gl", "bb"])
def test_device_trace_builds_on_demand(field, model):
    """``width``, ``domain_size`` and ``constrain_number`` read no column;
    ``cols_dev`` builds the whole once, equal to the JAX whole; a block
    read through ``evals`` builds that block alone."""
    sf = FIELDS[field][0]
    steps = N - 1
    if model == "fibonacci":
        trace = fibonacci_device_trace(sf, steps, SECRET[steps], on_device=True, device="cpu")
    else:
        trace = counter_device_trace(sf, steps, *COUNTER[steps], on_device=True,
                                     device="cpu")
    build, built = trace.build, []
    trace.build = lambda lo, count: built.append((lo, count)) or build(lo, count)
    width = 3 if model == "fibonacci" else 2
    assert (trace.width, trace.domain_size) == (width, N)
    assert trace.constrain_number() == width + len(trace.transitions)
    assert built == [] and trace.cols is None

    class _Rows:                      # a rank's block, as parallel.Rows gives it
        lo, count = 256, 512

    dtype = torch.int64 if field == "gl" else torch.int32
    block = trace.evals(dtype, "cpu", _Rows())
    assert built == [(256, 512)]
    assert np.array_equal(unpack_u64(block), _jax(model, field, steps)[:, 256:768])
    whole = trace.cols_dev
    assert trace.cols_dev is whole and built == [(256, 512), (0, N)]
    assert whole.dtype == dtype
    assert np.array_equal(unpack_u64(whole), _jax(model, field, steps))
    with pytest.raises(ValueError):
        trace.evals(torch.int32 if field == "gl" else torch.int64, "cpu")


# ------------------------------------------------------------------ a mesh
WORLDS = (2, 4)
TIMEOUT_S = 300
SETTINGS = (("ministark_tpu_torch.stark.engine", "DEVICE_MIN_SIZE", 256),)
FAST_CFG = dict(queries=4, final_len=16)
# key -> cases.witness_blocks' keywords: traces whose stage splits at 2 and
# 4 ranks (parity 2^10, fast 2^8)
PROVES = {
    "parity": dict(field="gl", steps=N - 1),
    "parity_bb": dict(field="bb", steps=N - 1),
    "parity_counter": dict(field="gl", steps=N - 1, model="counter"),
    "fast": dict(field="gl", steps=255, mode="fast", cfg=FAST_CFG),
    "fast_bb": dict(field="bb", steps=255, mode="fast", cfg=FAST_CFG),
}


@pytest.fixture(scope="module")
def groups():
    """world -> future of its ranks' results, both groups started at once."""
    scenarios = [(key, "witness_blocks", kw) for key, kw in PROVES.items()]
    pool = ThreadPoolExecutor(len(WORLDS))
    futs = {w: pool.submit(launch.run, cases.run, w, "gloo", "cpu", TIMEOUT_S,
                           (scenarios,), SETTINGS) for w in WORLDS}
    yield futs
    pool.shutdown(wait=True)


@functools.lru_cache(maxsize=None)
def _one_device(key):
    import ministark_tpu_torch.stark.engine as t_eng

    default = t_eng.DEVICE_MIN_SIZE
    t_eng.DEVICE_MIN_SIZE = 256
    try:
        return cases.witness_blocks(None, **PROVES[key])
    finally:
        t_eng.DEVICE_MIN_SIZE = default


def _n(key):
    return N if PROVES[key].get("mode", "parity") == "parity" else 256


@pytest.mark.parametrize("key", list(PROVES))
@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_builds_only_its_block(groups, world, key):
    n = _n(key)
    ranks = groups[world].result()
    for r, res in enumerate(ranks):
        _, built, whole = res[key]
        assert built == [(r * n // world, n // world)], (r, built)
        assert not whole


@pytest.mark.parametrize("key", list(PROVES))
@pytest.mark.parametrize("world", WORLDS)
def test_rank_proofs_equal_one_device(groups, world, key):
    one, built, whole = _one_device(key)
    assert built == [(0, _n(key))] and whole      # one device: the whole, once
    for res in groups[world].result():
        assert res[key][0] == one
