"""Sharded proves of the port in CPU gloo groups of 2 and 4 ranks: every
rank's proof must be the same bytes, and those of the port's single-device
prove (which tests/test_torch_{engine,fast,stir,whir,bb_*}.py hold to the
JAX package), or of the golden fixture. The scenarios are the twins of
tests/test_sharded_engine.py and of ``__graft_entry__.py::dryrun_multichip``:
the Goldilocks parity prove at 2^10 - 1 with DEVICE_MIN_SIZE 256 (the
sharded FRI rounds), MiMC, FastStark in the dry run's two configurations,
STIR and WHIR through ``FastStark(lde_backend=...)``, BabyBear parity and
fast, and the golden fast fixtures, whose sizes split. Negative cases: a
size that does not split runs on one device, and a rank that raises or
hangs makes ``launch.run`` raise within its timeout. One group per world
size runs every scenario once; the tolerance is 0."""

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ministark_tpu_torch.stark.engine as t_eng
from ministark_tpu_torch.parallel import cases, launch

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DEVICE_MIN_SIZE = 256                   # the FRI rounds of 2^10 - 1 on tensors
SETTINGS = (("ministark_tpu_torch.stark.engine", "DEVICE_MIN_SIZE", DEVICE_MIN_SIZE),)
TIMEOUT_S = 300
WORLDS = (2, 4)
GOLDEN_CFG = dict(queries=4, final_len=8)        # tests/test_golden_proofs.py's

# key -> (case, keywords): ``__graft_entry__.py:180-260``'s proves
PROVES = {
    "parity": ("parity", dict(field="gl", steps=(1 << 10) - 1)),
    "mimc": ("parity", dict(field="gl", steps=(1 << 9) - 1, model="mimc")),
    "fast": ("fast", dict(field="gl", steps=255, cfg=dict(queries=4, final_len=16))),
    "fast_fold8_arity8": ("fast", dict(field="gl", steps=(1 << 12) - 1, cfg=dict(
        queries=4, final_len=64, fold_factor=8, arity=8))),
    "stir": ("fast", dict(field="gl", steps=(1 << 10) - 1, cfg=dict(
        queries=8, final_len=16, lde_backend="stir"))),
    "whir": ("fast", dict(field="gl", steps=(1 << 10) - 1, cfg=dict(
        queries=8, final_len=16, lde_backend="whir"))),
    "bb_parity": ("parity", dict(field="bb", steps=(1 << 10) - 1)),
    "bb_fast": ("fast", dict(field="bb", steps=255, cfg=dict(queries=4, final_len=16))),
}
GOLDENS = {"fast_fri_fib100.bin": "fri", "fast_stir_fib100.bin": "stir",
           "fast_whir_fib100.bin": "whir"}
X = np.arange(8 * 256, dtype=np.uint64).reshape(8, 256)


def _scenarios():
    out = [(key, name, kw) for key, (name, kw) in PROVES.items()]
    out += [(g, "fast", dict(field="gl", steps=100, cfg=dict(GOLDEN_CFG, lde_backend=b)))
            for g, b in GOLDENS.items()]
    # 2^1 does not split over 2 or 4 ranks, 2^8 does
    out += [(("select", n), "select_ntt", dict(field="gl", n=n, x=X[:, :n]))
            for n in (2, 256)]
    return out


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def groups():
    """world -> future of its ranks' results, both groups started at once
    so that they prove while the references are made here."""
    pool = ThreadPoolExecutor(len(WORLDS))
    futs = {w: pool.submit(launch.run, cases.run, w, "gloo", "cpu", TIMEOUT_S,
                           (_scenarios(),), SETTINGS) for w in WORLDS}
    yield futs
    pool.shutdown(wait=True)


@functools.lru_cache(maxsize=None)
def _single(key):
    """The port's single-device proof of a scenario, on the CPU."""
    name, kw = PROVES[key]
    default = t_eng.DEVICE_MIN_SIZE
    t_eng.DEVICE_MIN_SIZE = DEVICE_MIN_SIZE
    try:
        return getattr(cases, name)(None, **kw)[0]
    finally:
        t_eng.DEVICE_MIN_SIZE = default


def _ranks(groups, world, key):
    """(proof, collectives) of rank 0, after checking every rank's proof
    is the same bytes."""
    res = [r[key] for r in groups[world].result()]
    for rank, (proof, _) in enumerate(res):
        same = (np.array_equal(proof, res[0][0]) if isinstance(proof, np.ndarray)
                else proof == res[0][0])
        assert same, f"{key}: rank {rank} of {world} differs from rank 0"
    return res[0]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(PROVES))
def test_sharded_prove_equals_one_device(groups, world, key):
    want = _single(key)
    proof, collectives = _ranks(groups, world, key)
    assert collectives > 0, f"{key}: nothing was sharded"
    assert proof == want


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(GOLDENS))
def test_sharded_fast_equals_golden(groups, world, name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        want = f.read()
    proof, collectives = _ranks(groups, world, name)
    assert collectives > 0
    assert proof == want


@pytest.mark.parametrize("world", WORLDS)
def test_size_that_does_not_split_runs_on_one_device(groups, world):
    from ministark_tpu_torch.fields import GOLDILOCKS_FP
    from ministark_tpu_torch.ops.ntt import transform_plain
    from ministark_tpu_torch.parallel import can_shard

    for n, splits in ((2, False), (256, True)):
        assert can_shard(n, world) is splits
        out, collectives = _ranks(groups, world, ("select", n))
        assert (collectives > 0) is splits
        x = torch.from_numpy(X[:, :n].view(np.int64))
        assert np.array_equal(out, transform_plain(x, field=GOLDILOCKS_FP).numpy()
                              .view(np.uint64))


def test_failing_rank_raises_within_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        launch.run(cases.fail_on_rank, 2, "gloo", "cpu", timeout_s=120, args=(1,))
    assert time.monotonic() - t0 < 120


def test_hanging_rank_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch.run(cases.fail_on_rank, 2, "gloo", "cpu", timeout_s=10, args=(1, True))
    assert time.monotonic() - t0 < 60
