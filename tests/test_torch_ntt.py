"""The port's plain NTT (ministark_tpu_torch/ops/ntt.py) against the JAX
package: the fused MXU level kernel in Pallas interpret mode at 2^14 (as
tests/test_ntt_mxu.py runs it) and the device NTT at 2^1 .. 2^13; the CUDA
kernel's pass plan replayed in torch ops (``transform_passes_plain``) at
plans of one to four passes, its two-table coset powers and its launches
per size. Exact integer equality (tolerance 0)."""

from functools import lru_cache

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ministark_tpu.fields import GOLDILOCKS_FP as J_FP
from ministark_tpu.ops import gl as jgl
from ministark_tpu.ops.ntt_device import get_ntt_fns as j_get_ntt_fns
from ministark_tpu.ops.ntt_mxu import make_mxu_ntt_fns
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import GOLDILOCKS_FP
from ministark_tpu_torch.ops import ntt

P = GOLDILOCKS_FP.p
SHIFT = 0x9E3779B97F4A7C15 % P


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run side by side: one intra-op thread each
    keeps the plain torch ops from contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(batch, n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, P, size=(batch, n), dtype=np.uint64)
    vals.reshape(-1)[:3] = [0, P - 1, 1 << 63][: vals.size]
    return jgl.pack(vals)


def _compare(j_fns, t_fns, x):
    tx = from_jax_packed(x, GOLDILOCKS_FP)
    off = jnp.asarray(jgl.pack([SHIFT])[0])
    off_inv = jnp.asarray(jgl.pack([J_FP.inv(SHIFT)])[0])
    pairs = [
        (j_fns[0](x), t_fns[0](tx)),
        (j_fns[1](x), t_fns[1](tx)),
        (j_fns[2](x, off), t_fns[2](tx, SHIFT)),
        (j_fns[3](x, off_inv), t_fns[3](tx, J_FP.inv(SHIFT))),
    ]
    for want, got in pairs:
        assert np.array_equal(to_jax_packed(got, GOLDILOCKS_FP), np.asarray(want))


def test_plain_matches_fused_mxu_kernel(monkeypatch):
    """K1 (ntt_mxu._make_fused_kernel) in interpret mode, batch 2."""
    monkeypatch.setenv("MINISTARK_MXU_FUSED", "1")
    n = 1 << 14
    _compare(make_mxu_ntt_fns(J_FP, n), ntt.get_ntt_fns(GOLDILOCKS_FP, n),
             _rand(2, n, seed=14))


@pytest.mark.parametrize("log_n", range(1, 14))
def test_plain_matches_device_ntt(log_n):
    n = 1 << log_n
    _compare(j_get_ntt_fns(J_FP, n), ntt.get_ntt_fns(GOLDILOCKS_FP, n),
             _rand(3, n, seed=log_n))


def test_roundtrip_and_size_one():
    x = from_jax_packed(_rand(2, 1 << 10, seed=5), GOLDILOCKS_FP)
    fft, ifft, cfft, cifft = ntt.get_ntt_fns(GOLDILOCKS_FP, 1 << 10)
    assert np.array_equal(ifft(fft(x)).numpy(), x.numpy())
    assert np.array_equal(cifft(cfft(x, SHIFT), J_FP.inv(SHIFT)).numpy(), x.numpy())
    one = x[:, :1]
    assert np.array_equal(ntt.transform(one).numpy(), one.numpy())
    with pytest.raises(ValueError):
        ntt.get_ntt_fns(GOLDILOCKS_FP, 12)


# (max_pass_log, log n): the kernel's plan in one to four passes
PLAN_CASES = ([(2, k) for k in range(1, 9)] + [(3, k) for k in range(3, 13)]
              + [(11, k) for k in (6, 11, 12, 13)])
# the four transforms, in the order of get_ntt_fns
TRANSFORMS = ({}, {"inverse": True}, {"pre": SHIFT},
              {"inverse": True, "post": J_FP.inv(SHIFT)})


@lru_cache(maxsize=None)
def _device_ntt(batch, log_n):
    """One seeded input and the JAX device NTT's four transforms of it."""
    n = 1 << log_n
    x = _rand(batch, n, seed=100 + log_n)
    fft, ifft, cfft, cifft = j_get_ntt_fns(J_FP, n)
    off = jnp.asarray(jgl.pack([SHIFT])[0])
    off_inv = jnp.asarray(jgl.pack([J_FP.inv(SHIFT)])[0])
    return x, [np.asarray(y) for y in (fft(x), ifft(x), cfft(x, off), cifft(x, off_inv))]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("max_pass_log,log_n", PLAN_CASES)
def test_pass_replay_matches_plain_and_device_ntt(max_pass_log, log_n, batch):
    assert 1 <= len(ntt.pass_plan(log_n, max_pass_log)) <= 4
    x, want = _device_ntt(batch, log_n)
    tx = from_jax_packed(x, GOLDILOCKS_FP)
    for kw, w in zip(TRANSFORMS, want):
        got = ntt.transform_passes_plain(tx, **kw, max_pass_log=max_pass_log)
        assert torch.equal(got, ntt.transform_plain(tx, **kw)), kw
        assert np.array_equal(to_jax_packed(got, GOLDILOCKS_FP), w), kw


@pytest.mark.parametrize("log_n,scale", [(0, 1), (1, 1), (6, 1), (7, 5), (21, 1),
                                         (21, 3)])
def test_coset_tables_match_pow(log_n, scale):
    lo, hi = ntt.coset_tables(GOLDILOCKS_FP, SHIFT, log_n, "cpu", scale)
    h = ntt.coset_split(log_n)
    assert lo.numel() == 1 << h and hi.numel() == 1 << (log_n - h)
    for i in sorted({0, 1, (1 << h) - 1, 1 << h, (1 << log_n) - 1}):
        if i >= 1 << log_n:
            continue
        got = GOLDILOCKS_FP.mul(int(lo[i & ((1 << h) - 1)]) % (1 << 64),
                                int(hi[i >> h]) % (1 << 64))
        assert got == pow(SHIFT, i, P) * scale % P, i


def test_coset_tables_cache_stays_bounded():
    """A prove's coset offset is drawn from its transcript, so each new
    trace brings a new one: transforms at more offsets than COSET_CACHE
    keep at most COSET_CACHE table pairs, stay right, and hit on the
    newest."""
    x = from_jax_packed(_rand(2, 1 << 6, seed=7), GOLDILOCKS_FP)
    offsets = [(SHIFT + 17 * k) % P for k in range(ntt.COSET_CACHE + 4)]
    for off in offsets:
        got = ntt.transform_passes_plain(x, pre=off, max_pass_log=3)
        assert torch.equal(got, ntt.transform_plain(x, pre=off))
        assert ntt._coset_tables.cache_info().currsize <= ntt.COSET_CACHE
    hits = ntt._coset_tables.cache_info().hits
    assert ntt.coset_tables(GOLDILOCKS_FP, offsets[-1], 6, "cpu") is not None
    assert ntt._coset_tables.cache_info().hits == hits + 1


@pytest.mark.parametrize("log_n,launches", [(0, 1), (1, 1), (10, 1), (11, 1), (12, 2),
                                            (21, 2), (22, 2), (23, 3), (30, 3)])
def test_pass_plan_launches_and_tiles(log_n, launches):
    """One launch up to 2^MAX_PASS_LOG, two up to 2^(2 MAX_PASS_LOG), three
    to 2^30; the passes tile every stage once, every block reads whole
    32-byte runs (from 2^(MAX_PASS_LOG + 2) on) and two blocks fit an SM's
    228 KB of shared memory."""
    plan = ntt.pass_plan(log_n)
    assert len(plan) == launches
    s0 = 0
    for p in plan:
        assert p.s0 == s0 and 1 <= p.log_tile <= ntt.MAX_PASS_LOG or log_n == 0
        assert p.blocks << (p.log_tile + p.log_cols) == 1 << log_n
        assert p.log_cols == 2 or log_n < ntt.MAX_PASS_LOG + 2
        assert 32 <= p.threads <= 512 and 2 * p.smem <= 228 * 1024
        s0 += p.log_tile
    assert s0 == log_n
