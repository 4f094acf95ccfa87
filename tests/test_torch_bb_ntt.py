"""The port's NTTs over BabyBear on the CPU against ministark_tpu: the plain
radix-2 transform against ``ntt_device.get_ntt_fns``, the four-step passes
(ops/ntt_four_step.py) against ``make_pallas_ntt_fns`` in Pallas interpret
mode, the pipelined factor walk (ops/ntt_pipe.py) against
``make_mxu_ntt_fns`` with ``MINISTARK_MXU_PIPE=1`` (its levels branch to
``_recombine_bb``), the per-field table caches, the backend dispatch and the
fields the NTT refuses. Field arithmetic is exact: the tolerance is 0
everywhere."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.fields import BABYBEAR_FP as J_BB
from ministark_tpu.ops import ntt_mxu as jmxu
from ministark_tpu.ops.ntt_device import get_ntt_fns as j_get_ntt_fns
from ministark_tpu.ops.ntt_pallas import make_pallas_ntt_fns
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import (
    BABYBEAR_FP,
    BABYBEAR_FP2,
    BABYBEAR_FP4,
    GOLDILOCKS_FP,
    GOLDILOCKS_FP2,
)
from ministark_tpu_torch.ops import ntt
from ministark_tpu_torch.ops import ntt_four_step as fs
from ministark_tpu_torch.ops import ntt_pipe as pp


import torch_four_step_checks as checks  # tests/, shared with the Goldilocks file
import torch_pipe_checks as pipe_checks  # tests/, shared with the Goldilocks file

F = BABYBEAR_FP
P = F.p
SHIFT = 0x9E3779B9 % P
BACKENDS = ["radix2", "four_step", "pipe"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run side by side: one intra-op thread each
    keeps the plain torch ops from contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bb(shape, seed):
    """Seeded canonical values with 0, 1 and p - 1 up front."""
    v = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint32)
    v.reshape(-1)[:3] = [0, 1, P - 1][: v.size]
    return v


def _compare_with_jax(j_fns, t_fns, batch, n, seed):
    """The four transforms of both packages on the same seeded input."""
    x = _bb((batch, n), seed)
    jx, tx = jnp.asarray(x), from_jax_packed(x, F)
    inv = J_BB.inv(SHIFT)
    pairs = [
        (j_fns[0](jx), t_fns[0](tx)),
        (j_fns[1](jx), t_fns[1](tx)),
        (j_fns[2](jx, jnp.asarray(np.uint32(SHIFT))), t_fns[2](tx, SHIFT)),
        (j_fns[3](jx, jnp.asarray(np.uint32(inv))), t_fns[3](tx, inv)),
    ]
    for want, got in pairs:
        assert np.array_equal(to_jax_packed(got, F), np.asarray(want))


def _compare_with_radix2(fns, n, seed):
    x = torch.from_numpy(_bb((2, n), seed).astype(np.int32))
    fft, ifft, coset_fft, coset_ifft = fns
    inv = F.inv(SHIFT)
    assert torch.equal(fft(x), ntt.transform_plain(x, field=F))
    assert torch.equal(ifft(x), ntt.transform_plain(x, inverse=True, field=F))
    assert torch.equal(coset_fft(x, SHIFT),
                       ntt.transform_plain(x, pre=SHIFT, field=F))
    assert torch.equal(coset_ifft(x, inv),
                       ntt.transform_plain(x, inverse=True, post=inv, field=F))


# ---------------------------------------------------------------- row 1
@pytest.mark.parametrize("log_n", range(3, 16))
def test_radix2_matches_device_ntt(log_n):
    n = 1 << log_n
    _compare_with_jax(j_get_ntt_fns(J_BB, n), ntt.get_ntt_fns(F, n), 3, n, log_n)


# (max_pass_log, log n): the CUDA kernel's plan in one to four passes,
# replayed in torch ops
PLAN_CASES = ([(2, k) for k in range(1, 9)] + [(3, k) for k in range(3, 13)]
              + [(11, k) for k in (6, 11, 12, 13)])
TRANSFORMS = ({}, {"inverse": True}, {"pre": SHIFT},
              {"inverse": True, "post": J_BB.inv(SHIFT)})


@lru_cache(maxsize=None)
def _device_ntt(batch, log_n):
    """One seeded input and the JAX device NTT's four transforms of it."""
    n = 1 << log_n
    x = jnp.asarray(_bb((batch, n), 100 + log_n))
    fft, ifft, cfft, cifft = j_get_ntt_fns(J_BB, n)
    off = jnp.asarray(np.uint32(SHIFT))
    off_inv = jnp.asarray(np.uint32(J_BB.inv(SHIFT)))
    return x, [np.asarray(y) for y in (fft(x), ifft(x), cfft(x, off), cifft(x, off_inv))]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("max_pass_log,log_n", PLAN_CASES)
def test_pass_replay_matches_plain_and_device_ntt(max_pass_log, log_n, batch):
    assert 1 <= len(ntt.pass_plan(log_n, max_pass_log)) <= 4
    x, want = _device_ntt(batch, log_n)
    tx = from_jax_packed(np.asarray(x), F)
    for kw, w in zip(TRANSFORMS, want):
        got = ntt.transform_passes_plain(tx, **kw, field=F, max_pass_log=max_pass_log)
        assert torch.equal(got, ntt.transform_plain(tx, **kw, field=F)), kw
        assert np.array_equal(to_jax_packed(got, F), w), kw


@pytest.mark.parametrize("log_n,scale", [(0, 1), (1, 1), (6, 1), (7, 5), (21, 1),
                                         (21, 3)])
def test_coset_tables_match_pow(log_n, scale):
    lo, hi = ntt.coset_tables(F, SHIFT, log_n, "cpu", scale)
    h = ntt.coset_split(log_n)
    assert lo.numel() == 1 << h and hi.numel() == 1 << (log_n - h)
    for i in sorted({0, 1, (1 << h) - 1, 1 << h, (1 << log_n) - 1}):
        if i >= 1 << log_n:
            continue
        assert int(lo[i & ((1 << h) - 1)]) * int(hi[i >> h]) % P == \
            pow(SHIFT, i, P) * scale % P, i


# ---------------------------------------------------------------- row 4
@lru_cache(maxsize=None)
def _pallas_four_step(log_n):
    """A seeded (3, 2^log_n) input and its transforms by
    ``make_pallas_ntt_fns`` (nlimbs = 1) in interpret mode, as the port's
    tensors: fft, ifft, coset_fft(x, SHIFT), coset_ifft(x, SHIFT^-1), as
    the Goldilocks file makes them (fft and ifft through the coset entry
    points at offset 1, None at 2^15)."""
    n = 1 << log_n
    _, _, coset_fft, coset_ifft = make_pallas_ntt_fns(J_BB, n)
    x = jnp.asarray(_bb((3, n), log_n))
    off = jnp.asarray(np.uint32(SHIFT))
    off_inv = jnp.asarray(np.uint32(J_BB.inv(SHIFT)))
    one = jnp.asarray(np.uint32(1))
    outs = [coset_fft(x, one), coset_ifft(x, one)] if log_n == 14 else [None, None]
    outs += [coset_fft(x, off), coset_ifft(x, off_inv)]
    return from_jax_packed(np.asarray(x), F), [
        None if y is None else from_jax_packed(np.asarray(y), F) for y in outs]


def test_four_step_matches_pallas_four_step():
    """ntt_pallas._make_pass1_kernel / _make_pass2_kernel with nlimbs = 1 in
    interpret mode, batch 3, all four transforms."""
    x, want = _pallas_four_step(14)
    fns = fs.make_four_step_ntt_fns(F, 1 << 14)
    got = [fns[0](x), fns[1](x), fns[2](x, SHIFT), fns[3](x, J_BB.inv(SHIFT))]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("log_n", [14, 15])
def test_four_step_replay_matches_pallas_four_step(log_n, batch):
    """As the Goldilocks test (tests/torch_four_step_checks.py), over
    BabyBear."""
    x, want = _pallas_four_step(log_n)
    checks.replay_matches_pallas(x, want, batch, SHIFT, F)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("log_n", [14, 15])
def test_four_step_replay_passes_match_plain(log_n, batch):
    x = torch.from_numpy(_bb((batch, 1 << log_n), 40 + log_n).astype(np.int32))
    checks.replay_passes_match_plain(x, SHIFT, F)


@pytest.mark.parametrize("log_n", [14, 15, 22])
def test_four_step_kernel_tables_match_pow(log_n):
    checks.kernel_tables_match_pow(log_n, SHIFT, F)


@pytest.mark.parametrize("log_n", [14, 16])
def test_four_step_matches_radix2(log_n):
    _compare_with_radix2(fs.make_four_step_ntt_fns(F, 1 << log_n), 1 << log_n,
                         log_n)


# ---------------------------------------------------------------- row 5
def test_pipe_matches_pipelined_mxu_levels(monkeypatch):
    """ntt_mxu._make_pipe_kernel's BabyBear branch in interpret mode
    (MINISTARK_MXU_FUSED=1, MINISTARK_MXU_PIPE=1), batch 2."""
    monkeypatch.setenv("MINISTARK_MXU_FUSED", "1")
    monkeypatch.setenv("MINISTARK_MXU_PIPE", "1")
    n = 1 << 14
    _compare_with_jax(jmxu.make_mxu_ntt_fns(J_BB, n),
                      pp.make_pipe_ntt_fns(F, n), 2, n, 41)


@pytest.mark.parametrize("log_n", [17, 18])
def test_pipe_matches_radix2(log_n):
    """2^17 has an F = 32 level, 2^18's middle level K_prod > 1."""
    _compare_with_radix2(pp.make_pipe_ntt_fns(F, 1 << log_n), 1 << log_n, log_n)


@pytest.mark.parametrize("log_f,log_r,log_k", pipe_checks.LEVEL_SHAPES)
def test_pipe_level_replay_matches_plain(log_f, log_r, log_k):
    """As the Goldilocks test (tests/torch_pipe_checks.py), over BabyBear."""
    pipe_checks.replay_matches_plain(log_f, log_r, log_k, SHIFT, F)


def test_pipe_transform_replay_matches_radix2(monkeypatch):
    pipe_checks.transform_replay_matches_radix2(17, SHIFT, F, monkeypatch)


@pytest.mark.parametrize("log_n", [14, 17])
def test_pipe_kernel_tables_match_pow(log_n):
    pipe_checks.kernel_tables_match_pow(log_n, SHIFT, F)


# ------------------------------------------------------- tables, dispatch
def test_tables_are_kept_per_field():
    """The same (root, n) in the two fields gives two tables, each right
    for its own modulus: a cache keyed without p would hand one field's
    table to the other."""
    root, n = 5, 64
    for field in (GOLDILOCKS_FP, BABYBEAR_FP):
        tw = ntt.twiddles(field, root, n, "cpu")
        want = [pow(root, j, field.p) for j in range(n // 2)]
        assert [int(v) % (1 << 64) for v in tw] == want
        st = ntt.stage_table(field, root, n, "cpu")
        assert int(st[-1, 1]) % (1 << 64) == root
        assert int(st[0, 0]) == 1 and int(st[-2, 1]) % (1 << 64) == root * root % field.p
    assert not torch.equal(ntt.twiddles(GOLDILOCKS_FP, root, 1 << 12, "cpu"),
                           ntt.twiddles(BABYBEAR_FP, root, 1 << 12, "cpu"))
    gl_levels = pp._tables(1 << 14, False, "cpu", GOLDILOCKS_FP)
    bb_levels = pp._tables(1 << 14, False, "cpu", BABYBEAR_FP)
    assert not torch.equal(gl_levels[0][1], bb_levels[0][1])
    tw1, _, _ = fs._tables(1 << 14, False, "cpu", BABYBEAR_FP)
    assert int(tw1.max()) < P


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_dispatch_by_size(backend):
    x = torch.from_numpy(_bb((2, 1 << 13), 13).astype(np.int32))
    fns = ntt.get_ntt_fns(F, 1 << 13, backend)
    assert torch.equal(fns[2](x, SHIFT), ntt.transform_plain(x, pre=SHIFT, field=F))
    _compare_with_radix2(ntt.get_ntt_fns(F, 1 << 14, backend), 1 << 14, 7)


@pytest.mark.parametrize("field", [BABYBEAR_FP2, BABYBEAR_FP4, GOLDILOCKS_FP2])
def test_extension_fields_are_refused(field):
    """An extension codeword is transformed component by component over
    the prime field; the NTT itself takes a prime field only (BabyBear
    Fp4's base_field is Fp2)."""
    with pytest.raises(ValueError):
        ntt.get_ntt_fns(field, 1 << 4)
    with pytest.raises(ValueError):
        fs.make_four_step_ntt_fns(field, 1 << 14)
    with pytest.raises(ValueError):
        pp.make_pipe_ntt_fns(field, 1 << 14)
