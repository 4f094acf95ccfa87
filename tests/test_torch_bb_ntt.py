"""The port's NTTs over BabyBear on the CPU against ministark_tpu: the plain
radix-2 transform against ``ntt_device.get_ntt_fns``, the four-step passes
(ops/ntt_four_step.py) against ``make_pallas_ntt_fns`` in Pallas interpret
mode, the pipelined factor walk (ops/ntt_pipe.py) against
``make_mxu_ntt_fns`` with ``MINISTARK_MXU_PIPE=1`` (its levels branch to
``_recombine_bb``), the per-field table caches, the backend dispatch and the
fields the NTT refuses. Field arithmetic is exact: the tolerance is 0
everywhere."""

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
    v.reshape(-1)[:3] = [0, 1, P - 1]
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
    x = torch.from_numpy(_bb((2, n), seed).astype(np.int64))
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


# ---------------------------------------------------------------- row 4
def test_four_step_matches_pallas_four_step():
    """ntt_pallas._make_pass1_kernel / _make_pass2_kernel with nlimbs = 1 in
    interpret mode, batch 2, all four transforms."""
    n = 1 << 14
    _compare_with_jax(make_pallas_ntt_fns(J_BB, n),
                      fs.make_four_step_ntt_fns(F, n), 2, n, 14)


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
    x = torch.from_numpy(_bb((2, 1 << 13), 13).astype(np.int64))
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
