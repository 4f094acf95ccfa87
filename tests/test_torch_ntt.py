"""The port's plain NTT (ministark_tpu_torch/ops/ntt.py) against the JAX
package: the fused MXU level kernel in Pallas interpret mode at 2^14 (as
tests/test_ntt_mxu.py runs it) and the device NTT at 2^1 .. 2^13. Exact
integer equality (tolerance 0)."""

import numpy as np
import pytest
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
