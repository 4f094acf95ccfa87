"""The port's other NTT backends on the CPU against ministark_tpu: the
four-step passes (ops/ntt_four_step.py) against ``make_pallas_ntt_fns`` in
Pallas interpret mode, the pipelined factor walk (ops/ntt_pipe.py) against
``make_mxu_ntt_fns`` with ``MINISTARK_MXU_PIPE=1`` and one level against
``_fused_level_pipe``, both against the port's radix-2 NTT, the backend
dispatch, and whole proofs of both provers with every backend against the
JAX package's proofs and the golden fixtures. Field arithmetic is exact: the
tolerance is 0 everywhere."""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.fields import GOLDILOCKS_FP as J_FP
from ministark_tpu.ops import gl as jgl
from ministark_tpu.ops import ntt_mxu as jmxu
from ministark_tpu.ops.ntt_pallas import make_pallas_ntt_fns
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import GOLDILOCKS_FP, Goldilocks
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.ops import ntt
from ministark_tpu_torch.ops import ntt_four_step as fs
from ministark_tpu_torch.ops import ntt_pipe as pp
from ministark_tpu_torch.stark import StarkConfig
from ministark_tpu_torch.stark import engine as t_eng
from ministark_tpu_torch.stark.engine import DeviceEngine
from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
from ministark_tpu_torch.stark.proof_io import (
    fast_proof_to_bytes,
    proof_digests,
    proof_to_json,
)

P = GOLDILOCKS_FP.p
SHIFT = 0x9E3779B97F4A7C15 % P
BACKENDS = ["radix2", "four_step", "pipe"]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# proof_digests() of ministark_tpu's DeviceEngine at 2^14 - 1 steps and the
# sha256 of ministark_tpu's FastStark proof bytes at 2^14 - 1 steps in
# bench.py::fast_prove's configuration (chip_smoke.py's PINS and FAST_PINS)
JAX_PARITY_16383 = {
    "trace_commit": "cc4dc7e9f1b627fbcdeed56c42abe394af23c58abed3d682f4c909b3b9d8b838",
    "constrain_trace_commit": "2f845ad82e0a4e3cb19170f1782d7c5bf5361edfe4e588a5d63ec23f86b6175e",
    "arthur_sha256": "ad1e759bd5a957b4fb10bae83ca2dfbf62aab68e79dbca21be36e1c284d178c2",
    "fri_payload_sha256": "79f4af90c7fe2d84d1bf0c5a53f49ccd87117f7e61e99698587e30fdcc2f8e57",
}
JAX_FAST_16383 = "465c2b3d49113bc8ac0319772732acf5e6e49c3b41aca93e2e14effd31cebcd4"
FAST_CFG = dict(queries=32, point_queries=2, blowup=2, arity=4, fold_factor=4,
                final_len=32, lde_backend="fri", grinding_bits=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests' plain torch ops run no faster on more intra-op threads,
    and the suite runs several test processes side by side: one thread each
    keeps them from contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u64(shape, seed):
    """Seeded canonical values with 0, p - 1 and values >= 2^63 up front."""
    v = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    v.reshape(-1)[:4] = [0, P - 1, 1 << 63, (1 << 63) + 7]
    return v


def _tensor(v):
    return torch.from_numpy(v.view(np.int64))


def _compare_with_jax(j_fns, t_fns, batch, n, seed):
    """The four transforms of both packages on the same seeded input."""
    x = jnp.asarray(jgl.pack(_u64((batch, n), seed)))
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


def _compare_with_radix2(fns, n, seed):
    x = _tensor(_u64((2, n), seed))
    fft, ifft, coset_fft, coset_ifft = fns
    inv = J_FP.inv(SHIFT)
    assert torch.equal(fft(x), ntt.transform_plain(x))
    assert torch.equal(ifft(x), ntt.transform_plain(x, inverse=True))
    assert torch.equal(coset_fft(x, SHIFT), ntt.transform_plain(x, pre=SHIFT))
    assert torch.equal(coset_ifft(x, inv),
                       ntt.transform_plain(x, inverse=True, post=inv))


# ---------------------------------------------------------------- row 4
def test_four_step_matches_pallas_four_step():
    """ntt_pallas._make_pass1_kernel / _make_pass2_kernel in interpret mode,
    batch 2, all four transforms."""
    n = 1 << 14
    _compare_with_jax(make_pallas_ntt_fns(J_FP, n),
                      fs.make_four_step_ntt_fns(GOLDILOCKS_FP, n), 2, n, 14)


@pytest.mark.parametrize("log_n", [14, 16])
def test_four_step_matches_radix2(log_n):
    _compare_with_radix2(fs.make_four_step_ntt_fns(GOLDILOCKS_FP, 1 << log_n),
                         1 << log_n, log_n)


def test_four_step_passes_split_and_shapes():
    assert fs._split_sizes(1 << 14) == (1 << 7, 1 << 7)
    assert fs._split_sizes(1 << 21) == (1 << 11, 1 << 10)
    assert fs.supports(1 << 14) and fs.supports(1 << 22)
    assert not fs.supports(1 << 13) and not fs.supports(1 << 23)
    n = 1 << 15
    tw1, tw2, wpow = fs._tables(n, False, "cpu")
    assert tw1.shape == (8, 128) and tw2.shape == (7, 64) and wpow.shape == (256,)
    x = _tensor(_u64((2, n), 3))
    c = fs.pass1_plain(x, tw2, wpow, pre=SHIFT)
    assert c.shape == (2, 128, 256)
    y = fs.pass2_plain(c, tw1)
    assert torch.equal(y, ntt.transform_plain(x, pre=SHIFT))


# ---------------------------------------------------------------- row 5
def test_pipe_matches_pipelined_mxu_levels(monkeypatch):
    """ntt_mxu._make_pipe_kernel in interpret mode (MINISTARK_MXU_FUSED=1,
    MINISTARK_MXU_PIPE=1, as tests/test_ntt_mxu.py:124-139), batch 2."""
    monkeypatch.setenv("MINISTARK_MXU_FUSED", "1")
    monkeypatch.setenv("MINISTARK_MXU_PIPE", "1")
    n = 1 << 14
    _compare_with_jax(jmxu.make_mxu_ntt_fns(J_FP, n),
                      pp.make_pipe_ntt_fns(GOLDILOCKS_FP, n), 2, n, 41)


@pytest.mark.parametrize("log_n,factors", [(17, [6, 6, 5]), (18, [6, 6, 6])])
def test_pipe_matches_radix2(log_n, factors):
    """2^17 has an F = 32 level (the case of scripts/tpu_f32_pad_probe.py);
    2^18's middle level has K_prod > 1 (its twiddle rows are r // K_prod)."""
    assert pp.factorize(1 << log_n) == factors == jmxu.factorize(1 << log_n)
    _compare_with_radix2(pp.make_pipe_ntt_fns(GOLDILOCKS_FP, 1 << log_n),
                         1 << log_n, log_n)


def test_pipe_level_matches_fused_level_pipe():
    """One level_plain call against _fused_level_pipe in interpret mode: the
    first level of 2^14 ([7, 7]), with the coset pre-multiply and the
    inter-level twiddle."""
    n, B = 1 << 14, 2
    root = int(J_FP.get_root_of_unity(n))
    factors, _, _, tws_flat, v_pads = jmxu._build_tables(J_FP, n, root)
    Fi, R = 1 << factors[0], n >> factors[0]
    kp = jgl.pack([jmxu._recombine_const(P)])[0]
    kc_np = (np.uint32(kp[0]), np.uint32(kp[1]))
    _, NA, NB = jmxu._params(P)

    x = _u64((B, n), 7)
    pre = np.array([pow(SHIFT, i, P) for i in range(n)], dtype=np.uint64)

    def planes(v):
        return (jnp.asarray((v & 0xFFFFFFFF).astype(np.uint32)),
                jnp.asarray((v >> np.uint64(32)).astype(np.uint32)))

    xp = tuple(t.reshape(B, Fi, R) for t in planes(x))
    lo, hi = jmxu._fused_level_pipe(xp, v_pads[0], NA, NB, kc_np, tws_flat[0],
                                    None, True, pre=planes(pre))
    want = (np.asarray(lo).astype(np.uint64)
            | (np.asarray(hi).astype(np.uint64) << np.uint64(32)))

    (f0, tw, W, k_prod), _ = pp._tables(n, False, "cpu")
    assert f0 == Fi and W.shape == (R, Fi) and k_prod == 1
    got = pp.level_plain(_tensor(x).reshape(B, Fi, R), tw, pre=SHIFT, W=W,
                         k_prod=k_prod)
    assert got.shape == (B, R, Fi)
    assert np.array_equal(got.numpy().view(np.uint64), want)


def test_pipe_tables_follow_the_factor_walk():
    n = 1 << 18
    levels = pp._tables(n, True, "cpu")
    assert [(f, k) for f, _, _, k in levels] == [(64, 1), (64, 64), (64, 4096)]
    assert [None if W is None else tuple(W.shape) for _, _, W, _ in levels] == [
        (4096, 64), (64, 64), None]
    assert pp.fused_supports(1 << 14) and not pp.fused_supports(1 << 13)


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_dispatch_by_size(backend):
    """Below a backend's range the call goes to radix-2, by size."""
    for log_n in (1, 5, 13):
        assert ntt.backend_transform(backend, 1 << log_n) is ntt.transform
    want = {"radix2": ntt.transform, "four_step": fs.transform,
            "pipe": pp.transform}[backend]
    assert ntt.backend_transform(backend, 1 << 14) is want
    assert ntt.backend_transform(backend, 1 << 21) is want
    x = _tensor(_u64((2, 1 << 13), 13))
    fns = ntt.get_ntt_fns(GOLDILOCKS_FP, 1 << 13, backend)
    assert torch.equal(fns[2](x, SHIFT), ntt.transform_plain(x, pre=SHIFT))


def test_four_step_range_ends_at_2_22():
    assert ntt.backend_transform("four_step", 1 << 23) is ntt.transform
    assert ntt.backend_transform("pipe", 1 << 23) is pp.transform


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        ntt.get_ntt_fns(GOLDILOCKS_FP, 1 << 14, "mxu")
    cfg = StarkConfig(Goldilocks, 20, 2, 9, 6)
    with pytest.raises(ValueError):
        DeviceEngine(cfg, device="cpu", ntt_backend="four-step")
    with pytest.raises(ValueError):
        FastStark(FastStarkConfig(Goldilocks, 63), device="cpu", ntt_backend="")


# ------------------------------------------------------------ whole proofs
def _trace(steps):
    return fibonacci_device_trace(Goldilocks, steps, on_device=True, device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_parity_proof_matches_jax_at_2_14(backend):
    """Trace iFFT at 2^14 and LDE at 2^15 through the backend: the proof's
    digests equal those of ministark_tpu's DeviceEngine."""
    steps = (1 << 14) - 1
    trace = _trace(steps)
    engine = DeviceEngine(StarkConfig(Goldilocks, 20, 2, steps,
                                      trace.constrain_number()),
                          device="cpu", ntt_backend=backend)
    proof = engine.prove(trace)
    assert proof_digests(Goldilocks, proof) == JAX_PARITY_16383
    assert engine.verify(engine.constrain_coeffs(trace), proof)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fast_proof_matches_jax_at_2_14(backend):
    steps = (1 << 14) - 1
    trace = _trace(steps)
    stark = FastStark(FastStarkConfig(Goldilocks, steps, **FAST_CFG),
                      device="cpu", ntt_backend=backend)
    proof = stark.prove(trace)
    blob = fast_proof_to_bytes(Goldilocks, proof)
    assert hashlib.sha256(blob).hexdigest() == JAX_FAST_16383
    assert stark.verify(stark._constraint_polys(trace), proof)


@pytest.mark.parametrize("backend", BACKENDS)
def test_small_proofs_match_golden_fixtures(backend, monkeypatch):
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 1)
    trace = _trace(9)
    engine = DeviceEngine(StarkConfig(Goldilocks, 20, 2, 9, trace.constrain_number()),
                          device="cpu", ntt_backend=backend)
    golden = json.load(open(os.path.join(GOLDEN, "goldilocks_fib9.json")))
    assert json.loads(proof_to_json(Goldilocks, engine.prove(trace))) == golden
    stark = FastStark(FastStarkConfig(Goldilocks, 100, queries=4, final_len=8),
                      device="cpu", ntt_backend=backend)
    blob = fast_proof_to_bytes(Goldilocks, stark.prove(_trace(100)))
    assert blob == open(os.path.join(GOLDEN, "fast_fri_fib100.bin"), "rb").read()
