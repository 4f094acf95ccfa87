"""The CUDA kernels against their plain PyTorch versions on the card (the
NTT passes and levels up to the main path's 2^21, in Goldilocks and in
BabyBear), the engine's proof on the card against the host oracle, and the
fast mode's proof on the card against its golden fixture and the CPU's
bytes. Marked ``cuda``: they skip on a host without a
CUDA device (run them on one with ``python -m pytest --noconftest
tests/test_torch_cuda.py -m cuda``)."""

import json
import os

import numpy as np
import pytest
import torch

import ministark_tpu_torch.stark.engine as t_eng
from ministark_tpu_torch.fields import BABYBEAR_FP, BabyBear, Goldilocks
from ministark_tpu_torch.models import fibonacci_air
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.ops import field as gl
from ministark_tpu_torch.ops import leaf_hash as lh
from ministark_tpu_torch.ops import ntt
from ministark_tpu_torch.ops import ntt_four_step as fs
from ministark_tpu_torch.ops import ntt_pipe as pp
from ministark_tpu_torch.ops import sha256 as sh
from ministark_tpu_torch.stark import Stark, StarkConfig

pytestmark = pytest.mark.cuda

P = Goldilocks.base.p


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, seed):
    v = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    v.reshape(-1)[:3] = [0, P - 1, 1 << 63]
    return torch.from_numpy(v.view(np.int64))


@pytest.mark.parametrize("log_n", [1, 3, 12, 13, 16])
def test_ntt_kernel_matches_plain(dev, log_n):
    x = _rand((3, 1 << log_n), log_n).to(dev)
    for kw in ({}, {"inverse": True}, {"pre": 7}, {"inverse": True, "post": 11}):
        assert torch.equal(ntt.transform_cuda(x, **kw), ntt.transform_plain(x, **kw))


@pytest.mark.parametrize("case", ["flat", "broadcast", "fp2-component",
                                  "scalar", "scalars", "empty", "cpu-scalar"])
def test_gl_mul_kernel_matches_plain(dev, case):
    x = _rand((6, 1000, 2), 5).to(dev)
    a, b = {
        "flat": lambda: (x.reshape(-1), x.flip(0).reshape(-1)),
        "broadcast": lambda: (x[..., 0], x[0, :, 1]),
        "fp2-component": lambda: (x[..., 0], x[..., 1]),
        "scalar": lambda: (x, x[2, 3, 1]),
        "scalars": lambda: (x[0, 0, 0], x[1, 1, 1]),
        "empty": lambda: (x[:0], x[0, :, :]),
        "cpu-scalar": lambda: (x[..., 1], gl.pack_u64(12345)),
    }[case]()
    got = gl.mul_cuda(a, b)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), gl.mul_plain(a.cpu(), b.cpu()))
    assert torch.equal(gl.mul(a, b), got)


@pytest.mark.parametrize("log_n", [14, 17, 20, 21])
def test_four_step_passes_match_plain(dev, log_n):
    n = 1 << log_n
    x = _rand((2, n), log_n).to(dev)
    for inverse, pre, post in ((False, None, None), (True, None, None),
                               (False, 7, None), (True, None, 11)):
        tw1, tw2, wpow = fs._tables(n, inverse, dev)
        c = fs.pass1_cuda(x, tw2, wpow, pre)
        assert torch.equal(c, fs.pass1_plain(x, tw2, wpow, pre))
        scale = ntt.inv_n(Goldilocks.base, n) if inverse else None
        assert torch.equal(fs.pass2_cuda(c, tw1, scale, post),
                           fs.pass2_plain(c, tw1, scale, post))
        assert torch.equal(fs.transform(x, inverse, pre, post),
                           ntt.transform_plain(x, inverse, pre, post))


@pytest.mark.parametrize("log_n", [14, 17, 20, 21])
def test_pipe_levels_match_plain(dev, log_n):
    n = 1 << log_n
    x = _rand((2, n), log_n).to(dev)
    for inverse, pre, post in ((False, None, None), (True, None, None),
                               (False, 7, None), (True, None, 11)):
        levels = pp._tables(n, inverse, dev)
        y = x
        for i, (Fi, tw, W, k_prod) in enumerate(levels):
            scale = (ntt.inv_n(Goldilocks.base, n)
                     if inverse and i == len(levels) - 1 else None)
            args = (y.reshape(2, Fi, n // Fi), tw, pre if i == 0 else None, W,
                    k_prod, scale)
            y = pp.level_cuda(*args)
            assert torch.equal(y, pp.level_plain(*args)), (log_n, i)
        assert torch.equal(pp.transform(x, inverse, pre, post),
                           ntt.transform_plain(x, inverse, pre, post))


@pytest.mark.parametrize("fmt,k", [(0, 6), (1, 2)])
def test_leaf_hash_kernel_matches_plain(dev, fmt, k):
    c = _rand((4096 * k, fmt + 1), fmt).to(dev)
    c[:1000] %= 1000
    assert torch.equal(lh.leaf_hash_cuda(c, k, fmt), lh.leaf_hash_plain(c, k, fmt))


def test_inner_level_kernel_matches_plain(dev):
    d = torch.from_numpy(np.random.default_rng(1).integers(
        -2**31, 2**31, size=(8192, 8)).astype(np.int32)).to(dev)
    assert torch.equal(sh.inner_level_cuda(d), sh.inner_level_plain(d))


@pytest.mark.parametrize("fan", [2, 4, 8])
@pytest.mark.parametrize("parents", [1, 2, 3, 4, 1000])
def test_inner_level_kernel_matches_plain_at_every_fan(dev, fan, parents):
    d = torch.from_numpy(np.random.default_rng(fan * parents).integers(
        -2**31, 2**31, size=(fan * parents, 8)).astype(np.int32)).to(dev)
    assert torch.equal(sh.inner_level_cuda(d, fan), sh.inner_level_plain(d, fan))


@pytest.mark.parametrize("C", [1, 6, 7, 8, 9, 40, 48, 192])
def test_row_kernel_matches_plain(dev, C):
    c = _rand((3001, C), C).to(dev)
    assert torch.equal(sh.binary_row_digests_cuda(c), sh.binary_row_digests_plain(c))


def test_fast_stark_on_card_matches_golden(dev):
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
    from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes

    trace = fibonacci_device_trace(Goldilocks, 100, on_device=True, device=dev)
    stark = FastStark(FastStarkConfig(Goldilocks, 100, queries=4, final_len=8),
                      device=dev)
    proof = stark.prove(trace)
    golden = open(os.path.join(os.path.dirname(__file__), "golden",
                               "fast_fri_fib100.bin"), "rb").read()
    assert fast_proof_to_bytes(Goldilocks, proof) == golden
    assert stark.verify(stark._constraint_polys(trace), proof)


@pytest.mark.parametrize("backend", ["four_step", "pipe"])
def test_backends_on_card_match_radix2(dev, backend):
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
    from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_digests

    steps = (1 << 14) - 1
    trace = fibonacci_device_trace(Goldilocks, steps, on_device=True, device=dev)
    cfg = StarkConfig(Goldilocks, 20, 2, steps, trace.constrain_number())
    digests = [proof_digests(Goldilocks, t_eng.DeviceEngine(
        cfg, device=dev, ntt_backend=b).prove(trace)) for b in ("radix2", backend)]
    assert digests[0] == digests[1]
    fcfg = FastStarkConfig(Goldilocks, steps)
    blobs = [fast_proof_to_bytes(Goldilocks, FastStark(
        fcfg, device=dev, ntt_backend=b).prove(trace)) for b in ("radix2", backend)]
    assert blobs[0] == blobs[1]


def test_engine_on_card_matches_host(dev, monkeypatch):
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 32)
    claim, witness = fibonacci_air(Goldilocks, 61)
    cfg = StarkConfig(Goldilocks, 20, 2, 61, claim.trace(witness).constrain_number())
    host = Stark(cfg).prove(claim, witness)
    trace = fibonacci_device_trace(Goldilocks, 61, on_device=True, device=dev)
    engine = t_eng.DeviceEngine(cfg, device=dev)
    proof = engine.prove(trace)
    assert proof.arthur == host.arthur
    assert proof.trace_commit == host.trace_commit
    assert proof.fri_proof.to_host().points == host.fri_proof.points
    assert engine.verify(engine.constrain_coeffs(trace), proof)


# ------------------------------------------------------------ BabyBear
PB = BABYBEAR_FP.p


def _rand_bb(shape, seed):
    v = np.random.default_rng(seed).integers(0, PB, size=shape, dtype=np.int64)
    v.reshape(-1)[:3] = [0, PB - 1, 1]
    return torch.from_numpy(v)


@pytest.mark.parametrize("log_n", [1, 3, 12, 13, 16, 21])
def test_ntt_bb_kernel_matches_plain(dev, log_n):
    x = _rand_bb((3, 1 << log_n), log_n).to(dev)
    for kw in ({}, {"inverse": True}, {"pre": 7}, {"inverse": True, "post": 11}):
        assert torch.equal(ntt.transform_cuda(x, field=BABYBEAR_FP, **kw),
                           ntt.transform_plain(x, field=BABYBEAR_FP, **kw))


@pytest.mark.parametrize("log_n", [14, 17, 20, 21])
def test_four_step_bb_passes_match_plain(dev, log_n):
    n, F = 1 << log_n, BABYBEAR_FP
    x = _rand_bb((2, n), log_n).to(dev)
    for inverse, pre, post in ((False, None, None), (True, None, None),
                               (False, 7, None), (True, None, 11)):
        tw1, tw2, wpow = fs._tables(n, inverse, dev, F)
        c = fs.pass1_cuda(x, tw2, wpow, pre, F)
        assert torch.equal(c, fs.pass1_plain(x, tw2, wpow, pre, F))
        scale = ntt.inv_n(F, n) if inverse else None
        assert torch.equal(fs.pass2_cuda(c, tw1, scale, post, F),
                           fs.pass2_plain(c, tw1, scale, post, F))
        assert torch.equal(fs.transform(x, inverse, pre, post, F),
                           ntt.transform_plain(x, inverse, pre, post, F))


@pytest.mark.parametrize("log_n", [14, 17, 20, 21])
def test_pipe_bb_levels_match_plain(dev, log_n):
    n, F = 1 << log_n, BABYBEAR_FP
    x = _rand_bb((2, n), log_n).to(dev)
    for inverse, pre, post in ((False, None, None), (True, None, None),
                               (False, 7, None), (True, None, 11)):
        levels = pp._tables(n, inverse, dev, F)
        y = x
        for i, (Fi, tw, W, k_prod) in enumerate(levels):
            scale = (ntt.inv_n(F, n)
                     if inverse and i == len(levels) - 1 else None)
            args = (y.reshape(2, Fi, n // Fi), tw, pre if i == 0 else None, W,
                    k_prod, scale, F)
            y = pp.level_cuda(*args)
            assert torch.equal(y, pp.level_plain(*args)), (log_n, i)
        assert torch.equal(pp.transform(x, inverse, pre, post, F),
                           ntt.transform_plain(x, inverse, pre, post, F))


@pytest.mark.parametrize("fmt,k", [(0, 6), (0, 1), (2, 2), (2, 1)])
def test_leaf_hash_bb_kernel_matches_plain(dev, fmt, k):
    c = _rand_bb((4096 * k, 4 if fmt else 1), fmt + k).to(dev)
    c[:1000] %= 1000
    assert torch.equal(lh.leaf_hash_cuda(c, k, fmt, 10),
                       lh.leaf_hash_plain(c, k, fmt, 10))
    # BabyBear values have at most 10 digits: the 20-digit path agrees
    assert torch.equal(lh.leaf_hash_cuda(c, k, fmt, 20),
                       lh.leaf_hash_plain(c, k, fmt, 10))


@pytest.mark.parametrize("C", [16, 96, 384])
def test_row_kernel_bb_widths_match_plain(dev, C):
    c = _rand_bb((3001, C), C).to(dev)
    assert torch.equal(sh.binary_row_digests_cuda(c), sh.binary_row_digests_plain(c))


def test_babybear_engine_on_card_matches_host(dev, monkeypatch):
    from ministark_tpu_torch.stark.proof_io import proof_to_json

    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 1)
    claim, witness = fibonacci_air(BabyBear, 7)
    cfg = StarkConfig(BabyBear, 20, 2, 7, claim.trace(witness).constrain_number())
    trace = fibonacci_device_trace(BabyBear, 7, on_device=True, device=dev)
    engine = t_eng.DeviceEngine(cfg, device=dev)
    proof = engine.prove(trace)
    golden = open(os.path.join(os.path.dirname(__file__), "golden",
                               "babybear_fib7.json")).read()
    assert json.loads(proof_to_json(BabyBear, proof)) == json.loads(golden)
    assert engine.verify(engine.constrain_coeffs(trace), proof)


@pytest.mark.parametrize("backend", ["radix2", "four_step", "pipe"])
def test_babybear_proofs_on_card_match_cpu(dev, backend):
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
    from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_digests

    steps = (1 << 14) - 1
    digests, blobs = [], []
    for d in ("cpu", dev):
        trace = fibonacci_device_trace(BabyBear, steps, on_device=True, device=d)
        cfg = StarkConfig(BabyBear, 20, 2, steps, trace.constrain_number())
        digests.append(proof_digests(BabyBear, t_eng.DeviceEngine(
            cfg, device=d, ntt_backend=backend).prove(trace)))
        blobs.append(fast_proof_to_bytes(BabyBear, FastStark(
            FastStarkConfig(BabyBear, steps), device=d,
            ntt_backend=backend).prove(trace)))
    assert digests[0] == digests[1]
    assert blobs[0] == blobs[1]
