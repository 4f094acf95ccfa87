"""The CUDA kernels against their plain PyTorch versions on the card (the
NTT passes and levels up to the main path's 2^21, in Goldilocks and in
BabyBear), the engine's proof on the card against the host oracle, and the
fast mode's proof on the card against its golden fixture and the CPU's
bytes, the prove core (stark/core.py) and batch_inverse_full on the card
against the CPU's. Marked ``cuda``: they skip on a host without a
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
from ministark_tpu_torch.ops import ntt_digit as nd
from ministark_tpu_torch.ops import ntt_four_step as fs
from ministark_tpu_torch.ops import ntt_pipe as pp
from ministark_tpu_torch.ops import sha256 as sh
from ministark_tpu_torch.ops import stream
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


# the sizes where ntt.pass_plan changes (MAX_PASS_LOG 11): one pass up to
# 2^11, two up to 2^22, three at 2^23 (batch 1 from 2^22)
PLAN_SIZES = [1, 3, 10, 11, 12, 13, 16, 21, 22, 23]


@pytest.mark.parametrize("log_n", PLAN_SIZES)
def test_ntt_kernel_matches_plain(dev, log_n):
    x = _rand((1 if log_n >= 22 else 3, 1 << log_n), log_n).to(dev)
    for kw in ({}, {"inverse": True}, {"pre": 7}, {"inverse": True, "post": 11}):
        before = ntt.pass_launches["gl"]
        got = ntt.transform_cuda(x, **kw)
        assert ntt.pass_launches["gl"] - before == len(ntt.pass_plan(log_n))
        assert torch.equal(got, ntt.transform_plain(x, **kw))


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


@pytest.mark.parametrize("n", [1, 2, 3, 4097, 1 << 16])
def test_gl_mul_contiguous_path_matches_plain(dev, n):
    """The 16-byte path (aligned contiguous operands, odd tails) and the
    same data one element off the boundary (the strided path)."""
    x = _rand((2, n + 1), n).to(dev)
    for a, b in ((x[0, :n], x[1, :n]), (x[0, 1:], x[1, :n]), (x[0, 1:], x[1, 1:])):
        assert torch.equal(gl.mul_cuda(a, b).cpu(), gl.mul_plain(a.cpu(), b.cpu()))


_EXT_CASES = {
    "query-round": lambda x: (x, x.flip(0)),
    "query-scalars": lambda x: (x[:, 0], x[:, 1]),
    "powers": lambda x: (x, x[:, :1]),
    "even-odd": lambda x: (x[:, 0::2], x[:, 1::2]),
    "expand-as": lambda x: (x, x[3, 4].expand_as(x)),
    "scalar": lambda x: (x, x[5, 6]),
    "scalars": lambda x: (x[5, 6], x[4, 8]),
    "cpu-scalar": lambda x: (x, gl.pack_u64([12345, P - 1])),
    "component-stride": lambda x: (x.movedim(-1, 0).contiguous().movedim(0, -1), x),
    "unaligned": lambda x: (x.reshape(-1)[1:-1].reshape(-1, 2), x.reshape(-1, 2)[1:]),
    "empty": lambda x: (x[:0], x[0]),
    "4-axes": lambda x: (x.reshape(2, 3, 2, -1, 2)[:, :, :, 1:], x.reshape(2, 3, 2, -1, 2)[0, :1, :, :-1]),
}


@pytest.mark.parametrize("case", list(_EXT_CASES))
def test_gl_ext_mul_kernel_matches_plain(dev, case):
    x = _rand((6, 1000, 2), 7).to(dev)
    a, b = _EXT_CASES[case](x)
    got = gl.ext_mul_cuda(a, b)
    assert got.device.type == "cuda" and got.is_contiguous()
    assert torch.equal(got.cpu(), gl.ext_mul_plain(a.cpu(), b.cpu()))
    before = gl.ext_launches
    assert torch.equal(gl.ext_mul(a, b), got)
    assert gl.ext_launches == before + (got.numel() > 0)


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


@pytest.mark.parametrize("field", [Goldilocks.base, BABYBEAR_FP], ids=["gl", "bb"])
def test_pipe_level_options_match_plain(dev, field):
    """W's rows and its two-table split, at a level with the coset and W
    (level 0 of 2^21) and at one with K_prod > 1 and the scale."""
    n = 1 << 21
    x = (_rand if field is Goldilocks.base else _rand_bb)((2, n), 5).to(dev)
    levels = pp._tables(n, False, dev, field)
    splits = pp.w_split_tables(n, False, dev, field)
    (F0, tw0, W0, k0), (F1, tw1, W1, k1) = levels[:2]
    cases = [((x.reshape(2, F0, n // F0), tw0, 7, W0, k0, None, field), splits[0]),
             ((x.reshape(2, F1, n // F1), tw1, None, W1, k1, 12345, field), splits[1])]
    for args, split in cases:
        want = pp.level_plain(*args)
        for w_split in (None, split):
            assert torch.equal(pp.level_cuda(*args, w_split=w_split), want)


@pytest.mark.parametrize("fmt,k", [(0, 6), (1, 2)])
def test_leaf_hash_kernel_matches_plain(dev, fmt, k):
    c = _rand((4096 * k, fmt + 1), fmt).to(dev)
    c[:1000] %= 1000
    assert torch.equal(lh.leaf_hash_cuda(c, k, fmt), lh.leaf_hash_plain(c, k, fmt))


@pytest.mark.parametrize("fmt,md,k,lengths", lh.BOUNDARY_CASES,
                         ids=[f"fmt{f}-md{m}-k{k}" for f, m, k, _ in lh.BOUNDARY_CASES])
def test_leaf_hash_kernel_at_padding_boundaries(dev, fmt, md, k, lengths):
    p = P if md == 20 else BABYBEAR_FP.p
    c = torch.from_numpy(lh.boundary_groups(fmt, k, md, p, lengths).view(np.int64))
    assert torch.equal(lh.leaf_hash_cuda(c.to(dev), k, fmt, md).cpu(),
                       lh.leaf_hash_plain(c, k, fmt, md))


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


@pytest.mark.parametrize("log_n", PLAN_SIZES)
def test_ntt_bb_kernel_matches_plain(dev, log_n):
    x = _rand_bb((1 if log_n >= 22 else 3, 1 << log_n), log_n).to(dev)
    for kw in ({}, {"inverse": True}, {"pre": 7}, {"inverse": True, "post": 11}):
        before = ntt.pass_launches["bb"]
        got = ntt.transform_cuda(x, field=BABYBEAR_FP, **kw)
        assert ntt.pass_launches["bb"] - before == len(ntt.pass_plan(log_n))
        assert torch.equal(got, ntt.transform_plain(x, field=BABYBEAR_FP, **kw))


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


# --------------------------------------------- the digit level and the stream
def _rand_centre(shape, seed):
    """Random canonical values with the centring threshold's neighbours."""
    v = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    edge = [0, 1, nd.GL_CENTER_T - 1, nd.GL_CENTER_T, nd.GL_CENTER_T + 1,
            1 << 63, P - 2, P - 1]
    v.reshape(-1)[:len(edge)] = edge[:v.size]
    return torch.from_numpy(v.view(np.int64))


@pytest.mark.parametrize("shape", [(2, 32, 4096), (1, 64, 1), (3, 128, 37),
                                   (2, 5, 130), (1, 512, 64)])
def test_digitize_kernel_matches_plain(dev, shape):
    x = _rand_centre(shape, shape[1]).to(dev)
    got = nd.digitize_cuda(x)
    assert got.dtype == torch.int8 and got.shape == (shape[0], 8 * shape[1], shape[2])
    assert torch.equal(got, nd.digitize_plain(x))
    assert torch.equal(nd.digitize(x), got)


@pytest.mark.parametrize("B,K,R,N", [(2, 256, 4096, 1024), (1, 64, 1, 128),
                                     (2, 512, 37, 512), (1, 1024, 130, 1024),
                                     (3, 256, 129, 256)])
def test_digit_dot_kernel_matches_plain(dev, B, K, R, N):
    rng = np.random.default_rng(K + R)
    d = torch.from_numpy(rng.integers(-128, 128, size=(B, K, R), dtype=np.int64)
                         .astype(np.int8)).to(dev)
    vd = torch.from_numpy(rng.integers(-128, 128, size=(K, N), dtype=np.int64)
                          .astype(np.int8)).to(dev)
    d[0, :, 0] = -128                       # the extreme products
    vd[:, 0] = -128
    got = nd.digit_dot_cuda(d, vd)
    want = (d.cpu().to(torch.int64).transpose(1, 2) @ vd.cpu().to(torch.int64))
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu().to(torch.int64), want)
    assert torch.equal(got, nd.digit_dot_plain(d, vd))


@pytest.mark.parametrize("F,PF,R,k_prod", [(32, 128, 4096, 1), (32, 32, 77, 1),
                                           (64, 64, 1, 1), (128, 128, 256, 64),
                                           (512, 512, 48, 16)])
def test_recombine_kernel_matches_plain(dev, F, PF, R, k_prod):
    rng = np.random.default_rng(F + R)
    Rm = torch.from_numpy(rng.integers(-(1 << 27) + 1, 1 << 27, size=(2, R, 8 * PF),
                                       dtype=np.int64).astype(np.int32)).to(dev)
    Rm[0, 0, :] = (1 << 27) - 1
    Rm[1, 0, :] = -(1 << 27) + 1
    assert torch.equal(nd.recombine_cuda(Rm, F), nd.recombine_plain(Rm, F))
    W = _rand_centre((-(-R // k_prod), F), 3).to(dev) if R % k_prod == 0 else None
    got = nd.recombine_cuda(Rm, F, W, k_prod if W is not None else 1, 12345)
    assert torch.equal(got, nd.recombine_plain(Rm, F, W,
                                               k_prod if W is not None else 1, 12345))


@pytest.mark.parametrize("F,R", [(32, 4096), (32, 33), (64, 1), (64, 200),
                                 (128, 8192), (128, 127), (256, 70), (512, 64),
                                 (512, 31)])
def test_digit_level_kernel_matches_plain_and_butterflies(dev, F, R):
    root = Goldilocks.base.get_root_of_unity(F)
    vd = nd.digit_matrix(root, F, dev)
    x = _rand_centre((2, F, R), F + R).to(dev)
    W = _rand_centre((R, F), 9).to(dev)
    tw = ntt.stage_table(Goldilocks.base, root, F, dev)
    for w, scale in ((None, None), (W, None), (W, 987654321)):
        got = nd.level_cuda(x, vd, w, 1, scale)
        assert torch.equal(got, nd.level_plain(x, vd, w, 1, scale))
        if R & (R - 1) == 0:                 # the butterfly level takes 2^k
            assert torch.equal(got, pp.level_cuda(x, tw, None, w, 1, scale))
    chain = nd.recombine_cuda(nd.digit_dot_cuda(nd.digitize_cuda(x), vd), F, W)
    assert torch.equal(chain, nd.level_cuda(x, vd, W))


def test_digit_level_unpadded_f32_matches_padded(dev):
    root = Goldilocks.base.get_root_of_unity(32)
    x = _rand_centre((2, 32, 512), 1).to(dev)
    assert torch.equal(nd.level_cuda(x, nd.digit_matrix(root, 32, dev, 32)),
                       nd.level_cuda(x, nd.digit_matrix(root, 32, dev, 128)))


@pytest.mark.parametrize("n", [1, 3, 4, 1023, 1 << 20, (1 << 20) + 5])
def test_stream_kernel_matches_plain(dev, n):
    v = np.random.default_rng(n).integers(0, 1 << 32, size=n, dtype=np.uint64)
    v[:1] = 0xFFFFFFFF
    v[-1:] = 0x7FFFFFFF
    x = torch.from_numpy(v.astype(np.uint32).view(np.int32)).to(dev)
    want = stream.stream_add1_plain(x)
    for threads, per in ((256, 4), (128, 1), (1024, 8), (512, 2)):
        assert torch.equal(stream.stream_add1_cuda(x, threads, per), want)
    assert torch.equal(torch.add(x, 1), want)


def test_stream_kernel_default_shape_takes_a_partial_group(dev):
    """The wrapper's default launch shape where the last group of a block
    is partial (some of its threads past the end, some with fewer vectors)
    and n % 4 words trail the last vector."""
    group = 4 * stream.THREADS * stream.PER_THREAD      # words a full group
    n = 3 * group + 4 * (stream.THREADS + 5) + 3
    v = np.random.default_rng(n).integers(0, 1 << 32, size=n, dtype=np.uint64)
    v[-3:] = 0xFFFFFFFF
    x = torch.from_numpy(v.astype(np.uint32).view(np.int32)).to(dev)
    before = stream.launches
    assert torch.equal(stream.stream_add1(x), stream.stream_add1_plain(x))
    assert stream.launches == before + 1


def test_digit_and_stream_wrappers_refuse_cpu_tensors(dev):
    x = _rand_centre((1, 32, 8), 0)
    vd = nd.digit_matrix(Goldilocks.base.get_root_of_unity(32), 32, "cpu")
    with pytest.raises(ValueError):
        nd.digitize_cuda(x)
    with pytest.raises(ValueError):
        nd.digit_dot_cuda(nd.digitize_plain(x), vd)
    with pytest.raises(ValueError):
        nd.recombine_cuda(torch.zeros((1, 8, 8 * 128), dtype=torch.int32), 32)
    with pytest.raises(ValueError):
        nd.level_cuda(x, vd)
    with pytest.raises(ValueError):
        stream.stream_add1_cuda(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        nd.level_cuda(x.to(dev), vd)            # the matrix left on the CPU


# ---- the sharded paths (parallel/): two ranks sharing this card in a gloo
# group, each output against the plain single-device version
SHARDED_LOG_N = 16
SHARDED_OFFSET = 7


def _sharded_inputs():
    from ministark_tpu_torch.fields import BABYBEAR_FP

    rng = np.random.default_rng(10)
    n = 1 << SHARDED_LOG_N
    return {
        "x": {"gl": rng.integers(0, P, size=(3, n), dtype=np.uint64),
              "bb": rng.integers(0, BABYBEAR_FP.p, size=(3, n), dtype=np.uint64)},
        "coeffs": {"gl": rng.integers(0, P, size=(1 << 12, 2), dtype=np.uint64),
                   "bb": rng.integers(0, BABYBEAR_FP.p, size=(1 << 12, 4),
                                      dtype=np.uint64)},
        "scalars": {"gl": ((5, 6), (7, 8)), "bb": (((5, 6), (7, 8)), ((9, 1), (2, 3)))},
        "leaves": {0: rng.integers(0, P, size=(6 << 12, 1), dtype=np.uint64),
                   1: rng.integers(0, P, size=(2 << 12, 2), dtype=np.uint64)},
        "rows": rng.integers(0, P, size=(1 << 12, 48), dtype=np.uint64),
    }


SHARDED_KINDS = ("fft", "ifft", "coset_fft", "coset_ifft")


@pytest.fixture(scope="module")
def sharded():
    """(inputs, rank results) of one two-rank group on the card running
    every sharded case once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ministark_tpu_torch.parallel import cases, launch

    inp = _sharded_inputs()
    todo = []
    for field in ("gl", "bb"):
        for kind in SHARDED_KINDS:
            todo.append(((field, kind), "ntt", dict(
                field=field, n=1 << SHARDED_LOG_N, x=inp["x"][field], kind=kind,
                offset=SHARDED_OFFSET if kind.startswith("coset") else None)))
        alpha, z = inp["scalars"][field]
        todo.append(((field, "fri"), "fri", dict(field=field, n=1 << 12,
                                                 coeffs=inp["coeffs"][field],
                                                 alpha=alpha, z=z)))
    for fmt, k in ((0, 6), (1, 2)):
        todo.append((("tree", fmt), "tree", dict(field="gl", comps=inp["leaves"][fmt],
                                                 leafs_per_node=k, fmt=fmt)))
    for arity in (4, 8):
        todo.append((("index", arity), "index_tree", dict(comps=inp["rows"],
                                                          arity=arity)))
    return inp, launch.run(cases.run, 2, "gloo", "cuda:0", 600, (todo,))


def _u64(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


@pytest.mark.parametrize("field", ["gl", "bb"])
@pytest.mark.parametrize("kind", SHARDED_KINDS)
def test_sharded_ntt_on_card_matches_plain(sharded, field, kind):
    from ministark_tpu_torch.fields import BABYBEAR_FP, GOLDILOCKS_FP

    inp, ranks = sharded
    F = {"gl": GOLDILOCKS_FP, "bb": BABYBEAR_FP}[field]
    x = _u64(inp["x"][field]).cuda()
    kw = {"fft": {}, "ifft": {"inverse": True}, "coset_fft": {"pre": SHARDED_OFFSET},
          "coset_ifft": {"inverse": True, "post": SHARDED_OFFSET}}[kind]
    want = ntt.transform_plain(x, field=F, **kw).cpu()
    for r in ranks:
        got, single = r[(field, kind)]
        assert torch.equal(_u64(got), want)
        assert torch.equal(_u64(single), want)


@pytest.mark.parametrize("field", ["gl", "bb"])
def test_sharded_fri_on_card_matches_plain(sharded, field):
    """fold / deep / divide of the two ranks against ops/poly.py's on the
    CPU (whose products are the plain versions)."""
    from ministark_tpu_torch.fields import BABYBEAR_FP4, GOLDILOCKS_FP2
    from ministark_tpu_torch.ops.poly import eval_even_odd, fold_even_odd, synth_div_suffix

    inp, ranks = sharded
    E = {"gl": GOLDILOCKS_FP2, "bb": BABYBEAR_FP4}[field]
    k = gl.get_ops(E)
    c = _u64(inp["coeffs"][field])
    alpha, z = inp["scalars"][field]
    ap, zp, zi = k.pack_scalar(alpha), k.pack_scalar(z), k.pack_scalar(E.inv(z))
    q = synth_div_suffix(k, c, zp, zi)
    want = {"fold": fold_even_odd(k, c, ap),
            "deep": torch.stack(list(eval_even_odd(k, c, zp))),
            "divide": torch.cat([q, torch.zeros_like(q[:1])])}
    for r in ranks:
        for name, (got, _) in r[(field, "fri")].items():
            assert torch.equal(_u64(got), want[name]), name


@pytest.mark.parametrize("fmt,k", [(0, 6), (1, 2)])
def test_sharded_tree_on_card_matches_plain(sharded, fmt, k):
    inp, ranks = sharded
    leaf = lh.leaf_hash_plain(_u64(inp["leaves"][fmt]).cuda(), k, fmt)
    levels = [leaf]
    while levels[-1].shape[0] > 1:
        levels.append(sh.inner_level_plain(levels[-1]))
    want = torch.cat(levels).cpu().numpy()
    for r in ranks:
        assert np.array_equal(r[("tree", fmt)][0], want)


@pytest.mark.parametrize("arity", [4, 8])
def test_sharded_index_tree_on_card_matches_plain(sharded, arity):
    inp, ranks = sharded
    levels = [sh.binary_row_digests_plain(_u64(inp["rows"]).cuda())]
    while levels[-1].shape[0] > 1:
        levels.append(sh.inner_level_plain(levels[-1], min(arity, levels[-1].shape[0])))
    want = torch.cat(levels).cpu().numpy()
    for r in ranks:
        assert np.array_equal(r[("index", arity)][0], want)


@pytest.mark.parametrize("field,model", [("gl", "fibonacci"), ("gl", "mimc"),
                                         ("bb", "fibonacci"), ("bb", "mimc")])
def test_prove_core_on_card_matches_cpu(dev, field, model):
    """stark/core.py's core at 2^14 on the card (the NTT and product
    kernels) equals the CPU's (their plain versions)."""
    from ministark_tpu_torch.models.mimc import mimc_device_trace
    from ministark_tpu_torch.stark.core import make_prove_core

    sf = {"gl": Goldilocks, "bb": BabyBear}[field]
    builder = mimc_device_trace if model == "mimc" else None
    outs = []
    for device in (dev, "cpu"):
        core, args = make_prove_core(sf, 1 << 14, builder, device=device)
        outs.append([o.cpu() for o in core(*args())])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("field", [Goldilocks.base, BABYBEAR_FP])
def test_batch_inverse_full_on_card(dev, field):
    from ministark_tpu_torch.ops.field import get_ops
    from ministark_tpu_torch.ops.poly import batch_inverse_full

    k = get_ops(field)
    v = np.random.default_rng(14).integers(1, field.p, size=1 << 16, dtype=np.uint64)
    x = torch.from_numpy(v.view(np.int64))
    want = batch_inverse_full(field, k, x)
    assert torch.equal(batch_inverse_full(field, k, x.to(dev)).cpu(), want)
    assert k.unpack(want[:4]) == [field.inv(int(a)) for a in v[:4]]
