"""The CUDA kernels against their plain PyTorch versions on the card (the
NTT passes and levels up to the main path's 2^21, in Goldilocks and in
BabyBear, the division scan and pow_dot in Fp2 and Fp4, the point
evaluations on pow_dot and the first-occurrence leaf search with one launch
a call, the field ops of csrc/field_ew.cu with one launch a call, the
device witnesses of csrc/witness.cu whole and in blocks with one launch a
call), the engine's proof on the card
against the host oracle, and the
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
from ministark_tpu_torch.ops import bb
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
    before = gl.launches["gl_ext_mul"]
    assert torch.equal(gl.ext_mul(a, b), got)
    assert gl.launches["gl_ext_mul"] == before + (got.numel() > 0)


def _k_cases(K, p):
    """``_EXT_CASES`` over elements of K components (Fp2, Fp4)."""
    return {
        "query-round": lambda x: (x, x.flip(0)),
        "query-scalars": lambda x: (x[:, 0], x[:, 1]),
        "powers": lambda x: (x, x[:, :1]),
        "even-odd": lambda x: (x[:, 0::2], x[:, 1::2]),
        "expand-as": lambda x: (x, x[3, 4].expand_as(x)),
        "scalar": lambda x: (x, x[5, 6]),
        "scalars": lambda x: (x[5, 6], x[4, 8]),
        "cpu-scalar": lambda x: (x, gl.pack_words([12345, p - 1, 7, 1][:K], x.dtype)),
        "component-stride": lambda x: (x.movedim(-1, 0).contiguous().movedim(0, -1), x),
        "unaligned": lambda x: (x.reshape(-1)[1:1 - K].reshape(-1, K),
                                x.reshape(-1, K)[1:]),
        "empty": lambda x: (x[:0], x[0]),
        "4-axes": lambda x: (x.reshape(2, 3, 2, -1, K)[:, :, :, 1:],
                             x.reshape(2, 3, 2, -1, K)[0, :1, :, :-1]),
    }


# extension op -> (module, kernel name, K, the CUDA wrapper, the plain version,
# the dispatcher), the second operand of a product by a base scalar its
# component 0
_EW_EXT_OPS = {
    "ext_add": (gl, "gl_ew", 2, gl.ext_add_cuda, gl.ext_add_plain, gl.ext_add),
    "ext_sub": (gl, "gl_ew", 2, gl.ext_sub_cuda, gl.ext_sub_plain, gl.ext_sub),
    "ext_neg": (gl, "gl_ew", 2, gl.neg_cuda, gl.ext_neg_plain, gl.ext_neg),
    "ext_scale_base": (gl, "gl_mul", 2, gl.ext_scale_base_cuda,
                       gl.ext_scale_base_plain, gl.ext_scale_base),
    "fp4_add": (bb, "bb_ew", 4, bb.fp4_add_cuda, bb.fp4_add_plain, bb.fp4_add),
    "fp4_sub": (bb, "bb_ew", 4, bb.fp4_sub_cuda, bb.fp4_sub_plain, bb.fp4_sub),
    "fp4_neg": (bb, "bb_ew", 4, bb.neg_cuda, bb.fp4_neg_plain, bb.fp4_neg),
    "fp4_scale_base": (bb, "bb_ew", 4, bb.fp4_scale_base_cuda,
                       bb.fp4_scale_base_plain, bb.fp4_scale_base),
    "fp4_mul": (bb, "bb_fp4_mul", 4, bb.fp4_mul_cuda, bb.fp4_mul_plain, bb.fp4_mul),
}


def _rand_p(shape, p, seed):
    """Values below p in the field's storage: int32 for BabyBear."""
    v = np.random.default_rng(seed).integers(0, p, size=shape, dtype=np.uint64)
    v.reshape(-1)[:3] = [0, 1, p - 1]
    return gl.pack_words(v, torch.int32 if p < 1 << 32 else torch.int64)


@pytest.mark.parametrize("case", list(_EXT_CASES))
@pytest.mark.parametrize("op", list(_EW_EXT_OPS))
def test_field_ew_ext_kernels_match_plain(dev, op, case):
    """csrc/field_ew.cu's kernels (and gl_mul under the Fp2 product by a
    base scalar) on the extension ops at ``_EXT_CASES``' shapes, against
    the plain versions; one call and one launch through the dispatcher."""
    mod, name, K, kern, plain, disp = _EW_EXT_OPS[op]
    x = _rand_p((6, 1000, K), mod.P, 11).to(dev)
    a, b = _k_cases(K, mod.P)[case](x)
    args = (a,) if op.endswith("_neg") else (a, b[..., 0]) if "scale" in op else (a, b)
    got = kern(*args)
    assert got.device.type == "cuda" and got.is_contiguous()
    assert torch.equal(got.cpu(), plain(*(t.cpu() for t in args)))
    launches, calls = mod.launches[name], mod.calls[name]
    assert torch.equal(disp(*args), got)
    one = int(got.numel() > 0)
    assert (mod.launches[name] - launches, mod.calls[name] - calls) == (one, one)


# base op -> (module, kernel, the CUDA wrapper, plain version, dispatcher)
_EW_BASE_OPS = {
    "gl.add": (gl, "gl_ew", gl.add_cuda, gl.add_plain, gl.add),
    "gl.sub": (gl, "gl_ew", gl.sub_cuda, gl.sub_plain, gl.sub),
    "gl.neg": (gl, "gl_ew", gl.neg_cuda, gl.neg_plain, gl.neg),
    "bb.add": (bb, "bb_ew", bb.add_cuda, bb.add_plain, bb.add),
    "bb.sub": (bb, "bb_ew", bb.sub_cuda, bb.sub_plain, bb.sub),
    "bb.neg": (bb, "bb_ew", bb.neg_cuda, bb.neg_plain, bb.neg),
    "bb.mul": (bb, "bb_ew", bb.mul_cuda, bb.mul_plain, bb.mul),
}


@pytest.mark.parametrize("case", ["flat", "broadcast", "fp2-component", "scalar",
                                  "scalars", "empty", "cpu-scalar"])
@pytest.mark.parametrize("op", list(_EW_BASE_OPS))
def test_field_ew_base_kernels_match_plain(dev, op, case):
    """The base-field ops at ``test_gl_mul_kernel_matches_plain``'s shapes."""
    mod, name, kern, plain, disp = _EW_BASE_OPS[op]
    x = _rand_p((6, 1000, 2), mod.P, 13).to(dev)
    a, b = {
        "flat": lambda: (x.reshape(-1), x.flip(0).reshape(-1)),
        "broadcast": lambda: (x[..., 0], x[0, :, 1]),
        "fp2-component": lambda: (x[..., 0], x[..., 1]),
        "scalar": lambda: (x, x[2, 3, 1]),
        "scalars": lambda: (x[0, 0, 0], x[1, 1, 1]),
        "empty": lambda: (x[:0], x[0, :, :]),
        "cpu-scalar": lambda: (x[..., 1], gl.pack_words(mod.P - 1, x.dtype)),
    }[case]()
    args = (a,) if op.endswith("neg") else (a, b)
    got = kern(*args)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), plain(*(t.cpu() for t in args)))
    launches, calls = mod.launches[name], mod.calls[name]
    assert torch.equal(disp(*args), got)
    one = int(got.numel() > 0)
    assert (mod.launches[name] - launches, mod.calls[name] - calls) == (one, one)


@pytest.mark.parametrize("n", [1, 2, 3, 4097, 1 << 16])
@pytest.mark.parametrize("op", list(_EW_BASE_OPS))
def test_field_ew_contiguous_path_matches_plain(dev, op, n):
    """The 16-byte path (aligned contiguous operands, odd tails) and the
    same data one element off the boundary (the strided path)."""
    mod, _, kern, plain, _ = _EW_BASE_OPS[op]
    x = _rand_p((2, n + 1), mod.P, n).to(dev)
    for a, b in ((x[0, :n], x[1, :n]), (x[0, 1:], x[1, :n]), (x[0, 1:], x[1, 1:])):
        args = (a,) if op.endswith("neg") else (a, b)
        assert torch.equal(kern(*args).cpu(), plain(*(t.cpu() for t in args)))


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
    g = lh.boundary_groups(fmt, k, md, p, lengths)
    # the 10-digit path is BabyBear's: 32-bit words (2^32 - 1 as -1)
    c = torch.from_numpy(g.view(np.int64) if md == 20 else g.astype(np.uint32).view(np.int32))
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
    assert torch.equal(sh.binary_row_digests_cuda(c, torch.int64),
                       sh.binary_row_digests_plain(c))


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
    return torch.from_numpy(v.astype(np.int32))


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
    # BabyBear values have at most 10 digits: the 20-digit path (Goldilocks'
    # 64-bit words) agrees on the same values widened
    assert torch.equal(lh.leaf_hash_cuda(c.to(torch.int64), k, fmt, 20),
                       lh.leaf_hash_plain(c, k, fmt, 10))
    with pytest.raises(ValueError):          # 10 digits take 32-bit words only
        lh.leaf_hash_cuda(c.to(torch.int64), k, fmt, 10)


@pytest.mark.parametrize("C", [16, 96, 384])
def test_row_kernel_bb_widths_match_plain(dev, C):
    c = _rand_bb((3001, C), C).to(dev)
    assert torch.equal(sh.binary_row_digests_cuda(c, torch.int32),
                       sh.binary_row_digests_plain(c))
    with pytest.raises(ValueError):          # the BabyBear kernel takes int32 only
        sh.binary_row_digests_cuda(c.to(torch.int64), torch.int32)


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


def _rand_ext(E, shape, seed):
    """(*shape, K) components of the extension E, below its prime, in its
    storage (int32 for BabyBear)."""
    v = np.random.default_rng(seed).integers(0, E.p, size=tuple(shape) + (E.extension_degree,),
                                             dtype=np.uint64)
    return gl.pack_words(v, gl.get_ops(E).dtype)


def _ext(field):
    from ministark_tpu_torch.fields import BABYBEAR_FP4, GOLDILOCKS_FP2

    E = {"gl2": GOLDILOCKS_FP2, "bb4": BABYBEAR_FP4}[field]
    return E, gl.get_ops(E)


def _points(E, k, count, seed):
    """(z, 1/z) stacked, (count, K) each, z nonzero."""
    zs = [E.from_base_coeffs(tuple(int(c) for c in gl.unpack_u64(row)))
          for row in _rand_ext(E, (count,), seed)]
    return k.pack(zs), k.pack([E.inv(z) for z in zs])


# one tile (Fp4 2048 elements, Fp2 4096) and its edges, several tiles, and
# 74 (Fp2) or 147 (Fp4) tiles: a look-back within its first round of 256
# tiles (test_div_scan_race_and_graph's 2^20 + 1 takes more than one round)
DIV_SCAN_SIZES = [1, 2, 5, 2047, 2048, 2049, 4095, 4096, 4097, 300001]


@pytest.mark.parametrize("field", ["gl2", "bb4"])
@pytest.mark.parametrize("m", DIV_SCAN_SIZES)
def test_div_scan_kernel_matches_plain(dev, field, m):
    """Every form (fold, head, carry) at a start, three rows, the head over
    one broadcast polynomial too; the plain version on the card."""
    from ministark_tpu_torch.ops import div_scan as ds

    E, k = _ext(field)
    B = 3
    z, zinv = (t.to(dev) for t in _points(E, k, B, m))
    for flags in range(8):
        fold, head, carry = bool(flags & 1), bool(flags & 2), bool(flags & 4)
        c = _rand_ext(E, (B, 2 * m if fold else m), 10 * m + flags).to(dev)
        kw = {"start": 12345 if carry else 0,
              "carry": _rand_ext(E, (B,), flags).to(dev) if carry else None,
              "head": _rand_ext(E, (B, 3), flags + 1).to(dev) if head else None,
              "fold": _rand_ext(E, (), flags + 2).to(dev) if fold else None}
        before = ds.launches["div_scan_" + field]
        got = ds.div_scan(k, c, z, zinv, **kw)
        assert ds.launches["div_scan_" + field] == before + 1     # one single-pass launch
        assert torch.equal(got, ds.div_scan_plain(k, c, z, zinv, **kw)), flags
        one = c[:1].expand(B, -1, -1)
        assert torch.equal(ds.div_scan_cuda(k, one, z, zinv, **kw),
                           ds.div_scan_plain(k, one, z, zinv, **kw)), flags


@pytest.mark.parametrize("field", ["gl2", "bb4"])
@pytest.mark.parametrize("n", [0, 1, 7, 2048, 4097, 300001])
def test_pow_dot_kernel_matches_plain(dev, field, n):
    from ministark_tpu_torch.ops import div_scan as ds

    E, k = _ext(field)
    c = _rand_ext(E, (2, n), n).to(dev)
    z, _ = (t.to(dev) for t in _points(E, k, 2, n + 1))
    cases = [(1, 0, 0, 1), (2, 0, 5, 1), (2, 1, 1 << 40, 1), (3, 2, 77, 1),
             (1, 0, 0, 2), (1, 0, 1 << 40, 2), (2, 1, 5, 2)]
    for stride, offset, start, parts in cases:
        for zz in (z, z[:1].expand(2, -1)):
            before = ds.launches["pow_dot_" + field]
            got = ds.pow_dot(k, c, zz, start, stride, offset, parts)
            assert ds.launches["pow_dot_" + field] == before + 1   # one launch a call
            assert torch.equal(got, ds.pow_dot_plain(k, c, zz, start, stride, offset, parts))


@pytest.mark.parametrize("field", ["gl2", "bb4"])
def test_div_scan_race_and_graph(dev, field):
    """50 back-to-back calls over 74-147 tiles a row, and over 257-513 (a
    look-back of more than one round of 256 tiles), the look-back's flags
    and ticket written back to zero by each call's last block, each equal
    to the plain result; a CUDA graph of one fold-divide replayed 3 times."""
    from ministark_tpu_torch.ops import div_scan as ds

    E, k = _ext(field)
    z, zinv = (t.to(dev) for t in _points(E, k, 3, 7))
    for m in (300001, (1 << 20) + 1):
        c = _rand_ext(E, (3, m), 8).to(dev)
        want = ds.div_scan_plain(k, c, z, zinv)
        outs = [ds.div_scan_cuda(k, c, z, zinv) for _ in range(50)]
        assert all(torch.equal(o, want) for o in outs)
        del outs
    m = 300001
    c2, alpha = _rand_ext(E, (1, 2 * m), 9).to(dev), _rand_ext(E, (), 10).to(dev)
    kw = dict(head=_rand_ext(E, (1, 1), 11).to(dev), fold=alpha)
    want = ds.div_scan_plain(k, c2, z[:1], zinv[:1], **kw)
    ds.div_scan_cuda(k, c2, z[:1], zinv[:1], **kw)            # warm: scratch made
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ds.div_scan_cuda(k, c2, z[:1], zinv[:1], **kw)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_div_scan_wrappers_refuse(dev):
    from ministark_tpu_torch.ops import div_scan as ds

    E, k = _ext("gl2")
    c = _rand_ext(E, (2, 8), 0).to(dev)
    z, zinv = (t.to(dev) for t in _points(E, k, 2, 0))
    with pytest.raises(ValueError):
        ds.div_scan_cuda(k, c, z.cpu(), zinv)               # z left on the CPU
    with pytest.raises(ValueError):
        ds.div_scan_cuda(k, c[:, :7], z, zinv, fold=z[0])   # an odd count does not fold
    with pytest.raises(ValueError):
        ds.pow_dot_cuda(k, c.movedim(-1, 0).contiguous().movedim(0, -1), z)


@pytest.mark.parametrize("field", ["gl2", "bb4"])
def test_point_evals_one_pow_dot_launch(dev, field):
    """eval_many (a point broadcast over 4 rows), STIR's eval_points and
    WHIR's sumcheck_evals (the coefficients broadcast over 5 points), with
    and without a start: one pow_dot launch each, equal to the CPU's."""
    from ministark_tpu_torch.fri.stir import eval_points
    from ministark_tpu_torch.fri.whir import sumcheck_evals
    from ministark_tpu_torch.ops import div_scan as ds
    from ministark_tpu_torch.ops.poly import eval_many

    E, k = _ext(field)
    c, pts = _rand_ext(E, (4, 4099), 3), _points(E, k, 5, 4)[0]
    for start in (0, 12345):
        for fn, args in ((eval_many, (c, pts[0])), (eval_points, (c[0], pts)),
                         (sumcheck_evals, (c[0, :4098], pts))):
            want = fn(k, *args, start)
            before = ds.launches["pow_dot_" + field]
            got = fn(k, *(a.to(dev) for a in args), start)
            assert ds.launches["pow_dot_" + field] == before + 1
            assert torch.equal(got.cpu(), want)


def _planted_comps(n, C, seed):
    """(n, C) random u64 elements with copies of element 5 at n // 2 and
    n - 1, and rows (6, C): index 0, n - 1 (a copy), 5, an element at
    n // 3, one off in its last word, and an absent value."""
    rng = np.random.default_rng(seed)
    comps = rng.integers(0, 1 << 64, size=(n, C), dtype=np.uint64)
    comps[n // 2] = comps[5]
    comps[n - 1] = comps[5]
    rows = np.stack([comps[0], comps[n - 1], comps[5], comps[n // 3], comps[n // 3],
                     rng.integers(0, 1 << 64, size=C, dtype=np.uint64)])
    rows[4, -1] ^= np.uint64(1)
    return (torch.from_numpy(comps.view(np.int64)), torch.from_numpy(rows.view(np.int64)))


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 7, 1024, 1025, 300001, 1 << 21])
def test_first_match_kernel_matches_plain(dev, C, n):
    """ms_first_match against the plain compare at 6 rows, 64 rows (over
    SEARCH_CHUNK) and 1030 (two launches: MATCH_MAX_ROWS 1024 a launch),
    one launch a call up to 1024 rows; no rows, no launch."""
    from ministark_tpu_torch.commit import packed_tree as pt

    comps, rows = _planted_comps(max(n, 8), C, n)
    comps = comps[:n]
    for r in (rows, rows.repeat(11, 1)[:64], rows.repeat(172, 1)[:1030]):
        want = pt._first_match_find_plain(comps, r)
        before = pt.launches["first_match"]
        got = pt._first_match_find(comps.to(dev), r.to(dev), torch.int64)
        assert pt.launches["first_match"] - before == -(-r.shape[0] // pt.MATCH_MAX_ROWS)
        assert torch.equal(got.cpu(), want)
    before = pt.launches["first_match"]
    assert pt._first_match_find(comps.to(dev), rows[:0].to(dev), torch.int64).shape == (0,)
    assert pt.launches["first_match"] == before


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("n", [7, 1025, 1 << 21])
def test_first_match_bb_kernel_matches_plain(dev, C, n):
    """ms_first_match_bb (BabyBear's 32-bit words: a base element, an Fp4
    row one 16-byte load) against the plain compare, one launch a call."""
    from ministark_tpu_torch.commit import packed_tree as pt

    comps, rows = (t.numpy().view(np.uint64).astype(np.uint32).view(np.int32)
                   for t in _planted_comps(max(n, 8), C, n))
    comps, rows = torch.from_numpy(comps[:n].copy()), torch.from_numpy(rows.copy())
    want = pt._first_match_find_plain(comps, rows)
    before = pt.launches["first_match"]
    got = pt._first_match_find(comps.to(dev), rows.to(dev), torch.int32)
    assert pt.launches["first_match"] - before == 1
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError):          # the BabyBear kernel takes int32 only
        pt.first_match_cuda(comps.to(dev).to(torch.int64), rows.to(dev).to(torch.int64),
                            torch.int32)


def test_first_match_race_and_graph(dev):
    """50 calls back to back (the scratch's minima and ticket reset by each
    call's last block), each equal to the plain result; a CUDA graph of one
    call replayed 3 times."""
    from ministark_tpu_torch.commit import packed_tree as pt

    comps, rows = _planted_comps(1 << 21, 2, 50)
    want = pt._first_match_find_plain(comps, rows)
    c, r = comps.to(dev), rows.to(dev)
    outs = [pt.first_match_cuda(c, r, torch.int64) for _ in range(50)]
    assert all(torch.equal(o.cpu(), want) for o in outs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = pt.first_match_cuda(c, r, torch.int64)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype,C,q", [(torch.int64, 2, 6), (torch.int64, 2, 12),
                                       (torch.int64, 1, 9), (torch.int32, 4, 8),
                                       (torch.int32, 4, 64), (torch.int32, 2, 1024)])
def test_first_match_edges_and_prefilter_twins(dev, dtype, C, q):
    """Rows first at the edges of the kernel's walk (``first_match_geometry``:
    block 0's last thread, block 1's first, the grid's first and second
    pass, the passes the rings hold at the start and the first a slot
    takes again, the last pass, n - 1), each after an element equal to it
    in the prefilter word (word 0's low 32 bits) only, rows in registers
    (q <= MATCH_REG_ROWS) and in shared memory; equal to the plain compare,
    one launch."""
    from ministark_tpu_torch.commit import packed_tree as pt

    n = (1 << 21) - 5
    g = pt.first_match_geometry(n, q, C, dtype)
    ring = g["stages"] * g["step"]
    edges = sorted({e for e in (0, g["threads"] - 1, g["threads"], g["step"] - 1, g["step"],
                                ring - 1, ring, (n - 1) // g["step"] * g["step"], n - 1)
                    if e < n})
    rng = np.random.default_rng(q)
    bits = 63 if dtype == torch.int64 else 31
    comps = rng.integers(0, 1 << bits, size=(n, C), dtype=np.int64)
    idx = (edges + [int(i) for i in rng.integers(0, n, size=q)])[:q]
    for e in edges:
        if e >= 1 and e - 1 not in edges and (dtype == torch.int64 or C > 1):
            twin = comps[e].copy()
            if dtype == torch.int64:
                twin[0] ^= 1 << 40              # word 0's high half
            else:
                twin[1] ^= 1
            comps[e - 1] = twin
    rows = comps[idx].copy()
    c = torch.from_numpy(comps.astype(np.int32) if dtype == torch.int32 else comps)
    r = torch.from_numpy(rows.astype(np.int32) if dtype == torch.int32 else rows)
    want = pt._first_match_find_plain(c, r)
    k = min(q, len(edges))
    assert want[:k].tolist() == edges[:k]
    before = pt.launches["first_match"]
    got = pt.first_match_cuda(c.to(dev), r.to(dev), dtype)
    assert pt.launches["first_match"] - before == 1
    assert torch.equal(got.cpu(), want)


def test_first_match_wrapper_refuses(dev):
    from ministark_tpu_torch.commit import packed_tree as pt

    comps, rows = _planted_comps(64, 2, 1)
    c, r = comps.to(dev), rows.to(dev)
    for bad in ((c, r.cpu()), (c.t(), r), (c.to(torch.int32), r), (c, r[:, :1]),
                (_planted_comps(64, 3, 1)[0].to(dev), _planted_comps(64, 3, 1)[1].to(dev)),
                (c.reshape(-1)[1:-1].reshape(63, 2), r)):
        with pytest.raises(ValueError):
            pt.first_match_cuda(*bad, torch.int64)


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


def _u64(a, field="gl"):
    """u64 values -> a tensor in the field's storage (int32 for "bb")."""
    return gl.pack_words(np.ascontiguousarray(a, dtype=np.uint64),
                         torch.int32 if field == "bb" else torch.int64)


@pytest.mark.parametrize("field", ["gl", "bb"])
@pytest.mark.parametrize("kind", SHARDED_KINDS)
def test_sharded_ntt_on_card_matches_plain(sharded, field, kind):
    from ministark_tpu_torch.fields import BABYBEAR_FP, GOLDILOCKS_FP

    inp, ranks = sharded
    F = {"gl": GOLDILOCKS_FP, "bb": BABYBEAR_FP}[field]
    x = _u64(inp["x"][field], field).cuda()
    kw = {"fft": {}, "ifft": {"inverse": True}, "coset_fft": {"pre": SHARDED_OFFSET},
          "coset_ifft": {"inverse": True, "post": SHARDED_OFFSET}}[kind]
    want = ntt.transform_plain(x, field=F, **kw).cpu()
    for r in ranks:
        got, single = r[(field, kind)]
        assert torch.equal(_u64(got, field), want)
        assert torch.equal(_u64(single, field), want)


@pytest.mark.parametrize("field", ["gl", "bb"])
def test_sharded_fri_on_card_matches_plain(sharded, field):
    """fold / deep / divide of the two ranks against ops/poly.py's on the
    CPU (whose products are the plain versions)."""
    from ministark_tpu_torch.fields import BABYBEAR_FP4, GOLDILOCKS_FP2
    from ministark_tpu_torch.ops.poly import eval_even_odd, fold_even_odd, synth_div_suffix

    inp, ranks = sharded
    E = {"gl": GOLDILOCKS_FP2, "bb": BABYBEAR_FP4}[field]
    k = gl.get_ops(E)
    c = _u64(inp["coeffs"][field], field)
    alpha, z = inp["scalars"][field]
    ap, zp, zi = k.pack_scalar(alpha), k.pack_scalar(z), k.pack_scalar(E.inv(z))
    q = synth_div_suffix(k, c, zp, zi)
    want = {"fold": fold_even_odd(k, c, ap),
            "deep": torch.stack(list(eval_even_odd(k, c, zp))),
            "divide": torch.cat([q, torch.zeros_like(q[:1])])}
    for r in ranks:
        for name, (got, _) in r[(field, "fri")].items():
            assert torch.equal(_u64(got, field), want[name]), name


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
    x = gl.pack_words(v, k.dtype)
    want = batch_inverse_full(field, k, x)
    assert torch.equal(batch_inverse_full(field, k, x.to(dev)).cpu(), want)
    assert k.unpack(want[:4]) == [field.inv(int(a)) for a in v[:4]]


# the device witnesses (csrc/witness.cu): (lo, count) of a trace of 2^20
# rows at steps 2^20 - 1: the whole, a rank's block, a lo and a count that
# are not multiples of the kernel's chunk; and the whole of n = 8, steps 5
WITNESS_CASES = [(1 << 20, 0, 1 << 20), (1 << 20, 1 << 19, 1 << 19),
                 (1 << 20, (1 << 19) + 3, (1 << 18) + 5), (8, 0, 8)]


@pytest.mark.parametrize("n,lo,count", WITNESS_CASES)
@pytest.mark.parametrize("model", ["fibonacci", "counter"])
@pytest.mark.parametrize("sf", [Goldilocks, BabyBear], ids=["gl", "bb"])
def test_witness_kernel_matches_plain(dev, sf, model, n, lo, count):
    from ministark_tpu_torch.ops import witness
    from ministark_tpu_torch.utils.rng import ark_test_rng

    base = sf.base
    steps, pad = (n - 1 if n > 8 else 5), int(base.rand(ark_test_rng()))
    dtype = gl.field_dtype(base)
    width = 3 if model == "fibonacci" else 2
    got = torch.empty((width, count), dtype=dtype, device=dev)
    want = torch.empty_like(got)
    before = dict(witness.launches)
    if model == "fibonacci":
        witness.fib_witness(got, base, steps, 7, pad, lo)
        witness.fib_witness_plain(want, base, steps, 7, pad, lo)
    else:
        witness.counter_witness(got, base, steps, 11, 1_000_003, 9, 424_242, pad, lo)
        witness.counter_witness_plain(want, base, steps, 11, 1_000_003, 9, 424_242, pad, lo)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    moved = {k: witness.launches[k] - before[k] for k in before
             if witness.launches[k] != before[k]}
    assert moved == {f"{'fib' if model == 'fibonacci' else 'counter'}_witness_"
                     f"{'gl' if sf is Goldilocks else 'bb'}": 1}


def test_witness_wrappers_refuse_int64_babybear(dev):
    from ministark_tpu_torch.ops import witness

    before = dict(witness.launches)
    with pytest.raises(ValueError):
        witness.fib_witness(torch.zeros((3, 64), dtype=torch.int64, device=dev),
                            BABYBEAR_FP, 63, 2, 0)
    with pytest.raises(ValueError):
        witness.counter_witness_cuda(torch.zeros((2, 64), dtype=torch.int64, device=dev),
                                     BABYBEAR_FP, 63, 1, 3, 5, 7, 0)
    assert witness.launches == before
