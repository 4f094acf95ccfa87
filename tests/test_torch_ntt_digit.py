"""The digit-matmul NTT level of the port (ops/ntt_digit.py) and the stream
probe (ops/stream.py) on the CPU against ministark_tpu/ops/ntt_mxu.py: the
host tables, each stage's plain version, the fused level against the
Pallas kernel in interpret mode, and the wgmma kernels' table, routes and
lane maps (tests/torch_digit_checks.py). Same inputs, made from a seed with
numpy; tolerance 0 (field arithmetic is exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_digit_checks as digit_checks  # tests/, the wgmma kernels' checks

from ministark_tpu.fields import GOLDILOCKS_FP as J_FP
from ministark_tpu.ops import gl as jgl
from ministark_tpu.ops import ntt_mxu as M
from ministark_tpu_torch.convert import digits_from_jax, i64_to_planes, planes_to_i64
from ministark_tpu_torch.fields import GOLDILOCKS_FP
from ministark_tpu_torch.ops import ntt_digit as nd
from ministark_tpu_torch.ops import ntt_pipe as pp
from ministark_tpu_torch.ops import stream

torch.set_num_threads(1)
P = GOLDILOCKS_FP.p
EDGES = [0, 1, nd.GL_CENTER_T, nd.GL_CENTER_T + 1, P - 1, nd.GL_CENTER_T - 1, 1 << 63]


def _values(shape, seed):
    v = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    v.reshape(-1)[:len(EDGES)] = EDGES[:v.size]
    return torch.from_numpy(v.view(np.int64))


def _jplanes(t):
    return tuple(jnp.asarray(pl) for pl in i64_to_planes(t))


def _kc_np():
    kp = jgl.pack([M._recombine_const(P)])[0]
    return np.uint32(kp[0]), np.uint32(kp[1])


def _jax_vd(root, F):
    """The level's matrix as ``_build_tables`` hands it to the fused kernel:
    (NA, F, NB PF), padded to a 128 stride for F < 64."""
    vd = M._dft_digit_matrix(P, root, F)
    if F < 64:
        pad = np.zeros((8 * F, 8, 128), dtype=np.int8)
        pad[:, :, :F] = vd.reshape(8 * F, 8, F)
        vd = pad.reshape(8 * F, 8 * 128)
    return jnp.asarray(vd.reshape(8, F, -1))


@pytest.mark.parametrize("F", [32, 64, 128])
def test_digit_matrix_equals_jax(F):
    root = GOLDILOCKS_FP.get_root_of_unity(F)
    assert int(J_FP.get_root_of_unity(F)) == root
    want = M._dft_digit_matrix(P, root, F)
    assert np.array_equal(nd._dft_digit_matrix(P, root, F), want)
    got = nd.digit_matrix(root, F, "cpu")
    assert np.array_equal(got.numpy().reshape(8, F, -1), np.asarray(_jax_vd(root, F)))
    assert nd.plane_stride(F) == (128 if F < 64 else F)


def test_constants_equal_jax():
    assert nd._recombine_const(P) == M._recombine_const(P)
    assert nd._params(P) == M._params(P)
    assert nd.GL_CENTER_T == M._GL_CENTER_T and nd.OFF == int(M.OFF)
    with pytest.raises(ValueError):
        nd._params(2013265921)


@pytest.mark.parametrize("shape", [(2, 32, 40), (1, 128, 7), (1, 1, 7)])
def test_digitize_matches_jax(shape):
    x = _values(shape, shape[1])
    want = digits_from_jax(M._digitize(_jplanes(x), 8))
    got = nd.digitize_plain(x)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert torch.equal(nd.digitize(x), got)
    # the digits are the centred value: sum_a d_a 256^a == v or v - p
    v = x.numpy().view(np.uint64).astype(object).reshape(-1)
    d = got.reshape(shape[0], 8, shape[1], shape[2]).permute(0, 2, 3, 1).reshape(-1, 8)
    back = [sum(int(d[i, a]) << (8 * a) for a in range(8)) for i in range(len(v))]
    assert back == [int(u) if u <= nd.GL_CENTER_T else int(u) - P for u in v]


@pytest.mark.parametrize("B,K,R,N", [(2, 256, 33, 1024), (1, 64, 1, 128)])
def test_digit_dot_matches_numpy(B, K, R, N):
    rng = np.random.default_rng(K + R)
    d = rng.integers(-128, 128, size=(B, K, R), dtype=np.int64).astype(np.int8)
    vd = rng.integers(-128, 128, size=(K, N), dtype=np.int64).astype(np.int8)
    d[0, :, 0], vd[:, 0] = -128, -128
    want = np.einsum("bkr,kn->brn", d.astype(np.int64), vd.astype(np.int64))
    got = nd.digit_dot_plain(torch.from_numpy(d), torch.from_numpy(vd))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), want)
    assert torch.equal(nd.digit_dot(torch.from_numpy(d), torch.from_numpy(vd)), got)


@pytest.mark.parametrize("F,PF,twiddle", [(32, 128, False), (32, 128, True),
                                          (64, 64, True), (128, 128, False)])
def test_recombine_matches_jax(F, PF, twiddle):
    rng = np.random.default_rng(F + PF)
    R = 24
    Rm = rng.integers(-(1 << 27) + 1, 1 << 27, size=(2, R, 8 * PF), dtype=np.int64)
    Rm[0, 0], Rm[1, 0] = (1 << 27) - 1, -(1 << 27) + 1
    Rm = Rm.astype(np.int32)
    want = M._recombine_gl(jnp.asarray(Rm), 8, F, _kc_np(), PF)
    W = _values((R, F), 3) if twiddle else None
    if twiddle:
        want = M._mul_planes(want, _jplanes(W))
    got = nd.recombine_plain(torch.from_numpy(Rm), F, W)
    assert torch.equal(got, planes_to_i64(want))
    assert torch.equal(nd.recombine(torch.from_numpy(Rm), F, W), got)


@pytest.mark.parametrize("F", [32, 64, 128])
@pytest.mark.parametrize("twiddle", [False, True])
def test_level_matches_jax_fused_kernel(F, twiddle):
    """``level_plain`` against ``_fused_level`` (the Pallas kernel in
    interpret mode) with the tables ``_build_tables`` would hand it: the
    padded matrix at F = 32, a trailing scalar with the twiddle."""
    B, R = 2, 24
    root = GOLDILOCKS_FP.get_root_of_unity(F)
    x = _values((B, F, R), F)
    W = _values((R, F), 5) if twiddle else None
    scale = 0x123456789ABCDEF % P if twiddle else None
    scalar_np = None if scale is None else tuple(np.uint32(w) for w in
                                                 jgl.pack([scale])[0])
    want = M._fused_level(_jplanes(x), _jax_vd(root, F), 8, 8, _kc_np(),
                          None if W is None else _jplanes(W), scalar_np,
                          interpret=True)
    vd = nd.digit_matrix(root, F, "cpu")
    got = nd.level_plain(x, vd, W, 1, scale)
    assert got.shape == (B, R, F)
    assert torch.equal(got, planes_to_i64(want))
    assert torch.equal(nd.level(x, vd, W, 1, scale), got)


@pytest.mark.parametrize("inverse", [False, True])
def test_levels_match_butterfly_levels(inverse):
    """Every level of the 2^14 walk (twiddle rows by r // K_prod, 1/n on the
    last inverse level) equals the port's butterfly level on the same input."""
    n, B = 1 << 14, 2
    levels = nd.level_tables(n, inverse, "cpu")
    butterflies = pp._tables(n, inverse, torch.device("cpu"))
    assert [f for f, _, _, _ in levels] == [128, 128]
    y = _values((B, n), 14)
    scale = GOLDILOCKS_FP.inv(n) if inverse else None
    for i, ((Fi, vd, W, k_prod), (_, tw, _, _)) in enumerate(zip(levels, butterflies)):
        last = i == len(levels) - 1
        xi = y.reshape(B, Fi, n // Fi)
        got = nd.level_plain(xi, vd, W, k_prod, scale if last else None)
        assert torch.equal(got, pp.level_plain(xi, tw, None, W, k_prod,
                                               scale if last else None))
        y = got.reshape(B, n)


def test_unpadded_and_padded_f32_levels_agree():
    root = GOLDILOCKS_FP.get_root_of_unity(32)
    x = _values((1, 32, 9), 2)
    a = nd.level_plain(x, nd.digit_matrix(root, 32, "cpu", 32))
    assert torch.equal(a, nd.level_plain(x, nd.digit_matrix(root, 32, "cpu", 128)))


@pytest.mark.parametrize("F", [32, 64, 128])
def test_kernel_table_equals_jax_digit_matrix(F):
    digit_checks.kernel_table_matches_jax(F)


@pytest.mark.parametrize("F,R,twiddle", digit_checks.LEVEL_CASES)
def test_level_replay_matches_plain_and_jax(F, R, twiddle):
    digit_checks.level_replay_matches(F, R, twiddle)


@pytest.mark.parametrize("B,K,R,N", digit_checks.DOT_CASES)
def test_digit_dot_replay_matches_plain(B, K, R, N):
    digit_checks.digit_dot_replay_matches(B, K, R, N)


@pytest.mark.parametrize("F", [32, 64, 128, 256, 512])
def test_digit_lane_maps_meet_no_bank_conflict(F):
    digit_checks.lane_maps_meet_no_bank_conflict(F)


def test_stream_add1_wraps():
    v = np.array([0xFFFFFFFF, 0x7FFFFFFF, 0, 5, 0x80000000], dtype=np.uint32)
    x = torch.from_numpy(v.view(np.int32))
    got = stream.stream_add1(x)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), v + np.uint32(1))
    assert got[0].item() == 0 and got[1].item() == -(1 << 31)
    assert torch.equal(got, torch.add(x, 1))


def test_kernel_wrappers_refuse_cpu_tensors():
    x = _values((1, 32, 8), 0)
    vd = nd.digit_matrix(GOLDILOCKS_FP.get_root_of_unity(32), 32, "cpu")
    for call in (lambda: nd.digitize_cuda(x),
                 lambda: nd.digit_dot_cuda(nd.digitize_plain(x), vd),
                 lambda: nd.recombine_cuda(torch.zeros((1, 8, 1024), dtype=torch.int32), 32),
                 lambda: nd.level_cuda(x, vd),
                 lambda: stream.stream_add1_cuda(torch.zeros(8, dtype=torch.int32))):
        with pytest.raises(ValueError):
            call()
    assert all(v == 0 for v in nd.launches.values()) and stream.launches == 0
