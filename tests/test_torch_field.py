"""The port's Goldilocks and Fp2 tensor ops (ministark_tpu_torch/ops/field.py)
against the JAX package's limb kernels (ministark_tpu/ops/gl.py), its
Pallas multiply (ops/pallas_kernels.py, interpret mode) and the host field
oracle, and the operand addressing of csrc/gl_mul.cu's base and Fp2 product
kernels replayed on the CPU from the plans their wrappers build. Field
arithmetic is exact: every comparison is integer equality
(tolerance 0)."""

import numpy as np
import pytest
import torch

from ministark_tpu.fields import GOLDILOCKS_FP as J_FP
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_FP2
import jax.numpy as jnp

from ministark_tpu.ops import gl as jgl
from ministark_tpu.ops.pallas_kernels import _TILE, gl_mul_pallas
from ministark_tpu.ops.registry import get_kernels
from ministark_tpu.ops.registry import lift_base_array as j_lift
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import GOLDILOCKS_FP, GOLDILOCKS_FP2
from ministark_tpu_torch.ops import field as tgl

P = GOLDILOCKS_FP.p
EDGES = [0, 1, 2, P - 1, P - 2, P - (1 << 32), (1 << 32) - 1, 1 << 32,
         (1 << 63) - 1, 1 << 63, (1 << 63) + 12345, 0xFFFFFFFF00000000]


def _values(seed, n=600):
    """Canonical GL values: edge cases (several >= 2^63) plus random ones."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, P, size=n - len(EDGES), dtype=np.uint64)
    return np.concatenate([np.array(EDGES, dtype=np.uint64), rand])


def _pair(seed):
    a = _values(seed)
    b = np.random.default_rng(seed + 1).permutation(_values(seed + 2))
    return jgl.pack(a), jgl.pack(b)


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_base_binary_ops_match_jax(name):
    a, b = _pair(3)
    want = np.asarray(getattr(jgl, name)(a, b))
    got = getattr(tgl, name)(from_jax_packed(a, GOLDILOCKS_FP),
                             from_jax_packed(b, GOLDILOCKS_FP))
    assert np.array_equal(to_jax_packed(got, GOLDILOCKS_FP), want)


def test_base_neg_and_mul_nr_match_jax():
    a, _ = _pair(5)
    ta = from_jax_packed(a, GOLDILOCKS_FP)
    assert np.array_equal(to_jax_packed(tgl.neg(ta), GOLDILOCKS_FP),
                          np.asarray(jgl.neg(a)))
    assert np.array_equal(to_jax_packed(tgl._mul_nr(ta), GOLDILOCKS_FP),
                          np.asarray(jgl._mul_nr(a)))


@pytest.mark.parametrize("e", [0, 1, 2, 7, P - 2, (1 << 64) - 1])
def test_pow_matches_host(e):
    vals = _values(7, 64)
    got = tgl.pow(tgl.pack_u64(vals), e)
    assert [int(v) for v in tgl.unpack_u64(got)] == [
        GOLDILOCKS_FP.pow(int(v), e) for v in vals]


def _ext(seed):
    a = np.stack([_values(seed), _values(seed + 10)[::-1]], axis=-1)
    return jgl.pack(a)                                   # (n, 2, 2) u32


@pytest.mark.parametrize("name", ["ext_add", "ext_sub", "ext_mul"])
def test_ext_binary_ops_match_jax(name):
    a, b = _ext(11), _ext(13)
    want = np.asarray(getattr(jgl, name)(a, b))
    got = getattr(tgl, name)(from_jax_packed(a, GOLDILOCKS_FP2),
                             from_jax_packed(b, GOLDILOCKS_FP2))
    assert np.array_equal(to_jax_packed(got, GOLDILOCKS_FP2), want)


def test_ext_scale_base_and_pow_match():
    a = _ext(17)
    s = jgl.pack(_values(19))
    want = np.asarray(jgl.ext_scale_base(a, s))
    got = tgl.ext_scale_base(from_jax_packed(a, GOLDILOCKS_FP2),
                             from_jax_packed(s, GOLDILOCKS_FP))
    assert np.array_equal(to_jax_packed(got, GOLDILOCKS_FP2), want)
    ops = tgl.get_ops(GOLDILOCKS_FP2)
    elems = ops.unpack(from_jax_packed(a[:40], GOLDILOCKS_FP2))
    got = ops.unpack(ops.pow(ops.pack(elems), 12345))
    assert got == [GOLDILOCKS_FP2.pow(x, 12345) for x in elems]


def test_pack_unpack_and_scalars():
    for field, jfield in ((GOLDILOCKS_FP, J_FP), (GOLDILOCKS_FP2, J_FP2)):
        ops, jops = tgl.get_ops(field), get_kernels(jfield)
        if field is GOLDILOCKS_FP:
            vals = [int(v) for v in _values(23, 50)]
        else:
            vals = list(zip(map(int, _values(23, 50)), map(int, _values(29, 50))))
        t = ops.pack(vals)
        assert t.dtype == torch.int64
        assert ops.unpack(t) == vals
        assert np.array_equal(to_jax_packed(t, field), jops.pack(vals))
        for v in vals[:12]:
            assert np.array_equal(to_jax_packed(ops.pack_scalar(v), field),
                                  jops.pack_scalar(v))


def test_lift_base_array_matches_jax():
    a = jgl.pack(_values(31))
    want = np.asarray(j_lift(get_kernels(J_FP2), a))
    got = tgl.lift_base_array(tgl.get_ops(GOLDILOCKS_FP2),
                              from_jax_packed(a, GOLDILOCKS_FP))
    assert np.array_equal(to_jax_packed(got, GOLDILOCKS_FP2), want)


def test_convert_roundtrip_keeps_bit_patterns():
    a = _ext(37)
    t = from_jax_packed(a, GOLDILOCKS_FP2)
    assert t.shape == a.shape[:-1]
    assert np.array_equal(to_jax_packed(t, GOLDILOCKS_FP2), a)
    # values >= 2^63 are negative int64 patterns, not clipped or rounded
    hi = from_jax_packed(jgl.pack(np.array([P - 1], dtype=np.uint64)), GOLDILOCKS_FP)
    assert int(hi[0]) == P - 1 - (1 << 64)


def test_mul_plain_matches_pallas_gl_mul():
    """Row 6: ops/pallas_kernels.py::gl_mul_pallas in interpret mode at
    n = 2 x 1024, as tests/test_pallas_kernels.py runs it."""
    n = 2 * _TILE
    a, b = _values(41, n), np.random.default_rng(43).permutation(_values(45, n))
    want = np.asarray(gl_mul_pallas(jnp.asarray(jgl.pack(a)), jnp.asarray(jgl.pack(b))))
    got = tgl.mul_plain(tgl.pack_u64(a), tgl.pack_u64(b))
    assert np.array_equal(to_jax_packed(got, GOLDILOCKS_FP), want)
    assert torch.equal(tgl.mul(tgl.pack_u64(a), tgl.pack_u64(b)), got)


def _replay_offsets(plan):
    """Element offsets of both operands as csrc/gl_mul.cu computes them from
    the wrapper's plan for every output index: the row-major coordinates
    over the merged sizes, each division by an axis size done as the kernel
    does it (the multiply-high magic number on 32-bit indices, the plain
    divide on 64-bit ones), dotted with the operand's strides."""
    plan = list(plan)
    D = tgl.MUL_MAX_DIMS
    numel, ndim, _, wide = plan[:4]
    size, sa, sb, magic, shift = (plan[6 + j * D: 6 + j * D + ndim] for j in range(5))
    i = np.arange(numel, dtype=np.uint64)
    oa = np.zeros(numel, dtype=np.uint64)
    ob = np.zeros(numel, dtype=np.uint64)
    for k in range(ndim - 1, 0, -1):
        if wide:
            q = i // np.uint64(size[k])
        else:
            assert numel < 2**31
            q = (((i * np.uint64(magic[k])) >> np.uint64(32)) + i) >> np.uint64(shift[k])
            assert np.array_equal(q, i // np.uint64(size[k]))
        c = i - q * np.uint64(size[k])
        oa += c * np.uint64(sa[k])
        ob += c * np.uint64(sb[k])
        i = q
    oa += i * np.uint64(sa[0])
    ob += i * np.uint64(sb[0])
    return oa.astype(np.int64), ob.astype(np.int64)


def _storage(t):
    """Every element of t's storage, as a flat int64 tensor."""
    return torch.empty(0, dtype=torch.int64).set_(t.untyped_storage())


def _aligned(a, b):
    return not (a.data_ptr() | b.data_ptr()) & 15


_x = tgl.pack_u64(_values(47, 2 * 3 * 5 * 7)).reshape(2, 3, 5, 7)


@pytest.mark.parametrize("make", [
    lambda: (_x, _x),                                        # merges to one axis
    lambda: (_x[..., 0], _x[..., 1]),                        # strided views
    lambda: (_x, _x[0, 0, 0]),                               # 0-d operand
    lambda: (_x[:, :, :, 2:], _x[1, :, :1, :5]),             # broadcast, offsets
    lambda: (_x.transpose(1, 3), _x[0, 0, 0, :5].reshape(5, 1)),
    lambda: (_x[0, 0, 0, 0], _x[1, 1, 1, 1]),                # both 0-d
    lambda: (_x[:, None, :, 1], _x[0, 0, :3, :]),           # inserted axis
    lambda: (_x.reshape(-1)[1:], _x.reshape(-1)[:-1]),       # contiguous, offset
], ids=["contiguous", "fp2-components", "scalar", "broadcast", "transposed",
        "scalars", "unsqueezed", "contiguous-unaligned"])
def test_gl_mul_addressing_replays_broadcast(make):
    """What mul_cuda hands the kernel (the plan of ``_mul_plan``: merged
    sizes, element strides, magic numbers) addresses exactly the broadcast
    operands: replaying the kernel's index arithmetic on the CPU storage
    gives mul_plain's result. The 16-byte path is taken only by contiguous
    operands over the whole output."""
    a, b = make()
    shape, plan = tgl._mul_plan(a.shape, a.stride(), b.shape, b.stride(),
                                _aligned(a, b))
    assert shape == torch.broadcast_shapes(a.shape, b.shape)
    assert 1 <= plan[1] <= tgl.MUL_MAX_DIMS
    oa, ob = _replay_offsets(plan)
    if plan[2]:                                              # 16-byte path
        assert plan[1] == 1 and a.is_contiguous() and b.is_contiguous()
        assert np.array_equal(oa, np.arange(plan[0])) and np.array_equal(oa, ob)
    ga = _storage(a)[a.storage_offset() + oa]
    gb = _storage(b)[b.storage_offset() + ob]
    assert torch.equal(tgl.mul_plain(ga, gb).reshape(shape), tgl.mul_plain(a, b))


def test_gl_mul_plan_is_cached_and_wide_past_2_31():
    """The plan of a shape is built once; a call past 2^31 elements or
    offsets takes the 64-bit path (no magic numbers, no 16-byte path)."""
    key = ((8, 3), (3, 1), (3,), (1,), True)
    assert tgl._mul_plan(*key) is tgl._mul_plan(*key)
    _, plan = tgl._mul_plan((1 << 31,), (1,), (1 << 31,), (1,), True)
    assert list(plan[:4]) == [1 << 31, 1, 0, 1]
    _, plan = tgl._mul_plan((4, 2), (1 << 30, 1), (2,), (1,), True)
    assert plan[3] == 1                                      # reach 3 * 2^30
    _, plan = tgl._mul_plan((4, 2), (2, 1), (2,), (1,), True)
    assert plan[3] == 0


_e = tgl.pack_u64(np.stack([_values(53, 4 * 6 * 8), _values(59, 4 * 6 * 8)],
                           -1)).reshape(4, 6, 8, 2)
_q = _e.reshape(24, 8, 2)                                    # (Q, n0, 2)


@pytest.mark.parametrize("make", [
    lambda: (_q, _q.flip(0)),                                # query rounds
    lambda: (_e[:, 0, 0], _e[:, 1, 0]),                      # (Q, 2) x (Q, 2)
    lambda: (_q, _q[:, :1]),                                 # powers' broadcast
    lambda: (_q[:, 0::2], _q[:, 1::2]),                      # even / odd slices
    lambda: (_q, _e[0, 0, 3].expand_as(_q)),                 # expand_as, stride 0
    lambda: (_e[1, 2], _e[0, 0, :1].expand(8, 2)),          # expand_as of a row
    lambda: (_q, _e[2, 3, 4]),                               # a (2,) scalar
    lambda: (_e[2, 3, 4], _e[1, 1, 1]),                      # (2,) x (2,)
    lambda: (_e.movedim(-1, 0).contiguous().movedim(0, -1), _q.reshape(4, 6, 8, 2)),
    lambda: (_e[..., 1:2].expand(4, 6, 8, 2), _e),           # component stride 0
    lambda: (_e.reshape(-1)[2:-2].reshape(-1, 2), _e.reshape(-1, 2)[1:-1]),
    lambda: (_e.reshape(-1)[1:-3].reshape(-1, 2), _e.reshape(-1, 2)[1:-1]),
], ids=["query-round", "query-scalars", "powers", "even-odd", "expand-as",
        "expand-row", "scalar", "scalars", "component-stride", "component-bcast",
        "offset-even", "offset-odd"])
def test_gl_ext_mul_addressing_replays_broadcast(make):
    """What ext_mul_cuda hands csrc/gl_mul.cu's Fp2 kernel (the plan of
    ``_ext_plan`` over the leading axes, with the component strides)
    addresses exactly the broadcast operands: replaying the kernel's index
    arithmetic on the CPU storage gives ext_mul_plain's result. The 16-byte
    loads are taken only when both operands' components are adjacent and
    every element lies on a 16-byte boundary."""
    a, b = make()
    shape, plan = tgl._ext_plan(a.shape, a.stride(), b.shape, b.stride(),
                                _aligned(a, b))
    want = tgl.ext_mul_plain(a, b)
    assert shape == want.shape
    ca, cb = plan[4], plan[5]
    assert (ca, cb) == (a.stride(-1), b.stride(-1))
    oa, ob = _replay_offsets(plan)
    oa, ob = a.storage_offset() + oa, b.storage_offset() + ob
    if plan[2]:                                              # 16-byte loads
        assert ca == cb == 1 and _aligned(a, b)
        assert (oa % 2 == 0).all() and (ob % 2 == 0).all()
    sa, sb = _storage(a), _storage(b)
    ga = torch.stack([sa[oa], sa[oa + ca]], -1)
    gb = torch.stack([sb[ob], sb[ob + cb]], -1)
    assert torch.equal(tgl.ext_mul_plain(ga, gb).reshape(shape), want)


def test_ext_mul_plain_matches_jax_on_seeded_inputs():
    """ext_mul_plain against ministark_tpu/ops/gl.py::ext_mul (exact), on
    seeded random values and the edge values, broadcast over a batch."""
    a, b = _ext(61), _ext(67)
    want = np.asarray(jgl.ext_mul(a, b))
    got = tgl.ext_mul_plain(from_jax_packed(a, GOLDILOCKS_FP2),
                            from_jax_packed(b, GOLDILOCKS_FP2))
    assert np.array_equal(to_jax_packed(got, GOLDILOCKS_FP2), want)
    ta, tb = from_jax_packed(a, GOLDILOCKS_FP2), from_jax_packed(b, GOLDILOCKS_FP2)
    assert torch.equal(tgl.ext_mul(ta, tb), got)
    want_b = np.asarray(jgl.ext_mul(a, np.broadcast_to(b[:1], b.shape)))
    got_b = tgl.ext_mul_plain(ta, tb[0])
    assert np.array_equal(to_jax_packed(got_b, GOLDILOCKS_FP2), want_b)


def test_ext_mul_cuda_refuses_cpu_tensors():
    x = _e[0]
    with pytest.raises(ValueError, match="gl_ext_mul: expected a CUDA tensor"):
        tgl.ext_mul_cuda(x, x)
    with pytest.raises(ValueError, match="gl_mul: expected a CUDA tensor"):
        tgl.mul_cuda(x[..., 0], x[..., 1])


def test_collapse_merges_and_drops_axes():
    assert tgl._collapse((2, 3, 4), (12, 4, 1), (0, 0, 0)) == ([24], [[1], [0]])
    assert tgl._collapse((2, 1, 4), (8, 9, 2), (4, 9, 1)) == ([8], [[2], [1]])
    assert tgl._collapse((2, 4), (8, 1), (1, 2)) == ([2, 4], [[8, 1], [1, 2]])
    assert tgl._collapse((), ) == ([], [])
