"""The port's Goldilocks and Fp2 tensor ops (ministark_tpu_torch/ops/field.py)
against the JAX package's limb kernels (ministark_tpu/ops/gl.py), its
Pallas multiply (ops/pallas_kernels.py, interpret mode) and the host field
oracle, and the gl_mul kernel's operand addressing replayed on the CPU.
Field arithmetic is exact: every comparison is integer equality
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


def _kernel_offsets(sizes, strides, numel):
    """Element offsets of one operand as csrc/gl_mul.cu computes them for
    output index i: the row-major coordinates over ``sizes`` dotted with
    ``strides``."""
    idx = np.arange(numel, dtype=np.int64)
    off = np.zeros(numel, dtype=np.int64)
    for size, stride in zip(reversed(sizes), reversed(strides)):
        off += (idx % size) * stride
        idx //= size
    return off


def _storage(t):
    """Every element of t's storage, as a flat int64 tensor."""
    return torch.empty(0, dtype=torch.int64).set_(t.untyped_storage())


_x = tgl.pack_u64(_values(47, 2 * 3 * 5 * 7)).reshape(2, 3, 5, 7)


@pytest.mark.parametrize("make", [
    lambda: (_x, _x),                                        # merges to one axis
    lambda: (_x[..., 0], _x[..., 1]),                        # strided views
    lambda: (_x, _x[0, 0, 0]),                               # 0-d operand
    lambda: (_x[:, :, :, 2:], _x[1, :, :1, :5]),             # broadcast, offsets
    lambda: (_x.transpose(1, 3), _x[0, 0, 0, :5].reshape(5, 1)),
    lambda: (_x[0, 0, 0, 0], _x[1, 1, 1, 1]),                # both 0-d
    lambda: (_x[:, None, :, 1], _x[0, 0, :3, :]),           # inserted axis
], ids=["contiguous", "fp2-components", "scalar", "broadcast", "transposed",
        "scalars", "unsqueezed"])
def test_gl_mul_addressing_replays_broadcast(make):
    """What mul_cuda hands the kernel (merged sizes and element strides from
    ``_collapse``) addresses exactly the broadcast operands: replaying the
    kernel's index arithmetic on the CPU storage gives mul_plain's result."""
    a, b = make()
    shape = torch.broadcast_shapes(a.shape, b.shape)
    sizes, (sa, sb) = tgl._collapse(shape, a.expand(shape).stride(),
                                    b.expand(shape).stride())
    assert len(sizes) <= tgl.MUL_MAX_DIMS
    if not sizes:
        sizes, sa, sb = [1], [0], [0]
    numel = int(np.prod(shape))
    ga = _storage(a)[a.storage_offset() + _kernel_offsets(sizes, sa, numel)]
    gb = _storage(b)[b.storage_offset() + _kernel_offsets(sizes, sb, numel)]
    assert torch.equal(tgl.mul_plain(ga, gb).reshape(shape), tgl.mul_plain(a, b))


def test_collapse_merges_and_drops_axes():
    assert tgl._collapse((2, 3, 4), (12, 4, 1), (0, 0, 0)) == ([24], [[1], [0]])
    assert tgl._collapse((2, 1, 4), (8, 9, 2), (4, 9, 1)) == ([8], [[2], [1]])
    assert tgl._collapse((2, 4), (8, 1), (1, 2)) == ([2, 4], [[8, 1], [1, 2]])
    assert tgl._collapse((), ) == ([], [])
