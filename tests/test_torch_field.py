"""The port's Goldilocks and Fp2 tensor ops (ministark_tpu_torch/ops/field.py)
against the JAX package's limb kernels (ministark_tpu/ops/gl.py) and the
host field oracle. Field arithmetic is exact: every comparison is integer
equality (tolerance 0)."""

import numpy as np
import pytest
import torch

from ministark_tpu.fields import GOLDILOCKS_FP as J_FP
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_FP2
from ministark_tpu.ops import gl as jgl
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
