"""The port's BabyBear and Fp4 tensor ops (ministark_tpu_torch/ops/bb.py and
the BabyBear half of ops/field.py) against the JAX package's u32 kernels
(ministark_tpu/ops/bb.py, its registry) and the host field oracle, and the
BabyBear layouts of convert.py. Field arithmetic is exact: every comparison
is integer equality (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.fields import BABYBEAR_FP as J_BB
from ministark_tpu.fields import BABYBEAR_FP4 as J_BB4
from ministark_tpu.ops import bb as jbb
from ministark_tpu.ops.registry import get_kernels
from ministark_tpu.ops.registry import lift_base_array as j_lift
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import BABYBEAR_FP, BABYBEAR_FP2, BABYBEAR_FP4
from ministark_tpu_torch.ops import bb
from ministark_tpu_torch.ops.field import get_ops, lift_base_array

P = BABYBEAR_FP.p
EDGES = [0, 1, 2, P - 1, P - 2, 10, 11, (P - 1) // 2, 1 << 30, 999999999]


def _values(seed, n=600):
    """Canonical BabyBear values: 0, 1, p - 1 and other edges, then random."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, P, size=n - len(EDGES), dtype=np.uint32)
    return np.concatenate([np.array(EDGES, dtype=np.uint32), rand])


def _fp4(seed, n=600):
    return np.stack([_values(seed + i, n)[::1 - 2 * (i % 2)] for i in range(4)], -1)


def _t(a, field=BABYBEAR_FP):
    return from_jax_packed(a, field)


def _j(t, field=BABYBEAR_FP):
    return to_jax_packed(t, field)


def test_constants_match_jax():
    assert bb.P == jbb.P == P
    assert bb.NR_FP2 == int(jbb.NR_FP2) == BABYBEAR_FP2.nonresidue
    assert (bb.NR_FP4_C0, 1) == (int(jbb.NR_FP4_C0), 1) == BABYBEAR_FP4.nonresidue


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_base_binary_ops_match_jax(name):
    a = _values(3)
    b = np.random.default_rng(4).permutation(_values(5))
    want = np.asarray(getattr(jbb, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(bb, name)(_t(a), _t(b))
    assert got.dtype == torch.int32
    assert np.array_equal(_j(got), want)


def test_base_ops_cover_every_edge_pair():
    e = np.array(EDGES, dtype=np.uint32)
    a, b = np.repeat(e, len(e)), np.tile(e, len(e))
    for name in ("add", "sub", "mul"):
        want = np.asarray(getattr(jbb, name)(jnp.asarray(a), jnp.asarray(b)))
        assert np.array_equal(_j(getattr(bb, name)(_t(a), _t(b))), want), name
    assert np.array_equal(_j(bb.neg(_t(a))), np.asarray(jbb.neg(jnp.asarray(a))))


@pytest.mark.parametrize("e", [0, 1, 2, 7, 11, P - 2, P - 1, (1 << 64) - 1])
def test_pow_matches_host_and_jax(e):
    vals = _values(7, 64)
    got = [int(v) for v in bb.pow(_t(vals), e)]
    assert got == [BABYBEAR_FP.pow(int(v), e) for v in vals]
    if e:
        assert np.array_equal(np.asarray(got, dtype=np.uint32),
                              np.asarray(jbb.pow_scalar(jnp.asarray(vals), e)))


def test_fp2_mul_and_nonresidue_match_jax():
    a, b = _fp4(11)[:, :2], _fp4(13)[:, 2:]
    assert np.array_equal(_j(bb.fp2_mul(_t(a), _t(b))),
                          np.asarray(jbb.fp2_mul(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(_j(bb._fp2_mul_nr4(_t(a))),
                          np.asarray(jbb._fp2_mul_nr4(jnp.asarray(a))))


@pytest.mark.parametrize("name", ["fp4_add", "fp4_sub", "fp4_mul"])
def test_fp4_binary_ops_match_jax(name):
    a, b = _fp4(17), _fp4(19)[::-1]
    want = np.asarray(getattr(jbb, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(bb, name)(_t(a, BABYBEAR_FP4), _t(b, BABYBEAR_FP4))
    assert np.array_equal(_j(got, BABYBEAR_FP4), want)


def test_fp4_mul_matches_host_oracle_and_broadcasts():
    ops = get_ops(BABYBEAR_FP4)
    a = ops.unpack(_t(_fp4(23, 40), BABYBEAR_FP4))
    b = ops.unpack(_t(_fp4(29, 40), BABYBEAR_FP4))
    assert ops.unpack(ops.mul(ops.pack(a), ops.pack(b))) == [
        BABYBEAR_FP4.mul(x, y) for x, y in zip(a, b)]
    # one Fp4 scalar against a column, as the engines multiply
    s = ops.pack_scalar(b[0])
    assert ops.unpack(ops.mul(ops.pack(a), s)) == [BABYBEAR_FP4.mul(x, b[0]) for x in a]
    assert ops.unpack(ops.neg(ops.pack(a))) == [BABYBEAR_FP4.neg(x) for x in a]


def test_fp4_scale_base_and_pow_match():
    a, s = _fp4(31), _values(37)
    want = np.asarray(jbb.fp4_scale_base(jnp.asarray(a), jnp.asarray(s)))
    got = bb.fp4_scale_base(_t(a, BABYBEAR_FP4), _t(s))
    assert np.array_equal(_j(got, BABYBEAR_FP4), want)
    ops = get_ops(BABYBEAR_FP4)
    elems = ops.unpack(_t(a[:30], BABYBEAR_FP4))
    for e in (0, 1, 5, 12345):
        got = ops.unpack(ops.pow(ops.pack(elems), e))
        assert got == [BABYBEAR_FP4.pow(x, e) for x in elems]


def test_pack_unpack_and_scalars_match_jax():
    for field, jfield in ((BABYBEAR_FP, J_BB), (BABYBEAR_FP4, J_BB4)):
        ops, jops = get_ops(field), get_kernels(jfield)
        assert ops.elem_axes == jops.elem_axes
        assert ops.base_field is BABYBEAR_FP
        if field is BABYBEAR_FP:
            vals = [int(v) for v in _values(41, 50)]
        else:
            vals = ops.unpack(_t(_fp4(43, 50), field))
            assert vals[0][0][0] == 0 and vals[1][1][0] == 1
        t = ops.pack(vals)
        assert t.dtype == torch.int32
        assert ops.unpack(t) == vals
        assert np.array_equal(_j(t, field), jops.pack(vals))
        for v in vals[:12]:
            assert np.array_equal(_j(ops.pack_scalar(v), field), jops.pack_scalar(v))


def test_lift_base_array_matches_jax():
    a = _values(47)
    want = np.asarray(j_lift(get_kernels(J_BB4), jnp.asarray(a)))
    got = lift_base_array(get_ops(BABYBEAR_FP4), _t(a))
    assert got.shape == (a.shape[0], 4)
    assert np.array_equal(_j(got, BABYBEAR_FP4), want)


def test_get_ops_refuses_babybear_fp2():
    """The tower's middle field has no tensor ops (the JAX registry has
    none either): only the base field and Fp4 are used."""
    with pytest.raises(ValueError):
        get_ops(BABYBEAR_FP2)


def test_convert_roundtrip_babybear_layouts():
    base, ext = _values(53), _fp4(59)
    tb, te = _t(base), _t(ext, BABYBEAR_FP4)
    assert tb.shape == base.shape and te.shape == ext.shape
    assert tb.dtype == te.dtype == torch.int32
    assert np.array_equal(_j(tb), base) and np.array_equal(_j(te, BABYBEAR_FP4), ext)
    assert _j(tb).dtype == np.uint32
    with pytest.raises(ValueError):
        from_jax_packed(ext[:, :2], BABYBEAR_FP2)
