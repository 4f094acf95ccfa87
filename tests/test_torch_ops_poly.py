"""The port's polynomial primitives of ops/poly.py that complete its twin of
``ministark_tpu/ops/poly_device.py`` (eval_poly,
eval_poly_base_coeffs_ext_point, synth_div, prefix_products, batch_inverse,
batch_inverse_full): the cases of tests/test_ops_poly.py, each held against
the host oracle and, but for synth_div over the fields other than
Goldilocks Fp2 (the JAX scan compiles for seconds a field), against the
JAX function on the same inputs (numpy seed 11), on the CPU, tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.fields import BABYBEAR_FP as J_BB
from ministark_tpu.fields import BABYBEAR_FP4 as J_BB4
from ministark_tpu.fields import GOLDILOCKS_FP as J_GL
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_GL2
from ministark_tpu.ops import poly_device as jp
from ministark_tpu.ops.registry import get_kernels
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import (
    BABYBEAR_FP,
    BABYBEAR_FP4,
    GOLDILOCKS_FP,
    GOLDILOCKS_FP2,
)
from ministark_tpu_torch.fri.fri import FriRound
from ministark_tpu_torch.ops import poly
from ministark_tpu_torch.ops.field import get_ops
from ministark_tpu_torch.poly import DensePolynomial

FIELDS = {"gl": (GOLDILOCKS_FP, J_GL), "gl2": (GOLDILOCKS_FP2, J_GL2),
          "bb": (BABYBEAR_FP, J_BB), "bb4": (BABYBEAR_FP4, J_BB4)}
EXT_PAIRS = {"gl": ("gl", "gl2"), "bb": ("bb", "bb4")}
# the JAX functions jitted (the field's kernels static): one compile a
# shape instead of an eager dispatch per operation
J_EVAL = jax.jit(jp.eval_poly, static_argnums=0)
J_EVAL_BASE = jax.jit(jp.eval_poly_base_coeffs_ext_point, static_argnums=0)
J_SYNTH_DIV = jax.jit(jp.synth_div, static_argnums=0)
J_PREFIX = jax.jit(jp.prefix_products, static_argnums=0)
J_BATCH_INV = jax.jit(jp.batch_inverse, static_argnums=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(name):
    return np.random.default_rng([11, list(FIELDS).index(name)])


def _rand_scalars(F, n, rng, nonzero=False):
    out = []
    while len(out) < n:
        c = [int(x) % F.p for x in rng.integers(0, 2**63, size=F.extension_degree,
                                                dtype=np.uint64)]
        v = c[0] if F.extension_degree == 1 else F.from_base_coeffs(tuple(c))
        if not (nonzero and F.is_zero(v)):
            out.append(v)
    return out


def _jax(F, JF, t):
    """A port tensor -> the JAX package's packed array of the same values."""
    return jnp.asarray(to_jax_packed(t, F))


def _port(F, a, shape):
    """A JAX packed array -> a port tensor of ``shape``."""
    return from_jax_packed(np.asarray(a), F).reshape(shape)


def _pad(vals, n, F):
    return list(vals) + [F.zero()] * (n - len(vals))


@pytest.mark.parametrize("name", list(FIELDS))
def test_eval_poly(name):
    F, JF = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng(name)
    coeffs, x = _rand_scalars(F, 33, rng), _rand_scalars(F, 1, rng)[0]
    c, xp = k.pack(coeffs), k.pack_scalar(x)
    got = poly.eval_poly(k, c, xp)
    assert k.unpack(got[None])[0] == DensePolynomial(F, coeffs).evaluate(x)
    want = J_EVAL(jk, _jax(F, JF, c), _jax(F, JF, xp))
    assert torch.equal(got, _port(F, want, got.shape))


@pytest.mark.parametrize("pair", list(EXT_PAIRS))
def test_eval_base_coeffs_at_ext_point(pair):
    (base, jbase), (ext, jext) = (FIELDS[n] for n in EXT_PAIRS[pair])
    kb, ke = get_ops(base), get_ops(ext)
    rng = _rng(EXT_PAIRS[pair][1])
    coeffs, x = _rand_scalars(base, 17, rng), _rand_scalars(ext, 1, rng)[0]
    host = DensePolynomial(ext, [ext.from_base_prime_field(c) for c in coeffs]).evaluate(x)
    c, xp = kb.pack(coeffs), ke.pack_scalar(x)
    got = poly.eval_poly_base_coeffs_ext_point(ke, c, xp)
    assert ke.unpack(got[None])[0] == host
    want = J_EVAL_BASE(get_kernels(jext), _jax(base, jbase, c),
                                              _jax(ext, jext, xp))
    assert torch.equal(got, _port(ext, want, got.shape))


@pytest.mark.parametrize("name", list(FIELDS))
def test_synth_div(name):
    F, JF = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng(name)
    q_coeffs, z = _rand_scalars(F, 20, rng), _rand_scalars(F, 1, rng)[0]
    q = DensePolynomial(F, q_coeffs)
    fc = _pad((q * DensePolynomial(F, [F.neg(z), F.one()])).to_vec(), 21, F)
    c, zp = k.pack(fc), k.pack_scalar(z)
    got = poly.synth_div(k, c, zp)
    assert k.unpack(got) == _pad(q.to_vec(), 20, F)
    if name == "gl2":       # the JAX scan's compile is seconds a field
        want = J_SYNTH_DIV(jk, _jax(F, JF, c), _jax(F, JF, zp))
        assert torch.equal(got, _port(F, want, got.shape))


@pytest.mark.parametrize("n", [1, 2, 3, 21])
def test_synth_div_short_and_at_zero(n):
    """Lengths 1-3 and test_synth_div's 21 (a non-power of two), at z = 0
    (the closed form of synth_div_suffix cannot take it) and at a random
    z, against JAX."""
    F, JF = GOLDILOCKS_FP2, J_GL2
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng("gl2")
    c = k.pack(_rand_scalars(F, n, rng))
    for z in (F.zero(), _rand_scalars(F, 1, rng)[0]):
        zp = k.pack_scalar(z)
        got = poly.synth_div(k, c, zp)
        assert got.shape == (n - 1, 2)
        assert torch.equal(got, _port(F, J_SYNTH_DIV(jk, _jax(F, JF, c), _jax(F, JF, zp)),
                                     got.shape))


@pytest.mark.parametrize("name", ["gl2", "bb4"])
def test_double_synth_div_quadratic(name):
    """(f - g) / ((x - x1)(x - x2)) == chained synthetic divisions."""
    F, _ = FIELDS[name]
    k = get_ops(F)
    rng = _rng(name)
    q_coeffs = _rand_scalars(F, 12, rng)
    x1, x2 = _rand_scalars(F, 2, rng)
    q = DensePolynomial(F, q_coeffs)
    van = DensePolynomial(F, [F.neg(x1), F.one()]) * DensePolynomial(F, [F.neg(x2), F.one()])
    fc = _pad((q * van).to_vec(), 14, F)
    d1 = poly.synth_div(k, k.pack(fc), k.pack_scalar(x1))
    d2 = poly.synth_div(k, d1, k.pack_scalar(x2))
    assert k.unpack(d2) == _pad(q.to_vec(), 12, F)


@pytest.mark.parametrize("name", ["gl2", "bb4"])
def test_synth_div_suffix_matches_scan_version(name):
    F, _ = FIELDS[name]
    k = get_ops(F)
    rng = _rng(name)
    arr = k.pack(_rand_scalars(F, 24, rng))
    z = _rand_scalars(F, 1, rng, nonzero=True)[0]
    zp, zinv = k.pack_scalar(z), k.pack_scalar(F.inv(z))
    assert torch.equal(poly.synth_div_suffix(k, arr, zp, zinv), poly.synth_div(k, arr, zp))


@pytest.mark.parametrize("name", list(FIELDS))
def test_batch_inverse(name):
    F, JF = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    vals = _rand_scalars(F, 17, _rng(name), nonzero=True)
    arr = k.pack(vals)
    pre = poly.prefix_products(k, arr)
    acc = F.one()
    for i, v in enumerate(vals):
        acc = F.mul(acc, v)
        assert k.unpack(pre[i:i + 1])[0] == acc
    assert torch.equal(pre, _port(F, J_PREFIX(jk, _jax(F, JF, arr)), pre.shape))
    inv = poly.batch_inverse_full(F, k, arr)
    assert k.unpack(inv) == [F.inv(v) for v in vals]
    tinv = k.pack_scalar(F.inv(acc))
    assert torch.equal(poly.batch_inverse(k, arr, tinv), inv)
    want = J_BATCH_INV(jk, _jax(F, JF, arr), _jax(F, JF, tinv))
    assert torch.equal(inv, _port(F, want, inv.shape))


def test_eval_poly_matches_even_odd_split():
    """eval_poly of each half of FriRound.split_poly equals eval_even_odd."""
    F = GOLDILOCKS_FP2
    k = get_ops(F)
    rng = _rng("gl2")
    coeffs, z = _rand_scalars(F, 9, rng), _rand_scalars(F, 1, rng)[0]
    parts = FriRound.split_poly(F, DensePolynomial(F, coeffs), 2)
    zp = k.pack_scalar(z)
    fe, fo = poly.eval_even_odd(k, k.pack(coeffs), zp)
    for part, got in zip(parts, (fe, fo)):
        vals = _pad(part.to_vec(), 5, F)
        assert torch.equal(poly.eval_poly(k, k.pack(vals), zp), got)
