"""ops/div_scan.py's plain versions of the division by (x - z) and of the
sums weighted by powers of z, over Goldilocks Fp2 and BabyBear Fp4, held
against the JAX package on the same inputs (numpy seeds, one torch thread,
tolerance 0): ``poly_device.synth_div_suffix`` at n = 64 and at 4096 (its
planar path from PLANAR_MIN = 2048), ``eval_even_odd`` (an odd length
too) and ``eval_many``, the engine's FRI round ``_fold_div_jit`` at 64 and
``_fold_div_fused`` at 2^13 against ``div_scan``'s fold, and
``_query_quotients_from_reads_jit`` at Q = 3 against the port engine's
``_quotients_from_reads`` (quotients and effective lengths): Goldilocks at
n0 = 2^12 (the JAX planar path), BabyBear at n0 = 2^6 (its planar division
is held by the 4096 and 2^13 cases; the Fp4 reference's compile at 2^12
costs ~20 s more of a cold run).
Then the block forms: D = 2 and 4 blocks,
each with its start and the later blocks' ``pow_dot`` totals as its carry,
make the whole division (with the head and the fold); a head over a
broadcast polynomial equals one over its copies; z = 0 raises; the kernel
wrappers refuse a CPU tensor and a base field."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.fields import BABYBEAR_FP4 as J_BB4
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_GL2
from ministark_tpu.ops import poly_device as jp
from ministark_tpu.ops.registry import get_kernels
from ministark_tpu.stark.engine import (
    _fold_div_fused,
    _fold_div_jit,
    _query_quotients_from_reads_jit,
)
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import BABYBEAR_FP, BABYBEAR_FP4, GOLDILOCKS_FP2
from ministark_tpu_torch.fields import BabyBear, Goldilocks
from ministark_tpu_torch.ops import div_scan as ds
from ministark_tpu_torch.ops import poly
from ministark_tpu_torch.ops.field import get_ops
from ministark_tpu_torch.stark import StarkConfig
from ministark_tpu_torch.stark.engine import DeviceEngine, _FriRoundRepr

FIELDS = {"gl2": (GOLDILOCKS_FP2, J_GL2, Goldilocks), "bb4": (BABYBEAR_FP4, J_BB4, BabyBear)}
J_SYNTH = jax.jit(jp.synth_div_suffix, static_argnums=0)
J_EVEN_ODD = jax.jit(jp.eval_even_odd, static_argnums=0)
J_EVAL_MANY = jax.jit(jp.eval_many, static_argnums=0)
QUERY_N0 = {"gl2": 1 << 12, "bb4": 1 << 6}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(name, case):
    return np.random.default_rng([18, list(FIELDS).index(name), case])


def _rand(F, rng, shape):
    """Uniform field components, a tensor of shape (*shape, K)."""
    v = rng.integers(0, F.p, size=tuple(shape) + (F.extension_degree,), dtype=np.uint64)
    return torch.from_numpy(v.view(np.int64))


def _point(F, rng):
    """(z, 1/z) as packed (K,) tensors, z a nonzero extension element."""
    k = get_ops(F)
    z = F.from_base_coeffs(tuple(int(c) for c in _rand(F, rng, ()).numpy().view(np.uint64)))
    return k.pack_scalar(z), k.pack_scalar(F.inv(z))


def _j(F, t):
    return jnp.asarray(to_jax_packed(t, F))


def _port(F, a):
    return from_jax_packed(np.asarray(a), F)


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("n", [64, 4096])
def test_synth_div_suffix_matches_jax(name, n):
    F, JF, _ = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng(name, n)
    c = _rand(F, rng, (n,))
    z, zinv = _point(F, rng)
    want = _port(F, J_SYNTH(jk, _j(F, c), _j(F, z), _j(F, zinv)))
    assert torch.equal(poly.synth_div_suffix(k, c, z, zinv), want)
    q = ds.div_scan(k, c[None], z[None], zinv[None])[0]
    assert torch.equal(q[:-1], want) and not q[-1].any()


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("n", [64, 63])
def test_eval_even_odd_matches_jax(name, n):
    F, JF, _ = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng(name, 10 + n)
    c = _rand(F, rng, (n,))
    z, _ = _point(F, rng)
    fe, fo = J_EVEN_ODD(jk, _j(F, c), _j(F, z))
    got = poly.eval_even_odd(k, c, z)
    assert torch.equal(got[0], _port(F, fe)) and torch.equal(got[1], _port(F, fo))


@pytest.mark.parametrize("name", list(FIELDS))
def test_pow_dot_start_matches_eval_many(name):
    """pow_dot over B rows from x^37 equals eval_many of the rows with 37
    zero coefficients in front, one z for every row (batch stride 0)."""
    F, JF, _ = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng(name, 2)
    B, n, start = 3, 64, 37
    c = _rand(F, rng, (B, n))
    z, _ = _point(F, rng)
    padded = torch.cat([torch.zeros((B, start) + k.elem_axes, dtype=torch.int64), c], 1)
    want = _port(F, J_EVAL_MANY(jk, _j(F, padded), _j(F, z)))
    assert torch.equal(ds.pow_dot(k, c, z.expand(B, -1), start), want)


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("n", [64, 1 << 13])
def test_fold_div_matches_jax(name, n):
    """div_scan's fold with the DEEP value as its head: _fold_div_jit (the
    split CPU path) at 64, _fold_div_fused (planar) at 2^13; both n/2 long,
    the last slot zero."""
    F, JF, _ = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng(name, 20 + n)
    c = _rand(F, rng, (n,))
    z, zinv = _point(F, rng)
    alpha, dv = _rand(F, rng, ()), _rand(F, rng, ())
    fn = _fold_div_jit if n == 64 else _fold_div_fused
    want = _port(F, fn(jk, _j(F, c), _j(F, z), _j(F, alpha), _j(F, dv), _j(F, zinv)))
    got = ds.div_scan(k, c[None], z[None], zinv[None], head=dv[None, None], fold=alpha)[0]
    assert got.shape == want.shape == (n // 2, F.extension_degree)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(FIELDS))
def test_query_quotients_match_jax(name):
    """The engine's _quotients_from_reads (one polynomial against Q lines in
    the head, two divisions) at Q = 3 and the field's QUERY_N0, against the
    JAX engine's _query_quotients_from_reads_jit: quotients and effective
    lengths."""
    F, JF, sf = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng(name, 3)
    n0, Q = QUERY_N0[name], 3
    pc = _rand(F, rng, (n0,))
    pc[n0 - 40:] = 0                         # a shorter effective length
    reads = _rand(F, rng, (3 * Q,))
    xs = []
    for _ in range(Q):
        (x1, _), (x2, _) = _point(F, rng), _point(F, rng)
        x1, x2 = k.unpack(x1)[0], k.unpack(x2)[0]
        xs.append((x1, x2, F.one()))
    engine = DeviceEngine(StarkConfig(sf, 20, 2, 15, 6), device="cpu")
    prev = _FriRoundRepr(device=True, ke=k, coeffs=pc, codeword=None, tree=None, size=2 * n0)
    q2, effs = engine._quotients_from_reads(prev, reads, xs)

    def packed(vals):
        return _j(F, k.pack(vals))

    jq, jeffs = _query_quotients_from_reads_jit(
        jk, _j(F, pc), _j(F, reads),
        packed([F.inv(F.sub(x2, x1)) for x1, x2, _ in xs]),
        packed([x1 for x1, _, _ in xs]), packed([x2 for _, x2, _ in xs]),
        packed([F.inv(x1) for x1, _, _ in xs]), packed([F.inv(x2) for _, x2, _ in xs]))
    assert torch.equal(q2, _port(F, jq))
    assert effs.tolist() == np.asarray(jeffs).tolist()


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("fold", [False, True])
def test_blocks_make_the_whole_division(name, D, fold):
    """D blocks of m, each divided from its start r*m with the later blocks'
    pow_dot totals as its carry (the fold's total from the two stride-2
    halves), the line's head on block 0: the whole division, two rows."""
    F, _, _ = FIELDS[name]
    k = get_ops(F)
    rng = _rng(name, 30 + 2 * D + fold)
    B, n = 2, 256
    c = _rand(F, rng, (B, 2 * n if fold else n))
    (z0, zi0), (z1, zi1) = _point(F, rng), _point(F, rng)
    z, zinv = torch.stack([z0, z1]), torch.stack([zi0, zi1])
    head = _rand(F, rng, (B, 2))
    alpha = _rand(F, rng, ()) if fold else None
    whole = ds.div_scan(k, c, z, zinv, head=head, fold=alpha)
    m = n // D
    step = 2 * m if fold else m

    def total(r):
        blk = c[:, r * step:(r + 1) * step]
        if not fold:
            return ds.pow_dot(k, blk, z, r * m)
        even, odd = (ds.pow_dot(k, blk, z, r * m, 2, off) for off in (0, 1))
        return k.add(even, k.mul(odd, alpha.expand_as(odd)))

    totals = [total(r) for r in range(D)]
    blocks = []
    for r in range(D):
        carry = torch.zeros_like(z)
        for s in range(r + 1, D):
            carry = k.add(carry, totals[s])
        blocks.append(ds.div_scan(k, c[:, r * step:(r + 1) * step], z, zinv, r * m,
                                  carry, head, alpha))
    assert torch.equal(torch.cat(blocks, 1), whole)


@pytest.mark.parametrize("name", list(FIELDS))
def test_head_on_a_broadcast_polynomial_equals_its_copies(name):
    F, _, _ = FIELDS[name]
    k = get_ops(F)
    rng = _rng(name, 4)
    Q, n = 3, 100
    c = _rand(F, rng, (n,))
    pts = [_point(F, rng) for _ in range(Q)]
    z, zinv = torch.stack([p[0] for p in pts]), torch.stack([p[1] for p in pts])
    head = _rand(F, rng, (Q, 2))
    got = ds.div_scan(k, c.unsqueeze(0).expand(Q, -1, -1), z, zinv, head=head)
    assert torch.equal(got, ds.div_scan(k, c.unsqueeze(0).repeat(Q, 1, 1), z, zinv,
                                        head=head))


@pytest.mark.parametrize("name", list(FIELDS))
def test_zero_point_raises(name):
    F, _, _ = FIELDS[name]
    k = get_ops(F)
    rng = _rng(name, 5)
    c = _rand(F, rng, (2, 16))
    z, zinv = _point(F, rng)
    z = torch.stack([z, torch.zeros_like(z)])
    with pytest.raises(ValueError, match="z = 0"):
        ds.div_scan(k, c, z, torch.stack([zinv, zinv]))


@pytest.mark.parametrize("fn", ["pow_dot_cuda", "div_scan_cuda"])
def test_kernel_wrappers_refuse(fn):
    """The kernels take a CUDA tensor of Goldilocks Fp2 or BabyBear Fp4."""
    k = get_ops(GOLDILOCKS_FP2)
    c, z = torch.zeros((1, 8, 2), dtype=torch.int64), torch.ones((1, 2), dtype=torch.int64)
    args = (c, z) if fn == "pow_dot_cuda" else (c, z, z)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        getattr(ds, fn)(k, *args)
    with pytest.raises(ValueError, match="Goldilocks Fp2 and BabyBear Fp4"):
        getattr(ds, fn)(get_ops(BABYBEAR_FP), c[..., 0], z[..., 0], *args[2:])
