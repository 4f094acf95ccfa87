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
wrappers refuse a CPU tensor and a base field. The point evaluations, each
one ``pow_dot`` call (ROADMAP X8): ``eval_many``, STIR's ``eval_points``
and WHIR's ``sumcheck_evals`` against ``poly_device.eval_many``,
``_eval_points_jit`` and ``_sumcheck_evals_jit``, with and without a
start (the JAX functions given the start's zero coefficients in front),
and ``pow_dot_replay`` on their broadcast shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.fields import BABYBEAR_FP4 as J_BB4
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_GL2
from ministark_tpu.fri.stir import _eval_points_jit
from ministark_tpu.fri.whir import _sumcheck_evals_jit
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
from ministark_tpu_torch.fri import stir as t_stir
from ministark_tpu_torch.fri import whir as t_whir
from ministark_tpu_torch.ops import div_scan as ds
from ministark_tpu_torch.ops import poly
from ministark_tpu_torch.ops.field import get_ops, pack_words, unpack_u64
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
    """Uniform field components, a tensor of shape (*shape, K) in the
    field's storage (int32 for BabyBear)."""
    v = rng.integers(0, F.p, size=tuple(shape) + (F.extension_degree,), dtype=np.uint64)
    return pack_words(v, get_ops(F).dtype)


def _point(F, rng):
    """(z, 1/z) as packed (K,) tensors, z a nonzero extension element."""
    k = get_ops(F)
    z = F.from_base_coeffs(tuple(int(c) for c in unpack_u64(_rand(F, rng, ()))))
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


def _zeros_in_front(k, c, count: int, axis: int):
    shape = list(c.shape)
    shape[axis] = count
    return torch.cat([torch.zeros(shape, dtype=torch.int64), c], axis)


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("start", [0, 5])
def test_eval_many_matches_jax(name, start):
    """B = 4 polynomials of 64 coefficients at one point, from x^start."""
    F, JF, _ = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng(name, 30 + start)
    c = _rand(F, rng, (4, 64))
    z, _ = _point(F, rng)
    want = _port(F, J_EVAL_MANY(jk, _j(F, _zeros_in_front(k, c, start, 1)), _j(F, z)))
    assert torch.equal(poly.eval_many(k, c, z, start), want)


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("n,m", [(64, 6), (17, 1)])
def test_eval_points_matches_jax(name, start, n, m):
    """One polynomial at m points (the coefficients broadcast over the
    rows), from x^start."""
    F, JF, _ = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng(name, 40 + n + m + start)
    c, pts = _rand(F, rng, (n,)), _rand(F, rng, (m,))
    want = _port(F, _eval_points_jit(jk, _j(F, _zeros_in_front(k, c, start, 0)),
                                     _j(F, pts)))
    assert torch.equal(t_stir.eval_points(k, c, pts, start), want)


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("n,m", [(64, 5), (18, 1)])
def test_sumcheck_evals_match_jax(name, start, n, m):
    """The even and odd halves at m points, each half from x^start (a block
    whose first coefficient is 2 start)."""
    F, JF, _ = FIELDS[name]
    k, jk = get_ops(F), get_kernels(JF)
    rng = _rng(name, 50 + n + m + start)
    c, pts = _rand(F, rng, (n,)), _rand(F, rng, (m,))
    want = _port(F, _sumcheck_evals_jit(jk, _j(F, _zeros_in_front(k, c, 2 * start, 0)),
                                        _j(F, pts)))
    got = t_whir.sumcheck_evals(k, c, pts, start)
    assert got.shape == (m, 2, F.extension_degree) and torch.equal(got, want)


def test_point_evals_one_pow_dot_call(monkeypatch):
    """eval_many, eval_points and sumcheck_evals each make exactly one
    pow_dot call (so one launch on the card), the last with parts=2."""
    F, _, _ = FIELDS["gl2"]
    k = get_ops(F)
    rng = _rng("gl2", 60)
    seen = []
    real = ds.pow_dot

    def counted(*a, **kw):
        seen.append(kw.get("parts", 1))
        return real(*a, **kw)

    for mod in (poly, t_stir, t_whir):
        monkeypatch.setattr(mod, "pow_dot", counted)
    c, pts = _rand(F, rng, (3, 16)), _rand(F, rng, (4,))
    for call in (lambda: poly.eval_many(k, c, pts[0]),
                 lambda: poly.eval_many(k, c, pts[0], 7),
                 lambda: t_stir.eval_points(k, c[0], pts),
                 lambda: t_stir.eval_points(k, c[0], pts, 7),
                 lambda: t_whir.sumcheck_evals(k, c[0], pts),
                 lambda: t_whir.sumcheck_evals(k, c[0], pts, 7)):
        before = len(seen)
        call()
        assert len(seen) == before + 1
    assert seen == [1, 1, 1, 1, 2, 2]


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("parts", [1, 2])
def test_pow_dot_replay_on_point_eval_shapes(name, parts):
    """The kernel's route at the point evaluations' views: the coefficients
    broadcast over the rows (batch stride 0, STIR and WHIR) with a point a
    row, and one point broadcast over B rows (eval_many), with and without
    a start; and the plain version's one-point branch against its own
    point-a-row path."""
    F, _, _ = FIELDS[name]
    k = get_ops(F)
    rng = _rng(name, 70 + parts)
    c1, c = _rand(F, rng, (70,)), _rand(F, rng, (3, 70))
    pts = _rand(F, rng, (3,))
    for cc, zz in ((c1.unsqueeze(0).expand(3, -1, -1), pts), (c, pts[0].expand(3, -1))):
        for start in (0, 9):
            want = ds.pow_dot_plain(k, cc, zz, start, parts=parts)
            assert torch.equal(ds.pow_dot_replay(k, cc, zz, start, parts=parts), want)
            assert torch.equal(ds.pow_dot_plain(k, cc, zz.contiguous(), start, parts=parts),
                               want)


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


# ---- the kernels' routes replayed in torch ops (ops/div_scan.py's
# div_scan_replay / pow_dot_replay) against the plain versions, which the
# tests above hold to the JAX package: small tiles, no JAX compile
REPLAY_TILES = {8: dict(chunk=2, lanes=2, warps=2, look=1),
                16: dict(chunk=2, lanes=4, warps=2, look=2),
                64: dict(chunk=4, lanes=4, warps=4, look=1)}


# every size at the 8- and 16-element tiles, the long ones at 64
REPLAY_CASES = [(tile, size) for tile in (8, 16)
                for size in ("1", "tile-1", "tile", "tile+1", "5tile+3")]
REPLAY_CASES += [(64, "tile+1"), (64, "5tile+3")]


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("tile,size", REPLAY_CASES)
def test_div_scan_replay_matches_plain(name, tile, size):
    """Every fold/head/carry form over B = 3 rows (one polynomial broadcast
    to the rows in the odd forms), a start and carry with the carry, a head
    of tile + 2 coefficients that crosses the first tile's edge, the
    look-back's steps in a seeded order."""
    F, _, _ = FIELDS[name]
    k = get_ops(F)
    m = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "5tile+3": 5 * tile + 3}[size]
    rng = _rng(name, 100 + 7 * tile + m)
    pts = [_point(F, rng) for _ in range(3)]
    z, zinv = torch.stack([p[0] for p in pts]), torch.stack([p[1] for p in pts])
    for flags in range(8):
        fold, head, carry = flags & 1, flags & 2, flags & 4
        c = _rand(F, rng, (3, 2 * m if fold else m))
        if flags % 2:
            c = c[:1].expand(3, -1, -1)
        kw = dict(start=3 if carry else 0, carry=_rand(F, rng, (3,)) if carry else None,
                  head=_rand(F, rng, (3, tile + 2)) if head else None,
                  fold=_rand(F, rng, ()) if fold else None)
        got = ds.div_scan_replay(k, c, z, zinv, seed=flags, **REPLAY_TILES[tile], **kw)
        assert torch.equal(got, ds.div_scan_plain(k, c, z, zinv, **kw)), flags


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 161])
def test_pow_dot_replay_matches_plain(name, parts, n):
    """Tiles of 2 warps x 4 lanes x 4 terms (2 or 4 chains a thread), B = 3,
    a start, one z broadcast and three; odd and even lengths."""
    F, _, _ = FIELDS[name]
    k = get_ops(F)
    rng = _rng(name, 200 + 2 * n + parts)
    c = _rand(F, rng, (3, n))
    pts = [_point(F, rng)[0] for _ in range(3)]
    for z, start in ((torch.stack(pts), 0), (pts[0].expand(3, -1), 77)):
        got = ds.pow_dot_replay(k, c, z, start, parts=parts, per_thread=4)
        assert torch.equal(got, ds.pow_dot_plain(k, c, z, start, parts=parts))
    if parts == 2:
        got = ds.pow_dot_plain(k, c, z, start, parts=2)
        assert got.shape == (3, 2, F.extension_degree)
        for p in (0, 1):
            assert torch.equal(got[:, p], ds.pow_dot_plain(k, c, z, start, 2, p))


@pytest.mark.parametrize("name,fold", list(ds.GEOMETRY))
def test_tile_bank_map(name, fold):
    """csrc/div_scan.cu's swizzle of a tile's 16-byte units: a bijection; 8
    threads reading the same offset of their chunks (the chunk passes) and
    8 neighbouring units (the cp.async fill, the store) fall in 8 distinct
    4-bank groups; the Fp4 fill through registers (element-wise) is 2-way."""
    threads = ds.THREADS
    per_thread, units = ds.GEOMETRY[(name, fold)]
    log_chunk = (per_thread * units).bit_length() - 1
    n = threads * per_thread * units
    u = torch.arange(n)
    slot = ds.tile_slot(u, log_chunk)
    assert torch.equal(torch.sort(slot).values, u)
    chunk = per_thread * units
    for off in range(chunk):
        for t0 in range(0, threads, 8):
            groups = ds.tile_slot(torch.arange(t0, t0 + 8) * chunk + off, log_chunk) % 8
            assert len(set(groups.tolist())) == 8
    for u0 in range(0, n, 8):
        assert len(set((slot[u0:u0 + 8] % 8).tolist())) == 8
    # element-wise writes: 8 neighbouring threads write unit h of elements e..e+7
    for e0 in range(0, threads * per_thread, 8):
        for h in range(units):
            groups = (ds.tile_slot(torch.arange(e0, e0 + 8) * units + h, log_chunk) % 8).tolist()
            assert max(groups.count(g) for g in groups) == units
