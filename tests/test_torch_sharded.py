"""The port's sharded functions (ministark_tpu_torch/parallel/) in CPU gloo
groups of 2, 4 and 8 ranks, integer for integer: the NTT (every transform,
both fields, a batch of 3, the round trips), the FRI fold / deep / divide
over Goldilocks Fp2 and BabyBear Fp4, the fan-2 tree digests (fmt 0 and 1)
and the index tree at arity 4 and 8. Each is held against the port's
single-device function on every rank and, at one world size, against the
JAX package's sharded function (make_sharded_ntt_fns, make_sharded_fri_fns,
sharded_tree_digests, _build_digests_sharded) on the 8-device CPU mesh of
tests/conftest.py, computed here in the parent. One group per world size
runs all of its scenarios once, started when the module's first test asks
for it; the tolerance is 0."""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.commit.index_tree import _build_digests_sharded as j_index_sharded
from ministark_tpu.commit.packed_tree import to_leaf_comps as j_leaf_comps
from ministark_tpu.fields import BABYBEAR_FP as J_BB
from ministark_tpu.fields import BABYBEAR_FP4 as J_BB4
from ministark_tpu.fields import GOLDILOCKS_FP as J_GL
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_GL2
from ministark_tpu.ops.registry import get_kernels
from ministark_tpu.parallel import make_mesh as j_mesh
from ministark_tpu.parallel import make_sharded_fri_fns as j_fri_fns
from ministark_tpu.parallel import make_sharded_ntt_fns as j_ntt_fns
from ministark_tpu.parallel import sharded_tree_digests as j_tree
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import (
    BABYBEAR_FP,
    BABYBEAR_FP4,
    GOLDILOCKS_FP,
    GOLDILOCKS_FP2,
)
from ministark_tpu_torch.parallel import cases, launch

P_GL, P_BB = GOLDILOCKS_FP.p, BABYBEAR_FP.p
TIMEOUT_S = 240


def _rand(p, shape, seed):
    v = np.random.default_rng(seed).integers(0, p, size=shape, dtype=np.uint64)
    v.reshape(-1)[:2] = [0, p - 1]
    return v


X_GL = _rand(P_GL, (3, 256), 1)          # batch 3
X_BB = _rand(P_BB, (3, 128), 2)
C_GL = _rand(P_GL, (64, 2), 3)           # Fp2 coefficients
C_BB = _rand(P_BB, (64, 4), 4)           # Fp4 coefficients
SCALARS = {"gl": ((123456789, 987654321), (13579, 24680)),
           "bb": (((5, 6), (7, 8)), ((13579, 24680), (11, 12)))}
LEAVES = {0: _rand(P_GL, (384, 1), 5), 1: _rand(P_GL, (128, 2), 6)}   # fmt -> comps
PER_NODE = {0: 6, 1: 2}                  # 64 leaf groups each
ROWS = _rand(P_GL, (128, 6), 7)          # index-tree rows
OFFSETS = {"gl": 7, "bb": 31}
INPUTS = {"gl": (X_GL, 256), "bb": (X_BB, 128)}
WORLDS = (2, 4, 8)


def _scenarios(world):
    out = []
    for field, (x, n) in INPUTS.items():
        for kind in cases.KINDS:
            out.append(((field, kind), "ntt", dict(
                field=field, n=n, x=x, kind=kind,
                offset=OFFSETS[field] if kind.startswith("coset") else None)))
        out.append(((field, "lde"), "lde", dict(field=field, x=x[:, : n // 4],
                                                domain_size=n)))
        out.append(((field, "roundtrip"), "ntt_roundtrip",
                    dict(field=field, n=n, x=x, offset=OFFSETS[field])))
        coeffs = C_GL if field == "gl" else C_BB
        alpha, z = SCALARS[field]
        out.append(((field, "fri"), "fri", dict(field=field, n=64, coeffs=coeffs,
                                                alpha=alpha, z=z)))
    for fmt, comps in LEAVES.items():
        out.append((("tree", fmt), "tree", dict(field="gl", comps=comps,
                                                leafs_per_node=PER_NODE[fmt], fmt=fmt)))
    for arity in (4, 8):
        out.append((("index", arity), "index_tree", dict(comps=ROWS, arity=arity)))
    return out


@pytest.fixture(scope="module")
def groups():
    """world -> future of the ranks' results, every group started at once
    so that they run while the JAX references compile."""
    pool = ThreadPoolExecutor(len(WORLDS))
    futs = {w: pool.submit(launch.run, cases.run, w, "gloo", "cpu", TIMEOUT_S,
                           (_scenarios(w),)) for w in WORLDS}
    yield futs
    pool.shutdown(wait=True)


def _ranks(groups, world, key):
    """Every rank's result of one scenario; all ranks must agree."""
    res = [r[key] for r in groups[world].result()]
    for other in res[1:]:
        assert _equal(other, res[0]), f"{key}: ranks of {world} disagree"
    return res[0]


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def _jax_ntt(field, n, world, x, kind, offset=None):
    """The JAX package's sharded transform, as u64."""
    F = {"gl": J_GL, "bb": J_BB}[field]
    pf = {"gl": GOLDILOCKS_FP, "bb": BABYBEAR_FP}[field]
    k = get_kernels(F)
    fns = j_ntt_fns(F, n, j_mesh(world))
    xt = jnp.asarray(to_jax_packed(torch.from_numpy(x.view(np.int64)), pf))
    i = cases.KINDS.index(kind)
    if offset is None:
        out = fns[i](xt)
    else:
        # the coset argument as the port's cases pass it (coset_ifft's is
        # the inverse offset itself)
        out = fns[i](xt, jnp.asarray(k.pack([F.from_int(offset)])[0]))
    return from_jax_packed(np.asarray(out), pf).numpy().view(np.uint64)


# the JAX references that take longest to compile come first: they run
# while the groups start
@pytest.mark.parametrize("field", ["gl", "bb"])
def test_sharded_fri_matches_jax(groups, field):
    """fold / deep / divide over 4 ranks against make_sharded_fri_fns on a
    4-device mesh (the ``with mesh`` calls of tests/test_sharded.py)."""
    E, pe = {"gl": (J_GL2, GOLDILOCKS_FP2), "bb": (J_BB4, BABYBEAR_FP4)}[field]
    k = get_kernels(E)
    mesh = j_mesh(4)
    fns = j_fri_fns(E, 64, mesh)
    coeffs = C_GL if field == "gl" else C_BB
    alpha, z = SCALARS[field]
    x = jnp.asarray(to_jax_packed(torch.from_numpy(coeffs.view(np.int64)), pe))
    with mesh:
        fold = fns["fold"](x, jnp.asarray(k.pack_scalar(alpha)))
        fe, fo = fns["deep"](x, jnp.asarray(k.pack_scalar(z)))
        div = fns["divide"](x, jnp.asarray(k.pack_scalar(z)),
                            jnp.asarray(k.pack_scalar(E.inv(z))))

    def u64(a):
        return from_jax_packed(np.asarray(a), pe).numpy().view(np.uint64)

    res = _ranks(groups, 4, (field, "fri"))
    assert np.array_equal(res["fold"][0], u64(fold))
    assert np.array_equal(res["deep"][0], np.stack([u64(fe), u64(fo)]))
    assert np.array_equal(res["divide"][0], u64(div))


@pytest.mark.parametrize("fmt", [0, 1])
def test_sharded_tree_matches_jax(groups, fmt):
    """sharded_tree_digests over 8 ranks against the JAX package's on the
    8-device mesh; the digests' u32 words compare as int32."""
    F, pf = {0: (J_GL, GOLDILOCKS_FP), 1: (J_GL2, GOLDILOCKS_FP2)}[fmt]
    vals = LEAVES[fmt].reshape(-1) if fmt == 0 else LEAVES[fmt]
    packed = to_jax_packed(torch.from_numpy(np.ascontiguousarray(vals).view(np.int64)), pf)
    comps = j_leaf_comps(F, jnp.asarray(packed))
    mesh = j_mesh(8)
    with mesh:
        want = np.asarray(j_tree(comps, PER_NODE[fmt], fmt, mesh)).view(np.int32)
    assert np.array_equal(_ranks(groups, 8, ("tree", fmt))[0], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("field", ["gl", "bb"])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_sharded_transform_matches_single_device(groups, world, field, kind):
    sharded, single = _ranks(groups, world, (field, kind))
    assert sharded.shape == INPUTS[field][0].shape
    assert np.array_equal(sharded, single)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ntt_gl_matches_jax(groups, world):
    want = _jax_ntt("gl", 256, world, X_GL[:1], "fft")
    assert np.array_equal(_ranks(groups, world, ("gl", "fft"))[0][:1], want)


def test_sharded_ntt_bb_matches_jax(groups):
    want = _jax_ntt("bb", 128, 4, X_BB[:1], "fft")
    assert np.array_equal(_ranks(groups, 4, ("bb", "fft"))[0][:1], want)


def test_sharded_ntt_batched_matches_jax(groups):
    """A batch of 3 columns over 4 ranks: the transpose's batch axis."""
    want = _jax_ntt("gl", 256, 4, X_GL, "fft")
    assert np.array_equal(_ranks(groups, 4, ("gl", "fft"))[0], want)


@pytest.mark.parametrize("kind", ["coset_fft", "coset_ifft"])
def test_sharded_coset_transforms_match_jax(groups, kind):
    want = _jax_ntt("gl", 256, 8, X_GL[:1], kind, OFFSETS["gl"])
    assert np.array_equal(_ranks(groups, 8, ("gl", kind))[0][:1], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("field", ["gl", "bb"])
def test_sharded_ifft_and_coset_roundtrip(groups, world, field):
    plain, coset = _ranks(groups, world, (field, "roundtrip"))
    x = INPUTS[field][0]
    assert np.array_equal(plain, x) and np.array_equal(coset, x)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("field", ["gl", "bb"])
def test_sharded_fri_matches_single_device(groups, world, field):
    res = _ranks(groups, world, (field, "fri"))
    for name, (sharded, single) in res.items():
        assert np.array_equal(sharded, single), name
    assert res["divide"][0].shape == (64, 2 if field == "gl" else 4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fmt", [0, 1])
def test_sharded_tree_matches_single_device(groups, world, fmt):
    sharded, single = _ranks(groups, world, ("tree", fmt))
    assert sharded.shape == (2 * 64 - 1, 8)
    assert np.array_equal(sharded, single)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arity", [4, 8])
def test_sharded_index_tree_matches_single_device(groups, world, arity):
    sharded, single = _ranks(groups, world, ("index", arity))
    assert np.array_equal(sharded, single)


@pytest.mark.parametrize("arity", [4, 8])
def test_sharded_index_tree_matches_jax(groups, arity):
    comps = jnp.asarray(to_jax_packed(torch.from_numpy(ROWS.view(np.int64)),
                                      GOLDILOCKS_FP))
    want = np.asarray(j_index_sharded(comps, arity, j_mesh(4), "shards")).view(np.int32)
    assert np.array_equal(_ranks(groups, 4, ("index", arity))[0], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("field", ["gl", "bb"])
def test_sharded_lde_matches_single_device(groups, world, field):
    sharded, single = _ranks(groups, world, (field, "lde"))
    assert sharded.shape == INPUTS[field][0].shape
    assert np.array_equal(sharded, single)
