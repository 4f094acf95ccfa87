"""The resident fast prove of the port on a mesh (``FastStark(..., mesh=mesh)``
with batched FRI, ``parallel/__init__.py``) and the resident prove core, in
CPU gloo groups of 2 and 4 ranks: rank r holds the rows [r*n/D, (r+1)*n/D)
of every stage tensor. The pieces are held against the JAX package and one
device, integer for integer: the block LDE whose output is this rank's coset
rows (``get_block_coset_ntt_fns``: Goldilocks Fp2 over three polynomials,
BabyBear Fp4 over two, fold factor 8) against the JAX ``BatchedFri``'s
``_fft_batched`` + ``_coset_rows`` and the port's, with the one exchange it
needs where F*D divides N1 (``block_coset_fits``); the ``BlockIndexTree``'s
root and openings against one device's ``IndexMerkleTree``, its digests
joined against the JAX ``_build_digests_sharded`` on conftest's virtual
2-device mesh (fans 2, 4 and 8, local levels that do and do not reach one
node). Then the resident fast proves: tests/test_torch_fast.py's 100-step
and 63-step (arity 8) configurations against the JAX package's proof bytes
(pinned), the golden ``fast_fri_fib100.bin``, ``prove_many`` of three traces,
BabyBear at 255 steps and arity 8 at 255 steps, every rank equal to the
port's one-device proof. Each prove logs its handoffs (a layer that stops
splitting is gathered once) and every whole-tensor LDE (``_fft_batched``)
and ``IndexMerkleTree``: none comes before the first handoff, the 100-step
configuration hands off at its first folded layer (64 points, 16 coset
rows) at 4 ranks, and a trace that does not split (63 steps at 4 ranks)
proves on one device's code. A rank's ``all_gather`` bytes outside the
``opening`` kind stay under a quarter of one LDE. Last the resident prove
core, its blocks joined, against the JAX single core with shift 1. One group
per world size runs every scenario once; the tolerance is 0."""

import functools
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.commit.index_tree import _build_digests_sharded as j_build_sharded
from ministark_tpu.fields import BABYBEAR_FP4 as J_BB4
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_GL2
from ministark_tpu.fields import Goldilocks as J_GL
from ministark_tpu.fri.batched import BatchedFri as JBatchedFri
from ministark_tpu.fri.batched import BatchedFriConfig as JBatchedFriConfig
from ministark_tpu.parallel import make_mesh as j_mesh
from ministark_tpu.stark.core import make_prove_core as j_make_prove_core
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.ops.field import unpack_u64
from ministark_tpu_torch.fields import BABYBEAR_FP4, GOLDILOCKS_FP, GOLDILOCKS_FP2
from ministark_tpu_torch.fields import BabyBear, Goldilocks
from ministark_tpu_torch.parallel import block_coset_fits, cases, launch

WORLDS = (2, 4)
TIMEOUT_S = 300
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fast_fri_fib100.bin")
EXT = {"gl": (J_GL2, GOLDILOCKS_FP2), "bb": (J_BB4, BABYBEAR_FP4)}


def _seeded(p, shape, seed):
    return np.random.default_rng([16, seed]).integers(0, p, size=shape, dtype=np.uint64)


# key -> (field, B polynomials, m coefficients, N points, fold factor F)
LDES = {"gl": ("gl", 3, 128, 256, 4), "bb": ("bb", 2, 256, 512, 4),
        "gl_f8": ("gl", 1, 512, 1024, 8)}
LDE_IN = {key: _seeded(EXT[f][1].base.p, (B, m, EXT[f][1].extension_degree), i)
          for i, (key, (f, B, m, _, _)) in enumerate(LDES.items())}
# (rows, arity) of the index trees: 16 rows a rank at 4 ranks reach one node
# at fans 2 and 4 and stop at two nodes at fan 8; 8 rows a rank stop at two
# nodes at fan 4
TREES = ((64, 2), (64, 4), (64, 8), (32, 4))
TREE_IN = {t: _seeded(Goldilocks.base.p, (t[0], 8), 10 + i) for i, t in enumerate(TREES)}


def _tree_idxs(n):
    return [0, n - 1, n // 2, 5, 5, n // 4 + 3, 3 * n // 4 + 1]


CFG100 = dict(queries=8, point_queries=2, arity=4, final_len=8)   # test_torch_fast's
CFG63 = dict(queries=8, point_queries=2, arity=8, final_len=8)
# key -> keywords of cases.resident_fast
PROVES = {
    "fib100": dict(field="gl", steps=100, cfg=CFG100),
    "fib63_arity8": dict(field="gl", steps=63, cfg=CFG63),
    "golden": dict(field="gl", steps=100, cfg=dict(queries=4, final_len=8)),
    "many3": dict(field="gl", steps=255, cfg=dict(queries=4, final_len=16), batch=3),
    "bb255": dict(field="bb", steps=255, cfg=dict(queries=4, final_len=16)),
    "arity8": dict(field="gl", steps=255, cfg=dict(queries=4, final_len=8, arity=8)),
}
# sha256 of ministark_tpu.stark.proof_io.fast_proof_to_bytes of the JAX
# FastStark's Goldilocks Fibonacci proof (JAX_PLATFORMS=cpu), the
# configurations of tests/test_torch_fast.py::test_proof_bytes_match_jax
JAX_PINS = {"fib100": "f2abe75684474b6d1a526e1852619ce32020fb986e0a03d7152bd56fa5fd1a2b",
            "fib63_arity8": "496984e3746d53fdff33662476a97d3abe99e8503b8d12bb04bb84628f0ad83e"}
# (world, key) -> the prove's events (cases.resident_fast): ("handoff", m)
# gathers m coefficients where a layer stops splitting or the final ones,
# ("fft", N) / ("tree", rows) are whole-tensor LDEs and trees. A coset-row
# LDE of N points splits over D ranks when F*D divides N1
# (block_coset_fits): at 4 ranks the first folded layer of n = 128 (64
# points, N1 = 8) does not, and a trace of 64 rows does not split at all
EVENTS = {
    (2, "fib100"): [("handoff", 8)],
    (4, "fib100"): [("handoff", 32), ("fft", 64), ("tree", 16)],
    (2, "fib63_arity8"): [("handoff", 16), ("fft", 32), ("tree", 8)],
    (4, "fib63_arity8"): [("fft", 128), ("tree", 32), ("fft", 128), ("tree", 32),
                          ("fft", 32), ("tree", 8)],
    (2, "golden"): [("handoff", 8)],
    (4, "golden"): [("handoff", 32), ("fft", 64), ("tree", 16)],
    (2, "many3"): [("handoff", 16)],
    (4, "many3"): [("handoff", 64), ("fft", 128), ("tree", 32)],
    (2, "bb255"): [("handoff", 16)],
    (4, "bb255"): [("handoff", 64), ("fft", 128), ("tree", 32)],
    (2, "arity8"): [("handoff", 16), ("fft", 32), ("tree", 8)],
    (4, "arity8"): [("handoff", 64), ("fft", 128), ("tree", 32), ("fft", 32), ("tree", 8)],
}
ONE_DEVICE = {(4, "fib63_arity8")}          # the proves whose trace does not split
CORE_N = 128


def _core_inputs():
    """Seeded (cols, weights) of the Goldilocks Fibonacci core: w 3, t 3."""
    return _seeded(J_GL.base.p, (3, CORE_N), 20), _seeded(J_GL.base.p, (6,), 21)


def _scenarios():
    out = [(("lde", key), "block_coset_lde", dict(field=f, polys=LDE_IN[key], N=N, F=F))
           for key, (f, _, _, N, F) in LDES.items()]
    out += [(("tree",) + t, "block_index_tree", dict(rows=TREE_IN[t], arity=t[1],
                                                    idxs=_tree_idxs(t[0])))
            for t in TREES]
    out += [(key, "resident_fast", kw) for key, kw in PROVES.items()]
    cols, weights = _core_inputs()
    out.append(("core", "core", dict(field="gl", n=CORE_N, cols=cols, weights=weights)))
    return out


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def groups():
    """world -> future of its ranks' results, both groups started at once
    so that they run while the references are made here."""
    pool = ThreadPoolExecutor(len(WORLDS))
    futs = {w: pool.submit(launch.run, cases.run, w, "gloo", "cpu", TIMEOUT_S,
                           (_scenarios(),)) for w in WORLDS}
    yield futs
    pool.shutdown(wait=True)


def _ranks(groups, world, key):
    """Every rank's result of a scenario, in rank order."""
    return [r[key] for r in groups[world].result()]


def _u64(a, pf):
    return unpack_u64(from_jax_packed(np.asarray(a), pf))


@pytest.mark.parametrize("n, n_in, F, world, fits", [
    (256, 128, 4, 4, True),       # N1 = 16 = F * D
    (64, 32, 4, 2, True),         # N1 = 8 = F * D
    (64, 32, 4, 4, False),        # N1 = 8 < F * D = 16: a second exchange
    (128, 64, 4, 4, False),       # N1 = 8
    (1024, 512, 8, 4, True),      # N1 = 32 = F * D
    (512, 256, 8, 4, False),      # N1 = 16 < 32
])
def test_coset_rows_split_where_f_times_d_divides_n1(n, n_in, F, world, fits):
    assert block_coset_fits(n, n_in, F, world) is fits


@functools.lru_cache(maxsize=None)
def _jax_coset_rows(key):
    """The JAX package's ``_coset_rows(_fft_batched(polys, N), F)`` as u64."""
    field, _, _, N, F = LDES[key]
    je, pe = EXT[field]
    bf = JBatchedFri(JBatchedFriConfig(je, fold_factor=F))
    polys = jnp.asarray(to_jax_packed(torch.from_numpy(LDE_IN[key].view(np.int64)), pe))
    return _u64(bf._coset_rows(bf._fft_batched(polys, N), F), pe)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(LDES))
def test_coset_row_lde_matches_jax_and_one_device(groups, world, key):
    field, B, _, N, F = LDES[key]
    res = _ranks(groups, world, ("lde", key))
    d = EXT[field][1].extension_degree
    assert [blk.shape for blk, _ in res] == [(N // (F * world), B, F, d)] * world
    got = np.concatenate([blk for blk, _ in res], 0)
    assert np.array_equal(got, res[0][1])
    assert np.array_equal(got, _jax_coset_rows(key))


@functools.lru_cache(maxsize=None)
def _jax_sharded_digests(tree):
    """The JAX package's ``_build_digests_sharded`` on 2 virtual devices."""
    comps = to_jax_packed(torch.from_numpy(TREE_IN[tree].view(np.int64)), GOLDILOCKS_FP)
    out = j_build_sharded(jnp.asarray(comps), tree[1], j_mesh(2), "shards")
    return np.asarray(out).view(np.uint32)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tree", TREES)
def test_block_index_tree_matches_one_device_and_jax(groups, world, tree):
    from ministark_tpu_torch.commit.index_tree import IndexMerklePath, IndexMerkleTree

    n, arity = tree
    res = _ranks(groups, world, ("tree",) + tree)
    for r in res:
        block, single = r["block"], r["single"]
        assert block[0] == single[0]                              # root
        assert np.array_equal(block[1], single[1])                # digests
        assert block[2] == single[2]                              # paths
        for i, (row, path) in zip(_tree_idxs(n), block[2]):
            p = IndexMerklePath(row=row, groups=list(path))
            assert IndexMerkleTree.verify_path(block[0], n, arity, i, p)
    assert np.array_equal(res[0]["block"][1].view(np.uint32), _jax_sharded_digests(tree))


@functools.lru_cache(maxsize=None)
def _single(key):
    """The port's one-device proof bytes of a scenario, on the CPU."""
    kw = PROVES[key]
    return cases.fast(None, kw["field"], kw["steps"], kw["cfg"], kw.get("batch", 1))[0]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(PROVES))
def test_resident_fast_equals_one_device(groups, world, key):
    want = _single(key)
    for rank, (proof, collectives, received, _) in enumerate(_ranks(groups, world, key)):
        assert proof == want, f"{key}: rank {rank} of {world} differs from one device"
        # the openings come from their owners where the trace stage splits
        resident = (world, key) not in ONE_DEVICE
        assert (collectives > 0 and received["opening"] > 0) is resident


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(JAX_PINS))
def test_resident_fast_equals_jax(groups, world, key):
    for proof, *_ in _ranks(groups, world, key):
        assert hashlib.sha256(proof).hexdigest() == JAX_PINS[key]


@pytest.mark.parametrize("world", WORLDS)
def test_resident_fast_equals_golden(groups, world):
    with open(GOLDEN, "rb") as f:
        want = f.read()
    for proof, *_ in _ranks(groups, world, "golden"):
        assert proof == want


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(PROVES))
def test_no_whole_lde_or_tree_before_the_handoff(groups, world, key):
    """Each rank's events in order: a resident prove runs no whole-tensor
    LDE or tree before its first handoff; a trace that does not split
    proves on one device's code from the start, with no collective."""
    for _, collectives, _, events in _ranks(groups, world, key):
        assert events == EVENTS[(world, key)]
        if (world, key) in ONE_DEVICE:
            assert collectives == 0 and all(kind != "handoff" for kind, _ in events)
        else:
            assert events[0][0] == "handoff"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(PROVES))
def test_resident_fast_gathers_under_a_quarter_of_the_lde(groups, world, key):
    """One device's witness LDE is B(w + t) polynomials of 2n points of d
    int64 components; a rank's all_gather bytes outside the openings (the
    trees' local tops, the point evaluations' partial sums, the handoffs)
    stay under a quarter of it."""
    kw = PROVES[key]
    sf = {"gl": Goldilocks, "bb": BabyBear}[kw["field"]]
    trace = cases._trace("fibonacci", sf, kw["steps"], "cpu")
    lde_bytes = (kw.get("batch", 1) * trace.constrain_number() * 2 * trace.domain_size
                 * sf.extension.extension_degree * 8)
    for _, collectives, received, _ in _ranks(groups, world, key):
        assert received["all_gather"] < lde_bytes / 4
        assert (received["all_gather"] > 0) is (collectives > 0)


@pytest.mark.parametrize("world", WORLDS)
def test_block_core_equals_jax_single_core_with_shift_1(groups, world):
    """make_sharded_prove_core's blocks, joined across the ranks, against
    the JAX single core with the coset offset 1."""
    cols, weights = _core_inputs()
    base = J_GL.base
    core, _ = j_make_prove_core(J_GL, CORE_N)
    pack = lambda a: jnp.asarray(to_jax_packed(torch.from_numpy(a.view(np.int64)), base))  # noqa: E731
    want = core(pack(cols), pack(np.asarray(1, dtype=np.uint64)), pack(weights))
    blocks = _ranks(groups, world, "core")
    assert blocks[0][0].shape == (6, 2 * CORE_N // world)
    for g, w in zip(cases.core_whole(blocks), want):
        assert np.array_equal(g, _u64(w, base).reshape(g.shape))
