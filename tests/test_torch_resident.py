"""The resident prove of the port on a mesh (``parallel/__init__.py``): rank
r holds the rows [r*n/D, (r+1)*n/D) of every stage tensor, in CPU gloo
groups of 2 and 4 ranks. The block forms are held against the JAX package
and one device, integer for integer: the block NTT (every transform and
the LDE from n to 2n, whose zero padding the first all_to_all takes in)
at 2^10 against ``get_sharded_ntt_fns`` on a 2-device mesh of conftest's
virtual CPU devices and the port's one-device NTT; the block fold, deep
and divide (also batched over three divisors, the query quotients' form)
against ``ministark_tpu/ops/poly_device.py``'s fold_even_odd,
eval_even_odd and synth_div_suffix; the block tree's root, searches and
paths against one device's ``PackedMerkleTree``, with values that recur
in two ranks' blocks, so that the global first occurrence is on a lower
rank. Then the resident parity proves of all four AIRs (Goldilocks
Fibonacci, MiMC, counter and LFSR, BabyBear Fibonacci) at the sizes of
tests/test_torch_sharded_engine.py (DEVICE_MIN_SIZE 256): every rank's
proof equals the port's one-device proof, the Goldilocks one also the JAX
engine's (its pin, ``JAX_PROOF_1023`` of tests/test_torch_native.py), and
the bytes a rank receives by ``all_gather`` outside the ``opening`` kind
stay under a quarter of one device's LDE. Last the handoffs: a FRI round
whose halves stop splitting (2 ranks) or whose NTT stops splitting (4
ranks), with DEVICE_MIN_SIZE lowered so that such rounds run on tensors,
and a trace too short to split (4 ranks), each gathered once and proved
on with one device's code, equal to one device's proof. The host gathers
run in chunks of 4 KiB here. One group per world size runs every scenario once; the
tolerance is 0."""

import functools
import hashlib
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ministark_tpu_torch.stark.engine as t_eng
from ministark_tpu.fields import BABYBEAR_FP as J_BB
from ministark_tpu.fields import BABYBEAR_FP4 as J_BB4
from ministark_tpu.fields import GOLDILOCKS_FP as J_GL
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_GL2
from ministark_tpu.ops.poly_device import eval_even_odd as j_eval_even_odd
from ministark_tpu.ops.poly_device import fold_even_odd as j_fold_even_odd
from ministark_tpu.ops.poly_device import synth_div_suffix as j_synth_div_suffix
from ministark_tpu.ops.registry import get_kernels
from ministark_tpu.parallel import get_sharded_ntt_fns as j_ntt_fns
from ministark_tpu.parallel import make_mesh as j_mesh
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.ops.field import unpack_u64
from ministark_tpu_torch.fields import (
    BABYBEAR_FP,
    BABYBEAR_FP4,
    GOLDILOCKS_FP,
    GOLDILOCKS_FP2,
)
from ministark_tpu_torch.parallel import cases, launch

WORLDS = (2, 4)
TIMEOUT_S = 300
DEVICE_MIN_SIZE = 256                   # the FRI rounds of 2^10 - 1 on tensors
# chunks of at most 4 KiB in gather_to_host, so that the proves' host
# gathers (the quotients, the host tail) run in many chunks at this size
SETTINGS = (("ministark_tpu_torch.stark.engine", "DEVICE_MIN_SIZE", DEVICE_MIN_SIZE),
            ("ministark_tpu_torch.parallel.mesh", "HOST_CHUNK_BYTES", 4096))
N = 1 << 10
PRIME = {"gl": (J_GL, GOLDILOCKS_FP), "bb": (J_BB, BABYBEAR_FP)}
EXT = {"gl": (J_GL2, GOLDILOCKS_FP2), "bb": (J_BB4, BABYBEAR_FP4)}
OFFSETS = {"gl": 7, "bb": 31}
FRI_N = 64


def _seeded(p, shape, seed):
    return np.random.default_rng([15, seed]).integers(0, p, size=shape, dtype=np.uint64)


X = {"gl": _seeded(J_GL.p, (3, N), 1), "bb": _seeded(J_BB.p, (3, N), 2)}
FRI_IN = {"gl": (_seeded(J_GL.p, (FRI_N, 2), 3), (5, 6), (7, 8),
                 ((11, 12), (13, 14), (15, 16))),
          "bb": (_seeded(J_BB.p, (FRI_N, 4), 4), ((1, 2), (3, 4)), ((5, 6), (7, 8)),
                 (((9, 1), (2, 3)), ((4, 5), (6, 7)), ((8, 9), (1, 2))))}

# the block tree: 256 Goldilocks Fp2 values, two a group; the value at 40
# recurs at 130, the one at 70 at 230 and the one at 200 at 220, so a
# later rank's block holds a later copy of a value whose first occurrence
# is on rank 0 (40), on rank 1 of 4 (70) or on the same rank (200)
TREE_VALS = _seeded(J_GL.p, (256, 2), 5)
for first, again in ((40, 130), (70, 230), (200, 220)):
    TREE_VALS[again] = TREE_VALS[first]
TREE_LOOKUPS = TREE_VALS[[40, 70, 200, 5, 255, 128, 130]]

# key -> keywords of cases.resident_parity: tests/test_torch_sharded_engine.py's
# sizes, and the counter and LFSR AIRs at 2^10 - 1
PROVES = {
    "parity": dict(field="gl", steps=(1 << 10) - 1),
    "mimc": dict(field="gl", steps=(1 << 9) - 1, model="mimc"),
    "counter": dict(field="gl", steps=(1 << 10) - 1, model="counter"),
    "lfsr": dict(field="gl", steps=(1 << 10) - 1, model="lfsr"),
    "bb_parity": dict(field="bb", steps=(1 << 10) - 1),
}
# sha256 of ministark_tpu.stark.proof_io.proof_to_json of the JAX
# DeviceEngine's Goldilocks Fibonacci proof at 2^10 - 1 with its
# DEVICE_MIN_SIZE 256 (tests/test_torch_native.py's JAX_PROOF_1023)
JAX_PROOF_1023 = "67472a7cd8459a6a0b056298b5e71f7f0d7bc979d4ec96b94ef78529b732732f"
# (world, key) -> (keywords of cases.resident_parity, the row counts of the
# blocks gathered whole where a stage stops splitting): at 2 ranks the
# FRI round of 4 coefficients folds to halves of 2, which do not split;
# at 4 ranks the round of 8 coefficients on 16 points does not fit the
# block NTT; a trace of 8 rows does not split over 4 ranks at all, so
# the prove calls no collective
HANDOFFS = {
    (2, "fold_stops"): (dict(field="gl", steps=(1 << 10) - 1, device_min_size=4), [4]),
    (4, "round_stops"): (dict(field="gl", steps=(1 << 10) - 1, device_min_size=16), [8]),
    (4, "trace_stops"): (dict(field="gl", steps=7), []),
}


def _scenarios(world):
    out = []
    for field, x in X.items():
        for kind in cases.KINDS:
            out.append((("ntt", field, kind), "block_ntt", dict(
                field=field, n=N, x=x, kind=kind,
                offset=OFFSETS[field] if kind.startswith("coset") else None)))
        out.append((("lde", field), "block_ntt", dict(
            field=field, n=2 * N, x=x, kind="coset_fft", offset=OFFSETS[field])))
        coeffs, alpha, z, zs = FRI_IN[field]
        out.append((("fri", field), "block_fri", dict(
            field=field, n=FRI_N, coeffs=coeffs, alpha=alpha, z=z, zs=zs)))
    out.append(("tree", "block_tree", dict(field="gl", vals=TREE_VALS, leafs_per_node=2,
                                           lookups=TREE_LOOKUPS)))
    out.append(("mismatch", "block_mismatch", dict(n=N)))
    out += [(key, "resident_parity", kw) for key, kw in PROVES.items()]
    out += [(key, "resident_parity", kw) for (w, key), (kw, _) in HANDOFFS.items()
            if w == world]
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
    so that they run while the JAX references compile here."""
    pool = ThreadPoolExecutor(len(WORLDS))
    futs = {w: pool.submit(launch.run, cases.run, w, "gloo", "cpu", TIMEOUT_S,
                           (_scenarios(w),), SETTINGS) for w in WORLDS}
    yield futs
    pool.shutdown(wait=True)


def _blocks(groups, world, key):
    """Every rank's result of a scenario, in rank order."""
    return [r[key] for r in groups[world].result()]


def _u64(a, pf):
    return unpack_u64(from_jax_packed(np.asarray(a), pf))


def _jax(a, pf):
    return jnp.asarray(to_jax_packed(torch.from_numpy(np.ascontiguousarray(a).view(np.int64)),
                                     pf))


@functools.lru_cache(maxsize=None)
def _jax_ntt(field, n, kind):
    """The JAX package's sharded ``kind`` transform of X[field] zero-padded
    to n, on a 2-device mesh, as u64."""
    jf, pf = PRIME[field]
    x = np.zeros((X[field].shape[0], n), dtype=np.uint64)
    x[:, :N] = X[field]
    fns = j_ntt_fns(jf, n, j_mesh(2))
    i = cases.KINDS.index(kind)
    if kind.startswith("coset"):
        off = jnp.asarray(get_kernels(jf).pack([jf.from_int(OFFSETS[field])])[0])
        return _u64(fns[i](_jax(x, pf), off), pf)
    return _u64(fns[i](_jax(x, pf)), pf)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("field", ["gl", "bb"])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_block_transform_matches_jax_and_one_device(groups, world, field, kind):
    res = _blocks(groups, world, ("ntt", field, kind))
    got = np.concatenate([blk for blk, _ in res], 1)
    assert [blk.shape for blk, _ in res] == [(3, N // world)] * world
    assert np.array_equal(got, res[0][1])
    assert np.array_equal(got, _jax_ntt(field, N, kind))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("field", ["gl", "bb"])
def test_block_lde_takes_in_the_padding(groups, world, field):
    """The coset LDE from n = 2^10 coefficients (blocks of n/D) to 2n
    points (blocks of 2n/D)."""
    res = _blocks(groups, world, ("lde", field))
    got = np.concatenate([blk for blk, _ in res], 1)
    assert [blk.shape for blk, _ in res] == [(3, 2 * N // world)] * world
    assert np.array_equal(got, res[0][1])
    assert np.array_equal(got, _jax_ntt(field, 2 * N, "coset_fft"))


@functools.lru_cache(maxsize=None)
def _jax_fri(field):
    """The JAX package's (fold, (fe, fo), [quotient by (x - z) for z, then
    for each of zs]) of FRI_IN[field], quotients with their trailing zero
    slot, as u64."""
    E, pe = EXT[field]
    k = get_kernels(E)
    coeffs, alpha, z, zs = FRI_IN[field]
    c = _jax(coeffs, pe)

    def scalar(v):
        return jnp.asarray(k.pack_scalar(v))

    def quotient(zv):
        q = _u64(j_synth_div_suffix(k, c, scalar(zv), scalar(E.inv(zv))), pe)
        return np.concatenate([q, np.zeros_like(q[:1])], 0)

    fe, fo = j_eval_even_odd(k, c, scalar(z))
    return (_u64(j_fold_even_odd(k, c, scalar(alpha)), pe),
            np.stack([_u64(fe, pe), _u64(fo, pe)]), [quotient(v) for v in (z,) + zs])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("field", ["gl", "bb"])
def test_block_fri_matches_jax_formulas(groups, world, field):
    fold, deep, (quotient, *batched) = _jax_fri(field)
    res = _blocks(groups, world, ("fri", field))
    assert np.array_equal(np.concatenate([r["fold"] for r in res], 0), fold)
    for r in res:
        assert np.array_equal(r["deep"], deep)
    assert np.array_equal(np.concatenate([r["divide"] for r in res], 0), quotient)
    batch = np.concatenate([r["batch"] for r in res], 1)
    for q, want in enumerate(batched):
        assert np.array_equal(batch[q], want)


@pytest.mark.parametrize("world", WORLDS)
def test_block_tree_matches_one_device(groups, world):
    res = _blocks(groups, world, "tree")
    for block, single in res:
        assert block[0] == single[0]                     # root
        assert block[1] == single[1]                     # first occurrences
        assert block[2] == single[2]                     # paths
    # the global first occurrence of a value that recurs on a later rank
    assert res[0][0][1] == [40, 70, 200, 5, 255, 128, 40]


@pytest.mark.parametrize("world", WORLDS)
def test_block_of_the_wrong_size_raises(groups, world):
    for msg in _blocks(groups, world, "mismatch"):
        assert msg == ["does not fit", "do not split"]


@functools.lru_cache(maxsize=None)
def _single(key):
    """The port's one-device proof of a scenario, on the CPU."""
    default = t_eng.DEVICE_MIN_SIZE
    t_eng.DEVICE_MIN_SIZE = DEVICE_MIN_SIZE
    try:
        return cases.parity(None, **PROVES[key])[0]
    finally:
        t_eng.DEVICE_MIN_SIZE = default


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(PROVES))
def test_resident_parity_equals_one_device(groups, world, key):
    want = _single(key)
    for rank, (proof, collectives, received, _) in enumerate(_blocks(groups, world, key)):
        assert proof == want, f"{key}: rank {rank} of {world} differs from one device"
        # the openings come from their owners: the resident path ran
        assert collectives > 0 and received["opening"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_resident_parity_equals_jax(groups, world):
    proof = _blocks(groups, world, "parity")[0][0]
    assert hashlib.sha256(proof.encode()).hexdigest() == JAX_PROOF_1023


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(PROVES))
def test_resident_parity_gathers_under_a_quarter_of_the_lde(groups, world, key):
    """One device's LDE is (w + t) rows of 2n int64 points; a rank's
    all_gather bytes outside the openings (subtree roots, partial sums,
    lengths, the host tail) stay under a quarter of it."""
    from ministark_tpu_torch.fields import BabyBear, Goldilocks

    kw = PROVES[key]
    sf = {"gl": Goldilocks, "bb": BabyBear}[kw["field"]]
    trace = cases._trace(kw.get("model", "fibonacci"), sf, kw["steps"], "cpu")
    lde_bytes = trace.constrain_number() * 2 * trace.domain_size * 8
    for _, _, received, _ in _blocks(groups, world, key):
        assert 0 < received["all_gather"] < lde_bytes / 4


@pytest.mark.parametrize("world, key", list(HANDOFFS))
def test_stage_that_stops_splitting_hands_off_to_one_device(groups, world, key):
    kw, gathered = HANDOFFS[(world, key)]
    if kw["steps"] == PROVES["parity"]["steps"]:
        want = _single("parity")
    else:
        want = cases.parity(None, kw["field"], kw["steps"])[0]
    for rank, (proof, collectives, _, handoffs) in enumerate(_blocks(groups, world, key)):
        assert proof == want, f"{key}: rank {rank} of {world} differs from one device"
        assert handoffs == gathered
        assert (collectives > 0) == bool(gathered)
