"""The resident STIR and WHIR proves of the port on a mesh (``FastStark(...,
mesh=mesh)`` with ``lde_backend="stir"`` or ``"whir"``, ``fri/stir.py``,
``fri/whir.py``) in CPU gloo groups of 2 and 4 ranks: rank r holds the rows
[r*d/D, (r+1)*d/D) of every round's d coefficients until a round stops
splitting. The block pieces are held against the JAX package on the whole
input, integer for integer: the block point evaluations, the block quotient
with degree correction (its blocks joined) and the block sumcheck
evaluations, over Goldilocks Fp2 and BabyBear Fp4, against
``_eval_points_jit``, ``_quot_degcor_jit`` and ``_sumcheck_evals_jit``; the
coset-row block LDE over a coset against the JAX ``Stir._coset_fft_batched``
+ ``_coset_rows``. Then the resident proves, every rank against one device:
Goldilocks at 1023 steps against the JAX package's proof bytes (pinned),
BabyBear at 255 steps, ``prove_many`` of three traces, and a STIR
configuration whose rounds hand off because a
block would hold too few coefficients for the degree correction (|G| = 33
at 511 steps and 32 query bits). Each prove logs its handoffs and every
whole-tensor LDE and tree: none comes before the first handoff, which comes
at the round the split table predicts; a STIR round on blocks reads a
``halo`` of the previous rank's last coefficients, and a rank's
``all_gather`` bytes outside the openings stay under a quarter of one L_0
LDE. The 100-step golden fixtures are proved resident, with their events
and halos, in ``tests/test_torch_sharded_engine.py``. One group per world
size runs every scenario once; the tolerance is 0."""

import functools
import hashlib
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.fields import BABYBEAR_FP4 as J_BB4
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_GL2
from ministark_tpu.fri.stir import Stir as JStir
from ministark_tpu.fri.stir import StirConfig as JStirConfig
from ministark_tpu.fri.stir import _eval_points_jit, _quot_degcor_jit
from ministark_tpu.fri.whir import _sumcheck_evals_jit
from ministark_tpu.ops.registry import get_kernels
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import BABYBEAR_FP4, GOLDILOCKS_FP2
from ministark_tpu_torch.fields import BabyBear, Goldilocks
from ministark_tpu_torch.fri.stir import Stir, StirConfig
from ministark_tpu_torch.fri.whir import Whir, WhirConfig
from ministark_tpu_torch.ops.field import get_ops, unpack_u64
from ministark_tpu_torch.parallel import cases, launch

WORLDS = (2, 4)
TIMEOUT_S = 300
EXT = {"gl": (J_GL2, GOLDILOCKS_FP2), "bb": (J_BB4, BABYBEAR_FP4)}
LDTS = {"stir": (Stir, StirConfig), "whir": (Whir, WhirConfig)}


def _seeded(p, shape, seed, low=0):
    return np.random.default_rng([17, seed]).integers(low, p, size=shape, dtype=np.uint64)


# key -> (field, B polynomials, m coefficients, N points, F, coset offset):
# STIR's L_1 offset g^2 and WHIR's L_0 offset g
LDES = {"gl": ("gl", 2, 128, 256, 4, pow(Goldilocks.base.generator, 2, Goldilocks.base.p)),
        "bb": ("bb", 1, 256, 512, 4, BabyBear.base.generator)}
LDE_IN = {key: _seeded(EXT[f][1].base.p, (B, m, EXT[f][1].extension_degree), i)
          for i, (key, (f, B, m, _, _, _)) in enumerate(LDES.items())}
# field -> (n coefficients, |G| quotient points, evaluation points, sumcheck
# points): n / 4 > |G|, so every block of 4 ranks holds more than |G|
OPS = {"gl": (64, 6, 5, 4), "bb": (32, 3, 2, 3)}


def _ops_inputs(field):
    p, d = EXT[field][1].base.p, EXT[field][1].extension_degree
    n, m, e, s = OPS[field]
    seed = 10 * (1 + list(OPS).index(field))
    return dict(coeffs=_seeded(p, (n, d), seed), pts=_seeded(p, (e, d), seed + 1),
                ans=_seeded(p, (m, d), seed + 2), roots=_seeded(p, (m, d), seed + 3, 1),
                r_cor=_seeded(p, (d,), seed + 4), start_pts=_seeded(p, (s, d), seed + 5))


CFG = dict(queries=4, final_len=8)           # tests/test_torch_{stir,whir}.py's golden
# (name, lde) -> keywords of cases.resident_fast with lde_backend lde
PROVES = {}
for lde in LDTS:
    PROVES[("gl1023", lde)] = dict(field="gl", steps=1023, cfg=dict(CFG, lde_backend=lde))
    PROVES[("bb255", lde)] = dict(field="bb", steps=255, cfg=dict(CFG, lde_backend=lde))
    PROVES[("many3", lde)] = dict(field="gl", steps=255, batch=3,
                                  cfg=dict(queries=4, final_len=16, lde_backend=lde))
PROVES[("halo", "stir")] = dict(field="gl", steps=511,
                                cfg=dict(queries=32, final_len=8, lde_backend="stir"))
# sha256 of ministark_tpu.stark.proof_io.fast_proof_to_bytes of the JAX
# FastStark's Goldilocks Fibonacci proof at 1023 steps in CFG with that
# lde_backend (JAX_PLATFORMS=cpu; 83 s for STIR and 37 s for WHIR on the
# CPU that made them)
JAX_PINS = {("gl1023", "stir"): "288bbdff370470a2ac70697deace3fec51eb9840727d72130ce8b256e9bf09d8",
            ("gl1023", "whir"): "eb5411b7b9f6aa272d594b7739482d16a73e7d2f149affd8509e39329e673bac"}
# (world, key) -> the prove's events (cases.resident_fast): ("handoff", m)
# gathers a round's m coefficients where it stops splitting, or the last
# round's for the final fold; ("fft", N) / ("tree", rows) are whole-tensor
# LDEs and trees. The same for STIR and WHIR but where |G| decides
EVENTS = {}
for lde in LDTS:
    for w in WORLDS:
        EVENTS[(w, ("gl1023", lde))] = [("handoff", 64), ("fft", 256), ("tree", 64)]
        EVENTS[(w, ("many3", lde))] = [("handoff", 64)]
    EVENTS[(2, ("bb255", lde))] = [("handoff", 16)]
    EVENTS[(4, ("bb255", lde))] = [("handoff", 64), ("fft", 128), ("tree", 32)]
# |G| = 33 in round 1 and 17 in round 2: a block of 4 ranks holds 32
# coefficients of round 1, one of 2 ranks 16 of round 2
EVENTS[(2, ("halo", "stir"))] = [("handoff", 128), ("fft", 256), ("tree", 64)]
EVENTS[(4, ("halo", "stir"))] = [("handoff", 512), ("fft", 512), ("tree", 128),
                                 ("fft", 256), ("tree", 64)]


def _scenarios():
    out = [(("lde", key), "block_coset_lde", dict(field=f, polys=LDE_IN[key], N=N, F=F,
                                                  offset=off))
           for key, (f, _, _, N, F, off) in LDES.items()]
    out += [(("ops", f), "block_ldt_ops", dict(field=f, **_ops_inputs(f))) for f in OPS]
    out += [(key, "resident_fast", kw) for key, kw in PROVES.items()]
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


def _jax(a, pf):
    return jnp.asarray(to_jax_packed(torch.from_numpy(np.asarray(a).view(np.int64)), pf))


# ------------------------------------------------------------ the split table
def _resident_rounds(lde, n, queries, final_len, world):
    """The rounds a resident prove keeps on blocks (0: the L_0 commitment),
    by the prover's own rules: ``block_fits``, then ``_round_splits`` round
    by round until the first that fails."""
    from ministark_tpu_torch.parallel.mesh import Rows

    cls, config = LDTS[lde]
    ldt = cls(config(GOLDILOCKS_FP2, k=4, blowup=2, security_bits=queries,
                     final_len=final_len))
    d, N, _, t, R = ldt._schedule(n)
    if not ldt.block_fits(n, world):
        return []
    mesh = SimpleNamespace(size=world, rank=0)    # the rank does not matter to the rules
    out, rows = [0], Rows(mesh, n)
    for i in range(1, R + 1):
        if not ldt._round_splits(rows, i, N, t):
            break
        out.append(i)
        rows = Rows(mesh, d[i])
    return out


@pytest.mark.parametrize("lde", list(LDTS))
@pytest.mark.parametrize("n, queries, final_len, world, rounds", [
    (1 << 20, 32, 32, 2, [0, 1, 2, 3, 4, 5, 6]),   # chip_smoke.py's 2^20 - 1
    (1 << 20, 32, 32, 4, [0, 1, 2, 3, 4, 5]),
    (1024, 4, 8, 2, [0, 1, 2]),                     # 1023 steps: round 3 hands off
    (1024, 4, 8, 4, [0, 1, 2]),
    (1 << 14, 32, 32, 4, [0, 1, 2, 3]),             # chip_smoke.py's four-rank pins
])
def test_split_table(lde, n, queries, final_len, world, rounds):
    assert _resident_rounds(lde, n, queries, final_len, world) == rounds


@pytest.mark.parametrize("world, stir, whir", [(2, [0, 1], [0, 1, 2]), (4, [0], [0, 1])])
def test_stir_hands_off_where_a_block_is_shorter_than_g(world, stir, whir):
    """511 steps, 32 query bits: the coset-row LDE of round 1 splits at 4
    ranks and of round 2 at 2, but STIR's blocks hold no more than |G|
    coefficients there; WHIR, with no quotient, stays on its blocks."""
    assert _resident_rounds("stir", 512, 32, 8, world) == stir
    assert _resident_rounds("whir", 512, 32, 8, world) == whir


# ------------------------------------------------------------ block pieces
@functools.lru_cache(maxsize=None)
def _jax_coset_rows(key):
    """The JAX package's ``_coset_rows(Stir._coset_fft_batched(polys, N,
    offset), F)`` as u64."""
    field, _, _, N, F, offset = LDES[key]
    je, pe = EXT[field]
    js = JStir(JStirConfig(je, k=F))
    offp = jnp.asarray(js.kb.pack([offset])[0])
    return _u64(js._bf._coset_rows(js._coset_fft_batched(_jax(LDE_IN[key], pe), N, offp), F),
                pe)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(LDES))
def test_coset_offset_lde_matches_jax_and_one_device(groups, world, key):
    field, B, _, N, F, _ = LDES[key]
    res = _ranks(groups, world, ("lde", key))
    d = EXT[field][1].extension_degree
    assert [blk.shape for blk, _ in res] == [(N // (F * world), B, F, d)] * world
    got = np.concatenate([blk for blk, _ in res], 0)
    assert np.array_equal(got, res[0][1])
    assert np.array_equal(got, _jax_coset_rows(key))


@functools.lru_cache(maxsize=None)
def _jax_ops(field):
    """The JAX package's point evaluations, quotient with degree correction
    and sumcheck evaluations on the whole input, as u64."""
    je, pe = EXT[field]
    kj, ke = get_kernels(je), get_ops(pe)
    inp = _ops_inputs(field)
    roots = ke.unpack(torch.from_numpy(inp["roots"].view(np.int64)))
    r_cor = ke.unpack(torch.from_numpy(inp["r_cor"][None].view(np.int64)))[0]
    scales = ke.pack([pe.inv(x) for x in roots])
    rpows = ke.pack([pe.pow(r_cor, j) for j in range(len(roots) + 1)])
    c = _jax(inp["coeffs"], pe)
    quot = _quot_degcor_jit(kj, c, _jax(inp["ans"], pe), _jax(inp["roots"], pe),
                            _jax(unpack_u64(scales), pe), _jax(unpack_u64(rpows), pe))
    return {"eval_points": _u64(_eval_points_jit(kj, c, _jax(inp["pts"], pe)), pe),
            "quot_degcor": _u64(quot, pe),
            "sumcheck_evals": _u64(_sumcheck_evals_jit(kj, c, _jax(inp["start_pts"], pe)), pe)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("field", list(OPS))
def test_block_ldt_ops_match_jax(groups, world, field):
    res = _ranks(groups, world, ("ops", field))
    want = _jax_ops(field)
    n = OPS[field][0]
    for r in res:
        assert np.array_equal(r["eval_points"], want["eval_points"].reshape(r["eval_points"].shape))
        assert np.array_equal(r["sumcheck_evals"],
                              want["sumcheck_evals"].reshape(r["sumcheck_evals"].shape))
        assert r["quot_degcor"].shape[0] == n // world
    joined = np.concatenate([r["quot_degcor"] for r in res], 0)
    assert np.array_equal(joined, want["quot_degcor"].reshape(joined.shape))


# ------------------------------------------------------------ resident proves
@functools.lru_cache(maxsize=None)
def _want_sha(key):
    """sha256 of one device's proof bytes: the JAX pin, or the port's
    one-device prove on the CPU."""
    if key in JAX_PINS:
        return JAX_PINS[key]
    kw = PROVES[key]
    proof = cases.fast(None, kw["field"], kw["steps"], kw["cfg"], kw.get("batch", 1))[0]
    return hashlib.sha256(proof).hexdigest()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(PROVES), ids="-".join)
def test_resident_ldt_equals_one_device(groups, world, key):
    want = _want_sha(key)
    for rank, (proof, collectives, received, _) in enumerate(_ranks(groups, world, key)):
        assert hashlib.sha256(proof).hexdigest() == want, (
            f"{key}: rank {rank} of {world} differs from one device")
        # the openings come from their owners: the L_0 trees are blocks
        assert collectives > 0 and received["opening"] > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(PROVES), ids="-".join)
def test_no_whole_lde_or_tree_before_the_handoff(groups, world, key):
    """Each rank's events in order: the first is the handoff, at the round
    the split table predicts; STIR's rounds on blocks read a halo, WHIR's
    none."""
    for _, _, received, events in _ranks(groups, world, key):
        assert events == EVENTS[(world, key)]
        assert events[0][0] == "handoff"
        kw = PROVES[key]
        n = 1 << kw["steps"].bit_length()            # the trace domain
        rounds = _resident_rounds(key[1], n, kw["cfg"]["queries"], kw["cfg"]["final_len"],
                                  world)
        assert (received["halo"] > 0) is (key[1] == "stir" and len(rounds) > 1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(PROVES), ids="-".join)
def test_resident_ldt_gathers_under_a_quarter_of_the_lde(groups, world, key):
    """One device's L_0 witness LDE is B(w + t) polynomials of 2n points of
    d int64 components; a rank's all_gather bytes outside the openings (the
    trees' local tops, the point and sumcheck partial sums, the block
    divisions' totals, the handoffs) stay under a quarter of it."""
    kw = PROVES[key]
    sf = {"gl": Goldilocks, "bb": BabyBear}[kw["field"]]
    trace = cases._trace("fibonacci", sf, kw["steps"], "cpu")
    lde_bytes = (kw.get("batch", 1) * trace.constrain_number() * 2 * trace.domain_size
                 * sf.extension.extension_degree * 8)
    for _, _, received, _ in _ranks(groups, world, key):
        assert 0 < received["all_gather"] < lde_bytes / 4
