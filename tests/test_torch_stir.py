"""The port's STIR low-degree test (ministark_tpu_torch/fri/stir.py) on the
CPU against ministark_tpu/fri/stir.py: the batched point evaluation and the
quotient with degree correction against the JAX functions, a standalone
prove field by field, FastStark with ``lde_backend="stir"`` against the
golden fixture and the JAX package's proofs over both fields, tampering,
and every NTT backend against the JAX pin at 2^14 - 1. Field arithmetic and
hashing are exact: the tolerance is 0 everywhere."""

import copy
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.fields import BabyBear as J_BB
from ministark_tpu.fields import Goldilocks as J_GL
from ministark_tpu.fri.stir import Stir as JStir
from ministark_tpu.fri.stir import StirConfig as JStirConfig
from ministark_tpu.fri.stir import _eval_points_jit, _quot_degcor_jit
from ministark_tpu.models.fibonacci_device import fibonacci_device_trace as j_trace
from ministark_tpu.ops.registry import get_kernels
from ministark_tpu.stark.fast import FastStark as JFastStark
from ministark_tpu.stark.fast import FastStarkConfig as JConfig
from ministark_tpu.stark.proof_io import fast_proof_from_bytes as j_from_bytes
from ministark_tpu.stark.proof_io import fast_proof_to_bytes as j_to_bytes
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import BabyBear, Goldilocks
from ministark_tpu_torch.fri.stir import Stir, StirConfig, eval_points, quot_degcor
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.ops.field import get_ops, pack_words
from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
from ministark_tpu_torch.stark.proof_io import fast_proof_from_bytes, fast_proof_to_bytes

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fast_stir_fib100.bin")
FIELDS = {"goldilocks": (Goldilocks, J_GL), "babybear": (BabyBear, J_BB)}
# sha256 of ministark_tpu's FastStark proof bytes with lde_backend="stir" at
# 2^14 - 1 steps in bench.py::fast_prove's configuration (chip_smoke.py's
# STIR_PINS)
JAX_STIR_16383 = "09c83fba627010b8ef5dde0b5b9c84e0ce28c3082a50583b59cad73321864be2"
FAST_CFG = dict(queries=32, point_queries=2, blowup=2, arity=4, fold_factor=4,
                final_len=32, lde_backend="stir", grinding_bits=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run side by side: one intra-op thread each
    keeps the plain torch ops from contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand_ext(sf, shape, seed):
    """Seeded extension elements (*shape, d) as the port's tensor (int64
    Goldilocks, int32 BabyBear)."""
    d = sf.extension.extension_degree
    v = np.random.default_rng(seed).integers(0, sf.base.p, size=tuple(shape) + (d,),
                                             dtype=np.uint64)
    return pack_words(v, get_ops(sf.extension).dtype)


def jax_of(t, sf):
    return jnp.asarray(to_jax_packed(t, sf.extension))


def assert_same_proof(got, want):
    """Every field of two STIR / WHIR proofs, the paths by row and groups."""
    for name in ("group_sizes", "n", "group_roots", "round_roots", "betas",
                 "final_coeffs", "pow_nonces"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("batch_openings", "round_openings"):
        flat = [[(p.row, list(p.groups)) for p in q] for q in getattr(got, name)]
        ref = [[(p.row, list(p.groups)) for p in q] for q in getattr(want, name)]
        assert flat == ref, name


# ------------------------------------------------------------ device ops
@pytest.mark.parametrize("field,n,m", [
    ("goldilocks", 64, 6), ("goldilocks", 16, 1), ("babybear", 32, 3),
])
def test_eval_points_matches_jax(field, n, m):
    sf, jsf = FIELDS[field]
    coeffs, pts = rand_ext(sf, (n,), n + m), rand_ext(sf, (m,), 7 * m)
    got = eval_points(get_ops(sf.extension), coeffs, pts)
    want = _eval_points_jit(get_kernels(jsf.extension), jax_of(coeffs, sf),
                            jax_of(pts, sf))
    assert torch.equal(got, from_jax_packed(np.asarray(want), sf.extension))


@pytest.mark.parametrize("field,n,m", [
    ("goldilocks", 64, 6), ("goldilocks", 16, 2), ("babybear", 32, 3),
])
def test_quot_degcor_matches_jax(field, n, m):
    sf, jsf = FIELDS[field]
    ext, ke = sf.extension, get_ops(sf.extension)
    coeffs = rand_ext(sf, (n,), 3 * n + m)
    ans, roots = rand_ext(sf, (m,), 11 + m), rand_ext(sf, (m,), 13 + m)
    scales = ke.pack([ext.inv(x) for x in ke.unpack(roots)])
    r_cor = ke.unpack(rand_ext(sf, (1,), 17 + m))[0]
    rpows = ke.pack([ext.pow(r_cor, l) for l in range(m + 1)])
    got = quot_degcor(ke, coeffs, ans, roots, scales, rpows)
    want = _quot_degcor_jit(get_kernels(jsf.extension),
                            *(jax_of(t, sf) for t in (coeffs, ans, roots,
                                                      scales, rpows)))
    assert got.shape == coeffs.shape
    assert torch.equal(got, from_jax_packed(np.asarray(want), sf.extension))


# ------------------------------------------------------------ standalone
def test_standalone_prove_matches_jax_and_cross_verifies():
    """tests/test_stir.py's single-round case: n = 2^8, b = 1."""
    sf = Goldilocks
    polys = rand_ext(sf, (1, 1 << 8), 5)
    cfg = dict(k=4, blowup=2, security_bits=16, final_len=16)
    stir = Stir(StirConfig(sf.extension, **cfg))
    jstir = JStir(JStirConfig(J_GL.extension, **cfg))
    proof = stir.prove(polys)
    jproof = jstir.prove(np.asarray(jax_of(polys, sf)))
    assert len(proof.round_roots) == stir._schedule(1 << 8)[4] == 1
    assert_same_proof(proof, jproof)
    assert proof.size_bytes(sf.extension) == jproof.size_bytes(J_GL.extension)
    assert stir.verify(jproof) and jstir.verify(proof)
    bad = copy.deepcopy(proof)
    bad.betas[0] = sf.extension.add(bad.betas[0], sf.extension.one())
    with pytest.raises(AssertionError):
        stir.verify(bad)


# ------------------------------------------------------------ FastStark
def _port_stark(sf, steps, backend="radix2", **kw):
    return FastStark(FastStarkConfig(sf, steps, lde_backend="stir", **kw),
                     device="cpu", ntt_backend=backend)


def _port_trace(sf, steps, secret_b=2):
    return fibonacci_device_trace(sf, steps, secret_b, on_device=True, device="cpu")


def test_proof_matches_golden_fixture():
    stark = _port_stark(Goldilocks, 100, queries=4, final_len=8)
    trace = _port_trace(Goldilocks, 100)
    proof = stark.prove(trace)
    golden = open(GOLDEN, "rb").read()
    assert fast_proof_to_bytes(Goldilocks, proof) == golden
    back = fast_proof_from_bytes(Goldilocks, golden)
    assert fast_proof_to_bytes(Goldilocks, back) == golden
    assert stark.verify(stark._constraint_polys(trace), back)
    assert set(stark.phase_seconds) == {"constraint_polys", "commit_witness",
                                        "point_evals", "commit_validities",
                                        "lde_prove"}


def test_babybear_proof_matches_jax_and_cross_verifies():
    kw = dict(queries=8, point_queries=2, arity=4, final_len=8)
    jstark = JFastStark(JConfig(J_BB, 77, lde_backend="stir", **kw))
    jtrace = j_trace(J_BB, 77)
    jproof = jstark.prove(jtrace)
    jblob = j_to_bytes(J_BB, jproof)
    stark, trace = _port_stark(BabyBear, 77, **kw), _port_trace(BabyBear, 77)
    proof = stark.prove(trace)
    assert fast_proof_to_bytes(BabyBear, proof) == jblob
    assert proof.size_bytes() == jproof.size_bytes()
    jcons = np.asarray(jstark._constraint_polys(jtrace))
    assert stark.verify(stark._constraint_polys(trace),
                        fast_proof_from_bytes(BabyBear, jblob))
    assert jstark.verify(jcons, j_from_bytes(J_BB, fast_proof_to_bytes(BabyBear, proof)))


def test_rejects_wrong_witness_and_tampering():
    ext = Goldilocks.extension
    stark = _port_stark(Goldilocks, 60, queries=8, final_len=8)
    proof = stark.prove(_port_trace(Goldilocks, 60))
    cons = stark._constraint_polys(_port_trace(Goldilocks, 60))
    assert stark.verify(cons, proof)
    with pytest.raises(AssertionError):
        stark.verify(stark._constraint_polys(_port_trace(Goldilocks, 60, 99)), proof)
    fp = proof.fri_proof
    tampered = []
    bad = copy.deepcopy(proof)
    row = bytearray(bad.fri_proof.batch_openings[0][0].row)
    row[3] ^= 0x10
    bad.fri_proof.batch_openings[0][0].row = bytes(row)
    tampered.append(bad)
    bad = copy.deepcopy(proof)
    bad.fri_proof.betas[0] = ext.add(fp.betas[0], ext.one())
    tampered.append(bad)
    bad = copy.deepcopy(proof)
    bad.fri_proof.final_coeffs[0] = ext.add(fp.final_coeffs[0], ext.one())
    tampered.append(bad)
    bad = copy.deepcopy(proof)
    bad.fri_proof.round_roots[0] = bytes(32)
    tampered.append(bad)
    for bad in tampered:
        with pytest.raises(AssertionError):
            stark.verify(cons, bad)


@pytest.mark.parametrize("backend", ["radix2", "four_step", "pipe"])
def test_backends_match_the_jax_pin_at_2_14(backend):
    """The coset FFTs at 2^15 .. 2^11 through each NTT backend (four-step
    and pipe take 2^14 and up): four quotient rounds, the JAX bytes."""
    steps = (1 << 14) - 1
    trace = _port_trace(Goldilocks, steps)
    stark = FastStark(FastStarkConfig(Goldilocks, steps, **FAST_CFG),
                      device="cpu", ntt_backend=backend)
    proof = stark.prove(trace)
    assert len(proof.fri_proof.round_roots) == 4
    blob = fast_proof_to_bytes(Goldilocks, proof)
    assert hashlib.sha256(blob).hexdigest() == JAX_STIR_16383
    assert stark.verify(stark._constraint_polys(trace), proof)
