"""The port's WHIR low-degree test (ministark_tpu_torch/fri/whir.py) on the
CPU against ministark_tpu/fri/whir.py: the batched sumcheck evaluations
against the JAX function, standalone proves field by field (k = 4, and
k = 8 with three sumcheck rounds an iteration), FastStark with
``lde_backend="whir"`` against the golden fixture and the JAX package's
proofs over both fields, tampering, and every NTT backend against the JAX
pin at 2^14 - 1. Field arithmetic and hashing are exact: the tolerance is 0
everywhere."""

import copy
import hashlib
import os

import numpy as np
import pytest
import torch

from ministark_tpu.fields import BabyBear as J_BB
from ministark_tpu.fields import Goldilocks as J_GL
from ministark_tpu.fri.whir import Whir as JWhir
from ministark_tpu.fri.whir import WhirConfig as JWhirConfig
from ministark_tpu.fri.whir import _sumcheck_evals_jit
from ministark_tpu.models.fibonacci_device import fibonacci_device_trace as j_trace
from ministark_tpu.ops.registry import get_kernels
from ministark_tpu.stark.fast import FastStark as JFastStark
from ministark_tpu.stark.fast import FastStarkConfig as JConfig
from ministark_tpu.stark.proof_io import fast_proof_from_bytes as j_from_bytes
from ministark_tpu.stark.proof_io import fast_proof_to_bytes as j_to_bytes
from ministark_tpu_torch.convert import from_jax_packed
from ministark_tpu_torch.fields import BabyBear, Goldilocks
from ministark_tpu_torch.fri.whir import Whir, WhirConfig, sumcheck_evals
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.ops.field import get_ops
from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
from ministark_tpu_torch.stark.proof_io import fast_proof_from_bytes, fast_proof_to_bytes
from test_torch_stir import FIELDS, assert_same_proof, jax_of, rand_ext

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fast_whir_fib100.bin")
# sha256 of ministark_tpu's FastStark proof bytes with lde_backend="whir" at
# 2^14 - 1 steps in bench.py::fast_prove's configuration (chip_smoke.py's
# WHIR_PINS)
JAX_WHIR_16383 = "f9dd5faafd2a5739d481df5238aa072db403bf6fd35e5c58e3b1f83b754b8ddb"
FAST_CFG = dict(queries=32, point_queries=2, blowup=2, arity=4, fold_factor=4,
                final_len=32, lde_backend="whir", grinding_bits=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run side by side: one intra-op thread each
    keeps the plain torch ops from contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ device ops
@pytest.mark.parametrize("field,n,m", [
    ("goldilocks", 64, 6), ("goldilocks", 16, 1), ("babybear", 32, 3),
])
def test_sumcheck_evals_match_jax(field, n, m):
    sf, jsf = FIELDS[field]
    cur, pts = rand_ext(sf, (n,), 5 * n + m), rand_ext(sf, (m,), 9 * m)
    got = sumcheck_evals(get_ops(sf.extension), cur, pts)
    want = _sumcheck_evals_jit(get_kernels(jsf.extension), jax_of(cur, sf),
                               jax_of(pts, sf))
    assert got.shape == (m, 2, sf.extension.extension_degree)
    assert torch.equal(got, from_jax_packed(np.asarray(want), sf.extension))


# ------------------------------------------------------------ standalone
@pytest.mark.parametrize("b,log_n,k", [
    (1, 8, 4),      # single iteration, single poly
    (2, 10, 8),     # kappa = 3 (tests/test_whir.py:87-95)
])
def test_standalone_prove_matches_jax_and_cross_verifies(b, log_n, k):
    sf = Goldilocks
    polys = rand_ext(sf, (b, 1 << log_n), log_n + k)
    cfg = dict(k=k, blowup=2, security_bits=16, final_len=16)
    whir = Whir(WhirConfig(sf.extension, **cfg))
    jwhir = JWhir(JWhirConfig(J_GL.extension, **cfg))
    proof = whir.prove(polys)
    jproof = jwhir.prove(np.asarray(jax_of(polys, sf)))
    assert_same_proof(proof, jproof)
    assert proof.sumcheck == jproof.sumcheck
    assert all(len(it) == whir.cfg.kappa for it in proof.sumcheck)
    assert proof.size_bytes(sf.extension) == jproof.size_bytes(J_GL.extension)
    assert whir.verify(jproof) and jwhir.verify(proof)
    bad = copy.deepcopy(proof)
    bad.sumcheck[0][0][1] = sf.extension.add(bad.sumcheck[0][0][1],
                                             sf.extension.one())
    with pytest.raises(AssertionError):
        whir.verify(bad)


# ------------------------------------------------------------ FastStark
def _port_stark(sf, steps, backend="radix2", **kw):
    return FastStark(FastStarkConfig(sf, steps, lde_backend="whir", **kw),
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


def test_babybear_proof_matches_jax_and_cross_verifies():
    kw = dict(queries=8, point_queries=2, arity=4, final_len=8)
    jstark = JFastStark(JConfig(J_BB, 77, lde_backend="whir", **kw))
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
    bad.fri_proof.sumcheck[-1][0][2] = ext.add(fp.sumcheck[-1][0][2], ext.one())
    tampered.append(bad)
    bad = copy.deepcopy(proof)
    bad.fri_proof.final_coeffs[0] = ext.add(fp.final_coeffs[0], ext.one())
    tampered.append(bad)
    for bad in tampered:
        with pytest.raises(AssertionError):
            stark.verify(cons, bad)


@pytest.mark.parametrize("backend", ["radix2", "four_step", "pipe"])
def test_backends_match_the_jax_pin_at_2_14(backend):
    """The coset FFTs at 2^15 .. 2^11 through each NTT backend (four-step
    and pipe take 2^14 and up): four iterations, the JAX bytes."""
    steps = (1 << 14) - 1
    trace = _port_trace(Goldilocks, steps)
    stark = FastStark(FastStarkConfig(Goldilocks, steps, **FAST_CFG),
                      device="cpu", ntt_backend=backend)
    proof = stark.prove(trace)
    assert len(proof.fri_proof.round_roots) == 4
    blob = fast_proof_to_bytes(Goldilocks, proof)
    assert hashlib.sha256(blob).hexdigest() == JAX_WHIR_16383
    assert stark.verify(stark._constraint_polys(trace), proof)
