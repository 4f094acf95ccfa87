"""The port's parity prover over BabyBear + Fp4 on the CPU, end to end:
DeviceEngine's proofs byte-identical to the host prover Stark.prove, to
ministark_tpu's DeviceEngine and to tests/golden/babybear_fib7.json, and the
2^14 - 1 proof with every NTT backend equal to the JAX package's digests
(tests/test_torch_bb_fast.py has the fast mode)."""

import json
import os

import numpy as np
import pytest
import torch

import ministark_tpu.stark.engine as j_eng
import ministark_tpu_torch.stark.engine as t_eng
from ministark_tpu.fields import BabyBear as J_BB
from ministark_tpu.models import FibonacciClaim as JClaim
from ministark_tpu.models import Witness as JWitness
from ministark_tpu.models.fibonacci_device import fibonacci_device_trace as j_trace
from ministark_tpu.stark import Stark as JStark
from ministark_tpu.stark import StarkConfig as JConfig
from ministark_tpu_torch.convert import from_jax_trace
from ministark_tpu_torch.fields import BabyBear
from ministark_tpu_torch.models import FibonacciClaim, Witness
from ministark_tpu_torch.models.fibonacci_device import (
    _fib_transitions,
    fibonacci_device_trace,
    fibonacci_trace_cols_on_device,
)
from ministark_tpu_torch.ops.field import get_ops
from ministark_tpu_torch.poly import Radix2EvaluationDomain
from ministark_tpu_torch.stark import Stark, StarkConfig, StarkProof
from ministark_tpu_torch.stark.proof_io import proof_digests, proof_to_json

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "babybear_fib7.json")
# proof_digests() of ministark_tpu's DeviceEngine over BabyBear at 2^14 - 1
# steps (chip_smoke.py's BB_PINS)
JAX_BB_16383 = {
    "trace_commit": "9cb37713310ff68ae3ed993fd2fd22b7ef8b42711454962485322f08147c0498",
    "constrain_trace_commit": "2fc56ee270418f3d3dd8c1847d48101ba8332417ee8017835032b7e2854a6f1c",
    "arthur_sha256": "41609d2c2fb7e3eb08075730e7ac5e0982600444bc4e916aac41d9f29ae81111",
    "fri_payload_sha256": "074d9817a483ddda4c9df45e9caab9857f90625295191cac58aa6e8131c9c6c7",
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run side by side: one intra-op thread each
    keeps the plain torch ops from contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host_proof(steps):
    base = BabyBear.base
    witness = Witness(secret_b=base.from_int(2))
    claim = FibonacciClaim(field=base, step=steps, output=base.from_int(13))
    cfg = StarkConfig(BabyBear, 20, 2, steps, claim.trace(witness).constrain_number())
    return Stark(cfg).prove(claim, witness)


def _jax_host_proof(steps):
    base = J_BB.base
    witness = JWitness(secret_b=base.from_int(2))
    claim = JClaim(field=base, step=steps, output=base.from_int(13))
    cfg = JConfig(J_BB, 20, 2, steps, claim.trace(witness).constrain_number())
    return JStark(cfg).prove(claim, witness)


def _jax_device_proof(steps):
    trace = j_trace(J_BB, steps)
    cfg = JConfig(J_BB, 20, 2, steps, trace.constrain_number())
    return j_eng.DeviceEngine(cfg).prove(trace)


def _port(steps, on_device=True, ntt_backend="radix2"):
    trace = fibonacci_device_trace(BabyBear, steps, on_device=on_device, device="cpu")
    cfg = StarkConfig(BabyBear, 20, 2, steps, trace.constrain_number())
    engine = t_eng.DeviceEngine(cfg, device="cpu", ntt_backend=ntt_backend)
    return engine, trace, engine.prove(trace)


def _host_fri(fri):
    return fri.to_host() if hasattr(fri, "to_host") else fri


def _assert_equal_proofs(ref, dev):
    """tests/test_engine.py::_assert_equal_proofs semantics."""
    assert dev.trace_commit == ref.trace_commit
    assert dev.constrain_trace_commit == ref.constrain_trace_commit
    assert dev.arthur == ref.arthur
    assert dev.constrain_queries == ref.constrain_queries
    assert dev.validity_queries == ref.validity_queries
    dev_fri, ref_fri = _host_fri(dev.fri_proof), _host_fri(ref.fri_proof)
    assert dev_fri.points == ref_fri.points
    assert dev_fri.quotients == ref_fri.quotients
    for r_dev, r_ref in zip(dev_fri.queries, ref_fri.queries):
        for (d1, d2), (h1, h2) in zip(r_dev, r_ref):
            assert d1.leaf_neighbours == h1.leaf_neighbours
            assert d1.path == h1.path
            assert d2.leaf_neighbours == h2.leaf_neighbours
            assert d2.path == h2.path


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("min_size", [1, 8, 32])
@pytest.mark.parametrize("steps", [7, 13])
def test_engine_matches_host_and_jax_engine(monkeypatch, steps, min_size):
    monkeypatch.setattr(j_eng, "DEVICE_MIN_SIZE", min_size)
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", min_size)
    engine, trace, proof = _port(steps)
    _assert_equal_proofs(_host_proof(steps), proof)
    jax_proof = _jax_device_proof(steps)
    _assert_equal_proofs(jax_proof, proof)
    assert proof_digests(BabyBear, proof) == proof_digests(J_BB, jax_proof)
    assert engine.verify(engine.constrain_coeffs(trace), proof)
    if steps == 7:
        assert json.loads(proof_to_json(BabyBear, proof)) == json.load(open(GOLDEN))


def test_copied_host_oracle_matches_jax_host():
    _assert_equal_proofs(_jax_host_proof(13), _host_proof(13))


def test_host_witness_path_and_tampering(monkeypatch):
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 8)
    _, _, a = _port(45, on_device=False)
    engine, trace, b = _port(45)
    _assert_equal_proofs(a, b)
    coeffs = engine.constrain_coeffs(trace)
    assert engine.verify(coeffs, b)
    fields = dict(b.__dict__)
    bad = StarkProof(**{**fields, "arthur": bytes([b.arthur[0] ^ 1]) + b.arthur[1:]})
    with pytest.raises(AssertionError):
        engine.verify(coeffs, bad)
    ext = BabyBear.extension
    v0 = ext.add(b.validity_queries[0], ext.one())
    bad = StarkProof(**{**fields, "validity_queries": [v0] + b.validity_queries[1:]})
    with pytest.raises(AssertionError):
        engine.verify(coeffs, bad)


def test_witness_ladder_matches_jax():
    for steps in (7, 13, 100):
        got = fibonacci_trace_cols_on_device(BabyBear, steps, device="cpu")
        want = j_trace(J_BB, steps).cols
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_from_jax_trace_proves_identically(monkeypatch):
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 8)
    jt = j_trace(J_BB, 13, on_device=True)
    omega = Radix2EvaluationDomain(BabyBear.base, 14).group_gen
    trace = from_jax_trace(jt, _fib_transitions(get_ops(BabyBear.base), omega))
    assert trace.stark_field is BabyBear and trace.cols_dev.dtype == torch.int64
    cfg = StarkConfig(BabyBear, 20, 2, 13, trace.constrain_number())
    a = t_eng.DeviceEngine(cfg, device="cpu").prove(trace)
    _, _, b = _port(13)
    _assert_equal_proofs(a, b)


@pytest.mark.parametrize("backend", ["radix2", "four_step", "pipe"])
def test_parity_proof_matches_jax_at_2_14(backend):
    """Trace iFFT at 2^14, LDE and the first FRI rounds at 2^15 through the
    backend's BabyBear kernels' plain versions."""
    engine, trace, proof = _port((1 << 14) - 1, ntt_backend=backend)
    assert proof_digests(BabyBear, proof) == JAX_BB_16383
    assert engine.verify(engine.constrain_coeffs(trace), proof)
