"""The port's DeviceEngine on the CPU, end to end: its proofs must be
byte-identical to ministark_tpu's DeviceEngine and to the host prover
Stark.prove, equal to the golden fixture, and verify."""

import json
import os

import numpy as np
import pytest
import torch

import ministark_tpu.stark.engine as j_eng
import ministark_tpu_torch.stark.engine as t_eng
from ministark_tpu.fields import Goldilocks as J_GL
from ministark_tpu.models import FibonacciClaim as JClaim
from ministark_tpu.models import Witness as JWitness
from ministark_tpu.models.fibonacci_device import fibonacci_device_trace as j_trace
from ministark_tpu.stark import Stark as JStark
from ministark_tpu.stark import StarkConfig as JConfig
from ministark_tpu_torch.convert import from_jax_trace
from ministark_tpu_torch.fields import Goldilocks
from ministark_tpu_torch.models import fibonacci_air
from ministark_tpu_torch.models.fibonacci_device import (
    _fib_transitions,
    fibonacci_device_trace,
    fibonacci_trace_cols_on_device,
)
from ministark_tpu_torch.ops.field import get_ops
from ministark_tpu_torch.poly import Radix2EvaluationDomain
from ministark_tpu_torch.stark import Stark, StarkConfig, StarkProof
from ministark_tpu_torch.stark.proof_io import proof_digests, proof_to_json

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "goldilocks_fib9.json")


def _jax_host_proof(steps):
    base = J_GL.base
    witness = JWitness(secret_b=base.from_int(2))
    claim = JClaim(field=base, step=steps, output=base.from_int(13))
    cfg = JConfig(J_GL, 20, 2, steps, claim.trace(witness).constrain_number())
    return JStark(cfg).prove(claim, witness)


def _jax_device_proof(steps):
    trace = j_trace(J_GL, steps)
    cfg = JConfig(J_GL, 20, 2, steps, trace.constrain_number())
    return j_eng.DeviceEngine(cfg).prove(trace)


def _port(steps, on_device=True):
    trace = fibonacci_device_trace(Goldilocks, steps, on_device=on_device,
                                   device="cpu")
    cfg = StarkConfig(Goldilocks, 20, 2, steps, trace.constrain_number())
    engine = t_eng.DeviceEngine(cfg, device="cpu")
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
    for r_dev, r_ref in zip(dev_fri.quotients, ref_fri.quotients):
        assert r_dev == r_ref
    for r_dev, r_ref in zip(dev_fri.queries, ref_fri.queries):
        for (d1, d2), (h1, h2) in zip(r_dev, r_ref):
            assert d1.leaf_neighbours == h1.leaf_neighbours
            assert d1.path == h1.path
            assert d2.leaf_neighbours == h2.leaf_neighbours
            assert d2.path == h2.path


@pytest.mark.parametrize("steps,min_size", [(9, 1), (61, 32), (61, None)])
def test_engine_matches_jax_engine_and_host(monkeypatch, steps, min_size):
    if min_size is not None:
        monkeypatch.setattr(j_eng, "DEVICE_MIN_SIZE", min_size)
        monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", min_size)
    _, _, proof = _port(steps)
    _assert_equal_proofs(_jax_host_proof(steps), proof)
    jax_proof = _jax_device_proof(steps)
    _assert_equal_proofs(jax_proof, proof)
    assert proof_digests(Goldilocks, proof) == proof_digests(J_GL, jax_proof)


def test_host_witness_path_matches(monkeypatch):
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 8)
    _, _, a = _port(61, on_device=False)
    _, _, b = _port(61, on_device=True)
    _assert_equal_proofs(a, b)


def test_copied_host_oracle_matches_jax_host():
    claim, witness = fibonacci_air(Goldilocks, 9)
    cfg = StarkConfig(Goldilocks, 20, 2, 9, claim.trace(witness).constrain_number())
    _assert_equal_proofs(_jax_host_proof(9), Stark(cfg).prove(claim, witness))


def test_proof_matches_golden_fixture(monkeypatch):
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 1)
    _, _, proof = _port(9)
    assert json.loads(proof_to_json(Goldilocks, proof)) == json.load(open(GOLDEN))


def test_verify_and_tampering(monkeypatch):
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 32)
    engine, trace, proof = _port(61)
    coeffs = engine.constrain_coeffs(trace)
    assert engine.verify(coeffs, proof)
    fields = dict(proof.__dict__)
    bad_arthur = StarkProof(**{**fields, "arthur": bytes([proof.arthur[0] ^ 1])
                               + proof.arthur[1:]})
    with pytest.raises(AssertionError):
        engine.verify(coeffs, bad_arthur)
    ext = Goldilocks.extension
    v0 = ext.add(proof.validity_queries[0], ext.one())
    bad_validity = StarkProof(**{**fields, "validity_queries":
                                 [v0] + proof.validity_queries[1:]})
    with pytest.raises(AssertionError):
        engine.verify(coeffs, bad_validity)


def test_witness_ladder_matches_jax():
    for steps in (9, 61, 100):
        got = fibonacci_trace_cols_on_device(Goldilocks, steps, device="cpu")
        want = j_trace(J_GL, steps).cols
        assert np.array_equal(got.numpy().view(np.uint64), want)


def test_from_jax_trace_proves_identically(monkeypatch):
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 8)
    jt = j_trace(J_GL, 61)
    omega = Radix2EvaluationDomain(Goldilocks.base, 62).group_gen
    trace = from_jax_trace(jt, _fib_transitions(get_ops(Goldilocks.base), omega))
    assert trace.stark_field is Goldilocks
    cfg = StarkConfig(Goldilocks, 20, 2, 61, trace.constrain_number())
    a = t_eng.DeviceEngine(cfg, device="cpu").prove(trace)
    _, _, b = _port(61)
    _assert_equal_proofs(a, b)


def test_leaf_not_found_guard(monkeypatch):
    """A value search that misses must raise LeafNotFound before any gather
    (on a card, a gather past the end is a device-side fault)."""
    from ministark_tpu_torch.commit import packed_tree
    from ministark_tpu_torch.utils import LeafNotFound

    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 1)

    def miss(self, rows):
        return torch.full((rows.shape[0],), self.n_leafs, dtype=torch.int64)

    monkeypatch.setattr(packed_tree.PackedMerkleTree, "search_rows_async", miss)
    with pytest.raises(LeafNotFound):
        _port(9)
