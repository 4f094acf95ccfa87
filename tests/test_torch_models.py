"""The counter, LFSR and MiMC AIRs of the port (models/{counter,lfsr,mimc}.py)
on the CPU: each model over both fields proves through ``DeviceEngine`` to
the bytes of the host oracle ``Stark.prove`` and of ministark_tpu's
``DeviceEngine``; MiMC and LFSR prove through ``FastStark`` to the JAX
package's proof bytes; the counter's on-device witness equals the host
one. Mirrors tests/test_{counter,lfsr,mimc}_model.py. Tolerance 0."""

import numpy as np
import pytest
import torch

import ministark_tpu.stark.engine as j_eng
import ministark_tpu_torch.stark.engine as t_eng
from ministark_tpu.fields import BabyBear as J_BB
from ministark_tpu.fields import Goldilocks as J_GL
from ministark_tpu.models.counter import counter_device_trace as j_counter
from ministark_tpu.models.lfsr import lfsr_device_trace as j_lfsr
from ministark_tpu.models.mimc import mimc_device_trace as j_mimc
from ministark_tpu.stark import StarkConfig as JConfig
from ministark_tpu.stark.fast import FastStark as JFastStark
from ministark_tpu.stark.fast import FastStarkConfig as JFastConfig
from ministark_tpu.stark.proof_io import fast_proof_to_bytes as j_to_bytes
from ministark_tpu_torch.convert import from_jax_packed, from_jax_trace
from ministark_tpu_torch.fields import BabyBear, Goldilocks
from ministark_tpu_torch.models import counter, lfsr, mimc
from ministark_tpu_torch.ops.field import unpack_u64
from ministark_tpu_torch.stark import Stark, StarkConfig
from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_digests

torch.set_num_threads(1)
FIELDS = {"goldilocks": (Goldilocks, J_GL), "babybear": (BabyBear, J_BB)}


def _case(model, sf, steps):
    """(host claim, witness, the port's device trace on the CPU)."""
    base = sf.base
    if model == "counter":
        return (counter.CounterClaim(field=base, steps=steps), None,
                counter.counter_device_trace(sf, steps, on_device=True, device="cpu"))
    if model == "lfsr":
        return (lfsr.LfsrClaim(field=base, steps=steps), None,
                lfsr.lfsr_device_trace(sf, steps, device="cpu"))
    out = mimc.mimc_chain_output(base.p, steps, 3)
    return (mimc.MimcClaim(field=base, steps=steps, output=out),
            mimc.MimcWitness(s0=3), mimc.mimc_device_trace(sf, steps, device="cpu"))


def _jax_trace(model, jsf, steps):
    return {"counter": lambda: j_counter(jsf, steps, on_device=True),
            "lfsr": lambda: j_lfsr(jsf, steps),
            "mimc": lambda: j_mimc(jsf, steps, 3)}[model]()


def _assert_equal_proofs(ref, dev):
    assert dev.trace_commit == ref.trace_commit
    assert dev.constrain_trace_commit == ref.constrain_trace_commit
    assert dev.arthur == ref.arthur
    assert dev.constrain_queries == ref.constrain_queries
    assert dev.validity_queries == ref.validity_queries
    dfri, rfri = (p.fri_proof.to_host() if hasattr(p.fri_proof, "to_host")
                  else p.fri_proof for p in (dev, ref))
    assert dfri.points == rfri.points and dfri.quotients == rfri.quotients
    for r_dev, r_ref in zip(dfri.queries, rfri.queries):
        for (d1, d2), (h1, h2) in zip(r_dev, r_ref):
            assert d1.leaf_neighbours == h1.leaf_neighbours and d1.path == h1.path
            assert d2.leaf_neighbours == h2.leaf_neighbours and d2.path == h2.path


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
@pytest.mark.parametrize("model,steps", [("counter", 21), ("lfsr", 25), ("mimc", 25)])
def test_engine_matches_host_and_jax(monkeypatch, model, steps, field):
    """The port with DEVICE_MIN_SIZE 8 (its first FRI rounds run as tensors,
    the tail on host scalars); the JAX engine keeps its default, which
    changes no byte and spares its per-size compiles."""
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 8)
    sf, jsf = FIELDS[field]
    claim, witness, trace = _case(model, sf, steps)
    host_trace = claim.trace(witness)
    assert trace.constrain_number() == host_trace.constrain_number()
    cfg = StarkConfig(sf, 20, 2, steps, trace.constrain_number())
    host = Stark(cfg).prove(claim, witness)
    engine = t_eng.DeviceEngine(cfg, device="cpu")
    proof = engine.prove(trace)
    _assert_equal_proofs(host, proof)
    assert engine.verify(engine.constrain_coeffs(trace), proof)

    jtrace = _jax_trace(model, jsf, steps)
    jproof = j_eng.DeviceEngine(
        JConfig(jsf, 20, 2, steps, jtrace.constrain_number())).prove(jtrace)
    assert proof_digests(sf, jproof) == proof_digests(sf, proof)
    # the JAX trace's columns under this package's closures prove the same
    carried = from_jax_trace(jtrace, trace.transitions, device="cpu")
    assert proof_digests(sf, engine.prove(carried)) == proof_digests(sf, proof)


@pytest.mark.parametrize("model,width", [("mimc", 2), ("lfsr", 8)])
def test_fast_stark_matches_jax(model, width):
    steps, kw = 100, dict(queries=8, final_len=8)
    jstark = JFastStark(JFastConfig(J_GL, steps, **kw))
    jtrace = _jax_trace(model, J_GL, steps)
    jblob = j_to_bytes(J_GL, jstark.prove(jtrace))
    _, _, trace = _case(model, Goldilocks, steps)
    stark = FastStark(FastStarkConfig(Goldilocks, steps, **kw), device="cpu")
    proof = stark.prove(trace)
    assert proof.width == width and proof.transitions == width
    assert fast_proof_to_bytes(Goldilocks, proof) == jblob
    cons = stark._constraint_polys(trace)
    assert torch.equal(cons, from_jax_packed(
        np.asarray(jstark._constraint_polys(jtrace)), Goldilocks.base))
    assert stark.verify(cons, proof)


@pytest.mark.parametrize("field,steps", [("goldilocks", 21), ("babybear", 13)])
def test_counter_on_device_witness_matches_host(field, steps):
    sf, jsf = FIELDS[field]
    host = counter.counter_device_trace(sf, steps, device="cpu")
    dev = counter.counter_device_trace(sf, steps, on_device=True, device="cpu")
    assert host.cols_dev is None and dev.cols is None
    assert np.array_equal(unpack_u64(dev.cols_dev), host.cols)
    assert np.array_equal(host.cols, j_counter(jsf, steps).cols)


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_host_columns_match_jax(field):
    sf, jsf = FIELDS[field]
    assert np.array_equal(unpack_u64(lfsr.lfsr_device_trace(sf, 25, device="cpu").cols_dev),
                          j_lfsr(jsf, 25).cols)
    assert np.array_equal(unpack_u64(mimc.mimc_device_trace(sf, 25, device="cpu").cols_dev),
                          j_mimc(jsf, 25, 3).cols)
    assert lfsr.mix_matrix()[3][5] == ((3 + 1) * (5 + 2) + 3 * 3 + 5) % 11 + 1


def test_mimc_chain_and_constants():
    p = Goldilocks.base.p
    assert mimc.round_constant(5, p) == 167
    s = 3
    for i in range(9):
        s = pow((s + mimc.round_constant(i, p)) % p, 3, p)
    assert mimc.mimc_chain_output(p, 9, 3) == s
    bp = BabyBear.base.p
    want = [mimc.round_constant(i, bp) for i in range(64)]
    assert [int(v) for v in mimc._round_constants(64, bp)] == want


def test_device_models_need_a_device_when_asked_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: lfsr.lfsr_device_trace(Goldilocks, 9),
                 lambda: mimc.mimc_device_trace(Goldilocks, 9),
                 lambda: counter.counter_device_trace(Goldilocks, 9, on_device=True)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()
