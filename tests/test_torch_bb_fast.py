"""The port's fast mode over BabyBear + Fp4 on the CPU: FastStark's proof
bytes, single trace (tests/test_fast_stark.py:21's configuration) and
prove_many, equal to ministark_tpu's FastStark and cross-verified, tampering
rejected, and every NTT backend giving the radix-2 bytes at 2^14 - 1 (its
component NTT runs over the prime field, BabyBear)."""

import copy

import numpy as np
import pytest
import torch

from ministark_tpu.fields import BabyBear as J_BB
from ministark_tpu.models.fibonacci_device import fibonacci_device_trace as j_trace
from ministark_tpu.stark.fast import FastStark as JFastStark
from ministark_tpu.stark.fast import FastStarkConfig as JFastConfig
from ministark_tpu.stark.proof_io import fast_proof_from_bytes as j_from_bytes
from ministark_tpu.stark.proof_io import fast_proof_to_bytes as j_to_bytes
from ministark_tpu_torch.convert import from_jax_packed
from ministark_tpu_torch.fields import BABYBEAR_FP, BabyBear
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
from ministark_tpu_torch.stark.proof_io import fast_proof_from_bytes, fast_proof_to_bytes

FAST_77 = dict(queries=8, point_queries=2, arity=4, final_len=8)  # test_fast_stark.py:21


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run side by side: one intra-op thread each
    keeps the plain torch ops from contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fast(steps, backend="radix2", **kw):
    return FastStark(FastStarkConfig(BabyBear, steps, **kw), device="cpu",
                     ntt_backend=backend)


def _fast_trace(steps, secret_b=2):
    return fibonacci_device_trace(BabyBear, steps, secret_b, on_device=True,
                                  device="cpu")


def test_fast_proof_matches_jax_and_cross_verifies():
    jstark = JFastStark(JFastConfig(J_BB, 77, **FAST_77))
    jtrace = j_trace(J_BB, 77)
    jblob = j_to_bytes(J_BB, jstark.prove(jtrace))
    stark, trace = _fast(77, **FAST_77), _fast_trace(77)
    proof = stark.prove(trace)
    blob = fast_proof_to_bytes(BabyBear, proof)
    assert blob == jblob
    jcons = np.asarray(jstark._constraint_polys(jtrace))
    cons = stark._constraint_polys(trace)
    assert torch.equal(cons, from_jax_packed(jcons, BabyBear.base))
    assert stark.verify(cons, fast_proof_from_bytes(BabyBear, jblob))
    assert jstark.verify(jcons, j_from_bytes(J_BB, blob))
    assert proof.size_bytes() < 200_000
    bad = copy.deepcopy(proof)
    row = bytearray(bad.fri_proof.batch_openings[0][0].row)
    row[3] ^= 0x10
    bad.fri_proof.batch_openings[0][0].row = bytes(row)
    with pytest.raises(AssertionError):
        stark.verify(cons, bad)
    with pytest.raises(AssertionError):
        stark.verify(stark._constraint_polys(_fast_trace(77, 99)), proof)


def test_fast_prove_many_matches_jax():
    jstark = JFastStark(JFastConfig(J_BB, 77, **FAST_77))
    jblob = j_to_bytes(J_BB, jstark.prove_many(
        [j_trace(J_BB, 77, secret_b=b) for b in (2, 5, 9)]))
    stark = _fast(77, **FAST_77)
    traces = [_fast_trace(77, b) for b in (2, 5, 9)]
    proof = stark.prove_many(traces)
    blob = fast_proof_to_bytes(BabyBear, proof)
    assert blob == jblob and proof.n_traces == 3
    assert stark.verify_many([stark._constraint_polys(t) for t in traces],
                             fast_proof_from_bytes(BabyBear, blob))


@pytest.mark.parametrize("backend", ["four_step", "pipe"])
def test_fast_backends_give_the_radix2_bytes_at_2_14(backend):
    steps = (1 << 14) - 1
    trace = _fast_trace(steps)
    blobs = [fast_proof_to_bytes(BabyBear, _fast(steps, b).prove(trace))
             for b in ("radix2", backend)]
    assert blobs[0] == blobs[1]


def test_fast_ntt_runs_over_the_prime_field():
    """BabyBear Fp4's base_field is Fp2; the component NTT walks down to
    BabyBear itself."""
    assert _fast(77, **FAST_77).fri._ntt_base is BABYBEAR_FP
