"""A run with the timed path broken underneath it comes out not correct:
once for each fault a prove_many cell can have. (The exchange between
chips has no place in a one-chip cell.)"""

import pytest

from benchmark import harness
from benchmark.systems.fast_stark import System


class AlteredAnswer(System):
    """A byte of the first opened row flipped as the proof is handed over."""

    def call(self, secrets):
        proof = super().call(secrets)
        path = proof.fri_proof.batch_openings[0][0]
        path.row = bytes([path.row[0] ^ 1]) + path.row[1:]
        return proof


class HalfBatch(System):
    """Half of the call's traces left out of the proof."""

    def call(self, secrets):
        return super().call(secrets[:len(secrets) // 2])


class Unchanged(System):
    """The state never moves on: every call returns the first proof."""

    first = None

    def call(self, secrets):
        if self.first is None:
            self.first = super().call(secrets)
        return self.first


@pytest.mark.parametrize("fault,kind", [(AlteredAnswer, "openings"), (HalfBatch, "shape"),
                                        (Unchanged, "roots")])
def test_fault_is_not_correct(tiny, fault, kind):
    cell = harness.load_cell("fast_gl_seg22_b4", *tiny)
    result = harness.run_cell(cell, 2**31 + 5, 0.01, False, device="cpu", system=fault)
    assert result["correct"] is False
    assert result["checks"][f"{kind}_differing"]["value"] > 0
