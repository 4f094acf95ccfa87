"""Fibonacci AIR — the reference's e2e "model" (tests/e2e_goldilocks.rs:11-63,
tests/e2e_babybear.rs:11-63), generalized over the field.

3-register Fibonacci with a secret witness ``b``: rows (a, b, c=a+b); four
boundary marks (write-only, SURVEY §8.2) and three transition closures.

Quirks replicated exactly:
* the closures multiply trace polynomials by the *scalar* omega — NOT
  composition f(omega x) (SURVEY §8.2);
* the second transition constraint is a verbatim duplicate of the first
  (the reference's comment says b[1]==c[0] but the code repeats a*omega - b;
  tests/e2e_goldilocks.rs:48-55).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..air import Provable, TraceTable
from ..poly import DensePolynomial


@dataclass
class Witness:
    secret_b: int


@dataclass
class FibonacciClaim(Provable):
    field: object  # base prime field
    step: int      # nth fibonacci number
    output: int

    def trace(self, witness: Witness) -> TraceTable:
        F = self.field
        trace = TraceTable(F, self.step, 3)
        omega = trace.omega

        a = F.one()
        b = F.from_int(witness.secret_b) if isinstance(witness.secret_b, int) else witness.secret_b
        c = F.add(a, b)

        trace.add_boundary_constrain(0, 0)
        trace.add_boundary_constrain(0, 1)
        trace.add_boundary_constrain(0, 2)

        for i in range(trace.step_number()):
            trace.add_row(i, [a, b, c])
            a = b
            b = c
            c = F.add(a, b)

        trace.add_boundary_constrain(self.step - 1, 2)

        # a[1] == b[0]  (scalar-omega quirk, §8.2)
        trace.add_transition_constrain(
            lambda tp: tp[0] * DensePolynomial(F, [omega]) - tp[1]
        )
        # "b[1] == c[0]" — the reference repeats the first constraint verbatim
        trace.add_transition_constrain(
            lambda tp: tp[0] * DensePolynomial(F, [omega]) - tp[1]
        )
        trace.add_transition_constrain(lambda tp: tp[2] - tp[0] - tp[1])

        return trace


def fibonacci_air(stark_field, steps: int, secret_b: int = 2):
    """Convenience: claim + witness for the reference test setup
    (tests/e2e_*.rs:65-75; output value is recorded but unused — "FIXME" in
    the reference)."""
    base = stark_field.base
    witness = Witness(secret_b=base.from_int(secret_b))
    claim = FibonacciClaim(field=base, step=steps, output=base.from_int(13))
    return claim, witness
