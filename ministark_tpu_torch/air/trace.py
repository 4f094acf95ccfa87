"""AIR frontend: execution traces, constraints, and the ``Provable`` interface.

Mirrors src/air.rs:9-186 semantics exactly:

* ``TraceTable.new(steps, registers)`` allocates a power-of-two domain of size
  ``next_pow2(steps + 1)`` and fills every row index >= steps with the
  deterministic "ZK" random padding — a *fresh* ``ark_std::test_rng()`` per
  cell, so all padding cells share one value (src/air.rs:77-83; SURVEY §8.7);
* boundary constraints are recorded but never used by the prover
  (src/air.rs:114-117; SURVEY §8.2) — kept write-only here too;
* transition constraints are callables mapping the list of trace polynomials
  to a constraint polynomial (the reference's boxed closures, src/air.rs:61);
* ``derive_constrains`` returns trace polynomials ++ transition outputs
  (src/air.rs:127-144);
* ``get_trace_polys`` interpolates each column over the trace domain
  (iFFT, src/air.rs:147-160).

This is the host oracle: every column is interpolated with the host domain
iFFT. The device engine (stark/engine.py) carries its own column NTT.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from ..poly import DensePolynomial, Radix2EvaluationDomain
from ..utils import is_power_of_two
from ..utils.rng import ark_test_rng

Constrain = Callable[[List[DensePolynomial]], DensePolynomial]


class Matrix:
    """Row-major scalar matrix (src/air.rs:15-59)."""

    def __init__(self, length: int, width: int, entries: Optional[List] = None, zero=0):
        assert is_power_of_two(length)
        if entries is not None:
            assert len(entries) == length * width
            self.data = list(entries)
        else:
            self.data = [zero] * (length * width)
        self.length = length
        self.width = width

    def get_data(self) -> List:
        return self.data

    def get_value(self, row: int, col: int):
        assert row < self.length and col < self.width
        return self.data[row * self.width + col]

    def is_empty(self) -> bool:
        return self.length == 0 or self.width == 0

    def add_col(self, index: int, col: Sequence) -> None:
        assert len(col) == self.length
        assert index < self.width
        for i, val in enumerate(col):
            self.data[i * self.width + index] = val


class TraceTable:
    """src/air.rs:63-161."""

    def __init__(self, field, steps: int, registers: int):
        self.field = field
        domain = Radix2EvaluationDomain(field, steps + 1)
        self.domain = domain
        self.omega = domain.group_gen
        self.steps = steps

        size = domain.size()
        data = [field.zero()] * (steps * registers)
        # ZK padding: F::rand(&mut test_rng()) per cell — fresh RNG each time
        padding_length = (size - steps) * registers
        data.extend(field.rand(ark_test_rng()) for _ in range(padding_length))
        self.trace = Matrix(size, registers, data, zero=field.zero())

        self.boundaries: List = []  # write-only (§8.2)
        self.transition_constrains: List[Constrain] = []

    def step_number(self) -> int:
        return self.steps

    def get_domain(self) -> Radix2EvaluationDomain:
        return self.domain

    def width(self) -> int:
        return self.trace.width

    def add_row(self, index: int, row: Sequence) -> None:
        assert len(row) == self.trace.width
        assert index < self.steps
        for j, val in enumerate(row):
            self.trace.data[index * self.trace.width + j] = val

    def add_boundary_constrain(self, row: int, col: int) -> None:
        assert row < self.steps and col < self.trace.width
        self.boundaries.append((row, col))

    def add_transition_constrain(self, f: Constrain) -> None:
        self.transition_constrains.append(f)

    def constrain_number(self) -> int:
        return self.trace.width + len(self.transition_constrains)

    def get_trace_polys(self) -> List[DensePolynomial]:
        F = self.field
        polys = []
        n = self.trace.length
        for i in range(self.trace.width):
            evals = [self.trace.get_value(j, i) for j in range(n)]
            coeffs = self.domain.ifft(evals)
            polys.append(DensePolynomial(F, coeffs))
        return polys

    def derive_constrains(self) -> "Constrains":
        constrains = self.get_trace_polys()
        transition_evals = [f(constrains) for f in self.transition_constrains]
        trace_num = self.trace.width
        transition_num = len(transition_evals)
        constrains = constrains + transition_evals
        return Constrains(trace_num, transition_num, constrains)


class Constrains:
    """src/air.rs:163-186."""

    def __init__(self, trace_constrains_num, transition_constrains_num, constrains):
        self.trace_constrains_num = trace_constrains_num
        self.transition_constrains_num = transition_constrains_num
        self.constrains = constrains

    def __len__(self) -> int:
        return len(self.constrains)

    def is_empty(self) -> bool:
        return len(self.constrains) == 0

    def get_constrain_poly(self, col: int) -> DensePolynomial:
        assert col < self.trace_constrains_num + self.transition_constrains_num
        return self.constrains[col]

    def get_polynomials(self) -> List[DensePolynomial]:
        return list(self.constrains)


class Provable:
    """``Provable<W, F>`` trait (src/air.rs:9-12)."""

    def trace(self, witness) -> TraceTable:
        raise NotImplementedError
