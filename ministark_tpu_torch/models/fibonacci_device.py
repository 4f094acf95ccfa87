"""Tensor-native Fibonacci AIR for the device engine (stark/engine.py).

Port of ``ministark_tpu/models/fibonacci_device.py``: bit-identical traces
and constraints to models/fibonacci.py (the same rows, the same constant ZK
padding row from ``ark_test_rng``, the same three transition constraints
including the duplicated carry constraint, SURVEY §8.2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.field import get_ops
from ..ops.witness import fib_witness
from ..poly import Radix2EvaluationDomain
from ..stark.engine import DeviceTrace
from ..utils.rng import ark_test_rng


def fibonacci_trace_cols_on_device(stark_field, steps: int, secret_b: int = 2,
                                   device="cuda", lo: int = 0,
                                   count: "int | None" = None) -> torch.Tensor:
    """Witness generation on ``device``: row i of the trace is
    M^i [a0; b0] with M = [[0, 1], [1, 1]], so every row comes from an
    exponent-bit ladder of 2x2 matrix powers, with no host loop and no
    upload of the trace (ops/witness.py: one kernel launch on the card,
    torch ops on the CPU).

    Returns rows [lo, lo + count) (default: all n) of the (3, n) column
    evaluations in the field's dtype (rows >= steps carry the deterministic
    ZK padding), bit-identical to the host path."""
    base = stark_field.base
    n = Radix2EvaluationDomain(base, steps + 1).size()
    count = n - lo if count is None else count
    if lo < 0 or count < 0 or lo + count > n:
        raise ValueError(f"rows [{lo}, {lo + count}) of a trace of {n}")
    out = torch.empty((3, count), dtype=get_ops(base).dtype, device=device)
    return fib_witness(out, base, steps, int(base.from_int(secret_b)),
                       int(base.rand(ark_test_rng())), lo)


def fibonacci_device_trace(stark_field, steps: int, secret_b: int = 2,
                           on_device: bool = False, device="cuda") -> DeviceTrace:
    """The Fibonacci trace for DeviceEngine: columns built on ``device``
    with the matrix-power ladder (``on_device``: on demand, a rank of a
    mesh only its own rows), or on the host."""
    base = stark_field.base
    kb = get_ops(base)
    domain = Radix2EvaluationDomain(base, steps + 1)
    n = domain.size()
    transitions = _fib_transitions(kb, domain.group_gen)

    if on_device:
        torch.empty(0, device=device)   # fails here when the device does not exist
        return DeviceTrace(
            stark_field=stark_field, steps=steps, cols=None,
            transitions=transitions, shape=(3, n),
            build=lambda lo, count: fibonacci_trace_cols_on_device(
                stark_field, steps, secret_b, device, lo, count),
        )

    # trace columns (a, b, c): sequential recurrence on host ints
    p = base.p
    a, b = 1, secret_b % p
    c = (a + b) % p
    rows = np.empty((n, 3), dtype=np.uint64)
    for i in range(steps):
        rows[i] = (a, b, c)
        a, b = b, c
        c = (a + b) % p
    # deterministic ZK padding: fresh test_rng per cell => constant value
    rows[steps:, :] = base.rand(ark_test_rng())
    return DeviceTrace(stark_field=stark_field, steps=steps,
                       cols=np.ascontiguousarray(rows.T), transitions=transitions)


def _fib_transitions(kb, omega):
    """(carry, carry, sum): the reference repeats the carry constraint
    a * omega - b verbatim (§8.2), with omega a scalar factor. Both act on
    each coefficient alone, so a block of the coefficients (``rows``, a
    ``parallel.Rows``, on a mesh) maps to the same block of the output."""

    def t_carry(tp, rows=None):
        w = kb.pack_scalar(omega, tp.device)
        return kb.sub(kb.scale_base(tp[0], w), tp[1])

    def t_sum(tp, rows=None):
        return kb.sub(kb.sub(tp[2], tp[0]), tp[1])

    return [t_carry, t_carry, t_sum]
