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
from ..poly import Radix2EvaluationDomain
from ..stark.engine import DeviceTrace
from ..utils.rng import ark_test_rng


def fibonacci_trace_cols_on_device(stark_field, steps: int, secret_b: int = 2,
                                   device="cuda") -> torch.Tensor:
    """Witness generation on ``device``: row i of the trace is
    M^i [a0; b0] with M = [[0, 1], [1, 1]], so every row comes from an
    exponent-bit ladder of 2x2 matrix powers in log2(n) steps, with no host
    loop and no upload of the trace.

    Returns the (3, n) int64 column evaluations (rows >= steps carry the
    deterministic ZK padding), bit-identical to the host path."""
    base = stark_field.base
    kb = get_ops(base)
    n = Radix2EvaluationDomain(base, steps + 1).size()

    def scalar(v):
        return kb.pack_scalar(base.from_int(v), device)

    def mat_mul(A, B):
        return [[kb.add(kb.mul(A[r][0], B[0][c]), kb.mul(A[r][1], B[1][c]))
                 for c in range(2)] for r in range(2)]

    idx = torch.arange(n, device=device)
    one = torch.ones(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(one)
    Mp = [[one, zero], [zero, one]]                       # M^(idx & (2^b - 1))
    M2 = [[scalar(0), scalar(1)], [scalar(1), scalar(1)]]  # M^(2^b)
    for b in range(max((n - 1).bit_length(), 1)):
        bit = ((idx >> b) & 1) == 1
        prod = mat_mul(Mp, M2)
        Mp = [[torch.where(bit, prod[r][c], Mp[r][c]) for c in range(2)]
              for r in range(2)]
        M2 = mat_mul(M2, M2)
    a0, b0 = scalar(1), scalar(secret_b)
    a = kb.add(kb.mul(Mp[0][0], a0), kb.mul(Mp[0][1], b0))
    bcol = kb.add(kb.mul(Mp[1][0], a0), kb.mul(Mp[1][1], b0))
    cols = torch.stack([a, bcol, kb.add(a, bcol)])       # (3, n)
    # deterministic ZK padding rows (one constant value)
    pad = kb.pack_scalar(base.rand(ark_test_rng()), device)
    return torch.where(idx < steps, cols, pad)


def fibonacci_device_trace(stark_field, steps: int, secret_b: int = 2,
                           on_device: bool = False, device="cuda") -> DeviceTrace:
    """The Fibonacci trace for DeviceEngine: columns built on ``device``
    with the matrix-power ladder (``on_device``), or on the host."""
    base = stark_field.base
    kb = get_ops(base)
    domain = Radix2EvaluationDomain(base, steps + 1)
    n = domain.size()
    transitions = _fib_transitions(kb, domain.group_gen)

    if on_device:
        return DeviceTrace(
            stark_field=stark_field, steps=steps, cols=None,
            transitions=transitions,
            cols_dev=fibonacci_trace_cols_on_device(stark_field, steps,
                                                    secret_b, device),
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
    a * omega - b verbatim (§8.2), with omega a scalar factor."""

    def t_carry(tp):
        w = kb.pack_scalar(omega, tp.device)
        return kb.sub(kb.scale_base(tp[0], w), tp[1])

    def t_sum(tp):
        return kb.sub(kb.sub(tp[2], tp[0]), tp[1])

    return [t_carry, t_carry, t_sum]
