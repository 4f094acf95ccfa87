"""A width-8 linear-state machine ("LFSR mixer"): s_{i+1} = A s_i for a fixed
8x8 mixing matrix.

Port of ``ministark_tpu/models/lfsr.py``: a wide trace (8 columns + 8
transition constraints, so 16-way leaf groups in the trace commitment and
batch-16 NTTs). Transitions follow the reference's closure convention
(linear combinations of the trace polynomials with the scalar-omega quirk,
SURVEY §8.2): t_j = sum_k A[j][k] * P_k - omega * P_j. The host claim and
the tensor-native trace give identical proofs through either prover.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..air import Provable, TraceTable
from ..ops.field import get_ops, pack_u64
from ..poly import Radix2EvaluationDomain
from ..stark.engine import DeviceTrace
from ..utils.rng import ark_test_rng

WIDTH = 8


def mix_matrix():
    """Fixed 8x8 mixing matrix with small nonzero entries."""
    return [[((j + 1) * (k + 2) + 3 * j + k) % 11 + 1 for k in range(WIDTH)]
            for j in range(WIDTH)]


@dataclass
class LfsrClaim(Provable):
    field: object
    steps: int
    seed: int = 7

    def trace(self, _witness=None) -> TraceTable:
        F = self.field
        A = mix_matrix()
        trace = TraceTable(F, self.steps, WIDTH)
        omega = trace.omega
        s = [F.from_int(self.seed + j) for j in range(WIDTH)]
        for i in range(self.steps):
            trace.add_row(i, list(s))
            s = [
                _dot(F, A[j], s)
                for j in range(WIDTH)
            ]

        trace.add_boundary_constrain(0, 0)
        trace.add_boundary_constrain(self.steps - 1, WIDTH - 1)

        for j in range(WIDTH):
            def t(tp, j=j):
                acc = tp[0].scale(F.from_int(A[j][0]))
                for k in range(1, WIDTH):
                    acc = acc + tp[k].scale(F.from_int(A[j][k]))
                return acc - tp[j].scale(omega)
            trace.add_transition_constrain(t)
        return trace


def _dot(F, row, s):
    acc = F.zero()
    for k in range(WIDTH):
        acc = F.add(acc, F.mul(F.from_int(row[k]), s[k]))
    return acc


def lfsr_device_trace(stark_field, steps: int, seed: int = 7,
                      device="cuda") -> DeviceTrace:
    """The LFSR trace for DeviceEngine and FastStark (same rows, padding
    and closures as ``LfsrClaim.trace``): the recurrence runs on the host
    and the columns are put on ``device``."""
    base = stark_field.base
    kb = get_ops(base)
    domain = Radix2EvaluationDomain(base, steps + 1)
    n = domain.size()
    p = base.p
    A = mix_matrix()

    rows = np.empty((n, WIDTH), dtype=np.uint64)
    s = [(seed + j) % p for j in range(WIDTH)]
    for i in range(steps):
        rows[i] = s
        s = [sum(A[j][k] * s[k] for k in range(WIDTH)) % p for j in range(WIDTH)]
    rows[steps:, :] = base.rand(ark_test_rng())
    cols_dev = pack_u64(np.ascontiguousarray(rows.T), device)

    def make_t(j):
        def t(tp):
            def scalar(v):
                return kb.pack_scalar(v, tp.device)

            acc = kb.scale_base(tp[0], scalar(base.from_int(A[j][0])))
            for k in range(1, WIDTH):
                acc = kb.add(acc, kb.scale_base(tp[k], scalar(base.from_int(A[j][k]))))
            return kb.sub(acc, kb.scale_base(tp[j], scalar(domain.group_gen)))
        return t

    return DeviceTrace(stark_field=stark_field, steps=steps, cols=None,
                       transitions=[make_t(j) for j in range(WIDTH)],
                       cols_dev=cols_dev)
