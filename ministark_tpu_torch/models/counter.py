"""A width-2 affine-counter AIR: col0 walks an arithmetic progression, col1
an affine image of it.

Port of ``ministark_tpu/models/counter.py``: a constant-term transition
polynomial and a configurable width. The host claim (``CounterClaim``) and
the tensor-native trace (``counter_device_trace``) give identical proofs
through either prover.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..air import Provable, TraceTable
from ..ops.field import get_ops
from ..poly import DensePolynomial, Radix2EvaluationDomain
from ..stark.engine import DeviceTrace
from ..utils.rng import ark_test_rng


@dataclass
class CounterClaim(Provable):
    """col0[i] = start + i*step; col1[i] = a*col0[i] + b (all mod p)."""

    field: object
    steps: int
    start: int = 1
    step: int = 3
    a: int = 5
    b: int = 7

    def trace(self, _witness=None) -> TraceTable:
        F = self.field
        trace = TraceTable(F, self.steps, 2)
        omega = trace.omega
        x = F.from_int(self.start)
        for i in range(self.steps):
            trace.add_row(i, [x, F.add(F.mul(F.from_int(self.a), x), F.from_int(self.b))])
            x = F.add(x, F.from_int(self.step))

        trace.add_boundary_constrain(0, 0)
        trace.add_boundary_constrain(self.steps - 1, 1)

        step_c = F.from_int(self.step)
        a_c = F.from_int(self.a)
        b_c = F.from_int(self.b)
        # increment: t0*omega - t0 - step  (same scalar-omega convention as
        # the reference closures, SURVEY §8.2)
        trace.add_transition_constrain(
            lambda tp: tp[0].scale(omega) - tp[0] - DensePolynomial(F, [step_c])
        )
        # affine link: t1 - a*t0 - b
        trace.add_transition_constrain(
            lambda tp: tp[1] - tp[0].scale(a_c) - DensePolynomial(F, [b_c])
        )
        return trace


def _counter_cols_on_device(stark_field, steps, start, step, a, b,
                            device="cuda") -> torch.Tensor:
    """Witness generation on ``device``: the counter trace is closed-form
    (col0[i] = start + i*step, col1[i] = a*col0[i] + b), so the whole
    witness is a few broadcast field ops over ``arange``, with no host loop
    and no upload. Returns the (2, n) int64 column evaluations."""
    base = stark_field.base
    kb = get_ops(base)
    n = Radix2EvaluationDomain(base, steps + 1).size()

    def scalar(v):
        return kb.pack_scalar(base.from_int(v), device)

    idx = torch.arange(n, dtype=torch.int64, device=device)   # i < p: canonical
    col0 = kb.add(scalar(start).expand(n), kb.mul(idx, scalar(step)))
    col1 = kb.add(kb.mul(col0, scalar(a)), scalar(b).expand(n))
    cols = torch.stack([col0, col1])
    pad = kb.pack_scalar(base.rand(ark_test_rng()), device)
    return torch.where(idx < steps, cols, pad)


def counter_device_trace(stark_field, steps: int, start=1, step=3, a=5, b=7,
                         on_device: bool = False, device="cuda") -> DeviceTrace:
    """The counter trace for DeviceEngine and FastStark: columns built on
    ``device`` in closed form (``on_device``), or by the host loop."""
    base = stark_field.base
    kb = get_ops(base)
    domain = Radix2EvaluationDomain(base, steps + 1)
    n = domain.size()
    p = base.p

    cols = cols_dev = None
    if on_device:
        cols_dev = _counter_cols_on_device(stark_field, steps, start, step, a, b,
                                           device)
    else:
        rows = np.empty((n, 2), dtype=np.uint64)
        x = start % p
        for i in range(steps):
            rows[i, 0] = x
            rows[i, 1] = (a * x + b) % p
            x = (x + step) % p
        rows[steps:, :] = base.rand(ark_test_rng())
        cols = np.ascontiguousarray(rows.T)

    def minus_constant(out, c):
        """out - c as polynomials: the constant touches coefficient 0 only."""
        head = kb.sub(out[0:1], kb.pack_scalar(base.from_int(c), out.device)[None])
        return torch.cat([head, out[1:]], 0)

    def t_inc(tp):
        w = kb.pack_scalar(domain.group_gen, tp.device)
        return minus_constant(kb.sub(kb.scale_base(tp[0], w), tp[0]), step)

    def t_affine(tp):
        av = kb.pack_scalar(base.from_int(a), tp.device)
        return minus_constant(kb.sub(tp[1], kb.scale_base(tp[0], av)), b)

    return DeviceTrace(stark_field=stark_field, steps=steps, cols=cols,
                       transitions=[t_inc, t_affine], cols_dev=cols_dev)
