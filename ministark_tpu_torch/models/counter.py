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
from ..ops.witness import counter_witness
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
                            device="cuda", lo: int = 0,
                            count: "int | None" = None) -> torch.Tensor:
    """Witness generation on ``device``: the counter trace is closed-form
    (col0[i] = start + i*step, col1[i] = a*col0[i] + b), so the witness is
    built with no host loop and no upload (ops/witness.py: one kernel
    launch on the card, a few torch ops on the CPU). Returns rows [lo, lo +
    count) (default: all n) of the (2, n) column evaluations in the field's
    dtype."""
    base = stark_field.base
    n = Radix2EvaluationDomain(base, steps + 1).size()
    count = n - lo if count is None else count
    if lo < 0 or count < 0 or lo + count > n:
        raise ValueError(f"rows [{lo}, {lo + count}) of a trace of {n}")
    out = torch.empty((2, count), dtype=get_ops(base).dtype, device=device)
    return counter_witness(out, base, steps, int(base.from_int(start)),
                           int(base.from_int(step)), int(base.from_int(a)),
                           int(base.from_int(b)), int(base.rand(ark_test_rng())), lo)


def counter_device_trace(stark_field, steps: int, start=1, step=3, a=5, b=7,
                         on_device: bool = False, device="cuda") -> DeviceTrace:
    """The counter trace for DeviceEngine and FastStark: columns built on
    ``device`` in closed form (``on_device``: on demand, a rank of a mesh
    only its own rows), or by the host loop."""
    base = stark_field.base
    kb = get_ops(base)
    domain = Radix2EvaluationDomain(base, steps + 1)
    n = domain.size()
    p = base.p

    cols = build = None
    if on_device:
        torch.empty(0, device=device)   # fails here when the device does not exist

        def build(lo, count):
            return _counter_cols_on_device(stark_field, steps, start, step, a, b,
                                           device, lo, count)
    else:
        rows = np.empty((n, 2), dtype=np.uint64)
        x = start % p
        for i in range(steps):
            rows[i, 0] = x
            rows[i, 1] = (a * x + b) % p
            x = (x + step) % p
        rows[steps:, :] = base.rand(ark_test_rng())
        cols = np.ascontiguousarray(rows.T)

    def minus_constant(out, c, rows):
        """out - c as polynomials: the constant touches coefficient 0 only,
        which a block of the coefficients (``rows`` on a mesh) holds only
        on the rank whose block starts at 0."""
        if rows is not None and rows.lo != 0:
            return out
        head = kb.sub(out[0:1], kb.pack_scalar(base.from_int(c), out.device)[None])
        return torch.cat([head, out[1:]], 0)

    def t_inc(tp, rows=None):
        w = kb.pack_scalar(domain.group_gen, tp.device)
        return minus_constant(kb.sub(kb.scale_base(tp[0], w), tp[0]), step, rows)

    def t_affine(tp, rows=None):
        av = kb.pack_scalar(base.from_int(a), tp.device)
        return minus_constant(kb.sub(tp[1], kb.scale_base(tp[0], av)), b, rows)

    return DeviceTrace(stark_field=stark_field, steps=steps, cols=cols,
                       transitions=[t_inc, t_affine], build=build, shape=(2, n))
