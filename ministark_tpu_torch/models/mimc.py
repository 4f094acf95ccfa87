"""A MiMC-style cubing hash chain: the model with a nonlinear transition
constraint.

Port of ``ministark_tpu/models/mimc.py``. State s evolves by the MiMC round
function s_{i+1} = (s_i + k_i)^3 with a fixed public round-constant
schedule k_i. The trace has width 2: row i is (s_i, u_i) with
u_i = (s_i + k_i)^3 and s_{i+1} = u_i. The chain input s_0 is the secret
witness (hash-preimage claim).

The protocol consumes transitions as opaque closures mapping trace
polynomials to one constraint polynomial, so a degree-d constraint is
represented by its degree < N interpolant over the trace domain: evaluate
the trace polynomials over the domain, apply the nonlinear map pointwise,
interpolate back (FFT -> pointwise cube -> iFFT). On the card the closure
launches the NTT kernels and, over Goldilocks, the ``gl_mul`` kernel.

Transitions:
  t0 (cubic, intra-row): interp over the trace domain of (e0 + K)^3 - e1,
     where e0/e1 are the column evaluations and K the round-constant
     evaluations (defined for every domain row, including ZK padding rows).
  t1 (linear link): P1.scale(omega) - P0, following the reference's
     scalar-omega closure convention (SURVEY §8.2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..air import Provable, TraceTable
from ..ops.field import get_ops, pack_u64
from ..ops.ntt import get_ntt_fns
from ..poly import DensePolynomial, Radix2EvaluationDomain
from ..stark.engine import DeviceTrace
from ..utils.rng import ark_test_rng

WIDTH = 2


def round_constant(i: int, p: int) -> int:
    """Public MiMC round-constant schedule: k_i = (i^3 + 42) mod p."""
    return (i * i * i + 42) % p


def mimc_chain_output(p: int, steps: int, s0: int) -> int:
    """Host oracle: run the chain steps times, return the final state."""
    s = s0 % p
    for i in range(steps):
        s = pow((s + round_constant(i, p)) % p, 3, p)
    return s


@dataclass
class MimcWitness:
    s0: int  # secret chain input (the hash preimage)


@dataclass
class MimcClaim(Provable):
    field: object  # base prime field
    steps: int
    output: int    # claimed chain output (recorded; unused, like the
                   # reference's Fibonacci "FIXME" output)

    def trace(self, witness: MimcWitness) -> TraceTable:
        F = self.field
        p = F.p
        trace = TraceTable(F, self.steps, WIDTH)
        omega = trace.omega
        domain = trace.get_domain()
        n = domain.size()

        s = witness.s0 % p
        for i in range(self.steps):
            u = pow((s + round_constant(i, p)) % p, 3, p)
            trace.add_row(i, [F.from_int(s), F.from_int(u)])
            s = u

        trace.add_boundary_constrain(0, 0)
        trace.add_boundary_constrain(self.steps - 1, 1)

        k_evals = [F.from_int(round_constant(i, p)) for i in range(n)]

        def cubic(tp):
            e0 = tp[0].evaluate_over_domain(domain)
            e1 = tp[1].evaluate_over_domain(domain)
            c = []
            for i in range(n):
                t = F.add(e0[i], k_evals[i])
                c.append(F.sub(F.mul(F.mul(t, t), t), e1[i]))
            return DensePolynomial(F, domain.ifft(c))

        trace.add_transition_constrain(cubic)
        trace.add_transition_constrain(
            lambda tp: tp[1].scale(omega) - tp[0]
        )
        return trace


def _round_constants(n: int, p: int) -> np.ndarray:
    """[k_0 .. k_(n-1)] as uint64: in bulk while i^3 + 42 fits 64 bits."""
    if n <= 1 << 21:
        i = np.arange(n, dtype=np.uint64)
        return (i * i * i + np.uint64(42)) % np.uint64(p)
    return np.array([round_constant(i, p) for i in range(n)], dtype=np.uint64)


def mimc_device_trace(stark_field, steps: int, s0: int = 3,
                      device="cuda") -> DeviceTrace:
    """The MiMC trace for DeviceEngine and FastStark (same rows, padding
    and closures as ``MimcClaim.trace``, so byte-identical proofs): the
    chain runs on the host and the columns are put on ``device``."""
    base = stark_field.base
    p = base.p
    kb = get_ops(base)
    domain = Radix2EvaluationDomain(base, steps + 1)
    n = domain.size()

    rows = np.empty((n, WIDTH), dtype=np.uint64)
    s = s0 % p
    for i in range(steps):
        u = pow((s + round_constant(i, p)) % p, 3, p)
        rows[i] = (s, u)
        s = u
    rows[steps:, :] = base.rand(ark_test_rng())
    cols_dev = pack_u64(np.ascontiguousarray(rows.T), device)
    k_dev = pack_u64(_round_constants(n, p), device)

    def cubic(tp):
        fft, ifft, _, _ = get_ntt_fns(base, n)
        evs = fft(tp[:2].contiguous())           # (2, n) column evaluations
        t = kb.add(evs[0], k_dev.to(tp.device))
        c = kb.sub(kb.mul(kb.mul(t, t), t), evs[1])
        return ifft(c[None])[0]

    def link(tp):
        w = kb.pack_scalar(domain.group_gen, tp.device)
        return kb.sub(kb.scale_base(tp[1], w), tp[0])

    return DeviceTrace(stark_field=stark_field, steps=steps, cols=None,
                       transitions=[cubic, link], cols_dev=cols_dev)
