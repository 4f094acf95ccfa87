"""The commit-free prove core, on one device and sharded over a mesh, for
any DeviceTrace-shaped model.

Port of ``ministark_tpu/stark/core.py``. The core is the compute spine of
``DeviceEngine.prove`` with no commitment and no transcript between its
steps: trace iFFT -> transition constraints -> zero-padded LDE -> constraint
mixing -> one FRI fold. The JAX package jits it as a compile check for its
driver (``__graft_entry__.py``); here it is a function on tensors that
``entry.py`` runs, with the kernels of ``ops/ntt.py`` (``ntt_backend``
picks them, as in the provers) and ``ops/poly.py``.

The graph is built from the model's own ``DeviceTrace`` (width w, t
transition closures). The JAX core calls ``transitions_inline``, twins of
the transitions that nest inside ``jax.jit`` (only MiMC has them, and
tests/test_mimc_model.py holds them bit-equal to ``transitions``); the
port's ``DeviceTrace.transitions`` serve both cores, so there is no
``_inline`` field.

The two cores differ in their LDE, as in the JAX package: the single core
evaluates over the coset ``shift * H`` of size 2n, the sharded core over H
itself (a plain FFT of the padded batch, ``core.py:152-153``), so the
sharded core's LDE equals the single core's with ``shift = 1``.
"""

from __future__ import annotations

import torch

from ..ops.field import get_ops, pack_u64
from ..ops.ntt import get_ntt_fns
from ..ops.poly import fold_even_odd, mix_columns


def _trace_for(stark_field, n: int, trace_builder=None, device="cuda"):
    """The model's DeviceTrace of domain n. ``trace_builder``:
    callable(stark_field, steps, device=) -> DeviceTrace; the Fibonacci
    AIR (host columns) by default."""
    if trace_builder is None:
        from ..models.fibonacci_device import fibonacci_device_trace

        trace_builder = fibonacci_device_trace
    dtrace = trace_builder(stark_field, n - 1, device=device)
    assert dtrace.domain_size == n, (
        f"trace domain {dtrace.domain_size} != requested {n}"
    )
    return dtrace


def _packed_cols(dtrace, device) -> torch.Tensor:
    """The trace's (w, n) columns as a tensor on ``device``."""
    if dtrace.cols_dev is not None:
        return dtrace.cols_dev.to(device)
    return pack_u64(dtrace.cols, device)


def _spine(kb, trans, ifft, cols, weights, lde):
    """iFFT, transitions, the zero-padded batch through ``lde``, mix, fold."""
    tp = ifft(cols)                                          # (w, n)
    allc = torch.cat([tp] + [f(tp)[None] for f in trans], 0)  # (w+t, n)
    padded = torch.cat([allc, torch.zeros_like(allc)], 1)    # (w+t, 2n)
    mixed = mix_columns(kb, allc, weights)                   # (n,)
    return lde(padded), mixed, fold_even_odd(kb, mixed, weights[1])


def make_prove_core(stark_field, n: int, trace_builder=None, device="cuda",
                    ntt_backend: str = "radix2"):
    """Single-device core for a width-w, t-transition trace of domain n.

    Returns (core, example_args) with

      core(cols, shift, weights) -> (lde, mixed, folded)
        cols:    (w, n) column evaluations
        shift:   the coset offset, a packed base scalar (0-d tensor) or an int
        weights: (w + t,) mixing weights
        lde:     (w + t, 2n) evaluations of the padded coefficients over
                 shift * H; mixed: (n,); folded: (n / 2,)

    and example_args() -> (cols, shift = 7, weights = 5^i), packed on
    ``device`` (``core.py:110``). The trace's columns go to ``device``
    here, so a host without that device raises now."""
    base = stark_field.base
    kb = get_ops(base)
    device = torch.device(device)
    dtrace = _trace_for(stark_field, n, trace_builder, device)
    trans = list(dtrace.transitions)
    total = dtrace.width + len(trans)
    cols = _packed_cols(dtrace, device)
    ifft = get_ntt_fns(base, n, ntt_backend)[1]
    coset_fft = get_ntt_fns(base, 2 * n, ntt_backend)[2]

    def core(cols, shift, weights):
        if isinstance(shift, torch.Tensor):
            shift = kb.unpack(shift.reshape(1))[0]            # one pull
        return _spine(kb, trans, ifft, cols, weights,
                      lambda padded: coset_fft(padded, int(shift)))

    def example_args():
        shift = kb.pack_scalar(base.from_int(7), device)
        weights = kb.pack([base.pow(base.from_int(5), i) for i in range(total)],
                          device)
        return cols, shift, weights

    return core, example_args


def make_sharded_prove_core(stark_field, n: int, mesh, trace_builder=None,
                            ntt_backend: str = "radix2"):
    """The core over ``mesh`` (``parallel.Mesh``; every rank calls it on the
    same inputs): the trace iFFT, transitions, mixing and fold on each
    rank's device, the LDE one sharded four-step NTT of the whole padded
    batch (``parallel/ntt_sharded.py``). ``core(cols, weights) -> (lde,
    mixed, folded)``, whole on every rank; the LDE is over H (no coset)."""
    from ..parallel.ntt_sharded import get_sharded_ntt_fns

    base = stark_field.base
    kb = get_ops(base)
    dtrace = _trace_for(stark_field, n, trace_builder, mesh.device)
    trans = list(dtrace.transitions)
    ifft = get_ntt_fns(base, n, ntt_backend)[1]
    sharded_fft = get_sharded_ntt_fns(base, 2 * n, mesh, ntt_backend)[0]

    def core(cols, weights):
        return _spine(kb, trans, ifft, cols, weights, sharded_fft)

    return core
