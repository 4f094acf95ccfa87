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
sharded core's LDE equals the single core's with ``shift = 1``. The
sharded core is resident (``parallel/__init__.py``): each rank computes
and returns its block of every output, which a gather along the point or
coefficient axis makes the single core's.
"""

from __future__ import annotations

import torch

from ..ops.field import get_ops, pack_words
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
    """The trace's (w, n) columns as a tensor on ``device``, in the base
    field's dtype."""
    if dtrace.cols_dev is not None:
        return dtrace.cols_dev.to(device)
    return pack_words(dtrace.cols, get_ops(dtrace.stark_field.base).dtype, device)


def _spine(kb, trans, ifft, cols, weights, lde, rows=None):
    """iFFT, transitions, the coefficients through ``lde``, mix, fold; with
    ``rows`` (a ``parallel.Rows``) on this rank's block of each."""
    kw = {} if rows is None else {"rows": rows}
    tp = ifft(cols)                                          # (w, n)
    allc = torch.cat([tp] + [f(tp, **kw)[None] for f in trans], 0)  # (w+t, n)
    mixed = mix_columns(kb, allc, weights)                   # (n,)
    return lde(allc), mixed, fold_even_odd(kb, mixed, weights[1])


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
        return _spine(kb, trans, ifft, cols, weights, lambda allc: coset_fft(
            torch.cat([allc, torch.zeros_like(allc)], 1), int(shift)))  # (w+t, 2n)

    def example_args():
        shift = kb.pack_scalar(base.from_int(7), device)
        weights = kb.pack([base.pow(base.from_int(5), i) for i in range(total)],
                          device)
        return cols, shift, weights

    return core, example_args


def make_sharded_prove_core(stark_field, n: int, mesh, trace_builder=None,
                            ntt_backend: str = "radix2"):
    """The core over ``mesh`` (``parallel.Mesh``; every rank calls it on the
    same inputs), resident: rank r takes its block [r*n/D, (r+1)*n/D) of
    the columns and runs the block iFFT, the transitions on their block
    (``rows=``), the block LDE from n/D coefficients to its 2n/D points
    (the zero padding taken in by the block NTT, ``parallel/
    ntt_sharded.py``), and the mix and fold on its block.

    ``core(cols, weights) -> (lde, mixed, folded)``: cols (w, n) and
    weights whole on every rank; the outputs are this rank's blocks,
    lde (w + t, 2n/D) of the points [r*2n/D, (r+1)*2n/D) over H (no
    coset), mixed (n/D,) and folded (n/(2D),) of the coefficients from
    r*n/D and r*n/(2D). Raises when the sizes do not split over the mesh."""
    from ..parallel.mesh import Rows
    from ..parallel.ntt_sharded import block_ntt_fits, get_block_ntt_fns

    D = mesh.size
    if not (block_ntt_fits(n, n, D) and block_ntt_fits(2 * n, n, D) and (n // D) % 2 == 0):
        raise ValueError(f"the prove core of {n} rows does not split over {D} ranks")
    base = stark_field.base
    kb = get_ops(base)
    dtrace = _trace_for(stark_field, n, trace_builder, mesh.device)
    trans = list(dtrace.transitions)
    rows = Rows(mesh, n)
    ifft = get_block_ntt_fns(base, n, mesh, ntt_backend)[1]
    lde = get_block_ntt_fns(base, 2 * n, mesh, ntt_backend)[0]

    def core(cols, weights):
        return _spine(kb, trans, ifft, rows.take(cols, 1), weights, lde, rows)

    return core
