"""Driver entry points of the port: the prove core and the multi-rank dry run.

Twin of ``__graft_entry__.py``:

  entry(device)            -> (core, example_args) for the Goldilocks prove
                              core at n = 256, the card's kernels built first
  dryrun_multichip(n, ...) -> the sharded paths on n ranks
                              (``parallel/launch.run``), every rank held
                              byte for byte against one device

    python -m ministark_tpu_torch.entry [--device cuda|cpu] [--backend B]

runs ``entry()``'s core and then ``dryrun_multichip(DRYRUN_DEVICES)``
(2 ranks unless the environment says otherwise). The JAX package's compile
cache and its ``DRYRUN_SUBPROCESS`` re-exec stay behind: ``launch.run``
starts fresh processes.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ENTRY_N = 256            # the entry core's trace domain
DRYRUN_TIMEOUT_S = 1800
# the FRI rounds of the 2^10 - 1 parity prove on tensors (``:180``)
DRYRUN_SETTINGS = (("ministark_tpu_torch.stark.engine", "DEVICE_MIN_SIZE", 256),)
# key -> (case of parallel/cases.py, keywords): ``__graft_entry__.py:
# 180-260``'s proves
DRYRUN_PROVES = {
    "parity": ("parity", dict(field="gl", steps=(1 << 10) - 1)),
    "mimc": ("parity", dict(field="gl", steps=(1 << 9) - 1, model="mimc")),
    "fast": ("fast", dict(field="gl", steps=255, cfg=dict(queries=4, final_len=16))),
    "fast_fold8_arity8": ("fast", dict(field="gl", steps=(1 << 12) - 1, cfg=dict(
        queries=4, final_len=64, fold_factor=8, arity=8))),
    "stir": ("ldt", dict(backend="stir")),
    "whir": ("ldt", dict(backend="whir")),
}


def _build_kernels(device) -> None:
    if torch.device(device).type == "cuda":
        from .ops import cuda

        cuda.library()


def entry(device="cuda"):
    """(core, example_args()) of ``stark/core.py::make_prove_core`` for the
    Fibonacci AIR over Goldilocks at n = 256, on ``device``; on a card the
    kernel library is built first."""
    from .fields import Goldilocks
    from .stark.core import make_prove_core

    _build_kernels(device)
    core, example_args = make_prove_core(Goldilocks, ENTRY_N, device=device)
    return core, example_args()


def dryrun_scenarios(n_devices: int):
    """[(key, case, keywords)] of the dry run on ``n_devices`` ranks: the
    sharded core for Fibonacci and MiMC at n = max(64, 4 D^2), the sharded
    fold / deep on 4 D Fp2 coefficients, then the proves."""
    n = max(64, 4 * n_devices * n_devices)
    m = 4 * n_devices
    coeffs = np.asarray([(i + 1, 2 * i + 1) for i in range(m)], dtype=np.uint64)
    out = [("core", "core", dict(field="gl", n=n)),
           ("mimc_core", "core", dict(field="gl", n=n, model="mimc")),
           ("fold", "fold_deep", dict(field="gl", coeffs=coeffs, alpha=(5, 6),
                                      z=(7, 8)))]
    return out + [(key, name, kw) for key, (name, kw) in DRYRUN_PROVES.items()]


def _single(name, kw, device):
    """One scenario on one device."""
    from .parallel import cases
    from .stark import engine

    default = engine.DEVICE_MIN_SIZE
    engine.DEVICE_MIN_SIZE = DRYRUN_SETTINGS[0][2]
    try:
        return getattr(cases, name)(None, device=device, **kw)
    finally:
        engine.DEVICE_MIN_SIZE = default


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _sharded_lde_check(lde, device) -> None:
    """The sharded core's first LDE row against one device's transform:
    fft of the zero-padded iFFT of the first trace column
    (``__graft_entry__.py:155-164``)."""
    from .fields import Goldilocks
    from .ops.field import unpack_u64
    from .ops.ntt import get_ntt_fns
    from .stark.core import _packed_cols, _trace_for

    n = lde.shape[1] // 2
    base = Goldilocks.base
    cols = _packed_cols(_trace_for(Goldilocks, n, device=device), device)
    tp0 = get_ntt_fns(base, n)[1](cols[:1])
    ref = get_ntt_fns(base, 2 * n)[0](torch.cat([tp0, torch.zeros_like(tp0)], 1))
    assert np.array_equal(lde[:1], unpack_u64(ref)), "sharded LDE mismatch"


def _default_backend(n_devices: int, device) -> str:
    """nccl for ranks with a card each, gloo otherwise (CPU ranks, ranks
    that share a card)."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() >= n_devices):
        return "nccl"
    return "gloo"


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> dict:
    """The sharded paths on ``n_devices`` ranks of ``parallel/launch.run``,
    as ``__graft_entry__.py:46`` runs them on a mesh: the sharded core for
    Fibonacci and MiMC (equal to the single core with shift 1, its first
    LDE row to one device's transform), ``make_sharded_fold_fns`` on 4 D
    Fp2 coefficients, the parity proves of Fibonacci at 2^10 - 1
    (DEVICE_MIN_SIZE 256) and MiMC at 2^9 - 1, FastStark in the dry run's
    two configurations, and STIR and WHIR; every rank byte-equal to one
    device, or AssertionError. The ranks' device follows ``device``
    (``"cuda"``: rank i on card i % count; ``"cuda:0"``: all on that card;
    ``"cpu"``), and the one-device references run on ``device`` (card 0
    for ``"cuda"``) while the ranks prove. Prints a line a check; returns
    {key: rank 0's collectives} for the proves."""
    from .parallel import cases, launch

    if backend is None:
        backend = _default_backend(n_devices, device)
    ref_device = torch.device(device)
    if ref_device.type == "cuda" and ref_device.index is None:
        ref_device = torch.device("cuda", 0)
    _build_kernels(device)
    scenarios = dryrun_scenarios(n_devices)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(launch.run, cases.run, n_devices, backend, device,
                          DRYRUN_TIMEOUT_S, (scenarios,), DRYRUN_SETTINGS)
        single = {key: _single(name, kw, ref_device) for key, name, kw in scenarios}
        ranks = fut.result()
    tag = f"dryrun_multichip({n_devices})"

    def check(key, what):
        for rank, r in enumerate(ranks):
            assert _same(r[key], single[key]), (
                f"{tag}: rank {rank}'s {what} differs from one device's")

    check("core", "Fibonacci core")
    _sharded_lde_check(ranks[0]["core"][0], ref_device)
    lde, mixed, folded = ranks[0]["core"]
    print(f"{tag}: core OK — sharded LDE bit-exact, equal to the single core "
          f"with shift 1 on every rank; mixed shape {mixed.shape}, folded shape "
          f"{folded.shape}")
    check("mimc_core", "MiMC core")
    print(f"{tag}: MiMC generic core OK — lde shape {ranks[0]['mimc_core'][0].shape}")
    check("fold", "fold / deep")
    print(f"{tag}: sharded FRI fold and DEEP evals OK on {4 * n_devices} Fp2 "
          "coefficients")
    collectives = {}
    for key, (name, kw) in DRYRUN_PROVES.items():
        for rank, r in enumerate(ranks):
            assert _same(r[key][0], single[key][0]), (
                f"{tag}: rank {rank}'s {key} proof differs from one device's")
            assert r[key][1] > 0, f"{tag}: rank {rank}'s {key} prove sharded nothing"
        collectives[key] = ranks[0][key][1]
        size = kw.get("steps", 1 << 10)
        print(f"{tag}: OK — sharded {key} prove at {size} "
              f"{'steps' if 'steps' in kw else 'coeffs x 2 polys'} byte-identical "
              f"to one device on every rank ({collectives[key]} collectives)")
    return collectives


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: by device)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu)", file=sys.stderr)
        return 1
    core, core_args = entry(args.device)
    out = core(*core_args)
    print("entry(): ran; outputs:", [tuple(o.shape) for o in out])
    dryrun_multichip(int(os.environ.get("DRYRUN_DEVICES", "2")), args.device,
                     args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
