#!/usr/bin/env python3
"""Count the kernel launches and device time of one warm parity prove of the
PyTorch/CUDA port (ministark_tpu_torch) with torch.profiler.

    python3 scripts/torch_launch_count.py [--root DIR] [--steps N]
                                          [--ntt-backend B]
                                          [--field goldilocks|babybear]
                                          [--mode parity|fast|stir|whir]
                                          [--match S] [--top N] [--world N]
                                          [--backend gloo|nccl]

Proves Fibonacci over Goldilocks + Fp2, or with ``--field babybear`` over
BabyBear + Fp4 (security 20, blowup 2, witness on the card) once to warm
up, then once under torch.profiler (``--mode fast``: the fast mode's
``FastStark.prove_many`` of one trace in bench.py's configuration, arity 4
and ``lde_backend="fri"``; ``--mode stir`` / ``whir``: the same with that
low-degree test), and prints one JSON line: the card's
name and power limit (nvidia-smi), the runtime's
kernel-launch calls by name, the kernels that ran on the device and their
summed time, the prove's wall seconds and the device's busy share (kernel
time over wall time), the wall seconds of one warm prove before it
without the profiler (``warm_s``) with its peak allocated device memory
(``peak_allocated_bytes``, peak stats reset first) and, on a mesh, the
bytes the rank received by collective kind (``received_bytes``,
``parallel/mesh.py::received``), the sha256 of the proof's bytes, the
fast modes' ``phase_seconds``, the port's own counts of the field kernels
(``field_ops``: launches and calls by kernel, ops/field.py and ops/bb.py;
an older checkout's launch counts only), and with ``--match S`` the
launches and summed ms
of the kernels whose names contain S (``--top N``: the N kernels, by the
first 80 characters of their names, with the most device time). ``--root`` names the checkout whose
ministark_tpu_torch is imported (default: the one holding this script), so
an older commit unpacked beside this one can be measured in the same run;
``--ntt-backend`` is passed to the prover only when given. ``--world N``
proves sharded over N ranks (a group made by ``parallel/launch.py``,
``mesh=`` on the prover) after the same readings of one device here
(``one_device``), prints each rank's under ``ranks``, and exits 1 unless
every rank's proof is the one device's bytes. ``--backend gloo`` (the
default) puts every rank on card 0, so their device time overlaps and
reads a code path, not a scaling; ``--backend nccl`` gives rank r card r
(needs N cards). Needs a CUDA device; exits 1 without one.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=(1 << 20) - 1)
    ap.add_argument("--ntt-backend", default=None)
    ap.add_argument("--field", choices=("goldilocks", "babybear"),
                    default="goldilocks")
    ap.add_argument("--mode", choices=("parity", "fast", "stir", "whir"),
                    default="parity")
    ap.add_argument("--match", default=None)
    ap.add_argument("--top", type=int, default=0,
                    help="also list the N kernels with the most device time")
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.abspath(args.root))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    head = {"root": os.path.abspath(args.root), "field": args.field,
            "mode": args.mode, "steps": args.steps,
            "ntt_backend": args.ntt_backend, "gpu": smi}
    one = measure(None, args)
    if args.world == 1:
        print(json.dumps({**head, **one}), flush=True)
        return
    from ministark_tpu_torch.parallel import launch

    torch.cuda.empty_cache()
    device = "cuda:0" if args.backend == "gloo" else "cuda"
    ranks = launch.run(measure, args.world, args.backend, device, 1800, args=(args,))
    equal = all(r["proof_sha256"] == one["proof_sha256"] for r in ranks)
    print(json.dumps({**head, "world": args.world, "backend": args.backend,
                      "cards": torch.cuda.device_count(), "equal": equal,
                      "one_device": one, "ranks": ranks}), flush=True)
    if not equal:
        sys.exit(1)


TOP_NAME = 80      # the characters of a kernel's name that --top groups by


def field_counts():
    """{kernel: [launches, calls]} of the field kernels from the imported
    package's counters (ops/field.py, ops/bb.py); a checkout from before the
    field-op kernels has integer launch counts of the two products and no
    calls (None)."""
    from ministark_tpu_torch.ops import bb, field

    out = {}
    for mod in (field, bb):
        launches, calls = getattr(mod, "launches", None), getattr(mod, "calls", None)
        if isinstance(launches, dict):
            out.update({k: [v, calls[k]] for k, v in launches.items()})
    if isinstance(field.launches, int):
        out = {"gl_mul": [field.launches, None], "gl_ext_mul": [field.ext_launches, None]}
    return out


def measure(mesh, args):
    """The readings of one warm prove, sharded over ``mesh`` if given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ministark_tpu_torch.fields import BabyBear, Goldilocks
    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark.engine import DeviceEngine
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
    from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_to_json

    sf = {"goldilocks": Goldilocks, "babybear": BabyBear}[args.field]
    device = "cuda" if mesh is None else mesh.device
    trace = fibonacci_device_trace(sf, args.steps, on_device=True, device=device)
    kw = {} if args.ntt_backend is None else {"ntt_backend": args.ntt_backend}
    if mesh is not None:
        kw["mesh"] = mesh
    phases = None
    if args.mode != "parity":
        lde = "fri" if args.mode == "fast" else args.mode
        stark = FastStark(FastStarkConfig(sf, args.steps, queries=32, arity=4,
                                          lde_backend=lde), device=device, **kw)
        prove = lambda: stark.prove_many([trace])  # noqa: E731
        phases = lambda: {k: round(v, 4) for k, v in stark.phase_seconds.items()}  # noqa: E731
        to_bytes = lambda p: fast_proof_to_bytes(sf, p)  # noqa: E731
    else:
        cfg = StarkConfig(sf, 20, 2, args.steps, trace.constrain_number())
        engine = DeviceEngine(cfg, device=device, **kw)
        prove = lambda: engine.prove(trace)  # noqa: E731
        to_bytes = lambda p: proof_to_json(sf, p).encode()  # noqa: E731
    prove()                                                # build and warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = None
    if mesh is not None:
        from ministark_tpu_torch.parallel import mesh as pm

        got = dict(getattr(pm, "received", {}))
    t0 = time.time()
    proof = prove()
    torch.cuda.synchronize()
    warm = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    received = None if got is None else {k: v - got[k] for k, v in pm.received.items()}

    before = field_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        prove()
        torch.cuda.synchronize()
        wall = time.time() - t0
    field_ops = {k: [n - before[k][0], None if c is None else c - before[k][1]]
                 for k, (n, c) in field_counts().items()}

    launch_calls, kernels, device_us, by_name = {}, 0, 0.0, {}
    match_kernels, match_us = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            device_us += e.time_range.elapsed_us()
            n, us = by_name.get(e.name[:TOP_NAME], (0, 0.0))
            by_name[e.name[:TOP_NAME]] = (n + 1, us + e.time_range.elapsed_us())
            if args.match is not None and args.match in e.name:
                match_kernels += 1
                match_us += e.time_range.elapsed_us()
        elif "LaunchKernel" in e.name:
            launch_calls[e.name] = launch_calls.get(e.name, 0) + 1
    return {
        "rank": None if mesh is None else mesh.rank,
        "launch_calls": launch_calls, "device_kernels": kernels,
        "device_ms": device_us / 1e3, "prove_wall_s": wall,
        "device_busy_share": device_us / 1e6 / wall, "warm_s": warm,
        "peak_allocated_bytes": peak, "received_bytes": received,
        "proof_sha256": hashlib.sha256(to_bytes(proof)).hexdigest(),
        "phase_seconds": None if phases is None else phases(),
        "field_ops": field_ops,
        **({} if args.match is None else {"match": {
            "name": args.match, "launches": match_kernels,
            "device_ms": match_us / 1e3}}),
        **({} if not args.top else {"top": [
            {"name": name, "launches": n, "device_ms": round(us / 1e3, 4)}
            for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]]}),
    }


if __name__ == "__main__":
    main()
