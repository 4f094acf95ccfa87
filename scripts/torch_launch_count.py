#!/usr/bin/env python3
"""Count the kernel launches and device time of one warm parity prove of the
PyTorch/CUDA port (ministark_tpu_torch) with torch.profiler.

    python3 scripts/torch_launch_count.py [--root DIR] [--steps N]
                                          [--ntt-backend B]
                                          [--field goldilocks|babybear]
                                          [--mode parity|fast|stir|whir]
                                          [--match S]

Proves Fibonacci over Goldilocks + Fp2, or with ``--field babybear`` over
BabyBear + Fp4 (security 20, blowup 2, witness on the card) once to warm
up, then once under torch.profiler (``--mode fast``: the fast mode's
``FastStark.prove_many`` of one trace in bench.py's configuration, arity 4
and ``lde_backend="fri"``; ``--mode stir`` / ``whir``: the same with that
low-degree test), and prints one JSON line: the card's
name and power limit (nvidia-smi), the runtime's
kernel-launch calls by name, the kernels that ran on the device and their
summed time, the prove's wall seconds and the device's busy share (kernel
time over wall time), the fast modes' ``phase_seconds``, and with ``--match S`` the launches and summed ms
of the kernels whose names contain S. ``--root`` names the checkout whose
ministark_tpu_torch is imported (default: the one holding this script), so
an older commit unpacked beside this one can be measured in the same run;
``--ntt-backend`` is passed to the prover only when given. Needs a CUDA
device; exits 1 without one.
"""

import argparse
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
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.abspath(args.root))
    from ministark_tpu_torch.fields import BabyBear, Goldilocks
    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark.engine import DeviceEngine
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig

    sf = {"goldilocks": Goldilocks, "babybear": BabyBear}[args.field]
    trace = fibonacci_device_trace(sf, args.steps, on_device=True, device="cuda")
    kw = {} if args.ntt_backend is None else {"ntt_backend": args.ntt_backend}
    phases = None
    if args.mode != "parity":
        lde = "fri" if args.mode == "fast" else args.mode
        stark = FastStark(FastStarkConfig(sf, args.steps, queries=32, arity=4,
                                          lde_backend=lde), device="cuda", **kw)
        prove = lambda: stark.prove_many([trace])  # noqa: E731
        phases = lambda: {k: round(v, 4) for k, v in stark.phase_seconds.items()}  # noqa: E731
    else:
        cfg = StarkConfig(sf, 20, 2, args.steps, trace.constrain_number())
        engine = DeviceEngine(cfg, device="cuda", **kw)
        prove = lambda: engine.prove(trace)  # noqa: E731
    prove()                                                # build and warm up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        prove()
        torch.cuda.synchronize()
        wall = time.time() - t0

    launch_calls, kernels, device_us = {}, 0, 0.0
    match_kernels, match_us = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            device_us += e.time_range.elapsed_us()
            if args.match is not None and args.match in e.name:
                match_kernels += 1
                match_us += e.time_range.elapsed_us()
        elif "LaunchKernel" in e.name:
            launch_calls[e.name] = launch_calls.get(e.name, 0) + 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "root": os.path.abspath(args.root), "field": args.field, "mode": args.mode,
        "steps": args.steps,
        "ntt_backend": args.ntt_backend, "gpu": smi,
        "launch_calls": launch_calls, "device_kernels": kernels,
        "device_ms": device_us / 1e3, "prove_wall_s": wall,
        "device_busy_share": device_us / 1e6 / wall,
        "phase_seconds": None if phases is None else phases(),
        **({} if args.match is None else {"match": {
            "name": args.match, "launches": match_kernels,
            "device_ms": match_us / 1e3}}),
    }), flush=True)


if __name__ == "__main__":
    main()
