#!/usr/bin/env python3
"""Count the kernel launches and device time of one warm parity prove of the
PyTorch/CUDA port (ministark_tpu_torch) with torch.profiler.

    python3 scripts/torch_launch_count.py [--root DIR] [--steps N]
                                          [--ntt-backend B]
                                          [--field goldilocks|babybear]

Proves Fibonacci over Goldilocks + Fp2, or with ``--field babybear`` over
BabyBear + Fp4 (security 20, blowup 2, witness on the card) once to warm
up, then once under torch.profiler, and prints one JSON line: the card's
name and power limit (nvidia-smi), the runtime's
kernel-launch calls by name, the kernels that ran on the device and their
summed time, the prove's wall seconds and the device's busy share (kernel
time over wall time). ``--root`` names the checkout whose
ministark_tpu_torch is imported (default: the one holding this script), so
an older commit unpacked beside this one can be measured in the same run;
``--ntt-backend`` is passed to DeviceEngine only when given. Needs a CUDA
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

    sf = {"goldilocks": Goldilocks, "babybear": BabyBear}[args.field]
    trace = fibonacci_device_trace(sf, args.steps, on_device=True, device="cuda")
    cfg = StarkConfig(sf, 20, 2, args.steps, trace.constrain_number())
    kw = {} if args.ntt_backend is None else {"ntt_backend": args.ntt_backend}
    engine = DeviceEngine(cfg, device="cuda", **kw)
    engine.prove(trace)                                    # build and warm up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        engine.prove(trace)
        torch.cuda.synchronize()
        wall = time.time() - t0

    launch_calls, kernels, device_us = {}, 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            device_us += e.time_range.elapsed_us()
        elif "LaunchKernel" in e.name:
            launch_calls[e.name] = launch_calls.get(e.name, 0) + 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "root": os.path.abspath(args.root), "field": args.field,
        "steps": args.steps,
        "ntt_backend": args.ntt_backend, "gpu": smi,
        "launch_calls": launch_calls, "device_kernels": kernels,
        "device_ms": device_us / 1e3, "prove_wall_s": wall,
        "device_busy_share": device_us / 1e6 / wall,
    }), flush=True)


if __name__ == "__main__":
    main()
