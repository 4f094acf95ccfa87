#!/usr/bin/env python3
"""Time the device witnesses of the PyTorch/CUDA port (ministark_tpu_torch):
Fibonacci's columns (``models/fibonacci_device.py::fibonacci_trace_cols_on_device``)
and the counter's (``models/counter.py::_counter_cols_on_device``), each
built whole on the card in Goldilocks and in BabyBear.

    python3 scripts/torch_witness_probe.py [--root DIR] [--log-n 20[,22]]
                                           [--reps 5]

For each field, model and size (steps = 2^log_n - 1) it builds the witness
once to warm up (and build the kernels), then prints one JSON line: the
card's name and power limit (nvidia-smi), the sha256 of the columns' bytes,
the runtime's kernel-launch calls and the device kernels of one call under
torch.profiler with their summed ms (``profiler_ms``, the mean over
``--reps`` calls), the wall ms of one call to the card's synchronize
(median of ``--reps``), the package's own witness launches a call where the
checkout counts them (``ops/witness.py``), and ``cold_device_ms``
(``utils/roofline.py::cold_device_ms``: the card's time with the operands
out of L2), where the call makes no copy that waits for the card (a torch
scalar packed on the host and copied over does; there it is "not
measured"). ``--root`` names the checkout whose ministark_tpu_torch is
imported (default: the one holding this script), so that a parent commit
unpacked beside this one reads in the same call: run parent, change,
change, parent.
Needs a CUDA device; exits 1 without one.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

# the runtime calls inside a call that wait for the card (a pageable copy
# to the card first synchronizes its stream), so that a call queued behind
# a device sleep never outruns it (the probe's own synchronize after the
# call is a cudaDeviceSynchronize, not counted)
BLOCKING = ("cudaMemcpy", "cudaMemcpyAsync", "cudaStreamSynchronize")


def witnesses(field):
    """(model, fn(steps)) of the root's package for one field."""
    from ministark_tpu_torch.fields import BabyBear, Goldilocks
    from ministark_tpu_torch.models.counter import _counter_cols_on_device
    from ministark_tpu_torch.models.fibonacci_device import fibonacci_trace_cols_on_device

    sf = {"gl": Goldilocks, "bb": BabyBear}[field]
    return (("fibonacci", lambda steps: fibonacci_trace_cols_on_device(sf, steps, 2, "cuda")),
            ("counter", lambda steps: _counter_cols_on_device(sf, steps, 1, 3, 5, 7, "cuda")))


def own_launches():
    try:
        from ministark_tpu_torch.ops import witness
    except ImportError:                      # a checkout from before the kernels
        return None
    return sum(witness.launches.values())


def measure(fn, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ministark_tpu_torch.utils import roofline as rf

    out = fn()                                           # build and warm up
    torch.cuda.synchronize()
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    shape, dtype = list(out.shape), str(out.dtype)
    del out
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    before = own_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    after = own_launches()
    launch_calls, kernels, device_us, blocking = 0, 0, 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith("Memcpy") or e.name.startswith("Memset"):
                continue
            kernels += 1
            device_us += e.time_range.elapsed_us()
        elif "LaunchKernel" in e.name:
            launch_calls += 1
        elif e.name in BLOCKING:
            blocking += 1
    prof_ms, _ = rf.profiler_ms(fn, reps)
    cold = ("not measured (the call waits for the card)" if blocking
            else rf.cold_device_ms(fn, reps))
    return {"shape": shape, "dtype": dtype, "sha256": digest,
            "launch_calls": launch_calls, "device_kernels": kernels,
            "device_ms_one_call": device_us / 1e3, "profiler_ms": prof_ms,
            "wall_ms": statistics.median(walls), "cold_device_ms": cold,
            "own_launches": None if before is None else after - before}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--log-n", default="20")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    for log_n in (int(v) for v in args.log_n.split(",")):
        for field in ("gl", "bb"):
            for model, build in witnesses(field):
                steps = (1 << log_n) - 1
                row = measure(lambda: build(steps), args.reps)
                print(json.dumps({"root": root, "gpu": smi, "field": field,
                                  "model": model, "steps": steps, **row}), flush=True)


if __name__ == "__main__":
    main()
