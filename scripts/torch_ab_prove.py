#!/usr/bin/env python3
"""What the split query report costs: warm parity proves of the PyTorch/CUDA
port (ministark_tpu_torch) with ``DeviceEngine(query_split=False)`` and
``query_split=True`` in turns, in one process on one card.

    python3 scripts/torch_ab_prove.py [--steps N] [--pairs N]
                                      [--field goldilocks|babybear]
                                      [--device cuda|cpu]

Proves Fibonacci (security 20, blowup 2, witness on the device) once with
each engine to warm up, then ``--pairs`` times off, on, on, off (the order
turns so that a drift of the machine falls on both alike), and prints one
JSON line: the card's name and power limit (nvidia-smi), every prove's wall
seconds, the median and the range of each side, and the median of the
differences within a pair. The host's clock spreads by seconds between
proves of this host-bound prover, so read the difference beside the range.
``--device cpu`` is a dry run at a small ``--steps``: host times, no device
metric.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(steps, pairs, field="goldilocks", device="cuda"):
    import torch

    from ministark_tpu_torch.fields import BabyBear, Goldilocks
    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark.engine import DeviceEngine
    from ministark_tpu_torch.stark.proof_io import proof_digests

    on_card = torch.device(device).type == "cuda"
    sf = {"goldilocks": Goldilocks, "babybear": BabyBear}[field]
    trace = fibonacci_device_trace(sf, steps, on_device=True, device=device)
    cfg = StarkConfig(sf, 20, 2, steps, trace.constrain_number())
    engines = {split: DeviceEngine(cfg, device=device, query_split=split)
               for split in (False, True)}

    def prove(split):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.time()
        proof = engines[split].prove(trace)
        if on_card:
            torch.cuda.synchronize()
        return time.time() - t0, proof

    # warm-up, and the same bytes from both engines
    if proof_digests(sf, prove(False)[1]) != proof_digests(sf, prove(True)[1]):
        raise AssertionError("the split report changed the proof")

    secs = {False: [], True: []}
    diffs = []
    for i in range(pairs):
        order = (False, True) if i % 2 == 0 else (True, False)
        pair = {split: prove(split)[0] for split in order}
        for split in order:
            secs[split].append(pair[split])
        diffs.append(pair[True] - pair[False])

    def side(v):
        return {"prove_s": v, "median_s": statistics.median(v),
                "min_s": min(v), "max_s": max(v)}

    smi = None
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    return {"probe": "query_split_ab", "field": field, "steps": steps,
            "pairs": pairs, "gpu": smi, "device": device,
            "query_phase_labels": {
                "off": sum(k.startswith("fri_query_round_")
                           for k in engines[False].phase_seconds),
                "on": sum(k.startswith("fri_query_round_")
                          for k in engines[True].phase_seconds)},
            "off": side(secs[False]), "on": side(secs[True]),
            "median_diff_s": statistics.median(diffs),
            "median_diff_share": statistics.median(diffs)
            / statistics.median(secs[False])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=(1 << 20) - 1)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--field", choices=("goldilocks", "babybear"),
                    default="goldilocks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu for a dry run)", file=sys.stderr)
        sys.exit(1)
    print(json.dumps(run(args.steps, args.pairs, args.field, args.device)), flush=True)


if __name__ == "__main__":
    main()
