"""How fast does a hand-written kernel stream the card's memory?

The port's twin of scripts/pallas_stream_probe.py: out = x + 1 over a
(16384, 4096) array of 32-bit words (256 MB read, 256 MB written) with the
``stream_add1`` kernel (csrc/stream.cu) at a few launch shapes, beside
``torch.add(x, 1)`` on the same tensor. Times are CUDA events around
``--reps`` launches after a warm-up. Each launch shape (threads per block,
16-byte vectors in flight per thread; one group of them a block) is
timed against ``torch.add`` in ``--sweep-pairs`` pairs of interleaved turns
(kernel first in even pairs, ``torch.add`` first in odd ones), medians of
each: the sweep that sets ``ops/stream.py``'s default shape. With ``--pairs
N`` the kernel at the wrapper's own launch shape and ``torch.add`` are then
timed in N pairs the same way, with the median of each and of the
differences. Prints one line per shape and, last, one JSON line with every
reading in GB/s (2 x 4 bytes per word).

    python3 scripts/torch_stream_probe.py [--pairs 15]   # on the GPU host
    python3 scripts/torch_stream_probe.py --device cpu --rows 64   # dry run
"""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ministark_tpu_torch.ops import stream
from ministark_tpu_torch.utils.roofline import time_ms

# (threads per block, 16-byte vectors per thread)
LAUNCH_SHAPES = ((128, 1), (256, 1), (256, 2), (256, 4), (256, 8), (512, 1), (512, 2),
                 (512, 4), (1024, 1), (1024, 2), (1024, 4))


def paired(kernel, library, pairs, reps, device):
    """Both functions timed in ``pairs`` interleaved turns: ms lists, their
    medians and the median of kernel - library over the pairs."""
    k_ms, l_ms = [], []
    for i in range(pairs):
        if i % 2 == 0:
            k_ms.append(time_ms(kernel, reps, device))
            l_ms.append(time_ms(library, reps, device))
        else:
            l_ms.append(time_ms(library, reps, device))
            k_ms.append(time_ms(kernel, reps, device))
    return {"pairs": pairs, "kernel_ms": k_ms, "torch_add_ms": l_ms,
            "kernel_median_ms": statistics.median(k_ms),
            "torch_add_median_ms": statistics.median(l_ms),
            "diff_median_ms": statistics.median(a - b for a, b in zip(k_ms, l_ms))}


def run(rows=16384, cols=4096, reps=20, device="cuda", seed=0, pairs=0,
        sweep_pairs=3):
    """The probe's readings as a dict; raises if the kernel and the plain
    version disagree."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(rows, cols), dtype=np.uint64)
    words.reshape(-1)[:2] = (0xFFFFFFFF, 0x7FFFFFFF)          # both wraps
    x = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(device)
    gb = 2 * x.numel() * 4 / 1e9
    on_card = x.device.type == "cuda"
    out = {"probe": "stream_add1", "rows": rows, "cols": cols, "gb_moved": gb,
           "device": torch.cuda.get_device_name(0) if on_card else "cpu",
           "kernel": []}
    want = stream.stream_add1_plain(x[:256])
    if not torch.equal(stream.stream_add1(x)[:256], want):
        raise AssertionError("stream_add1 differs from its plain version")
    shapes = (LAUNCH_SHAPES if on_card
              else ((stream.THREADS, stream.PER_THREAD),))
    library = lambda: torch.add(x, 1)  # noqa: E731
    for threads, per_thread in shapes:
        if on_card:
            fn = lambda: stream.stream_add1_cuda(x, threads, per_thread)  # noqa: E731
        else:
            fn = lambda: stream.stream_add1(x)  # noqa: E731
        pr = paired(fn, library, sweep_pairs, reps, device)
        ms, lms = pr["kernel_median_ms"], pr["torch_add_median_ms"]
        out["kernel"].append({"threads": threads, "per_thread": per_thread,
                              "ms": ms, "gb_per_s": gb / ms * 1e3,
                              "torch_add_ms": lms})
        print(f"stream_add1 threads {threads:4d} x {per_thread} vectors: "
              f"{ms:8.4f} ms  {gb / ms * 1e3:7.1f} GB/s (median of "
              f"{sweep_pairs}; torch.add {lms:.4f} ms)", flush=True)
    ms = time_ms(library, reps, device)
    out["torch_add"] = {"ms": ms, "gb_per_s": gb / ms * 1e3}
    print(f"torch.add(x, 1):                      {ms:8.4f} ms  "
          f"{gb / ms * 1e3:7.1f} GB/s", flush=True)
    out["best_gb_per_s"] = max(k["gb_per_s"] for k in out["kernel"])
    if pairs:
        pr = out["paired"] = paired(lambda: stream.stream_add1(x),
                                    lambda: torch.add(x, 1), pairs, reps, device)
        print(f"paired, {pairs} pairs of {reps} calls: stream_add1 median "
              f"{pr['kernel_median_ms']:.4f} ms ({min(pr['kernel_ms']):.4f}-"
              f"{max(pr['kernel_ms']):.4f}), torch.add {pr['torch_add_median_ms']:.4f} "
              f"ms ({min(pr['torch_add_ms']):.4f}-{max(pr['torch_add_ms']):.4f}), "
              f"median difference {pr['diff_median_ms']:+.4f} ms", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--cols", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--sweep-pairs", type=int, default=3)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.rows, args.cols, args.reps, args.device,
                         pairs=args.pairs, sweep_pairs=args.sweep_pairs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
