"""Stage costs of one NTT level in its digit-matmul form, on the card.

The port's twin of scripts/tpu_fused_stage_probe.py: at level LVL_IDX of the
factor walk of size LVL_N (environment, defaults 2^20 and 0; B = 2), time
the three stages alone (digitize; the int8 dot against the level's digit
matrix; recombine with the inter-level twiddle), the fused level, and the
butterfly level (``ntt_pipe.level_cuda``) on the same input. Before any
timing the stage chain, the fused level and the butterfly level must be
equal, element for element. Times are CUDA events around ``--reps`` launches
after a warm-up. Prints the stage sum, the largest stage, the fused level
and the butterfly level, then one JSON line.

    LVL_N=1048576 LVL_IDX=0 python3 scripts/torch_digit_stage_probe.py
    LVL_N=16384 python3 scripts/torch_digit_stage_probe.py --device cpu  # dry run
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ministark_tpu_torch.fields import GOLDILOCKS_FP
from ministark_tpu_torch.ops import ntt_digit, ntt_pipe
from ministark_tpu_torch.utils.roofline import time_ms

BATCH = 2


def run(n=1 << 20, lvl=0, inverse=False, reps=20, device="cuda", seed=7):
    """The probe's readings (ms) as a dict; raises if the stage chain, the
    fused level and the butterfly level disagree."""
    p = GOLDILOCKS_FP.p
    dev = torch.device(device)
    levels = ntt_digit.level_tables(n, inverse, dev)
    Fi, vd, W, k_prod = levels[lvl]
    _, tw, _, _ = ntt_pipe._tables(n, inverse, dev)[lvl]
    R = n // Fi
    print(f"n=2^{n.bit_length() - 1} factors={[f for f, _, _, _ in levels]} "
          f"level={lvl} F={Fi} R={R} PF={vd.shape[1] // 8} "
          f"twiddle={'yes' if W is not None else 'no'}", flush=True)
    rng = np.random.default_rng(seed)
    v = rng.integers(0, p, size=(BATCH, Fi, R), dtype=np.uint64)
    v.reshape(-1)[:5] = (0, 1, ntt_digit.GL_CENTER_T, ntt_digit.GL_CENTER_T + 1, p - 1)
    x = torch.from_numpy(v.view(np.int64)).to(dev)

    d = ntt_digit.digitize(x)
    Rm = ntt_digit.digit_dot(d, vd)
    chain = ntt_digit.recombine(Rm, Fi, W, k_prod)
    fused = ntt_digit.level(x, vd, W, k_prod)
    butterfly = ntt_pipe.level(x, tw, None, W, k_prod)
    if not (torch.equal(chain, fused) and torch.equal(fused, butterfly)):
        raise AssertionError("the stage chain, the fused level and the "
                             "butterfly level disagree")

    ms = {
        "digitize": time_ms(lambda: ntt_digit.digitize(x), reps, dev),
        "dot": time_ms(lambda: ntt_digit.digit_dot(d, vd), reps, dev),
        "recombine_twiddle": time_ms(
            lambda: ntt_digit.recombine(Rm, Fi, W, k_prod), reps, dev),
        "fused_level": time_ms(lambda: ntt_digit.level(x, vd, W, k_prod), reps, dev),
        "butterfly_level": time_ms(
            lambda: ntt_pipe.level(x, tw, None, W, k_prod), reps, dev),
    }
    for k, t in ms.items():
        print(f"{k}: {t:.3f} ms", flush=True)
    stages = [ms["digitize"], ms["dot"], ms["recombine_twiddle"]]
    print(f"stage sum {sum(stages):.3f} ms vs fused {ms['fused_level']:.3f} ms; "
          f"largest stage {max(stages):.3f} ms; butterfly level "
          f"{ms['butterfly_level']:.3f} ms", flush=True)
    return {"probe": "digit_stage", "n": n, "level": lvl, "F": Fi, "R": R,
            "batch": BATCH, "inverse": inverse,
            "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "ms": ms, "stage_sum_ms": sum(stages), "largest_stage_ms": max(stages)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--inverse", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    n = int(os.environ.get("LVL_N", str(1 << 20)))
    lvl = int(os.environ.get("LVL_IDX", "0"))
    print(json.dumps(run(n, lvl, args.inverse, args.reps, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
