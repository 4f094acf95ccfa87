#!/usr/bin/env python3
"""chip_smoke.py's phase-3 rows of the BabyBear kernels, for one checkout.

    python3 scripts/torch_bb_kernels_ab.py [--root DIR] [--phase NAME ...]

Loads DIR's chip_smoke.py (default: the checkout holding this script) with
DIR's ministark_tpu_torch first on the path, builds that checkout's
kernels, and runs its phases that hold BabyBear's kernels against their
plain versions at the main paths' shapes (``phase_kernels_bb``: the NTTs,
the leaf hash, the BabyBear rows; ``phase_kernels_field_ew``;
``phase_kernels_div_scan``; ``phase_kernels_first_match``;
``phase_kernels_witness``, the device witnesses; their Goldilocks rows come
along and read as the control; ``--phase``, given once or more, runs only
those). It prints one JSON line: the
root, the card's name and power limit (nvidia-smi), and each kernel's rows
(shape, event ms, device ms, bound ms by that checkout's bound model,
bound_frac). Run it for a parent checkout unpacked beside this one and for
this one, in one call on one card, to compare the two storages. A row that
differs from its plain version fails as in chip_smoke.py (exit 1). Needs a
CUDA device.
"""

import argparse
import importlib.util
import json
import os
import sys

PHASES = ("phase_kernels_bb", "phase_kernels_field_ew", "phase_kernels_div_scan",
          "phase_kernels_first_match", "phase_kernels_witness")
KEEP = ("shape", "ms", "device_ms", "warm_device_ms", "bound_ms", "bound_by",
        "bound_frac")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--phase", action="append", choices=PHASES)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = cs.phase_gpu()
    from ministark_tpu_torch.utils import roofline

    cs.rf = roofline
    cs.phase_build()
    results = {name: {"max_abs_err": 0, "shapes": [], "paths": {}} for name in cs.KERNELS}
    for phase in args.phase or PHASES:
        getattr(cs, phase)(results)
    rows = {name: [{k: s[k] for k in KEEP if k in s} for s in r["shapes"]]
            for name, r in results.items() if r["shapes"]}
    print(json.dumps({"root": root, "gpu": smi, "kernels": rows}), flush=True)


if __name__ == "__main__":
    main()
