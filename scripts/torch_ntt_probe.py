"""How close is the radix-2 NTT kernel (csrc/ntt.cu) to its bound?

Builds the kernels, then for Goldilocks and BabyBear at the radix-2 shapes
that chip_smoke.py's phase 3 holds (the main paths' transforms, and a
three-pass 2^23 per field) checks ``ntt.transform_cuda`` equal to
``ntt.transform_plain`` on the same seeded input and prints, per shape, the
event-timed ms, ``device_ms`` (the calls queued behind a device sleep), the
bound and ``bound_frac`` from ``utils/roofline.py`` and the passes one
call launched (``ntt.pass_launches``, counted by csrc/ntt.cu) beside the
passes of its plan (``ntt.pass_plan``). The last line is one JSON object
with every reading. Exits 1 on any inequality, or if a call launches
another number of passes than its plan has.

    python3 scripts/torch_ntt_probe.py                 # on the GPU host
    python3 scripts/torch_ntt_probe.py --device cpu --max-log-n 12   # dry run

A dry run on the CPU cuts every size to 2^max_log_n and holds the kernel's
plan, replayed in torch ops (``ntt.transform_passes_plain``), against the
plain transform; it states no device metric.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ministark_tpu_torch.fields import BABYBEAR_FP, GOLDILOCKS_FP
from ministark_tpu_torch.ops import ntt
from ministark_tpu_torch.utils import roofline as rf

SEED = 20261017


def shapes(field):
    """(label, batch, log n, transform keywords): chip_smoke.py's radix-2
    lists for this field."""
    shift = 0x1234567 * 7 % field.p
    if field is GOLDILOCKS_FP:
        return [("ifft (3, 2^20)", 3, 20, {"inverse": True}),
                ("coset_fft (6, 2^21)", 6, 21, {"pre": shift}),
                ("fft (2, 2^21)", 2, 21, {}),
                ("fft (12, 2^21)", 12, 21, {}),
                ("fft (2, 2^3)", 2, 3, {}),
                ("coset_ifft (2, 2^14)", 2, 14, {"inverse": True, "post": shift}),
                ("fft (1, 2^23) (three passes)", 1, 23, {})]
    return [("ifft (3, 2^20)", 3, 20, {"inverse": True}),
            ("coset_fft (6, 2^21)", 6, 21, {"pre": shift}),
            ("fft (4, 2^21)", 4, 21, {}),
            ("fft (4, 2^14)", 4, 14, {}),
            ("fft (24, 2^21)", 24, 21, {}),
            ("coset_ifft (1, 2^23) (three passes)", 1, 23,
             {"inverse": True, "post": shift})]


def run(device="cuda", max_log_n=30, reps=20):
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from ministark_tpu_torch.ops import cuda

        cuda.library()
    rng = np.random.default_rng(SEED)
    out = {"probe": "ntt_radix2", "device": (torch.cuda.get_device_name(0)
                                             if on_card else "cpu"),
           "max_pass_log": ntt.MAX_PASS_LOG, "shapes": [], "equal": True}
    for field, tag in ((GOLDILOCKS_FP, "gl"), (BABYBEAR_FP, "bb")):
        for label, batch, log_n, kw in shapes(field):
            log_n = min(log_n, max_log_n)
            n = 1 << log_n
            v = rng.integers(0, field.p, size=(batch, n), dtype=np.uint64)
            x = torch.from_numpy(v.view(np.int64)).to(device)
            if on_card:
                fn = lambda: ntt.transform_cuda(x, **kw, field=field)  # noqa: E731
            else:
                fn = lambda: ntt.transform_passes_plain(x, **kw, field=field)  # noqa: E731
            equal = torch.equal(fn(), ntt.transform_plain(x, **kw, field=field))
            passes = len(ntt.pass_plan(log_n))
            launches = None
            if on_card:
                before = ntt.pass_launches[tag]
                fn()
                launches = ntt.pass_launches[tag] - before
            out["equal"] &= equal and launches in (None, passes)
            bms, by = rf.bound(*rf.ntt_work(batch, n, "pre" in kw,
                                            bool(kw.get("inverse")), tag))
            ms = rf.time_ms(fn, reps, device)
            dms = rf.device_ms(fn, reps) if on_card else None
            row = {"field": tag, "shape": label, "log_n": log_n, "equal": equal,
                   "passes": passes, "launches_per_call": launches, "ms": ms,
                   "device_ms": dms, "bound_ms": bms, "bound_by": by,
                   "bound_frac": bms / dms if on_card else None}
            out["shapes"].append(row)
            print(f"ntt_{tag} {label} (n 2^{log_n}): "
                  f"{'equal' if equal else 'DIFFERS'}, {passes} pass(es), {ms:.4f} ms"
                  + (f", {launches} launch(es) per call, device {dms:.4f} ms, "
                     f"bound {bms:.4f} ms ({by}), bound_frac {bms / dms:.3f}"
                     if on_card else " (host clock)"),
                  flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-log-n", type=int, default=30)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for a dry run", file=sys.stderr)
        return 1
    out = run(args.device, args.max_log_n, args.reps)
    print(json.dumps(out), flush=True)
    return 0 if out["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
