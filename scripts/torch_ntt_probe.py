"""How close are the NTT kernels to their bound?

``--backend radix2`` (the default): builds the kernels, then for Goldilocks
and BabyBear at the radix-2 shapes that chip_smoke.py's phase 3 holds (the
main paths' transforms, and a three-pass 2^23 per field) checks
``ntt.transform_cuda`` equal to ``ntt.transform_plain`` on the same seeded
input and prints, per shape, the event-timed ms, ``device_ms`` (the calls
queued behind a device sleep), the bound and ``bound_frac`` from
``utils/roofline.py`` and the passes one call launched
(``ntt.pass_launches``, counted by csrc/ntt.cu) beside the passes of its
plan (``ntt.pass_plan``).

``--backend four_step``: the two four-step passes alone
(csrc/ntt_four_step.cu) at phase 3's four-step shapes, each held equal to
its plain version (``pass1_plain`` / ``pass2_plain``) on the same input, with
the same readings per pass and its launches per call.

The last line is one JSON object with every reading. Exits 1 on any
inequality, or if a call launches another number of kernels than it should.

    python3 scripts/torch_ntt_probe.py [--backend four_step]     # on the GPU host
    python3 scripts/torch_ntt_probe.py --device cpu --max-log-n 12   # dry run
    python3 scripts/torch_ntt_probe.py --backend four_step --device cpu --max-log-n 15
    python3 scripts/torch_ntt_probe.py --backend four_step --batches 3,6,12,24

``--batches`` reads how a pass's bound_frac moves with the batch alone (the
grid's waves and each launch's fixed cost against its work).

A dry run on the CPU cuts every size to 2^max_log_n (the four-step's at
least 2^14) and holds the kernels' route, replayed in torch ops
(``ntt.transform_passes_plain``, ``ntt_four_step.pass1_replay`` /
``pass2_replay``), against the plain versions; it states no device metric.
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
from ministark_tpu_torch.ops import ntt_four_step as fs
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


def four_step_shapes(field, batches=()):
    """chip_smoke.py's four-step shapes for this field: (label, batch,
    log n, transform keywords); with ``batches``, ifft at 2^20 and 2^21 at
    each of those batch sizes instead."""
    if batches:
        return [(f"ifft ({b}, 2^{log_n})", b, log_n, {"inverse": True})
                for log_n in (20, 21) for b in batches]
    shift = 0x1234567 * 7 % field.p
    wide = 12 if field is GOLDILOCKS_FP else 24
    return [("ifft (3, 2^20)", 3, 20, {"inverse": True}),
            ("coset_fft (6, 2^21)", 6, 21, {"pre": shift}),
            (f"fft ({wide}, 2^21)", wide, 21, {}),
            ("coset_ifft (6, 2^21)", 6, 21, {"inverse": True, "post": shift})]


def _reading(fn, reps, device, work):
    """(ms, device_ms, bound_ms, bound_by, bound_frac) of one call."""
    on_card = torch.device(device).type == "cuda"
    ms = rf.time_ms(fn, reps, device)
    dms = rf.device_ms(fn, reps) if on_card else None
    bms, by = rf.bound(*work)
    return ms, dms, bms, by, (bms / dms if on_card else None)


def run_four_step(device="cuda", max_log_n=30, reps=20, batches=()):
    """Each four-step pass alone against its plain version, per field and
    shape; on the CPU the replayed route against the plain passes."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from ministark_tpu_torch.ops import cuda

        cuda.library()
    rng = np.random.default_rng(SEED)
    out = {"probe": "ntt_four_step", "device": (torch.cuda.get_device_name(0)
                                                if on_card else "cpu"),
           "shapes": [], "equal": True}
    for field, tag in ((GOLDILOCKS_FP, "gl"), (BABYBEAR_FP, "bb")):
        for label, batch, log_n, kw in four_step_shapes(field, batches):
            log_n = max(14, min(log_n, max_log_n))
            n = 1 << log_n
            n1, n2 = fs._split_sizes(n)
            v = rng.integers(0, field.p, size=(batch, n), dtype=np.uint64)
            x = torch.from_numpy(v.view(np.int64)).to(device)
            inverse, pre, post = bool(kw.get("inverse")), kw.get("pre"), kw.get("post")
            scale = ntt.inv_n(field, n) if inverse else None
            tw1, tw2, wpow = fs._tables(n, inverse, x.device, field)
            c = fs.pass1_plain(x, tw2, wpow, pre, field)
            p1, p2 = ((fs.pass1_cuda, fs.pass2_cuda) if on_card
                      else (fs.pass1_replay, fs.pass2_replay))
            work1, work2 = rf.four_step_work(batch, n1, n2, pre is not None,
                                             inverse or post is not None, tag)
            passes = [
                ("pass1", fs.pass1_launches, lambda: p1(x, tw2, wpow, pre, field),
                 lambda: fs.pass1_plain(x, tw2, wpow, pre, field), work1),
                ("pass2", fs.pass2_launches, lambda: p2(c, tw1, scale, post, field),
                 lambda: fs.pass2_plain(c, tw1, scale, post, field), work2),
            ]
            for name, counter, fn, plain, work in passes:
                equal = torch.equal(fn(), plain())
                before = counter[tag]
                fn()
                launches = counter[tag] - before if on_card else None
                out["equal"] &= equal and launches in (None, 1)
                ms, dms, bms, by, frac = _reading(fn, reps, device, work)
                out["shapes"].append({
                    "field": tag, "shape": label, "pass": name, "log_n": log_n,
                    "equal": equal, "launches_per_call": launches, "ms": ms,
                    "device_ms": dms, "bound_ms": bms, "bound_by": by,
                    "bound_frac": frac})
                print(f"four_step {name}_{tag} {label} (n 2^{log_n}): "
                      f"{'equal' if equal else 'DIFFERS'}, {ms:.4f} ms"
                      + (f", {launches} launch(es) per call, device {dms:.4f} ms, "
                         f"bound {bms:.4f} ms ({by}), bound_frac {frac:.3f}"
                         if on_card else " (host clock)"), flush=True)
    return out


def run(device="cuda", max_log_n=30, reps=20, batches=()):
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
    ap.add_argument("--backend", choices=("radix2", "four_step"), default="radix2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-log-n", type=int, default=30)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batches", default="",
                    help="four_step only: ifft at 2^20 and 2^21 at these batch "
                         "sizes (comma-separated) in place of phase 3's shapes")
    args = ap.parse_args(argv)
    batches = tuple(int(b) for b in args.batches.split(",") if b)
    if batches and args.backend != "four_step":
        ap.error("--batches takes --backend four_step")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for a dry run", file=sys.stderr)
        return 1
    probe = run_four_step if args.backend == "four_step" else run
    out = probe(args.device, args.max_log_n, args.reps, batches)
    print(json.dumps(out), flush=True)
    return 0 if out["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
