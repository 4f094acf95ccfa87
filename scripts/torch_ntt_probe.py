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

``--backend pipe``: every pipelined level alone (csrc/ntt_pipe.cu) at phase
3's pipe shapes (the factor walk's levels of each transform, each fed the
previous level's output), each held equal to ``level_plain`` on the same
input, with the same readings per level and its launches per call.
``--variants`` (pipe only) times, per field at level 0 of every phase-3
pipe shape, of coset_ifft's ifft (6, 2^21) and of the narrow fft at 2^21
(the prover's level-0 sizes) and
at level 1 of the wide fft, W's rows against its two-table split in turns,
each held equal to ``level_plain``.

The last line is one JSON object with every reading. Exits 1 on any
inequality, or if a call launches another number of kernels than it should.

    python3 scripts/torch_ntt_probe.py [--backend four_step]     # on the GPU host
    python3 scripts/torch_ntt_probe.py --device cpu --max-log-n 12   # dry run
    python3 scripts/torch_ntt_probe.py --backend four_step --device cpu --max-log-n 15
    python3 scripts/torch_ntt_probe.py --backend four_step --batches 3,6,12,24
    python3 scripts/torch_ntt_probe.py --backend pipe [--batches 3,6,12,24] [--variants]
    python3 scripts/torch_ntt_probe.py --backend pipe --device cpu --max-log-n 14

``--batches`` reads how a pass's (or level's) bound_frac moves with the
batch alone (the grid's waves and each launch's fixed cost against its
work).

A dry run on the CPU cuts every size to 2^max_log_n (the four-step's at
least 2^14) and holds the kernels' route, replayed in torch ops
(``ntt.transform_passes_plain``, ``ntt_four_step.pass1_replay`` /
``pass2_replay``, ``ntt_pipe.level_replay``), against the plain versions;
it states no device metric.
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
from ministark_tpu_torch.ops import ntt_pipe as pp
from ministark_tpu_torch.utils import roofline as rf

SEED = 20261017
# a checkout from before the level's redesign (the parent, read in turns):
# its coset level copies a table to the card in each call
PARENT = not hasattr(pp, "level_replay")


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


def _reading(fn, reps, device, work, may_sync=False):
    """(ms, device_ms, bound_ms, bound_by, bound_frac) of one call; device
    ms and bound_frac are None on the CPU, and, with ``may_sync``, where a
    call waits for the device (a host-to-device copy inside it), so that
    its calls cannot queue behind a device sleep."""
    on_card = torch.device(device).type == "cuda"
    ms = rf.time_ms(fn, reps, device)
    dms = None
    if on_card:
        try:
            dms = rf.device_ms(fn, reps)
        except RuntimeError as e:
            if not may_sync:
                raise
            print(f"device ms not measured: {e}", flush=True)
    bms, by = rf.bound(*work)
    return ms, dms, bms, by, (None if dms is None else bms / dms)


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


def pipe_shapes(field, batches=()):
    """chip_smoke.py's pipe shapes for this field (its four-step shapes but
    coset_ifft, whose post power the pipe's levels do not take)."""
    return [s for s in four_step_shapes(field, batches) if "post" not in s[3]]


def pipe_levels(x, field, kw):
    """(label suffix, args of ``level_plain``, work, the kernel's keywords
    as ``ntt_pipe.transform`` gives them) of each level of one transform of
    ``x``, each fed the previous level's plain output."""
    batch, n = x.shape
    inverse, pre = bool(kw.get("inverse")), kw.get("pre")
    tag = ntt.ntt_field(field).tag
    levels = pp._tables(n, inverse, x.device, field)
    # the parent, read in turns, has no split: its kernel reads W's rows
    splits = ([None] * len(levels) if PARENT
              else pp.level_splits(n, inverse, x.device, field))
    scale = ntt.inv_n(field, n) if inverse else None
    y, out = x, []
    for i, ((Fi, tw, W, k_prod), split) in enumerate(zip(levels, splits)):
        last = i == len(levels) - 1
        args = (y.reshape(batch, Fi, n // Fi), tw, pre if i == 0 else None, W,
                k_prod, scale if last else None, field)
        muls = int(i == 0 and pre is not None) + int(W is not None) + int(last and inverse)
        # products by 1: s^0, and the twiddles W that are w^0
        ones = int(i == 0 and pre is not None) + (
            0 if W is None else int((W == 1).sum()) * k_prod)
        out.append((f"level {i} (F {Fi})", args,
                    rf.pass_work(batch, n, Fi.bit_length() - 1, muls, tag, ones),
                    {} if split is None else {"w_split": split}))
        y = pp.level_plain(*args)
    return out


def run_pipe(device="cuda", max_log_n=30, reps=20, batches=()):
    """Each pipelined level alone against its plain version, per field and
    shape; on the CPU the replayed route against the plain level."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from ministark_tpu_torch.ops import cuda

        cuda.library()
    rng = np.random.default_rng(SEED)
    out = {"probe": "ntt_pipe", "device": (torch.cuda.get_device_name(0)
                                           if on_card else "cpu"),
           "shapes": [], "equal": True}
    kern = pp.level_cuda if on_card else pp.level_replay
    for field, tag in ((GOLDILOCKS_FP, "gl"), (BABYBEAR_FP, "bb")):
        for label, batch, log_n, kw in pipe_shapes(field, batches):
            log_n = max(14, min(log_n, max_log_n))
            v = rng.integers(0, field.p, size=(batch, 1 << log_n), dtype=np.uint64)
            x = torch.from_numpy(v.view(np.int64)).to(device)
            for name, args, work, kwargs in pipe_levels(x, field, kw):
                fn = lambda: kern(*args, **kwargs)  # noqa: E731
                equal = torch.equal(fn(), pp.level_plain(*args))
                before = pp.launches[tag]
                fn()
                launches = pp.launches[tag] - before if on_card else None
                out["equal"] &= equal and launches in (None, 1)
                ms, dms, bms, by, frac = _reading(fn, reps, device, work, PARENT)
                out["shapes"].append({
                    "field": tag, "shape": label, "level": name, "log_n": log_n,
                    "equal": equal, "launches_per_call": launches, "ms": ms,
                    "device_ms": dms, "bound_ms": bms, "bound_by": by,
                    "bound_frac": frac})
                print(f"pipe_level_{tag} {label} {name} (n 2^{log_n}): "
                      f"{'equal' if equal else 'DIFFERS'}, {ms:.4f} ms"
                      + ((f", {launches} launch(es) per call, device "
                          + ("not measured" if dms is None else f"{dms:.4f} ms")
                          + f", bound {bms:.4f} ms ({by})"
                          + ("" if frac is None else f", bound_frac {frac:.3f}"))
                         if on_card else " (host clock)"), flush=True)
    return out


def run_pipe_variants(device="cuda", reps=20, rounds=3):
    """W's rows against its two-table split (``w_split_tables``), per
    field, at level 0 of every phase-3 pipe shape, of coset_ifft's ifft
    (6, 2^21) and of the narrow fft (2 GL, 4 BB) at 2^21, and at level 1 of
    the wide fft: each held equal
    to ``level_plain``, then timed in ``rounds`` rounds of turns (the order
    reversed every other round), with every reading and the median of each
    ("ms": device ms on the card; on the CPU the host clock of the replay,
    at level 0 of coset_fft (6, 2^14) alone)."""
    import statistics

    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(SEED)
    out = {"probe": "ntt_pipe_variants",
           "device": torch.cuda.get_device_name(0) if on_card else "cpu",
           "equal": True, "shapes": []}
    for field, tag in ((GOLDILOCKS_FP, "gl"), (BABYBEAR_FP, "bb")):
        narrow, wide = (2, 12) if field is GOLDILOCKS_FP else (4, 24)
        cases = [(label, batch, log_n, kw, 0)
                 for label, batch, log_n, kw in pipe_shapes(field)]
        cases += [("ifft (6, 2^21)", 6, 21, {"inverse": True}, 0),   # coset_ifft's
                  (f"fft ({narrow}, 2^21)", narrow, 21, {}, 0),
                  (f"fft ({wide}, 2^21)", wide, 21, {}, 1)]
        if not on_card:
            cases = [(label.replace("2^21", "2^14"), batch, 14, kw, level)
                     for label, batch, _, kw, level in cases if "pre" in kw]
        for label, batch, log_n, kw, level in cases:
            split = pp.w_split_tables(1 << log_n, bool(kw.get("inverse")), device,
                                      field)[level]
            v = rng.integers(0, field.p, size=(batch, 1 << log_n), dtype=np.uint64)
            x = torch.from_numpy(v.view(np.int64)).to(device)
            _, args, work, _ = pipe_levels(x, field, kw)[level]
            bms, by = rf.bound(*work)
            want = pp.level_plain(*args)
            kern = pp.level_cuda if on_card else pp.level_replay
            fns = {"W rows": lambda: kern(*args),
                   "W split": lambda s=split: kern(*args, w_split=s)}
            row = {"field": tag, "shape": f"{label} level {level}", "bound_ms": bms,
                   "bound_by": by, "variants": {}}
            for name, fn in fns.items():
                equal = torch.equal(fn(), want)
                out["equal"] &= equal
                row["variants"][name] = {"equal": equal, "ms": []}
            for i in range(rounds):
                for name in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
                    ms = (rf.device_ms(fns[name], reps) if on_card
                          else rf.time_ms(fns[name], reps, device))
                    row["variants"][name]["ms"].append(ms)
            for name, r in row["variants"].items():
                r["median_ms"] = statistics.median(r["ms"])
                print(f"pipe_level_{tag} {row['shape']}, {name}: "
                      f"{'equal' if r['equal'] else 'DIFFERS'}, "
                      + ("device" if on_card else "host clock")
                      + f" {r['median_ms']:.4f} ms (median of {rounds}; "
                      + ", ".join(f"{t:.4f}" for t in r["ms"]) + ")"
                      + (f", bound_frac {bms / r['median_ms']:.3f}" if on_card else ""),
                      flush=True)
            out["shapes"].append(row)
            del x, args, want
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
    ap.add_argument("--backend", choices=("radix2", "four_step", "pipe"),
                    default="radix2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-log-n", type=int, default=30)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batches", default="",
                    help="four_step and pipe: ifft at 2^20 and 2^21 at these batch "
                         "sizes (comma-separated) in place of phase 3's shapes")
    ap.add_argument("--variants", action="store_true",
                    help="pipe only: W's rows against its split, in turns")
    ap.add_argument("--rounds", type=int, default=3,
                    help="--variants: rounds of turns")
    args = ap.parse_args(argv)
    batches = tuple(int(b) for b in args.batches.split(",") if b)
    if batches and args.backend == "radix2":
        ap.error("--batches takes --backend four_step or pipe")
    if args.variants and args.backend != "pipe":
        ap.error("--variants takes --backend pipe")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for a dry run", file=sys.stderr)
        return 1
    if args.variants:
        out = run_pipe_variants(args.device, args.reps, args.rounds)
    else:
        probe = {"four_step": run_four_step, "pipe": run_pipe}.get(args.backend, run)
        out = probe(args.device, args.max_log_n, args.reps, batches)
    print(json.dumps(out), flush=True)
    return 0 if out["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
