"""Stage costs of one NTT level in its digit-matmul form, on the card.

The port's twin of scripts/tpu_fused_stage_probe.py. At one level of a
factor walk it times the three stages alone (digitize; the int8 dot against
the level's digit matrix; recombine with the inter-level twiddle), the fused
level, and the butterfly level (``ntt_pipe.level``) on the same input, each
with its event ms (CUDA events around ``--reps`` launches after a warm-up),
its device ms (``utils/roofline.py::device_ms``: the launches queued behind
a device sleep), its bound and ``bound_frac`` = bound / device ms; the dot
also beside ``torch._int_mm`` with the matrix row-major and column-major.
Before any timing the stage chain, the fused level and the butterfly level
must be equal, element for element. Prints a line per reading, then one
JSON line.

    LVL_N=1048576 LVL_IDX=0 python3 scripts/torch_digit_stage_probe.py [--inverse]
    python3 scripts/torch_digit_stage_probe.py --shapes f32,ifft20,fft21,dot4096
    python3 scripts/torch_digit_stage_probe.py --shapes ifft20 --batches 2,4,8,16
    python3 scripts/torch_digit_stage_probe.py --root DIR --shapes ifft20
    LVL_N=16384 python3 scripts/torch_digit_stage_probe.py --device cpu  # dry run

Shapes (``chip_smoke.py`` phase 3's): ``f32`` B 2, F 32, R 4096, PF 128;
``ifft20`` the three levels of ifft 2^20 at B 2 (or each of ``--batches``);
``fft21`` the three levels of fft 2^21 at B 12 (the fast prover's LDE);
``dot4096`` the dot alone, (1, 4096, 4096) x (4096, 4096). ``--root`` runs
another checkout's package (a parent commit unpacked under the gitignored
``ministark_tpu_torch/_build/``) with this script, for turns in one call.
On the CPU (``--device cpu``) the fused level and the dot run as their
kernels' replays (``ntt_digit.level_replay`` / ``digit_dot_replay``) against
the plain versions, with host times only.
"""

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--root" in sys.argv:
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--root") + 1]))
else:
    sys.path.insert(0, _HERE)

import numpy as np
import torch

from ministark_tpu_torch.fields import GOLDILOCKS_FP
from ministark_tpu_torch.ops import ntt, ntt_digit, ntt_pipe
from ministark_tpu_torch.utils import roofline as rf

BATCH = 2


def _reading(fn, work, reps, dev, extra=None):
    """{ms, device_ms, bound_ms, bound_by, bound_frac} of one call."""
    out = {"ms": rf.time_ms(fn, reps, dev)}
    bms, by = rf.bound(*work)
    out.update(bound_ms=bms, bound_by=by)
    if dev.type == "cuda":
        dms = rf.device_ms(fn, reps)
        out.update(device_ms=dms, bound_frac=bms / dms)
    else:                                      # a dry run: no device metric
        out.update(device_ms=None, bound_frac=None)
    out.update(extra or {})
    return out


def _values(shape, seed, dev):
    p = GOLDILOCKS_FP.p
    v = np.random.default_rng(seed).integers(0, p, size=shape, dtype=np.uint64)
    v.reshape(-1)[:5] = (0, 1, ntt_digit.GL_CENTER_T, ntt_digit.GL_CENTER_T + 1, p - 1)
    return torch.from_numpy(v.view(np.int64)).to(dev)


def level_readings(label, x, vd, tw, W, k_prod, reps, dev):
    """Every stage, the fused level and the butterfly level at one shape."""
    B, Fi, R = x.shape
    K, N = vd.shape
    rows = 0 if W is None else W.shape[0]
    cpu = dev.type != "cuda"
    d = ntt_digit.digitize(x)
    dot = (lambda: ntt_digit.digit_dot_replay(d, vd)) if cpu else \
        (lambda: ntt_digit.digit_dot(d, vd))
    fused = (lambda: ntt_digit.level_replay(x, vd, W, k_prod)) if cpu else \
        (lambda: ntt_digit.level(x, vd, W, k_prod))
    Rm = dot()
    chain = ntt_digit.recombine(Rm, Fi, W, k_prod)
    if not torch.equal(Rm, ntt_digit.digit_dot_plain(d, vd)):
        raise AssertionError(f"{label}: the dot differs from its plain version")
    if not (torch.equal(chain, fused()) and
            torch.equal(chain, ntt_pipe.level(x, tw, None, W, k_prod))):
        raise AssertionError(f"{label}: the stage chain, the fused level and the "
                             "butterfly level disagree")
    lib = {}
    if not cpu:                    # torch._int_mm wants (R, K) rows of digits
        d_rows = d.transpose(1, 2).contiguous()
        vd_col = vd.t().contiguous().t()
        lib = {"int_mm_row_ms": rf.time_ms(
                   lambda: [torch._int_mm(d_rows[b], vd) for b in range(B)], reps, dev),
               "int_mm_col_ms": rf.time_ms(
                   lambda: [torch._int_mm(d_rows[b], vd_col) for b in range(B)],
                   reps, dev)}
    out = {
        "digitize": _reading(lambda: ntt_digit.digitize(x),
                             rf.digitize_work(B, Fi, R), reps, dev),
        "dot": _reading(dot, rf.digit_dot_work(B, K, R, N), reps, dev, lib),
        "recombine_twiddle": _reading(lambda: ntt_digit.recombine(Rm, Fi, W, k_prod),
                                      rf.recombine_work(B, R, Fi, rows), reps, dev),
        "fused_level": _reading(fused, rf.digit_level_work(B, Fi, R, rows), reps, dev),
        "butterfly_level": _reading(
            lambda: ntt_pipe.level(x, tw, None, W, k_prod),
            rf.pass_work(B, Fi * R, Fi.bit_length() - 1, int(W is not None), "gl",
                         0 if W is None else int((W == 1).sum()) * k_prod), reps, dev),
    }
    for k, r in out.items():
        print(f"{label} {k}: {r['ms']:.4f} ms"
              + ("" if r["device_ms"] is None else
                 f", device {r['device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                 f"({r['bound_by']}), bound_frac {r['bound_frac']:.3f}")
              + "".join(f", {k2} {r[k2]:.4f}" for k2 in ("int_mm_row_ms", "int_mm_col_ms")
                        if k2 in r), flush=True)
    return out


def run(n=1 << 20, lvl=0, inverse=False, reps=20, device="cuda", seed=7, batch=BATCH):
    """Level ``lvl`` of the factor walk of size ``n`` at ``batch``: the
    readings (``ms``: event ms by stage, as before; ``readings``: every
    reading) as a dict."""
    dev = torch.device(device)
    levels = ntt_digit.level_tables(n, inverse, dev)
    Fi, vd, W, k_prod = levels[lvl]
    _, tw, _, _ = ntt_pipe._tables(n, inverse, dev)[lvl]
    R = n // Fi
    label = (f"{'ifft' if inverse else 'fft'} 2^{n.bit_length() - 1} B {batch} "
             f"level {lvl} (F {Fi})")
    print(f"{label}: factors={[f for f, _, _, _ in levels]} R={R} "
          f"PF={vd.shape[1] // 8} twiddle={'yes' if W is not None else 'no'}",
          flush=True)
    x = _values((batch, Fi, R), seed, dev)
    out = level_readings(label, x, vd, tw, W, k_prod, reps, dev)
    ms = {k: r["ms"] for k, r in out.items()}
    stages = [ms["digitize"], ms["dot"], ms["recombine_twiddle"]]
    return {"probe": "digit_stage", "label": label, "n": n, "level": lvl, "F": Fi,
            "R": R, "batch": batch, "inverse": inverse,
            "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "ms": ms, "readings": out, "stage_sum_ms": sum(stages),
            "largest_stage_ms": max(stages)}


def run_f32(reps, device, seed=7):
    """B 2, F 32, R 4096 with the 128-column plane stride, no twiddle."""
    dev = torch.device(device)
    F, R = 32, 4096
    root = GOLDILOCKS_FP.get_root_of_unity(F)
    vd = ntt_digit.digit_matrix(root, F, dev, 128)
    tw = ntt.stage_table(GOLDILOCKS_FP, root, F, dev)
    x = _values((BATCH, F, R), seed, dev)
    label = "F 32, R 4096, PF 128"
    return {"label": label, "readings": level_readings(label, x, vd, tw, None, 1,
                                                        reps, dev)}


def run_dot4096(reps, device, seed=7):
    """The kernel bench's product: one K-major (4096, 4096) operand against a
    (4096, 4096) matrix, random int8 over the full range."""
    dev = torch.device(device)
    dm = 4096 if dev.type == "cuda" else 256
    rng = np.random.default_rng(seed)
    a8 = torch.from_numpy(rng.integers(-128, 128, size=(1, dm, dm)).astype(np.int8)).to(dev)
    b8 = torch.from_numpy(rng.integers(-128, 128, size=(dm, dm)).astype(np.int8)).to(dev)
    cpu = dev.type != "cuda"
    dot = (lambda: ntt_digit.digit_dot_replay(a8, b8)) if cpu else \
        (lambda: ntt_digit.digit_dot(a8, b8))
    if not torch.equal(dot(), ntt_digit.digit_dot_plain(a8, b8)):
        raise AssertionError("the dot differs from its plain version")
    lib = {}
    if not cpu:
        a_rows = a8[0].T.contiguous()
        b_col = b8.t().contiguous().t()
        lib = {"int_mm_row_ms": rf.time_ms(lambda: torch._int_mm(a_rows, b8), reps, dev),
               "int_mm_col_ms": rf.time_ms(lambda: torch._int_mm(a_rows, b_col), reps,
                                           dev)}
    label = f"dot (1, {dm}, {dm}) x ({dm}, {dm})"
    r = _reading(dot, rf.digit_dot_work(1, dm, dm, dm), reps, dev, lib)
    print(f"{label}: {r['ms']:.4f} ms" + ("" if r["device_ms"] is None else
          f", device {r['device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, bound_frac "
          f"{r['bound_frac']:.3f}, int_mm row {lib['int_mm_row_ms']:.4f} / col "
          f"{lib['int_mm_col_ms']:.4f} ms"), flush=True)
    return {"label": label, "readings": {"dot": r}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--inverse", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", default="",
                    help="comma list of f32, ifft20, fft21, dot4096")
    ap.add_argument("--batches", default="",
                    help="comma list of batch sizes for ifft20 (default 2)")
    ap.add_argument("--root", default=None,
                    help="the checkout whose ministark_tpu_torch runs")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: use --device cpu for the dry run", file=sys.stderr)
        return 1
    if not args.shapes:
        n = int(os.environ.get("LVL_N", str(1 << 20)))
        lvl = int(os.environ.get("LVL_IDX", "0"))
        print(json.dumps(run(n, lvl, args.inverse, args.reps, args.device)), flush=True)
        return 0
    cpu = args.device != "cuda"
    n20, n21 = (1 << 14, 1 << 15) if cpu else (1 << 20, 1 << 21)
    batches = [int(b) for b in args.batches.split(",") if b] or [BATCH]
    results = []
    for shape in args.shapes.split(","):
        if shape == "f32":
            results.append(run_f32(args.reps, args.device))
        elif shape == "ifft20":
            results += [run(n20, lvl, True, args.reps, args.device, batch=b)
                        for b in batches for lvl in range(len(
                            ntt_digit.level_tables(n20, True, args.device)))]
        elif shape == "fft21":
            results += [run(n21, lvl, False, args.reps, args.device, batch=12)
                        for lvl in range(len(
                            ntt_digit.level_tables(n21, False, args.device)))]
        elif shape == "dot4096":
            results.append(run_dot4096(args.reps, args.device))
        else:
            ap.error(f"unknown shape {shape!r}")
    print(json.dumps({"probe": "digit_stage", "root": args.root or _HERE,
                      "device": torch.cuda.get_device_name(0) if not cpu else "cpu",
                      "results": [{"label": r["label"], "readings": r["readings"]}
                                  for r in results]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
