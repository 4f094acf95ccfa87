"""Which collectives does gloo carry for ranks that share one card?

Two ranks on one device, a gloo group made by
``ministark_tpu_torch/parallel/launch.py``: each calls
``all_to_all_single``, ``all_gather_into_tensor`` and ``broadcast`` on
int64 tensors on the device directly (values at and above 2^62 among
them), checks what arrives, and times the mesh's own collectives
(``parallel/mesh.py``, the device's tensors handed to the backend) at the
sharded LDE's size, (6, 2^21) int64 split over the ranks, beside the same
collectives staged through host memory (copied to the CPU and back), the
transport a backend that refuses device tensors would need. Prints one
JSON line: per collective "ok", "wrong values" or the error, and the times
in ms.

    python3 scripts/torch_dist_probe.py                 # on the GPU host
    python3 scripts/torch_dist_probe.py --device cpu --log-n 12   # dry run
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.distributed as dist

from ministark_tpu_torch.parallel import launch
from ministark_tpu_torch.parallel.mesh import all_gather_rows, all_to_all_rows

BIG = 1 << 62


def _direct(mesh):
    """Each collective on the device's tensors, called on dist directly."""
    D, r, dev = mesh.size, mesh.rank, mesh.device
    base = torch.arange(4 * D, dtype=torch.int64, device=dev) + BIG
    cases = {}

    def a2a():
        src = (base + 1000 * r).reshape(D, 4)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        want = torch.stack([(base + 1000 * s).reshape(D, 4)[r] for s in range(D)])
        return torch.equal(out, want)

    def gather():
        src = (base + 1000 * r)[None]        # the concatenated form
        out = src.new_empty((D,) + tuple(base.shape))
        dist.all_gather_into_tensor(out, src)
        return torch.equal(out, torch.stack([base + 1000 * s for s in range(D)]))

    def bcast():
        x = base + 1000 * r
        dist.broadcast(x, 0)
        return torch.equal(x, base)

    for name, call in (("all_to_all_single", a2a), ("all_gather_into_tensor", gather),
                       ("broadcast", bcast)):
        try:
            cases[name] = "ok" if call() else "wrong values"
        except Exception as e:   # the probe's answer: this collective's error
            cases[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
    return cases


def _timed(mesh, fn, x, reps):
    fn(mesh, x)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(mesh, x)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps * 1e3


def _staged(collective):
    def call(mesh, x):
        return collective(mesh, x.cpu()).to(mesh.device)
    return call


def _probe(mesh, log_n, reps):
    out = {"rank": mesh.rank, "backend": mesh.backend, "direct": _direct(mesh)}
    D = mesh.size
    rows = torch.full((6 * (1 << log_n) // D,), mesh.rank, dtype=torch.int64,
                      device=mesh.device) + BIG
    got, out["all_gather_rows_ms"] = _timed(mesh, all_gather_rows, rows, reps)
    assert bool((got[:, 0] - BIG == torch.arange(D, device=mesh.device)).all())
    got, out["all_to_all_rows_ms"] = _timed(mesh, all_to_all_rows,
                                            rows.reshape(D, -1), reps)
    assert bool((got[:, 0] - BIG == torch.arange(D, device=mesh.device)).all())
    out["mb_per_rank"] = rows.numel() * 8 / 1e6
    _, out["staged_all_gather_rows_ms"] = _timed(mesh, _staged(all_gather_rows),
                                                 rows, reps)
    _, out["staged_all_to_all_rows_ms"] = _timed(mesh, _staged(all_to_all_rows),
                                                 rows.reshape(D, -1), reps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--log-n", type=int, default=21)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        sys.exit("no CUDA device (use --device cpu for a dry run)")
    ranks = launch.run(_probe, args.world, "gloo", args.device, timeout_s=300,
                       args=(args.log_n, args.reps))
    out = {"device": (torch.cuda.get_device_name(0) if args.device != "cpu"
                      else "cpu"), "world": args.world, "ranks": ranks}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
