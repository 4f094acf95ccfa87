#!/usr/bin/env python3
"""The readings that the comparison's limits are set from, at a cell's own
size: for each seed, the statements of the window's first call proved by
the program and by the control, each compared with the reference.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 [--device cuda]

The control is the reference with one guarantee of the configuration
broken: its point queries' z drawn from the base field, not the
extension. One JSON line a seed: the differing parts by kind, the
program's (the lower reading) and the control's (the upper one).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(workload: str, seed: int, device: str = "cuda", spec_path=None,
             bench_dir=None) -> dict:
    import importlib

    from benchmark import compare, harness, traffic

    kw = {k: v for k, v in (("spec_path", spec_path), ("bench_dir", bench_dir)) if v}
    cell = harness.load_cell(workload, **kw)
    sut = importlib.import_module(f"benchmark.systems.{cell.config['system']}").System(
        cell.config, cell.mix, device)
    secrets = traffic.statements(cell.mix, seed, 0)
    t0 = time.perf_counter()
    got = sut.parts(sut.call(secrets))
    sut.release()
    want = sut.reference(secrets)
    control = sut.reference(secrets, control=True)
    total = lambda d: sum(v[0] for v in d.values())  # noqa: E731
    prog, ctrl = compare.compare(want, got), compare.compare(want, control)
    return {"workload": workload, "seed": seed, "program": total(prog), "control": total(ctrl),
            "program_by_kind": prog, "control_by_kind": ctrl,
            "seconds": time.perf_counter() - t0}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.device)), flush=True)


if __name__ == "__main__":
    main()
