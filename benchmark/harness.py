"""One run of one cell: set-up, a measured window, the traced readings and
the comparison with the reference, as ``run.py`` prints them.

Everything that belongs to one configuration, traffic mix or metric is in
a file of its own, found by the name ``BENCHMARK.json`` gives it: the
configuration at its ``file``, the mix at ``traffic/<name>.json``, each
metric's reader at ``metrics/<name>.py`` (``read(run)``: a number, or None
where it finds nothing to read). A configuration names its system under
test, ``systems/<system>.py``, whose ``System`` builds the program's
prover, makes one call, reads a proof into plain data and runs the plain
reference.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from . import compare, trace, traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEC = os.path.join(ROOT, "BENCHMARK.json")
# modules that must not be loaded in a run, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "ministark_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list          # the spec's metric entries this cell reports
    per_layer: list
    bench_dir: str = HERE     # where traffic/ and metrics/ are


@dataclass
class Run:
    """What the readers see."""
    setup_s: float = 0.0
    calls: list = field(default_factory=list)     # (start, end) host seconds
    window_s: float = 0.0
    rows: int = 0
    peak_bytes: int = 0
    work: Optional[tuple] = None                   # (bytes, ops) a call
    trace: Optional[trace.Reading] = None


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, spec_path: str = SPEC, bench_dir: str = HERE) -> Cell:
    with open(spec_path) as f:
        spec = json.load(f)
    root = os.path.dirname(os.path.abspath(spec_path))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {spec_path}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    return Cell(workload, w["chips"], config, mix,
                [m for m in spec["end_to_end"] if _reports(m, workload)],
                [m for m in spec["per_layer"] if _reports(m, workload)], bench_dir)


def reader(name: str, bench_dir: str = HERE):
    """The reader module of metric ``name`` (metrics/<name>.py)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


def _host_probe() -> float:
    """Microseconds a SHA-256 of 41 bytes takes in a Python loop, the best
    of three rounds of 20,000: how fast this process's host runs its
    Python, read before and after the window."""
    import hashlib

    best = None
    for _ in range(3):
        t = time.perf_counter()
        for n in range(20000):
            hashlib.sha256(b"probe-state-of-32-bytes-----" + n.to_bytes(8, "little")).digest()
        us = (time.perf_counter() - t) / 20000 * 1e6
        best = us if best is None else min(best, us)
    return best


def _host_sample() -> dict:
    """This process's CPU seconds, the collector's counts, the probe, and
    the machine's CPU time by state (``/proc/stat``, in clock ticks)."""
    out = {"process_s": time.process_time(), "probe_us": _host_probe(),
           "gc": [g["collections"] for g in gc.get_stats()]}
    try:
        with open("/proc/stat") as f:
            out["ticks"] = [int(v) for v in f.readline().split()[1:9]]
    except (OSError, ValueError):
        pass
    return out


def _log_host(a: dict, b: dict, window_s: float):
    """One stderr line: this process's CPU seconds over the window, the
    probe before and after, the collector's runs by generation, and the
    machine's ticks by state over the window (user, nice, system, idle,
    iowait, irq, softirq, steal) against what its CPUs could count."""
    line = (f"host: process cpu {b['process_s'] - a['process_s']:.2f} s of {window_s:.2f} s; "
            f"probe {a['probe_us']:.4f} -> {b['probe_us']:.4f} us a hash; gc runs "
            f"{[y - x for x, y in zip(a['gc'], b['gc'])]}")
    if "ticks" in a and "ticks" in b:
        d = [y - x for x, y in zip(a["ticks"], b["ticks"])]
        line += (f"; /proc/stat ticks {d} of {os.cpu_count()} cpus x "
                 f"{window_s * os.sysconf('SC_CLK_TCK'):.0f}")
    _log(line)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float = None, system=None) -> dict:
    """One run; returns the result object. ``system`` replaces the
    configuration's system class (a test's broken program)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if system is None:
        system = importlib.import_module(
            f"benchmark.systems.{cell.config['system']}").System
    sut = system(cell.config, cell.mix, device)
    for i in range(cell.mix["warm_up_calls"]):
        sut.call(traffic.statements(cell.mix, seed, i, traffic.WARM_UP))
        sync()
    run = Run(work=sut.work())

    prof = None
    if traced:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        sut.mark_phases(record_function)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kept = traffic.Reservoir(seed, cell.mix["checked_calls"])
    failed = 0
    rows_per_call = sut.rows_per_call()
    run.setup_s = time.perf_counter() - t_start
    if hasattr(sut, "reset_notes"):
        sut.reset_notes()
    host_begin = _host_sample()
    window = record_function("bench:window") if traced else None
    if window is not None:
        window.__enter__()
    t_begin = time.perf_counter()
    i = 0
    while time.perf_counter() - t_begin < seconds:
        secrets = traffic.statements(cell.mix, seed, i)
        scope = record_function("bench:call") if traced else None
        if scope is not None:
            scope.__enter__()
        t0 = time.perf_counter()
        try:
            proof = sut.call(secrets)
            sync()
        except Exception as e:          # a failed call is counted, and the run goes on
            _log(f"call {i} failed: {type(e).__name__}: {e}")
            failed += 1
            proof = None
        t1 = time.perf_counter()
        if scope is not None:
            scope.__exit__(None, None, None)
        if proof is not None:
            run.calls.append((t0, t1))
            kept.offer(i, (secrets, proof))
        i += 1
    t_end = time.perf_counter()
    if window is not None:
        window.__exit__(None, None, None)
    run.window_s = t_end - t_begin
    _log_host(host_begin, _host_sample(), run.window_s)
    if hasattr(sut, "notes"):
        note = sut.notes([(t1 - t0) * 1e3 for t0, t1 in run.calls])
        if note:
            _log(note)
    if run.calls:
        ms = [(b - a) * 1e3 for a, b in run.calls]
        sixth = [ms[k * len(ms) // 6:(k + 1) * len(ms) // 6] for k in range(6)]
        _log(f"calls {len(ms)}: ms min {min(ms):.2f} median {statistics.median(ms):.2f} "
             f"max {max(ms):.2f}; mean by sixth of the window "
             f"{[round(statistics.fmean(x), 2) for x in sixth if x]}")
    run.rows = len(run.calls) * rows_per_call
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if prof is not None:
        sync()
        prof.__exit__(None, None, None)
        t_read = time.perf_counter()
        run.trace = trace.read(prof.profiler.kineto_results.events(),
                               lambda e: e.device_type() == torch.autograd.DeviceType.CUDA)
        _log(f"trace read: {time.perf_counter() - t_read:.1f} s")
        prof = None
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")

    # the comparison, once the program's state is freed
    checked = [(c, s, sut.parts(p)) for c, (s, p) in sorted(kept.kept)]
    kept = None
    sut.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    diffs = {k: [0, 0] for k in compare.KINDS}
    t_ref = time.perf_counter()
    for c, secrets, got in checked:
        for k, (d, n) in compare.compare(sut.reference(secrets), got).items():
            diffs[k][0] += d
            diffs[k][1] += n
    _log(f"reference: calls {[c for c, _, _ in checked]} of {len(run.calls)} checked in "
         f"{time.perf_counter() - t_ref:.1f} s; parts {[n for _, n in diffs.values()]}")
    checks = {f"{k}_differing": {"value": d, "limit": 0} for k, (d, _) in diffs.items()}
    correct = (failed == 0 and len(checked) >= 1
               and all(v["value"] <= v["limit"] for v in checks.values()))

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(m["name"], cell.bench_dir).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": i, "failed": failed, "metrics": metrics,
              "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                               "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    result["checks"] = checks
    return result
