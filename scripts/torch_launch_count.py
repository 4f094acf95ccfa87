#!/usr/bin/env python3
"""Count the kernel launches and device time of one warm parity prove of the
PyTorch/CUDA port (ministark_tpu_torch) with torch.profiler.

    python3 scripts/torch_launch_count.py [--root DIR] [--steps N]
                                          [--ntt-backend B]
                                          [--field goldilocks|babybear]
                                          [--model fibonacci|mimc]
                                          [--mode parity|fast|stir|whir]
                                          [--match S] [--top N] [--world N]
                                          [--backend gloo|nccl]
                                          [--split PHASES] [--cprofile N]

Proves Fibonacci (``--model mimc``: MiMC, ``models/mimc.py``) over
Goldilocks + Fp2, or with ``--field babybear`` over BabyBear + Fp4
(security 20, blowup 2, witness on the card) once to warm
up, then once under torch.profiler (``--mode fast``: the fast mode's
``FastStark.prove_many`` of one trace in bench.py's configuration, arity 4
and ``lde_backend="fri"``; ``--mode stir`` / ``whir``: the same with that
low-degree test), and prints one JSON line: the card's
name and power limit (nvidia-smi), the runtime's
kernel-launch calls by name, the kernels that ran on the device and their
summed time, the prove's wall seconds and the device's busy share (kernel
time over wall time), the wall seconds of one warm prove before it
without the profiler (``warm_s``) with its peak allocated device memory
(``peak_allocated_bytes``, peak stats reset first), for the parity
prover the bytes of that prove's query-round pulls of the quotients to
the host (``query_pull_bytes``: ``DeviceEngine._trim_quotients``'s copy of
the (Q, longest, K) prefix, one a round) and, on a mesh, the
bytes the rank received by collective kind (``received_bytes``,
``parallel/mesh.py::received``), the sha256 of the proof's bytes, the
fast modes' ``phase_seconds`` of that warm prove (with ``--split`` the
parity prover's too), the port's own counts of the field kernels
(``field_ops``: launches and calls by kernel, ops/field.py and ops/bb.py;
an older checkout's launch counts only), and with ``--match S`` the
launches and summed ms
of the kernels whose names contain S (``--top N``: the N kernels, by the
first 80 characters of their names, with the most device time). ``--root`` names the checkout whose
ministark_tpu_torch is imported (default: the one holding this script), so
an older commit unpacked beside this one can be measured in the same run;
``--ntt-backend`` is passed to the prover only when given. ``--world N``
proves sharded over N ranks (a group made by ``parallel/launch.py``,
``mesh=`` on the prover) after the same readings of one device here
(``one_device``), prints each rank's under ``ranks``, and exits 1 unless
every rank's proof is the one device's bytes. ``--backend gloo`` (the
default) puts every rank on card 0, so their device time overlaps and
reads a code path, not a scaling; ``--backend nccl`` gives rank r card r
(needs N cards). Needs a CUDA device; exits 1 without one.

``--split lde_prove`` (comma-separated prefixes of ``phase_seconds``
labels, e.g. ``fri_query,deep_ali`` for the parity prover) splits the
profiled prove's phases whose labels start with one of them (the labels
summed under their prefix; every phase boundary synchronizes the card, so
a phase owns the kernels that start inside it): ``wall_ms``, the device
kernels by name (``device_ms``, ``kernels``), the torch ops called from
Python (top-level ``aten::`` ops: count and CPU ms by name), the launch
calls and those made outside any torch op (this package's ctypes kernel
wrappers, ``own_launches``, and their CPU ms), the ms spent in
synchronizing runtime calls (``sync_ms``: stream and device
synchronizations and copies, inside the torch ops too) and ``host_ms``,
the wall less the torch ops and the own launches: Python's own time. It
also reads the point evaluations and the leaf search by function
(``functions``: ``eval_many``, ``eval_points``, ``sumcheck_evals``,
``_first_match_find``; calls, host ms, launch calls, torch ops, and the
kernels and their device ms inside each call's range on the device
timeline). The ranges' own copies on the device timeline are no kernels
and are left out of every device count. ``--cprofile N`` adds one more
warm prove under cProfile, switched on only inside those phases, and lists
the N functions with the most cumulative seconds there and the N with
the most seconds of their own (cProfile slows Python down, so read its
seconds as shares, not as times).
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=(1 << 20) - 1)
    ap.add_argument("--ntt-backend", default=None)
    ap.add_argument("--field", choices=("goldilocks", "babybear"),
                    default="goldilocks")
    ap.add_argument("--mode", choices=("parity", "fast", "stir", "whir"),
                    default="parity")
    ap.add_argument("--model", choices=("fibonacci", "mimc"), default="fibonacci")
    ap.add_argument("--match", default=None)
    ap.add_argument("--top", type=int, default=0,
                    help="also list the N kernels with the most device time")
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--split", default=None,
                    help="comma-separated phase-label prefixes to split")
    ap.add_argument("--cprofile", type=int, default=0,
                    help="with --split: the N functions with the most time there")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.abspath(args.root))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    head = {"root": os.path.abspath(args.root), "field": args.field,
            "model": args.model, "mode": args.mode, "steps": args.steps,
            "ntt_backend": args.ntt_backend, "gpu": smi}
    one = measure(None, args)
    if args.world == 1:
        print(json.dumps({**head, **one}), flush=True)
        return
    from ministark_tpu_torch.parallel import launch

    torch.cuda.empty_cache()
    device = "cuda:0" if args.backend == "gloo" else "cuda"
    ranks = launch.run(measure, args.world, args.backend, device, 1800, args=(args,))
    equal = all(r["proof_sha256"] == one["proof_sha256"] for r in ranks)
    print(json.dumps({**head, "world": args.world, "backend": args.backend,
                      "cards": torch.cuda.device_count(), "equal": equal,
                      "one_device": one, "ranks": ranks}), flush=True)
    if not equal:
        sys.exit(1)


TOP_NAME = 80      # the characters of a kernel's name that --top groups by
# the functions --split reads by name: (module, attribute) of their callers'
# bindings
MARKED = (("ministark_tpu_torch.stark.engine", "eval_many"),
          ("ministark_tpu_torch.stark.fast", "eval_many"),
          ("ministark_tpu_torch.fri.stir", "eval_points"),
          ("ministark_tpu_torch.fri.whir", "sumcheck_evals"),
          ("ministark_tpu_torch.commit.packed_tree", "_first_match_find"))
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
        "cudaMemcpyAsync", "cudaMemcpy")


class PhaseMarks:
    """Wraps a prover's ``_t`` so that each phase is a ``record_function``
    range ``phase:<label>`` opened after the boundary's synchronize, and the
    MARKED functions in ranges ``fn:<name>``; ``profile``, when set, is a
    cProfile.Profile switched on inside the phases whose labels start with
    one of ``prefixes``."""

    def __init__(self, prover, prefixes):
        import importlib

        from torch.autograd.profiler import record_function

        self._rf = record_function
        self._open = None
        self.profile = None
        self.prefixes = tuple(prefixes)
        orig = prover._t

        def t(label):
            self.close()
            orig(label)
            self._open = record_function("phase:" + label)
            self._open.__enter__()
            if self.profile is not None and label.startswith(self.prefixes):
                self.profile.enable()

        prover._t = t
        for mod, name in MARKED:
            m = importlib.import_module(mod)
            fn = getattr(m, name, None)
            if fn is not None:
                setattr(m, name, self._wrap(fn, name))

    def _wrap(self, fn, name):
        rf = self._rf

        def marked(*a, **kw):
            with rf("fn:" + name):
                return fn(*a, **kw)
        return marked

    def close(self):
        """End the open phase (call after each prove)."""
        if self.profile is not None:
            self.profile.disable()
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


def _annotation(e) -> bool:
    """A PhaseMarks range's copy on the device timeline, not a kernel."""
    return e.name.startswith(("phase:", "fn:"))


def _top_level(ops):
    """The ops of ``ops`` (one thread's, sorted by start) inside no other."""
    out, end = [], -1.0
    for e in ops:
        if e.time_range.start >= end:
            out.append(e)
            end = e.time_range.end
    return out


def _inside(spans, t):
    """Whether time t lies in one of the sorted, disjoint (start, end) spans."""
    import bisect

    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t < spans[i][1]


def _by_name(events, ms, top):
    agg = {}
    for e in events:
        n, t = agg.get(e.name[:TOP_NAME], (0, 0.0))
        agg[e.name[:TOP_NAME]] = (n + 1, t + ms(e))
    return [{"name": k, "count": n, "ms": round(t, 4)}
            for k, (n, t) in sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]]


def split_phases(events, prefixes, top):
    """The --split readings of the profiled prove's events."""
    import torch

    dev_t = torch.autograd.DeviceType.CUDA
    cpu = sorted((e for e in events if e.device_type != dev_t),
                 key=lambda e: (e.time_range.start, -e.time_range.end))
    dev = [e for e in events if e.device_type == dev_t and not _annotation(e)]
    # the device timeline's copy of each fn: range spans that call's kernels
    fn_spans = {}
    for e in events:
        if e.device_type == dev_t and e.name.startswith("fn:"):
            fn_spans.setdefault(e.name[3:], []).append((e.time_range.start,
                                                        e.time_range.end))
    phase_evs = [e for e in cpu if e.name.startswith("phase:")]
    main = phase_evs[0].thread if phase_evs else None
    mine = [e for e in cpu if e.thread == main]
    ops = _top_level([e for e in mine if e.name.startswith("aten::")])
    op_spans = [(e.time_range.start, e.time_range.end) for e in ops]
    launches = [e for e in mine if "LaunchKernel" in e.name]
    own = [e for e in launches if not _inside(op_spans, e.time_range.start)]
    syncs = [e for e in mine if e.name in SYNC]
    us = lambda e: e.time_range.elapsed_us() / 1e3  # noqa: E731
    out = {}
    for p in prefixes:
        spans = sorted((e.time_range.start, e.time_range.end) for e in phase_evs
                       if e.name[len("phase:"):].startswith(p))
        if not spans:
            continue
        ins = lambda e: _inside(spans, e.time_range.start)  # noqa: E731
        wall = sum(b - a for a, b in spans) / 1e3
        p_ops = [e for e in ops if ins(e)]
        p_own = [e for e in own if ins(e)]
        p_dev = [e for e in dev if ins(e)]
        ops_ms, own_ms = sum(map(us, p_ops)), sum(map(us, p_own))
        out[p] = {
            "phases": len(spans), "wall_ms": round(wall, 4),
            "device_ms": round(sum(map(us, p_dev)), 4),
            "device_kernels": len(p_dev),
            "kernels": _by_name(p_dev, us, top),
            "launch_calls": sum(1 for e in launches if ins(e)),
            "own_launches": len(p_own), "own_launch_ms": round(own_ms, 4),
            "torch_ops": len(p_ops), "torch_ops_ms": round(ops_ms, 4),
            "top_torch_ops": _by_name(p_ops, us, top),
            "sync_ms": round(sum(us(e) for e in syncs if ins(e)), 4),
            "host_ms": round(wall - ops_ms - own_ms, 4),
        }
    fns = {}
    for e in mine:
        if not e.name.startswith("fn:"):
            continue
        a, b = e.time_range.start, e.time_range.end
        f = fns.setdefault(e.name[3:], {"calls": 0, "host_ms": 0.0, "launch_calls": 0,
                                        "torch_ops": 0})
        f["calls"] += 1
        f["host_ms"] += (b - a) / 1e3
        f["launch_calls"] += sum(1 for x in launches if a <= x.time_range.start < b)
        f["torch_ops"] += sum(1 for x in ops if a <= x.time_range.start < b)
    for name, f in fns.items():
        spans = sorted(fn_spans.get(name, []))
        ks = [e for e in dev if _inside(spans, e.time_range.start)]
        f["device_kernels"], f["device_ms"] = len(ks), sum(map(us, ks))
    return out, {k: {n: round(v, 4) if isinstance(v, float) else v for n, v in f.items()}
                 for k, f in fns.items()}


def field_counts():
    """{kernel: [launches, calls]} of the field kernels from the imported
    package's counters (ops/field.py, ops/bb.py); a checkout from before the
    field-op kernels has integer launch counts of the two products and no
    calls (None)."""
    from ministark_tpu_torch.ops import bb, field

    out = {}
    for mod in (field, bb):
        launches, calls = getattr(mod, "launches", None), getattr(mod, "calls", None)
        if isinstance(launches, dict):
            out.update({k: [v, calls[k]] for k, v in launches.items()})
    if isinstance(field.launches, int):
        out = {"gl_mul": [field.launches, None], "gl_ext_mul": [field.ext_launches, None]}
    return out


def cprofile_top(prof, n):
    """The n functions with the most cumulative seconds in ``prof``, and
    the n with the most seconds of their own."""
    import pstats

    st = pstats.Stats(prof)

    def rows(col):
        return [{"function": f"{os.path.basename(f)}:{line}({name})", "calls": nc,
                 "tottime_s": round(tt, 4), "cumtime_s": round(ct, 4)}
                for (f, line, name), (_, nc, tt, ct, _) in
                sorted(st.stats.items(), key=lambda kv: -kv[1][col])[:n]]
    return {"cumtime": rows(3), "tottime": rows(2)}


def measure(mesh, args):
    """The readings of one warm prove, sharded over ``mesh`` if given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ministark_tpu_torch.fields import BabyBear, Goldilocks
    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark.engine import DeviceEngine
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
    from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_to_json

    sf = {"goldilocks": Goldilocks, "babybear": BabyBear}[args.field]
    device = "cuda" if mesh is None else mesh.device
    if args.model == "mimc":
        from ministark_tpu_torch.models.mimc import mimc_device_trace

        trace = mimc_device_trace(sf, args.steps, device=device)
    else:
        trace = fibonacci_device_trace(sf, args.steps, on_device=True, device=device)
    pulled = []                     # bytes of each query-round pull, this prove
    real_trim = DeviceEngine._trim_quotients

    def trim(self, qs, effs, rows=None):
        out = real_trim(self, qs, effs, rows)
        longest = max([t.shape[0] for t in out] + [0])
        pulled.append(len(out) * longest * (qs[:1, :1].numel() * qs.element_size()))
        return out

    DeviceEngine._trim_quotients = trim
    kw = {} if args.ntt_backend is None else {"ntt_backend": args.ntt_backend}
    if mesh is not None:
        kw["mesh"] = mesh
    phases = None
    if args.mode != "parity":
        lde = "fri" if args.mode == "fast" else args.mode
        prover = FastStark(FastStarkConfig(sf, args.steps, queries=32, arity=4,
                                           lde_backend=lde), device=device, **kw)
        run = lambda: prover.prove_many([trace])  # noqa: E731
        phases = lambda: {k: round(v, 4) for k, v in prover.phase_seconds.items()}  # noqa: E731
        to_bytes = lambda p: fast_proof_to_bytes(sf, p)  # noqa: E731
    else:
        cfg = StarkConfig(sf, 20, 2, args.steps, trace.constrain_number())
        prover = DeviceEngine(cfg, device=device, **kw)
        run = lambda: prover.prove(trace)  # noqa: E731
        to_bytes = lambda p: proof_to_json(sf, p).encode()  # noqa: E731
        if args.split:
            phases = lambda: {k: round(v, 4) for k, v in prover.phase_seconds.items()}  # noqa: E731
    prefixes = args.split.split(",") if args.split else ()
    marks = PhaseMarks(prover, prefixes) if prefixes else None

    def prove():
        out = run()
        if marks is not None:
            marks.close()
        return out

    prove()                                                # build and warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pulled.clear()
    got = None
    if mesh is not None:
        from ministark_tpu_torch.parallel import mesh as pm

        got = dict(getattr(pm, "received", {}))
    t0 = time.time()
    proof = prove()
    torch.cuda.synchronize()
    warm = time.time() - t0
    warm_phases = None if phases is None else phases()
    peak = torch.cuda.max_memory_allocated()
    pull_bytes = sum(pulled) if args.mode == "parity" else None
    received = None if got is None else {k: v - got[k] for k, v in pm.received.items()}

    before = field_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        prove()
        torch.cuda.synchronize()
        wall = time.time() - t0
    field_ops = {k: [n - before[k][0], None if c is None else c - before[k][1]]
                 for k, (n, c) in field_counts().items()}
    split = functions = cprof = None
    if marks is not None:
        split, functions = split_phases(prof.events(), prefixes, args.top or 15)
        if args.cprofile:
            import cProfile

            marks.profile = cProfile.Profile()
            prove()
            torch.cuda.synchronize()
            cprof = cprofile_top(marks.profile, args.cprofile)
            marks.profile = None

    launch_calls, kernels, device_us, by_name = {}, 0, 0.0, {}
    match_kernels, match_us = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if _annotation(e):
                continue
            kernels += 1
            device_us += e.time_range.elapsed_us()
            n, us = by_name.get(e.name[:TOP_NAME], (0, 0.0))
            by_name[e.name[:TOP_NAME]] = (n + 1, us + e.time_range.elapsed_us())
            if args.match is not None and args.match in e.name:
                match_kernels += 1
                match_us += e.time_range.elapsed_us()
        elif "LaunchKernel" in e.name:
            launch_calls[e.name] = launch_calls.get(e.name, 0) + 1
    return {
        "rank": None if mesh is None else mesh.rank,
        "launch_calls": launch_calls, "device_kernels": kernels,
        "device_ms": device_us / 1e3, "prove_wall_s": wall,
        "device_busy_share": device_us / 1e6 / wall, "warm_s": warm,
        "peak_allocated_bytes": peak, "query_pull_bytes": pull_bytes,
        "received_bytes": received,
        "proof_sha256": hashlib.sha256(to_bytes(proof)).hexdigest(),
        "phase_seconds": warm_phases,
        "field_ops": field_ops,
        **({} if split is None else {"split": split, "functions": functions}),
        **({} if cprof is None else {"cprofile": cprof}),
        **({} if args.match is None else {"match": {
            "name": args.match, "launches": match_kernels,
            "device_ms": match_us / 1e3}}),
        **({} if not args.top else {"top": [
            {"name": name, "launches": n, "device_ms": round(us / 1e3, 4)}
            for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]]}),
    }


if __name__ == "__main__":
    main()
