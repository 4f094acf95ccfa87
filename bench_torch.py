"""End-to-end STARK prove benchmark of the PyTorch/CUDA port on one GPU.

The port's twin of bench.py: a 2^20-row Fibonacci AIR over Goldilocks
(+Fp2) proved by the parity prover (``DeviceEngine``), or by the fast mode
(``FastStark``) with BENCH_MODE=fast, or the fast mode with its STIR or
WHIR low-degree test with BENCH_MODE=stir / whir. One process: the kernels are built
(``build_s``), the first prove after the build is timed apart
(``cold_prove_s``), then the steady state is the best of two proves. Every
proof that is timed is verified unless BENCH_SKIP_VERIFY=1.

The last line of stdout that parses is the result: one whole JSON line
  {"metric": "e2e_prove_rows_per_s_fib1048575_goldilocks", "value": N,
   "unit": "rows/s", "vs_baseline": N, "vs_host_oracle": N, "host_oracle_s": N,
   "cold_prove_s": N, "build_s": N, "device_s": N, "phases": {...},
   "kernels": {...}, ...}
is written after the headline, again after the kernel entries
(bench_kernels_torch.py) and again after every side entry
(``fast_e2e_prove``, ``babybear_e2e_prove_2^20``, ``fast_e2e_prove_2^22``,
``fast_prove_many_batch4``, ``stir_e2e_prove``, ``whir_e2e_prove``,
``mimc_e2e_prove``), and once more on SIGTERM, so a run that is cut loses
only the entry in flight.

vs_baseline is bench.py's: the host oracle (the same protocol in pure
Python) timed at BENCH_BASE_STEPS rows, extrapolated by N log N to the
benchmark size, over the measured prove, divided by PY_VS_RUST_FACTOR.

    python3 bench_torch.py [--device cuda] [--ntt-backend radix2]
    BENCH_STEPS=63 BENCH_BASE_STEPS=15 BENCH_SHRINK=14 \\
        python3 bench_torch.py --device cpu              # dry run

Environment: BENCH_MODEL (fibonacci, counter, lfsr, mimc), BENCH_FIELD
(goldilocks, babybear), BENCH_STEPS (2^20 - 1), BENCH_BASE_STEPS (2^13 - 1),
BENCH_MODE (fast, stir, whir), BENCH_BATCH, BENCH_ARITY, BENCH_SKIP_VERIFY=1,
BENCH_SKIP_KERNELS=1, BENCH_SHRINK (cut the kernel sizes and the fixed
2^20 / 2^22 side sizes by 2^BENCH_SHRINK: dry runs).
"""

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch

# bench.py's calibration for vs_baseline: the host oracle is pure-Python
# bigint arithmetic, the reference single-core Rust over Montgomery fields;
# both run the same N log N operation sequence, the oracle about 40x slower.
PY_VS_RUST_FACTOR = 40.0
MODES = ("parity", "fast", "stir", "whir")
FAST_MODES = ("fast", "stir", "whir")     # BENCH_MODE -> FastStark


def _field(name: str):
    from ministark_tpu_torch.fields import BabyBear, Goldilocks

    return {"goldilocks": Goldilocks, "babybear": BabyBear}[name]


def _device_trace(sf, steps, model="fibonacci", device="cuda"):
    """The model's trace for the device provers (one selection point)."""
    if model == "counter":
        from ministark_tpu_torch.models.counter import counter_device_trace

        return counter_device_trace(sf, steps, on_device=True, device=device)
    if model == "lfsr":
        from ministark_tpu_torch.models.lfsr import lfsr_device_trace

        return lfsr_device_trace(sf, steps, device=device)
    if model == "mimc":
        from ministark_tpu_torch.models.mimc import mimc_device_trace

        return mimc_device_trace(sf, steps, device=device)
    if model != "fibonacci":
        raise ValueError(f"unknown BENCH_MODEL {model!r}")
    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace

    return fibonacci_device_trace(sf, steps, on_device=True, device=device)


def _host_claim(base, steps, model="fibonacci"):
    """The matching host-oracle claim and witness."""
    if model == "counter":
        from ministark_tpu_torch.models.counter import CounterClaim

        return CounterClaim(field=base, steps=steps), None
    if model == "lfsr":
        from ministark_tpu_torch.models.lfsr import LfsrClaim

        return LfsrClaim(field=base, steps=steps), None
    if model == "mimc":
        from ministark_tpu_torch.models.mimc import (
            MimcClaim,
            MimcWitness,
            mimc_chain_output,
        )

        out = mimc_chain_output(base.p, steps, 3)
        return MimcClaim(field=base, steps=steps, output=out), MimcWitness(s0=3)
    from ministark_tpu_torch.models import FibonacciClaim, Witness

    return (FibonacciClaim(field=base, step=steps, output=base.from_int(13)),
            Witness(secret_b=base.from_int(2)))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _phase_report(phases: dict) -> dict:
    """``device_s`` and the 8 longest phases, as bench.py reports them, the
    parity prover's query rounds summed by kind (``fri_query_device``,
    ``fri_query_copy``, ``fri_query_host``)."""
    from ministark_tpu_torch.stark.engine import merge_query_phases

    top = sorted(merge_query_phases(phases).items(), key=lambda kv: -kv[1])[:8]
    return {"device_s": round(sum(phases.values()), 4),
            "phases": {k: round(v, 4) for k, v in top}}


def device_prove(steps, field="goldilocks", model="fibonacci", device="cuda",
                 ntt_backend="radix2", verify=True):
    """One parity prove: (prove seconds, verify seconds or None, extras)."""
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark.engine import DeviceEngine

    sf = _field(field)
    dtrace = _device_trace(sf, steps, model, device)
    dtrace.cols_dev                     # a witness built on demand: before t0
    cfg = StarkConfig(sf, 20, 2, steps, dtrace.constrain_number())
    engine = DeviceEngine(cfg, device=device, ntt_backend=ntt_backend,
                          query_split=True)
    _sync(device)

    t0 = time.time()
    proof = engine.prove(dtrace)
    _sync(device)
    t_prove = time.time() - t0
    extras = _phase_report(engine.phase_seconds)

    t_verify = None
    if verify:
        coeffs = engine.constrain_coeffs(dtrace)
        t0 = time.time()
        assert engine.verify(coeffs, proof)
        t_verify = time.time() - t0
    return t_prove, t_verify, extras


def fast_prove(steps, field="goldilocks", model="fibonacci", device="cuda",
               ntt_backend="radix2", verify=True, batch=1, arity=4,
               lde_backend="fri"):
    """One fast-mode prove of ``batch`` traces with the low-degree test
    ``lde_backend`` ("fri", "stir" or "whir"): (prove seconds per trace,
    verify seconds or None, extras)."""
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig

    sf = _field(field)
    traces = [_device_trace(sf, steps, model, device) for _ in range(batch)]
    for t in traces:
        t.cols_dev                      # a witness built on demand: before t0
    stark = FastStark(FastStarkConfig(sf, steps, queries=32, arity=arity,
                                      lde_backend=lde_backend),
                      device=device, ntt_backend=ntt_backend)
    _sync(device)

    t0 = time.time()
    proof = stark.prove_many(traces)
    _sync(device)
    t_prove = (time.time() - t0) / batch     # per trace: rows/s counts B * steps

    t_verify = None
    if verify:
        cons = [stark._constraint_polys(t) for t in traces]
        t0 = time.time()
        assert stark.verify_many(cons, proof)
        t_verify = time.time() - t0
    print(f"# fast ({lde_backend}) proof size {proof.size_bytes() / 1e6:.2f} MB "
          f"(batch {batch})", file=sys.stderr)
    return t_prove, t_verify, {"proof_bytes": proof.size_bytes(),
                               **_phase_report(stark.phase_seconds)}


def host_prove(steps, field="goldilocks", model="fibonacci"):
    """Seconds of the pure-Python host oracle's prove, best of two."""
    from ministark_tpu_torch.stark import Stark, StarkConfig

    sf = _field(field)
    claim, witness = _host_claim(sf.base, steps, model)
    trace = claim.trace(witness)
    stark = Stark(StarkConfig(sf, 20, 2, steps, trace.constrain_number()))
    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        stark.prove(claim, witness)
        best = min(best, time.time() - t0)
    return best


def _emit(data):
    """The current snapshot as one whole JSON line, in one write, so that a
    kill at any point leaves the last complete line standing."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (json.dumps(data) + "\n").encode())


def _steady(prove_fn, steps, **kw):
    """Best of two proves (and verifies): (prove s, verify s, extras, the
    first prove's seconds)."""
    t_first, t_verify, extras = prove_fn(steps, **kw)
    t_prove, v2, e2 = prove_fn(steps, **kw)
    if t_prove < t_first:
        extras = e2
    if t_verify is not None and v2 is not None:
        t_verify = min(t_verify, v2)
    return min(t_first, t_prove), t_verify, extras, t_first


def _gpu_line():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()


def main(argv=None, side=True):
    """``side=False`` stops after the kernel entries (the tests of the
    metric names use it)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ntt-backend", default="radix2")
    args = ap.parse_args(argv)
    env = os.environ
    device, backend = args.device, args.ntt_backend
    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (pass --device cpu for a dry run)",
              file=sys.stderr)
        return 1

    steps = int(env.get("BENCH_STEPS", (1 << 20) - 1))
    base_steps = int(env.get("BENCH_BASE_STEPS", (1 << 13) - 1))
    field = env.get("BENCH_FIELD", "goldilocks")
    model = env.get("BENCH_MODEL", "fibonacci")
    mode = env.get("BENCH_MODE", "parity")
    shrink = int(env.get("BENCH_SHRINK", "0"))
    verify = env.get("BENCH_SKIP_VERIFY") != "1"
    if mode not in MODES:
        raise ValueError(f"unknown BENCH_MODE {mode!r}")
    common = dict(field=field, model=model, device=device, ntt_backend=backend,
                  verify=verify)
    if mode in FAST_MODES:
        prove_fn = fast_prove
        common.update(batch=int(env.get("BENCH_BATCH", "1")),
                      arity=int(env.get("BENCH_ARITY", "4")),
                      lde_backend="fri" if mode == "fast" else mode)
    else:
        prove_fn = device_prove

    snapshot = {}

    def on_term(signum, frame):           # a time limit sends SIGTERM first
        if snapshot:
            _emit(snapshot)
        os._exit(1)

    signal.signal(signal.SIGTERM, on_term)

    build_s = None
    if on_card:
        from ministark_tpu_torch.ops import cuda

        t0 = time.time()
        cuda.library()
        build_s = time.time() - t0
    t_cold = prove_fn(steps, **common)[0]
    print(f"# build {build_s if build_s is None else round(build_s, 2)}s | "
          f"cold prove {t_cold:.2f}s", file=sys.stderr)
    t_prove, t_verify, extras, _ = _steady(prove_fn, steps, **common)
    rows_per_s = steps / t_prove

    t_host = host_prove(base_steps, field, model)
    # N log N extrapolation of the single-core oracle to the benchmark size
    scale = (steps * math.log2(steps)) / (base_steps * math.log2(base_steps))
    vs_host_oracle = t_host * scale / t_prove
    vs_baseline = vs_host_oracle / PY_VS_RUST_FACTOR

    tag = "fib" if model == "fibonacci" else model
    if mode in FAST_MODES:
        tag = mode + "_" + tag
    snapshot.update({
        "metric": f"e2e_prove_rows_per_s_{tag}{steps}_{field}",
        "value": round(rows_per_s, 1),
        "unit": "rows/s",
        "vs_baseline": round(vs_baseline, 2),
        "vs_host_oracle": round(vs_host_oracle, 2),
        "host_oracle_s": round(t_host, 2),
        "prove_s": round(t_prove, 4),
        "verify_s": None if t_verify is None else round(t_verify, 4),
        "cold_prove_s": round(t_cold, 4),
        "build_s": None if build_s is None else round(build_s, 2),
        "ntt_backend": backend,
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "gpu": _gpu_line() if on_card else None,
        "kernels": {},
    })
    snapshot.update(extras)
    _emit(snapshot)                        # the headline stands from here on
    print(f"# prove {t_prove:.2f}s | verify "
          f"{t_verify if t_verify is None else round(t_verify, 2)}s | host-oracle "
          f"{t_host:.2f}s @ {base_steps} rows -> {t_host * scale:.1f}s extrapolated",
          file=sys.stderr)

    kernels = snapshot["kernels"]
    if env.get("BENCH_SKIP_KERNELS") != "1":
        from bench_kernels_torch import kernel_rooflines

        for r in kernel_rooflines(device, shrink=shrink):
            kernels[r["metric"]] = {k: r[k] for k in ("value", "unit", "bound_frac")}
        _emit(snapshot)

    if mode == "parity" and side:
        base = dict(field=field, model=model, device=device, ntt_backend=backend,
                    verify=verify)
        s20, s22 = (1 << max(20 - shrink, 4)) - 1, (1 << max(22 - shrink, 6)) - 1
        # (kernels key, prove function, steps, overrides), in bench.py's order
        side = [
            ("fast_e2e_prove", fast_prove, steps, {}),
            ("babybear_e2e_prove_2^20", device_prove, s20, {"field": "babybear"}),
            ("fast_e2e_prove_2^22", fast_prove, s22, {}),
            ("fast_prove_many_batch4", fast_prove, steps, {"batch": 4}),
            ("stir_e2e_prove", fast_prove, steps, {"lde_backend": "stir"}),
            ("whir_e2e_prove", fast_prove, steps, {"lde_backend": "whir"}),
            ("mimc_e2e_prove", device_prove, steps, {"model": "mimc"}),
        ]
        if field != "goldilocks":
            side = [s for s in side if "babybear" not in s[0]]
        for key, fn, ssteps, over in side:
            kw = {**base, **over}
            if fn is fast_prove:
                kw["arity"] = int(env.get("BENCH_ARITY", "4"))
            t_side, v_side, e_side, t_first = _steady(fn, ssteps, **kw)
            kernels[key] = {"value": round(ssteps / t_side, 1), "unit": "rows/s",
                            "prove_s": round(t_side, 4),
                            "first_prove_s": round(t_first, 4),
                            "verify_s": None if v_side is None else round(v_side, 4),
                            **e_side}
            _emit(snapshot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
