"""The port's bench path on the CPU at tiny sizes: bench_torch.py (every key
and metric name bench.py forms, one whole JSON line per emission, the last
line parseable after SIGTERM, the STIR and WHIR entries and modes),
bench_kernels_torch.py
(every entry, at cut sizes), the probe scripts' dry runs and the shared bound
model. The scripts run with jax and ministark_tpu blocked: the bench path
imports neither. CPU runs state no device metric (``bound_frac`` is None)."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_kernels_torch  # noqa: E402
import bench_torch  # noqa: E402
from ministark_tpu_torch.utils import roofline as rf  # noqa: E402

KERNEL_METRICS = list(bench_kernels_torch.METRICS)
SIDE = ["fast_e2e_prove", "babybear_e2e_prove_2^20", "fast_e2e_prove_2^22",
        "fast_prove_many_batch4", "stir_e2e_prove", "whir_e2e_prove",
        "mimc_e2e_prove"]
SCRIPTS = ["chip_smoke.py", "bench_torch.py", "bench_kernels_torch.py",
           "scripts/torch_stream_probe.py", "scripts/torch_f32_pad_probe.py",
           "scripts/torch_digit_stage_probe.py", "scripts/torch_ntt_probe.py",
           "scripts/torch_launch_count.py",
           "scripts/torch_ab_prove.py", "scripts/torch_dist_probe.py",
           "scripts/torch_first_match_probe.py", "scripts/torch_witness_probe.py"]

# run a script as __main__ with jax and the JAX package unimportable
_BLOCKED = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['ministark_tpu'] = None; sys.argv = sys.argv[1:]; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("BENCH_")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    return env


def _run(script, *args, **extra):
    return subprocess.run([sys.executable, "-c", _BLOCKED, str(ROOT / script), *args],
                          cwd=ROOT, env=_env(**extra), capture_output=True, text=True,
                          timeout=600)


def test_bench_scripts_import_no_jax():
    for rel in SCRIPTS:
        for line in (ROOT / rel).read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import ministark_tpu ",
                                     "from ministark_tpu ", "from ministark_tpu.",
                                     "import ministark_tpu.")), (rel, line)


def test_bench_torch_emits_whole_lines_with_every_key():
    res = _run("bench_torch.py", "--device", "cpu", BENCH_STEPS="63",
               BENCH_BASE_STEPS="15", BENCH_SHRINK="14")
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    snaps = [json.loads(ln) for ln in lines]          # every line is whole JSON
    # the headline, the kernel entries, then one line per side entry
    assert len(snaps) == 2 + len(SIDE)
    assert snaps[0]["kernels"] == {}
    last = snaps[-1]
    assert last["metric"] == "e2e_prove_rows_per_s_fib63_goldilocks"
    assert last["unit"] == "rows/s" and last["value"] > 0
    for key in ("vs_baseline", "vs_host_oracle", "host_oracle_s", "kernels",
                "device_s", "phases", "cold_prove_s", "build_s", "prove_s",
                "verify_s", "ntt_backend", "device"):
        assert key in last, key
    assert last["device"] == "cpu" and last["build_s"] is None
    assert 0 < len(last["phases"]) <= 8
    # the per-round query labels are summed by kind (host, device, copy)
    assert any(k.startswith("fri_query_") for k in last["phases"])
    assert not any(k.startswith("fri_query_round_") for k in last["phases"])
    assert last["device_s"] > 0
    kernels = last["kernels"]
    assert list(kernels) == KERNEL_METRICS + SIDE       # bench.py's order
    # both low-degree-test entries, in bench.py's order (bench.py:433-434)
    assert [k for k in kernels if "stir" in k or "whir" in k] == [
        "stir_e2e_prove", "whir_e2e_prove"]
    for name in KERNEL_METRICS:
        assert set(kernels[name]) == {"value", "unit", "bound_frac"}
        assert kernels[name]["bound_frac"] is None       # no device metric here
    for name in SIDE:
        e = kernels[name]
        assert e["unit"] == "rows/s" and e["value"] > 0
        assert "device_s" in e and "phases" in e
        assert ("proof_bytes" in e) == name.startswith(("fast", "stir", "whir"))
    for key in ("stir_e2e_prove", "whir_e2e_prove"):
        assert kernels[key]["proof_bytes"] > 0 and kernels[key]["verify_s"] is not None
    assert "not ported" not in res.stderr
    # each snapshot extends the one before
    for a, b in zip(snaps, snaps[1:]):
        assert set(a["kernels"]) < set(b["kernels"])


def test_bench_torch_last_line_parses_after_sigterm():
    proc = subprocess.Popen(
        [sys.executable, "-c", _BLOCKED, str(ROOT / "bench_torch.py"), "--device", "cpu"],
        cwd=ROOT, env=_env(BENCH_STEPS="63", BENCH_BASE_STEPS="15",
                           BENCH_SKIP_KERNELS="1", BENCH_SHRINK="10"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()                 # the headline is out
        assert json.loads(first)["metric"].startswith("e2e_prove_rows_per_s_fib63")
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 1
    lines = (first + rest).splitlines()
    assert len(lines) >= 2                             # re-emitted on SIGTERM
    for ln in lines:
        json.loads(ln)
    last = json.loads(lines[-1])
    assert last["metric"] == json.loads(first)["metric"] and "kernels" in last


@pytest.mark.parametrize("model,mode,field,steps,metric", [
    ("mimc", "parity", "goldilocks", 31, "e2e_prove_rows_per_s_mimc31_goldilocks"),
    ("counter", "parity", "babybear", 13, "e2e_prove_rows_per_s_counter13_babybear"),
    ("lfsr", "fast", "goldilocks", 63, "e2e_prove_rows_per_s_fast_lfsr63_goldilocks"),
    ("fibonacci", "fast", "babybear", 63, "e2e_prove_rows_per_s_fast_fib63_babybear"),
])
def test_metric_names_follow_bench_py(monkeypatch, capfd, model, mode, field, steps,
                                      metric):
    for key, val in (("BENCH_MODEL", model), ("BENCH_MODE", mode),
                     ("BENCH_FIELD", field), ("BENCH_STEPS", str(steps)),
                     ("BENCH_BASE_STEPS", "7"), ("BENCH_SKIP_KERNELS", "1"),
                     ("BENCH_BATCH", "2")):
        monkeypatch.setenv(key, val)
    assert bench_torch.main(["--device", "cpu", "--ntt-backend", "pipe"], side=False) == 0
    out = capfd.readouterr().out.splitlines()
    snap = json.loads(out[-1])
    assert snap["metric"] == metric and snap["ntt_backend"] == "pipe"
    assert snap["kernels"] == {} and snap["verify_s"] is not None
    assert ("proof_bytes" in snap) == (mode == "fast")


@pytest.mark.parametrize("mode", ["stir", "whir"])
def test_unported_modes_are_refused(monkeypatch, capfd, mode):
    """BENCH_MODE=stir / whir (once refused here) runs FastStark with that
    low-degree test and names the metric as bench.py does."""
    for key, val in (("BENCH_MODE", mode), ("BENCH_STEPS", "255"),
                     ("BENCH_BASE_STEPS", "7"), ("BENCH_SKIP_KERNELS", "1")):
        monkeypatch.setenv(key, val)
    assert bench_torch.main(["--device", "cpu"]) == 0
    cap = capfd.readouterr()
    snap = json.loads(cap.out.splitlines()[-1])
    assert snap["metric"] == f"e2e_prove_rows_per_s_{mode}_fib255_goldilocks"
    assert snap["proof_bytes"] > 0 and snap["verify_s"] is not None
    assert snap["kernels"] == {} and "not ported" not in cap.err
    assert f"# fast ({mode}) proof size" in cap.err


def test_bench_torch_refuses_a_missing_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_torch.main([]) == 1
    with pytest.raises(RuntimeError):
        bench_kernels_torch.kernel_rooflines()


def test_kernel_rooflines_on_the_cpu_at_cut_sizes():
    results = bench_kernels_torch.kernel_rooflines("cpu", shrink=10)
    assert [r["metric"] for r in results] == KERNEL_METRICS
    # the names bench_kernels.py forms for the same measurements
    assert {"gl_mul_throughput", "hbm_stream", "gl_ntt_2^20_batch2",
            "gl_ntt_2^21_batch2", "fri_fold_div_2^21_fp2",
            "fri_fold_div_chain_2^21_to_2^12", "batched_commit_2^20_b4_arity4"
            } <= set(KERNEL_METRICS)
    assert len(KERNEL_METRICS) == 16
    for r in results:
        assert r["device"] == "cpu" and r["bound_frac"] is None
        assert r["value"] > 0 and r["ms"] > 0 and r["bound_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations")
    by_name = {r["metric"]: r for r in results}
    assert by_name["hbm_stream"]["unit"] == "GB/s"
    assert by_name["int8_matmul_4096"]["route"] == "torch._int_mm"
    assert by_name["digit_dot_4096"]["route"] == "ms_digit_dot_s8"
    assert by_name["batched_commit_2^20_b4_arity4"]["leaf_rows_per_s"] > 0


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_query_split_is_opt_in_and_changes_no_byte(field):
    """An engine reports one label per query round unless it is asked for
    the host / device / copy split, and the proof is the same either way."""
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark import engine as eng
    from ministark_tpu_torch.stark.proof_io import proof_digests

    sf = bench_torch._field(field)
    trace = bench_torch._device_trace(sf, 61, "fibonacci", "cpu")
    cfg = StarkConfig(sf, 20, 2, 61, trace.constrain_number())
    default = eng.DEVICE_MIN_SIZE
    try:
        eng.DEVICE_MIN_SIZE = 32           # tensor rounds and host-tail rounds
        plain = eng.DeviceEngine(cfg, device="cpu")
        split = eng.DeviceEngine(cfg, device="cpu", query_split=True)
        assert plain.query_split is False
        p1, p2 = plain.prove(trace), split.prove(trace)
    finally:
        eng.DEVICE_MIN_SIZE = default
    assert proof_digests(sf, p1) == proof_digests(sf, p2)
    rounds = [k for k in plain.phase_seconds if k.startswith("fri_query_round_")]
    assert rounds and all(k.rsplit("_", 1)[1].isdigit() for k in rounds)
    kinds = {k.rsplit("_", 1)[1] for k in split.phase_seconds
             if k.startswith("fri_query_round_")}
    assert kinds == {"host", "device", "copy"}
    merged = eng.merge_query_phases(plain.phase_seconds)
    assert "fri_query" in merged and not any(k.startswith("fri_query_") for k in merged)
    merged = eng.merge_query_phases(split.phase_seconds)
    assert {"fri_query_host", "fri_query_device", "fri_query_copy"} <= set(merged)
    assert abs(sum(merged.values()) - sum(split.phase_seconds.values())) < 1e-9


@pytest.mark.parametrize("script,args,env,want", [
    ("scripts/torch_stream_probe.py", ["--device", "cpu", "--rows", "8", "--reps", "1"],
     {}, '"probe": "stream_add1"'),
    ("scripts/torch_f32_pad_probe.py", ["--device", "cpu", "--rows", "16"], {}, "PASS"),
    ("scripts/torch_digit_stage_probe.py", ["--device", "cpu", "--reps", "1"],
     {"LVL_N": "16384", "LVL_IDX": "1"}, '"probe": "digit_stage"'),
    ("scripts/torch_digit_stage_probe.py", ["--device", "cpu", "--reps", "1",
                                            "--shapes", "f32,dot4096"],
     {}, '"probe": "digit_stage"'),
    ("scripts/torch_ntt_probe.py", ["--device", "cpu", "--max-log-n", "12", "--reps", "1"],
     {}, '"probe": "ntt_radix2"'),
    ("scripts/torch_ntt_probe.py", ["--backend", "pipe", "--device", "cpu",
                                    "--max-log-n", "14", "--reps", "1"],
     {}, '"probe": "ntt_pipe"'),
    ("scripts/torch_ntt_probe.py", ["--backend", "pipe", "--variants", "--device", "cpu",
                                    "--reps", "1"],
     {}, '"probe": "ntt_pipe_variants"'),
    ("scripts/torch_ab_prove.py", ["--device", "cpu", "--steps", "61", "--pairs", "2"],
     {}, '"probe": "query_split_ab"'),
    ("scripts/torch_ab_prove.py", ["--device", "cpu", "--steps", "61", "--pairs", "1",
                                   "--root", "."], {}, '"probe": "parent_change_ab"'),
    ("scripts/torch_ab_prove.py", ["--device", "cpu", "--steps", "61", "--pairs", "1",
                                   "--tail"], {}, '"probe": "tail_tree_ab"'),
    ("scripts/torch_dist_probe.py", ["--device", "cpu", "--log-n", "10", "--reps", "1"],
     {}, '"all_gather_into_tensor": "ok"'),
])
def test_probe_scripts_dry_run(script, args, env, want):
    res = _run(script, *args, **env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert want in res.stdout.splitlines()[-1]


@pytest.mark.parametrize("n,stages", [(1 << 4, 4), (1 << 6, 3), (1 << 10, 10),
                                      (1 << 10, 1)])
def test_stage_muls_count_the_roots_other_than_one(n, stages):
    """The bound's products in ``stages`` DIT stages over blocks of
    2^stages values: stage u's butterflies take the stage roots
    w^(j 2^(stages - u)), j < 2^(u - 1), as the kernels read them; a root
    that is 1 needs no product."""
    from ministark_tpu_torch.fields import GOLDILOCKS_FP
    from ministark_tpu_torch.ops import ntt

    m = 1 << stages
    roots = ntt.stage_table(GOLDILOCKS_FP, ntt._roots(GOLDILOCKS_FP, m, False), m,
                            "cpu")[-1]
    want = sum((n >> u) * int((roots[torch.arange(1 << (u - 1)) << (stages - u)]
                               != 1).sum()) for u in range(1, stages + 1))
    assert rf.stage_muls(n, stages) == want


def test_four_step_work_skips_the_twiddles_that_are_one():
    """Pass 1's twiddles w^(i1 k2) that are 1 (i1 = 0 or k2 = 0), counted
    from the port's tables, are the ones ``four_step_work`` leaves out."""
    from ministark_tpu_torch.fields import GOLDILOCKS_FP
    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops import ntt_four_step as fs

    n = 1 << 15
    n1, n2 = fs._split_sizes(n)
    _, tw2, wpow = fs._tables(n, False, "cpu")
    e = (torch.arange(n2)[:, None] * torch.arange(n1)).reshape(-1)
    tw = fs._split_twiddle(e, wpow, tw2[-1], ntt.ntt_field(GOLDILOCKS_FP))
    ones = int((tw == 1).sum())
    assert ones == n1 + n2 - 1
    work1, work2 = rf.four_step_work(2, n1, n2, False, False)
    assert work1 == rf.pass_work(2, n, 7, 1, ones=ones)
    assert work2 == rf.pass_work(2, n, 8, 0)
    assert work1[1] == 2 * ((n // 2) * 7 * (rf.OPS_BUTTERFLY - rf.OPS_GL_MUL)
                            + (rf.stage_muls(n, 7) + n - ones) * rf.OPS_GL_MUL)


def test_bound_model():
    assert rf.bound(3.35e12, 0) == (1000.0, "bytes")
    ms, by = rf.bound(8, rf.INT32_OPS_PER_S)
    assert by == "operations" and abs(ms - 1000.0) < 1e-9
    ms, by = rf.bound(8, 0, rf.INT8_OPS_PER_S / 2)        # a MAC is 2 operations
    assert by == "operations" and abs(ms - 1000.0) < 1e-9
    # ifft 2^20 level 0 (B 2, F 128, R 8192): 2^34 multiply-adds lead the bytes
    nbytes, ops, macs = rf.digit_level_work(2, 128, 8192, 64)
    assert macs == 2 * 8192 * 1024 * 1024
    assert rf.bound(nbytes, ops, macs)[1] == "operations"
    assert rf.bound(*rf.stream_work(1 << 26))[1] == "bytes"
    assert rf.bound(*rf.digitize_work(2, 128, 8192))[1] == "bytes"
    assert rf.bound(*rf.recombine_work(2, 8192, 128, 64))[1] == "bytes"
    assert rf.tree_work(8, 4) == tuple(map(sum, zip(rf.level_work(2, 4),
                                                    rf.level_work(1, 2))))
    assert rf.time_ms(lambda: None, 2, "cpu") >= 0
    # a * a reads its operand once; an expanded operand only as stored
    x = torch.zeros(1 << 10, 2, dtype=torch.int64)
    assert rf.mul_work(x[:, 0], x[:, 0])[0] == 8 * 2 * (1 << 10)
    assert rf.mul_work(x[:, 0], x[:, 1])[0] == 8 * 3 * (1 << 10)
    assert rf.ext_mul_work(x, x)[0] == 8 * 4 * (1 << 10)
    assert rf.ext_mul_work(x, x[3].expand_as(x))[0] == 8 * (4 * (1 << 10) + 2)
