"""The harness: what it finds by name, the result line it prints, the work
formulas, the trace arithmetic, the import check and the cells on the
card."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark import harness, roofline, trace
from benchmark.systems.fast_stark import System

from .conftest import BENCH, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_spec_names_every_file():
    spec = _spec()
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in spec["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        mod = harness.reader(m["name"])
        assert (mod.NAME, mod.UNIT, mod.SOURCE) == (m["name"], m["unit"], m["source"])
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_spec_form():
    """The spec's keys, names and units in the form the benchmark's format allows."""
    import re

    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    name, unit = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"), re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for key, keys in allowed.items():
        for e in spec[key]:
            assert set(e) <= keys and name.match(e["name"])
            if "unit" in e:
                assert unit.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in spec["end_to_end"])
    assert all(w["chips"] == 1 for w in spec["workloads"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert all(m["moves"] in e2e for m in spec["per_layer"])


def test_new_files_are_found(tiny, tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files (and entries) are found and run with no other file edited."""
    spec_path, bench = tiny
    with open(spec_path) as f:
        spec = json.load(f)
    with open(os.path.join(ROOT, "benchmark/configs/fib_gl_fast.json")) as f:
        conf = json.load(f)
    conf.update(name="fib_gl_fast_q16", queries=16)
    (tmp_path / "fib_gl_fast_q16.json").write_text(json.dumps(conf))
    mix = {"steps": 127, "traces_per_call": 2, "secret_range": [2, 100],
           "warm_up_calls": 0, "checked_calls": 1}
    (tmp_path / "bench" / "traffic" / "tiny_b2.json").write_text(json.dumps(mix))
    (tmp_path / "bench" / "metrics" / "calls_in_window.py").write_text(
        'NAME, UNIT, SOURCE = "calls_in_window", "calls", "host_clock"\n'
        "def read(run):\n    return len(run.calls)\n")
    spec["configs"].append({"name": "fib_gl_fast_q16", "source": "x", "reduced": [],
                            "file": str(tmp_path / "fib_gl_fast_q16.json"), "why": "x"})
    spec["workloads"].append({"name": "q16_b2", "config": "fib_gl_fast_q16",
                              "traffic": "tiny_b2", "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "bound": 0.01, "source": "host_clock",
                               "workloads": ["q16_b2"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    cell = harness.load_cell("q16_b2", spec_path, bench)
    assert cell.config["queries"] == 16 and cell.mix["traces_per_call"] == 2
    assert "calls_in_window" in [m["name"] for m in cell.end_to_end]
    assert "calls_in_window" not in [m["name"] for m in harness.load_cell(
        "fast_gl_seg22_b4", spec_path, bench).end_to_end]
    result = harness.run_cell(cell, 5, 0.01, False, device="cpu")
    assert result["correct"] is True
    assert result["metrics"]["calls_in_window"]["value"] == result["attempted"] >= 1


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(tiny, traced):
    cell = harness.load_cell("fast_bb_seg22_b4", *tiny)
    result = harness.run_cell(cell, 2**33 + 17, 1.0, traced, device="cpu")
    keys = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0
    assert all(v == {"value": 0, "limit": 0} for v in result["checks"].values())
    if traced:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        names = {m["name"] for m in cell.end_to_end}
        assert set(result["metrics"]) == names - {"peak_device_gib"}   # no card: no peak
    json.dumps(result)


def test_work_at_the_cells_size():
    """Bytes and operations of a call of 4 traces of 2^22 rows, written out
    by hand from the protocol: transforms, and SHA-256 of each row and node."""
    mul, bfly = 29, 42                 # Goldilocks product, butterfly
    sha, const = 1384, 904             # a block, a padding-only block

    def ntt(batch, n, scale):
        k = n.bit_length() - 1
        muls = n // 2 * k - n + 1 + (n if scale else 0)
        return 8 * (2 * batch * n + n // 2), batch * (n // 2 * k * (bfly - mul) + muls * mul)

    def tree(rows, row_bytes):
        blocks = (row_bytes + 72) // 64
        nodes, ops, size = rows, rows * blocks * sha, rows
        while size > 1:
            f = min(4, size)
            size //= f
            nodes += size
            ops += size * (f // 2 * sha + const)
        return 32 * nodes, ops

    n, N = 1 << 22, 1 << 23
    pieces = [ntt(12, n, True), ntt(24, N, False), tree(N // 4, 8 * 24 * 4 * 2),
              ntt(8, N, False), tree(N // 4, 8 * 4 * 4 * 2)]
    m, Nn = n, N
    while m // 4 > 32:
        m, Nn = m // 4, Nn // 4
        pieces += [ntt(2, Nn, False), tree(Nn // 4, 64)]
    want = (sum(p[0] for p in pieces), sum(p[1] for p in pieces))
    sut = System.__new__(System)
    sut.field, sut.n, sut.mix = "goldilocks", n, {"traces_per_call": 4}
    sut.cfg = {"blowup": 2, "fold_factor": 4, "arity": 4, "final_len": 32}
    assert sut.work() == want == (5493604288, 242346837388)
    assert (1536 + 9 + 63) // 64 == 25                     # a witness row: 25 blocks
    assert roofline.least_s(*want) == want[1] / (132 * 64 * 1.98e9)   # bound by operations
    sut.field = "babybear"
    assert sut.work() == (3432803008, 279620203432)


class _E:
    """A raw profiler event."""

    def __init__(self, name, a, b, cuda=False, kind=None, thread=1):
        self._n, self._a, self._b, self.cuda, self._k, self._t = name, a, b, cuda, kind, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def activity_type(self):
        return self._k or ("kernel" if self.cuda else "cpu_op")

    def start_thread_id(self):
        return self._t


class _Old(_E):
    """An event of a torch whose raw events have no activity type."""

    activity_type = None


@pytest.mark.parametrize("E", [_E, _Old], ids=["typed", "untyped"])
def test_trace_union_and_gaps(E):
    ms = 1_000_000
    ev = [
        E("bench:window", 0, 100 * ms, kind="user_annotation"),
        E("bench:call", 0, 50 * ms, kind="user_annotation"),
        E("bench:call", 50 * ms, 100 * ms, kind="user_annotation"),
        E("phase:commit", 0, 45 * ms, kind="user_annotation"),
        E("aten::cat", 30 * ms, 45 * ms),
        E("cudaLaunchKernel", 1 * ms, 2 * ms, kind="cuda_runtime"),
        E("cudaLaunchKernel", 3 * ms, 4 * ms, kind="cuda_runtime"),
        E("cuLaunchKernel", 4 * ms, 5 * ms, kind="cuda_runtime"),
        E("phase:commit", 10 * ms, 40 * ms, cuda=True, kind="gpu_user_annotation"),
        E("ntt", 10 * ms, 20 * ms, cuda=True),
        E("sha", 15 * ms, 22 * ms, cuda=True),             # overlaps ntt: counted once
        E("Memcpy DtoH", 60 * ms, 70 * ms, cuda=True, kind="gpu_memcpy"),
        E("ntt", 95 * ms, 105 * ms, cuda=True),           # clipped at the window's end
    ]
    r = trace.read(ev, lambda e: e.cuda)
    assert r.calls == 2 and r.launches == 3 and r.kernels == 3
    assert r.window_s == pytest.approx(0.1)
    assert r.busy_s == pytest.approx(0.012 + 0.010 + 0.005)
    assert r.kernel_s == pytest.approx(0.010 + 0.007 + 0.005)
    assert dict(r.device_ops) == pytest.approx({"ntt": 0.015, "sha": 0.007, "Memcpy DtoH": 0.01})
    gaps = dict(r.idle_gaps)
    # idle: [0, 10) in the phase, [22, 60) in its cat (the middle, 41),
    # [70, 95) in the second call, outside any op
    assert gaps == pytest.approx({"commit/python": 0.010, "commit/aten::cat": 0.038,
                                  "python": 0.025})
    assert sum(gaps.values()) == pytest.approx(r.window_s - r.busy_s)
    assert trace.union([(5, 9), (1, 3), (2, 4), (9, 10)]) == [(1, 4), (5, 10)]


def test_no_jax_after_a_run(tiny):
    harness.run_cell(harness.load_cell("fast_gl_seg22_b4", *tiny), 3, 0.01, False, device="cpu")
    assert harness.forbidden_modules() == []
    assert "ministark_tpu_torch" in sys.modules


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax_like", SimpleNamespace())
    monkeypatch.setitem(sys.modules, "ministark_tpu_torch_x", SimpleNamespace())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ministark_tpu.fields", SimpleNamespace())
    assert harness.forbidden_modules() == ["ministark_tpu"]


def test_run_refuses_without_a_card(tmp_path):
    """run.py prints no result and exits non-zero where the cell's CUDA
    devices are missing, or where the program is not there at all."""
    import torch

    bare = tmp_path / "bare"
    bare.mkdir()
    subprocess.run(["cp", "-r", BENCH, str(bare / "benchmark")], check=True)
    subprocess.run(["cp", os.path.join(ROOT, "BENCHMARK.json"), str(bare)], check=True)
    dirs = [str(bare)] + ([] if torch.cuda.is_available() else [ROOT])
    for d in dirs:
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "fast_gl_seg22_b4",
                            "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=d,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["fast_gl_seg22_b4", "fast_bb_seg22_b4"])
def test_cell_on_the_card(card, workload):
    """A short run of each cell at its own sizes: correct, every end-to-end
    metric read."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                        "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {m["name"] for m in _spec()["end_to_end"]}
