"""Fixtures of the benchmark's own tests: a benchmark folder at a size the
CPU proves in seconds, and the card check of the tests marked ``cuda``."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
sys.path.insert(0, ROOT)

# a cell's traffic at a CPU test's size: 256-row traces, four a call
TINY_MIX = {"steps": 255, "traces_per_call": 4, "secret_range": [2, 1 << 30],
            "warm_up_calls": 1, "checked_calls": 1}


@pytest.fixture
def tiny(tmp_path):
    """(spec path, bench dir): BENCHMARK.json's cells over the tiny mix, with
    copies of the metric readers, in a folder of their own."""
    bench = tmp_path / "bench"
    shutil.copytree(os.path.join(BENCH, "metrics"), bench / "metrics")
    (bench / "traffic").mkdir()
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TINY_MIX))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        c["file"] = os.path.join(ROOT, c["file"])
    for w in spec["workloads"]:
        w["traffic"] = "tiny"
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return str(path), str(bench)


@pytest.fixture
def card():
    """Skips a test unless a CUDA device is present (decided at run time,
    never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with -m cuda")
