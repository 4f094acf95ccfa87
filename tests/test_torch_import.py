"""ministark_tpu_torch stands alone: it imports and proves with jax blocked,
it never falls back from a CUDA device to the CPU, and a kernel wrapper
given a tensor it cannot take raises instead of running the plain version."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

import ministark_tpu_torch
from ministark_tpu_torch.fields import BABYBEAR_FP, Goldilocks
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.ops import field, leaf_hash, ntt, ntt_four_step, ntt_pipe, sha256
from ministark_tpu_torch.stark import StarkConfig
from ministark_tpu_torch.stark.engine import DeviceEngine
from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig

PKG = pathlib.Path(ministark_tpu_torch.__file__).parent
ROOT = PKG.parent

_BLOCKED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any "import jax" now raises ImportError
import ministark_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from ministark_tpu_torch.fields import BabyBear, Goldilocks
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.stark import StarkConfig
from ministark_tpu_torch.stark.engine import DeviceEngine
from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
trace = fibonacci_device_trace(Goldilocks, 9, on_device=True, device="cpu")
engine = DeviceEngine(StarkConfig(Goldilocks, 20, 2, 9, trace.constrain_number()),
                      device="cpu")
proof = engine.prove(trace)
assert engine.verify(engine.constrain_coeffs(trace), proof)
ftrace = fibonacci_device_trace(Goldilocks, 63, on_device=True, device="cpu")
fast = FastStark(FastStarkConfig(Goldilocks, 63, queries=4, final_len=8), device="cpu")
assert fast.verify(fast._constraint_polys(ftrace), fast.prove(ftrace))
btrace = fibonacci_device_trace(BabyBear, 7, on_device=True, device="cpu")
bengine = DeviceEngine(StarkConfig(BabyBear, 20, 2, 7, btrace.constrain_number()),
                       device="cpu")
bproof = bengine.prove(btrace)
assert bengine.verify(bengine.constrain_coeffs(btrace), bproof)
btrace = fibonacci_device_trace(BabyBear, 77, on_device=True, device="cpu")
bfast = FastStark(FastStarkConfig(BabyBear, 77, queries=4, final_len=8), device="cpu")
assert bfast.verify(bfast._constraint_polys(btrace), bfast.prove(btrace))
assert not any(n == "ministark_tpu" or n.startswith("ministark_tpu.") for n in sys.modules)
print("proved", len(proof.arthur), len(bproof.arthur))
"""


def test_imports_and_proves_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    # transcripts of 320 B (Goldilocks, 5 rounds) and 256 B (BabyBear, 4)
    assert res.stdout.strip() == "proved 320 256"


def test_no_module_imports_jax():
    for path in PKG.rglob("*.py"):
        if "_build" in path.relative_to(PKG).parts:   # build outputs
            continue
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), path


def test_cuda_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = StarkConfig(Goldilocks, 20, 2, 9, 6)
    with pytest.raises((RuntimeError, AssertionError)):
        DeviceEngine(cfg, device="cuda")


@pytest.mark.parametrize("make", [
    lambda: DeviceEngine(StarkConfig(Goldilocks, 20, 2, 9, 6)),
    lambda: FastStark(FastStarkConfig(Goldilocks, 63)),
    lambda: fibonacci_device_trace(Goldilocks, 9, on_device=True),
], ids=["DeviceEngine", "FastStark", "fibonacci_device_trace"])
def test_entry_points_default_to_the_card(make):
    """With no device argument the entry points use the card, so on a host
    without one they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        make()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain version: a CPU tensor is an
    error there (the dispatchers send CPU tensors to the plain version)."""
    x = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        ntt.transform_cuda(x)
    with pytest.raises(ValueError):
        sha256.inner_level_cuda(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        leaf_hash.leaf_hash_cuda(torch.zeros((12, 1), dtype=torch.int64), 6, 0)
    with pytest.raises(ValueError):
        sha256.inner_level_cuda(torch.zeros((8, 8), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        sha256.binary_row_digests_cuda(torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        field.mul_cuda(x, x)
    y = torch.zeros((2, 1 << 14), dtype=torch.int64)
    tw1, tw2, wpow = ntt_four_step._tables(1 << 14, False, "cpu")
    with pytest.raises(ValueError):
        ntt_four_step.pass1_cuda(y, tw2, wpow)
    with pytest.raises(ValueError):
        ntt_four_step.pass2_cuda(y.reshape(2, 128, 128), tw1)
    (_, tw, W, _), _ = ntt_pipe._tables(1 << 14, False, "cpu")
    with pytest.raises(ValueError):
        ntt_pipe.level_cuda(y.reshape(2, 128, 128), tw, W=W)
    # the BabyBear instantiations refuse them too
    bb = BABYBEAR_FP
    with pytest.raises(ValueError):
        ntt.transform_cuda(x, field=bb)
    with pytest.raises(ValueError):
        leaf_hash.leaf_hash_cuda(torch.zeros((4, 4), dtype=torch.int64), 2, 2, 10)
    tw1, tw2, wpow = ntt_four_step._tables(1 << 14, False, "cpu", bb)
    with pytest.raises(ValueError):
        ntt_four_step.pass1_cuda(y, tw2, wpow, field=bb)
    with pytest.raises(ValueError):
        ntt_four_step.pass2_cuda(y.reshape(2, 128, 128), tw1, field=bb)
    (_, tw, W, _), _ = ntt_pipe._tables(1 << 14, False, "cpu", bb)
    with pytest.raises(ValueError):
        ntt_pipe.level_cuda(y.reshape(2, 128, 128), tw, W=W, field=bb)
