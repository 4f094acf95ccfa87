"""The port's native Merkle engine (ministark_tpu_torch/commit/native.py and
its copy of commit/csrc/sha256_merkle.cpp) on the CPU: the leaf hash and the
inner levels against hashlib (commit/merkle.py) and against the JAX
package's ministark_tpu/commit/native.py for fmt 0, 1 and 2 on inputs from
a numpy seed, the native tree against the hashlib tree, the library's file
name keyed by source and host CPU, a failed build raising with the
compiler's output, and the parity prove whose host-tail FRI trees it hashes
against the golden fixture and the JAX engine's proof. Tolerance 0."""

import filecmp
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import ministark_tpu_torch.stark.engine as t_eng
from ministark_tpu.commit import native as j_native
from ministark_tpu_torch.commit import native
from ministark_tpu_torch.commit.merkle import MerkleTree, MerkleTreeConfig
from ministark_tpu_torch.fields import (
    BABYBEAR_FP4,
    GOLDILOCKS_FP,
    GOLDILOCKS_FP2,
    Goldilocks,
)
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.stark import StarkConfig
from ministark_tpu_torch.stark.proof_io import proof_to_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "goldilocks_fib9.json")
FIELDS = {0: GOLDILOCKS_FP, 1: GOLDILOCKS_FP2, 2: BABYBEAR_FP4}      # fmt -> field
# sha256 of ministark_tpu.stark.proof_io.proof_to_json of the JAX
# DeviceEngine's Fibonacci proof over Goldilocks at 2^10 - 1 steps, security
# 20, blowup 2, with its DEVICE_MIN_SIZE 256 (JAX on the CPU, host witness)
JAX_PROOF_1023 = "67472a7cd8459a6a0b056298b5e71f7f0d7bc979d4ec96b94ef78529b732732f"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _values(fmt, n, seed):
    """(n, comps) canonical components from a numpy seed, the field's edge
    values first, and the host scalars they are."""
    F = FIELDS[fmt]
    comps = F.extension_degree
    v = np.random.default_rng([14, fmt, seed]).integers(
        0, F.p, size=(n, comps), dtype=np.uint64)
    v.reshape(-1)[:3] = [0, F.p - 1, 10**9 if F.p > 10**9 else 9]
    return v, [int(r[0]) if comps == 1 else F.from_base_coeffs(tuple(int(x) for x in r))
               for r in v]


def test_source_is_the_jax_package_copy():
    src = os.path.join(ROOT, "ministark_tpu", "commit", "csrc", "sha256_merkle.cpp")
    assert filecmp.cmp(native.SRC, src, shallow=False)


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 65, 1000])
def test_sha256_oneshot(length):
    data = np.random.default_rng([14, length]).integers(0, 256, size=length,
                                                         dtype=np.uint8).tobytes()
    assert native.sha256_oneshot(data) == hashlib.sha256(data).digest()


@pytest.mark.parametrize("fmt", sorted(FIELDS))
@pytest.mark.parametrize("leafs_per_node", [1, 2, 6])
def test_leaf_hash_batch_matches_hashlib_and_jax(fmt, leafs_per_node):
    F = FIELDS[fmt]
    vals, scalars = _values(fmt, 24 * leafs_per_node, leafs_per_node)
    got = native.leaf_hash_batch(vals, leafs_per_node, fmt)
    want = [MerkleTree.calculate_from_leafs(F, scalars[i:i + leafs_per_node])
            for i in range(0, len(scalars), leafs_per_node)]
    assert [bytes(r) for r in got] == want
    assert np.array_equal(got, j_native.leaf_hash_batch(vals, leafs_per_node, fmt))


@pytest.mark.parametrize("fan_in", [2, 4])
def test_inner_levels_matches_hashlib_and_jax(fan_in):
    n = fan_in ** 4
    level0 = np.random.default_rng([14, fan_in]).integers(0, 256, size=(n, 32),
                                                          dtype=np.uint8)
    got = native.inner_levels(level0, fan_in)
    want, level = [], [bytes(r) for r in level0]
    while len(level) > 1:
        level = [MerkleTree.calculate_from_nodes(level[i:i + fan_in])
                 for i in range(0, len(level), fan_in)]
        want += level
    assert [bytes(r) for r in got] == want
    assert np.array_equal(got, j_native.inner_levels(level0, fan_in))


@pytest.mark.parametrize("fmt", sorted(FIELDS))
def test_native_tree_equals_hashlib_tree(fmt):
    """At the host tail's sizes (2^8 to 2^12 leaves), leaf pairs, fan-in 2."""
    F = FIELDS[fmt]
    cfg = MerkleTreeConfig(leafs_per_node=2, inner_children=2)
    for log_n in (8, 12):
        _, scalars = _values(fmt, 1 << log_n, log_n)
        a, b = native.merkle_tree(F, scalars, cfg), MerkleTree(F, scalars, cfg)
        assert a.nodes == b.nodes and a.root() == b.root()
        for leaf in scalars[:3] + scalars[-2:]:
            pa, pb = a.generate_proof(leaf), b.generate_proof(leaf)
            assert pa.leaf_neighbours == pb.leaf_neighbours and pa.path == pb.path


def test_library_is_keyed_by_source_and_cpu(monkeypatch, tmp_path):
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "ministark_tpu_torch", "_build")
    assert native.available() and os.path.exists(path)
    monkeypatch.setattr(native, "_cpu_key", lambda: "model name : another CPU")
    assert native.library_path() != path
    monkeypatch.undo()
    other = tmp_path / "sha256_merkle.cpp"
    other.write_bytes(open(native.SRC, "rb").read() + b"\n")
    assert native.library_path(str(other)) != path


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native.cuda, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native._build(str(bad))
    assert "bad.cpp" in str(e.value) and "error" in str(e.value)
    # with the library not built yet and its build failing, available()
    # reports False and a call raises: nothing falls back to hashlib
    def failing_build(src=native.SRC):
        raise RuntimeError("g++ failed (1)")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build", failing_build)
    assert native.available() is False
    with pytest.raises(RuntimeError):
        native.leaf_hash_batch(np.zeros((2, 1), np.uint64), 2, 0)


def test_golden_proof_with_the_native_tail():
    """Steps 9: every FRI round is a host-tail round, hashed natively."""
    trace = fibonacci_device_trace(Goldilocks, 9, on_device=True, device="cpu")
    engine = t_eng.DeviceEngine(StarkConfig(Goldilocks, 20, 2, 9,
                                            trace.constrain_number()), device="cpu")
    assert engine.tail_tree is native.merkle_tree
    proof = engine.prove(trace)
    assert json.loads(proof_to_json(Goldilocks, proof)) == json.load(open(GOLDEN))


def test_parity_proof_at_1023_with_the_native_tail(monkeypatch):
    """DEVICE_MIN_SIZE 256: the rounds from 2^11 to 2^8 on tensors, the
    rest on the native tail; equal to the JAX engine's proof and to the
    same engine with the hashlib tail."""
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 256)
    steps = (1 << 10) - 1
    trace = fibonacci_device_trace(Goldilocks, steps, on_device=True, device="cpu")
    cfg = StarkConfig(Goldilocks, 20, 2, steps, trace.constrain_number())
    engine = t_eng.DeviceEngine(cfg, device="cpu")
    got = proof_to_json(Goldilocks, engine.prove(trace))
    assert hashlib.sha256(got.encode()).hexdigest() == JAX_PROOF_1023
    engine.tail_tree = MerkleTree
    assert proof_to_json(Goldilocks, engine.prove(trace)) == got
