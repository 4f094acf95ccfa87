"""The port's fast mode on the CPU against ministark_tpu: the row-leaf and
fan-2/4/8 SHA-256 levels (against the JAX functions, the Pallas kernel in
interpret mode and hashlib), the index tree, the F-way fold, and whole
FastStark proofs compared through ``fast_proof_to_bytes``. Field arithmetic
and hashing are exact: the tolerance is 0 everywhere."""

import copy
import hashlib
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.commit.index_tree import IndexMerkleTree as JTree
from ministark_tpu.commit.index_tree import _build_digests as j_build_digests
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_FP2
from ministark_tpu.fields import Goldilocks as J_GL
from ministark_tpu.models.fibonacci_device import fibonacci_device_trace as j_trace
from ministark_tpu.ops import sha256 as jsh
from ministark_tpu.ops import sha256_pallas as sp
from ministark_tpu.ops.poly_device import fold_factor as j_fold_factor
from ministark_tpu.ops.registry import get_kernels
from ministark_tpu.stark.fast import FastStark as JFastStark
from ministark_tpu.stark.fast import FastStarkConfig as JConfig
from ministark_tpu.stark.proof_io import fast_proof_from_bytes as j_from_bytes
from ministark_tpu.stark.proof_io import fast_proof_to_bytes as j_to_bytes
from ministark_tpu_torch.commit.index_tree import IndexMerkleTree
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import GOLDILOCKS_FP2, Goldilocks
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.ops import field as tgl
from ministark_tpu_torch.ops import sha256 as sh
from ministark_tpu_torch.ops.poly import fold_factor
from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
from ministark_tpu_torch.stark.proof_io import fast_proof_from_bytes, fast_proof_to_bytes

P = Goldilocks.base.p
EDGES = [0, 1, P - 1, P - 2, 1 << 63, (1 << 63) + 5, P - (1 << 32), 1 << 32]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fast_fri_fib100.bin")


def _u64(shape, seed):
    """Seeded u64 field values with 0, p - 1 and values >= 2^63 up front."""
    v = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    flat = v.reshape(-1)
    flat[: min(flat.size, len(EDGES))] = EDGES[: flat.size]
    return v


def _jax_comps(v):
    """(n, C) u64 -> the JAX package's (n, C, 2) u32 [lo, hi] rows."""
    return to_jax_packed(torch.from_numpy(v.view(np.int64)), Goldilocks.base)


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8),
                                                dtype=np.uint64).astype(np.uint32)


# ------------------------------------------------------------ SHA-256 levels
@pytest.mark.parametrize("C", [1, 8, 40, 160])
def test_row_digests_match_jax_and_hashlib(C):
    v = _u64((37, C), C)
    got = sh.binary_row_digests_plain(torch.from_numpy(v.view(np.int64)))
    want = np.asarray(jsh.binary_row_digests(jnp.asarray(_jax_comps(v))))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    out = sh.digests_to_bytes(got)
    for i in range(v.shape[0]):
        assert out[i].tobytes() == hashlib.sha256(v[i].astype("<u8").tobytes()).digest()


@pytest.mark.parametrize("fan", [2, 4, 8])
def test_inner_level_matches_jax(fan):
    d = _words(fan * 19, fan)
    got = sh.inner_level_plain(torch.from_numpy(d.view(np.int32)), fan)
    want = np.asarray(jax.jit(partial(jsh._inner_level, fan_in=fan))(jnp.asarray(d)))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_row_digests_match_pallas_kernel():
    """Row 3b (sha256_pallas._make_kernel via row_digests_tr) at MIN_LANES
    rows of C = 8 (two blocks), interpret mode."""
    v = _u64((sp.MIN_LANES, 8), 3)
    want = np.asarray(sp.row_digests_tr(jnp.asarray(_jax_comps(v)), interpret=True)).T
    got = sh.binary_row_digests_plain(torch.from_numpy(v.view(np.int64)))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_tree_matches_pallas_build():
    """build_digests_tr at MIN_LANES * 4 rows, arity 4 (a Pallas row level,
    a Pallas fan-4 level, then the narrow levels), interpret mode."""
    v = _u64((sp.MIN_LANES * 4, 8), 4)
    want = np.asarray(sp.build_digests_tr(jnp.asarray(_jax_comps(v)), 4,
                                          interpret=True))
    tree = IndexMerkleTree(torch.from_numpy(v.view(np.int64)), 4, dtype=torch.int64)
    assert np.array_equal(tree._digests.numpy().view(np.uint32), want)


def test_bytes_to_digests_roundtrip():
    d = _words(16, 7)
    b = sh.digests_to_bytes(torch.from_numpy(d.view(np.int32)))
    back = sh.bytes_to_digests(b)
    assert np.array_equal(back.numpy().view(np.uint32), d)
    assert np.array_equal(back.numpy().view(np.uint32), np.asarray(jsh.bytes_to_digests(b)))


# ------------------------------------------------------------ index tree
@pytest.mark.parametrize("log_n,arity", [(5, 2), (5, 4), (5, 8), (11, 2), (11, 4), (11, 8)])
def test_index_tree_matches_jax(log_n, arity):
    n = 1 << log_n
    v = _u64((n, 8), log_n * arity)
    jc = _jax_comps(v)
    tree = IndexMerkleTree(torch.from_numpy(v.view(np.int64)), arity, dtype=torch.int64)
    want = np.asarray(j_build_digests(jnp.asarray(jc), arity))
    assert np.array_equal(tree._digests.numpy().view(np.uint32), want)
    jtree = JTree(jc, arity)
    assert tree.root() == jtree.root()
    idxs = [0, n - 1, n // 2, 5 % n, 5 % n]
    for got, ref, i in zip(tree.open_many(idxs), jtree.open_many(idxs), idxs):
        assert got.row == ref.row and got.groups == ref.groups
        assert IndexMerkleTree.verify_path(tree.root(), n, arity, i, got)
        bad = copy.deepcopy(got)
        bad.row = bytes([bad.row[0] ^ 1]) + bad.row[1:]
        assert not IndexMerkleTree.verify_path(tree.root(), n, arity, i, bad)


# ------------------------------------------------------------ fold
@pytest.mark.parametrize("F", [2, 4, 8, 16])
def test_fold_factor_matches_jax(F):
    n = 2048                     # PLANAR_MIN: the JAX planar branch
    v = _u64((n, 2), F)
    alpha = (int(_u64((1,), 100 + F)[0]), P - 1 - F)
    ke = get_kernels(J_FP2)
    coeffs = torch.from_numpy(v.view(np.int64))
    got = fold_factor(tgl.get_ops(GOLDILOCKS_FP2), coeffs,
                      tgl.pack_u64(list(alpha)), F)
    jc = jnp.asarray(to_jax_packed(coeffs, GOLDILOCKS_FP2))
    want = jax.jit(j_fold_factor, static_argnums=(0, 3))(
        ke, jc, jnp.asarray(ke.pack_scalar(alpha)), F)
    assert torch.equal(got, from_jax_packed(np.asarray(want), GOLDILOCKS_FP2))


# ------------------------------------------------------------ whole proofs
def _port_stark(steps, device="cpu", **kw):
    return FastStark(FastStarkConfig(Goldilocks, steps, **kw), device=device)


def _port_trace(steps, secret_b=2):
    return fibonacci_device_trace(Goldilocks, steps, secret_b, on_device=True,
                                  device="cpu")


@pytest.mark.parametrize("steps,kw", [
    (100, dict(queries=8, point_queries=2, arity=4, final_len=8)),
    (63, dict(queries=8, point_queries=2, arity=8, final_len=8)),
])
def test_proof_bytes_match_jax(steps, kw):
    jstark = JFastStark(JConfig(J_GL, steps, **kw))
    jtrace = j_trace(J_GL, steps)
    jblob = j_to_bytes(J_GL, jstark.prove(jtrace))
    stark = _port_stark(steps, **kw)
    trace = _port_trace(steps)
    proof = stark.prove(trace)
    blob = fast_proof_to_bytes(Goldilocks, proof)
    assert blob == jblob
    assert set(stark.phase_seconds) == {"constraint_polys", "commit_witness",
                                        "point_evals", "commit_validities",
                                        "lde_prove"}
    # cross-verification: each verifier accepts the other's proof
    jcons = np.asarray(jstark._constraint_polys(jtrace))
    assert torch.equal(stark._constraint_polys(trace),
                       from_jax_packed(jcons, Goldilocks.base))
    assert stark.verify(from_jax_packed(jcons, Goldilocks.base),
                        fast_proof_from_bytes(Goldilocks, jblob))
    assert jstark.verify(jcons, j_from_bytes(J_GL, blob))
    assert proof.size_bytes() < 200_000


def test_prove_many_matches_jax():
    steps, kw = 60, dict(queries=8, point_queries=1, final_len=8)
    jstark = JFastStark(JConfig(J_GL, steps, **kw))
    jblob = j_to_bytes(J_GL, jstark.prove_many(
        [j_trace(J_GL, steps, secret_b=b) for b in (2, 5, 9)]))
    stark = _port_stark(steps, **kw)
    traces = [_port_trace(steps, b) for b in (2, 5, 9)]
    proof = stark.prove_many(traces)
    blob = fast_proof_to_bytes(Goldilocks, proof)
    assert blob == jblob and proof.n_traces == 3
    cons = [stark._constraint_polys(t) for t in traces]
    back = fast_proof_from_bytes(Goldilocks, blob)
    assert fast_proof_to_bytes(Goldilocks, back) == blob
    assert stark.verify_many(cons, back)
    bad_cons = list(cons)
    bad_cons[1] = stark._constraint_polys(_port_trace(steps, 77))
    with pytest.raises(AssertionError):
        stark.verify_many(bad_cons, proof)


def test_proof_matches_golden_fixture():
    stark = _port_stark(100, queries=4, final_len=8)
    trace = _port_trace(100)
    blob = fast_proof_to_bytes(Goldilocks, stark.prove(trace))
    golden = open(GOLDEN, "rb").read()
    assert blob == golden
    assert stark.verify(stark._constraint_polys(trace),
                        fast_proof_from_bytes(Goldilocks, golden))


def test_rejects_wrong_witness_and_tampering():
    """tests/test_fast_stark.py:70-101 on the port."""
    ext = Goldilocks.extension
    stark = _port_stark(60, queries=8, final_len=8)
    proof = stark.prove(_port_trace(60))
    cons = stark._constraint_polys(_port_trace(60))
    assert stark.verify(cons, proof)
    with pytest.raises(AssertionError):
        stark.verify(stark._constraint_polys(_port_trace(60, 99)), proof)

    bad = copy.deepcopy(proof)
    bad.point_evals[0][0] = ext.add(bad.point_evals[0][0], ext.one())
    with pytest.raises(AssertionError):
        stark.verify(cons, bad)

    bad = copy.deepcopy(proof)
    row = bytearray(bad.fri_proof.batch_openings[0][0].row)
    row[3] ^= 0x10
    bad.fri_proof.batch_openings[0][0].row = bytes(row)
    with pytest.raises(AssertionError):
        stark.verify(cons, bad)


@pytest.mark.parametrize("backend", ["stir", "whir"])
def test_unported_backends_raise(backend):
    """The STIR and WHIR backends (once refused here) build, prove 60 steps
    and verify; an unknown backend is refused."""
    stark = _port_stark(60, queries=8, final_len=8, lde_backend=backend)
    trace = _port_trace(60)
    proof = stark.prove(trace)
    blob = fast_proof_to_bytes(Goldilocks, proof)
    assert blob[len(b"MSF4") + 1 + len(b"Goldilocks")] == {"stir": 1, "whir": 2}[backend]
    assert stark.verify(stark._constraint_polys(trace),
                        fast_proof_from_bytes(Goldilocks, blob))
    with pytest.raises(ValueError, match="unknown LDE backend"):
        _port_stark(60, lde_backend=backend + "2")
