"""The port's plain SHA-256 Merkle level and leaf hash (ministark_tpu_torch/
ops/{sha256,leaf_hash}.py) against the JAX package's Pallas kernels in
interpret mode, hashlib and the commit/merkle.py oracle. Digests must be
identical (tolerance 0)."""

import hashlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ministark_tpu.commit.merkle import MerkleTree as JMerkleTree
from ministark_tpu.fields import GOLDILOCKS_FP2 as J_FP2
from ministark_tpu.ops import sha256_pallas as sp
from ministark_tpu.ops.leaf_hash import leaf_hash_device
from ministark_tpu.ops.sha256 import digests_to_bytes as j_digests_to_bytes
from ministark_tpu_torch.commit.merkle import MerkleTree, MerkleTreeConfig
from ministark_tpu_torch.commit.packed_tree import PackedMerkleTree
from ministark_tpu_torch.fields import GOLDILOCKS_FP, GOLDILOCKS_FP2
from ministark_tpu_torch.ops import field as tgl
from ministark_tpu_torch.ops import leaf_hash as lh
from ministark_tpu_torch.ops import sha256 as sh
from ministark_tpu_torch.utils import LeafNotFound

P = GOLDILOCKS_FP.p
# 0, p - 1 and numbers with 1, 19 and 20 decimal digits
EDGES = [0, 1, 9, 10, P - 1, 10**18, 10**19 - 1, 10**19, 12345678901234567890 % P,
         P - (1 << 32), 1 << 63]


def _digests(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def test_inner_level_matches_pallas_kernel():
    """K2 (sha256_pallas._make_kernel via inner_level_tr, fan 2) at L = 2048
    parents, interpret mode."""
    d = _digests(2 * sp.MIN_LANES, 1)
    want = np.asarray(sp.inner_level_tr(jnp.asarray(d.T), 2, interpret=True)).T
    got = sh.inner_level_plain(torch.from_numpy(d.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    b = sh.digests_to_bytes(torch.from_numpy(d.view(np.int32)))
    out = sh.digests_to_bytes(got)
    for i in (0, 1, 777, sp.MIN_LANES - 1):
        assert out[i].tobytes() == hashlib.sha256(
            b[2 * i].tobytes() + b[2 * i + 1].tobytes()).digest()


def test_digests_to_bytes_matches_jax():
    d = _digests(64, 2)
    assert np.array_equal(sh.digests_to_bytes(torch.from_numpy(d.view(np.int32))),
                          j_digests_to_bytes(d))


def _comps(n_elems, c, seed, short=False):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, size=(n_elems, c), dtype=np.uint64)
    flat = v.reshape(-1)
    flat[: min(flat.size, len(EDGES))] = EDGES[: flat.size]
    if short:                         # short digit strings: fewer blocks
        v[: n_elems // 4] %= 1000
    return v


def _to_jax_comps(v):
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    return jnp.asarray(np.stack([lo, hi], axis=-1))


@pytest.mark.parametrize("fmt,k", [(0, 6), (1, 2)])
def test_leaf_hash_matches_masked_pallas_kernel(fmt, k):
    """K3 (sha256_pallas._make_masked_kernel via leaf_hash_device) over 2048
    groups, interpret mode."""
    v = _comps(sp.MIN_LANES * k, fmt + 1, seed=10 + fmt, short=True)
    want = np.asarray(leaf_hash_device(_to_jax_comps(v), k, fmt, use_pallas=True))
    got = lh.leaf_hash_plain(tgl.pack_u64(v), k, fmt)
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("fmt,k", [(0, 6), (0, 1), (1, 2), (1, 3)])
def test_leaf_hash_matches_merkle_oracle(fmt, k):
    field = GOLDILOCKS_FP if fmt == 0 else GOLDILOCKS_FP2
    v = _comps(12 * k, fmt + 1, seed=20 + k)
    out = sh.digests_to_bytes(lh.leaf_hash_plain(tgl.pack_u64(v), k, fmt))
    elems = [int(r[0]) if fmt == 0 else (int(r[0]), int(r[1])) for r in v]
    for g in range(12):
        group = elems[g * k:(g + 1) * k]
        assert out[g].tobytes() == MerkleTree.calculate_from_leafs(field, group)
        jfield = J_FP2 if fmt else None
        if jfield is not None:
            assert out[g].tobytes() == JMerkleTree.calculate_from_leafs(jfield, group)


def test_u64_digits():
    vals = EDGES + [2**64 - 1, 2**63 - 1]
    dig, length = lh.u64_digits(tgl.pack_u64(vals))
    for i, v in enumerate(vals):
        s = str(v)
        assert int(length[i]) == len(s)
        assert "".join(str(int(d)) for d in dig[i, : len(s)].flip(0)) == s


@pytest.mark.parametrize("field,k,n", [(GOLDILOCKS_FP, 6, 96), (GOLDILOCKS_FP2, 2, 64)])
def test_packed_tree_matches_host_tree(field, k, n):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, P, size=(n, field.extension_degree), dtype=np.uint64)
    vals[1] = vals[5]                 # a duplicate: first occurrence wins (§8.6)
    if field.extension_degree == 1:
        scalars = [int(r[0]) for r in vals]
        t = tgl.pack_u64(vals[:, 0])
    else:
        scalars = [(int(r[0]), int(r[1])) for r in vals]
        t = tgl.pack_u64(vals)
    cfg = MerkleTreeConfig(leafs_per_node=k, inner_children=2)
    host = MerkleTree(field, scalars, cfg)
    tree = PackedMerkleTree(field, t, cfg)
    assert tree.root() == host.root()
    picks = [scalars[5], scalars[0], scalars[n - 1], scalars[n // 2]]
    for got, want in zip(tree.generate_proofs(picks),
                         [host.generate_proof(v) for v in picks]):
        assert got.leaf_neighbours == want.leaf_neighbours
        assert got.path == want.path
    absent = 0 if field.extension_degree == 1 else (0, 0)
    if absent not in scalars:
        with pytest.raises(LeafNotFound):
            tree.generate_proofs([absent])
    with pytest.raises(LeafNotFound):
        tree.proofs_gather_async([n])
