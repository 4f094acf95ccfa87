"""The port's leaf hash and Merkle trees over BabyBear on the CPU: format 0
with the 10-digit path and format 2 (Fp4) against the JAX package's masked
Pallas kernel in interpret mode (``leaf_hash_device``) and the hashlib
MerkleTree oracle, the digit bound chosen by field (a Goldilocks value at
or above 2^32 never reaches the 10-digit path), and the packed tree over
Fp4 against the host tree. Digests must be identical (tolerance 0)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.commit.merkle import MerkleTree as JMerkleTree
from ministark_tpu.fields import BABYBEAR_FP4 as J_BB4
from ministark_tpu.ops import sha256_pallas as sp
from ministark_tpu.ops.leaf_hash import leaf_hash_device
from ministark_tpu_torch.commit import packed_tree
from ministark_tpu_torch.commit.merkle import MerkleTree, MerkleTreeConfig
from ministark_tpu_torch.commit.packed_tree import PackedMerkleTree, field_fmt
from ministark_tpu_torch.fields import (
    BABYBEAR_FP,
    BABYBEAR_FP4,
    GOLDILOCKS_FP,
    GOLDILOCKS_FP2,
)
from ministark_tpu_torch.ops import leaf_hash as lh
from ministark_tpu_torch.ops import sha256 as sh

P = BABYBEAR_FP.p
# 0, 1, p - 1 and numbers of 1, 9 and 10 decimal digits
EDGES = [0, 1, 9, 10, P - 1, 10**8, 10**9 - 1, 10**9, 1999999999, P - 2]


def _comps(n_elems, c, seed, short=False):
    v = np.random.default_rng(seed).integers(0, P, size=(n_elems, c), dtype=np.int64)
    flat = v.reshape(-1)
    flat[: min(flat.size, len(EDGES))] = EDGES[: flat.size]
    if short:                         # short digit strings: fewer blocks
        v[: n_elems // 4] %= 1000
    return v


def _to_jax_comps(v):
    """(n, c) values -> the JAX leaf hash's (n, c, 2) [lo, hi] u32 words."""
    return jnp.asarray(np.stack([v.astype(np.uint32), np.zeros_like(v, np.uint32)], -1))


@pytest.mark.parametrize("fmt,k", [(0, 6), (2, 2), (2, 1)])
def test_leaf_hash_matches_masked_pallas_kernel(fmt, k):
    """Row 2 (sha256_pallas._make_masked_kernel via leaf_hash_device, 10
    digits) over 2048 groups, interpret mode."""
    v = _comps(sp.MIN_LANES * k, 4 if fmt else 1, seed=30 + fmt + k, short=True)
    want = np.asarray(leaf_hash_device(_to_jax_comps(v), k, fmt, 10,
                                       use_pallas=True))
    got = lh.leaf_hash_plain(torch.from_numpy(v), k, fmt, 10)
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("fmt,k", [(0, 6), (0, 1), (2, 2), (2, 3)])
def test_leaf_hash_matches_merkle_oracle(fmt, k):
    field = BABYBEAR_FP if fmt == 0 else BABYBEAR_FP4
    v = _comps(12 * k, 4 if fmt else 1, seed=40 + k)
    out = sh.digests_to_bytes(lh.leaf_hash_plain(torch.from_numpy(v), k, fmt, 10))
    elems = [int(r[0]) if fmt == 0 else field.from_base_coeffs(tuple(map(int, r)))
             for r in v]
    for g in range(12):
        group = elems[g * k:(g + 1) * k]
        assert out[g].tobytes() == MerkleTree.calculate_from_leafs(field, group)
        if fmt == 2:
            assert out[g].tobytes() == JMerkleTree.calculate_from_leafs(J_BB4, group)


def test_fmt2_preimage_is_nested_display():
    """One Fp4 element's preimage byte for byte (fields/host.py Display)."""
    e = ((1, 22), (333, P - 1))
    want = BABYBEAR_FP4.to_string(e)
    assert want == (f"QuadExtField(QuadExtField(1 + 22 * u) + "
                    f"QuadExtField(333 + {P - 1} * u) * u)")
    digest = lh.leaf_hash_plain(torch.tensor([[1, 22, 333, P - 1]]), 1, 2, 10)
    assert sh.digests_to_bytes(digest)[0].tobytes() == hashlib.sha256(
        want.encode()).digest()
    assert lh.max_group_bytes(2, 2, 10) == 2 * (63 + 4 * 10)


def test_ten_digit_path_equals_twenty_on_babybear():
    v = torch.from_numpy(_comps(64 * 2, 4, seed=5, short=True))
    assert torch.equal(lh.leaf_hash_plain(v, 2, 2, 10), lh.leaf_hash_plain(v, 2, 2, 20))
    dig10, len10 = lh.u64_digits(v, 10)
    dig20, len20 = lh.u64_digits(v, 20)
    assert torch.equal(len10, len20) and torch.equal(dig10, dig20[..., :10])


def test_digit_bound_is_chosen_by_field_not_value():
    """Goldilocks trees always take 20 digits, BabyBear trees 10: the
    10-digit path reads the low 32 bits only (as the JAX package's), so a
    Goldilocks value >= 2^32 given 10 digits would hash wrong."""
    assert lh.digits_for(GOLDILOCKS_FP) == lh.digits_for(GOLDILOCKS_FP2) == 20
    assert lh.digits_for(BABYBEAR_FP) == lh.digits_for(BABYBEAR_FP4) == 10
    big = [(1 << 32) + 5, GOLDILOCKS_FP.p - 1, 7, 1 << 40, 0, 12345678901]
    t = torch.tensor([v if v < (1 << 63) else v - (1 << 64) for v in big])
    right = lh.leaf_hash_plain(t.reshape(-1, 1), 6, 0, 20)
    assert not torch.equal(lh.leaf_hash_plain(t.reshape(-1, 1), 6, 0, 10), right)
    assert sh.digests_to_bytes(right)[0].tobytes() == MerkleTree.calculate_from_leafs(
        GOLDILOCKS_FP, big)


def test_goldilocks_tree_never_takes_the_ten_digit_path(monkeypatch):
    seen = []
    real = packed_tree.leaf_hash

    def spy(comps, k, fmt, max_digits=20):
        seen.append(max_digits)
        return real(comps, k, fmt, max_digits)

    monkeypatch.setattr(packed_tree, "leaf_hash", spy)
    vals = [(1 << 32) + i for i in range(12)]
    cfg = MerkleTreeConfig(leafs_per_node=6, inner_children=2)
    tree = PackedMerkleTree(GOLDILOCKS_FP, torch.tensor(vals), cfg)
    assert tree.root() == MerkleTree(GOLDILOCKS_FP, vals, cfg).root()
    bb_tree = PackedMerkleTree(BABYBEAR_FP, (torch.tensor(vals) % P).to(torch.int32), cfg)
    assert bb_tree.root() == MerkleTree(BABYBEAR_FP, [v % P for v in vals], cfg).root()
    assert seen == [20, 10]


def test_leaf_hash_refuses_other_digit_bounds_and_formats():
    v = torch.zeros((4, 4), dtype=torch.int64)
    for md in (0, 9, 19, 21):
        with pytest.raises(ValueError):
            lh.leaf_hash_plain(v, 2, 2, md)
    with pytest.raises(ValueError):
        lh.leaf_hash_plain(v, 2, 3, 10)
    with pytest.raises(ValueError):
        lh.leaf_hash_plain(v[:, :2], 2, 2, 10)


@pytest.mark.parametrize("field,k,n", [(BABYBEAR_FP, 6, 96), (BABYBEAR_FP4, 2, 64)])
def test_packed_tree_matches_host_tree(field, k, n):
    d = field.extension_degree
    vals = _comps(n, d, seed=n)
    vals[1] = vals[5]                 # a duplicate: first occurrence wins (§8.6)
    assert field_fmt(field) == (0 if d == 1 else 2)
    scalars = [int(r[0]) if d == 1 else field.from_base_coeffs(tuple(map(int, r)))
               for r in vals]
    t = torch.from_numpy(vals[:, 0] if d == 1 else vals).to(torch.int32)
    cfg = MerkleTreeConfig(leafs_per_node=k, inner_children=2)
    host = MerkleTree(field, scalars, cfg)
    tree = PackedMerkleTree(field, t, cfg)
    assert tree.root() == host.root()
    picks = [scalars[5], scalars[0], scalars[n - 1], scalars[n // 2]]
    for got, want in zip(tree.generate_proofs(picks),
                         [host.generate_proof(v) for v in picks]):
        assert got.leaf_neighbours == want.leaf_neighbours
        assert got.path == want.path
