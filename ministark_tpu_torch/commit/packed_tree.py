"""Tensor-resident Merkle tree for large codewords.

Port of the device backend of ``ministark_tpu/commit/packed_tree.py``
(:111-200, :287-375). Digests are identical to commit/merkle.py (the same
decimal-Display leaf preimages, the same level-by-level build, the same
first-occurrence value lookup, SURVEY §8.6), but leaf values stay a (n,
comps) tensor and all nodes one (n_nodes, 8) digest tensor, on whatever
device the values were given. A tree over a CUDA tensor hashes on the card
with the kernels; a tree over a CPU tensor takes their plain versions.

Component layout per field (fields/host.py Display semantics):
  base field       -> (n, 1) canonical u64          (fmt 0)
  quadratic ext    -> (n, 2) [c0, c1]               (fmt 1)
  BabyBear Fp4     -> (n, 4) [c00, c01, c10, c11]   (fmt 2)

The leaf hash's digit bound comes from the field (``digits_for``: 10 for
BabyBear, 20 for Goldilocks), never from the values.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.field import pack_u64, unpack_u64
from ..ops.leaf_hash import digits_for, leaf_hash
from ..ops.sha256 import digests_to_bytes, merkle_inner_levels
from ..parallel.merkle_sharded import can_shard_tree, sharded_tree_digests
from ..utils import LeafNotFound, logarithm_of_two_k
from .merkle import MerklePath, MerkleTreeConfig

# queries per chunk of the (q x n) first-match compare: bounds its
# temporaries to a few times SEARCH_CHUNK * n elements
SEARCH_CHUNK = 8


def field_fmt(field) -> int:
    d = field.extension_degree
    if d == 1:
        return 0
    if d == 2:
        return 1
    if d == 4:
        return 2
    raise ValueError(f"unsupported extension degree {d}")


def to_leaf_comps(field, vals: torch.Tensor) -> torch.Tensor:
    """Field tensor -> (n_elems, comps) component layout of the leaf hash:
    base (n,) -> (n, 1); Fp2 (n, 2) and Fp4 (n, 4) stay."""
    return vals.reshape(-1, field.extension_degree)


def unpack_scalar(field, row) -> object:
    if field.extension_degree == 1:
        return int(row[0])
    return field.from_base_coeffs(tuple(int(x) for x in row))


def _first_match_find(comps: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(q,) first indices where (n, C) ``comps`` equals each of (q, C)
    ``rows``; n where absent. The (q x n) compare runs SEARCH_CHUNK
    queries at a time; nothing is pulled to the host."""
    n = comps.shape[0]
    idx = torch.arange(n, device=comps.device)
    none = torch.full_like(idx, n)
    out = []
    for s in range(0, rows.shape[0], SEARCH_CHUNK):
        r = rows[s:s + SEARCH_CHUNK]
        hits = (comps.unsqueeze(0) == r.unsqueeze(1)).all(-1)       # (c, n)
        out.append(torch.where(hits, idx, none).amin(1))
    if not out:
        return torch.zeros((0,), dtype=torch.int64, device=comps.device)
    return torch.cat(out)


class PackedMerkleTree:
    """Same commitment as commit/merkle.py MerkleTree, over a tensor."""

    def __init__(self, field, vals: torch.Tensor, config: MerkleTreeConfig,
                 mesh=None):
        """``vals``: the field values, whole on every rank of ``mesh``
        (a ``parallel.Mesh``) when one is given."""
        self.field = field
        self.config = config
        self.fmt = field_fmt(field)
        k = config.leafs_per_node
        c = config.inner_children
        if c != 2:
            raise ValueError("only fan-in 2 trees are ported")
        comps = to_leaf_comps(field, vals).contiguous()
        n = comps.shape[0]
        assert n % k == 0
        group_num = n // k
        self.n_leafs = n
        self.levels = logarithm_of_two_k(group_num, c) + 1
        assert c ** (self.levels - 1) == group_num

        self._comps = comps
        md = digits_for(field)
        if mesh is not None and group_num > 1 and can_shard_tree(n, k, mesh.size):
            self._digests = sharded_tree_digests(comps, k, self.fmt, mesh, md)
        else:
            leaf_dig = leaf_hash(comps, k, self.fmt, md)
            self._digests = (torch.cat([leaf_dig, merkle_inner_levels(leaf_dig)], 0)
                             if group_num > 1 else leaf_dig)
        self._root = None

    @property
    def device(self) -> torch.device:
        return self._comps.device

    def root(self) -> bytes:
        if self._root is None:
            self._root = digests_to_bytes(self._digests[-1:])[0].tobytes()
        return self._root

    def get_node_number(self) -> int:
        return self.n_leafs + self._digests.shape[0]

    def _parent_idx(self, index: int) -> int:
        """Reference virtual-index parent arithmetic (src/merkle.rs:188-207)."""
        if index < self.n_leafs:
            return self.n_leafs + index // self.config.leafs_per_node
        return index + (self.get_node_number() - index + 1) // self.config.inner_children

    # --- proofs (value lookup, first occurrence: §8.6) --------------------
    #
    # The engine's query phase runs the stages in order: search_rows_async
    # enqueues the value search on the tree's device, the caller pulls the
    # indices and checks them, proofs_gather_async enqueues the digest and
    # leaf-group gathers, proofs_finish pulls them and assembles the paths.

    def search_rows_async(self, rows: torch.Tensor) -> torch.Tensor:
        """First-occurrence indices of (q, comps) value rows, as an
        un-pulled (q,) tensor on the tree's device; n_leafs where absent."""
        return _first_match_find(self._comps, rows.reshape(rows.shape[0], -1))

    def _sibling_groups(self, idxs: List[int]):
        c = self.config.inner_children
        n_nodes = self.get_node_number() - self.n_leafs
        all_groups: List[List[List[int]]] = []
        for i in idxs:
            groups: List[List[int]] = []
            current = self._parent_idx(i)
            for _ in range(1, self.levels):
                shifted = current - self.n_leafs
                s = shifted - shifted % c
                groups.append(list(range(s, min(s + c, n_nodes))))
                current = self._parent_idx(current)
            all_groups.append(groups)
        return all_groups

    def proofs_gather_async(self, idxs: List[int]):
        """Host leaf indices (each < n_leafs) -> enqueue the digest and
        leaf-group gathers; returns a handle for proofs_finish."""
        if any(not 0 <= i < self.n_leafs for i in idxs):
            raise LeafNotFound()
        k = self.config.leafs_per_node
        all_groups = self._sibling_groups(idxs)
        flat = [g for groups in all_groups for grp in groups for g in grp]
        lidx = [i - i % k + j for i in idxs for j in range(k)]
        dev = self.device
        dig_rows = self._digests[torch.tensor(flat, dtype=torch.int64, device=dev)]
        leaf_rows = self._comps[torch.tensor(lidx, dtype=torch.int64, device=dev)]
        return (all_groups, k, dig_rows, leaf_rows)

    def proofs_finish(self, handle) -> List[MerklePath]:
        all_groups, k, dig_rows, leaf_rows = handle
        b = digests_to_bytes(dig_rows)
        rows_u64 = unpack_u64(leaf_rows)
        proofs = []
        pos = 0
        for qi, groups in enumerate(all_groups):
            path: List[List[bytes]] = []
            for grp in groups:
                path.append([b[pos + j].tobytes() for j in range(len(grp))])
                pos += len(grp)
            neigh = [unpack_scalar(self.field, rows_u64[qi * k + j])
                     for j in range(k)]
            proofs.append(MerklePath(leaf_neighbours=neigh, path=path))
        return proofs

    def generate_proofs(self, leafs) -> List[MerklePath]:
        """Proofs looked up by leaf value (first occurrence), in one search
        and one gather for the whole batch."""
        rows = np.asarray([list(self.field.base_coeffs(v)) for v in leafs],
                          dtype=np.uint64).reshape(len(leafs), -1)
        idxs = self.search_rows_async(pack_u64(rows, self.device))
        idxs = [int(i) for i in idxs.cpu()]
        if any(i >= self.n_leafs for i in idxs):
            raise LeafNotFound()
        return self.proofs_finish(self.proofs_gather_async(idxs))
