"""Index-addressed Merkle tree with 2^k arity (fast mode).

Port of ``ministark_tpu/commit/index_tree.py``: leaves are SHA-256 over the
raw little-endian bytes of a row of u64 field components
(``ops/sha256.binary_row_digests``), parents hash the concatenation of
their children, and openings are by index with per-level sibling groups.
Every level groups ``arity`` children except when fewer remain (the last
level of a 2^19-leaf 4-ary tree is fan 2).

The rows and all level digests stay tensors on the device the rows were
given on: a CUDA tensor hashes with the row-leaf and inner-level kernels,
one launch per level; a CPU tensor takes their plain versions. With a mesh
(``parallel/``) the leaf hashing and the lower levels shard over its ranks.
Verification (``verify_path``) is pure-host hashlib.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..ops.field import unpack_u64
from ..ops.sha256 import binary_row_digests, digests_to_bytes, inner_level
from ..parallel.merkle_sharded import gather_levels, local_rows


def _build_digests(comps: torch.Tensor, arity: int) -> torch.Tensor:
    """(n, C) int64 rows -> (n_nodes, 8) int32 digests of every level,
    leaves first, root last: one row-leaf call, then one inner-level call
    per level."""
    levels = [binary_row_digests(comps)]
    cur = levels[0]
    while cur.shape[0] > 1:
        cur = inner_level(cur, min(arity, cur.shape[0]))
        levels.append(cur)
    return torch.cat(levels, 0) if len(levels) > 1 else levels[0]


def _build_digests_sharded(comps: torch.Tensor, arity: int, mesh) -> torch.Tensor:
    """``_build_digests`` over a mesh, the same digests and layout. Each
    rank hashes its contiguous block of rows and folds fan ``arity`` while
    its local level size divides the fan (every rank holds the same
    power-of-two node count, so local blocks stay group-aligned); one
    gather of the local levels, then the top levels replicated."""
    levels = [binary_row_digests(local_rows(mesh, comps))]
    while levels[-1].shape[0] % arity == 0:
        levels.append(inner_level(levels[-1], arity))
    levels = gather_levels(mesh, levels)
    while levels[-1].shape[0] > 1:
        levels.append(inner_level(levels[-1], min(arity, levels[-1].shape[0])))
    return torch.cat(levels, 0)


def _level_sizes(n_leaves: int, arity: int) -> List[int]:
    sizes = [n_leaves]
    while sizes[-1] > 1:
        f = min(arity, sizes[-1])
        assert sizes[-1] % f == 0, "leaf count must be a power of two"
        sizes.append(sizes[-1] // f)
    return sizes


@dataclass
class IndexMerklePath:
    """Opening of one leaf: its row bytes + per-level sibling digest groups
    (each group includes the queried node's own slot)."""

    row: bytes
    groups: List[bytes]  # level l: concatenated digests of the sibling group


class IndexMerkleTree:
    def __init__(self, comps: torch.Tensor, arity: int = 2, mesh=None):
        """comps: (n, C) int64 tensor of u64 row components, n a power of
        two; the tree is built on its device. ``mesh``: a
        ``parallel.Mesh``, the whole rows on every rank; the build shards
        when n splits over it (the same digests)."""
        assert arity >= 2 and arity & (arity - 1) == 0
        n = int(comps.shape[0])
        assert n & (n - 1) == 0, "leaf count must be a power of two"
        self.arity = arity
        self.n_leaves = n
        self.sizes = _level_sizes(n, arity)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self._comps = comps.contiguous()
        if mesh is not None and n % mesh.size == 0 and n > mesh.size:
            self._digests = _build_digests_sharded(self._comps, arity, mesh)
        else:
            self._digests = _build_digests(self._comps, arity)
        self._root = None

    def root(self) -> bytes:
        if self._root is None:
            self._root = digests_to_bytes(self._digests[-1:])[0].tobytes()
        return self._root

    def open_many(self, indices: List[int]) -> List[IndexMerklePath]:
        """Open several leaves with one digest gather and one row gather,
        each pulled to the host once."""
        arity = self.arity
        all_groups: List[List[range]] = []
        for idx in indices:
            pos = idx
            groups = []
            for lvl, size in enumerate(self.sizes[:-1]):
                f = min(arity, size)
                start = self.offsets[lvl] + (pos - pos % f)
                groups.append(range(int(start), int(start + f)))
                pos //= f
            all_groups.append(groups)

        dev = self._digests.device
        flat = torch.tensor([i for groups in all_groups for g in groups for i in g],
                            dtype=torch.int64, device=dev)
        fetched = digests_to_bytes(self._digests[flat])
        rows = unpack_u64(self._comps[torch.tensor(list(indices), dtype=torch.int64,
                                                   device=dev)])

        out = []
        pos = 0
        for qi, groups in enumerate(all_groups):
            path_groups = []
            for g in groups:
                path_groups.append(fetched[pos : pos + len(g)].tobytes())
                pos += len(g)
            out.append(IndexMerklePath(row=rows[qi].astype("<u8").tobytes(),
                                       groups=path_groups))
        return out

    @staticmethod
    def verify_path(
        root: bytes, n_leaves: int, arity: int, index: int, path: IndexMerklePath
    ) -> bool:
        """Pure-host verification: recompute the leaf digest from the row
        bytes and fold sibling groups up to the root."""
        digest = hashlib.sha256(path.row).digest()
        pos = index
        for size, group in zip(_level_sizes(n_leaves, arity)[:-1], path.groups):
            f = min(arity, size)
            if len(group) != 32 * f:
                return False
            slot = pos % f
            if group[32 * slot : 32 * (slot + 1)] != digest:
                return False
            digest = hashlib.sha256(group).digest()
            pos //= f
        return digest == root
