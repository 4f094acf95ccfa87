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

``BlockIndexTree`` is the same commitment on a mesh over each rank's block
of the rows, the resident fast prove's (``parallel/__init__.py``): no rank
holds the whole rows or the whole lower levels.
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
from ..parallel.mesh import owner_select


def _build_digests(comps: torch.Tensor, arity: int, dtype: torch.dtype) -> torch.Tensor:
    """(n, C) rows in the field's storage ``dtype`` (int64 Goldilocks, int32
    BabyBear) -> (n_nodes, 8) int32 digests of every level, leaves first,
    root last: one row-leaf call, then one inner-level call per level."""
    levels = [binary_row_digests(comps, dtype)]
    cur = levels[0]
    while cur.shape[0] > 1:
        cur = inner_level(cur, min(arity, cur.shape[0]))
        levels.append(cur)
    return torch.cat(levels, 0) if len(levels) > 1 else levels[0]


def _local_levels(block: torch.Tensor, arity: int, dtype: torch.dtype) -> List[torch.Tensor]:
    """A rank's (n/D, C) block of rows -> its local levels: the row digests,
    then fan ``arity`` while the level's size divides the fan (every rank
    holds the same power-of-two node count, so local blocks stay
    group-aligned), as ``ministark_tpu/commit/index_tree.py:91-95``."""
    levels = [binary_row_digests(block, dtype)]
    while levels[-1].shape[0] % arity == 0:
        levels.append(inner_level(levels[-1], arity))
    return levels


def _top_levels(level: torch.Tensor, arity: int) -> List[torch.Tensor]:
    """The levels above a whole ``level`` up to the root, ``level`` first."""
    levels = [level]
    while levels[-1].shape[0] > 1:
        levels.append(inner_level(levels[-1], min(arity, levels[-1].shape[0])))
    return levels


def _build_digests_sharded(comps: torch.Tensor, arity: int, mesh,
                           dtype: torch.dtype) -> torch.Tensor:
    """``_build_digests`` over a mesh, the whole rows on every rank, the same
    digests and layout: each rank's local levels of its contiguous block,
    one gather of them all, then the top levels replicated (STIR's and
    WHIR's trees)."""
    levels = gather_levels(mesh, _local_levels(local_rows(mesh, comps), arity, dtype))
    return torch.cat(levels[:-1] + _top_levels(levels[-1], arity), 0)


def _level_sizes(n_leaves: int, arity: int) -> List[int]:
    sizes = [n_leaves]
    while sizes[-1] > 1:
        f = min(arity, sizes[-1])
        assert sizes[-1] % f == 0, "leaf count must be a power of two"
        sizes.append(sizes[-1] // f)
    return sizes


def _check_dtype(comps: torch.Tensor, dtype: torch.dtype):
    if comps.dtype != dtype:
        raise ValueError(f"an index tree over a field held in {dtype} takes {dtype} "
                         f"rows, got {comps.dtype}")


@dataclass
class IndexMerklePath:
    """Opening of one leaf: its row bytes + per-level sibling digest groups
    (each group includes the queried node's own slot)."""

    row: bytes
    groups: List[bytes]  # level l: concatenated digests of the sibling group


class IndexMerkleTree:
    def __init__(self, comps: torch.Tensor, arity: int = 2, mesh=None, *,
                 dtype: torch.dtype):
        """comps: (n, C) tensor of row components in the field's storage
        ``dtype`` (int64 Goldilocks u64 patterns, int32 BabyBear; another
        dtype raises), n a power of two; the tree is built on its device.
        ``mesh``: a ``parallel.Mesh``, the whole rows on every rank; the
        build shards when n splits over it (the same digests)."""
        assert arity >= 2 and arity & (arity - 1) == 0
        _check_dtype(comps, dtype)
        n = int(comps.shape[0])
        assert n & (n - 1) == 0, "leaf count must be a power of two"
        self.arity = arity
        self.n_leaves = n
        self.sizes = _level_sizes(n, arity)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self._comps = comps.contiguous()
        if mesh is not None and n % mesh.size == 0 and n > mesh.size:
            self._digests = _build_digests_sharded(self._comps, arity, mesh, dtype)
        else:
            self._digests = _build_digests(self._comps, arity, dtype)
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


class BlockIndexTree(IndexMerkleTree):
    """The commitment of ``IndexMerkleTree`` over this rank's block of the
    rows on ``mesh``: rank r holds the rows [r*n/D, (r+1)*n/D) and hashes
    its local levels (``_local_levels``); one gather brings the D local
    tops, and the levels above them are built replicated, so ``root()`` is
    the one-device tree's. ``open_many`` is a collective: every rank calls
    it alike."""

    def __init__(self, block: torch.Tensor, arity: int, mesh, *, dtype: torch.dtype):
        assert arity >= 2 and arity & (arity - 1) == 0
        _check_dtype(block, dtype)
        n_loc = int(block.shape[0])
        n = n_loc * mesh.size
        if n_loc == 0 or n & (n - 1):
            raise ValueError(f"a tree of {n} rows does not split over {mesh.size} ranks")
        self.arity, self.mesh = arity, mesh
        self.n_leaves = n
        self.sizes = _level_sizes(n, arity)
        self._comps = block.contiguous()
        local = _local_levels(self._comps, arity, dtype)
        # the local levels below the top one, which goes into the gather,
        # concatenated
        self._local_sizes = [lv.shape[0] for lv in local[:-1]]
        self._local = torch.cat(local[:-1], 0) if len(local) > 1 else local[0][:0]
        self._top = _top_levels(gather_levels(mesh, local[-1:])[0], arity)
        self._root = None

    def root(self) -> bytes:
        if self._root is None:
            self._root = digests_to_bytes(self._top[-1])[0].tobytes()
        return self._root

    def open_many(self, indices: List[int]) -> List[IndexMerklePath]:
        """The paths of ``IndexMerkleTree.open_many``: a query's row and its
        groups on the local levels come from the rank that owns the row
        (``owner_select``, one gather each), the groups above from the
        replicated top."""
        arity, n_loc, L = self.arity, self._comps.shape[0], len(self._local_sizes)
        offsets = np.concatenate([[0], np.cumsum(self._local_sizes)])
        dev = self._comps.device
        owner = torch.tensor([i // n_loc for i in indices], dtype=torch.int64, device=dev)
        local_idx, top_groups = [], []
        for idx in indices:
            pos = idx % n_loc
            for lvl in range(L):
                start = int(offsets[lvl]) + pos - pos % arity
                local_idx.extend(range(start, start + arity))
                pos //= arity
            pos, groups = idx // arity ** L, []
            for lvl, level in enumerate(self._top[:-1]):
                f = min(arity, level.shape[0])
                groups.append((lvl, pos - pos % f, f))
                pos //= f
            top_groups.append(groups)
        rows = unpack_u64(owner_select(self.mesh, self._comps[torch.tensor(
            [i % n_loc for i in indices], dtype=torch.int64, device=dev)], owner))
        if L:
            mine = self._local[torch.tensor(local_idx, dtype=torch.int64, device=dev)]
            local = digests_to_bytes(owner_select(
                self.mesh, mine.reshape(len(indices), L * arity, 8), owner
            ).reshape(-1, 8))
        top = [digests_to_bytes(level) for level in self._top[:-1]]

        out = []
        for qi, groups in enumerate(top_groups):
            path_groups = [local[(qi * L + lvl) * arity:(qi * L + lvl + 1) * arity].tobytes()
                           for lvl in range(L)]
            path_groups += [top[lvl][start:start + f].tobytes() for lvl, start, f in groups]
            out.append(IndexMerklePath(row=rows[qi].astype("<u8").tobytes(),
                                       groups=path_groups))
        return out
