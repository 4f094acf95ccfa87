"""Sharded Merkle tree digests over a mesh.

Port of ``ministark_tpu/parallel/merkle_sharded.py``. The build is
parallel until a level is narrower than the mesh: each rank hashes its
contiguous block of leaf groups (the decimal leaf preimages and SHA-256 of
``ops/leaf_hash.py``, the ``ms_leaf_hash`` kernel on a card) and folds its
subtree with the fan-2 inner level (``ops/sha256.py``, ``inner_level<2>``).
One gather brings every rank's levels together in rank order, which is
each level's global order, and the last log2(D) levels finish replicated.
The JAX body hashes with ``use_pallas=False`` because a Pallas kernel
under ``shard_map`` was never run on a multi-chip TPU; the CUDA kernels
compute the same function on one rank as on one device, so they run here.

The layout and bytes are those of the single-device build (leaf level
first, upper levels in order, root last), so a ``PackedMerkleTree`` over a
mesh commits to the same root. ``gather_levels`` is the pattern
``commit/index_tree.py``'s sharded build shares.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.leaf_hash import leaf_hash
from ..ops.sha256 import inner_level
from .mesh import Mesh, all_gather_rows


def can_shard_tree(n_elems: int, leafs_per_node: int, n_dev: int) -> bool:
    if n_dev <= 1 or n_elems % leafs_per_node:
        return False
    n_groups = n_elems // leafs_per_node
    # need whole leaf-group blocks per shard and a power-of-two local subtree
    if n_groups % n_dev:
        return False
    g_loc = n_groups // n_dev
    return g_loc >= 1 and (g_loc & (g_loc - 1)) == 0


def local_rows(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of the rows (axis 0)."""
    n_loc = rows.shape[0] // mesh.size
    return rows[mesh.rank * n_loc:(mesh.rank + 1) * n_loc]


def gather_levels(mesh: Mesh, levels: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's local levels (each (size_l, 8) digests) -> the global
    levels (D * size_l, 8), blocks in rank order, in one gather."""
    gathered = all_gather_rows(mesh, torch.cat(levels, 0))
    out, off = [], 0
    for lvl in levels:
        size = lvl.shape[0]
        # contiguous, as the inner-level kernel takes it (a level of one
        # digest a rank reshapes to a strided view)
        out.append(gathered[:, off:off + size].reshape(mesh.size * size, -1).contiguous())
        off += size
    return out


def sharded_tree_digests(comps: torch.Tensor, leafs_per_node: int, fmt: int,
                         mesh: Mesh, max_digits: int = 20) -> torch.Tensor:
    """comps: (n_elems, C) int64 leaf components, whole on every rank.
    Returns all level digests, leaf level first and root last, as the
    (2 * n_groups - 1, 8) int32 tensor of ``leaf_hash`` +
    ``merkle_inner_levels``."""
    assert can_shard_tree(comps.shape[0], leafs_per_node, mesh.size)
    levels = [leaf_hash(local_rows(mesh, comps).contiguous(), leafs_per_node, fmt,
                        max_digits)]
    while levels[-1].shape[0] > 1:
        levels.append(inner_level(levels[-1], 2))
    levels = gather_levels(mesh, levels)
    while levels[-1].shape[0] > 1:        # the top, replicated
        levels.append(inner_level(levels[-1], 2))
    return torch.cat(levels, 0)
