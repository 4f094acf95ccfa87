"""Tensor-resident Merkle tree for large codewords.

Port of the device backend of ``ministark_tpu/commit/packed_tree.py``
(:111-200, :287-375). Digests are identical to commit/merkle.py (the same
decimal-Display leaf preimages, the same level-by-level build, the same
first-occurrence value lookup, SURVEY §8.6), but leaf values stay a (n,
comps) tensor and all nodes one (n_nodes, 8) digest tensor, on whatever
device the values were given. A tree over a CUDA tensor hashes on the card
with the kernels; a tree over a CPU tensor takes their plain versions.

Component layout per field (fields/host.py Display semantics), in the
field's dtype (int64 Goldilocks, int32 BabyBear; a tensor of the other
raises):
  base field       -> (n, 1) canonical value        (fmt 0)
  quadratic ext    -> (n, 2) [c0, c1]               (fmt 1)
  BabyBear Fp4     -> (n, 4) [c00, c01, c10, c11]   (fmt 2)

The leaf hash's digit bound comes from the field (``digits_for``: 10 for
BabyBear, 20 for Goldilocks), never from the values.

``BlockMerkleTree`` is the same commitment on a mesh over each rank's block
of the values, the resident prove's (``parallel/__init__.py``): no rank
holds the whole.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops import cuda
from ..ops.field import field_dtype, pack_words, unpack_u64
from ..ops.leaf_hash import digits_for, leaf_hash
from ..ops.sha256 import digests_to_bytes, merkle_inner_levels
from ..parallel.merkle_sharded import (
    block_tree_levels,
    can_shard_tree,
    sharded_tree_digests,
    tree_top,
)
from ..parallel.mesh import all_gather_rows, min_over_ranks, owner_select
from ..utils import LeafNotFound, logarithm_of_two_k
from .merkle import MerklePath, MerkleTreeConfig

# queries per chunk of the plain (q x n) first-match compare: bounds its
# temporaries to a few times SEARCH_CHUNK * n elements
SEARCH_CHUNK = 8
# csrc/leaf_search.cu: the rows one launch takes (MAX_ROWS there; the
# block's shared memory holds them); more rows take one launch a chunk
MATCH_MAX_ROWS = 1024
_NONE = -1                     # 0xFFFFFFFF: the kernel's "no hit yet" minimum
# Incremented once per launch of ms_first_match, and once per call of its
# wrapper with at least one row, launched or refused (one launch a call up
# to MATCH_MAX_ROWS rows).
launches = {"first_match": 0}
calls = {"first_match": 0}


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
    base (n,) -> (n, 1); Fp2 (n, 2) and Fp4 (n, 4) stay. A tensor of
    another dtype than the field's raises."""
    if vals.dtype != field_dtype(field):
        raise ValueError(f"a tree over {field!r} takes {field_dtype(field)} "
                         f"values, got {vals.dtype}")
    return vals.reshape(-1, field.extension_degree)


def unpack_scalar(field, row) -> object:
    if field.extension_degree == 1:
        return int(row[0])
    return field.from_base_coeffs(tuple(int(x) for x in row))


def _first_match_find_plain(comps: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
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


# device -> the kernel's int32 scratch: word 0 the last-block ticket (0),
# words 1..MATCH_MAX_ROWS the per-row minima (_NONE); each call's last block
# leaves them so, and a buffer is never replaced, so a CUDA graph that
# captured a call replays right
_match_scratch = {}


def _match_scratch_for(device):
    buf = _match_scratch.get(device)
    if buf is None:
        buf = torch.full((1 + MATCH_MAX_ROWS,), _NONE, dtype=torch.int32, device=device)
        buf[0] = 0
        _match_scratch[device] = buf
    return buf


def first_match_cuda(comps: torch.Tensor, rows: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """CUDA kernel (csrc/leaf_search.cu ``ms_first_match``), same contract
    as ``_first_match_find_plain``: every element read once, one launch for
    up to MATCH_MAX_ROWS rows (one a chunk beyond); no rows, no launch.
    ``dtype`` is the tree's field's storage and picks the kernel: int64
    (Goldilocks, ``ms_first_match``) or int32 (BabyBear,
    ``ms_first_match_bb``: 4-byte words, an Fp4 row one 16-byte load).
    ``comps`` (n, C) and ``rows`` (q, C): contiguous on one CUDA device,
    both of ``dtype``, C 1, 2 or 4, n < 2^31 - 1; raises on anything
    else."""
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"first_match: a field is held in int32 or int64, not {dtype}")
    cuda.require(comps, "first_match comps", dtype, 2)
    n, C = comps.shape
    if rows.device != comps.device or rows.dim() != 2 or rows.shape[1] != C:
        raise ValueError(f"first_match: rows {tuple(rows.shape)} on {rows.device} "
                         f"against comps {tuple(comps.shape)} on {comps.device}")
    q = rows.shape[0]
    out = torch.empty((q,), dtype=torch.int64, device=comps.device)
    if q == 0:
        return out
    calls["first_match"] += 1
    cuda.require(rows, "first_match rows", dtype, 2)
    if C not in (1, 2, 4):
        raise ValueError(f"first_match: C is 1, 2 or 4, got {C}")
    if not 1 <= n < (1 << 31) - 1:
        raise ValueError(f"first_match: n must be in [1, 2^31 - 1), got {n}")
    if C > 1 and comps.data_ptr() % 16:
        raise ValueError("first_match: comps must start on a 16-byte boundary")
    scratch = _match_scratch_for(comps.device)
    lib = cuda.library()
    fn = lib.ms_first_match_bb if dtype == torch.int32 else lib.ms_first_match
    stream = cuda.stream_ptr(out)
    for s in range(0, q, MATCH_MAX_ROWS):
        r = rows[s:s + MATCH_MAX_ROWS]
        err = fn(comps.data_ptr(), r.data_ptr(), out[s:].data_ptr(), scratch.data_ptr(),
                 n, r.shape[0], C, stream)
        cuda.check("first_match", err)
        launches["first_match"] += 1
    return out


def _first_match_find(comps: torch.Tensor, rows: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """(q,) first indices where (n, C) ``comps`` equals each of (q, C)
    ``rows``; n where absent (§8.6), un-pulled. Both hold the field's
    storage ``dtype``; another raises, on the CPU too. Dispatch by device:
    CPU tensors -> ``_first_match_find_plain``; a CUDA tensor ->
    ``first_match_cuda``, the kernel, or raise."""
    if comps.device.type == "cpu" and rows.device.type == "cpu":
        if comps.dtype != dtype or rows.dtype != dtype:
            raise ValueError(f"first_match: comps {comps.dtype} and rows {rows.dtype} "
                             f"for a field held in {dtype}")
        return _first_match_find_plain(comps, rows)
    return first_match_cuda(comps, rows.contiguous(), dtype)
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
        return _first_match_find(self._comps, rows.reshape(rows.shape[0], -1),
                                 field_dtype(self.field))

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
        idxs = self.search_rows_async(pack_words(rows, field_dtype(self.field),
                                                 self.device))
        idxs = [int(i) for i in idxs.cpu()]
        if any(i >= self.n_leafs for i in idxs):
            raise LeafNotFound()
        return self.proofs_finish(self.proofs_gather_async(idxs))


class BlockMerkleTree(PackedMerkleTree):
    """The commitment of ``PackedMerkleTree`` over this rank's block of the
    values on ``mesh``: rank r holds the elements [r*n/D, (r+1)*n/D), whole
    leaf groups, and hashes its subtree; one gather brings the D subtree
    roots, and the levels above them are built replicated
    (``ministark_tpu/parallel/merkle_sharded.py:70-84``), so ``root()`` is
    the one-device tree's. The search and the proofs are collectives:
    every rank calls them alike."""

    def __init__(self, field, block: torch.Tensor, config: MerkleTreeConfig, mesh):
        self.field = field
        self.config = config
        self.fmt = field_fmt(field)
        self.mesh = mesh
        k = config.leafs_per_node
        if config.inner_children != 2:
            raise ValueError("only fan-in 2 trees are ported")
        comps = to_leaf_comps(field, block).contiguous()
        n_loc = comps.shape[0]
        n = n_loc * mesh.size
        if n_loc == 0 or n % k or n // k < 2 or not can_shard_tree(n, k, mesh.size):
            raise ValueError(f"a tree of {n} leaves, {k} a group, does not split "
                             f"over {mesh.size} ranks")
        self.n_leafs = n
        self.levels = logarithm_of_two_k(n // k, 2) + 1
        self._comps = comps
        self._lo = mesh.rank * n_loc
        local = block_tree_levels(comps, k, self.fmt, digits_for(field))
        self._g_loc = local[0].shape[0]
        top = tree_top(all_gather_rows(mesh, local[-1][0]))
        self._local = torch.cat(local[:-1], 0) if len(local) > 1 else local[0][:0]
        self._top = torch.cat(top, 0)
        self._root = None

    def root(self) -> bytes:
        if self._root is None:
            self._root = digests_to_bytes(self._top[-1:])[0].tobytes()
        return self._root

    def get_node_number(self) -> int:
        return self.n_leafs + 2 * (self.n_leafs // self.config.leafs_per_node) - 1

    def search_rows_async(self, rows: torch.Tensor) -> torch.Tensor:
        """The global first occurrence (§8.6): each rank's first match in
        its block plus its offset, or n_leafs, then the least across the
        ranks (one gather)."""
        n_loc = self._comps.shape[0]
        local = _first_match_find(self._comps, rows.reshape(rows.shape[0], -1),
                                  field_dtype(self.field))
        found = torch.where(local < n_loc, local + self._lo,
                            torch.full_like(local, self.n_leafs))
        return min_over_ranks(self.mesh, found)

    def _locate(self, flat: List[int]):
        """Digest indices of the one-device layout -> (owner, row in the
        owner's local levels, row in the replicated top or -1)."""
        D, g = self.mesh.size, self._g_loc
        owner, local, top = [], [], []
        for f in flat:
            size, off_g, off_l, lvl = g * D, 0, 0, 0
            while f >= off_g + size:
                off_g += size
                off_l += size // D
                size //= 2
                lvl += 1
            i = f - off_g
            per_rank = size // D
            if per_rank >= 2:                    # a local level
                owner.append(i // per_rank)
                local.append(off_l + i % per_rank)
                top.append(-1)
            else:                                # at or above the subtree roots
                owner.append(0)
                local.append(0)
                top.append(2 * D - 2 * size + i)
        return owner, local, top

    def proofs_gather_async(self, idxs: List[int]):
        """Host leaf indices -> the sibling digests and leaf groups from
        their owners (``owner_select``; the levels above the subtree roots
        are read from the replicated top), as a handle for
        proofs_finish."""
        if any(not 0 <= i < self.n_leafs for i in idxs):
            raise LeafNotFound()
        k = self.config.leafs_per_node
        n_loc = self._comps.shape[0]
        all_groups = self._sibling_groups(idxs)
        flat = [g for groups in all_groups for grp in groups for g in grp]
        lidx = [i - i % k + j for i in idxs for j in range(k)]
        dev = self.device

        def t(v):
            return torch.tensor(v, dtype=torch.int64, device=dev)

        owner, local, top = (t(v) for v in self._locate(flat))
        if self._local.shape[0]:
            mine = self._local[local]
        else:
            mine = self._top.new_zeros((len(flat), 8))
        dig_rows = owner_select(self.mesh, mine, owner)
        on_top = (top >= 0)[:, None]
        dig_rows = torch.where(on_top, self._top[top.clamp(min=0)], dig_rows)
        leaf_owner = t([i // n_loc for i in lidx])
        leaf_rows = owner_select(self.mesh, self._comps[t([i % n_loc for i in lidx])],
                                 leaf_owner)
        return (all_groups, k, dig_rows, leaf_rows)
