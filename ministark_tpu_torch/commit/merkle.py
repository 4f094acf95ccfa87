"""k-ary Merkle tree commitments with the reference's exact semantics.

Replicates src/merkle.rs:8-339 behavior bit-for-bit:

* two branching parameters: ``leafs_per_node`` (leaf-group width) and
  ``inner_children`` (inner fan-in) — src/merkle.rs:34-43;
* leaf-group hash = SHA-256 over the concatenated *decimal Display strings*
  of the field elements (``hasher.update(child.to_string())``,
  src/merkle.rs:162-168) — extension elements use the nested
  ``QuadExtField(c0 + c1 * u)`` rendering;
* inner hash = SHA-256 over concatenated raw child digests;
* single flat ``nodes`` vector built level by level with the reference's
  "distance" index walk and ``get_parent_idx`` arithmetic (src/merkle.rs:81-207);
* proofs are looked up by leaf *value* — linear scan, first occurrence wins
  (src/merkle.rs:216-225; SURVEY.md §8.6) — we accelerate with a value->index
  map that preserves first-occurrence semantics;
* ``MerkleRoot.check_proof`` re-hashes the leaf group and at each level only
  checks *membership* of the previous digest among the siblings
  (src/merkle.rs:312-338).

Hash backends: leaf hashing for large traces is offloaded to the native C++
extension (commit/native.py) or the device SHA-256 kernel (ops/sha256.py);
all backends produce identical digests to this host path.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..utils import LeafNotFound, OutOfRangeError, logarithm_of_two_k


@dataclass(frozen=True)
class MerkleTreeConfig:
    """src/merkle.rs:34-43 (digest is always SHA-256, as in the reference tests)."""

    leafs_per_node: int
    inner_children: int


@dataclass
class MerklePath:
    """src/merkle.rs:293-298: the leaf sibling group plus, per level, the full
    group of sibling digests."""

    leaf_neighbours: List
    path: List[List[bytes]]


class MerkleRoot:
    """src/merkle.rs:300-339."""

    def __init__(self, root: bytes):
        self.root = root

    def check_proof(self, field, proof: MerklePath) -> bool:
        previous = MerkleTree.calculate_from_leafs(field, proof.leaf_neighbours)
        for level in proof.path:
            if previous not in level:
                return False
            previous = MerkleTree.calculate_from_nodes(level)
        return previous == self.root

    def __eq__(self, other):
        return isinstance(other, MerkleRoot) and self.root == other.root


class MerkleTree:
    """src/merkle.rs:56-289."""

    def __init__(
        self,
        field,
        inputs: Sequence,
        config: MerkleTreeConfig,
        leaf_hashes: Optional[List[bytes]] = None,
    ):
        leafs_per_node = config.leafs_per_node
        inner_children = config.inner_children

        leaf_num = len(inputs)
        group_num = leaf_num // leafs_per_node

        try:
            self.levels = logarithm_of_two_k(group_num, inner_children) + 1
        except ValueError as e:
            raise AssertionError(str(e)) from e

        assert leaf_num % leafs_per_node == 0
        assert inner_children ** (self.levels - 1) == group_num, (
            f"Tree is not full! input length must be a power of {inner_children}"
        )

        node_num = (1 - inner_children ** self.levels) // (1 - inner_children)

        self.field = field
        self.config = config
        self.leafs = list(inputs)

        nodes: List[bytes] = []
        # First pass: hash leaf groups (optionally precomputed by a fast backend)
        if leaf_hashes is not None:
            assert len(leaf_hashes) == group_num
            nodes.extend(leaf_hashes)
        else:
            for g in range(group_num):
                chunk = self.leafs[g * leafs_per_node : (g + 1) * leafs_per_node]
                nodes.append(self.calculate_from_leafs(field, chunk))

        # Second pass: build upper levels (same traversal as the reference's
        # "distance" walk — level-by-level order over the flat vector)
        level_start = 0
        level_size = group_num
        while level_size > 1:
            for i in range(level_start, level_start + level_size, inner_children):
                nodes.append(self.calculate_from_nodes(nodes[i : i + inner_children]))
            level_start += level_size
            level_size //= inner_children

        assert len(nodes) == node_num
        self.nodes = nodes
        # value -> first leaf index (preserves the reference's first-match
        # linear-scan semantics, src/merkle.rs:216-225, without the O(n) scan)
        self._index = {}
        for i, v in enumerate(self.leafs):
            self._index.setdefault(self._key(v), i)

    # --- hashing (src/merkle.rs:162-177) ---
    @staticmethod
    def calculate_from_leafs(field, children: Sequence) -> bytes:
        h = hashlib.sha256()
        for child in children:
            h.update(field.to_string(child).encode())
        return h.digest()

    @staticmethod
    def calculate_from_nodes(children: Sequence[bytes]) -> bytes:
        h = hashlib.sha256()
        for child in children:
            h.update(child)
        return h.digest()

    # --- queries ---
    def root(self) -> bytes:
        return self.nodes[-1]

    def get_node_number(self) -> int:
        return len(self.leafs) + len(self.nodes)

    def _key(self, value):
        return value if not isinstance(value, tuple) else value

    def get_parent_idx(self, index: int) -> int:
        """src/merkle.rs:188-207 (indices over the virtual leafs++nodes vector)."""
        root_idx = self.get_node_number() - 1
        if index > root_idx:
            raise OutOfRangeError("index outside of tree length")
        if index == root_idx:
            raise OutOfRangeError("index is root node")
        if index < len(self.leafs):
            return len(self.leafs) + index // self.config.leafs_per_node
        return index + (self.get_node_number() - index + 1) // self.config.inner_children

    def get_leaf_index(self, node) -> int:
        try:
            return self._index[self._key(node)]
        except KeyError:
            raise LeafNotFound() from None

    def get_leaf_neighbours(self, index: int) -> List:
        k = self.config.leafs_per_node
        start = index - index % k
        return self.leafs[start : start + k]

    def get_inner_neighbours(self, index: int) -> List[bytes]:
        shifted = index - len(self.leafs)
        k = self.config.inner_children
        start = shifted - shifted % k
        return self.nodes[start : start + k]

    def calculate_path(self, index: int) -> List[List[bytes]]:
        path = []
        current = index
        for _ in range(1, self.levels):
            path.append(self.get_inner_neighbours(current))
            current = self.get_parent_idx(current)
        return path

    def generate_proof(self, leaf) -> MerklePath:
        """Proof looked up by leaf *value* (first occurrence), src/merkle.rs:262-288."""
        leaf_index = self.get_leaf_index(leaf)
        leaf_neighbours = self.get_leaf_neighbours(leaf_index)
        leaf_parent = self.get_parent_idx(leaf_index)
        path = self.calculate_path(leaf_parent)
        return MerklePath(leaf_neighbours=leaf_neighbours, path=path)
