from .merkle import MerkleTree, MerkleTreeConfig, MerklePath, MerkleRoot

__all__ = ["MerkleTree", "MerkleTreeConfig", "MerklePath", "MerkleRoot"]
