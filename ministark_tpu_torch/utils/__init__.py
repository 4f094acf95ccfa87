from .math import is_power_of_two, logarithm_of_two_k, ceil_log2_k
from .errors import (
    MiniStarkError,
    MerkleProofError,
    LeafNotFound,
    OutOfRangeError,
    ProverError,
    VerifierError,
    TranscriptError,
)

__all__ = [
    "is_power_of_two",
    "logarithm_of_two_k",
    "ceil_log2_k",
    "MiniStarkError",
    "MerkleProofError",
    "LeafNotFound",
    "OutOfRangeError",
    "ProverError",
    "VerifierError",
    "TranscriptError",
]
