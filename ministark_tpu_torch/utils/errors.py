"""Error types mirroring the reference's error_set! enums (src/error.rs:1-22).

The reference surfaces protocol soundness failures as panics and uses error
enums only for transcript and Merkle lookup failures; we mirror that split:
soundness checks raise ``AssertionError`` (via plain asserts) while the error
paths below are raised for transcript / Merkle issues.
"""


class MiniStarkError(Exception):
    """Base class for all framework errors."""


class TranscriptError(MiniStarkError):
    """Fiat-Shamir transcript violated its IO pattern (nimue IOPatternError)."""


class MerkleProofError(MiniStarkError):
    """Base for Merkle proof generation errors (src/error.rs:13-21)."""


class LeafNotFound(MerkleProofError):
    def __init__(self, msg: str = "leaf is not included in the tree"):
        super().__init__(f"Error generating Merkle proof: {msg}")


class OutOfRangeError(MerkleProofError):
    def __init__(self, msg: str):
        super().__init__(f"Error generating Merkle proof: {msg}")


class ProverError(MiniStarkError):
    """Prover-side failure (src/error.rs:4-8)."""


class VerifierError(MiniStarkError):
    """Verifier-side failure (src/error.rs:9-12)."""
