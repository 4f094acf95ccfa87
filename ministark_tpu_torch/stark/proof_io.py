"""Proof (de)serialization.

The reference keeps proofs purely in memory (no serde — SURVEY §5
"checkpoint/resume: none"); persistence is new framework capability, needed
for cross-checking against reference vectors and for shipping proofs between
prover and verifier processes.

Format: a self-describing JSON envelope; field scalars are encoded as the
compressed little-endian hex used by the transcript layer, digests as hex.
"""

from __future__ import annotations

import hashlib
import json
from ..commit.merkle import MerklePath
from ..fri.fri import FriProof
from .stark import StarkProof


def _enc_scalar(field, s) -> str:
    return field.serialize_compressed(s).hex()

def _dec_scalar(field, h: str):
    return field.deserialize_compressed(bytes.fromhex(h))


def _enc_path(ext, p: MerklePath) -> dict:
    return {
        "leaf_neighbours": [_enc_scalar(ext, v) for v in p.leaf_neighbours],
        "path": [[d.hex() for d in level] for level in p.path],
    }

def _dec_path(ext, d: dict) -> MerklePath:
    return MerklePath(
        leaf_neighbours=[_dec_scalar(ext, v) for v in d["leaf_neighbours"]],
        path=[[bytes.fromhex(x) for x in level] for level in d["path"]],
    )


def proof_to_json(stark_field, proof: StarkProof) -> str:
    ext = stark_field.extension
    fri = proof.fri_proof
    if hasattr(fri, "to_host"):
        fri = fri.to_host()
    doc = {
        "version": 1,
        "field": stark_field.name,
        "arthur": proof.arthur.hex(),
        "trace_commit": proof.trace_commit.hex(),
        "constrain_trace_commit": proof.constrain_trace_commit.hex(),
        "constrain_queries": [
            [_enc_scalar(ext, v) for v in q] for q in proof.constrain_queries
        ],
        "validity_queries": [_enc_scalar(ext, v) for v in proof.validity_queries],
        "fri": {
            "points": [
                [[[_enc_scalar(ext, x), _enc_scalar(ext, y)] for (x, y) in triple]
                 for triple in rnd]
                for rnd in fri.points
            ],
            "queries": [
                [[_enc_path(ext, p1), _enc_path(ext, p2)] for (p1, p2) in rnd]
                for rnd in fri.queries
            ],
            "quotients": [
                [[_enc_scalar(ext, c) for c in q] for q in rnd]
                for rnd in fri.quotients
            ],
        },
    }
    return json.dumps(doc)


def proof_digests(stark_field, proof: StarkProof) -> dict:
    """Short fingerprints of a parity proof, for pinning large proofs whose
    JSON would be tens of MB: both commitments, SHA-256 of the transcript,
    and SHA-256 of the FRI query payload. The payload is hashed round by
    round, query by query: the three (x, y) points, then the quotient
    coefficients, then the two Merkle paths (leaf neighbours, then each
    level's digests). Every variable-length list is prefixed by its length
    as 4 little-endian bytes; scalars use the compressed serialization."""
    ext = stark_field.extension
    ser = ext.serialize_compressed
    fri = proof.fri_proof
    if hasattr(fri, "to_host"):
        fri = fri.to_host()

    def n(items) -> bytes:
        return len(items).to_bytes(4, "little")

    h = hashlib.sha256()
    for r, rnd in enumerate(fri.points):
        for q, triple in enumerate(rnd):
            for x, y in triple:
                h.update(ser(x) + ser(y))
            quotient = fri.quotients[r][q]
            h.update(n(quotient) + b"".join(ser(c) for c in quotient))
            for path in fri.queries[r][q]:
                h.update(n(path.leaf_neighbours))
                h.update(b"".join(ser(v) for v in path.leaf_neighbours))
                for level in path.path:
                    h.update(n(level) + b"".join(level))
    return {
        "trace_commit": proof.trace_commit.hex(),
        "constrain_trace_commit": proof.constrain_trace_commit.hex(),
        "arthur_sha256": hashlib.sha256(proof.arthur).hexdigest(),
        "fri_payload_sha256": h.hexdigest(),
    }


def proof_from_json(stark_field, data: str) -> StarkProof:
    ext = stark_field.extension
    doc = json.loads(data)
    assert doc["version"] == 1
    assert doc["field"] == stark_field.name, "field mismatch"
    fri = FriProof(
        points=[
            [[tuple([_dec_scalar(ext, x), _dec_scalar(ext, y)]) for x, y in triple]
             for triple in rnd]
            for rnd in doc["fri"]["points"]
        ],
        queries=[
            [[_dec_path(ext, p1), _dec_path(ext, p2)] for p1, p2 in rnd]
            for rnd in doc["fri"]["queries"]
        ],
        quotients=[
            [[_dec_scalar(ext, c) for c in q] for q in rnd]
            for rnd in doc["fri"]["quotients"]
        ],
    )
    return StarkProof(
        arthur=bytes.fromhex(doc["arthur"]),
        trace_commit=bytes.fromhex(doc["trace_commit"]),
        constrain_trace_commit=bytes.fromhex(doc["constrain_trace_commit"]),
        constrain_queries=[
            [_dec_scalar(ext, v) for v in q] for q in doc["constrain_queries"]
        ],
        validity_queries=[_dec_scalar(ext, v) for v in doc["validity_queries"]],
        fri_proof=fri,
    )
