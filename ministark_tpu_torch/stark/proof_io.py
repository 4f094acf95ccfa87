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


# ---------------------------------------------------------------------------
# Fast-mode proofs (stark/fast.py): compact length-prefixed binary, format
# MSF4 (``ministark_tpu/stark/proof_io.py`` :79-258). Only the batched-FRI
# backend (tag 0) is ported; the STIR and WHIR tags raise until their slice.
# ---------------------------------------------------------------------------

_FAST_MAGIC = b"MSF4"


def _w_bytes(out: bytearray, b: bytes, width: int = 4):
    out += len(b).to_bytes(width, "little")
    out += b


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        assert len(b) == n, "truncated proof"
        self.pos += n
        return b

    def u(self, width: int) -> int:
        return int.from_bytes(self.take(width), "little")

    def blob(self, width: int = 4) -> bytes:
        return self.take(self.u(width))


def _stir_whir_not_ported():
    raise NotImplementedError(
        "STIR and WHIR fast proofs are not ported yet (ROADMAP §1 item 11)")


def fast_proof_to_bytes(stark_field, proof) -> bytes:
    ext = stark_field.extension
    fp = proof.fri_proof
    if hasattr(fp, "round_openings"):
        _stir_whir_not_ported()
    out = bytearray(_FAST_MAGIC)
    _w_bytes(out, stark_field.name.encode(), 1)
    out += (0).to_bytes(1, "little")             # LDE backend tag: batched FRI
    out += proof.width.to_bytes(2, "little")
    out += proof.transitions.to_bytes(2, "little")
    out += proof.n_traces.to_bytes(2, "little")

    out += len(proof.point_evals).to_bytes(2, "little")
    for evals in proof.point_evals:
        out += len(evals).to_bytes(2, "little")
        for e in evals:
            _w_bytes(out, ext.serialize_compressed(e), 1)

    out += len(fp.group_sizes).to_bytes(1, "little")
    for gs in fp.group_sizes:
        out += gs.to_bytes(2, "little")
    out += fp.n.to_bytes(4, "little")
    for root in fp.group_roots:
        out += root
    out += len(fp.layer_roots).to_bytes(2, "little")
    for r in fp.layer_roots:
        out += r
    out += len(fp.final_coeffs).to_bytes(4, "little")
    for c in fp.final_coeffs:
        _w_bytes(out, ext.serialize_compressed(c), 1)
    _w_bytes(out, fp.pow_nonce, 1)

    def w_openings(paths):
        out.extend(len(paths).to_bytes(2, "little"))
        for p in paths:
            _w_bytes(out, p.row)
            out.extend(len(p.groups).to_bytes(1, "little"))
            for g in p.groups:
                _w_bytes(out, g, 2)

    out += len(fp.batch_openings).to_bytes(2, "little")
    for per_query in fp.batch_openings:
        w_openings(per_query)
    out += len(fp.layer_openings).to_bytes(2, "little")
    for group in fp.layer_openings:
        w_openings(group)
    return bytes(out)


def fast_proof_from_bytes(stark_field, data: bytes):
    from ..commit.index_tree import IndexMerklePath
    from ..fri.batched import BatchedFriProof
    from .fast import FastStarkProof

    ext = stark_field.extension
    r = _Reader(data)
    assert r.take(4) == _FAST_MAGIC, "bad magic"
    assert r.blob(1).decode() == stark_field.name, "field mismatch"
    tag = r.u(1)
    assert tag in (0, 1, 2), f"unknown LDE backend tag {tag}"
    if tag:
        _stir_whir_not_ported()
    width = r.u(2)
    transitions = r.u(2)
    n_traces = r.u(2)

    point_evals = []
    for _ in range(r.u(2)):
        point_evals.append(
            [ext.deserialize_compressed(r.blob(1)) for _ in range(r.u(2))]
        )

    group_sizes = [r.u(2) for _ in range(r.u(1))]
    n = r.u(4)
    group_roots = [r.take(32) for _ in range(len(group_sizes))]
    layer_roots = [r.take(32) for _ in range(r.u(2))]
    final_coeffs = [ext.deserialize_compressed(r.blob(1)) for _ in range(r.u(4))]
    pow_nonce = r.blob(1)

    def r_openings():
        paths = []
        for _ in range(r.u(2)):
            row = r.blob()
            groups = [r.blob(2) for _ in range(r.u(1))]
            paths.append(IndexMerklePath(row=row, groups=groups))
        return paths

    batch_openings = [r_openings() for _ in range(r.u(2))]
    layer_openings = [r_openings() for _ in range(r.u(2))]
    assert r.pos == len(data), "trailing bytes"
    fri_proof = BatchedFriProof(
        group_sizes=group_sizes, n=n, group_roots=group_roots,
        layer_roots=layer_roots, final_coeffs=final_coeffs,
        batch_openings=batch_openings, layer_openings=layer_openings,
        pow_nonce=pow_nonce,
    )
    return FastStarkProof(
        width=width, transitions=transitions, point_evals=point_evals,
        fri_proof=fri_proof, n_traces=n_traces,
    )


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
