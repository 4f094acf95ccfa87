"""Prover (Merlin) and verifier (Arthur) transcript views.

nimue semantics (used at src/starks.rs:64,73-81,... and src/fri.rs):

* ``Merlin`` (prover): written data (``add_bytes`` / ``add_scalars``) is both
  absorbed into the sponge and appended to the *narg string* — the transcript
  byte vector shipped inside the proof (``merlin.transcript()``,
  src/starks.rs:160). Challenges are squeezed and not shipped.
* ``Arthur`` (verifier): reads the next declared units from the narg string,
  absorbing them, and re-squeezes the same challenges.
* both enforce the declared IO pattern op-by-op (merged-adjacent semantics).

Field encodings (nimue ark plugin):
* ``add_scalars``: compressed little-endian canonical coordinates;
* ``challenge_scalars``: per base coefficient, ``bytes_uniform_modp`` bytes
  interpreted big-endian and reduced mod p; extension elements take their
  coefficients in tower order (c0..c{d-1}).
"""

from __future__ import annotations

from typing import List

from ..utils import TranscriptError
from .iopattern import IOPattern, bytes_uniform_modp
from .sponge import DigestSponge


class _TranscriptBase:
    def __init__(self, io: IOPattern):
        self.io = io
        self.sponge = DigestSponge(io.as_bytes())
        self._stack = io.finalize()
        self._pos = 0  # bytes consumed within the current op

    def _consume(self, kind: str, count: int) -> None:
        if not self._stack:
            raise TranscriptError(f"transcript exhausted; attempted {kind}{count}")
        op, budget = self._stack[0]
        if op != kind:
            raise TranscriptError(
                f"transcript op mismatch: declared {op}{budget}, attempted {kind}{count}"
            )
        if self._pos + count > budget:
            raise TranscriptError(
                f"transcript op overflow: declared {op}{budget}, "
                f"attempted {count} at offset {self._pos}"
            )
        self._pos += count
        if self._pos == budget:
            self._stack.pop(0)
            self._pos = 0

    # --- shared challenge squeezing ---
    def fill_challenge_bytes(self, n: int) -> bytes:
        self._consume("S", n)
        return self.sponge.squeeze(n)

    def challenge_scalars(self, field, count: int) -> List:
        width = bytes_uniform_modp(field.base.modulus_bit_size)
        per_elem = field.extension_degree * width
        out = []
        for _ in range(count):
            buf = self.fill_challenge_bytes(per_elem)
            coeffs = tuple(
                field.base.from_be_bytes_mod_order(buf[i * width : (i + 1) * width])
                for i in range(field.extension_degree)
            )
            out.append(field.from_base_coeffs(coeffs))
        return out

    def challenge_scalar(self, field):
        return self.challenge_scalars(field, 1)[0]


class Merlin(_TranscriptBase):
    def __init__(self, io: IOPattern):
        super().__init__(io)
        self._narg = bytearray()

    def add_bytes(self, data: bytes) -> None:
        self._consume("A", len(data))
        self.sponge.absorb(data)
        self._narg.extend(data)

    def add_scalars(self, field, scalars: List) -> None:
        data = b"".join(field.serialize_compressed(s) for s in scalars)
        self.add_bytes(data)

    def transcript(self) -> bytes:
        return bytes(self._narg)


class Arthur(_TranscriptBase):
    def __init__(self, io: IOPattern, narg: bytes):
        super().__init__(io)
        self._narg = narg
        self._read = 0

    def fill_next_units(self, n: int) -> bytes:
        if self._read + n > len(self._narg):
            raise TranscriptError("transcript bytes exhausted")
        data = self._narg[self._read : self._read + n]
        self._read += n
        self._consume("A", n)
        self.sponge.absorb(data)
        return data

    def next_digest(self) -> bytes:
        return self.fill_next_units(32)

    def next_scalars(self, field, count: int) -> List:
        data = self.fill_next_units(count * field.compressed_size)
        out = []
        w = field.compressed_size
        for i in range(count):
            out.append(field.deserialize_compressed(data[i * w : (i + 1) * w]))
        return out
