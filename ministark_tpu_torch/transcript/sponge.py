"""Duplex-sponge-over-SHA-256 (nimue ``DigestBridge`` architecture).

The reference's transcript hash is nimue 0.2's ``DigestBridge<Sha256>``
(Cargo.lock pins rev 0e58498). Its *architecture* is: an incremental hasher
absorbs written data; switching to squeeze mode finalizes the absorbed stream
into a 32-byte chaining value ``cv``; squeezed bytes are produced in 32-byte
blocks derived from ``cv`` and a block counter; switching back to absorb mode
chains ``cv`` into a fresh hasher.  Squeezing is *streaming*: output bytes are
independent of the call granularity (two squeezes of n and m bytes equal one
of n+m), which matches the SAFE-style merging of adjacent IO-pattern ops.

PARITY NOTE (see PARITY.md): the nimue sources are not available in this
environment, so the exact byte-level derivations below (tag = SHA-256 of the
IO pattern string; squeeze block = SHA-256(cv || LE64(counter)); absorb-resume
= SHA-256 over (cv || new data)) are a documented reconstruction of the
architecture, pinned by golden vectors in tests/test_transcript.py. Both the
prover and the verifier use this class, so proofs produced by this framework
verify regardless; swapping in byte-exact nimue semantics later only requires
touching this file.
"""

from __future__ import annotations

import hashlib

_ABSORB = 0
_SQUEEZE = 1


class DigestSponge:
    OUTPUT_SIZE = 32

    def __init__(self, iopattern_bytes: bytes):
        tag = hashlib.sha256(iopattern_bytes).digest()
        self._hasher = hashlib.sha256()
        self._cv = b"\x00" * self.OUTPUT_SIZE
        self._mode = _ABSORB
        self._block_ctr = 0
        self._buf = b""
        self.absorb(tag)

    def absorb(self, data: bytes) -> None:
        if self._mode == _SQUEEZE:
            self._hasher = hashlib.sha256()
            self._hasher.update(self._cv)
            self._mode = _ABSORB
            self._block_ctr = 0
            self._buf = b""
        self._hasher.update(data)

    def squeeze(self, n: int) -> bytes:
        if self._mode == _ABSORB:
            self._cv = self._hasher.digest()
            self._hasher = hashlib.sha256()
            self._mode = _SQUEEZE
            self._block_ctr = 0
            self._buf = b""
        out = bytearray()
        while len(out) < n:
            if not self._buf:
                block = hashlib.sha256(
                    self._cv + self._block_ctr.to_bytes(8, "little")
                ).digest()
                self._block_ctr += 1
                self._buf = block
            take = min(n - len(out), len(self._buf))
            out.extend(self._buf[:take])
            self._buf = self._buf[take:]
        return bytes(out)
