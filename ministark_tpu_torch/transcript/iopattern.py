"""Fiat-Shamir IO patterns (nimue ``IOPattern`` semantics + the reference's
STARK/FRI pattern builders from src/fiatshamir.rs).

An IO pattern is a declarative description of the whole transcript: a domain
separator string followed by absorb ("A{n}label") / squeeze ("S{n}label") ops,
serialized as ``domsep \\0 op \\0 op ...``. The serialized string seeds the
sponge (domain separation), and the op list is enforced at runtime: adjacent
ops of the same kind merge (SAFE-style), and every absorb/squeeze performed by
Merlin/Arthur must stay within the declared budget.

Field ops follow the nimue ark plugin byte accounting:

* ``challenge_scalars(count, label)`` over field F squeezes
  ``count * extension_degree * bytes_uniform_modp(base_bits)`` bytes where
  ``bytes_uniform_modp(bits) = (bits + 128) // 8`` (16 statistical-excess
  bytes); each base coefficient is reduced from big-endian bytes mod p.
* ``add_scalars(count, label)`` absorbs ``count * compressed_size`` bytes
  (little-endian canonical coordinates).
* ``add_digest(count, label)`` absorbs ``count * 32`` bytes
  (reference src/fiatshamir.rs:19-31).
"""

from __future__ import annotations

from typing import List, Tuple

SEP = "\x00"


def bytes_uniform_modp(modulus_bits: int) -> int:
    return (modulus_bits + 128) // 8


class IOPattern:
    def __init__(self, domsep: str):
        assert SEP not in domsep
        self._parts: List[str] = [domsep]

    # --- core ops (nimue safe API) ---
    def absorb(self, count: int, label: str) -> "IOPattern":
        assert count > 0
        assert SEP not in label
        assert not (label and label[0].isdigit())
        self._parts.append(f"A{count}{label}")
        return self

    def squeeze(self, count: int, label: str) -> "IOPattern":
        assert count > 0
        assert SEP not in label
        assert not (label and label[0].isdigit())
        self._parts.append(f"S{count}{label}")
        return self

    # --- byte/digest sugar (nimue ByteIOPattern + reference DigestIOWritter) ---
    def add_bytes(self, count: int, label: str) -> "IOPattern":
        return self.absorb(count, label)

    def challenge_bytes(self, count: int, label: str) -> "IOPattern":
        return self.squeeze(count, label)

    def add_digest(self, count: int, label: str) -> "IOPattern":
        return self.add_bytes(count * 32, label)

    # --- ark field sugar (nimue ark plugin) ---
    def add_scalars(self, field, count: int, label: str) -> "IOPattern":
        return self.absorb(count * field.compressed_size, label)

    def challenge_scalars(self, field, count: int, label: str) -> "IOPattern":
        n = count * field.extension_degree * bytes_uniform_modp(field.base.modulus_bit_size)
        return self.squeeze(n, label)

    # --- serialization + runtime stack ---
    def as_string(self) -> str:
        return SEP.join(self._parts)

    def as_bytes(self) -> bytes:
        return self.as_string().encode("utf-8")

    def finalize(self) -> List[Tuple[str, int]]:
        """Parse into an op stack, merging adjacent same-kind ops."""
        stack: List[Tuple[str, int]] = []
        for part in self._parts[1:]:
            kind = part[0]
            i = 1
            while i < len(part) and part[i].isdigit():
                i += 1
            count = int(part[1:i])
            if stack and stack[-1][0] == kind:
                stack[-1] = (kind, stack[-1][1] + count)
            else:
                stack.append((kind, count))
        return stack


# ---------------------------------------------------------------------------
# Reference pattern builders (src/fiatshamir.rs:33-117)
# ---------------------------------------------------------------------------


def new_stark_iopattern(
    stark_field, rounds: int, constrain_queries: int, fri_queries: int, domsep: str
) -> IOPattern:
    """``StarkIOPattern::new_stark`` (src/fiatshamir.rs:48-64)."""
    base = stark_field.base
    ext = stark_field.extension
    io = IOPattern(domsep)
    io.add_digest(1, "commit to original trace")
    io.challenge_scalars(base, 1, "ZK: pick random shift of domain")
    io.add_digest(1, "commit to quotients")
    io.challenge_scalars(base, 1, "batching: retrieve random scalar r")
    io.challenge_scalars(
        base,
        constrain_queries * ext.extension_degree,
        "number of queries in DEEP ALI",
    )
    return add_fri_iopattern(io, ext, rounds, fri_queries)


def new_fri_iopattern(ext_field, domsep: str, rounds: int, queries: int) -> IOPattern:
    """``FriIOPattern::new_fri`` (src/fiatshamir.rs:98-100)."""
    return add_fri_iopattern(IOPattern(domsep), ext_field, rounds, queries)


def add_fri_iopattern(io: IOPattern, ext_field, rounds: int, queries: int) -> IOPattern:
    """``FriIOPattern::add_fri`` (src/fiatshamir.rs:102-117)."""
    for _ in range(rounds - 1):
        io.challenge_scalars(ext_field, 1, "(DEEP) FRI: pick random z")
        io.add_scalars(ext_field, 2, "(DEEP) FRI: degree one B polynomial")
        io.challenge_scalars(ext_field, 1, "FRI COMMIT Phase: random scalar challenge")
        io.add_digest(1, "FRI COMMIT Phase: commit to folded codeword")
    io.challenge_bytes(
        8 * queries, "FRI QUERY Phase: choose a random element in the domain"
    )
    return io
