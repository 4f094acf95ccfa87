"""Replication of the reference's deterministic "ZK" randomness stream.

The reference pads traces with ``F::rand(&mut ark_std::test_rng())`` — note the
RNG is constructed *fresh for every padded cell* (reference: src/air.rs:79-83,
``(0..padding_length).map(|_| F::rand(&mut test_rng()))``), so every padding
cell holds the *same* field element: the first accepted sample from the fixed
seed.

Chain replicated here (PARITY.md has confidence notes):
  * ``ark_std::test_rng()`` = ``rand::rngs::StdRng::from_seed(ARK_TEST_SEED)``
    with the well-known hard-coded 32-byte seed (ark-std 0.5 lib.rs).
  * rand 0.8's ``StdRng`` is ChaCha12 (rand_chacha 0.3): 32-byte key, 64-bit
    stream = 0, 32-bit block counter starting at 0; ``next_u64`` consumes two
    consecutive little-endian 32-bit output words (lo, hi).
  * ``Fp::rand`` (ark-ff 0.5 Montgomery backend, N=1 u64 limb): draw a u64
    limb, mask the top ``64*N - MODULUS_BIT_SIZE`` bits, reject if >= p, and —
    crucially — interpret the accepted limb as the *Montgomery representation*
    of the element (ark constructs ``Fp(BigInt, PhantomData)`` raw). The
    canonical value is ``limb * 2^{-64} mod p``.
"""

import struct

ARK_TEST_SEED = bytes(
    [1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
)

_MASK32 = 0xFFFFFFFF


def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _MASK32


def chacha_block(key_words, counter: int, nonce_words, rounds: int = 12):
    """One ChaCha block: 16 output words (u32) for the given 256-bit key,
    32-bit block counter and 96-bit nonce (IETF layout used by rand_chacha's
    word64 variant uses 64-bit counter + 64-bit nonce; rand_chacha 0.3 uses a
    64-bit counter occupying words 12-13 and 64-bit stream id in words 14-15).
    """
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & _MASK32, (counter >> 32) & _MASK32,
        nonce_words[0], nonce_words[1],
    ]
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _MASK32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _MASK32
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    return [(x[i] + state[i]) & _MASK32 for i in range(16)]


class ChaCha12Rng:
    """rand_chacha 0.3 ``ChaCha12Rng`` word-stream semantics (as used by
    rand 0.8 ``StdRng``): words are emitted block by block in order; ``next_u32``
    pops one word, ``next_u64`` pops two (lo then hi)."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = list(struct.unpack("<8I", seed))
        self.counter = 0
        self.buf = []

    def _refill(self):
        self.buf.extend(chacha_block(self.key, self.counter, (0, 0), rounds=12))
        self.counter += 1

    def next_u32(self) -> int:
        if not self.buf:
            self._refill()
        return self.buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)


def ark_test_rng() -> ChaCha12Rng:
    return ChaCha12Rng(ARK_TEST_SEED)


def fp_rand_limb(rng: ChaCha12Rng, modulus: int, modulus_bit_size: int) -> int:
    """ark-ff 0.5 ``Fp::rand`` for a single-u64-limb Montgomery backend:
    returns the accepted raw limb (= Montgomery representation)."""
    shave_bits = 64 - modulus_bit_size
    mask = 0 if shave_bits == 64 else (0xFFFFFFFFFFFFFFFF >> shave_bits)
    while True:
        limb = rng.next_u64() & mask
        if limb < modulus:
            return limb


def ark_test_rng_fp(modulus: int, modulus_bit_size: int) -> int:
    """Canonical value of ``F::rand(&mut ark_std::test_rng())`` for a base
    prime field with a 64-bit Montgomery limb (R = 2^64 mod p)."""
    limb = fp_rand_limb(ark_test_rng(), modulus, modulus_bit_size)
    r_inv = pow(1 << 64, modulus - 2, modulus)
    return (limb * r_inv) % modulus
