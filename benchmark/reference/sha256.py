"""Plain SHA-256 (FIPS 180-4) over batches of equal-length messages, in
int64 tensor ops, and the index tree built from it.

A message is a row of 32-bit big-endian words held in int64; every row of
a batch has the same length, so one compression per block runs over the
whole batch at once.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

M32 = 0xFFFFFFFF
H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4,
    0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE,
    0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F,
    0x4A7484AA, 0x5CB0A9DC, 0x76F988DA, 0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC,
    0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070, 0x19A4C116,
    0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7,
    0xC67178F2,
)


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state, block):
    """One SHA-256 compression: state, 8 (L,) tensors; block, 16 (L,)."""
    w = list(block)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if t >= 16:
            x, y = w[t - 15], w[t - 2]
            s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
            s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = h + S1 + ch + K[t] + w[t]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + S0 + maj) & M32
    return [(s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_words(words: torch.Tensor) -> torch.Tensor:
    """(L, W) message words (each message 4W bytes) -> (L, 8) digests."""
    L, W = words.shape
    nbits = 32 * W
    blocks = (4 * W + 9 + 63) // 64
    pad = torch.zeros((L, 16 * blocks - W), dtype=torch.int64, device=words.device)
    pad[:, 0] = 0x80000000
    pad[:, -2] = nbits >> 32
    pad[:, -1] = nbits & M32
    msg = torch.cat([words, pad], 1)
    state = [torch.full((L,), v, dtype=torch.int64, device=words.device) for v in H0]
    for k in range(blocks):
        blk = msg[:, 16 * k:16 * (k + 1)]
        state = _compress(state, [blk[:, i] for i in range(16)])
    return torch.stack(state, 1)


def _bswap32(x):
    return (((x & 0xFF) << 24) | (((x >> 8) & 0xFF) << 16)
            | (((x >> 16) & 0xFF) << 8) | ((x >> 24) & 0xFF))


def u64_words(comps: torch.Tensor) -> torch.Tensor:
    """(L, C) values as u64 bit patterns -> (L, 2C) words of their
    little-endian bytes, as SHA-256 reads them (big-endian words)."""
    lo = _bswap32(comps & M32)
    hi = _bswap32((comps >> 32) & M32)
    return torch.stack([lo, hi], -1).reshape(comps.shape[0], -1)


def row_bytes(comps) -> bytes:
    """(C,) u64 bit patterns -> their little-endian bytes."""
    return b"".join((int(v) % (1 << 64)).to_bytes(8, "little") for v in comps.tolist())


class IndexTree:
    """The fast mode's index tree: leaf i is SHA-256 of row i's components
    as little-endian u64 bytes, each parent SHA-256 of its children's
    digests, ``arity`` children a parent (fewer where fewer remain).
    ``leaf_rows(lo, hi)`` gives rows [lo, hi) as (hi - lo, C) bit
    patterns, so no whole copy of the rows is kept; openings read them
    again. A level of ``tensor_min`` nodes or more hashes in tensor ops
    (the leaves in blocks of ``block`` rows), a smaller one with hashlib on
    the host. Every level is kept as (nodes, 32) digest bytes."""

    def __init__(self, leaf_rows, n_leaves: int, arity: int, tensor_min: int = 1 << 16,
                 block: int = 1 << 20):
        self.leaf_rows, self.arity = leaf_rows, arity
        if n_leaves >= tensor_min:
            cur = torch.cat([sha256_words(u64_words(leaf_rows(lo, min(lo + block, n_leaves))))
                             for lo in range(0, n_leaves, block)], 0)
            self.levels = [_digest_array(cur)]
        else:
            rows = leaf_rows(0, n_leaves).cpu().numpy().astype("<i8")
            self.levels = [_hash_rows(rows.view(np.uint8).reshape(n_leaves, -1))]
            cur = None
        while self.levels[-1].shape[0] > 1:
            size = self.levels[-1].shape[0]
            f = min(arity, size)
            if cur is not None and size // f >= tensor_min:
                cur = sha256_words(cur.reshape(size // f, 8 * f))
                self.levels.append(_digest_array(cur))
            else:
                cur = None
                self.levels.append(_hash_rows(self.levels[-1].reshape(size // f, 32 * f)))

    def root(self) -> bytes:
        return self.levels[-1][0].tobytes()

    def open(self, idx: int):
        """(row bytes, [sibling group bytes a level])."""
        groups, pos = [], idx
        for level in self.levels[:-1]:
            f = min(self.arity, level.shape[0])
            start = pos - pos % f
            groups.append(level[start:start + f].tobytes())
            pos //= f
        return row_bytes(self.leaf_rows(idx, idx + 1)[0]), groups


def _digest_array(d: torch.Tensor) -> np.ndarray:
    """(L, 8) digest words -> (L, 32) bytes on the host."""
    return d.cpu().numpy().astype(">u4").view(np.uint8).reshape(d.shape[0], 32)


def _hash_rows(buf: np.ndarray) -> np.ndarray:
    """(L, k) bytes -> (L, 32) hashlib SHA-256 digests."""
    out = b"".join(hashlib.sha256(row.tobytes()).digest() for row in buf)
    return np.frombuffer(out, dtype=np.uint8).reshape(buf.shape[0], 32)
