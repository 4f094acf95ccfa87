"""Merkle leaf hashing: SHA-256 of decimal Display-string preimages.

Port of ``ministark_tpu/ops/leaf_hash.py``. The reference hashes a group of
``leafs_per_node`` field elements as SHA-256 over their concatenated ASCII
renderings (src/merkle.rs:162-168):

  fmt 0 (base field)   "<c0>"                       e.g. "18446744069414584320"
  fmt 1 (quadratic)    "QuadExtField(<c0> + <c1> * u)"
  fmt 2 (BabyBear Fp4) "QuadExtField(QuadExtField(<c00> + <c01> * u) +
                        QuadExtField(<c10> + <c11> * u) * u)"

with every component printed in decimal and the standard SHA-256 padding
(0x80, zeros, 64-bit big-endian bit length). ``max_digits`` bounds a
component's digits and is chosen by field, never by value
(``packed_tree.py:164-167``): 20 for Goldilocks (u64 values), 10 for
BabyBear (values below 2^31), where the digits come from the low 32 bits as
the JAX package's 10-digit path reads only the low word
(``leaf_hash.py:142-143``). A Goldilocks value >= 2^32 given 10 digits would
hash wrong, so the trees pass ``digits_for(field)``.

``leaf_hash`` dispatches by device: a CPU tensor takes ``leaf_hash_plain``
(digit extraction, byte placement and masked multi-block SHA-256 in torch
ops), a CUDA tensor launches csrc/leaf_hash.cu or raises.
"""

from __future__ import annotations

import torch

from . import cuda
from .sha256 import from_u32, sha256_blocks_plain

# Incremented once per call that launches the CUDA leaf-hash kernel, by
# max_digits (20: Goldilocks trees, 10: BabyBear trees).
launches = {20: 0, 10: 0}

MAX_DIGITS = 20

# segment descriptors per format: ("const", bytes) | ("digits", component)
_FMT_SEGMENTS = {
    0: [("digits", 0)],
    1: [("const", b"QuadExtField("), ("digits", 0), ("const", b" + "),
        ("digits", 1), ("const", b" * u)")],
    2: [("const", b"QuadExtField(QuadExtField("), ("digits", 0),
        ("const", b" + "), ("digits", 1), ("const", b" * u) + QuadExtField("),
        ("digits", 2), ("const", b" + "), ("digits", 3), ("const", b" * u) * u)")],
}
_FMT_COMPS = {0: 1, 1: 2, 2: 4}


def digits_for(field) -> int:
    """The digit bound of a field's components, by its modulus
    (``packed_tree.py:167``): 10 below 2^32 (BabyBear), else 20."""
    return 10 if field.p < (1 << 32) else MAX_DIGITS


def max_group_bytes(fmt: int, leafs_per_node: int,
                    max_digits: int = MAX_DIGITS) -> int:
    per = sum(len(v) if kind == "const" else max_digits
              for kind, v in _FMT_SEGMENTS[fmt])
    return per * leafs_per_node


def u64_digits(v: torch.Tensor, max_digits: int = MAX_DIGITS):
    """int64 u64 patterns (...,) -> ((..., max_digits) decimal digits, least
    significant first, (...,) digit counts >= 1). With 20 digits the first
    step halves the value with a logical shift so that every later step
    works on non-negative int64; with 10 the digits are those of the low 32
    bits (the kernel's and the JAX package's 10-digit path)."""
    if max_digits == 10:
        q = v & 0xFFFFFFFF
        digits = []
    else:
        half = (v >> 1) & 0x7FFFFFFFFFFFFFFF       # floor(v / 2), v unsigned
        q = half // 5                               # floor(v / 10)
        digits = [(half - 5 * q) * 2 + (v & 1)]
    while len(digits) < max_digits:
        digits.append(q % 10)
        q = q // 10
    dig = torch.stack(digits, -1)
    idx = torch.arange(1, max_digits + 1, device=v.device)
    length = torch.where(dig != 0, idx, torch.zeros_like(idx)).amax(-1)
    return dig, length.clamp_min(1)


def _check(comps: torch.Tensor, leafs_per_node: int, fmt: int, max_digits: int):
    if fmt not in _FMT_SEGMENTS:
        raise ValueError(f"unknown leaf format {fmt} (0, 1 and 2 exist)")
    if max_digits not in (10, MAX_DIGITS):
        raise ValueError(f"max_digits must be 10 or 20, got {max_digits}")
    if comps.dim() != 2 or comps.shape[1] != _FMT_COMPS[fmt]:
        raise ValueError(f"leaf_hash fmt {fmt}: need (n, {_FMT_COMPS[fmt]}) "
                         f"components, got {tuple(comps.shape)}")
    if comps.shape[0] % leafs_per_node:
        raise ValueError("leaf count must be a multiple of leafs_per_node")


def leaf_hash_plain(comps: torch.Tensor, leafs_per_node: int, fmt: int,
                    max_digits: int = MAX_DIGITS):
    """Plain PyTorch version: (n_elems, comps) int64 -> (n_groups, 8) int32
    digests of each group of ``leafs_per_node`` consecutive elements."""
    _check(comps, leafs_per_node, fmt, max_digits)
    k = leafs_per_node
    G = comps.shape[0] // k
    dev = comps.device
    dig, dlen = u64_digits(comps.reshape(G, k, -1), max_digits)  # (G,k,c,md)
    B = max_group_bytes(fmt, k, max_digits)
    n_blocks = (B + 8) // 64 + 1
    PB = n_blocks * 64
    dump = PB                                  # column for masked-off writes
    buf = torch.zeros((G, PB + 1), dtype=torch.int64, device=dev)
    pos = torch.zeros((G,), dtype=torch.int64, device=dev)
    j = torch.arange(max_digits, device=dev)
    for e in range(k):
        for kind, v in _FMT_SEGMENTS[fmt]:
            if kind == "const":
                cols = pos[:, None] + torch.arange(len(v), device=dev)[None]
                vals = torch.tensor(list(v), dtype=torch.int64, device=dev)
                buf.scatter_(1, cols, vals.expand(G, len(v)))
                pos = pos + len(v)
            else:
                ln = dlen[:, e, v][:, None]                       # (G, 1)
                # character j is digit ln-1-j (most significant first)
                d = torch.gather(dig[:, e, v], 1, (ln - 1 - j).clamp_min(0))
                cols = torch.where(j < ln, pos[:, None] + j, dump)
                buf.scatter_(1, cols, d + 48)
                pos = pos + ln[:, 0]
    total = pos
    buf.scatter_(1, total[:, None], torch.full_like(total[:, None], 0x80))
    last = (total + 8) // 64                    # index of the last block
    bitlen = total * 8                          # < 2^32: 4 low bytes only
    for b in range(4):
        cols = (last * 64 + 60 + b)[:, None]
        buf.scatter_(1, cols, ((bitlen >> (24 - 8 * b)) & 0xFF)[:, None])
    w = buf[:, :PB].reshape(G, n_blocks, 16, 4)
    words = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]
    active = torch.arange(n_blocks, device=dev)[None] <= last[:, None]
    return from_u32(sha256_blocks_plain(words, active))


def leaf_hash_cuda(comps: torch.Tensor, leafs_per_node: int, fmt: int,
                   max_digits: int = MAX_DIGITS):
    """CUDA kernel (csrc/leaf_hash.cu), same contract as ``leaf_hash_plain``.

    Replaces the Pallas kernel ``ministark_tpu/ops/sha256_pallas.py::
    _make_masked_kernel`` and the XLA digit extraction and byte placement
    around it (``leaf_hash.py:87``, ``:243-304``). One thread per leaf
    group reads the group's u64 components, writes the decimal digits and
    constant segments into a 64-byte block buffer, compresses whenever the
    buffer fills, pads, and stores 8 big-endian words; with 10 digits
    the ladder runs on 32 bits. Bound on this card: integer ALU throughput
    (up to 4 compressions plus 20 or 10 divide-by-10 steps per component,
    per 8-32 bytes read)."""
    cuda.require(comps, "leaf_hash", torch.int64, 2)
    _check(comps, leafs_per_node, fmt, max_digits)
    G = comps.shape[0] // leafs_per_node
    out = torch.empty((G, 8), dtype=torch.int32, device=comps.device)
    if G:
        err = cuda.library().ms_leaf_hash(
            comps.data_ptr(), out.data_ptr(), G, leafs_per_node, fmt,
            max_digits, cuda.stream_ptr(comps))
        cuda.check("leaf_hash", err)
        launches[max_digits] += 1
    return out


def leaf_hash(comps: torch.Tensor, leafs_per_node: int, fmt: int,
              max_digits: int = MAX_DIGITS):
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if comps.device.type == "cpu":
        return leaf_hash_plain(comps, leafs_per_node, fmt, max_digits)
    return leaf_hash_cuda(comps, leafs_per_node, fmt, max_digits)
