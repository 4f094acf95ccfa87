"""Batched SHA-256: Merkle inner levels and binary row leaves.

Port of ``ministark_tpu/ops/sha256.py`` (``sha256_blocks``, ``_inner_level``
:113, ``_inner_levels_fused`` :134, ``binary_row_digests`` :194,
``digests_to_bytes`` :212, ``bytes_to_digests`` :224). A digest is a row of
8 big-endian u32 words held in an ``int32`` tensor (n, 8); the CUDA kernels
read it as ``uint32_t``. Row components are int64 u64 bit patterns.

``inner_level`` (fan 2 for the parity trees, the arity for the fast mode's
index trees) and ``binary_row_digests`` dispatch by device: a CPU tensor
takes the plain version (the compression written in int64 torch ops on u32
values), a CUDA tensor launches csrc/sha256.cu or raises. The Merkle trees
call them once per level down to the root, at every level width.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda

# Incremented once per call that launches the CUDA inner-level kernel
# (``fan_launches`` splits the same count by fan), and the row-leaf kernel.
launches = 0
fan_launches: dict = {}
row_launches = 0

M32 = 0xFFFFFFFF

_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)

_H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)


def pad_block(msg_bytes: int):
    """Final all-padding block (16 words) for a block-aligned message."""
    assert msg_bytes % 64 == 0
    return [0x80000000] + [0] * 14 + [msg_bytes * 8]


# ------------------------------------------------------------ plain version
def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state, w):
    """One block. state: 8 int64 tensors of u32 values; w: 16 such tensors
    (or ints) of big-endian message words. Returns the new state."""
    w = list(w)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        if i >= 16:
            w15, w2 = w[(i - 15) % 16], w[(i - 2) % 16]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w[i % 16] = (w[i % 16] + s0 + w[(i - 7) % 16] + s1) & M32
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = h + S1 + ch + _K[i] + w[i % 16]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f = g, f, e
        e = (d + t1) & M32
        d, c, b = c, b, a
        a = (t1 + S0 + maj) & M32
    return [(s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def to_u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & M32


def from_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return ((t ^ 0x80000000) - 0x80000000).to(torch.int32)


def sha256_blocks_plain(words: torch.Tensor, active=None) -> torch.Tensor:
    """words: (lanes, n_blocks, 16) int64 u32 big-endian words, padded;
    active: optional (lanes, n_blocks) bool, False blocks leave a lane's
    state as it was. Returns (lanes, 8) int64 u32 digest words."""
    lanes = words.shape[0]
    state = [torch.full((lanes,), h, dtype=torch.int64, device=words.device)
             for h in _H0]
    for blk in range(words.shape[1]):
        new = _compress(state, [words[:, blk, j] for j in range(16)])
        if active is None:
            state = new
        else:
            m = active[:, blk]
            state = [torch.where(m, ns, s) for ns, s in zip(new, state)]
    return torch.stack(state, 1)


def inner_level_plain(digests: torch.Tensor, fan: int = 2) -> torch.Tensor:
    """Plain PyTorch version: (fan * n, 8) int32 child digests -> (n, 8)
    parents, SHA-256 of each group's fan * 32 concatenated bytes: fan/2
    data blocks, then the padding block (``_inner_level``, src/merkle.rs:
    171-177)."""
    _check_level(digests, fan, "sha256_inner_level")
    d = to_u32(digests).reshape(-1, fan // 2, 16)
    state = [torch.full((d.shape[0],), h, dtype=torch.int64, device=d.device)
             for h in _H0]
    for b in range(fan // 2):
        state = _compress(state, [d[:, b, j] for j in range(16)])
    state = _compress(state, pad_block(fan * 32))
    return from_u32(torch.stack(state, 1))


def _bswap32(x):
    """Byte swap of int64 tensors holding u32 values."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def _row_tail(C: int):
    """The constant words after a row's 2C data words: 0x80000000, zeros,
    the 64-bit bit length; (8C + 9 + 63) // 64 blocks in all."""
    m = 8 * C
    n_blocks = (m + 9 + 63) // 64
    tail = [0] * (n_blocks * 16 - 2 * C)
    tail[0] = 0x80000000
    tail[-2] = (m * 8) >> 32
    tail[-1] = (m * 8) & M32
    return n_blocks, tail


def binary_row_digests_plain(comps: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (n, C) int64 u64 components -> (n, 8) int32
    digests of each row's C little-endian u64s (``binary_row_digests``
    :194; hashlib.sha256(row_le_bytes))."""
    _check_rows(comps)
    n, C = comps.shape
    words = torch.stack([_bswap32(comps & M32), _bswap32((comps >> 32) & M32)],
                        -1).reshape(n, 2 * C)
    n_blocks, tail = _row_tail(C)
    tail_t = torch.tensor(tail, dtype=torch.int64, device=comps.device)
    msgs = torch.cat([words, tail_t.expand(n, -1)], 1).reshape(n, n_blocks, 16)
    return from_u32(sha256_blocks_plain(msgs))


def _check_level(digests, fan: int, name: str):
    if fan < 2 or fan & (fan - 1):
        raise ValueError(f"{name}: fan must be a power of two >= 2, got {fan}")
    if digests.dim() != 2 or digests.shape[1] != 8 or digests.shape[0] % fan:
        raise ValueError(f"{name}: need ({fan}n, 8) digests, got "
                         f"{tuple(digests.shape)}")


def _check_rows(comps):
    if comps.dim() != 2 or comps.shape[1] < 1:
        raise ValueError(f"sha256_rows: need (n, C) components, got "
                         f"{tuple(comps.shape)}")


# ------------------------------------------------------------ CUDA kernels
CUDA_FANS = (2, 4, 8)


def inner_level_cuda(digests: torch.Tensor, fan: int = 2) -> torch.Tensor:
    """CUDA kernel (csrc/sha256.cu), same contract as ``inner_level_plain``.

    Replaces the Pallas kernel ``ministark_tpu/ops/sha256_pallas.py::
    _make_kernel`` as reached through ``inner_level_tr``: one thread per
    parent compresses its fan/2 blocks of child words and then the constant
    padding block, whose schedule is immediates. Bound on this card:
    integer ALU throughput (fan/2 + 1 64-round compressions per fan * 32
    bytes read)."""
    global launches
    cuda.require(digests, "sha256_inner_level", torch.int32, 2)
    _check_level(digests, fan, "sha256_inner_level")
    if fan not in CUDA_FANS:
        raise ValueError(f"sha256_inner_level: the kernel takes fan {CUDA_FANS}, "
                         f"got {fan}")
    n = digests.shape[0] // fan
    out = torch.empty((n, 8), dtype=torch.int32, device=digests.device)
    if n:
        err = cuda.library().ms_sha256_inner_level(
            digests.data_ptr(), out.data_ptr(), n, fan, cuda.stream_ptr(digests))
        cuda.check("sha256_inner_level", err)
        launches += 1
        fan_launches[fan] = fan_launches.get(fan, 0) + 1
    return out


def binary_row_digests_cuda(comps: torch.Tensor) -> torch.Tensor:
    """CUDA kernel (csrc/sha256.cu), same contract as
    ``binary_row_digests_plain``.

    Replaces the Pallas kernel ``ministark_tpu/ops/sha256_pallas.py::
    _make_kernel`` as reached through ``row_digests_tr``: one thread per row
    reads its C components, byte-swaps each u32 half into a big-endian word
    and compresses block by block, then the constant tail. Bound on this
    card: integer ALU throughput ((8C + 9 + 63) // 64 compressions per
    8C bytes read)."""
    global row_launches
    cuda.require(comps, "sha256_rows", torch.int64, 2)
    _check_rows(comps)
    n, C = comps.shape
    out = torch.empty((n, 8), dtype=torch.int32, device=comps.device)
    if n:
        err = cuda.library().ms_sha256_rows(
            comps.data_ptr(), out.data_ptr(), n, C, cuda.stream_ptr(comps))
        cuda.check("sha256_rows", err)
        row_launches += 1
    return out


def inner_level(digests: torch.Tensor, fan: int = 2) -> torch.Tensor:
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if digests.device.type == "cpu":
        return inner_level_plain(digests, fan)
    return inner_level_cuda(digests, fan)


def binary_row_digests(comps: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if comps.device.type == "cpu":
        return binary_row_digests_plain(comps)
    return binary_row_digests_cuda(comps)


def merkle_inner_levels(leaf_digests: torch.Tensor) -> torch.Tensor:
    """All fan-2 levels above the leaves, level by level, root last:
    (2^k, 8) -> (2^k - 1, 8). One inner-level call per level."""
    levels = []
    cur = leaf_digests
    while cur.shape[0] > 1:
        cur = inner_level(cur)
        levels.append(cur)
    if not levels:
        return leaf_digests[:0]
    return torch.cat(levels, 0)


def digests_to_bytes(digests) -> np.ndarray:
    """(n, 8) int32 big-endian words (tensor or array) -> (n, 32) uint8."""
    if isinstance(digests, torch.Tensor):
        digests = digests.detach().cpu().numpy()
    d = np.ascontiguousarray(digests).view(np.uint32)
    return d.astype(">u4").view(np.uint8).reshape(d.shape[0], 32)


def bytes_to_digests(b) -> torch.Tensor:
    """(n, 32) uint8 -> (n, 8) int32 big-endian words (``bytes_to_digests``
    :224)."""
    words = np.ascontiguousarray(b, dtype=np.uint8).reshape(-1, 32).view(">u4")
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))
