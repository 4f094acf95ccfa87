"""The yardstick of the kernels' roofline share: the H100's published peaks
and the work formulas, frozen here from the port's utils/roofline.py as it
stood when the benchmark was defined, so that no change to the program
moves them.

The least time of a piece of work is the larger of its bytes over the
device-memory rate and its 32-bit integer operations over the INT32 rate
(``least_s``). Operation counts are the arithmetic the algorithm needs
(a field product, a butterfly, a SHA-256 block), not what a kernel
happens to execute.
"""

from __future__ import annotations

# H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# one SHA-256 block: 64 rounds of 14 (3-input LOP3 and IADD3 fused) plus 48
# schedule steps of 10, plus the 8 feed-forward adds; a block of constant
# words (the padding block of a 64-byte message) needs no schedule
OPS_SHA_BLOCK = 64 * 14 + 48 * 10 + 8
OPS_SHA_CONST_BLOCK = 64 * 14 + 8
# Goldilocks: a product is four 32x32->64 multiplies (two instructions
# each) with 4 adds, and the reduction about 17; an add 8, a sub 5
OPS_GL_MUL = 8 + 4 + 17
OPS_GL_BUTTERFLY = OPS_GL_MUL + 8 + 5
# BabyBear: a product is one 32x32->64 multiply (2), a Barrett step's
# multiply-high (12), a multiply-subtract (2) and a conditional
# subtraction (2); an add or a sub 3
OPS_BB_MUL = 2 + 12 + 2 + 2
OPS_BB_BUTTERFLY = OPS_BB_MUL + 3 + 3
# (product, butterfly) operations and the bytes a stored component takes
FIELD_OPS = {"gl": (OPS_GL_MUL, OPS_GL_BUTTERFLY), "bb": (OPS_BB_MUL, OPS_BB_BUTTERFLY)}
WIDTH = {"gl": 8, "bb": 4}


def least_s(nbytes: float, ops: float) -> float:
    """The least seconds the card needs for this work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def sha_blocks(msg_bytes: int) -> int:
    """SHA-256 blocks of a message of this many bytes."""
    return (msg_bytes + 9 + 63) // 64


def stage_muls(n: int, stages: int) -> int:
    """Products by a root other than 1 in ``stages`` radix-2 stages over
    each 2^stages-point block of n values: stage u has n / 2 butterflies,
    n / 2^u of them by w^0 = 1."""
    return (n // 2) * stages - n + (n >> stages)


def ntt_work(batch: int, n: int, scale_mul: bool, tag: str):
    """(bytes, ops) of ``batch`` transforms of n points: log2(n) stages,
    with a scale product a value if asked (the inverse's 1/n); values in
    and out and the n / 2 roots read once."""
    mul, butterfly = FIELD_OPS[tag]
    log_n = n.bit_length() - 1
    ops = batch * ((n // 2) * log_n * (butterfly - mul) + stage_muls(n, log_n) * mul
                   + n * int(scale_mul) * mul)
    return WIDTH[tag] * (2 * batch * n + n // 2), ops


def tree_work(n_rows: int, row_bytes: int, arity: int):
    """(bytes, ops) of an index tree over n_rows rows of row_bytes hashed
    bytes each: every row hashed, every parent hashed over its children's
    digests, each digest written once (the rows are counted where they
    were made)."""
    ops = n_rows * sha_blocks(row_bytes) * OPS_SHA_BLOCK
    nodes, size = n_rows, n_rows
    while size > 1:
        f = min(arity, size)
        size //= f
        nodes += size
        ops += size * ((f // 2) * OPS_SHA_BLOCK + OPS_SHA_CONST_BLOCK)
    return 32 * nodes, ops
