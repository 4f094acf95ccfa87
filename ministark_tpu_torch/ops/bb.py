"""BabyBear (p = 15 * 2^27 + 1 = 2013265921) and its quartic tower on tensors.

Port of ``ministark_tpu/ops/bb.py``. A base element is an ``int64`` tensor
holding the canonical value (below 2^31); an Fp4 element adds a trailing axis
of 4 in tower order (c00, c01, c10, c11): Fp4 = Fp2[v] / (v^2 - (2013265910 +
u)) over Fp2 = Fp[u] / (u^2 - 11) (reference src/field.rs:64-109). The CUDA
kernels read the same storage as ``uint64_t`` (csrc/bb.cuh).

The JAX package computes BabyBear arithmetic in XLA, outside any Pallas
kernel, so these are plain torch ops on every device: a product of two
values below 2^31 fits int64, so ``mul`` is a product and a remainder, and
``add``/``sub`` a sum and a remainder (torch's ``%`` takes the sign of the
divisor, so the result is canonical). The outputs are the exact field values
the JAX package computes, whatever the formula.
"""

from __future__ import annotations

import torch

P = 2013265921
NR_FP2 = 11                 # Fp2 = Fp[u] / (u^2 - 11)
NR_FP4_C0 = 2013265910      # Fp4 nonresidue = Fp2(2013265910, 1)


# --------------------------------------------------------------- base field
def add(a, b):
    return (a + b) % P


def sub(a, b):
    return (a - b) % P


def neg(a):
    return (-a) % P


def mul(a, b):
    """(a * b) mod p for canonical operands (the product is below 2^62)."""
    return (a * b) % P


def _pow(mul_fn, one, a, e: int):
    """a ** e for a static exponent by square and multiply."""
    result = None
    acc = a
    while e:
        if e & 1:
            result = acc if result is None else mul_fn(result, acc)
        e >>= 1
        if e:
            acc = mul_fn(acc, acc)
    return one(a) if result is None else result


def pow(a, e: int):
    return _pow(mul, torch.ones_like, a, e)


# --------------------------------------------------------------- Fp2, Fp4
def fp2_mul(a, b):
    """(..., 2) tensors: Karatsuba with NR = 11 (``bb.py::fp2_mul``)."""
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    v0 = mul(a0, b0)
    v1 = mul(a1, b1)
    c0 = add(v0, mul(v1, NR_FP2))
    c1 = sub(mul(add(a0, a1), add(b0, b1)), add(v0, v1))
    return torch.stack([c0, c1], -1)


def _fp2_mul_nr4(a):
    """Fp2 element times the Fp4 nonresidue (2013265910 + u):
    (a0 + a1 u)(k + u) = (a0 k + 11 a1) + (a1 k + a0) u."""
    a0, a1 = a[..., 0], a[..., 1]
    c0 = add(mul(a0, NR_FP4_C0), mul(a1, NR_FP2))
    c1 = add(mul(a1, NR_FP4_C0), a0)
    return torch.stack([c0, c1], -1)


fp4_add = add
fp4_sub = sub
fp4_neg = neg


def fp4_mul(a, b):
    """(..., 4) tensors in tower order, Karatsuba over Fp2
    (``bb.py::fp4_mul``); the operands broadcast."""
    a0, a1 = a[..., :2], a[..., 2:]
    b0, b1 = b[..., :2], b[..., 2:]
    v0 = fp2_mul(a0, b0)
    v1 = fp2_mul(a1, b1)
    c0 = add(v0, _fp2_mul_nr4(v1))
    c1 = sub(fp2_mul(add(a0, a1), add(b0, b1)), add(v0, v1))
    return torch.cat([c0, c1], -1)


def fp4_scale_base(a, s):
    """Fp4 element times a base scalar (s broadcasts over a[..., 0])."""
    return mul(a, s.unsqueeze(-1))


def _fp4_one(a):
    one = torch.zeros_like(a)
    one[..., 0] = 1
    return one


def fp4_pow(a, e: int):
    return _pow(fp4_mul, _fp4_one, a, e)
