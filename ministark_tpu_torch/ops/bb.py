"""BabyBear (p = 15 * 2^27 + 1 = 2013265921) and its quartic tower on tensors.

Port of ``ministark_tpu/ops/bb.py``. A base element is an ``int32`` tensor
holding the canonical value (below p < 2^31, so never negative), as the JAX
package holds it in one ``uint32`` lane; an Fp4 element adds a trailing axis
of 4 in tower order (c00, c01, c10, c11): Fp4 = Fp2[v] / (v^2 - (2013265910 +
u)) over Fp2 = Fp[u] / (u^2 - 11) (reference src/field.rs:64-109). The CUDA
kernels read the same storage as ``uint32_t`` (csrc/bb.cuh's ``bb::word``).

torch's int32 arithmetic wraps silently, and a Python int beside an int32
tensor keeps int32, so the plain versions never form a value outside
(-p, p): ``add`` is a - (p - b), ``sub`` a - b and ``neg`` -a, each brought
into [0, p) by adding p where the sign bit is set (``_canon``); ``mul``
widens to int64 for the product (below 2^62) and its remainder, then
narrows. An int64 operand beside an int32 one promotes the result to int64
without a word: the kernels refuse it (``field._operands``), the tests
assert the dtype on the CPU.

The JAX package computes BabyBear arithmetic in XLA, outside any Pallas
kernel, which fuses each op into one kernel. Here every op dispatches by the
tensors' device, as ops/field.py's do (``field.dispatch``): CPU tensors take
its plain version, torch ops that launch no kernel; a CUDA operand launches
one kernel or raises: ``add``, ``sub``, ``neg``, ``mul`` and the Fp4
``fp4_add``, ``fp4_sub``, ``fp4_neg`` and ``fp4_scale_base`` are
csrc/field_ew.cu's ``ms_bb_ew`` (bb.cuh's 32-bit add and sub, its Barrett
product), ``fp4_mul`` its ``ms_bb_fp4_mul``. The kernels take canonical
int32 operands. The outputs are the exact field values the JAX package
computes, whatever the formula.
"""

from __future__ import annotations

import torch

from . import field

P = 2013265921
DTYPE = torch.int32         # the storage of a component (field.FieldOps.dtype)
NR_FP2 = 11                 # Fp2 = Fp[u] / (u^2 - 11)
NR_FP4_C0 = 2013265910      # Fp4 nonresidue = Fp2(2013265910, 1)

# Incremented once per launch of each kernel (csrc/field_ew.cu).
launches = {"bb_ew": 0, "bb_fp4_mul": 0}
# Incremented once per call of an op that takes a kernel with an output to
# compute (``field.dispatch``).
calls = dict.fromkeys(launches, 0)


# --------------------------------------------------------------- base field
def _canon(d):
    """d in (-p, p) -> d mod p: p added where the sign bit is set."""
    return d + ((d >> 31) & P)


def _wide(x):
    return x.to(torch.int64) if isinstance(x, torch.Tensor) else x


def add_plain(a, b):
    """(a + b) mod p without leaving (-p, p): a - (p - b)."""
    return _canon(a - (P - b))


def sub_plain(a, b):
    return _canon(a - b)


def neg_plain(a):
    return _canon(-a)


def mul_plain(a, b):
    """(a * b) mod p for canonical operands: the product (below 2^62) and
    its remainder in int64, narrowed to int32."""
    return ((_wide(a) * _wide(b)) % P).to(DTYPE)


def add_cuda(a, b, scalar_dim=0):
    """CUDA kernel (csrc/field_ew.cu ``ms_bb_ew``, ADD), same contract as
    ``add_plain`` on canonical operands: broadcast, strided operands read in
    place (``field.ew_cuda``), one launch, a contiguous output. Replaces
    ``ministark_tpu/ops/bb.py::add`` (:40), which XLA fused on the TPU.
    Bound on this card: device-memory bandwidth (12 bytes an element
    against ~3 integer operations)."""
    return field.ew_cuda("bb_ew", field.ADD, a, b, launches, scalar_dim, DTYPE)


def sub_cuda(a, b, scalar_dim=0):
    """``add_cuda`` with SUB (``ministark_tpu/ops/bb.py::sub`` :45)."""
    return field.ew_cuda("bb_ew", field.SUB, a, b, launches, scalar_dim, DTYPE)


def neg_cuda(a):
    """``add_cuda`` with NEG, 0 - a, no second operand read
    (``ministark_tpu/ops/bb.py::neg`` :49)."""
    return field.ew_cuda("bb_ew", field.NEG, a, None, launches, 0, DTYPE)


def mul_cuda(a, b, scalar_dim=0):
    """``add_cuda`` with MUL, bb.cuh's Barrett product, no 64-bit division
    (``ministark_tpu/ops/bb.py::mul`` :53; was a product and an int64 ``%``,
    a division the card emulates). Bound: bytes (12 an element against ~18
    integer operations)."""
    return field.ew_cuda("bb_ew", field.MUL, a, b, launches, scalar_dim, DTYPE)


def add(a, b):
    """(a + b) mod p. Dispatch by device: CPU tensors -> ``add_plain``; a
    CUDA tensor (with a CUDA tensor or a 0-d scalar) -> ``add_cuda``, the
    kernel, or raise."""
    return field.dispatch(add_plain, add_cuda, calls, "bb_ew", a, b)


def sub(a, b):
    return field.dispatch(sub_plain, sub_cuda, calls, "bb_ew", a, b)


def neg(a):
    return field.dispatch(neg_plain, neg_cuda, calls, "bb_ew", a)


def mul(a, b):
    return field.dispatch(mul_plain, mul_cuda, calls, "bb_ew", a, b)


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
    """(..., 2) tensors: Karatsuba with NR = 11 (``bb.py::fp2_mul``), in
    torch ops (a part of ``fp4_mul_plain``)."""
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    v0 = mul_plain(a0, b0)
    v1 = mul_plain(a1, b1)
    c0 = add_plain(v0, mul_plain(v1, NR_FP2))
    c1 = sub_plain(mul_plain(add_plain(a0, a1), add_plain(b0, b1)), add_plain(v0, v1))
    return torch.stack([c0, c1], -1)


def _fp2_mul_nr4(a):
    """Fp2 element times the Fp4 nonresidue (2013265910 + u):
    (a0 + a1 u)(k + u) = (a0 k + 11 a1) + (a1 k + a0) u."""
    a0, a1 = a[..., 0], a[..., 1]
    c0 = add_plain(mul_plain(a0, NR_FP4_C0), mul_plain(a1, NR_FP2))
    c1 = add_plain(mul_plain(a1, NR_FP4_C0), a0)
    return torch.stack([c0, c1], -1)


fp4_add_plain = add_plain
fp4_sub_plain = sub_plain
fp4_neg_plain = neg_plain


def fp4_mul_plain(a, b):
    """(..., 4) tensors in tower order, Karatsuba over Fp2
    (``bb.py::fp4_mul``), in torch ops; the operands broadcast. The plain
    version of ``fp4_mul_cuda``."""
    a0, a1 = a[..., :2], a[..., 2:]
    b0, b1 = b[..., :2], b[..., 2:]
    v0 = fp2_mul(a0, b0)
    v1 = fp2_mul(a1, b1)
    c0 = add_plain(v0, _fp2_mul_nr4(v1))
    c1 = sub_plain(fp2_mul(add_plain(a0, a1), add_plain(b0, b1)), add_plain(v0, v1))
    return torch.cat([c0, c1], -1)


def fp4_scale_base_plain(a, s):
    """Fp4 element times a base scalar (s broadcasts over a[..., 0])."""
    return mul_plain(a, s.unsqueeze(-1))


def fp4_add_cuda(a, b):
    """Fp4 addition is componentwise: ``add_cuda`` over the whole (..., 4)
    tensors; a CPU (4,) scalar joins a CUDA operand."""
    return add_cuda(a, b, scalar_dim=1)


def fp4_sub_cuda(a, b):
    return sub_cuda(a, b, scalar_dim=1)


def fp4_scale_base_cuda(a, s):
    """One ``mul_cuda`` launch on (a, s broadcast over the component axis)."""
    return mul_cuda(a, s.unsqueeze(-1), scalar_dim=1)


def fp4_mul_cuda(a, b):
    """CUDA kernel (csrc/field_ew.cu ``ms_bb_fp4_mul``), same contract as
    ``fp4_mul_plain``: (..., 4) operands that broadcast over their leading
    axes, read in place through their strides (0 on a broadcast axis) and
    their component strides (``field.ext_cuda`` with k = 4); a CPU (4,)
    scalar joins a CUDA operand. One launch (was about 80 torch ops); the
    output is a contiguous (..., 4) tensor.

    Replaces ``ministark_tpu/ops/bb.py::fp4_mul`` (:127), which XLA fused on
    the TPU; the twin of ``field.ext_mul_cuda``. Bound on this card:
    device-memory bandwidth (32 bytes read and 16 written per product
    against ~333 integer operations); operands with adjacent components and
    16-byte aligned elements take one 16-byte load per element."""
    return field.ext_cuda("bb_fp4_mul", 4, a, b, launches, DTYPE)


def fp4_add(a, b):
    """Sum in Fp4, dispatched as ``add``."""
    return field.dispatch(fp4_add_plain, fp4_add_cuda, calls, "bb_ew", a, b)


def fp4_sub(a, b):
    return field.dispatch(fp4_sub_plain, fp4_sub_cuda, calls, "bb_ew", a, b)


def fp4_neg(a):
    return field.dispatch(fp4_neg_plain, neg_cuda, calls, "bb_ew", a)


def fp4_mul(a, b):
    """Product in Fp4. Dispatch by device: CPU tensors -> ``fp4_mul_plain``;
    a CUDA tensor (with a CUDA tensor or a CPU scalar) -> ``fp4_mul_cuda``,
    the kernel, or raise."""
    return field.dispatch(fp4_mul_plain, fp4_mul_cuda, calls, "bb_fp4_mul", a, b)


def fp4_scale_base(a, s):
    """Fp4 element times a base scalar, dispatched as ``mul``."""
    return field.dispatch(fp4_scale_base_plain, fp4_scale_base_cuda, calls, "bb_ew",
                          a, s)


def _fp4_one(a):
    one = torch.zeros_like(a)
    one[..., 0] = 1
    return one


def fp4_pow(a, e: int):
    return _pow(fp4_mul, _fp4_one, a, e)
