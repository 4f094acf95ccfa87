"""Goldilocks (p = 2^64 - 2^32 + 1) and its quadratic extension on tensors,
and the field registry ``get_ops`` (Goldilocks, Fp2, BabyBear and its Fp4,
the last two from ops/bb.py).

Port of ``ministark_tpu/ops/{u32,gl,registry}.py``. The TPU's u32 limb-pair
layout stays behind: a base element is an ``int64`` tensor holding the
canonical u64 bit pattern (values >= 2^63 read as negative), and an Fp2
element adds a trailing axis of 2 (c0, c1), with u^2 = 7. CUDA kernels
reinterpret the same storage as ``uint64_t``. BabyBear is held in ``int32``
(ops/bb.py), as the JAX package holds it in one u32 lane: ``FieldOps.dtype``
says which, and ``pack_words`` / ``unpack_u64`` carry host values either
way.

Every op dispatches by the tensors' device: CPU tensors take its plain
version (``add_plain``, ``mul_plain``, ``ext_mul_plain``, ...), torch ops
that launch no kernel; a CUDA operand launches one kernel or raises, with
no fallback: ``add``, ``sub`` and ``neg`` csrc/field_ew.cu's ``ms_gl_ew``
(the Fp2 forms over the whole (..., 2) tensors), ``mul`` and
``ext_scale_base`` csrc/gl_mul.cu's base product, ``ext_mul`` its Fp2
product. So every caller (``pow``, ``ext_pow``, ops/poly.py, the engines,
the FRI code) gets one launch per field op on the card, as XLA fused each
op into one kernel on the TPU. The plan that addresses broadcast, strided
operands in place (``_plan``) is shared by those kernels and ops/bb.py's.

torch has no unsigned 64-bit arithmetic and a
64x64 -> 128 product fits no dtype, so the plain ops split their operands
into 32-bit halves (and the multiply into 16-bit limbs) so that no
intermediate leaves [-2^63, 2^63): the results do not depend on wrapping
behaviour. The 128-bit product is reduced with 2^64 == 2^32 - 1 and
2^96 == -1 (mod p), as ``ops/gl.py::_reduce128``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from . import bb, cuda

P = 18446744069414584321
M32 = 0xFFFFFFFF
M16 = 0xFFFF
EPS = M32  # 2^64 mod p


# --------------------------------------------------------------- halves
def _split(a):
    """int64 u64 pattern -> (lo, hi) 32-bit halves, each in [0, 2^32)."""
    return a & M32, (a >> 32) & M32


def _join(lo, hi):
    """(lo, hi) halves -> int64 u64 pattern, without overflowing int64."""
    return (hi - ((hi >> 31) << 32)) * (1 << 32) + lo


def _cond_sub_p(lo, hi):
    """x - p where x >= p, for x < 2^64. p = (hi 0xFFFFFFFF, lo 1)."""
    ge = (hi == M32) & (lo >= 1)
    return torch.where(ge, lo - 1, lo), torch.where(ge, torch.zeros_like(hi), hi)


def _fold_carry(lo, hi):
    """(lo, hi) with hi in [0, 2^33): fold a carry out of 2^64 back in as
    EPS. Callers guarantee it cannot carry twice."""
    carry = hi >> 32
    hi = hi & M32
    lo = lo + carry * EPS
    return lo & M32, hi + (lo >> 32)


def _add_h(alo, ahi, blo, bhi):
    lo = alo + blo
    hi = ahi + bhi + (lo >> 32)
    # a + b < 2p: after folding a carry the value stays below 2^64
    lo, hi = _fold_carry(lo & M32, hi)
    return _cond_sub_p(lo, hi)


def _sub_h(alo, ahi, blo, bhi):
    lo = alo - blo
    hi = ahi - bhi + (lo >> 32)          # arithmetic shift: -1 on borrow
    lo = lo & M32
    borrow = (hi >> 32) & 1
    hi = hi & M32
    # wrapped by 2^64: subtract EPS (== add p); a - b + 2^64 >= 2^32 > EPS
    lo = lo - borrow * EPS
    return lo & M32, hi + (lo >> 32)


def _reduce128(x0, x1, x2, x3):
    """(x0 + x1 2^32 + x2 2^64 + x3 2^96) mod p, words in [0, 2^32).
    n == lo64 - x3 + x2 * (2^32 - 1)  (mod p)."""
    lo = x0 - x3
    hi = x1 + (lo >> 32)
    lo = lo & M32
    borrow = (hi >> 32) & 1
    hi = hi & M32
    lo = lo - borrow * EPS               # cannot underflow twice
    hi = hi + (lo >> 32)
    lo = lo & M32
    # + x2 * (2^32 - 1) = (x2 - 1) * 2^32 + (2^32 - x2), or 0 for x2 = 0
    m_lo = (-x2) & M32
    m_hi = (x2 - 1).clamp_min(0)
    lo = lo + m_lo
    hi = hi + m_hi + (lo >> 32)
    lo, hi = _fold_carry(lo & M32, hi)   # cannot overflow twice
    return _cond_sub_p(lo, hi)


def _mul_h(alo, ahi, blo, bhi):
    """Product of halves via 16-bit limbs: partial products < 2^32, column
    sums < 2^34, so every intermediate fits int64."""
    a = (alo & M16, alo >> 16, ahi & M16, ahi >> 16)
    b = (blo & M16, blo >> 16, bhi & M16, bhi >> 16)
    limbs = []
    t = None
    for k in range(7):
        col = None
        for i in range(max(0, k - 3), min(k, 3) + 1):
            pp = a[i] * b[k - i]
            col = pp if col is None else col + pp
        t = col if t is None else (t >> 16) + col
        limbs.append(t & M16)
    limbs.append(t >> 16)
    x = [limbs[2 * i] | (limbs[2 * i + 1] << 16) for i in range(4)]
    return _reduce128(*x)


# --------------------------------------------------------------- base field
def add_plain(a, b):
    """(a + b) mod p in torch ops: the plain version of ``add_cuda``."""
    return _join(*_add_h(*_split(a), *_split(b)))


def sub_plain(a, b):
    """(a - b) mod p in torch ops: the plain version of ``sub_cuda``."""
    return _join(*_sub_h(*_split(a), *_split(b)))


def neg_plain(a):
    """-a mod p in torch ops: the plain version of ``neg_cuda``."""
    return sub_plain(torch.zeros_like(a), a)


def mul_plain(a, b):
    """(a * b) mod p in torch ops: the plain version of ``mul_cuda``."""
    return _join(*_mul_h(*_split(a), *_split(b)))


# Incremented once per launch of each kernel: csrc/gl_mul.cu's base and Fp2
# products, csrc/field_ew.cu's add / sub / neg.
launches = {"gl_mul": 0, "gl_ext_mul": 0, "gl_ew": 0}
# Incremented once per call of an op (``add``, ``ext_add``, ``mul``, ...)
# that takes a kernel with an output to compute (``dispatch``): a run whose
# launches equal its calls launched once an op.
calls = dict.fromkeys(launches, 0)
# csrc/field_ew.cu's op codes
ADD, SUB, NEG, MUL = 0, 1, 2, 3

MUL_MAX_DIMS = 4   # csrc/elementwise.cuh addresses operands with up to 4 strides
# csrc/elementwise.cuh's plan: numel, ndim, vec, wide, ca, cb, then size,
# a's and b's strides, magic and shift, MUL_MAX_DIMS each
PLAN_LEN = 6 + 5 * MUL_MAX_DIMS
_PlanArray = ctypes.c_int64 * PLAN_LEN
_I31 = 1 << 31


def _collapse(shape, *strides):
    """Drop size-1 axes and merge neighbouring axes that every operand walks
    contiguously: (sizes, [strides per operand]) with the fewest axes, in
    element units, addressing the same elements of a row-major output."""
    sizes, out = [], [[] for _ in strides]
    for d, size in enumerate(shape):
        if size == 1:
            continue
        if sizes and all(st[-1] == s[d] * size for st, s in zip(out, strides)):
            sizes[-1] *= size
            for st, s in zip(out, strides):
                st[-1] = s[d]
            continue
        sizes.append(size)
        for st, s in zip(out, strides):
            st.append(s[d])
    return sizes, out


def _broadcast_strides(shape, t_shape, t_stride):
    """Element strides of a tensor of ``t_shape`` / ``t_stride`` expanded to
    ``shape``: 0 on the axes it is broadcast along."""
    lead = len(shape) - len(t_shape)
    return [0 if d < lead or t_shape[d - lead] != size else t_stride[d - lead]
            for d, size in enumerate(shape)]


def _magic(d: int):
    """(magic, shift) of the round-up multiply-high division by 0 < d < 2^31
    that csrc/elementwise.cuh runs on 32-bit indices: for every i < 2^31,
    i // d == ((i * magic >> 32) + i) >> shift."""
    shift = (d - 1).bit_length()                  # the least s with 2^s >= d
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def _plan(shape, sa, sb, vec: bool, ca: int = 0, cb: int = 0, k: int = 1):
    """The int64 plan of one elementwise launch (csrc/elementwise.cuh) over
    the row-major ``shape`` with operand element strides ``sa`` / ``sb``
    (and, for an extension product of ``k`` components, component strides
    ``ca`` / ``cb``): the merged axes, their magic numbers, and whether the
    call needs 64-bit indices. ``vec`` asks for the 16-byte path; it is kept
    only where the kernel can take it."""
    numel = 1
    for size in shape:
        numel *= size
    sizes, (sa, sb) = _collapse(shape, sa, sb)
    if len(sizes) > MUL_MAX_DIMS:
        raise ValueError(f"elementwise kernel: operands of shape {tuple(shape)} "
                         f"need {len(sizes)} strided axes, the kernels take "
                         f"{MUL_MAX_DIMS}")
    if not sizes:                                  # one element
        sizes, sa, sb = [1], [0], [0]
    reach = max(sum((n - 1) * s for n, s in zip(sizes, st)) + (k - 1) * c
                for st, c in ((sa, ca), (sb, cb)))
    wide = numel >= _I31 or reach >= _I31
    magics = [_magic(n) if n < _I31 else (0, 0) for n in sizes]
    pad = [0] * (MUL_MAX_DIMS - len(sizes))
    return _PlanArray(numel, len(sizes), int(vec and not wide), int(wide), ca, cb,
                      *sizes, *[1] * len(pad), *sa, *pad, *sb, *pad,
                      *[m for m, _ in magics], *pad, *[s for _, s in magics], *pad)


@functools.lru_cache(maxsize=4096)
def _mul_plan(a_shape, a_stride, b_shape, b_stride, aligned: bool):
    """(output shape, plan or None when the output is empty) of a launch in
    the base layout (a product, an add, a sub, or a neg with a in b's
    place); the 16-byte path when both operands are contiguous over the
    whole output and 16-byte aligned."""
    shape = torch.broadcast_shapes(a_shape, b_shape)
    if shape.numel() == 0:
        return shape, None
    sa = _broadcast_strides(shape, a_shape, a_stride)
    sb = _broadcast_strides(shape, b_shape, b_stride)
    sizes, (ma, mb) = _collapse(shape, sa, sb)
    contiguous = len(sizes) == 1 and ma == [1] and mb == [1]
    return shape, _plan(shape, sa, sb, aligned and contiguous)


@functools.lru_cache(maxsize=4096)
def _ext_plan(a_shape, a_stride, b_shape, b_stride, aligned: bool, k: int = 2,
              kernel: str = "gl_ext_mul", width: int = 8):
    """(output shape, plan or None) of an extension product of ``k``
    components of ``width`` bytes (Fp2, 8; ops/bb.py's Fp4, k = 4 and 4)
    over the leading axes; 16-byte loads when both operands' components are
    adjacent and every element starts on a 16-byte boundary (strides of a
    multiple of 16 bytes, aligned base)."""
    for t_shape, name in ((a_shape, "a"), (b_shape, "b")):
        if len(t_shape) < 1 or t_shape[-1] != k:
            raise ValueError(f"{kernel}: {name} must have a trailing axis of "
                             f"{k} components, got shape {tuple(t_shape)}")
    lead = torch.broadcast_shapes(a_shape[:-1], b_shape[:-1])
    shape = lead + (k,)
    if lead.numel() == 0:
        return shape, None
    sa = _broadcast_strides(lead, a_shape[:-1], a_stride[:-1])
    sb = _broadcast_strides(lead, b_shape[:-1], b_stride[:-1])
    ca, cb = a_stride[-1], b_stride[-1]
    vec = (aligned and ca == 1 and cb == 1
           and all(s * width % 16 == 0 for s in sa + sb))
    return shape, _plan(lead, sa, sb, vec, ca, cb, k)


def _on_device(t: torch.Tensor, name: str, device, kernel="gl_mul",
               scalar_dim=0) -> torch.Tensor:
    """t on ``device``: a CPU scalar (0-d, or with ``scalar_dim`` 1 one
    extension element of at most 4 components) is moved there, as torch's
    own binary ops move a 0-d one; any other tensor elsewhere is refused."""
    if t.device != device:
        if t.device.type == "cpu" and t.dim() <= scalar_dim and t.numel() <= 4:
            return t.to(device)
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    return t


def _operands(a, b, kernel, scalar_dim=0, dtype=torch.int64):
    """(a, b) on one CUDA device, both of the field's ``dtype`` (int64
    Goldilocks, int32 BabyBear), or raise: no cast."""
    if (a.is_cuda and b.is_cuda and a.get_device() == b.get_device()
            and a.dtype == b.dtype == dtype):
        return a, b                        # every prover call: no more checks
    device = a.device if a.device.type == "cuda" else b.device
    if device.type != "cuda":
        raise ValueError(f"{kernel}: expected a CUDA tensor, got {a.device}")
    a = _on_device(a, "a", device, kernel, scalar_dim)
    b = _on_device(b, "b", device, kernel, scalar_dim)
    for t, name in ((a, "a"), (b, "b")):
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    return a, b


def dispatch(plain, kernel, counts, name, *ts):
    """One field op by the tensors' device: ``plain(*ts)`` when every tensor
    is on the CPU, else ``kernel(*ts)``, which launches kernel ``name`` once
    or raises; the call counts in ``counts[name]`` unless its output is
    empty (an operand with no element: nothing to launch)."""
    if all(t.device.type == "cpu" for t in ts):
        return plain(*ts)
    if all(t.numel() for t in ts):
        counts[name] += 1
    return kernel(*ts)


def ew_cuda(name, op, a, b, counts, scalar_dim=0, dtype=torch.int64):
    """One launch of the elementwise kernel ``ms_<name>`` over the broadcast
    operands, read in place through their element strides (0 on a broadcast
    axis), with op code ``op`` (csrc/field_ew.cu's ``gl_ew`` / ``bb_ew``;
    None for gl_mul.cu's ``gl_mul``, which takes none); for NEG ``b`` is
    None and a takes its place in the plan, unread. A CPU scalar
    (``_on_device``, ``scalar_dim``) joins a CUDA operand; the output is
    contiguous, of the field's ``dtype`` (operands of another raise).
    Counted in ``counts[name]``."""
    a, b = _operands(a, a if b is None else b, name, scalar_dim, dtype)
    pa, pb = a.data_ptr(), b.data_ptr()
    shape, plan = _mul_plan(a.shape, a.stride(), b.shape, b.stride(),
                            not (pa | pb) & 15)
    out = torch.empty(shape, dtype=dtype, device=a.device)
    if plan is None:
        return out
    args = () if op is None else (op,)
    err = getattr(cuda.library(), "ms_" + name)(pa, pb, out.data_ptr(), plan, *args,
                                                cuda.stream_ptr(out))
    cuda.check(name, err)
    counts[name] += 1
    return out


def ext_cuda(name, k, a, b, counts, dtype=torch.int64):
    """One launch of the extension product ``ms_<name>`` (``gl_ext_mul``,
    k = 2; ops/bb.py's ``bb_fp4_mul``, k = 4) over (..., k) operands that
    broadcast over their leading axes, read in place through their strides
    and component strides (``_ext_plan``); a CPU (k,) scalar joins a CUDA
    operand; the output is a contiguous (..., k) tensor. Counted in
    ``counts[name]``."""
    a, b = _operands(a, b, name, 1, dtype)
    pa, pb = a.data_ptr(), b.data_ptr()
    shape, plan = _ext_plan(a.shape, a.stride(), b.shape, b.stride(),
                            not (pa | pb) & 15, k, name, a.element_size())
    out = torch.empty(shape, dtype=dtype, device=a.device)
    if plan is None:
        return out
    err = getattr(cuda.library(), "ms_" + name)(pa, pb, out.data_ptr(), plan,
                                                cuda.stream_ptr(out))
    cuda.check(name, err)
    counts[name] += 1
    return out


def add_cuda(a, b, scalar_dim=0):
    """CUDA kernel (csrc/field_ew.cu ``ms_gl_ew``, ADD), same contract as
    ``add_plain`` and ``mul_cuda``: broadcast, strided operands read in
    place, one launch, a contiguous output. Replaces ``ministark_tpu/ops/
    gl.py::add`` (:82), which XLA fused on the TPU. Bound on this card:
    device-memory bandwidth (24 bytes an element against ~8 integer
    operations)."""
    return ew_cuda("gl_ew", ADD, a, b, launches, scalar_dim)


def sub_cuda(a, b, scalar_dim=0):
    """``add_cuda`` with SUB (``ministark_tpu/ops/gl.py::sub`` :103)."""
    return ew_cuda("gl_ew", SUB, a, b, launches, scalar_dim)


def neg_cuda(a):
    """``add_cuda`` with NEG, 0 - a, no second operand read
    (``ministark_tpu/ops/gl.py::neg`` :109)."""
    return ew_cuda("gl_ew", NEG, a, None, launches)


def mul_cuda(a, b, scalar_dim=0):
    """CUDA kernel (csrc/gl_mul.cu ``ms_gl_mul``), same contract as
    ``mul_plain``: the operands broadcast, may be strided views (an Fp2
    component ``a[..., 0]`` has stride 2) and are read in place through
    their element strides (0 on a broadcast axis), so no copy costs a
    launch; the output is contiguous.

    Replaces the Pallas kernel ``ministark_tpu/ops/pallas_kernels.py::
    _gl_mul_kernel`` (one (8, 128) tile of u32 limb pairs per grid step).
    Bound on this card: device-memory bandwidth (16 bytes read and 8
    written per product against ~30 integer operations); contiguous aligned
    operands take 16-byte vectors, the others 32-bit multiply-high index
    arithmetic. The plan of a shape is built once (``_mul_plan``)."""
    return ew_cuda("gl_mul", None, a, b, launches, scalar_dim)


def add(a, b):
    """(a + b) mod p. Dispatch by device (``dispatch``): CPU tensors ->
    ``add_plain``; a CUDA tensor (with a CUDA tensor or a 0-d scalar) ->
    ``add_cuda``, the kernel, or raise."""
    return dispatch(add_plain, add_cuda, calls, "gl_ew", a, b)


def sub(a, b):
    """(a - b) mod p, dispatched as ``add``."""
    return dispatch(sub_plain, sub_cuda, calls, "gl_ew", a, b)


def neg(a):
    """-a mod p, dispatched as ``add``."""
    return dispatch(neg_plain, neg_cuda, calls, "gl_ew", a)


def mul(a, b):
    """(a * b) mod p. Dispatch by device: CPU tensors -> ``mul_plain``; a
    CUDA tensor (with a CUDA tensor or a 0-d scalar) -> ``mul_cuda``, the
    kernel, or raise."""
    return dispatch(mul_plain, mul_cuda, calls, "gl_mul", a, b)


def square(a):
    return mul(a, a)


def pow(a, e: int):
    """a ** e for a static integer exponent (square and multiply)."""
    result = None
    acc = a
    while e:
        if e & 1:
            result = acc if result is None else mul(result, acc)
        e >>= 1
        if e:
            acc = square(acc)
    return torch.ones_like(a) if result is None else result


def _mul_nr(a):
    """a * 7 as 8a - a with three doublings (``ops/gl.py::_mul_nr``), in
    torch ops."""
    two = add_plain(a, a)
    four = add_plain(two, two)
    eight = add_plain(four, four)
    return sub_plain(eight, a)


# --------------------------------------------------------------- Fp2
def ext_add_plain(a, b):
    return torch.stack([add_plain(a[..., 0], b[..., 0]),
                        add_plain(a[..., 1], b[..., 1])], -1)


def ext_sub_plain(a, b):
    return torch.stack([sub_plain(a[..., 0], b[..., 0]),
                        sub_plain(a[..., 1], b[..., 1])], -1)


def ext_neg_plain(a):
    return torch.stack([neg_plain(a[..., 0]), neg_plain(a[..., 1])], -1)


def ext_add_cuda(a, b):
    """Fp2 addition is componentwise: ``add_cuda`` over the whole (..., 2)
    tensors, the component axis one more plan axis; a CPU (2,) scalar joins
    a CUDA operand. One launch (was two base adds and a ``stack``)."""
    return add_cuda(a, b, scalar_dim=1)


def ext_sub_cuda(a, b):
    return sub_cuda(a, b, scalar_dim=1)


def ext_add(a, b):
    """Sum in Fp2, dispatched as ``add`` (``ext_add_plain`` on the CPU)."""
    return dispatch(ext_add_plain, ext_add_cuda, calls, "gl_ew", a, b)


def ext_sub(a, b):
    return dispatch(ext_sub_plain, ext_sub_cuda, calls, "gl_ew", a, b)


def ext_neg(a):
    return dispatch(ext_neg_plain, neg_cuda, calls, "gl_ew", a)


def ext_mul_plain(a, b):
    """Karatsuba product in Fp[u]/(u^2 - 7), as ``ops/gl.py::ext_mul``, in
    torch ops with ``mul_plain``: the plain version of ``ext_mul_cuda``."""
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    v0 = mul_plain(a0, b0)
    v1 = mul_plain(a1, b1)
    c0 = add_plain(v0, _mul_nr(v1))
    c1 = sub_plain(mul_plain(add_plain(a0, a1), add_plain(b0, b1)), add_plain(v0, v1))
    return torch.stack([c0, c1], -1)


def ext_mul_cuda(a, b):
    """CUDA kernel (csrc/gl_mul.cu ``ms_gl_ext_mul``), same contract as
    ``ext_mul_plain``: (..., 2) operands that broadcast over their leading
    axes, read in place through their strides (0 on a broadcast axis) and
    their component strides; a CPU (2,) scalar joins a CUDA operand. One
    launch; the output is a contiguous (..., 2) tensor.

    Replaces ``ministark_tpu/ops/gl.py::ext_mul`` (:215), the Fp2 form that
    ``pallas_kernels.py:12-16`` left to XLA on the TPU. Bound on this card:
    device-memory bandwidth (32 bytes read and 16 written per product
    against ~100 integer operations); operands with adjacent components
    take one 16-byte load per element."""
    return ext_cuda("gl_ext_mul", 2, a, b, launches)


def ext_mul(a, b):
    """Product in Fp2. Dispatch by device: CPU tensors -> ``ext_mul_plain``;
    a CUDA tensor (with a CUDA tensor or a CPU scalar) -> ``ext_mul_cuda``,
    the kernel, or raise."""
    return dispatch(ext_mul_plain, ext_mul_cuda, calls, "gl_ext_mul", a, b)


def ext_scale_base_plain(a, s):
    """Fp2 element times a base scalar (s broadcasts over a[..., 0])."""
    return torch.stack([mul_plain(a[..., 0], s), mul_plain(a[..., 1], s)], -1)


def ext_scale_base_cuda(a, s):
    """One ``mul_cuda`` launch on (a, s broadcast over the component axis)."""
    return mul_cuda(a, s.unsqueeze(-1), scalar_dim=1)


def ext_scale_base(a, s):
    """Fp2 element times a base scalar, dispatched as ``mul``."""
    return dispatch(ext_scale_base_plain, ext_scale_base_cuda, calls, "gl_mul", a, s)


def ext_pow(a, e: int):
    result = None
    acc = a
    while e:
        if e & 1:
            result = acc if result is None else ext_mul(result, acc)
        e >>= 1
        if e:
            acc = ext_mul(acc, acc)
    if result is None:
        one = torch.zeros_like(a)
        one[..., 0] = 1
        return one
    return result


# --------------------------------------------------------------- packing
def pack_u64(values, device=None) -> torch.Tensor:
    """Python ints (< 2^64, any nesting) -> int64 tensor of their bit
    patterns. ``torch.tensor`` refuses ints >= 2^63; numpy's uint64 view
    converts them to two's complement exactly."""
    arr = np.array(values, dtype=np.uint64)   # a C-contiguous copy, 0-d kept
    return torch.from_numpy(arr.view(np.int64)).to(device)


def unpack_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array of the same bit patterns; an
    int32 (BabyBear) tensor -> its values, widened to uint64."""
    a = t.detach().cpu().contiguous().numpy()
    if a.dtype == np.int32:
        return a.view(np.uint32).astype(np.uint64)
    return a.view(np.uint64)


def pack_words(values, dtype: torch.dtype, device=None) -> torch.Tensor:
    """Canonical Python ints (any nesting) -> a tensor of the field's
    ``dtype``: int64 bit patterns (``pack_u64``) or int32 values below 2^31
    (BabyBear; numpy's uint32 refuses anything at or above 2^32)."""
    if dtype == torch.int64:
        return pack_u64(values, device)
    arr = np.array(values, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32)).to(device)


@dataclass(frozen=True)
class FieldOps:
    """Tensor ops for one host field (``ops/registry.py::FieldKernels``)."""

    field: object                  # host field (oracle + constants)
    base_field: object             # host base prime field
    elem_axes: Tuple[int, ...]     # trailing element shape: (), (2,) or (4,)
    dtype: torch.dtype             # a component's storage: int64 or int32
    add: Callable
    sub: Callable
    mul: Callable
    neg: Callable
    pow: Callable
    scale_base: Callable           # elementwise multiply by base scalars
    pack: Callable                 # host scalars -> tensor
    unpack: Callable               # tensor -> list of host scalars
    pack_scalar: Callable          # one host scalar -> 0-d / (2,) / (4,) tensor


def _pack_base(dtype):
    def pack(vals, device=None):
        return pack_words([int(v) for v in vals], dtype, device)

    def pack_scalar(v, device=None):
        return pack_words(int(v), dtype, device)

    return pack, pack_scalar


def _unpack_base(t):
    return [int(v) for v in unpack_u64(t).reshape(-1)]


def _gl_base(field):
    pack, pack_scalar = _pack_base(torch.int64)
    return FieldOps(
        field=field, base_field=field, elem_axes=(), dtype=torch.int64,
        add=add, sub=sub, mul=mul, neg=neg, pow=pow,
        scale_base=mul, pack=pack, unpack=_unpack_base,
        pack_scalar=pack_scalar,
    )


def _gl_ext(field, base):
    def pack(vals, device=None):
        return pack_u64([[int(c0), int(c1)] for (c0, c1) in vals], device
                        ).reshape(-1, 2)

    def unpack(t):
        u = unpack_u64(t).reshape(-1, 2)
        return [(int(r[0]), int(r[1])) for r in u]

    return FieldOps(
        field=field, base_field=base, elem_axes=(2,), dtype=torch.int64,
        add=ext_add, sub=ext_sub, mul=ext_mul, neg=ext_neg, pow=ext_pow,
        scale_base=ext_scale_base, pack=pack, unpack=unpack,
        pack_scalar=lambda v, device=None: pack_u64([int(v[0]), int(v[1])],
                                                    device),
    )


def _bb_base(field):
    pack, pack_scalar = _pack_base(bb.DTYPE)
    return FieldOps(
        field=field, base_field=field, elem_axes=(), dtype=bb.DTYPE,
        add=bb.add, sub=bb.sub, mul=bb.mul, neg=bb.neg, pow=bb.pow,
        scale_base=bb.mul, pack=pack, unpack=_unpack_base,
        pack_scalar=pack_scalar,
    )


def _bb_fp4(field, base):
    """BabyBear Fp4 (``ops/registry.py::_bb_fp4``): host scalars are nested
    ((c00, c01), (c10, c11)) tuples, tensors (..., 4) in that order."""
    def flat(v):
        return [int(v[0][0]), int(v[0][1]), int(v[1][0]), int(v[1][1])]

    def pack(vals, device=None):
        return pack_words([flat(v) for v in vals], bb.DTYPE, device).reshape(-1, 4)

    def unpack(t):
        u = unpack_u64(t).reshape(-1, 4)
        return [((int(r[0]), int(r[1])), (int(r[2]), int(r[3]))) for r in u]

    return FieldOps(
        field=field, base_field=base, elem_axes=(4,), dtype=bb.DTYPE,
        add=bb.fp4_add, sub=bb.fp4_sub, mul=bb.fp4_mul, neg=bb.fp4_neg,
        pow=bb.fp4_pow, scale_base=bb.fp4_scale_base,
        pack=pack, unpack=unpack,
        pack_scalar=lambda v, device=None: pack_words(flat(v), bb.DTYPE, device),
    )


_OPS = {}


def get_ops(field) -> FieldOps:
    """Tensor ops for a host field from fields/host.py: Goldilocks, its
    quadratic extension, BabyBear or its quartic extension
    (``ops/registry.py::get_kernels`` :128-150)."""
    from ..fields import BABYBEAR_FP, BABYBEAR_FP4, GOLDILOCKS_FP, GOLDILOCKS_FP2

    key = id(field)
    if key not in _OPS:
        if field is GOLDILOCKS_FP:
            _OPS[key] = _gl_base(field)
        elif field is GOLDILOCKS_FP2:
            _OPS[key] = _gl_ext(field, GOLDILOCKS_FP)
        elif field is BABYBEAR_FP:
            _OPS[key] = _bb_base(field)
        elif field is BABYBEAR_FP4:
            _OPS[key] = _bb_fp4(field, BABYBEAR_FP)
        else:
            raise ValueError(f"no tensor ops for {field!r}")
    return _OPS[key]


def field_dtype(field) -> torch.dtype:
    """The storage dtype of a host field's tensors (``FieldOps.dtype``)."""
    return get_ops(field).dtype


def lift_base_array(ext_ops: FieldOps, base_arr):
    """Embed a base-field tensor (...) into the extension's layout: Fp2
    (..., 2) or Fp4 (..., 4), the higher components 0, in the field's
    dtype (a base tensor of another raises)."""
    if base_arr.dtype != ext_ops.dtype:
        raise ValueError(f"lift_base_array: a {base_arr.dtype} tensor for a "
                         f"field held in {ext_ops.dtype}")
    if ext_ops.elem_axes == ():
        return base_arr
    z = torch.zeros_like(base_arr)
    return torch.stack([base_arr] + [z] * (ext_ops.elem_axes[0] - 1), -1)
