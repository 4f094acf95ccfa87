"""Goldilocks (p = 2^64 - 2^32 + 1) and its quadratic extension on tensors,
and the field registry ``get_ops`` (Goldilocks, Fp2, BabyBear and its Fp4,
the last two from ops/bb.py).

Port of ``ministark_tpu/ops/{u32,gl,registry}.py``. The TPU's u32 limb-pair
layout stays behind: a base element is an ``int64`` tensor holding the
canonical u64 bit pattern (values >= 2^63 read as negative), and an Fp2
element adds a trailing axis of 2 (c0, c1), with u^2 = 7. CUDA kernels
reinterpret the same storage as ``uint64_t``.

Add and subtract are plain torch ops and run on the CPU and on CUDA alike
(the JAX package has no Pallas kernel for them). ``mul`` and ``ext_mul``
dispatch by the tensors' device: on the CPU they take ``mul_plain`` and
``ext_mul_plain``, on a CUDA tensor they launch csrc/gl_mul.cu's base or
Fp2 product kernel or raise, so every caller (``pow``, ``ext_pow``,
ops/poly.py, the engines, the FRI code) gets one kernel launch per product
on the card. torch has no unsigned 64-bit arithmetic and a
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
def add(a, b):
    """(a + b) mod p."""
    return _join(*_add_h(*_split(a), *_split(b)))


def sub(a, b):
    """(a - b) mod p."""
    return _join(*_sub_h(*_split(a), *_split(b)))


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul_plain(a, b):
    """(a * b) mod p in torch ops: the plain version of ``mul_cuda``."""
    return _join(*_mul_h(*_split(a), *_split(b)))


# Incremented once per call that launches the gl_mul kernel (``launches``)
# or the Fp2 product kernel (``ext_launches``).
launches = 0
ext_launches = 0

MUL_MAX_DIMS = 4   # csrc/gl_mul.cu addresses operands with up to 4 strides
# csrc/gl_mul.cu's plan: numel, ndim, vec, wide, ca, cb, then size, a's and
# b's strides, magic and shift, MUL_MAX_DIMS each
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
    that csrc/gl_mul.cu runs on 32-bit indices: for every i < 2^31,
    i // d == ((i * magic >> 32) + i) >> shift."""
    shift = (d - 1).bit_length()                  # the least s with 2^s >= d
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def _plan(shape, sa, sb, vec: bool, ca: int = 0, cb: int = 0):
    """The int64 plan of one csrc/gl_mul.cu launch over the row-major
    ``shape`` with operand element strides ``sa`` / ``sb`` (and, for the Fp2
    kernel, component strides ``ca`` / ``cb``): the merged axes, their magic
    numbers, and whether the call needs 64-bit indices. ``vec`` asks for the
    16-byte path; it is kept only where the kernel can take it."""
    numel = 1
    for size in shape:
        numel *= size
    sizes, (sa, sb) = _collapse(shape, sa, sb)
    if len(sizes) > MUL_MAX_DIMS:
        raise ValueError(f"gl_mul: operands of shape {tuple(shape)} need "
                         f"{len(sizes)} strided axes, the kernel takes "
                         f"{MUL_MAX_DIMS}")
    if not sizes:                                  # one element
        sizes, sa, sb = [1], [0], [0]
    reach = max(sum((n - 1) * s for n, s in zip(sizes, st)) + c
                for st, c in ((sa, ca), (sb, cb)))
    wide = numel >= _I31 or reach >= _I31
    magics = [_magic(n) if n < _I31 else (0, 0) for n in sizes]
    pad = [0] * (MUL_MAX_DIMS - len(sizes))
    return _PlanArray(numel, len(sizes), int(vec and not wide), int(wide), ca, cb,
                      *sizes, *[1] * len(pad), *sa, *pad, *sb, *pad,
                      *[m for m, _ in magics], *pad, *[s for _, s in magics], *pad)


@functools.lru_cache(maxsize=4096)
def _mul_plan(a_shape, a_stride, b_shape, b_stride, aligned: bool):
    """(output shape, plan or None when the output is empty) of a base
    product; the 16-byte path when both operands are contiguous over the
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
def _ext_plan(a_shape, a_stride, b_shape, b_stride, aligned: bool):
    """(output shape, plan or None) of an Fp2 product over the leading axes;
    16-byte loads when both operands' components are adjacent and every
    element starts on a 16-byte boundary (even strides, aligned base)."""
    for t_shape, name in ((a_shape, "a"), (b_shape, "b")):
        if len(t_shape) < 1 or t_shape[-1] != 2:
            raise ValueError(f"gl_ext_mul: {name} must have a trailing axis of "
                             f"2 (c0, c1), got shape {tuple(t_shape)}")
    lead = torch.broadcast_shapes(a_shape[:-1], b_shape[:-1])
    shape = lead + (2,)
    if lead.numel() == 0:
        return shape, None
    sa = _broadcast_strides(lead, a_shape[:-1], a_stride[:-1])
    sb = _broadcast_strides(lead, b_shape[:-1], b_stride[:-1])
    ca, cb = a_stride[-1], b_stride[-1]
    vec = (aligned and ca == 1 and cb == 1
           and all(s % 2 == 0 for s in sa + sb))
    return shape, _plan(lead, sa, sb, vec, ca, cb)


def _on_device(t: torch.Tensor, name: str, device, kernel="gl_mul",
               scalar_dim=0) -> torch.Tensor:
    """t on ``device``: a CPU scalar (0-d, or (2,) for the Fp2 kernel with
    ``scalar_dim`` 1) is moved there, as torch's own binary ops move a 0-d
    one; any other tensor elsewhere is refused."""
    if t.device != device:
        if t.device.type == "cpu" and t.dim() == scalar_dim and t.numel() <= 2:
            return t.to(device)
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    return t


def _operands(a, b, kernel, scalar_dim=0):
    """(a, b) on one CUDA device, both int64, or raise."""
    if (a.is_cuda and b.is_cuda and a.get_device() == b.get_device()
            and a.dtype == b.dtype == torch.int64):
        return a, b                        # every prover call: no more checks
    device = a.device if a.device.type == "cuda" else b.device
    if device.type != "cuda":
        raise ValueError(f"{kernel}: expected a CUDA tensor, got {a.device}")
    a = _on_device(a, "a", device, kernel, scalar_dim)
    b = _on_device(b, "b", device, kernel, scalar_dim)
    for t, name in ((a, "a"), (b, "b")):
        if t.dtype != torch.int64:
            raise ValueError(f"{kernel}: {name} must be int64, got {t.dtype}")
    return a, b


def mul_cuda(a, b):
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
    global launches
    a, b = _operands(a, b, "gl_mul")
    pa, pb = a.data_ptr(), b.data_ptr()
    shape, plan = _mul_plan(a.shape, a.stride(), b.shape, b.stride(),
                            not (pa | pb) & 15)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    if plan is None:
        return out
    err = cuda.library().ms_gl_mul(pa, pb, out.data_ptr(), plan, cuda.stream_ptr(out))
    cuda.check("gl_mul", err)
    launches += 1
    return out


def mul(a, b):
    """(a * b) mod p. Dispatch by device: CPU tensors -> ``mul_plain``; a
    CUDA tensor (with a CUDA tensor or a 0-d scalar) -> ``mul_cuda``, the
    kernel, or raise."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_plain(a, b)
    return mul_cuda(a, b)


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
    """a * 7 as 8a - a with three doublings (``ops/gl.py::_mul_nr``)."""
    two = add(a, a)
    four = add(two, two)
    eight = add(four, four)
    return sub(eight, a)


# --------------------------------------------------------------- Fp2
def ext_add(a, b):
    return torch.stack([add(a[..., 0], b[..., 0]), add(a[..., 1], b[..., 1])], -1)


def ext_sub(a, b):
    return torch.stack([sub(a[..., 0], b[..., 0]), sub(a[..., 1], b[..., 1])], -1)


def ext_neg(a):
    return torch.stack([neg(a[..., 0]), neg(a[..., 1])], -1)


def ext_mul_plain(a, b):
    """Karatsuba product in Fp[u]/(u^2 - 7), as ``ops/gl.py::ext_mul``, in
    torch ops with ``mul_plain``: the plain version of ``ext_mul_cuda``."""
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    v0 = mul_plain(a0, b0)
    v1 = mul_plain(a1, b1)
    c0 = add(v0, _mul_nr(v1))
    c1 = sub(mul_plain(add(a0, a1), add(b0, b1)), add(v0, v1))
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
    global ext_launches
    a, b = _operands(a, b, "gl_ext_mul", scalar_dim=1)
    pa, pb = a.data_ptr(), b.data_ptr()
    shape, plan = _ext_plan(a.shape, a.stride(), b.shape, b.stride(),
                            not (pa | pb) & 15)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    if plan is None:
        return out
    err = cuda.library().ms_gl_ext_mul(pa, pb, out.data_ptr(), plan,
                                       cuda.stream_ptr(out))
    cuda.check("gl_ext_mul", err)
    ext_launches += 1
    return out


def ext_mul(a, b):
    """Product in Fp2. Dispatch by device: CPU tensors -> ``ext_mul_plain``;
    a CUDA tensor (with a CUDA tensor or a CPU scalar) -> ``ext_mul_cuda``,
    the kernel, or raise."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ext_mul_plain(a, b)
    return ext_mul_cuda(a, b)


def ext_scale_base(a, s):
    """Fp2 element times a base scalar (s broadcasts over a[..., 0])."""
    return torch.stack([mul(a[..., 0], s), mul(a[..., 1], s)], -1)


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
    """int64 tensor -> numpy uint64 array of the same bit patterns."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


@dataclass(frozen=True)
class FieldOps:
    """Tensor ops for one host field (``ops/registry.py::FieldKernels``)."""

    field: object                  # host field (oracle + constants)
    base_field: object             # host base prime field
    elem_axes: Tuple[int, ...]     # trailing element shape: (), (2,) or (4,)
    add: Callable
    sub: Callable
    mul: Callable
    neg: Callable
    pow: Callable
    scale_base: Callable           # elementwise multiply by base scalars
    pack: Callable                 # host scalars -> tensor
    unpack: Callable               # tensor -> list of host scalars
    pack_scalar: Callable          # one host scalar -> 0-d / (2,) / (4,) tensor


def _pack_base(vals, device=None):
    return pack_u64([int(v) for v in vals], device)


def _unpack_base(t):
    return [int(v) for v in unpack_u64(t).reshape(-1)]


def _pack_scalar_base(v, device=None):
    return pack_u64(int(v), device)


def _gl_base(field):
    return FieldOps(
        field=field, base_field=field, elem_axes=(),
        add=add, sub=sub, mul=mul, neg=neg, pow=pow,
        scale_base=mul, pack=_pack_base, unpack=_unpack_base,
        pack_scalar=_pack_scalar_base,
    )


def _gl_ext(field, base):
    def pack(vals, device=None):
        return pack_u64([[int(c0), int(c1)] for (c0, c1) in vals], device
                        ).reshape(-1, 2)

    def unpack(t):
        u = unpack_u64(t).reshape(-1, 2)
        return [(int(r[0]), int(r[1])) for r in u]

    return FieldOps(
        field=field, base_field=base, elem_axes=(2,),
        add=ext_add, sub=ext_sub, mul=ext_mul, neg=ext_neg, pow=ext_pow,
        scale_base=ext_scale_base, pack=pack, unpack=unpack,
        pack_scalar=lambda v, device=None: pack_u64([int(v[0]), int(v[1])],
                                                    device),
    )


def _bb_base(field):
    return FieldOps(
        field=field, base_field=field, elem_axes=(),
        add=bb.add, sub=bb.sub, mul=bb.mul, neg=bb.neg, pow=bb.pow,
        scale_base=bb.mul, pack=_pack_base, unpack=_unpack_base,
        pack_scalar=_pack_scalar_base,
    )


def _bb_fp4(field, base):
    """BabyBear Fp4 (``ops/registry.py::_bb_fp4``): host scalars are nested
    ((c00, c01), (c10, c11)) tuples, tensors (..., 4) in that order."""
    def flat(v):
        return [int(v[0][0]), int(v[0][1]), int(v[1][0]), int(v[1][1])]

    def pack(vals, device=None):
        return pack_u64([flat(v) for v in vals], device).reshape(-1, 4)

    def unpack(t):
        u = unpack_u64(t).reshape(-1, 4)
        return [((int(r[0]), int(r[1])), (int(r[2]), int(r[3]))) for r in u]

    return FieldOps(
        field=field, base_field=base, elem_axes=(4,),
        add=bb.fp4_add, sub=bb.fp4_sub, mul=bb.fp4_mul, neg=bb.fp4_neg,
        pow=bb.fp4_pow, scale_base=bb.fp4_scale_base,
        pack=pack, unpack=unpack,
        pack_scalar=lambda v, device=None: pack_u64(flat(v), device),
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


def lift_base_array(ext_ops: FieldOps, base_arr):
    """Embed a base-field tensor (...) into the extension's layout: Fp2
    (..., 2) or Fp4 (..., 4), the higher components 0."""
    if ext_ops.elem_axes == ():
        return base_arr
    z = torch.zeros_like(base_arr)
    return torch.stack([base_arr] + [z] * (ext_ops.elem_axes[0] - 1), -1)
