"""Division by (x - z) and the sums weighted by powers of z that feed it,
over Goldilocks Fp2 and BabyBear Fp4, for B rows at once, each with its own
z (csrc/div_scan.cu):

  pow_dot(k, c, z, start, stride, offset)
      S[b] = sum_j c[b, offset + stride j] z[b]^(start + j)
  div_scan(k, c, z, zinv, start, carry, head, fold)
      q[b, g] = zinv^(start + g + 1) (carry[b] + sum_(g < j < m) c'[b, j] z^(start + j))

c (B, n, *elem), z and zinv = 1/z (B, *elem), S (B, *elem), q (B, m, *elem).
c'[b, j] is c[b, j], or with ``fold`` = alpha (*elem) the fold c[b, 2j] +
alpha c[b, 2j + 1] of 2m coefficients, less ``head`` (B, H, *elem) at the
global indices start + j < H. With no carry q[b, m - 1] is zero: the
trailing slot a FRI round re-pads. ``start`` and ``carry`` make one rank's
block of a division over a mesh: its start index, and the later blocks'
pow_dot totals summed (parallel/fri_sharded.py). c, z and zinv may be
broadcast views (batch stride 0): one polynomial divided by Q points.

The callers: ops/poly.py's synth_div_suffix and eval_even_odd, the parity
prover's FRI fold-divide and query quotients (stark/engine.py), the block
divide and deep (parallel/fri_sharded.py) and STIR's quotients
(fri/stir.py). The JAX package computes these in XLA
(``ministark_tpu/ops/planar.py::synth_div_planes`` :391, ``fold_div_planes``
:419); there is no Pallas kernel to port (ROADMAP X3 and X1).

Dispatch by the tensors' device, as ``ops/field.py::mul``: CPU tensors take
the plain versions, the closed form in torch ops (``powers`` ladders,
``field_sum`` and ``suffix_sums``, which live here and which ops/poly.py
re-exports), which needs z != 0 and raises on it; a CUDA
tensor launches the kernel (Horner's scan, which checks no z: a check would
wait for the card; the callers take the host path on a zero challenge) or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import bb, cuda
from .field import P as GL_P
from .field import FieldOps

TILE = 2048          # csrc/div_scan.cu's TILE: the elements one block scans
MAX_ROWS = 65535     # rows a launch takes (the grid's y extent)
FOLD, HEAD, CARRY = 1, 2, 4
# csrc/div_scan.cu's plan: rows, n, c's batch and coefficient strides, z's,
# zinv's, head's batch strides, H, carry's batch stride, start, tiles, flags
PLAN_LEN = 12
_PlanArray = ctypes.c_int64 * PLAN_LEN
_SUFFIX = {((2,), GL_P): "gl2", ((4,), bb.P): "bb4"}

# Incremented once per kernel launch, by the wrapper's kernel name: two a
# pow_dot call, three a div_scan call over more than one tile, else one.
launches = {"pow_dot_gl2": 0, "pow_dot_bb4": 0, "div_scan_gl2": 0, "div_scan_bb4": 0}


# ----------------------------------------------------------------- plain
def field_sum(k: FieldOps, arr, axis: int = 0):
    """Field sum along ``axis`` by pairwise halving (log2(n) adds)."""
    arr = torch.movedim(arr, axis, 0)
    while arr.shape[0] > 1:
        if arr.shape[0] % 2:
            arr = torch.cat([arr, torch.zeros_like(arr[:1])], 0)
        h = arr.shape[0] // 2
        arr = k.add(arr[:h], arr[h:])
    return arr[0]


def powers(k: FieldOps, x, n: int):
    """[1, x, ..., x^(n-1)] along a new coefficient axis: x (*batch, *elem)
    -> (*batch, n, *elem). Doubling: the first 2^j powers times x^(2^j)
    give the next 2^j."""
    nd = len(k.elem_axes)
    ax = x.dim() - nd
    one = torch.zeros_like(x)
    if nd:
        one[..., 0] = 1
    else:
        one.fill_(1)
    pw = one.unsqueeze(ax)
    step = x.unsqueeze(ax)                      # x^(2^j)
    while pw.shape[ax] < n:
        pw = torch.cat([pw, k.mul(pw, step)], ax)
        step = k.mul(step, step)
    return pw.narrow(ax, 0, n)


def suffix_sums(k: FieldOps, arr):
    """S_i = sum_{j >= i} arr[j] along the coefficient axis (Hillis-Steele)."""
    ax = arr.dim() - 1 - len(k.elem_axes)
    n = arr.shape[ax]
    s = 1
    while s < n:
        shifted = torch.cat([arr.narrow(ax, s, n - s),
                             torch.zeros_like(arr.narrow(ax, 0, s))], ax)
        arr = k.add(arr, shifted)
        s *= 2
    return arr


def _check_nonzero(z):
    if bool((z == 0).reshape(z.shape[0], -1).all(1).any()):
        raise ValueError("div_scan: z = 0 has no inverse; divide on the host")


def pow_dot_plain(k: FieldOps, c, z, start: int = 0, stride: int = 1, offset: int = 0):
    """``pow_dot`` in torch ops: the powers of z by doubling, one product,
    a pairwise sum, and z^start."""
    terms = c[:, offset::stride]
    if terms.shape[1] == 0:
        return torch.zeros_like(z)
    s = field_sum(k, k.mul(terms, powers(k, z, terms.shape[1])), axis=1)
    return k.mul(s, k.pow(z, start)) if start else s


def div_scan_plain(k: FieldOps, c, z, zinv, start: int = 0, carry=None, head=None,
                   fold=None):
    """``div_scan`` by the closed form, the start cancelling out of the sum:
    q[g] = zinv^(g+1) (T[g+1] + carry zinv^start), T[i] = sum_(j >= i) c'[j]
    z^j, T[m] = 0."""
    _check_nonzero(z)
    if fold is not None:
        if c.shape[1] % 2:
            raise ValueError(f"div_scan: the fold takes an even count, got {c.shape[1]}")
        odd = c[:, 1::2]
        c = k.add(c[:, 0::2], k.mul(odd, fold.expand_as(odd)))
    m = c.shape[1]
    if head is not None and start < head.shape[1]:
        h = min(head.shape[1] - start, m)
        c = torch.cat([k.sub(c[:, :h], head[:, start:start + h]), c[:, h:]], 1)
    suf = suffix_sums(k, k.mul(c, powers(k, z, m)))
    t = torch.cat([suf[:, 1:], torch.zeros_like(suf[:, :1])], 1)
    if carry is not None:
        if start:
            carry = k.mul(carry, k.pow(zinv, start))
        t = k.add(t, carry.unsqueeze(1).expand_as(t))
    ipw = powers(k, zinv, m)
    return k.mul(t, k.mul(ipw, zinv.unsqueeze(1).expand_as(ipw)))


# ----------------------------------------------------------------- kernels
def _suffix(k: FieldOps, kernel: str) -> str:
    sfx = _SUFFIX.get((tuple(k.elem_axes), k.base_field.p))
    if sfx is None:
        raise ValueError(f"{kernel}: kernels for Goldilocks Fp2 and BabyBear Fp4, "
                         f"got {k.field!r}")
    return sfx


def _strides(t, shape, name: str, kernel: str, device):
    """t's strides in u64 words: an int64 tensor of ``shape`` on ``device``
    whose element components are adjacent."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.int64:
        raise ValueError(f"{kernel}: {name} must be int64, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.stride(-1) != 1 and t.numel():
        raise ValueError(f"{kernel}: {name}'s element components must be adjacent")
    return t.stride()


def _rows(c, kernel: str) -> int:
    if c.device.type != "cuda":
        raise ValueError(f"{kernel}: expected a CUDA tensor, got {c.device}")
    if c.dim() != 3 or not 1 <= c.shape[0] <= MAX_ROWS:
        raise ValueError(f"{kernel}: c must be (B, n, K) with 1 <= B <= {MAX_ROWS}, "
                         f"got shape {tuple(c.shape)}")
    return c.shape[0]


def _tiles(n: int) -> int:
    return max(1, -(-n // TILE))


def pow_dot_cuda(k: FieldOps, c, z, start: int = 0, stride: int = 1, offset: int = 0):
    """CUDA kernel (csrc/div_scan.cu ``ms_pow_dot_gl2`` / ``_bb4``), same
    contract as ``pow_dot_plain``: the terms c[:, offset::stride] read in
    place, two launches (the tiles' sums, then one block a row)."""
    name = "pow_dot_" + _suffix(k, "pow_dot")
    B, K = _rows(c, name), k.elem_axes[0]
    terms = c[:, offset::stride]
    n = terms.shape[1]
    sc = _strides(terms, (B, n, K), "c", name, c.device)
    sz = _strides(z, (B, K), "z", name, c.device)
    if start < 0:
        raise ValueError(f"{name}: start must be >= 0, got {start}")
    out = torch.empty((B, K), dtype=torch.int64, device=c.device)
    nt = _tiles(n)
    tot = torch.empty((B, nt, K), dtype=torch.int64, device=c.device)
    plan = _PlanArray(B, n, sc[0], sc[1], sz[0], 0, 0, 0, 0, start, nt, 0)
    err = getattr(cuda.library(), "ms_" + name)(
        terms.data_ptr(), z.data_ptr(), out.data_ptr(), tot.data_ptr(), plan,
        cuda.stream_ptr(out))
    cuda.check(name, err)
    launches[name] += 2
    return out


def div_scan_cuda(k: FieldOps, c, z, zinv, start: int = 0, carry=None, head=None,
                  fold=None):
    """CUDA kernel (csrc/div_scan.cu ``ms_div_scan_gl2`` / ``_bb4``), same
    contract as ``div_scan_plain`` but for z = 0, which it does not check:
    Horner's scan from the top, the fold, head and carry read in the scan;
    three launches for a row longer than one tile (one otherwise). c, z and
    zinv are read in place through their strides."""
    name = "div_scan_" + _suffix(k, "div_scan")
    B, K = _rows(c, name), k.elem_axes[0]
    dev = c.device
    sc = _strides(c, c.shape, "c", name, dev)
    m = c.shape[1] // 2 if fold is not None else c.shape[1]
    if m < 1 or (fold is not None and c.shape[1] % 2):
        raise ValueError(f"{name}: {c.shape[1]} coefficients"
                         + (" do not fold in pairs" if fold is not None else ""))
    if start < 0:
        raise ValueError(f"{name}: start must be >= 0, got {start}")
    sz = _strides(z, (B, K), "z", name, dev)
    szi = _strides(zinv, (B, K), "zinv", name, dev)
    flags, ptrs, H, sh, scy = 0, [None, None, None], 0, 0, 0
    if fold is not None:
        fold = fold.contiguous()
        _strides(fold, (K,), "fold", name, dev)
        flags, ptrs[0] = flags | FOLD, fold.data_ptr()
    if head is not None:
        head = head.contiguous()
        H = head.shape[1] if head.dim() == 3 else -1
        sh = _strides(head, (B, H, K), "head", name, dev)[0]
        flags, ptrs[1] = flags | HEAD, head.data_ptr()
    if carry is not None:
        scy = _strides(carry, (B, K), "carry", name, dev)[0]
        flags, ptrs[2] = flags | CARRY, carry.data_ptr()
    out = torch.empty((B, m, K), dtype=torch.int64, device=dev)
    nt = _tiles(m)
    tot = cin = None
    if nt > 1:
        tot = torch.empty((B, nt, K), dtype=torch.int64, device=dev)
        cin = torch.empty_like(tot)
    plan = _PlanArray(B, m, sc[0], sc[1], sz[0], szi[0], sh, H, scy, start, nt, flags)
    err = getattr(cuda.library(), "ms_" + name)(
        c.data_ptr(), z.data_ptr(), zinv.data_ptr(), *ptrs, out.data_ptr(),
        None if tot is None else tot.data_ptr(), None if cin is None else cin.data_ptr(),
        plan, cuda.stream_ptr(out))
    cuda.check(name, err)
    launches[name] += 3 if nt > 1 else 1
    return out


# ----------------------------------------------------------------- dispatch
def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts if t is not None)


def pow_dot(k: FieldOps, c, z, start: int = 0, stride: int = 1, offset: int = 0):
    """S[b] = sum_j c[b, offset + stride j] z[b]^(start + j). Dispatch by
    device: CPU tensors -> ``pow_dot_plain``; a CUDA tensor ->
    ``pow_dot_cuda``, the kernel, or raise."""
    if _on_cpu(c, z):
        return pow_dot_plain(k, c, z, start, stride, offset)
    return pow_dot_cuda(k, c, z, start, stride, offset)


def div_scan(k: FieldOps, c, z, zinv, start: int = 0, carry=None, head=None, fold=None):
    """The quotient of c' by (x - z), with its start, carry, head and fold
    (module docstring): (B, m, *elem). Dispatch by device: CPU tensors ->
    ``div_scan_plain``; a CUDA tensor -> ``div_scan_cuda``, the kernel, or
    raise."""
    if _on_cpu(c, z, zinv, carry, head, fold):
        return div_scan_plain(k, c, z, zinv, start, carry, head, fold)
    return div_scan_cuda(k, c, z, zinv, start, carry, head, fold)
