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

The callers: ops/poly.py's synth_div_suffix, eval_even_odd and eval_many,
the parity prover's FRI fold-divide and query quotients (stark/engine.py),
the block divide and deep (parallel/fri_sharded.py), STIR's quotients and
point evaluations (fri/stir.py) and WHIR's sumcheck evaluations
(fri/whir.py). The JAX package computes these in XLA
(``ministark_tpu/ops/planar.py::synth_div_planes`` :391, ``fold_div_planes``
:419); there is no Pallas kernel to port (ROADMAP X3 and X1).

Dispatch by the tensors' device, as ``ops/field.py::mul``: CPU tensors take
the plain versions, the closed form in torch ops (``powers`` ladders,
``field_sum`` and ``suffix_sums``, which live here and which ops/poly.py
re-exports), which needs z != 0 and raises on it; a CUDA
tensor launches the kernel or raises: one launch a call for either
function (``launches`` counts it). The division kernel is a single-pass
scan (a tile of the row in shared memory, Horner in each thread's chunk,
warp shuffles across the chunks, decoupled look-back across the tiles from
the top; no check of z: a check would wait for the card, and the callers
take the host path on a zero challenge); pow_dot sums its tiles and the
last block of a row adds their partials. Both keep their look-back flags
and counters in a scratch buffer per device (``_scratch``), zero when made
and written back to zero by each call's last block. ``div_scan_replay`` and
``pow_dot_replay`` follow the kernels' route in torch ops for the tests.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import bb, cuda
from .field import P as GL_P
from .field import FieldOps

# csrc/div_scan.cu's tiles: a division's block of THREADS compute threads
# (and a helper warp) scans THREADS x E elements; GEOMETRY: (E, 16-byte
# units an element) by the kernels' field suffix and the fold; pow_dot's
# block sums DOT_TILE = 128 x 32 terms (with parts=2, pairs)
THREADS = 128
GEOMETRY = {("gl2", False): (32, 1), ("gl2", True): (16, 1),
            ("bb4", False): (16, 2), ("bb4", True): (16, 2)}
DOT_TILE = THREADS * 32


def tile(sfx: str, fold: bool) -> int:
    """The elements one block of the division kernel scans."""
    return THREADS * GEOMETRY[(sfx, fold)][0]
MAX_ROWS = 65535     # rows a launch takes
FOLD, HEAD, CARRY = 1, 2, 4
# csrc/div_scan.cu's plan: rows, n, c's batch and coefficient strides, z's,
# zinv's, head's batch strides, H, carry's batch stride, start, tiles,
# flags, parts
PLAN_LEN = 13
_PlanArray = ctypes.c_int64 * PLAN_LEN
_SUFFIX = {((2,), GL_P): "gl2", ((4,), bb.P): "bb4"}

# Incremented once per kernel launch, by the wrapper's kernel name: one a
# call of either function.
launches = {"pow_dot_gl2": 0, "pow_dot_bb4": 0, "div_scan_gl2": 0, "div_scan_bb4": 0}
# Incremented once per call of a kernel wrapper, launched or refused: a run
# whose launches equal its calls launched once a call.
calls = dict.fromkeys(launches, 0)


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


def pow_dot_plain(k: FieldOps, c, z, start: int = 0, stride: int = 1, offset: int = 0,
                  parts: int = 1):
    """``pow_dot`` in torch ops: the powers of z by doubling, one product,
    a pairwise sum, and z^start. With ``parts=2`` the terms' even and odd
    halves, (B, 2, *elem)."""
    if parts == 2:
        return torch.stack([pow_dot_plain(k, c, z, start, 2 * stride, offset + p * stride)
                            for p in (0, 1)], 1)
    if parts != 1:
        raise ValueError(f"pow_dot: parts is 1 or 2, got {parts}")
    terms = c[:, offset::stride]
    n = terms.shape[1]
    if n == 0:
        return torch.zeros_like(z)
    if z.shape[0] > 1 and z.stride(0) == 0:     # one point for every row
        pw = powers(k, z[:1], n).expand(terms.shape)
    else:
        pw = powers(k, z, n)
    s = field_sum(k, k.mul(terms, pw), axis=1)
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


# ----------------------------------------------------------------- replays
def _elem_pow(k: FieldOps, x, log_n: int):
    """[x^(2^s) for s < log_n]: the kernels' tables of squarings."""
    out = [x]
    for _ in range(log_n - 1):
        out.append(k.mul(out[-1], out[-1]))
    return out


def _bcast(v, t):
    """v (B, *elem) against t (B, ..., *elem)."""
    return v.reshape(v.shape[:1] + (1,) * (t.dim() - v.dim()) + v.shape[1:]).expand_as(t)


def _lane_suffix(k: FieldOps, v, mp, ax: int):
    """The kernels' warp_suffix along axis ``ax`` (the lanes): v[l] +=
    m^d v[l + d] for d = 1, 2, 4, ... while l + d is a lane, mp[s] = m^(2^s)."""
    lanes = v.shape[ax]
    d, s = 1, 0
    while d < lanes:
        o = torch.cat([v.narrow(ax, d, lanes - d),
                       torch.zeros_like(v.narrow(ax, 0, d))], ax)
        v = k.add(v, k.mul(o, _bcast(mp[s], o)))
        d, s = 2 * d, s + 1
    return v


def tile_slot(u, log_chunk: int):
    """csrc/div_scan.cu's swz: 16-byte unit u of a tile (thread t's chunk of
    2^log_chunk units at t 2^log_chunk) at u ^ (t & 7) in shared memory."""
    return u ^ ((u >> log_chunk) & 7)


def div_scan_replay(k: FieldOps, c, z, zinv, start: int = 0, carry=None, head=None,
                    fold=None, chunk: int = 4, lanes: int = 4, warps: int = 2,
                    look: int = 2, seed: int = 0):
    """``div_scan`` by the kernel's route in torch ops, with a tile of
    ``warps`` x ``lanes`` threads of ``chunk`` elements (the kernel: 4 x 32
    x 32 for Fp2, x 16 with the fold and for Fp4) and look-back rounds of ``lanes`` x
    ``look`` tiles (the kernel: 32 x 8): a[j] = c'[j + 1] loaded once with
    the fold and the head (a[m - 1] the carry's first value); each thread's
    chunk by Horner; the lanes' suffix scan with z^(chunk 2^s); the warps'
    totals by Horner in z^(lanes chunk); each tile's absolute partial P =
    sum_(j in tile) a[j] z^j published, then its look-back (a sum of the P
    above it up to the first inclusive sum) and its inclusive sum, each step
    taken in an order drawn from a permutation seeded by ``seed`` among
    those that would not wait; q at the next tile's base = zinv^(base +
    tile) times that sum; each lane's carry from the next lane's scan and
    the table z^(chunk (lanes - l)); Horner down each chunk. Same contract
    as ``div_scan_plain``."""
    _check_nonzero(z)
    if chunk & (chunk - 1) or lanes & (lanes - 1) or warps & (warps - 1):
        raise ValueError("div_scan_replay: chunk, lanes and warps are powers of two")
    B, K = c.shape[0], k.elem_axes
    if fold is not None:
        odd = c[:, 1::2]
        c = k.add(c[:, 0::2], k.mul(odd, fold.expand_as(odd)))
    m = c.shape[1]
    E, L, W = chunk, lanes, warps
    T = E * L * W
    nt = max(1, -(-m // T))
    # the load: a[j] = c'[j + 1], the head at global indices start + j + 1
    a = torch.zeros((B, nt * T) + K, dtype=k.dtype, device=c.device)
    a[:, :m - 1] = c[:, 1:]
    if head is not None and start + 1 < head.shape[1]:
        h = min(head.shape[1] - start - 1, m - 1)
        a[:, :h] = k.sub(a[:, :h], head[:, start + 1:start + 1 + h])
    if carry is not None:
        a[:, m - 1] = k.mul(carry, k.pow(zinv, start + m))
    zp = _elem_pow(k, z, (E * L).bit_length() + 1)
    log_e, log_l = E.bit_length() - 1, L.bit_length() - 1
    zc, zw = zp[log_e], zp[log_e + log_l]
    tiles = a.reshape((B, nt, W, L, E) + K)
    # chunks: Horner in z
    w = tiles[:, :, :, :, E - 1]
    for i in range(E - 2, -1, -1):
        w = k.add(k.mul(w, _bcast(z, w)), tiles[:, :, :, :, i])
    s = _lane_suffix(k, w, zp[log_e:], 3)                # (B, nt, W, L, *K)
    wtot = s[:, :, :, 0]
    rel = wtot[:, :, W - 1]
    for v in range(W - 2, -1, -1):
        rel = k.add(wtot[:, :, v], k.mul(rel, _bcast(zw, rel)))
    bases = torch.stack([k.pow(z, t * T) for t in range(nt)], 1)
    agg = k.mul(rel, bases)                              # P: (B, nt, *K)
    # ftab[l] = zc^(L - l), ftab[L] = 1: the lanes' product scan
    f = _lane_suffix_mul(k, zc.unsqueeze(1).expand((B, L) + K).clone(), 1)
    one = torch.zeros_like(zc)
    one[..., 0] = 1
    ftab = torch.cat([f, one.unsqueeze(1)], 1)           # (B, L + 1, *K)
    # the look-back, tile by tile in a seeded order of the steps that would not wait
    R = L * look
    flag = np.zeros((B, nt), dtype=np.int64)
    incl = torch.zeros_like(agg)
    above = torch.zeros_like(agg)
    steps = [(b, t, 0) for b in range(B) for t in range(nt - 1)]
    steps += [(b, t, 1) for b in range(B) for t in range(nt)]
    rng = np.random.default_rng(seed)
    while steps:
        ready = [st for st in steps if _ready(flag, st, nt, R)]
        b, t, phase = ready[rng.integers(len(ready))]
        steps.remove((b, t, phase))
        if phase == 0:
            flag[b, t] = 1
            continue
        lane_sums = torch.zeros((L,) + K, dtype=k.dtype, device=c.device)
        for u0 in range(t + 1, nt, R):
            fl = [int(flag[b, u]) if u < nt else 2 for u in range(u0, u0 + R)]
            first = fl.index(2) if 2 in fl else R
            for pos in range(min(first + 1, R)):
                if u0 + pos < nt:
                    v = incl[b, u0 + pos] if pos == first else agg[b, u0 + pos]
                    lane_sums[pos % L] = k.add(lane_sums[pos % L], v)
            if first < R:
                break
        acc = field_sum(k, lane_sums)
        above[b, t] = acc
        incl[b, t] = k.add(agg[b, t], acc)
        flag[b, t] = 2
    # q at the next tile's base, each warp's incoming carry, each lane's
    nxt_base = torch.stack([k.pow(zinv, (t + 1) * T) for t in range(nt)], 1)
    xs = [k.mul(above, nxt_base)]
    for v in range(W - 2, -1, -1):
        xs.append(k.add(wtot[:, :, v + 1], k.mul(xs[-1], _bcast(zw, xs[-1]))))
    xin = torch.stack(xs[::-1], 2)                       # (B, nt, W, *K)
    nxt = torch.cat([s[:, :, :, 1:], torch.zeros_like(s[:, :, :, :1])], 3)
    fl1 = ftab[:, 1:].reshape((B, 1, 1, L) + K).expand_as(nxt)
    q = k.add(nxt, k.mul(fl1, xin.unsqueeze(3).expand_as(nxt)))
    out = torch.empty_like(tiles)
    for i in range(E - 1, -1, -1):
        q = k.add(tiles[:, :, :, :, i], k.mul(q, _bcast(z, q)))
        out[:, :, :, :, i] = q
    return out.reshape((B, nt * T) + K)[:, :m]


def _lane_suffix_mul(k: FieldOps, f, ax: int):
    """The suffix products along ``ax``: f[l] = prod_(u >= l) f[u]."""
    lanes = f.shape[ax]
    d = 1
    while d < lanes:
        one = torch.zeros_like(f.narrow(ax, 0, d))
        one[..., 0] = 1
        o = torch.cat([f.narrow(ax, d, lanes - d), one], ax)
        f = k.mul(f, o)
        d *= 2
    return f


def _ready(flag, step, nt: int, R: int) -> bool:
    """Whether a replayed step would run without waiting: an aggregate
    always; a look-back once its own aggregate is out and no round of R
    tiles it reads shows a 0 below its first inclusive flag."""
    b, t, phase = step
    if phase == 0:
        return True
    if t < nt - 1 and flag[b, t] == 0:          # its own aggregate comes first
        return False
    for u0 in range(t + 1, nt, R):
        fl = [int(flag[b, u]) if u < nt else 2 for u in range(u0, u0 + R)]
        first = fl.index(2) if 2 in fl else R
        if 0 in fl[:first]:
            return False
        if first < R:
            return True
    return True


def pow_dot_replay(k: FieldOps, c, z, start: int = 0, stride: int = 1, offset: int = 0,
                   parts: int = 1, per_thread: int = 4, lanes: int = 4, warps: int = 2):
    """``pow_dot`` by the kernel's route in torch ops: tiles of ``warps`` x
    ``lanes`` threads x ``per_thread`` terms (the kernel: 4 x 32 x 32),
    thread t's terms at base + i threads + t in 4 / parts chains (i mod
    chains) by Horner in z^(chains threads), joined in z^threads, the
    lanes' shuffle tree with z^(2^s), the warps' by Horner in z^lanes, times
    z^(start + base); the last tile to finish adds every tile's partial in
    tile order. Same contract as ``pow_dot_plain``."""
    B, K = c.shape[0], k.elem_axes
    if per_thread % (4 // parts):
        raise ValueError(f"pow_dot_replay: {per_thread} terms a thread do not split "
                         f"into {4 // parts} chains")
    terms = c[:, offset::stride]
    n = terms.shape[1]
    J = -(-n // parts)
    TH = lanes * warps
    T = TH * per_thread
    nt = max(1, -(-J // T))
    pad = torch.zeros((B, nt * T * parts) + K, dtype=k.dtype, device=c.device)
    pad[:, :n] = terms
    # (B, nt, per_thread, warps, lanes, parts): term base + i TH + thread, part p
    t6 = pad.reshape((B, nt, per_thread, warps, lanes, parts) + K)
    zp = _elem_pow(k, z, TH.bit_length() + 2)
    zth = zp[TH.bit_length() - 1]
    # ACC chains a part: chain r the terms i = r mod ACC by Horner in
    # z^(ACC threads), joined by Horner in z^threads
    ACC = 4 // parts
    zacc = zp[TH.bit_length() - 1 + ACC.bit_length() - 1]
    chains = []
    for r in range(ACC):
        acc = t6[:, :, per_thread - ACC + r]
        for i0 in range(per_thread - 2 * ACC, -1, -ACC):
            acc = k.add(k.mul(acc, _bcast(zacc, acc)), t6[:, :, i0 + r])
        chains.append(acc)
    w = chains[-1]
    for r in range(ACC - 2, -1, -1):
        w = k.add(chains[r], k.mul(w, _bcast(zth, w)))
    w = _lane_suffix(k, w, zp, 3)[:, :, :, 0]          # (B, nt, warps, parts, *K)
    zl = zp[lanes.bit_length() - 1]
    s = w[:, :, warps - 1]
    for v in range(warps - 2, -1, -1):
        s = k.add(w[:, :, v], k.mul(s, _bcast(zl, s)))
    base = torch.stack([k.pow(z, start + t * T) for t in range(nt)], 1)  # (B, nt, *K)
    partial = k.mul(s, base.unsqueeze(2).expand_as(s))  # (B, nt, parts, *K)
    total = partial[:, 0]
    for t in range(1, nt):
        total = k.add(total, partial[:, t])
    return total if parts == 2 else total[:, 0]


# ----------------------------------------------------------------- kernels
def _suffix(k: FieldOps, kernel: str) -> str:
    sfx = _SUFFIX.get((tuple(k.elem_axes), k.base_field.p))
    if sfx is None:
        raise ValueError(f"{kernel}: kernels for Goldilocks Fp2 and BabyBear Fp4, "
                         f"got {k.field!r}")
    return sfx


def _strides(t, shape, name: str, kernel: str, device, dtype):
    """t's strides in words of the field's ``dtype`` (int64 Goldilocks,
    int32 BabyBear): a tensor of that dtype and ``shape`` on ``device``
    whose element components are adjacent."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
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


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


# (kernel, device, part) -> int64 scratch. "counts" (the look-back's
# ticket, finished count and flags; pow_dot's per-row counts) is zero when
# made and zero again after every call, its last block writing back what
# it used; "values" (the tiles' partial sums) needs no reset. A buffer that
# grows is kept, so a CUDA graph that captured a call keeps its pointer.
_scratch = {}
_retired = []


def _scratch_for(kind: str, device, counts: int, values: int):
    """(counts, values) of at least these sizes in int64 words: the
    kernels keep their flags and partial sums in 64-bit words in either
    field (csrc/div_scan.cu widens a BabyBear value on load)."""
    out = []
    for part, words in (("counts", counts), ("values", values)):
        buf = _scratch.get((kind, device, part))
        if buf is None or buf.numel() < words:
            if buf is not None:
                _retired.append(buf)
            size = max(words, 2 * buf.numel() if buf is not None else 1 << 12)
            make = torch.zeros if part == "counts" else torch.empty
            buf = _scratch[(kind, device, part)] = make(size, dtype=torch.int64,
                                                        device=device)
        out.append(buf)
    return out


def pow_dot_cuda(k: FieldOps, c, z, start: int = 0, stride: int = 1, offset: int = 0,
                 parts: int = 1):
    """CUDA kernel (csrc/div_scan.cu ``ms_pow_dot_gl2`` / ``_bb4``), same
    contract as ``pow_dot_plain``: the terms c[:, offset::stride] read in
    place, each once (``parts=2``: both halves), one launch."""
    name = "pow_dot_" + _suffix(k, "pow_dot")
    calls[name] += 1
    B, K = _rows(c, name), k.elem_axes[0]
    if parts not in (1, 2):
        raise ValueError(f"{name}: parts is 1 or 2, got {parts}")
    terms = c[:, offset::stride]
    n = terms.shape[1]
    sc = _strides(terms, (B, n, K), "c", name, c.device, k.dtype)
    sz = _strides(z, (B, K), "z", name, c.device, k.dtype)
    if start < 0:
        raise ValueError(f"{name}: start must be >= 0, got {start}")
    out = torch.empty((B, parts, K), dtype=k.dtype, device=c.device)
    nt = max(1, _ceil(_ceil(n, parts), DOT_TILE))
    counts, values = _scratch_for("pow_dot", c.device, B, B * nt * parts * K)
    plan = _PlanArray(B, n, sc[0], sc[1], sz[0], 0, 0, 0, 0, start, nt, 0, parts)
    err = getattr(cuda.library(), "ms_" + name)(
        terms.data_ptr(), z.data_ptr(), out.data_ptr(), counts.data_ptr(),
        values.data_ptr(), plan, cuda.stream_ptr(out))
    cuda.check(name, err)
    launches[name] += 1
    return out if parts == 2 else out[:, 0]


def div_scan_cuda(k: FieldOps, c, z, zinv, start: int = 0, carry=None, head=None,
                  fold=None):
    """CUDA kernel (csrc/div_scan.cu ``ms_div_scan_gl2`` / ``_bb4``), same
    contract as ``div_scan_plain`` but for z = 0, which it does not check:
    one single-pass launch, the fold, head and carry read in it. c, z and
    zinv are read in place through their strides."""
    sfx = _suffix(k, "div_scan")
    name = "div_scan_" + sfx
    calls[name] += 1
    B, K = _rows(c, name), k.elem_axes[0]
    dev = c.device
    sc = _strides(c, c.shape, "c", name, dev, k.dtype)
    m = c.shape[1] // 2 if fold is not None else c.shape[1]
    if m < 1 or (fold is not None and c.shape[1] % 2):
        raise ValueError(f"{name}: {c.shape[1]} coefficients"
                         + (" do not fold in pairs" if fold is not None else ""))
    if start < 0:
        raise ValueError(f"{name}: start must be >= 0, got {start}")
    sz = _strides(z, (B, K), "z", name, dev, k.dtype)
    szi = _strides(zinv, (B, K), "zinv", name, dev, k.dtype)
    flags, ptrs, H, sh, scy = 0, [None, None, None], 0, 0, 0
    if fold is not None:
        fold = fold.contiguous()
        _strides(fold, (K,), "fold", name, dev, k.dtype)
        flags, ptrs[0] = flags | FOLD, fold.data_ptr()
    if head is not None:
        head = head.contiguous()
        H = head.shape[1] if head.dim() == 3 else -1
        sh = _strides(head, (B, H, K), "head", name, dev, k.dtype)[0]
        flags, ptrs[1] = flags | HEAD, head.data_ptr()
    if carry is not None:
        scy = _strides(carry, (B, K), "carry", name, dev, k.dtype)[0]
        flags, ptrs[2] = flags | CARRY, carry.data_ptr()
    out = torch.empty((B, m, K), dtype=k.dtype, device=dev)
    nt = _ceil(m, tile(sfx, fold is not None))
    counts, values = _scratch_for("div_scan", dev, 2 + B * nt, 2 * B * nt * K)
    plan = _PlanArray(B, m, sc[0], sc[1], sz[0], szi[0], sh, H, scy, start, nt, flags, 1)
    err = getattr(cuda.library(), "ms_" + name)(
        c.data_ptr(), z.data_ptr(), zinv.data_ptr(), *ptrs, out.data_ptr(),
        counts.data_ptr(), values.data_ptr(), plan, cuda.stream_ptr(out))
    cuda.check(name, err)
    launches[name] += 1
    return out


# ----------------------------------------------------------------- dispatch
def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts if t is not None)


def pow_dot(k: FieldOps, c, z, start: int = 0, stride: int = 1, offset: int = 0,
            parts: int = 1):
    """S[b] = sum_j c[b, offset + stride j] z[b]^(start + j); with
    ``parts=2`` the terms' even and odd halves (B, 2, *elem), each
    coefficient read once. Dispatch by device: CPU tensors ->
    ``pow_dot_plain``; a CUDA tensor -> ``pow_dot_cuda``, the kernel, or
    raise."""
    if _on_cpu(c, z):
        return pow_dot_plain(k, c, z, start, stride, offset, parts)
    return pow_dot_cuda(k, c, z, start, stride, offset, parts)


def div_scan(k: FieldOps, c, z, zinv, start: int = 0, carry=None, head=None, fold=None):
    """The quotient of c' by (x - z), with its start, carry, head and fold
    (module docstring): (B, m, *elem). Dispatch by device: CPU tensors ->
    ``div_scan_plain``; a CUDA tensor -> ``div_scan_cuda``, the kernel, or
    raise."""
    if _on_cpu(c, z, zinv, carry, head, fold):
        return div_scan_plain(k, c, z, zinv, start, carry, head, fold)
    return div_scan_cuda(k, c, z, zinv, start, carry, head, fold)
