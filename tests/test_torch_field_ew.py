"""The elementwise field ops that csrc/field_ew.cu launches once a call
(``ms_gl_ew``: Goldilocks add, sub, neg and their Fp2 forms; ``ms_bb_ew``:
BabyBear add, sub, neg, mul and the Fp4 add, sub, neg and product by a base
scalar; ``ms_bb_fp4_mul``: the Fp4 product) and the Fp2 product by a base
scalar on csrc/gl_mul.cu, on the CPU: each op's plain version and its
dispatcher against the JAX package's function (ministark_tpu/ops/gl.py,
ops/bb.py) on seeded inputs with the edge values, at the broadcast shapes
the provers use; the kernels' operand addressing replayed from the plans
their wrappers build; the wrappers refusing CPU tensors; the plain versions
of the NTTs bound to the plain ops; and small proofs with every field op
sent through the wrappers onto a replay of the kernels' addressing from raw
pointers, equal to the plain proofs, one launch a call. Field arithmetic is
exact: every comparison is integer equality (tolerance 0)."""

import contextlib
import ctypes
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.ops import bb as jbb
from ministark_tpu.ops import gl as jgl
import ministark_tpu_torch.stark.engine as t_eng
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import (BABYBEAR_FP, BABYBEAR_FP4, GOLDILOCKS_FP,
                                        GOLDILOCKS_FP2, BabyBear, Goldilocks)
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.ops import bb, cuda, ntt
from ministark_tpu_torch.ops import field as gl
from ministark_tpu_torch.stark import StarkConfig
from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_to_json

torch.set_num_threads(1)

# field -> (prime, element axes, base host field, extension host field)
FIELDS = {"gl": (gl.P, (2,), GOLDILOCKS_FP, GOLDILOCKS_FP2),
          "bb": (bb.P, (4,), BABYBEAR_FP, BABYBEAR_FP4)}
Q, N = 3, 8


def _edges(p):
    return [0, 1, p - 1, p - 2, 2, (p - 1) // 2]


def _dtype(p):
    """The field's storage: int64 bit patterns (Goldilocks), int32 values
    (BabyBear)."""
    return torch.int32 if p < 1 << 32 else torch.int64


def _values(p, shape, seed):
    """Canonical values of ``shape`` in the field's storage, the first ones
    the edge values 0, 1, p - 1, p - 2, ..."""
    v = np.random.default_rng(seed).integers(0, p, size=shape, dtype=np.uint64)
    flat = v.reshape(-1)
    edges = np.array(_edges(p), dtype=np.uint64)[: flat.size]
    flat[: edges.size] = edges
    return gl.pack_words(v, _dtype(p))


def _edge_pairs(p, d):
    """Every pair of edge values: (E, 1, *d) against (1, E, *d)."""
    e = gl.pack_words(_edges(p), _dtype(p))
    e = e.reshape(-1, *[1] * len(d)).expand(-1, *d).contiguous()
    return e[:, None], e.flip(0)[None]


def _cases(p, d, seed):
    """(a, b) at the provers' shapes: (Q, n, *d) against (Q, n, *d) and
    (Q, 1, *d), the even / odd stride-2 halves of a FRI fold, one element
    (0-d for the base field, (d,) for an extension), both operands one
    element, an empty tensor, and every pair of edge values."""
    x = _values(p, (Q, N) + d, seed)
    y = _values(p, (Q, N) + d, seed + 1).flip(1)
    return {"flat": (x, y), "broadcast": (x, y[:, :1]),
            "even-odd": (x[:, 0::2], x[:, 1::2]), "scalar": (x, y[1, 2]),
            "scalars": (x[0, 3], y[2, 5]), "empty": (x[:0], y[:0]),
            "edges": _edge_pairs(p, d)}


CASES = list(_cases(gl.P, (), 0))


def _jax(t, host):
    return to_jax_packed(t, host)


# op -> (field, element axes: base or extension, port module's op name, the
# JAX function, arity)
OPS = {
    "gl.add": ("gl", False, "add", jgl.add, 2),
    "gl.sub": ("gl", False, "sub", jgl.sub, 2),
    "gl.neg": ("gl", False, "neg", jgl.neg, 1),
    "gl.ext_add": ("gl", True, "ext_add", jgl.ext_add, 2),
    "gl.ext_sub": ("gl", True, "ext_sub", jgl.ext_sub, 2),
    "gl.ext_neg": ("gl", True, "ext_neg", jgl.neg, 1),
    "bb.add": ("bb", False, "add", jbb.add, 2),
    "bb.sub": ("bb", False, "sub", jbb.sub, 2),
    "bb.neg": ("bb", False, "neg", jbb.neg, 1),
    "bb.mul": ("bb", False, "mul", jbb.mul, 2),
    "bb.fp4_add": ("bb", True, "fp4_add", jbb.fp4_add, 2),
    "bb.fp4_sub": ("bb", True, "fp4_sub", jbb.fp4_sub, 2),
    "bb.fp4_neg": ("bb", True, "fp4_neg", jbb.neg, 1),
    "bb.fp4_mul": ("bb", True, "fp4_mul", jbb.fp4_mul, 2),
}
MODULES = {"gl": gl, "bb": bb}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", list(OPS))
def test_plain_ops_match_jax(op, case):
    """Each op's plain version against the JAX package's function (exact),
    and its dispatcher on CPU tensors returning the plain version's value
    without counting a kernel call."""
    tag, ext, name, jfn, arity = OPS[op]
    p, d, base, extf = FIELDS[tag]
    host = extf if ext else base
    a, b = _cases(p, d if ext else (), 7)[case]
    args = (a, b)[:arity]
    mod = MODULES[tag]
    want = from_jax_packed(np.asarray(jfn(*(_jax(t, host) for t in args))), host)
    got = getattr(mod, name + "_plain")(*args)
    assert got.shape == torch.broadcast_shapes(*(t.shape for t in args))
    assert torch.equal(got, want.reshape(got.shape))     # convert makes 0-d 1-d
    calls = dict(mod.calls)
    assert torch.equal(getattr(mod, name)(*args), got)
    assert mod.calls == calls


@pytest.mark.parametrize("case", ["flat", "broadcast", "even-odd", "scalar", "empty"])
@pytest.mark.parametrize("tag", ["gl", "bb"])
def test_scale_base_plain_matches_jax(tag, case):
    """An extension element times base scalars (gl ``ext_scale_base``, bb
    ``fp4_scale_base``): s (Q, n), (Q, 1), the odd half against the even
    half, a 0-d scalar, empty."""
    p, d, base, extf = FIELDS[tag]
    x = _values(p, (Q, N) + d, 11)
    s = _values(p, (Q, N), 12).flip(1)
    a, s = {"flat": (x, s), "broadcast": (x, s[:, :1]),
            "even-odd": (x[:, 0::2], s[:, 1::2]), "scalar": (x, s[1, 2]),
            "empty": (x[:0], s[:0])}[case]
    jfn, name = ((jgl.ext_scale_base, "ext_scale_base") if tag == "gl"
                 else (jbb.fp4_scale_base, "fp4_scale_base"))
    want = from_jax_packed(np.asarray(jfn(_jax(a, extf), _jax(s, base))), extf)
    mod = MODULES[tag]
    got = getattr(mod, name + "_plain")(a, s)
    assert torch.equal(got, want)
    assert torch.equal(getattr(mod, name)(a, s), got)


# ------------------------------------------------------------ addressing
def _replay_offsets(plan):
    """Element offsets of both operands as csrc/elementwise.cuh computes them
    from a plan for every output index: the coordinates over the merged
    sizes, each division by an axis size the kernel's (the multiply-high
    magic number on 32-bit indices, the divide on 64-bit ones), dotted with
    the operand's strides."""
    plan = list(plan)
    D = gl.MUL_MAX_DIMS
    numel, ndim, _, wide = plan[:4]
    size, sa, sb, magic, shift = (plan[6 + j * D: 6 + j * D + ndim] for j in range(5))
    i = np.arange(numel, dtype=np.uint64)
    oa = np.zeros(numel, dtype=np.uint64)
    ob = np.zeros(numel, dtype=np.uint64)
    for k in range(ndim - 1, 0, -1):
        if wide:
            q = i // np.uint64(size[k])
        else:
            q = (((i * np.uint64(magic[k])) >> np.uint64(32)) + i) >> np.uint64(shift[k])
            assert np.array_equal(q, i // np.uint64(size[k]))
        c = i - q * np.uint64(size[k])
        oa += c * np.uint64(sa[k])
        ob += c * np.uint64(sb[k])
        i = q
    oa += i * np.uint64(sa[0])
    ob += i * np.uint64(sb[0])
    return oa.astype(np.int64), ob.astype(np.int64)


def _storage(t):
    return torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())


def _aligned(*ts):
    ptr = 0
    for t in ts:
        ptr |= t.data_ptr()
    return not ptr & 15


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", [op for op in OPS if not op.endswith("fp4_mul")])
def test_ew_addressing_replays_broadcast(op, case):
    """What ``field.ew_cuda`` hands ms_gl_ew / ms_bb_ew (the plan of
    ``_mul_plan`` over the whole tensors, an extension's component axis one
    more axis; a neg with a in b's place) addresses exactly the broadcast
    operands: the kernel's index arithmetic replayed on the CPU storage
    gives the plain result. The 16-byte path only over contiguous operands
    and the whole output."""
    tag, ext, name, _, arity = OPS[op]
    p, d, _, _ = FIELDS[tag]
    a, b = _cases(p, d if ext else (), 13)[case]
    if arity == 1:
        b = a
    shape, plan = gl._mul_plan(a.shape, a.stride(), b.shape, b.stride(), _aligned(a, b))
    plain = getattr(MODULES[tag], name + "_plain")
    args = (a, b)[:arity]
    want = plain(*args)
    assert shape == want.shape
    if plan is None:
        assert want.numel() == 0
        return
    oa, ob = _replay_offsets(plan)
    if plan[2]:
        assert plan[1] == 1 and a.is_contiguous() and b.is_contiguous()
        assert np.array_equal(oa, np.arange(plan[0])) and np.array_equal(oa, ob)
    ga = _storage(a)[a.storage_offset() + oa]
    gb = _storage(b)[b.storage_offset() + ob]
    base = getattr(MODULES[tag], name.replace("ext_", "").replace("fp4_", "") + "_plain")
    assert torch.equal(base(*(ga, gb)[:arity]).reshape(shape), want)


_f = _values(bb.P, (4, 6, 8, 4), 17)
_fq = _f.reshape(24, 8, 4)


@pytest.mark.parametrize("make", [
    lambda: (_fq, _fq.flip(0)),                               # query rounds
    lambda: (_f[:, 0, 0], _f[:, 1, 0]),                       # (Q, 4) x (Q, 4)
    lambda: (_fq, _fq[:, :1]),                                # powers' broadcast
    lambda: (_fq[:, 0::2], _fq[:, 1::2]),                     # even / odd halves
    lambda: (_fq, _f[0, 0, 3].expand_as(_fq)),                # expand_as, stride 0
    lambda: (_fq, _f[2, 3, 4]),                               # a (4,) scalar
    lambda: (_f[2, 3, 4], _f[1, 1, 1]),                       # (4,) x (4,)
    lambda: (_f.movedim(-1, 0).contiguous().movedim(0, -1), _fq.reshape(4, 6, 8, 4)),
    lambda: (_f[..., 1:2].expand(4, 6, 8, 4), _f),            # component stride 0
    lambda: (_f.reshape(-1)[2:-2].reshape(-1, 4), _f.reshape(-1, 4)[1:]),
    lambda: (_f.reshape(-1)[1:-3].reshape(-1, 4), _f.reshape(-1, 4)[1:]),
    lambda: (_fq[:0], _fq[0]),                                # empty
], ids=["query-round", "query-scalars", "powers", "even-odd", "expand-as", "scalar",
        "scalars", "component-stride", "component-bcast", "offset-even", "offset-odd",
        "empty"])
def test_fp4_mul_addressing_replays_broadcast(make):
    """What ``bb.fp4_mul_cuda`` hands ms_bb_fp4_mul (``field._ext_plan`` with
    k = 4: the leading axes and the component strides) addresses exactly the
    broadcast operands: the replayed index arithmetic gathers the operands
    of ``fp4_mul_plain``'s result. Two 16-byte loads an element only where
    both operands' components are adjacent and every element lies on a
    16-byte boundary (an element of int32 words is 16 bytes: one load)."""
    a, b = make()
    shape, plan = gl._ext_plan(a.shape, a.stride(), b.shape, b.stride(),
                               _aligned(a, b), 4, "bb_fp4_mul", a.element_size())
    want = bb.fp4_mul_plain(a, b)
    assert shape == want.shape
    if plan is None:
        assert want.numel() == 0
        return
    ca, cb = plan[4], plan[5]
    assert (ca, cb) == (a.stride(-1), b.stride(-1))
    oa, ob = _replay_offsets(plan)
    oa, ob = a.storage_offset() + oa, b.storage_offset() + ob
    if plan[2]:
        w = 16 // a.element_size()                          # words a 16-byte unit
        assert ca == cb == 1 and _aligned(a, b)
        assert (oa % w == 0).all() and (ob % w == 0).all()
    sa, sb = _storage(a), _storage(b)
    ga = torch.stack([sa[oa + k * ca] for k in range(4)], -1)
    gb = torch.stack([sb[ob + k * cb] for k in range(4)], -1)
    assert torch.equal(bb.fp4_mul_plain(ga, gb).reshape(shape), want)


def test_fp4_plan_reach_and_trailing_axis():
    """The plan of a product of k components reaches (k - 1) component
    strides past its last element (64-bit indices past 2^31), and an
    operand without a trailing axis of k is refused."""
    _, plan = gl._ext_plan((1 << 29, 4), (4, 1), (4,), (1,), True, 4, "bb_fp4_mul")
    assert plan[3] == 0                                   # reach 2^31 - 1
    _, plan = gl._ext_plan((1 << 29, 4), (4, 1 << 1), (4,), (1,), True, 4, "bb_fp4_mul")
    assert plan[3] == 1                                   # reach 2^31 + 2
    with pytest.raises(ValueError, match="bb_fp4_mul: a must have a trailing axis of 4"):
        gl._ext_plan((8, 2), (2, 1), (8, 4), (4, 1), True, 4, "bb_fp4_mul")


_CUDA_WRAPPERS = {
    "gl_ew": [lambda x, y: gl.add_cuda(x, y), lambda x, y: gl.sub_cuda(x, y),
              lambda x, y: gl.neg_cuda(x), gl.ext_add_cuda, gl.ext_sub_cuda],
    "gl_mul": [lambda x, y: gl.ext_scale_base_cuda(x, y[..., 0])],
    "bb_ew": [lambda x, y: bb.add_cuda(x, y), lambda x, y: bb.sub_cuda(x, y),
              lambda x, y: bb.neg_cuda(x), lambda x, y: bb.mul_cuda(x, y),
              bb.fp4_add_cuda, bb.fp4_sub_cuda,
              lambda x, y: bb.fp4_scale_base_cuda(x, y[..., 0])],
    "bb_fp4_mul": [bb.fp4_mul_cuda],
}


@pytest.mark.parametrize("kernel", list(_CUDA_WRAPPERS))
def test_cuda_wrappers_refuse_cpu_tensors(kernel):
    """Every ``*_cuda`` wrapper raises on CPU tensors, before any launch,
    and counts no launch: the CPU takes the plain versions only through the
    dispatchers."""
    x = _values(bb.P, (5, 4), 19)
    before = {**gl.launches, **bb.launches}
    for fn in _CUDA_WRAPPERS[kernel]:
        with pytest.raises(ValueError, match=f"{kernel}: expected a CUDA tensor"):
            fn(x, x)
    assert {**gl.launches, **bb.launches} == before


def test_ntt_and_field_ops_bindings():
    """The NTTs' plain versions add, subtract and multiply with the plain
    ops (so, on a CUDA tensor, a reference launches no field kernel), and
    every FieldOps op of the four fields is a dispatcher."""
    for field, mod in ((GOLDILOCKS_FP, gl), (BABYBEAR_FP, bb)):
        F = ntt.ntt_field(field)
        assert (F.add, F.sub, F.mul) == (mod.add_plain, mod.sub_plain, mod.mul_plain)
    k = gl.get_ops(GOLDILOCKS_FP)
    assert (k.add, k.sub, k.neg, k.mul, k.scale_base) == (gl.add, gl.sub, gl.neg,
                                                          gl.mul, gl.mul)
    k = gl.get_ops(GOLDILOCKS_FP2)
    assert (k.add, k.sub, k.neg, k.mul, k.scale_base) == (
        gl.ext_add, gl.ext_sub, gl.ext_neg, gl.ext_mul, gl.ext_scale_base)
    k = gl.get_ops(BABYBEAR_FP)
    assert (k.add, k.sub, k.neg, k.mul, k.scale_base) == (bb.add, bb.sub, bb.neg,
                                                          bb.mul, bb.mul)
    k = gl.get_ops(BABYBEAR_FP4)
    assert (k.add, k.sub, k.neg, k.mul, k.scale_base) == (
        bb.fp4_add, bb.fp4_sub, bb.fp4_neg, bb.fp4_mul, bb.fp4_scale_base)


# ------------------------------------------------------------ whole proofs
def _words(ptr, n, p):
    """n storage words of the field of prime p at ``ptr``: int64 for
    Goldilocks, int32 for BabyBear."""
    word = ctypes.c_int32 if p < 1 << 32 else ctypes.c_int64
    return np.ctypeslib.as_array((word * int(n)).from_address(ptr))


class _ReplayLibrary:
    """The five field kernels' entry points replayed on CPU memory: each
    reads its operands through the plan from the raw pointers it is given
    (canonical values only), computes with the plain version and writes the
    output words, as csrc/field_ew.cu and csrc/gl_mul.cu do."""

    _BASE = {("gl", gl.ADD): gl.add_plain, ("gl", gl.SUB): gl.sub_plain,
             ("gl", gl.MUL): gl.mul_plain, ("bb", gl.ADD): bb.add_plain,
             ("bb", gl.SUB): bb.sub_plain, ("bb", gl.MUL): bb.mul_plain}

    @staticmethod
    def _read(ptr, offs, p):
        v = _words(ptr, offs.max() + 1, p)[offs].copy()
        u = v.astype(np.uint64) if p < 1 << 32 else v.view(np.uint64)
        assert (u < np.uint64(p)).all(), "a non-canonical operand"
        return torch.from_numpy(v)

    def _ew(self, tag, pa, pb, po, plan, op):
        p = gl.P if tag == "gl" else bb.P
        oa, ob = _replay_offsets(plan)
        if plan[2]:
            assert not (pa | pb | po) & 15 and np.array_equal(oa, np.arange(plan[0]))
        a = self._read(pa, oa, p)
        out = (MODULES[tag].neg_plain(a) if op == gl.NEG
               else self._BASE[(tag, op)](a, self._read(pb, ob, p)))
        _words(po, plan[0], p)[:] = out.numpy()
        return 0

    def _ext(self, K, pa, pb, po, plan):
        p = gl.P if K == 2 else bb.P
        oa, ob = _replay_offsets(plan)
        if plan[2]:                          # 16-byte elements: 2 or 4 words
            w = 2 if K == 2 else 4
            assert not (pa | pb | po) & 15 and (oa % w == 0).all() and (ob % w == 0).all()
        cs = np.arange(K)[None]
        a = self._read(pa, oa[:, None] + plan[4] * cs, p)
        b = self._read(pb, ob[:, None] + plan[5] * cs, p)
        out = (gl.ext_mul_plain if K == 2 else bb.fp4_mul_plain)(a, b)
        _words(po, plan[0] * K, p)[:] = out.reshape(-1).numpy()
        return 0

    def ms_gl_ew(self, pa, pb, po, plan, op, stream):
        assert op in (gl.ADD, gl.SUB, gl.NEG)
        return self._ew("gl", pa, pb, po, list(plan), op)

    def ms_bb_ew(self, pa, pb, po, plan, op, stream):
        return self._ew("bb", pa, pb, po, list(plan), op)

    def ms_gl_mul(self, pa, pb, po, plan, stream):
        return self._ew("gl", pa, pb, po, list(plan), gl.MUL)

    def ms_gl_ext_mul(self, pa, pb, po, plan, stream):
        return self._ext(2, pa, pb, po, list(plan))

    def ms_bb_fp4_mul(self, pa, pb, po, plan, stream):
        return self._ext(4, pa, pb, po, list(plan))


@contextlib.contextmanager
def _through_the_wrappers(monkeypatch):
    """Every field op takes its ``*_cuda`` wrapper on CPU tensors (of the
    field's dtype only), onto ``_ReplayLibrary``; the counts start at 0."""
    def operands(a, b, kernel, scalar_dim=0, dtype=torch.int64):
        for t in (a, b):
            assert isinstance(t, torch.Tensor) and t.dtype == dtype, kernel
        return a, b

    def dispatch(plain, kernel, counts, name, *ts):
        if all(t.numel() for t in ts):
            counts[name] += 1
        return kernel(*ts)

    lib = _ReplayLibrary()
    monkeypatch.setattr(cuda, "library", lambda: lib)
    monkeypatch.setattr(cuda, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(gl, "_operands", operands)
    monkeypatch.setattr(gl, "dispatch", dispatch)
    saved = [dict(c) for c in (gl.launches, gl.calls, bb.launches, bb.calls)]
    for c in (gl.launches, gl.calls, bb.launches, bb.calls):
        c.update(dict.fromkeys(c, 0))
    try:
        yield
    finally:
        for c, s in zip((gl.launches, gl.calls, bb.launches, bb.calls), saved):
            c.update(s)


def _prove(tag, mode, steps):
    sf = Goldilocks if tag == "gl" else BabyBear
    trace = fibonacci_device_trace(sf, steps, on_device=True, device="cpu")
    if mode == "parity":
        cfg = StarkConfig(sf, 20, 2, steps, trace.constrain_number())
        proof = t_eng.DeviceEngine(cfg, device="cpu").prove(trace)
        return hashlib.sha256(proof_to_json(sf, proof).encode()).hexdigest()
    stark = FastStark(FastStarkConfig(sf, steps, queries=8, arity=4, lde_backend=mode),
                      device="cpu")
    return hashlib.sha256(fast_proof_to_bytes(sf, stark.prove(trace))).hexdigest()


@pytest.mark.parametrize("tag,mode", [("gl", "parity"), ("bb", "parity"),
                                      ("gl", "whir"), ("bb", "stir")])
def test_proofs_through_the_wrappers_equal_plain(monkeypatch, tag, mode):
    """A small proof with every field op routed through its ``*_cuda``
    wrapper, the plan built as on the card and replayed on the operands'
    memory, equals the plain proof byte for byte: the provers hand the
    wrappers only tensors of the field's dtype (int64 Goldilocks, int32
    BabyBear) of canonical values in shapes the plans
    take, and every op launches once (launches equal calls). DEVICE_MIN_SIZE
    32 brings the FRI rounds' tensor code in at this size."""
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 32)
    steps = 255
    want = _prove(tag, mode, steps)
    with _through_the_wrappers(monkeypatch):
        got = _prove(tag, mode, steps)
        launches = {**gl.launches, **bb.launches}
        assert launches == {**gl.calls, **bb.calls}
    assert got == want
    used = ("gl_ew", "gl_mul", "gl_ext_mul") if tag == "gl" else ("bb_ew", "bb_fp4_mul")
    assert all(launches[k] > 0 for k in used), launches
    assert not any(n for k, n in launches.items() if k not in used), launches
