"""BabyBear held in int32, as the JAX package holds it in u32 lanes.

Every BabyBear ``FieldOps`` op of the port (base and Fp4, on CPU tensors:
the plain versions) against ``ministark_tpu/ops/bb.py`` at the edge values
where int32 arithmetic would wrap (0, 1, 2^30, p - 2, p - 1, pairs whose sum
reaches 2^31, the products of p - 1) and on a seeded random batch: each
output int32 and equal to the JAX function's; ``convert.py``'s BabyBear
round trip; and a dtype probe on a parity and a fast prove at 2^10 - 1
whose LDE, codewords and pulled query quotients must be int32 and whose
bytes must equal the JAX package's (the pins below). Exact: tolerance 0.
No JAX compile beyond a field op's."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ministark_tpu_torch.stark.engine as t_eng
from ministark_tpu.ops import bb as jbb
from ministark_tpu_torch.commit import index_tree, packed_tree
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.fields import BABYBEAR_FP, BABYBEAR_FP4, BabyBear
from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
from ministark_tpu_torch.ops import bb, ntt, sha256
from ministark_tpu_torch.ops.field import get_ops, pack_words, unpack_u64
from ministark_tpu_torch.stark import StarkConfig
from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_digests

P = BABYBEAR_FP.p
# the values where int32 arithmetic would leave (-p, p) or wrap: sums of
# two of the last four reach 2^31, products of p - 1 reach 2^62
EDGES = [0, 1, 2, 11, (P - 1) // 2, (P + 1) // 2, 1 << 30, P - 2, P - 1]
POW_EXPONENTS = (0, 1, 2, 7, P - 2)

# proof_digests of ministark_tpu's DeviceEngine over BabyBear at 2^10 - 1
# steps with DEVICE_MIN_SIZE 256, and the sha256 of its FastStark's
# fast_proof_to_bytes at 2^10 - 1 with tests/test_fast_stark.py:21's
# configuration (JAX on the CPU)
PARITY_1023 = {
    "trace_commit": "7d868abc8354a2bca4f5432d6392c7adf3f5271834ac94e463b20363123e8109",
    "constrain_trace_commit": "74fe15da811f55ff6bed63481ced00f44458dafd818b582d40d4eaae99f0dcbf",
    "arthur_sha256": "633fb79d4cddba1c144cdf4d711908de724e624f337e1e17fdb1c20792a33c87",
    "fri_payload_sha256": "c38fa96bf59141e3e82dc86f37af1bfb9530119de6a520b23714df6d7b280b5b",
}
FAST_1023_SHA256 = "db6f998aa5284b0a7611d258be54c422d1720e8a2bcb58edf5793b212240fd16"
FAST_77 = dict(queries=8, point_queries=2, arity=4, final_len=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run side by side: one intra-op thread each
    keeps the plain torch ops from contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(kind):
    """(a, b) uint32 operand arrays: every pair of EDGES, or two seeded
    random batches of 600."""
    if kind == "edges":
        e = np.array(EDGES, dtype=np.uint32)
        return np.repeat(e, e.size), np.tile(e, e.size)
    rng = np.random.default_rng(61)
    return (rng.integers(0, P, size=600, dtype=np.uint32),
            rng.integers(0, P, size=600, dtype=np.uint32))


def _fp4_pairs(kind):
    """(a, b) (n, 4) uint32 Fp4 operands: element i's component c the edge
    (i + 2c) mod 9, and (p - 1, ..., p - 1) (every pair of these 10), or
    seeded random."""
    if kind == "edges":
        e = np.array(EDGES, dtype=np.uint32)
        elems = np.array([[e[(i + 2 * c) % e.size] for c in range(4)]
                          for i in range(e.size)] + [[P - 1] * 4], dtype=np.uint32)
        m = elems.shape[0]
        return np.repeat(elems, m, 0), np.tile(elems, (m, 1))
    rng = np.random.default_rng(67)
    return (rng.integers(0, P, size=(300, 4), dtype=np.uint32),
            rng.integers(0, P, size=(300, 4), dtype=np.uint32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def _jpow(mul, one, a, e):
    """a^e by square and multiply with a JAX product."""
    result, acc = one, a
    while e:
        if e & 1:
            result = mul(result, acc)
        e >>= 1
        acc = mul(acc, acc)
    return result


def _check(got, want):
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want, np.uint32))


BASE_CASES = [
    ("add", lambda k, a, b: k.add(a, b), jbb.add),
    ("sub", lambda k, a, b: k.sub(a, b), jbb.sub),
    ("mul", lambda k, a, b: k.mul(a, b), jbb.mul),
    ("neg", lambda k, a, b: k.neg(a), lambda a, b: jbb.neg(a)),
    ("scale_base", lambda k, a, b: k.scale_base(a, b), jbb.mul),
    ("add_plain", lambda k, a, b: bb.add_plain(a, b), jbb.add),
    ("sub_plain", lambda k, a, b: bb.sub_plain(a, b), jbb.sub),
    ("mul_plain", lambda k, a, b: bb.mul_plain(a, b), jbb.mul),
    ("neg_plain", lambda k, a, b: bb.neg_plain(a), lambda a, b: jbb.neg(a)),
]


@pytest.mark.parametrize("kind", ["edges", "random"])
@pytest.mark.parametrize("name,port,jax", BASE_CASES, ids=[c[0] for c in BASE_CASES])
def test_base_op_is_int32_and_matches_jax(name, port, jax, kind):
    a, b = _pairs(kind)
    got = port(get_ops(BABYBEAR_FP), _t(a), _t(b))
    _check(got, jax(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("kind", ["edges", "random"])
@pytest.mark.parametrize("e", POW_EXPONENTS)
def test_base_pow_is_int32_and_matches_jax(e, kind):
    a, _ = _pairs(kind)
    got = get_ops(BABYBEAR_FP).pow(_t(a), e)
    _check(got, jbb.pow_scalar(jnp.asarray(a), e))


FP4_CASES = [
    ("add", lambda k, a, b: k.add(a, b), jbb.fp4_add),
    ("sub", lambda k, a, b: k.sub(a, b), jbb.fp4_sub),
    ("mul", lambda k, a, b: k.mul(a, b), jbb.fp4_mul),
    ("neg", lambda k, a, b: k.neg(a), lambda a, b: jbb.neg(a)),
    ("scale_base", lambda k, a, b: k.scale_base(a, b[..., 0]),
     lambda a, b: jbb.fp4_scale_base(a, b[..., 0])),
    ("fp4_mul_plain", lambda k, a, b: bb.fp4_mul_plain(a, b), jbb.fp4_mul),
    ("fp4_scale_base_plain", lambda k, a, b: bb.fp4_scale_base_plain(a, b[..., 1]),
     lambda a, b: jbb.fp4_scale_base(a, b[..., 1])),
    ("fp2_mul", lambda k, a, b: bb.fp2_mul(a[..., :2], b[..., 2:]),
     lambda a, b: jbb.fp2_mul(a[..., :2], b[..., 2:])),
    ("fp2_mul_nr4", lambda k, a, b: bb._fp2_mul_nr4(a[..., 2:]),
     lambda a, b: jbb._fp2_mul_nr4(a[..., 2:])),
]


@pytest.mark.parametrize("kind", ["edges", "random"])
@pytest.mark.parametrize("name,port,jax", FP4_CASES, ids=[c[0] for c in FP4_CASES])
def test_fp4_op_is_int32_and_matches_jax(name, port, jax, kind):
    a, b = _fp4_pairs(kind)
    got = port(get_ops(BABYBEAR_FP4), _t(a), _t(b))
    _check(got, jax(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("kind", ["edges", "random"])
@pytest.mark.parametrize("e", (0, 1, 2, 7, 13))
def test_fp4_pow_is_int32_and_matches_jax(e, kind):
    a, _ = _fp4_pairs(kind)
    one = jnp.asarray(np.broadcast_to(np.array([1, 0, 0, 0], np.uint32), a.shape))
    got = get_ops(BABYBEAR_FP4).pow(_t(a), e)
    _check(got, _jpow(jbb.fp4_mul, one, jnp.asarray(a), e))


@pytest.mark.parametrize("field", [BABYBEAR_FP, BABYBEAR_FP4])
def test_pack_and_scalars_are_int32(field):
    k = get_ops(field)
    assert k.dtype == torch.int32
    vals = k.unpack(_t(_fp4_pairs("edges")[0] if k.elem_axes else _pairs("edges")[0]))
    t = k.pack(vals)
    assert t.dtype == torch.int32 and k.unpack(t) == vals
    assert k.pack_scalar(vals[-1]).dtype == torch.int32
    assert pack_words([P - 1], torch.int32).dtype == torch.int32
    assert unpack_u64(t).dtype == np.uint64
    with pytest.raises(OverflowError):
        pack_words([1 << 32], torch.int32)


def test_convert_round_trip_babybear():
    """A BabyBear array of the JAX package becomes an int32 tensor of the
    same values, and back, base and Fp4; a word at or above p is
    refused."""
    for a, field in ((_pairs("random")[0], BABYBEAR_FP),
                     (_fp4_pairs("random")[0], BABYBEAR_FP4)):
        t = from_jax_packed(a, field)
        assert t.dtype == torch.int32 and t.shape == a.shape
        assert np.array_equal(t.numpy(), a.astype(np.int64))
        back = to_jax_packed(t, field)
        assert back.dtype == np.uint32 and np.array_equal(back, a)
    with pytest.raises(ValueError):
        from_jax_packed(np.array([P], np.uint32), BABYBEAR_FP)


def test_int64_babybear_is_refused_by_the_trees_and_lift():
    """Where the field is known, an int64 BabyBear tensor raises on the CPU
    too: the trees and ``lift_base_array`` take no cast."""
    from ministark_tpu_torch.commit.merkle import MerkleTreeConfig
    from ministark_tpu_torch.ops.field import lift_base_array

    cfg = MerkleTreeConfig(leafs_per_node=2, inner_children=2)
    with pytest.raises(ValueError):
        packed_tree.PackedMerkleTree(BABYBEAR_FP, torch.arange(8), cfg)
    with pytest.raises(ValueError):
        lift_base_array(get_ops(BABYBEAR_FP4), torch.arange(8))


_ROWS64 = torch.arange(32, dtype=torch.int64).reshape(8, 4)


@pytest.mark.parametrize("call", [
    lambda: index_tree.IndexMerkleTree(_ROWS64, 2, dtype=torch.int32),
    lambda: index_tree.BlockIndexTree(_ROWS64, 2, None, dtype=torch.int32),
    lambda: sha256.binary_row_digests(_ROWS64, torch.int32),
    lambda: packed_tree._first_match_find(_ROWS64, _ROWS64[:2], torch.int32),
    lambda: packed_tree._first_match_find(_ROWS64.to(torch.int32), _ROWS64[:2],
                                          torch.int32),
], ids=["index_tree", "block_index_tree", "row_digests", "search", "search_rows"])
def test_int64_babybear_is_refused_by_the_index_tree_and_search(call):
    """The index trees, the row hash and the value search take the field's
    storage from their caller and refuse int64 operands for BabyBear on the
    CPU as the kernels do on the card: no cast, no dtype read off the
    operand."""
    with pytest.raises(ValueError):
        call()


def test_babybear_tree_search_refuses_int64_rows():
    """A BabyBear ``PackedMerkleTree`` searches in int32: int64 query rows
    raise, int32 ones find their first occurrence."""
    from ministark_tpu_torch.commit.merkle import MerkleTreeConfig

    cfg = MerkleTreeConfig(leafs_per_node=2, inner_children=2)
    vals = torch.tensor([5, 7, 5, 9, 11, 7, 3, 1], dtype=torch.int32)
    tree = packed_tree.PackedMerkleTree(BABYBEAR_FP, vals, cfg)
    rows = torch.tensor([[7], [3]], dtype=torch.int32)
    assert tree.search_rows_async(rows).tolist() == [1, 6]
    with pytest.raises(ValueError):
        tree.search_rows_async(rows.to(torch.int64))


def _spy(monkeypatch, module, name, seen, label):
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((label, out.dtype))
        return out

    monkeypatch.setattr(module, name, spy)


def test_parity_prove_is_int32_throughout(monkeypatch):
    """BabyBear parity at 2^10 - 1 on the CPU: every transform's output (the
    LDE, the FRI codewords), every tree's values and the pulled query
    quotients are int32, and the proof equals the JAX package's."""
    monkeypatch.setattr(t_eng, "DEVICE_MIN_SIZE", 256)
    seen = []
    _spy(monkeypatch, ntt, "transform_plain", seen, "ntt")
    _spy(monkeypatch, packed_tree, "to_leaf_comps", seen, "tree values")
    real_trim = t_eng.DeviceEngine._trim_quotients

    def trim(self, qs, effs, rows=None):
        seen.append(("query quotients", qs.dtype))
        out = real_trim(self, qs, effs, rows)
        seen.extend(("pulled quotients", q.dtype) for q in out)
        return out

    monkeypatch.setattr(t_eng.DeviceEngine, "_trim_quotients", trim)
    steps = (1 << 10) - 1
    trace = fibonacci_device_trace(BabyBear, steps, on_device=True, device="cpu")
    assert trace.cols_dev.dtype == torch.int32
    cfg = StarkConfig(BabyBear, 20, 2, steps, trace.constrain_number())
    proof = t_eng.DeviceEngine(cfg, device="cpu").prove(trace)
    labels = {label for label, _ in seen}
    assert {"ntt", "tree values", "query quotients", "pulled quotients"} <= labels
    assert all(dtype == torch.int32 for _, dtype in seen), seen
    assert proof_digests(BabyBear, proof) == PARITY_1023


def test_fast_prove_is_int32_throughout(monkeypatch):
    """The BabyBear fast mode at 2^10 - 1 on the CPU: every transform's
    output (the coset-row LDE, the folded codewords) and every index tree's
    rows are int32, and the proof bytes equal the JAX package's."""
    seen = []
    _spy(monkeypatch, ntt, "transform_plain", seen, "ntt")
    real_rows = index_tree.binary_row_digests

    def rows(comps, dtype):
        seen.append(("tree rows", comps.dtype))
        return real_rows(comps, dtype)

    monkeypatch.setattr(index_tree, "binary_row_digests", rows)
    steps = (1 << 10) - 1
    trace = fibonacci_device_trace(BabyBear, steps, on_device=True, device="cpu")
    stark = FastStark(FastStarkConfig(BabyBear, steps, **FAST_77), device="cpu")
    blob = fast_proof_to_bytes(BabyBear, stark.prove(trace))
    assert {"ntt", "tree rows"} <= {label for label, _ in seen}
    assert all(dtype == torch.int32 for _, dtype in seen), seen
    assert hashlib.sha256(blob).hexdigest() == FAST_1023_SHA256


@pytest.mark.parametrize("strides,vec", [((4, 1), 1), ((8, 1), 1), ((2, 1), 0),
                                         ((6, 1), 0), ((4, 2), 0)])
def test_fp4_plan_takes_the_16_byte_path_on_int32_words(strides, vec):
    """An Fp4 element of int32 words is 16 bytes: ms_bb_fp4_mul's one
    16-byte load an element needs adjacent components and element strides of
    a multiple of 4 words (a Goldilocks-width rule, even strides, would
    misalign it)."""
    from ministark_tpu_torch.ops import field

    _, plan = field._ext_plan((64, 4), strides, (64, 4), (4, 1), True, 4, "bb_fp4_mul", 4)
    assert plan[2] == vec
