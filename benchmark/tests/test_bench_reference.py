"""The plain reference's pieces against Python ints, hashlib and a naive
DFT, and the control against the reference."""

import hashlib
import random

import pytest
import torch

from benchmark.control import readings
from benchmark.reference import fast_stark, field, sha256

FIELDS = [field.GOLDILOCKS, field.BABYBEAR]


@pytest.mark.parametrize("F", FIELDS, ids=lambda F: F.name)
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_prime_ops(F, op):
    rng = random.Random(7)
    p = F.p
    edge = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 2**31 - 1, 2**31, 2**16] + (
        [2**32 - 1, 2**32, 2**32 + 1, 2**48, 2**63 - 1, 2**63] if p > 2**32 else [])
    xs = edge + [rng.randrange(p) for _ in range(2000)]
    ys = [rng.choice(edge) if i % 3 == 0 else rng.randrange(p) for i in range(len(xs))]
    want = {"add": lambda a, b: (a + b) % p, "sub": lambda a, b: (a - b) % p,
            "mul": lambda a, b: a * b % p}[op]
    got = F.to_ints(getattr(F, op)(F.to_tensor(xs, "cpu"), F.to_tensor(ys, "cpu")))
    assert got == [want(a, b) for a, b in zip(xs, ys)]


@pytest.mark.parametrize("F", FIELDS, ids=lambda F: F.name)
def test_sum_and_roots(F):
    rng = random.Random(3)
    xs = [rng.randrange(F.p) for _ in range(1001)]
    assert F.to_ints(F.sum(F.to_tensor(xs, "cpu")))[0] == sum(xs) % F.p
    w = F.root(1 << 10)
    assert pow(w, 1 << 10, F.p) == 1 and pow(w, 1 << 9, F.p) != 1


@pytest.mark.parametrize("name", ["goldilocks", "babybear"])
def test_extension(name):
    E = field.FIELDS[name]
    p = E.base.p
    u = (0, 0, 1, 0) if E.d == 4 else (0, 1)
    # u^2 is the top level's nonresidue: 7 in Goldilocks Fp2, -11 + v in BabyBear Fp4
    assert E.hmul(u, u) == ((7, 0) if E.d == 2 else (p - 11, 1, 0, 0))
    rng = random.Random(5)
    xs = [tuple(rng.randrange(p) for _ in range(E.d)) for _ in range(100)]
    ys = [tuple(rng.randrange(p) for _ in range(E.d)) for _ in range(100)]
    got = E.to_host(E.mul(E.tensor(xs, "cpu"), E.tensor(ys, "cpu")))
    assert got == [E.hmul(x, y) for x, y in zip(xs, ys)]
    # associativity and the inverse of the Frobenius-free check: x^(q^d - 1) = 1
    assert E.hmul(E.hmul(xs[0], ys[0]), xs[1]) == E.hmul(xs[0], E.hmul(ys[0], xs[1]))
    assert E.hpow(xs[2], p**E.d - 1) == E.one()


@pytest.mark.parametrize("C", [1, 6, 8, 24, 96])
def test_sha256_rows(C):
    rng = random.Random(C)
    vals = [[rng.randrange(2**64) for _ in range(C)] for _ in range(4)]
    t = torch.tensor([[v - 2**64 if v >= 2**63 else v for v in r] for r in vals])
    d = sha256.sha256_words(sha256.u64_words(t))
    want = [hashlib.sha256(b"".join(v.to_bytes(8, "little") for v in r)).digest() for r in vals]
    assert [sha256._digest_array(d)[i].tobytes() for i in range(4)] == want
    assert sha256.row_bytes(t[0]) == b"".join(v.to_bytes(8, "little") for v in vals[0])


@pytest.mark.parametrize("arity", [2, 4, 8])
def test_tree_tensor_and_host_paths(arity):
    rows = torch.randint(-2**62, 2**62, (512, 5), generator=torch.Generator().manual_seed(1))
    host = sha256.IndexTree(lambda lo, hi: rows[lo:hi], 512, arity)
    tens = sha256.IndexTree(lambda lo, hi: rows[lo:hi], 512, arity, tensor_min=1, block=100)
    assert host.root() == tens.root()
    row, groups = tens.open(300)
    assert (row, groups) == host.open(300)
    # the path verifies: fold the sibling groups up to the root
    digest, pos = hashlib.sha256(row).digest(), 300
    for g in groups:
        f = len(g) // 32
        assert g[32 * (pos % f):32 * (pos % f + 1)] == digest
        digest, pos = hashlib.sha256(g).digest(), pos // f
    assert digest == host.root()


@pytest.mark.parametrize("F", FIELDS, ids=lambda F: F.name)
def test_ntt_against_naive_dft(F):
    n = 16
    rng = random.Random(11)
    xs = [[rng.randrange(F.p) for _ in range(n)] for _ in range(3)]
    w = F.root(n)
    want = [[sum(c * pow(w, i * j, F.p) for j, c in enumerate(r)) % F.p for i in range(n)]
            for r in xs]
    x = F.to_tensor([c for r in xs for c in r], "cpu").reshape(3, n)
    ev = fast_stark.ntt(F, x)
    assert [F.to_ints(r) for r in ev] == want
    assert torch.equal(fast_stark.ntt(F, ev, inverse=True), x)


def test_padding_values():
    # ark-std's test_rng() first draw, as the Montgomery limb of each field
    assert fast_stark.padding_value(field.GOLDILOCKS) == 11610679913765557349
    assert fast_stark.padding_value(field.BABYBEAR) == 1283765506


@pytest.mark.parametrize("workload", ["fast_gl_seg22_b4", "fast_bb_seg22_b4"])
def test_control_fails_and_program_passes(tiny, workload):
    r = readings(workload, 2**32 + 9, "cpu", *tiny)
    assert r["program"] == 0
    assert r["control"] > 0 and r["control_by_kind"]["point_evals"][0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["fast_gl_seg22_b4", "fast_bb_seg22_b4"])
def test_control_on_the_card(card, workload):
    """At the cell's own size: the program's proof equals the reference's,
    the control's does not."""
    r = readings(workload, 2**31 + 3)
    assert r["program"] == 0 and r["control"] > 0
