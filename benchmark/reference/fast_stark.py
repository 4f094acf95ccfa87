"""Plain reference of the fast-mode STARK proof of B Fibonacci traces.

Written from the protocol's description, in plain torch ops (radix-2
transforms, ``sha256.py``) and hashlib: it imports nothing of the program
and takes nothing the program made. ``prove`` returns the proof's parts as
plain data, each a value the protocol fixes, so a proof from any correct
implementation equals it part for part:

1. Witness: trace i of B has rows (a, b, c) = M^r (1, secret_b_i) with
   M = [[0, 1], [1, 1]] and c = a + b, over n = 2^k >= steps + 1 rows; rows
   from ``steps`` on hold the constant padding value, ark-std's test_rng
   drawn once as a Montgomery limb.
2. Constraint polynomials (w = 3, t = 3 per trace): the three trace
   polynomials' coefficients (the inverse transform over the order-n
   subgroup), then omega a - b twice (omega its generator) and c - a - b,
   coefficient by coefficient: B * 6 polynomials, trace by trace.
3. Commitment: each polynomial lifted to the extension, evaluated over
   the order-N subgroup (N = blowup n), and grouped into N/F coset rows:
   row i holds, polynomial by polynomial, the values at points i + t N/F
   (t < F), each value's d components; an index tree over the rows.
4. Transcript: SHA-256 ratchet (``Transcript``). Absorb the parameters and
   the witness root; draw r; validity_i = sum_j r^j f_(6i + j); for each
   point query draw z and absorb every polynomial's value at z; commit the
   B validities and absorb their root.
5. Batched FRI: draw rho; g = sum_j rho^j h_j over the B * 6 + B
   polynomials; fold F to 1 with a drawn alpha until at most final_len
   coefficients are left (g'_i = sum_t alpha^t g_(F i + t)), committing
   every folded codeword but the last as in 3; absorb the final
   coefficients; draw the query indices below N/F and open every tree
   there (layer r at the index mod N / F^(r + 1)).

``control`` draws the point queries' z from the base field instead of the
extension, a proof with less soundness than the configuration states: the
comparison has to fail it.
"""

from __future__ import annotations

import hashlib
import struct

import torch

from .field import FIELDS, ExtField, PrimeField
from .sha256 import IndexTree

# ark-std 0.5's test_rng() seed: StdRng (ChaCha12) from these bytes
ARK_TEST_SEED = bytes([1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0] + [0] * 16)


# ------------------------------------------------------------------ padding
def _chacha12_words(key: bytes, blocks: int):
    """rand_chacha's ChaCha12 output words: 64-bit block counter in words
    12-13 from 0, stream 0 in words 14-15."""
    m = 0xFFFFFFFF

    def rotl(v, c):
        return ((v << c) | (v >> (32 - c))) & m

    kw = list(struct.unpack("<8I", key))
    out = []
    for ctr in range(blocks):
        s = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574, *kw, ctr & m, ctr >> 32, 0, 0]
        x = list(s)
        for _ in range(6):
            for a, b, c, d in ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
                               (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)):
                x[a] = (x[a] + x[b]) & m
                x[d] = rotl(x[d] ^ x[a], 16)
                x[c] = (x[c] + x[d]) & m
                x[b] = rotl(x[b] ^ x[c], 12)
                x[a] = (x[a] + x[b]) & m
                x[d] = rotl(x[d] ^ x[a], 8)
                x[c] = (x[c] + x[d]) & m
                x[b] = rotl(x[b] ^ x[c], 7)
        out += [(x[i] + s[i]) & m for i in range(16)]
    return out


def padding_value(F: PrimeField) -> int:
    """ark-ff's Fp::rand(&mut test_rng()) for a one-limb Montgomery field:
    u64 draws with the top 64 - bits masked, the first below p taken as
    the Montgomery form x R (R = 2^64 mod p)."""
    words = _chacha12_words(ARK_TEST_SEED, 4)
    mask = (1 << F.bits) - 1
    for i in range(0, len(words), 2):
        limb = (words[i] | words[i + 1] << 32) & mask
        if limb < F.p:
            return limb * pow((1 << 64) % F.p, F.p - 2, F.p) % F.p
    raise AssertionError("no draw below p")


# --------------------------------------------------------------- transcript
class Transcript:
    """The fast mode's Fiat-Shamir ratchet: state = SHA-256 of a label;
    absorb hashes state | 01 | data; a draw of n bytes hashes state | 02 |
    counter (u64 LE) for as many digests as it needs, then state becomes
    SHA-256(state | 03)."""

    def __init__(self, label: bytes):
        self.state = hashlib.sha256(b"ministark-fast-v1/" + label).digest()

    def absorb(self, data: bytes):
        self.state = hashlib.sha256(self.state + b"\x01" + data).digest()

    def draw(self, n: int) -> bytes:
        out = b"".join(hashlib.sha256(self.state + b"\x02" + i.to_bytes(8, "little")).digest()
                       for i in range((n + 31) // 32))
        self.state = hashlib.sha256(self.state + b"\x03").digest()
        return out[:n]

    def scalar(self, E: ExtField, d: int = None):
        """An element: d (default the extension's degree) components of 16
        LE bytes each, reduced mod p; fewer components lift."""
        d = E.d if d is None else d
        raw = self.draw(16 * d)
        comps = [int.from_bytes(raw[16 * i:16 * (i + 1)], "little") % E.base.p for i in range(d)]
        return tuple(comps) + (0,) * (E.d - d)

    def indices(self, count: int, bound: int):
        raw = self.draw(8 * count)
        return [int.from_bytes(raw[8 * i:8 * (i + 1)], "little") % bound for i in range(count)]

    def grind(self, bits: int) -> bytes:
        if bits == 0:
            return b""
        n = 0
        while True:
            nonce = n.to_bytes(8, "little")
            h = hashlib.sha256(self.state + b"\x04" + nonce).digest()
            if int.from_bytes(h[:4], "big") >> (32 - bits) == 0:
                self.absorb(nonce)
                return nonce
            n += 1


def scalar_bytes(e) -> bytes:
    return b"".join(c.to_bytes(8, "little") for c in e)


# --------------------------------------------------------------- transforms
def _bitrev(n: int, device) -> torch.Tensor:
    k = n.bit_length() - 1
    i = torch.arange(n, device=device)
    r = torch.zeros_like(i)
    for b in range(k):
        r |= ((i >> b) & 1) << (k - 1 - b)
    return r


def _powers(F: PrimeField, w: int, count: int, device) -> torch.Tensor:
    t = F.to_tensor([1], device)
    while t.shape[0] < count:
        t = torch.cat([t, F.scale(t, F.pow(w, t.shape[0]))])
    return t[:count]


def ntt(F: PrimeField, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """(R, n) values -> (R, n): evaluations sum_j x_j w^(ij) over the
    order-n subgroup in natural order, or with ``inverse`` the
    coefficients of those evaluations. Radix-2 DIT, in blocks of rows."""
    R, n = x.shape
    if n == 1:
        return x.clone()
    w = F.root(n)
    if inverse:
        w = F.inv(w)
    tw = _powers(F, w, n // 2, x.device)
    rev = _bitrev(n, x.device)
    step = max(1, (1 << 25) // n)
    out = []
    for lo in range(0, R, step):
        y = x[lo:lo + step][:, rev]
        r, h = y.shape[0], 1
        while h < n:
            y = y.reshape(r, n // (2 * h), 2, h)
            u, v = y[:, :, 0], F.mul(y[:, :, 1], tw[::n // (2 * h)])
            y = torch.stack([F.add(u, v), F.sub(u, v)], 2)
            h *= 2
        y = y.reshape(r, n)
        if inverse:
            y = F.scale(y, F.inv(n))
        out.append(y)
    return torch.cat(out, 0)


# ------------------------------------------------------------------ witness
def fib_columns(F: PrimeField, steps: int, secret_bs, n: int, device) -> torch.Tensor:
    """(B, 3, n): each trace's columns a, b, c."""
    # M^i = [[f(i-1), f(i)], [f(i), f(i+1)]] for i < n, doubling: M^(i+m) = M^i M^m
    fm1, f0, f1 = (F.to_tensor([v], device) for v in (1, 0, 1))
    m, mm = 1, (0, 1, 1)                 # M^m as (f(m-1), f(m), f(m+1))
    while fm1.shape[0] < n:
        A, Bm, C = mm
        fm1, f0, f1 = (torch.cat([fm1, F.add(F.scale(fm1, A), F.scale(f0, Bm))]),
                       torch.cat([f0, F.add(F.scale(fm1, Bm), F.scale(f0, C))]),
                       torch.cat([f1, F.add(F.scale(f0, Bm), F.scale(f1, C))]))
        p = F.p
        mm = ((A * A + Bm * Bm) % p, (A * Bm + Bm * C) % p, (Bm * Bm + C * C) % p)
        m *= 2
    pad = padding_value(F)
    cols = []
    for sb in secret_bs:
        a = F.add(fm1[:n], F.scale(f0[:n], sb))
        b = F.add(f0[:n], F.scale(f1[:n], sb))
        c = torch.stack([a, b, F.add(a, b)])
        c[:, steps:] = F.to_tensor([pad], device)
        cols.append(c)
    return torch.stack(cols)


# --------------------------------------------------------------- commitment
def commit(E: ExtField, polys: torch.Tensor, N: int, F: int, arity: int,
           lifted: bool) -> IndexTree:
    """polys: (P, m, d) extension coefficients, or with ``lifted`` (P, m)
    base ones -> the index tree of their coset rows over the order-N
    subgroup."""
    B = E.base
    P, m = polys.shape[:2]
    d = 1 if lifted else E.d
    comps = polys.reshape(P, m, d).movedim(2, 1).reshape(P * d, m)
    flat = torch.zeros((P * d, N), dtype=torch.int64, device=polys.device)
    flat[:, :m] = comps
    ev = ntt(B, flat).reshape(P, d, F, N // F)
    del flat
    if lifted:
        ev = torch.cat([ev, torch.zeros((P, E.d - 1, F, N // F), dtype=ev.dtype,
                                        device=ev.device)], 1)

    def rows(lo, hi):          # (hi - lo, P * F * d): polynomial, point t, component
        return ev[..., lo:hi].permute(3, 0, 2, 1).reshape(hi - lo, -1)

    return IndexTree(rows, N // F, arity)


def _eval_at(E: ExtField, coeffs: torch.Tensor, z) -> list:
    """(P, m) base coefficients at the extension point z -> P elements."""
    m = coeffs.shape[1]
    zp = E.tensor([E.one()], coeffs.device)
    while zp.shape[0] < m:
        zp = torch.cat([zp, E.scale(zp, E.hpow(z, zp.shape[0]))])
    zp = zp[:m]
    out = torch.stack([E.base.sum(E.base.mul(coeffs, zp[:, k]), -1) for k in range(E.d)], -1)
    return E.to_host(out)


def prove(field: str, steps: int, secret_bs, cfg: dict, device, control: bool = False) -> dict:
    """The proof's parts for the traces of ``secret_bs``; ``cfg`` holds
    queries, point_queries, blowup, arity, fold_factor, final_len and
    grinding_bits."""
    E = FIELDS[field]
    Fp = E.base
    B, w, t = len(secret_bs), 3, 3
    n = 1 << steps.bit_length()          # the least power of two >= steps + 1
    N, Ff = cfg["blowup"] * n, cfg["fold_factor"]
    arity = cfg["arity"]

    cols = fib_columns(Fp, steps, secret_bs, n, device).reshape(3 * B, n)
    tp = ntt(Fp, cols, inverse=True).reshape(B, 3, n)
    del cols
    omega = Fp.root(n)
    carry = Fp.sub(Fp.scale(tp[:, 0], omega), tp[:, 1])
    polys = torch.stack([tp[:, 0], tp[:, 1], tp[:, 2], carry, carry,
                         Fp.sub(Fp.sub(tp[:, 2], tp[:, 0]), tp[:, 1])], 1).reshape(B * 6, n)
    del tp, carry

    tr = Transcript(b"fast-stark")
    tr.absorb(b"%d/%d/%d/%d/%d/%d/%d/%d/%d/%d" % (
        w, t, steps, n, cfg["queries"], cfg["point_queries"], cfg["blowup"], arity,
        cfg["final_len"], B))
    tree_w = commit(E, polys, N, Ff, arity, lifted=True)
    tr.absorb(tree_w.root())

    r = tr.scalar(E)
    r_pows = E.powers(r, w + t)
    validities = torch.stack([                              # (B, n, d)
        torch.stack([Fp.sum(torch.stack([Fp.scale(polys[bi * 6 + j], r_pows[j][k])
                                         for j in range(6)]), 0) for k in range(E.d)], -1)
        for bi in range(B)])

    point_evals = []
    for _ in range(cfg["point_queries"]):
        z = tr.scalar(E, 1 if control else None)
        evals = _eval_at(E, polys, z)
        tr.absorb(b"".join(scalar_bytes(e) for e in evals))
        point_evals.append(evals)

    tree_v = commit(E, validities, N, Ff, arity, lifted=False)
    tr.absorb(tree_v.root())

    # batched FRI
    rho = tr.scalar(E)
    rho_pows = E.powers(rho, B * 6 + B)
    cur = torch.stack([Fp.sum(torch.stack([Fp.scale(polys[j], rho_pows[j][k])
                                           for j in range(B * 6)]), 0)
                       for k in range(E.d)], -1)            # (n, d)
    del polys
    for bi in range(B):
        cur = E.add(cur, E.scale(validities[bi], rho_pows[B * 6 + bi]))
    del validities
    layer_trees, m = [], n
    while m > cfg["final_len"]:
        alpha = tr.scalar(E)
        a_pows = E.powers(alpha, Ff)
        g = cur.reshape(m // Ff, Ff, E.d)
        cur = g[:, 0]
        for j in range(1, Ff):
            cur = E.add(cur, E.scale(g[:, j], a_pows[j]))
        m //= Ff
        if m > cfg["final_len"]:
            tree = commit(E, cur[None], cfg["blowup"] * m, Ff, arity, lifted=False)
            layer_trees.append(tree)
            tr.absorb(tree.root())
    final = E.to_host(cur)
    tr.absorb(b"".join(scalar_bytes(e) for e in final))
    nonce = tr.grind(cfg["grinding_bits"])
    idxs = tr.indices(cfg["queries"], N // Ff)

    batch = [[tree_w.open(i), tree_v.open(i)] for i in idxs]
    layers = [[tree.open(i % (N // Ff ** (r + 2))) for r, tree in enumerate(layer_trees)]
              for i in idxs]
    return {
        "n_traces": B, "width": w, "transitions": t,
        "point_evals": point_evals,
        "group_sizes": [B * 6, B], "n": n,
        "group_roots": [tree_w.root(), tree_v.root()],
        "layer_roots": [tree.root() for tree in layer_trees],
        "final_coeffs": final, "pow_nonce": nonce,
        "batch_openings": batch, "layer_openings": layers,
    }
