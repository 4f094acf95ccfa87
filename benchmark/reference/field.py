"""Plain modular arithmetic for the reference prover.

Goldilocks (p = 2^64 - 2^32 + 1) and BabyBear (p = 2^31 - 2^27 + 1), each
with the extension tower the configurations state: Goldilocks Fp2 with
u^2 = 7; BabyBear Fp2 with v^2 = 11 and Fp4 over it with u^2 = 11' + v,
where 11' = p - 11. Elements of an extension are flat tuples (host) or a
trailing axis of d components (tensors), in tower order: (c0, c1) of Fp2,
and Fp4's (a0 + a1 v) + (a2 + a3 v) u as (a0, a1, a2, a3).

Tensors hold a Goldilocks value as the int64 with its 64-bit pattern and a
BabyBear value as a canonical int64. Every Goldilocks tensor op keeps its
intermediate values below 2^62 in magnitude, so nothing here relies on
integer overflow wrapping.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
M16 = 0xFFFF


def _gl_canon(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The canonical Goldilocks value of x = hi * 2^32 + lo, as its int64
    bit pattern, for x >= 0 with |hi|, |lo| < 2^55. Uses 2^64 = 2^32 - 1
    (mod p) to fold hi's upper bits down, until hi * 2^32 + lo < 2p."""
    for _ in range(3):
        c = lo >> 32
        lo = lo & M32
        hi = hi + c
        c = hi >> 32
        hi = (hi & M32) + c
        lo = lo - c
    c = lo >> 32
    lo = lo & M32
    hi = hi + c
    big = (hi > M32) | ((hi == M32) & (lo >= 1))
    hi = torch.where(big, hi - M32, hi)
    lo = torch.where(big, lo - 1, lo)
    c = lo >> 32
    lo = lo & M32
    hi = hi + c
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)
    return hi * (1 << 32) + lo


def _halves(a: torch.Tensor):
    return (a >> 32) & M32, a & M32


class PrimeField:
    """A prime field: host ints and int64 tensors."""

    def __init__(self, name: str, p: int, generator: int):
        self.name = name
        self.p = p
        self.generator = generator
        self.bits = p.bit_length()
        t = p - 1
        self.two_adicity = (t & -t).bit_length() - 1

    # ---- host
    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def inv(self, a: int) -> int:
        return pow(a, self.p - 2, self.p)

    def root(self, n: int) -> int:
        """The generator of the subgroup of order n (a power of two):
        GENERATOR^((p - 1) / n), as ark-ff's get_root_of_unity gives it."""
        assert n & (n - 1) == 0 and (n.bit_length() - 1) <= self.two_adicity
        return pow(self.generator, (self.p - 1) // n, self.p)

    # ---- tensors
    def to_tensor(self, ints, device) -> torch.Tensor:
        vals = [v % self.p for v in ints]
        if self.bits > 63:
            vals = [v - (1 << 64) if v >= 1 << 63 else v for v in vals]
        return torch.tensor(vals, dtype=torch.int64, device=device)

    def to_ints(self, t: torch.Tensor):
        """int64 tensor -> flat list of canonical host ints."""
        return [v % (1 << 64) for v in t.reshape(-1).tolist()]

    def add(self, a, b):
        if self.bits <= 32:
            s = a + b
            return torch.where(s >= self.p, s - self.p, s)
        ah, al = _halves(a)
        bh, bl = _halves(b)
        return _gl_canon(ah + bh, al + bl)

    def sub(self, a, b):
        if self.bits <= 32:
            s = a - b
            return torch.where(s < 0, s + self.p, s)
        ah, al = _halves(a)
        bh, bl = _halves(b)
        # + p, as (2^32 - 1) * 2^32 + 1, keeps x >= 0
        return _gl_canon(ah - bh + M32, al - bl + 1)

    def mul(self, a, b):
        if self.bits <= 32:
            return (a * b) % self.p
        al = [(a >> s) & M16 for s in (0, 16, 32, 48)]
        bl = [(b >> s) & M16 for s in (0, 16, 32, 48)]
        c = [None] * 7
        for i in range(4):
            for j in range(4):
                t = al[i] * bl[j]
                c[i + j] = t if c[i + j] is None else c[i + j] + t
        # 2^64 = 2^32 - 1, 2^80 = 2^48 - 2^16, 2^96 = -1 (mod p)
        lo = c[0] - c[4] - c[6] + (c[1] - c[5]) * (1 << 16)
        hi = c[2] + c[4] + (c[3] + c[5]) * (1 << 16)
        # + 2^20 p keeps x >= 0
        return _gl_canon(hi + ((1 << 52) - (1 << 20)), lo + (1 << 20))

    def scale(self, a, s: int):
        """a times the host scalar s."""
        return self.mul(a, self.to_tensor([s], a.device).reshape(()))

    def sum(self, a, dim: int = -1):
        """The field sum along ``dim``."""
        a = a.movedim(dim, -1)
        if self.bits <= 32:
            return a.sum(-1) % self.p       # n < 2^32 values below 2^31
        while a.shape[-1] > 1:
            if a.shape[-1] % 2:
                a = torch.cat([a, torch.zeros_like(a[..., :1])], -1)
            h = a.shape[-1] // 2
            a = self.add(a[..., :h], a[..., h:])
        return a[..., 0]


class ExtField:
    """A tower of quadratic extensions over ``base``: ``nonresidues[k]``
    is level k+1's u^2, a flat tuple of level k's components."""

    def __init__(self, base: PrimeField, nonresidues):
        self.base = base
        self.nr = [tuple(x) if isinstance(x, tuple) else (x,) for x in nonresidues]
        self.d = 2 ** len(self.nr)

    # ---- host, flat tuples
    def hadd(self, a, b):
        p = self.base.p
        return tuple((x + y) % p for x, y in zip(a, b))

    def _hmul(self, a, b):
        if len(a) == 1:
            return ((a[0] * b[0]) % self.base.p,)
        h = len(a) // 2
        nr = self.nr[h.bit_length() - 1]
        v0 = self._hmul(a[:h], b[:h])
        v1 = self._hmul(a[h:], b[h:])
        c0 = self.hadd(v0, self._hmul(nr, v1))
        c1 = self.hadd(self._hmul(a[:h], b[h:]), self._hmul(a[h:], b[:h]))
        return c0 + c1

    def hmul(self, a, b):
        return self._hmul(tuple(a), tuple(b))

    def one(self):
        return (1,) + (0,) * (self.d - 1)

    def hpow(self, a, e: int):
        out, acc = self.one(), tuple(a)
        while e:
            if e & 1:
                out = self.hmul(out, acc)
            acc = self.hmul(acc, acc)
            e >>= 1
        return out

    def powers(self, a, count: int):
        out = [self.one()]
        for _ in range(count - 1):
            out.append(self.hmul(out[-1], a))
        return out

    # ---- tensors (..., d)
    def tensor(self, elems, device) -> torch.Tensor:
        """Host elements -> (len, d) tensor."""
        flat = [c for e in elems for c in e]
        return self.base.to_tensor(flat, device).reshape(len(elems), self.d)

    def to_host(self, t: torch.Tensor):
        """(..., d) tensor -> list of flat tuples."""
        ints = self.base.to_ints(t)
        return [tuple(ints[i:i + self.d]) for i in range(0, len(ints), self.d)]

    def add(self, a, b):
        return self.base.add(a, b)

    def _tmul(self, a, b):
        F = self.base
        if a.shape[-1] == 1 or b.shape[-1] == 1:
            return F.mul(a, b)
        h = a.shape[-1] // 2
        nr = self.nr[h.bit_length() - 1]
        v0 = self._tmul(a[..., :h], b[..., :h])
        v1 = self._tmul(a[..., h:], b[..., h:])
        nrt = F.to_tensor(list(nr), a.device)
        c0 = F.add(v0, self._tmul(v1, nrt.expand(v1.shape)))
        c1 = F.add(self._tmul(a[..., :h], b[..., h:]), self._tmul(a[..., h:], b[..., :h]))
        return torch.cat([c0, c1], -1)

    def mul(self, a, b):
        """(..., d) x (..., d), broadcasting."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return self._tmul(a.expand(shape), b.expand(shape))

    def scale(self, a, s):
        """(..., d) tensor times the host element s."""
        return self.mul(a, self.tensor([s], a.device).reshape(self.d))


GOLDILOCKS = PrimeField("goldilocks", 2**64 - 2**32 + 1, 7)
BABYBEAR = PrimeField("babybear", 2**31 - 2**27 + 1, 440564289)
FIELDS = {
    "goldilocks": ExtField(GOLDILOCKS, [7]),
    "babybear": ExtField(BABYBEAR, [11, (BABYBEAR.p - 11, 1)]),
}
