"""Host-exact field arithmetic (the golden oracle for the device kernels).

Field *elements* are plain Python ints (base fields, canonical form) or tuples
of ints (extension fields, coefficient order c0..c{d-1} over the base prime
field).  All protocol-visible semantics of ark-ff 0.5 are replicated:

* modulus / generator constants       — reference: src/field.rs:36-109
* 2-adic roots of unity as derived by the ``MontConfig`` derive macro
  (``TWO_ADIC_ROOT_OF_UNITY = GENERATOR^((p-1) / 2^TWO_ADICITY)``)
* ``Display`` strings (decimal for Fp; ``QuadExtField(c0 + c1 * u)`` nesting
  for extensions) which feed Merkle leaf hashes (reference: src/merkle.rs:165)
* compressed (little-endian canonical) serialization used by the transcript
* ``from_be_bytes_mod_order`` used for challenge sampling
* the extension towers: Goldilocks Fp2 (NONRESIDUE=7), BabyBear Fp2
  (NONRESIDUE=11) and BabyBear Fp4 (NONRESIDUE = Fp2(2013265910, 1))

The FFT-domain semantics live in poly/domain.py; device limb kernels in ops/.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

Scalar = Union[int, Tuple]


class PrimeField:
    """A prime field with the ark-ff Montgomery-backend-visible constants."""

    def __init__(self, name: str, modulus: int, generator: int):
        self.name = name
        self.p = modulus
        self.generator = generator
        self.modulus_bit_size = modulus.bit_length()
        # ark-ff MontConfig: TWO_ADICITY = v2(p - 1)
        t = modulus - 1
        two_adicity = (t & -t).bit_length() - 1
        self.two_adicity = two_adicity
        self.trace = t >> two_adicity  # odd part of p-1
        self.two_adic_root_of_unity = pow(generator, self.trace, modulus)
        # Montgomery constants for the 64-bit single-limb backend
        self.mont_r = (1 << 64) % modulus
        self.mont_r_inv = pow(self.mont_r, modulus - 2, modulus)
        # byte sizes used by the transcript layer
        self.compressed_size = (self.modulus_bit_size + 7) // 8
        self.extension_degree = 1

    # --- arithmetic (canonical ints) ---
    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def square(self, a):
        return (a * a) % self.p

    def inv(self, a):
        assert a % self.p != 0, "division by zero"
        return pow(a, self.p - 2, self.p)

    def pow(self, a, e: int):
        return pow(a, e, self.p)

    def zero(self):
        return 0

    def one(self):
        return 1

    def is_zero(self, a):
        return a % self.p == 0

    def from_int(self, v: int):
        return v % self.p

    # --- FftField ---
    def get_root_of_unity(self, n: int):
        """ark-ff ``FftField::get_root_of_unity``: for n = 2^k <= 2^TWO_ADICITY,
        returns TWO_ADIC_ROOT_OF_UNITY^(2^(TWO_ADICITY - k))."""
        assert n > 0 and n & (n - 1) == 0
        log_n = n.bit_length() - 1
        assert log_n <= self.two_adicity, "domain too large for field 2-adicity"
        return pow(self.two_adic_root_of_unity, 1 << (self.two_adicity - log_n), self.p)

    # --- protocol-visible encodings ---
    def to_string(self, a) -> str:
        """ark-ff ``Display`` for Fp: canonical decimal (src/merkle.rs:165 preimage)."""
        return str(a % self.p)

    def serialize_compressed(self, a) -> bytes:
        return int(a % self.p).to_bytes(self.compressed_size, "little")

    def deserialize_compressed(self, b: bytes):
        assert len(b) == self.compressed_size
        v = int.from_bytes(b, "little")
        assert v < self.p, "non-canonical field encoding"
        return v

    def from_be_bytes_mod_order(self, b: bytes):
        return int.from_bytes(b, "big") % self.p

    # --- Montgomery raw-limb view (used by the test_rng padding parity) ---
    def from_montgomery_limb(self, limb: int):
        return (limb * self.mont_r_inv) % self.p

    # --- base-field hooks shared with extensions ---
    @property
    def base(self):
        return self

    def base_coeffs(self, a) -> Tuple[int, ...]:
        return (a % self.p,)

    def from_base_coeffs(self, coeffs):
        (c,) = coeffs
        return c % self.p

    def from_base_prime_field(self, a):
        return a % self.p

    def rand(self, rng):
        """ark-ff UniformRand for the 64-bit Montgomery backend (see utils/rng.py)."""
        from ..utils.rng import fp_rand_limb

        limb = fp_rand_limb(rng, self.p, self.modulus_bit_size)
        return self.from_montgomery_limb(limb)

    def __repr__(self):
        return f"PrimeField({self.name})"


class QuadExtField:
    """Quadratic extension F_p[u] / (u^2 - NONRESIDUE) over ``base_field``.

    ``base_field`` may itself be an extension (BabyBear Fp4 = quad ext of Fp2).
    Elements are tuples (c0, c1) of base elements.
    """

    def __init__(self, name: str, base_field, nonresidue):
        self.name = name
        self.base_field = base_field
        self.nonresidue = nonresidue
        self.p = base_field.p
        self.extension_degree = 2 * base_field.extension_degree
        self.compressed_size = 2 * base_field.compressed_size
        # FftField for Fp2ConfigWrapper / Fp4ConfigWrapper: the 2-adic root
        # lives in the base prime subfield (c0 = base root, rest 0).
        self.two_adicity = self.base.two_adicity
        # Frobenius coefficients NONRESIDUE^((q^i - 1) / 2) for i < degree
        # (the hard-coded tables in reference src/field.rs:53-62,82-107 are
        # derived this way; scripts/derive_field_params.py re-derives them)
        d = self.extension_degree
        q = self.base.p
        self._frobenius_coeffs = None
        if isinstance(base_field, PrimeField):
            self._frobenius_coeffs = [
                pow(nonresidue, (q**i - 1) // 2, q) for i in range(2)
            ]

    @property
    def base(self) -> PrimeField:
        """The base *prime* field of the tower."""
        b = self.base_field
        while not isinstance(b, PrimeField):
            b = b.base_field
        return b

    # --- arithmetic on (c0, c1) tuples ---
    def add(self, a, b):
        F = self.base_field
        return (F.add(a[0], b[0]), F.add(a[1], b[1]))

    def sub(self, a, b):
        F = self.base_field
        return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))

    def neg(self, a):
        F = self.base_field
        return (F.neg(a[0]), F.neg(a[1]))

    def mul(self, a, b):
        F = self.base_field
        v0 = F.mul(a[0], b[0])
        v1 = F.mul(a[1], b[1])
        c0 = F.add(v0, F.mul(self.nonresidue, v1))
        c1 = F.sub(F.mul(F.add(a[0], a[1]), F.add(b[0], b[1])), F.add(v0, v1))
        return (c0, c1)

    def square(self, a):
        return self.mul(a, a)

    def inv(self, a):
        # (c0 - c1 u) / (c0^2 - NR * c1^2)
        F = self.base_field
        norm = F.sub(F.mul(a[0], a[0]), F.mul(self.nonresidue, F.mul(a[1], a[1])))
        ninv = F.inv(norm)
        return (F.mul(a[0], ninv), F.neg(F.mul(a[1], ninv)))

    def pow(self, a, e: int):
        result = self.one()
        acc = a
        while e > 0:
            if e & 1:
                result = self.mul(result, acc)
            acc = self.square(acc)
            e >>= 1
        return result

    def zero(self):
        F = self.base_field
        return (F.zero(), F.zero())

    def one(self):
        F = self.base_field
        return (F.one(), F.zero())

    def is_zero(self, a):
        F = self.base_field
        return F.is_zero(a[0]) and F.is_zero(a[1])

    def from_int(self, v: int):
        F = self.base_field
        return (F.from_int(v), F.zero())

    def get_root_of_unity(self, n: int):
        root = self.base.get_root_of_unity(n)
        return self.from_base_prime_field(root)

    def frobenius_map(self, a, power: int):
        """x -> x^(q^power): c1 is multiplied by the Frobenius coefficient
        (ark QuadExtField::frobenius_map; quadratic towers only)."""
        assert self._frobenius_coeffs is not None, "frobenius on quad-over-prime only"
        F = self.base_field
        coeff = self._frobenius_coeffs[power % 2]
        return (a[0], F.mul(a[1], coeff))

    # --- encodings ---
    def to_string(self, a) -> str:
        """ark-ff ``Display`` for QuadExtField (quadratic_extension.rs)."""
        F = self.base_field
        return f"QuadExtField({F.to_string(a[0])} + {F.to_string(a[1])} * u)"

    def serialize_compressed(self, a) -> bytes:
        F = self.base_field
        return F.serialize_compressed(a[0]) + F.serialize_compressed(a[1])

    def deserialize_compressed(self, b: bytes):
        F = self.base_field
        h = F.compressed_size
        return (F.deserialize_compressed(b[:h]), F.deserialize_compressed(b[h:]))

    # --- base prime field coefficient view (order: nimue ark plugin
    #     ``from_base_prime_field_elems`` = flattened tower order) ---
    def base_coeffs(self, a) -> Tuple[int, ...]:
        F = self.base_field
        return F.base_coeffs(a[0]) + F.base_coeffs(a[1])

    def from_base_coeffs(self, coeffs):
        F = self.base_field
        h = len(coeffs) // 2
        return (F.from_base_coeffs(coeffs[:h]), F.from_base_coeffs(coeffs[h:]))

    def from_base_prime_field(self, a):
        F = self.base_field
        return (F.from_base_prime_field(a), F.zero())

    def rand(self, rng):
        F = self.base_field
        c0 = F.rand(rng)
        c1 = F.rand(rng)
        return (c0, c1)

    def __repr__(self):
        return f"QuadExtField({self.name})"


# BabyBear Fp4 is just a QuadExtField over BabyBear Fp2 in ark (Fp4ConfigWrapper
# wraps QuadExtConfig with NONRESIDUE in Fp2); alias for clarity.
Fp4ExtField = QuadExtField


# ---------------------------------------------------------------------------
# Concrete fields (reference: src/field.rs:36-109)
# ---------------------------------------------------------------------------

GOLDILOCKS_FP = PrimeField("GoldilocksFp", 18446744069414584321, 7)
GOLDILOCKS_FP2 = QuadExtField("GoldilocksFp2", GOLDILOCKS_FP, 7)

BABYBEAR_FP = PrimeField("BabyBearFp", 2013265921, 440564289)
BABYBEAR_FP2 = QuadExtField("BabyBearFp2", BABYBEAR_FP, 11)
# NONRESIDUE = Fp2(2013265910, 1)  (reference: src/field.rs:100)
BABYBEAR_FP4 = Fp4ExtField("BabyBearFp4", BABYBEAR_FP2, (2013265910, 1))


@dataclass(frozen=True)
class StarkField:
    """Binds a base prime field to its FFT-friendly extension
    (reference ``StarkField`` trait, src/field.rs:9-33)."""

    name: str
    base: PrimeField
    extension: QuadExtField

    def soundness_check(self):
        assert self.base.modulus_bit_size * self.extension.extension_degree > 100

    def extend_scalar(self, a):
        return self.extension.from_base_prime_field(a)


Goldilocks = StarkField("Goldilocks", GOLDILOCKS_FP, GOLDILOCKS_FP2)
BabyBear = StarkField("BabyBear", BABYBEAR_FP, BABYBEAR_FP4)
