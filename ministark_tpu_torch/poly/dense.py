"""Dense univariate polynomials with ark-poly 0.5 ``DensePolynomial`` semantics.

Protocol-visible behaviors replicated exactly:

* construction truncates trailing zeros (``from_coefficients_vec``), so the
  zero polynomial has an *empty* coefficient vector and ``degree() == 0``
  (ark returns 0 for the zero poly; used in FRI degree-bound checks,
  reference src/fri.rs:221-227);
* ``divide_by_vanishing_poly(domain)`` returns **(quotient, remainder)** —
  the reference destructures this as ``(rest, validity_poly)`` which makes
  ``validity_poly`` the *remainder* (SURVEY.md §8.3); we keep ark's order and
  let the caller replicate the swap;
* ``/`` is euclidean division returning the quotient (remainder discarded);
* ``evaluate`` is Horner evaluation; ``naive_mul`` the schoolbook product.

Coefficients are host scalars (ints / tuples). Bulk transforms for large
polynomials run on device via ops/ntt.py — same bit-exact results.
"""

from __future__ import annotations

from typing import List, Sequence

from .domain import Radix2EvaluationDomain


class DensePolynomial:
    __slots__ = ("field", "coeffs")

    def __init__(self, field, coeffs: Sequence):
        c = list(coeffs)
        while c and field.is_zero(c[-1]):
            c.pop()
        self.field = field
        self.coeffs = c

    # --- constructors ---
    @classmethod
    def zero(cls, field) -> "DensePolynomial":
        return cls(field, [])

    @classmethod
    def from_coefficients_vec(cls, field, coeffs) -> "DensePolynomial":
        return cls(field, coeffs)

    # --- queries ---
    def is_zero(self) -> bool:
        return not self.coeffs

    def degree(self) -> int:
        """ark: zero polynomial -> 0, else len - 1."""
        return 0 if not self.coeffs else len(self.coeffs) - 1

    def leading_coefficient(self):
        assert self.coeffs
        return self.coeffs[-1]

    def evaluate(self, point):
        """Horner evaluation (exactly ark's ``Polynomial::evaluate``)."""
        F = self.field
        acc = F.zero()
        for c in reversed(self.coeffs):
            acc = F.add(F.mul(acc, point), c)
        return acc

    def to_vec(self) -> List:
        return list(self.coeffs)

    # --- ring ops ---
    def __add__(self, other: "DensePolynomial") -> "DensePolynomial":
        F = self.field
        n = max(len(self.coeffs), len(other.coeffs))
        out = []
        for i in range(n):
            a = self.coeffs[i] if i < len(self.coeffs) else F.zero()
            b = other.coeffs[i] if i < len(other.coeffs) else F.zero()
            out.append(F.add(a, b))
        return DensePolynomial(F, out)

    def __sub__(self, other: "DensePolynomial") -> "DensePolynomial":
        F = self.field
        n = max(len(self.coeffs), len(other.coeffs))
        out = []
        for i in range(n):
            a = self.coeffs[i] if i < len(self.coeffs) else F.zero()
            b = other.coeffs[i] if i < len(other.coeffs) else F.zero()
            out.append(F.sub(a, b))
        return DensePolynomial(F, out)

    def __neg__(self) -> "DensePolynomial":
        F = self.field
        return DensePolynomial(F, [F.neg(c) for c in self.coeffs])

    def scale(self, scalar) -> "DensePolynomial":
        """Multiplication by a field scalar (ark ``Mul<F>`` /
        multiplication by a degree-0 polynomial — same result)."""
        F = self.field
        return DensePolynomial(F, [F.mul(c, scalar) for c in self.coeffs])

    def naive_mul(self, other: "DensePolynomial") -> "DensePolynomial":
        F = self.field
        if self.is_zero() or other.is_zero():
            return DensePolynomial.zero(F)
        out = [F.zero()] * (len(self.coeffs) + len(other.coeffs) - 1)
        for i, a in enumerate(self.coeffs):
            for j, b in enumerate(other.coeffs):
                out[i + j] = F.add(out[i + j], F.mul(a, b))
        return DensePolynomial(F, out)

    def __mul__(self, other):
        if isinstance(other, DensePolynomial):
            return self.naive_mul(other)
        return self.scale(other)

    def divide_with_remainder(self, divisor: "DensePolynomial"):
        """Euclidean division -> (quotient, remainder), ark
        ``DivideWithRemainder`` semantics."""
        F = self.field
        assert not divisor.is_zero(), "division by zero polynomial"
        if self.is_zero():
            return DensePolynomial.zero(F), DensePolynomial.zero(F)
        if self.degree() < divisor.degree():
            return DensePolynomial.zero(F), DensePolynomial(F, self.coeffs)
        rem = list(self.coeffs)
        dlen = len(divisor.coeffs)
        lead_inv = F.inv(divisor.leading_coefficient())
        qlen = len(rem) - dlen + 1
        quot = [F.zero()] * qlen
        for i in range(qlen - 1, -1, -1):
            c = F.mul(rem[i + dlen - 1], lead_inv)
            quot[i] = c
            if not F.is_zero(c):
                for j in range(dlen):
                    rem[i + j] = F.sub(rem[i + j], F.mul(c, divisor.coeffs[j]))
        return DensePolynomial(F, quot), DensePolynomial(F, rem[: dlen - 1])

    def __truediv__(self, divisor: "DensePolynomial") -> "DensePolynomial":
        """ark ``Div``: quotient only (remainder silently discarded —
        the reference relies on exact divisions in FRI, src/fri.rs:101,166)."""
        q, _ = self.divide_with_remainder(divisor)
        return q

    def divide_by_vanishing_poly(self, domain: Radix2EvaluationDomain):
        """Divide by Z(x) = x^n - offset^n -> (quotient, remainder).

        NOTE the reference binds this as ``let (rest, validity_poly) = ...``
        (src/starks.rs:118,220): with ark's (quotient, remainder) order that
        makes the protocol's "validity polynomial" the *remainder*. Callers
        replicate that destructuring; do not "fix" it here (SURVEY.md §8.3).
        """
        F = self.field
        n = domain.size()
        offset_pow = F.pow(domain.offset, n)
        # synthetic division by x^n - h^n: process coefficients high to low
        if len(self.coeffs) <= n:
            return DensePolynomial.zero(F), DensePolynomial(F, self.coeffs)
        # fold x^(n+k) == h^n x^k (mod Z), high coefficients first
        quot = [F.zero()] * (len(self.coeffs) - n)
        work = list(self.coeffs)
        for i in range(len(work) - 1, n - 1, -1):
            c = work[i]
            quot[i - n] = F.add(quot[i - n], c)
            work[i - n] = F.add(work[i - n], F.mul(c, offset_pow))
            work[i] = F.zero()
        return DensePolynomial(F, quot), DensePolynomial(F, work[:n])

    def mul_by_vanishing_poly(self, domain: Radix2EvaluationDomain) -> "DensePolynomial":
        F = self.field
        n = domain.size()
        offset_pow = F.pow(domain.offset, n)
        shifted = [F.zero()] * n + list(self.coeffs)
        for i, c in enumerate(self.coeffs):
            shifted[i] = F.sub(shifted[i], F.mul(c, offset_pow))
        return DensePolynomial(F, shifted)

    def evaluate_over_domain(self, domain: Radix2EvaluationDomain) -> List:
        """Evaluations over (coset) domain — ark ``evaluate_over_domain``.

        If the polynomial's length exceeds the domain size ark folds
        coefficients (evaluates the polynomial mod Z(x) implicitly via fft of
        chunks); the reference never hits that path, and we assert against it.
        """
        assert len(self.coeffs) <= domain.size()
        return domain.fft(self.coeffs)

    # --- helpers used by the protocol layers ---
    def extend(self, stark_field) -> "DensePolynomial":
        """``StarkField::extend_poly`` (reference src/field.rs:23-32): lift
        base-field coefficients into the extension field."""
        ext = stark_field.extension
        return DensePolynomial(ext, [ext.from_base_prime_field(c) for c in self.coeffs])

    def __eq__(self, other):
        return (
            isinstance(other, DensePolynomial)
            and self.field is other.field
            and self.coeffs == other.coeffs
        )

    def __repr__(self):
        return f"DensePolynomial(deg={self.degree()}, n={len(self.coeffs)})"
