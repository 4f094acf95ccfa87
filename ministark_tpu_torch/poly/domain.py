"""Radix-2 evaluation domains with ark-poly 0.5 semantics.

Replicates the protocol-visible behavior of ark-poly's
``Radix2EvaluationDomain`` used throughout the reference:

* ``new(n)`` rounds the size up to the next power of two and uses the field's
  2-adic root chain for the group generator (reference use sites:
  src/air.rs:74, src/starks.rs:82-85,190, src/fri.rs:315).
* ``get_coset(offset)`` scales evaluation points by ``offset``.
* fft/ifft map between natural-order coefficients and natural-order
  evaluations (evals[i] = f(offset * g^i)).

The host implementation below works on Python-int scalars (exact); the device
NTT in ops/ntt.py is bit-identical and used for large sizes.
"""

from __future__ import annotations

from typing import List, Sequence


class Radix2EvaluationDomain:
    def __init__(self, field, num_coeffs: int, offset=None):
        size = 1 if num_coeffs == 0 else 1 << (num_coeffs - 1).bit_length()
        log_size = size.bit_length() - 1
        assert log_size <= field.base.two_adicity, "unsupported domain size"
        self.field = field
        self._size = size
        self.log_size = log_size
        self.group_gen = field.get_root_of_unity(size)
        self.group_gen_inv = field.inv(self.group_gen) if size > 1 else field.one()
        self.offset = offset if offset is not None else field.one()
        self.offset_inv = field.inv(self.offset)
        self.size_inv = field.inv(field.from_int(size))

    # --- ark-poly API surface ---
    def size(self) -> int:
        return self._size

    def element(self, i: int):
        """offset * g^i (ark: ``EvaluationDomain::element``)."""
        return self.field.mul(self.offset, self.field.pow(self.group_gen, i))

    def elements(self) -> List:
        F = self.field
        out = []
        cur = self.offset
        for _ in range(self._size):
            out.append(cur)
            cur = F.mul(cur, self.group_gen)
        return out

    def get_coset(self, offset) -> "Radix2EvaluationDomain":
        d = Radix2EvaluationDomain.__new__(Radix2EvaluationDomain)
        d.field = self.field
        d._size = self._size
        d.log_size = self.log_size
        d.group_gen = self.group_gen
        d.group_gen_inv = self.group_gen_inv
        d.offset = offset
        d.offset_inv = self.field.inv(offset)
        d.size_inv = self.size_inv
        return d

    # --- NTT core (host-exact; device path in ops/ntt.py) ---
    def _ntt(self, values: Sequence, root) -> List:
        """In-order DIT radix-2 NTT of length self._size with generator root."""
        F = self.field
        n = self._size
        a = list(values)
        assert len(a) == n
        if n == 1:
            return a
        # bit-reverse permutation
        logn = self.log_size
        for i in range(n):
            j = int(format(i, f"0{logn}b")[::-1], 2)
            if i < j:
                a[i], a[j] = a[j], a[i]
        # stages
        length = 2
        while length <= n:
            w_len = F.pow(root, n // length)
            half = length // 2
            for start in range(0, n, length):
                w = F.one()
                for k in range(half):
                    u = a[start + k]
                    v = F.mul(a[start + k + half], w)
                    a[start + k] = F.add(u, v)
                    a[start + k + half] = F.sub(u, v)
                    w = F.mul(w, w_len)
            length *= 2
        return a

    def fft(self, coeffs: Sequence) -> List:
        """Evaluations over the (coset) domain from coefficients.

        evals[i] = f(offset * g^i). Input may be shorter than the domain
        (zero-padded) — matching ark's ``evaluate_over_domain``.
        """
        F = self.field
        n = self._size
        c = list(coeffs)
        assert len(c) <= n, "polynomial degree exceeds domain size"
        c = c + [F.zero()] * (n - len(c))
        if not self._is_one(self.offset):
            # distribute_powers: c[i] *= offset^i
            cur = F.one()
            for i in range(n):
                c[i] = F.mul(c[i], cur)
                cur = F.mul(cur, self.offset)
        return self._ntt(c, self.group_gen)

    def ifft(self, evals: Sequence) -> List:
        """Coefficients from evaluations over the (coset) domain."""
        F = self.field
        n = self._size
        e = list(evals)
        assert len(e) == n
        c = self._ntt(e, self.group_gen_inv)
        c = [F.mul(x, self.size_inv) for x in c]
        if not self._is_one(self.offset):
            cur = F.one()
            for i in range(n):
                c[i] = F.mul(c[i], cur)
                cur = F.mul(cur, self.offset_inv)
        return c

    def vanishing_poly_coeffs(self) -> List:
        """Z(x) = x^n * offset_pow ... for offset h: Z(x) = x^n - h^n."""
        F = self.field
        n = self._size
        coeffs = [F.zero()] * (n + 1)
        coeffs[0] = F.neg(F.pow(self.offset, n))
        coeffs[n] = F.one()
        return coeffs

    def _is_one(self, x) -> bool:
        return x == self.field.one()

    def __eq__(self, other):
        return (
            isinstance(other, Radix2EvaluationDomain)
            and self.field is other.field
            and self._size == other._size
            and self.offset == other.offset
        )

    def __repr__(self):
        return f"Radix2EvaluationDomain(size={self._size}, field={self.field.name})"
