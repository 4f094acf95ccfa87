"""Polynomial primitives on coefficient tensors: powers, sums, evaluation,
folding, division by (x - z), prefix products and batch inversion.

Port of ``ministark_tpu/ops/poly_device.py``. Every function takes the
``FieldOps`` of its field (ops/field.py) and works on tensors of shape
(..., n, *elem) on any device; the outputs are the exact field values the
JAX package computes (modular arithmetic has no rounding, so a different
summation order gives the same result). Where the JAX package walked a
fixed shape with ``fori_loop`` to keep XLA graphs small, this one halves or
doubles the working tensor instead: the same values in O(n) work.
``powers`` and ``field_sum`` are ops/div_scan.py's, whose plain versions
are built on them, imported here for this module's callers.
"""

from __future__ import annotations

import torch

from .div_scan import div_scan, field_sum, pow_dot, powers
from .field import FieldOps, lift_base_array


def _elem_nd(k: FieldOps) -> int:
    return len(k.elem_axes)


def eval_poly(k: FieldOps, coeffs, x):
    """sum_i coeffs[i] * x^i: (n, *elem), (*elem) -> (*elem)."""
    return field_sum(k, k.mul(coeffs, powers(k, x, coeffs.shape[0])), axis=0)


def eval_poly_base_coeffs_ext_point(k_ext: FieldOps, base_coeffs, x):
    """A base-field polynomial (n,) evaluated at an extension point x
    (*elem): its coefficients lifted into the extension's layout."""
    return eval_poly(k_ext, lift_base_array(k_ext, base_coeffs), x)


def eval_many(k: FieldOps, coeffs_batch, x, start: int = 0):
    """Evaluate B polynomials at one point: (B, n, *elem), (*elem) -> (B, *elem).
    With ``start``, the coefficients are those of x^start .. x^(start+n-1):
    a block's partial sums, which a field sum across the blocks completes.
    One ``pow_dot`` call, x broadcast over the rows (batch stride 0)."""
    return pow_dot(k, coeffs_batch, x.expand(coeffs_batch.shape[0], *x.shape), start)


def _even_odd_split(coeffs):
    """coeffs[0::2], coeffs[1::2] along axis 0, odd zero-padded to even's length."""
    even = coeffs[0::2]
    odd = coeffs[1::2]
    if odd.shape[0] < even.shape[0]:
        odd = torch.cat([odd, torch.zeros_like(even[:1])], 0)
    return even, odd


def eval_even_odd(k: FieldOps, coeffs, zp):
    """(f_even(z), f_odd(z)) for the coefficient-split halves of (n, *elem):
    ``ops/div_scan.py::pow_dot`` with parts=2, one kernel launch reading
    each coefficient once on a CUDA tensor."""
    both = pow_dot(k, coeffs.unsqueeze(0), zp.unsqueeze(0), parts=2)[0]
    return both[0], both[1]


def fold_even_odd(k: FieldOps, coeffs, alpha):
    """f_even + alpha * f_odd over coefficient slices (split factor 2)."""
    even, odd = _even_odd_split(coeffs)
    return k.add(even, k.mul(odd, alpha.expand_as(odd)))


def fold_factor(k: FieldOps, coeffs, alpha, F: int):
    """sum_j alpha^j * coeffs[F*i + j]: the F-way coefficient fold of the
    fast mode's FRI (``poly_device.fold_factor`` :203); (n, *elem) ->
    (n / F, *elem)."""
    n = coeffs.shape[0]
    if n % F:
        raise ValueError(f"fold_factor: {n} coefficients do not fold by {F}")
    groups = coeffs.reshape((n // F, F) + tuple(coeffs.shape[1:]))
    pw = powers(k, alpha, F)                                   # (F, *elem)
    return field_sum(k, k.mul(groups, pw.unsqueeze(0).expand_as(groups)), axis=1)


def mix_columns(k: FieldOps, cols, weights):
    """sum_i weights[i] * cols[i]; cols: (w, n, *elem), weights: (w, *elem)."""
    return field_sum(k, k.mul(cols, weights.unsqueeze(1).expand_as(cols)), axis=0)


def synth_div_suffix(k: FieldOps, coeffs, zp, zinvp):
    """Quotient of division by (x - z), remainder dropped,
    q_i = z^-(i+1) * sum_{j >= i+1} c_j z^j: coeffs (*batch, n, *elem) with
    at most one batch axis, zp and zinvp = z^-1 (*batch, *elem) ->
    (*batch, n - 1, *elem). ``ops/div_scan.py::div_scan`` narrowed by its
    trailing zero, the kernel on a CUDA tensor. Requires z != 0 (callers
    take the host path on the zero challenge)."""
    one = coeffs.dim() == 1 + _elem_nd(k)
    if one:
        coeffs, zp, zinvp = coeffs.unsqueeze(0), zp.unsqueeze(0), zinvp.unsqueeze(0)
    q = div_scan(k, coeffs, zp, zinvp).narrow(1, 0, coeffs.shape[1] - 1)
    return q[0] if one else q


def synth_div(k: FieldOps, coeffs, z):
    """Exact division by (x - z): (n, *elem) coefficients, z (*elem) ->
    the (n - 1, *elem) quotient, the remainder f(z) dropped. Any z, zero
    included. The recurrence q_(i-1) = c_i + z q_i, read from the top,
    gives B_j = sum_(i <= j) z^(j - i) b_i over b = c_(n-1), ..., c_1
    (q_(n-2-j) = B_j), computed as a log-step scan: after the step of
    shift s, B_j holds the window (j - 2s, j], and one step adds
    z^s * B_(j-s)."""
    n = coeffs.shape[0]
    if n <= 1:
        return coeffs[:0]
    b = torch.flip(coeffs[1:], [0])              # c_(n-1), ..., c_1
    zs = z                                       # z^s
    s = 1
    while s < n - 1:
        shifted = k.mul(b[:-s], zs.expand_as(b[:-s]))
        b = torch.cat([b[:s], k.add(b[s:], shifted)], 0)
        zs = k.mul(zs, zs)
        s *= 2
    return torch.flip(b, [0])


def prefix_products(k: FieldOps, arr):
    """P_i = prod_(j <= i) arr[j] along axis 0 (Hillis-Steele)."""
    n = arr.shape[0]
    s = 1
    while s < n:
        arr = torch.cat([arr[:s], k.mul(arr[s:], arr[:-s])], 0)
        s *= 2
    return arr


def _one_like(k: FieldOps, a):
    one = torch.zeros_like(a)
    if k.elem_axes:
        one[..., 0] = 1
    else:
        one.fill_(1)
    return one


def batch_inverse(k: FieldOps, arr, total_inv):
    """Montgomery batch inversion of (n, *elem) nonzero values, given
    ``total_inv`` = 1 / prod(arr) (*elem): inv(a_i) = P_(i-1) S_(i+1)
    total_inv, with prefix products P and suffix products S (P_(-1) =
    S_n = 1)."""
    pre = prefix_products(k, arr)
    suf = torch.flip(prefix_products(k, torch.flip(arr, [0])), [0])
    one = _one_like(k, arr[:1])
    p_prev = torch.cat([one, pre[:-1]], 0)
    s_next = torch.cat([suf[1:], one], 0)
    return k.mul(k.mul(p_prev, s_next), total_inv.expand_as(arr))


def batch_inverse_full(field, k: FieldOps, arr):
    """``batch_inverse`` with the total product pulled to the host (one
    element), inverted there and sent back."""
    total = k.unpack(prefix_products(k, arr)[-1:])[0]
    return batch_inverse(k, arr, k.pack_scalar(field.inv(total), arr.device))


def effective_len(t, rows=None) -> int:
    """Length after trailing-zero trimming along axis 0 (0 for all zeros);
    one scalar crosses to the host. With ``rows`` (a ``parallel.Rows``),
    ``t`` is this rank's block of the whole and the length is the whole's:
    each rank's top nonzero index past its offset, the most across the
    ranks in one gather of an int."""
    if t.shape[0] == 0:
        top = torch.zeros((), dtype=torch.int64, device=t.device)
    else:
        nz = (t.reshape(t.shape[0], -1) != 0).any(1)
        idx = torch.arange(1, t.shape[0] + 1, device=t.device)
        top = torch.where(nz, idx, torch.zeros_like(idx)).max()
    if rows is not None:
        from ..parallel.mesh import max_over_ranks

        top = max_over_ranks(rows.mesh, torch.where(top > 0, top + rows.lo, top))
    return int(top)
