"""Polynomial primitives on coefficient tensors: powers, sums, evaluation,
folding, division by (x - z), prefix products and batch inversion.

Port of ``ministark_tpu/ops/poly_device.py``. Every function takes the
``FieldOps`` of its field (ops/field.py) and works on tensors of shape
(..., n, *elem) on any device; the outputs are the exact field values the
JAX package computes (modular arithmetic has no rounding, so a different
summation order gives the same result). Where the JAX package walked a
fixed shape with ``fori_loop`` to keep XLA graphs small, this one halves or
doubles the working tensor instead: the same values in O(n) work.
"""

from __future__ import annotations

import torch

from .field import FieldOps, lift_base_array


def _elem_nd(k: FieldOps) -> int:
    return len(k.elem_axes)


def _n_axis(k: FieldOps, arr) -> int:
    """Index of the coefficient axis: the last axis before the element axes."""
    return arr.dim() - 1 - _elem_nd(k)


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
    nd = _elem_nd(k)
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
    a block's partial sums, which a field sum across the blocks completes."""
    n = coeffs_batch.shape[1]
    pw = powers(k, x, n)
    if start:
        pw = k.mul(pw, k.pow(x, start).unsqueeze(0).expand_as(pw))
    return field_sum(k, k.mul(coeffs_batch, pw.unsqueeze(0)), axis=1)


def _even_odd_split(coeffs):
    """coeffs[0::2], coeffs[1::2] along axis 0, odd zero-padded to even's length."""
    even = coeffs[0::2]
    odd = coeffs[1::2]
    if odd.shape[0] < even.shape[0]:
        odd = torch.cat([odd, torch.zeros_like(even[:1])], 0)
    return even, odd


def eval_even_odd(k: FieldOps, coeffs, zp):
    """(f_even(z), f_odd(z)) for the coefficient-split halves of (n, *elem)."""
    even, odd = _even_odd_split(coeffs)
    pw = powers(k, zp, even.shape[0])
    return field_sum(k, k.mul(even, pw)), field_sum(k, k.mul(odd, pw))


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


def suffix_sums(k: FieldOps, arr):
    """S_i = sum_{j >= i} arr[j] along the coefficient axis (Hillis-Steele)."""
    ax = _n_axis(k, arr)
    n = arr.shape[ax]
    s = 1
    while s < n:
        shifted = torch.cat([arr.narrow(ax, s, n - s),
                             torch.zeros_like(arr.narrow(ax, 0, s))], ax)
        arr = k.add(arr, shifted)
        s *= 2
    return arr


def synth_div_suffix(k: FieldOps, coeffs, zp, zinvp):
    """Quotient of division by (x - z), remainder dropped, via the closed
    form q_i = z^-(i+1) * sum_{j >= i+1} c_j z^j: coeffs (*batch, n, *elem),
    zp and zinvp = z^-1 (*batch, *elem) -> (*batch, n - 1, *elem).
    Requires z != 0 (callers take the host path on the zero challenge)."""
    ax = _n_axis(k, coeffs)
    n = coeffs.shape[ax]
    pw = powers(k, zp, n)                        # z^0 .. z^(n-1)
    suf = suffix_sums(k, k.mul(coeffs, pw))      # T_i = sum_{j>=i} c_j z^j
    ipw = powers(k, zinvp, n - 1)                # zinv^0 .. zinv^(n-2)
    inv_pw = k.mul(ipw, zinvp.unsqueeze(ax).expand_as(ipw))
    return k.mul(suf.narrow(ax, 1, n - 1), inv_pw)


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
