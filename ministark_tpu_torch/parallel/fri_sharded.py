"""Sharded FRI rounds over a mesh.

Port of ``ministark_tpu/parallel/fri_sharded.py``. Rank r works on the
contiguous block [r*m, (r+1)*m) of the n coefficients (m = n / D even, a
power of two), and one round decomposes as:

  fold:    local strided combine e + alpha*o            (no communication)
  deep:    local partial ladder sums, one field-exact gather
  divide:  division by (x - z) from local suffix sums and one gather of
           the block totals

The division uses the closed form of the single-device code
(``ops/poly.py::synth_div_suffix``):

  q_i = z^-(i+1) * T_(i+1),   T_i = sum_(j >= i) c_j z^j

rank r adds to its local suffix sums the exclusive suffix of the later
ranks' block totals. The output keeps the input length with a trailing
zero (q has degree n - 2; slot n - 1 is z^-n * T_n = 0). As every sharded
function of the port, each takes the whole tensor on every rank and
returns it whole (``parallel/__init__.py``): fold and divide end with one
gather of the local results. Exact: the same values as one device.
"""

from __future__ import annotations

import torch

from ..ops.field import FieldOps, get_ops
from ..ops.poly import field_sum, fold_even_odd, powers, suffix_sums
from .mesh import Mesh, all_gather_rows


def _pow2_chain(k: FieldOps, x, e: int):
    """x^e for a power-of-two e by repeated squaring."""
    assert e & (e - 1) == 0 and e >= 1
    for _ in range(e.bit_length() - 1):
        x = k.mul(x, x)
    return x


def _mask(k: FieldOps, mask_1d, a):
    """a where mask_1d (along axis 0), else zero."""
    m = mask_1d.reshape(mask_1d.shape + (1,) * (a.dim() - 1))
    return torch.where(m, a, torch.zeros_like(a))


def _dot(k: FieldOps, a, b):
    return field_sum(k, k.mul(a, b), axis=0)


def _allreduce_field(k: FieldOps, x, mesh: Mesh):
    """Field sum of x across the ranks: a gather and a field sum (an int64
    all_reduce would wrap)."""
    return field_sum(k, all_gather_rows(mesh, x), axis=0)


def _offset_ladder(k: FieldOps, x, count: int, block: int, rank: int):
    """[x^(rank*block) .. x^(rank*block + count - 1)] for a power-of-two
    block: the rank's powers of x, its offset raised on the device."""
    off = k.pow(_pow2_chain(k, x, block), rank)
    pw = powers(k, x, count)
    return k.mul(pw, off.expand_as(pw))


def make_sharded_fri_fns(field, n: int, mesh: Mesh):
    """{"fold", "deep", "divide"} for (n, *elem) coefficient tensors of the
    extension ``field``:

      fold(coeffs, alpha)      -> (n/2, *elem) folded coefficients
      deep(coeffs, z)          -> (fe, fo), the even/odd halves at z
      divide(coeffs, z, zinv)  -> (n, *elem) quotient of the division by
                                  (x - z), trailing slot zero

    with alpha, z and zinv = 1/z packed scalars (*elem)."""
    k = get_ops(field)
    D, r = mesh.size, mesh.rank
    assert n % D == 0 and (n // D) % 2 == 0
    m = n // D
    assert m & (m - 1) == 0, "local block must be a power of two"
    lo = r * m

    def fold(coeffs, alpha):
        out = fold_even_odd(k, coeffs[lo:lo + m], alpha)
        return all_gather_rows(mesh, out).reshape((n // 2,) + tuple(out.shape[1:]))

    def deep(coeffs, z):
        # the local even coefficients have global even ranks r*m/2 + j
        local = coeffs[lo:lo + m]
        pw_off = _offset_ladder(k, z, m // 2, m // 2, r)
        parts = torch.stack([_dot(k, local[0::2], pw_off), _dot(k, local[1::2], pw_off)])
        fe, fo = _allreduce_field(k, parts, mesh)
        return fe, fo

    def divide(coeffs, z, zinv):
        # t_j = c_j * z^(r*m + j) for local j
        t = k.mul(coeffs[lo:lo + m], _offset_ladder(k, z, m, m, r))
        s_loc = suffix_sums(k, t)                      # local inclusive suffix
        # exclusive suffix of the later ranks' totals: E_r = sum_(s > r) total_s
        totals = all_gather_rows(mesh, s_loc[0])       # (D, *elem)
        later = torch.arange(D, device=coeffs.device) > r
        e_r = field_sum(k, _mask(k, later, totals), axis=0)
        # T_(g+1) for local j: the local suffix shifted left by one, plus E_r
        shifted = k.add(torch.cat([s_loc[1:], torch.zeros_like(s_loc[:1])], 0),
                        e_r.expand_as(s_loc))
        # q_g = zinv^(g+1) * T_(g+1), zinv^(g+1) = zinv^(r*m) * zinv^(j+1)
        pwi = _offset_ladder(k, zinv, m + 1, m, r)[1:]
        return all_gather_rows(mesh, k.mul(shifted, pwi)).reshape(coeffs.shape)

    return {"fold": fold, "deep": deep, "divide": divide}


def make_sharded_fold_fns(field, n: int, mesh: Mesh):
    """(fold, deep) of ``get_sharded_fri_fns``: the pair the dry run
    (``entry.py``) drives, as ``ministark_tpu/parallel/fri_sharded.py:156``."""
    fns = get_sharded_fri_fns(field, n, mesh)
    return fns["fold"], fns["deep"]


_FN_CACHE: dict = {}


def get_sharded_fri_fns(field, n: int, mesh: Mesh):
    key = (field.p, field.extension_degree, n, mesh)
    if key not in _FN_CACHE:
        _FN_CACHE[key] = make_sharded_fri_fns(field, n, mesh)
    return _FN_CACHE[key]
