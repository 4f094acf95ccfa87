"""Sharded FRI rounds over a mesh.

Port of ``ministark_tpu/parallel/fri_sharded.py``. Rank r works on the
contiguous block [r*m, (r+1)*m) of the n coefficients (m = n / D even, a
power of two), and one round decomposes as:

  fold:    local strided combine e + alpha*o            (no communication);
           the fold of block [lo, lo+m) is the block [lo/2, lo/2+m/2) of
           the result, so the folded coefficients stay resident
  deep:    local partial ladder sums, one field-exact gather
  divide:  division by (x - z) from local suffix sums and one gather of
           the block totals

The division uses the closed form of the single-device code
(``ops/poly.py::synth_div_suffix``):

  q_i = z^-(i+1) * T_(i+1),   T_i = sum_(j >= i) c_j z^j

rank r adds to its local suffix sums the exclusive suffix of the later
ranks' block totals. The output keeps the input length with a trailing
zero (q has degree n - 2; slot n - 1 is z^-n * T_n = 0). It takes a batch
of rows, each with its own z: the query quotients of a round divide Q
polynomials by Q lines' roots at once.

``get_block_fri_fns`` are the resident prove's: blocks in, blocks out (deep
returns the replicated pair). ``get_sharded_fri_fns`` wrap them for the
whole tensor on every rank (``parallel/__init__.py``): slice the rank's
block, call the block form, gather. Exact: the same values as one device.
"""

from __future__ import annotations

import torch

from ..ops.field import FieldOps, get_ops
from ..ops.poly import field_sum, fold_even_odd, powers, suffix_sums
from .mesh import Mesh, Rows, all_gather_rows, field_sum_over_ranks


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


def _offset_ladder(k: FieldOps, x, count: int, block: int, rank: int):
    """[x^(rank*block) .. x^(rank*block + count - 1)] along a new
    coefficient axis, x (*batch, *elem) -> (*batch, count, *elem), for a
    power-of-two block: the rank's powers of x, its offset raised on the
    device."""
    off = k.pow(_pow2_chain(k, x, block), rank)
    pw = powers(k, x, count)
    ax = x.dim() - len(k.elem_axes)
    return k.mul(pw, off.unsqueeze(ax).expand_as(pw))


def make_block_fri_fns(field, n: int, mesh: Mesh):
    """{"fold", "deep", "divide"} on this rank's block of m = n / D rows of
    (n, *elem) coefficients of the extension ``field``:

      fold(block, alpha)      -> (m/2, *elem): its block of the n/2 folded
      deep(block, z)          -> (fe, fo), the even/odd halves at z, whole
      divide(block, z, zinv)  -> (*batch, m, *elem): its block of the
                                 quotient by (x - z), trailing slot zero;
                                 block (*batch, m, *elem), z and zinv = 1/z
                                 (*batch, *elem)

    with alpha, z and zinv packed scalars (*elem) where no batch is given."""
    k = get_ops(field)
    D, r = mesh.size, mesh.rank
    if n % D or (n // D) % 2:
        raise ValueError(f"{n} coefficients do not split into even blocks over {D} ranks")
    m = n // D
    assert m & (m - 1) == 0, "local block must be a power of two"

    def check(block, ax):
        if block.shape[ax] != m:
            raise ValueError(f"expected a block of {m} rows, got {block.shape[ax]}")

    def fold(block, alpha):
        check(block, 0)
        return fold_even_odd(k, block, alpha)

    def deep(block, z):
        check(block, 0)
        # the local even coefficients have global even ranks r*m/2 + j
        pw_off = _offset_ladder(k, z, m // 2, m // 2, r)
        parts = torch.stack([_dot(k, block[0::2], pw_off), _dot(k, block[1::2], pw_off)])
        fe, fo = field_sum_over_ranks(k, mesh, parts)
        return fe, fo

    def divide(block, z, zinv):
        ax = block.dim() - 1 - len(k.elem_axes)         # the coefficient axis
        check(block, ax)
        # t_j = c_j * z^(r*m + j) for local j
        t = k.mul(block, _offset_ladder(k, z, m, m, r))
        s_loc = suffix_sums(k, t)                      # local inclusive suffix
        # exclusive suffix of the later ranks' totals: E_r = sum_(s > r) total_s
        totals = all_gather_rows(mesh, s_loc.select(ax, 0))  # (D, *batch, *elem)
        later = torch.arange(D, device=block.device) > r
        e_r = field_sum(k, _mask(k, later, totals), axis=0)
        # T_(g+1) for local j: the local suffix shifted left by one, plus E_r
        shifted = torch.cat([s_loc.narrow(ax, 1, m - 1),
                             torch.zeros_like(s_loc.narrow(ax, 0, 1))], ax)
        shifted = k.add(shifted, e_r.unsqueeze(ax).expand_as(shifted))
        # q_g = zinv^(g+1) * T_(g+1), zinv^(g+1) = zinv^(r*m) * zinv^(j+1)
        pwi = _offset_ladder(k, zinv, m + 1, m, r).narrow(ax, 1, m)
        return k.mul(shifted, pwi)

    return {"fold": fold, "deep": deep, "divide": divide}


def make_sharded_fri_fns(field, n: int, mesh: Mesh):
    """{"fold", "deep", "divide"} for (n, *elem) coefficient tensors of the
    extension ``field``, whole on every rank:

      fold(coeffs, alpha)      -> (n/2, *elem) folded coefficients
      deep(coeffs, z)          -> (fe, fo), the even/odd halves at z
      divide(coeffs, z, zinv)  -> (n, *elem) quotient of the division by
                                  (x - z), trailing slot zero

    with alpha, z and zinv = 1/z packed scalars (*elem): the block forms
    on the rank's slice, gathered."""
    fns = get_block_fri_fns(field, n, mesh)
    rows = Rows(mesh, n)

    def whole(block):
        return all_gather_rows(mesh, block).reshape((-1,) + tuple(block.shape[1:]))

    def fold(coeffs, alpha):
        return whole(fns["fold"](rows.take(coeffs), alpha))

    def deep(coeffs, z):
        return fns["deep"](rows.take(coeffs), z)

    def divide(coeffs, z, zinv):
        return whole(fns["divide"](rows.take(coeffs), z, zinv))

    return {"fold": fold, "deep": deep, "divide": divide}


def make_sharded_fold_fns(field, n: int, mesh: Mesh):
    """(fold, deep) of ``get_sharded_fri_fns``: the pair the dry run
    (``entry.py``) drives, as ``ministark_tpu/parallel/fri_sharded.py:156``."""
    fns = get_sharded_fri_fns(field, n, mesh)
    return fns["fold"], fns["deep"]


_FN_CACHE: dict = {}


def _cached(make, field, n: int, mesh: Mesh):
    key = (make, field.p, field.extension_degree, n, mesh)
    if key not in _FN_CACHE:
        _FN_CACHE[key] = make(field, n, mesh)
    return _FN_CACHE[key]


def get_sharded_fri_fns(field, n: int, mesh: Mesh):
    return _cached(make_sharded_fri_fns, field, n, mesh)


def get_block_fri_fns(field, n: int, mesh: Mesh):
    return _cached(make_block_fri_fns, field, n, mesh)
