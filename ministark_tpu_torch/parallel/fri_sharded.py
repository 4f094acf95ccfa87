"""Sharded FRI rounds over a mesh.

Port of ``ministark_tpu/parallel/fri_sharded.py``. Rank r works on the
contiguous block [r*m, (r+1)*m) of the n coefficients (m = n / D even, a
power of two), and one round decomposes as:

  fold:    local strided combine e + alpha*o            (no communication);
           the fold of block [lo, lo+m) is the block [lo/2, lo/2+m/2) of
           the result, so the folded coefficients stay resident
  deep:    local partial sums at stride 2 from the block's start, one
           field-exact gather
  divide:  division by (x - z) from the block's total and one gather of
           the totals

Both are ``ops/div_scan.py``'s (the kernels on the card): with c_j the
block's coefficients and start = r*m, the block's total is
pow_dot(c, z, start) = sum_j c_j z^(start+j), and rank r's block of the
quotient is div_scan(c, z, zinv, start, carry=E_r) with E_r the sum of the
later ranks' totals: q_g = z^-(start+g+1) * (E_r + sum_(j > g) c_j
z^(start+j)). The output keeps the input length with a trailing zero (q
has degree n - 2: the last rank's block ends in a slot with nothing above
it). It takes a batch of rows, each with its own z: the query quotients of
a round divide Q polynomials by Q lines' roots at once; with ``fold`` it
divides the fold of a block of 2m coefficients, the FRI round's fold and
division in one scan.

``get_block_fri_fns`` are the resident prove's: blocks in, blocks out (deep
returns the replicated pair). ``get_sharded_fri_fns`` wrap them for the
whole tensor on every rank (``parallel/__init__.py``): slice the rank's
block, call the block form, gather. Exact: the same values as one device.
"""

from __future__ import annotations

import torch

from ..ops.div_scan import div_scan, pow_dot
from ..ops.field import FieldOps, get_ops
from ..ops.poly import field_sum, fold_even_odd
from .mesh import Mesh, Rows, all_gather_rows, field_sum_over_ranks


def _mask(k: FieldOps, mask_1d, a):
    """a where mask_1d (along axis 0), else zero."""
    m = mask_1d.reshape(mask_1d.shape + (1,) * (a.dim() - 1))
    return torch.where(m, a, torch.zeros_like(a))


def make_block_fri_fns(field, n: int, mesh: Mesh):
    """{"fold", "deep", "divide"} on this rank's block of m = n / D rows of
    (n, *elem) coefficients of the extension ``field``:

      fold(block, alpha)      -> (m/2, *elem): its block of the n/2 folded
      deep(block, z)          -> (fe, fo), the even/odd halves at z, whole
      divide(block, z, zinv, head=None, fold=None)
                              -> (*batch, m, *elem): its block of the
                                 quotient by (x - z), trailing slot zero;
                                 block (*batch, m, *elem), or 2m rows
                                 folded by ``fold`` = alpha; z and zinv =
                                 1/z (*batch, *elem); ``head`` (*batch, H,
                                 *elem), H <= m, subtracted at x^0..x^(H-1)
                                 (on rank 0's block)

    with alpha, z and zinv packed scalars (*elem) where no batch is given."""
    k = get_ops(field)
    D, r = mesh.size, mesh.rank
    if n % D or (n // D) % 2:
        raise ValueError(f"{n} coefficients do not split into even blocks over {D} ranks")
    m = n // D
    assert m & (m - 1) == 0, "local block must be a power of two"
    nd = len(k.elem_axes)

    def check(block, ax, rows=m):
        if block.shape[ax] != rows:
            raise ValueError(f"expected a block of {rows} rows, got {block.shape[ax]}")

    def fold(block, alpha):
        check(block, 0)
        return fold_even_odd(k, block, alpha)

    def deep(block, z):
        check(block, 0)
        # the local even coefficients have global even ranks r*m/2 + j
        parts = pow_dot(k, block.unsqueeze(0), z.unsqueeze(0), r * m // 2, parts=2)[0]
        fe, fo = field_sum_over_ranks(k, mesh, parts)
        return fe, fo

    def divide(block, z, zinv, head=None, fold=None):
        one = block.dim() == 1 + nd                     # no batch axis
        if one:
            block, z, zinv = block.unsqueeze(0), z.unsqueeze(0), zinv.unsqueeze(0)
            head = None if head is None else head.unsqueeze(0)
        check(block, 1, m if fold is None else 2 * m)
        if head is not None and head.shape[1] > m:
            raise ValueError(f"a head of {head.shape[1]} coefficients spans blocks of {m}")
        start = r * m
        # this block's sum_j c'_j z^(start+j); rank 0's, the one the head
        # changes, joins no carry
        if fold is None:
            total = pow_dot(k, block, z, start)
        else:
            halves = pow_dot(k, block, z, start, parts=2)
            even, odd = halves[:, 0], halves[:, 1]
            total = k.add(even, k.mul(odd, fold.expand_as(odd)))
        # the later ranks' totals: E_r = sum_(s > r) total_s
        totals = all_gather_rows(mesh, total)                  # (D, B, *elem)
        later = torch.arange(D, device=block.device) > r
        e_r = field_sum(k, _mask(k, later, totals), axis=0)
        q = div_scan(k, block, z, zinv, start, e_r, head, fold)
        return q[0] if one else q

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
