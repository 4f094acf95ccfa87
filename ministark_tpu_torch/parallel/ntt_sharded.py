"""Sharded NTT over a mesh by the four-step (Bailey) split.

Port of ``ministark_tpu/parallel/ntt_sharded.py``. For N = N1 * N2 with
the input viewed column-major as A[i1][i2] = x[i1 + N1*i2], rank r owns
rows i1 in [i0, i0 + N1/D), i0 = r * N1/D:

  a. its rows of A: a strided slice of the replicated input (no
     communication)
  b. a length-N2 NTT of every local row (the port's NTT, ops/ntt.py: the
     ``ms_ntt_gl`` / ``ms_ntt_bb`` kernel on a card)
  c. the twiddle multiply by W[i][k2] = w_N^((i0+i) * k2), rows built on
     the device from i0 (one ``gl_mul`` on a Goldilocks card)
  d. one ``all_to_all`` transposes the matrix, then a length-N1 NTT of
     every row k2 it now owns

giving E[k2][k1] = X[k2 + N2*k1]; one ``all_gather`` makes the natural
order output whole on every rank (``parallel/__init__.py``: replicated in
and out). The inverse runs both NTTs inverse: their 1/N2 and 1/N1 make
1/N. A coset's powers fold into the NTTs and the twiddle rows: s^(i1 +
N1*i2) is the N2-NTT's own coset ``pre`` s^N1 times the row factor s^i1,
and the inverse's s'^(k2 + N2*k1) is the N1-NTT's ``post`` s'^N2 times the
column factor s'^k2, both multiplied into W (a row or column factor
commutes with the transform along the other axis).

``get_sharded_ntt_fns(field, n, mesh, backend)`` -> (fft, ifft,
coset_fft, coset_ifft), the signatures of ``ops/ntt.py::get_ntt_fns``:
(batch, n) int64 tensors in natural order, coset offsets as host scalars.
Steps b and d take the caller's NTT backend; a sub-transform outside a
backend's range runs radix-2, as on one device. Exact: the same values as
one device (tests/test_torch_sharded.py).
"""

from __future__ import annotations

import torch

from ..ops.field import get_ops
from ..ops.ntt import check_backend, get_ntt_fns, ntt_field
from ..ops.poly import powers
from .mesh import Mesh, all_gather_rows, all_to_all_rows


def _split_sizes(n: int, n_dev: int):
    """Pick N1 (sharded row count, multiple of n_dev) and N2 = n // N1."""
    assert n_dev > 0 and n_dev & (n_dev - 1) == 0, (
        f"device count must be a power of two, got {n_dev}"
    )
    log_n = n.bit_length() - 1
    n1 = 1 << (log_n // 2)
    while n1 % n_dev != 0 and n1 <= n:
        n1 *= 2
    assert n1 <= n and n % n1 == 0, f"cannot split size {n} over {n_dev} devices"
    return n1, n // n1


def can_shard(n: int, n_dev: int) -> bool:
    """True when the four-step split supports this (size, device) pair."""
    if n_dev <= 1 or n_dev & (n_dev - 1):
        return False
    log_n = n.bit_length() - 1
    n1 = 1 << (log_n // 2)
    while n1 % n_dev != 0 and n1 <= n:
        n1 *= 2
    return n1 <= n and n % n1 == 0 and n // n1 >= n_dev


def _twiddle_rows(kb, row_bases: torch.Tensor, n2: int) -> torch.Tensor:
    """W[i, j] = row_bases[i]^j: (rows,) -> (rows, n2), by doubling
    (``ntt_device._twiddle_rows``)."""
    return powers(kb, row_bases, n2)


def _offset_powers(kb, field, s: int, start: int, count: int, device):
    """[s^start .. s^(start + count - 1)] on ``device``. The JAX body raises
    to the traced rank with ``_pow_traced``; here the rank is a host int."""
    return kb.mul(powers(kb, kb.pack_scalar(s, device), count),
                  kb.pack_scalar(field.pow(s, start), device))


def make_sharded_ntt_fns(field, n: int, mesh: Mesh, backend: str = "radix2"):
    """(fft, ifft, coset_fft, coset_ifft) for size n over ``mesh``."""
    ntt_field(field)
    check_backend(backend)
    kb = get_ops(field)
    D = mesh.size
    n1, n2 = _split_sizes(n, D)
    assert n2 % D == 0, f"four-step column count {n2} must divide over {D} devices"
    n1_loc, n2_loc = n1 // D, n2 // D
    i0 = mesh.rank * n1_loc
    dev = mesh.device
    sub1 = get_ntt_fns(field, n1, backend)
    sub2 = get_ntt_fns(field, n2, backend)
    W = {}

    def twiddles(inverse: bool) -> torch.Tensor:
        """This rank's (N1/D, N2) rows root^((i0+i) * k2)."""
        if inverse not in W:
            root = field.get_root_of_unity(n)
            if inverse:
                root = field.inv(root)
            W[inverse] = _twiddle_rows(
                kb, _offset_powers(kb, field, root, i0, n1_loc, dev), n2)
        return W[inverse]

    def transform(x, inverse=False, pre=None, post=None):
        batch = x.shape[0]
        assert x.shape[1:] == (n,), f"expected (batch, {n}), got {tuple(x.shape)}"
        w = twiddles(inverse)
        if pre is not None:           # row factor s^(i0+i)
            w = kb.mul(w, _offset_powers(kb, field, pre, i0, n1_loc, dev)[:, None])
        if post is not None:          # column factor s'^k2
            w = kb.mul(w, _offset_powers(kb, field, post, 0, n2, dev)[None])
        # a. this rank's rows of A[i1][i2] = x[i1 + N1*i2]
        a = x.reshape(batch, n2, n1)[:, :, i0:i0 + n1_loc].transpose(1, 2)
        a = a.reshape(batch * n1_loc, n2).contiguous()     # the kernel's layout
        # b. length-N2 NTT per local row (with the coset's s^N1 powers)
        if inverse:
            b = sub2[1](a)
        elif pre is not None:
            b = sub2[2](a, field.pow(pre, n1))
        else:
            b = sub2[0](a)
        # c. twiddle multiply
        c = kb.mul(b.reshape(batch, n1_loc, n2), w)
        # d. the transpose, one all_to_all: all_to_all_single splits dim 0,
        # so the column blocks k2 = t*N2/D + j go to the front (rank t);
        # block s received holds rows i1 = s*N1/D + i of this rank's columns
        c = c.reshape(batch, n1_loc, D, n2_loc).permute(2, 0, 1, 3)
        d = all_to_all_rows(mesh, c).permute(1, 3, 0, 2).reshape(batch * n2_loc, n1)
        d = d.contiguous()
        # length-N1 NTT per row k2 (with the inverse coset's s'^N2 powers)
        if not inverse:
            e = sub1[0](d)
        elif post is not None:
            e = sub1[3](d, field.pow(post, n2))
        else:
            e = sub1[1](d)
        # E[k2][k1] = X[k2 + N2*k1], rows k2 = s*N2/D + j from rank s
        g = all_gather_rows(mesh, e.reshape(batch, n2_loc, n1))
        return g.permute(1, 3, 0, 2).reshape(batch, n)

    def fft(x):
        return transform(x)

    def ifft(x):
        return transform(x, inverse=True)

    def coset_fft(x, offset):
        return transform(x, pre=int(offset))

    def coset_ifft(x, offset_inv):
        return transform(x, inverse=True, post=int(offset_inv))

    return fft, ifft, coset_fft, coset_ifft


_FN_CACHE: dict = {}


def get_sharded_ntt_fns(field, n: int, mesh: Mesh, backend: str = "radix2"):
    """Cached ``make_sharded_ntt_fns``: one set (and one pair of twiddle
    row tables) per (field, size, mesh, backend)."""
    key = (field.p, n, mesh, backend)
    if key not in _FN_CACHE:
        _FN_CACHE[key] = make_sharded_ntt_fns(field, n, mesh, backend)
    return _FN_CACHE[key]


def select_ntt_fns(field, n: int, mesh: Mesh = None, backend: str = "radix2"):
    """(fft, ifft, coset_fft, coset_ifft): sharded over ``mesh`` when one
    is given and the size splits over it, single-device otherwise. The one
    place the mesh-gating rule lives (engine, batched FRI and FastStark all
    route through here)."""
    if mesh is not None and can_shard(n, mesh.size):
        return get_sharded_ntt_fns(field, n, mesh, backend)
    return get_ntt_fns(field, n, backend)


def sharded_lde(field, coeffs: torch.Tensor, domain_size: int, mesh: Mesh,
                backend: str = "radix2") -> torch.Tensor:
    """Forward NTT of zero-padded (batch, m) coefficients over
    ``domain_size`` >= m using the mesh."""
    fft = get_sharded_ntt_fns(field, domain_size, mesh, backend)[0]
    m = coeffs.shape[1]
    if m < domain_size:
        pad = coeffs.new_zeros((coeffs.shape[0], domain_size - m))
        coeffs = torch.cat([coeffs, pad], 1)
    return fft(coeffs)
