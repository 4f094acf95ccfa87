"""Sharded NTT over a mesh by the four-step (Bailey) split.

Port of ``ministark_tpu/parallel/ntt_sharded.py``. For N = N1 * N2 with
the input viewed column-major as A[i1][i2] = x[i1 + N1*i2], rank r owns
rows i1 in [i0, i0 + N1/D), i0 = r * N1/D:

  a. its rows of A
  b. a length-N2 NTT of every local row (the port's NTT, ops/ntt.py: the
     ``ms_ntt_gl`` / ``ms_ntt_bb`` kernel on a card)
  c. the twiddle multiply by W[i][k2] = w_N^((i0+i) * k2), rows built on
     the device from i0 (one ``gl_mul`` on a Goldilocks card)
  d. one ``all_to_all`` transposes the matrix, then a length-N1 NTT of
     every row k2 it now owns

giving E[k2][k1] = X[k2 + N2*k1], rows k2 owned in blocks of N2/D. The
inverse runs both NTTs inverse: their 1/N2 and 1/N1 make 1/N. A coset's
powers fold into the NTTs and the twiddle rows: s^(i1 + N1*i2) is the
N2-NTT's own coset ``pre`` s^N1 times the row factor s^i1, and the
inverse's s'^(k2 + N2*k1) is the N1-NTT's ``post`` s'^N2 times the column
factor s'^k2, both multiplied into W (a row or column factor commutes with
the transform along the other axis).

Three forms share steps b-d (``_FourStep``):

* Block form (``get_block_ntt_fns``), the resident prove's: rank r holds
  the natural-order block [r*n/D, (r+1)*n/D) of the output and
  [r*n_in/D, (r+1)*n_in/D) of the input. Its rows i2 of A are a block, so
  step a is an ``all_to_all`` of column blocks; the output E is owned by
  k2-blocks, so one more ``all_to_all`` turns it into natural blocks of
  k1 (the reshards the JAX package gets from XLA around its
  ``shard_map``, ``ministark_tpu/parallel/ntt_sharded.py:147-155``). An
  input of n_in = n / B points (B a power of two: the LDE's zero padding)
  is taken in by the first ``all_to_all``: only rows i2 < N2/B exist, so
  the padded tail is never built, on any rank.
* Coset-row block form (``get_block_coset_ntt_fns``), the resident fast
  mode's LDE (``fri/batched.py``): the input as in the block form, the
  output the fast mode's coset rows, row i holding the points {i +
  t*n/F : t < F}, rank r its rows [r*n/(F*D), (r+1)*n/(F*D)). When F*D
  divides N1 (``block_coset_fits``), row i = k2 + N2*k1' at coset t is
  column k1 = t*N1/F + k1', so rank r's rows are the columns t*N1/F +
  r*N1/(F*D) + [0, N1/(F*D)) of every t: one ``all_to_all``, as the block
  form's, with another column map. Where F*D does not divide N1 the rows
  would need a second exchange; the stage is then not resident.
* Replicated form (``get_sharded_ntt_fns``), the signatures of
  ``ops/ntt.py::get_ntt_fns``: the whole (batch, n) tensor on every rank,
  whose strided rows of A are a slice (no communication), and one
  ``all_gather`` of E that makes the output whole on every rank.

Coset offsets are host scalars. Steps b and d take the caller's NTT
backend; a sub-transform outside a backend's range runs radix-2, as on one
device. Exact: the same values as one device (tests/test_torch_sharded.py,
tests/test_torch_resident.py).
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


def block_ntt_fits(n: int, n_in: int, n_dev: int) -> bool:
    """True when the block transform of size n takes (batch, n_in / D)
    blocks: n is a power of two that splits (``can_shard``), n_in divides
    it by a power of two B, and every rank's input block is whole rows i2
    of A (N2 divisible by B * D)."""
    if n & (n - 1) or not can_shard(n, n_dev) or n_in <= 0 or n % n_in:
        return False
    b = n // n_in
    return b & (b - 1) == 0 and _split_sizes(n, n_dev)[1] % (b * n_dev) == 0


def block_coset_fits(n: int, n_in: int, F: int, n_dev: int) -> bool:
    """True when the coset-row block transform of size n takes (batch,
    n_in / D) blocks and gives each rank its n/(F*D) coset rows in one
    ``all_to_all``: ``block_ntt_fits`` and F*D dividing N1."""
    return block_ntt_fits(n, n_in, n_dev) and _split_sizes(n, n_dev)[0] % (F * n_dev) == 0


class _FourStep:
    """Steps b-d of the size-n transform over ``mesh``, between this
    rank's rows of A (``rows_of_whole`` / ``rows_of_block``) and its rows
    k2 of E (``whole`` / ``block``)."""

    def __init__(self, field, n: int, mesh: Mesh, backend: str):
        ntt_field(field)
        check_backend(backend)
        self.field, self.n, self.mesh = field, n, mesh
        self.kb = get_ops(field)
        D = mesh.size
        self.n1, self.n2 = _split_sizes(n, D)
        assert self.n2 % D == 0, (
            f"four-step column count {self.n2} must divide over {D} devices")
        self.n1_loc, self.n2_loc = self.n1 // D, self.n2 // D
        self.i0 = mesh.rank * self.n1_loc
        self.sub1 = get_ntt_fns(field, self.n1, backend)
        self.sub2 = get_ntt_fns(field, self.n2, backend)
        self._w = {}

    def twiddles(self, inverse: bool) -> torch.Tensor:
        """This rank's (N1/D, N2) rows root^((i0+i) * k2)."""
        if inverse not in self._w:
            field = self.field
            root = field.get_root_of_unity(self.n)
            if inverse:
                root = field.inv(root)
            self._w[inverse] = _twiddle_rows(self.kb, _offset_powers(
                self.kb, field, root, self.i0, self.n1_loc, self.mesh.device), self.n2)
        return self._w[inverse]

    def rows_of_whole(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, n) whole -> this rank's rows of A[i1][i2] = x[i1 + N1*i2]
        as (batch * N1/D, N2): a strided slice, no communication."""
        batch = x.shape[0]
        assert x.shape[1:] == (self.n,), f"expected (batch, {self.n}), got {tuple(x.shape)}"
        a = x.reshape(batch, self.n2, self.n1)[:, :, self.i0:self.i0 + self.n1_loc]
        return a.transpose(1, 2).reshape(batch * self.n1_loc, self.n2).contiguous()

    def rows_of_block(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, n_in/D) natural-order blocks of an input of n_in = n/B
        points (zero past n_in) -> this rank's rows of A, by one
        ``all_to_all``. Rank s's block is rows i2 in [s*R, (s+1)*R) of A,
        R = N2/(B*D), every column i1; column block t of it goes to rank t.
        Rows i2 >= N2/B are the padding: zeros made here, never sent."""
        batch, width = x.shape
        D, n1_loc, n2 = self.mesh.size, self.n1_loc, self.n2
        if not block_ntt_fits(self.n, width * D, D):
            raise ValueError(f"a block of {width} points does not fit the size-"
                             f"{self.n} transform over {D} ranks")
        r = n2 // (self.n // (width * D) * D)
        c = x.reshape(batch, r, D, n1_loc).permute(2, 0, 1, 3)
        got = all_to_all_rows(self.mesh, c)                  # (D[s], batch, R, N1/D)
        a = got.permute(1, 3, 0, 2).reshape(batch, n1_loc, D * r)
        if D * r < n2:
            a = torch.cat([a, a.new_zeros((batch, n1_loc, n2 - D * r))], 2)
        return a.reshape(batch * n1_loc, n2).contiguous()

    def steps(self, a: torch.Tensor, batch: int, inverse=False, pre=None, post=None):
        """Steps b-d on this rank's rows of A -> its rows k2 of E, as
        (batch * N2/D, N1)."""
        kb, field, dev = self.kb, self.field, self.mesh.device
        D, n1, n2, n1_loc, n2_loc = self.mesh.size, self.n1, self.n2, self.n1_loc, self.n2_loc
        w = self.twiddles(inverse)
        if pre is not None:           # row factor s^(i0+i)
            w = kb.mul(w, _offset_powers(kb, field, pre, self.i0, n1_loc, dev)[:, None])
        if post is not None:          # column factor s'^k2
            w = kb.mul(w, _offset_powers(kb, field, post, 0, n2, dev)[None])
        # each step rebinds ``a``, so a rank holds at most two stage tensors
        # besides the collective's buffers
        # b. length-N2 NTT per local row (with the coset's s^N1 powers)
        if inverse:
            a = self.sub2[1](a)
        elif pre is not None:
            a = self.sub2[2](a, field.pow(pre, n1))
        else:
            a = self.sub2[0](a)
        # c. twiddle multiply
        a = kb.mul(a.reshape(batch, n1_loc, n2), w)
        # d. the transpose, one all_to_all: all_to_all_single splits dim 0,
        # so the column blocks k2 = t*N2/D + j go to the front (rank t);
        # block s received holds rows i1 = s*N1/D + i of this rank's columns
        a = all_to_all_rows(self.mesh, a.reshape(batch, n1_loc, D, n2_loc).permute(2, 0, 1, 3))
        a = a.permute(1, 3, 0, 2).reshape(batch * n2_loc, n1).contiguous()
        # length-N1 NTT per row k2 (with the inverse coset's s'^N2 powers)
        if not inverse:
            return self.sub1[0](a)
        if post is not None:
            return self.sub1[3](a, field.pow(post, n2))
        return self.sub1[1](a)

    def whole(self, e: torch.Tensor, batch: int) -> torch.Tensor:
        """Rows k2 of E, X[k2 + N2*k1] -> the natural-order (batch, n) on
        every rank: one ``all_gather``."""
        g = all_gather_rows(self.mesh, e.reshape(batch, self.n2_loc, self.n1))
        return g.permute(1, 3, 0, 2).reshape(batch, self.n)

    def block(self, e: torch.Tensor, batch: int) -> torch.Tensor:
        """Rows k2 of E -> this rank's natural-order block (batch, n/D),
        points [t*n/D, (t+1)*n/D) = columns k1 in [t*N1/D, (t+1)*N1/D):
        column block t goes to rank t, one ``all_to_all``."""
        D, n1_loc, n2_loc = self.mesh.size, self.n1_loc, self.n2_loc
        c = e.reshape(batch, n2_loc, D, n1_loc).permute(2, 0, 1, 3)
        got = all_to_all_rows(self.mesh, c)                  # (D[s], batch, N2/D, N1/D)
        return got.permute(1, 3, 0, 2).reshape(batch, n1_loc * self.n2)


    def coset_rows(self, e: torch.Tensor, batch: int, F: int) -> torch.Tensor:
        """Rows k2 of E -> this rank's coset rows (n/(F*D), batch, F): row
        j holds X[i + t*n/F] of every batch row at column t, i = r*n/(F*D)
        + j. Columns k1 = t*N1/F + s*N1/(F*D) + c go to rank s, one
        ``all_to_all``; a received block from rank s holds the rows k2 in
        [s*N2/D, (s+1)*N2/D), and row i = k2 + N2*(r*N1/(F*D) + c)."""
        D, n2_loc, n2 = self.mesh.size, self.n2_loc, self.n2
        c_len = self.n1 // (F * D)
        if c_len * F * D != self.n1:
            raise ValueError(f"coset rows of {F} do not split the size-{self.n} "
                             f"transform over {D} ranks")
        c = e.reshape(batch, n2_loc, F, D, c_len).permute(3, 0, 1, 2, 4)
        got = all_to_all_rows(self.mesh, c)          # (D[s], batch, N2/D, F, c)
        return got.permute(4, 0, 2, 1, 3).reshape(c_len * n2, batch, F)


def _four_fns(t: _FourStep, rows_in, out):
    """(fft, ifft, coset_fft, coset_ifft) through ``t`` from ``rows_in``
    to ``out``."""

    def run(x, **kw):
        return out(t.steps(rows_in(x), x.shape[0], **kw), x.shape[0])

    def fft(x):
        return run(x)

    def ifft(x):
        return run(x, inverse=True)

    def coset_fft(x, offset):
        return run(x, pre=int(offset))

    def coset_ifft(x, offset_inv):
        return run(x, inverse=True, post=int(offset_inv))

    return fft, ifft, coset_fft, coset_ifft


def make_sharded_ntt_fns(field, n: int, mesh: Mesh, backend: str = "radix2"):
    """(fft, ifft, coset_fft, coset_ifft) for size n over ``mesh``, the
    whole (batch, n) tensor in and out on every rank."""
    t = _FourStep(field, n, mesh, backend)
    return _four_fns(t, t.rows_of_whole, t.whole)


def make_block_ntt_fns(field, n: int, mesh: Mesh, backend: str = "radix2"):
    """(fft, ifft, coset_fft, coset_ifft) for size n over ``mesh`` on
    blocks: (batch, n_in/D) in, rank r's points [r*n_in/D, (r+1)*n_in/D)
    of an input zero past n_in (n_in = n unless ``block_ntt_fits`` allows
    a padded one), (batch, n/D) out, its points [r*n/D, (r+1)*n/D)."""
    t = _FourStep(field, n, mesh, backend)
    return _four_fns(t, t.rows_of_block, t.block)


def make_block_coset_ntt_fns(field, n: int, F: int, mesh: Mesh, backend: str = "radix2"):
    """(fft, ifft, coset_fft, coset_ifft) for size n over ``mesh`` from the
    block form's (batch, n_in/D) input blocks to this rank's coset rows
    (n/(F*D), batch, F) (``block_coset_fits``)."""
    t = _FourStep(field, n, mesh, backend)
    return _four_fns(t, t.rows_of_block, lambda e, batch: t.coset_rows(e, batch, F))


_FN_CACHE: dict = {}


def get_sharded_ntt_fns(field, n: int, mesh: Mesh, backend: str = "radix2"):
    """Cached ``make_sharded_ntt_fns``: one set (and one pair of twiddle
    row tables) per (field, size, mesh, backend)."""
    key = ("whole", field.p, n, mesh, backend)
    if key not in _FN_CACHE:
        _FN_CACHE[key] = make_sharded_ntt_fns(field, n, mesh, backend)
    return _FN_CACHE[key]


def get_block_ntt_fns(field, n: int, mesh: Mesh, backend: str = "radix2"):
    """Cached ``make_block_ntt_fns``."""
    key = ("block", field.p, n, mesh, backend)
    if key not in _FN_CACHE:
        _FN_CACHE[key] = make_block_ntt_fns(field, n, mesh, backend)
    return _FN_CACHE[key]


def get_block_coset_ntt_fns(field, n: int, F: int, mesh: Mesh, backend: str = "radix2"):
    """Cached ``make_block_coset_ntt_fns``."""
    key = ("coset_rows", field.p, n, F, mesh, backend)
    if key not in _FN_CACHE:
        _FN_CACHE[key] = make_block_coset_ntt_fns(field, n, F, mesh, backend)
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
