"""The mesh of a sharded prove, its collectives, and a rank's block of rows.

Port of ``ministark_tpu/parallel/mesh.py``. The JAX package's mesh is a
``jax.sharding.Mesh`` over the devices of one process; here a rank is a
process (``parallel/__init__.py`` says why), and a ``Mesh`` names what
that process needs to take part: its process group, its rank, the group's
size and the ``torch.device`` its tensors live on. One axis, named
``default_axis()``, as in the JAX package.

The backend is the caller's: ``nccl`` for ranks with a card each, ``gloo``
for CPU ranks and for ranks that share one card (NCCL refuses two ranks on
one GPU). Nothing here picks one. gloo takes the card's tensors as they
are: ``scripts/torch_dist_probe.py`` found all three collectives exact on
int64 CUDA tensors with two ranks on one H100 (torch 2.11, CUDA 12.8), and
faster than copying them through host memory; BabyBear's int32 tensors
cross the same collectives (the card's sharded cases in
``chip_smoke.py`` and ``tests/test_torch_cuda.py``). A backend that
refuses a tensor raises; nothing falls back.

The collectives only move bytes, so a field value crosses them exactly; a
field sum across ranks is a gather and ``ops/poly.py::field_sum``, never
``all_reduce(SUM)``, which would wrap int64. Rows that live on one rank
reach the others by ``owner_select`` (one gather, the owner's row picked by
its index); a tensor too large for one device leaves by
``gather_to_host``, in chunks.

``collectives`` counts the calls a rank makes by kind and ``received`` the
bytes that reached it from the other ranks. ``opening`` is the kind of what
the proof itself carries (codeword reads, path digests, leaf groups, query
quotients), gathered from the ranks that own it; ``halo`` the previous
rank's last coefficients that a block's shifted products read (STIR's
degree correction).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops.poly import field_sum

AXIS = "shards"

KINDS = ("all_to_all", "all_gather", "opening", "halo")
# Incremented once per collective a rank calls, by kind ...
collectives = dict.fromkeys(KINDS, 0)
# ... and by the bytes that reached the rank from the others in it.
received = dict.fromkeys(KINDS, 0)
# The most bytes one chunk of ``gather_to_host`` holds on the device.
HOST_CHUNK_BYTES = 1 << 26


def default_axis() -> str:
    return AXIS


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a 1-D mesh. Compared and hashed by identity, so
    the per-mesh caches of the sharded functions never mix two groups."""

    group: object            # torch.distributed process group (None: default)
    rank: int
    size: int
    device: torch.device
    backend: str             # "nccl" or "gloo"


def make_mesh(group=None, device="cuda") -> Mesh:
    """The mesh of an initialised process group (the default group unless
    ``group`` is given), with this rank's tensors on ``device``. Raises if
    the device does not exist or the backend cannot carry its tensors."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    torch.empty(0, device=device)           # fails here when there is no card
    backend = dist.get_backend(group)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an nccl group carries CUDA tensors only")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), device,
                backend)


def all_to_all_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(D, ...) -> (D, ...): row j goes to rank j, row s of the result came
    from rank s. One ``all_to_all_single``."""
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all_rows: {x.shape[0]} rows for {mesh.size} ranks")
    src = x.contiguous()
    _count("all_to_all", src[0].nbytes * (mesh.size - 1))
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return out


def _count(kind: str, nbytes: int):
    collectives[kind] += 1
    received[kind] += nbytes


# torch 2.13 renamed all_gather_into_tensor (the name older releases have)
_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_rows(mesh: Mesh, x: torch.Tensor, kind: str = "all_gather") -> torch.Tensor:
    """(...) on every rank -> (D, ...), row s from rank s. One
    ``all_gather_into_tensor`` into the concatenated form (gloo's only),
    counted under ``kind`` (``all_gather``, ``opening`` or ``halo``)."""
    src = x.contiguous().reshape((1,) + tuple(x.shape))
    _count(kind, src.nbytes * (mesh.size - 1))
    out = src.new_empty((mesh.size,) + tuple(x.shape))
    _gather(out, src, group=mesh.group)
    return out


def owner_select(mesh: Mesh, rows: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
    """(q, ...) rows, each right on the rank ``owner`` (q,) names, ->
    the owners' rows on every rank (an ``opening``). A rank sends its own
    rows and zeros elsewhere; one gather, then row i is picked from rank
    owner[i]: a selection, never a sum."""
    mine = (owner == mesh.rank).reshape((-1,) + (1,) * (rows.dim() - 1))
    sent = torch.where(mine, rows, torch.zeros_like(rows))
    got = all_gather_rows(mesh, sent, "opening")                  # (D, q, ...)
    return got[owner, torch.arange(rows.shape[0], device=rows.device)]


def previous_rows(mesh: Mesh, block: torch.Tensor, m: int) -> torch.Tensor:
    """The previous rank's last ``m`` rows of its block (zeros on rank 0,
    whose block starts the axis): one gather of every rank's last rows, a
    ``halo``. The blocks hold at least ``m`` rows."""
    if block.shape[0] < m:
        raise ValueError(f"a block of {block.shape[0]} rows has no {m}-row halo")
    got = all_gather_rows(mesh, block[block.shape[0] - m:], "halo")
    return got[mesh.rank - 1] if mesh.rank else torch.zeros_like(got[0])


def gather_to_host(mesh: Mesh, block: torch.Tensor, count: int = None,
                   kind: str = "opening") -> torch.Tensor:
    """Every rank's (m, ...) block -> the (D * m, ...) whole on the host
    (a CPU tensor), block s at rows [s*m, (s+1)*m). Only each block's
    first ``count`` rows are gathered (the rest stay zero), in chunks of at
    most ``HOST_CHUNK_BYTES`` gathered bytes, so no device holds the whole.
    Every rank passes the same ``count``."""
    m = block.shape[0]
    count = m if count is None else max(0, min(count, m))
    rest = tuple(block.shape[1:])
    out = torch.zeros((mesh.size, m) + rest, dtype=block.dtype)
    row_bytes = max(block[:1].nbytes * mesh.size, 1)
    step = max(1, HOST_CHUNK_BYTES // row_bytes)
    for s in range(0, count, step):
        e = min(s + step, count)
        out[:, s:e] = all_gather_rows(mesh, block[s:e], kind).cpu()
    return out.reshape((mesh.size * m,) + rest)


def field_sum_over_ranks(k, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The field sum of x across the ranks (``k``: its ``FieldOps``): a
    gather and ``ops/poly.py::field_sum`` (an int64 all_reduce would
    wrap)."""
    return field_sum(k, all_gather_rows(mesh, x), axis=0)


def max_over_ranks(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of an int tensor across the ranks."""
    return all_gather_rows(mesh, x).amax(0)


def min_over_ranks(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum of an int tensor across the ranks."""
    return all_gather_rows(mesh, x).amin(0)


@dataclass(frozen=True)
class Rows:
    """A rank's block of an axis of length ``n``: the contiguous rows
    [lo, lo + count), count = n / D, of rank ``mesh.rank``. The resident
    prove holds every stage tensor so; a length that does not split over
    the mesh raises."""

    mesh: Mesh
    n: int

    def __post_init__(self):
        if self.n % self.mesh.size:
            raise ValueError(f"{self.n} rows do not split over {self.mesh.size} ranks")

    @property
    def count(self) -> int:
        return self.n // self.mesh.size

    @property
    def lo(self) -> int:
        return self.mesh.rank * self.count

    def take(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's rows of the whole ``t`` along ``axis``, as a copy."""
        if t.shape[axis] != self.n:
            raise ValueError(f"expected {self.n} rows on axis {axis}, got {t.shape[axis]}")
        return t.narrow(axis, self.lo, self.count).clone(memory_format=torch.contiguous_format)
