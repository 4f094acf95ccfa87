"""The mesh of a sharded prove, and its two collectives.

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
faster than copying them through host memory. A backend that refuses a
tensor raises; nothing falls back.

The collectives only move bytes, so a field value crosses them exactly; a
field sum across ranks is a gather and ``ops/poly.py::field_sum``, never
``all_reduce(SUM)``, which would wrap int64.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

AXIS = "shards"

# Incremented once per collective a rank calls, by kind.
collectives = {"all_to_all": 0, "all_gather": 0}


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
    collectives["all_to_all"] += 1
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return out


# torch 2.13 renamed all_gather_into_tensor (the name older releases have)
_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(...) on every rank -> (D, ...), row s from rank s. One
    ``all_gather_into_tensor`` into the concatenated form (gloo's only)."""
    collectives["all_gather"] += 1
    src = x.contiguous().reshape((1,) + tuple(x.shape))
    out = src.new_empty((mesh.size,) + tuple(x.shape))
    _gather(out, src, group=mesh.group)
    return out
