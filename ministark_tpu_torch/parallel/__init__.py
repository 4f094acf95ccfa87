"""Sharded proving over several ranks (port of ``ministark_tpu/parallel/``).

Programming model: SPMD, one process per rank, on ``torch.distributed``.

* Every rank runs the same ``prove()`` on the same inputs. The Fiat-Shamir
  transcript and every host scalar are replicated: each rank draws the
  same challenges from the same roots, and every rank returns the proof,
  byte for byte the proof of one device.
* A ``Mesh`` (``mesh.py``) is a small frozen object: the process group, the
  rank, the group's size and the rank's ``torch.device``. ``make_mesh``
  builds it from an initialised group; ``launch.run`` starts a group of
  processes and runs a function on each with its mesh. The backend is the
  caller's: ``nccl`` for ranks with a card each, ``gloo`` for CPU ranks and
  for ranks that share one card.
* Module boundary: the signatures of one device, replicated in and out. A
  sharded function (``ntt_sharded``, ``fri_sharded``, ``merkle_sharded``,
  ``commit/index_tree.py``'s sharded build) takes the whole tensor on every
  rank, computes the rank's share with the port's kernels, does the
  collectives of the JAX body, and ends with one gather that makes the
  result whole on every rank. Callers only choose where to dispatch, by
  the JAX package's size rules (``select_ntt_fns``, ``can_shard_tree``,
  the engine's ``_fri_sharded``). A rank's memory holds one device's data;
  keeping data row-sharded from stage to stage is later work.
* Exactness: collectives only move bytes (``all_to_all_single``,
  ``all_gather_into_tensor``); a field sum across ranks is a gather and
  ``ops/poly.py::field_sum``, never ``all_reduce(SUM)`` on field values.
* Every rank calls the same collectives in the same order, so every rank
  calls the same entry points alike: ``prove``, and ``verify`` where the
  caller verifies (the verifier's own iFFT of the constraints is sharded
  too). The launcher's timeout turns a rank that strays (and so a hang)
  into an error.

Use: inside each rank, ``DeviceEngine(config, device=mesh.device,
mesh=mesh)`` or ``FastStark(config, device=mesh.device, mesh=mesh)``; the
``mesh=`` argument also goes to ``BatchedFri``, ``Stir``, ``Whir``,
``PackedMerkleTree`` and ``IndexMerkleTree``.
"""

from .fri_sharded import get_sharded_fri_fns, make_sharded_fold_fns, make_sharded_fri_fns
from .mesh import Mesh, default_axis, make_mesh
from .merkle_sharded import can_shard_tree, sharded_tree_digests
from .ntt_sharded import (
    can_shard,
    get_sharded_ntt_fns,
    make_sharded_ntt_fns,
    select_ntt_fns,
    sharded_lde,
)

__all__ = [
    "Mesh", "make_mesh", "default_axis", "make_sharded_ntt_fns", "sharded_lde",
    "can_shard", "get_sharded_ntt_fns", "select_ntt_fns", "get_sharded_fri_fns",
    "make_sharded_fri_fns", "make_sharded_fold_fns", "can_shard_tree", "sharded_tree_digests",
]
