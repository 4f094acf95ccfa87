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
* Residency (the parity prover's, ``DeviceEngine(..., mesh=mesh)``): rank
  r holds the rows [r*n/D, (r+1)*n/D) of every stage tensor of length n
  (``mesh.Rows``), its contiguous natural-order block, from the start of
  ``prove`` until a stage's size stops splitting by the JAX package's size
  rules (``block_ntt_fits``, ``can_shard_tree``, the engine's
  ``_fri_splits``); there the blocks are gathered once and every rank goes
  on with one device's code on the whole tensor. The block forms: ``get_block_ntt_fns`` (natural blocks in
  and out, an input of n/B points zero-padded to n taken in by its first
  ``all_to_all``), ``get_block_fri_fns`` (fold and divide block to block,
  deep to the replicated pair), ``block_tree_levels`` / ``tree_top`` and
  ``commit/packed_tree.py::BlockMerkleTree`` (local levels stay local, the
  D subtree roots are gathered, the top is replicated). What the proof
  carries comes from its owners: ``owner_select`` (one gather, the
  owner's row picked) for codeword reads, path digests and leaf groups,
  ``gather_to_host`` (in chunks, so no device holds the whole) for the
  query quotients. A rank's memory holds 1/D of each stage tensor, and
  the witness, which arrives whole.
* Replicated in and out: the fast mode (``FastStark``, ``fri/batched.py``,
  ``commit/index_tree.py``), STIR, WHIR, ``stark/core.py``'s sharded prove
  core and the verifier's iFFT keep the signatures of one device. Their
  sharded functions (``get_sharded_ntt_fns``, ``get_sharded_fri_fns``,
  ``sharded_tree_digests``, the index tree's sharded build) take the whole
  tensor on every rank, share the block forms' steps on the rank's share
  and end with one gather that makes the result whole on every rank.
  Callers choose where to dispatch by the same size rules
  (``select_ntt_fns``, ``can_shard_tree``).
* Exactness: collectives only move bytes (``all_to_all_single``,
  ``all_gather_into_tensor``); a field sum across ranks is a gather and
  ``ops/poly.py::field_sum`` (``field_sum_over_ranks``), never
  ``all_reduce(SUM)`` on field values. ``mesh.collectives`` counts each
  rank's calls by kind and ``mesh.received`` the bytes that reached it
  (``all_to_all``, ``all_gather``, and ``opening`` for what the proof
  carries).
* Every rank calls the same collectives in the same order, so every rank
  calls the same entry points alike: ``prove``, and ``verify`` where the
  caller verifies (the verifier's own iFFT of the constraints is sharded
  too). A block of the wrong size raises on every rank before any
  collective; an error that one rank finds after a gather (``LeafNotFound``
  after the leaf search) is found by every rank. The launcher's timeout
  turns a rank that strays (and so a hang) into an error.

Use: inside each rank, ``DeviceEngine(config, device=mesh.device,
mesh=mesh)`` or ``FastStark(config, device=mesh.device, mesh=mesh)``; the
``mesh=`` argument also goes to ``BatchedFri``, ``Stir``, ``Whir``,
``PackedMerkleTree`` and ``IndexMerkleTree``. A model's transitions take
the block of the coefficients with ``rows=`` (a ``Rows``) on a mesh.
"""

from .fri_sharded import (
    get_block_fri_fns,
    get_sharded_fri_fns,
    make_sharded_fold_fns,
    make_sharded_fri_fns,
)
from .merkle_sharded import can_shard_tree, sharded_tree_digests
from .mesh import Mesh, Rows, default_axis, gather_to_host, make_mesh, owner_select
from .ntt_sharded import (
    block_ntt_fits,
    can_shard,
    get_block_ntt_fns,
    get_sharded_ntt_fns,
    make_sharded_ntt_fns,
    select_ntt_fns,
    sharded_lde,
)

__all__ = [
    "Mesh", "Rows", "make_mesh", "default_axis", "owner_select", "gather_to_host",
    "make_sharded_ntt_fns", "sharded_lde", "can_shard", "block_ntt_fits",
    "get_sharded_ntt_fns", "get_block_ntt_fns", "select_ntt_fns", "get_sharded_fri_fns",
    "get_block_fri_fns", "make_sharded_fri_fns", "make_sharded_fold_fns",
    "can_shard_tree", "sharded_tree_digests",
]
