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
* Residency: rank r holds the rows [r*n/D, (r+1)*n/D) of every stage
  tensor of length n (``mesh.Rows``), its contiguous natural-order block,
  from the start of ``prove`` until a stage's size stops splitting by the
  size rules below; there the blocks are gathered once and every
  rank goes on with one device's code on the whole tensor. A rank's memory
  holds 1/D of each stage tensor, and the witness, which arrives whole.
  Resident paths:

  - the parity prover (``DeviceEngine(..., mesh=mesh)``), gated by
    ``block_ntt_fits``, ``can_shard_tree`` and the engine's
    ``_fri_splits``;
  - the fast mode (``FastStark(..., mesh=mesh)``) with each of its
    low-degree tests, gated by ``block_ntt_fits`` for the trace iFFT and
    ``block_coset_fits`` for the L_0 commitments' LDE; a FRI layer hands
    off where its fold, LDE or tree stops splitting (``fri/batched.py``), a
    STIR round or WHIR iteration where its fold or coset-row LDE stops
    splitting or (STIR) its block would hold no more than |G| coefficients
    (``fri/stir.py``, ``fri/whir.py``);
  - the prove core (``stark/core.py::make_sharded_prove_core``), which
    returns each rank's blocks.

  The block forms: ``get_block_ntt_fns`` (natural blocks in and out, an
  input of n/B points zero-padded to n taken in by its first
  ``all_to_all``), ``get_block_coset_ntt_fns`` (the same input, the fast
  mode's coset rows out, one exchange when F*D divides the four-step's
  N1), ``get_block_fri_fns`` (fold and divide block to block, deep to the
  replicated pair), ``block_tree_levels`` / ``tree_top`` with
  ``commit/packed_tree.py::BlockMerkleTree`` and ``commit/index_tree.py::
  BlockIndexTree`` (local levels stay local, the D local tops are
  gathered, the top is replicated), block partial sums added by
  ``field_sum_over_ranks`` (DEEP, point and sumcheck evaluations), and
  ``previous_rows`` (the previous rank's last rows, a ``halo``: STIR's
  degree correction, ``fri/stir.py::quot_degcor_block``). What the proof
  carries comes from its owners: ``owner_select`` (one gather, the owner's
  row picked) for codeword reads, path digests, leaf groups and index-tree
  rows, ``gather_to_host`` (in chunks, so no device holds the whole) for
  the query quotients.
* Replicated in and out: only the verifiers' iFFT and binding LDE
  (``DeviceEngine.constrain_coeffs``, ``FastStark._constraint_polys`` and
  ``binding_lde``); a low-degree test's ``commit`` and ``prove`` without
  rows run one device's code. The sharded functions
  (``get_sharded_ntt_fns``, ``get_sharded_fri_fns``,
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
  (``all_to_all``, ``all_gather``, ``opening`` for what the proof
  carries, and ``halo``).
* Every rank calls the same collectives in the same order, so every rank
  calls the same entry points alike: ``prove``, and ``verify`` where the
  caller verifies (the verifier's own iFFT of the constraints is sharded
  too). A block of the wrong size raises on every rank before any
  collective; an error that one rank finds after a gather (``LeafNotFound``
  after the leaf search) is found by every rank. The launcher's timeout
  turns a rank that strays (and so a hang) into an error.

Use: inside each rank, ``DeviceEngine(config, device=mesh.device,
mesh=mesh)`` or ``FastStark(config, device=mesh.device, mesh=mesh)``; the
``mesh=`` argument also goes to ``PackedMerkleTree`` and
``IndexMerkleTree`` (the replicated forms) and to ``BatchedFri``,
``Stir`` and ``Whir`` (their ``binding_lde``), whose ``commit`` /
``prove`` take ``rows=`` for the resident forms. A
model's transitions take the block of the coefficients with ``rows=`` (a
``Rows``) on a mesh.
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
    block_coset_fits,
    block_ntt_fits,
    can_shard,
    get_block_coset_ntt_fns,
    get_block_ntt_fns,
    get_sharded_ntt_fns,
    make_sharded_ntt_fns,
    select_ntt_fns,
    sharded_lde,
)

__all__ = [
    "Mesh", "Rows", "make_mesh", "default_axis", "owner_select", "gather_to_host",
    "make_sharded_ntt_fns", "sharded_lde", "can_shard", "block_ntt_fits",
    "get_sharded_ntt_fns", "get_block_ntt_fns", "block_coset_fits",
    "get_block_coset_ntt_fns", "select_ntt_fns", "get_sharded_fri_fns",
    "get_block_fri_fns", "make_sharded_fri_fns", "make_sharded_fold_fns",
    "can_shard_tree", "sharded_tree_digests",
]
