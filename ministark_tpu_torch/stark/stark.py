"""STARK protocol orchestration (prove / verify / config math).

Mirrors src/starks.rs:21-333:

* ``StarkConfig.new(security_bits, blowup_factor, steps, trace_columns)``
  derives every protocol parameter — degree = steps - 1,
  rounds = ceil_log2_k(steps * blowup + 1, 2), the linking/FRI query counts
  (src/starks.rs:268-332) — and composes the full IO pattern with domain
  separator "🐺" (src/starks.rs:303-308);
* ``Stark.prove``: trace commit -> coset-shift challenge -> LDE of all
  constraint polynomials -> constraint-trace commit -> batching challenge r ->
  mixed polynomial -> ``divide_by_vanishing_poly`` with the reference's
  swapped destructuring (the "validity polynomial" is the *remainder*,
  SURVEY §8.3) -> DEEP-ALI extension queries -> FRI (src/starks.rs:59-169);
* ``Stark.verify`` takes the ``Constrains`` out-of-band (the reference's
  verifier is deliberately non-succinct, src/starks.rs:171-235) and mirrors
  every assertion including the same §8.3 swap.

The verifier's trace domain is ``Radix2(degree + 1)`` over the *extension*
field (src/starks.rs:190) — size ``steps`` before pow-2 rounding, equal to the
prover's domain after rounding for all reference configurations.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import List

from ..air import Constrains, Matrix, Provable
from ..commit import MerkleTree, MerkleTreeConfig
from ..fri import Fri, FriConfig, FriProof
from ..poly import DensePolynomial, Radix2EvaluationDomain
from ..transcript.iopattern import new_stark_iopattern
from ..transcript.merlin import Arthur, Merlin
from ..utils import ceil_log2_k

logger = logging.getLogger(__name__)


@dataclass
class StarkProof:
    """src/starks.rs:21-28."""

    arthur: bytes
    trace_commit: bytes
    constrain_trace_commit: bytes
    constrain_queries: List[List]
    validity_queries: List
    fri_proof: FriProof


class StarkConfig:
    """src/starks.rs:238-333."""

    def __init__(self, stark_field, security_bits: int, blowup_factor: int,
                 steps: int, trace_columns: int):
        constrain_queries, fri_queries = self.num_queries_from_config(
            stark_field, security_bits, blowup_factor, steps
        )
        self.stark_field = stark_field
        self.security_bits = security_bits
        self.steps = steps
        self.blowup_factor = blowup_factor
        self.degree = steps - 1
        self.rounds = ceil_log2_k(steps * blowup_factor + 1, 2)
        self.constrain_queries = constrain_queries
        self.fri_queries = fri_queries
        self.fri_config = FriConfig(
            queries=fri_queries,
            blowup_factor=blowup_factor,
            rounds=self.rounds,
            merkle_config=MerkleTreeConfig(leafs_per_node=2, inner_children=2),
        )
        self.merkle_config = MerkleTreeConfig(
            leafs_per_node=trace_columns, inner_children=2
        )
        self.io = new_stark_iopattern(
            stark_field, self.rounds, constrain_queries, fri_queries, "🐺"
        )

    @staticmethod
    def num_queries_from_config(stark_field, security_bits: int, blowup_factor: int,
                                steps: int):
        """src/starks.rs:312-332 — exact float math replicated."""
        if security_bits < 20:
            logger.error("STARK Config: security bits has to be at least 20")
            raise AssertionError("")
        log_steps = ceil_log2_k(steps, 2)
        modulus_bits = stark_field.base.modulus_bit_size
        # The reference computes security_bits / (modulus_bits - log_steps) in
        # usize arithmetic and would panic on underflow when the trace is as
        # long as the modulus allows; raise the equivalent hard error instead
        # of silently producing a nonsensical query count (ADVICE r1).
        assert modulus_bits > log_steps, (
            f"trace too long for field: log2(steps)={log_steps} >= "
            f"modulus bits {modulus_bits} (reference panics via usize underflow)"
        )
        linking_queries = -(-security_bits // (modulus_bits - log_steps))

        rounds = ceil_log2_k(steps * blowup_factor, 2)
        rho = 1.0 / blowup_factor
        denominator = math.log2(2.0 / (1.0 + rho))
        total_fri_queries = security_bits / denominator
        round_fri_queries = math.ceil(total_fri_queries / rounds)
        return linking_queries, round_fri_queries


class Stark:
    """src/starks.rs:30-236."""

    def __init__(self, config: StarkConfig):
        self.config = config
        logger.info(
            "New STARK: trace length %s | security bits %s | blowup %s | rounds %s",
            config.steps, config.security_bits, config.blowup_factor, config.rounds,
        )

    # ------------------------------------------------------------- prover
    def prove(self, air: Provable, witness) -> StarkProof:
        cfg = self.config
        sf = cfg.stark_field
        base, ext = sf.base, sf.extension
        merlin = Merlin(cfg.io)

        # 1.1 compute trace and commit to trace (src/starks.rs:68-81)
        trace = air.trace(witness)
        trace_domain = trace.get_domain()
        trace_codeword = MerkleTree(base, trace.trace.get_data(), cfg.merkle_config)
        trace_commit = trace_codeword.root()
        merlin.add_bytes(trace_commit)

        # 1.2 low-degree extension of all constraint polynomials (src/starks.rs:82-95)
        lde_domain_size = cfg.blowup_factor * trace_domain.size()
        random_shift = merlin.challenge_scalar(base)
        lde_domain = Radix2EvaluationDomain(base, lde_domain_size).get_coset(random_shift)
        constrains = trace.derive_constrains()
        constrain_trace = Matrix(lde_domain_size, len(constrains), zero=base.zero())
        for i, poly in enumerate(constrains.get_polynomials()):
            constrain_trace.add_col(i, poly.evaluate_over_domain(lde_domain))
        constrain_trace_codeword = MerkleTree(
            base, constrain_trace.get_data(), cfg.merkle_config
        )
        constrain_trace_commit = constrain_trace_codeword.root()
        merlin.add_bytes(constrain_trace_commit)

        # 1.3 mix constraints into the validity polynomial (src/starks.rs:108-120)
        r = merlin.challenge_scalar(base)
        mixed = DensePolynomial.zero(base)
        for i, poly in enumerate(constrains.get_polynomials()):
            mixed = mixed + poly.scale(base.pow(r, i))
        rest, validity_poly = mixed.divide_by_vanishing_poly(trace_domain)
        # §8.3: ark returns (quotient, remainder); the reference's naming makes
        # the remainder the validity polynomial and asserts the quotient zero.
        assert rest.is_zero()

        # 2. DEEP-ALI queries (src/starks.rs:124-151)
        queries = merlin.challenge_scalars(ext, cfg.constrain_queries)
        extension_validity_poly = validity_poly.extend(sf)
        extension_constrain_polys = [p.extend(sf) for p in constrains.get_polynomials()]
        constrain_queries, validity_queries = [], []
        for query in queries:
            constrain_queries.append(
                [p.evaluate(query) for p in extension_constrain_polys]
            )
            validity_queries.append(extension_validity_poly.evaluate(query))

        # 3. DEEP-IOPP: FRI on the validity polynomial (src/starks.rs:155-156)
        fri = Fri(ext, cfg.fri_config)
        fri_proof = fri.prove(merlin, extension_validity_poly)

        return StarkProof(
            arthur=merlin.transcript(),
            trace_commit=trace_commit,
            constrain_trace_commit=constrain_trace_commit,
            constrain_queries=constrain_queries,
            validity_queries=validity_queries,
            fri_proof=fri_proof,
        )

    # ----------------------------------------------------------- verifier
    def verify(self, constrains: Constrains, proof: StarkProof) -> bool:
        cfg = self.config
        sf = cfg.stark_field
        base, ext = sf.base, sf.extension

        # 1. transcript replay (src/starks.rs:185-193)
        arthur = Arthur(cfg.io, proof.arthur)
        assert arthur.next_digest() == proof.trace_commit
        _shift = arthur.challenge_scalar(base)
        # NOTE reference uses degree+1 (= steps) here, not steps+1; equal after
        # pow-2 rounding (src/starks.rs:190)
        domain = Radix2EvaluationDomain(ext, cfg.degree + 1)
        assert arthur.next_digest() == proof.constrain_trace_commit
        r = arthur.challenge_scalar(base)

        # 2. DEEP-ALI linking (src/starks.rs:198-226)
        queries = arthur.challenge_scalars(ext, cfg.constrain_queries)
        extension_constrains = [p.extend(sf) for p in constrains.get_polynomials()]
        for query, constrain_query, validity_query in zip(
            queries, proof.constrain_queries, proof.validity_queries
        ):
            c_x = DensePolynomial.zero(ext)
            for i, (constrain, constrain_eval) in enumerate(
                zip(extension_constrains, constrain_query)
            ):
                assert constrain.evaluate(query) == constrain_eval
                c_x = c_x + constrain.scale(
                    ext.from_base_prime_field(base.pow(r, i))
                )
            rest, quotient = c_x.divide_by_vanishing_poly(domain)
            assert rest.is_zero()  # same §8.3 swap as the prover
            assert quotient.evaluate(query) == validity_query

        # 3. FRI (src/starks.rs:229-230)
        fri_verifier = Fri(ext, cfg.fri_config)
        assert fri_verifier.verify(proof.fri_proof, arthur)
        return True
