"""DEEP-FRI low-degree test (commit / fold / query / verify).

Mirrors src/fri.rs:17-377 including every parity-critical quirk (SURVEY §8):

* round 0 commits the unfolded polynomial; each later round: challenge z,
  ship [f_even(z), f_odd(z)], challenge alpha, fold f_even + alpha*f_odd, then
  DEEP-adjust ``(folded - deep_poly(alpha)) / (x - z)`` (src/fri.rs:85-110);
* betas are squeezed once (8 bytes each, little-endian usize) and reused for
  every round; the reduction uses ``>`` not ``>=`` (src/fri.rs:142-146, §8.4);
* prover y-values come from direct polynomial evaluation, not the committed
  codeword (src/fri.rs:151-153, §8.8);
* the shipped quotient is the full coefficient vector of
  ``(f - line) / Z_{x1,x2}`` (src/fri.rs:157-167);
* Merkle proofs are generated for y1/y2 *by value* from the previous round's
  tree (src/fri.rs:169-172);
* the verifier chains x3 -> x1 across rounds, checks DEEP linearity and
  degree bounds, and calls — but deliberately ignores the result of —
  ``check_proof`` (src/fri.rs:236-239, §8.5), likewise discarding the
  quotient/vanishing division result (src/fri.rs:227).

Device notes: codeword evaluation (coset-free NTT) and the synthetic division
behind the DEEP adjustment dispatch to ops/ntt.py for large rounds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import logging

from ..commit import MerkleRoot, MerkleTree, MerkleTreeConfig
from ..poly import DensePolynomial, Radix2EvaluationDomain
from ..transcript.merlin import Arthur, Merlin

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class FriConfig:
    """src/fri.rs:24-30."""

    queries: int
    merkle_config: MerkleTreeConfig
    blowup_factor: int
    rounds: int


@dataclass
class FriProof:
    """src/fri.rs:17-22: per round, per query — three (x, y) points, two
    Merkle paths (y1, y2), and the quotient coefficient vector."""

    points: List[List[List[Tuple]]]
    queries: List[List[List]]
    quotients: List[List[List]]


class FriRound:
    """src/fri.rs:300-377: a committed codeword for one folding round."""

    def __init__(self, field, poly: DensePolynomial, domain_size: int, config: MerkleTreeConfig):
        self.field = field
        self.poly = poly
        self.domain = Radix2EvaluationDomain(field, domain_size)
        self.split_factor = config.inner_children
        self.splited_polys = self.split_poly(field, poly, self.split_factor)
        evals = poly.evaluate_over_domain(self.domain)
        self.commit = MerkleTree(field, evals, config)

    @staticmethod
    def split_poly(field, poly: DensePolynomial, split_factor: int) -> List[DensePolynomial]:
        parts: List[List] = [[] for _ in range(split_factor)]
        for i, c in enumerate(poly.coeffs):
            parts[i % split_factor].append(c)
        return [DensePolynomial(field, p) for p in parts]

    def get_deep_coeffs(self, z) -> List:
        return [self.splited_polys[0].evaluate(z), self.splited_polys[1].evaluate(z)]

    def fold_poly(self, alpha) -> DensePolynomial:
        F = self.field
        acc = DensePolynomial.zero(F)
        for i, poly in enumerate(self.splited_polys):
            acc = acc + poly.scale(F.pow(alpha, i))
        return acc

    def next_round_domain_size(self) -> int:
        return self.domain.size() // self.split_factor


class Fri:
    """src/fri.rs:32-290."""

    def __init__(self, field, config: FriConfig):
        # config echo mirrors src/fri.rs:46-49
        logger.info(
            "FRI initialized: queries %s | blowup factor %s | rounds %s",
            config.queries, config.blowup_factor, config.rounds,
        )
        self.field = field
        self.config = config

    # ------------------------------------------------------------- prover
    def prove(self, transcript: Merlin, poly: DensePolynomial) -> FriProof:
        fri_rounds = self.commit_phase(transcript, poly)
        return self.query_phase(transcript, fri_rounds)

    def commit_phase(self, transcript: Merlin, poly: DensePolynomial) -> List[FriRound]:
        F = self.field
        cfg = self.config
        round_domain_size = (poly.degree() + 1) * cfg.blowup_factor

        previous = FriRound(F, poly, round_domain_size, cfg.merkle_config)
        fri_rounds = [previous]

        for _ in range(1, cfg.rounds):
            z = transcript.challenge_scalar(F)
            deep_coeffs = previous.get_deep_coeffs(z)
            denominator = DensePolynomial(F, [F.neg(z), F.one()])
            deep_poly = DensePolynomial(F, deep_coeffs)
            transcript.add_scalars(F, deep_coeffs)

            alpha = transcript.challenge_scalar(F)
            folded = previous.fold_poly(alpha)
            deep_value = DensePolynomial(F, [deep_poly.evaluate(alpha)])
            round_poly = (folded - deep_value) / denominator

            domain_size = previous.next_round_domain_size()
            previous = FriRound(F, round_poly, domain_size, cfg.merkle_config)
            transcript.add_bytes(previous.commit.root())
            fri_rounds.append(previous)

        return fri_rounds

    def query_phase(self, transcript: Merlin, fri_rounds: List[FriRound]) -> FriProof:
        F = self.field
        cfg = self.config
        raw = transcript.fill_challenge_bytes(8 * cfg.queries)
        betas = [
            int.from_bytes(raw[i * 8 : (i + 1) * 8], "little") for i in range(cfg.queries)
        ]

        points, queries, quotients = [], [], []
        for round_i in range(len(fri_rounds) - 1):
            # the reference has a stray println!("Prove Round {i}") here
            # (src/fri.rs:133); kept as a debug log so bench stdout stays clean
            logger.debug("Prove Round %s", round_i)
            previous, rnd = fri_rounds[round_i], fri_rounds[round_i + 1]
            assert previous.domain.size() // cfg.merkle_config.inner_children == rnd.domain.size()

            round_points, round_queries, round_quotients = [], [], []
            for query in betas:
                beta = query
                # NOTE `>` (not >=): beta == size survives via omega^N == 1 (§8.4)
                if beta > previous.domain.size():
                    beta %= previous.domain.size()

                x1 = previous.domain.element(beta)
                x2 = previous.domain.element(rnd.domain.size() + beta)
                x3 = rnd.domain.element(beta)
                y1 = previous.poly.evaluate(x1)
                y2 = previous.poly.evaluate(x2)
                y3 = rnd.poly.evaluate(x3)
                round_points.append([(x1, y1), (x2, y2), (x3, y3)])
                assert x3 == previous.domain.element(2 * beta)

                # line g(x) = ax + b through (x1,y1), (x2,y2)
                a = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
                b = F.sub(y1, F.mul(a, x1))
                g = DensePolynomial(F, [b, a])

                numerator = previous.poly - g
                vanishing = self.calculate_vanishing_poly(F, [x1, x2])
                q = numerator / vanishing
                round_quotients.append(q.to_vec())

                proof1 = previous.commit.generate_proof(y1)
                proof2 = previous.commit.generate_proof(y2)
                round_queries.append([proof1, proof2])

            points.append(round_points)
            queries.append(round_queries)
            quotients.append(round_quotients)

        return FriProof(points=points, queries=queries, quotients=quotients)

    # ----------------------------------------------------------- verifier
    def verify(self, proof: FriProof, arthur: Arthur) -> bool:
        F = self.field
        cfg = self.config
        commits, alphas, betas, deep_queries, deep_polys = self.read_proof_transcript(arthur)
        assert len(commits) == cfg.rounds - 1
        assert len(commits) == len(proof.points)

        domain = Radix2EvaluationDomain(F, 1 << cfg.rounds)
        prev_x3s = [domain.element(b) for b in betas]
        for i, (round_points, round_queries) in enumerate(zip(proof.points, proof.queries)):
            logger.debug("FRI Verifier: verification Round %s", i + 1)
            for j, (pts, paths) in enumerate(zip(round_points, round_queries)):
                (x1, y1), (x2, y2), (x3, y3) = pts
                path1, path2 = paths
                assert x1 == prev_x3s[j]
                assert F.neg(x1) == x2
                assert F.pow(x1, 2) == x3

                quotient = DensePolynomial(F, proof.quotients[i][j])
                vanishing = self.calculate_vanishing_poly(F, [x1, x2, x3])
                total_degree = quotient.degree() + vanishing.degree()
                assert total_degree >= 2
                assert total_degree <= 1 << (cfg.rounds - i)
                _ = quotient / vanishing  # result deliberately discarded (§8.5)

                # DEEP linearity test
                a = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
                b = F.sub(y1, F.mul(a, x1))
                deep_adjusted_y = F.add(
                    F.mul(y3, F.sub(x3, deep_queries[i])),
                    deep_polys[i].evaluate(alphas[i]),
                )
                g = DensePolynomial(F, [b, a])
                assert g.evaluate(alphas[i]) == deep_adjusted_y

                assert y1 in path1.leaf_neighbours
                commits[i].check_proof(F, path1)  # result ignored (§8.5)
                assert y2 in path2.leaf_neighbours
                commits[i].check_proof(F, path2)  # result ignored (§8.5)
                prev_x3s[j] = x3

        return True

    def read_proof_transcript(self, arthur: Arthur):
        """src/fri.rs:247-281: replay the IO pattern to recover challenges."""
        F = self.field
        cfg = self.config
        commits, alphas, deep_queries, deep_polys = [], [], [], []
        domain_size = 1 << cfg.rounds

        for _ in range(1, cfg.rounds):
            z = arthur.challenge_scalar(F)
            deep_queries.append(z)
            b_coeffs = arthur.next_scalars(F, 2)
            deep_polys.append(DensePolynomial(F, b_coeffs))
            alpha = arthur.challenge_scalar(F)
            alphas.append(alpha)
            commits.append(MerkleRoot(arthur.next_digest()))

        raw = arthur.fill_challenge_bytes(8 * cfg.queries)
        betas = []
        for i in range(cfg.queries):
            a = int.from_bytes(raw[i * 8 : (i + 1) * 8], "little")
            # verifier reduces once mod 1 << rounds, same `>` quirk (§8.4)
            betas.append(a % domain_size if a > domain_size else a)

        return commits, alphas, betas, deep_queries, deep_polys

    @staticmethod
    def calculate_vanishing_poly(field, roots: List) -> DensePolynomial:
        acc = None
        for r in roots:
            term = DensePolynomial(field, [field.neg(r), field.one()])
            acc = term if acc is None else acc * term
        return acc
