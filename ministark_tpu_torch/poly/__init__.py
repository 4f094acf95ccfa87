from .domain import Radix2EvaluationDomain
from .dense import DensePolynomial

__all__ = ["Radix2EvaluationDomain", "DensePolynomial"]
