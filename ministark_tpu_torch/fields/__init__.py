from .host import (
    PrimeField,
    QuadExtField,
    Fp4ExtField,
    GOLDILOCKS_FP,
    GOLDILOCKS_FP2,
    BABYBEAR_FP,
    BABYBEAR_FP2,
    BABYBEAR_FP4,
    Goldilocks,
    BabyBear,
    StarkField,
)

__all__ = [
    "PrimeField",
    "QuadExtField",
    "Fp4ExtField",
    "GOLDILOCKS_FP",
    "GOLDILOCKS_FP2",
    "BABYBEAR_FP",
    "BABYBEAR_FP2",
    "BABYBEAR_FP4",
    "Goldilocks",
    "BabyBear",
    "StarkField",
]
