"""Tensor kernels: Goldilocks and BabyBear field ops (with Fp2 and Fp4), the
NTT, SHA-256 and leaf hashing.

Each kernel module holds a plain PyTorch version and a wrapper around the
CUDA kernel (csrc/); the wrapper picks by the device of the tensor it is
given and never falls back.
"""
