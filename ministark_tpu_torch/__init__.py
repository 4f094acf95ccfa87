"""ministark_tpu_torch: the ministark provers on PyTorch and CUDA.

A port of ``ministark_tpu`` (JAX + Pallas) to PyTorch, with hand-written
CUDA C++ kernels for NVIDIA Hopper (``sm_90a``), over Goldilocks + Fp2 and
BabyBear + Fp4. The JAX package stays the
reference: the same inputs give byte-identical proofs in both.

Layer map (module paths mirror ``ministark_tpu``):
  fields/     host field oracle (pure Python copy)
  poly/       host polynomials and FFT domains (pure Python copy)
  commit/     hashlib Merkle oracle (copy) + tensor-resident PackedMerkleTree
              (parity) and IndexMerkleTree (fast mode, 2^k-ary)
  transcript/ Fiat-Shamir sponge (pure Python copy)
  fri/        host FRI oracle (pure Python copy) + batched FRI (fast mode)
  air/        host traces and constraints (pure Python copy)
  stark/      host oracle ``Stark`` (copy), tensor ``DeviceEngine`` (parity)
              and ``FastStark`` (fast mode, batched-FRI backend)
  models/     Fibonacci AIR: host claim (copy) + tensor witness ladder
  ops/        field ops (GL, BabyBear), NTT, SHA-256 and leaf hashing over
              torch tensors;
              each kernel has a plain PyTorch version beside it
  csrc/       the CUDA C++ kernels, built with nvcc at first use

Dispatch is by tensor device: a CPU tensor takes the plain PyTorch version
of a kernel, a CUDA tensor launches the CUDA kernel or raises. The provers
put their tensors on the card unless the caller passes ``device="cpu"``.

The pure-Python host layers are copies, not imports, of the JAX package's:
importing any module of ``ministark_tpu`` runs a package ``__init__`` that
imports jax, and this package must import without it.
"""

__version__ = "0.1.0"
