"""out = x + 1 over 32-bit words with wraparound: the streaming probe.

Port of ``scripts/pallas_stream_probe.py::_copy_kernel`` (out = x + 1 over
a (16384, 4096) uint32 array): the measured device-memory streaming rate
of a hand-written kernel. The words are int32 storage (torch has no
uint32 arithmetic), so 2^31 - 1 wraps to -2^31. ``stream_add1`` dispatches
by device: a CPU tensor takes ``stream_add1_plain``, a CUDA tensor
launches ``stream_add1_cuda`` (csrc/stream.cu) or raises.
"""

from __future__ import annotations

import torch

from . import cuda

# Incremented once per call that launches the kernel.
launches = 0

# The default launch shape, from the paired sweep of
# scripts/torch_stream_probe.py --sweep-pairs 15 on an H100 80GB HBM3 at
# 700 W ((16384, 4096) words, medians of 15 pairs): 512 or 1024 threads x 1
# vector, one group a block, 0.1783 ms against torch.add's 0.1797; 128 or
# 256 x 1 0.1786-0.1788, x 2 0.1791, x 4 0.1798-0.1800, whole waves of
# resident blocks walking the groups 0.1849-0.1887 (a grid since removed).
THREADS = 512        # threads per block
PER_THREAD = 1       # 16-byte vectors each thread keeps in flight


def stream_add1_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the sum in int64, folded back into int32's range."""
    wide = x.to(torch.int64) + 1 + (1 << 31)
    return ((wide & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def stream_add1_cuda(x: torch.Tensor, threads: int = THREADS,
                     per_thread: int = PER_THREAD) -> torch.Tensor:
    """CUDA kernel ``ms_stream_add1``, same contract as
    ``stream_add1_plain``; ``threads`` per block and the 16-byte vectors
    ``per_thread`` keeps in flight (1, 2, 4 or 8) set the launch shape,
    one group of threads x per_thread vectors a block."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"stream_add1: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("stream_add1: expected a contiguous, 16-byte aligned "
                         f"int32 tensor, got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    if x.numel():
        err = cuda.library().ms_stream_add1(x.data_ptr(), out.data_ptr(), x.numel(),
                                            threads, per_thread, cuda.stream_ptr(x))
        cuda.check("stream_add1", err)
        launches += 1
    return out


def stream_add1(x: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    return stream_add1_plain(x) if x.device.type == "cpu" else stream_add1_cuda(x)
