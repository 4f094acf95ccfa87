"""Kernel-level benchmarks of the PyTorch/CUDA port against its bounds.

The port's twin of bench_kernels.py: steady-state times of the hot kernels
and kernel chains on one GPU, one JSON line per entry. A time is the mean of
N launches between two CUDA events after a warm-up (``utils/roofline.py::
time_ms``); ``bound_frac`` is the least time the card could take for the
same work (``utils/roofline.py::bound``: bytes over the device-memory rate,
integer operations or int8 multiply-adds over their peaks) over the measured
time, so 1.0 is the card's limit and a reading above 1.0 is a fault of the
count, which raises.

    python3 bench_kernels_torch.py                       # on the GPU host
    python3 bench_kernels_torch.py --device cpu --shrink 8   # dry run

``--device cpu`` runs the plain versions at sizes cut by 2^shrink to
rehearse the control flow: its times are host times and carry no
``bound_frac``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from ministark_tpu_torch.utils import roofline as rf

NTT_BACKENDS = ("radix2", "four_step", "pipe")
# every metric a full run of kernel_rooflines() yields, in order
METRICS = (
    "gl_mul_throughput", "hbm_stream", "fp2_mul_throughput", "int8_matmul_4096",
    "digit_dot_4096", "gl_ntt_2^20_batch2", "gl_ntt_four_step_2^20_batch2",
    "gl_ntt_pipe_2^20_batch2", "gl_ntt_2^21_batch2", "gl_ntt_four_step_2^21_batch2",
    "gl_ntt_pipe_2^21_batch2", "gl_ntt_digit_2^20_level0", "fri_fold_div_2^21_fp2",
    "fri_fold_div_chain_2^21_to_2^12", "batched_commit_2^20_b4_arity4",
    "sha_tree_2^21x4_arity4")


def _rand_gl(rng, shape, device):
    from ministark_tpu_torch.fields import GOLDILOCKS_FP

    v = rng.integers(0, GOLDILOCKS_FP.p, size=shape, dtype=np.uint64)
    return torch.from_numpy(v.view(np.int64)).to(device)


def _rand_s8(rng, shape, device):
    v = rng.integers(-128, 128, size=shape, dtype=np.int64).astype(np.int8)
    return torch.from_numpy(v).to(device)


def kernel_rooflines(device="cuda", shrink: int = 0):
    """Measure the hot kernels; returns a list of result dicts, each with
    ``metric``, ``value``, ``unit``, ``ms``, ``bound_ms``, ``bound_by``,
    ``bound_frac`` and ``shape``.

    ``shrink``: every size is cut by 2^shrink (a dry run; the metric names
    keep the full sizes, ``shape`` says what ran)."""
    from ministark_tpu_torch.commit.index_tree import _build_digests
    from ministark_tpu_torch.fields import GOLDILOCKS_FP, GOLDILOCKS_FP2, Goldilocks
    from ministark_tpu_torch.fri.batched import BatchedFri, BatchedFriConfig
    from ministark_tpu_torch.ops import field as gl
    from ministark_tpu_torch.ops import ntt_digit, stream
    from ministark_tpu_torch.ops.field import get_ops
    from ministark_tpu_torch.ops.ntt import get_ntt_fns
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark.engine import DeviceEngine, _FriRoundRepr

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a dry run")
    rng = np.random.default_rng(0)
    results = []

    def cut(log_size, floor):
        return 1 << max(log_size - shrink, floor)

    def entry(metric, fn, reps, work, value, unit, shape, **extra):
        """Time ``fn`` and append one result; ``value(ms)`` forms the
        reported number, ``work`` is ``bound``'s arguments."""
        ms = rf.time_ms(fn, reps, dev)
        bms, by = rf.bound(*work)
        r = {"metric": metric, "value": value(ms), "unit": unit, "ms": ms,
             "bound_ms": bms, "bound_by": by,
             "bound_frac": bms / ms if on_card else None,
             "shape": shape, "device": torch.cuda.get_device_name(0)
             if on_card else "cpu", **extra}
        if on_card and r["bound_frac"] > 1.0:
            raise AssertionError(f"{metric}: {ms:.4f} ms is below its bound "
                                 f"{bms:.4f} ms ({by}): the count is wrong")
        results.append(r)

    def split(fn, reps):
        """On the card the host's ms per call issued without a synchronize,
        the card's ms alone and torch.profiler's (``utils/roofline.py::
        split_ms``), so that a product's event-timed ms is not read as
        device time; a dry run has host times only."""
        if not on_card:
            return {"host_ms": rf.time_ms(fn, reps, dev), "device_ms": None,
                    "profiler_ms": None, "profiler_kernels": None}
        return rf.split_ms(fn, reps)

    # --- Goldilocks elementwise multiply (the gl_mul kernel's contiguous path)
    n = cut(22, 10)
    a = _rand_gl(rng, (n,), dev)
    entry("gl_mul_throughput", lambda: gl.mul(a, a), 20, rf.mul_work(a, a),
          lambda ms: n / ms / 1e6, "Gop/s", [n], **split(lambda: gl.mul(a, a), 20))

    # --- device-memory stream (the stream_add1 kernel: read + write)
    rows = cut(14, 2)
    words = torch.from_numpy(rng.integers(0, 1 << 32, size=(rows, 4096), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(dev)
    entry("hbm_stream", lambda: stream.stream_add1(words), 10,
          rf.stream_work(words.numel()), lambda ms: 8 * words.numel() / ms / 1e6,
          "GB/s", [rows, 4096])
    del words

    # --- Fp2 multiply: one launch of the Fp2 product kernel (csrc/gl_mul.cu
    # ms_gl_ext_mul: Karatsuba in registers, 16-byte loads and stores)
    ke = get_ops(GOLDILOCKS_FP2)
    m = cut(21, 10)
    e, f = _rand_gl(rng, (m, 2), dev), _rand_gl(rng, (m, 2), dev)
    entry("fp2_mul_throughput", lambda: ke.mul(e, f), 10, rf.ext_mul_work(e, f),
          lambda ms: m / ms / 1e6, "Gext/s", [m, 2], **split(lambda: ke.mul(e, f), 10))

    # --- int8 multiply-add rate: the library's product and the hand kernel
    # on the same operands (A is handed to digit_dot K-major, as the level's
    # digits are)
    dm = cut(12, 7)
    a8, b8 = _rand_s8(rng, (dm, dm), dev), _rand_s8(rng, (dm, dm), dev)
    dot_work = rf.digit_dot_work(1, dm, dm, dm)
    tmacs = lambda ms: dm ** 3 / ms / 1e9   # noqa: E731
    entry("int8_matmul_4096", lambda: torch._int_mm(a8, b8), 10, dot_work, tmacs,
          "TMAC/s", [dm, dm, dm], route="torch._int_mm")
    a8_t = a8.T.contiguous()[None]           # (1, K, R): A[r, k] = a8_t[0, k, r]
    if not torch.equal(ntt_digit.digit_dot(a8_t, b8)[0], torch._int_mm(a8, b8)):
        raise AssertionError("digit_dot differs from torch._int_mm")
    entry("digit_dot_4096", lambda: ntt_digit.digit_dot(a8_t, b8), 10, dot_work,
          tmacs, "TMAC/s", [dm, dm, dm], route="ms_digit_dot_s8")
    del a8, b8, a8_t

    # --- the NTT, every backend (forward, batch 2)
    batch = 2
    for logn in (20, 21):
        size = cut(logn, 14)
        x = _rand_gl(rng, (batch, size), dev)
        want = None
        for backend in NTT_BACKENDS:
            fft = get_ntt_fns(GOLDILOCKS_FP, size, backend)[0]
            got = fft(x)
            if want is None:
                want = got
            elif not torch.equal(got, want):
                raise AssertionError(f"{backend} NTT differs from radix2 at {size}")
            name = "" if backend == "radix2" else backend + "_"
            entry(f"gl_ntt_{name}2^{logn}_batch{batch}", lambda: fft(x), 10,
                  rf.ntt_work(batch, size, False, False),
                  lambda ms: ms, "ms", [batch, size])
        del x, want, got

    # --- the fused digit level at level 0 of the forward 2^20 transform,
    # held against the butterfly level on the same input
    from ministark_tpu_torch.ops import ntt_pipe

    size = cut(20, 14)
    Fi, vd, W, k_prod = ntt_digit.level_tables(size, False, dev)[0]
    _, tw, _, _ = ntt_pipe._tables(size, False, dev)[0]
    x = _rand_gl(rng, (batch, Fi, size // Fi), dev)
    if not torch.equal(ntt_digit.level(x, vd, W, k_prod),
                       ntt_pipe.level(x, tw, None, W, k_prod)):
        raise AssertionError("the digit level differs from the butterfly level")
    entry("gl_ntt_digit_2^20_level0", lambda: ntt_digit.level(x, vd, W, k_prod), 10,
          rf.digit_level_work(batch, Fi, size // Fi, 0 if W is None else W.shape[0]),
          lambda ms: ms, "ms", [batch, Fi, size // Fi])
    del x

    # --- one FRI fold + DEEP subtract + division round of the parity engine
    # (stark/engine.py::_fold_div), and the whole chain down to 2^12
    ext = GOLDILOCKS_FP2
    engine = DeviceEngine(StarkConfig(Goldilocks, 20, 2, 15, 6), device=dev)
    m = cut(21, 13)
    coeffs = _rand_gl(rng, (m, 2), dev)
    z, alpha, dv = (12345, 67890), (99991, 31337), (777, 4242)

    def fold_div(c):
        # ``size`` only decides when the engine hands over to host scalars:
        # keep every round a tensor
        rnd = _FriRoundRepr(device=True, ke=ke, coeffs=c, codeword=None, tree=None,
                            size=max(4 * c.shape[0], 4 * (1 << 13)))
        return engine._fold_div(rnd, z, alpha, dv)[0]      # (coefficients, rows)

    def fold_work(length):
        # the fused fold-divide (ops/div_scan.py) of (length, 2) coefficients
        # to half as many: chip_smoke.py phase 3's count of its row
        return rf.div_scan_work(torch.empty((1, length, 2), device="meta"), length // 2,
                                True, "gl2")

    entry("fri_fold_div_2^21_fp2", lambda: fold_div(coeffs), 3, fold_work(m),
          lambda ms: ms, "ms", [m, 2])

    floor = min(1 << 12, m // 2)

    def fold_chain():
        cur = coeffs
        while cur.shape[0] > floor:
            cur = fold_div(cur)
        return cur

    chain_work, length = [0, 0], m
    while length > floor:
        b, o = fold_work(length)
        chain_work, length = [chain_work[0] + b, chain_work[1] + o], length // 2
    entry("fri_fold_div_chain_2^21_to_2^12", fold_chain, 2, chain_work,
          lambda ms: ms, "ms", [m, 2])
    del coeffs

    # --- batched multi-polynomial commit, 4-ary tree: 4 polynomials of 2^20
    # Fp2 coefficients to 2^21 evaluations and one coset-row tree
    bfri = BatchedFri(BatchedFriConfig(ext, blowup=2, arity=4))
    nb, npoly = cut(20, 10), 4
    polys = _rand_gl(rng, (npoly, nb, 2), dev)
    fold = bfri.cfg.fold_factor
    n_rows, C = 2 * nb // fold, npoly * fold * 2
    work = [sum(w) for w in zip(rf.ntt_work(2 * npoly, 2 * nb, False, False),
                                rf.rows_work(n_rows, C), rf.tree_work(n_rows, 4))]
    entry("batched_commit_2^20_b4_arity4", lambda: bfri.commit(polys).root(), 3, work,
          lambda ms: ms, "ms", [npoly, nb, 2])
    results[-1]["leaf_rows_per_s"] = 2 * nb / results[-1]["ms"] * 1e3
    del polys

    # --- SHA-256 tree build: 2^21 rows of 4 values, 4-ary
    nt = cut(21, 10)
    comps = _rand_gl(rng, (nt, 4), dev)
    work = [sum(w) for w in zip(rf.rows_work(nt, 4), rf.tree_work(nt, 4))]
    entry("sha_tree_2^21x4_arity4", lambda: _build_digests(comps, 4, torch.int64), 5, work,
          lambda ms: ms, "ms", [nt, 4])
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shrink", type=int, default=0,
                    help="cut every size by 2^SHRINK (dry runs)")
    args = ap.parse_args(argv)
    for r in kernel_rooflines(args.device, shrink=args.shrink):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
