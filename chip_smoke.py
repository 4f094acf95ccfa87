#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ministark_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure prints FAIL and exits 1:

  1. gpu       no CUDA device -> exit 1; else the card's name and power limit
  2. build     nvcc builds the kernels from ministark_tpu_torch/csrc
  3. kernels   each CUDA kernel against its plain PyTorch version, on the card,
               at the main paths' shapes, Goldilocks then BabyBear: exact
               equality, times in ms beside the least time the card could
               take (bound); the four-step and pipelined NTTs also whole,
               against the plain radix-2 NTT
  4. parity    the engine on the card proves Fibonacci steps 9 and 61 over
               Goldilocks and steps 7 and 13 over BabyBear, with
               DEVICE_MIN_SIZE 1 and 32; byte-identical to the host oracle
               Stark.prove, steps 9 / 7 equal to tests/golden/
               goldilocks_fib9.json / babybear_fib7.json
  5. main      the parity prover, Fibonacci over Goldilocks + Fp2, security
               20, blowup 2, witness built on the card: the pinned sizes
               against digests of the JAX package's proofs, then 2^20 - 1
               steps proved cold and warm, verified, and its two commitments
               recomputed with the plain versions on the card; then the
               2^14 - 1 pin and 2^20 - 1 cold and warm with each other NTT
               backend (ntt_backend="four_step", "pipe"), equal to the
               radix-2 proof and verified
  6. fast      the fast-mode prover (FastStark: batched FRI, 4-ary index
               trees) in bench.py's configuration: tests/golden/
               fast_fri_fib100.bin, the pinned sizes against the JAX
               package's proof bytes, 2^20 - 1 steps proved cold and warm,
               verified, both group roots recomputed with the plain versions
               on the card, then prove_many of 4 traces at 2^20 - 1, verified;
               then with each other NTT backend the 2^14 - 1 pins, 2^20 - 1
               cold and warm and prove_many of 4, equal to the radix-2 bytes
               and verified
  7. bb_main   phase 5 over BabyBear + Fp4 (bench.py's BENCH_FIELD=babybear):
               the BB_PINS sizes, 2^20 - 1 cold and warm, verified, both
               commitments recomputed with the plain versions; each other
               NTT backend at the 2^14 - 1 pin and one 2^20 - 1 prove equal to
               the radix-2 bytes, verified
  8. bb_fast   phase 6 over BabyBear + Fp4: the BB_FAST_PINS, 2^20 - 1 cold
               and warm, verified, both group roots recomputed with the plain
               versions, prove_many of 4; each other NTT backend at one
               2^20 - 1 prove equal to the radix-2 bytes, verified
  9. launches  every kernel was launched by the 2^20 - 1 proves of the paths
               it is on (counts set to 0 just before each cold prove): the
               Goldilocks multiply on every Goldilocks path, each NTT
               backend's kernels of each field on the parity and fast paths
               of that backend and field, the 10-digit leaf hash on the
               BabyBear parity paths

The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

# proof_digests() of ministark_tpu's DeviceEngine (JAX on the CPU,
# MINISTARK_DEVICE_HASH=1, witness on the device) for Fibonacci over
# Goldilocks, security 20, blowup 2: (steps) -> digests.
PINS = {
    16383: {
        "trace_commit": "cc4dc7e9f1b627fbcdeed56c42abe394af23c58abed3d682f4c909b3b9d8b838",
        "constrain_trace_commit": "2f845ad82e0a4e3cb19170f1782d7c5bf5361edfe4e588a5d63ec23f86b6175e",
        "arthur_sha256": "ad1e759bd5a957b4fb10bae83ca2dfbf62aab68e79dbca21be36e1c284d178c2",
        "fri_payload_sha256": "79f4af90c7fe2d84d1bf0c5a53f49ccd87117f7e61e99698587e30fdcc2f8e57",
    },
    131071: {
        "trace_commit": "72763a8c1c691bc112fcac785846a0671a84f9cb21c5ec43e005242e8880dfe0",
        "constrain_trace_commit": "042b108951a3d04b7e8700be0340d0356c6e1effb8a6e46b33078b6ce39ab138",
        "arthur_sha256": "c673e09e91898718a0cb5df0afb97f67a3575007deca998f7b3d1449a4dcaa1d",
        "fri_payload_sha256": "9d847020d79ea6aea27ad1293f4fe9008b6c5b23c10c5056e470f4ab6656a450",
    },
    262143: {
        "trace_commit": "ce53488b0f97be3e338ec9530ce2acb55112e9c7039944b118455968cccad8bc",
        "constrain_trace_commit": "356756c61570345dbfa60a8aebaa90d2af3504369827281c2f3b256b33050b78",
        "arthur_sha256": "360dd4a8f5b52cd83c27a0fa40edd772b83b20fa8511a12406fbba11b7a941dc",
        "fri_payload_sha256": "fba15b1963b8ed1b8a8fe4eefe2c3d76e84194b5faa1c0c32d80c6973e399cc6",
    },
    524287: {
        "trace_commit": "032c30a502d1a9e0481527521491428800a034344b5d28be2c2c2a99d784479a",
        "constrain_trace_commit": "ee0f855b99195552944fc0bcdb926481d922bae19801eb9d940e879051e58092",
        "arthur_sha256": "e12c2e956afd674555c9318263c73cac79d312241e14407ed0aa103cac9d8df8",
        "fri_payload_sha256": "1421d5fb8592fca5b9f7bdf6b05ad7178bf22c1ffa812acb32f236c34654e4cb",
    },
}
MAIN_STEPS = (1 << 20) - 1
SEED = 20261016
# the NTT backends proved after the default radix-2 one (ops/ntt.py)
NTT_BACKENDS = ("four_step", "pipe")

# sha256 of fast_proof_to_bytes of ministark_tpu's FastStark (JAX on the
# CPU, witness on the device) in bench.py::fast_prove's configuration
# (FAST_CFG): (steps, traces given to prove_many) -> digest.
FAST_PINS = {
    (16383, 1): "465c2b3d49113bc8ac0319772732acf5e6e49c3b41aca93e2e14effd31cebcd4",
    (16383, 4): "2e28bd5794f410b1dcb50fa46e1382cef3f422f945af40a70f136d76876b2eb9",
    (131071, 1): "1a378eeb1b22590fb22cb011bc165155a488b8c5ef6b15133a67fe5c61130915",
}
FAST_CFG = dict(queries=32, point_queries=2, blowup=2, arity=4, fold_factor=4,
                final_len=32, lde_backend="fri", grinding_bits=0)
FAST_BATCH = 4                     # bench.py's fast_prove_many_batch4

# The same pins over BabyBear + Fp4 (bench.py with BENCH_FIELD=babybear):
# proof_digests() of ministark_tpu's DeviceEngine and the sha256 of its
# FastStark proof bytes, both made on the CPU as PINS and FAST_PINS are.
BB_PINS = {
    16383: {
        "trace_commit": "9cb37713310ff68ae3ed993fd2fd22b7ef8b42711454962485322f08147c0498",
        "constrain_trace_commit": "2fc56ee270418f3d3dd8c1847d48101ba8332417ee8017835032b7e2854a6f1c",
        "arthur_sha256": "41609d2c2fb7e3eb08075730e7ac5e0982600444bc4e916aac41d9f29ae81111",
        "fri_payload_sha256": "074d9817a483ddda4c9df45e9caab9857f90625295191cac58aa6e8131c9c6c7",
    },
    131071: {
        "trace_commit": "764e58000985911e51bc961b7a63806b3bd9898724375370bdeea42b5817403a",
        "constrain_trace_commit": "1159dd38a289525d71adddd4802b4b5d36e24d6e32b705af9c88d40783f7d5e7",
        "arthur_sha256": "a2bc0314018846fbb5595e82bfca8c37d8e1839b493d288998caea54622df6de",
        "fri_payload_sha256": "a230a29a10e2454240440a2e02611d5ced3446a1f8a7431e209182df45795c81",
    },
}
BB_FAST_PINS = {
    (16383, 1): "6dd4dc47941ca20f4250b21b6f194a051157f80e7f0180c8d0ac07600c8b4dcc",
    (16383, 4): "d5052f1b32446e049d392ad13c64d3b0f42e2397ccaabf36d93af9a821c73570",
}

# The least time the card could take for a call (bound_ms): the larger of
# its bytes (each input read once, each output written once) over the
# H100 SXM's 3.35 TB/s, and its 32-bit integer operations over the INT32
# peak, 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.73e12 per second.
# The operation counts are lower bounds taken from the kernels' arithmetic:
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# one SHA-256 block: 64 rounds of 14 (3-input LOP3 and IADD3 fused) plus 48
# schedule steps of 10, plus the 8 feed-forward adds; a block of constant
# words needs no schedule (its words fold to immediates)
OPS_SHA_BLOCK = 64 * 14 + 48 * 10 + 8
OPS_SHA_CONST_BLOCK = 64 * 14 + 8
# Goldilocks: a product is four 32x32->64 multiplies (two instructions
# each) with 4 adds, and the reduction of gl.cuh about 17; an add 8, a sub 5
OPS_GL_MUL = 8 + 4 + 17
OPS_BUTTERFLY = OPS_GL_MUL + 8 + 5
# BabyBear (bb.cuh): a product is one 32x32->64 multiply (2), the Barrett
# step's 64-bit multiply-high (four 32x32->64 multiplies and 4 adds, 12),
# one 32-bit multiply-subtract (2) and the conditional subtraction (2); an
# add or a sub is 3 (add, compare, select)
OPS_BB_MUL = 2 + 12 + 2 + 2
OPS_BB_BUTTERFLY = OPS_BB_MUL + 3 + 3
# (product, butterfly) operations per field, by the kernels' field suffix
FIELD_OPS = {"gl": (OPS_GL_MUL, OPS_BUTTERFLY), "bb": (OPS_BB_MUL, OPS_BB_BUTTERFLY)}
OPS_DIGIT = 4                      # one decimal digit: multiply-high, shift, multiply, sub

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def timed(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, after one warm-up call, with
    CUDA events around the whole run."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |got - want| over u64 (or u32) values; 0 when identical."""
    import torch

    if got.shape != want.shape:
        return -1
    bad = got != want
    if not bool(bad.any()):
        return 0
    a = got[bad].cpu().numpy().astype(object)
    b = want[bad].cpu().numpy().astype(object)
    mod = 1 << (8 * got.element_size())
    return max(abs(int(x) % mod - int(y) % mod) for x, y in zip(a, b))


def phase_gpu():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    line = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(line, flush=True)
    say("gpu", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    sys.path.insert(0, ROOT)
    try:
        import ministark_tpu_torch  # noqa: F401
    except ImportError:
        fail("ministark_tpu_torch not found beside chip_smoke.py")
    return line


def phase_build():
    from ministark_tpu_torch.ops import cuda

    t0 = time.time()
    path = cuda.build()
    cuda.library()
    secs = time.time() - t0
    log = open(os.path.join(cuda.BUILD_DIR, "build.log")).read()
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("  ptxas " + ln.strip(), flush=True)
    say("build", f"{os.path.relpath(path, ROOT)} in {secs:.1f} s")


def _rand_u64(rng, shape, p):
    import numpy as np
    import torch

    v = rng.integers(0, p, size=shape, dtype=np.uint64)
    flat = v.reshape(-1)
    edge = np.array([e for e in (0, 1, p - 1, p - 2, p - (1 << 32), 9, 10,
                                 10**9 - 1, 10**19 - 1) if 0 <= e < p],
                    dtype=np.uint64)
    flat[: min(edge.size, flat.size)] = edge[: flat.size]
    return torch.from_numpy(v.view(np.int64)).cuda()


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sha_blocks(msg_bytes):
    """SHA-256 blocks of messages of these byte lengths (int or tensor)."""
    return (msg_bytes + 9 + 63) // 64


def _ntt_work(batch, n, coset_mul: bool, scale_mul: bool, tag="gl"):
    mul, butterfly = FIELD_OPS[tag]
    log_n = n.bit_length() - 1
    ops = batch * ((n // 2) * log_n * butterfly
                   + n * mul * (int(coset_mul) + int(scale_mul)))
    return 16 * batch * n + 8 * (n // 2), ops


def _pass_work(batch, n, stages, muls, tag="gl"):
    """One pass over (batch, n): ``stages`` radix-2 stages and ``muls``
    elementwise products per value (coset, twiddle, scale); each value read
    and written once."""
    mul, butterfly = FIELD_OPS[tag]
    ops = batch * ((n // 2) * stages * butterfly + n * mul * muls)
    return 16 * batch * n, ops


def _mul_work(a, b):
    out = a.numel() if a.numel() >= b.numel() else b.numel()
    return 8 * (a.numel() + b.numel() + out), out * OPS_GL_MUL


def _leaf_hash_work(comps, k, fmt, max_digits=20):
    """Bytes and ops of the leaf hash on these inputs: the preimage lengths
    (and so the block counts) depend on the values' decimal digits."""
    from ministark_tpu_torch.ops.leaf_hash import u64_digits

    _, length = u64_digits(comps, max_digits)       # (n, comps)
    const = {0: 0, 1: 21, 2: 63}[fmt]               # "QuadExtField(" ... " * u)"
    per_elem = length.sum(1) + const
    msg = per_elem.reshape(-1, k).sum(1)
    blocks = int(_sha_blocks(msg).sum())
    ops = blocks * OPS_SHA_BLOCK + int(length.sum()) * OPS_DIGIT
    return comps.numel() * 8 + msg.numel() * 32, ops


def _level_work(n_parents, fan):
    ops = n_parents * ((fan // 2) * OPS_SHA_BLOCK + OPS_SHA_CONST_BLOCK)
    return n_parents * (fan + 1) * 32, ops


def _rows_work(n, C):
    return n * (8 * C + 32), n * _sha_blocks(8 * C) * OPS_SHA_BLOCK


def make_compare(results):
    """compare(name, label, kern, plain, work): the kernel's output against
    its plain version's on the same inputs (exact), then both timed, into
    ``results[name]`` unless ``name`` is a whole transform."""
    import torch

    def compare(name, label, kern, plain, work, reps=5, plain_reps=2):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            fail(f"{name} {label}: kernel differs from its plain version "
                 f"(max_abs_err {err})")
        ms = timed(kern, reps)
        pms = timed(plain, plain_reps)
        bms, by = bound(*work)
        say("kernels", f"{name} {label}: equal (tolerance 0), kernel "
                       f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.3f} ms "
                       f"({by})")
        if name not in results:              # a whole transform, not a kernel
            return
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append({"shape": label, "ms": ms, "plain_ms": pms,
                            "bound_ms": bms, "bound_by": by})

    return compare


def _compare_ntts(compare, rng, F, tag, radix2_shapes, backend_shapes):
    """The NTT kernels of one prime field F (kernel names suffixed "_bb" for
    BabyBear): the radix-2 NTT at ``radix2_shapes``; at ``backend_shapes``
    the four-step passes and every pipelined level, each against its plain
    version on the same input, then each whole transform against the plain
    radix-2 NTT. A shape is (label, batch, n, transform keywords)."""
    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops import ntt_four_step as fs
    from ministark_tpu_torch.ops import ntt_pipe as pp

    sfx = "" if tag == "gl" else "_" + tag
    for label, batch, n, kw in radix2_shapes:
        x = _rand_u64(rng, (batch, n), F.p)
        work = _ntt_work(batch, n, "pre" in kw, bool(kw.get("inverse")), tag)
        compare("ntt" + sfx, label, lambda: ntt.transform_cuda(x, **kw, field=F),
                lambda: ntt.transform_plain(x, **kw, field=F), work)

    for label, batch, n, kw in backend_shapes:
        x = _rand_u64(rng, (batch, n), F.p)
        inverse, pre = bool(kw.get("inverse")), kw.get("pre")
        scale = ntt.inv_n(F, n) if inverse else None
        n1, n2 = fs._split_sizes(n)
        tw1, tw2, wpow = fs._tables(n, inverse, x.device, F)
        c = fs.pass1_cuda(x, tw2, wpow, pre, F)
        compare("ntt_four_step_pass1" + sfx, label,
                lambda: fs.pass1_cuda(x, tw2, wpow, pre, F),
                lambda: fs.pass1_plain(x, tw2, wpow, pre, F),
                _pass_work(batch, n, n2.bit_length() - 1, 1 + (pre is not None),
                           tag), plain_reps=1)
        compare("ntt_four_step_pass2" + sfx, label,
                lambda: fs.pass2_cuda(c, tw1, scale, None, F),
                lambda: fs.pass2_plain(c, tw1, scale, None, F),
                _pass_work(batch, n, n1.bit_length() - 1, int(inverse), tag),
                plain_reps=1)
        levels = pp._tables(n, inverse, x.device, F)
        y = x
        for i, (Fi, tw, W, k_prod) in enumerate(levels):
            last = i == len(levels) - 1
            args = (y.reshape(batch, Fi, n // Fi), tw, pre if i == 0 else None,
                    W, k_prod, scale if last else None, F)
            muls = int(i == 0 and pre is not None) + int(W is not None) + int(
                last and inverse)
            compare("ntt_pipe_level" + sfx, f"{label} level {i} (F {Fi})",
                    lambda: pp.level_cuda(*args), lambda: pp.level_plain(*args),
                    _pass_work(batch, n, Fi.bit_length() - 1, muls, tag),
                    plain_reps=1)
            y = pp.level_cuda(*args)
        work = _ntt_work(batch, n, pre is not None, inverse, tag)
        for name, mod in (("four_step", fs), ("pipe", pp)):
            compare(f"{name} transform{sfx}", label,
                    lambda: mod.transform(x, **kw, field=F),
                    lambda: ntt.transform_plain(x, **kw, field=F), work,
                    plain_reps=1)


def _compare_leaf_hash(compare, rng, F, name, shapes):
    """The leaf hash at ``shapes`` of (label, groups, k, fmt), with F's digit
    bound; a quarter of the values made short, for every block count."""
    from ministark_tpu_torch.ops import leaf_hash as lh

    md = lh.digits_for(F)
    for label, groups, k, fmt in shapes:
        comps = _rand_u64(rng, (groups * k, lh._FMT_COMPS[fmt]), F.p)
        comps[: groups // 4] %= 1000
        compare(name, label, lambda: lh.leaf_hash_cuda(comps, k, fmt, md),
                lambda: lh.leaf_hash_plain(comps, k, fmt, md),
                _leaf_hash_work(comps, k, fmt, md), reps=3, plain_reps=1)


def phase_kernels(results):
    import numpy as np
    import torch

    from ministark_tpu_torch.fields import GOLDILOCKS_FP as F
    from ministark_tpu_torch.ops import field as gl
    from ministark_tpu_torch.ops import sha256 as sh

    rng = np.random.default_rng(SEED)
    compare = make_compare(results)

    # K1 at every main-path shape (the parity prover's; the fast mode's are
    # (6, 2^20) ifft, (12, 2^21) fft and its FRI layers), then K4 / K6 at
    # the main paths' transforms
    shift = 0x1234567 * 7 % F.p
    _compare_ntts(compare, rng, F, "gl", [
        ("ifft (3, 2^20)", 3, 1 << 20, {"inverse": True}),
        ("coset_fft (6, 2^21)", 6, 1 << 21, {"pre": shift}),
        ("fft (2, 2^21)", 2, 1 << 21, {}),
        ("fft (12, 2^21)", 12, 1 << 21, {}),
        ("fft (2, 2^3)", 2, 1 << 3, {}),
        ("coset_ifft (2, 2^14)", 2, 1 << 14, {"inverse": True, "post": shift}),
    ], [
        ("ifft (3, 2^20)", 3, 1 << 20, {"inverse": True}),
        ("coset_fft (6, 2^21)", 6, 1 << 21, {"pre": shift}),
        ("fft (12, 2^21)", 12, 1 << 21, {}),
    ])

    # K5: the field multiply, flat and broadcast over a batch of rows (the
    # coset powers times the LDE rows)
    a, b = _rand_u64(rng, (6, 1 << 21), F.p), _rand_u64(rng, (1 << 21,), F.p)
    for label, x, y in [("(2^21,) x (2^21,)", a[0], b),
                        ("(6, 2^21) x (2^21,) broadcast", a, b)]:
        compare("gl_mul", label, lambda: gl.mul_cuda(x, y),
                lambda: gl.mul_plain(x, y), _mul_work(x, y), reps=10)

    # K3: leaf hashes of the trace / constraint trees (fmt 0, 6 per group)
    # and of the first FRI round tree (fmt 1, 2 per group)
    _compare_leaf_hash(compare, rng, F, "leaf_hash", [
        ("fmt 0, k 6, 2^21 groups", 1 << 21, 6, 0),
        ("fmt 1, k 2, 2^20 groups", 1 << 20, 2, 1),
    ])

    # K2: every fan-2 level of a 2^21-leaf tree, and the fast mode's fan-4
    # level above a 2^19-leaf index tree
    leaves = torch.from_numpy(rng.integers(-2**31, 2**31, size=(1 << 21, 8),
                                           dtype=np.int64).astype(np.int32)).cuda()

    def levels(fn):
        def run():
            cur, out = leaves, []
            while cur.shape[0] > 1:
                cur = fn(cur)
                out.append(cur)
            return torch.cat(out)
        return run

    work = [sum(w) for w in zip(*(_level_work(1 << j, 2) for j in range(21)))]
    compare("sha256_inner_level", "all 21 levels of a 2^21-leaf tree",
            levels(sh.inner_level_cuda), levels(sh.inner_level_plain), work,
            reps=5, plain_reps=1)
    d4 = leaves[: 1 << 19]
    compare("sha256_inner_level", "fan 4, 2^19 -> 2^17",
            lambda: sh.inner_level_cuda(d4, 4), lambda: sh.inner_level_plain(d4, 4),
            _level_work(1 << 17, 4))

    # K2b: the fast mode's row leaves over 2^19 coset rows: the witness group
    # (6 polynomials x F 4 x Fp2 = 48 u64 per row), the validity group and
    # every FRI layer (C 8), and prove_many's witness group of 4 traces (192)
    for C in (48, 8, 192):
        comps = _rand_u64(rng, (1 << 19, C), F.p)
        compare("sha256_rows", f"2^19 rows, C {C}",
                lambda: sh.binary_row_digests_cuda(comps),
                lambda: sh.binary_row_digests_plain(comps),
                _rows_work(1 << 19, C), reps=5, plain_reps=1)


def phase_kernels_bb(results):
    """Phase 3 over BabyBear: the NTT, four-step and pipe kernels at the
    BabyBear main paths' shapes (the Fp4 FRI codewords and the fast LDE are
    batches of 4 components per polynomial), the 10-digit leaf hash in
    formats 0 and 2, and the BabyBear row-leaf width."""
    import numpy as np

    from ministark_tpu_torch.fields import BABYBEAR_FP as F
    from ministark_tpu_torch.ops import sha256 as sh

    rng = np.random.default_rng(SEED + 1)
    compare = make_compare(results)
    shift = 0x1234567 * 7 % F.p

    # K1: trace ifft, constraint LDE, the FRI rounds' Fp4 codewords (4
    # components, 2^21 down to the last device round) and the fast LDE of
    # 6 polynomials x 4 components; K4 / K5 at the main paths' transforms
    _compare_ntts(compare, rng, F, "bb", [
        ("ifft (3, 2^20)", 3, 1 << 20, {"inverse": True}),
        ("coset_fft (6, 2^21)", 6, 1 << 21, {"pre": shift}),
        ("fft (4, 2^21)", 4, 1 << 21, {}),
        ("fft (4, 2^14)", 4, 1 << 14, {}),
        ("fft (24, 2^21)", 24, 1 << 21, {}),
    ], [
        ("ifft (3, 2^20)", 3, 1 << 20, {"inverse": True}),
        ("coset_fft (6, 2^21)", 6, 1 << 21, {"pre": shift}),
        ("fft (24, 2^21)", 24, 1 << 21, {}),
    ])

    # K2: the 10-digit leaf hash of the trace tree (3 x 2^20 values, 6 per
    # group), the constraint tree (6 x 2^21) and the first FRI round's Fp4
    # tree (fmt 2, 2 per group)
    _compare_leaf_hash(compare, rng, F, "leaf_hash_bb", [
        ("fmt 0, k 6, 2^19 groups", 1 << 19, 6, 0),
        ("fmt 0, k 6, 2^21 groups", 1 << 21, 6, 0),
        ("fmt 2, k 2, 2^20 groups", 1 << 20, 2, 2),
    ])

    # K2b: the fast mode's BabyBear witness rows (6 polynomials x F 4 x 4
    # components = 96 u64 per row) over 2^19 coset rows
    comps = _rand_u64(rng, (1 << 19, 96), F.p)
    compare("sha256_rows", "2^19 rows, C 96 (BabyBear witness group)",
            lambda: sh.binary_row_digests_cuda(comps),
            lambda: sh.binary_row_digests_plain(comps),
            _rows_work(1 << 19, 96), reps=5, plain_reps=1)


def _host_proof(sf, steps):
    from ministark_tpu_torch.models import FibonacciClaim, Witness
    from ministark_tpu_torch.stark import Stark, StarkConfig

    base = sf.base
    witness = Witness(secret_b=base.from_int(2))
    claim = FibonacciClaim(field=base, step=steps, output=base.from_int(13))
    trace = claim.trace(witness)
    cfg = StarkConfig(sf, 20, 2, steps, trace.constrain_number())
    return Stark(cfg).prove(claim, witness)


def _assert_equal_proofs(host, dev):
    assert dev.trace_commit == host.trace_commit, "trace_commit"
    assert dev.constrain_trace_commit == host.constrain_trace_commit, "constrain commit"
    assert dev.arthur == host.arthur, "transcript"
    assert dev.constrain_queries == host.constrain_queries, "constrain queries"
    assert dev.validity_queries == host.validity_queries, "validity queries"
    fri = dev.fri_proof.to_host()
    assert fri.points == host.fri_proof.points, "FRI points"
    assert fri.quotients == host.fri_proof.quotients, "FRI quotients"
    for rd, rh in zip(fri.queries, host.fri_proof.queries):
        for (d1, d2), (h1, h2) in zip(rd, rh):
            assert d1.leaf_neighbours == h1.leaf_neighbours, "leaf neighbours"
            assert d1.path == h1.path and d2.path == h2.path, "Merkle paths"
            assert d2.leaf_neighbours == h2.leaf_neighbours, "leaf neighbours"


def _stark_field(name):
    from ministark_tpu_torch.fields import BabyBear, Goldilocks

    return {"gl": Goldilocks, "bb": BabyBear}[name]


def _engine(steps, on_device=True, ntt_backend="radix2", field="gl"):
    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark.engine import DeviceEngine

    sf = _stark_field(field)
    trace = fibonacci_device_trace(sf, steps, on_device=on_device, device="cuda")
    cfg = StarkConfig(sf, 20, 2, steps, trace.constrain_number())
    return DeviceEngine(cfg, device="cuda", ntt_backend=ntt_backend), trace


def phase_parity():
    from ministark_tpu_torch.stark import StarkProof
    from ministark_tpu_torch.stark import engine as eng
    from ministark_tpu_torch.stark.proof_io import proof_to_json

    default = eng.DEVICE_MIN_SIZE
    try:
        for field, golden_steps, steps_list, golden_name in (
                ("gl", 9, (9, 61), "goldilocks_fib9.json"),
                ("bb", 7, (7, 13), "babybear_fib7.json")):
            sf = _stark_field(field)
            golden = json.load(open(os.path.join(ROOT, "tests", "golden",
                                                 golden_name)))
            for steps in steps_list:
                host = _host_proof(sf, steps)
                for dms in (1, 32):
                    eng.DEVICE_MIN_SIZE = dms
                    engine, trace = _engine(steps, field=field)
                    proof = engine.prove(trace)
                    _assert_equal_proofs(host, proof)
                    assert engine.verify(engine.constrain_coeffs(trace), proof)
                    if steps == golden_steps:
                        assert json.loads(proof_to_json(sf, proof)) == golden, \
                            "golden fixture"
                        bad = StarkProof(**{**proof.__dict__, "arthur": bytes(
                            [proof.arthur[0] ^ 1]) + proof.arthur[1:]})
                        try:
                            engine.verify(engine.constrain_coeffs(trace), bad)
                            fail("a flipped transcript byte was accepted")
                        except AssertionError:
                            pass
                    say("parity", f"{sf.name} steps {steps}, DEVICE_MIN_SIZE "
                                  f"{dms}: byte-identical to Stark.prove, "
                                  "verified"
                                  + (f", equal to {golden_name}, tamper "
                                     "rejected" if steps == golden_steps else ""))
    except AssertionError as e:
        fail(f"parity: {e}")
    finally:
        eng.DEVICE_MIN_SIZE = default


def _reference_commits(engine, trace):
    """The two commitments of a prove, recomputed on the card with the
    plain versions of all three kernels."""
    import torch

    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops.leaf_hash import digits_for, leaf_hash_plain
    from ministark_tpu_torch.ops.sha256 import digests_to_bytes, inner_level_plain
    from ministark_tpu_torch.transcript.merlin import Merlin

    cfg = engine.config
    base = cfg.stark_field.base
    k = cfg.merkle_config.leafs_per_node

    def root(rows):
        cur = leaf_hash_plain(rows.reshape(-1, 1), k, 0, digits_for(base))
        while cur.shape[0] > 1:
            cur = inner_level_plain(cur)
        return digests_to_bytes(cur)[0].tobytes()

    cols = trace.cols_dev
    n = cols.shape[1]
    trace_root = root(cols.T.contiguous())
    merlin = Merlin(cfg.io)
    merlin.add_bytes(trace_root)
    shift = merlin.challenge_scalar(base)
    tp = ntt.transform_plain(cols, inverse=True, field=base)
    coeffs = torch.cat([tp] + [f(tp)[None] for f in trace.transitions])
    padded = torch.zeros((coeffs.shape[0], 2 * n), dtype=torch.int64,
                         device=cols.device)
    padded[:, :n] = coeffs
    lde = ntt.transform_plain(padded, pre=shift, field=base)
    return trace_root, root(lde.T.contiguous())


def reset_counts():
    """Set every kernel wrapper's launch count to 0."""
    from ministark_tpu_torch.ops import field as gl
    from ministark_tpu_torch.ops import leaf_hash as lh
    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops import ntt_four_step as fs
    from ministark_tpu_torch.ops import ntt_pipe as pp
    from ministark_tpu_torch.ops import sha256 as sh

    for counts in (ntt.launches, lh.launches, fs.pass1_launches,
                   fs.pass2_launches, pp.launches):
        for key in counts:
            counts[key] = 0
    sh.launches = sh.row_launches = gl.launches = 0
    sh.fan_launches = {}


def read_counts():
    """({kernel: launches}, {fan: inner-level launches}) since reset_counts,
    with each NTT kernel and the leaf hash split by field ("_bb")."""
    from ministark_tpu_torch.ops import field as gl
    from ministark_tpu_torch.ops import leaf_hash as lh
    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops import ntt_four_step as fs
    from ministark_tpu_torch.ops import ntt_pipe as pp
    from ministark_tpu_torch.ops import sha256 as sh

    counts = {"sha256_inner_level": sh.launches, "sha256_rows": sh.row_launches,
              "gl_mul": gl.launches, "leaf_hash": lh.launches[20],
              "leaf_hash_bb": lh.launches[10]}
    for tag, suffix in (("gl", ""), ("bb", "_bb")):
        counts["ntt" + suffix] = ntt.launches[tag]
        counts["ntt_four_step_pass1" + suffix] = fs.pass1_launches[tag]
        counts["ntt_four_step_pass2" + suffix] = fs.pass2_launches[tag]
        counts["ntt_pipe_level" + suffix] = pp.launches[tag]
    return counts, dict(sh.fan_launches)


def record(results, path, launches):
    """The kernels a path's 2^20 - 1 prove launched, under that path."""
    for name, count in launches.items():
        if count:
            results[name]["paths"][path] = count


def phase_main(results, field="gl"):
    """The parity prover at its pins and at 2^20 - 1, then each other NTT
    backend: Goldilocks proves each backend cold and warm, BabyBear once."""
    import torch

    from ministark_tpu_torch.stark.engine import DeviceEngine
    from ministark_tpu_torch.stark.proof_io import proof_digests

    sf = _stark_field(field)
    pins = PINS if field == "gl" else BB_PINS
    label = "main" if field == "gl" else "bb_main"
    path = "parity" if field == "gl" else "parity_bb"
    for steps, want in pins.items():
        engine, trace = _engine(steps, field=field)
        t0 = time.time()
        proof = engine.prove(trace)
        secs = time.time() - t0
        got = proof_digests(sf, proof)
        if got != want:
            fail(f"{sf.name} steps {steps}: digests differ from the JAX pins: {got}")
        if not engine.verify(engine.constrain_coeffs(trace), proof):
            fail(f"{sf.name} steps {steps}: verify returned False")
        say(label, f"steps {steps}: equal to the JAX package's pinned "
                   f"digests, verified; prove {secs:.2f} s")

    t0 = time.time()
    engine, trace = _engine(MAIN_STEPS, field=field)
    torch.cuda.synchronize()
    say(label, f"steps {MAIN_STEPS}: witness (3, {trace.domain_size}) built on "
               f"the card in {time.time() - t0:.3f} s")

    reset_counts()
    t0 = time.time()
    proof = engine.prove(trace)
    cold = time.time() - t0
    launches, _ = read_counts()
    cold_phases = engine.phase_seconds
    say(label, f"cold prove {cold:.3f} s; phase_seconds "
               + json.dumps({k: round(v, 4) for k, v in cold_phases.items()}))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    proof2 = engine.prove(trace)
    warm = time.time() - t0
    say(label, f"warm prove {warm:.3f} s; peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
               "phase_seconds "
               + json.dumps({k: round(v, 4) for k, v in engine.phase_seconds.items()}))
    d1, d2 = proof_digests(sf, proof), proof_digests(sf, proof2)
    if d1 != d2:
        fail(f"{sf.name}: cold and warm proofs differ")
    say(label, "digests " + json.dumps(d1))

    t0 = time.time()
    coeffs = engine.constrain_coeffs(trace)
    ok = engine.verify(coeffs, proof)
    torch.cuda.synchronize()
    vsecs = time.time() - t0
    if not ok:
        fail(f"{sf.name}: verify returned False")
    say(label, f"verify True in {vsecs:.3f} s")

    trace_root, constrain_root = _reference_commits(engine, trace)
    if trace_root != proof.trace_commit:
        fail(f"{sf.name}: trace_commit differs from the plain versions' commitment")
    if constrain_root != proof.constrain_trace_commit:
        fail(f"{sf.name}: constrain_trace_commit differs from the plain "
             "versions' commitment")
    say(label, "trace_commit and constrain_trace_commit equal the plain "
               "versions' on the card")
    record(results, path, launches)

    for backend in NTT_BACKENDS:
        small, strace = _engine(16383, ntt_backend=backend, field=field)
        if proof_digests(sf, small.prove(strace)) != pins[16383]:
            fail(f"{sf.name} {backend}: steps 16383 differ from the JAX pins")
        bengine = DeviceEngine(engine.config, device="cuda", ntt_backend=backend)
        reset_counts()
        t0 = time.time()
        proof = bengine.prove(trace)
        cold = time.time() - t0
        launches, _ = read_counts()
        cold_phases = bengine.phase_seconds
        if proof_digests(sf, proof) != d1:
            fail(f"{sf.name} {backend}: the 2^20 - 1 proof differs from the "
                 "radix-2 proof")
        if not bengine.verify(bengine.constrain_coeffs(trace), proof):
            fail(f"{sf.name} {backend}: verify returned False")
        say(label, f"ntt_backend={backend}: steps 16383 equal to the JAX pins; "
                   f"steps {MAIN_STEPS} equal to the radix-2 proof, verified; "
                   f"cold prove {cold:.3f} s, phase_seconds "
                   + json.dumps({k: round(v, 4) for k, v in cold_phases.items()}))
        if field == "gl":
            t0 = time.time()
            proof2 = bengine.prove(trace)
            warm = time.time() - t0
            if proof_digests(sf, proof2) != d1:
                fail(f"{backend}: the warm 2^20 - 1 proof differs from the "
                     "radix-2 proof")
            say(label, f"ntt_backend={backend}: warm prove {warm:.3f} s; "
                       "phase_seconds "
                       + json.dumps({k: round(v, 4)
                                     for k, v in bengine.phase_seconds.items()}))
        record(results, f"{path}_{backend}", launches)


def _fast(steps, batch=1, ntt_backend="radix2", field="gl", **cfg):
    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig

    sf = _stark_field(field)
    traces = [fibonacci_device_trace(sf, steps, on_device=True, device="cuda")
              for _ in range(batch)]
    stark = FastStark(FastStarkConfig(sf, steps, **(cfg or FAST_CFG)),
                      device="cuda", ntt_backend=ntt_backend)
    return stark, traces


def _fast_reference_roots(stark, trace):
    """Both group roots of a fast prove, recomputed on the card with the
    plain versions of the NTT, row-leaf and inner-level kernels, and the
    coset-row layout written out here afresh."""
    import torch

    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops import sha256 as sh
    from ministark_tpu_torch.ops.field import lift_base_array
    from ministark_tpu_torch.ops.poly import mix_columns

    cfg, ke, ext = stark.config, stark.ke, stark.ext
    F, arity = cfg.fold_factor, cfg.arity
    d = ext.extension_degree

    def coset_rows(polys):                       # (B, n, d) coefficients
        B, n = polys.shape[0], polys.shape[1]
        N = cfg.blowup * n
        padded = torch.zeros((d * B, N), dtype=torch.int64, device=polys.device)
        padded[:, :n] = polys.movedim(-1, 1).reshape(d * B, n)
        ev = ntt.transform_plain(padded, field=stark.base).reshape(B, d, N)
        # row i: for each polynomial, for t < F, the d components of the
        # value at i + t * N / F
        rows = ev.reshape(B, d, F, N // F).permute(3, 0, 2, 1)
        return rows.reshape(N // F, B * F * d).contiguous()

    def root(rows):
        cur = sh.binary_row_digests_plain(rows)
        while cur.shape[0] > 1:
            cur = sh.inner_level_plain(cur, min(arity, cur.shape[0]))
        return sh.digests_to_bytes(cur)[0].tobytes()

    tp = ntt.transform_plain(trace.cols_dev, inverse=True, field=stark.base)
    coeffs = lift_base_array(ke, torch.cat([tp] + [f(tp)[None]
                                                   for f in trace.transitions]))
    root_w = root(coset_rows(coeffs))
    total = coeffs.shape[0]
    tr = stark._transcript(trace.width, total - trace.width, tp.shape[1], 1)
    tr.absorb(root_w)
    r = tr.challenge_scalar(ext)
    weights = ke.pack([ext.pow(r, i) for i in range(total)], coeffs.device)
    root_v = root(coset_rows(mix_columns(ke, coeffs, weights)[None]))
    return root_w, root_v


def phase_fast(results, field="gl"):
    """The fast prover: Goldilocks with its golden fixture, pins, 2^20 - 1
    cold/warm, prove_many of 4, and each other backend at its pins, cold,
    warm and prove_many; BabyBear with its pins, 2^20 - 1 cold/warm,
    prove_many of 4, and each other backend at one 2^20 - 1 prove."""
    import copy
    import hashlib

    import torch

    from ministark_tpu_torch.stark.proof_io import (
        fast_proof_from_bytes,
        fast_proof_to_bytes,
    )

    sf = _stark_field(field)
    pins = FAST_PINS if field == "gl" else BB_FAST_PINS
    label = "fast" if field == "gl" else "bb_fast"
    path = "fast" if field == "gl" else "fast_bb"

    def proof_bytes(proof):
        return fast_proof_to_bytes(sf, proof)

    if field == "gl":
        # the golden fixture (tests/test_golden_proofs.py's configuration)
        stark, (trace,) = _fast(100, queries=4, final_len=8)
        golden = open(os.path.join(ROOT, "tests", "golden",
                                   "fast_fri_fib100.bin"), "rb").read()
        proof = stark.prove(trace)
        if proof_bytes(proof) != golden:
            fail("fast: steps 100 differ from tests/golden/fast_fri_fib100.bin")
        cons = stark._constraint_polys(trace)
        if not stark.verify(cons, fast_proof_from_bytes(sf, golden)):
            fail("fast: the golden proof was not accepted")
        bad = copy.deepcopy(proof)
        row = bytearray(bad.fri_proof.batch_openings[0][0].row)
        row[3] ^= 0x10
        bad.fri_proof.batch_openings[0][0].row = bytes(row)
        try:
            stark.verify(cons, bad)
            fail("fast: a tampered batch row was accepted")
        except AssertionError:
            pass
        say(label, "steps 100: equal to fast_fri_fib100.bin, verified, "
                   "tampered row rejected")

    for (steps, batch), pin in pins.items():
        stark, traces = _fast(steps, batch, field=field)
        t0 = time.time()
        proof = stark.prove_many(traces)
        secs = time.time() - t0
        got = hashlib.sha256(proof_bytes(proof)).hexdigest()
        if got != pin:
            fail(f"{label}: steps {steps} x {batch}: sha256 {got} differs from "
                 "the JAX pin")
        if not stark.verify_many([stark._constraint_polys(t) for t in traces],
                                 proof):
            fail(f"{label}: steps {steps} x {batch}: verify returned False")
        say(label, f"steps {steps} x {batch} traces: equal to the JAX "
                   f"package's pinned proof bytes, verified; prove {secs:.2f} s")

    stark, (trace,) = _fast(MAIN_STEPS, field=field)
    reset_counts()
    t0 = time.time()
    proof = stark.prove(trace)
    cold = time.time() - t0
    launches, fans = read_counts()
    say(label, f"steps {MAIN_STEPS}: cold prove {cold:.3f} s; phase_seconds "
               + json.dumps({k: round(v, 4) for k, v in stark.phase_seconds.items()}))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    proof2 = stark.prove(trace)
    warm = time.time() - t0
    say(label, f"steps {MAIN_STEPS}: warm prove {warm:.3f} s; peak device "
               f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
               "phase_seconds "
               + json.dumps({k: round(v, 4) for k, v in stark.phase_seconds.items()}))
    blob = proof_bytes(proof)
    if proof_bytes(proof2) != blob:
        fail(f"{label}: cold and warm proofs differ")
    t0 = time.time()
    ok = stark.verify(stark._constraint_polys(trace), proof)
    torch.cuda.synchronize()
    vsecs = time.time() - t0
    if not ok:
        fail(f"{label}: verify returned False")
    say(label, f"steps {MAIN_STEPS}: {len(blob)} proof bytes, sha256 "
               f"{hashlib.sha256(blob).hexdigest()}; verify True in {vsecs:.3f} s")
    roots = _fast_reference_roots(stark, trace)
    if list(roots) != proof.fri_proof.group_roots:
        fail(f"{label}: the group roots differ from the plain versions' roots")
    say(label, "tree_w and tree_v roots equal the plain versions' on the card")
    record(results, path, launches)
    if fans.get(4, 0) <= 0:
        fail(f"{label}: the fan-4 inner level was not launched")
    say(label, f"inner-level launches by fan: {json.dumps(fans)}")
    del proof, proof2, stark, trace

    stark, traces = _fast(MAIN_STEPS, FAST_BATCH, field=field)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    proof = stark.prove_many(traces)
    secs = time.time() - t0
    cons = [stark._constraint_polys(t) for t in traces]
    t0 = time.time()
    ok = stark.verify_many(cons, proof)
    vsecs = time.time() - t0
    if not ok:
        fail(f"{label}: prove_many verify returned False")
    say(label, f"steps {MAIN_STEPS} x {FAST_BATCH} traces (prove_many): "
               f"prove {secs:.3f} s ({secs / FAST_BATCH:.3f} s per trace), "
               f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
               f"GiB, {len(proof_bytes(proof))} proof bytes, verify True in "
               f"{vsecs:.3f} s; phase_seconds "
               + json.dumps({k: round(v, 4) for k, v in stark.phase_seconds.items()}))
    many_blob = proof_bytes(proof)
    del proof

    for backend in NTT_BACKENDS:
        if field == "gl":
            for (steps, batch), pin in pins.items():
                if steps != 16383:
                    continue
                bstark, btraces = _fast(steps, batch, ntt_backend=backend)
                got = hashlib.sha256(proof_bytes(bstark.prove_many(btraces))
                                     ).hexdigest()
                if got != pin:
                    fail(f"fast {backend}: steps {steps} x {batch} differ from "
                         "the JAX pin")
        bstark, _ = _fast(MAIN_STEPS, 0, ntt_backend=backend, field=field)
        reset_counts()
        t0 = time.time()
        proof = bstark.prove(traces[0])
        cold = time.time() - t0
        launches, _ = read_counts()
        cold_phases = bstark.phase_seconds
        if proof_bytes(proof) != blob:
            fail(f"{label} {backend}: the 2^20 - 1 proof differs from the "
                 "radix-2 proof")
        if not bstark.verify(bstark._constraint_polys(traces[0]), proof):
            fail(f"{label} {backend}: verify returned False")
        say(label, f"ntt_backend={backend}: steps {MAIN_STEPS} equal to the "
                   f"radix-2 proof, verified; cold prove {cold:.3f} s, "
                   "phase_seconds "
                   + json.dumps({k: round(v, 4) for k, v in cold_phases.items()}))
        record(results, f"{path}_{backend}", launches)
        if field != "gl":
            continue
        t0 = time.time()
        proof2 = bstark.prove(traces[0])
        warm = time.time() - t0
        if proof_bytes(proof2) != blob:
            fail(f"fast {backend}: the warm 2^20 - 1 proof differs from the "
                 "radix-2 proof")
        say(label, f"ntt_backend={backend}: steps 16383 x 1 and x 4 equal to "
                   f"the JAX pins; warm prove {warm:.3f} s; phase_seconds "
                   + json.dumps({k: round(v, 4)
                                 for k, v in bstark.phase_seconds.items()}))
        del proof, proof2
        t0 = time.time()
        proof = bstark.prove_many(traces)
        secs = time.time() - t0
        if proof_bytes(proof) != many_blob:
            fail(f"fast {backend}: prove_many differs from the radix-2 proof")
        if not bstark.verify_many(cons, proof):
            fail(f"fast {backend}: prove_many verify returned False")
        say(label, f"ntt_backend={backend}: steps {MAIN_STEPS} x {FAST_BATCH} "
                   f"traces (prove_many) equal to the radix-2 proof, verified; "
                   f"prove {secs:.3f} s ({secs / FAST_BATCH:.3f} s per trace)")
        del proof


_BACKEND_PATHS = tuple(f"{p}_{b}" for p in ("parity", "fast") for b in NTT_BACKENDS)
_BB_PATHS = ("parity_bb", "fast_bb")
# name -> (source, the TPU kernel it replaces, the paths whose 2^20 - 1 prove
# must launch it). The BabyBear entries are the same sources' bb
# instantiations (the NTTs) and 10-digit path (the leaf hash).
KERNELS = {
    "ntt": ("ministark_tpu_torch/csrc/ntt.cu",
            "ministark_tpu/ops/ntt_mxu.py:370", ("parity", "fast")),
    "sha256_inner_level": ("ministark_tpu_torch/csrc/sha256.cu",
                           "ministark_tpu/ops/sha256_pallas.py:113",
                           ("parity", "fast") + _BB_PATHS),
    "leaf_hash": ("ministark_tpu_torch/csrc/leaf_hash.cu",
                  "ministark_tpu/ops/sha256_pallas.py:163", ("parity",)),
    "sha256_rows": ("ministark_tpu_torch/csrc/sha256.cu",
                    "ministark_tpu/ops/sha256_pallas.py:113",
                    ("fast", "fast_bb")),
    "gl_mul": ("ministark_tpu_torch/csrc/gl_mul.cu",
               "ministark_tpu/ops/pallas_kernels.py:36",
               ("parity", "fast") + _BACKEND_PATHS),
    "ntt_four_step_pass1": ("ministark_tpu_torch/csrc/ntt_four_step.cu",
                            "ministark_tpu/ops/ntt_pallas.py:190",
                            ("parity_four_step", "fast_four_step")),
    "ntt_four_step_pass2": ("ministark_tpu_torch/csrc/ntt_four_step.cu",
                            "ministark_tpu/ops/ntt_pallas.py:204",
                            ("parity_four_step", "fast_four_step")),
    "ntt_pipe_level": ("ministark_tpu_torch/csrc/ntt_pipe.cu",
                       "ministark_tpu/ops/ntt_mxu.py:486",
                       ("parity_pipe", "fast_pipe")),
    "ntt_bb": ("ministark_tpu_torch/csrc/ntt.cu",
               "ministark_tpu/ops/ntt_mxu.py:370", _BB_PATHS),
    "leaf_hash_bb": ("ministark_tpu_torch/csrc/leaf_hash.cu",
                     "ministark_tpu/ops/sha256_pallas.py:163", ("parity_bb",)),
    "ntt_four_step_pass1_bb": ("ministark_tpu_torch/csrc/ntt_four_step.cu",
                               "ministark_tpu/ops/ntt_pallas.py:190",
                               ("parity_bb_four_step", "fast_bb_four_step")),
    "ntt_four_step_pass2_bb": ("ministark_tpu_torch/csrc/ntt_four_step.cu",
                               "ministark_tpu/ops/ntt_pallas.py:204",
                               ("parity_bb_four_step", "fast_bb_four_step")),
    "ntt_pipe_level_bb": ("ministark_tpu_torch/csrc/ntt_pipe.cu",
                          "ministark_tpu/ops/ntt_mxu.py:486",
                          ("parity_bb_pipe", "fast_bb_pipe")),
}


def main():
    t_start = time.time()
    smi = phase_gpu()
    import torch

    phase_build()
    results = {name: {"max_abs_err": 0, "shapes": [], "paths": {}}
               for name in KERNELS}
    phase_kernels(results)
    phase_kernels_bb(results)
    phase_parity()
    phase_main(results)
    phase_fast(results)
    phase_main(results, "bb")
    phase_fast(results, "bb")

    for name, (_, _, paths) in KERNELS.items():
        for path in paths:
            if results[name]["paths"].get(path, 0) <= 0:
                fail(f"{name} was not launched by the {path} 2^20 - 1 prove")
    say("launches", json.dumps({k: r["paths"] for k, r in results.items()}))
    say("done", f"all phases in {time.time() - t_start:.1f} s")

    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        r = results[name]
        main_shape = max(r["shapes"], key=lambda s: s["ms"])
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(r["paths"].values()),
                        "launches_by_path": r["paths"],
                        "max_abs_err": r["max_abs_err"],
                        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
                        "bound_ms": main_shape["bound_ms"],
                        "bound_by": main_shape["bound_by"],
                        # torch has no Goldilocks or BabyBear NTT, no SHA-256
                        # and no modular u64 multiply
                        "library_ms": None,
                        "shape": main_shape["shape"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception as e:  # any phase error: report it and exit non-zero
        import traceback

        traceback.print_exc()
        fail(f"{type(e).__name__}: {e}")
