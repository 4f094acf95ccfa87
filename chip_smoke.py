#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ministark_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure prints FAIL and exits 1:

  1. gpu       no CUDA device -> exit 1; else the card's name and power limit
  2. build     nvcc builds the kernels from ministark_tpu_torch/csrc; every
               leaf_hash, ntt, ntt_four_step, ntt_pipe, stream, digit level,
               digit dot, div_scan, pow_dot, field_ew (gl_ew, bb_ew),
               bb_fp4_mul and first_match instantiation has a 0-byte stack frame and no
               spill, and the digit kernels' SASS holds the warpgroup MMA
               (IGMMA) and no mma.sync (IMMA)
  3. kernels   each CUDA kernel against its plain PyTorch version, on the card,
               at the main paths' shapes, Goldilocks then BabyBear: exact
               equality, times in ms beside the least time the card could
               take (bound), the radix-2 NTT also at a three-pass 2^23 and
               with its launches per call; the four-step passes (pass 2 with
               the coset post-multiply at a coset_ifft shape) and every
               pipelined level with their device time and bound_frac; the
               four-step and pipelined NTTs also whole,
               against the plain radix-2 NTT; both paths of the base
               product, the Fp2 product at the provers' shapes, and the
               leaf hash at every SHA-256 padding boundary; the products'
               and the leaf hash's lines split the host's time per call
               from the card's; the division scan and pow_dot
               (csrc/div_scan.cu) in Fp2 and Fp4 at the FRI and query
               rounds' shapes and the point evaluations' (eval_many's one
               point over 6 and 24 rows, STIR's eval_points and WHIR's
               sumcheck_evals over their broadcast polynomial, each one
               launch through the function), with device ms and bound_frac,
               one launch a call, 50 calls back to back and 3 CUDA-graph
               replays equal to the plain result; the first-occurrence leaf
               search (csrc/leaf_search.cu) at the query rounds' (2^21, 2)
               and (2^21, 4) with 6 rows, a resident block (2^20, 2) and 64
               rows, planted rows (first matches before later copies in
               other blocks and in one warp, indices 0 and n - 1, absent
               rows), device ms and bound_frac, one launch a call, 50 calls
               back to back and 3 graph replays; the field ops (csrc/field_ew.cu:
               Goldilocks add, sub, neg and their Fp2 forms, BabyBear add,
               sub, neg, mul and their Fp4 forms, the Fp4 product; the Fp2
               product by a base scalar on gl_mul) at 2^21 elements, with a
               broadcast, a strided and a CPU-scalar case each, device ms
               and bound_frac, one call and one launch through the op the
               provers call; a row's device ms is timed with its operands
               out of L2 (as its bound counts their bytes), beside its
               warm_device_ms; every BabyBear wrapper refuses an int64
               operand (int64_refused)
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
               2^14 - 1 pin and one 2^20 - 1 prove with each other NTT
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
  9. stir_whir the fast prover with the STIR and the WHIR low-degree tests
               (lde_backend="stir" / "whir", fri/{stir,whir}.py) in FAST_CFG:
               tests/golden/fast_{stir,whir}_fib100.bin proved on the card,
               decoded and verified; the STIR_PINS / WHIR_PINS sizes against
               the JAX package's proof bytes; 2^20 - 1 steps cold and warm,
               verified, both group roots recomputed with the plain versions
               over the backend's own L_0 coset (offset g); one BabyBear + Fp4
               2^20 - 1 prove, verified
 10. sharded   the sharded paths (ministark_tpu_torch/parallel/) with ranks
               that share the one card in gloo groups (parallel/launch.py):
               two ranks prove GL parity, fast, STIR and WHIR at 2^20 - 1
               cold and warm, all resident (each rank holds its block of
               every stage tensor, STIR and WHIR until the round that hands
               off), each rank's proof equal to phases main's / fast's /
               stir_whir's and verified, with its kernel launches (paths
               sharded_parity, sharded_fast, sharded_stir and sharded_whir,
               per rank), its bytes received by collective kind and its warm
               prove's peak allocated memory; a one-rank group proves all
               four on one device in a process of its own, and a rank's
               resident prove fails above 0.75 of that one's peak
               (SHARDED_PEAK_SHARE), a fast, STIR or WHIR rank above 2 MB
               of all_gather outside the openings; the two ranks then
               prove_many 4 traces at 2^20 - 1, resident, equal to phase
               fast's bytes; the sharded coset LDE (6, 2^21),
               constrain tree (6 x 2^21 elements) and index tree (2^19, 48)
               equal to one device's, both timed (a time of the code path:
               the ranks share the card); the resident prove core
               (make_sharded_prove_core) at 2^18, each rank's blocks joined
               and equal to the single core with shift 1, with its launches
               (path sharded_core); then four ranks prove the 2^14 - 1 pins
               (PINS, FAST_PINS x 1 and x 4, STIR_PINS and WHIR_PINS,
               resident, one BB_PINS and one BB_FAST_PINS entry, MiMC's
               MODEL_PINS)
 11. models    the counter, LFSR and MiMC AIRs (models/{counter,lfsr,mimc}.py)
               on the card: small proofs byte-identical to the host oracle
               over both fields, the 2^14 - 1 pins of the JAX package
               (parity for all three, fast for MiMC and LFSR), MiMC at
               2^20 - 1 cold and warm, verified
 12. core      the driver entry and the prove core (ministark_tpu_torch/
               entry.py, stark/core.py): entry()'s core on the card equal to
               the CPU's; make_prove_core for Fibonacci and MiMC over both
               fields at 2^14 against CORE_PINS; the Fibonacci core over
               Goldilocks at the bench's n = 2^20 (a 3 x 2^20 iFFT, a 6 x 2^21
               coset LDE) equal to its plain versions on the card, with its
               host ms, device ms and launches by kernel;
               dryrun_multichip(2) on two ranks sharing the card (gloo), every
               rank byte-equal to one device; the native Merkle engine
               (commit/native.py) against hashlib at the host tail's sizes,
               both timed, and warm 2^20 - 1 proves with either tail in
               turns (scripts/torch_ab_prove.py --tail); batch_inverse_full
               at 2^20 Goldilocks elements, 64 entries against field.inv
 13. probes    the three probe scripts in-process (scripts/torch_stream_probe,
               torch_f32_pad_probe, torch_digit_stage_probe at the three
               levels of ifft 2^20)
 14. bench     bench_kernels_torch.kernel_rooflines() at full size (every
               entry present, bound_frac <= 1) and bench_torch's device_prove,
               fast_prove (with lde_backend "fri", then the stir_e2e_prove and
               whir_e2e_prove entries) and host_prove in-process
 15. launches  every kernel was launched by the paths it is on (counts set to
               0 just before each path runs, read just after): the 2^20 - 1
               proves of each prover, backend and field (the STIR and WHIR
               paths stir, whir, stir_bb, whir_bb; the sharded paths
               sharded_parity, sharded_fast, sharded_stir and sharded_whir,
               rank 0's, every rank checked; the division scan on every
               parity path, STIR's and the resident parity and STIR
               ranks', pow_dot where eval_even_odd, the block deep and
               divide or the point evaluations run (every parity, fast,
               STIR and WHIR path); each of the two launched once a call on
               every path and rank; first_match on every parity path and
               the resident parity ranks, once a call), the MiMC prove, the prove core at 2^20 (core) and
               sharded over two ranks (sharded_core, rank 0's), the probes,
               the kernel bench and the bench's proves; every field op one
               launch (the field kernels' launches equal their calls on
               every path and rank; each path's are printed), gl_ew on
               every Goldilocks path, bb_ew and bb_fp4_mul on every
               BabyBear path
 16. processes no process that the script started is left: every child of
               this process has ended and been reaped (the ranks, and the
               resource tracker that the spawn method starts beside them,
               parallel/launch.py)

Phase 3 also holds the stream kernel and the digit level's four kernels
(digitize, int8 dot, recombine, fused level) against their plain versions at
the probes' shapes and the dot at the kernel bench's 4096^3, with their
device ms and bound_frac, the fused level against the stage chain and the
butterfly level there and at the three levels of fft (12, 2^21), and times
torch.add and torch._int_mm beside them (library_ms; _int_mm also with its
matrix column-major, library_col_ms); the stream kernel and torch.add also
in 15 pairs of interleaved turns (paired medians).

The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import hashlib
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
# The same digest with the STIR / WHIR low-degree test (FAST_CFG with
# lde_backend "stir" / "whir"; 2^14 - 1 steps gives 4 quotient rounds /
# WHIR iterations): steps -> digest.
STIR_PINS = {16383: "09c83fba627010b8ef5dde0b5b9c84e0ce28c3082a50583b59cad73321864be2"}
WHIR_PINS = {16383: "f9dd5faafd2a5739d481df5238aa072db403bf6fd35e5c58e3b1f83b754b8ddb"}
LDT_PINS = {"stir": STIR_PINS, "whir": WHIR_PINS}

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
# The same pins for the other AIRs over Goldilocks at 2^14 - 1 steps, made the
# same way: proof_digests() of the JAX DeviceEngine's proof of
# counter_device_trace (witness on the device), lfsr_device_trace and
# mimc_device_trace, and the sha256 of the JAX FastStark's proof bytes in
# FAST_CFG.
MODEL_PIN_STEPS = 16383
MODEL_PINS = {
    "counter": {
        "trace_commit": "d384264bea90d15faeab111c46c9d99193d8c21ec6d0f15bbd181697e47d6ab8",
        "constrain_trace_commit": "935d799b8046bfc13e21a40f2f0900309e7dabb04f3c4762a06a4bf284a360ab",
        "arthur_sha256": "d7db9438c49fe669c1f80b3f073a8f0459379fb5fb919b7f80eeb48022811f88",
        "fri_payload_sha256": "aad1f74bd5e49608c7419eaeee7c74b90ee88c844be13af3f4174d29c406ee01",
    },
    "lfsr": {
        "trace_commit": "29b85dee23d672c32807418dc08fec8402403d91f530bee7d23c877461545ec3",
        "constrain_trace_commit": "022a4a0bca0ed78a3b3edf8206f4c059d27770973cf4677e0d384f9291827930",
        "arthur_sha256": "5bbc2547c02d63d577c5f9c060776c14d018db224cfcc32614afbd58dae01e60",
        "fri_payload_sha256": "6a59cbf7b864a39e784ff3a6493ea35a7a1d21739a73f0afe4ba03567bd788c2",
    },
    "mimc": {
        "trace_commit": "1a73f69dc2e8a77b49d545d07fd0dee9e053262509b6601fe3cd20a4c3db7c4e",
        "constrain_trace_commit": "5c8e661cb3019d957aca19cfeb2ee70fc8c7111b89bfa986946887f62f353aee",
        "arthur_sha256": "439e5681ac194bf7383c177dabb8b31569047de20a6a67e02e0cc75c17aa7893",
        "fri_payload_sha256": "abb2d4e4ab46a08c094f246ecc9a6c35e928d1a44a751b6e6020138acadd3c9f",
    },
}
MODEL_FAST_PINS = {
    "mimc": "f6a1e6061d338a089b4a54953e23e09c1867ab35ccc3c12bae108cbbbbe98a5e",
    "lfsr": "b5cb1fe927f46ed757ecacf963361dd63e80431a498497d219cb0e111ae67b43",
}

BB_FAST_PINS = {
    (16383, 1): "6dd4dc47941ca20f4250b21b6f194a051157f80e7f0180c8d0ac07600c8b4dcc",
    (16383, 4): "d5052f1b32446e049d392ad13c64d3b0f42e2397ccaabf36d93af9a821c73570",
}

# sha256 of the three outputs (lde, mixed, folded), each as little-endian
# u64 (ministark_tpu_torch/convert.py's from_jax_packed, then unpack_u64),
# of ministark_tpu.stark.core.make_prove_core(sf, 2^14, builder)'s core on
# its example_args() (shift 7, weights 5^i), JAX on the CPU; builder None
# (Fibonacci) or ministark_tpu.models.mimc.mimc_device_trace
CORE_PIN_N = 1 << 14
CORE_PINS = {
    ("gl", "fibonacci"): "f07c289c723f1806205da48e9edb7532953271e8fc0e376596e872f8a170e96a",
    ("gl", "mimc"): "714dcbc2f5e7f560ef35c4461206fad3f4b5ab0f7e231263915257c6229216b2",
    ("bb", "fibonacci"): "2445d4805baa6ae921bbdb365f8c7544e425ab78fd02343cb175e9b41fda7d48",
    ("bb", "mimc"): "78f1de2ecda5a6a7d9a05d1cd279b50a4bed62f66b6bfc9e5f70f720a4b476f8",
}

# the bound model and the timing helper (ministark_tpu_torch/utils/roofline.py),
# bound in main() once the package is on the path
rf = None

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def timed(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after a warm-up (CUDA events)."""
    return rf.time_ms(fn, reps, "cuda")


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


def _children() -> list:
    """[(pid, command)] of the processes whose parent is this one, zombies
    included (read from /proc)."""
    me, out = str(os.getpid()), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        if stat.rsplit(")", 1)[1].split()[1] == me:
            out.append((int(pid), cmd))
    return out


def phase_processes():
    left = _children()
    if left:
        fail(f"processes: the script leaves {len(left)} process(es) of its own: {left}")
    say("processes", "no process that the script started is left")


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
    # the radix-2 NTT's kernel is csrc/ntt.cu's ntt_pass<gl / bb>, the
    # four-step's csrc/ntt_four_step.cu's four_step_pass{1,2}<gl / bb>, the
    # pipe's csrc/ntt_pipe.cu's pipe_level<gl / bb>, the stream's
    # stream_add1_kernel<1, 2, 4, 8>, csrc/field_ew.cu's field_ew_contig /
    # field_ew_strided<gl / bb, op, ...> and bb_fp4_mul_kernel<...>, the
    # leaf search's first_match_kernel<1, 2, 4>
    for name, symbol in (("leaf_hash", "leaf_hash"), ("ntt", "ntt_pass"),
                         ("ntt_four_step", "four_step_pass"),
                         ("ntt_pipe", "pipe_level"), ("stream", "stream_add1_kernel"),
                         ("digit_level", "digit_level_kernel"),
                         ("digit_dot", "digit_dot_kernel"),
                         ("div_scan", "div_scan_kernel"), ("pow_dot", "pow_dot_kernel"),
                         ("gl_ew / bb_ew", "field_ew_"),
                         ("bb_fp4_mul", "bb_fp4_mul_kernel"),
                         ("first_match", "first_match_kernel")):
        frames = _stack_frames(log, symbol)
        if not frames or any(any(v) for v in frames.values()):
            fail(f"build: {name} uses local memory (stack frame, spill stores, "
                 f"spill loads in bytes): {frames}")
        say("build", f"{name}: {len(frames)} instantiations, 0 bytes stack frame, "
                     "0 bytes spill stores and loads")
    # the digit kernels run Hopper's warpgroup MMA (IGMMA in SASS for
    # wgmma ... .s8), and no mma.sync (IMMA)
    mixes = _load_script("torch_sass_mix").sass_mix(path, "digit_")
    for symbol in ("digit_level_kernel", "digit_dot_kernel"):
        found = {fn: mix for fn, mix in mixes.items() if symbol in fn}
        if not found or any(not mix["IGMMA"] or mix["IMMA"] for mix in found.values()):
            fail(f"build: {symbol}'s SASS lacks IGMMA or holds IMMA: "
                 + json.dumps({fn: {k: mix[k] for k in ("IGMMA", "IMMA")}
                               for fn, mix in found.items()}))
        say("build", f"{symbol}: {len(found)} instantiations, IGMMA "
                     f"{[mix['IGMMA'] for mix in found.values()]} a kernel, no IMMA")


def _stack_frames(log, name):
    """{function: (stack frame, spill stores, spill loads) bytes} from ptxas'
    -v report, for the kernels whose mangled names contain ``name``."""
    import re

    frames, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and fn is not None and name in fn:
            frames[fn] = tuple(int(v) for v in m.groups())
        fn = None if m else fn
    return frames


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


def _rand_bb(rng, shape, p):
    """``_rand_u64``'s BabyBear twin: the same draws and edge values, as the
    int32 tensor on the card that the port holds BabyBear in."""
    import numpy as np
    import torch

    v = rng.integers(0, p, size=shape, dtype=np.uint64)
    flat = v.reshape(-1)
    edge = np.array([e for e in (0, 1, p - 1, p - 2, 9, 10, 10**9 - 1) if 0 <= e < p],
                    dtype=np.uint64)
    flat[: min(edge.size, flat.size)] = edge[: flat.size]
    return torch.from_numpy(v.astype(np.int32)).cuda()


def _rand_field(rng, shape, p):
    """Random values of the field of prime p in its storage: ``_rand_bb``
    for BabyBear (p < 2^32), ``_rand_u64`` for Goldilocks."""
    return (_rand_bb if p < (1 << 32) else _rand_u64)(rng, shape, p)


# kernels whose lines also carry the host's time per call issued without a
# synchronize (host_ms), the card's time alone (device_ms: the calls queued
# behind a device sleep) and torch.profiler's kernel time and kernel records
# per call (profiler_ms, profiler_kernels), so that the event-timed ms of a
# short kernel is not read as device time
SPLIT_TIMED = ("gl_mul", "gl_ext_mul", "leaf_hash", "leaf_hash_bb")
SPLIT_KEYS = ("host_ms", "device_ms", "profiler_ms", "profiler_kernels")


def make_compare(results):
    """compare(name, label, kern, plain, work, library=None, device=False):
    the kernel's output against its plain version's on the same inputs
    (exact), then both timed (and ``library``, one PyTorch call computing
    the same function, where there is one; with ``device``, the kernel's
    device_ms with its operands out of L2 (``rf.cold_device_ms``), as the
    bound counts their bytes, warm_device_ms with them left in L2 by the
    call before, and the bound_frac of device_ms), into ``results[name]``
    unless ``name`` is a whole transform; returns that record (None for a
    whole transform)."""
    import torch

    def compare(name, label, kern, plain, work, reps=5, plain_reps=2, library=None,
                device=False):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            fail(f"{name} {label}: kernel differs from its plain version "
                 f"(max_abs_err {err})")
        del got, want
        ms = timed(kern, reps)
        pms = timed(plain, plain_reps)
        lms = None if library is None else timed(library, reps)
        bms, by = rf.bound(*work)
        split = rf.split_ms(kern, reps) if name in SPLIT_TIMED else {}
        if device:      # the card's time alone, operands from device memory
            dms = rf.cold_device_ms(kern, reps)       # (not L2), and the share of it
            split.update(device_ms=dms, warm_device_ms=rf.device_ms(kern, reps),
                         bound_frac=bms / dms)
        say("kernels", f"{name} {label}: equal (tolerance 0), kernel "
                       f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.3f} ms "
                       f"({by})" + ("" if lms is None else f", library {lms:.3f} ms")
                       + "".join(f", {k} {v:.4f}" for k, v in split.items()))
        if name not in results:              # a whole transform, not a kernel
            return
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append({"shape": label, "ms": ms, "plain_ms": pms,
                            "bound_ms": bms, "bound_by": by, "library_ms": lms,
                            **split})
        return r["shapes"][-1]

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
        x = _rand_field(rng, (batch, n), F.p)
        work = rf.ntt_work(batch, n, "pre" in kw, bool(kw.get("inverse")), tag)
        rec = compare("ntt" + sfx, label, lambda: ntt.transform_cuda(x, **kw, field=F),
                      lambda: ntt.transform_plain(x, **kw, field=F), work)
        # the passes one call launched, as csrc/ntt.cu counts them
        before = ntt.pass_launches[tag]
        ntt.transform_cuda(x, **kw, field=F)
        per_call = ntt.pass_launches[tag] - before
        passes = len(ntt.pass_plan(n.bit_length() - 1))
        say("kernels", f"ntt{sfx} {label}: {per_call} launch(es) per call")
        if per_call != passes:
            fail(f"ntt{sfx} {label}: {per_call} launches per call, where the plan "
                 f"has {passes} passes")
        rec["launches_per_call"] = per_call

    for label, batch, n, kw in backend_shapes:
        x = _rand_field(rng, (batch, n), F.p)
        inverse, pre, post = bool(kw.get("inverse")), kw.get("pre"), kw.get("post")
        scale = ntt.inv_n(F, n) if inverse else None
        n1, n2 = fs._split_sizes(n)
        tw1, tw2, wpow = fs._tables(n, inverse, x.device, F)
        c = fs.pass1_cuda(x, tw2, wpow, pre, F)
        # pass 2 stores with one product: the post power (1/n folded in) or 1/n
        work1, work2 = rf.four_step_work(batch, n1, n2, pre is not None,
                                         inverse or post is not None, tag)
        compare("ntt_four_step_pass1" + sfx, label,
                lambda: fs.pass1_cuda(x, tw2, wpow, pre, F),
                lambda: fs.pass1_plain(x, tw2, wpow, pre, F), work1,
                plain_reps=1, device=True)
        compare("ntt_four_step_pass2" + sfx, label,
                lambda: fs.pass2_cuda(c, tw1, scale, post, F),
                lambda: fs.pass2_plain(c, tw1, scale, post, F), work2,
                plain_reps=1, device=True)
        # the pipe's levels take no post power (its transform multiplies it
        # in after them): a shape with one would repeat the ifft levels
        levels = [] if post is not None else pp._tables(n, inverse, x.device, F)
        splits = pp.level_splits(n, inverse, x.device, F)   # W as transform gives it
        y = x
        for i, ((Fi, tw, W, k_prod), split) in enumerate(zip(levels, splits)):
            last = i == len(levels) - 1
            args = (y.reshape(batch, Fi, n // Fi), tw, pre if i == 0 else None,
                    W, k_prod, scale if last else None, F)
            muls = int(i == 0 and pre is not None) + int(W is not None) + int(
                last and inverse)
            # products by 1: s^0, and the twiddles W that are w^0
            ones = int(i == 0 and pre is not None) + (
                0 if W is None else int((W == 1).sum()) * k_prod)
            compare("ntt_pipe_level" + sfx, f"{label} level {i} (F {Fi})",
                    lambda: pp.level_cuda(*args, w_split=split),
                    lambda: pp.level_plain(*args),
                    rf.pass_work(batch, n, Fi.bit_length() - 1, muls, tag, ones),
                    plain_reps=1, device=True)
            y = pp.level_cuda(*args, w_split=split)
        work = rf.ntt_work(batch, n, pre is not None, inverse, tag)
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
        comps = _rand_field(rng, (groups * k, lh._FMT_COMPS[fmt]), F.p)
        comps[: groups // 4] %= 1000
        compare(name, label, lambda: lh.leaf_hash_cuda(comps, k, fmt, md),
                lambda: lh.leaf_hash_plain(comps, k, fmt, md),
                rf.leaf_hash_work(comps, k, fmt, md), reps=3, plain_reps=1)


def _check_leaf_boundaries(rng):
    """The leaf hash (both digit paths, all three formats) against its plain
    version on groups whose preimages end at every SHA-256 padding boundary
    (ops/leaf_hash.py::BOUNDARY_CASES), each case's groups repeated 1000
    times in a shuffled order so that every lane position of a warp meets
    every length."""
    import numpy as np
    import torch

    from ministark_tpu_torch.fields import BABYBEAR_FP, GOLDILOCKS_FP
    from ministark_tpu_torch.ops import leaf_hash as lh

    for fmt, md, k, lengths in lh.BOUNDARY_CASES:
        p = (GOLDILOCKS_FP if md == 20 else BABYBEAR_FP).p
        groups = lh.boundary_groups(fmt, k, md, p, lengths).reshape(len(lengths), -1)
        order = rng.permutation(np.tile(np.arange(len(lengths)), 1000))
        groups = groups[order].reshape(len(order) * k, -1)
        # the 10-digit path is BabyBear's, 32-bit words (2^32 - 1 as -1)
        words = (groups.view(np.int64) if md == 20
                 else groups.astype(np.uint32).view(np.int32))
        comps = torch.from_numpy(np.ascontiguousarray(words)).cuda()
        got = lh.leaf_hash_cuda(comps, k, fmt, md)
        err = max_abs_err(got, lh.leaf_hash_plain(comps, k, fmt, md))
        if err != 0:
            fail(f"leaf_hash fmt {fmt}, {md} digits, k {k}: differs from its plain "
                 f"version at the padding boundaries (max_abs_err {err})")
        say("kernels", f"leaf_hash fmt {fmt}, {md} digits, k {k}: equal (tolerance "
                       f"0) at preimage lengths {list(lengths)}, {len(order)} groups")


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
        ("fft (1, 2^23) (three passes)", 1, 1 << 23, {}),
    ], [
        ("ifft (3, 2^20)", 3, 1 << 20, {"inverse": True}),
        ("coset_fft (6, 2^21)", 6, 1 << 21, {"pre": shift}),
        ("fft (12, 2^21)", 12, 1 << 21, {}),
        ("coset_ifft (6, 2^21)", 6, 1 << 21, {"inverse": True, "post": shift}),
    ])

    # K5: the base product on both of its paths: 16-byte vectors over
    # contiguous aligned operands, and the strided path (the same operands
    # one element off the 16-byte boundary, and broadcast over a batch of
    # rows: the coset powers times the LDE rows), at 2^21 and at the kernel
    # bench's 2^22
    a, b = _rand_u64(rng, (6, 1 << 21), F.p), _rand_u64(rng, (1 << 21,), F.p)
    c = _rand_u64(rng, (2, (1 << 22) + 2), F.p)
    n22 = 1 << 22
    for label, x, y, vec in [
            ("(2^21,) x (2^21,), contiguous", a[0], b, 1),
            ("(2^21,) x (2^21,), strided (offset 1)", a[0, 1:], a[1, :-1], 0),
            ("(6, 2^21) x (2^21,) broadcast, strided", a, b, 0),
            ("(2^22,) x (2^22,), contiguous", c[0, :n22], c[1, :n22], 1),
            ("(2^22,) x (2^22,), strided (offset 1)", c[0, 1:n22 + 1],
             c[1, 1:n22 + 1], 0)]:
        aligned = not (x.data_ptr() | y.data_ptr()) & 15
        if gl._mul_plan(x.shape, x.stride(), y.shape, y.stride(), aligned)[1][2] != vec:
            fail(f"gl_mul {label}: the wrapper took the other path")
        compare("gl_mul", label, lambda: gl.mul_cuda(x, y),
                lambda: gl.mul_plain(x, y), rf.mul_work(x, y), reps=10)
    del a, b, c

    # K5b: the Fp2 product, one launch: flat, the parity query rounds'
    # (Q, 2^20, 2) x (Q, 2^20, 2) at the parity configuration's Q, a
    # ``powers`` doubling step (..., k, 2) x (..., 1, 2), the even / odd
    # stride-2 slices of a FRI fold and a (2,) scalar
    from ministark_tpu_torch.fields import Goldilocks
    from ministark_tpu_torch.stark import StarkConfig

    Q = StarkConfig(Goldilocks, 20, 2, MAIN_STEPS, 6).fri_queries
    e, f = _rand_u64(rng, (1 << 21, 2), F.p), _rand_u64(rng, (1 << 21, 2), F.p)
    qa, qb = _rand_u64(rng, (Q, 1 << 20, 2), F.p), _rand_u64(rng, (Q, 1 << 20, 2), F.p)
    for label, x, y in [
            ("(2^21, 2) x (2^21, 2)", e, f),
            (f"query round ({Q}, 2^20, 2) x ({Q}, 2^20, 2)", qa, qb),
            (f"powers ({Q}, 2^19, 2) x ({Q}, 1, 2)", qa[:, : 1 << 19], qb[:, :1]),
            ("even / odd stride-2 slices (2^20, 2) x (2^20, 2)", e[0::2], e[1::2]),
            ("(2^21, 2) x (2,) scalar", e, f[7])]:
        compare("gl_ext_mul", label, lambda: gl.ext_mul_cuda(x, y),
                lambda: gl.ext_mul_plain(x, y), rf.ext_mul_work(x, y), reps=10)
    del e, f, qa, qb

    # K3: leaf hashes of the trace / constraint trees (fmt 0, 6 per group)
    # and of the first FRI round tree (fmt 1, 2 per group)
    _compare_leaf_hash(compare, rng, F, "leaf_hash", [
        ("fmt 0, k 6, 2^21 groups", 1 << 21, 6, 0),
        ("fmt 1, k 2, 2^20 groups", 1 << 20, 2, 1),
    ])

    _check_leaf_boundaries(rng)

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

    work = [sum(w) for w in zip(*(rf.level_work(1 << j, 2) for j in range(21)))]
    compare("sha256_inner_level", "all 21 levels of a 2^21-leaf tree",
            levels(sh.inner_level_cuda), levels(sh.inner_level_plain), work,
            reps=5, plain_reps=1)
    d4 = leaves[: 1 << 19]
    compare("sha256_inner_level", "fan 4, 2^19 -> 2^17",
            lambda: sh.inner_level_cuda(d4, 4), lambda: sh.inner_level_plain(d4, 4),
            rf.level_work(1 << 17, 4))

    # K2b: the fast mode's row leaves over 2^19 coset rows: the witness group
    # (6 polynomials x F 4 x Fp2 = 48 u64 per row), the validity group and
    # every FRI layer (C 8), and prove_many's witness group of 4 traces (192)
    for C in (48, 8, 192):
        comps = _rand_u64(rng, (1 << 19, C), F.p)
        compare("sha256_rows", f"2^19 rows, C {C}",
                lambda: sh.binary_row_digests_cuda(comps, torch.int64),
                lambda: sh.binary_row_digests_plain(comps),
                rf.rows_work(1 << 19, C), reps=5, plain_reps=1)


def phase_kernels_bb(results):
    """Phase 3 over BabyBear: the NTT, four-step and pipe kernels at the
    BabyBear main paths' shapes (the Fp4 FRI codewords and the fast LDE are
    batches of 4 components per polynomial), the 10-digit leaf hash in
    formats 0 and 2, and the BabyBear row-leaf width."""
    import numpy as np
    import torch

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
        ("coset_ifft (1, 2^23) (three passes)", 1, 1 << 23,
         {"inverse": True, "post": shift}),
    ], [
        ("ifft (3, 2^20)", 3, 1 << 20, {"inverse": True}),
        ("coset_fft (6, 2^21)", 6, 1 << 21, {"pre": shift}),
        ("fft (24, 2^21)", 24, 1 << 21, {}),
        ("coset_ifft (6, 2^21)", 6, 1 << 21, {"inverse": True, "post": shift}),
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
    # components = 96 int32 per row, each hashed as 8 little-endian bytes)
    # over 2^19 coset rows
    comps = _rand_bb(rng, (1 << 19, 96), F.p)
    compare("sha256_rows", "2^19 rows, C 96 (BabyBear witness group)",
            lambda: sh.binary_row_digests_cuda(comps, torch.int32),
            lambda: sh.binary_row_digests_plain(comps),
            rf.rows_work(1 << 19, 96, 4), reps=5, plain_reps=1)
    _check_int64_refused()


def _check_int64_refused():
    """Every BabyBear kernel's wrapper refuses an int64 operand (the storage
    before the 32-bit port) with a ValueError and launches nothing: no
    cast, no fallback."""
    import torch

    from ministark_tpu_torch.commit import packed_tree as pt
    from ministark_tpu_torch.fields import BABYBEAR_FP as F
    from ministark_tpu_torch.fields import BABYBEAR_FP4 as E
    from ministark_tpu_torch.ops import bb
    from ministark_tpu_torch.ops import div_scan as ds
    from ministark_tpu_torch.ops import leaf_hash as lh
    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops import ntt_four_step as fs
    from ministark_tpu_torch.ops import ntt_pipe as pp
    from ministark_tpu_torch.ops import sha256 as sh
    from ministark_tpu_torch.ops.field import get_ops

    n = 1 << 14
    x64 = torch.ones((2, n), dtype=torch.int64, device="cuda")
    e64 = torch.ones((2, n, 4), dtype=torch.int64, device="cuda")
    z64 = torch.ones((2, 4), dtype=torch.int64, device="cuda")
    tw1, tw2, wpow = fs._tables(n, False, "cuda", F)
    levels = pp._tables(n, False, "cuda", F)
    Fi, tw, W, k_prod = levels[0]
    k4 = get_ops(E)
    cases = [("ms_ntt_bb", lambda: ntt.transform_cuda(x64, field=F)),
             ("ms_ntt_four_step_pass1_bb", lambda: fs.pass1_cuda(x64, tw2, wpow, None, F)),
             ("ms_ntt_pipe_level_bb", lambda: pp.level_cuda(
                 x64.reshape(2, Fi, n // Fi), tw, None, W, k_prod, None, F)),
             ("ms_leaf_hash_bb", lambda: lh.leaf_hash_cuda(x64.reshape(-1, 1), 2, 0, 10)),
             ("ms_bb_ew", lambda: bb.mul_cuda(x64, x64)),
             ("ms_bb_fp4_mul", lambda: bb.fp4_mul_cuda(e64, e64)),
             ("ms_pow_dot_bb4", lambda: ds.pow_dot_cuda(k4, e64, z64)),
             ("ms_div_scan_bb4", lambda: ds.div_scan_cuda(k4, e64, z64, z64)),
             ("ms_first_match_bb", lambda: pt.first_match_cuda(
                 e64.reshape(-1, 4), e64[0, :2].contiguous(), k4.dtype)),
             ("ms_sha256_rows_bb", lambda: sh.binary_row_digests_cuda(
                 e64.reshape(-1, 4), k4.dtype))]
    before = read_counts()[0]
    for name, call in cases:
        try:
            call()
        except ValueError as e:
            say("kernels", f"int64_refused {name}: ValueError ({e})")
            continue
        fail(f"{name}: an int64 BabyBear operand was taken, not refused")
    torch.cuda.synchronize()
    after = read_counts()[0]
    moved = {k: after[k] - before[k] for k in after
             if not k.endswith(" calls") and after[k] != before[k]}
    if moved:
        fail(f"int64 BabyBear operands launched kernels: {moved}")
    say("kernels", f"int64_refused: {len(cases)} BabyBear wrappers refuse an int64 "
                   "operand, no launch")


def phase_kernels_field_ew(results):
    """Phase 3 for the field ops (csrc/field_ew.cu, and gl_mul.cu's base
    product under the Fp2 product by a base scalar): ms_gl_ew (add, sub,
    neg, the Fp2 forms over the whole (..., 2) tensors), ms_bb_ew (add,
    sub, neg, mul, the Fp4 forms and the product by a base scalar) and
    ms_bb_fp4_mul, each against its plain version on the card (exact) at
    2^21 elements (the shapes of the bounds), with one broadcast, one
    strided and one CPU-scalar case a kernel, the 16-byte path where the
    operands allow it, device ms and bound_frac (not for a CPU scalar,
    whose copy to the card waits for it); then each row once through
    the op the provers call (``field.dispatch``), which must count one call
    and one launch. No PyTorch call computes a field op mod p."""
    import numpy as np

    from ministark_tpu_torch.fields import BABYBEAR_FP, GOLDILOCKS_FP, Goldilocks
    from ministark_tpu_torch.ops import bb
    from ministark_tpu_torch.ops import field as gl
    from ministark_tpu_torch.stark import StarkConfig

    rng = np.random.default_rng(SEED + 20)
    compare = make_compare(results)
    Q = StarkConfig(Goldilocks, 20, 2, MAIN_STEPS, 6).fri_queries
    n21 = 1 << 21
    ew = rf.EW_OPS

    def row(kernel, label, op, cuda_fn, plain, args, work, vec=None, k=None):
        """One kernel row: the path the wrapper takes (``vec``: 1 the
        16-byte path, 0 the strided one, None a CPU scalar), the compare,
        and one call of the dispatcher ``op``."""
        mod = bb if kernel.startswith("bb_") else gl
        if vec is not None:
            x, y = args if len(args) == 2 else (args[0], args[0])
            aligned = not (x.data_ptr() | y.data_ptr()) & 15
            plan = (gl._mul_plan(x.shape, x.stride(), y.shape, y.stride(), aligned)
                    if k is None else
                    gl._ext_plan(x.shape, x.stride(), y.shape, y.stride(), aligned, k,
                                 kernel, x.element_size()))[1]
            if plan[2] != vec:
                fail(f"{kernel} {label}: the wrapper took the other path")
        # a CPU scalar's copy to the card waits for the card: no device ms
        on_card = all(t.is_cuda for t in args)
        # torch ops take no CPU operand but a 0-d one: the plain version gets
        # the CPU scalar's copy on the card
        on_dev = tuple(t.cuda() for t in args)
        rec = compare(kernel, label, lambda: cuda_fn(*args), lambda: plain(*on_dev),
                      work, reps=10, device=on_card)
        launches, calls = mod.launches[kernel], mod.calls[kernel]
        op(*args)
        got = (mod.launches[kernel] - launches, mod.calls[kernel] - calls)
        rec["launches_per_call"] = got[0]
        if got != (1, 1):
            fail(f"{kernel} {label}: the op counted {got[1]} call(s) and "
                 f"{got[0]} launch(es), expected 1 and 1")

    p = GOLDILOCKS_FP.p
    a, b = _rand_u64(rng, (6, n21), p), _rand_u64(rng, (n21,), p)
    e, f = _rand_u64(rng, (n21, 2), p), _rand_u64(rng, (n21, 2), p)
    cpu0, cpu2 = gl.pack_u64(p - 1), gl.pack_u64([12345, p - 1])
    add, sub, neg = ew["gl", "add"], ew["gl", "sub"], ew["gl", "neg"]
    for args in [
            ("add (2^21,) x (2^21,), contiguous", gl.add, gl.add_cuda, gl.add_plain,
             (a[0], b), rf.ew_work(a[0], b, add), 1),
            ("sub (2^21,) x (2^21,), contiguous", gl.sub, gl.sub_cuda, gl.sub_plain,
             (a[0], b), rf.ew_work(a[0], b, sub), 1),
            ("neg (2^21,), contiguous", gl.neg, gl.neg_cuda, gl.neg_plain, (a[1],),
             rf.ew_work(a[1], None, neg), 1),
            ("ext_add (2^21, 2) x (2^21, 2), contiguous", gl.ext_add, gl.ext_add_cuda,
             gl.ext_add_plain, (e, f), rf.ew_work(e, f, add), 1),
            ("add (6, 2^21) x (2^21,) broadcast, strided", gl.add, gl.add_cuda,
             gl.add_plain, (a, b), rf.ew_work(a, b, add), 0),
            ("sub (2^21,) x (2^21,), strided (offset 1)", gl.sub, gl.sub_cuda,
             gl.sub_plain, (a[0, 1:], a[1, :-1]), rf.ew_work(a[0, 1:], a[1, :-1], sub), 0),
            ("ext_sub even / odd stride-2 slices (2^20, 2)", gl.ext_sub, gl.ext_sub_cuda,
             gl.ext_sub_plain, (e[0::2], e[1::2]), rf.ew_work(e[0::2], e[1::2], sub), 0),
            ("add (2^21,) x 0-d CPU scalar", gl.add, gl.add_cuda, gl.add_plain,
             (a[2], cpu0), rf.ew_work(a[2], cpu0, add), None),
            ("ext_add (2^21, 2) x (2,) CPU scalar", gl.ext_add, gl.ext_add_cuda,
             gl.ext_add_plain, (e, cpu2), rf.ew_work(e, cpu2, add), None)]:
        row("gl_ew", *args)
    row("gl_mul", "ext_scale_base (2^21, 2) x (2^21,)", gl.ext_scale_base,
        gl.ext_scale_base_cuda, gl.ext_scale_base_plain, (e, b),
        rf.ew_work(e, b.unsqueeze(-1), rf.OPS_GL_MUL))
    del a, b, e, f

    p = BABYBEAR_FP.p
    a, b = _rand_bb(rng, (6, n21), p), _rand_bb(rng, (n21,), p)
    g, h = _rand_bb(rng, (n21, 4), p), _rand_bb(rng, (n21, 4), p)
    cpu0 = gl.pack_words(p - 1, bb.DTYPE)
    cpu4 = gl.pack_words([1, 12345, p - 1, p - 2], bb.DTYPE)
    add, mul, neg = ew["bb", "add"], ew["bb", "mul"], ew["bb", "neg"]
    for args in [
            ("mul (2^21,) x (2^21,), contiguous", bb.mul, bb.mul_cuda, bb.mul_plain,
             (a[0], b), rf.ew_work(a[0], b, mul), 1),
            ("add (2^21,) x (2^21,), contiguous", bb.add, bb.add_cuda, bb.add_plain,
             (a[0], b), rf.ew_work(a[0], b, add), 1),
            ("sub (2^21,) x (2^21,), contiguous", bb.sub, bb.sub_cuda, bb.sub_plain,
             (a[0], b), rf.ew_work(a[0], b, ew["bb", "sub"]), 1),
            ("neg (2^21,), contiguous", bb.neg, bb.neg_cuda, bb.neg_plain, (a[1],),
             rf.ew_work(a[1], None, neg), 1),
            ("fp4_add (2^21, 4) x (2^21, 4), contiguous", bb.fp4_add, bb.fp4_add_cuda,
             bb.fp4_add_plain, (g, h), rf.ew_work(g, h, add), 1),
            ("fp4_scale_base (2^21, 4) x (2^21,)", bb.fp4_scale_base,
             bb.fp4_scale_base_cuda, bb.fp4_scale_base_plain, (g, b),
             rf.ew_work(g, b.unsqueeze(-1), mul)),
            ("mul (6, 2^21) x (2^21,) broadcast, strided", bb.mul, bb.mul_cuda,
             bb.mul_plain, (a, b), rf.ew_work(a, b, mul), 0),
            ("mul (2^21,) x (2^21,), strided (offset 1)", bb.mul, bb.mul_cuda,
             bb.mul_plain, (a[0, 1:], a[1, :-1]), rf.ew_work(a[0, 1:], a[1, :-1], mul), 0),
            ("mul (2^21,) x 0-d CPU scalar", bb.mul, bb.mul_cuda, bb.mul_plain,
             (a[2], cpu0), rf.ew_work(a[2], cpu0, mul), None),
            ("fp4_add (2^21, 4) x (4,) CPU scalar", bb.fp4_add, bb.fp4_add_cuda,
             bb.fp4_add_plain, (g, cpu4), rf.ew_work(g, cpu4, add), None)]:
        row("bb_ew", *args)

    qa, qb = _rand_bb(rng, (Q, 1 << 20, 4), p), _rand_bb(rng, (Q, 1 << 20, 4), p)
    for label, x, y, vec in [
            ("(2^21, 4) x (2^21, 4)", g, h, 1),
            (f"query round ({Q}, 2^20, 4) x ({Q}, 2^20, 4)", qa, qb, 1),
            (f"powers ({Q}, 2^19, 4) x ({Q}, 1, 4) broadcast", qa[:, : 1 << 19],
             qb[:, :1], 1),
            ("even / odd stride-2 slices (2^20, 4)", g[0::2], g[1::2], 1),
            ("component-strided (2^21, 4) x (2^21, 4)", g.T.contiguous().T, h, 0),
            ("(2^21, 4) x (4,) CPU scalar", g, cpu4, None)]:
        row("bb_fp4_mul", label, bb.fp4_mul, bb.fp4_mul_cuda, bb.fp4_mul_plain,
            (x, y), rf.ext_mul_work(x, y, "bb4"), vec, k=4)
    del a, b, g, h, qa, qb


def phase_kernels_digit(results):
    """Phase 3 for the stream kernel and the digit level: the probes'
    shapes ((16384, 4096) words; B 2, F 32, R 4096, PF 128; the three levels
    of ifft 2^20 with B 2; the kernel bench's 4096^3 product for the dot),
    each kernel against its plain version with its device ms and
    bound_frac, the fused level also against the stage chain and the
    butterfly level (independent kernels), there and at the three levels
    of fft (12, 2^21), with both levels' device ms; torch.add /
    torch._int_mm timed beside the stream and the dot, _int_mm with its
    matrix row-major (library_ms) and column-major (library_col_ms)."""
    import numpy as np
    import torch

    from ministark_tpu_torch.fields import GOLDILOCKS_FP as F
    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops import ntt_digit as nd
    from ministark_tpu_torch.ops import ntt_pipe as pp
    from ministark_tpu_torch.ops import stream

    rng = np.random.default_rng(SEED + 2)
    compare = make_compare(results)

    words = torch.from_numpy(rng.integers(0, 1 << 32, size=(16384, 4096),
                                          dtype=np.uint64).astype(np.uint32)
                             .view(np.int32)).cuda()
    words.view(-1)[:2] = torch.tensor([-1, 2**31 - 1], dtype=torch.int32)
    rec = compare("stream_add1", "(16384, 4096) words",
                  lambda: stream.stream_add1_cuda(words),
                  lambda: stream.stream_add1_plain(words),
                  rf.stream_work(words.numel()), reps=10, plain_reps=1,
                  library=lambda: torch.add(words, 1))
    # the kernel and torch.add in 15 pairs of interleaved turns, medians
    pr = _load_script("torch_stream_probe").paired(
        lambda: stream.stream_add1_cuda(words), lambda: torch.add(words, 1), 15, 10,
        "cuda")
    rec["paired_ms"] = pr["kernel_median_ms"]
    rec["paired_library_ms"] = pr["torch_add_median_ms"]
    say("kernels", f"stream_add1 (16384, 4096) words, {pr['pairs']} pairs in turns: "
                   f"kernel median {pr['kernel_median_ms']:.4f} ms, torch.add median "
                   f"{pr['torch_add_median_ms']:.4f} ms, median difference "
                   f"{pr['diff_median_ms']:+.4f} ms")
    del words

    def level_shapes():
        root32 = F.get_root_of_unity(32)
        yield ("F 32, R 4096, PF 128", 32, 4096,
               nd.digit_matrix(root32, 32, "cuda", 128),
               ntt.stage_table(F, root32, 32, "cuda"), None, 1)
        n = 1 << 20
        tables = zip(nd.level_tables(n, True, "cuda"),
                     pp._tables(n, True, torch.device("cuda")))
        for i, ((Fi, vd, W, k_prod), (_, tw, _, _)) in enumerate(tables):
            yield (f"ifft 2^20 level {i} (F {Fi})", Fi, n // Fi, vd, tw, W, k_prod)

    def int_mm_col(rec, fn):
        """torch._int_mm with its matrix column-major (the layout cuBLAS's
        int8 product is fast in), beside today's row-major reading."""
        rec["library_col_ms"] = timed(fn, 10)
        say("kernels", f"digit_dot_s8 {rec['shape']}: torch._int_mm row-major matrix "
                       f"{rec['library_ms']:.4f} ms, column-major "
                       f"{rec['library_col_ms']:.4f} ms")

    def butterfly(label, x, vd, tw, W, k_prod, fused):
        """The fused level against the butterfly level on the same input,
        both timed on the card alone (device ms)."""
        if not torch.equal(fused, pp.level_cuda(x, tw, None, W, k_prod)):
            fail(f"digit_level_gl {label}: differs from the butterfly level")
        bdms = rf.device_ms(lambda: pp.level_cuda(x, tw, None, W, k_prod), 10)
        fdms = rf.device_ms(lambda: nd.level_cuda(x, vd, W, k_prod), 10)
        say("kernels", f"digit_level_gl {label}: equal to the butterfly level; device "
                       f"ms digit {fdms:.4f}, butterfly (ntt_pipe_level) {bdms:.4f}, "
                       f"butterfly / digit {bdms / fdms:.3f}")

    B = 2
    for label, Fi, R, vd, tw, W, k_prod in level_shapes():
        x = _rand_u64(rng, (B, Fi, R), F.p)
        x.view(-1)[:4] = torch.tensor(
            [nd.GL_CENTER_T - 1, nd.GL_CENTER_T, nd.GL_CENTER_T + 1, 0],
            dtype=torch.int64)
        rows = 0 if W is None else W.shape[0]
        K, N = vd.shape
        compare("digitize_gl", label, lambda: nd.digitize_cuda(x),
                lambda: nd.digitize_plain(x), rf.digitize_work(B, Fi, R), reps=10,
                device=True)
        d = nd.digitize_cuda(x)

        # the library's product beside the kernel's: torch._int_mm wants
        # row-major (R, K) digits, so the K-major stack is transposed once,
        # outside the timed call (library_ms is the B products alone)
        d_rows = d.transpose(1, 2).contiguous()
        vd_col = vd.t().contiguous().t()
        if not torch.equal(torch.stack([torch._int_mm(d_rows[b], vd) for b in range(B)]),
                           nd.digit_dot_cuda(d, vd)):
            fail(f"digit_dot_s8 {label}: differs from torch._int_mm")
        rec = compare("digit_dot_s8", label, lambda: nd.digit_dot_cuda(d, vd),
                      lambda: nd.digit_dot_plain(d, vd), rf.digit_dot_work(B, K, R, N),
                      reps=10, library=lambda: [torch._int_mm(d_rows[b], vd)
                                                for b in range(B)], device=True)
        int_mm_col(rec, lambda: [torch._int_mm(d_rows[b], vd_col) for b in range(B)])
        del d_rows, vd_col
        Rm = nd.digit_dot_cuda(d, vd)
        compare("recombine_gl", label + ", no twiddle",
                lambda: nd.recombine_cuda(Rm, Fi), lambda: nd.recombine_plain(Rm, Fi),
                rf.recombine_work(B, R, Fi), reps=10, device=True)
        if W is not None:
            compare("recombine_gl", label + ", twiddle",
                    lambda: nd.recombine_cuda(Rm, Fi, W, k_prod),
                    lambda: nd.recombine_plain(Rm, Fi, W, k_prod),
                    rf.recombine_work(B, R, Fi, rows), reps=10, device=True)
        compare("digit_level_gl", label, lambda: nd.level_cuda(x, vd, W, k_prod),
                lambda: nd.level_plain(x, vd, W, k_prod),
                rf.digit_level_work(B, Fi, R, rows), reps=10, device=True)
        fused = nd.level_cuda(x, vd, W, k_prod)
        if not torch.equal(fused, nd.recombine_cuda(Rm, Fi, W, k_prod)):
            fail(f"digit_level_gl {label}: differs from the stage chain")
        butterfly(label, x, vd, tw, W, k_prod, fused)
        del x, d, Rm, fused

    # the fused level where a prover would use it: fft (12, 2^21), the fast
    # prover's LDE size, every level (no coset), against the butterfly level
    n, B = 1 << 21, 12
    tables = zip(nd.level_tables(n, False, "cuda"),
                 pp._tables(n, False, torch.device("cuda")))
    for i, ((Fi, vd, W, k_prod), (_, tw, _, _)) in enumerate(tables):
        label = f"fft (12, 2^21) level {i} (F {Fi})"
        x = _rand_u64(rng, (B, Fi, n // Fi), F.p)
        compare("digit_level_gl", label, lambda: nd.level_cuda(x, vd, W, k_prod),
                lambda: nd.level_plain(x, vd, W, k_prod),
                rf.digit_level_work(B, Fi, n // Fi, 0 if W is None else W.shape[0]),
                reps=10, plain_reps=1, device=True)
        butterfly(label, x, vd, tw, W, k_prod, nd.level_cuda(x, vd, W, k_prod))
        del x

    # the kernel bench's product (digit_dot_4096): one K-major (4096, 4096)
    # operand against a (4096, 4096) matrix, random int8 over the full range
    dm = 4096
    a8 = torch.from_numpy(rng.integers(-128, 128, size=(1, dm, dm), dtype=np.int64)
                          .astype(np.int8)).cuda()
    b8 = torch.from_numpy(rng.integers(-128, 128, size=(dm, dm), dtype=np.int64)
                          .astype(np.int8)).cuda()
    a8_rows = a8[0].T.contiguous()
    b8_col = b8.t().contiguous().t()
    if not torch.equal(torch._int_mm(a8_rows, b8_col), nd.digit_dot_cuda(a8, b8)[0]):
        fail("digit_dot_s8 4096^3: differs from torch._int_mm")
    rec = compare("digit_dot_s8", "(1, 4096, 4096) x (4096, 4096)",
                  lambda: nd.digit_dot_cuda(a8, b8), lambda: nd.digit_dot_plain(a8, b8),
                  rf.digit_dot_work(1, dm, dm, dm), reps=10,
                  library=lambda: torch._int_mm(a8_rows, b8), device=True)
    int_mm_col(rec, lambda: torch._int_mm(a8_rows, b8_col))


# phase 3's back-to-back division calls and CUDA-graph replays
DIV_SCAN_RACE_CALLS = 50
DIV_SCAN_GRAPH_REPLAYS = 3


def _ext_points(rng, E, count):
    """(z, 1/z) on the card, (count, K) each: random nonzero elements of the
    extension E and their inverses from the host field."""
    import numpy as np

    from ministark_tpu_torch.ops.field import get_ops

    k = get_ops(E)
    zs = [E.from_base_coeffs(tuple(int(c) for c in row))
          for row in rng.integers(1, E.p, size=(count, E.extension_degree),
                                  dtype=np.uint64)]
    return k.pack(zs).cuda(), k.pack([E.inv(z) for z in zs]).cuda()


def phase_kernels_div_scan(results):
    """Phase 3 for the division scan and pow_dot (csrc/div_scan.cu), Goldilocks
    Fp2 then BabyBear Fp4, at the provers' shapes: the FRI fold-divide 2^21 ->
    2^20 (fold, DEEP value as the head), a division of 2^20 coefficients, the
    query round's two divisions at the parity configuration's Q (one
    polynomial broadcast against Q lines in the head, then Q rows), a
    resident 2^19 block with its start and carry; pow_dot at stride 2 over
    2^21 coefficients (the even half), both halves at once (parts=2,
    eval_even_odd's call) and a 2^19 block's total from its start. Each
    against its plain version on the card (exact), with device ms,
    bound_frac and the launches one call counts (fails unless 1); no
    PyTorch call computes either function. Then DIV_SCAN_RACE_CALLS calls
    back to back at the fold-divide and the (Q, 2^20) query shapes, each
    equal to the plain result (the look-back's flags and ticket written back
    to zero by each call), and one CUDA graph of the Goldilocks fold-divide
    replayed DIV_SCAN_GRAPH_REPLAYS times, equal each time."""
    import numpy as np
    import torch

    from ministark_tpu_torch.fields import BABYBEAR_FP4, GOLDILOCKS_FP2, Goldilocks
    from ministark_tpu_torch.fri.stir import eval_points
    from ministark_tpu_torch.fri.whir import sumcheck_evals
    from ministark_tpu_torch.ops import div_scan as ds
    from ministark_tpu_torch.ops import poly
    from ministark_tpu_torch.ops.field import get_ops
    from ministark_tpu_torch.stark import StarkConfig

    rng = np.random.default_rng(SEED + 18)
    compare = make_compare(results)
    Q = StarkConfig(Goldilocks, 20, 2, MAIN_STEPS, 6).fri_queries
    n20, n19 = 1 << 20, 1 << 19
    for tag, E in (("gl2", GOLDILOCKS_FP2), ("bb4", BABYBEAR_FP4)):
        k, K = get_ops(E), E.extension_degree
        z, zinv = _ext_points(rng, E, Q)
        z1, zi1 = z[:1], zinv[:1]
        c21 = _rand_field(rng, (1, 2 * n20, K), E.p)
        cq = _rand_field(rng, (Q, n20, K), E.p)
        blk = _rand_field(rng, (1, n19, K), E.p)
        alpha, small = _rand_field(rng, (K,), E.p), _rand_field(rng, (Q, 2, K), E.p)
        fold_kw = dict(head=small[:1, :1], fold=alpha)
        divisions = [
            ("fold-divide 2^21 -> 2^20 (fold, head 1)", c21, n20, z1, zi1, fold_kw),
            ("(1, 2^20)", cq[:1], n20, z1, zi1, {}),
            (f"query ({Q}, 2^20), one polynomial broadcast, head 2",
             cq[:1].expand(Q, -1, -1), n20, z, zinv, dict(head=small)),
            (f"query ({Q}, 2^20)", cq, n20, z, zinv, {}),
            ("block 2^19 from 2^19 with its carry", blk, n19, z1, zi1,
             dict(start=n19, carry=small[:1, 0]))]
        def per_call(name, label, rec, kern):
            """The launches one call counts (ops/div_scan.py::launches): 1."""
            before = ds.launches[name]
            kern()
            rec["launches_per_call"] = got = ds.launches[name] - before
            say("kernels", f"{name} {label}: {got} launch(es) per call")
            if got != 1:
                fail(f"{name} {label}: {got} launches per call, expected 1")

        for label, c, m, zz, zi, kw in divisions:
            small = (zz, zi, kw.get("head"), kw.get("carry"), kw.get("fold"))
            count = dict(start=kw.get("start", 0), carry="carry" in kw)
            work = rf.div_scan_work(c, m, "fold" in kw, tag, *small, **count)
            kern = lambda: ds.div_scan_cuda(k, c, zz, zi, **kw)   # noqa: E731
            rec = compare("div_scan_" + tag, label, kern,
                          lambda: ds.div_scan_plain(k, c, zz, zi, **kw), work,
                          plain_reps=1, device=True)
            # the most bound_frac the parallel scan can reach: its own work
            # (two Horner steps an output) against the bound's
            scan = rf.bound(*rf.div_scan_work(c, m, "fold" in kw, tag, *small, **count,
                                              scan=True))[0]
            rec["ceiling"] = rec["bound_ms"] / scan
            say("kernels", f"div_scan_{tag} {label}: the scan's ceiling "
                           f"{rec['ceiling']:.3f} of the bound")
            per_call("div_scan_" + tag, label, rec, kern)
        # the point evaluations (ROADMAP X8) at 2^20 - 1: eval_many's one
        # point broadcast over the w + t = 6 polynomials (deep_ali, the fast
        # mode's point_evals) and over FAST_BATCH traces' 24; STIR's
        # eval_points and WHIR's sumcheck_evals at their largest broadcast
        # rounds, 2^18 coefficients at 32 and 34 points
        pts, _ = _ext_points(rng, E, 34)
        c6 = _rand_field(rng, (6 * FAST_BATCH, n20, K), E.p)
        c18 = _rand_field(rng, (1, n20 // 4, K), E.p)
        dots = [("eval_even_odd 2^21, stride 2 (even half)", c21, z1, 0, 2, 1),
                ("eval_even_odd 2^21, both halves (parts=2)", c21, z1, 0, 1, 2),
                ("block total 2^19 from 2^19", blk, z1, n19, 1, 1),
                ("eval_many (6, 2^20), one point broadcast (deep_ali, fast point_evals)",
                 c6[:6], z1.expand(6, -1), 0, 1, 1),
                (f"eval_many ({6 * FAST_BATCH}, 2^20), one point broadcast (fast, "
                 f"{FAST_BATCH} traces)", c6, z1.expand(6 * FAST_BATCH, -1), 0, 1, 1),
                ("STIR eval_points (32, 2^18), the polynomial broadcast",
                 c18.expand(32, -1, -1), pts[:32], 0, 1, 1),
                ("WHIR sumcheck_evals (34, 2^18), the polynomial broadcast (parts=2)",
                 c18.expand(34, -1, -1), pts, 0, 1, 2)]
        for label, c, zz, start, stride, parts in dots:
            work = rf.pow_dot_work(c[:, ::stride], zz, tag, parts, start)
            kern = lambda: ds.pow_dot_cuda(k, c, zz, start, stride, 0, parts)   # noqa: E731
            rec = compare("pow_dot_" + tag, label, kern,
                          lambda: ds.pow_dot_plain(k, c, zz, start, stride, 0, parts),
                          work, plain_reps=1, device=True)
            per_call("pow_dot_" + tag, label, rec, kern)
        # the point evaluations themselves: one pow_dot launch each
        x8 = [("eval_many", lambda: poly.eval_many(k, c6[:6], z1[0]), dots[3]),
              ("eval_points", lambda: eval_points(k, c18[0], pts[:32]), dots[5]),
              ("sumcheck_evals", lambda: sumcheck_evals(k, c18[0], pts), dots[6])]
        for label, fn, (_, c, zz, start, stride, parts) in x8:
            before = ds.launches["pow_dot_" + tag]
            got = fn()
            per = ds.launches["pow_dot_" + tag] - before
            if per != 1 or not torch.equal(
                    got, ds.pow_dot_plain(k, c, zz, start, stride, 0, parts)):
                fail(f"pow_dot_{tag} {label}: {per} launches, or not the plain result")
            say("kernels", f"pow_dot_{tag} {label}: one launch, equal to pow_dot_plain")
        del c6, c18
        for label, c, zz, zi, kw in (("fold-divide 2^21 -> 2^20", c21, z1, zi1, fold_kw),
                                      (f"query ({Q}, 2^20)", cq, z, zinv, {})):
            want = ds.div_scan_plain(k, c, zz, zi, **kw)
            outs = [ds.div_scan_cuda(k, c, zz, zi, **kw) for _ in range(DIV_SCAN_RACE_CALLS)]
            bad = [i for i, o in enumerate(outs) if not torch.equal(o, want)]
            if bad:
                fail(f"div_scan_{tag} {label}: calls {bad} of {DIV_SCAN_RACE_CALLS} "
                     "back to back differ from the plain result")
            say("kernels", f"div_scan_{tag} {label}: {DIV_SCAN_RACE_CALLS} calls back "
                           "to back, each equal to the plain result")
            del outs
        if tag == "gl2":
            want = ds.div_scan_plain(k, c21, z1, zi1, **fold_kw)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = ds.div_scan_cuda(k, c21, z1, zi1, **fold_kw)
            for i in range(DIV_SCAN_GRAPH_REPLAYS):
                got.zero_()
                graph.replay()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"div_scan_gl2 fold-divide: CUDA graph replay {i} differs "
                         "from the plain result")
            say("kernels", f"div_scan_gl2 fold-divide: one CUDA graph replayed "
                           f"{DIV_SCAN_GRAPH_REPLAYS} times, equal each time")
            del graph, got
        del c21, cq, blk


FIRST_MATCH_RACE_CALLS = 50
FIRST_MATCH_GRAPH_REPLAYS = 3
FIRST_MATCH_LAUNCHES_PER_CALL = 1     # up to MATCH_MAX_ROWS rows a call


def _planted_search(rng, n, C, q, p):
    """(comps (n, C), rows (q, C), want (q,)) on the card: random elements
    below p with planted rows and their expected first indices (the kernel's
    blocks take 256 threads x 4 elements a pass): index 0 and n - 1; a first
    match in block 1 with a copy in a later block; one in block 5 with a
    copy in block 0's second pass (past 1056 blocks x 1024); two copies in
    one warp's pass (40000, 40003); an absent value (n); beyond 6 rows,
    elements at random indices (their first index from the host) and every
    seventh row absent."""
    import numpy as np
    import torch

    comps = rng.integers(0, p, size=(n, C), dtype=np.uint64)
    pairs = [(1500, min(700_000, n - 2)), (5 * 1024 + 7, 1056 * 1024 + 10),
             (40000, 40003)]
    for first, later in pairs:
        if later < n:
            comps[later] = comps[first]
    want = [0, n - 1] + [first for first, _ in pairs]
    rows = [comps[i].copy() for i in want]
    absent = rng.integers(0, p, size=C, dtype=np.uint64)
    rows.append(absent)
    want.append(n)
    for j in range(6, q):
        if j % 7 == 0:
            rows.append(rng.integers(0, p, size=C, dtype=np.uint64))
            want.append(n)
        else:
            i = int(rng.integers(0, n))
            rows.append(comps[i].copy())
            want.append(i)
    rows = np.stack(rows[:q])
    want = want[:q]
    # a planted or random row's value may occur earlier (a later copy's first)
    for j, i in enumerate(want):
        if i < n:
            hit = np.flatnonzero((comps == rows[j]).all(1))
            want[j] = int(hit[0])
    # the field's storage: Goldilocks int64, BabyBear int32
    if p < (1 << 32):
        t = lambda a: torch.from_numpy(a.astype(np.int32)).cuda()  # noqa: E731
    else:
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).cuda()  # noqa: E731
    return t(comps), t(rows), torch.tensor(want, dtype=torch.int64)


def phase_kernels_first_match(results):
    """Phase 3 for the first-occurrence leaf search (csrc/leaf_search.cu,
    commit/packed_tree.py; ROADMAP X4) at the parity prover's query rounds:
    GL Fp2 (2^21, 2) and BB Fp4 (2^21, 4) with q = 6 rows (two a query,
    fri_queries 3), a resident rank's block (2^20, 2) and q = 64 rows (over
    the plain version's SEARCH_CHUNK), the rows planted (_planted_search).
    Each against its plain version on the card and the planted indices
    (exact), with device ms, the bytes bound and bound_frac; one launch a
    call (FIRST_MATCH_LAUNCHES_PER_CALL); no PyTorch call computes a first
    occurrence (library_ms null). Then FIRST_MATCH_RACE_CALLS calls back to
    back at (2^21, 2) with q 6 and 64, each equal to the plain result (the
    minima and the ticket reset by each call's last block), and one CUDA
    graph of a call replayed FIRST_MATCH_GRAPH_REPLAYS times."""
    import numpy as np
    import torch

    from ministark_tpu_torch.commit import packed_tree as pt
    from ministark_tpu_torch.fields import BABYBEAR_FP, Goldilocks

    rng = np.random.default_rng(SEED + 21)
    compare = make_compare(results)
    gl_p, bb_p = Goldilocks.base.p, BABYBEAR_FP.p
    n21 = 1 << 21
    cases = [("GL Fp2 (2^21, 2), q 6", n21, 2, 6, gl_p),
             ("BB Fp4 (2^21, 4), q 6", n21, 4, 6, bb_p),
             ("resident block (2^20, 2), q 6", n21 // 2, 2, 6, gl_p),
             ("(2^21, 2), q 64", n21, 2, 64, gl_p)]
    race = []
    for label, n, C, q, p in cases:
        comps, rows, want = _planted_search(rng, n, C, q, p)
        kern = lambda: pt.first_match_cuda(comps, rows, comps.dtype)   # noqa: E731
        got = kern().cpu()
        if not torch.equal(got, want):
            fail(f"first_match {label}: {got.tolist()} against the planted "
                 f"{want.tolist()}")
        rec = compare("first_match", label, kern,
                      lambda: pt._first_match_find_plain(comps, rows),
                      rf.first_match_work(comps, rows), plain_reps=1, device=True)
        before = pt.launches["first_match"]
        kern()
        rec["launches_per_call"] = per = pt.launches["first_match"] - before
        say("kernels", f"first_match {label}: {per} launch(es) per call")
        if per != FIRST_MATCH_LAUNCHES_PER_CALL:
            fail(f"first_match {label}: {per} launches per call, expected "
                 f"{FIRST_MATCH_LAUNCHES_PER_CALL}")
        if n == n21 and C == 2:
            race.append((label, comps, rows, want))
    for label, comps, rows, want in race:
        outs = [pt.first_match_cuda(comps, rows, torch.int64)
                for _ in range(FIRST_MATCH_RACE_CALLS)]
        bad = [i for i, o in enumerate(outs) if not torch.equal(o.cpu(), want)]
        if bad:
            fail(f"first_match {label}: calls {bad} of {FIRST_MATCH_RACE_CALLS} back "
                 "to back differ from the plain result")
        say("kernels", f"first_match {label}: {FIRST_MATCH_RACE_CALLS} calls back to "
                       "back, each equal to the plain result")
    label, comps, rows, want = race[0]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = pt.first_match_cuda(comps, rows, torch.int64)
    for i in range(FIRST_MATCH_GRAPH_REPLAYS):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            fail(f"first_match {label}: CUDA graph replay {i} differs from the "
                 "plain result")
    say("kernels", f"first_match {label}: one CUDA graph replayed "
                   f"{FIRST_MATCH_GRAPH_REPLAYS} times, equal each time")
    del graph, got, race


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
    padded = torch.zeros((coeffs.shape[0], 2 * n), dtype=coeffs.dtype,
                         device=cols.device)
    padded[:, :n] = coeffs
    lde = ntt.transform_plain(padded, pre=shift, field=base)
    return trace_root, root(lde.T.contiguous())


def reset_counts():
    """Set every kernel wrapper's launch count to 0, and the call counts of
    the field ops, the division scan and the leaf search."""
    from ministark_tpu_torch.commit import packed_tree as pt
    from ministark_tpu_torch.ops import bb
    from ministark_tpu_torch.ops import div_scan as ds
    from ministark_tpu_torch.ops import field as gl
    from ministark_tpu_torch.ops import leaf_hash as lh
    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops import ntt_four_step as fs
    from ministark_tpu_torch.ops import ntt_pipe as pp
    from ministark_tpu_torch.ops import ntt_digit as nd
    from ministark_tpu_torch.ops import sha256 as sh
    from ministark_tpu_torch.ops import stream

    for counts in (ntt.launches, lh.launches, fs.pass1_launches,
                   fs.pass2_launches, pp.launches, nd.launches, ds.launches, ds.calls,
                   gl.launches, gl.calls, bb.launches, bb.calls, pt.launches, pt.calls):
        for key in counts:
            counts[key] = 0
    sh.launches = sh.row_launches = 0
    stream.launches = 0
    sh.fan_launches = {}


def read_counts():
    """({kernel: launches}, {fan: inner-level launches}) since reset_counts,
    with each NTT kernel and the leaf hash split by field ("_bb"), and the
    calls of the field ops, the division scan and the leaf search ("<kernel>
    calls")."""
    from ministark_tpu_torch.commit import packed_tree as pt
    from ministark_tpu_torch.ops import bb
    from ministark_tpu_torch.ops import div_scan as ds
    from ministark_tpu_torch.ops import field as gl
    from ministark_tpu_torch.ops import leaf_hash as lh
    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops import ntt_four_step as fs
    from ministark_tpu_torch.ops import ntt_pipe as pp
    from ministark_tpu_torch.ops import ntt_digit as nd
    from ministark_tpu_torch.ops import sha256 as sh
    from ministark_tpu_torch.ops import stream

    counts = {"sha256_inner_level": sh.launches, "sha256_rows": sh.row_launches,
              "leaf_hash": lh.launches[20],
              "leaf_hash_bb": lh.launches[10], "stream_add1": stream.launches,
              **nd.launches, **ds.launches, **gl.launches, **bb.launches,
              **pt.launches,
              **{f"{name} calls": n
                 for name, n in {**ds.calls, **gl.calls, **bb.calls, **pt.calls}.items()}}
    for tag, suffix in (("gl", ""), ("bb", "_bb")):
        counts["ntt" + suffix] = ntt.launches[tag]
        counts["ntt_four_step_pass1" + suffix] = fs.pass1_launches[tag]
        counts["ntt_four_step_pass2" + suffix] = fs.pass2_launches[tag]
        counts["ntt_pipe_level" + suffix] = pp.launches[tag]
    return counts, dict(sh.fan_launches)


def one_launch_a_call(launches, where):
    """Fails unless each division scan, pow_dot and first_match kernel
    launched once for each of its wrapper's calls, and each field kernel
    (gl_mul, gl_ext_mul, gl_ew, bb_ew, bb_fp4_mul) once for each field op
    that took it (the "<kernel> calls" counts)."""
    for key, n in launches.items():
        if key.endswith(" calls") and launches[key[:-6]] != n:
            fail(f"{key[:-6]}: {launches[key[:-6]]} launches for {n} calls on {where}")


FIELD_KERNELS = ("gl_mul", "gl_ext_mul", "gl_ew", "bb_ew", "bb_fp4_mul")


def record(results, path, launches):
    """The kernels a path's run launched, under that path; prints the field
    kernels' launches and calls."""
    one_launch_a_call(launches, f"the {path} path")
    say("launches", f"{path}: field ops " + json.dumps(
        {k: [launches[k], launches[f"{k} calls"]] for k in FIELD_KERNELS
         if launches[k] or launches[f"{k} calls"]}) + " ([launches, calls])")
    for name, count in launches.items():
        if count and name in results:
            results[name]["paths"][path] = count


def phase_main(results, field="gl"):
    """The parity prover at its pins and at 2^20 - 1 cold and warm, then
    each other NTT backend at its 2^14 - 1 pin and one 2^20 - 1 prove."""
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
    peak = torch.cuda.max_memory_allocated()
    say(label, f"warm prove {warm:.3f} s; peak device memory "
               f"{peak / 2**30:.2f} GiB ({peak} B); "
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
        record(results, f"{path}_{backend}", launches)
    return d1


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
    coset-row layout written out here afresh. The batched FRI commits over
    the subgroup of size N, STIR and WHIR over its coset by the prime
    field's generator g (their L_0)."""
    import torch

    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops import sha256 as sh
    from ministark_tpu_torch.ops.field import lift_base_array
    from ministark_tpu_torch.ops.poly import mix_columns

    cfg, ke, ext = stark.config, stark.ke, stark.ext
    F, arity = cfg.fold_factor, cfg.arity
    d = ext.extension_degree
    offset = None if cfg.lde_backend == "fri" else stark.base.generator

    def coset_rows(polys):                       # (B, n, d) coefficients
        B, n = polys.shape[0], polys.shape[1]
        N = cfg.blowup * n
        padded = torch.zeros((d * B, N), dtype=polys.dtype, device=polys.device)
        padded[:, :n] = polys.movedim(-1, 1).reshape(d * B, n)
        ev = ntt.transform_plain(padded, pre=offset,
                                 field=stark.base).reshape(B, d, N)
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
    peak = torch.cuda.max_memory_allocated()
    say(label, f"steps {MAIN_STEPS}: warm prove {warm:.3f} s; peak device "
               f"memory {peak / 2**30:.2f} GiB ({peak} B); "
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
    return blob, many_blob


def phase_stir_whir(results):
    """The fast prover with the STIR and the WHIR low-degree tests, each in
    FAST_CFG: its golden fixture, its JAX pins, 2^20 - 1 cold and warm
    (verified, both group roots recomputed with the plain versions), then
    one BabyBear + Fp4 2^20 - 1 prove, verified. Returns {"stir": sha256,
    "whir": sha256} of the Goldilocks 2^20 - 1 proof bytes."""
    import hashlib

    import torch

    from ministark_tpu_torch.stark.proof_io import (
        fast_proof_from_bytes,
        fast_proof_to_bytes,
    )

    label = "stir_whir"
    digests = {}
    for lde, pins in LDT_PINS.items():
        cfg = dict(FAST_CFG, lde_backend=lde)
        sf = _stark_field("gl")

        name = f"fast_{lde}_fib100.bin"
        stark, (trace,) = _fast(100, queries=4, final_len=8, lde_backend=lde)
        golden = open(os.path.join(ROOT, "tests", "golden", name), "rb").read()
        if fast_proof_to_bytes(sf, stark.prove(trace)) != golden:
            fail(f"{lde}: steps 100 differ from tests/golden/{name}")
        if not stark.verify(stark._constraint_polys(trace),
                            fast_proof_from_bytes(sf, golden)):
            fail(f"{lde}: the golden proof was not accepted")
        say(label, f"{lde}: steps 100 equal to {name}, decoded and verified")

        for steps, pin in pins.items():
            stark, (trace,) = _fast(steps, **cfg)
            t0 = time.time()
            proof = stark.prove(trace)
            secs = time.time() - t0
            got = hashlib.sha256(fast_proof_to_bytes(sf, proof)).hexdigest()
            if got != pin:
                fail(f"{lde}: steps {steps}: sha256 {got} differs from the JAX pin")
            if not stark.verify(stark._constraint_polys(trace), proof):
                fail(f"{lde}: steps {steps}: verify returned False")
            say(label, f"{lde}: steps {steps}: equal to the JAX package's pinned "
                       f"proof bytes, verified; prove {secs:.2f} s")

        stark, (trace,) = _fast(MAIN_STEPS, **cfg)
        reset_counts()
        t0 = time.time()
        proof = stark.prove(trace)
        cold = time.time() - t0
        launches, fans = read_counts()
        say(label, f"{lde}: steps {MAIN_STEPS}: cold prove {cold:.3f} s; "
                   "phase_seconds " + json.dumps(
                       {k: round(v, 4) for k, v in stark.phase_seconds.items()}))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        proof2 = stark.prove(trace)
        warm = time.time() - t0
        say(label, f"{lde}: steps {MAIN_STEPS}: warm prove {warm:.3f} s; peak "
                   f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                   "GiB; phase_seconds " + json.dumps(
                       {k: round(v, 4) for k, v in stark.phase_seconds.items()}))
        blob = fast_proof_to_bytes(sf, proof)
        if fast_proof_to_bytes(sf, proof2) != blob:
            fail(f"{lde}: cold and warm proofs differ")
        digests[lde] = hashlib.sha256(blob).hexdigest()
        t0 = time.time()
        if not stark.verify(stark._constraint_polys(trace), proof):
            fail(f"{lde}: verify returned False")
        vsecs = time.time() - t0
        say(label, f"{lde}: steps {MAIN_STEPS}: {len(blob)} proof bytes "
                   f"(size_bytes {proof.size_bytes()}), sha256 "
                   f"{hashlib.sha256(blob).hexdigest()}; verify True in "
                   f"{vsecs:.3f} s")
        if list(_fast_reference_roots(stark, trace)) != proof.fri_proof.group_roots:
            fail(f"{lde}: the group roots differ from the plain versions' roots")
        say(label, f"{lde}: tree_w and tree_v roots equal the plain versions' "
                   "over the coset g * H on the card")
        record(results, lde, launches)
        say(label, f"{lde}: launches " + json.dumps(
            {k: v for k, v in launches.items() if v}) + "; inner-level by fan "
            + json.dumps(fans))
        del proof, proof2, stark, trace

        sf = _stark_field("bb")
        stark, (trace,) = _fast(MAIN_STEPS, field="bb", **cfg)
        reset_counts()
        t0 = time.time()
        proof = stark.prove(trace)
        secs = time.time() - t0
        launches, fans = read_counts()
        if not stark.verify(stark._constraint_polys(trace), proof):
            fail(f"{lde} BabyBear: verify returned False")
        blob = fast_proof_to_bytes(sf, proof)
        say(label, f"{lde} BabyBear: steps {MAIN_STEPS}: cold prove {secs:.3f} s, "
                   f"{len(blob)} proof bytes, verified; phase_seconds "
                   + json.dumps({k: round(v, 4)
                                 for k, v in stark.phase_seconds.items()}))
        record(results, f"{lde}_bb", launches)
        say(label, f"{lde} BabyBear: launches " + json.dumps(
            {k: v for k, v in launches.items() if v}) + "; inner-level by fan "
            + json.dumps(fans))
        del proof, stark, trace
    return digests


SHARDED_TIMEOUT_S = 900
# a rank of two holds its block of every stage tensor: its peak allocated
# memory in the warm 2^20 - 1 parity, fast, STIR and WHIR proves stays at
# most this share of one device's, read alike in a process that proves with
# no mesh
SHARDED_PEAK_SHARE = 0.75
# a resident fast, STIR or WHIR rank's all_gather bytes outside the openings
# in the cold 2^20 - 1 prove (local tree tops, point-evaluation and sumcheck
# partials, the block divisions' totals, the handoff and final
# coefficients); one witness LDE is 6 x 2^21 x 2 x 8 B = 201 MB
SHARDED_FAST_GATHER_BYTES = 2 << 20
# phase sharded's shapes: the sharded pieces timed against one device (the
# 2^20 - 1 prove's coset LDE and constrain tree, the fast prove's witness
# index tree) and the four-rank group's pinned steps
SHARDED_LDE = (6, 1 << 21)
SHARDED_TREE = 6 << 21
SHARDED_ROWS = (1 << 19, 48)
SHARDED_PIN_STEPS = MODEL_PIN_STEPS
SHARDED_CORE_N = 1 << 18                 # the sharded prove core's trace domain


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sharded_timed(fn, device, reps=3):
    """(result, mean ms of ``reps`` warm calls): host clock, the card
    synchronized around the calls."""
    out = fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) / reps * 1e3


def _sharded_prove(prove, digest, device):
    """(the cold proof, its digest, cold s, warm s, the cold prove's kernel
    launches, its collectives, the warm proof's digest, the warm prove's
    peak allocated bytes, the bytes the cold prove received by kind)."""
    import torch

    from ministark_tpu_torch.parallel import mesh as pm

    reset_counts()
    before, got = sum(pm.collectives.values()), dict(pm.received)
    t0 = time.time()
    proof = prove()
    _sync(device)
    cold = time.time() - t0
    launches, _ = read_counts()
    collectives = sum(pm.collectives.values()) - before
    received = {k: v - got[k] for k, v in pm.received.items()}
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    proof2 = prove()
    _sync(device)
    warm = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device)
    return (proof, digest(proof), cold, warm, launches, collectives, digest(proof2),
            peak, received)


def _sharded_one(mesh):
    """Phase sharded's one-device baseline, in a process of its own as each
    rank of the two-rank group is: the GL parity and fast proves at 2^20 - 1
    (the fast one with batched FRI, STIR and WHIR) with no mesh, each cold
    then warm. {"parity": ..., "fast": ..., "stir": ..., "whir": ...}, each (cold
    and warm proofs' digests, the warm prove's peak allocated bytes, warm
    s)."""
    import hashlib

    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark.engine import DeviceEngine
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
    from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_digests

    sf, dev = _stark_field("gl"), mesh.device
    trace = fibonacci_device_trace(sf, MAIN_STEPS, on_device=True, device=dev)
    engine = DeviceEngine(StarkConfig(sf, 20, 2, MAIN_STEPS, trace.constrain_number()),
                          device=dev)
    _, cold_digest, _, warm, _, _, warm_digest, peak, _ = _sharded_prove(
        lambda: engine.prove(trace), lambda p: proof_digests(sf, p), dev)
    out = {"parity": (cold_digest, warm_digest, peak, warm)}
    del engine
    for path, lde in (("fast", "fri"), ("stir", "stir"), ("whir", "whir")):
        stark = FastStark(FastStarkConfig(sf, MAIN_STEPS, **dict(FAST_CFG, lde_backend=lde)),
                          device=dev)
        _, cold_digest, _, warm, _, _, warm_digest, peak, _ = _sharded_prove(
            lambda: stark.prove(trace),
            lambda p: hashlib.sha256(fast_proof_to_bytes(sf, p)).hexdigest(), dev)
        out[path] = (cold_digest, warm_digest, peak, warm)
        del stark
    return out


def _sharded_full(mesh):
    """One rank of phase sharded's two-rank group: the GL parity and fast
    proves at 2^20 - 1 (cold, warm, verified; the fast one with batched
    FRI, STIR and WHIR, all resident), then the sharded coset LDE, constrain
    tree and index tree against one device, timed."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from ministark_tpu_torch.commit.index_tree import IndexMerkleTree
    from ministark_tpu_torch.commit.packed_tree import PackedMerkleTree
    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
    from ministark_tpu_torch.ops.field import get_ops, pack_words
    from ministark_tpu_torch.ops.ntt import get_ntt_fns
    from ministark_tpu_torch.parallel import get_sharded_ntt_fns
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark.engine import DeviceEngine
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
    from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_digests

    sf, dev = _stark_field("gl"), mesh.device
    out = {"rank": mesh.rank}
    trace = fibonacci_device_trace(sf, MAIN_STEPS, on_device=True, device=dev)
    cfg = StarkConfig(sf, 20, 2, MAIN_STEPS, trace.constrain_number())
    engine = DeviceEngine(cfg, device=dev, mesh=mesh)
    proof, *rest = _sharded_prove(lambda: engine.prove(trace),
                                  lambda p: proof_digests(sf, p), dev)
    out["parity"] = rest + [engine.verify(engine.constrain_coeffs(trace), proof),
                            dict(engine.phase_seconds)]
    del proof, engine

    stark = FastStark(FastStarkConfig(sf, MAIN_STEPS, **FAST_CFG), device=dev, mesh=mesh)
    proof, *rest = _sharded_prove(
        lambda: stark.prove(trace),
        lambda p: hashlib.sha256(fast_proof_to_bytes(sf, p)).hexdigest(), dev)
    out["fast"] = rest + [stark.verify(stark._constraint_polys(trace), proof),
                          dict(stark.phase_seconds)]
    del proof
    for lde in ("stir", "whir"):
        ldt = FastStark(FastStarkConfig(sf, MAIN_STEPS, **dict(FAST_CFG, lde_backend=lde)),
                        device=dev, mesh=mesh)
        proof, *rest = _sharded_prove(
            lambda: ldt.prove(trace),
            lambda p: hashlib.sha256(fast_proof_to_bytes(sf, p)).hexdigest(), dev)
        out[lde] = rest + [ldt.verify(ldt._constraint_polys(trace), proof),
                           dict(ldt.phase_seconds)]
        del proof, ldt
    # prove_many of FAST_BATCH traces, resident, against phase fast's bytes
    traces = [trace] + [fibonacci_device_trace(sf, MAIN_STEPS, on_device=True, device=dev)
                        for _ in range(FAST_BATCH - 1)]
    _sync(dev)
    t0 = time.time()
    blob = fast_proof_to_bytes(sf, stark.prove_many(traces))
    _sync(dev)
    out["fast_many"] = (hashlib.sha256(blob).hexdigest(), time.time() - t0)
    del stark, trace, traces

    rng = np.random.default_rng(SEED)
    base = sf.base

    def rand(shape):
        return pack_words(rng.integers(0, base.p, size=shape, dtype=np.uint64),
                          get_ops(base).dtype, dev)

    x, shift, n = rand(SHARDED_LDE), base.generator, SHARDED_LDE[1]
    dist.barrier()
    a, ms = _sharded_timed(lambda: get_sharded_ntt_fns(base, n, mesh)[2](x, shift), dev)
    b, ms1 = _sharded_timed(lambda: get_ntt_fns(base, n)[2](x, shift), dev)
    out["coset_fft"] = (bool(torch.equal(a, b)), ms, ms1)
    vals = rand((SHARDED_TREE,))
    mcfg = cfg.merkle_config
    dist.barrier()
    a, ms = _sharded_timed(lambda: PackedMerkleTree(base, vals, mcfg, mesh), dev)
    b, ms1 = _sharded_timed(lambda: PackedMerkleTree(base, vals, mcfg), dev)
    out["constrain_tree"] = (bool(torch.equal(a._digests, b._digests)), ms, ms1)
    rows = rand(SHARDED_ROWS)
    dist.barrier()
    dtype = get_ops(base).dtype
    a, ms = _sharded_timed(lambda: IndexMerkleTree(rows, FAST_CFG["arity"], mesh,
                                                   dtype=dtype), dev)
    b, ms1 = _sharded_timed(lambda: IndexMerkleTree(rows, FAST_CFG["arity"], dtype=dtype),
                            dev)
    out["index_tree"] = (bool(torch.equal(a._digests, b._digests)), ms, ms1)

    # the sharded prove core (path sharded_core) against the single core
    # with shift 1 (its LDE is over H), the counts around the sharded call;
    # each rank's blocks, joined across the ranks
    from ministark_tpu_torch.parallel.mesh import all_gather_rows
    from ministark_tpu_torch.stark.core import make_prove_core, make_sharded_prove_core

    single, example = make_prove_core(sf, SHARDED_CORE_N, device=dev)
    core = make_sharded_prove_core(sf, SHARDED_CORE_N, mesh)
    cols, _, weights = example()
    want = single(cols, 1, weights)
    dist.barrier()
    _sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    got = core(cols, weights)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches, _ = read_counts()
    joined = [torch.cat(list(all_gather_rows(mesh, block)), axis)
              for block, axis in zip(got, (1, 0, 0))]
    out["core"] = (all(torch.equal(a, b) for a, b in zip(joined, want)), secs, launches)
    return out


def _sharded_pins(mesh):
    """One rank of phase sharded's four-rank group: the proves pinned at
    2^14 - 1 (parity, fast x 1 and x 4, STIR, WHIR, BabyBear parity and
    fast, MiMC parity), sharded; their digests."""
    import hashlib

    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
    from ministark_tpu_torch.models.mimc import mimc_device_trace
    from ministark_tpu_torch.stark import StarkConfig
    from ministark_tpu_torch.stark.engine import DeviceEngine
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
    from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_digests

    steps, dev, out = SHARDED_PIN_STEPS, mesh.device, {}
    for field, model in (("gl", "fib"), ("bb", "fib"), ("gl", "mimc")):
        sf = _stark_field(field)
        trace = (mimc_device_trace(sf, steps, device=dev) if model == "mimc" else
                 fibonacci_device_trace(sf, steps, on_device=True, device=dev))
        cfg = StarkConfig(sf, 20, 2, steps, trace.constrain_number())
        out[("parity", field, model)] = proof_digests(
            sf, DeviceEngine(cfg, device=dev, mesh=mesh).prove(trace))
    for field, lde, batch in (("gl", "fri", 1), ("gl", "fri", 4), ("gl", "stir", 1),
                              ("gl", "whir", 1), ("bb", "fri", 1)):
        sf = _stark_field(field)
        traces = [fibonacci_device_trace(sf, steps, on_device=True, device=dev)
                  for _ in range(batch)]
        stark = FastStark(FastStarkConfig(sf, steps, **dict(FAST_CFG, lde_backend=lde)),
                          device=dev, mesh=mesh)
        out[("fast", field, lde, batch)] = hashlib.sha256(
            fast_proof_to_bytes(sf, stark.prove_many(traces))).hexdigest()
    return out


def phase_sharded(results, parity_digests, fast_sha, fast_many_sha, ldt_sha):
    """The sharded paths (ministark_tpu_torch/parallel/) with ranks that
    share the one card: a two-rank group at full width against phases main,
    fast and stir_whir (the parity, fast, STIR and WHIR proves resident,
    each rank's peak memory against a one-rank group's one-device prove,
    prove_many of FAST_BATCH) and the sharded pieces against one device,
    then a four-rank group at the pinned 2^14 - 1 sizes."""
    import torch

    from ministark_tpu_torch.parallel import launch

    label = "sharded"
    one = launch.run(_sharded_one, 1, "gloo", "cuda:0", SHARDED_TIMEOUT_S)[0]
    proves = (("parity", "sharded_parity", "main", parity_digests),
              ("fast", "sharded_fast", "fast", fast_sha),
              ("stir", "sharded_stir", "stir_whir", ldt_sha["stir"]),
              ("whir", "sharded_whir", "stir_whir", ldt_sha["whir"]))
    for path, _, phase, want in proves:
        cold_digest, warm_digest, peak, warm = one[path]
        if cold_digest != want or warm_digest != want:
            fail(f"sharded: the one-rank group's {path} proof at {MAIN_STEPS} steps "
                 f"differs from phase {phase}'s")
        say(label, f"one device in a process of its own: {path} steps {MAIN_STEPS} "
                   f"equal to phase {phase}'s proof; warm {warm:.3f} s, warm "
                   f"prove's peak allocated {peak} B")
    t0 = time.time()
    ranks = launch.run(_sharded_full, 2, "gloo", "cuda:0", SHARDED_TIMEOUT_S)
    say(label, f"2 ranks on {torch.cuda.get_device_name(0)} (one card shared, "
               "so every time here is a time of the code path, not a scaling), "
               "backend gloo, collectives on the card's tensors unstaged; group "
               f"ran in {time.time() - t0:.1f} s")
    for path, what, phase, want in proves:
        for r in ranks:
            (cold_digest, cold, warm, launches, collectives, warm_digest, peak,
             received, ok, phases) = r[path]
            if cold_digest != want or warm_digest != want:
                fail(f"sharded: rank {r['rank']}'s {path} proof at {MAIN_STEPS} "
                     f"steps differs from phase {phase}'s")
            if not ok:
                fail(f"sharded: rank {r['rank']}'s {path} proof did not verify")
            say(label, f"{path} steps {MAIN_STEPS}, rank {r['rank']} of 2: cold "
                       f"{cold:.3f} s, warm {warm:.3f} s, equal to phase {phase}'s "
                       f"proof, verified; {collectives} collectives; phase_seconds "
                       + json.dumps({k: round(v, 4) for k, v in phases.items()}))
            one_peak = one[path][2]
            share = peak / one_peak
            say(label, f"{path} rank {r['rank']} of 2: warm prove's peak allocated "
                       f"{peak} B, {share:.4f} of one device's ({one_peak} B); bytes "
                       "received by kind in the cold prove " + json.dumps(received))
            if share > SHARDED_PEAK_SHARE:
                fail(f"sharded: rank {r['rank']}'s resident {path} prove peaks at "
                     f"{share:.3f} of one device's memory, over "
                     f"{SHARDED_PEAK_SHARE}")
            if path != "parity" and received["all_gather"] > SHARDED_FAST_GATHER_BYTES:
                fail(f"sharded: rank {r['rank']}'s resident {path} prove received "
                     f"{received['all_gather']} B of all_gather outside the openings, "
                     f"over {SHARDED_FAST_GATHER_BYTES}")
            say(label, f"{what} rank {r['rank']} launches "
                       + json.dumps({k: v for k, v in launches.items() if v}))
            one_launch_a_call(launches, f"rank {r['rank']} of the {what} path")
            for name, (_, _, paths) in KERNELS.items():
                if what in paths and launches.get(name, 0) <= 0:
                    fail(f"{name} was not launched by rank {r['rank']} of the "
                         f"{what} path")
        record(results, what, ranks[0][path][3])     # per rank: rank 0's
    for r in ranks:
        digest, secs = r["fast_many"]
        if digest != fast_many_sha:
            fail(f"sharded: rank {r['rank']}'s resident prove_many of {FAST_BATCH} "
                 f"traces at {MAIN_STEPS} steps differs from phase fast's")
        say(label, f"fast prove_many steps {MAIN_STEPS} x {FAST_BATCH}, rank "
                   f"{r['rank']} of 2: resident, equal to phase fast's proof; "
                   f"{secs:.3f} s")
    for what, shape in (("coset_fft", str(SHARDED_LDE)),
                        ("constrain_tree", f"{SHARDED_TREE} elements, 6 per group"),
                        ("index_tree", f"{SHARDED_ROWS}, arity {FAST_CFG['arity']}")):
        for r in ranks:
            equal, ms, ms1 = r[what]
            if not equal:
                fail(f"sharded: rank {r['rank']}'s {what} {shape} differs from "
                     "one device's")
            say(label, f"{what} {shape}, rank {r['rank']} of 2: equal to one "
                       f"device; sharded {ms:.3f} ms, one device {ms1:.3f} ms")
    for r in ranks:
        equal, secs, launches = r["core"]
        if not equal:
            fail(f"sharded: rank {r['rank']}'s sharded prove core at n "
                 f"{SHARDED_CORE_N} differs from the single core with shift 1")
        say(label, f"make_sharded_prove_core n {SHARDED_CORE_N}, rank {r['rank']} "
                   f"of 2: its blocks, joined, equal to the single core with shift "
                   f"1; {secs:.3f} s "
                   "(first call); launches "
                   + json.dumps({k: v for k, v in launches.items() if v}))
        for name, (_, _, paths) in KERNELS.items():
            if "sharded_core" in paths and launches.get(name, 0) <= 0:
                fail(f"{name} was not launched by rank {r['rank']} of the "
                     "sharded_core path")
    record(results, "sharded_core", ranks[0]["core"][2])

    t0 = time.time()
    ranks = launch.run(_sharded_pins, 4, "gloo", "cuda:0", SHARDED_TIMEOUT_S)
    steps = SHARDED_PIN_STEPS
    pins = {("parity", "gl", "fib"): PINS[steps], ("parity", "bb", "fib"): BB_PINS[steps],
            ("parity", "gl", "mimc"): MODEL_PINS["mimc"],
            ("fast", "gl", "fri", 1): FAST_PINS[(steps, 1)],
            ("fast", "gl", "fri", 4): FAST_PINS[(steps, 4)],
            ("fast", "gl", "stir", 1): STIR_PINS[steps],
            ("fast", "gl", "whir", 1): WHIR_PINS[steps],
            ("fast", "bb", "fri", 1): BB_FAST_PINS[(steps, 1)]}
    for key, want in pins.items():
        for rank, r in enumerate(ranks):
            if r[key] != want:
                fail(f"sharded: rank {rank} of 4, {key} at {steps} steps differs "
                     f"from the JAX pin: {r[key]}")
    say(label, f"4 ranks on one card: steps {steps} parity (GL, "
               "BabyBear, MiMC) and fast (GL x 1 and x 4, STIR, WHIR, BabyBear) "
               "proofs equal to the JAX pins on every rank; group ran in "
               f"{time.time() - t0:.1f} s")


def _model_case(name, field, steps):
    """(host claim, witness, device trace) of a model at ``steps``, through
    bench_torch.py's selection (BENCH_MODEL's)."""
    import bench_torch

    sf = _stark_field(field)
    claim, witness = bench_torch._host_claim(sf.base, steps, name)
    return claim, witness, bench_torch._device_trace(sf, steps, name, "cuda")


def phase_models(results):
    """The counter, LFSR and MiMC AIRs on the card: small proofs against
    the host oracle over both fields, the 2^14 - 1 pins of the JAX package,
    then MiMC at 2^20 - 1 cold and warm."""
    import hashlib

    import torch

    from ministark_tpu_torch.stark import Stark, StarkConfig
    from ministark_tpu_torch.stark import engine as eng
    from ministark_tpu_torch.stark.engine import DeviceEngine
    from ministark_tpu_torch.stark.fast import FastStark, FastStarkConfig
    from ministark_tpu_torch.stark.proof_io import fast_proof_to_bytes, proof_digests

    default = eng.DEVICE_MIN_SIZE
    try:
        eng.DEVICE_MIN_SIZE = 1            # the tensor path at every size
        for field in ("gl", "bb"):
            sf = _stark_field(field)
            for name, steps in (("counter", 13), ("lfsr", 11), ("mimc", 12)):
                claim, witness, trace = _model_case(name, field, steps)
                cfg = StarkConfig(sf, 20, 2, steps, trace.constrain_number())
                host = Stark(cfg).prove(claim, witness)
                engine = DeviceEngine(cfg, device="cuda")
                proof = engine.prove(trace)
                _assert_equal_proofs(host, proof)
                assert engine.verify(engine.constrain_coeffs(trace), proof)
                say("models", f"{name} {sf.name} steps {steps}: byte-identical to "
                              "Stark.prove, verified")
    except AssertionError as e:
        fail(f"models: {e}")
    finally:
        eng.DEVICE_MIN_SIZE = default

    sf = _stark_field("gl")
    for name, want in MODEL_PINS.items():
        _, _, trace = _model_case(name, "gl", MODEL_PIN_STEPS)
        engine = DeviceEngine(StarkConfig(sf, 20, 2, MODEL_PIN_STEPS,
                                          trace.constrain_number()), device="cuda")
        t0 = time.time()
        proof = engine.prove(trace)
        secs = time.time() - t0
        got = proof_digests(sf, proof)
        if got != want:
            fail(f"models: {name} steps {MODEL_PIN_STEPS}: digests differ from "
                 f"the JAX pins: {got}")
        if not engine.verify(engine.constrain_coeffs(trace), proof):
            fail(f"models: {name} steps {MODEL_PIN_STEPS}: verify returned False")
        say("models", f"{name} steps {MODEL_PIN_STEPS}: equal to the JAX package's "
                      f"pinned digests, verified; prove {secs:.2f} s")
    for name, pin in MODEL_FAST_PINS.items():
        _, _, trace = _model_case(name, "gl", MODEL_PIN_STEPS)
        stark = FastStark(FastStarkConfig(sf, MODEL_PIN_STEPS, **FAST_CFG),
                          device="cuda")
        proof = stark.prove(trace)
        got = hashlib.sha256(fast_proof_to_bytes(sf, proof)).hexdigest()
        if got != pin:
            fail(f"models: fast {name} steps {MODEL_PIN_STEPS}: sha256 {got} "
                 "differs from the JAX pin")
        if not stark.verify(stark._constraint_polys(trace), proof):
            fail(f"models: fast {name}: verify returned False")
        say("models", f"fast {name} steps {MODEL_PIN_STEPS}: equal to the JAX "
                      "package's pinned proof bytes, verified")

    t0 = time.time()
    _, _, trace = _model_case("mimc", "gl", MAIN_STEPS)
    torch.cuda.synchronize()
    say("models", f"mimc steps {MAIN_STEPS}: witness (2, {trace.domain_size}) from "
                  f"the host chain in {time.time() - t0:.3f} s")
    engine = DeviceEngine(StarkConfig(sf, 20, 2, MAIN_STEPS, trace.constrain_number()),
                          device="cuda", query_split=True)
    reset_counts()
    t0 = time.time()
    proof = engine.prove(trace)
    cold = time.time() - t0
    launches, _ = read_counts()
    say("models", f"mimc cold prove {cold:.3f} s; phase_seconds "
                  + json.dumps(_merge_query_phases(engine.phase_seconds)))
    t0 = time.time()
    proof2 = engine.prove(trace)
    warm = time.time() - t0
    say("models", f"mimc warm prove {warm:.3f} s; phase_seconds "
                  + json.dumps(_merge_query_phases(engine.phase_seconds)))
    if proof_digests(sf, proof) != proof_digests(sf, proof2):
        fail("models: mimc cold and warm proofs differ")
    t0 = time.time()
    ok = engine.verify(engine.constrain_coeffs(trace), proof)
    torch.cuda.synchronize()
    if not ok:
        fail("models: mimc verify returned False")
    say("models", f"mimc verify True in {time.time() - t0:.3f} s; digests "
                  + json.dumps(proof_digests(sf, proof)))
    record(results, "mimc", launches)


CORE_N = 1 << 20                   # the bench's trace domain (2^20 - 1 steps)
CORE_AB_PAIRS = 4                  # warm proves with either tail, in turns
TAIL_LOG_SIZES = range(8, 13)      # the host tail's FRI codewords, Fp2 leaves
INV_N = 1 << 20                    # batch_inverse_full's elements


def _core_digest(out):
    """sha256 of the core's outputs, each as little-endian u64 (CORE_PINS)."""
    import numpy as np

    from ministark_tpu_torch.ops.field import unpack_u64

    h = hashlib.sha256()
    for t in out:
        h.update(np.ascontiguousarray(unpack_u64(t)).tobytes())
    return h.hexdigest()


def _core_plain(cols, shift, weights):
    """The Goldilocks Fibonacci core with every kernel's plain version:
    ntt.transform_plain for the iFFT and the coset LDE, the transitions,
    mix and fold with the plain field ops (torch ops, no kernel)."""
    import dataclasses

    import torch

    from ministark_tpu_torch.fields import GOLDILOCKS_FP
    from ministark_tpu_torch.models.fibonacci_device import _fib_transitions
    from ministark_tpu_torch.ops import field as gl
    from ministark_tpu_torch.ops import ntt
    from ministark_tpu_torch.ops.field import get_ops
    from ministark_tpu_torch.ops.poly import fold_even_odd, mix_columns
    from ministark_tpu_torch.poly import Radix2EvaluationDomain

    F = GOLDILOCKS_FP
    kp = dataclasses.replace(get_ops(F), add=gl.add_plain, sub=gl.sub_plain,
                             neg=gl.neg_plain, mul=gl.mul_plain,
                             scale_base=gl.mul_plain)
    n = cols.shape[1]
    tp = ntt.transform_plain(cols, inverse=True, field=F)
    trans = _fib_transitions(kp, Radix2EvaluationDomain(F, n).group_gen)
    allc = torch.cat([tp] + [f(tp)[None] for f in trans], 0)
    lde = ntt.transform_plain(torch.cat([allc, torch.zeros_like(allc)], 1),
                              pre=int(shift), field=F)
    mixed = mix_columns(kp, allc, weights)
    return lde, mixed, fold_even_odd(kp, mixed, weights[1])


def phase_core(results, smi):
    """The driver entry and the prove core on the card (entry.py,
    stark/core.py), the two-rank dry run, the native Merkle engine and
    batch_inverse_full."""
    import functools

    import numpy as np
    import torch

    from ministark_tpu_torch.commit import native
    from ministark_tpu_torch.commit.merkle import MerkleTree, MerkleTreeConfig
    from ministark_tpu_torch.entry import dryrun_multichip, entry
    from ministark_tpu_torch.fields import GOLDILOCKS_FP, GOLDILOCKS_FP2
    from ministark_tpu_torch.models.fibonacci_device import fibonacci_device_trace
    from ministark_tpu_torch.models.mimc import mimc_device_trace
    from ministark_tpu_torch.ops.field import get_ops
    from ministark_tpu_torch.ops.poly import batch_inverse_full
    from ministark_tpu_torch.stark.core import make_prove_core

    label = "core"
    t_phase = time.time()
    core, args = entry()
    out = core(*args)
    cpu_core, cpu_args = entry(device="cpu")
    want = cpu_core(*cpu_args)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(out, want)):
        fail("core: entry()'s core on the card differs from the CPU's")
    say(label, "entry(): the Goldilocks core at n 256 on the card, outputs "
               f"{[tuple(o.shape) for o in out]}, equal to the CPU's (plain versions)")

    builders = {"fibonacci": None, "mimc": mimc_device_trace}
    for (field, model), pin in CORE_PINS.items():
        sf = _stark_field(field)
        c, a = make_prove_core(sf, CORE_PIN_N, builders[model], device="cuda")
        got = _core_digest(c(*a()))
        if got != pin:
            fail(f"core: {model} over {sf.name} at n {CORE_PIN_N}: sha256 {got} "
                 "differs from the JAX pin")
        say(label, f"{model} over {sf.name} at n {CORE_PIN_N}: equal to the JAX "
                   "package's make_prove_core (pinned sha256)")

    # full width: the bench's domain, the witness built on the card
    sf = _stark_field("gl")
    t0 = time.time()
    c, a = make_prove_core(sf, CORE_N, functools.partial(
        fibonacci_device_trace, on_device=True), device="cuda")
    cols, shift, weights = a()
    torch.cuda.synchronize()
    say(label, f"make_prove_core Fibonacci over Goldilocks at n {CORE_N}: trace "
               f"{tuple(cols.shape)} on the card in {time.time() - t0:.3f} s")
    reset_counts()
    t0 = time.perf_counter()
    out = c(cols, shift, weights)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches, _ = read_counts()
    record(results, "core", launches)
    plain = _core_plain(cols, 7, weights)
    for name, got, want in zip(("lde", "mixed", "folded"), out, plain):
        err = max_abs_err(got, want)
        if err != 0:
            fail(f"core: the {name} output at n {CORE_N} differs from its plain "
                 f"version (max_abs_err {err})")
    # timed with an int shift: the packed one's pull to the host waits for
    # the card in every call
    if _core_digest(out) != _core_digest(c(cols, 7, weights)):
        fail("core: the core with the int shift 7 differs from the packed one")
    call = functools.partial(c, cols, 7, weights)
    reset_counts()
    call()
    torch.cuda.synchronize()
    warm_launches, _ = read_counts()
    host = rf.time_ms(call, 5, "cuda")
    dev_ms, kernels = rf.profiler_ms(call, 5)
    say(label, f"n {CORE_N} (ifft (3, 2^20), coset LDE (6, 2^21)): lde, mixed, "
               "folded equal to the plain versions on the card (tolerance 0); "
               f"first call {first * 1e3:.1f} ms, warm {host:.3f} ms a call "
               f"(host clock, CUDA events), device {dev_ms:.3f} ms "
               f"(torch.profiler kernel time, {kernels:.0f} kernels a call); "
               "launches, first call (its tables built) "
               + json.dumps({k: v for k, v in launches.items() if v}) + ", warm call "
               + json.dumps({k: v for k, v in warm_launches.items() if v}) + f"; {smi}")
    del out, plain, cols, c

    t0 = time.time()
    collectives = dryrun_multichip(2, device="cuda:0", backend="gloo")
    say(label, f"{time.time() - t_phase:.1f} s into the phase")
    say(label, f"dryrun_multichip(2) on cuda:0 (gloo, ranks sharing the card): "
               f"every rank byte-equal to one device in {time.time() - t0:.1f} s; "
               f"collectives {json.dumps(collectives)}")

    # the native engine at the host tail's sizes against hashlib
    ext = GOLDILOCKS_FP2
    cfg = MerkleTreeConfig(leafs_per_node=2, inner_children=2)
    rng = np.random.default_rng(SEED + 14)
    for log_n in TAIL_LOG_SIZES:
        v = rng.integers(0, ext.p, size=(1 << log_n, 2), dtype=np.uint64)
        vals = [ext.from_base_coeffs((int(a0), int(a1))) for a0, a1 in v]
        ta, tb = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            a_tree = native.merkle_tree(ext, vals, cfg)
            ta.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            b_tree = MerkleTree(ext, vals, cfg)
            tb.append(time.perf_counter() - t0)
        if a_tree.nodes != b_tree.nodes:
            fail(f"core: the native tree over 2^{log_n} Fp2 leaves differs from hashlib's")
        say(label, f"native tree 2^{log_n} Fp2 leaves (fmt 1): equal to hashlib's; "
                   f"median of 3 native {sorted(ta)[1] * 1e3:.3f} ms, hashlib "
                   f"{sorted(tb)[1] * 1e3:.3f} ms (host)")
    ab = _load_script("torch_ab_prove").run(MAIN_STEPS, CORE_AB_PAIRS, tail=True)
    say(label, f"warm GL parity proves at {MAIN_STEPS} steps, hashlib tail against "
               "native tail in turns: " + json.dumps(ab))

    # batch_inverse_full at 2^20 Goldilocks elements on the card
    F = GOLDILOCKS_FP
    k = get_ops(F)
    x = _rand_u64(rng, (INV_N,), F.p)
    x[x == 0] = 1
    inv = batch_inverse_full(F, k, x)
    torch.cuda.synchronize()
    idx = rng.choice(INV_N, size=64, replace=False)
    xs, ys = k.unpack(x[idx]), k.unpack(inv[idx])
    if any(y != F.inv(v) for v, y in zip(xs, ys)):
        fail("core: batch_inverse_full differs from field.inv")
    ms = rf.time_ms(lambda: batch_inverse_full(F, k, x), 3, "cuda")
    say(label, f"batch_inverse_full at {INV_N} Goldilocks elements: 64 sampled "
               f"entries equal to field.inv; {ms:.3f} ms a call (CUDA events)")
    say(label, f"phase ran in {time.time() - t_phase:.1f} s")


def _merge_query_phases(phases):
    """phase_seconds rounded, the per-round query labels summed by kind."""
    from ministark_tpu_torch.stark.engine import merge_query_phases

    return {k: round(v, 4) for k, v in merge_query_phases(phases).items()}


def _load_script(name):
    """A script of scripts/ as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_probes(results):
    """The three probe scripts, in-process, at their own shapes."""
    reset_counts()
    out = _load_script("torch_stream_probe").run(reps=10)
    say("probes", f"stream: kernel best {out['best_gb_per_s']:.1f} GB/s, torch.add "
                  f"{out['torch_add']['gb_per_s']:.1f} GB/s over {out['gb_moved']:.3f} "
                  f"GB; the bound uses {rf.HBM_BYTES_PER_S / 1e9:.0f} GB/s")
    ok, bad, total = _load_script("torch_f32_pad_probe").run()
    if not ok:
        fail(f"probes: the padded F = 32 level has {bad}/{total} mismatches")
    say("probes", "f32 pad: PASS, the padded-column F = 32 level is bit-exact")
    stage = _load_script("torch_digit_stage_probe")
    for lvl in range(3):
        r = stage.run(1 << 20, lvl, inverse=True, reps=10)
        say("probes", f"digit stages ifft 2^20 level {lvl} (F {r['F']}): "
                      + json.dumps({k: round(v, 4) for k, v in r["ms"].items()})
                      + f", stage sum {r['stage_sum_ms']:.3f} ms")
    launches, _ = read_counts()
    record(results, "probes", launches)


BENCH_BASE_STEPS = (1 << 10) - 1          # the host oracle's size in this run


def phase_bench(results):
    """The kernel bench at full size, then bench_torch's headline functions
    in-process: one parity and one fast prove at 2^20 - 1, verified, and the
    host oracle at BENCH_BASE_STEPS."""
    import bench_kernels_torch
    import bench_torch

    reset_counts()
    entries = bench_kernels_torch.kernel_rooflines("cuda")
    launches, _ = read_counts()
    record(results, "bench_kernels", launches)
    got = {r["metric"]: r for r in entries}
    for metric in bench_kernels_torch.METRICS:
        if metric not in got:
            fail(f"bench: kernel_rooflines() has no entry {metric}")
        r = got[metric]
        if not 0 < r["bound_frac"] <= 1.0:
            fail(f"bench: {metric} bound_frac {r['bound_frac']} is outside (0, 1]")
        say("bench", f"{metric}: {r['value']:.4g} {r['unit']} ({r['ms']:.3f} ms, bound "
                     f"{r['bound_ms']:.3f} ms by {r['bound_by']}, bound_frac "
                     f"{r['bound_frac']:.3f})"
                     + "".join(f", {k} {r[k]:.4f}" for k in SPLIT_KEYS
                               if r.get(k) is not None))

    reset_counts()
    t_prove, t_verify, extras = bench_torch.device_prove(MAIN_STEPS)
    say("bench", f"device_prove steps {MAIN_STEPS}: {MAIN_STEPS / t_prove:.0f} rows/s "
                 f"({t_prove:.3f} s), verify {t_verify:.3f} s, " + json.dumps(extras))
    t_fast, v_fast, e_fast = bench_torch.fast_prove(MAIN_STEPS)
    say("bench", f"fast_prove steps {MAIN_STEPS}: {MAIN_STEPS / t_fast:.0f} rows/s "
                 f"({t_fast:.3f} s), verify {v_fast:.3f} s, " + json.dumps(e_fast))
    ldt_reports = []
    for key, lde in (("stir_e2e_prove", "stir"), ("whir_e2e_prove", "whir")):
        t_ldt, v_ldt, e_ldt = bench_torch.fast_prove(MAIN_STEPS, lde_backend=lde)
        say("bench", f"{key} (fast_prove, lde_backend={lde!r}) steps {MAIN_STEPS}: "
                     f"{MAIN_STEPS / t_ldt:.0f} rows/s ({t_ldt:.3f} s), verify "
                     f"{v_ldt:.3f} s, " + json.dumps(e_ldt))
        ldt_reports.append((key, e_ldt))
    launches, _ = read_counts()
    record(results, "bench_prove", launches)
    t_host = bench_torch.host_prove(BENCH_BASE_STEPS)
    say("bench", f"host_prove steps {BENCH_BASE_STEPS}: {t_host:.3f} s (pure Python)")
    for key in ("device_s", "phases"):
        if key not in extras or key not in e_fast:
            fail(f"bench: the prove's report lacks {key}")
    for key, report in [("fast_prove", e_fast)] + ldt_reports:
        if "proof_bytes" not in report:
            fail(f"bench: {key}'s report lacks proof_bytes")


_BACKEND_PATHS = tuple(f"{p}_{b}" for p in ("parity", "fast") for b in NTT_BACKENDS)
_BB_PATHS = ("parity_bb", "fast_bb")
# the fast prover's 2^20 - 1 proves on each NTT backend, both fields
_FAST_BACKEND_PATHS = tuple(f"fast_{b}" for b in NTT_BACKENDS)
_FAST_BB_BACKEND_PATHS = tuple(f"fast_bb_{b}" for b in NTT_BACKENDS)
# the fast prover's 2^20 - 1 proves with the STIR and WHIR low-degree tests
_LDT_PATHS = ("stir", "whir")
_LDT_BB_PATHS = ("stir_bb", "whir_bb")
# the bench path's runs: the MiMC 2^20 - 1 prove, the kernel bench, the bench's
# parity and fast proves (the probes launch only the probe kernels)
_BENCH_PATHS = ("mimc", "bench_kernels", "bench_prove")
# the 2^20 - 1 proves of phase sharded, per rank (of two)
_SHARDED_PATHS = ("sharded_parity", "sharded_fast", "sharded_stir", "sharded_whir")
# the prove core on one device at 2^20 (phase core) and sharded over two
# ranks (phase sharded, per rank)
_CORE_PATHS = ("core", "sharded_core")
# the Goldilocks and BabyBear parity proves at 2^20 - 1, every backend (the
# MiMC prove and the bench's parity prove among them)
_PARITY_PATHS = ("parity", "mimc", "bench_prove") + tuple(
    f"parity_{b}" for b in NTT_BACKENDS)
_PARITY_BB_PATHS = ("parity_bb",) + tuple(f"parity_bb_{b}" for b in NTT_BACKENDS)
# every Goldilocks and every BabyBear 2^20 - 1 prove (the sharded and core
# ones Goldilocks)
_GL_PATHS = (("parity", "fast") + _BACKEND_PATHS + _LDT_PATHS + ("mimc", "bench_prove")
             + _SHARDED_PATHS + _CORE_PATHS)
_ALL_BB_PATHS = (_BB_PATHS + _LDT_BB_PATHS
                 + tuple(f"{p}_bb_{b}" for p in ("parity", "fast") for b in NTT_BACKENDS))
# name -> (source, the TPU kernel it replaces, the paths whose 2^20 - 1 prove
# must launch it). The BabyBear entries are the same sources' bb
# instantiations (the NTTs) and 10-digit path (the leaf hash).
KERNELS = {
    "ntt": ("ministark_tpu_torch/csrc/ntt.cu",
            "ministark_tpu/ops/ntt_mxu.py:370",
            ("parity", "fast") + _LDT_PATHS + _BENCH_PATHS + _SHARDED_PATHS
            + _CORE_PATHS),
    "sha256_inner_level": ("ministark_tpu_torch/csrc/sha256.cu",
                           "ministark_tpu/ops/sha256_pallas.py:113",
                           ("parity", "fast") + _BB_PATHS + _LDT_PATHS
                           + _LDT_BB_PATHS + _BENCH_PATHS + _SHARDED_PATHS),
    "leaf_hash": ("ministark_tpu_torch/csrc/leaf_hash.cu",
                  "ministark_tpu/ops/sha256_pallas.py:163",
                  ("parity", "mimc", "bench_prove", "sharded_parity")),
    "sha256_rows": ("ministark_tpu_torch/csrc/sha256.cu",
                    "ministark_tpu/ops/sha256_pallas.py:113",
                    ("fast", "fast_bb", "bench_kernels", "bench_prove", "sharded_fast",
                     "sharded_stir", "sharded_whir") + _LDT_PATHS + _LDT_BB_PATHS),
    "gl_mul": ("ministark_tpu_torch/csrc/gl_mul.cu",
               "ministark_tpu/ops/pallas_kernels.py:36",
               ("parity", "fast") + _BACKEND_PATHS + _LDT_PATHS + _BENCH_PATHS
               + _SHARDED_PATHS + _CORE_PATHS),
    "gl_ext_mul": ("ministark_tpu_torch/csrc/gl_mul.cu", "ministark_tpu/ops/gl.py:215",
                   ("parity", "fast") + _BACKEND_PATHS + _LDT_PATHS + _BENCH_PATHS
                   + _SHARDED_PATHS),
    "ntt_four_step_pass1": ("ministark_tpu_torch/csrc/ntt_four_step.cu",
                            "ministark_tpu/ops/ntt_pallas.py:190",
                            ("parity_four_step", "fast_four_step", "bench_kernels")),
    "ntt_four_step_pass2": ("ministark_tpu_torch/csrc/ntt_four_step.cu",
                            "ministark_tpu/ops/ntt_pallas.py:204",
                            ("parity_four_step", "fast_four_step", "bench_kernels")),
    "ntt_pipe_level": ("ministark_tpu_torch/csrc/ntt_pipe.cu",
                       "ministark_tpu/ops/ntt_mxu.py:486",
                       ("parity_pipe", "fast_pipe", "bench_kernels", "probes")),
    "ntt_bb": ("ministark_tpu_torch/csrc/ntt.cu",
               "ministark_tpu/ops/ntt_mxu.py:370", _BB_PATHS + _LDT_BB_PATHS),
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
    "stream_add1": ("ministark_tpu_torch/csrc/stream.cu",
                    "scripts/pallas_stream_probe.py:35", ("probes", "bench_kernels")),
    "digitize_gl": ("ministark_tpu_torch/csrc/ntt_digit.cu",
                    "scripts/tpu_fused_stage_probe.py:102", ("probes",)),
    "digit_dot_s8": ("ministark_tpu_torch/csrc/ntt_digit.cu",
                     "scripts/tpu_fused_stage_probe.py:124",
                     ("probes", "bench_kernels")),
    "recombine_gl": ("ministark_tpu_torch/csrc/ntt_digit.cu",
                     "scripts/tpu_fused_stage_probe.py:165", ("probes",)),
    "digit_level_gl": ("ministark_tpu_torch/csrc/ntt_digit.cu",
                       "scripts/tpu_f32_pad_probe.py:54", ("probes", "bench_kernels")),
    # array code the JAX package left to XLA (ROADMAP X3, X1, X8): the FRI
    # round's eval_even_odd, the block totals and the point evaluations
    # (eval_many, STIR's eval_points, WHIR's sumcheck_evals) on pow_dot, the
    # fold-divide, the query quotients and STIR's quotients (div_scan)
    "pow_dot_gl2": ("ministark_tpu_torch/csrc/div_scan.cu",
                    "ministark_tpu/ops/poly_device.py:279",
                    _PARITY_PATHS + ("fast",) + _FAST_BACKEND_PATHS + _LDT_PATHS
                    + _SHARDED_PATHS),
    "div_scan_gl2": ("ministark_tpu_torch/csrc/div_scan.cu",
                     "ministark_tpu/ops/planar.py:391",
                     _PARITY_PATHS + ("stir", "sharded_parity", "sharded_stir")),
    "pow_dot_bb4": ("ministark_tpu_torch/csrc/div_scan.cu",
                    "ministark_tpu/ops/poly_device.py:279",
                    _PARITY_BB_PATHS + ("fast_bb",) + _FAST_BB_BACKEND_PATHS + _LDT_BB_PATHS),
    "div_scan_bb4": ("ministark_tpu_torch/csrc/div_scan.cu",
                     "ministark_tpu/ops/planar.py:391", _PARITY_BB_PATHS + ("stir_bb",)),
    # the field ops XLA fused (ROADMAP X6, X7): Goldilocks add / sub / neg
    # and their Fp2 forms; BabyBear add / sub / neg / mul and the Fp4 forms;
    # the Fp4 product
    "gl_ew": ("ministark_tpu_torch/csrc/field_ew.cu", "ministark_tpu/ops/gl.py:82",
              _GL_PATHS),
    "bb_ew": ("ministark_tpu_torch/csrc/field_ew.cu", "ministark_tpu/ops/bb.py:40",
              _ALL_BB_PATHS),
    "bb_fp4_mul": ("ministark_tpu_torch/csrc/field_ew.cu",
                   "ministark_tpu/ops/bb.py:127", _ALL_BB_PATHS),
    # the first-occurrence leaf search of the parity prover's query rounds
    # (ROADMAP X4), on one device and a resident rank's block
    "first_match": ("ministark_tpu_torch/csrc/leaf_search.cu",
                    "ministark_tpu/commit/packed_tree.py:87",
                    _PARITY_PATHS + _PARITY_BB_PATHS + ("sharded_parity",)),
}


def main():
    t_start = time.time()
    smi = phase_gpu()
    import torch

    global rf
    from ministark_tpu_torch.utils import roofline as rf

    phase_build()
    results = {name: {"max_abs_err": 0, "shapes": [], "paths": {}}
               for name in KERNELS}
    phase_kernels(results)
    phase_kernels_bb(results)
    phase_kernels_field_ew(results)
    phase_kernels_digit(results)
    phase_kernels_div_scan(results)
    phase_kernels_first_match(results)
    phase_parity()
    parity_digests = phase_main(results)
    fast_blob, fast_many_blob = phase_fast(results)
    phase_main(results, "bb")
    phase_fast(results, "bb")
    ldt_sha = phase_stir_whir(results)
    phase_sharded(results, parity_digests, hashlib.sha256(fast_blob).hexdigest(),
                  hashlib.sha256(fast_many_blob).hexdigest(), ldt_sha)
    phase_models(results)
    phase_core(results, smi)
    phase_probes(results)
    phase_bench(results)

    for name, (_, _, paths) in KERNELS.items():
        for path in paths:
            if results[name]["paths"].get(path, 0) <= 0:
                fail(f"{name} was not launched by the {path} path")
    say("launches", json.dumps({k: r["paths"] for k, r in results.items()}))
    phase_processes()
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
                        # torch.add for the stream, torch._int_mm for the
                        # dot; torch has no Goldilocks or BabyBear NTT, no
                        # SHA-256, no modular u64 multiply and no digit stage
                        "library_ms": main_shape["library_ms"],
                        "shape": main_shape["shape"],
                        **{k: main_shape[k] for k in SPLIT_KEYS
                           + ("bound_frac", "launches_per_call", "paired_ms",
                              "paired_library_ms", "library_col_ms")
                           if k in main_shape}})
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
