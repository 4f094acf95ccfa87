"""Build the CUDA kernels in ``csrc/`` at first use and bind them with ctypes.

All kernels go into one shared library with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` (Hopper) into ``ministark_tpu_torch/_build/``: one
``nvcc -c`` per source, all started together, then one link. The library's
file name carries a hash of the sources and flags, so an edit rebuilds it;
a file lock makes concurrent first uses build it once. Nothing here is
imported or built until a CUDA tensor reaches a kernel wrapper.

Every entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launches;
``check`` raises on anything but 0. A BabyBear entry point reads and
writes 32-bit words (``int32`` tensors), a Goldilocks one 64-bit words;
``require`` refuses a tensor of the other dtype.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ntt.cu", "sha256.cu", "leaf_hash.cu", "gl_mul.cu",
           "ntt_four_step.cu", "ntt_pipe.cu", "ntt_digit.cu", "stream.cu",
           "div_scan.cu", "field_ew.cu", "leaf_search.cu")
HEADERS = ("gl.cuh", "bb.cuh", "ext_field.cuh", "elementwise.cuh", "ntt_common.cuh",
           "ntt_stages.cuh", "sha256.cuh", "wgmma_s8.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)   # a host int64 array
_NTT = [_P, _P, _I, _I, _I64P, _P, _P, _P, _P, _P, _P, _U64, _I64P, _P]
_PASS1 = [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
_PASS2 = [_P, _P, _I, _I, _I, _P, _P, _P, _U64, _P]
_LEVEL = [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _U64, _P]
_POW_DOT = [_P] * 5 + [_I64P, _P]
_DIV_SCAN = [_P] * 9 + [_I64P, _P]
# name -> argtypes; every function returns int (a cudaError_t). The NTT
# kernels have one symbol per field, suffixed _gl (Goldilocks) or _bb
# (BabyBear), with the same arguments.
_SIGNATURES = {
    # x, y, batch, log_n, plan (int64, ops/ntt.py::_plan_array), twiddles,
    # tile twiddles, pre lo / hi, post lo / hi (ops/ntt.py::coset_tables),
    # scale, launched (a host int64, plus one a pass launched), stream
    "ms_ntt_gl": _NTT, "ms_ntt_bb": _NTT,
    # children, parents, n_parents, fan, stream
    "ms_sha256_inner_level": [_P, _P, _I, _I, _P],
    # comps, digests, n_rows, C, stream; _bb: 32-bit components
    "ms_sha256_rows": [_P, _P, _I, _I, _P], "ms_sha256_rows_bb": [_P, _P, _I, _I, _P],
    # comps, digests, n_groups, leafs_per_node, fmt, stream: 64-bit
    # Goldilocks components, 20 digits; _bb: 32-bit BabyBear ones, 10
    "ms_leaf_hash": [_P, _P, _I, _I, _I, _P],
    "ms_leaf_hash_bb": [_P, _P, _I, _I, _I, _P],
    # a, b, out, plan (int64[ops/field.py::PLAN_LEN]), stream
    "ms_gl_mul": [_P, _P, _P, _I64P, _P],
    "ms_gl_ext_mul": [_P, _P, _P, _I64P, _P],
    # csrc/field_ew.cu: a, b, out, plan, op (ops/field.py::ADD, SUB, NEG,
    # MUL), stream; the Fp4 product a, b, out, plan, stream
    "ms_gl_ew": [_P, _P, _P, _I64P, _I, _P], "ms_bb_ew": [_P, _P, _P, _I64P, _I, _P],
    "ms_bb_fp4_mul": [_P, _P, _P, _I64P, _P],
    # x, c, batch, log_n1, log_n2, w2 stage roots, wpow, pre lo / hi
    # (ops/ntt.py::coset_tables), stream
    "ms_ntt_four_step_pass1_gl": _PASS1, "ms_ntt_four_step_pass1_bb": _PASS1,
    # c, y, batch, log_n1, log_n2, w1 stage roots, post lo / hi (1/n folded
    # into hi), scale, stream
    "ms_ntt_four_step_pass2_gl": _PASS2, "ms_ntt_four_step_pass2_bb": _PASS2,
    # x, y, batch, log_f, log_r, stage roots, pre lo / hi
    # (ops/ntt.py::coset_tables), W, W's split lo / hi (or null), log_kprod,
    # scale, stream
    "ms_ntt_pipe_level_gl": _LEVEL, "ms_ntt_pipe_level_bb": _LEVEL,
    # x, d, batch, F, R, stream
    "ms_digitize_gl": [_P, _P, _I, _I, _I, _P],
    # A, V, C, batch, K, R, N, stream
    "ms_digit_dot_s8": [_P, _P, _P, _I, _I, _I, _I, _P],
    # Rm, y, batch, R, F, PF, W, log_kprod, scale, kc, stream
    "ms_recombine_gl": [_P, _P, _I, _I, _I, _I, _P, _I, _U64, _U64, _P],
    # x, V (the kernel table, ops/ntt_digit.py::kernel_table), y, batch, F,
    # R, W, log_kprod, scale, kc, stream
    "ms_digit_level_gl": [_P, _P, _P, _I, _I, _I, _P, _I, _U64, _U64, _P],
    # x, out, n, threads, per_thread, stream
    "ms_stream_add1": [_P, _P, _I64, _I, _I, _P],
    # c, z, out, counts, values (ops/div_scan.py::_scratch_for), plan
    # (int64[ops/div_scan.py::PLAN_LEN]), stream; _gl2 Goldilocks Fp2, _bb4
    # BabyBear Fp4
    "ms_pow_dot_gl2": _POW_DOT, "ms_pow_dot_bb4": _POW_DOT,
    # c, z, zinv, alpha, head, carry (null where unused), out, counts,
    # values, plan, stream
    "ms_div_scan_gl2": _DIV_SCAN, "ms_div_scan_bb4": _DIV_SCAN,
    # comps, rows, out, scratch (commit/packed_tree.py::_match_scratch_for),
    # n, q, C, stream; _bb: 32-bit words
    "ms_first_match": [_P, _P, _P, _P, _I, _I, _I, _P],
    "ms_first_match_bb": [_P, _P, _P, _P, _I, _I, _I, _P],
}

_lib = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands at once; [(cmd, stdout and stderr, returncode)]."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    return [(cmd, p.communicate()[0], p.returncode) for cmd, p in zip(cmds, procs)]


@contextlib.contextmanager
def build_lock():
    """Hold ``_build/build.lock`` (an exclusive file lock): every build
    into ``_build/`` (these kernels, commit/native.py's library) runs
    under it, so concurrent first uses build once."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def build() -> str:
    """Compile the library if it is not built yet; returns its path. The
    compiler's output (ptxas register and spill counts) goes to
    ``_build/build.log``."""
    so = os.path.join(BUILD_DIR, f"libministark_kernels_{_source_hash()}.so")
    with build_lock():
        if not os.path.exists(so):
            nvcc = _nvcc()
            tmp = f"{so}.tmp{os.getpid()}"
            objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj]
                    for src, obj in zip(SOURCES, objs)]
            results = _run_all(cmds)
            if all(rc == 0 for _, _, rc in results):
                results += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
            with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
                f.write("".join(" ".join(cmd) + "\n" + out for cmd, out, _ in results))
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
            for cmd, out, rc in results:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                                       f"{out[-4000:]}")
            os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ms_error_string.argtypes = [ctypes.c_int]
        lib.ms_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, err: int) -> None:
    if err != 0:
        msg = library().ms_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and rank:
    the field's (int64 Goldilocks, int32 BabyBear), with no cast."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_aligned(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """``require``, and the storage starts on a 16-byte boundary (the
    kernels that move 4- and 16-byte vectors of narrower elements)."""
    require(t, name, dtype, ndim)
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte aligned storage")
