"""The native (C++) Merkle hashing engine, bound with ctypes.

Port of ``ministark_tpu/commit/native.py``. ``csrc/sha256_merkle.cpp`` is
the JAX package's source byte for byte (SHA-NI dispatched at run time,
decimal Display leaves). It is built with g++ at first use into the
gitignored ``ministark_tpu_torch/_build/``, under the lock every build
there takes (``ops/cuda.py::build_lock``), and exposes:

* ``leaf_hash_batch(vals_u64, leafs_per_node, fmt)`` -> (n_groups, 32) u8
* ``inner_levels(level0_digests, fan_in)`` -> every upper level's digests
* ``sha256_oneshot(data)`` -> 32 bytes
* ``merkle_tree(field, scalars, config)`` -> a ``MerkleTree`` whose digests
  come from here: the host-tail FRI round trees of ``stark/engine.py``
* ``available()`` -> whether the library builds and passes its self-test

Element formats (fields/host.py Display semantics, PARITY.md): fmt 0 base
decimal; fmt 1 QuadExtField(a + b * u); fmt 2 nested Fp4.

The source builds with ``-march=native``, so the library's file name
carries a hash of the source, the flags and the host CPU (model name and
flags of ``/proc/cpuinfo``): a library built on one machine is never
loaded on another. Nothing falls back to hashlib: a failed build raises
with g++'s output, a failed self-test raises, and ``available()`` only
reports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import List, Sequence

import numpy as np

from ..ops import cuda
from .merkle import MerkleTree, MerkleTreeConfig
from .packed_tree import field_fmt

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "csrc", "sha256_merkle.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()
_NTHREADS = min(8, os.cpu_count() or 1)
# hash on _NTHREADS threads from this many leaf groups (or parents a level
# up), on the calling thread below it: the host tail's trees (2^12 leaves
# and less) stay on one. Starting the threads costs more than the few
# thousand hashes they share: a tree of 2^11 Fp2 leaves read 5.6 ms on 8
# threads against hashlib's 4.4 (H100 host, chip_smoke.py phase core)
THREAD_MIN = 1 << 16
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _cpu_key() -> str:
    """The host CPU as ``-march=native`` sees it: the first model name and
    flags lines of /proc/cpuinfo (the machine and processor names where
    there is no /proc/cpuinfo)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    keep = {}
    for ln in lines:
        key = ln.split(":", 1)[0].strip()
        if key in ("model name", "flags", "Features", "CPU part") and key not in keep:
            keep[key] = ln
    return "\n".join(keep[k] for k in sorted(keep)) or platform.machine()


def library_path(src: str = SRC) -> str:
    """Where the library for this source, these flags and this CPU goes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _cpu_key().encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(cuda.BUILD_DIR, f"libsha256_merkle_{h.hexdigest()[:16]}.so")


def _build(src: str = SRC) -> str:
    """Compile the library unless it is built; returns its path. Raises
    with the compiler's output if the build fails."""
    so = library_path(src)
    with cuda.build_lock():
        if not os.path.exists(so):
            cxx = os.environ.get("CXX") or shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: the native Merkle engine "
                                   "(commit/csrc/sha256_merkle.cpp) needs it")
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = [cxx, *CXX_FLAGS, src, "-o", tmp]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if res.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n"
                                   f"{(res.stdout + res.stderr)[-4000:]}")
            os.replace(tmp, so)
    return so


def _load():
    """The bound library, built and checked on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.leaf_hash_batch.restype = None
        lib.leaf_hash_batch.argtypes = [_U64P, ctypes.c_size_t, ctypes.c_size_t,
                                        ctypes.c_int, ctypes.c_int, _U8P]
        lib.inner_levels.restype = ctypes.c_size_t
        lib.inner_levels.argtypes = [_U8P, ctypes.c_size_t, ctypes.c_size_t,
                                     ctypes.c_int, _U8P]
        lib.sha256_oneshot.restype = None
        lib.sha256_oneshot.argtypes = [_U8P, ctypes.c_size_t, _U8P]
        # a known answer before the library is trusted with a commitment
        probe = b"ministark native self-test"
        out = np.empty(32, dtype=np.uint8)
        buf = np.frombuffer(bytearray(probe), dtype=np.uint8)
        lib.sha256_oneshot(buf.ctypes.data_as(_U8P), len(probe),
                           out.ctypes.data_as(_U8P))
        if out.tobytes() != hashlib.sha256(probe).digest():
            raise RuntimeError("native Merkle engine: the SHA-256 self-test failed")
        _lib = lib
        return _lib


def _threads(n: int) -> int:
    return _NTHREADS if n >= THREAD_MIN else 1


def available() -> bool:
    """True when the library builds, loads and passes its self-test."""
    try:
        _load()
    except Exception:           # reported, never acted on here
        return False
    return True


def sha256_oneshot(data: bytes) -> bytes:
    lib = _load()
    out = np.empty(32, dtype=np.uint8)
    buf = np.frombuffer(bytearray(data), dtype=np.uint8)
    lib.sha256_oneshot(buf.ctypes.data_as(_U8P), len(data), out.ctypes.data_as(_U8P))
    return out.tobytes()


def leaf_hash_batch(vals: np.ndarray, leafs_per_node: int, fmt: int) -> np.ndarray:
    """vals: uint64 (n_elems, comps) (or (n_elems,) for fmt 0) canonical
    components -> (n_elems // leafs_per_node, 32) uint8 digests."""
    lib = _load()
    comps = {0: 1, 1: 2, 2: 4}[fmt]
    v = np.ascontiguousarray(vals, dtype=np.uint64).reshape(-1)
    n_elems = v.size // comps
    assert n_elems % leafs_per_node == 0
    n_groups = n_elems // leafs_per_node
    out = np.empty((n_groups, 32), dtype=np.uint8)
    lib.leaf_hash_batch(v.ctypes.data_as(_U64P), n_groups, leafs_per_node, fmt,
                        _threads(n_groups), out.ctypes.data_as(_U8P))
    return out


def inner_levels(level0: np.ndarray, fan_in: int) -> np.ndarray:
    """level0: (n, 32) uint8 digests -> the (n / fan_in + ... + 1, 32)
    digests of every level above it, level by level."""
    lib = _load()
    n = level0.shape[0]
    total, m = 0, n
    while m > 1:
        m //= fan_in
        total += m
    out = np.empty((total, 32), dtype=np.uint8)
    src = np.ascontiguousarray(level0, dtype=np.uint8)
    written = lib.inner_levels(src.ctypes.data_as(_U8P), n, fan_in,
                               _threads(n // fan_in), out.ctypes.data_as(_U8P))
    assert written == total
    return out


def pack_scalars(field, scalars: Sequence) -> np.ndarray:
    """Host scalars -> (n, comps) uint64 canonical components."""
    if field.extension_degree == 1:
        return np.asarray([int(s) for s in scalars], dtype=np.uint64).reshape(-1, 1)
    return np.asarray([list(field.base_coeffs(s)) for s in scalars],
                      dtype=np.uint64).reshape(len(scalars), -1)


def tree_nodes(field, scalars: Sequence, config: MerkleTreeConfig) -> List[bytes]:
    """Every node digest of the tree over ``scalars``, leaf groups first
    then level by level (``MerkleTree.nodes``), hashed here."""
    leaf = leaf_hash_batch(pack_scalars(field, scalars), config.leafs_per_node,
                           field_fmt(field))
    if leaf.shape[0] > 1:
        leaf = np.concatenate([leaf, inner_levels(leaf, config.inner_children)])
    flat = leaf.tobytes()
    return [flat[i:i + 32] for i in range(0, len(flat), 32)]


def merkle_tree(field, scalars: Sequence, config: MerkleTreeConfig) -> MerkleTree:
    """``MerkleTree(field, scalars, config)`` with its digests from the
    native engine: the same tree, root and proofs."""
    return MerkleTree(field, scalars, config,
                      nodes=tree_nodes(field, scalars, config))
