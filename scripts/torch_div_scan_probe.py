#!/usr/bin/env python3
"""The division scan and pow_dot kernels (csrc/div_scan.cu) alone.

    python3 scripts/torch_div_scan_probe.py [--root DIR]
    python3 scripts/torch_div_scan_probe.py --device cpu

On a GPU host: builds the kernels, prints ptxas' register, stack and spill
lines for them, then runs chip_smoke.py's phase 3 rows for the two kernels
(``phase_kernels_div_scan``: every row against its plain version, exact,
with ms, device ms, bound and bound_frac) and prints one JSON line with
the rows and the card's name and power limit. ``--root DIR`` runs another
checkout's package and chip_smoke.py (say a parent commit unpacked under
the gitignored ``ministark_tpu_torch/_build/``), so that two versions are
read in one call; run it in a process of its own for each checkout.
``--sweep`` reads device ms by size instead (fold-divide, division,
pow_dot's even half at n = 2^10..2^20, one row each field).

After phase 3's rows, the diagnosis: csrc/div_scan.cu built three more
times with its diagnosis macros (never in ops/cuda.py's library), the
kernel wrappers pointed at each build in turn. With MS_DIV_SCAN_TRACE, the
blocks' phase clocks of one call at the fold-divide, (1, 2^20), (3, 2^20)
and (1, 2^12) divisions and pow_dot's two halves at 2^21 and 2^12, each
field; with MS_POW_DOT_LOOP = 1 (no loads), 2 (no products) and 3 (no
Horner steps), pow_dot's device ms beside the real kernel's at its
phase-3 shapes, 2^12 and 2^10, and an empty launch's (``stream_add1`` of
1024 words).

``--device cpu`` is the dry run here: the kernels' routes replayed in torch
ops (``div_scan_replay``, ``pow_dot_replay``) against the plain versions at
small tiles, every form of the division and both pow_dot forms.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dry_run():
    import numpy as np
    import torch

    from ministark_tpu_torch.fields import BABYBEAR_FP4, GOLDILOCKS_FP2
    from ministark_tpu_torch.ops import div_scan as ds
    from ministark_tpu_torch.ops.field import get_ops, pack_words, unpack_u64

    rng = np.random.default_rng(19)
    cases = 0
    for E in (GOLDILOCKS_FP2, BABYBEAR_FP4):
        k = get_ops(E)

        def rand(shape):
            v = rng.integers(0, E.p, size=tuple(shape) + (E.extension_degree,),
                             dtype=np.uint64)
            return pack_words(v, k.dtype)

        zs = [E.from_base_coeffs(tuple(int(c) for c in unpack_u64(r)))
              for r in rand((3,))]
        z, zinv = k.pack(zs), k.pack([E.inv(x) for x in zs])
        for m in (1, 15, 16, 17, 83):
            for flags in range(8):
                fold, head, carry = flags & 1, flags & 2, flags & 4
                c = rand((3, 2 * m if fold else m))
                kw = dict(start=5 if carry else 0, carry=rand((3,)) if carry else None,
                          head=rand((3, 18)) if head else None,
                          fold=rand(()) if fold else None)
                got = ds.div_scan_replay(k, c, z, zinv, chunk=2, lanes=4, warps=2,
                                         seed=flags, **kw)
                if not torch.equal(got, ds.div_scan_plain(k, c, z, zinv, **kw)):
                    raise SystemExit(f"div_scan_replay differs: {E} m {m} flags {flags}")
                cases += 1
        for n in (0, 1, 33, 70):
            c = rand((3, n))
            for parts in (1, 2):
                got = ds.pow_dot_replay(k, c, z, 9, 1, 0, parts, per_thread=4)
                if not torch.equal(got, ds.pow_dot_plain(k, c, z, 9, 1, 0, parts)):
                    raise SystemExit(f"pow_dot_replay differs: {E} n {n} parts {parts}")
                cases += 1
    print(json.dumps({"device": "cpu", "replay_cases": cases, "equal": True}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="the checkout whose package runs")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sweep", action="store_true",
                    help="device ms by size (2^10..2^20) in place of phase 3's rows")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if args.device == "cpu":
        return dry_run()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_div_scan_probe: no CUDA device (--device cpu for the dry run)")
    import chip_smoke as cs

    from ministark_tpu_torch.ops import cuda
    from ministark_tpu_torch.utils import roofline as rf

    cs.rf = rf
    smi = cs.phase_gpu()
    cuda.library()
    log = open(os.path.join(cuda.BUILD_DIR, "build.log")).read()
    fn = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        if fn and ("div_scan" in fn or "pow_dot" in fn) and (
                "registers" in ln or "stack frame" in ln):
            print(f"  ptxas {fn}: {ln.strip()}", flush=True)
    if args.sweep:
        print(json.dumps({"root": os.path.relpath(root, ROOT), "card": smi,
                          "sweep": sweep(cs, rf)}), flush=True)
        return
    results = {name: {"max_abs_err": 0, "shapes": [], "paths": {}}
               for name in ("div_scan_gl2", "div_scan_bb4", "pow_dot_gl2", "pow_dot_bb4")}
    cs.phase_kernels_div_scan(results)
    print(json.dumps({"root": os.path.relpath(root, ROOT), "card": smi,
                      "rows": {name: r["shapes"] for name, r in results.items()}}),
          flush=True)
    libs = diagnosis_builds(cuda)
    if libs:
        print(json.dumps({"trace": traced(cs, cuda, libs["trace"])}), flush=True)
        print(json.dumps({"pow_dot_loops": pow_dot_loops(cs, rf, cuda, libs)}), flush=True)


def sweep(cs, rf):
    """Device ms of one call by size, each field: the fold-divide of 2n
    coefficients, the division of n and pow_dot's even half of 2n (stride
    2), n = 2^10..2^20, one row; the calls and signatures every checkout of
    the kernels takes."""
    import numpy as np

    from ministark_tpu_torch.fields import BABYBEAR_FP4, GOLDILOCKS_FP2
    from ministark_tpu_torch.ops.field import get_ops

    ds = ds_module()
    rng = np.random.default_rng(cs.SEED + 20)
    out = {}
    for tag, E in (("gl2", GOLDILOCKS_FP2), ("bb4", BABYBEAR_FP4)):
        k, K = get_ops(E), E.extension_degree
        z, zinv = cs._ext_points(rng, E, 1)
        alpha = cs._rand_field(rng, (K,), E.p)
        c = cs._rand_field(rng, (1, 1 << 21, K), E.p)
        for log_n in range(10, 21):
            n = 1 << log_n
            c2, c1 = c[:, :2 * n], c[:, :n]
            out[f"{tag} 2^{log_n}"] = [round(rf.device_ms(f, 20), 4) for f in (
                lambda: ds.div_scan_cuda(k, c2, z, zinv, fold=alpha),
                lambda: ds.div_scan_cuda(k, c1, z, zinv),
                lambda: ds.pow_dot_cuda(k, c2, z, 0, 2))]
    return out


def ds_module():
    from ministark_tpu_torch.ops import div_scan as ds

    return ds


# csrc/div_scan.cu's diagnosis builds: name -> macros
DIAGNOSIS = {"trace": ("-DMS_DIV_SCAN_TRACE",),
             "no_loads": ("-DMS_POW_DOT_LOOP=1",),
             "no_products": ("-DMS_POW_DOT_LOOP=2",),
             "no_loop": ("-DMS_POW_DOT_LOOP=3",)}
TRACE = 9            # int64 words a block writes with MS_DIV_SCAN_TRACE
DIV_PHASES = ("load", "chunks", "look_back", "horner_down", "store")
DOT_PHASES = ("table", "horner", "z_power_wait", "partial", "last_sum")


def diagnosis_builds(cuda):
    """{name: library} of csrc/div_scan.cu compiled alone with each set of
    DIAGNOSIS macros, all at once; {} for a source without them."""
    src = os.path.join(cuda.CSRC, "div_scan.cu")
    text = open(src).read()
    if "MS_DIV_SCAN_TRACE" not in text:
        return {}
    h = hashlib.sha256(text.encode())
    for name in cuda.HEADERS:
        h.update(open(os.path.join(cuda.CSRC, name), "rb").read())
    sos = {name: os.path.join(cuda.BUILD_DIR, f"div_scan_{name}_{h.hexdigest()[:16]}.so")
           for name in DIAGNOSIS}
    cmds = [[cuda._nvcc(), *cuda.NVCC_FLAGS, "-shared", *DIAGNOSIS[name], src, "-o", so]
            for name, so in sos.items()]
    for cmd, out, rc in cuda._run_all(cmds):
        if rc:
            raise SystemExit(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out[-4000:]}")
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(so)
        for fn in ("ms_pow_dot_gl2", "ms_pow_dot_bb4", "ms_div_scan_gl2", "ms_div_scan_bb4"):
            getattr(lib, fn).argtypes = cuda._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    libs["trace"].ms_div_scan_trace.argtypes = [ctypes.c_void_p]
    return libs


@contextlib.contextmanager
def launching(cuda, lib):
    """The kernel wrappers launch ``lib``'s kernels inside the block (its
    missing symbols from the package's library)."""
    main = cuda.library()

    class Diagnosis:
        def __getattr__(self, name):
            try:
                return getattr(lib, name)
            except AttributeError:
                return getattr(main, name)

    cuda._lib = Diagnosis()
    try:
        yield
    finally:
        cuda._lib = main


def phases(trace, names) -> dict:
    """A traced call's blocks: each phase's median and largest SM clock
    cycles, the blocks an SM ran at most, and the span from the first
    block's start to the last one's end in ns (%globaltimer)."""
    import numpy as np

    t = trace.cpu().numpy().astype(np.int64)
    cyc = np.diff(t[:, 3:], axis=1)
    out = {n: [int(np.median(cyc[:, i])), int(cyc[:, i].max())] for i, n in enumerate(names)}
    out["block_cycles"] = [int(np.median(cyc.sum(1))), int(cyc.sum(1).max())]
    out["blocks_per_sm_max"] = int(np.bincount(t[:, 0]).max())
    out["span_ns"] = int(t[:, 2].max() - t[:, 1].min())
    out["start_spread_ns"] = int(t[:, 1].max() - t[:, 1].min())
    return out


def traced(cs, cuda, lib):
    """The last of three calls, traced, at the fold-divide, (1, 2^20), (3,
    2^20) and (1, 2^12) divisions and pow_dot's two halves at 2^21 and
    2^12, each field: ``phases`` of its blocks."""
    import numpy as np
    import torch

    from ministark_tpu_torch.fields import BABYBEAR_FP4, GOLDILOCKS_FP2
    from ministark_tpu_torch.ops.field import get_ops

    ds = ds_module()
    rng = np.random.default_rng(cs.SEED + 19)
    out = {}

    def run(label, blocks, names, call):
        tr = torch.zeros((blocks, TRACE), dtype=torch.int64, device="cuda")
        cuda.check("ms_div_scan_trace", lib.ms_div_scan_trace(tr.data_ptr()))
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        out[label] = phases(tr, names)

    with launching(cuda, lib):
        for tag, E in (("gl2", GOLDILOCKS_FP2), ("bb4", BABYBEAR_FP4)):
            k, K = get_ops(E), E.extension_degree
            z, zinv = cs._ext_points(rng, E, 3)
            alpha = cs._rand_field(rng, (K,), E.p)
            for label, c, kw in (("fold 2^21", cs._rand_field(rng, (1, 1 << 21, K), E.p),
                                  dict(fold=alpha)),
                                 ("(1, 2^20)", cs._rand_field(rng, (1, 1 << 20, K), E.p), {}),
                                 ("(3, 2^20)", cs._rand_field(rng, (3, 1 << 20, K), E.p), {}),
                                 ("(1, 2^12)", cs._rand_field(rng, (1, 1 << 12, K), E.p), {})):
                B = c.shape[0]
                m = c.shape[1] // (2 if kw else 1)
                run(f"{tag} {label}", B * -(-m // ds.tile(tag, bool(kw))), DIV_PHASES,
                    lambda: ds.div_scan_cuda(k, c, z[:B], zinv[:B], **kw))
            for log_n in (21, 12):
                c = cs._rand_field(rng, (1, 1 << log_n, K), E.p)
                run(f"{tag} pow_dot parts=2 2^{log_n}", -(-(1 << log_n) // (2 * ds.DOT_TILE)),
                    DOT_PHASES, lambda: ds.pow_dot_cuda(k, c, z[:1], 0, 1, 0, 2))
    return out


def pow_dot_loops(cs, rf, cuda, libs):
    """pow_dot's device ms at phase 3's three shapes, both halves at 2^12
    and one sum of 2^10, each field: the kernel, and the builds without
    loads, without products and without the Horner steps (the powers, the
    trees and the sums alone); an empty launch's device ms beside them."""
    import numpy as np
    import torch

    from ministark_tpu_torch.fields import BABYBEAR_FP4, GOLDILOCKS_FP2
    from ministark_tpu_torch.ops import stream
    from ministark_tpu_torch.ops.field import get_ops

    ds = ds_module()
    rng = np.random.default_rng(cs.SEED + 21)
    out = {}
    for tag, E in (("gl2", GOLDILOCKS_FP2), ("bb4", BABYBEAR_FP4)):
        k, K = get_ops(E), E.extension_degree
        z, _ = cs._ext_points(rng, E, 1)
        c = cs._rand_field(rng, (1, 1 << 21, K), E.p)
        for label, cc, start, stride, parts in (
                ("2^21, stride 2 (even half)", c, 0, 2, 1), ("2^21, parts=2", c, 0, 1, 2),
                ("block 2^19 from 2^19", c[:, :1 << 19], 1 << 19, 1, 1),
                ("2^12, parts=2", c[:, :1 << 12], 0, 1, 2), ("2^10", c[:, :1 << 10], 0, 1, 1)):
            def call():
                return ds.pow_dot_cuda(k, cc, z, start, stride, 0, parts)
            row = {"kernel": rf.device_ms(call, 30)}
            for name in ("no_loads", "no_products", "no_loop"):
                with launching(cuda, libs[name]):
                    row[name] = rf.device_ms(call, 30)
            out[f"{tag} {label}"] = {n: round(v, 4) for n, v in row.items()}
    x = torch.zeros(1024, dtype=torch.int32, device="cuda")
    out["stream_add1 (1024,)"] = round(rf.device_ms(lambda: stream.stream_add1_cuda(x), 50), 4)
    return out


if __name__ == "__main__":
    main()
