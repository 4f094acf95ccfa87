#!/usr/bin/env python3
"""Where a cold call of the first-occurrence leaf search spends its time.

    python3 scripts/torch_first_match_probe.py [--root DIR] [--reps N] [--rounds N]
    python3 scripts/torch_first_match_probe.py --device cpu

On a GPU host: builds ``scripts/torch_first_match_probe.cu`` (throwaway
kernels, never part of the package) and DIR's
``ministark_tpu_torch/csrc/leaf_search.cu``, each alone with the package's
nvcc flags, and times at chip_smoke.py's four phase-3 shapes of the search
(GL Fp2 (2^21, 2) q 6, BB Fp4 (2^21, 4) q 6, a resident block (2^20, 2) q 6,
(2^21, 2) q 64; the rows planted by ``chip_smoke._planted_search``), each
cold (``rf.cold_device_ms``: the operands out of L2) and warm
(``rf.device_ms``), in ``--rounds`` rounds, the variants in turns
(forward, then backward):

  empty      an empty launch of the pre-redesign search's grid
             (min(ceil(n / 1024), 8 a SM) blocks of 256 threads)
  read       a read-only pass over the same bytes with that grid and the
             same loads (4 elements a thread a pass), no compare, no
             epilogue
  v0         the search as it stood before its redesign (commit 8662a95:
             the rows and minima in shared memory), in the probe's source
  v0_hoist   the same with each thread's loads issued before the row fill
  port       DIR's ``first_match_cuda`` on DIR's leaf_search.cu
  read_u8, read_u16
             the read-only pass at 8 and 16 elements a thread a pass on a
             grid of one wave (min(blocks needed, resident blocks an SM x
             SMs)); at the q 6 shapes only
  v1_*       the redesign's first candidates (q 6 only): the elements in
             registers, U elements a thread a pass at 256 or 1024 threads,
             the ticket after a SC fence (epi1), as one acq_rel atomic
             (epi2) or none (epi0, no result), and on the grid the elements
             need (``_need``)
  ring_*     the ring design's knobs (q 6 only): S elements in flight a
             thread through cp.async (s4, s8, s16), read only (``_read``),
             a contiguous chunk a block (``_chunk``), 4 blocks an SM, the
             ticket in two levels, and the epilogue cut down to nothing, the
             barrier, the ticket, or the ticket and the last block's
             write-back with its minima read by atomicExch, plain loads or
             not at all (``_only``: timing, no result); ``rring_*`` the
             ring in registers (loads, no cp.async) at S 4 and 8, read
             only and with the port's compare and epilogue

v0, v0_hoist, port and every variant that writes a result must equal the
planted indices (exit 1 otherwise).
Then one call each of v0, v0_hoist and the v1 variants with a ticket
traced (each block's SM and
%globaltimer at its start, after its first compare, after its loop's
barrier and at its end): the span from the first block's start to the last
one's end, the spread of the starts, the median and largest wait for a
block's first data, the median loop, and the tail from the last loop's end
to the last block's end. Prints ptxas' lines for the port's kernels and
one JSON line with the card's name and power limit, the grids and the
readings (ms) beside ``rf.first_match_work``'s bound.

``--device cpu`` prints the grids of v0 and the read-only passes on a
132-SM card at 4 resident blocks an SM (the dry run of the plan).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROBE_SRC = os.path.join(HERE, "torch_first_match_probe.cu")
THREADS = 256
V0_UNROLL = 4
V0_BLOCKS_PER_SM = 8
TRACE_WORDS = 5
# chip_smoke.py phase 3's shapes: label, n, C, q, field
SHAPES = (("GL Fp2 (2^21, 2), q 6", 1 << 21, 2, 6, "gl"),
          ("BB Fp4 (2^21, 4), q 6", 1 << 21, 4, 6, "bb"),
          ("resident block (2^20, 2), q 6", 1 << 20, 2, 6, "gl"),
          ("(2^21, 2), q 64", 1 << 21, 2, 64, "gl"))
READ_UNROLLS = (8, 16)
# the ring design's knobs (probe_ring_launch's variants): name, variant,
# blocks an SM at most (0: as many as fit)
RING_VARIANTS = (("ring_s4", 0, 0), ("ring_s8", 1, 0), ("ring_s16", 2, 0),
                 ("ring_s8_read", 3, 0), ("ring_s8_chunk", 4, 0), ("ring_s8_chunk_read", 5, 0),
                 ("ring_s8_4_per_sm", 1, 4), ("ring_s8_no_epilogue", 6, 0),
                 ("ring_s8_two_level", 7, 0), ("ring_s4_two_level", 8, 0),
                 ("ring_s4_ticket_only", 9, 0), ("ring_s4_barrier_only", 10, 0),
                 ("ring_s4_two_level_spread", 11, 0), ("ring_s4_no_epilogue", 12, 0),
                 ("ring_s4_relaxed_exch", 13, 0), ("ring_s4_relaxed_exch_apart_only", 14, 0),
                 ("ring_s4_relaxed_plain_apart_only", 15, 0),
                 ("ring_s4_relaxed_no_minima_only", 16, 0),
                 ("rring_s4_read", 17, 0), ("rring_s8_read", 18, 0),
                 ("rring_s4", 19, 0), ("rring_s8", 20, 0))
# the redesign's candidates (probe_v1_launch's variants 0-4, then variant 1
# on the grid the elements need): name, unroll, threads a block, one wave
V1_VARIANTS = (("v1_u8_t256_epi1", 0, 8, 256, True), ("v1_u8_t256_epi2", 1, 8, 256, True),
               ("v1_u8_t256_epi0", 2, 8, 256, True), ("v1_u8_t1024_epi2", 3, 8, 1024, True),
               ("v1_u4_t256_epi2", 4, 4, 256, True),
               ("v1_u8_t256_epi2_need", 1, 8, 256, False))


def v0_blocks(n: int, sms: int) -> int:
    need = -(-n // (THREADS * V0_UNROLL))
    return min(need, sms * V0_BLOCKS_PER_SM)


def wave_blocks(n: int, unroll: int, sms: int, resident: int) -> int:
    return min(-(-n // (THREADS * unroll)), sms * resident)


def build(root: str):
    """(probe library, DIR's leaf_search.cu library, ptxas log), each
    compiled alone into DIR's gitignored ``_build/``."""
    from ministark_tpu_torch.ops import cuda

    leaf = os.path.join(cuda.CSRC, "leaf_search.cu")
    out = {}
    cmds = []
    for name, src in (("probe", PROBE_SRC), ("leaf", leaf)):
        h = hashlib.sha256(" ".join(cuda.NVCC_FLAGS).encode() + open(src, "rb").read())
        so = os.path.join(cuda.BUILD_DIR, f"first_match_{name}_{h.hexdigest()[:16]}.so")
        out[name] = so
        cmds.append([cuda._nvcc(), *cuda.NVCC_FLAGS, "-shared", src, "-o", so])
    os.makedirs(cuda.BUILD_DIR, exist_ok=True)
    results = cuda._run_all(cmds)
    for cmd, text, rc in results:
        if rc:
            raise SystemExit(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text[-4000:]}")
    probe = ctypes.CDLL(out["probe"])
    P, I = ctypes.c_void_p, ctypes.c_int
    probe.probe_empty_launch.argtypes = [I, P]
    probe.probe_read_launch.argtypes = [P, P, I, I, I, I, I, P]
    probe.probe_read_occupancy.argtypes = [I, I, I]
    probe.probe_v0_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, P, P]
    probe.probe_v1_launch.argtypes = [I, P, P, P, P, I, I, I, I, I, P, P, P]
    probe.probe_ring_launch.argtypes = [I, P, P, P, P, I, I, I, I, I, P, P]
    for fn in ("probe_empty_launch", "probe_read_launch", "probe_read_occupancy",
               "probe_v0_launch", "probe_v1_launch", "probe_ring_launch"):
        getattr(probe, fn).restype = I
    probe.ms_error_string.argtypes = [I]
    probe.ms_error_string.restype = ctypes.c_char_p
    leaf_lib = ctypes.CDLL(out["leaf"])
    for fn in ("ms_first_match", "ms_first_match_bb", "ms_first_match_geometry"):
        if hasattr(leaf_lib, fn):                   # the geometry: since the redesign
            getattr(leaf_lib, fn).argtypes = cuda._SIGNATURES[fn]
            getattr(leaf_lib, fn).restype = I
    return probe, leaf_lib, results[1][1]


def ptxas_lines(log: str):
    fn, lines = None, []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        if fn and ("registers" in ln or "stack frame" in ln):
            lines.append(f"{fn}: {ln.strip()}")
    return lines


class Proxy:
    """The package's kernel library as ``first_match_cuda`` sees it: the
    search from DIR's leaf_search.cu built alone, the error strings from
    the probe's library."""

    def __init__(self, leaf, probe):
        self.leaf, self.probe = leaf, probe

    def __getattr__(self, name):
        lib = self.leaf if name.startswith("ms_first_match") else self.probe
        return getattr(lib, name)


def trace_summary(t) -> dict:
    """A traced call's blocks (smid, start, first compare, loop barrier,
    end; %globaltimer ns)."""
    import numpy as np

    t = t.cpu().numpy().astype(np.int64)
    start, first, loop, end = t[:, 1], t[:, 2], t[:, 3], t[:, 4]
    return {"blocks": int(t.shape[0]),
            "blocks_per_sm_max": int(np.bincount(t[:, 0]).max()),
            "span_ns": int(end.max() - start.min()),
            "start_spread_ns": int(start.max() - start.min()),
            "first_data_ns": [int(np.median(first - start)), int((first - start).max())],
            "first_data_after_launch_ns": int(first.min() - start.min()),
            "loop_ns": [int(np.median(loop - start)), int((loop - start).max())],
            "tail_ns": int(end.max() - loop.max()),
            "last_loop_end_ns": int(loop.max() - start.min())}


def dry_run():
    for label, n, C, q, field in SHAPES:
        plan = {"v0_blocks": v0_blocks(n, 132)}
        for u in READ_UNROLLS:
            plan[f"read_u{u}_blocks (4 resident)"] = wave_blocks(n, u, 132, 4)
        print(json.dumps({"shape": label, **plan}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="the checkout whose package runs")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if args.device == "cpu":
        return dry_run()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_first_match_probe: no CUDA device (--device cpu for the plan)")
    import chip_smoke as cs

    from ministark_tpu_torch.commit import packed_tree as pt
    from ministark_tpu_torch.fields import BABYBEAR_FP, Goldilocks
    from ministark_tpu_torch.ops import cuda
    from ministark_tpu_torch.utils import roofline as rf

    cs.rf = rf
    smi = cs.phase_gpu()
    probe, leaf_lib, log = build(root)
    for ln in ptxas_lines(log):
        print("  ptxas " + ln, flush=True)
    cuda._lib = Proxy(leaf_lib, probe)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream   # noqa: E731

    def check(name, err):
        if err:
            raise SystemExit(f"{name}: CUDA error {err} "
                             f"({probe.ms_error_string(err).decode()})")

    rng = np.random.default_rng(cs.SEED + 23)
    sink = torch.zeros(1, dtype=torch.int64, device="cuda")
    flush = torch.ones(rf.L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    # the kernels' scratch: word 0 the ticket, the minima, and 32 x 32 zero
    # words for the probe's two-level tickets
    scratch = torch.zeros(1 + pt.MATCH_MAX_ROWS + 1024, dtype=torch.int32, device="cuda")
    scratch[1:1 + pt.MATCH_MAX_ROWS] = -1
    report = {"root": os.path.relpath(root, ROOT), "gpu": smi, "sms": sms, "shapes": {}}
    for label, n, C, q, field in SHAPES:
        p = Goldilocks.base.p if field == "gl" else BABYBEAR_FP.p
        comps, rows, want = cs._planted_search(rng, n, C, q, p)
        word = comps.element_size()
        blocks = v0_blocks(n, sms)
        out = torch.empty(q, dtype=torch.int64, device="cuda")

        def v0(hoist, trace=None, comps=comps, rows=rows, out=out, n=n, q=q, C=C,
               word=word, blocks=blocks):
            check("v0", probe.probe_v0_launch(
                comps.data_ptr(), rows.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, q,
                C, word, blocks, hoist, None if trace is None else trace.data_ptr(),
                stream()))
            return out

        def read(unroll, grid, comps=comps, n=n, C=C, word=word):
            check("read", probe.probe_read_launch(comps.data_ptr(), sink.data_ptr(), n, C,
                                                  word, unroll, grid, stream()))

        variants = {
            "empty": lambda blocks=blocks: check("empty", probe.probe_empty_launch(
                blocks, stream())),
            "read": lambda: read(V0_UNROLL, blocks),
            "v0": lambda: v0(0),
            "v0_hoist": lambda: v0(1),
            "port": lambda comps=comps, rows=rows: pt.first_match_cuda(comps, rows,
                                                                       comps.dtype),
        }
        grids = {"v0": blocks}
        v1_calls = {}
        checked = []
        if hasattr(leaf_lib, "ms_first_match_geometry"):
            grids["port"] = pt.first_match_geometry(n, q, C, comps.dtype)
        if q <= 8:
            for name, k, unroll, tpb, wave in V1_VARIANTS:
                res = ctypes.c_int(0)
                check("v1 occupancy", probe.probe_v1_launch(
                    k, None, None, None, None, n, q, C, word, 0, None, None,
                    ctypes.byref(res)))
                need = -(-n // (tpb * unroll))
                g = min(need, sms * res.value) if wave else need
                grids[name] = [g, res.value]

                def v1(trace=None, k=k, g=g, comps=comps, rows=rows, out=out, n=n, q=q,
                       C=C, word=word):
                    check("v1", probe.probe_v1_launch(
                        k, comps.data_ptr(), rows.data_ptr(), out.data_ptr(),
                        scratch.data_ptr(), n, q, C, word, g,
                        None if trace is None else trace.data_ptr(), stream(), None))
                    return out

                variants[name] = v1
                v1_calls[name] = (v1, g)
            for name, k, per_sm in RING_VARIANTS:
                res = ctypes.c_int(0)
                check("ring occupancy", probe.probe_ring_launch(
                    k, None, None, None, None, n, q, C, word, 0, None, ctypes.byref(res)))
                g = min(-(-n // THREADS), sms * min(res.value, per_sm or res.value))
                grids[name] = [g, res.value]

                def ring(k=k, g=g, comps=comps, rows=rows, out=out, n=n, q=q, C=C, word=word):
                    check("ring", probe.probe_ring_launch(
                        k, comps.data_ptr(), rows.data_ptr(), out.data_ptr(),
                        scratch.data_ptr(), n, q, C, word, g, stream(), None))
                    return out

                variants[name] = ring
                if not any(w in name for w in ("read", "no_epilogue", "_only")):
                    checked.append(name)
            for u in READ_UNROLLS:
                res = probe.probe_read_occupancy(C, word, u)
                grids[f"read_u{u}"] = g = wave_blocks(n, u, sms, res)
                grids[f"read_u{u}_resident_per_sm"] = res
                variants[f"read_u{u}"] = lambda u=u, g=g: read(u, g)
        for name in ("v0", "v0_hoist", "port", *(k for k in v1_calls if "epi0" not in k),
                     *checked):
            got = variants[name]().cpu()
            if not torch.equal(got, want):
                raise SystemExit(f"{label} {name}: {got.tolist()} against the planted "
                                 f"{want.tolist()}")
        readings = {name: {"cold": [], "warm": []} for name in variants}
        order = list(variants)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                readings[name]["cold"].append(rf.cold_device_ms(variants[name], args.reps))
                readings[name]["warm"].append(rf.device_ms(variants[name], args.reps))
        traces = {}
        for name, hoist in (("v0", 0), ("v0_hoist", 1)):
            tr = torch.zeros((blocks, TRACE_WORDS), dtype=torch.int64, device="cuda")
            flush.sum()                 # the traced call's operands out of L2
            v0(hoist, tr)
            torch.cuda.synchronize()
            traces[name] = trace_summary(tr)
        for name, (call, g) in v1_calls.items():
            if name.endswith("epi1") or name.endswith("epi2"):
                tr = torch.zeros((g, TRACE_WORDS), dtype=torch.int64, device="cuda")
                flush.sum()
                call(tr)
                torch.cuda.synchronize()
                traces[name] = trace_summary(tr)
        bms, by = rf.bound(*rf.first_match_work(comps, rows))
        row = {"bound_ms": bms, "bound_by": by, "grids": grids, "traces": traces}
        for name, rd in readings.items():
            cold = statistics.median(rd["cold"])
            row[name] = {"cold_ms": cold, "warm_ms": statistics.median(rd["warm"]),
                         "cold_all": rd["cold"], "warm_all": rd["warm"],
                         "bound_frac": bms / cold}
            print(f"  {label} {name}: cold {cold:.4f} ms, warm "
                  f"{row[name]['warm_ms']:.4f} ms, bound_frac {bms / cold:.3f}", flush=True)
        for name, s in traces.items():
            print(f"  {label} {name} traced: {json.dumps(s)}", flush=True)
        report["shapes"][label] = row
        del comps, rows, want
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
