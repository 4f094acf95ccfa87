#!/usr/bin/env python3
"""Warm parity proves of the PyTorch/CUDA port (ministark_tpu_torch) on two
sides in turns, in one process on one card: with ``DeviceEngine(
query_split=False)`` against ``query_split=True`` (what the split query
report costs), with ``--tail`` the host-tail FRI trees hashed by hashlib
(``commit/merkle.py::MerkleTree``) against the native engine
(``commit/native.py``, the engine's ``tail_tree``), or with ``--root DIR``
the package of another checkout (a parent commit unpacked beside this one)
against this checkout's.

    python3 scripts/torch_ab_prove.py [--steps N] [--pairs N] [--root DIR]
                                      [--tail] [--field goldilocks|babybear]
                                      [--device cuda|cpu]

Proves Fibonacci (security 20, blowup 2, witness on the device) once on
each side to warm up, checks that both give the same proof, then
``--pairs`` times A, B, B, A (the order turns so that a drift of the
machine falls on both alike), and prints one JSON line: the card's name and
power limit (nvidia-smi), every prove's wall seconds, the median and the
range of each side, and the median of the differences B - A within a pair.
The host's clock spreads by seconds between proves of this host-bound
prover, so read the difference beside the range. The other checkout's
package is imported under another name (the package imports itself only
relatively) and builds its kernels into its own ``_build/``. ``--device
cpu`` is a dry run at a small ``--steps``: host times, no device metric.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_package(root, alias):
    """ministark_tpu_torch of the checkout at ``root``, imported as
    ``alias`` so that it lives beside this checkout's in one process."""
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "ministark_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def _side(pkg, field, steps, device, **engine_kw):
    """(engine, trace, proof_digests) of one side, from package ``pkg``."""
    import importlib

    fields = importlib.import_module(pkg + ".fields")
    trace_mod = importlib.import_module(pkg + ".models.fibonacci_device")
    stark = importlib.import_module(pkg + ".stark")
    engine_mod = importlib.import_module(pkg + ".stark.engine")
    proof_io = importlib.import_module(pkg + ".stark.proof_io")
    sf = {"goldilocks": fields.Goldilocks, "babybear": fields.BabyBear}[field]
    trace = trace_mod.fibonacci_device_trace(sf, steps, on_device=True, device=device)
    cfg = stark.StarkConfig(sf, 20, 2, steps, trace.constrain_number())
    engine = engine_mod.DeviceEngine(cfg, device=device, **engine_kw)
    return engine, trace, lambda proof: proof_io.proof_digests(sf, proof)


def run(steps, pairs, field="goldilocks", device="cuda", root=None, tail=False):
    import torch

    on_card = torch.device(device).type == "cuda"
    if tail:
        from ministark_tpu_torch.commit.merkle import MerkleTree

        probe, names = "tail_tree_ab", ("hashlib", "native")
        sides = {name: _side("ministark_tpu_torch", field, steps, device)
                 for name in names}
        sides["hashlib"][0].tail_tree = MerkleTree
    elif root is None:
        probe, names = "query_split_ab", ("off", "on")
        sides = {name: _side("ministark_tpu_torch", field, steps, device,
                             query_split=split)
                 for name, split in zip(names, (False, True))}
    else:
        load_package(root, "ministark_tpu_torch_other")
        probe, names = "parent_change_ab", ("parent", "change")
        sides = {"parent": _side("ministark_tpu_torch_other", field, steps, device),
                 "change": _side("ministark_tpu_torch", field, steps, device)}

    def prove(name):
        """(wall seconds, proof); the proof's digests (seconds of Python at
        2^20 - 1) are taken outside the timed prove, and only here below."""
        engine, trace, _ = sides[name]
        if on_card:
            torch.cuda.synchronize()
        t0 = time.time()
        proof = engine.prove(trace)
        if on_card:
            torch.cuda.synchronize()
        return time.time() - t0, proof

    # warm-up, and the same bytes from both sides
    if (sides[names[0]][2](prove(names[0])[1])
            != sides[names[1]][2](prove(names[1])[1])):
        raise AssertionError(f"{names[0]} and {names[1]} give different proofs")

    secs = {name: [] for name in names}
    diffs = []
    for i in range(pairs):
        order = names if i % 2 == 0 else names[::-1]
        pair = {name: prove(name)[0] for name in order}
        for name in order:
            secs[name].append(pair[name])
        diffs.append(pair[names[1]] - pair[names[0]])

    def side(v):
        return {"prove_s": v, "median_s": statistics.median(v),
                "min_s": min(v), "max_s": max(v)}

    smi = None
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out = {"probe": probe, "field": field, "steps": steps, "pairs": pairs,
           "gpu": smi, "device": device}
    if root is None and not tail:
        out["query_phase_labels"] = {
            name: sum(k.startswith("fri_query_round_")
                      for k in sides[name][0].phase_seconds) for name in names}
    elif root is not None:
        out["root"] = os.path.abspath(root)
    out.update({name: side(secs[name]) for name in names})
    out["median_diff_s"] = statistics.median(diffs)
    out["median_diff_share"] = statistics.median(diffs) / statistics.median(secs[names[0]])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=(1 << 20) - 1)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--field", choices=("goldilocks", "babybear"),
                    default="goldilocks")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None,
                    help="another checkout, proved against this one")
    ap.add_argument("--tail", action="store_true",
                    help="the hashlib host-tail trees against the native ones")
    args = ap.parse_args()

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu for a dry run)", file=sys.stderr)
        sys.exit(1)
    print(json.dumps(run(args.steps, args.pairs, args.field, args.device, args.root,
                         args.tail)),
          flush=True)


if __name__ == "__main__":
    main()
