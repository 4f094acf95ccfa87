"""Run a function on every rank of a new process group, one process each.

    results = run(fn, world=4, backend="gloo", device="cpu", timeout_s=120)

``fn(mesh, *args)`` runs in ``world`` processes started with the ``spawn``
method (CUDA needs it), which meet through a ``FileStore`` in a temporary
directory (no TCP port, so groups started side by side never collide).
``run`` returns the ranks' results in rank order. A rank that raises makes
``run`` kill the group and raise ``RuntimeError`` with that rank's
traceback; a group that has not answered within ``timeout_s`` seconds is
killed and ``run`` raises ``TimeoutError``. The same limit goes to
``init_process_group``, so a collective that waits on a lost rank ends too.

``fn`` and its arguments and results are pickled, so ``fn`` is a module
level function of a module that imports without jax (the port's modules,
or the running script). ``settings`` are (module, attribute, value)
triples set in every rank before ``fn`` runs: module state a caller
changed in its own process (``stark.engine.DEVICE_MIN_SIZE``) does not
reach a spawned process otherwise. Each rank runs torch on one thread.
``device`` is the card by default: ``device="cuda"`` gives rank r card
r % (number of cards) (a card each, the nccl case, when there are enough);
``device="cuda:0"`` puts every rank on that card (ranks that share one
card, with gloo); ``device="cpu"`` runs CPU ranks (gloo). The kernel
library is built here, before the ranks start.

``run`` leaves no process behind: it reaps every rank, and it stops and
reaps the resource tracker that the ``spawn`` method starts beside them
(on a Python whose tracker has no finalizer, 3.12.3 for one, it would end
only when the caller exits, and nothing would reap it then).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from multiprocessing import resource_tracker

import torch
import torch.distributed as dist

from .mesh import make_mesh

# seconds to drain what a rank wrote just before it exited
_DRAIN_S = 2.0
# runs in progress in this process, and whether the last one out stops the
# resource tracker (none was running when the first began)
_RUNS = {"active": 0, "stop": False}
_RUNS_LOCK = threading.Lock()


def _rank_main(fn, rank, world, backend, device, store_path, timeout_s, args,
               settings, results):
    try:
        torch.set_num_threads(1)
        for module, attr, value in settings:
            setattr(importlib.import_module(module), attr, value)
        dev = torch.device(device)
        if dev.type == "cuda":
            index = rank % torch.cuda.device_count() if dev.index is None else dev.index
            dev = torch.device("cuda", index)
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout_s))
        out = fn(make_mesh(device=dev), *args)
        results.put((rank, True, out))
    except BaseException:      # reported to the parent, which kills the group
        results.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()


def _collect(procs, results, world, timeout_s):
    got = {}
    deadline = time.monotonic() + timeout_s
    while len(got) < world:
        left = deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(world)) - set(got))
            raise TimeoutError(f"ranks {missing} of {world} gave no result "
                               f"within {timeout_s} s")
        try:
            rank, ok, out = results.get(timeout=min(left, 0.5))
        except queue_mod.Empty:
            gone = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode is not None]
            if not gone:
                continue
            try:                 # its last message may still be in the pipe
                rank, ok, out = results.get(timeout=_DRAIN_S)
            except queue_mod.Empty:
                raise RuntimeError(
                    f"rank {gone[0]} of {world} exited with code "
                    f"{procs[gone[0]].exitcode} and no result") from None
        if not ok:
            raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
        got[rank] = out
    return [got[r] for r in range(world)]


def run(fn, world: int, backend: str, device="cuda", timeout_s: float = 300.0,
        args=(), settings=()):
    """[fn(mesh, *args) of rank 0, ..., of rank world - 1]."""
    if torch.device(device).type == "cuda":
        from ..ops import cuda

        cuda.library()
    with _reaped_tracker():
        try:
            return _run(fn, world, backend, device, timeout_s, args, settings)
        except BaseException as e:
            # the traceback's frames hold the queue: drop their locals, so
            # that its semaphores go now and not after the tracker has
            # stopped (their finalizers would start a new one)
            traceback.clear_frames(e.__traceback__)
            raise


@contextlib.contextmanager
def _reaped_tracker():
    """Around a run: when the last run in progress in this process ends, and
    no tracker was running when the first began, stop the resource tracker
    and reap it (runs may overlap, from threads)."""
    tracker = resource_tracker._resource_tracker
    with _RUNS_LOCK:
        if _RUNS["active"] == 0:
            _RUNS["stop"] = tracker._pid is None
        _RUNS["active"] += 1
    try:
        yield
    finally:
        with _RUNS_LOCK:
            _RUNS["active"] -= 1
            if _RUNS["active"] == 0 and _RUNS["stop"]:
                gc.collect()         # the queues' semaphores, unregistered
                tracker._stop()      # closes its pipe and reaps it


def _run(fn, world, backend, device, timeout_s, args, settings):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ministark_mesh_") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, rank, world, backend, str(device), store_path, timeout_s,
            tuple(args), tuple(settings), results)) for rank in range(world)]
        for p in procs:
            p.start()
        try:
            out = _collect(procs, results, world, timeout_s)
            for p in procs:          # each rank leaves its group, then exits
                p.join(timeout=_DRAIN_S * 5)
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()             # a killed rank always ends: reap it
            results.close()
            results.join_thread()
