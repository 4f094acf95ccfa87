"""Profiling hooks (port of ``ministark_tpu/utils/profiling.py``).

Set MINISTARK_PROFILE=<dir> to capture a ``torch.profiler`` trace of a
section (CPU and, where the card is there, CUDA activity) into
``<dir>/<section>/trace.json`` (Chrome trace format); ``annotate(name)``
names a range inside it. Unset, both do nothing. No module of the package
calls them: a caller wraps what it wants to read.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def maybe_profile(section: str):
    out = os.environ.get("MINISTARK_PROFILE")
    if not out:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(out, section)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the profiler's trace (``record_function``)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
