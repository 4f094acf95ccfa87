"""Kernel-launch calls a prove makes: the CUDA API launch calls the
profiler recorded in the traced window, over its calls."""

NAME, UNIT, LAYER, SOURCE = "launches_per_call", "launches", "prover and torch ops", "device_trace"
MOVES = "rows_per_s"


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.launches:
        return None
    return t.launches / t.calls
