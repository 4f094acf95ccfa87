"""Device milliseconds of kernels a prove: the summed durations of the
kernels the traced window ran (copies and sets left out), over its
calls."""

NAME, UNIT, LAYER, SOURCE = "kernel_ms_per_call", "ms", "kernels", "device_trace"
MOVES = "rows_per_s"


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.kernels:
        return None
    return t.kernel_s * 1e3 / t.calls
