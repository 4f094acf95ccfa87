"""The share of the traced window in which the device ran nothing: 1 less
the union of its kernels', copies' and sets' intervals over the window."""

NAME, UNIT, LAYER, SOURCE = "device_idle_frac", "frac", "device", "device_trace"
MOVES = "rows_per_s"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
