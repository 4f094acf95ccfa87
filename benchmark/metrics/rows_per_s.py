"""Trace rows proved a second: the rows of every call of the window (its
traces times their rows) over the window's seconds, from its start to the
end of its last call."""

NAME, UNIT, LAYER, SOURCE = "rows_per_s", "rows/s", None, "host_clock"


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return run.rows / run.window_s
