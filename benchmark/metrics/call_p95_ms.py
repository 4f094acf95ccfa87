"""The 95th percentile of the window's call times, each from handing the
statements over to holding the proof after a synchronize (inclusive
quantiles, Python's statistics)."""

import statistics

NAME, UNIT, LAYER, SOURCE = "call_p95_ms", "ms", None, "host_clock"


def read(run):
    times = [(b - a) * 1e3 for a, b in run.calls]
    if len(times) < 2:
        return times[0] if times else None
    return statistics.quantiles(times, n=100, method="inclusive")[94]
