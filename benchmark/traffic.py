"""The one traffic generator: a mix file (``traffic/<name>.json``) holds the
parameters, and every statement of a run comes from (seed, stream, call,
item), so that the same seed gives the same statements in any run.

A mix is a closed loop of one caller: each call hands over
``traces_per_call`` statements and waits for its proof before the next.
Each statement is a trace of ``steps`` steps with its own secret, drawn
uniformly from ``secret_range`` = [lo, hi). The work of a call is the
same for every seed; only the values change.
"""

from __future__ import annotations

import numpy as np

WINDOW, WARM_UP, CHECK = 0, 1, 2     # streams


def statements(mix: dict, seed: int, call: int, stream: int = WINDOW) -> list:
    """The secrets of one call."""
    rng = np.random.default_rng([abs(seed), int(seed < 0), stream, call])
    lo, hi = mix["secret_range"]
    return [int(v) for v in rng.integers(lo, hi, size=mix["traces_per_call"])]


class Reservoir:
    """A uniform sample of ``count`` of the calls offered, drawn from the
    seed as they come (reservoir sampling), so that only the sampled
    calls' answers are kept."""

    def __init__(self, seed: int, count: int):
        self.rng = np.random.default_rng([abs(seed), int(seed < 0), CHECK])
        self.count = count
        self.kept = []                  # (call index, item)

    def offer(self, call: int, item):
        if len(self.kept) < self.count:
            self.kept.append((call, item))
            return
        j = int(self.rng.integers(0, call + 1))
        if j < self.count:
            self.kept[j] = (call, item)
