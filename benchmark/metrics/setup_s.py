"""Seconds from the harness's first line to the first timed call: imports,
the kernel library (built on a checkout's first run, else loaded), the
prover's tables and the warm-up calls at the cell's own shapes."""

NAME, UNIT, LAYER, SOURCE = "setup_s", "s", None, "host_clock"


def read(run):
    return run.setup_s
