"""The kernels' share of their roofline, in %: the least time the H100
needs for a call's compulsory device work (the system's ``work``: the
protocol's transforms and SHA-256 at the cell's sizes, at the published
peaks of ``roofline.py``) over the kernel time a call took. The numerator
is fixed by the protocol, whatever kernels run."""

from benchmark import roofline

NAME, UNIT, LAYER, SOURCE = "kernels_roofline", "%", "kernels", "device_trace"
MOVES = "rows_per_s"


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.kernels or run.work is None:
        return None
    return 100.0 * roofline.least_s(*run.work) / (t.kernel_s / t.calls)
