"""The device memory the program held at its peak in the window: the CUDA
caching allocator's max_memory_allocated after a reset at the window's
start, read by the harness, in GiB."""

NAME, UNIT, LAYER, SOURCE = "peak_device_gib", "GiB", None, "host_clock"


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
