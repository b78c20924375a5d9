"""kernel_ms: device milliseconds of the port's own kernels a job, from
the profiler's rows in the window; nothing where none ran."""

from benchmark import roofline


def read(trace):
    events = trace.window_device("kernel", roofline.ALL_DEVICE_KERNELS)
    if not events or not trace.jobs:
        return None
    return sum(e.end - e.start for e in events) / len(trace.jobs) / 1e6
