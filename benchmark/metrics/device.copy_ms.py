"""device.copy_ms: device milliseconds of host-device copies a job, from
the profiler's rows in the window; nothing where none ran."""


def read(trace):
    events = trace.window_device("copy")
    if not events or not trace.jobs:
        return None
    return sum(e.end - e.start for e in events) / len(trace.jobs) / 1e6
