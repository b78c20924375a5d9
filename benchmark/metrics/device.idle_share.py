"""device.idle_share: percent of the window (its first job's start to its
last job's end) in which no operation ran on the card.  The first two
jobs' idle time is in the traced run's ``breakdown`` (``first and warm
job``), not here."""

from benchmark.trace import busy_intervals


def read(trace):
    lo, hi = trace.window
    if hi <= lo:
        return None
    busy = sum(e - s for s, e in busy_intervals(trace.device, lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo))
