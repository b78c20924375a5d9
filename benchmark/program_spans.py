"""The program's own spans in a traced run.

``fastqdedup_tpu_torch.utils.trace`` keeps every span it records while
a ``torch.profiler`` session records in the process, which is the whole
of a ``--trace 1`` run.  Its times are ``time.time_ns()``, the clock of
the harness's ``Trace.jobs``, ``Trace.window`` and ``Trace.traced``, so
the spans are cut along the harness's own intervals here.  A span's
``counts`` hold what the program counted while it was the innermost
open span, so the window's totals are the sum over the window's spans.

A program without that recorder gives nothing, and so does a run in
which it recorded nothing: each reader then reports nothing.
"""

from typing import Dict, List, Optional


def recorded() -> Optional[list]:
    """The recorder's spans, or None where the program has no recorder."""
    try:
        from fastqdedup_tpu_torch.utils import trace as recorder
    except ImportError:
        return None
    return recorder.spans()


def inside(spans: list, lo: int, hi: int) -> list:
    """The spans whose interval lies within [lo, hi]."""
    return [s for s in spans if lo <= s.start and s.end <= hi]


def per_job(trace) -> Optional[List[list]]:
    """The spans of each of the window's jobs, or None."""
    spans = recorded()
    if not spans or not trace.jobs:
        return None
    return [inside(spans, start, end) for start, end in trace.jobs]


def before_window(trace) -> Optional[list]:
    """The spans of the first two jobs (from t0 to the window), or None."""
    spans = recorded()
    lo, hi = trace.traced[0], trace.window[0]
    if not spans or hi <= lo:
        return None
    return inside(spans, lo, hi)


def window_counts(trace) -> Optional[Dict[str, int]]:
    """The counters' totals over the window's spans, or None where no
    span lies in the window."""
    spans = recorded()
    if not spans:
        return None
    window = inside(spans, *trace.window)
    if not window:
        return None
    totals: Dict[str, int] = {}
    for s in window:
        for name, n in s.counts.items():
            totals[name] = totals.get(name, 0) + n
    return totals


def seconds(spans: list, name: str) -> float:
    """The summed seconds of the spans called ``name``."""
    return sum(s.end - s.start for s in spans if s.name == name) / 1e9


def mean_job_seconds(trace, name: str) -> Optional[float]:
    """Seconds a window job spends in spans called ``name``, the mean
    over the window's jobs; None where no job has one."""
    jobs = per_job(trace)
    if not jobs or not any(s.name == name for job in jobs for s in job):
        return None
    return sum(seconds(job, name) for job in jobs) / len(jobs)
