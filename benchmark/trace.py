"""The traced run: spans around the port's calls into each layer, the
shapes of each kernel launch, the launch counters, and the device
activity that ``torch.profiler`` records.

Spans come from the benchmark's own wrappers, put around names the
pipeline looks up when it runs them (and taken away again):
``pipeline.build_partition_groups`` (pair generation and labels),
``pipeline._write_from_record_store`` and ``pipeline._filter_and_write``
(pass 3).  A job's span is the job loop's own.  The launch shapes come
from the host side of the two verification routes, where the index
pairs are still numpy arrays: ``ops.bucket._DevicePairVerifier.verify``
(one pair-list launch each) and ``ops.edit.edit_verify_indexed`` (one
edit-distance launch each), with the key lengths from
``_DevicePairVerifier.__init__`` and ``engine._start_key_upload``; the
wrappers keep the arrays and count nothing while the window runs.

Times are ``time.time_ns()``; the profiler's rows are put on the same
clock through one annotation (``bench.window``) whose start both sides
record.
"""

import contextlib
import functools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import roofline

Interval = Tuple[int, int]


@dataclass
class DeviceEvent:
    name: str
    start: int
    end: int
    kind: str                          # "kernel", "copy" or "set"


@dataclass
class Launch:
    """One kernel launch as its wrapper saw it: the index arrays it was
    given (held, not copied, so that the timed path does no more work)
    and the key length (kernel 3) or every key's length (kernel 4).  The
    problem's bytes are counted from them after the window
    (:func:`benchmark.roofline.launch_bytes`)."""
    kernel: str
    at: int
    rows_i: np.ndarray
    rows_j: np.ndarray
    lengths: object                    # int, or the keys' lengths


@dataclass
class Trace:
    """What a traced run recorded; the per-layer readers take this."""
    jobs: List[Interval] = field(default_factory=list)       # window jobs
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    launches: List[Launch] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)   # window
    device: List[DeviceEvent] = field(default_factory=list)
    traced: Interval = (0, 0)          # t0 (before the first job) -> end
    window: Interval = (0, 0)

    def in_window(self, start: int, end: int) -> bool:
        return self.window[0] <= start and end <= self.window[1]

    def window_device(self, kind: Optional[str] = None,
                      names=None) -> List[DeviceEvent]:
        return [e for e in self.device
                if self.in_window(e.start, e.end)
                and (kind is None or e.kind == kind)
                and (names is None or roofline.matches(e.name, names))]

    def job_layers(self) -> List[Dict[str, Interval]]:
        """Each window job's layer intervals: pass1 (job start -> pair
        generation), pairs, dissect (-> pass 3), pass3."""
        out = []
        for start, end in self.jobs:
            inside = [(n, s, e) for n, s, e in self.spans
                      if start <= s and e <= end]
            pairs = [(s, e) for n, s, e in inside if n == "pairs"]
            pass3 = [(s, e) for n, s, e in inside if n == "pass3"]
            if not pairs or not pass3:
                continue
            out.append({"pass1": (start, pairs[0][0]),
                        "pairs": (pairs[0][0], pairs[-1][1]),
                        "dissect": (pairs[-1][1], pass3[0][0]),
                        "pass3": (pass3[0][0], pass3[-1][1])})
        return out


def busy_intervals(events: List[DeviceEvent], lo: int, hi: int
                   ) -> List[Interval]:
    """The union of the events' intervals, clipped to [lo, hi]."""
    spans = sorted((max(e.start, lo), min(e.end, hi)) for e in events
                   if e.end > lo and e.start < hi)
    merged: List[List[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Tracer:
    """Wraps the port's layer calls for one traced run; ``close`` puts
    every wrapped name back."""

    def __init__(self):
        self.trace = Trace()
        self._undo: List[Callable[[], None]] = []
        self._edit_lens: Optional[np.ndarray] = None

    def _patch(self, owner, name: str, make: Callable) -> None:
        original = getattr(owner, name)
        setattr(owner, name, make(original))
        self._undo.append(lambda: setattr(owner, name, original))

    def _span(self, label: str):
        def make(original):
            @functools.wraps(original)
            def wrapped(*args, **kwargs):
                start = time.time_ns()
                try:
                    return original(*args, **kwargs)
                finally:
                    self.trace.spans.append((label, start, time.time_ns()))
            return wrapped
        return make

    def install(self) -> None:
        from fastqdedup_tpu_torch import engine, pipeline
        from fastqdedup_tpu_torch.ops import bucket, edit

        self._patch(pipeline, "build_partition_groups", self._span("pairs"))
        self._patch(pipeline, "_write_from_record_store",
                    self._span("pass3"))
        self._patch(pipeline, "_filter_and_write", self._span("pass3"))
        launches = self.trace.launches

        def verifier_init(original):
            @functools.wraps(original)
            def wrapped(verifier, matrix, *args, **kwargs):
                original(verifier, matrix, *args, **kwargs)
                verifier._bench_key_length = int(matrix.shape[1])
            return wrapped

        def verifier_verify(original):
            @functools.wraps(original)
            def wrapped(verifier, gi, gj):
                if len(gi):
                    launches.append(Launch(
                        "rowwise_within_packed", time.time_ns(), gi, gj,
                        verifier._bench_key_length))
                return original(verifier, gi, gj)
            return wrapped

        def key_upload(original):
            @functools.wraps(original)
            def wrapped(keys, lens, *args, **kwargs):
                self._edit_lens = lens
                return original(keys, lens, *args, **kwargs)
            return wrapped

        def edit_verify(original):
            @functools.wraps(original)
            def wrapped(keys_dev, lens_dev, cand_i, cand_j, *args, **kwargs):
                if len(cand_i) and self._edit_lens is not None:
                    launches.append(Launch(
                        "banded_within_edit_distance", time.time_ns(),
                        cand_i, cand_j, self._edit_lens))
                return original(keys_dev, lens_dev, cand_i, cand_j,
                                *args, **kwargs)
            return wrapped

        self._patch(bucket._DevicePairVerifier, "__init__", verifier_init)
        self._patch(bucket._DevicePairVerifier, "verify", verifier_verify)
        self._patch(engine, "_start_key_upload", key_upload)
        self._patch(edit, "edit_verify_indexed", edit_verify)

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()


def launch_counts() -> Dict[str, int]:
    """The port's launch counters, real work and warm-up apart."""
    from fastqdedup_tpu_torch.ops import edit_kernels, hamming_kernels
    from fastqdedup_tpu_torch.ops.kernel_lib import WARMUP_LAUNCHES

    counts = {**hamming_kernels.LAUNCHES, **edit_kernels.LAUNCHES}
    return {**counts, **{f"warmup:{k}": v
                         for k, v in WARMUP_LAUNCHES.items()}}


def device_events(prof, window_start_ns: int) -> List[DeviceEvent]:
    """The profiler's device rows on the clock of ``time.time_ns()``: the
    ``bench.window`` annotation started at ``window_start_ns``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    marks = [e.start_ns() for e in events if e.name() == "bench.window"
             and e.device_type() == DeviceType.CPU]
    shift = window_start_ns - marks[0] if marks else 0
    out = []
    for e in events:
        kind_of = getattr(e, "activity_type", lambda: "")
        what = f"{kind_of()} {e.name()}".lower()
        if e.device_type() != DeviceType.CUDA or "annotation" in what \
                or e.name().startswith("bench."):
            continue
        kind = "copy" if "memcpy" in what else \
            "set" if "memset" in what else "kernel"
        start = e.start_ns() + shift
        out.append(DeviceEvent(e.name(), start, start + e.duration_ns(),
                               kind))
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` over CPU and CUDA activity, or nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].replace("void ", "").strip()[:120]


def breakdown(trace: Trace) -> Dict[str, List]:
    """The device operations that took the most time in the traced run,
    and its longest idle gaps labelled by the layer the host was in."""
    lo, hi = trace.traced
    totals: Dict[str, float] = {}
    for e in trace.device:
        if e.end > lo and e.start < hi:
            key = _short(e.name)
            totals[key] = totals.get(key, 0.0) + (e.end - e.start) / 1e9
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    busy = busy_intervals(trace.device, lo, hi)
    edges = [lo] + [t for span in busy for t in span] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    # What the host was doing: the first two jobs, then each window
    # job's layers, and the time between jobs.
    segments = [("first and warm job", lo, trace.window[0])]
    cursor = trace.window[0]
    for job, (start, end) in zip(trace.job_layers(), trace.jobs):
        segments.append(("between jobs", cursor, start))
        segments += [(name, s, e) for name, (s, e) in job.items()]
        segments.append(("end of job", job["pass3"][1], end))
        cursor = end
    segments.append(("between jobs", cursor, hi))
    pieces = [(min(g1, e) - max(g0, s), name)
              for g0, g1 in gaps for name, s, e in segments
              if min(g1, e) > max(g0, s)]
    longest = sorted(pieces, reverse=True)[:10]
    return {"device_ops": [[name, secs] for name, secs in ops],
            "idle_gaps": [[name, ns / 1e9] for ns, name in longest]}
