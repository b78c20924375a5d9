"""Spans and counters of the pipeline's layers.

One recorder for the whole port.  A span is a named interval of one
thread's work::

    with trace.span("pass1.read"):
        item = next(chunks)

and a counter is a process-wide total::

    trace.count("records.read", len(chunk))

**When it records.**  Counters always add to the process totals
(:func:`counts`), like the kernel wrappers' ``LAUNCHES``: one dict add
under a lock, once a chunk or a batch, never once a record.  Spans are
recorded only while a ``torch.profiler`` session records in this process
(read at each span's entry), or while the ``fastqdedup`` logger is
enabled for DEBUG (the CLI's ``-v``).  Otherwise :func:`span` returns a
context manager that does nothing: the cost is the flag reads at its
entry.

**What a span holds.**  Its name, its start and end in
``time.time_ns()`` (the wall clock, on which a profiler's device rows
can be placed), its own id, its parent's id (the innermost span open on
this thread when it opened; on a worker thread, the span that handed
the work over through :func:`carry`), the job id (a sequence number per
:func:`job`, shared by every span of one ``deduplicate_cluster`` call,
worker threads included), the thread's name, and the counts that
arrived while it was the innermost open span.  Only str and int values:
never an array, so a span keeps no buffer alive.

**Where spans go.**  While a profiler records they stay in memory until
the process reads them (:func:`spans`) or drops them (:func:`clear`).
Under DEBUG without a profiler, the end of each job logs one line with
each span name's total seconds and count and the job's counters, and
the job's spans are dropped.
"""

import contextlib
import functools
import itertools
import logging
import threading
import time
from typing import Callable, Dict, Iterator, List

import torch.autograd.profiler as _profiler

_logger = logging.getLogger("fastqdedup")

# Process totals of every counter, recorded or not.
COUNTS: Dict[str, int] = {}

_lock = threading.Lock()
_local = threading.local()          # .stack: open spans; .job: job id
_spans: List["Span"] = []
_span_ids = itertools.count(1)
_job_ids = itertools.count(1)


def recording() -> bool:
    """Whether spans opened now are recorded."""
    return _profiler._is_profiler_enabled \
        or _logger.isEnabledFor(logging.DEBUG)


def _stack() -> List["Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One recorded interval (see the module's docstring)."""

    __slots__ = ("name", "start", "end", "id", "parent", "job", "thread",
                 "counts")

    def __init__(self, name: str):
        self.name = name
        self.start = 0
        self.end = 0
        self.id = next(_span_ids)
        self.parent = 0
        self.job = getattr(_local, "job", 0)
        self.thread = threading.current_thread().name
        self.counts: Dict[str, int] = {}

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.job or _profiler._is_profiler_enabled:
            with _lock:
                _spans.append(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {(self.end - self.start) / 1e9:.6f}s,"
                f" id={self.id}, parent={self.parent}, job={self.job}, "
                f"thread={self.thread!r}, counts={self.counts})")


class _Off:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that records ``name`` around its block while the
    recorder is on, and does nothing otherwise."""
    return Span(name) if recording() else _OFF


def spanned(name: str) -> Callable[[Callable], Callable]:
    """A decorator: every call of the function inside ``span(name)``."""
    def decorate(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return decorate


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``; while a span is open on this
    thread (or was open where the work was carried from), to the
    innermost one that is still open too."""
    n = int(n)
    with _lock:
        COUNTS[name] = COUNTS.get(name, 0) + n
        stack = getattr(_local, "stack", None)
        if stack:
            for open_span in reversed(stack):
                if not open_span.end:
                    open_span.counts[name] = open_span.counts.get(name, 0) + n
                    break


def carry(fn: Callable) -> Callable:
    """``fn``, to be run on another thread as if inside the spans open
    here: its spans take the innermost of them as their parent and this
    job's id, and its counts go to the innermost that is still open.
    ``fn`` itself while the recorder is off."""
    if not recording():
        return fn
    stack = list(_stack())
    job_id = getattr(_local, "job", 0)

    def carried(*args, **kwargs):
        saved = getattr(_local, "stack", None), getattr(_local, "job", 0)
        _local.stack, _local.job = list(stack), job_id
        try:
            return fn(*args, **kwargs)
        finally:
            _local.stack, _local.job = saved

    return carried


@contextlib.contextmanager
def job() -> Iterator[int]:
    """One deduplication job: a new job id for every span opened inside
    (and on the threads its work is carried to), under a ``job`` span.
    Under DEBUG its end logs the job's span totals and counters."""
    ident = next(_job_ids)
    outer = getattr(_local, "job", 0)
    _local.job = ident
    debug = _logger.isEnabledFor(logging.DEBUG)
    before = counts() if debug else {}
    try:
        with span("job"):
            yield ident
    finally:
        _local.job = outer
        if debug:
            _report(ident, before)
            if not _profiler._is_profiler_enabled:
                with _lock:
                    _spans[:] = [s for s in _spans if s.job != ident]


def _report(ident: int, before: Dict[str, int]) -> None:
    with _lock:
        mine = [s for s in _spans if s.job == ident]
    totals: Dict[str, List[int]] = {}
    for s in sorted(mine, key=lambda s: s.start):
        entry = totals.setdefault(s.name, [0, 0])
        entry[0] += s.end - s.start
        entry[1] += 1
    moved = {k: v - before.get(k, 0) for k, v in counts().items()
             if v != before.get(k, 0)}
    _logger.debug(
        "spans of job %d (seconds, count): %s; counters: %s", ident,
        ", ".join(f"{name} {ns / 1e9:.3f} {n}"
                  for name, (ns, n) in totals.items()),
        ", ".join(f"{k} {v}" for k, v in sorted(moved.items())))


def counts() -> Dict[str, int]:
    """The process totals of every counter."""
    with _lock:
        return dict(COUNTS)


def spans() -> List[Span]:
    """The recorded spans, in the order they ended."""
    with _lock:
        return list(_spans)


def clear() -> None:
    """Drop every recorded span."""
    with _lock:
        _spans.clear()
