"""The readers of the edit route's program spans
(``pairs.edit_candidates_s``, ``pairs.edit_verify_s``,
``pairs.key_upload_wait_s``) on made-up traces: the mean seconds a
window job spends in its span, and nothing where no such span lies in
the window or the program has no recorder."""

from dataclasses import dataclass

import pytest

from benchmark import harness, program_spans
from benchmark.trace import Trace

MS = 10 ** 6
READERS = {"pairs.edit_candidates_s": "pairs.candidates",
           "pairs.edit_verify_s": "pairs.edit_verify",
           "pairs.key_upload_wait_s": "pairs.key_upload_wait"}


@dataclass
class Span:
    name: str
    start: int
    end: int


def _span(name, start_ms, end_ms):
    return Span(name, start_ms * MS, end_ms * MS)


def _run():
    """Two jobs before the window, two in it; each job's edit route
    (the second window job's in two length windows)."""
    run = Trace(traced=(0, 1000 * MS), window=(200 * MS, 1000 * MS),
                jobs=[(200 * MS, 600 * MS), (600 * MS, 1000 * MS)])
    spans = [_span("job", 0, 100), _span("pairs.candidates", 10, 90),
             _span("pairs.edit_verify", 90, 99),
             _span("pairs.key_upload_wait", 90, 95),
             _span("job", 100, 200)]
    for lo, edit in ((200, [(0, 100, 20, 5)]),
                     (600, [(0, 150, 25, 1), (200, 50, 5, 2)])):
        spans.append(_span("job", lo, lo + 400))
        spans.append(_span("pairs", lo + 10, lo + 390))
        for at, candidates, verify, wait in edit:
            t = lo + 20 + at
            spans.append(_span("pairs.candidates", t, t + candidates))
            t += candidates
            spans.append(_span("pairs.edit_verify", t, t + verify))
            spans.append(_span("pairs.key_upload_wait", t, t + wait))
    return run, spans


def _read(run):
    return {name: harness.read_metric(name, run) for name in READERS}


def test_each_reader_gives_the_mean_a_window_job(monkeypatch):
    run, spans = _run()
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    assert _read(run) == {
        "pairs.edit_candidates_s": pytest.approx((0.100 + 0.200) / 2),
        "pairs.edit_verify_s": pytest.approx((0.020 + 0.030) / 2),
        "pairs.key_upload_wait_s": pytest.approx((0.005 + 0.003) / 2),
    }


@pytest.mark.parametrize("absent", ["recorder", "spans", "window"])
def test_each_reader_gives_nothing_without_its_span(monkeypatch, absent):
    """No recorder (a program without one), no edit span at all (the
    Hamming routes; a parent without ``pairs.key_upload_wait``), and
    edit spans only before the window."""
    run, spans = _run()
    if absent == "recorder":
        kept = None
    elif absent == "spans":
        kept = [s for s in spans if s.name not in READERS.values()]
    else:
        kept = [s for s in spans if s.name not in READERS.values()
                or s.end <= run.window[0]]
    monkeypatch.setattr(program_spans, "recorded", lambda: kept)
    assert _read(run) == dict.fromkeys(READERS)


def test_a_parent_without_the_wait_span_reads_the_other_two(monkeypatch):
    run, spans = _run()
    kept = [s for s in spans if s.name != "pairs.key_upload_wait"]
    monkeypatch.setattr(program_spans, "recorded", lambda: kept)
    read = _read(run)
    assert read.pop("pairs.key_upload_wait_s") is None
    assert all(value > 0 for value in read.values())
