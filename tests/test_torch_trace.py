"""The port's span-and-counter recorder (``fastqdedup_tpu_torch/utils/
trace.py``) on the CPU device, and the benchmark's readers of what it
records (``benchmark/program_spans.py``, ``benchmark/metrics/``).

Off (no profiler, no DEBUG) a run keeps no span and still counts.  Under
``torch.profiler`` every span of a run carries its parent, the run's job
id and its thread, lies inside its job, and holds only str and int
values; the outputs are the same bytes on and off.  Each reader gives
its value on a made-up trace and nothing where its spans are absent.
The spans only the card gives (``device.wait`` from a real event, the
prewarm thread's ``warmup.*``, the edit route's ``pairs.key_upload_wait``)
are absent from a run here; the first two are held here with stand-ins,
and all three on the card by ``tests/test_torch_cuda.py``.
"""

import logging
import random
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, program_spans
from benchmark.trace import Trace
from fastqdedup_tpu_torch import pipeline
from fastqdedup_tpu_torch.io.bgzf import BgzfWriter
from fastqdedup_tpu_torch.ops import bucket, transfer
from fastqdedup_tpu_torch.utils import trace

# Each span of the program, with the spans that may be its parent
# (None: the outermost).
PARENTS = {
    "job": {None},
    "pass1": {"job"},
    "pass1.plan": {"pass1"},
    "pass1.read": {"pass1"},
    "pass1.keys": {"pass1"},
    "pass1.drain": {"pass1"},
    "pass1.quality": {"pass1"},
    "pass1.accumulate": {"pass1"},
    "pass1.render": {"pass1.accumulate"},
    "pass2.finalize": {"job"},
    "warmup.join": {"job"},
    "pairs": {"job"},
    "pairs.alphabet": {"pairs"},
    "pairs.edges": {"pairs"},
    "pairs.labels": {"pairs"},
    "pairs.assemble": {"pairs"},
    "pairs.hash": {"pairs.edges"},
    "pairs.group": {"pairs.edges"},
    "pairs.host_verify": {"pairs.edges"},
    "pairs.device_verify": {"pairs.edges"},
    "pairs.drain": {"pairs.edges", "pairs.device_verify"},
    "pairs.oversized": {"pairs.edges"},
    "pairs.dedup": {"pairs.edges"},
    "pairs.pad": {"pairs.edges"},
    "pairs.candidates": {"pairs.edges"},
    "pairs.edit_verify": {"pairs.edges"},
    "pairs.key_upload_wait": {"pairs.candidates"},
    "pass2.dissect": {"job"},
    "dissect.singletons": {"pass2.dissect"},
    "dissect.two_member": {"pass2.dissect"},
    "dissect.batched": {"pass2.dissect"},
    "dissect.large": {"pass2.dissect"},
    "pass3": {"job"},
    "pass3.emit_set": {"pass3"},
    "pass3.read": {"pass3"},
    "pass3.render": {"pass3"},
    "pass3.writer_wait": {"pass3"},
}
# Spans a run on the CPU device cannot open: the card's waits, the
# thread that brings it up (held below with stand-ins) and the wait for
# the edit route's key matrix (held by tests/test_torch_cuda.py).
CARD_ONLY = {"warmup.join", "device.wait", "warmup.context",
             "warmup.library", "warmup.launches", "pairs.key_upload_wait"}
WORKER_SPANS = {"pass1.quality", "pass1.accumulate", "pass1.render"}
FIELDS = ("name", "start", "end", "id", "parent", "job", "thread")

HOST_ROUTE = {"FASTQDEDUP_DISPATCH_S": "1e3", "FASTQDEDUP_H2D_RATE": "1e-9"}
PAIR_LIST_ROUTE = {"FASTQDEDUP_DISPATCH_S": "1e-9",
                   "FASTQDEDUP_H2D_RATE": "1e15",
                   "FASTQDEDUP_HOST_RATE": "1.0"}
BUCKET_ROUTE = {"FASTQDEDUP_DISPATCH_S": "1e-9",
                "FASTQDEDUP_H2D_RATE": "1e-9"}

# Configuration -> (environment, edit distance, sizes of groups of reads
# that share their first half (one bucket each), spans it must open,
# spans it cannot open).
RUNS = {
    "host-route": (HOST_ROUTE, False, (), {
        "pairs.host_verify", "pairs.hash", "pairs.group", "pairs.dedup"},
        set()),
    "pair-list-route": (PAIR_LIST_ROUTE, False, (), {
        "pairs.device_verify"}, set()),
    "bucket-route": (BUCKET_ROUTE, False, (3_000, 400), {
        "pairs.device_verify", "pairs.drain", "pairs.oversized"}, set()),
    "edit": ({}, True, (), {
        "pairs.pad", "pairs.candidates", "pairs.edit_verify"}, set()),
    "re-stream": ({**HOST_ROUTE, "FASTQDEDUP_MEMORY_LIMIT": "1"}, False, (),
                  {"pass3.read"}, set()),
}
EVERY_RUN = set(PARENTS) - CARD_ONLY - {
    name for _, _, _, opened, _ in RUNS.values() for name in opened} - {
    "pairs.hash", "pairs.group", "pairs.dedup"}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")
    for key in ("FASTQDEDUP_INGEST_READERS", "FASTQDEDUP_MEMORY_LIMIT"):
        monkeypatch.delenv(key, raising=False)
    logger = logging.getLogger("fastqdedup")
    level = logger.level
    logger.setLevel(logging.INFO)
    bucket._dispatch_cache.clear()
    bucket._h2d_rate_cache.clear()
    trace.clear()
    yield
    logger.setLevel(level)
    bucket._dispatch_cache.clear()
    bucket._h2d_rate_cache.clear()
    trace.clear()


def _reads(n, buckets=(), length=30, seed=3):
    """``n`` near-duplicate reads (30 copies of a molecule, half of them
    with one substitution), a fifth of them with a low-quality tail, and
    for each size in ``buckets`` that many reads that share their first
    half, in random order."""
    rng = random.Random(seed)

    def bases(k):
        return "".join(rng.choice("ACGT") for _ in range(k))

    molecules = [bases(length) for _ in range(max(8, n // 30))]
    seqs = []
    for _ in range(n):
        seq = rng.choice(molecules)
        if rng.random() < 0.5:
            pos = rng.randrange(length)
            seq = seq[:pos] + rng.choice("ACGT") + seq[pos + 1:]
        seqs.append(seq)
    for size in buckets:
        half = bases(length // 2)
        seqs += [half + bases(length - len(half)) for _ in range(size)]
    rng.shuffle(seqs)
    out = []
    for i, seq in enumerate(seqs):
        qual = "I" * length if rng.random() < 0.8 else \
            "I" * (length - 6) + "#" * 6
        out.append(f"@r{i}\n{seq}\n+\n{qual}\n")
    return out


def _bgzf_input(tmp_path, n, buckets=()):
    path = str(tmp_path / f"in{n}_{len(buckets)}.fastq.gz")
    writer = BgzfWriter(path)
    try:
        for record in _reads(n, buckets):
            writer.write(record.encode())
    finally:
        writer.close()
    return path


def _run(src, out, edit=False):
    pipeline.deduplicate_cluster([src], [out], None, 1, 0.001,
                                 use_edit_distance=edit,
                                 chunk_records=4096)
    with open(out, "rb") as f:
        return f.read()


def _moved(before):
    after = trace.counts()
    return {k: v - before.get(k, 0) for k, v in after.items()}


def test_recorder_off_keeps_no_span_and_counts(tmp_path):
    src = _bgzf_input(tmp_path, 20_000)
    before = trace.counts()
    _run(src, str(tmp_path / "out.fastq.gz"))
    assert trace.spans() == []
    moved = _moved(before)
    assert moved["records.read"] == 20_000
    assert 0 < moved["records.filtered"] < 20_000
    assert 0 < moved["records.written"] < 20_000 - moved["records.filtered"]
    candidates = sum(moved.get(f"pairs.candidates.{side}", 0)
                     for side in ("host", "device"))
    kept = sum(moved.get(f"pairs.kept.{side}", 0)
               for side in ("host", "device"))
    assert 0 < kept <= candidates
    # The CPU device copies nothing.
    assert not moved.get("bytes.h2d") and not moved.get("bytes.d2h")


def _check_job(spans):
    """Every span of one run: its fields, its parent, one job id, and
    inside the job's interval.  Returns the names seen."""
    by_id = {s.id: s for s in spans}
    jobs = [s for s in spans if s.name == "job"]
    assert len(jobs) == 1
    job = jobs[0]
    for s in spans:
        assert all(isinstance(getattr(s, f), (str, int)) for f in FIELDS)
        assert all(isinstance(k, str) and isinstance(v, int)
                   for k, v in s.counts.items())
        assert s.job == job.job > 0, s
        assert job.start <= s.start <= s.end <= job.end, s
        parent = by_id[s.parent].name if s.parent else None
        assert parent in PARENTS[s.name], (s.name, parent)
    main = job.thread
    workers = {s.thread for s in spans if s.name in WORKER_SPANS}
    assert workers and main not in workers
    assert all(s.thread == main for s in spans
               if s.name not in WORKER_SPANS)
    return {s.name for s in spans}


@pytest.mark.parametrize("config", sorted(RUNS))
def test_profiler_records_each_span_under_its_parent(tmp_path, monkeypatch,
                                                     config):
    env, edit, buckets, opened, closed = RUNS[config]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    src = _bgzf_input(tmp_path, 4_000 if edit else 20_000, buckets)
    with profile(activities=[ProfilerActivity.CPU]):
        _run(src, str(tmp_path / "out.fastq.gz"), edit)
    names = _check_job(trace.spans())
    assert opened <= names, opened - names
    assert not names & CARD_ONLY, names & CARD_ONLY
    assert EVERY_RUN - closed <= names, EVERY_RUN - closed - names


def test_the_runs_open_every_span_a_cpu_run_can():
    opened = set().union(*(o for _, _, _, o, _ in RUNS.values()))
    assert EVERY_RUN | opened == set(PARENTS) - CARD_ONLY


def test_outputs_are_the_same_bytes_on_and_off(tmp_path, monkeypatch):
    """Parallel range ingest as it is by default, on an input that splits
    across range readers at member boundaries; off, under the profiler
    and under DEBUG."""
    src = _bgzf_input(tmp_path, 40_000)
    assert len(pipeline._plan_split_ranges(src, 4)) > 1
    parts = []
    inner = pipeline._parallel_range_chunks

    def spy(files, records, plan, *args, **kwargs):
        parts.append(sum(isinstance(entry, pipeline._Split)
                         for part, _ in plan for entry in part))
        return inner(files, records, plan, *args, **kwargs)

    monkeypatch.setattr(pipeline, "_parallel_range_chunks", spy)
    off = _run(src, str(tmp_path / "off.fastq.gz"))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _run(src, str(tmp_path / "on.fastq.gz"))
    assert {s.name for s in trace.spans()} >= {"pass1.read", "pass3"}
    logging.getLogger("fastqdedup").setLevel(logging.DEBUG)
    debug = _run(src, str(tmp_path / "debug.fastq.gz"))
    assert max(parts) > 1
    assert off == on == debug and len(off) > 0


def test_debug_logs_each_job_and_keeps_nothing(tmp_path, caplog):
    src = _bgzf_input(tmp_path, 20_000)
    with caplog.at_level(logging.DEBUG, logger="fastqdedup"):
        _run(src, str(tmp_path / "out.fastq.gz"))
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("spans of job")]
    assert len(lines) == 1
    assert " pass1 " in lines[0] and " pass3.writer_wait " in lines[0]
    assert "records.read 20000" in lines[0]
    assert any(r.getMessage().startswith("Key table length")
               for r in caplog.records)
    assert trace.spans() == []


def test_device_waits_are_spans():
    """The event wait of a copy back (``transfer.host_array``) and the
    device synchronize (``bucket._synchronize``), with stand-ins for the
    event and for ``torch.cuda.synchronize``."""
    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1

    copy = transfer.HostCopy(torch.arange(4), Event())
    real = torch.cuda.synchronize
    torch.cuda.synchronize = lambda dev=None: None
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("caller") as caller:
                assert transfer.host_array(copy).tolist() == [0, 1, 2, 3]
                bucket._synchronize(torch.device("cuda", 0))
                bucket._synchronize(torch.device("cpu"))
    finally:
        torch.cuda.synchronize = real
    waits = [s for s in trace.spans() if s.name == "device.wait"]
    assert Event.waited == 1 and len(waits) == 2
    assert all(s.parent == caller.id for s in waits)


def test_carry_hands_parent_and_job_to_a_thread():
    seen = []

    def work():
        with trace.span("worker") as worker:
            trace.count("carried", 2)
        seen.append(worker)

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.job() as job_id, trace.span("submitter") as submitter:
            thread = threading.Thread(target=trace.carry(work))
            thread.start()
            thread.join(timeout=30)
    assert not thread.is_alive()
    (worker,) = seen
    assert worker.parent == submitter.id and worker.job == job_id
    assert worker.thread != threading.current_thread().name
    assert worker.counts == {"carried": 2}
    # Off, the function goes over as it is.
    assert trace.carry(work) is work


def test_counts_lose_nothing_under_contention():
    threads, each = 16, 2_000
    before = trace.counts().get("stress", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("stress") as target:
                def add():
                    for _ in range(each):
                        trace.count("stress", 1)
                workers = [threading.Thread(target=trace.carry(add))
                           for _ in range(threads)]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    assert trace.counts()["stress"] - before == threads * each
    assert target.counts == {"stress": threads * each}


# ---------------------------------------------------------------------
# The benchmark's readers of the recorder

MS = 10 ** 6
NEW_METRICS = ("pass1.read_wait_s", "pass1.drain_s", "pass2.finalize_s",
               "pairs.device_wait_s", "pairs.kept_share",
               "pass3.writer_wait_s", "setup.warmup_wait_s",
               "host.fresh_mib")


def _span(name, start_ms, end_ms, job=1, **counts):
    s = trace.Span(name)
    s.start, s.end, s.job, s.counts = start_ms * MS, end_ms * MS, job, counts
    return s


def _made_up_run():
    """Two jobs before the window, two in it."""
    run = Trace(traced=(0, 1000 * MS), window=(200 * MS, 1000 * MS),
                jobs=[(200 * MS, 600 * MS), (600 * MS, 1000 * MS)])
    spans = [
        _span("job", 0, 100, 1), _span("warmup.join", 10, 40, 1),
        _span("job", 100, 200, 2), _span("warmup.join", 150, 155, 2),
        _span("job", 200, 600, 3, **{"pool.fresh_bytes": 8 << 20}),
        _span("pass1.read", 210, 230, 3), _span("pass1.read", 240, 250, 3),
        _span("pass1.drain", 300, 310, 3),
        _span("pass2.finalize", 310, 330, 3),
        _span("pairs", 340, 400, 3, **{
            "pairs.candidates.host": 100, "pairs.kept.host": 30}),
        _span("pairs.device_verify", 345, 399, 3, **{
            "pairs.candidates.device": 300, "pairs.kept.device": 170}),
        _span("device.wait", 350, 360, 3),
        _span("device.wait", 420, 425, 3),            # not in pairs
        _span("pass3.writer_wait", 500, 504, 3),
        _span("job", 600, 1000, 4, **{"pool.fresh_bytes": 4 << 20}),
        _span("pass1.read", 610, 620, 4), _span("pass1.drain", 700, 730, 4),
        _span("pass2.finalize", 730, 740, 4), _span("pairs", 750, 800, 4),
        _span("device.wait", 760, 790, 4),
        _span("pass3.writer_wait", 900, 906, 4),
    ]
    return run, spans


def test_each_reader_on_a_made_up_run(monkeypatch):
    run, spans = _made_up_run()
    monkeypatch.setattr(trace, "spans", lambda: spans)
    read = {name: harness.read_metric(name, run) for name in NEW_METRICS}
    assert read == {
        "pass1.read_wait_s": pytest.approx(0.020),
        "pass1.drain_s": pytest.approx(0.020),
        "pass2.finalize_s": pytest.approx(0.015),
        "pairs.device_wait_s": pytest.approx(0.020),
        "pairs.kept_share": pytest.approx(50.0),
        "pass3.writer_wait_s": pytest.approx(0.005),
        "setup.warmup_wait_s": pytest.approx(0.035),
        "host.fresh_mib": pytest.approx(6.0),
    }


@pytest.mark.parametrize("absent", ["recorder", "spans", "names"])
def test_each_reader_gives_nothing_where_its_spans_are_absent(monkeypatch,
                                                              absent):
    """No recorder in the program (as at a parent commit), a recorder
    that kept nothing, and spans of other names only."""
    run, spans = _made_up_run()
    if absent == "recorder":
        monkeypatch.setattr(program_spans, "recorded", lambda: None)
    else:
        kept = [] if absent == "spans" else [
            _span("job", s.start // MS, s.end // MS, s.job)
            for s in spans if s.name == "job"]
        monkeypatch.setattr(trace, "spans", lambda: kept)
    read = {name: harness.read_metric(name, run) for name in NEW_METRICS}
    if absent == "names":
        # The window's jobs are there but counted nothing new.
        assert read.pop("host.fresh_mib") == 0.0
    assert all(value is None for value in read.values()), read
