"""Split ingest of one BGZF file (``pipeline._plan_split_ranges``).

One host reading one BGZF file cuts it at member boundaries without
inflating anything; each range reader finds its own first record (the
first line after a newline that starts with '@' and whose next-but-one
line starts with '+') and stops exactly where the next reader starts
(``native/_fastq_io_port.c``).  Records take provisional positions per
reader and are mapped to exact ordinals once pass 1 has drained.

Held here: every seam of inputs written in tiny BGZF members (mid-line,
on a line start, on a record start, with quality lines that start with
'@' or '+'); the outputs against serial ingest and against the JAX
package for 2-8 readers in both pass-3 layouts; inputs that keep their
path (several files, plain gzip, one reader); malformed input, which
never gives another output than the serial reader's; the position map
against the counted plan's record ranges; and the plan each input
takes (``pipeline._plan_pass1``).
"""

import gzip
import random

import numpy as np
import pytest

from fastqdedup_tpu.pipeline import deduplicate_cluster as jax_dedup
from fastqdedup_tpu_torch import pipeline
from fastqdedup_tpu_torch.io.bgzf import BGZF_EOF, compress_block
from fastqdedup_tpu_torch.io.fastq import FastqFormatError
from fastqdedup_tpu_torch.native import loader
from fastqdedup_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _records(n, seed, first_chars="IJ@+", seq_first=None):
    """FASTQ text of ``n`` duplicate-heavy records; quality lines start
    with one of ``first_chars``; ``seq_first`` prefixes every sequence."""
    rng = random.Random(seed)
    molecules = ["".join(rng.choice("ACGT") for _ in range(rng.randrange(8, 30)))
                 for _ in range(max(1, n // 4))]
    out = []
    for i in range(n):
        seq = rng.choice(molecules)
        if rng.random() < 0.3:
            pos = rng.randrange(len(seq))
            seq = seq[:pos] + rng.choice("ACGT") + seq[pos + 1:]
        if seq_first:
            seq = seq_first + seq[1:]
        qual = rng.choice(first_chars) + "".join(
            rng.choice("5?IJ@+") for _ in range(len(seq) - 1))
        out.append(f"@r{i} c{rng.randrange(9)}\n{seq}\n+\n{qual}\n")
    return "".join(out).encode()


def _line_starts(data):
    return [0] + [i + 1 for i, c in enumerate(data[:-1]) if c == 0x0A]


def _cuts(data, layout, seed=0):
    """Offsets at which the BGZF members of ``data`` start."""
    lines = _line_starts(data)
    if layout == "mid_line":
        cuts = list(range(0, len(data), 7))
    elif layout == "line_starts":
        cuts = lines
    elif layout == "record_starts":
        cuts = lines[::4]
    elif layout == "sequence_lines":
        # Inside every sequence line: after each member's first newline
        # come the separator, the quality line, then the next header.
        cuts = [0] + [start + 1 for start in lines[1::4]]
    else:
        rng = random.Random(seed)
        cuts = sorted({0, *rng.sample(range(1, len(data)), len(data) // 40)})
    return sorted(set(cuts))


def _write_bgzf(path, data, cuts):
    """``data`` as one BGZF member per cut; returns each member's offset."""
    offsets = []
    with open(path, "wb") as f:
        for lo, hi in zip(cuts, cuts[1:] + [len(data)]):
            offsets.append(f.tell())
            f.write(compress_block(data[lo:hi], 1))
        f.write(BGZF_EOF)
    return offsets


def _parse(path, **kwargs):
    """(header, sequence, quality) of each record the reader yields."""
    out = []
    for c in loader.read_fastq_chunks_native(path, 5, **kwargs):
        for i in range(c.count):
            out.append((bytes(c.headers[c.header_offsets[i]:
                                        c.header_offsets[i + 1]]),
                        bytes(c.sequences[c.offsets[i]:c.offsets[i + 1]]),
                        bytes(c.qualities[c.offsets[i]:c.offsets[i + 1]])))
    return out


@pytest.mark.parametrize("layout", ["mid_line", "line_starts",
                                    "record_starts", "random"])
def test_every_seam_reads_each_record_once(tmp_path, layout):
    """Two readers meeting at each member boundary in turn, and three at
    pairs of them, read the serial reader's records once each, in order.
    Quality lines start with '@' or '+' in about half the records."""
    data = _records(60, seed=len(layout))
    path = str(tmp_path / "in.fastq.gz")
    members = _write_bgzf(path, data, _cuts(data, layout))
    serial = _parse(path)
    assert len(serial) == 60
    for b in members[1:]:
        assert _parse(path, split=(0, b)) + _parse(path, split=(b, -1)) \
            == serial, b
    rng = random.Random(3)
    for _ in range(20):
        b1, b2 = sorted(rng.sample(members[1:], 2))
        assert (_parse(path, split=(0, b1)) + _parse(path, split=(b1, b2))
                + _parse(path, split=(b2, -1))) == serial, (b1, b2)


def test_record_start_takes_the_header_after_the_first_newline(tmp_path):
    """``bgzf_record_start`` from a member that begins at each byte of
    the data: the next header after the first newline, with its bytes."""
    data = (b"@a 1\nACGT\n+\n@@+I\n"     # quality line starting with '@'
            b"@b 2\nAC\n+\n+@\n"         # and with '+'
            b"@c 3\nGGA\n+x\nIII\n")
    headers = [i for i in _line_starts(data) if data[i:i + 1] == b"@"
               and data[i + 1:i + 2] in b"abc"]
    for start in range(1, len(data)):
        path = str(tmp_path / f"at{start}.fastq.gz")
        members = _write_bgzf(path, data, [0, start])
        found = loader.bgzf_record_start(path, members[1])
        newline = data.index(b"\n", start) + 1
        later = [h for h in headers if h >= newline]
        if not later:
            assert found is None, start
            continue
        t, head = found
        assert start + t == later[0], start
        assert bytes(head) == data[start:later[0]]


@pytest.fixture(scope="module")
def dense_input(tmp_path_factory):
    """A 3,000-record input in small members, and the JAX package's
    output for it (its own counted range readers)."""
    root = tmp_path_factory.mktemp("split")
    data = _records(3_000, seed=11)
    path = str(root / "in.fastq.gz")
    _write_bgzf(path, data, _cuts(data, "random", seed=5)[::8])
    want = str(root / "jax.fastq.gz")
    jax_dedup([path], [want], None, 1, 1.0, chunk_records=97)
    with gzip.open(want) as f:
        return path, f.read()


def _torch_run(path, out, monkeypatch, env, chunk_records=97):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    before = trace.counts()
    pipeline.deduplicate_cluster([path], [out], None, 1, 1.0,
                                 chunk_records=chunk_records)
    after = trace.counts()
    with gzip.open(out) as f:
        return f.read(), {k: after[k] - before.get(k, 0) for k in after}


# The record arena, and the arena over its budget: pass 3 re-streams.
LAYOUTS = {
    "arena": {},
    "arena_abandoned": {"FASTQDEDUP_MEMORY_LIMIT": "1"},
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("readers", [2, 3, 4, 5, 8])
def test_outputs_match_serial_ingest_and_jax(tmp_path, monkeypatch,
                                             dense_input, readers, layout):
    path, want = dense_input
    serial, _ = _torch_run(path, str(tmp_path / "serial.fastq.gz"),
                           monkeypatch,
                           {**LAYOUTS[layout],
                            "FASTQDEDUP_INGEST_READERS": "1"})
    split, moved = _torch_run(path, str(tmp_path / "split.fastq.gz"),
                              monkeypatch,
                              {"FASTQDEDUP_INGEST_READERS": str(readers)})
    assert moved.get("pass1.parts.split", 0) > 1
    assert moved.get("pass1.parts.counted", 0) == 0
    assert split == serial == want and want


def test_fewer_records_than_readers(tmp_path, monkeypatch):
    data = _records(3, seed=2)
    path = str(tmp_path / "in.fastq.gz")
    _write_bgzf(path, data, _cuts(data, "mid_line"))
    want = str(tmp_path / "jax.fastq.gz")
    jax_dedup([path], [want], None, 1, 1.0)
    got, moved = _torch_run(path, str(tmp_path / "out.fastq.gz"),
                            monkeypatch,
                            {"FASTQDEDUP_INGEST_READERS": "8"})
    assert moved.get("pass1.parts.split", 0) > 3
    with gzip.open(want) as f:
        assert got == f.read()


@pytest.mark.parametrize("case", ["paired", "three_files", "plain_gzip",
                                  "one_reader"])
def test_other_inputs_keep_their_path(tmp_path, monkeypatch, case):
    """Several files zip by record (the counted plan), plain gzip has no
    members to split, one reader reads serially: the JAX package's
    bytes, and no part opened at a member split."""
    n_files = {"paired": 2, "three_files": 3}.get(case, 1)
    paths = []
    for k in range(n_files):
        data = _records(800, seed=40 + k)
        path = str(tmp_path / f"in{k}.fastq.gz")
        if case == "plain_gzip":
            with gzip.open(path, "wb") as f:
                f.write(data)
        else:
            _write_bgzf(path, data, _cuts(data, "random", seed=k)[::6])
        paths.append(path)
    env = {"one_reader": {"FASTQDEDUP_INGEST_READERS": "1"}}.get(
        case, {"FASTQDEDUP_INGEST_READERS": "4"})
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    want = [str(tmp_path / f"jax{k}.fastq.gz") for k in range(n_files)]
    got = [str(tmp_path / f"torch{k}.fastq.gz") for k in range(n_files)]
    jax_dedup(paths, want, None, 1, 1.0, chunk_records=61)
    before = trace.counts()
    pipeline.deduplicate_cluster(paths, got, None, 1, 1.0, chunk_records=61)
    after = trace.counts()
    moved = {k: after[k] - before.get(k, 0) for k in after}
    assert moved.get("pass1.parts.split", 0) == 0
    assert (moved.get("pass1.parts.counted", 0) > 1) == (n_files > 1)
    for w, g in zip(want, got):
        with gzip.open(w) as a, gzip.open(g) as b:
            assert a.read() == b.read()


def test_seam_that_is_not_a_record_start_never_changes_the_output(
        tmp_path, monkeypatch):
    """Every sequence starts with '+' and every quality line with '@', so
    the rule takes a quality line for a header at a seam inside a
    sequence line.  The serial parser reads such input; the split reader
    before the seam ends in a cut record and refuses it, and the job
    reads pass 1 again serially: the serial reader's bytes."""
    data = _records(400, seed=8, first_chars="@", seq_first="+")
    path = str(tmp_path / "in.fastq.gz")
    members = _write_bgzf(path, data, _cuts(data, "sequence_lines")[::9])
    with pytest.raises(FastqFormatError):
        _parse(path, split=(0, members[1]))
    calls = []
    inner = pipeline._deduplicate_cluster_impl

    def spy(*args, **kwargs):
        calls.append(kwargs.get("split_ingest", True))
        return inner(*args, **kwargs)

    monkeypatch.setattr(pipeline, "_deduplicate_cluster_impl", spy)
    for tag, layout in LAYOUTS.items():
        with monkeypatch.context() as m:
            serial, _ = _torch_run(path, str(tmp_path / f"s{tag}.fastq.gz"),
                                   m, {**layout,
                                       "FASTQDEDUP_INGEST_READERS": "1"})
        with monkeypatch.context() as m:
            calls.clear()
            split, moved = _torch_run(path, str(tmp_path / f"{tag}.fastq.gz"),
                                      m, {**layout,
                                          "FASTQDEDUP_INGEST_READERS": "4"})
        assert calls == [True, False], tag
        assert moved.get("pass1.parts.split", 0) > 1
        assert split == serial and serial, tag


@pytest.mark.parametrize("where", ["first_part", "last_part"])
def test_malformed_input_raises_the_serial_error(tmp_path, monkeypatch,
                                                 where):
    """A record with sequence and quality of different lengths: the
    serial parser's FastqFormatError, with its line, not a reader's."""
    records = _records(600, seed=9).split(b"\n")
    bad = 4 * (30 if where == "first_part" else 570) + 3
    records[bad] = records[bad] + b"I"
    data = b"\n".join(records)
    path = str(tmp_path / "in.fastq.gz")
    _write_bgzf(path, data, _cuts(data, "random", seed=2)[::4])
    errors = []
    for env in ({"FASTQDEDUP_INGEST_READERS": "1"},
                {"FASTQDEDUP_INGEST_READERS": "4"}):
        with monkeypatch.context() as m:
            with pytest.raises(FastqFormatError) as caught:
                _torch_run(path, str(tmp_path / "out.fastq.gz"), m, env)
        errors.append((str(caught.value), caught.value.line))
    assert errors[0] == errors[1]
    assert errors[0][1] == bad


@pytest.mark.parametrize("n_parts", [2, 3, 4, 7])
def test_provisional_positions_map_to_the_counted_plan(tmp_path, n_parts):
    """Positions ``(p << shift) + local`` of the counted plan's parts,
    with its record counts, map to its ``base + local``; and inside one
    shard's stride under a shard base."""
    data = _records(2_000, seed=n_parts)
    path = str(tmp_path / "in.fastq.gz")
    _write_bgzf(path, data, _cuts(data, "random", seed=n_parts)[::3])
    parts = pipeline._plan_local_ranges([path], n_parts)
    assert parts is not None and len(parts) == n_parts
    counts = np.array([plan[0][2] for plan, _ in parts])
    shift = pipeline._split_shift(n_parts)
    assert (n_parts - 1) << shift < pipeline._SHARD_STRIDE
    offsets = pipeline._split_offsets(counts, shift)
    for shard_base in (0, 3 * pipeline._SHARD_STRIDE):
        provisional = np.concatenate([
            shard_base + (p << shift) + np.arange(n, dtype=np.int64)
            for p, n in enumerate(counts)])
        pipeline._exact_positions(provisional, offsets, shift, shard_base)
        exact = np.concatenate([
            shard_base + base + np.arange(plan[0][2], dtype=np.int64)
            for plan, base in parts])
        assert np.array_equal(provisional, exact)
    with pytest.raises(RuntimeError):
        pipeline._split_offsets(np.array([1, 1 << shift]), shift)


def test_split_plan_reads_the_file_in_order(tmp_path):
    """The plan's parts, each read by its own reader, are the serial
    records in order, and their counts give the exact ordinals."""
    data = _records(2_500, seed=4)
    path = str(tmp_path / "in.fastq.gz")
    _write_bgzf(path, data, _cuts(data, "random", seed=1)[::5])
    splits = pipeline._plan_split_ranges(path, 4)
    assert len(splits) == 4 and splits[0].lo == 0 and splits[-1].hi == -1
    assert all(a.hi == b.lo for a, b in zip(splits, splits[1:]))
    parts = [_parse(path, split=part) for part in splits]
    assert sum(parts, []) == _parse(path)
    assert pipeline._plan_split_ranges(str(tmp_path / "missing"), 4) is None
    plain = str(tmp_path / "plain.fastq.gz")
    with gzip.open(plain, "wb") as f:
        f.write(data)
    assert pipeline._plan_split_ranges(plain, 4) is None


def _made_up_run(counts_by_job):
    """A traced run of two window jobs whose ``pass1.plan`` spans hold
    ``counts_by_job``, and a job before the window that counted 7 parts."""
    from benchmark.trace import Trace
    ms = 10 ** 6
    run = Trace(traced=(0, 1000 * ms), window=(200 * ms, 1000 * ms),
                jobs=[(200 * ms, 600 * ms), (600 * ms, 1000 * ms)])
    spans = []
    for job, (lo, counts) in enumerate(
            [(0, {"pass1.parts.counted": 7})]
            + list(zip((200, 600), counts_by_job))):
        for name, start, end in (("job", lo, lo + 400),
                                 ("pass1.plan", lo + 1, lo + 2)):
            s = trace.Span(name)
            s.start, s.end, s.job = start * ms, end * ms, job + 1
            s.counts = counts if name == "pass1.plan" else {}
            spans.append(s)
    return run, spans


@pytest.mark.parametrize("counts,share", [
    (({"pass1.parts.split": 4}, {"pass1.parts.split": 4}), 100.0),
    (({"pass1.parts.split": 4}, {"pass1.parts.counted": 2}), 200 / 3),
    (({"pass1.parts.counted": 3}, {}), 0.0),
    (({}, {}), None),
])
def test_split_share_reads_the_window_counters(monkeypatch, counts, share):
    from benchmark import harness
    run, spans = _made_up_run(counts)
    monkeypatch.setattr(trace, "spans", lambda: spans)
    got = harness.read_metric("pass1.split_share", run)
    assert got == (pytest.approx(share) if share is not None else None)


def test_split_share_in_a_traced_cpu_run_of_the_cell(tmp_path):
    """The cell's own input through the harness on the CPU device, in a
    child process (the harness refuses a run that loaded jax): every part
    of every window job opened at a member split."""
    import json
    import os
    import subprocess
    import sys

    code = """
import json, os, tempfile
from benchmark import harness
tempfile.tempdir = os.environ["SPLIT_TMP"]
bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
config = dict(harness.load_json(os.path.join(
    harness.BENCH, "configs", "hamming-d1.json")), reads_per_job=20_000)
cell = harness.Cell(
    "hamming-d1.dense", config,
    harness.load_json(os.path.join(harness.BENCH, "traffic", "dense.json")),
    1, [m for m in bench["end_to_end"] if "workloads" not in m],
    [m for m in bench["per_layer"] if m["name"] == "pass1.split_share"])
result = harness.run_cell(cell, 2**31 + 7, 0.5, True,
                          harness.process_start(), require_cuda=False)
print(json.dumps([result["correct"], result["metrics"]]))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "SPLIT_TMP": str(tmp_path),
           "FASTQDEDUP_TORCH_DEVICE": "cpu"}
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    correct, metrics = json.loads(done.stdout.strip().splitlines()[-1])
    assert correct
    assert metrics["pass1.split_share"]["value"] == 100.0


@pytest.mark.parametrize("case", ["one_file", "sharded_input", "two_files",
                                  "plain_gzip", "one_reader",
                                  "split_ingest_off"])
def test_pass1_plan_of_each_input(tmp_path, monkeypatch, case):
    """``_plan_pass1`` on one host, or one process of a sharded-input
    job: one BGZF file splits at member boundaries, several files take
    the counted plan, and plain gzip, one reader or split ingest turned
    off read serially.  Its counters name the plan."""
    n_files = 2 if case == "two_files" else 1
    paths = []
    for k in range(n_files):
        data = _records(500, seed=70 + k)
        path = str(tmp_path / f"in{k}.fastq.gz")
        if case == "plain_gzip":
            with gzip.open(path, "wb") as f:
                f.write(data)
        else:
            _write_bgzf(path, data, _cuts(data, "random", seed=k)[::4])
        paths.append(path)
    monkeypatch.setenv("FASTQDEDUP_INGEST_READERS",
                       "1" if case == "one_reader" else "3")
    pid, nproc = (1, 2) if case == "sharded_input" else (0, 1)
    before = trace.counts()
    plan = pipeline._plan_pass1(paths, pid, nproc, case == "sharded_input",
                                case != "split_ingest_off")
    after = trace.counts()
    moved = {k: after[k] - before.get(k, 0) for k in after
             if k.startswith("pass1.parts.")}
    moved = {k: v for k, v in moved.items() if v}
    assert plan.range_plan is None and plan.range_base == 0
    parts = plan.parallel_parts
    if case in ("plain_gzip", "one_reader", "split_ingest_off"):
        assert parts is None and plan.split_shift is None and not moved
        return
    assert len(parts) == 3
    if case == "two_files":
        assert plan.split_shift is None
        assert moved == {"pass1.parts.counted": 3}
        assert [base for _, base in parts] == sorted(
            base for _, base in parts)
        assert sum(per_file[0][2] for per_file, _ in parts) == 500
        assert all(len(per_file) == 2 for per_file, _ in parts)
        return
    assert moved == {"pass1.parts.split": 3}
    assert plan.split_shift == pipeline._split_shift(3)
    assert [base for _, base in parts] == \
        [p << plan.split_shift for p in range(3)]
    assert sum((_parse(paths[0], split=per_file[0])
                for per_file, _ in parts), []) == _parse(paths[0])
