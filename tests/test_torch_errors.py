"""Error paths of the port's ingest and write stack, beside the JAX
package's (tests/test_error_injection.py and tests/test_review_fixes.py
on ``fastqdedup_tpu``).

Each case breaks one stage (BGZF inflate, the writer, the quality worker,
the mate check, the chunk prefetch) on the same input for both packages:
the port must raise what the JAX package raises, leave no thread behind,
and where the run succeeds write the same bytes.  The port runs on the
CPU device.  The 2-process case runs the port alone, under a time limit
of its own: a hang fails it.
"""

import gzip
import random
import struct
import threading
import time

import numpy as np
import pytest

import fastqdedup_tpu.pipeline as jax_pipeline
import fastqdedup_tpu_torch.pipeline as torch_pipeline
from fastqdedup_tpu_torch.io.bgzf import BGZF_EOF, BgzfWriter

from torch_two_process import run_two_processes

PIPELINES = (("jax", jax_pipeline), ("torch", torch_pipeline))


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _records(n, length=40, seed=5):
    rng = random.Random(seed)
    return "".join(
        f"@r{i} x\n{''.join(rng.choice('ACGT') for _ in range(length))}\n"
        f"+\n{'I' * length}\n" for i in range(n))


def _write_bgzf(path, text):
    with BgzfWriter(str(path), compresslevel=1) as f:
        f.write(text.encode())


def _write_gz(path, records):
    with gzip.open(path, "wt") as f:
        for name, seq, qual in records:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


def _read(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _corrupt_middle_block(path):
    """Flip 30 bytes of the deflate payload of the middle BGZF member
    (found through each member's BSIZE field); its header stays."""
    data = path.read_bytes()
    offsets, pos = [], 0
    while pos < len(data) - len(BGZF_EOF):
        assert data[pos:pos + 2] == b"\x1f\x8b", "not a BGZF member"
        offsets.append(pos)
        pos += struct.unpack_from("<H", data, pos + 16)[0] + 1
    assert len(offsets) > 10, "need a multi-block file"
    corrupted = bytearray(data)
    victim = offsets[len(offsets) // 2]
    for i in range(30, 60):
        corrupted[victim + i] ^= 0xFF
    path.write_bytes(bytes(corrupted))


def _assert_threads_settle(baseline, deadline_s=10.0):
    deadline = time.time() + deadline_s
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= baseline, (
        f"leaked threads: {[t.name for t in threading.enumerate()]}")


def _raised_by_both(call, expected):
    """Run ``call(pipeline module)`` for both packages; each must raise
    one of ``expected`` (matched by class name: each package has its own
    FastqFormatError) and settle its threads.  Returns the two
    exceptions."""
    raised = []
    for _, pipeline in PIPELINES:
        baseline = threading.active_count()
        with pytest.raises(Exception) as info:
            call(pipeline)
        assert type(info.value).__name__ in expected, repr(info.value)
        _assert_threads_settle(baseline)
        raised.append(info.value)
    assert type(raised[0]).__name__ == type(raised[1]).__name__
    return raised


def _same_bytes_from_both(inputs, outputs_of, *args, **kwargs):
    """Both packages' ``deduplicate_cluster`` on ``inputs``; returns the
    port's decompressed outputs after holding them against the JAX
    package's."""
    got = {}
    for tag, pipeline in PIPELINES:
        outs = outputs_of(tag)
        pipeline.deduplicate_cluster(inputs, outs, *args, **kwargs)
        got[tag] = [_read(o) for o in outs]
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_bgzf_corruption_midstream_fails_cleanly(tmp_path):
    """A corrupt deflate payload in a middle block raises on the caller
    while the inflate helpers and the producer shut down; the pipeline
    stays usable afterwards."""
    src = tmp_path / "in.fastq.gz"
    _write_bgzf(src, _records(60_000))
    _corrupt_middle_block(src)
    out = str(tmp_path / "out.fastq.gz")
    _raised_by_both(
        lambda pl: pl.deduplicate_cluster([str(src)], [out], None, 1, 1.0),
        ("OSError", "FastqFormatError"))
    good = tmp_path / "good.fastq.gz"
    _write_bgzf(good, _records(500))
    assert _same_bytes_from_both(
        [str(good)], lambda tag: [str(tmp_path / f"{tag}.fastq.gz")],
        None, 1, 1.0)[0]


def test_writer_failure_midstream_propagates(tmp_path, monkeypatch):
    """A write() that fails after the stream opened surfaces after the
    writer-thread join; it neither hangs nor is swallowed."""
    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wt") as f:
        f.write(_records(5_000))

    class FailsMidstream:
        def __init__(self, inner):
            self._inner = inner
            self._writes = 0

        def write(self, payload):
            self._writes += 1
            if self._writes >= 2:
                raise OSError("injected mid-stream write failure")
            return self._inner.write(payload)

        def close(self):
            self._inner.close()

    for _, pipeline in PIPELINES:
        real_xopen = pipeline.xopen

        def fake_xopen(path, mode="rb", _real=real_xopen, **kw):
            handle = _real(path, mode, **kw)
            return FailsMidstream(handle) if "w" in mode else handle

        monkeypatch.setattr(pipeline, "xopen", fake_xopen)
    # Tiny chunks force several writer payloads so write #2 exists.
    raised = _raised_by_both(
        lambda pl: pl.deduplicate_cluster(
            [str(src)], [str(tmp_path / "out.fastq.gz")], None, 1, 1.0,
            chunk_records=256), ("OSError",))
    assert all("injected mid-stream" in str(e) for e in raised)


def test_quality_pool_exception_races_shutdown(tmp_path):
    """An out-of-range phred byte in the last chunk raises ValueError
    through the quality worker and the accumulate worker to the caller
    while the producer thread is already winding down."""
    src = tmp_path / "in.fastq.gz"
    bad = f"@bad x\nACGTACGT\n+\n{'I' * 7}{chr(127)}\n"  # 127 > '~'
    with gzip.open(src, "wt") as f:
        f.write(_records(4_000) + bad)
    raised = _raised_by_both(
        lambda pl: pl.deduplicate_cluster(
            [str(src)], [str(tmp_path / "out.fastq.gz")], None, 1, 0.001,
            chunk_records=512), ("ValueError",))
    assert "phred" in str(raised[1])
    assert str(raised[0]) == str(raised[1])


def test_desynced_pairs_raise(tmp_path):
    r1 = tmp_path / "r1.fastq.gz"
    r2 = tmp_path / "r2.fastq.gz"
    _write_gz(r1, [("a/1", "ACGT", "IIII"), ("b/1", "ACGT", "IIII")])
    _write_gz(r2, [("a/2", "ACGT", "IIII"), ("c/2", "ACGT", "IIII")])
    raised = _raised_by_both(
        lambda pl: pl.deduplicate_cluster(
            [str(r1), str(r2)],
            [str(tmp_path / "o1.fq"), str(tmp_path / "o2.fq")], None, 1,
            1.0), ("FastqFormatError",))
    assert "not mates" in str(raised[1])
    assert str(raised[0]) == str(raised[1])


def test_illumina_comment_headers_pass_mate_check(tmp_path):
    records = [("x:1:2:3 1:N:0:ACGT", "ACGTACGT", "IIIIIIII"),
               ("y:1:2:4 1:N:0:ACGT", "ACGTACGA", "IIIIIIII")]
    r1 = tmp_path / "r1.fastq.gz"
    r2 = tmp_path / "r2.fastq.gz"
    _write_gz(r1, records)
    _write_gz(r2, [(name.replace(" 1:", " 2:"), s, q)
                   for name, s, q in records])
    outs = _same_bytes_from_both(
        [str(r1), str(r2)],
        lambda tag: [str(tmp_path / f"{tag}{i}.fastq.gz") for i in (1, 2)],
        None, 1, 1.0)
    # The keys (both mates joined) differ in two bases: both pairs stay.
    assert outs[0].count(b"@") == 2 and b" 2:N:0:ACGT" in outs[1]


@pytest.mark.parametrize("distinct", [False, True])
def test_paired_files_with_short_native_chunks(tmp_path, distinct):
    """Records larger than the native parser's per-record byte estimate
    force short mid-file chunks; the lockstep zip of the two files
    realigns and no record is dropped.  With one repeated sequence one
    record survives, with distinct sequences every record."""
    n = 500
    rng = np.random.default_rng(0)
    seqs = ["".join("ACGT"[b] for b in rng.integers(0, 4, 600))
            for _ in range(n)] if distinct else ["ACGT" * 150] * n
    r1 = tmp_path / "r1.fastq.gz"
    r2 = tmp_path / "r2.fastq.gz"
    _write_gz(r1, [(f"r{i} 1:N:0:x", s, "I" * 600)
                   for i, s in enumerate(seqs)])
    _write_gz(r2, [(f"r{i} 2:N:0:x", s, "I" * 600)
                   for i, s in enumerate(seqs)])
    outs = _same_bytes_from_both(
        [str(r1), str(r2)],
        lambda tag: [str(tmp_path / f"{tag}{i}.fastq.gz") for i in (1, 2)],
        None, 0, 1.0, chunk_records=64)
    for out in outs:
        assert out.count(b"@r") == (n if distinct else 1)


def test_threaded_pipeline_stress_many_small_chunks(tmp_path):
    """Tiny chunks maximise the handoffs between the parse thread, the
    accumulate worker and the writer thread; repeated runs stay identical
    and equal to the JAX package's."""
    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wt") as f:
        f.write(_records(3000, length=12, seed=99))
    runs = [_same_bytes_from_both(
        [str(src)], lambda tag: [str(tmp_path / f"{tag}{run}.fastq.gz")],
        None, 1, 1.0, chunk_records=7) for run in range(2)]
    assert runs[0] == runs[1] and runs[0][0]


def test_writer_thread_error_propagates(tmp_path):
    """An output path that cannot be opened raises on the caller."""
    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wt") as f:
        f.write(_records(500, length=12, seed=98))
    bad_out = tmp_path / "no_such_dir" / "out.fastq.gz"
    _raised_by_both(
        lambda pl: pl.deduplicate_cluster([str(src)], [str(bad_out)], None,
                                          1, 1.0),
        ("OSError", "FileNotFoundError"))


def test_prefetch_cancel_on_consumer_error(tmp_path):
    """Abandoning the chunk iterator mid-stream unblocks the producer
    thread, which exits promptly."""
    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wt") as f:
        f.write("".join(f"@r{i} z\nACGTACGT\n+\nIIIIIIII\n"
                        for i in range(5000)))
    for _, pipeline in PIPELINES:
        before = threading.active_count()
        chunks = pipeline._zip_chunks([str(src)], chunk_records=16)
        next(chunks)
        chunks.close()  # generator close triggers the finally-drain path
        _assert_threads_settle(before, deadline_s=5.0)


def test_corrupt_shard_fails_two_process_job(tmp_path):
    """A sharded-input 2-process job of the port where one process's
    shard is corrupt: the owner exits non-zero with the inflate error,
    and its peer, parked in an exchange, fails fast too (the owner tears
    the socket mesh down) instead of waiting out the job.  Limit: 150 s
    for the pair, then both are killed and the test fails."""
    good = tmp_path / "shard0.fastq.gz"
    bad = tmp_path / "shard1.fastq.gz"
    _write_bgzf(good, _records(60_000, seed=6))
    _write_bgzf(bad, _records(60_000, seed=7))
    _corrupt_middle_block(bad)
    t0 = time.monotonic()
    results = run_two_processes(tmp_path, f"""
        from fastqdedup_tpu_torch.pipeline import deduplicate_cluster
        shard = [{str(good)!r}, {str(bad)!r}][pid]
        deduplicate_cluster([shard], [f"out{{pid}}.fastq.gz"], None, 1, 1.0)
        print("DONE", pid)
        """, env={"FASTQDEDUP_SHARDED_INPUT": "1"}, timeout=150.0,
        check=False)
    (peer_code, peer_log), (owner_code, owner_log) = results
    assert owner_code != 0, owner_log[-2000:]
    assert any(word in owner_log.lower()
               for word in ("corrupt", "inflate", "gzip", "bgzf")), \
        owner_log[-2000:]
    assert "DONE" not in owner_log
    assert peer_code != 0 and "DONE" not in peer_log, peer_log[-2000:]
    assert time.monotonic() - t0 < 150.0
