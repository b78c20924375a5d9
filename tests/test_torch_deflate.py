"""The deflate kernel's plain version and the card writer on the CPU.

``ops/deflate_kernels.py`` states the rule the kernel (``csrc/deflate.cu``)
applies; its plain version, held here, applies the same rule, and
``tests/test_torch_cuda.py`` holds the kernel to it byte for byte on the
card.  Here: members inflate (zlib, gzip and the port's own BGZF reader)
to their input; the framing is BGZF; outputs are deterministic; random
bytes fall back to stored blocks; the stream's edge sizes; the size
against the host compressor's on the benchmark's FASTQ; the card
writer's windows (``io/bgzf.DeviceBgzfWriter``, run on the CPU device,
where its windows call the plain version); the choice of writer; and
the counters that ``pass3.deflate_device_share`` reads.
"""

import gzip
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.generate import generate_fastq
from benchmark.trace import Trace
from fastqdedup_tpu_torch import pipeline
from fastqdedup_tpu_torch.io import bgzf
from fastqdedup_tpu_torch.io.fastq import render_fastq_records
from fastqdedup_tpu_torch.io.opener import xopen
from fastqdedup_tpu_torch.native import loader
from fastqdedup_tpu_torch.ops import deflate_kernels as dk
from fastqdedup_tpu_torch.utils import trace

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


@pytest.fixture
def small_windows(monkeypatch):
    """Windows of two members, two in flight, in a pool of their own."""
    monkeypatch.setattr(bgzf, "DEVICE_WINDOW_MEMBERS", 2)
    monkeypatch.setattr(bgzf, "DEVICE_WINDOWS", 2)
    monkeypatch.setattr(bgzf, "_windows", {})


def _fastq(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 100))
        qual = bytes(33 + rng.integers(30, 41, 100, dtype=np.uint8))
        out.append(b"@read%09d\n%s\n+\n%s\n" % (i, seq, qual))
    return b"".join(out)


def _inputs():
    rng = np.random.default_rng(11)
    return {
        "fastq": _fastq(300)[:dk.BLOCK_SIZE],
        "zeros": bytes(dk.BLOCK_SIZE),
        "pattern": b"ACGTTGCA" * 5000,
        "text": b"the quick brown fox jumps over the lazy dog " * 40,
        "short": b"@r\nACGT\n+\nIIII\n",
        "three": b"abc",
        "one": b"x",
        "skewed": bytes(rng.geometric(0.3, 60000).clip(0, 255)
                        .astype(np.uint8)),
    }


def _card_write(data, chunk=7777):
    out = io.BytesIO()
    writer = bgzf.DeviceBgzfWriter(out, CPU)
    for i in range(0, len(data), chunk):
        writer.write(data[i:i + chunk])
    writer.close()
    return out.getvalue()


def _host_write(data):
    out = io.BytesIO()
    writer = bgzf.ParallelBgzfWriter(out)
    writer.write(data)
    writer.close()
    return out.getvalue()


def _members(blob):
    """(header, payload, crc, isize) of each member, in order."""
    members, pos = [], 0
    while pos < len(blob):
        bsize = struct.unpack_from("<H", blob, pos + 16)[0] + 1
        crc, isize = struct.unpack_from("<II", blob, pos + bsize - 8)
        members.append((blob[pos:pos + 18], blob[pos + 18:pos + bsize - 8],
                        crc, isize))
        pos += bsize
    assert pos == len(blob)
    return members


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_plain_members_inflate_to_their_input(name):
    data = _inputs()[name]
    member = dk.bgzf_member_plain(data)
    assert zlib.decompress(dk.deflate_plain(data), -15) == data
    assert gzip.decompress(member) == data
    (header, payload, crc, isize), = _members(member)
    assert crc == zlib.crc32(data) and isize == len(data)
    assert zlib.decompressobj(-15).decompress(payload) == data


def test_members_are_bgzf_and_end_with_one_eof(small_windows):
    data = _fastq(1500)
    blob = _card_write(data)
    assert blob.endswith(bgzf.BGZF_EOF)
    assert blob.count(bgzf.BGZF_EOF) == 1
    members = _members(blob)
    start = 0
    for header, payload, crc, isize in members[:-1]:
        # gzip, deflate, FEXTRA, no mtime, XLEN 6, the BC subfield of 2.
        assert header[:16] == (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                               b"\x06\x00BC\x02\x00")
        assert struct.unpack_from("<H", header, 16)[0] == \
            18 + len(payload) + 8 - 1
        piece = data[start:start + isize]
        assert crc == zlib.crc32(piece)
        assert zlib.decompressobj(-15).decompress(payload) == piece
        start += isize
    assert start == len(data) and members[-1][3] == 0
    # The same members as the host writer's, at the same offsets.
    assert [m[3] for m in members] == \
        [m[3] for m in _members(_host_write(data))]
    assert gzip.decompress(blob) == data


def test_outputs_are_deterministic(small_windows):
    data = _fastq(1200, seed=5)
    assert _card_write(data) == _card_write(data, chunk=65280 * 3 + 1)
    assert dk.deflate_plain(data[:50000]) == dk.deflate_plain(data[:50000])


def test_random_bytes_fall_back_to_stored_blocks(small_windows):
    data = np.random.default_rng(7).integers(
        0, 256, 2 * dk.BLOCK_SIZE + 99, dtype=np.uint8).tobytes()
    blob = _card_write(data)
    assert gzip.decompress(blob) == data
    for header, payload, crc, isize in _members(blob)[:-1]:
        assert payload[0] == 1 and len(payload) == isize + 5
        assert struct.unpack_from("<HH", payload, 1) == \
            (isize, isize ^ 0xFFFF)


@pytest.mark.parametrize("size,members", [(0, 0), (1, 1), (65280, 1),
                                          (65281, 2)])
def test_stream_edge_sizes(small_windows, size, members):
    data = (_fastq(400) * 2)[:size]
    blob = _card_write(data)
    assert gzip.decompress(blob) == data
    assert len(_members(blob)) == members + 1
    assert _members(blob)[:-1] == _members(
        b"".join(dk.bgzf_member_plain(data[i:i + dk.BLOCK_SIZE])
                 for i in range(0, size, dk.BLOCK_SIZE)) + bgzf.BGZF_EOF
    )[:-1]


@pytest.mark.parametrize("traffic", ["default", "dense"])
def test_size_within_three_percent_of_the_host_writer(tmp_path, traffic):
    """On the benchmark's FASTQ: at most 1.03 times the host writer's
    level 1 (libdeflate where it is loaded, else zlib)."""
    spec = harness.load_json(os.path.join(harness.BENCH, "traffic",
                                          traffic + ".json"))
    kwargs = {k: v for k, v in spec.items()
              if not k.endswith("why") and k != "files"}
    path = str(tmp_path / "reads.fastq.gz")
    generate_fastq(path, 3000, seed=2**31 + 5, threads=2, **kwargs)
    data = gzip.open(path).read()
    card, host = _card_write(data, chunk=1 << 20), _host_write(data)
    assert gzip.decompress(card) == data
    assert len(card) <= 1.03 * len(host), (len(card), len(host))


def test_port_reader_reads_the_card_members(tmp_path, small_windows):
    data = _fastq(1500, seed=9)
    path = str(tmp_path / "card.fastq.gz")
    with open(path, "wb") as f:
        f.write(_card_write(data))

    def rendered(chunks):
        return b"".join(render_fastq_records(c, np.arange(c.count)).tobytes()
                        for c in chunks)

    def read(**kwargs):
        return rendered(loader.read_fastq_chunks_native(path, 500, **kwargs))

    assert read() == data
    seam = loader.bgzf_boundary(path, 1)
    assert seam and seam > 0
    assert read(split=(0, seam)) + read(split=(seam, -1)) == data


def test_huffman_lengths_are_limited_and_complete():
    fib = [1, 1]
    while len(fib) < 30:
        fib.append(fib[-1] + fib[-2])
    for freq, limit in ((fib, 15), (fib[:19], 7), ([0] * 10 + [5], 15),
                        ([0] * 30, 15), ([3, 3, 3, 3], 15)):
        lengths = dk.huffman_lengths(np.array(freq), limit)
        assert lengths.max() <= limit
        used = lengths[lengths > 0]
        assert len(used) >= 2
        assert sum(2.0 ** -used) == 1.0


def test_xopen_on_a_cpu_device_keeps_the_host_writer(tmp_path):
    data = _fastq(800)
    path = str(tmp_path / "out.fastq.gz")
    with xopen(path, "wb", compresslevel=1) as writer:
        assert type(writer) is bgzf.ParallelBgzfWriter
        writer.write(data)
    with open(path, "rb") as f:
        assert f.read() == _host_write(data)


def test_xopen_on_a_card_picks_the_card_writer(tmp_path, monkeypatch):
    """Where ``runtime.device()`` answers a card, a level-1 gzip write
    takes the card writer; other levels and other codecs do not."""
    import fastqdedup_tpu_torch.runtime as runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(runtime, "device", lambda: torch.device("cuda", 0))
    monkeypatch.setattr(bgzf, "_stream", lambda device: None)
    writer = xopen(str(tmp_path / "a.fastq.gz"), "wb", compresslevel=1)
    assert type(writer) is bgzf.DeviceBgzfWriter
    writer._current = None
    writer._file.close()
    with xopen(str(tmp_path / "b.fastq.gz"), "wb", compresslevel=6) as w:
        assert type(w) is bgzf.ParallelBgzfWriter
    with xopen(str(tmp_path / "c.fastq"), "wb") as w:
        assert not isinstance(w, (bgzf.DeviceBgzfWriter,
                                  bgzf.ParallelBgzfWriter))


def test_writers_count_the_bytes_they_deflate(small_windows):
    before = trace.counts()
    data = _fastq(700)
    _card_write(data)
    _host_write(data)
    after = trace.counts()
    moved = {k: after[k] - before.get(k, 0) for k in after}
    assert moved["bytes.deflate.device"] == len(data)
    assert moved["bytes.deflate.host"] == len(data)


def test_pass3_counts_reach_its_span(tmp_path):
    """The pass-3 writer thread carries the job's spans, so its writer's
    counts land in ``pass3`` (what the window's counters sum)."""
    src = str(tmp_path / "in.fastq.gz")
    with open(src, "wb") as f:
        f.write(_host_write(_fastq(3000)))
    out = str(tmp_path / "out.fastq.gz")
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        pipeline.deduplicate_cluster([src], [out], None, 1, 0.001,
                                     chunk_records=1024)
        spans = trace.spans()
    trace.clear()
    written = sum(s.counts.get("bytes.deflate.host", 0) for s in spans
                  if s.name.startswith("pass3"))
    assert written == len(gzip.open(out).read()) > 0


def _span(name, start_ms, end_ms, **counts):
    s = trace.Span(name)
    s.start, s.end, s.job, s.counts = start_ms * 10**6, end_ms * 10**6, 1, \
        counts
    return s


@pytest.mark.parametrize("counts,share", [
    ({"bytes.deflate.device": 300, "bytes.deflate.host": 100}, 75.0),
    ({"bytes.deflate.device": 300}, 100.0),
    ({"bytes.deflate.host": 5}, 0.0),
    ({}, None),
])
def test_device_share_reader(monkeypatch, counts, share):
    ms = 10 ** 6
    run = Trace(traced=(0, 1000 * ms), window=(200 * ms, 1000 * ms),
                jobs=[(200 * ms, 1000 * ms)])
    spans = [_span("pass3", 100, 150, **{"bytes.deflate.host": 7}),
             _span("job", 200, 1000), _span("pass3", 600, 900, **counts)]
    monkeypatch.setattr(trace, "spans", lambda: spans)
    got = harness.read_metric("pass3.deflate_device_share", run)
    assert got == (None if share is None else pytest.approx(share))
