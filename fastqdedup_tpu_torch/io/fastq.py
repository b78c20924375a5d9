"""FASTQ parsing and writing (host layer).

Replaces the reference's third-party ``dnaio``/``xopen`` stack
(/root/reference/src/fastqdedup/__init__.py:54-57, 170-206) with a
self-contained implementation.  Two read paths are provided:

* :class:`FastqReader` — record-at-a-time iterator (API-compatible with the
  reference's usage of dnaio records: ``.name``, ``.sequence``,
  ``.qualities``, ``.fastq_bytes()``).
* :func:`read_fastq_chunks` — the TPU-native ingest path: yields columnar
  :class:`FastqChunk` batches (concatenated bytes + offset arrays) that feed
  directly into the vectorized encode/quality kernels without creating
  per-record Python objects.

A native C chunk parser (fastqdedup_tpu.native) transparently accelerates
:func:`read_fastq_chunks` when built.
"""

from dataclasses import dataclass
from typing import IO, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .opener import xopen


class FastqFormatError(Exception):
    """Raised on malformed FASTQ input or desynchronized mate files."""

    def __init__(self, message: str, line: Optional[int] = None):
        if line is not None:
            message = f"{message} (line {line + 1})"
        super().__init__(message)
        self.line = line


@dataclass
class FastqRecord:
    """One FASTQ record.  ``name`` excludes the leading ``@``."""
    name: str
    sequence: str
    qualities: str

    @property
    def id(self) -> str:
        return self.name.split(maxsplit=1)[0] if self.name else ""

    def fastq_bytes(self) -> bytes:
        return (f"@{self.name}\n{self.sequence}\n+\n{self.qualities}\n"
                .encode("ascii"))


def records_are_mates(*records: FastqRecord) -> bool:
    """True iff all records belong to the same fragment.

    Mirrors dnaio's rule as relied on by the reference
    (__init__.py:180-186): record IDs (name up to first whitespace) must be
    identical, or identical except for the final character, which must then
    be ``1``, ``2`` or ``3`` in every record.
    """
    if len(records) < 2:
        raise ValueError("At least two records are required")
    ids = [record.id for record in records]
    first = ids[0]
    if all(i == first for i in ids[1:]):
        return True
    stem = first[:-1]
    if not first:
        return False
    return all(len(i) == len(first) and i[:-1] == stem and i[-1] in "123"
               for i in ids) and first[-1] in "123"


class FastqReader:
    """Iterate :class:`FastqRecord`s from a (possibly gzipped) FASTQ file."""

    def __init__(self, file: IO[bytes], filename: str = "<stream>"):
        self._file = file
        self._filename = filename

    def __iter__(self) -> Iterator[FastqRecord]:
        line_iter = enumerate(self._file)
        for line_number, header in line_iter:
            header = header.rstrip(b"\r\n")
            if not header:
                continue
            if not header.startswith(b"@"):
                raise FastqFormatError(
                    f"{self._filename}: expected '@' at record start, got "
                    f"{header[:20]!r}", line=line_number)
            try:
                _, sequence = next(line_iter)
                _, plus = next(line_iter)
                _, qualities = next(line_iter)
            except StopIteration:
                raise FastqFormatError(
                    f"{self._filename}: truncated FASTQ record",
                    line=line_number) from None
            sequence = sequence.rstrip(b"\r\n")
            qualities = qualities.rstrip(b"\r\n")
            if not plus.startswith(b"+"):
                raise FastqFormatError(
                    f"{self._filename}: expected '+' on third record line",
                    line=line_number + 2)
            if len(sequence) != len(qualities):
                raise FastqFormatError(
                    f"{self._filename}: sequence and qualities differ in "
                    f"length", line=line_number + 3)
            yield FastqRecord(header[1:].decode("ascii"),
                              sequence.decode("ascii"),
                              qualities.decode("ascii"))


def file_to_fastq_reader(filename: str) -> Iterator[FastqRecord]:
    """Stream records from ``filename`` (gzip-transparent)."""
    with xopen(filename, "rb") as file:
        yield from FastqReader(file, filename)


def fastq_files_to_records(
        input_files: List[str]) -> Iterator[Tuple[FastqRecord, ...]]:
    """Zip N FASTQ files record-wise, validating mate synchronization
    (reference __init__.py:170-186)."""
    readers = [file_to_fastq_reader(f) for f in input_files]
    for records in zip(*readers):
        if len(records) > 1 and not records_are_mates(*records):
            names = ", ".join(record.name for record in records)
            raise FastqFormatError(
                f"FASTQ files not in sync: {names} are not mates.")
        yield records


class FastqWriter:
    """Write records (or raw record bytes) to a gzip-transparent file."""

    def __init__(self, filename: str, compresslevel: int = 1):
        self._file = xopen(filename, "wb", compresslevel=compresslevel)

    def write_record(self, record: FastqRecord) -> None:
        self._file.write(record.fastq_bytes())

    def write_bytes(self, data: bytes) -> None:
        self._file.write(data)

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "FastqWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclass
class FastqChunk:
    """Columnar batch of FASTQ records (the device-facing ingest format).

    ``sequences``/``qualities`` hold all record payloads concatenated as
    uint8; ``offsets`` is an int64 array of length ``count + 1`` delimiting
    each record (shared by sequences and qualities, whose lengths match per
    record).  ``headers`` holds the raw header lines (without ``@``)
    concatenated, delimited by ``header_offsets``.
    """
    sequences: np.ndarray
    qualities: np.ndarray
    offsets: np.ndarray
    headers: np.ndarray
    header_offsets: np.ndarray
    # Base buffers eligible for runtime.release() once the consumer is
    # provably done with every view of this chunk (set by the native
    # parser; dropped by any transform that mixes chunks).
    pool_bases: Optional[Tuple[np.ndarray, ...]] = None

    @property
    def count(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def sequence(self, i: int) -> bytes:
        return self.sequences[self.offsets[i]:self.offsets[i + 1]].tobytes()

    def quality(self, i: int) -> bytes:
        return self.qualities[self.offsets[i]:self.offsets[i + 1]].tobytes()

    def header(self, i: int) -> bytes:
        return self.headers[
            self.header_offsets[i]:self.header_offsets[i + 1]].tobytes()

    def record_id(self, i: int) -> bytes:
        return self.header(i).split(None, 1)[0] if self.header(i) else b""


def _lines_to_chunk(lines: Sequence[bytes], filename: str,
                    first_line_number: int) -> FastqChunk:
    n = len(lines) // 4
    seq_parts: List[bytes] = []
    qual_parts: List[bytes] = []
    head_parts: List[bytes] = []
    offsets = np.empty(n + 1, dtype=np.int64)
    header_offsets = np.empty(n + 1, dtype=np.int64)
    offsets[0] = 0
    header_offsets[0] = 0
    pos = 0
    hpos = 0
    for i in range(n):
        header, sequence, plus, qualities = lines[4 * i:4 * i + 4]
        if not header.startswith(b"@"):
            raise FastqFormatError(
                f"{filename}: expected '@' at record start",
                line=first_line_number + 4 * i)
        if not plus.startswith(b"+"):
            raise FastqFormatError(
                f"{filename}: expected '+' on third record line",
                line=first_line_number + 4 * i + 2)
        if len(sequence) != len(qualities):
            raise FastqFormatError(
                f"{filename}: sequence and qualities differ in length",
                line=first_line_number + 4 * i + 3)
        head_parts.append(header[1:])
        seq_parts.append(sequence)
        qual_parts.append(qualities)
        pos += len(sequence)
        hpos += len(header) - 1
        offsets[i + 1] = pos
        header_offsets[i + 1] = hpos
    return FastqChunk(
        sequences=np.frombuffer(b"".join(seq_parts), dtype=np.uint8),
        qualities=np.frombuffer(b"".join(qual_parts), dtype=np.uint8),
        offsets=offsets,
        headers=np.frombuffer(b"".join(head_parts), dtype=np.uint8),
        header_offsets=header_offsets,
    )


def read_fastq_chunks(filename: str,
                      chunk_records: int = 1 << 18) -> Iterator[FastqChunk]:
    """Yield columnar :class:`FastqChunk`s of up to ``chunk_records`` records.

    Pure-Python fallback path; the native C parser is used automatically when
    available (see fastqdedup_tpu.native).
    """
    if not filename.endswith((".bz2", ".xz", ".zst")):
        # The native parser speaks gzip/BGZF/plain; other codecs stream
        # through the Python line parser below via the xopen codec layer.
        try:
            from ..native import read_fastq_chunks_native
        except ImportError:
            read_fastq_chunks_native = None
        if read_fastq_chunks_native is not None:
            yield from read_fastq_chunks_native(filename, chunk_records)
            return
    with xopen(filename, "rb") as file:
        line_number = 0
        lines: List[bytes] = []
        take = 4 * chunk_records
        for raw in file:
            line = raw.rstrip(b"\r\n")
            if not line and not lines:
                line_number += 1
                continue  # tolerate stray blank lines between records
            lines.append(line)
            if len(lines) == take:
                yield _lines_to_chunk(lines, filename, line_number)
                line_number += take
                lines = []
        if lines:
            while lines and not lines[-1]:
                lines.pop()
            if len(lines) % 4:
                raise FastqFormatError(
                    f"{filename}: truncated FASTQ record", line=line_number)
            if lines:
                yield _lines_to_chunk(lines, filename, line_number)


def _ragged_copy(out: np.ndarray, dst_starts: np.ndarray, src: np.ndarray,
                 src_starts: np.ndarray, lengths: np.ndarray) -> None:
    """out[dst_starts[i]:+lengths[i]] = src[src_starts[i]:+lengths[i]],
    vectorized per distinct length."""
    for length in np.unique(lengths):
        if length == 0:
            continue
        sel = np.flatnonzero(lengths == length)
        idx = np.arange(length, dtype=np.int64)
        out[dst_starts[sel][:, None] + idx] = \
            src[src_starts[sel][:, None] + idx]


def render_fastq_records(chunk: FastqChunk, rows: np.ndarray) -> np.ndarray:
    """Serialize the selected records of a chunk to FASTQ bytes (uint8).

    Vectorized assembly: three ragged copies (header, sequence, quality)
    plus constant separators — no per-record Python objects.
    """
    rows = np.asarray(rows, dtype=np.int64)
    if not len(rows):
        return np.empty(0, dtype=np.uint8)
    try:
        from ..native.loader import render_records_native
        return render_records_native(
            chunk.sequences, chunk.qualities, chunk.offsets,
            chunk.headers, chunk.header_offsets, rows)
    except ImportError:
        pass
    h0 = chunk.header_offsets[rows]
    hl = chunk.header_offsets[rows + 1] - h0
    s0 = chunk.offsets[rows]
    sl = chunk.offsets[rows + 1] - s0
    rec_len = 1 + hl + 1 + sl + 3 + sl + 1
    out_offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(rec_len, out=out_offsets[1:])
    out = np.empty(out_offsets[-1], dtype=np.uint8)
    base = out_offsets[:-1]
    out[base] = ord("@")
    _ragged_copy(out, base + 1, chunk.headers, h0, hl)
    p = base + 1 + hl
    out[p] = 10
    _ragged_copy(out, p + 1, chunk.sequences, s0, sl)
    q = p + 1 + sl
    out[q] = 10
    out[q + 1] = ord("+")
    out[q + 2] = 10
    _ragged_copy(out, q + 3, chunk.qualities, s0, sl)
    out[q + 3 + sl] = 10
    return out
