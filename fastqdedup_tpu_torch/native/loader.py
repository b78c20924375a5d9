"""ctypes bindings for the native FASTQ chunk parser / gzip writer.

Importing this module builds (if needed) and loads ``_fastq_io.so``.  On any
failure an ImportError propagates and callers fall back to the pure-Python
path (fastqdedup_tpu/io/fastq.py).
"""

import ctypes
import os
from typing import Iterator

import numpy as np

from .build import library_path

_FQ_OK = 0
_FQ_ERR_FORMAT = 3

# FASTQDEDUP_NATIVE_LIB: load a specific build of the library instead
# of the auto-built one (e.g. an -fsanitize=address build for sanitizer
# test runs; LD_PRELOAD the matching runtime first).
_lib = ctypes.CDLL(os.environ.get("FASTQDEDUP_NATIVE_LIB")
                   or library_path())

_lib.fq_open.restype = ctypes.c_void_p
_lib.fq_open.argtypes = [ctypes.c_char_p]
_lib.fq_close.restype = None
_lib.fq_close.argtypes = [ctypes.c_void_p]
_lib.fq_error.restype = ctypes.c_char_p
_lib.fq_error.argtypes = [ctypes.c_void_p]
_lib.fq_error_line.restype = ctypes.c_int64
_lib.fq_error_line.argtypes = [ctypes.c_void_p]
_lib.fq_has_pending.restype = ctypes.c_int
_lib.fq_has_pending.argtypes = [ctypes.c_void_p]
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_lib.fq_next_chunk.restype = ctypes.c_int
_lib.fq_next_chunk.argtypes = [
    ctypes.c_void_p, ctypes.c_int64,
    _u8p, _u8p, ctypes.c_int64, _i64p,
    _u8p, ctypes.c_int64, _i64p,
    ctypes.POINTER(ctypes.c_int64)]

_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_lib.fq_avg_error_rates.restype = ctypes.c_int64
_lib.fq_avg_error_rates.argtypes = [
    _u8p, _i64p, ctypes.c_int64, ctypes.c_int, _f64p]
_avg_err_mt = getattr(_lib, "fq_avg_error_rates_mt", None)
if _avg_err_mt is not None:
    _avg_err_mt.restype = ctypes.c_int64
    _avg_err_mt.argtypes = [_u8p, _i64p, ctypes.c_int64, ctypes.c_int,
                            _f64p, ctypes.c_int]

_lib.acc_new.restype = ctypes.c_void_p
_lib.acc_new.argtypes = [ctypes.c_int64]
_lib.acc_free.restype = None
_lib.acc_free.argtypes = [ctypes.c_void_p]
_lib.acc_add.restype = ctypes.c_int
_lib.acc_add.argtypes = [ctypes.c_void_p, _u8p, _i64p,
                         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
_lib.acc_add_mark.restype = ctypes.c_int
_lib.acc_add_mark.argtypes = [ctypes.c_void_p, _u8p, _i64p,
                              ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_int64, _u8p]
_lib.acc_size.restype = ctypes.c_int64
_lib.acc_size.argtypes = [ctypes.c_void_p]
_lib.acc_key_bytes.restype = ctypes.c_int64
_lib.acc_key_bytes.argtypes = [ctypes.c_void_p]
# The port's own export (native/_fastq_io_port.c): the shared acc_export
# can leave the last key bytes of a table uncopied.
_lib.acc_export_port.restype = None
_lib.acc_export_port.argtypes = [ctypes.c_void_p, _u8p, _i64p, _i64p,
                                 _i64p]
_u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_lib.acc_export_hashes.restype = None
_lib.acc_export_hashes.argtypes = [ctypes.c_void_p, _u64p]
_lib.acc_byte_presence.restype = None
_lib.acc_byte_presence.argtypes = [ctypes.c_void_p, _u8p]

_lib.acc_lookup.restype = None
_lib.acc_lookup.argtypes = [ctypes.c_void_p, _u8p, _i64p,
                            ctypes.c_int64, _i64p]
_lib.acc_lookup_mt.restype = None
_lib.acc_lookup_mt.argtypes = [ctypes.c_void_p, _u8p, _i64p,
                               ctypes.c_int64, _i64p, ctypes.c_int]

_lib.uf_components.restype = ctypes.c_int
_lib.uf_components.argtypes = [ctypes.c_int64, _i64p, _i64p,
                               ctypes.c_int64, _i64p]

_lib.fq_hash_rows.restype = None
_lib.fq_hash_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_uint64, ctypes.c_int,
                              ctypes.c_int, _u64p]

_lib.fq_partition_assemble.restype = ctypes.c_int
_lib.fq_partition_assemble.argtypes = [
    ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _i64p,
    ctypes.POINTER(ctypes.c_int64)]

_lib.fq_open_range.restype = ctypes.c_void_p
_lib.fq_open_range.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_int64]
_lib.fq_scan_boundary.restype = ctypes.c_int64
_lib.fq_scan_boundary.argtypes = [ctypes.c_char_p, ctypes.c_int64]
_lib.fq_count_units.restype = ctypes.c_int
_lib.fq_count_units.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                _i64p, _i64p,
                                ctypes.POINTER(ctypes.c_int64)]
_lib.fq_skip_newlines.restype = ctypes.c_int
_lib.fq_skip_newlines.argtypes = [ctypes.c_void_p, ctypes.c_int64]
# The port's own entries (native/_fastq_io_port.c): split ingest.
_lib.fq_record_start.restype = ctypes.c_int64
_lib.fq_record_start.argtypes = [ctypes.c_char_p, ctypes.c_int64, _u8p,
                                 ctypes.c_int64]
_lib.fq_open_split.restype = ctypes.c_void_p
_lib.fq_open_split.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64, _u8p,
                               ctypes.c_int64]
_lib.fq_close_split.restype = None
_lib.fq_close_split.argtypes = [ctypes.c_void_p]
_START_EOF = -1
_START_NOT_FOUND = -4

_lib.acc_add_sharded.restype = ctypes.c_int
_lib.acc_add_sharded.argtypes = [_u64p, ctypes.c_int, _u8p, _i64p,
                                 ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_void_p]

_lib.fq_radix_sort_u64.restype = ctypes.c_int
_lib.fq_radix_sort_u64.argtypes = [ctypes.c_int64, _u64p]
# Additive symbol: guard so a stale .so degrades to the serial sort.
_radix_mt = getattr(_lib, "fq_radix_sort_u64_mt", None)
if _radix_mt is not None:
    _radix_mt.restype = ctypes.c_int
    _radix_mt.argtypes = [ctypes.c_int64, _u64p, ctypes.c_int]
_rank_rows = getattr(_lib, "fq_rank_rows", None)
if _rank_rows is not None:
    _rank_rows.restype = ctypes.c_int
    _rank_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int,
                           _i64p, _i64p]
_pack_nibbles = getattr(_lib, "fq_pack_nibbles", None)
if _pack_nibbles is not None:
    _pack_nibbles.restype = ctypes.c_int
    _pack_nibbles.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_int, _u32p]
_hash_owner = getattr(_lib, "fq_hash_owner_select", None)
if _hash_owner is not None:
    _hash_owner.restype = ctypes.c_int64
    _hash_owner.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_uint64, ctypes.c_uint64,
                            ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int, _i64p, _u64p]
_ham_verify = getattr(_lib, "fq_hamming_verify_pairs", None)
if _ham_verify is not None:
    _ham_verify.restype = ctypes.c_int
    _ham_verify.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                            _i64p, _i64p, ctypes.c_int64,
                            ctypes.c_int64, _u8p, ctypes.c_int]

_lib.fq_edit_verify.restype = ctypes.c_int
_lib.fq_edit_verify.argtypes = [_u8p, ctypes.c_int64, _i64p, _i64p,
                                _i64p, ctypes.c_int64, ctypes.c_int,
                                _u8p, ctypes.c_int]

_lib.fq_owned_merge.restype = ctypes.c_int
_lib.fq_owned_merge.argtypes = [ctypes.c_int64, _i64p, _u64p, _u64p,
                                _i64p, _i64p, ctypes.c_int64,
                                ctypes.c_int64, _i64p, ctypes.c_int64,
                                _i64p, _i64p, _i64p, _i64p,
                                ctypes.POINTER(ctypes.c_int64)]

_lib.fq_sort_permute4.restype = ctypes.c_int
_lib.fq_sort_permute4.argtypes = [ctypes.c_int64,
                                  _i64p, _i64p, _i64p, _i64p,
                                  _i64p, _i64p, _i64p, _i64p]

_lib.fq_hash_ragged.restype = None
_lib.fq_hash_ragged.argtypes = [_u8p, _i64p, ctypes.c_int64,
                                ctypes.c_uint64, ctypes.c_int,
                                ctypes.c_int, _u64p]

_lib.fq_gather_ragged.restype = None
_lib.fq_gather_ragged.argtypes = [_u8p, _i64p, _i64p, ctypes.c_int64,
                                  _i64p, _u8p, ctypes.c_int]

_lib.fq_render_records.restype = ctypes.c_int64
_lib.fq_render_records.argtypes = [_u8p, _u8p, _i64p, _u8p, _i64p,
                                   _i64p, ctypes.c_int64, _u8p]

_lib.fq_render_records_mt.restype = None
_lib.fq_render_records_mt.argtypes = [_u8p, _u8p, _i64p, _u8p, _i64p,
                                      _i64p, ctypes.c_int64, _i64p, _u8p,
                                      ctypes.c_int]

_lib.fqw_open.restype = ctypes.c_void_p
_lib.fqw_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
_lib.fqw_write.restype = ctypes.c_int
_lib.fqw_write.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_int64]
_lib.fqw_close.restype = ctypes.c_int
_lib.fqw_close.argtypes = [ctypes.c_void_p]

# Initial per-record payload estimate; buffers regrow on overflow carry.
_BYTES_PER_RECORD = 256
_HEAD_BYTES_PER_RECORD = 96


def bgzf_boundary(filename: str, lo: int) -> "int | None":
    """First BGZF member boundary at byte offset >= ``lo``.

    Returns None when the file is not BGZF; -1 when no member starts
    before EOF (empty range).  Raises on read errors.
    """
    out = _lib.fq_scan_boundary(os.fsencode(filename), int(lo))
    if out == -3:
        return None
    if out == -2:
        raise OSError(f"could not read {filename!r}")
    return int(out)


def count_bgzf_range_units(filename: str, lo: int, hi: int
                           ) -> "tuple[np.ndarray, np.ndarray] | None":
    """Newline counts of the BGZF members starting in ``[lo, hi)``.

    Returns ``(unit_end_offsets, unit_newline_counts)`` — ascending
    member-boundary offsets with the newline count of the decompressed
    bytes they delimit — or None when the file is not BGZF.  An empty
    range returns two empty arrays.  One sequential inflate of the
    range, no parsing (pipeline._plan_input_ranges phase A).
    """
    handle = _lib.fq_open_range(os.fsencode(filename), int(lo), int(hi))
    if not handle:
        if bgzf_boundary(filename, 0) is None:
            return None
        return (np.empty(0, dtype=np.int64),) * 2  # empty range
    try:
        # One unit per <=64-member inflate batch (<=4 MiB decompressed):
        # a generous fixed capacity; overflow merges into the last unit.
        cap = 1 << 20
        ends = np.empty(cap, dtype=np.int64)
        lines = np.empty(cap, dtype=np.int64)
        n = ctypes.c_int64(0)
        rc = _lib.fq_count_units(handle, cap, ends, lines,
                                 ctypes.byref(n))
        if rc != _FQ_OK:
            message = _lib.fq_error(handle).decode("utf-8", "replace")
            raise OSError(f"{filename}: {message or f'count error {rc}'}")
        return ends[:n.value].copy(), lines[:n.value].copy()
    finally:
        _lib.fq_close(handle)


def bgzf_record_start(filename: str, member: int
                      ) -> "tuple[int, np.ndarray] | None":
    """The first FASTQ record start after the first newline of the
    decompressed bytes that begin at the BGZF member at byte ``member``.

    A line that starts with '@' and whose next-but-one line starts with
    '+' is a header; of the four line starts after that newline the first
    such one is taken.  Returns ``(t, head)``: its offset ``t`` from the
    member's first decompressed byte, and those ``t`` bytes.  None when
    no record starts after that newline (the data ends first).  Raises
    FastqFormatError when none of the four lines qualifies, which only
    malformed input gives.  Inflates only the members it reads.
    """
    from ..io.fastq import FastqFormatError

    cap = 1 << 16
    while True:
        head = np.empty(cap, dtype=np.uint8)
        t = _lib.fq_record_start(os.fsencode(filename), int(member), head,
                                 cap)
        if t <= cap:
            break
        cap = t
    if t == _START_EOF:
        return None
    if t == _START_NOT_FOUND:
        raise FastqFormatError(
            f"{filename}: no FASTQ record start among the four lines "
            f"after the first newline of the BGZF member at byte {member}")
    if t < 0:
        raise OSError(f"{filename}: could not inflate the BGZF member at "
                      f"byte {member} (code {t})")
    return t, head[:t]


def read_fastq_chunks_native(filename: str, chunk_records: int = 1 << 18,
                             range_start: "int | None" = None,
                             skip_newlines: int = 0,
                             split: "tuple[int, int] | None" = None
                             ) -> Iterator["FastqChunk"]:
    """Yield columnar FastqChunk batches parsed by the C library.

    ``range_start``: open the file as a BGZF byte range starting at the
    member boundary ``range_start`` (exact — no scan) and skip the first
    ``skip_newlines`` newlines, so parsing starts at a record boundary
    computed from global line ordinals.  The caller bounds the record
    count (the reader itself runs to EOF).

    ``split=(lo, hi)``: read the records from the first record start
    after member ``lo`` (the file's first byte when ``lo`` is 0) up to
    the first record start after member ``hi`` (EOF when ``hi`` is -1),
    both found by :func:`bgzf_record_start`; ``lo`` and ``hi`` are member
    boundaries.  Readers over consecutive splits of one file read each
    record once.  A seam that is not a record start, which only malformed
    input gives, leaves a cut record at the end of the reader before it:
    FastqFormatError.
    """
    from ..io.fastq import FastqChunk, FastqFormatError

    close = _lib.fq_close
    if split is not None:
        lo, hi = split
        skip = 0
        if lo > 0:
            start = bgzf_record_start(filename, lo)
            if start is None:
                return  # no record starts in this split
            skip = start[0]
        tail = np.empty(0, dtype=np.uint8)
        if hi >= 0:
            end = bgzf_record_start(filename, hi)
            if end is None:
                hi = -1  # no record starts after hi: read to EOF
            else:
                tail = end[1]
        handle = _lib.fq_open_split(os.fsencode(filename), int(lo), int(hi),
                                    int(skip), tail, len(tail))
        if not handle:
            raise OSError(f"could not open {filename!r} at byte {lo}")
        close = _lib.fq_close_split
    elif range_start is not None:
        handle = _lib.fq_open_range(os.fsencode(filename),
                                    int(range_start), -1)
        if not handle:
            raise OSError(
                f"could not open {filename!r} at byte {range_start}")
        if skip_newlines:
            rc = _lib.fq_skip_newlines(handle, int(skip_newlines))
            if rc != _FQ_OK:
                message = _lib.fq_error(handle).decode("utf-8", "replace")
                _lib.fq_close(handle)
                raise OSError(f"{filename}: {message or f'skip error {rc}'}")
    else:
        handle = _lib.fq_open(os.fsencode(filename))
        if not handle:
            raise OSError(f"could not open {filename!r}")
    payload_cap = chunk_records * _BYTES_PER_RECORD
    head_cap = chunk_records * _HEAD_BYTES_PER_RECORD
    adapted = False
    from ..runtime import big_empty
    try:
        while True:
            # big_empty pre-faults: the parser writes every byte from C
            # and per-page write faults cost seconds/GiB on lazily-backed
            # guests, which would serialize on the parse thread.
            seq_buf = big_empty(payload_cap, dtype=np.uint8)
            qual_buf = big_empty(payload_cap, dtype=np.uint8)
            head_buf = big_empty(head_cap, dtype=np.uint8)
            offsets = big_empty(chunk_records + 1, dtype=np.int64)
            head_offsets = big_empty(chunk_records + 1, dtype=np.int64)
            n_records = ctypes.c_int64(0)
            rc = _lib.fq_next_chunk(
                handle, chunk_records, seq_buf, qual_buf, payload_cap,
                offsets, head_buf, head_cap, head_offsets,
                ctypes.byref(n_records))
            if rc != _FQ_OK:
                message = _lib.fq_error(handle).decode(
                    "utf-8", "replace") or f"native parser error {rc}"
                line = _lib.fq_error_line(handle)
                if rc == _FQ_ERR_FORMAT:
                    raise FastqFormatError(
                        f"{filename}: {message}",
                        line=int(line) if line >= 0 else None)
                raise OSError(f"{filename}: {message}")
            n = n_records.value
            if n == 0:
                # No chunk came out of this iteration's buffers (EOF
                # probe, or a record larger than the buffers): recycle
                # them — dropping them leaks one full buffer set per
                # file into fresh-page faults on the next run.
                from ..runtime import release
                for buf in (seq_buf, qual_buf, head_buf, offsets,
                            head_offsets):
                    release(buf)
                if _lib.fq_has_pending(handle):
                    # A single record exceeds the buffers: grow and retry.
                    payload_cap *= 2
                    head_cap *= 2
                    continue
                return
            yield FastqChunk(
                sequences=seq_buf[:offsets[n]],
                qualities=qual_buf[:offsets[n]],
                offsets=offsets[:n + 1],
                headers=head_buf[:head_offsets[n]],
                header_offsets=head_offsets[:n + 1],
                # Consumers that provably drop every view may recycle
                # the backing pages (runtime.release) — see the
                # pipeline's record-arena mode.
                pool_bases=(seq_buf, qual_buf, head_buf),
            )
            if n < chunk_records:
                # Buffers filled before the record quota: size the next
                # buffers from the observed per-record payload (+25%), so
                # record sizes larger than the initial estimate converge in
                # one step instead of oscillating with the tight sizing
                # below.  No further tightening after this.
                bpr = -(-int(offsets[n]) // n)
                hpr = -(-int(head_offsets[n]) // n)
                payload_cap = max(payload_cap,
                                  chunk_records * (bpr + (bpr >> 2) + 2))
                head_cap = max(head_cap,
                               chunk_records * (hpr + (hpr >> 2) + 2))
                adapted = True
            elif not adapted:
                # Right-size subsequent buffers to the observed per-record
                # payload (+6% headroom): downstream keeps these chunks
                # alive for the rewrite pass, and tight buffers mean the
                # views pin almost no slack (no compaction copies).
                payload_cap = max(
                    int(offsets[n]) + (int(offsets[n]) >> 4) + 4096,
                    chunk_records * 8)
                head_cap = max(
                    int(head_offsets[n]) + (int(head_offsets[n]) >> 4)
                    + 4096, chunk_records * 8)
                adapted = True
    finally:
        close(handle)


def average_error_rates_native(qual_data: np.ndarray,
                               offsets: np.ndarray,
                               phred_offset: int = 33) -> np.ndarray:
    """float64 [N] mean error rate per ragged record (C hot loop).

    Bit-identical to the reference's sequential accumulation
    (_fastqmodule.c:58-75).  Raises ValueError on out-of-range phred bytes.
    """
    n = len(offsets) - 1
    out = np.empty(n, dtype=np.float64)
    qual_data = np.ascontiguousarray(qual_data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if _avg_err_mt is not None and n >= (1 << 15):
        # Records split across threads; per-record arithmetic is the
        # identical sequential loop, and the reported bad byte is the
        # batch-wide first.
        bad = _avg_err_mt(qual_data, offsets, n, int(phred_offset),
                          out, 0)
    else:
        bad = _lib.fq_avg_error_rates(qual_data, offsets, n,
                                      int(phred_offset), out)
    if bad >= 0:
        char = int(qual_data[bad])
        raise ValueError(
            f"Character {chr(char)} outside of valid phred range "
            f"('{chr(phred_offset)}' to '{chr(126)}')")
    return out


class NativeGzWriter:
    """zlib-backed block writer (transparent for .gz and plain paths)."""

    def __init__(self, filename: str, compresslevel: int = 1):
        self._handle = _lib.fqw_open(os.fsencode(filename),
                                     int(compresslevel))
        if not self._handle:
            raise OSError(f"could not open {filename!r} for writing")

    def write(self, data) -> int:
        arr = np.frombuffer(data, dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        if len(arr) and _lib.fqw_write(self._handle, arr,
                                       len(arr)) != _FQ_OK:
            raise OSError("native gzip write failed")
        return len(arr)

    def close(self) -> None:
        if self._handle:
            rc = _lib.fqw_close(self._handle)
            self._handle = None
            if rc != _FQ_OK:
                raise OSError("native gzip close failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class KeyAccumulator:
    """Streaming (key -> count, first_pos) aggregation in C.

    Replaces pass 1's per-chunk sort/unique + global merge: each chunk's
    ragged keys feed a GIL-free open-addressing hash table; ``export``
    dumps unique keys with quality-passing counts and the global index of
    each key's first occurrence among all records (pass 3's first-wins
    rule, reference __init__.py:203-206, becomes a stateless equality
    test against first_pos).
    """

    collapsed = True  # export() emits each key exactly once (hash table)

    def __init__(self, expected: int = 1 << 20):
        self._handle = _lib.acc_new(int(expected))
        if not self._handle:
            raise MemoryError("could not allocate key accumulator")

    def add(self, key_data: np.ndarray, key_offsets: np.ndarray,
            counted, base: int) -> None:
        """Insert one chunk.  ``counted``: optional uint8/bool [n] mask of
        records that increment the count (first_pos tracks every record);
        ``base``: global index of the chunk's first record."""
        n = len(key_offsets) - 1
        key_data = np.ascontiguousarray(key_data, dtype=np.uint8)
        key_offsets = np.ascontiguousarray(key_offsets, dtype=np.int64)
        if counted is None:
            cptr = None
        else:
            counted = np.ascontiguousarray(counted, dtype=np.uint8)
            cptr = counted.ctypes.data_as(ctypes.c_void_p)
        rc = _lib.acc_add(self._handle, key_data, key_offsets, cptr,
                          n, int(base))
        if rc != _FQ_OK:
            raise MemoryError("key accumulator allocation failure")

    def add_mark(self, key_data: np.ndarray, key_offsets: np.ndarray,
                 counted, base: int) -> np.ndarray:
        """Like :meth:`add`, but also returns a uint8 [n] mask marking the
        records that became their key's first occurrence SO FAR: inserts
        of unseen keys, plus records that lowered an existing key's
        first_pos (possible only when batches arrive out of global
        record order — parallel range ingest).  The final first
        occurrence of every key is always marked, so the mask is exactly
        the candidate set pass 3 may emit (record-arena mode);
        superseded marks are filtered there by position."""
        n = len(key_offsets) - 1
        key_data = np.ascontiguousarray(key_data, dtype=np.uint8)
        key_offsets = np.ascontiguousarray(key_offsets, dtype=np.int64)
        if counted is None:
            cptr = None
        else:
            counted = np.ascontiguousarray(counted, dtype=np.uint8)
            cptr = counted.ctypes.data_as(ctypes.c_void_p)
        is_new = np.empty(n, dtype=np.uint8)
        rc = _lib.acc_add_mark(self._handle, key_data, key_offsets, cptr,
                               n, int(base), is_new)
        if rc != _FQ_OK:
            raise MemoryError("key accumulator allocation failure")
        return is_new

    def lookup(self, key_data: np.ndarray,
               key_offsets: np.ndarray) -> np.ndarray:
        """int64 [n]: stored first_pos per queried key, -1 where absent.

        Insert keys with ``base=0`` in one ``add`` call and first_pos is
        the insertion row id — i.e. this doubles as an exact index map.
        """
        n = len(key_offsets) - 1
        out = np.empty(n, dtype=np.int64)
        _lib.acc_lookup_mt(
            self._handle,
            np.ascontiguousarray(key_data, dtype=np.uint8),
            np.ascontiguousarray(key_offsets, dtype=np.int64),
            n, out, min(8, os.cpu_count() or 1))
        return out

    def export(self):
        """-> (key_data, key_offsets, counts, first_pos) in table order."""
        from ..runtime import big_empty
        n = _lib.acc_size(self._handle)
        nbytes = _lib.acc_key_bytes(self._handle)
        key_out = big_empty(nbytes, dtype=np.uint8)
        offsets_out = big_empty(n + 1, dtype=np.int64)
        counts_out = big_empty(n, dtype=np.int64)
        firstpos_out = big_empty(n, dtype=np.int64)
        _lib.acc_export_port(self._handle, key_out, offsets_out,
                             counts_out, firstpos_out)
        return key_out, offsets_out, counts_out, firstpos_out

    def export_hashes(self) -> np.ndarray:
        """uint64 [n]: per-key content hash, aligned with ``export``."""
        from ..runtime import big_empty
        n = _lib.acc_size(self._handle)
        out = big_empty(n, dtype=np.uint64)
        _lib.acc_export_hashes(self._handle, out)
        return out

    def byte_presence(self) -> np.ndarray:
        """bool [256]: which byte values occur in any stored key —
        collected at insertion, so deriving the alphabet needs no rescan
        of the (multi-gigabyte) key table."""
        out = np.zeros(256, dtype=np.uint8)
        _lib.acc_byte_presence(self._handle, out)
        return out.astype(bool)

    def close(self) -> None:
        if self._handle:
            _lib.acc_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def render_records_native(seq: np.ndarray, qual: np.ndarray,
                          offsets: np.ndarray, head: np.ndarray,
                          head_offsets: np.ndarray,
                          rows: np.ndarray,
                          return_offsets: bool = False):
    """Serialize selected FASTQ records to one uint8 buffer (C memcpy).

    Each row's output offset is the cumsum of rendered record sizes, so
    rows render independently — split across pthreads for large batches.
    With ``return_offsets`` the per-row output offsets come back too (as
    an int64 [n+1] array with total-size sentinel), making the result a
    ragged record store that ``gather_ragged_native`` can sub-select —
    the record-arena fast path of pass 3.
    """
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    s0 = offsets[rows]
    sl = offsets[rows + 1] - s0
    hl = head_offsets[rows + 1] - head_offsets[rows]
    if not len(rows):
        empty = np.empty(0, dtype=np.uint8)
        if return_offsets:
            return empty, np.zeros(1, dtype=np.int64)
        return empty
    sizes = 1 + hl + 1 + sl + 3 + sl + 1
    bounds = np.empty(len(rows) + 1, dtype=np.int64)
    bounds[0] = 0
    np.cumsum(sizes, out=bounds[1:])
    out_offsets = bounds[:-1]
    total = int(bounds[-1])
    from ..runtime import big_empty
    out = big_empty(total, dtype=np.uint8)
    if total:
        nthreads = min(8, os.cpu_count() or 1) if len(rows) >= 4096 else 1
        _lib.fq_render_records_mt(
            np.ascontiguousarray(seq, dtype=np.uint8),
            np.ascontiguousarray(qual, dtype=np.uint8),
            np.ascontiguousarray(offsets, dtype=np.int64),
            np.ascontiguousarray(head, dtype=np.uint8),
            np.ascontiguousarray(head_offsets, dtype=np.int64),
            rows, len(rows), out_offsets, out, nthreads)
    if return_offsets:
        return out, bounds
    return out


def hash_rows_native(window: np.ndarray, seed: int, strong: bool = True,
                     threads: int = 0) -> np.ndarray:
    """uint64 [n] row-content hashes of a uint8 [n, w] matrix view.

    Bit-identical C twin of ``ops.bucket._hash_window_rows`` (which
    computes ``seed`` from its salt and finishes with the same
    finalizer); accepts strided ROW views (e.g. ``matrix[:, a:b]``) as
    long as columns are contiguous — one pass over the bytes instead of
    numpy's pad-copy + transpose + per-column ufunc sweeps, with rows
    split across pthreads.  Raises ValueError for layouts the C loop
    cannot walk (callers fall back to the numpy path).
    """
    n, w = window.shape
    if window.dtype != np.uint8:
        raise ValueError("window must be uint8")
    if n and w and (window.strides[1] != 1 or window.strides[0] < w):
        raise ValueError("rows must be forward-strided, columns contiguous")
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    _lib.fq_hash_rows(
        ctypes.c_void_p(window.__array_interface__["data"][0]),
        n, window.strides[0] if w else 0, w,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        1 if strong else 0, threads, out)
    return out


def rank_rows_native(matrix: np.ndarray, threads: int = 0) -> np.ndarray:
    """int64 [m] lexicographic rank of the rows of a contiguous uint8
    [m, w] matrix — bit-identical to
    ``rank[np.argsort(matrix.view(void), kind="stable")] = arange(m)``
    (memcmp order, ties by row index), via a threaded C sample sort.
    Raises ValueError for layouts the C loop cannot walk."""
    m, w = matrix.shape
    if _rank_rows is None:
        raise ValueError("stale _fastq_io.so lacks fq_rank_rows")
    if matrix.dtype != np.uint8:
        raise ValueError("matrix must be uint8")
    if m and w and (matrix.strides[1] != 1 or matrix.strides[0] != w):
        raise ValueError("matrix must be C-contiguous")
    rank = np.empty(m, dtype=np.int64)
    if m == 0:
        return rank
    if w == 0:
        return np.arange(m, dtype=np.int64)
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    scratch = np.empty(2 * m + 64 * 8, dtype=np.int64)
    rc = _rank_rows(
        ctypes.c_void_p(matrix.__array_interface__["data"][0]),
        m, w, threads, scratch, rank)
    if rc != _FQ_OK:
        raise MemoryError("fq_rank_rows failed")
    return rank


def pack_nibbles_native(matrix: np.ndarray, lanes: int,
                        lut: "np.ndarray | None" = None,
                        threads: int = 0,
                        out: "np.ndarray | None" = None) -> np.ndarray:
    """uint32 [n, lanes] nibble-packed rows (bit-identical to
    ops.encode.pack_nibbles), optionally translating raw bytes through a
    uint8[256] ``lut`` in the same pass.  One C pass over the rows vs
    numpy's ~10; raises ValueError for unsupported layouts/alphabets so
    callers fall back to the numpy path.  ``out``: a C-contiguous uint32
    [n, lanes] array to pack into (a pinned upload buffer) instead of a
    new one."""
    n, w = matrix.shape
    if _pack_nibbles is None:
        raise ValueError("stale _fastq_io.so lacks fq_pack_nibbles")
    if matrix.dtype != np.uint8:
        raise ValueError("matrix must be uint8")
    if n and w and (matrix.strides[1] != 1 or matrix.strides[0] < w):
        raise ValueError("rows must be forward-strided, columns contiguous")
    if lut is not None:
        lut = np.ascontiguousarray(lut, dtype=np.uint8)
        if lut.shape != (256,):
            raise ValueError("lut must be uint8[256]")
    if out is None:
        out = np.empty((n, lanes), dtype=np.uint32)
    elif out.shape != (n, lanes) or out.dtype != np.uint32 \
            or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous uint32 [n, lanes]")
    if n == 0:
        return out
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    rc = _pack_nibbles(
        ctypes.c_void_p(matrix.__array_interface__["data"][0]),
        n, matrix.strides[0] if w else 0, w,
        ctypes.c_void_p(lut.__array_interface__["data"][0])
        if lut is not None else None,
        lanes, threads, out.reshape(-1))
    if rc == _FQ_ERR_FORMAT:
        raise ValueError("pack_nibbles requires alphabet indices < 16")
    if rc != _FQ_OK:
        raise MemoryError("fq_pack_nibbles failed")
    return out


def hash_owner_select_native(window: np.ndarray, seed: int, salt_mix: int,
                             pid: int, nproc: int, threads: int = 0
                             ) -> "tuple[np.ndarray, np.ndarray]":
    """(owned row indices int64, their weak hashes uint64) in one pass.

    Fused multi-host bucket sharding primitive: hashes every row of the
    uint8 [n, w] window (bit-identical to ``hash_rows_native`` with
    ``strong=False``), derives each row's owning host exactly as
    ``parallel.distributed.bucket_owner_mask`` does
    (``mix64(hash ^ salt_mix) % nproc``), and compacts the rows owned by
    ``pid`` — replacing three replicated ~n-sized numpy passes per
    segment on every host.  Raises ValueError for layouts the C loop
    cannot walk (callers fall back to the numpy path).
    """
    n, w = window.shape
    if _hash_owner is None:
        raise ValueError("stale _fastq_io.so lacks fq_hash_owner_select")
    if window.dtype != np.uint8:
        raise ValueError("window must be uint8")
    if n and w and (window.strides[1] != 1 or window.strides[0] < w):
        raise ValueError("rows must be forward-strided, columns contiguous")
    idx = np.empty(n, dtype=np.int64)
    hashes = np.empty(n, dtype=np.uint64)
    if n == 0 or w == 0:
        return idx[:0], hashes[:0]
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    count = _hash_owner(
        ctypes.c_void_p(window.__array_interface__["data"][0]),
        n, window.strides[0], w,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        ctypes.c_uint64(salt_mix & 0xFFFFFFFFFFFFFFFF),
        pid, nproc, threads, idx, hashes)
    return idx[:count], hashes[:count]


def hash_ragged_native(data: np.ndarray, offsets: np.ndarray,
                       seed: int, strong: bool = True,
                       threads: int = 0) -> np.ndarray:
    """uint64 [n] content hashes of ragged rows (row i spans
    ``data[offsets[i]:offsets[i+1]]``) — same word algorithm as
    :func:`hash_rows_native`, so a ragged row and a fixed-width row with
    equal bytes hash equal.  Serves as the second, independent content
    hash of the multi-host key exchange."""
    n = len(offsets) - 1
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    _lib.fq_hash_ragged(
        np.ascontiguousarray(data, dtype=np.uint8),
        np.ascontiguousarray(offsets, dtype=np.int64),
        n, ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        1 if strong else 0, threads, out)
    return out


def gather_ragged_native(data: np.ndarray, offsets: np.ndarray,
                         rows: np.ndarray,
                         out_offsets: np.ndarray) -> np.ndarray:
    """Packed bytes of the selected ragged rows, in ``rows`` order.

    ``out_offsets`` must be the cumulative lengths of the selected rows
    (``out_offsets[i+1] - out_offsets[i] == len(row rows[i])``); one C
    memcpy per row, thread-parallel.
    """
    from ..runtime import big_empty
    n = len(rows)
    out = big_empty(int(out_offsets[-1]) if n else 0, dtype=np.uint8)
    if n == 0:
        return out
    _lib.fq_gather_ragged(
        np.ascontiguousarray(data, dtype=np.uint8),
        np.ascontiguousarray(offsets, dtype=np.int64),
        np.ascontiguousarray(rows, dtype=np.int64), n,
        np.ascontiguousarray(out_offsets, dtype=np.int64), out,
        min(8, os.cpu_count() or 1))
    return out


def union_find_native(n: int, pairs_i: np.ndarray,
                      pairs_j: np.ndarray) -> np.ndarray:
    """int64 [n] min-index component labels (C union-find, GIL-free)."""
    labels = np.empty(n, dtype=np.int64)
    _lib.uf_components(
        int(n),
        np.ascontiguousarray(pairs_i, dtype=np.int64),
        np.ascontiguousarray(pairs_j, dtype=np.int64),
        len(pairs_i), labels)
    return labels



class ShardedKeyAccumulator:
    """KeyAccumulator over S hash shards with threaded inserts.

    Pass 1's single insert thread lags the parse pipeline at large
    inputs (~30 s of accumulate backlog at 100M reads); routing keys by
    their high hash bits to S independent tables lets S threads insert
    concurrently while preserving the serial table's semantics exactly:
    every key lives in one shard (global uniqueness), shards visit their
    records in ascending global order (first-occurrence positions
    unchanged), and ``export`` is the deterministic concatenation of the
    shard tables (_finalize_groups accepts any fixed order).
    """

    collapsed = True

    def __init__(self, expected: int = 1 << 20, shards: int = 0):
        if shards <= 0:
            shards = min(4, os.cpu_count() or 1)
        self._handles = []
        for _ in range(shards):
            h = _lib.acc_new(int(expected // shards + 1))
            if not h:
                raise MemoryError("could not allocate key accumulator")
            self._handles.append(h)
        self._harr = np.array(self._handles, dtype=np.uint64)

    def _add(self, key_data, key_offsets, counted, base, is_new):
        n = len(key_offsets) - 1
        key_data = np.ascontiguousarray(key_data, dtype=np.uint8)
        key_offsets = np.ascontiguousarray(key_offsets, dtype=np.int64)
        if counted is None:
            cptr = None
        else:
            counted = np.ascontiguousarray(counted, dtype=np.uint8)
            cptr = counted.ctypes.data_as(ctypes.c_void_p)
        iptr = None if is_new is None else             is_new.ctypes.data_as(ctypes.c_void_p)
        rc = _lib.acc_add_sharded(self._harr, len(self._handles),
                                  key_data, key_offsets, cptr,
                                  n, int(base), iptr)
        if rc != _FQ_OK:
            raise MemoryError("key accumulator allocation failure")

    def add(self, key_data, key_offsets, counted, base: int) -> None:
        self._add(key_data, key_offsets, counted, base, None)

    def add_mark(self, key_data, key_offsets, counted,
                 base: int) -> np.ndarray:
        n = len(key_offsets) - 1
        is_new = np.empty(n, dtype=np.uint8)
        self._add(key_data, key_offsets, counted, base, is_new)
        return is_new

    def export(self):
        """Concatenated shard exports (deterministic shard-major order).

        Shards export concurrently — each sweeps its own table into a
        disjoint slice of the output (ctypes drops the GIL), so the
        3 GiB-scale copy at 100M reads costs one shard's wall time."""
        from concurrent.futures import ThreadPoolExecutor

        from ..runtime import big_empty
        sizes = [int(_lib.acc_size(h)) for h in self._handles]
        nbytes = [int(_lib.acc_key_bytes(h)) for h in self._handles]
        n = sum(sizes)
        total = sum(nbytes)
        key_out = big_empty(total, dtype=np.uint8)
        offsets_out = big_empty(n + 1, dtype=np.int64)
        counts_out = big_empty(n, dtype=np.int64)
        firstpos_out = big_empty(n, dtype=np.int64)
        rows = np.concatenate([[0], np.cumsum(sizes)])
        bytes_at = np.concatenate([[0], np.cumsum(nbytes)])

        def export_shard(s):
            # Keys/counts/firstpos go straight into disjoint slices of
            # the shared outputs; offsets go to a PRIVATE buffer because
            # adjacent shards share the boundary slot (this shard's
            # sentinel is the next shard's first offset).
            row, byte = int(rows[s]), int(bytes_at[s])
            local_offsets = np.empty(sizes[s] + 1, dtype=np.int64)
            _lib.acc_export_port(self._handles[s], key_out[byte:],
                                 local_offsets, counts_out[row:],
                                 firstpos_out[row:])
            np.add(local_offsets[:-1], byte, out=offsets_out[row:row + sizes[s]])

        with ThreadPoolExecutor(max_workers=len(self._handles)) as pool:
            list(pool.map(export_shard, range(len(self._handles))))
        offsets_out[n] = total
        return key_out, offsets_out, counts_out, firstpos_out

    def export_hashes(self) -> np.ndarray:
        from ..runtime import big_empty
        sizes = [int(_lib.acc_size(h)) for h in self._handles]
        out = big_empty(sum(sizes), dtype=np.uint64)
        row = 0
        for h, sz in zip(self._handles, sizes):
            _lib.acc_export_hashes(h, out[row:])
            row += sz
        return out

    def byte_presence(self) -> np.ndarray:
        acc = np.zeros(256, dtype=np.uint8)
        tmp = np.zeros(256, dtype=np.uint8)
        for h in self._handles:
            _lib.acc_byte_presence(h, tmp)
            acc |= tmp
        return acc.astype(bool)

    def close(self) -> None:
        for h in self._handles:
            _lib.acc_free(h)
        self._handles = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def radix_sort_u64_native(values: np.ndarray) -> np.ndarray:
    """Sort a uint64 array ascending IN PLACE (returns it).  C LSB radix
    with constant-digit pass skipping; ~3x numpy's introsort at tens of
    millions of elements.  Above 4M elements a top-byte partition
    parallelizes both the scatter and the per-partition sorts across
    host threads."""
    values = np.ascontiguousarray(values, dtype=np.uint64)
    if _radix_mt is not None and len(values) >= (1 << 22):
        rc = _radix_mt(len(values), values, 0)
    else:
        rc = _lib.fq_radix_sort_u64(len(values), values)
    if rc != _FQ_OK:
        raise MemoryError("fq_radix_sort_u64 allocation failed")
    return values


def hamming_verify_pairs_native(matrix: np.ndarray, gi: np.ndarray,
                                gj: np.ndarray, max_distance: int,
                                nthreads: int = 0
                                ) -> "np.ndarray | None":
    """bool [P]: hamming(matrix[gi], matrix[gj]) <= max_distance over
    equal-width uint8 rows — threaded C with the reference's fast-fail
    exit (distances.h:22-30), no gathered row temporaries.  Returns
    None when the symbol is absent (stale .so) or the layout is not
    row-major contiguous; callers fall back to numpy."""
    if _ham_verify is None:
        return None
    n, w = matrix.shape
    if n == 0 or w == 0 or matrix.dtype != np.uint8 \
            or not matrix.flags.c_contiguous:
        return None
    gi = np.ascontiguousarray(gi, dtype=np.int64)
    gj = np.ascontiguousarray(gj, dtype=np.int64)
    keep = np.empty(len(gi), dtype=np.uint8)
    _ham_verify(matrix.reshape(-1), w, w, gi, gj, len(gi),
                int(max_distance), keep, int(nthreads))
    return keep.view(bool)


def edit_verify_native(padded: np.ndarray, lengths: np.ndarray,
                       cand_i: np.ndarray, cand_j: np.ndarray,
                       max_distance: int,
                       nthreads: int = 0) -> np.ndarray:
    """bool [P]: banded Levenshtein <= max_distance for candidate index
    pairs over a padded uint8 key matrix — multithreaded host DP.

    Semantics match the reference's within_edit_distance
    (distances.h:33-88); used when the measured host-device wire makes
    shipping the key matrix costlier than the whole DP
    (engine._edit_edges_entries cost model)."""
    import os as _os
    n, stride = padded.shape
    p = len(cand_i)
    keep = np.empty(p, dtype=np.uint8)
    if p == 0:
        return keep.astype(bool)
    if nthreads <= 0:
        nthreads = min(_os.cpu_count() or 1, 8)
    rc = _lib.fq_edit_verify(
        np.ascontiguousarray(padded), int(stride),
        np.ascontiguousarray(lengths, dtype=np.int64),
        np.ascontiguousarray(cand_i, dtype=np.int64),
        np.ascontiguousarray(cand_j, dtype=np.int64),
        int(p), int(max_distance), keep, int(nthreads))
    if rc != _FQ_OK:
        raise ValueError(
            f"fq_edit_verify rejected max_distance={max_distance}")
    return keep.astype(bool)


def owned_merge_native(g_len: np.ndarray, g_h1: np.ndarray,
                       g_h2: np.ndarray, g_cnt: np.ndarray,
                       g_fp: np.ndarray, pid: int, nproc: int,
                       host_starts: np.ndarray):
    """One-pass hash aggregation of the owned gathered-metadata rows.

    Returns ``(rep_gidx, counts, first_pos, lengths)`` with exactly the
    semantics of parallel/distributed._owned_meta_merge's tournament
    path (summed counts, min first positions, salted-mix representative
    with smallest-row tie-break, zero-count keys dropped) — emission
    order differs (first-seen vs h1-sorted) but the caller canonicalizes
    by representative row order, so native and numpy hosts interoperate.
    """
    n_rows = len(g_cnt)
    # Worst case every owned row is a distinct key.
    rep = np.empty(n_rows, dtype=np.int64)
    cnt = np.empty(n_rows, dtype=np.int64)
    fp = np.empty(n_rows, dtype=np.int64)
    ln = np.empty(n_rows, dtype=np.int64)
    n_out = ctypes.c_int64(0)
    rc = _lib.fq_owned_merge(
        int(n_rows),
        np.ascontiguousarray(g_len, dtype=np.int64),
        np.ascontiguousarray(g_h1, dtype=np.uint64),
        np.ascontiguousarray(g_h2, dtype=np.uint64),
        np.ascontiguousarray(g_cnt, dtype=np.int64),
        np.ascontiguousarray(g_fp, dtype=np.int64),
        int(pid), int(nproc),
        np.ascontiguousarray(host_starts, dtype=np.int64),
        len(host_starts), rep, cnt, fp, ln, ctypes.byref(n_out))
    if rc != _FQ_OK:
        raise MemoryError("fq_owned_merge allocation failed")
    k = n_out.value
    return (rep[:k].copy(), cnt[:k].copy(), fp[:k].copy(),
            ln[:k].copy())


def sort_permute4_native(cols: np.ndarray):
    """Sort a [4, n] int64 column block by ascending row 0 in O(n).

    Returns four new arrays (c0_sorted, c1, c2, c3 permuted alike) —
    the reorder exchange_merge_key_tables needs to put merged keys in
    ascending representative-row order.  LSB radix in C; bit-identical
    to ``order = np.argsort(cols[0], kind="stable"); cols[:, order]``
    because row-0 values are unique (one gathered row per key).
    """
    from ..runtime import big_empty
    n = cols.shape[1]
    outs = [big_empty((n,), dtype=np.int64) for _ in range(4)]
    ins = [np.ascontiguousarray(cols[i], dtype=np.int64) for i in range(4)]
    rc = _lib.fq_sort_permute4(int(n), *ins, *outs)
    if rc != _FQ_OK:
        raise MemoryError("fq_sort_permute4 allocation failed")
    return tuple(outs)


def partition_assemble_native(labels: np.ndarray):
    """Counting-sort partition assembly over min-index component labels.

    Returns ``(order, starts, ends, cluster_of, local_index)`` exactly
    matching the ``np.argsort(labels, kind="stable")`` grouping (the
    trie's pop_cluster partition analog, _triemodule.c:778-897) in O(n).
    """
    n = len(labels)
    order = np.empty(n, dtype=np.int64)
    cluster_of = np.empty(n, dtype=np.int64)
    local_index = np.empty(n, dtype=np.int64)
    starts_buf = np.empty(n + 1, dtype=np.int64)
    num = ctypes.c_int64(0)
    rc = _lib.fq_partition_assemble(
        int(n), np.ascontiguousarray(labels, dtype=np.int64),
        order, cluster_of, local_index, starts_buf, ctypes.byref(num))
    if rc != _FQ_OK:
        raise MemoryError("fq_partition_assemble allocation failed")
    c = num.value
    # Plain copies: the n+1-sized scratch would otherwise stay pinned by
    # two small views for the run's whole pass 2.
    starts = starts_buf[:c].copy()
    ends = starts_buf[1:c + 1].copy()
    return order, starts, ends, cluster_of, local_index
