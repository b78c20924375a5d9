"""End-to-end deduplication pipeline (three passes).

Counterpart of ``fastqdedup_tpu/pipeline.py``, including its
multi-process modes (strided and byte-range ingest across processes,
key-table exchange, sharded input, part-file output merge) over
``torch.distributed`` (parallel/distributed.py).

Drop-in equivalent of the reference's ``deduplicate_cluster``
(/root/reference/src/fastqdedup/__init__.py:209-288), re-architected for
batch execution:

* **Pass 1 — ingest**: columnar FASTQ chunks -> vectorized check-slice keys
  -> quality filter (bit-exact float64 LUT reduction, see
  fastqdedup_tpu_torch.quality) -> per-chunk sort/unique exact-duplicate collapse
  into a global (key -> count) map.  This replaces per-record trie insertion
  (_triemodule.c:222-288).
* **Pass 2 — cluster & dissect**: the dense engine partitions unique keys
  into within-distance connected components on device
  (fastqdedup_tpu_torch.engine), and the dissection strategies pick
  representative keys per cluster using the already-computed adjacency.
* **Pass 3 — filtered rewrite**: re-stream the inputs, emit the first record
  whose key is in the kept set, then retire the key — first occurrence in
  file order wins, exactly like the reference (__init__.py:203-206), except
  the kept set holds exact keys rather than 64-bit Python hashes (the
  reference's hash-collision quirk is deliberately not reproduced; see
  SURVEY.md section 5).
"""

import functools
import gc
import logging
import os
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np

from .dissect import (
    CLUSTER_DISSECTION_METHODS,
    ClusterDissectionFunc,
    cluster_dissection_directional,
    dissect_partition,
)
from .engine import KeyGroups, build_partition_groups
from .io.fastq import FastqChunk, FastqFormatError, read_fastq_chunks
from .io.opener import deflates_on_card, xopen
from .quality import ragged_average_error_rate
from .utils import trace
from .utils.ragged import (
    apply_slice,
    concat_ragged,
    rows_as_void,
)
from .utils.timing import Timer

DEFAULT_MAX_DISTANCE = 1
DEFAULT_MAX_AVERAGE_ERROR_RATE = 0.001
DEFAULT_CHUNK_RECORDS = 1 << 18
# Global-record-index stride between hosts in sharded-input mode: each
# host's records occupy [pid * stride, pid * stride + its record count).
_SHARD_STRIDE = 1 << 44

logger = logging.getLogger("fastqdedup")


def _total_ram_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 32 * 1024 ** 3


def _slice_chunk(chunk: FastqChunk, start: int, stop: int) -> FastqChunk:
    """Record range [start, stop) of a chunk as views (no copies)."""
    if start == 0 and stop == chunk.count:
        return chunk  # keeps pool_bases: a full-range slice IS the chunk
    o0 = chunk.offsets[start]
    h0 = chunk.header_offsets[start]
    return FastqChunk(
        sequences=chunk.sequences[o0:chunk.offsets[stop]],
        qualities=chunk.qualities[o0:chunk.offsets[stop]],
        offsets=chunk.offsets[start:stop + 1] - o0,
        headers=chunk.headers[h0:chunk.header_offsets[stop]],
        header_offsets=chunk.header_offsets[start:stop + 1] - h0,
        # Recycling eligibility travels with the views; the refcount
        # gate in runtime.release turns any premature or duplicate
        # attempt (other slices of this chunk still alive) into a no-op,
        # so the LAST consumer's recycle is the one that lands.
        pool_bases=chunk.pool_bases,
    )


def _concat_chunks(parts: List[FastqChunk]) -> FastqChunk:
    if len(parts) == 1:
        return parts[0]
    seq = np.concatenate([p.sequences for p in parts])
    qual = np.concatenate([p.qualities for p in parts])
    head = np.concatenate([p.headers for p in parts])
    offsets = [parts[0].offsets]
    h_offsets = [parts[0].header_offsets]
    for p in parts[1:]:
        offsets.append(p.offsets[1:] + offsets[-1][-1])
        h_offsets.append(p.header_offsets[1:] + h_offsets[-1][-1])
    # The concat COPIES the payloads, but the source buffers' recycle
    # eligibility must survive: the merged chunk is now their last
    # consumer (dedupe by identity — slices of one source share bases).
    bases: List[np.ndarray] = []
    for p in parts:
        for b in p.pool_bases or ():
            if not any(b is seen for seen in bases):
                bases.append(b)
    return FastqChunk(seq, qual, np.concatenate(offsets), head,
                      np.concatenate(h_offsets),
                      pool_bases=tuple(bases) or None)


def _rechunk(source: Iterator[FastqChunk], chunk_records: int
             ) -> Iterator[FastqChunk]:
    """Re-buffer a chunk stream to EXACTLY chunk_records per chunk (final
    chunk excepted).

    The native parser legitimately yields short chunks mid-file when its
    byte-capacity buffers fill before the record quota; the lockstep zip
    across paired files relies on uniform chunk sizes, so uneven chunks
    must be realigned here (a mismatch must only ever mean end-of-file).
    """
    pending: List[FastqChunk] = []
    pending_count = 0
    for chunk in source:
        pending.append(chunk)
        pending_count += chunk.count
        while pending_count >= chunk_records:
            take_last = pending[-1].count - (pending_count - chunk_records)
            head = pending[:-1]
            if take_last > 0:
                head = head + [_slice_chunk(pending[-1], 0, take_last)]
            yield _concat_chunks(head)
            if take_last < pending[-1].count:
                pending = [_slice_chunk(pending[-1], take_last,
                                        pending[-1].count)]
                pending_count = pending[0].count
            else:
                pending = []
                pending_count = 0
    if pending_count:
        yield _concat_chunks(pending)


def _capped_chunks(source: Iterator[FastqChunk], n_records: int
                   ) -> Iterator[FastqChunk]:
    """First ``n_records`` records of a chunk stream (range-mode cap:
    the byte-range reader runs to EOF; the record budget stops it)."""
    left = n_records
    for chunk in source:
        if left <= 0:
            return
        if chunk.count <= left:
            left -= chunk.count
            yield chunk
        else:
            yield _slice_chunk(chunk, 0, left)
            return


class _Split(NamedTuple):
    """One reader's part of a single BGZF file (:func:`_plan_split_ranges`):
    the records from the first record start after member ``lo`` to the
    first record start after member ``hi`` (-1: to EOF)."""
    lo: int
    hi: int


# A reader's part of one input file: a split, or the counted plan's
# ``(start_offset, skip_newlines, n_records)``.
_RangeEntry = Union[_Split, Tuple[int, int, int]]


def _range_chunks(path: str, chunk_records: int, entry: _RangeEntry
                  ) -> Iterator[FastqChunk]:
    """The chunks of one reader's part of ``path``."""
    from .native.loader import read_fastq_chunks_native
    if isinstance(entry, _Split):
        return read_fastq_chunks_native(path, chunk_records, split=entry)
    start, skip, n_records = entry
    return _capped_chunks(read_fastq_chunks_native(
        path, chunk_records, range_start=start, skip_newlines=skip),
        n_records)


def _zip_chunks_serial(input_files: List[str], chunk_records: int,
                       range_plan: Optional[List[_RangeEntry]] = None
                       ) -> Iterator[Tuple[FastqChunk, ...]]:
    """Read all files in lockstep chunks; like zip(), stop at the shortest
    file (matching the reference's zip at __init__.py:180).

    With multiple files each file parses on its own thread (the native
    parser releases the GIL inside zlib/parse), so paired-end ingest costs
    one file's wall time, not the sum.

    ``range_plan``: one entry per file.  A counted plan's
    ``(start_offset, skip_newlines, n_records)`` (see
    :func:`_plan_input_ranges`): the reader opens at its BGZF member
    boundary, skips to its record boundary, and is capped at its record
    budget.  A :class:`_Split`: the reader finds its own first record and
    stops where the next split's reader starts.
    """
    if range_plan is not None:
        iterators = [
            _rechunk(_range_chunks(f, chunk_records, entry), chunk_records)
            for f, entry in zip(input_files, range_plan)]
    else:
        iterators = [_rechunk(read_fastq_chunks(f, chunk_records),
                              chunk_records) for f in input_files]
    pool = None
    if len(input_files) > 1:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=len(input_files))
    try:
        while True:
            if pool is not None:
                futures = [pool.submit(trace.carry(next), it, None)
                           for it in iterators]
                maybe_chunks = [f.result() for f in futures]
            else:
                maybe_chunks = [next(iterators[0], None)]
            if any(c is None for c in maybe_chunks):
                return
            chunks: List[FastqChunk] = maybe_chunks  # all non-None
            counts = [c.count for c in chunks]
            if len(set(counts)) > 1:
                low = min(counts)
                chunks = [_truncate_chunk(c, low) for c in chunks]
                if low:
                    yield tuple(chunks)
                return
            yield tuple(chunks)
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def _zip_chunks(input_files: List[str], chunk_records: int,
                prefetch: int = 2,
                range_plan: Optional[List[_RangeEntry]] = None
                ) -> Iterator[Tuple[FastqChunk, ...]]:
    """Prefetching wrapper around :func:`_zip_chunks_serial`.

    Parsing runs on a reader thread (the native chunk parser releases the
    GIL inside zlib/parse), overlapping ingest with device compute and
    host-side batch work.  Greenfield vs the reference, which parses
    records inline on the single thread (__init__.py:242-252).  The
    single-producer special case of :func:`_parallel_range_chunks`.
    """
    for _base, chunks in _parallel_range_chunks(
            input_files, chunk_records, [(range_plan, 0)],
            queue_depth=prefetch):
        yield chunks


def _truncate_chunk(chunk: FastqChunk, count: int) -> FastqChunk:
    return FastqChunk(
        sequences=chunk.sequences[:chunk.offsets[count]],
        qualities=chunk.qualities[:chunk.offsets[count]],
        offsets=chunk.offsets[:count + 1],
        headers=chunk.headers[:chunk.header_offsets[count]],
        header_offsets=chunk.header_offsets[:count + 1],
    )


def _id_spans(chunk: FastqChunk) -> Tuple[np.ndarray, np.ndarray]:
    """(start, length) of each record's ID (header up to first space/tab),
    vectorized."""
    h = chunk.headers
    starts = chunk.header_offsets[:-1]
    ends = chunk.header_offsets[1:]
    ws = np.flatnonzero((h == 32) | (h == 9))
    pos = np.searchsorted(ws, starts)
    ws_clipped = ws[np.minimum(pos, max(len(ws) - 1, 0))] \
        if len(ws) else np.zeros(len(starts), dtype=np.int64)
    first_ws = np.where((pos < len(ws)) & (ws_clipped < ends),
                        ws_clipped, ends)
    return starts, first_ws - starts


def _mates_ok_mask(c0: FastqChunk, ck: FastqChunk) -> np.ndarray:
    """bool [count]: record IDs are mates per dnaio's rule — identical, or
    identical except the final character with both finals in '123'."""
    s0, l0 = _id_spans(c0)
    sk, lk = _id_spans(ck)
    ok = l0 == lk
    for length in np.unique(l0[ok]):
        rows = np.flatnonzero(ok & (l0 == length))
        if length == 0:
            continue
        idx = np.arange(length, dtype=np.int64)
        a = c0.headers[s0[rows][:, None] + idx]
        b = ck.headers[sk[rows][:, None] + idx]
        full_eq = (a == b).all(axis=1)
        stem_eq = (a[:, :-1] == b[:, :-1]).all(axis=1)
        digits = ((a[:, -1] >= ord("1")) & (a[:, -1] <= ord("3")) &
                  (b[:, -1] >= ord("1")) & (b[:, -1] <= ord("3")))
        ok[rows] = full_eq | (stem_eq & digits)
    return ok


def _validate_mates(chunks: Tuple[FastqChunk, ...]) -> None:
    """Vectorized mate-sync check (reference __init__.py:180-186).

    Real paired files differ in the header comment (" 1:N:..." vs
    " 2:N:..."), so the comparison is on the whitespace-delimited ID with
    the dnaio last-character rule — all numpy, no per-record objects."""
    first = chunks[0]
    bad: Optional[int] = None
    for other in chunks[1:]:
        ok = _mates_ok_mask(first, other)
        if not ok.all():
            bad = int(np.flatnonzero(~ok)[0])
            break
    if bad is None:
        return
    names = ", ".join(c.header(bad).decode("ascii", "replace")
                      for c in chunks)
    raise FastqFormatError(
        f"FASTQ files not in sync: {names} are not mates.")


def _chunk_keys(chunks: Tuple[FastqChunk, ...],
                check_slices: Optional[List[slice]],
                use_qualities: bool
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build per-record key bytes (and sliced qualities) for a chunk tuple.

    Returns (key_data, key_offsets, qual_data, qual_offsets); quality arrays
    are empty placeholders when ``use_qualities`` is False.
    """
    seq_parts = []
    qual_parts = []
    for f, chunk in enumerate(chunks):
        slc = check_slices[f] if check_slices else slice(None)
        seq_parts.append(apply_slice(chunk.sequences, chunk.offsets, slc))
        if use_qualities:
            qual_parts.append(
                apply_slice(chunk.qualities, chunk.offsets, slc))
    key_data, key_offsets = concat_ragged(seq_parts)
    if use_qualities:
        qual_data, qual_offsets = concat_ragged(qual_parts)
    else:
        qual_data = np.empty(0, dtype=np.uint8)
        qual_offsets = np.zeros(1, dtype=np.int64)
    return key_data, key_offsets, qual_data, qual_offsets


class _NumpyKeyAccumulator:
    """Pure-numpy fallback for native.loader.KeyAccumulator.

    Per-chunk sort/unique per length group with quality-passing counts and
    first-occurrence positions; chunks merge lazily in :meth:`export`
    (replaces the trie's per-record count aggregation,
    _triemodule.c:233-239).  Unlike the native accumulator, ``export`` may
    repeat a key once per chunk (``collapsed = False``): _finalize_groups
    must still sort and merge duplicates."""

    collapsed = False

    def __init__(self, expected: int = 0):
        self._pending: Dict[int, List[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]]] = {}

    def add(self, key_data: np.ndarray, key_offsets: np.ndarray,
            counted: Optional[np.ndarray], base: int) -> None:
        n = len(key_offsets) - 1
        lengths = np.diff(key_offsets)
        if counted is None:
            counted_i = np.ones(n, dtype=np.int64)
        else:
            counted_i = counted.astype(np.int64)
        positions = base + np.arange(n, dtype=np.int64)
        for length in np.unique(lengths):
            sel = np.flatnonzero(lengths == length)
            void = rows_as_void(key_data, key_offsets, sel, int(length))
            uniq, inverse = np.unique(void, return_inverse=True)
            cnt = np.bincount(inverse, weights=counted_i[sel]
                              ).astype(np.int64)
            pos = np.full(len(uniq), np.iinfo(np.int64).max, dtype=np.int64)
            np.minimum.at(pos, inverse, positions[sel])
            self._pending.setdefault(int(length), []).append(
                (uniq, cnt, pos))

    def export(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
        datas: List[np.ndarray] = []
        lens: List[np.ndarray] = []
        counts_out: List[np.ndarray] = []
        pos_out: List[np.ndarray] = []
        for length in sorted(self._pending):
            parts = self._pending[length]
            if len(parts) == 1:
                uniq, counts, pos = parts[0]
            else:
                allv = np.concatenate([p[0] for p in parts])
                allc = np.concatenate([p[1] for p in parts])
                allp = np.concatenate([p[2] for p in parts])
                # Presorted runs (np.unique output) merge cheaply under a
                # stable timsort.
                order = np.argsort(allv, kind="stable")
                sv, sc, sp = allv[order], allc[order], allp[order]
                if len(sv):
                    run_starts = np.concatenate(
                        [[0], np.flatnonzero(sv[1:] != sv[:-1]) + 1])
                    uniq = sv[run_starts]
                    counts = np.add.reduceat(sc, run_starts)
                    pos = np.minimum.reduceat(sp, run_starts)
                else:
                    uniq, counts, pos = sv, sc, sp
            datas.append(uniq.view(np.uint8).reshape(-1))
            lens.append(np.full(len(uniq), length, dtype=np.int64))
            counts_out.append(counts)
            pos_out.append(pos)
        if not datas:
            return (np.empty(0, dtype=np.uint8),
                    np.zeros(1, dtype=np.int64),
                    np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int64))
        key_offsets = np.zeros(sum(len(c) for c in counts_out) + 1,
                               dtype=np.int64)
        np.cumsum(np.concatenate(lens), out=key_offsets[1:])
        return (np.concatenate(datas), key_offsets,
                np.concatenate(counts_out), np.concatenate(pos_out))

    def close(self) -> None:
        self._pending.clear()


def _make_key_accumulator(expected: int = 1 << 20):
    try:
        cpus = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # pragma: no cover - non-Linux
        cpus = os.cpu_count() or 1
    shards = int(os.environ.get("FASTQDEDUP_ACC_SHARDS", 0)) or \
        min(4, cpus)
    try:
        if shards > 1:
            # Threaded insert path: the single accumulate worker lags
            # the parse pipeline at large inputs (~30 s of backlog
            # drain at 100M reads); hash-sharded tables insert with
            # `shards` threads and export deterministically.
            from .native.loader import ShardedKeyAccumulator
            return ShardedKeyAccumulator(expected, shards=shards)
        from .native.loader import KeyAccumulator
        return KeyAccumulator(expected)
    except (ImportError, AttributeError):
        return _NumpyKeyAccumulator(expected)


class _RecordArenaStore:
    """Rendered first-occurrence records, captured during pass 1.

    Pass 3 emits exactly the records ``{first_pos(k) : k kept}`` (the
    first occurrence of each kept key in file order, reference
    __init__.py:203-206), and every such record announces itself in
    pass 1 as the insert of a previously-unseen key.  Rendering those
    records to FASTQ bytes at insert time turns pass 3 into a pure
    gather + compress over this store — no re-stream of the inputs, and
    memory proportional to UNIQUE keys rather than all records.
    Exceeding the byte budget abandons the store (pass 3 then
    re-streams), so memory stays within the budget.
    """

    def __init__(self, num_files: int, budget_bytes: int):
        self.positions: List[np.ndarray] = []  # ascending, per part
        self.chunk_ids: List[int] = []         # source chunk per part
        self.parts: List[List[Tuple[np.ndarray, np.ndarray]]] = \
            [[] for _ in range(num_files)]     # (payload, bounds) per file
        self.bytes = 0
        self.budget = budget_bytes
        self.abandoned = False

    def add(self, chunks: Tuple[FastqChunk, ...], is_new: np.ndarray,
            base: int) -> None:
        """Render the marked records of one chunk tuple (single render
        worker; parts may arrive out of position order under parallel
        range ingest — the write path orders them by base)."""
        if self.abandoned:
            return
        from .native.loader import render_records_native
        rows = np.flatnonzero(is_new).astype(np.int64)
        self.positions.append(base + rows)
        # Part id = the chunk's base record position: globally unique
        # and ascending in file order across hosts under BOTH strided
        # and byte-range partitions (chunk indices are host-local in
        # range mode, so they no longer work as a global order).
        self.chunk_ids.append(base)
        for f, chunk in enumerate(chunks):
            payload, bounds = render_records_native(
                chunk.sequences, chunk.qualities, chunk.offsets,
                chunk.headers, chunk.header_offsets, rows,
                return_offsets=True)
            self.parts[f].append((payload, bounds))
            self.bytes += payload.nbytes
        if self.bytes > self.budget:
            logger.debug(
                "record arena exceeded the memory budget "
                f"({self.bytes / (1 << 30):.2f} GiB); pass 3 will "
                f"re-stream the inputs")
            self.abandon()

    def rebase(self, offsets: np.ndarray, shift: int,
               shard_base: int) -> None:
        """Provisional split positions -> exact ordinals (each part holds
        one reader's records; see :func:`_exact_positions`)."""
        for i, chunk_id in enumerate(self.chunk_ids):
            offset = int(offsets[(chunk_id - shard_base) >> shift])
            self.positions[i] += offset
            self.chunk_ids[i] = chunk_id + offset

    def abandon(self) -> None:
        self.abandoned = True
        self.dispose()

    def dispose(self) -> None:
        """Drop all parts, recycling their backing pages for the next run."""
        from .runtime import release
        self.positions.clear()
        self.chunk_ids.clear()
        for file_parts in self.parts:
            payloads = [payload for payload, _ in file_parts]
            file_parts.clear()
            for payload in payloads:
                release(payload)
        self.bytes = 0


def _finalize_groups(key_data: np.ndarray, key_offsets: np.ndarray,
                     counts: np.ndarray, first_pos: np.ndarray,
                     single_table: bool = False,
                     pre_merged: bool = False,
                     hashes: Optional[np.ndarray] = None) -> KeyGroups:
    """Accumulator dump -> per-length deterministically ordered KeyGroups.

    Tolerates duplicate keys (a key seen by several hosts appears once per
    host in the gathered table): duplicates collapse by summing counts and
    taking the minimum first position.  Keys whose merged count is zero
    (every occurrence was quality-filtered) are then dropped: they can
    never be cluster members or representatives — the reference never
    inserted them into the trie (__init__.py:247-252).

    Within-group order: when the native layer is present every consumer
    resolves keys through hash lookups or index maps, so any fixed order
    works.  ``single_table=True`` asserts the input is ONE host's native
    accumulator export — already duplicate-free and in deterministic
    table order — and skips sorting/collapsing entirely (for 31M x 100 bp
    keys the avoided hash+sort+gather cost ~130 s; with the zero-copy
    rows_as_void slice the whole finalize drops to the export cost).
    Otherwise (multi-host allgather concatenation, or the numpy fallback
    accumulator whose export repeats keys across chunks) keys are sorted
    by content: two independent 64-bit hashes when the native layer is
    present (equal keys adjacent; double collision is a 2^-128 event),
    LEXICOGRAPHIC order otherwise, which the fallback searchsorted
    membership paths require.  All orders are deterministic and identical
    across hosts."""
    try:
        from .native.loader import KeyAccumulator as _acc_probe  # noqa
        use_hash_order = True
    except ImportError:
        use_hash_order = False
    from .ops.bucket import _hash_window_rows
    lengths_all = np.diff(key_offsets)
    lengths_list: List[int] = []
    voids: List[np.ndarray] = []
    group_counts: List[np.ndarray] = []
    group_pos: List[np.ndarray] = []
    starts: List[int] = []
    n = 0
    uniform_length = len(lengths_all) > 0 and \
        int(lengths_all[0]) > 0 and \
        len(key_data) == len(lengths_all) * int(lengths_all[0]) and \
        bool((lengths_all == lengths_all[0]).all())
    if uniform_length:
        # All keys one length (the common case): skip the per-length
        # bincount/flatnonzero scans — at P>1 every one of these ~n-sized
        # passes is replicated on every host.
        unique_lengths = lengths_all[:1]
    elif len(lengths_all) and int(lengths_all.max()) < (1 << 20):
        # bincount beats np.unique's 31M-element sort for read lengths
        unique_lengths = np.flatnonzero(np.bincount(lengths_all))
    else:
        unique_lengths = np.unique(lengths_all)
    for length in unique_lengths:
        if uniform_length:
            sel = np.arange(len(lengths_all), dtype=np.int64)
            void = key_data.reshape(len(lengths_all), int(length)).view(
                np.dtype((np.void, int(length)))).ravel()
        else:
            sel = np.flatnonzero(lengths_all == length)
            void = rows_as_void(key_data, key_offsets, sel, int(length))
        if (single_table and use_hash_order) or pre_merged:
            # Native accumulator export (single_table) or the gathered
            # concatenation of per-host owned merges (pre_merged): unique
            # keys, deterministic order — no sort, no duplicate collapse.
            sv = void
            if uniform_length:
                # Full-slice views, NOT the caller's array objects: the
                # runtime pool's refcount gate detects aliasing by
                # counting view objects on the base, so handing the SAME
                # object to both ``groups`` and a caller that later
                # release()s its export would let the buffer recycle
                # while groups still reads it (measured: corrupted
                # counts at 100M when the partition's composite-sort
                # scratch landed on the recycled counts base).
                sc = counts[:]
                sp = first_pos[:]
            else:
                sc = counts[sel]
                sp = first_pos[sel]
        else:
            if hashes is not None and length > 0 and len(sel) > 1:
                # Per-key hashes came out of the native accumulators
                # (content-determined, so equal keys from different
                # hosts hash equal).  A stable sort on one 64-bit hash
                # puts equal keys adjacent UNLESS two distinct keys of
                # this length collide AND interleave — detected below
                # and repaired with an exact byte sort.
                sh = hashes[sel]
                order = np.argsort(sh, kind="stable")
                collide = sh[order]
                collide = collide[1:] == collide[:-1]
                if collide.any():
                    sv_probe = void[order]
                    if ((sv_probe[1:] != sv_probe[:-1]) & collide).any():
                        order = np.argsort(void, kind="stable")
            elif use_hash_order and length > 0 and len(sel) > 1:
                raw = void.view(np.uint8).reshape(len(sel), int(length))
                h1 = _hash_window_rows(raw, int(length))
                h2 = _hash_window_rows(raw, int(length) + 65537)
                order = np.lexsort((h2, h1))
            else:
                order = np.argsort(void, kind="stable")
            from .runtime import big_empty
            sv = big_empty(len(order) * void.dtype.itemsize) \
                .view(void.dtype)
            np.take(void, order, out=sv)
            sc = counts[sel][order]
            sp = first_pos[sel][order]
            if len(sv) > 1:
                dup = sv[1:] == sv[:-1]
                if dup.any():
                    run_starts = np.concatenate(
                        [[0], np.flatnonzero(~dup) + 1])
                    sv = sv[run_starts]
                    sc = np.add.reduceat(sc, run_starts)
                    sp = np.minimum.reduceat(sp, run_starts)
        keep = sc > 0
        if not keep.all():
            sv, sc, sp = sv[keep], sc[keep], sp[keep]
        if not len(sv):
            continue
        lengths_list.append(int(length))
        voids.append(sv)
        group_counts.append(sc)
        group_pos.append(sp)
        starts.append(n)
        n += len(sv)
    return KeyGroups(lengths_list, voids, group_counts,
                     np.asarray(starts, dtype=np.int64), n,
                     first_pos=group_pos)


@trace.spanned("pass1.quality")
def _quality_mask(qual_data, qual_offsets, max_average_error_rate
                  ) -> np.ndarray:
    """uint8 keep-mask for one chunk (runs on its own worker thread)."""
    if os.environ.get("FASTQDEDUP_DEVICE_QUALITY") == "1":
        # Opt-in device path: f32 LUT gather + masked mean on the run's
        # device (ops/phred.py).  Trades the host path's bit-exact
        # float64 rounding and strict character-range validation for
        # throughput when the host CPU is the bottleneck.
        import torch

        from .ops.phred import quality_filter_mask
        from .runtime import device
        from .utils.ragged import pad_to_matrix
        matrix, lens = pad_to_matrix(qual_data, qual_offsets, fill=33)
        dev = device()
        keep = quality_filter_mask(
            torch.from_numpy(np.ascontiguousarray(matrix)).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev),
            max_average_error_rate).cpu().numpy()
    else:
        rates = ragged_average_error_rate(qual_data, qual_offsets)
        keep = ~(rates > max_average_error_rate)
    return keep.astype(np.uint8)


def _plan_input_ranges(input_files: List[str], pid: int, nproc: int,
                       n_parts: int = 1
                       ) -> "Optional[List[Tuple[List[Tuple[int, int, int]], int]]]":
    """Byte-range ingest plan for the default multi-host mode.

    Returns this host's record window [N*p/P, N*(p+1)/P) split into up
    to ``n_parts`` concurrent-reader plans, each ``(per_file_plan,
    base_record)`` with ``per_file_plan`` one ``(start_offset,
    skip_newlines, n_records)`` per input file — or None when any input
    is not BGZF / not line-clean (callers fall back to strided chunk
    ownership, pipeline.py's ``chunk_index % nproc`` partition, which
    parses the whole input on every host).

    Phase A: every host inflates only its 1/P compressed-byte range of
    each file (no FASTQ parsing) and counts newlines per inflate unit;
    the tiny unit tables all-gather, making global line — and hence
    record — ordinals exact on every host.  Phase B (the caller's parse)
    then reads records [N*p/P, N*(p+1)/P) per file: inflate work is 2/P
    of the file total and parse work is 1/P, versus 1 + 1/P for strided
    ownership.  Correctness does not rely on FASTQ resynchronization
    heuristics (quality lines may contain '@').
    """
    try:
        from .native.loader import count_bgzf_range_units
    except ImportError:
        return None
    from .parallel.distributed import allgather_int64_cols

    per_file_units = []
    supported = True
    for path in input_files:
        try:
            size = os.path.getsize(path)
            lo = size * pid // nproc
            hi = size * (pid + 1) // nproc if pid < nproc - 1 else -1
            units = count_bgzf_range_units(path, lo, hi)
        except OSError:
            units = None
        if units is None:
            supported = False
            break
        per_file_units.append(units)
    # BGZF-ness is a property of the file bytes, but IO errors need not
    # be symmetric (per-host filesystems) — vote so no host proceeds to
    # the unit-table allgather while another has already given up.
    from .parallel.distributed import sum_scalars
    (ok_hosts,) = sum_scalars(int(supported))
    if ok_hosts != nproc:
        return None

    gathered_units = []
    for ends, lines in per_file_units:
        gathered, _ = allgather_int64_cols(
            np.ascontiguousarray(np.stack([ends, lines])))
        gathered_units.append((gathered[0], gathered[1]))
    made = _splits_from_units(gathered_units)
    if made is None:
        # Blank/truncated trailing lines: give up on exact record
        # ordinals and let the strided path's tolerant parser decide.
        return None
    splits, n_min = made
    rec_lo = n_min * pid // nproc
    rec_hi = n_min * (pid + 1) // nproc
    parts = _range_parts_from_units(splits, rec_lo, rec_hi, n_parts)
    if not parts:
        # Empty window (more hosts than records): a zero-budget plan —
        # NOT None/[], which would divert this host to strided mode
        # while its peers partition by range (records double-counted).
        parts = [([(0, 0, 0)] * len(splits), rec_lo)]
    return parts


def _splits_from_units(per_file_units
                       ) -> "Optional[Tuple[List[Tuple[np.ndarray, np.ndarray]], int]]":
    """Per-file BGZF unit tables -> (splits, n_min).

    ``splits`` holds one ``(unit_end_offsets, [0]+cumsum(newlines))``
    per file; ``n_min`` is the record count of the shortest file (zip
    semantics).  Returns None when any file is not line-clean (total
    newlines not a multiple of 4 — exact record ordinals impossible).
    """
    splits: List[Tuple[np.ndarray, np.ndarray]] = []
    n_min: Optional[int] = None
    for ends, lines in per_file_units:
        total_lines = int(lines.sum())
        if total_lines % 4 != 0:
            return None
        n_f = total_lines // 4
        n_min = n_f if n_min is None else min(n_min, n_f)
        splits.append((ends, np.concatenate([[0], np.cumsum(lines)])))
    if n_min is None:
        return None
    return splits, n_min


def _range_parts_from_units(splits: List[Tuple[np.ndarray, np.ndarray]],
                            rec_lo: int, rec_hi: int, n_parts: int
                            ) -> List[Tuple[List[Tuple[int, int, int]],
                                            int]]:
    """Split the record window ``[rec_lo, rec_hi)`` into up to
    ``n_parts`` contiguous reader plans — one ``(per_file_plan,
    base_record)`` each — from per-file BGZF unit tables ``(unit end
    offsets, [0]+cumsum(unit newline counts))``."""
    parts: List[Tuple[List[Tuple[int, int, int]], int]] = []
    span = rec_hi - rec_lo
    for p in range(n_parts):
        lo = rec_lo + span * p // n_parts
        hi = rec_lo + span * (p + 1) // n_parts
        if hi <= lo:
            continue  # tiny window: fewer parts than readers
        plan: List[Tuple[int, int, int]] = []
        for g_ends, g_cum in splits:
            target = 4 * lo
            if target == 0:
                start, skip = 0, 0
            else:
                # Largest unit end with cum_lines <= target - 1, so the
                # record's first byte cannot precede the start offset.
                j = int(np.searchsorted(g_cum, target - 1,
                                        side="right")) - 1
                start = int(g_ends[j - 1]) if j >= 1 else 0
                skip = target - int(g_cum[j])
            plan.append((start, skip, hi - lo))
        parts.append((plan, lo))
    return parts


def _plan_local_ranges(input_files: List[str], n_parts: int
                       ) -> "Optional[List[Tuple[List[Tuple[int, int, int]], int]]]":
    """Split this host's inputs into ``n_parts`` record ranges for
    CONCURRENT readers inside one process (no collectives).

    Returns one ``(per_file_plan, base_record)`` per part — the same
    shape :func:`_plan_input_ranges` returns per host — or None when any
    input is not BGZF / not line-clean.  Phase A (the newline count) is
    itself parallelized across ``n_parts`` byte ranges per file.
    """
    try:
        from .native.loader import count_bgzf_range_units
    except ImportError:
        return None
    from concurrent.futures import ThreadPoolExecutor

    per_file_units = []
    with ThreadPoolExecutor(max_workers=max(n_parts, 1)) as pool:
        for path in input_files:
            try:
                size = os.path.getsize(path)
            except OSError:
                return None
            bounds = [(size * p // n_parts,
                       size * (p + 1) // n_parts if p < n_parts - 1
                       else -1) for p in range(n_parts)]
            futures = [pool.submit(count_bgzf_range_units, path, lo, hi)
                       for lo, hi in bounds]
            try:
                units = [f.result() for f in futures]
            except OSError:
                return None  # serial path surfaces the real error
            if any(u is None for u in units):
                return None
            per_file_units.append(
                (np.concatenate([u[0] for u in units]),
                 np.concatenate([u[1] for u in units])))
    made = _splits_from_units(per_file_units)
    if made is None:
        return None
    splits, n_min = made
    return _range_parts_from_units(splits, 0, n_min, n_parts)


def _plan_split_ranges(path: str, n_parts: int
                       ) -> Optional[List[_Split]]:
    """Split one BGZF file into up to ``n_parts`` parts for CONCURRENT
    readers inside one process, inflating nothing.

    Part p starts at the first member boundary at or after byte
    ``size * p / n_parts`` (``fq_scan_boundary``, at most 256 KiB read),
    part 0 at byte 0; repeated or missing boundaries drop out.  Each
    reader finds its own first record and stops at the next one's (see
    :func:`native.loader.read_fastq_chunks_native`), so no newline count
    is needed.  None when the file is not BGZF or fewer than two parts
    remain (the serial reader then reads it).
    """
    try:
        from .native.loader import bgzf_boundary
    except ImportError:
        return None
    try:
        size = os.path.getsize(path)
        bounds = [0]
        for p in range(1, n_parts):
            boundary = bgzf_boundary(path, size * p // n_parts)
            if boundary is None:
                return None
            if boundary > bounds[-1]:
                bounds.append(boundary)
    except OSError:
        return None  # the serial path surfaces the real error
    if len(bounds) < 2:
        return None
    return [_Split(lo, hi) for lo, hi in zip(bounds, bounds[1:] + [-1])]


def _split_shift(n_parts: int) -> int:
    """Bits of a split reader's local ordinal in its provisional record
    positions: part p's records take ``[p << shift, (p + 1) << shift)``,
    all inside one shard's ``_SHARD_STRIDE``."""
    return _SHARD_STRIDE.bit_length() - 1 - max(n_parts - 1, 1).bit_length()


def _split_offsets(counts: np.ndarray, shift: int) -> np.ndarray:
    """What to add to a provisional position of each part to make it the
    record's exact ordinal: ``base_p - (p << shift)``, where ``base_p`` is
    the number of records of the parts before p."""
    counts = np.asarray(counts, dtype=np.int64)
    if len(counts) and int(counts.max()) >= 1 << shift:
        raise RuntimeError("a split reader read more records than its "
                           "position range holds")
    bases = np.zeros(len(counts), dtype=np.int64)
    np.cumsum(counts[:-1], out=bases[1:])
    return bases - (np.arange(len(counts), dtype=np.int64) << shift)


def _exact_positions(positions: np.ndarray, offsets: np.ndarray, shift: int,
                     shard_base: int = 0) -> None:
    """Map provisional split positions (``shard_base`` + part p's
    ``(p << shift) + local ordinal``) to exact ordinals, in place."""
    if len(positions):
        positions += offsets[(positions - shard_base) >> shift]


def _parallel_range_chunks(input_files: List[str], chunk_records: int,
                           parts: "List[Tuple[Optional[List[_RangeEntry]], int]]",
                           queue_depth: int = 2
                           ) -> Iterator[Tuple[int, Tuple[FastqChunk,
                                                          ...]]]:
    """(base, chunks) from len(parts) CONCURRENT range readers.

    A part's plan may be None — read the whole files serially from the
    top (the single-producer prefetch case, :func:`_zip_chunks`).

    The single-threaded record scan in the native parser is the ingest
    bottleneck once inflate parallelizes; running one reader per record
    range multiplies scan throughput by the reader count.  Chunks
    arrive in ARRIVAL order (positions interleave across ranges) —
    every consumer downstream is position-keyed: the accumulator takes
    per-key position minima (marking a record as first whenever it
    lowers the minimum), the arena sorts its parts by base position in
    pass 3, and part files are named by base.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(2, queue_depth))
    stop = threading.Event()
    _DONE = object()

    def produce(plan, base0):
        running = base0
        try:
            for chunks in _zip_chunks_serial(input_files, chunk_records,
                                             range_plan=plan):
                item = (running, chunks)
                running += chunks[0].count
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            while not stop.is_set():
                try:
                    q.put(_DONE, timeout=0.1)
                    break
                except queue.Full:
                    continue
        except BaseException as exc:
            while not stop.is_set():
                try:
                    q.put(exc, timeout=0.1)
                    break
                except queue.Full:
                    continue

    threads = [threading.Thread(target=trace.carry(produce),
                                args=(plan, base0), daemon=True)
               for plan, base0 in parts]
    for t in threads:
        t.start()
    done = 0
    try:
        while done < len(threads):
            item = q.get()
            if item is _DONE:
                done += 1
                continue
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=0.5)


def _compress_part_payload(payload: np.ndarray, out_name: str) -> np.ndarray:
    """Compress a raw output part into BGZF members when the final output
    is gzip.  Hosts compress their own parts in parallel; the rank-0
    merge then only CONCATENATES part bytes (BGZF members chain) instead
    of recompressing the whole output serially — the former p0 tail was
    a per-output-byte non-scaling term every host paid at the final
    barrier.  Non-gz outputs pass through (merged via the codec layer)."""
    if not out_name.endswith(".gz") or not len(payload):
        return payload
    from .io.bgzf import BLOCK_SIZE, compress_block
    mv = memoryview(payload)
    parts = [compress_block(bytes(mv[off:off + BLOCK_SIZE]), 1)
             for off in range(0, len(mv), BLOCK_SIZE)]
    return np.frombuffer(b"".join(parts), dtype=np.uint8)


def _merge_output_parts(out: str, parts_dir: str) -> None:
    """Concatenate a parts directory into the final output file."""
    import shutil
    if out.endswith(".gz"):
        from .io.bgzf import BGZF_EOF
        with open(out, "wb") as writer:
            for name in sorted(os.listdir(parts_dir)):
                with open(os.path.join(parts_dir, name), "rb") as part:
                    shutil.copyfileobj(part, writer, 8 << 20)
            writer.write(BGZF_EOF)
    else:
        with xopen(out, "wb", compresslevel=1) as writer:
            for name in sorted(os.listdir(parts_dir)):
                writer.write(np.fromfile(
                    os.path.join(parts_dir, name), dtype=np.uint8))
    shutil.rmtree(parts_dir)


@trace.spanned("pass1.render")
def _render_and_recycle(store, chunks, is_new, base, recycle_bin):
    """Arena render of one chunk's new-key records + parse-buffer
    recycling (the single render worker — the last pipeline stage that
    touches chunk memory in arena mode)."""
    store.add(chunks, is_new, base)
    # The PREVIOUS chunk tuple is fully consumed by now; recycle its parse
    # buffers so the next parser chunk reuses already-backed pages.
    # Deferred by one chunk because the current tuple was just rendered in
    # this frame.
    from .runtime import release
    # pop() before release: iterating leaves both the list entry and the
    # loop variable alive during the call, which trips the refcount gate
    # for entries that are base arrays.
    while recycle_bin:
        release(recycle_bin.pop())
    for chunk in chunks:
        if chunk.pool_bases is not None:
            recycle_bin.extend(chunk.pool_bases)


def _filter_and_accumulate(accumulator, key_data, key_offsets, mask_future,
                           b, base, store=None, chunks=None,
                           recycle_bin=None, render_pool=None,
                           render_futures=None):
    """Add one chunk's keys to the accumulator, gated on its quality mask.

    Runs on the single accumulate worker (serial inserts keep the C
    tables race-free); the quality reduction runs concurrently on its
    own worker and is awaited here.  With a record-arena ``store``,
    new-key records render on the single render worker (``render_pool``),
    overlapping the next chunk's insert.  Returns (records_in, kept).
    """
    counted = mask_future.result() if mask_future is not None else None
    with trace.span("pass1.accumulate"):
        is_new = None
        if store is not None and not store.abandoned:
            is_new = accumulator.add_mark(key_data, key_offsets, counted,
                                          base)
        if store is not None:
            # Even after abandonment (is_new None -> add no-ops) the
            # recycling stays on the render worker so exactly one stage
            # ever owns a chunk's buffers.
            render_futures.append(render_pool.submit(
                trace.carry(_render_and_recycle), store, chunks, is_new,
                base, recycle_bin))
        if is_new is None:
            accumulator.add(key_data, key_offsets, counted, base)
        kept = int(counted.sum()) if counted is not None else b
        return b, kept


def _kept_first_positions(groups: KeyGroups,
                          kept_mask: List[np.ndarray]) -> np.ndarray:
    """Global record positions pass 3 emits: first_pos of every kept key."""
    assert groups.first_pos is not None, \
        "pass 3 requires first-occurrence positions from pass 1"
    parts: List[np.ndarray] = []
    for g in range(len(groups.lengths)):
        km = kept_mask[g]
        if len(km) and km.any():
            parts.append(groups.first_pos[g][km])
    return np.concatenate(parts) if parts else np.empty(0, dtype=np.int64)


class _SplitIngestFailed(Exception):
    """A split reader raised FastqFormatError in pass 1 (see
    :func:`deduplicate_cluster`)."""


def deduplicate_cluster(
    input_files: List[str],
    output_files: List[str],
    check_slices: Optional[List[slice]],
    max_distance: int = DEFAULT_MAX_DISTANCE,
    max_average_error_rate: float = DEFAULT_MAX_AVERAGE_ERROR_RATE,
    cluster_dissection_func: ClusterDissectionFunc =
        cluster_dissection_directional,
    use_edit_distance: bool = False,
    chunk_records: int = DEFAULT_CHUNK_RECORDS,
) -> None:
    """Deduplicate ``input_files`` into ``output_files``.

    Same contract as the reference driver (__init__.py:209-288): arity
    validation, quality filter applied over the check-sliced qualities,
    within-distance clustering, cluster dissection, first-wins rewrite.

    In a multi-process job, any failure tears down the host byte
    transport before re-raising so PEER hosts parked in a collective
    fail fast instead of deadlocking against this host's interpreter
    shutdown.  The prewarm thread pass 1 may start (``warmup.py``) is
    waited for on every way out, so no CUDA call of its is in flight at
    interpreter exit or when the process group is destroyed.
    """
    prewarm: List = []
    prewarm_writer: List = []
    args = (input_files, output_files, check_slices, max_distance,
            max_average_error_rate, cluster_dissection_func,
            use_edit_distance, chunk_records, prewarm, prewarm_writer)
    with trace.job():
        try:
            serial_again = False
            try:
                _deduplicate_cluster_impl(*args)
            except _SplitIngestFailed as failed:
                # A split reader met input the serial parser reads
                # otherwise (a seam that is not a record start) or refuses:
                # nothing was written yet, so the job starts again with
                # pass 1 read serially, which gives its answer or its error.
                # (Outside this block: the traceback holds pass 1's state.)
                logger.debug("split ingest stopped (%s); pass 1 again, "
                             "serially", failed)
                serial_again = True
            if serial_again:
                _deduplicate_cluster_impl(*args, split_ingest=False)
        except BaseException:
            from .parallel.transport import abort_mesh
            abort_mesh()
            raise
        finally:
            # Only reached with a thread still listed when the run failed
            # before its own join: that failure is the one to report.
            for thread in prewarm + prewarm_writer:
                try:
                    thread.join()
                except Exception:
                    logger.exception("prewarm thread failed")


class _Pass1Plan(NamedTuple):
    """Which readers read which records in pass 1 (:func:`_plan_pass1`)."""
    # Concurrent readers' ``(per-file plan, base record)``, or None: one
    # reader.
    parallel_parts: Optional[List[Tuple[List[_RangeEntry], int]]]
    # This host's record window of a multi-host byte-range plan, one
    # counted entry per file: pass 1's one reader, pass 3's re-stream.
    range_plan: Optional[List[Tuple[int, int, int]]]
    range_base: int
    # The parts are splits of one file: bits of a reader's local ordinal
    # in its provisional record positions (:func:`_split_shift`).
    split_shift: Optional[int]


def _plan_pass1(input_files: List[str], pid: int, nproc: int,
                sharded_input: bool, split_ingest: bool) -> _Pass1Plan:
    """The pass-1 plan of this host.

    * Several hosts reading one input: byte-range ingest — each host
      inflates and parses only its record window (exact global ordinals
      from a newline-count exchange, :func:`_plan_input_ranges`), in up to
      one part a reader; strided chunk ownership (parse everything, keep
      1/P) for input that is not BGZF.
    * One host, or sharded input, with several readers: one BGZF file
      splits at member boundaries, inflating nothing
      (:func:`_plan_split_ranges`); several files zip record by record, so
      each reader needs the same record range in every file, which only
      the newline count gives (:func:`_plan_local_ranges`).
    * Otherwise one serial reader.

    The native parser's record scan is single-threaded per reader, so
    concurrent readers multiply scan throughput.  Chunks then arrive out
    of position order; every consumer is position-keyed (see
    :func:`_parallel_range_chunks`).
    """
    try:
        cpus = len(os.sched_getaffinity(0))  # respects core pinning
    except (AttributeError, OSError):  # pragma: no cover - non-Linux
        cpus = os.cpu_count() or 2
    # Measured at 100M reads on a 4-core host: 3 readers beat 2 (143 vs
    # 165 s end to end) and, once rendering/inserts moved off the critical
    # path, 4 beat 3 in interleaved reps (165 vs 177, 144 vs 253) — the
    # scan threads tolerate sharing cores with the inflate/accumulate
    # workers better than they tolerate idling.
    n_readers = int(os.environ.get("FASTQDEDUP_INGEST_READERS", "0")) \
        or max(1, min(4, cpus))
    serial = _Pass1Plan(None, None, 0, None)
    if nproc > 1 and not sharded_input:
        with trace.span("pass1.plan"):
            planned = _plan_input_ranges(input_files, pid, nproc,
                                         n_parts=n_readers)
            if planned:
                trace.count("pass1.parts.counted", len(planned))
        if not planned:
            return serial
        logger.debug("byte-range ingest: host %d/%d parses records "
                     "[%d, %d) per file across %d reader(s)", pid, nproc,
                     planned[0][1], planned[-1][1] + planned[-1][0][0][2],
                     len(planned))
        if len(planned) == 1:
            return _Pass1Plan(None, planned[0][0], planned[0][1], None)
        # Pass 3's re-stream reads serially; give it the whole host window
        # (parts are contiguous, so part 0's start/skip plus the summed
        # record budget IS the window).
        total = sum(per_file[0][2] for per_file, _ in planned)
        return _Pass1Plan(planned, [(start, skip, total) for start, skip, _
                                    in planned[0][0]], planned[0][1], None)
    if n_readers < 2:
        return serial
    parts = shift = None
    with trace.span("pass1.plan"):
        if len(input_files) > 1:
            parts = _plan_local_ranges(input_files, n_readers)
            if parts is not None:
                trace.count("pass1.parts.counted", len(parts))
        elif split_ingest:
            # Reader p's records take provisional positions from
            # p << shift on, in file order; pass 1 maps them to exact
            # ordinals once every reader has counted.
            splits = _plan_split_ranges(input_files[0], n_readers)
            if splits is not None:
                shift = _split_shift(len(splits))
                parts = [([split], p << shift)
                         for p, split in enumerate(splits)]
                trace.count("pass1.parts.split", len(splits))
    if parts is None:
        return serial
    logger.debug("parallel ingest: %d range readers", len(parts))
    return _Pass1Plan(parts, None, 0, shift)


def _start_prewarm(key_length: int, max_distance: int,
                   use_edit_distance: bool, card_writer: bool,
                   prewarm: List, prewarm_writer: List) -> None:
    """Bring the card up while pass 1 is still parsing: the CUDA context,
    the kernel library and each kernel's first launch (warmup.py).  None
    on the CPU device.  The card writer's deflate launch has a thread of
    its own, joined before pass 3, where an output takes it."""
    from .warmup import prewarm_async, prewarm_deflate_async
    thread = prewarm_async(key_length, max_distance=max_distance,
                           use_edit_distance=use_edit_distance) \
        if max_distance > 0 else None
    if thread is not None:
        prewarm.append(thread)
    thread = prewarm_deflate_async() if card_writer else None
    if thread is not None:
        prewarm_writer.append(thread)


def _join_warmup(threads: List) -> None:
    """Wait for warm-up threads; raises what a thread's work raised."""
    if threads:
        with trace.span("warmup.join"):
            while threads:
                threads.pop().join()


class _Pass1(NamedTuple):
    """What pass 1 leaves for passes 2 and 3 (:func:`_read_pass1`)."""
    accumulator: object
    record_store: Optional[_RecordArenaStore]  # None: pass 3 re-streams
    records: int
    kept: int
    discarded: int
    # Provisional split positions -> exact ordinals (None: no splits).
    split_offsets: Optional[np.ndarray]


def _read_pass1(input_files: List[str], check_slices: Optional[List[slice]],
                chunk_records: int, max_average_error_rate: float,
                plan: _Pass1Plan, pid: int, nproc: int, shard_base: int,
                sharded_input: bool, warm_up: Callable[[int], None]
                ) -> _Pass1:
    """Pass 1: ingest, quality-filter and count unique keys.

    Key accumulation (C hash table; GIL-free) runs on a worker thread,
    overlapping with the parse thread and the quality filter.
    ``warm_up(key_length)`` is called once, when 100,000 records are in:
    small inputs never reach the device (the engine's host path covers
    them)."""
    from concurrent.futures import ThreadPoolExecutor
    filter_on_quality = max_average_error_rate < 1.0
    accumulator = _make_key_accumulator()
    # Record arena (the native accumulator, which marks each key's first
    # insert): render each new key's first record during pass 1, so pass 3
    # never re-reads the inputs — O(unique keys) rendered bytes.  Over its
    # budget (default: half of physical RAM, floor 16 GiB) it is dropped
    # and pass 3 re-streams.  Multi-host included: each host's arena holds
    # ITS chunks' local first occurrences; every kept key's GLOBAL first
    # position lives in exactly one host's arena.
    record_store: Optional[_RecordArenaStore] = None
    recycle_bin: Optional[List[np.ndarray]] = None
    if hasattr(accumulator, "add_mark"):
        record_store = _RecordArenaStore(
            len(input_files),
            int(os.environ.get("FASTQDEDUP_MEMORY_LIMIT", 0))
            or max(16 * 1024 ** 3, _total_ram_bytes() // 2))
        recycle_bin = []
    split_counts = None if plan.split_shift is None else \
        np.zeros(len(plan.parallel_parts), dtype=np.int64)
    accumulate_pool = ThreadPoolExecutor(max_workers=1)
    quality_pool = ThreadPoolExecutor(max_workers=1) \
        if filter_on_quality else None
    # Arena renders overlap the next chunk's C inserts on their own
    # worker; both are single-threaded FIFO so part order and recycle
    # order stay serial.
    render_pool = ThreadPoolExecutor(max_workers=1) \
        if record_store is not None else None
    render_futures: List = []
    accumulate_futures = []
    total_records = total_kept = discarded_records = 0
    global_base = 0
    if plan.parallel_parts is not None:
        chunk_iter: Iterator = iter(_parallel_range_chunks(
            input_files, chunk_records, plan.parallel_parts))
    else:
        chunk_iter = iter(_zip_chunks(input_files, chunk_records,
                                      range_plan=plan.range_plan))
    chunk_index = -1
    try:
        while True:
            with trace.span("pass1.read"):
                try:
                    item = next(chunk_iter, None)
                except FastqFormatError as exc:
                    if split_counts is None:
                        raise
                    raise _SplitIngestFailed(str(exc)) from exc
            if item is None:
                break
            chunk_index += 1
            if plan.parallel_parts is not None:
                part_base, chunks = item
                base = shard_base + part_base
                if split_counts is not None:
                    split_counts[part_base >> plan.split_shift] += \
                        chunks[0].count
            else:
                chunks = item
                base = shard_base + plan.range_base + global_base
            global_base += chunks[0].count
            if plan.parallel_parts is None and plan.range_plan is None \
                    and not sharded_input and chunk_index % nproc != pid:
                continue  # another host owns this chunk (strided mode)
            if len(chunks) > 1:
                _validate_mates(chunks)
            with trace.span("pass1.keys"):
                key_data, key_offsets, qual_data, qual_offsets = \
                    _chunk_keys(chunks, check_slices,
                                use_qualities=filter_on_quality)
            if warm_up is not None and global_base >= 100_000:
                warm_up(int(key_offsets[1] - key_offsets[0]))
                warm_up = None
            b = chunks[0].count
            total_records += b
            trace.count("records.read", b)
            mask_future = quality_pool.submit(
                trace.carry(_quality_mask), qual_data, qual_offsets,
                max_average_error_rate) \
                if quality_pool is not None else None
            accumulate_futures.append(accumulate_pool.submit(
                trace.carry(_filter_and_accumulate), accumulator, key_data,
                key_offsets, mask_future, b, base, record_store, chunks,
                recycle_bin, render_pool, render_futures))

        with trace.span("pass1.drain"):
            for future in accumulate_futures:
                # Raises what the accumulation raised.
                b, kept = future.result()
                total_kept += kept
                discarded_records += b - kept
            for future in render_futures:
                future.result()  # propagate any arena render error
            accumulate_pool.shutdown()
            if render_pool is not None:
                render_pool.shutdown()
            if quality_pool is not None:
                quality_pool.shutdown()
        trace.count("records.filtered", discarded_records)
    finally:
        # An exception anywhere in pass 1 (parse error, mate desync,
        # quality range error re-raised from a worker) must not leak the
        # worker pools' threads.
        accumulate_pool.shutdown(wait=False, cancel_futures=True)
        if render_pool is not None:
            render_pool.shutdown(wait=False, cancel_futures=True)
        if quality_pool is not None:
            quality_pool.shutdown(wait=False, cancel_futures=True)
    if recycle_bin:
        # Drop this frame's references to the final chunk tuple (the loop
        # variables outlive the loop) so its parse buffers recycle too.
        key_data = key_offsets = qual_data = qual_offsets = None
        mask_future = None
        item = chunks = None  # FastqChunk views pin the parse buffers
        from .runtime import release
        # pop() before release: iterating leaves both the list entry and
        # the loop variable alive during the call, which trips the
        # refcount gate for entries that are base arrays.
        while recycle_bin:
            release(recycle_bin.pop())
    split_offsets: Optional[np.ndarray] = None
    if split_counts is not None:
        # Every reader has counted: provisional positions -> exact
        # ordinals, here for the arena, in pass 2 for the key table's
        # first positions.
        split_offsets = _split_offsets(split_counts, plan.split_shift)
        if record_store is not None and not record_store.abandoned:
            record_store.rebase(split_offsets, plan.split_shift, shard_base)
    return _Pass1(accumulator, record_store, total_records, total_kept,
                  discarded_records, split_offsets)


def _finalize_key_tables(accumulator, split_offsets: Optional[np.ndarray],
                         split_shift: Optional[int], shard_base: int,
                         nproc: int
                         ) -> Tuple[KeyGroups, Optional[np.ndarray]]:
    """Pass 2's key tables: the accumulator's export as
    :class:`KeyGroups`, and the bitmap of byte values in the keys (None
    where the accumulator does not collect it).

    In multi-host runs each host contributes its partial key table; one
    exchange merges them and the finalize step collapses keys seen by
    several hosts (summing counts, min-ing first positions)."""
    from .parallel.distributed import allgather_key_tables
    from .runtime import release
    with trace.span("pass2.finalize"):
        collapsed = getattr(accumulator, "collapsed", False)
        byte_presence: Optional[np.ndarray] = None
        if collapsed and hasattr(accumulator, "byte_presence"):
            # Collected at insertion during pass 1; saves every host the
            # alphabet rescan of the merged key table.
            byte_presence = accumulator.byte_presence()
            if nproc > 1:
                from .parallel.distributed import or_byte_presence
                byte_presence = or_byte_presence(byte_presence)
        if nproc > 1 and collapsed:
            # The native accumulator already computed a content hash per
            # key; exporting it (one O(capacity) sweep) and gathering it as
            # an extra column means no host ever re-hashes the gathered
            # table — the O(bytes) hashing happened shard-local, during
            # pass 1.
            kd, ko, kc, kp = accumulator.export()
            if split_offsets is not None:
                _exact_positions(kp, split_offsets, split_shift, shard_base)
            h1 = accumulator.export_hashes()
            from .native.loader import hash_ragged_native
            h2 = hash_ragged_native(kd, ko, seed=0xA5B35705F1E2D3C4)
            # Metadata-first exchange: 40 B/row of metadata gathers, each
            # host merges only the keys it owns, and every unique key's
            # payload crosses the wire exactly once — ~2x less traffic than
            # gathering every host's full table, with all merge work
            # sharded 1/P (parallel/distributed.py).
            from .parallel.distributed import exchange_merge_key_tables
            kd2, ko2, kc2, kp2 = exchange_merge_key_tables(
                kd, ko, kc, kp, h1, h2)
            # The local export is fully represented in the merged table now;
            # recycle its pooled buffers (refcount-gated no-ops if the
            # accumulator still references them).
            for _buf in (kd, ko, kc, kp, h1, h2):
                release(_buf)
            del kd, ko, kc, kp, h1, h2, _buf
            groups = _finalize_groups(kd2, ko2, kc2, kp2, pre_merged=True)
            # The uniform-length fast path aliases the merged columns into
            # ``groups`` instead of copying; drop this frame's references so
            # groups.dispose() can recycle them at the end of the run.
            del kd2, ko2, kc2, kp2
        else:
            kd, ko, kc, kp = accumulator.export()
            if split_offsets is not None:
                _exact_positions(kp, split_offsets, split_shift, shard_base)
            kd, ko, kc, kp = allgather_key_tables(kd, ko, kc, kp)
            groups = _finalize_groups(
                kd, ko, kc, kp, single_table=(nproc == 1 and collapsed))
            # Recycle whichever export columns _finalize_groups did NOT
            # alias into ``groups`` (the refcount gate makes release a no-op
            # for aliased ones — those recycle at groups.dispose()).  The
            # offsets column in particular is never aliased, and without
            # this it re-faulted 240 MiB per run at 100M reads.
            for _buf in (kd, ko, kc, kp):
                release(_buf)
            del kd, ko, kc, kp, _buf
        accumulator.close()
    if logger.isEnabledFor(logging.DEBUG):
        # Analog of the reference's DEBUG trie stats during pass 1
        # (__init__.py:260-264): per-length unique-key table sizes.
        total_bytes = 0
        for g, length in enumerate(groups.lengths):
            size = len(groups.counts[g])
            nbytes = size * (length + 8)  # key bytes + int64 count
            total_bytes += nbytes
            logger.debug(f"Key table length {length}: {size} unique keys, "
                         f"{nbytes / (1024 ** 3):.3f} GiB")
        logger.debug(f"Key tables total: {groups.n} unique keys, "
                     f"{total_bytes / (1024 ** 3):.3f} GiB")
    return groups, byte_presence


def _deduplicate_cluster_impl(
    input_files: List[str],
    output_files: List[str],
    check_slices: Optional[List[slice]],
    max_distance: int,
    max_average_error_rate: float,
    cluster_dissection_func: ClusterDissectionFunc,
    use_edit_distance: bool,
    chunk_records: int,
    prewarm: List,
    prewarm_writer: List,
    split_ingest: bool = True,
) -> None:
    from .parallel.distributed import (
        allgather_int64,
        process_shape,
        sum_scalars,
    )
    from .runtime import device, tune_host_allocator
    tune_host_allocator()
    # Resolve the device before any work: a run configured for CUDA on a
    # host without it fails here, not after pass 1.
    device()
    # Multi-host mode engages automatically when the process is part of an
    # initialized torch.distributed job (same CLI invocation on every host):
    # each host reads its share of the records in passes 1 and 3, pair
    # generation and dissection shard across hosts in pass 2, and the
    # per-host results merge through all-gathers (parallel/distributed.py).
    # A user-supplied cluster_dissection_func must be deterministic — it
    # runs identically on every host.
    pid, nproc = process_shape()
    if nproc > 1:
        # Build the TCP mesh NOW, while every host is provably alive and
        # inside the pipeline: lazy construction at the first exchange
        # would block for the KV timeout if a peer died during pass 1.
        from .parallel.transport import get_mesh
        get_mesh()
    # Sharded-input mode (FASTQDEDUP_SHARDED_INPUT=1): each host passes
    # ITS OWN input/output shard on the command line (e.g. per-lane
    # files); parsing and rewriting parallelize perfectly — no strided
    # chunk skipping, no output merge — while the key tables, clustering,
    # and dissection still agree globally.  The global record order is
    # the concatenation of shards by process id, so first-wins picks the
    # first occurrence in that concatenated order.
    sharded_input = nproc > 1 and \
        os.environ.get("FASTQDEDUP_SHARDED_INPUT") == "1"
    shard_base = pid * _SHARD_STRIDE if sharded_input else 0
    if len(input_files) != len(output_files):
        raise ValueError(f"Amount of output files ({len(output_files)}) "
                         f"must be equal to the amount of input files "
                         f"({len(input_files)}). ")
    if check_slices and len(input_files) != len(check_slices):
        raise ValueError(f"Amount of check lengths ({len(check_slices)}) "
                         f"must be equal to the amount of input files "
                         f"({len(input_files)}). ")
    timer = Timer()
    # Pass 3 writes through the card writer (a distributed job's part
    # files are compressed on the host).
    card_writer = not (nproc > 1 and not sharded_input) and any(
        deflates_on_card(f) for f in output_files)

    # ---------------- Pass 1: ingest, filter, count unique keys ----------
    with trace.span("pass1"):
        plan = _plan_pass1(input_files, pid, nproc, sharded_input,
                           split_ingest)
        ingest = _read_pass1(
            input_files, check_slices, chunk_records, max_average_error_rate,
            plan, pid, nproc, shard_base, sharded_input, functools.partial(
                _start_prewarm, max_distance=max_distance,
                use_edit_distance=use_edit_distance, card_writer=card_writer,
                prewarm=prewarm, prewarm_writer=prewarm_writer))
    records, kept, discarded = ingest.records, ingest.kept, ingest.discarded
    if nproc > 1:
        records, kept, discarded = sum_scalars(records, kept, discarded)
    if max_average_error_rate < 1.0:
        logger.info(
            f"{discarded} records out of {records} records had an error "
            f"rate higher than {max_average_error_rate} and were discarded.")
    logger.info(f"Processed {kept} sequences. ({timer.get_difference()})")

    # ---------------- Pass 2: cluster and dissect ------------------------
    groups, byte_presence = _finalize_key_tables(
        ingest.accumulator, ingest.split_offsets, plan.split_shift,
        shard_base, nproc)
    _join_warmup(prewarm)
    part = build_partition_groups(groups, max_distance, use_edit_distance,
                                  shard=(pid, nproc),
                                  byte_presence=byte_presence)
    # Built-in methods at P>1 shard their per-cluster work across hosts;
    # the kept key indices merge through one all-gather.
    gather = allgather_int64 if nproc > 1 and cluster_dissection_func in \
        CLUSTER_DISSECTION_METHODS.values() else None
    kept_mask = dissect_partition(groups, part, cluster_dissection_func,
                                  max_distance, use_edit_distance,
                                  shard=(pid, nproc), gather=gather)
    logger.info(f"Found {sum(int(m.sum()) for m in kept_mask)} distinct "
                f"reads in {part.num_clusters} clusters."
                f"({timer.get_difference()})")

    # ---------------- Pass 3: filtered rewrite ---------------------------
    _join_warmup(prewarm_writer)
    store = ingest.record_store
    arena_ok = store is not None and not store.abandoned
    if nproc > 1:
        # Both pass-3 paths synchronize through collectives, so every
        # host must take the SAME one: if any host's arena overflowed
        # its budget, all hosts re-stream.
        (arena_ok_hosts,) = sum_scalars(int(arena_ok))
        arena_ok = arena_ok_hosts == nproc
    if arena_ok:
        try:
            _write_from_record_store(output_files, groups, kept_mask, store,
                                     pid=pid, nproc=nproc,
                                     shard_base=shard_base,
                                     sharded_input=sharded_input)
        finally:
            store.dispose()
    else:
        if store is not None:
            store.abandon()
        _filter_and_write(input_files, output_files, check_slices, groups,
                          kept_mask, chunk_records, pid=pid, nproc=nproc,
                          shard_base=shard_base, sharded_input=sharded_input,
                          range_plan=plan.range_plan,
                          range_base=plan.range_base)
    logger.info(f"Filtered FASTQ files based on distinct reads from each "
                f"cluster. ({timer.get_difference()}) ")
    # The run is done with the key table: recycle its backing buffers
    # (the accumulator export / merged-exchange columns, ~L bytes/key)
    # into the process buffer pool so the next run skips re-faulting
    # them.  Refcount-gated — a live view anywhere makes it a no-op,
    # so collect cyclic garbage first: a traceback/frame cycle that
    # happens to reference a column view silently blocks the recycle of
    # a multi-GiB table (measured: per-rep finalize flapping 2 s <-> 18 s
    # at 100M reads with the reject tracing to gc-pending referrers).
    gc.collect()
    groups.dispose()


@trace.spanned("pass3")
def _write_from_record_store(output_files: List[str], groups: KeyGroups,
                             kept_mask: List[np.ndarray],
                             store: _RecordArenaStore,
                             pid: int = 0, nproc: int = 1,
                             shard_base: int = 0,
                             sharded_input: bool = False) -> None:
    """Pass 3 via the record arena: gather the kept keys' pre-rendered
    first-occurrence records (captured at insert time in pass 1) and
    stream them to the compressors — the inputs are never re-read.

    Emits the identical byte stream to :func:`_filter_and_write`: parts
    are walked in chunk order, rows within a part in ascending record
    position, which IS file order.

    Multi-host strided mode mirrors :func:`_filter_and_write`'s merge:
    every kept key's GLOBAL first position lives in exactly one host's
    arena (the host that ingested its chunk — a global first occurrence
    is necessarily that host's local first insert), so each host gathers
    its own kept records, writes raw per-chunk part files, and process 0
    streams the parts in chunk order through one compressor.  Sharded-
    input mode writes each host's own output files directly: arena
    positions already carry the shard base, so intersecting with the
    global kept set selects exactly this shard's records.
    """
    import queue
    import threading

    from .native.loader import gather_ragged_native

    from .runtime import release

    with trace.span("pass3.emit_set"):
        kept_sorted = np.sort(_kept_first_positions(groups, kept_mask))
    distributed = nproc > 1 and not sharded_input
    writers: List = []
    parts_dirs: List[str] = []
    if distributed:
        # Raw per-chunk part files on a shared filesystem; process 0
        # compresses after the barrier (same layout as _filter_and_write).
        from .parallel.distributed import barrier
        parts_dirs = [f + ".parts" for f in output_files]
        if pid == 0:
            for d in parts_dirs:
                os.makedirs(d, exist_ok=True)
        barrier("fastqdedup:arena-parts-dirs")
    else:
        writers = [xopen(f, "wb", compresslevel=1) for f in output_files]
    write_queue: "queue.Queue" = queue.Queue(maxsize=8)
    write_error: List[BaseException] = []

    def write_worker():
        # Release DEFERRED by one item: an immediate release races the
        # producer's `selected = None` (the producer may still bind the
        # buffer for a few instructions after put()), which silently
        # failed the refcount gate for ~2-3 gather buffers per run.
        pending = None
        while True:
            item = write_queue.get()
            if item is None:
                if pending is not None:
                    release(pending)
                return
            index, chunk_id, payload = item
            try:
                if not write_error:
                    if distributed:
                        _compress_part_payload(
                            payload, output_files[index]).tofile(
                            os.path.join(parts_dirs[index],
                                         f"{chunk_id:016d}.bin"))
                    else:
                        writers[index].write(payload)
                    del item
                    if pending is not None:
                        release(pending)  # refcount-gated
                    pending = payload
                    payload = None
            except BaseException as exc:  # surfaced after join
                write_error.append(exc)

    worker = threading.Thread(target=trace.carry(write_worker),
                              daemon=True)
    worker.start()
    try:
        # Parts append in ingest-arrival order, which under parallel range
        # readers is not position order; the id IS the base position, so
        # sorting by it restores file order (no-op for serial ingest).
        part_order = sorted(range(len(store.positions)),
                            key=store.chunk_ids.__getitem__)
        for part_index in part_order:
            with trace.span("pass3.render"):
                positions = store.positions[part_index]
                if not len(positions):
                    continue
                lo = np.searchsorted(kept_sorted, positions[0])
                hi = np.searchsorted(kept_sorted, positions[-1],
                                     side="right")
                want = kept_sorted[lo:hi]
                if not len(want):
                    continue
                rows = np.searchsorted(positions, want)
                # Every kept first_pos is the position of a record that
                # inserted its key, so it must be present in the store.
                # (Multi-host: a part's position span lies inside ONE
                # chunk this host ingested, so every kept first position
                # in the span is this host's local first insert — present
                # here.)
                if rows[-1] >= len(positions) or \
                        not np.array_equal(positions[rows], want):
                    raise RuntimeError(
                        "record arena is missing kept first occurrences")
                chunk_id = store.chunk_ids[part_index]
            trace.count("records.written", len(rows))
            for index in range(len(output_files)):
                payload, bounds = store.parts[index][part_index]
                with trace.span("pass3.render"):
                    out_bounds = np.zeros(len(rows) + 1, dtype=np.int64)
                    np.cumsum(bounds[rows + 1] - bounds[rows],
                              out=out_bounds[1:])
                    selected = gather_ragged_native(payload, bounds, rows,
                                                    out_bounds)
                if len(selected):
                    with trace.span("pass3.writer_wait"):
                        write_queue.put((index, chunk_id, selected))
                # Drop this frame's binding so the write worker's
                # refcount-gated release can recycle the gather buffer.
                selected = None
    finally:
        with trace.span("pass3.writer_wait"):
            write_queue.put(None)
            worker.join()
            for writer in writers:
                writer.close()
        if write_error:
            raise write_error[0]
    if distributed:
        from .parallel.distributed import barrier
        barrier("fastqdedup:arena-parts-written")
        if pid == 0:
            for out, parts_dir in zip(output_files, parts_dirs):
                _merge_output_parts(out, parts_dir)
        barrier("fastqdedup:arena-output-merged")


@trace.spanned("pass3")
def _filter_and_write(input_files: List[str], output_files: List[str],
                      check_slices: Optional[List[slice]],
                      groups: KeyGroups, kept_mask: List[np.ndarray],
                      chunk_records: int,
                      pid: int = 0, nproc: int = 1,
                      shard_base: int = 0,
                      sharded_input: bool = False,
                      range_plan: Optional[
                          List[Tuple[int, int, int]]] = None,
                      range_base: int = 0) -> None:
    """Second pass: write the first record matching each kept key
    (reference filter_fastq_files_on_set, __init__.py:189-206; no quality
    filter is applied here, matching the reference's behavior).

    Re-streams the inputs: this host's record window under a multi-host
    byte-range plan, else every chunk it owns.  Compression runs on a
    writer thread (the native zlib writer releases the GIL), overlapping
    with membership computation of the next chunk.

    Multi-host: each host renders the chunks it owns (first-wins needs no
    claim state — pass 1's first_pos decides), writes raw per-chunk part
    files, and process 0 streams the parts in chunk order through one
    compressor so the final file is byte-identical to a single-host run.
    """
    import queue
    import threading

    # The emit set IS a set of record POSITIONS: a record emits iff its
    # key is kept AND its global index equals the key's recorded first
    # occurrence (first-wins, reference __init__.py:203-206) — and every
    # first_pos is by construction a position OF that key, so the emit
    # set is exactly {first_pos(k) : k kept}.  Pass 3 therefore needs no
    # key recomputation and no lookup structure at all: scatter the kept
    # first positions into a byte mask over this host's record range and
    # read one mask window per chunk.  (An earlier design rebuilt a hash
    # table over kept key BYTES and probed it per record — minutes at
    # 100M reads; the position identity makes it O(kept) setup.)
    with trace.span("pass3.emit_set"):
        kept_fps = _kept_first_positions(groups, kept_mask)
        # Keep the mask local: this host renders only positions in
        # [shard_base, shard_base + _SHARD_STRIDE); kept keys first seen
        # by another shard can never emit here.  (Strided multi-host mode
        # has shard_base 0 and a global mask — positions in chunks this
        # host does not render are simply never read.)
        local_fps = kept_fps[(kept_fps >= shard_base)
                             & (kept_fps < shard_base + _SHARD_STRIDE)]
        local_fps = local_fps - shard_base
        mask_size = int(local_fps.max()) + 1 if len(local_fps) else 0
        emit_mask = np.zeros(mask_size, dtype=bool)
        emit_mask[local_fps] = True
    # Sharded-input mode: this host's files are wholly its own — plain
    # single-host writing (no parts, no merge); only the global record
    # base carries the shard offset.
    distributed = nproc > 1 and not sharded_input
    if distributed:
        # Raw per-chunk part files; process 0 compresses after the
        # barrier.  Assumes a shared filesystem (or a post-run copy of
        # each host's parts into one place).
        writers = []
        parts_dirs = [f + ".parts" for f in output_files]
        if pid == 0:
            for d in parts_dirs:
                os.makedirs(d, exist_ok=True)
        from .parallel.distributed import barrier
        barrier("fastqdedup:parts-dirs")
    else:
        writers = [xopen(f, "wb", compresslevel=1) for f in output_files]
    write_queue: "queue.Queue" = queue.Queue(maxsize=8)
    write_error: List[BaseException] = []

    def write_worker():
        while True:
            item = write_queue.get()
            if item is None:
                return
            index, payload = item
            try:
                if not write_error:
                    writers[index].write(payload)
            except BaseException as exc:  # surfaced after join
                write_error.append(exc)

    worker = threading.Thread(target=trace.carry(write_worker),
                              daemon=True)
    worker.start()
    if range_plan is not None:
        def _range_source():
            running = range_base
            for c in _zip_chunks(input_files, chunk_records,
                                 range_plan=range_plan):
                yield running, c
                running += c[0].count
        source = _range_source()
    else:
        source = ((shard_base + i * chunk_records, c) for i, c in
                  enumerate(_zip_chunks(input_files, chunk_records))
                  if sharded_input or i % nproc == pid)
    try:
        from .io.fastq import render_fastq_records
        while True:
            with trace.span("pass3.read"):
                item = next(source, None)
            if item is None:
                break
            chunk_base, chunks = item
            with trace.span("pass3.render"):
                local_base = chunk_base - shard_base
                lo = min(local_base, mask_size)
                hi = min(local_base + chunks[0].count, mask_size)
                emit_rows = np.flatnonzero(emit_mask[lo:hi])
            trace.count("records.written", len(emit_rows))
            # Vectorized serialization, one compressor call per chunk.
            for index, chunk in enumerate(chunks):
                with trace.span("pass3.render"):
                    payload = render_fastq_records(chunk, emit_rows)
                    if distributed and len(payload):
                        _compress_part_payload(
                            payload, output_files[index]).tofile(
                            os.path.join(parts_dirs[index],
                                         f"{chunk_base:016d}.bin"))
                if not distributed and len(payload):
                    with trace.span("pass3.writer_wait"):
                        write_queue.put((index, payload))
    finally:
        with trace.span("pass3.writer_wait"):
            write_queue.put(None)
            worker.join()
            for writer in writers:
                writer.close()
        if write_error:
            raise write_error[0]
    if distributed:
        barrier("fastqdedup:parts-written")
        if pid == 0:
            for out, parts_dir in zip(output_files, parts_dirs):
                _merge_output_parts(out, parts_dir)
        barrier("fastqdedup:output-merged")
