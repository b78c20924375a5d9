"""Vectorized operations on ragged byte batches (CSR layout).

A ragged batch is ``(data, offsets)``: ``data`` a 1-D uint8 array of all
records concatenated, ``offsets`` an int64 array of length B+1.  These
helpers implement the per-record string operations of the reference —
check-length slicing and multi-file key concatenation
(/root/reference/src/fastqdedup/__init__.py:160-167) — as batched gathers and
scatters, grouped by record length so each group is a dense matrix op.
"""

from typing import List, Sequence, Tuple

import numpy as np

Ragged = Tuple[np.ndarray, np.ndarray]


def ragged_lengths(offsets: np.ndarray) -> np.ndarray:
    return np.diff(offsets)


def apply_slice(data: np.ndarray, offsets: np.ndarray,
                slc: slice) -> Ragged:
    """Apply a Python slice to every record of a ragged batch."""
    lengths = ragged_lengths(offsets)
    b = len(lengths)
    if slc == slice(None):
        return data, offsets
    out_lengths = np.empty(b, dtype=np.int64)
    unique_lengths = np.unique(lengths)
    per_length_sel = {}
    for length in unique_lengths:
        sel = np.arange(*slc.indices(int(length)), dtype=np.int64)
        per_length_sel[int(length)] = sel
        out_lengths[lengths == length] = len(sel)
    out_offsets = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(out_lengths, out=out_offsets[1:])
    out = np.empty(out_offsets[-1], dtype=np.uint8)
    for length, sel in per_length_sel.items():
        if not len(sel):
            continue
        rows = np.flatnonzero(lengths == length)
        src = offsets[rows][:, None] + sel[None, :]
        dst = out_offsets[rows][:, None] + \
            np.arange(len(sel), dtype=np.int64)[None, :]
        out[dst.ravel()] = data[src.ravel()]
    return out, out_offsets


def concat_ragged(parts: Sequence[Ragged]) -> Ragged:
    """Per-record concatenation across batches of identical record count."""
    if len(parts) == 1:
        return parts[0]
    b = len(parts[0][1]) - 1
    lengths = [ragged_lengths(off) for _, off in parts]
    total_lengths = np.sum(lengths, axis=0)
    out_offsets = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(total_lengths, out=out_offsets[1:])
    out = np.empty(out_offsets[-1], dtype=np.uint8)
    base = out_offsets[:-1].copy()
    for (data, offsets), lens in zip(parts, lengths):
        for length in np.unique(lens):
            if length == 0:
                continue
            rows = np.flatnonzero(lens == length)
            sel = np.arange(length, dtype=np.int64)
            src = offsets[rows][:, None] + sel[None, :]
            dst = base[rows][:, None] + sel[None, :]
            out[dst.ravel()] = data[src.ravel()]
        base += lens
    return out, out_offsets


def pad_to_matrix(data: np.ndarray, offsets: np.ndarray,
                  fill: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged batch -> padded matrix [B, Lmax] plus lengths [B]."""
    lengths = ragged_lengths(offsets)
    b = len(lengths)
    lmax = int(lengths.max()) if b else 0
    if not lmax:
        return np.full((b, 0), fill, dtype=np.uint8), lengths
    if offsets[0] == 0 and offsets[-1] == b * lmax and \
            len(data) == b * lmax:
        # Uniform record length (every length <= lmax and the total is
        # b * lmax, so all records are exactly lmax): the payload IS the
        # matrix.
        return data.reshape(b, lmax), lengths
    # Clipped gather + masked fill — no boolean fancy-indexing temporaries.
    flat_src = offsets[:-1][:, None] + np.arange(lmax, dtype=np.int64)[None, :]
    np.minimum(flat_src, len(data) - 1, out=flat_src)
    matrix = data[flat_src]
    mask = np.arange(lmax, dtype=np.int64)[None, :] >= lengths[:, None]
    matrix[mask] = fill
    return matrix, lengths


def take_records(data: np.ndarray, offsets: np.ndarray,
                 rows: np.ndarray) -> Ragged:
    """Select a subset of records (by index) from a ragged batch."""
    lengths = ragged_lengths(offsets)[rows]
    out_offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lengths, out=out_offsets[1:])
    out = np.empty(out_offsets[-1], dtype=np.uint8)
    for length in np.unique(lengths):
        if length == 0:
            continue
        local = np.flatnonzero(lengths == length)
        sel = np.arange(length, dtype=np.int64)
        src = offsets[rows[local]][:, None] + sel[None, :]
        dst = out_offsets[local][:, None] + sel[None, :]
        out[dst.ravel()] = data[src.ravel()]
    return out, out_offsets


def records_as_bytes(data: np.ndarray, offsets: np.ndarray) -> List[bytes]:
    """Materialize each record as a bytes object (boundary use only)."""
    raw = data.tobytes()
    return [raw[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]


def group_rows_by_length(offsets: np.ndarray) -> List[Tuple[int, np.ndarray]]:
    """[(length, record_indices)] for a ragged batch."""
    lengths = ragged_lengths(offsets)
    return [(int(length), np.flatnonzero(lengths == length))
            for length in np.unique(lengths)]


def rows_as_void(data: np.ndarray, offsets: np.ndarray,
                 rows: np.ndarray, length: int) -> np.ndarray:
    """View equal-length records as a 1-D void array (hashable rows)."""
    if length == 0:
        return np.zeros(len(rows), dtype=np.dtype((np.void, 1)))
    if len(rows) == 0:
        return np.empty(0, dtype=np.dtype((np.void, length)))
    b = len(offsets) - 1
    if offsets[0] == 0 and offsets[-1] == b * length and \
            len(data) == b * length and \
            bool((np.diff(offsets) == length).all()):
        # Uniform layout: row-select on the reshaped payload, no index math.
        r0, r1 = int(rows[0]), int(rows[-1])
        if len(rows) == r1 - r0 + 1 and \
                (len(rows) == 1 or bool((np.diff(rows) == 1).all())):
            # Contiguous ascending run (e.g. flatnonzero over a single
            # length class): zero-copy slice view instead of a gather.
            gathered = data.reshape(b, length)[r0:r1 + 1]
        else:
            gathered = data.reshape(b, length)[rows]
    else:
        sel = np.arange(length, dtype=np.int64)
        gathered = data[offsets[rows][:, None] + sel[None, :]]
    return np.ascontiguousarray(gathered).view(
        np.dtype((np.void, length))).ravel()
