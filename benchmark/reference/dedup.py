"""The reference's passes, in plain NumPy.

Semantics (upstream ``src/fastqdedup/__init__.py`` and its C modules):

* Pass 1: for each record (one from each input file, in step), the key
  is the concatenation of each file's sequence cut by its
  ``--check-lengths`` slice, and the quality string is cut and joined
  the same way.  A record whose mean per-base error rate (mean of
  ``10 ** (-Q / 10)`` over the joined qualities, summed left to right in
  float64) exceeds ``--max-average-error-rate`` is not counted.  Every
  other record adds one to its key's count.
* Pass 2: two keys are neighbours when their Hamming distance (equal
  lengths only) or, with ``--edit``, their Levenshtein distance is at
  most ``--max-distance``.  Clusters are the connected components of
  that relation.  Directional dissection takes the remaining key with
  the highest (count, key) as an origin, absorbs every key reachable
  from it through neighbours ``u -> v`` with ``2 * count(v) - 1 <=
  count(u)`` among the keys still remaining, keeps the origin and
  repeats.  Adjacency keeps the highest remaining key and drops its
  remaining neighbours; highest-count keeps the highest key of each
  cluster.  Clusters are disjoint, so one pass over all keys in
  descending (count, key) order gives every cluster's answer.
* Pass 3: the first record in file order whose key is kept is written,
  once per key, whether or not it passed the quality filter; records
  are written unchanged, in file order, one output per input file.

Neighbours are found by the pigeonhole rule: split a key into d + 1
segments; a key within distance d of it holds one of them unchanged,
at the same place (Hamming) or shifted by at most d (Levenshtein).  Keys
that share a segment so are candidates, and each candidate is checked
exactly.  All work is in NumPy arrays, apart from the dissection loop
over keys that have neighbours.
"""

import argparse
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# 10 ** -(Q / 10) for Q in 0..127, as upstream's score_to_error_rate.py.
ERROR_RATE = np.array([10.0 ** -(i / 10) for i in range(128)])
PHRED_OFFSET = 33
MAX_PHRED = 126
_MIX = np.uint64(0x9E3779B97F4A7C15)


def parse_args(args: Sequence[str]) -> argparse.Namespace:
    """The upstream command line's options that change the output (the
    inputs and outputs are given apart)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("-l", "--check-lengths")
    p.add_argument("-d", "--max-distance", type=int, default=1)
    p.add_argument("-e", "--max-average-error-rate", type=float,
                   default=0.001)
    p.add_argument("-E", "--no-average-error-rate-filter",
                   action="store_const", dest="max_average_error_rate",
                   const=1.0)
    p.add_argument("--edit", action="store_true")
    p.add_argument("-c", "--cluster-dissection-method",
                   choices=("directional", "adjacency", "highest_count"),
                   default="directional")
    return p.parse_args(list(args))


def check_slices(lengths: Optional[str], n_files: int) -> List[slice]:
    """``-l 16,8`` or ``-l 4:8,::8``: one slice per input file."""
    if not lengths:
        return [slice(None)] * n_files
    out = []
    for entry in lengths.split(","):
        fields = [None if f in ("", "None") else int(f)
                  for f in entry.split(":")]
        out.append(slice(*fields))
    if len(out) != n_files:
        raise ValueError(f"{len(out)} check lengths for {n_files} files")
    return out


def _bgzf_blocks(raw: memoryview) -> Optional[List[Tuple[int, int]]]:
    """(start, end) of each member of a BGZF file, or None if the file is
    not BGZF (every member must carry its size in a ``BC`` field)."""
    blocks, pos = [], 0
    while pos < len(raw):
        head = bytes(raw[pos:pos + 18])
        if len(head) < 18 or head[:4] != b"\x1f\x8b\x08\x04" \
                or head[10:12] != b"\x06\x00" or head[12:14] != b"BC":
            return None
        end = pos + int.from_bytes(head[16:18], "little") + 1
        blocks.append((pos, end))
        pos = end
    return blocks


def gunzip(path: str, threads: int = 8) -> bytes:
    """The decompressed bytes of a gzip file of one or more members; the
    members of a BGZF file inflate on ``threads`` threads."""
    with open(path, "rb") as f:
        raw = memoryview(f.read())
    blocks = _bgzf_blocks(raw)
    if blocks is not None:
        def inflate(span):
            return zlib.decompress(raw[span[0] + 18:span[1] - 8], -15)
        with ThreadPoolExecutor(max_workers=threads) as pool:
            return b"".join(pool.map(inflate, blocks))
    out, pos, piece = [], 0, 1 << 20
    while pos < len(raw):
        member = zlib.decompressobj(31)
        while not member.eof:
            if pos >= len(raw):
                raise ValueError(f"{path}: truncated gzip member")
            chunk = raw[pos:pos + piece]
            out.append(member.decompress(chunk))
            pos += len(chunk) - len(member.unused_data)
    return b"".join(out)


class Fastq:
    """One decompressed FASTQ file: its bytes and, per record, where its
    sequence, its qualities and the whole record lie."""

    def __init__(self, path: str):
        self.data = np.frombuffer(gunzip(path), dtype=np.uint8)
        nl = np.flatnonzero(self.data == 10)
        if len(nl) % 4 or (len(self.data) and nl[-1] != len(self.data) - 1):
            raise ValueError(f"{path}: not whole FASTQ records")
        starts = np.concatenate([[0], nl[:-1] + 1])
        if len(nl) and (np.any(self.data[starts[0::4]] != ord("@"))
                        or np.any(self.data[starts[2::4]] != ord("+"))):
            raise ValueError(f"{path}: malformed FASTQ record")
        self.seq_start = starts[1::4]
        self.seq_len = nl[1::4] - self.seq_start
        self.qual_start = starts[3::4]
        if np.any(nl[3::4] - self.qual_start != self.seq_len):
            raise ValueError(f"{path}: sequence and quality lengths differ")
        self.rec_start = starts[0::4]
        self.rec_end = nl[3::4] + 1
        self.count = len(self.seq_start)

    def records(self, positions: np.ndarray) -> bytes:
        """The records at ``positions`` (ascending), as in the file."""
        delta = np.zeros(len(self.data) + 1, dtype=np.int8)
        delta[self.rec_start[positions]] += 1
        delta[self.rec_end[positions]] -= 1
        return self.data[np.cumsum(delta[:-1], dtype=np.int8) > 0].tobytes()


def _cut(fq: Fastq, starts: np.ndarray, cut: slice, block: int = 1 << 18
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Padded uint8 [n, W] rows of ``data[start:start + len][cut]`` per
    record, and their lengths; the padding is 0."""
    lens = fq.seq_len
    out_len = np.empty(fq.count, dtype=np.int64)
    cols_of = {}
    for length in np.unique(lens):
        cols = np.arange(int(length))[cut]
        cols_of[int(length)] = cols
        out_len[lens == length] = len(cols)
    rows = np.zeros((fq.count, int(out_len.max(initial=0))), dtype=np.uint8)
    index = np.int32 if len(fq.data) < 1 << 31 else np.int64
    for length, cols in cols_of.items():
        sel = np.flatnonzero(lens == length)
        cols = cols.astype(index)
        for s in range(0, len(sel) if len(cols) else 0, block):
            part = sel[s:s + block]
            rows[part, :len(cols)] = fq.data[
                starts[part, None].astype(index) + cols[None, :]]
    return rows, out_len


def _join(parts: List[Tuple[np.ndarray, np.ndarray]]
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate each record's pieces, one piece a file."""
    if len(parts) == 1:
        return parts[0]
    lengths = sum(lens for _, lens in parts)
    out = np.zeros((len(lengths), int(lengths.max(initial=0))),
                   dtype=np.uint8)
    offset = np.zeros(len(lengths), dtype=np.int64)
    for rows, lens in parts:
        for width in np.unique(lens):
            cols = np.arange(int(width))
            sel = np.flatnonzero(lens == width)
            for s in range(0, len(sel), 1 << 18):
                part = sel[s:s + (1 << 18)]
                out[part[:, None], offset[part, None] + cols[None, :]] = \
                    rows[part, :int(width)]
        offset += lens
    return out, lengths


def error_rates(quals: np.ndarray, lens: np.ndarray,
                block: int = 1 << 17, dtype=np.float64) -> np.ndarray:
    """Mean per-base error rate of each padded phred row, summed left to
    right in float64 as upstream's C loop does (``np.cumsum`` along a row
    adds in that order); NaN for an empty row.  Another ``dtype`` sums
    and divides in that precision (the control)."""
    table = ERROR_RATE.astype(dtype)
    lens = lens.astype(dtype)
    total = np.zeros(len(quals), dtype=dtype)
    for s in range(0, len(quals) if quals.shape[1] else 0, block):
        q = quals[s:s + block]
        valid = np.arange(q.shape[1])[None, :] < lens[s:s + block, None]
        if np.any(valid & ((q < PHRED_OFFSET) | (q > MAX_PHRED))):
            raise ValueError("quality character outside the phred range")
        rate = table[q - PHRED_OFFSET & 0x7F]
        rate[~valid] = 0.0                # adding 0.0 leaves a sum as it is
        total[s:s + block] = np.cumsum(rate, axis=1, dtype=dtype)[:, -1]
    with np.errstate(invalid="ignore", divide="ignore"):
        return total / lens


def _hash_cols(rows: np.ndarray, start: int, width: int) -> np.ndarray:
    """64-bit hash of ``rows[:, start:start + width]`` (candidate buckets
    only: every candidate is checked exactly)."""
    h = np.full(len(rows), width, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for c in range(start, start + width):
            h = (h ^ rows[:, c].astype(np.uint64)) * _MIX
            h ^= h >> np.uint64(31)
    return h


def _join_equal(ha: np.ndarray, hb: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Every (i, j) with ``ha[i] == hb[j]``."""
    order_a = np.argsort(ha)
    order_b = np.argsort(hb)
    sa, sb = ha[order_a], hb[order_b]
    lo = np.searchsorted(sb, sa, side="left")
    n = np.searchsorted(sb, sa, side="right") - lo
    total = int(n.sum())
    if total > 1 << 28:
        raise MemoryError(f"{total} candidate pairs in one join")
    first = np.repeat(lo - (np.cumsum(n) - n), n)
    return np.repeat(order_a, n), order_b[first + np.arange(total)]


def candidate_pairs(keys: np.ndarray, lens: np.ndarray, d: int, edit: bool,
                    segments: Optional[Sequence[int]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pairs (i < j) of keys that share a pigeonhole segment: key i split
    into d + 1 segments, one of them found in key j at the same place
    (Hamming, equal lengths) or shifted by at most d (Levenshtein,
    lengths at most d apart).  ``segments`` limits the segments searched
    (all by default)."""
    out_i, out_j = [], []
    by_len = {int(L): np.flatnonzero(lens == L) for L in np.unique(lens)}
    hashes: Dict[Tuple[int, int, int], np.ndarray] = {}

    def hashed(length: int, start: int, width: int) -> np.ndarray:
        if (length, start, width) not in hashes:
            hashes[length, start, width] = _hash_cols(
                keys[by_len[length]], start, width)
        return hashes[length, start, width]

    for la, ia in by_len.items():
        bounds = [j * la // (d + 1) for j in range(d + 2)]
        for lb, ib in by_len.items():
            if (lb != la and not edit) or abs(lb - la) > d:
                continue
            for s in (range(d + 1) if segments is None else segments):
                q, w = bounds[s], bounds[s + 1] - bounds[s]
                for shift in (range(-d, d + 1) if edit else (0,)):
                    if q + shift < 0 or q + shift + w > lb:
                        continue
                    i, j = _join_equal(hashed(la, q, w),
                                       hashed(lb, q + shift, w))
                    out_i.append(ia[i])
                    out_j.append(ib[j])
    if not out_i:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    i = np.concatenate(out_i)
    j = np.concatenate(out_j)
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    code = np.unique(lo[lo != hi] * len(keys) + hi[lo != hi])
    return code // len(keys), code % len(keys)


def hamming_within(keys, ci, cj, d, block=1 << 20) -> np.ndarray:
    """Hamming(keys[ci], keys[cj]) <= d (equal lengths; padding is 0)."""
    keep = np.empty(len(ci), dtype=bool)
    for s in range(0, len(ci), block):
        a, b = keys[ci[s:s + block]], keys[cj[s:s + block]]
        keep[s:s + block] = np.count_nonzero(a != b, axis=1) <= d
    return keep


def levenshtein_within(keys, lens, ci, cj, d, block=1 << 18) -> np.ndarray:
    """Levenshtein(keys[ci], keys[cj]) <= d.  Pairs of equal length
    within Hamming distance d are; the others go through a dynamic
    program over the band |row - column| <= d, a block of pairs in
    step."""
    la, lb = lens[ci], lens[cj]
    keep = np.zeros(len(ci), dtype=bool)
    same = np.flatnonzero(la == lb)
    keep[same] = hamming_within(keys, ci[same], cj[same], d)
    rest = np.flatnonzero(~keep & (np.abs(la - lb) <= d))
    big = d + 1
    width = keys.shape[1]
    band = np.arange(2 * d + 1)            # cell k holds column i + k - d
    for s in range(0, len(rest), block):
        sel = rest[s:s + block]
        a = keys[ci[sel]]
        # b[j - 1] sits at b_pad[i + k - 1] for cell k of row i.
        b_pad = np.full((len(sel), width + 2 * d), 0xFF, dtype=np.uint8)
        b_pad[:, d:d + width] = keys[cj[sel]]
        sa, sb = la[sel], lb[sel]
        out = sb - sa + d                  # the cell of (la, lb)
        prev = np.repeat(np.where(band >= d, band - d, big)[None, :],
                         len(sel), axis=0).astype(np.int16)
        result = np.where(sa == 0, prev[np.arange(len(sel)), out], big)
        for i in range(1, int(sa.max(initial=0)) + 1):
            cur = prev + (b_pad[:, i - 1:i + 2 * d] != a[:, i - 1:i])
            cur[:, :-1] = np.minimum(cur[:, :-1], prev[:, 1:] + 1)
            column = i + band - d
            cur[:, column < 0] = big
            cur[:, column == 0] = min(i, big)
            for k in range(1, 2 * d + 1):
                np.minimum(cur[:, k], cur[:, k - 1] + 1, out=cur[:, k])
            np.minimum(cur, big, out=cur)
            done = np.flatnonzero(sa == i)
            result[done] = cur[done, out[done]]
            prev = cur
        keep[sel] = result <= d
    return keep


def neighbours(keys, lens, d, edit, segments=None):
    """Every pair (i < j) of keys within distance ``d``."""
    ci, cj = candidate_pairs(keys, lens, d, edit, segments)
    if edit:
        keep = levenshtein_within(keys, lens, ci, cj, d)
    else:
        keep = hamming_within(keys, ci, cj, d)
    return ci[keep], cj[keep]


def _adjacency(n: int, ei: np.ndarray, ej: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR (offsets, targets) of the undirected edges."""
    src = np.concatenate([ei, ej])
    dst = np.concatenate([ej, ei])
    order = np.argsort(src, kind="stable")
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=offsets[1:])
    return offsets, dst[order]


def _components(n: int, ei: np.ndarray, ej: np.ndarray) -> np.ndarray:
    """Smallest member index of each key's connected component."""
    label = np.arange(n)
    while True:
        li, lj = label[ei], label[ej]
        low = np.minimum(li, lj)
        np.minimum.at(label, li, low)
        np.minimum.at(label, lj, low)
        while True:
            nxt = label[label]
            if np.array_equal(nxt, label):
                break
            label = nxt
        if np.array_equal(label[ei], label[ej]):
            return label


def dissect(counts: np.ndarray, ei: np.ndarray, ej: np.ndarray,
            method: str) -> np.ndarray:
    """bool [n]: the keys kept.  Keys are numbered in ascending key order,
    so (count, index) orders them as upstream's (count, key) tuples."""
    n = len(counts)
    order = np.lexsort((np.arange(n), counts))[::-1]
    if method == "highest_count":
        _, top = np.unique(_components(n, ei, ej)[order], return_index=True)
        kept = np.zeros(n, dtype=bool)
        kept[order[top]] = True
        return kept
    kept = np.ones(n, dtype=bool)
    has_edge = np.zeros(n, dtype=bool)
    has_edge[ei] = has_edge[ej] = True
    offsets, targets = _adjacency(n, ei, ej)
    offsets, targets, cnt = offsets.tolist(), targets.tolist(), \
        counts.tolist()
    done = [False] * n
    for u in order[has_edge[order]].tolist():
        if done[u]:
            continue
        done[u] = True                                  # u is kept
        if method == "adjacency":
            for v in targets[offsets[u]:offsets[u + 1]]:
                if not done[v]:
                    done[v] = True
                    kept[v] = False
            continue
        stack = [u]
        while stack:
            t = stack.pop()
            gate = cnt[t]
            for v in targets[offsets[t]:offsets[t + 1]]:
                if not done[v] and 2 * cnt[v] - 1 <= gate:
                    done[v] = True
                    kept[v] = False
                    stack.append(v)
    return kept


def kept_positions(files: List[Fastq], args: argparse.Namespace,
                   segments: Optional[Sequence[int]] = None,
                   rate_dtype=np.float64) -> np.ndarray:
    """Record numbers written by pass 3, ascending."""
    n = files[0].count
    if any(f.count != n for f in files):
        raise ValueError("input files hold different numbers of records")
    cuts = check_slices(args.check_lengths, len(files))
    keys, lens = _join([_cut(f, f.seq_start, c) for f, c in zip(files, cuts)])
    if np.any(keys[np.arange(keys.shape[1])[None, :] < lens[:, None]] == 0):
        raise ValueError("a key holds a zero byte")
    passed = np.ones(n, dtype=bool)
    if args.max_average_error_rate < 1.0:
        quals, qlens = _join([_cut(f, f.qual_start, c)
                              for f, c in zip(files, cuts)])
        passed = ~(error_rates(quals, qlens, dtype=rate_dtype)
                   > rate_dtype(args.max_average_error_rate))
    # Key number = rank among distinct keys in ascending key order (the
    # 0 padding sorts a key before every longer key it begins).
    void = np.ascontiguousarray(keys).view(f"V{max(keys.shape[1], 1)}")
    key_of = np.unique(void.ravel(), return_inverse=True)[1]
    n_keys = int(key_of.max(initial=-1)) + 1
    counts = np.bincount(key_of[passed], minlength=n_keys)
    first = np.full(n_keys, n, dtype=np.int64)
    np.minimum.at(first, key_of, np.arange(n))
    # The keys of pass 2: those with a counted record.
    live = np.flatnonzero(counts > 0)
    uniq = keys[first[live]]
    ulens = lens[first[live]]
    ei, ej = neighbours(uniq, ulens, args.max_distance, args.edit, segments)
    kept = dissect(counts[live], ei, ej, args.cluster_dissection_method)
    return np.sort(first[live[kept]])


def expected_outputs(args: Sequence[str], input_paths: Sequence[str],
                     segments: Optional[Sequence[int]] = None,
                     rate_dtype=np.float64) -> List[bytes]:
    """The decompressed bytes upstream writes for ``args`` (a command
    line without its inputs and outputs) on ``input_paths``, one output
    per input file.  For the benchmark's controls: ``segments`` limits
    the neighbour search to those pigeonhole segments (a search that
    misses neighbours); ``rate_dtype`` np.float32 computes the quality
    filter's mean error rates in float32."""
    files = [Fastq(p) for p in input_paths]
    positions = kept_positions(files, parse_args(args), segments,
                               rate_dtype)
    return [f.records(positions) for f in files]

