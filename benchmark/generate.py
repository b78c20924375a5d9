"""The benchmark's input generator: synthetic duplicate-heavy FASTQ as BGZF.

A frozen copy of ``chip_smoke.generate_fastq`` (itself the JAX package's
``bench.generate_fastq``): it draws the same random sequence, so a seed
gives the same records.  It writes through a BGZF writer of its own on
``zlib`` (level 1, blocks of 65,280 bytes, compressed on a few threads),
so it needs numpy and the standard library only.

A traffic file (``benchmark/traffic/<name>.json``) holds the keyword
arguments of :func:`generate_fastq` other than the paths, the read count
and the seed, notes under keys that end in ``why``, and ``files``: which files a job reads, in command-line
order (``reads``, and optionally ``mate`` and ``umi``).  The read count
is the configuration's (``reads_per_job``).

Run as a script it writes one traffic's files:
``python3 benchmark/generate.py TRAFFIC.json N_READS SEED OUT_DIR``
prints the paths, one a line.
"""

import contextlib
import json
import os
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

BLOCK_SIZE = 65280
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
COMPANIONS = ("mate", "umi")


def bgzf_block(data: bytes, level: int = 1) -> bytes:
    """One BGZF member holding ``data`` (at most ``BLOCK_SIZE`` bytes)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    bsize = 18 + len(payload) + 8 - 1
    if bsize >= 1 << 16:
        raise ValueError("block does not fit a BGZF frame")
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
              b"\x06\x00BC\x02\x00" + struct.pack("<H", bsize))
    return header + payload + struct.pack(
        "<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)


class BgzfFile:
    """Binary BGZF writer; blocks compress on ``pool`` (zlib releases the
    interpreter lock) and are written in order."""

    def __init__(self, path: str, pool: ThreadPoolExecutor,
                 level: int = 1):
        self._file = open(path, "wb")
        self._pool = pool
        self._level = level
        self._tail = b""

    def write(self, data: bytes) -> None:
        data = self._tail + data
        stop = len(data) - len(data) % BLOCK_SIZE
        blocks = [data[i:i + BLOCK_SIZE]
                  for i in range(0, stop, BLOCK_SIZE)]
        for block in self._pool.map(bgzf_block, blocks,
                                    [self._level] * len(blocks)):
            self._file.write(block)
        self._tail = data[stop:]

    def close(self) -> None:
        if self._tail:
            self._file.write(bgzf_block(self._tail, self._level))
        self._file.write(BGZF_EOF)
        self._file.close()

    def __enter__(self) -> "BgzfFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def apply_indels(rng, seqs: np.ndarray, rate: float, bases: np.ndarray):
    """uint8 [n, L+1] rows and int64 lengths: ``rate`` of the rows of
    ``seqs`` [n, L] lose one base or gain one random base at a random
    position (half each); the others keep length L."""
    n, length = seqs.shape
    hit = np.flatnonzero(rng.random(n) < rate)
    insert = rng.random(len(hit)) < 0.5
    pos = rng.integers(0, length, len(hit))
    new_base = bases[rng.integers(0, 4, len(hit))]
    out = np.zeros((n, length + 1), dtype=np.uint8)
    out[:, :length] = seqs
    lengths = np.full(n, length, dtype=np.int64)
    cols = np.arange(length + 1)
    # Deletion: column c takes c + 1 from pos on.  Insertion: c - 1 past
    # pos, the new base at pos.
    src = np.where(cols[None, :] < pos[:, None], cols[None, :],
                   np.where(insert[:, None], cols[None, :] - 1,
                            cols[None, :] + 1))
    src = src.clip(0, length - 1)
    moved = np.take_along_axis(seqs[hit], src, axis=1)
    moved[insert, pos[insert]] = new_base[insert]
    out[hit] = moved
    lengths[hit] = np.where(insert, length + 1, length - 1)
    return out, lengths


def _headers(block: np.ndarray, start: int, digits: int) -> None:
    block[:, 0:5] = np.frombuffer(b"@read", dtype=np.uint8)
    ids = np.arange(start, start + len(block), dtype=np.int64)
    for d in range(digits):
        block[:, 5 + d] = 48 + (ids // 10 ** (digits - 1 - d)) % 10
    block[:, 5 + digits] = 10


def fastq_block(start: int, seqs: np.ndarray, quals: np.ndarray,
                digits: int = 9) -> bytes:
    """FASTQ bytes of fixed-width records ``@read<id>``, ids from
    ``start``."""
    count, read_len = seqs.shape
    head_len = 5 + digits + 1
    block = np.empty((count, head_len + 2 * read_len + 4), dtype=np.uint8)
    _headers(block, start, digits)
    block[:, head_len:head_len + read_len] = seqs
    block[:, head_len + read_len:head_len + read_len + 3] = \
        np.frombuffer(b"\n+\n", dtype=np.uint8)
    qstart = head_len + read_len + 3
    block[:, qstart:qstart + read_len] = quals
    block[:, -1] = 10
    return block.tobytes()


def quality_mix(rng, quals: np.ndarray, lengths: np.ndarray,
                tail_rate: float, edge_rate: float) -> None:
    """Redraw, in place, the phred characters of two shares of the rows
    of ``quals`` [n, width] (row ``i`` holds ``lengths[i]`` bases).

    ``tail_rate``: a 3' tail of 1 to 10 bases in Q2-Q20, which puts a
    read's mean error rate on either side of 0.001.  ``edge_rate``: a
    read of ``a`` Q20, ``10 a`` Q40 and the rest Q30 bases (``a`` in
    0..9), in random order, whose mean error rate is 0.001 in decimal:
    all Q30 where ``a`` is 0.  Float64 added left to right puts such a
    read on one side of 0.001 and float32 on the other for about one in
    forty."""
    count, width = quals.shape
    cols = np.arange(width)[None, :]
    if tail_rate:
        tail = np.flatnonzero(rng.random(count) < tail_rate)
        size = rng.integers(1, 11, len(tail))
        low = 33 + rng.integers(2, 21, size=(len(tail), width),
                                dtype=np.int8).astype(np.uint8)
        end = lengths[tail, None]
        rows = quals[tail]
        in_tail = (cols >= end - size[:, None]) & (cols < end)
        rows[in_tail] = low[in_tail]
        quals[tail] = rows
    if edge_rate:
        edge = np.flatnonzero(rng.random(count) < edge_rate)
        end = lengths[edge, None]
        a = np.minimum(rng.integers(0, 10, len(edge))[:, None], end // 11)
        value = np.where(cols < a, 20, np.where(cols < 11 * a, 40, 30))
        keys = rng.random((len(edge), width))
        keys[cols >= end] = 2.0            # past the read: left in place
        order = np.argsort(keys, axis=1, kind="stable")
        quals[edge] = 33 + np.take_along_axis(value, order, axis=1).astype(
            np.uint8)


def indel_block(rng, seqs: np.ndarray, start: int, rate: float,
                bases: np.ndarray, digits: int, tail_rate: float = 0.0,
                edge_rate: float = 0.0) -> bytes:
    """FASTQ bytes of ``seqs`` after :func:`apply_indels`: records of
    variable length, laid out in one [n, widest] array and flattened
    through a mask of the bytes each record really has."""
    count, read_len = seqs.shape
    seqs, lengths = apply_indels(rng, seqs, rate, bases)
    width = read_len + 1
    quals = (33 + rng.integers(30, 41, size=(count, width),
                               dtype=np.int8)).astype(np.uint8)
    quality_mix(rng, quals, lengths, tail_rate, edge_rate)
    head_len = 5 + digits + 1
    q0 = head_len + width + 3
    full = np.empty((count, q0 + width + 1), dtype=np.uint8)
    _headers(full, start, digits)
    full[:, head_len:head_len + width] = seqs
    full[:, head_len + width:q0] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    full[:, q0:q0 + width] = quals
    full[:, -1] = 10
    keep = np.ones(full.shape, dtype=bool)
    short = np.arange(width)[None, :] >= lengths[:, None]
    keep[:, head_len:head_len + width] = ~short
    keep[:, q0:q0 + width] = ~short
    return full[keep].tobytes()


def generate_fastq(path: str, n_reads: int, read_len: int, umi_len: int,
                   seed: int = 7, dup_factor: int = 5,
                   error_rate: "float | None" = None,
                   indel_rate: float = 0.0, lowq_rate: float = 0.0,
                   tail_rate: float = 0.0, edge_rate: float = 0.0,
                   mate_path: "str | None" = None,
                   umi_path: "str | None" = None,
                   threads: int = 8) -> None:
    """Write ``n_reads`` 100-base-style reads drawn from ``n_reads //
    dup_factor`` random molecules to ``path`` as BGZF (level 1).

    Without ``error_rate`` 15% of reads get one substitution; with it,
    every base is substituted at that rate.  ``indel_rate`` > 0 adds one
    deletion or insertion to that share of the reads after the
    substitutions.  ``lowq_rate`` > 0 redraws every quality of that share
    of the reads in Q2-Q10.  Qualities are otherwise uniform in Q30-Q40.
    ``mate_path`` and ``umi_path`` name two more files written in the
    same pass, record for record under the same names: the second read
    of each molecule (``read_len`` bases, 15% with one substitution) and
    its UMI (``umi_len`` bases, 5% with one substitution), drawn from a
    generator of their own (``seed + 1``)."""
    rng = np.random.default_rng(seed)
    n_molecules = max(n_reads // dup_factor, 1)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    molecules = bases[rng.integers(0, 4, size=(n_molecules, read_len),
                                   dtype=np.uint8)]
    digits = 9
    with contextlib.ExitStack() as stack:
        pool = stack.enter_context(ThreadPoolExecutor(max_workers=threads))
        extra = []      # (writer, molecule pool, share with one substitution)
        if mate_path or umi_path:
            rng2 = np.random.default_rng(seed + 1)
            for extra_path, width, share in ((mate_path, read_len, 0.15),
                                             (umi_path, umi_len, 0.05)):
                molecule_pool = bases[rng2.integers(
                    0, 4, size=(n_molecules, width), dtype=np.uint8)]
                if extra_path:
                    extra.append((stack.enter_context(
                        BgzfFile(extra_path, pool)), molecule_pool, share))
        f = stack.enter_context(BgzfFile(path, pool))
        step = 250_000
        for start in range(0, n_reads, step):
            stop = min(start + step, n_reads)
            count = stop - start
            picks = rng.integers(0, n_molecules, size=count)
            seqs = molecules[picks]
            if error_rate is None:
                errored = np.flatnonzero(rng.random(count) < 0.15)
                pos = rng.integers(0, read_len, size=len(errored))
                seqs[errored, pos] = bases[
                    rng.integers(0, 4, size=len(errored))]
            else:
                err = rng.random(size=seqs.shape) < error_rate
                seqs = np.where(
                    err, bases[rng.integers(0, 4, size=seqs.shape,
                                            dtype=np.uint8)], seqs)
            for writer, molecule_pool, share in extra:
                other = molecule_pool[picks]
                errored = np.flatnonzero(rng2.random(count) < share)
                pos = rng2.integers(0, other.shape[1], size=len(errored))
                other[errored, pos] = bases[
                    rng2.integers(0, 4, size=len(errored))]
                writer.write(fastq_block(start, other, (33 + rng2.integers(
                    30, 41, size=other.shape, dtype=np.int8)).astype(
                        np.uint8), digits))
            if indel_rate:
                f.write(indel_block(rng, seqs, start, indel_rate, bases,
                                    digits, tail_rate, edge_rate))
                continue
            quals = (33 + rng.integers(
                30, 41, size=(count, read_len),
                dtype=np.int8)).astype(np.uint8)
            if lowq_rate:
                low = np.flatnonzero(rng.random(count) < lowq_rate)
                quals[low] = (33 + rng.integers(
                    2, 11, size=(len(low), read_len),
                    dtype=np.int8)).astype(np.uint8)
            quality_mix(rng, quals, np.full(count, read_len), tail_rate,
                        edge_rate)
            f.write(fastq_block(start, seqs, quals, digits))


def generate_traffic(traffic: Dict, n_reads: int, seed: int,
                     out_dir: str) -> List[str]:
    """Write one job's input files for ``traffic`` (a traffic file's
    contents) into ``out_dir``; returns their paths in command-line
    order."""
    params = {k: v for k, v in traffic.items() if not k.endswith("why")}
    files = params.pop("files", ["reads"])
    unknown = set(files) - {"reads", *COMPANIONS}
    if unknown or files[0] != "reads":
        raise ValueError(f"traffic files must start with 'reads' and name "
                         f"only {COMPANIONS}: {files}")
    paths = {name: os.path.join(out_dir, f"{name}.fastq.gz")
             for name in files}
    generate_fastq(paths["reads"], n_reads, seed=seed,
                   **{f"{name}_path": paths[name] for name in COMPANIONS
                      if name in paths}, **params)
    return [paths[name] for name in files]


def main(argv: List[str]) -> int:
    traffic_path, n_reads, seed, out_dir = argv
    with open(traffic_path) as f:
        traffic = json.load(f)
    for path in generate_traffic(traffic, int(n_reads), int(seed), out_dir):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
