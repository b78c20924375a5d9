"""The port's key-table export (``acc_export_port`` in
``fastqdedup_tpu_torch/native/_fastq_io_port.c``, bound by
``native/loader.py``) gives back every key byte, count, first position
and offset, whatever the length of a table's key arena.

The shared ``acc_export`` copies n >= 8 MiB in 8 pieces of
round_up(n / 8, 4096) bytes, which end short of n where n mod 32768 is
1-7: the last n mod 8 key bytes kept whatever the destination held.
These tables hold such lengths (and 0 mod 32768, which that copy got
right), and each export writes into buffers filled with a byte that no
key holds.  The answers are the keys inserted, not the JAX package's,
which compiles the same C.
"""

import numpy as np
import pytest

from fastqdedup_tpu_torch import runtime
from fastqdedup_tpu_torch.native import loader

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
FILL = 0xEE                  # no key holds it
ARENA = 272 * 32768          # 8.5 MiB: every copy is split in 8 pieces
SHARDS = 2


def _keys(rng, count, length, first):
    """``count`` distinct keys of ``length`` bases, [count, length]: the
    index ``first + i`` in base 4 in the first 12 bases, random after."""
    index = np.arange(first, first + count, dtype=np.int64)
    digits = (index[:, None] >> (2 * np.arange(12))) & 3
    rest = rng.integers(0, 4, (count, length - 12))
    return BASES[np.concatenate([digits, rest], axis=1)]


def _ragged(keys):
    """(bytes, offsets) of a list of keys, as the accumulators take them."""
    lengths = np.array([len(k) for k in keys], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return np.frombuffer(b"".join(keys), dtype=np.uint8).copy(), offsets


def _arena_keys(rng, nbytes, first):
    """Distinct keys that hold ``nbytes`` together: 100 bases each, and
    one last key of 100-199 bases."""
    count = (nbytes - 100) // 100
    rows = _keys(rng, count, 100, first)
    last = _keys(rng, 1, nbytes - 100 * count, first + count)
    return [row.tobytes() for row in rows] + [last[0].tobytes()]


def _shard_of(acc, keys):
    """The shard of ``acc`` that holds each key (an index array)."""
    data, offsets = _ragged(keys)
    where = np.full(len(keys), -1, dtype=np.int64)
    found = np.empty(len(keys), dtype=np.int64)
    for s, handle in enumerate(acc._handles):
        loader._lib.acc_lookup_mt(handle, data, offsets, len(keys), found, 1)
        where[found >= 0] = s
    assert (where >= 0).all()
    return where


def _sharded_keys(rng, nbytes):
    """Distinct keys such that each of the ``SHARDS`` shards of a
    ShardedKeyAccumulator holds ``nbytes`` of them."""
    probe = loader.ShardedKeyAccumulator(expected=1 << 18, shards=SHARDS)
    try:
        count = (nbytes - 100) // 100
        pool = [row.tobytes() for row in
                _keys(rng, count * SHARDS * 5 // 4, 100, 0)]
        lasts = [row.tobytes() for row in
                 _keys(rng, 64, nbytes - 100 * count, len(pool))]
        probe.add(*_ragged(pool + lasts), None, 0)
        shard = _shard_of(probe, pool + lasts)
    finally:
        probe.close()
    keys = []
    for s in range(SHARDS):
        mine = np.flatnonzero(shard[:len(pool)] == s)
        last = np.flatnonzero(shard[len(pool):] == s)
        assert len(mine) >= count and len(last)
        keys += [pool[i] for i in mine[:count]] + [lasts[last[0]]]
    order = rng.permutation(len(keys))
    return [keys[i] for i in order]


def _filled_big_empty(shape, dtype=np.uint8):
    out = np.empty(shape, dtype=dtype)
    out.view(np.uint8).fill(FILL)
    return out


def _insert(acc, rng, keys):
    """Every key once, then a random half of them again, each record
    counted or not at random.  Returns {key: (count, first position)}."""
    again = rng.permutation(len(keys))[:len(keys) // 2]
    records = keys + [keys[i] for i in again]
    counted = rng.random(len(records)) < 0.7
    half = len(keys)
    acc.add(*_ragged(records[:half]), counted[:half], 0)
    acc.add(*_ragged(records[half:]), counted[half:], half)
    want = {key: [0, i] for i, key in enumerate(keys)}
    for key, c in zip(records, counted):
        want[key][0] += int(c)
    return {key: tuple(v) for key, v in want.items()}


def _exported(acc, monkeypatch):
    monkeypatch.setattr(runtime, "big_empty", _filled_big_empty)
    key_out, offsets, counts, first = acc.export()
    got = {}
    for i in range(len(counts)):
        key = key_out[offsets[i]:offsets[i + 1]].tobytes()
        got[key] = (int(counts[i]), int(first[i]))
    return key_out, offsets, got


@pytest.mark.parametrize("residue", [0, 1, 4, 7])
@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_export_gives_back_every_key_byte(monkeypatch, kind, residue):
    """Arenas of 8.5 MiB + ``residue`` bytes a table, exported into
    buffers filled with a byte no key holds."""
    rng = np.random.default_rng(1000 * residue + len(kind))
    nbytes = ARENA + residue
    if kind == "single":
        keys = _arena_keys(rng, nbytes, 0)
        acc = loader.KeyAccumulator(expected=1 << 17)
    else:
        keys = _sharded_keys(rng, nbytes)
        acc = loader.ShardedKeyAccumulator(expected=1 << 18, shards=SHARDS)
    try:
        want = _insert(acc, rng, keys)
        handles = acc._handles if kind == "sharded" else [acc._handle]
        assert [loader._lib.acc_key_bytes(h) for h in handles] == \
            [nbytes] * len(handles)
        key_out, offsets, got = _exported(acc, monkeypatch)
    finally:
        acc.close()
    total = nbytes * len(handles)
    assert len(key_out) == total and offsets[0] == 0
    assert offsets[-1] == total and (np.diff(offsets) > 0).all()
    assert not (key_out == FILL).any()
    assert got == want
    if kind == "single":
        # One table exports in insertion order, here the keys' order.
        assert key_out.tobytes() == b"".join(keys)
