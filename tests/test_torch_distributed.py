"""The port's multi-process layer (parallel/distributed.py and the
pipeline's multi-process modes) against the JAX package's.

Single-process contracts run on the same numpy inputs through both
packages (exact equality: the outputs are indices, counts and bytes).
The 2-process runs start two interpreters of one ``torch.distributed``
job on the CPU device (tests/torch_two_process.py); their output must
equal the JAX package's single-process output on the same input, byte
for byte.
"""

import gzip
import random

import numpy as np
import pytest

from fastqdedup_tpu.parallel import distributed as jax_dist
from fastqdedup_tpu.pipeline import deduplicate_cluster as jax_dedup
from fastqdedup_tpu_torch.parallel import distributed as torch_dist
from torch_two_process import run_two_processes


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def test_shard_for_host_partitions_completely():
    items = list(range(17))
    shards = [torch_dist.shard_for_host(items, process_id=p, num_processes=4)
              for p in range(4)]
    assert shards == [jax_dist.shard_for_host(items, process_id=p,
                                              num_processes=4)
                      for p in range(4)]
    assert sorted(x for s in shards for x in s) == items
    assert all(len(s) in (4, 5) for s in shards)


def test_single_process_passthroughs():
    """Without a process group: the identity partition, and every
    exchange returns its input."""
    assert torch_dist.process_shape() == (0, 1)
    items = ["a.fastq", "b.fastq"]
    assert torch_dist.shard_for_host(items) == items
    kept = {b"ACGT", b"TTTT"}
    assert torch_dist.merge_kept_keys(kept) == kept
    vec = np.arange(5, dtype=np.int64) + (1 << 44)
    assert torch_dist.allgather_int64(vec) is vec
    assert torch_dist.sum_scalars(3, 4) == (3, 4)
    cols = np.ones((2, 3), dtype=np.int64)
    got, sizes = torch_dist.allgather_int64_cols(cols)
    assert got is cols and sizes.tolist() == [3]
    torch_dist.barrier("noop")
    torch_dist.initialize_distributed()  # no environment: a no-op
    assert torch_dist.process_shape() == (0, 1)


def test_partition_buckets_by_hash_matches_jax():
    keys = [bytes([65 + (i % 26)]) * 3 + bytes([i % 250])
            for i in range(200)]
    shards = torch_dist.partition_buckets_by_hash(keys, 4)
    assert shards == jax_dist.partition_buckets_by_hash(keys, 4)
    assert sorted(i for s in shards for i in s) == list(range(200))
    shards2 = torch_dist.partition_buckets_by_hash([b"same"] * 50, 8)
    assert len([s for s in shards2 if s]) == 1


def test_bucket_owner_mask_matches_jax():
    ids = np.random.default_rng(4).integers(
        0, 1 << 63, 1000, dtype=np.int64).astype(np.uint64)
    for salt in (0, 3):
        for pid in range(3):
            np.testing.assert_array_equal(
                torch_dist.bucket_owner_mask(ids, salt, pid, 3),
                jax_dist.bucket_owner_mask(ids, salt, pid, 3))


def test_bucket_shard_union_equals_full():
    """The per-host bucket partition is exact: the union of every shard's
    pair output equals the unsharded output (the JAX package's)."""
    from fastqdedup_tpu.ops import bucket as jax_bucket
    from fastqdedup_tpu_torch.ops import bucket as torch_bucket

    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, size=(900, 20), dtype=np.uint8)
    matrix = np.repeat(base, 4, axis=0)[:3000]
    for i in range(0, len(matrix) - 1, 4):
        matrix[i + 1, rng.integers(20)] = rng.integers(4)
    full_i, full_j = jax_bucket.hamming_neighbor_pairs_bucketed(
        matrix, 5, 1, large_bucket_threshold=32)
    full = set(zip(full_i.tolist(), full_j.tolist()))
    for nproc in (2, 3):
        union = set()
        for p in range(nproc):
            si, sj = torch_bucket.hamming_neighbor_pairs_bucketed(
                matrix, 5, 1, large_bucket_threshold=32, shard=(p, nproc))
            want = jax_bucket.hamming_neighbor_pairs_bucketed(
                matrix, 5, 1, large_bucket_threshold=32, shard=(p, nproc))
            np.testing.assert_array_equal(si, want[0])
            np.testing.assert_array_equal(sj, want[1])
            union |= set(zip(si.tolist(), sj.tolist()))
        assert union == full


def test_edit_shard_union_equals_full():
    """Edit-mode candidate generation and verification striding across
    hosts is exact, and each shard's edges are the JAX package's."""
    from fastqdedup_tpu import engine as jax_engine
    from fastqdedup_tpu.ops.encode import EncodeTable as JaxEncodeTable
    from fastqdedup_tpu_torch import engine as torch_engine
    from fastqdedup_tpu_torch.ops.encode import EncodeTable

    rng = np.random.default_rng(12)
    keys = []
    for _ in range(300):
        k = "".join("ACGT"[c] for c in rng.integers(0, 4, 18))
        keys.append(k.encode())
        if rng.random() < 0.5:
            mutated = bytearray(k.encode())
            op = rng.integers(3)
            pos = rng.integers(len(mutated))
            if op == 0:
                mutated[pos] = ord("ACGT"[rng.integers(4)])
            elif op == 1:
                del mutated[pos]
            else:
                mutated.insert(pos, ord("ACGT"[rng.integers(4)]))
            keys.append(bytes(mutated))
    table = EncodeTable("ACGTN")
    entries = torch_engine._entries_from_keys(
        keys, torch_engine._group_by_length(keys), table)
    fi, fj = torch_engine._edit_edges_entries(entries, len(keys), 1)
    full = set(zip(fi.tolist(), fj.tolist()))
    jax_entries = jax_engine._entries_from_keys(
        keys, jax_engine._group_by_length(keys), JaxEncodeTable("ACGTN"))
    union = set()
    for p in range(2):
        si, sj = torch_engine._edit_edges_entries(entries, len(keys), 1,
                                                  shard=(p, 2))
        wi, wj = jax_engine._edit_edges_entries(jax_entries, len(keys), 1,
                                                shard=(p, 2))
        assert set(zip(si.tolist(), sj.tolist())) == \
            set(zip(wi.tolist(), wj.tolist()))
        union |= set(zip(si.tolist(), sj.tolist()))
    assert union == full


def _meta_rows(seed, n, n_keys):
    rng = np.random.default_rng(seed)
    triples = np.stack([rng.integers(5, 9, size=n_keys),
                        rng.integers(0, 1 << 62, size=n_keys),
                        rng.integers(0, 1 << 62, size=n_keys)], axis=1)
    pick = rng.integers(0, n_keys, size=n)
    return (triples[pick, 0].astype(np.int64),
            triples[pick, 1].astype(np.uint64),
            triples[pick, 2].astype(np.uint64),
            rng.integers(0, 4, size=n).astype(np.int64),
            rng.integers(0, 1 << 40, size=n).astype(np.int64))


def test_owned_meta_merge_union_equals_full_merge():
    """The per-host owned metadata merges (numpy path) equal the JAX
    package's and union (over pid) to the full merge: every key once,
    summed counts, min first positions, zero-count keys dropped, rep =
    smallest gathered row of the key."""
    g_len, g_h1, g_h2, g_cnt, g_fp = _meta_rows(11, 500, 60)
    nproc = 3
    parts = []
    for pid in range(nproc):
        got = torch_dist._owned_meta_merge(g_len, g_h1, g_h2, g_cnt, g_fp,
                                           pid, nproc)
        want = jax_dist._owned_meta_merge(g_len, g_h1, g_h2, g_cnt, g_fp,
                                          pid, nproc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        parts.append(got)
    rep, cnt, fp, ln = (np.concatenate(c) for c in zip(*parts))
    want = {}
    for i in range(len(g_len)):
        key = (int(g_len[i]), int(g_h1[i]), int(g_h2[i]))
        c, f, r = want.get(key, (0, 1 << 62, 1 << 62))
        want[key] = (c + int(g_cnt[i]), min(f, int(g_fp[i])), min(r, i))
    want = {k: v for k, v in want.items() if v[0] > 0}
    got = {(int(ln[i]), int(g_h1[rep[i]]), int(g_h2[rep[i]])):
           (int(cnt[i]), int(fp[i]), int(rep[i])) for i in range(len(rep))}
    assert got == want


def test_owned_meta_merge_tournament_rep_valid_and_balanced():
    """With host segment boundaries (the tournament / native path) the
    merge equals the JAX package's, every representative row belongs to
    its key, and payload contributions spread across hosts."""
    rng = np.random.default_rng(21)
    nhosts, n_keys = 4, 4000
    g_len = np.tile(np.full(n_keys, 20, dtype=np.int64), nhosts)
    h1 = rng.integers(0, 1 << 62, size=n_keys).astype(np.uint64)
    h2 = rng.integers(0, 1 << 62, size=n_keys).astype(np.uint64)
    g_h1, g_h2 = np.tile(h1, nhosts), np.tile(h2, nhosts)
    g_cnt = np.ones(nhosts * n_keys, dtype=np.int64)
    g_fp = rng.integers(0, 1 << 30, size=nhosts * n_keys).astype(np.int64)
    host_starts = np.arange(nhosts + 1, dtype=np.int64) * n_keys
    share = np.zeros(nhosts, dtype=np.int64)
    total = 0
    for pid in range(nhosts):
        got = torch_dist._owned_meta_merge(g_len, g_h1, g_h2, g_cnt, g_fp,
                                           pid, nhosts,
                                           host_starts=host_starts)
        want = jax_dist._owned_meta_merge(g_len, g_h1, g_h2, g_cnt, g_fp,
                                          pid, nhosts,
                                          host_starts=host_starts)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        rep, cnt = got[0], got[1]
        assert (cnt == nhosts).all()
        assert (g_h1[rep] == h1[rep % n_keys]).all()
        np.add.at(share, rep // n_keys, 1)
        total += len(rep)
    assert total == n_keys
    assert share.max() < 0.4 * n_keys, share.tolist()


def test_ragged_take_and_exchange_single_process():
    keys = [b"ACGT", b"", b"TTTTTTT", b"AA"]
    data = np.frombuffer(b"".join(keys), dtype=np.uint8)
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    rows = np.asarray([2, 0], dtype=np.int64)
    taken = torch_dist._ragged_take(data, offsets, rows)
    assert taken.tobytes() == b"TTTTTTTACGT" == \
        jax_dist._ragged_take(data, offsets, rows).tobytes()
    counts = np.asarray([2, 1, 0, 3], dtype=np.int64)
    fp = np.asarray([5, 6, 7, 8], dtype=np.int64)
    h = np.arange(4, dtype=np.uint64)
    d2, o2, c2, f2 = torch_dist.exchange_merge_key_tables(
        data, offsets, counts, fp, h, h)
    got = [d2[o2[i]:o2[i + 1]].tobytes() for i in range(len(c2))]
    assert got == [b"ACGT", b"", b"AA"]
    assert c2.tolist() == [2, 1, 3] and f2.tolist() == [5, 6, 8]


def test_hash_ragged_matches_fixed_width():
    """Ragged and fixed-width hashing agree on equal bytes (the exchange
    compares h2 across hosts whose tables differ in layout)."""
    from fastqdedup_tpu_torch.native.loader import (
        hash_ragged_native,
        hash_rows_native,
    )
    rng = np.random.default_rng(5)
    for w in (1, 7, 8, 17, 100):
        mat = rng.integers(0, 256, size=(50, w), dtype=np.uint8)
        offsets = np.arange(51, dtype=np.int64) * w
        assert (hash_rows_native(mat, 12345, strong=True) ==
                hash_ragged_native(mat.reshape(-1), offsets, 12345,
                                   strong=True)).all()


@pytest.mark.parametrize("transport_on", [True, False])
def test_two_process_exchanges_keep_int64(tmp_path, transport_on):
    """Every exchange of a real 2-process job, over the socket mesh and
    over gloo: int64 values at and above 2^44 (sharded-input record
    offsets are multiples of ``pipeline._SHARD_STRIDE``) arrive whole,
    in process order, and the key-table exchange merges both tables."""
    env = {} if transport_on else {"FASTQDEDUP_TCP_TRANSPORT": "0"}
    run_two_processes(tmp_path, """
import numpy as np
from fastqdedup_tpu_torch.parallel import distributed as d
from fastqdedup_tpu_torch.pipeline import _SHARD_STRIDE
big = pid * _SHARD_STRIDE + np.arange(3, dtype=np.int64) + (1 << 44)
want = np.concatenate([h * _SHARD_STRIDE + np.arange(3) + (1 << 44)
                       for h in range(2)])
assert (d.allgather_int64(big) == want).all()
a, b = d.allgather_int64_pairs(big, -big)
assert (a == want).all() and (b == -want).all()
cols, sizes = d.allgather_int64_cols(np.stack([big, big + 1]))
assert (cols[0] == want).all() and (cols[1] == want + 1).all()
assert sizes.tolist() == [3, 3]
assert d.sum_scalars(1 << 45, pid) == (1 << 46, 1)
presence = np.zeros(256, dtype=bool)
presence[65 + pid] = True
assert np.flatnonzero(d.or_byte_presence(presence)).tolist() == [65, 66]
data, sizes = d.allgather_uint8(np.full(5 + pid, pid, dtype=np.uint8))
assert data.tolist() == [0] * 5 + [1] * 6
assert d.merge_kept_keys({b"A" * (pid + 1)}) == {b"A", b"AA"}
keys = [b"ACGT", b"TT"] if pid == 0 else [b"TT", b"GGG"]
kd = np.frombuffer(b"".join(keys), dtype=np.uint8)
ko = np.cumsum([0] + [len(k) for k in keys]).astype(np.int64)
from fastqdedup_tpu_torch.native.loader import hash_ragged_native
h1 = hash_ragged_native(kd, ko, seed=1)
h2 = hash_ragged_native(kd, ko, seed=2)
cnt = np.asarray([1, 2], dtype=np.int64)
fp = np.asarray([pid * 10, pid * 10 + 1], dtype=np.int64)
md, mo, mc, mf = d.exchange_merge_key_tables(kd, ko, cnt, fp, h1, h2)
merged = {md[mo[i]:mo[i + 1]].tobytes(): (int(mc[i]), int(mf[i]))
          for i in range(len(mc))}
assert merged == {b"ACGT": (1, 0), b"TT": (3, 1), b"GGG": (2, 11)}, merged
d.barrier("done")
""", env)


def _bgzf_pair(tmp_path):
    """Paired BGZF inputs of 1200 records in many small blocks (so byte
    splits land mid-file); the mates are shorter, so the two files split
    at other record ordinals."""
    from fastqdedup_tpu_torch.io.bgzf import BGZF_EOF, compress_block

    rng = random.Random(99)
    mols = ["".join(rng.choice("ACGT") for _ in range(30))
            for _ in range(60)]
    r1, r2 = [], []
    for i in range(1200):
        seq = list(rng.choice(mols))
        if rng.random() < 0.25:
            seq[rng.randrange(30)] = rng.choice("ACGT")
        qual = "".join(chr(33 + rng.randrange(25, 40)) for _ in range(30))
        r1.append(f"@r{i}/1 c\n{''.join(seq)}\n+\n{qual}\n")
        seq2 = "".join(rng.choice("ACGT") for _ in range(12))
        qual2 = "".join(chr(33 + rng.randrange(25, 40)) for _ in range(12))
        r2.append(f"@r{i}/2 c\n{seq2}\n+\n{qual2}\n")
    srcs = [tmp_path / "in1.fastq.gz", tmp_path / "in2.fastq.gz"]
    for path, recs in zip(srcs, (r1, r2)):
        data = "".join(recs).encode()
        with open(path, "wb") as f:
            for off in range(0, len(data), 4096):
                f.write(compress_block(data[off:off + 4096], 1))
            f.write(BGZF_EOF)
    return srcs


@pytest.mark.parametrize("arena,readers,edit", [
    ("1", "1", False), ("1", "3", False), ("restream", "3", False),
    ("1", "3", True)])
def test_two_process_byte_range_ingest_parity(tmp_path, arena, readers,
                                              edit):
    """BGZF inputs take the byte-range ingest path (each process inflates
    and parses only its record range); the merged output equals the JAX
    package's single-process output, on both pass-3 layouts (record
    arena, and — with a 1-byte memory limit — re-streaming only the
    process's window), with one reader or three per process, and in
    ``--edit`` mode."""
    srcs = _bgzf_pair(tmp_path)
    single = [tmp_path / "s1.fastq.gz", tmp_path / "s2.fastq.gz"]
    jax_dedup([str(s) for s in srcs], [str(o) for o in single], None, 1,
              0.001, use_edit_distance=edit, chunk_records=64)

    dist = [tmp_path / "d1.fastq.gz", tmp_path / "d2.fastq.gz"]
    env = {"FASTQDEDUP_INGEST_READERS": readers}
    if arena == "restream":
        env["FASTQDEDUP_MEMORY_LIMIT"] = "1"
    run_two_processes(tmp_path, f"""
from fastqdedup_tpu_torch import pipeline
srcs = [{str(srcs[0])!r}, {str(srcs[1])!r}]
plan = pipeline._plan_input_ranges(srcs, pid, 2)
assert plan, "byte-range ingest did not activate"
per_file, base = plan[0]
assert per_file[0][2] == per_file[1][2] > 0
pipeline.deduplicate_cluster(
    srcs, [{str(dist[0])!r}, {str(dist[1])!r}], None, 1, 0.001,
    use_edit_distance={edit!r}, chunk_records=64)
""", env)
    for s_out, d_out in zip(single, dist):
        want = gzip.open(s_out, "rb").read()
        assert gzip.open(d_out, "rb").read() == want
        assert want


def test_two_process_run_moves_off_a_taken_port(tmp_path, monkeypatch):
    """A port that another process binds between ``free_port`` and the
    store's own bind: the first child fails with EADDRINUSE, the run is
    ended at once (its peer does not wait out the store's timeout) and
    started again on a new port."""
    import socket
    import time

    import torch_two_process

    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    ports = [taken.getsockname()[1]]
    real = torch_two_process.free_port
    given = []

    def next_port():
        given.append(ports.pop(0) if ports else real())
        return given[-1]

    monkeypatch.setattr(torch_two_process, "free_port", next_port)
    t0 = time.monotonic()
    try:
        results = run_two_processes(tmp_path, 'print("RAN", pid)\n')
    finally:
        taken.close()
    assert len(given) == 2 and given[0] != given[1]
    assert [("RAN 0" in text, "RAN 1" in text)
            for _, text in results] == [(True, False), (False, True)]
    assert time.monotonic() - t0 < 120.0
