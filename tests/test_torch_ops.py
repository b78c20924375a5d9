"""The port's pair generation and clustering against the JAX package's.

Same numpy inputs (fixed seeds) go through ``fastqdedup_tpu`` and
``fastqdedup_tpu_torch``: ``neighbor_pairs``, ``verify_pairs``,
``hamming_neighbor_pairs_bucketed`` with each device route forced by the
packages' own rate knobs, and ``build_partition_groups`` on one key
table.  Outputs are index pairs and integer arrays, so the tolerance is
exact equality.
"""

import logging
import re

import numpy as np
import pytest
import torch

from fastqdedup_tpu import engine as jax_engine
from fastqdedup_tpu.ops import bucket as jax_bucket
from fastqdedup_tpu.ops import hamming as jax_hamming
from fastqdedup_tpu_torch import engine as torch_engine
from fastqdedup_tpu_torch import runtime
from fastqdedup_tpu_torch.ops import bucket as torch_bucket
from fastqdedup_tpu_torch.ops import hamming as torch_hamming
from fastqdedup_tpu_torch.ops.encode import EncodeTable


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _near_duplicates(seed, n_base, copies, length, alphabet=5):
    """Unique uint8 rows in dense near-duplicate neighbourhoods."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, alphabet, size=(n_base, length), dtype=np.uint8)
    rows = [base]
    for _ in range(copies):
        m = base.copy()
        idx = rng.integers(0, length, size=len(m))
        m[np.arange(len(m)), idx] = rng.integers(0, alphabet, size=len(m))
        rows.append(m)
    return np.unique(np.concatenate(rows), axis=0)


def _bucketed_matrix(seed):
    """Dense near-duplicate neighbourhoods plus a few large buckets: rows
    that share their first half, so the first pigeonhole segment's
    buckets grow past every host cap candidate."""
    rng = np.random.default_rng(seed)
    length = 40
    shared = []
    for _ in range(3):
        base = rng.integers(0, 5, size=length, dtype=np.uint8)
        rows = np.repeat(base[None], 90, axis=0)
        pos = rng.integers(length // 2, length, size=90)
        rows[np.arange(90), pos] = rng.integers(0, 5, size=90)
        shared.append(rows)
    return np.unique(np.concatenate(
        [_near_duplicates(seed, 30, 7, length)] + shared), axis=0)


def _pair_set(pairs):
    return set(zip(pairs[0].tolist(), pairs[1].tolist()))


@pytest.mark.parametrize("tile,d", [(128, 1), (128, 2), (2048, 1)])
def test_neighbor_pairs_matches_jax(tile, d):
    matrix = _near_duplicates(1, 60, 4, 30)
    want = jax_hamming.neighbor_pairs(matrix, 5, d, tile=tile)
    got = torch_hamming.neighbor_pairs(matrix, 5, d, tile=tile)
    assert _pair_set(got) == _pair_set(want)
    assert got[0].dtype == np.int64


@pytest.mark.parametrize("alphabet,d", [(5, 1), (6, 2)])
def test_pairwise_and_rowwise_ops_match_jax(alphabet, d):
    """The plain torch ops of ops/hamming.py (pairwise_hamming,
    pairwise_within, rowwise_within) against their jitted JAX originals."""
    matrix = _near_duplicates(7, 20, 3, 17, alphabet=alphabet)
    a, b = matrix[:50], matrix[-40:]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        torch_hamming.pairwise_hamming(ta, tb, alphabet).numpy(),
        np.asarray(jax_hamming.pairwise_hamming(a, b, alphabet)))
    np.testing.assert_array_equal(
        torch_hamming.pairwise_within(ta, tb, alphabet, d).numpy(),
        np.asarray(jax_hamming.pairwise_within(a, b, alphabet, d)))
    rows = matrix[:40]
    np.testing.assert_array_equal(
        torch_hamming.rowwise_within(tb, torch.from_numpy(rows), alphabet,
                                     d).numpy(),
        np.asarray(jax_hamming.rowwise_within(b, rows, alphabet, d)))


@pytest.mark.parametrize("alphabet,d", [(5, 1), (5, 0), (20, 2)])
def test_verify_pairs_matches_jax(alphabet, d):
    """Packed rowwise kernel (alphabet <= 16) and the torch elementwise
    compare (larger alphabets)."""
    rng = np.random.default_rng(10 + alphabet)
    matrix = _near_duplicates(2, 40, 3, 21, alphabet=alphabet)
    pi = rng.integers(0, len(matrix), size=700).astype(np.int64)
    pj = rng.integers(0, len(matrix), size=700).astype(np.int64)
    want = jax_hamming.verify_pairs(matrix, pi, pj, alphabet, d)
    got = torch_hamming.verify_pairs(matrix, pi, pj, alphabet, d)
    np.testing.assert_array_equal(got, want)


def _bucketed_route_env(monkeypatch, route):
    """Force one route of hamming_neighbor_pairs_bucketed through the
    rate knobs both packages read."""
    if route == "host":
        monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "1e3")
        monkeypatch.setenv("FASTQDEDUP_H2D_RATE", "1e-9")
    elif route in ("bucket-kernel", "oversized"):
        # Cheap dispatch, no upload bandwidth: large buckets go to the
        # size-class kernel (or, above the threshold, the tile sweep)
        # and small ones stay on the host.
        monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "1e-9")
        monkeypatch.setenv("FASTQDEDUP_H2D_RATE", "1e-9")
    elif route == "pair-list":
        monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "1e-9")
        monkeypatch.setenv("FASTQDEDUP_H2D_RATE", "1e15")
        monkeypatch.setenv("FASTQDEDUP_HOST_RATE", "1.0")


def _device_pair_count(records):
    counts = [re.search(r"pairs host=(\d+) device=(\d+)", m)
              for m in records]
    counts = [m for m in counts if m]
    assert counts, "bucketed debug line missing"
    return (sum(int(m.group(1)) for m in counts),
            sum(int(m.group(2)) for m in counts))


@pytest.fixture
def debug_records():
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("fastqdedup")
    handler = Grab(level=logging.DEBUG)
    old = logger.level
    logger.setLevel(logging.DEBUG)
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)
    logger.setLevel(old)


@pytest.mark.parametrize("route,d,threshold", [
    ("host", 1, 2048), ("bucket-kernel", 1, 2048),
    ("bucket-kernel", 2, 2048), ("pair-list", 1, 2048),
    ("oversized", 1, 64),
])
def test_bucketed_pairs_match_jax(monkeypatch, debug_records, route, d,
                                  threshold):
    """Pair sets equal the JAX package's on every route; the debug split
    shows the forced route really ran on the device side."""
    _bucketed_route_env(monkeypatch, route)
    matrix = _bucketed_matrix(3)
    want = jax_bucket.hamming_neighbor_pairs_bucketed(
        matrix, 5, d, large_bucket_threshold=threshold)
    debug_records.clear()
    got = torch_bucket.hamming_neighbor_pairs_bucketed(
        matrix, 5, d, large_bucket_threshold=threshold)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    host, device = _device_pair_count(debug_records)
    if route == "host":
        assert device == 0 < host
    else:
        assert device > 0


def test_bucketed_raw_bytes_with_lut_matches_jax(monkeypatch):
    """Raw key bytes translated through the EncodeTable LUT only at the
    kernel boundary, on the bucket-kernel route."""
    _bucketed_route_env(monkeypatch, "bucket-kernel")
    matrix = _bucketed_matrix(4) % 4
    raw = np.frombuffer(b"ACGT", dtype=np.uint8)[matrix]
    table = EncodeTable("ACGTN")
    want = jax_bucket.hamming_neighbor_pairs_bucketed(
        raw, table.size, 1, encode_lut=table.table)
    got = torch_bucket.hamming_neighbor_pairs_bucketed(
        raw, table.size, 1, encode_lut=table.table)
    assert _pair_set(got) == _pair_set(want)


def _key_groups(seed):
    """A JAX-package KeyGroups of two length groups: one large enough for
    the bucketed path, one for the tile sweep."""
    groups = []
    for length, n_base, copies in ((36, 400, 6), (20, 300, 2)):
        m = _near_duplicates(seed + length, n_base, copies, length,
                             alphabet=4)
        raw = np.frombuffer(b"ACGT", dtype=np.uint8)[m]
        groups.append((length, np.ascontiguousarray(raw)))
    groups.sort()
    lengths, voids, counts, starts, first_pos = [], [], [], [], []
    rng = np.random.default_rng(seed)
    n = 0
    for length, raw in groups:
        lengths.append(length)
        voids.append(raw.view(np.dtype((np.void, length))).ravel())
        counts.append(rng.integers(1, 20, size=len(raw)).astype(np.int64))
        first_pos.append(np.arange(n, n + len(raw), dtype=np.int64))
        starts.append(n)
        n += len(raw)
    return jax_engine.KeyGroups(lengths, voids, counts,
                                np.asarray(starts, dtype=np.int64), n,
                                first_pos=first_pos)


@pytest.mark.parametrize("d", [1, 2])
def test_build_partition_groups_matches_jax(monkeypatch, d):
    """Both engines on one key table, with the host brute-force budget
    pinned so both length groups take device routes."""
    monkeypatch.setattr(jax_engine, "_HOST_BYTE_OP_BUDGET", 1)
    monkeypatch.setattr(jax_engine, "HOST_LIMIT", 8)
    monkeypatch.setattr(torch_engine, "_HOST_BYTE_OP_BUDGET", 1)
    monkeypatch.setattr(torch_engine, "HOST_LIMIT", 8)
    monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "1e-9")
    kg = _key_groups(5)
    want = jax_engine.build_partition_groups(kg, d)
    port_kg = torch_engine.key_groups_from_arrays(
        kg.lengths, kg.voids, kg.counts, kg.starts, kg.n, kg.first_pos)
    got = torch_engine.build_partition_groups(port_kg, d)
    assert got.num_clusters == want.num_clusters < kg.n
    for field in ("order", "starts", "ends", "cluster_of", "local_index",
                  "edges_i", "edges_j"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


@pytest.mark.parametrize("query,d", [
    (b"ACGTACGTAC", 1), (b"ACGTACGTTT", 1), (b"TTTTTTTTTT", 2), (b"", 1),
])
def test_contains_within_matches_jax(query, d):
    rng = np.random.default_rng(8)
    keys = [bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=10)]) for _ in range(300)]
    keys.append(b"ACGTACGTAA")
    assert torch_engine.contains_within(keys, query, d, False) == \
        jax_engine.contains_within(keys, query, d, False)


def test_edit_above_host_limit_matches_jax():
    """Edit mode above HOST_LIMIT keys of five lengths (runs of one base
    that an indel shifts): the port gives the JAX package's partition."""
    keys = [bytes([65 + i % 4]) * 12 + bytes([65 + i // 4 % 4]) * 3
            + bytes([65 + i // 16 % 4]) * (1 + i // 64)
            for i in range(300)]
    keys = sorted(set(keys))
    assert len(keys) > torch_engine.HOST_LIMIT
    want = jax_engine.build_partition(keys, 1, use_edit_distance=True)
    got = torch_engine.build_partition(keys, 1, use_edit_distance=True)
    assert got.num_clusters == want.num_clusters
    for field in ("order", "starts", "ends", "edges_i", "edges_j"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_require_mesh_raises(monkeypatch):
    """The JAX package's threshold rule: under FASTQDEDUP_REQUIRE_MESH=1
    an edge list below FASTQDEDUP_MESH_MIN_EDGES raises; at or above it
    the labels come from the device mesh (here 4 shards on the CPU)."""
    from fastqdedup_tpu_torch.parallel import sharded

    monkeypatch.setenv("FASTQDEDUP_REQUIRE_MESH", "1")
    monkeypatch.setenv("FASTQDEDUP_MESH_MIN_EDGES", "2")
    monkeypatch.setattr(runtime, "local_device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="FASTQDEDUP_MESH_MIN_EDGES"):
        torch_engine._component_labels(3, np.array([0]), np.array([1]))
    before = sharded.MESH_COMPONENT_RUNS
    labels = torch_engine._component_labels(5, np.array([0, 3]),
                                            np.array([1, 4]))
    assert sharded.MESH_COMPONENT_RUNS == before + 1
    assert labels.tolist() == [0, 0, 2, 3, 3]


def test_device_from_environment(monkeypatch):
    assert runtime.device() == torch.device("cpu")
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cuda")
    if torch.cuda.is_available():
        assert runtime.device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            runtime.device()
