"""The port's pair generation and clustering against the JAX package's.

Same numpy inputs (fixed seeds) go through ``fastqdedup_tpu`` and
``fastqdedup_tpu_torch``: ``neighbor_pairs``, ``verify_pairs``,
``hamming_neighbor_pairs_bucketed`` with each device route forced by the
packages' own rate knobs, and ``build_partition_groups`` on one key
table.  Outputs are index pairs and integer arrays, so the tolerance is
exact equality.
"""

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
from fastqdedup_tpu_torch.utils import trace


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


def _kept_pairs_since(before):
    """Pairs kept on the host and on the device since the counter totals
    ``before`` (``fastqdedup_tpu_torch.utils.trace``)."""
    after = trace.counts()
    return tuple(after.get(f"pairs.kept.{side}", 0)
                 - before.get(f"pairs.kept.{side}", 0)
                 for side in ("host", "device"))


@pytest.mark.parametrize("route,d,threshold", [
    ("host", 1, 2048), ("bucket-kernel", 1, 2048),
    ("bucket-kernel", 2, 2048), ("pair-list", 1, 2048),
    ("oversized", 1, 64),
])
def test_bucketed_pairs_match_jax(monkeypatch, route, d, threshold):
    """Pair sets equal the JAX package's on every route; the kept-pair
    counters show the forced route really ran on the device side."""
    _bucketed_route_env(monkeypatch, route)
    matrix = _bucketed_matrix(3)
    want = jax_bucket.hamming_neighbor_pairs_bucketed(
        matrix, 5, d, large_bucket_threshold=threshold)
    before = trace.counts()
    got = torch_bucket.hamming_neighbor_pairs_bucketed(
        matrix, 5, d, large_bucket_threshold=threshold)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    host, device = _kept_pairs_since(before)
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


# --------------------------------------------------------------------- #
# Engine contracts that tests/test_engine.py pins on the JAX package


def _cluster_sets(clusters):
    return {frozenset(c.keys) for c in clusters}


def test_build_clusters_tolerates_0xff_key_bytes():
    """Byte 0xFF collides with the padding sentinel: both engines fall
    back to dense index matrices, give the same clusters, and every pair
    within Hamming 1 shares one."""
    import random

    rng = random.Random(3)
    base = bytes(rng.choice(b"\x41\x43\x47\x54\xff") for _ in range(12))
    keys = {base}
    while len(keys) < 80:
        k = bytearray(base)
        for _ in range(rng.randrange(1, 4)):
            k[rng.randrange(12)] = rng.choice(b"\x41\x43\x47\x54\xff")
        keys.add(bytes(k))
    keys = sorted(keys)
    got = torch_engine.build_clusters(keys, [1] * len(keys), max_distance=1)
    want = jax_engine.build_clusters(keys, [1] * len(keys), max_distance=1)
    assert _cluster_sets(got) == _cluster_sets(want)
    member_of = {k: c for c in _cluster_sets(got) for k in c}
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            if sum(x != y for x, y in zip(a, b)) <= 1:
                assert member_of[a] is member_of[b], (a, b)


def test_hamming_pair_code_limit():
    """The i*n+j int64 packing refuses key counts that would wrap, in
    both packages with the same message."""
    messages = []
    for bucket in (jax_bucket, torch_bucket):
        fake = bucket._HAMMING_PAIR_CODE_LIMIT

        class Huge(np.ndarray):
            @property
            def shape(self, _fake=fake):
                return (_fake + 1, 8)

        huge = np.zeros((4, 8), dtype=np.uint8).view(Huge)
        with pytest.raises(OverflowError,
                           match="equal-length unique keys") as info:
            bucket.hamming_neighbor_pairs_bucketed(huge, 5, 1)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_edit_pair_code_limit():
    """Edit-mode i*2^31+j packing refuses global indices >= 2^31."""
    messages = []
    for bucket in (jax_bucket, torch_bucket):
        matrix = np.zeros((2, 8), dtype=np.uint8)
        gidx = np.asarray([0, bucket._PAIR_BASE + 5], dtype=np.int64)
        with pytest.raises(OverflowError,
                           match="edit-mode pair encoding") as info:
            bucket.edit_candidate_pairs([matrix], [gidx], 1)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_host_device_crossover_moves_with_dispatch_cost(monkeypatch):
    """The host-bucket cap follows the measured rates: a costly dispatch
    keeps 60-member buckets on the host, a free one sends them to the
    device; both packages choose the same caps."""
    sizes = np.full(100, 60, dtype=np.int64)
    monkeypatch.setenv("FASTQDEDUP_HOST_RATE", "2e9")
    monkeypatch.setenv("FASTQDEDUP_H2D_RATE", "1e9")
    caps = {}
    for label, dispatch in (("slow", "0.5"), ("fast", "0.0000001")):
        monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", dispatch)
        caps[label] = torch_bucket.choose_host_bucket_cap(sizes, 100, 2048)
        assert caps[label] == jax_bucket.choose_host_bucket_cap(
            sizes, 100, 2048)
    assert caps["slow"] >= 60 > caps["fast"]


@pytest.mark.parametrize("path", ["classes", "oversized"])
def test_bucketed_exact_under_hash_collisions(monkeypatch, path):
    """Bucket hashes may collide: different segment contents landing in
    one bucket must not give false pairs (the per-pair segment re-check
    prunes them).  A 4-valued hash in both packages; the pairs equal the
    JAX package's and brute force."""
    import random

    def weak_hash(window, salt, strong=True):
        return window.astype(np.uint64).sum(axis=1) % np.uint64(4)

    for bucket in (jax_bucket, torch_bucket):
        monkeypatch.setattr(bucket, "_hash_window_rows", weak_hash)
    monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "1e-9")
    rng = random.Random(11)
    keys = list(dict.fromkeys(
        "".join(rng.choice("ACGT") for _ in range(10)).encode()
        for _ in range(400)))
    matrix = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(-1, 10)
    matrix = EncodeTable("ACGTN").encode(matrix)
    threshold = 2048 if path == "classes" else 8
    got = set(zip(*(x.tolist() for x in
                    torch_bucket.hamming_neighbor_pairs_bucketed(
                        matrix, 5, 1, large_bucket_threshold=threshold))))
    want = set(zip(*(x.tolist() for x in
                     jax_bucket.hamming_neighbor_pairs_bucketed(
                         matrix, 5, 1, large_bucket_threshold=threshold))))
    distance = (matrix[:, None, :] != matrix[None, :, :]).sum(axis=2)
    brute = {(i, j) for i, j in zip(*np.nonzero(distance <= 1)) if i < j}
    assert got == want == brute


def test_edit_candidate_completeness_brute_force():
    """Every true Levenshtein <= 1 pair (substitutions, insertions,
    deletions, across lengths) is among the port's candidates, which are
    the JAX package's."""
    from fastqdedup_tpu_torch.distance import within_distance

    rng = np.random.default_rng(5)
    keys = []
    for length in (12, 13):
        for _ in range(40):
            m = rng.integers(0, 4, size=length, dtype=np.uint8)
            v = m.copy()
            v[rng.integers(0, len(v))] = rng.integers(0, 4)
            keys += [m, v, np.delete(m, rng.integers(0, len(m))),
                     np.insert(m, rng.integers(0, len(m) + 1),
                               rng.integers(0, 4))]
    uniq = list({bytes(k): k for k in keys}.values())
    by_len = {}
    for i, k in enumerate(uniq):
        by_len.setdefault(len(k), []).append(i)
    mats = [np.stack([uniq[i] for i in idxs]).astype(np.uint8)
            for idxs in by_len.values()]
    gidx = [np.asarray(idxs, dtype=np.int64) for idxs in by_len.values()]
    ci, cj = torch_bucket.edit_candidate_pairs(mats, gidx, 1)
    wi, wj = jax_bucket.edit_candidate_pairs(mats, gidx, 1)
    cand = set(zip(ci.tolist(), cj.tolist()))
    assert cand == set(zip(wi.tolist(), wj.tolist()))
    strs = [bytes(k + 65).decode("latin-1") for k in uniq]
    for i in range(len(uniq)):
        for j in range(i + 1, len(uniq)):
            if within_distance(strs[i], strs[j], 1, True):
                assert (i, j) in cand, (strs[i], strs[j])
