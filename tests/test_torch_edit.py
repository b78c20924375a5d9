"""The port's Levenshtein (``--edit``) slice against the JAX package's.

Same numpy inputs (fixed seeds) go through ``fastqdedup_tpu`` and
``fastqdedup_tpu_torch``:

* ``banded_within_plain`` (what the edit wrapper computes on the CPU)
  against the Pallas kernel in interpret mode, on the reference's truth
  table, on a fuzz with indels and arbitrary pad bytes, and on 112-wide
  rows with lengths at word edges (the cases the card's kernel is held
  to the plain version on);
* ``batched_edit_distance`` (full-row DP) against the JAX one;
* ``edit_verify_indexed`` against the JAX ``_edit_verify_gathered``;
* ``pack_nibble_rows`` and ``edit_verify_indexed(..., packed=True)``
  against the JAX package's, the unpacked form and the scalar
  ``distance.within_distance``;
* ``edit_candidate_pairs`` on each of its branches;
* ``build_partition`` and ``contains_within`` in edit mode above the
  host limit, on the CPU branch and with the card's branch forced.

Every output is an integer, a bool or an index array: exact equality
throughout.  The CUDA kernel itself is held against the plain version on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from fastqdedup_tpu import engine as jax_engine
from fastqdedup_tpu.ops import bucket as jax_bucket
from fastqdedup_tpu.ops import edit as jax_edit
from fastqdedup_tpu.ops import pallas_edit
from fastqdedup_tpu_torch import engine as torch_engine
from fastqdedup_tpu_torch.ops import bucket as torch_bucket
from fastqdedup_tpu_torch.ops import edit as torch_edit
from fastqdedup_tpu_torch.ops import edit_kernels as ek

# The reference's truth table (tests/test__distance.py:37-60), as
# tests/test_pallas_kernels.py pins it for the Pallas kernel.
TRUTH_TABLE = [
    ("", "", 0, True), ("A", "", 1, True), ("", "AB", 1, False),
    ("ABC", "ABC", 0, True), ("ABC", "ABD", 1, True),
    ("ABC", "ABD", 0, False), ("GC", "AAAGC", 2, False),
    ("GC", "AAAGC", 3, True), ("ABCDE", "ABDEF", 2, True),
    ("ABCDE", "ABDEF", 1, False), ("AAAA", "AAA", 1, True),
    ("AAAA", "AA", 1, False), ("ACGT", "AGCT", 2, True),
]


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _pairs_to_rows(pairs, p):
    """uint8 [p, L] rows (0xFF pads in a, 0xEE in b) and int32 lengths."""
    lmax = max([len(a) for a, _ in pairs] + [len(b) for _, b in pairs] + [1])
    a = np.full((p, lmax), 0xFF, dtype=np.uint8)
    b = np.full((p, lmax), 0xEE, dtype=np.uint8)
    la = np.zeros(p, dtype=np.int32)
    lb = np.zeros(p, dtype=np.int32)
    for i, (x, y) in enumerate(pairs):
        a[i, :len(x)] = np.frombuffer(x.encode(), dtype=np.uint8)
        b[i, :len(y)] = np.frombuffer(y.encode(), dtype=np.uint8)
        la[i], lb[i] = len(x), len(y)
    return a, la, b, lb


def _plain(a, la, b, lb, d):
    out = ek.banded_within_edit_distance(
        torch.from_numpy(a), torch.from_numpy(la), torch.from_numpy(b),
        torch.from_numpy(lb), d)
    assert out.shape == (len(a), 1) and out.dtype == torch.bool
    return out.numpy()


def _pallas(a, la, b, lb, d):
    return np.asarray(pallas_edit.banded_within_edit_distance(
        a, la, b, lb, d))


@pytest.mark.parametrize("d", [0, 1, 2, 3])
def test_banded_plain_truth_table_matches_pallas(d):
    pairs = [(x, y) for x, y, cd, _ in TRUTH_TABLE if cd == d]
    wants = [w for _, _, cd, w in TRUTH_TABLE if cd == d]
    a, la, b, lb = _pairs_to_rows(pairs, pallas_edit.PAIR_BLOCK)
    got = _plain(a, la, b, lb, d)
    np.testing.assert_array_equal(got, _pallas(a, la, b, lb, d))
    assert got[:len(pairs), 0].tolist() == wants
    assert ek.LAUNCHES["banded_within_edit_distance"] == 0


def _indel_fuzz(rng, p, max_len):
    """Random ACGT strings and copies with up to 4 substitutions,
    deletions or insertions."""
    pairs = []
    for _ in range(p):
        x = list(rng.choice(list("ACGT"), size=rng.integers(0, max_len + 1)))
        y = list(x)
        for _ in range(rng.integers(0, 5)):
            op = rng.integers(3)
            if op == 0 and y:
                y[rng.integers(len(y))] = rng.choice(list("ACGT"))
            elif op == 1 and y:
                del y[rng.integers(len(y))]
            elif len(y) < max_len:
                y.insert(rng.integers(len(y) + 1), rng.choice(list("ACGT")))
        pairs.append(("".join(x), "".join(y)))
    return pairs


@pytest.mark.parametrize("d", [1, 2, 3])
def test_banded_plain_fuzz_matches_pallas(d):
    rng = np.random.default_rng(20 + d)
    pairs = _indel_fuzz(rng, pallas_edit.PAIR_BLOCK, 14)
    a, la, b, lb = _pairs_to_rows(pairs, pallas_edit.PAIR_BLOCK)
    got = _plain(a, la, b, lb, d)
    np.testing.assert_array_equal(got, _pallas(a, la, b, lb, d))
    # The pad bytes do not matter: other pads, same answers.
    a2 = np.where(np.arange(a.shape[1]) < la[:, None], a, np.uint8(7))
    b2 = np.where(np.arange(b.shape[1]) < lb[:, None], b, np.uint8(0))
    np.testing.assert_array_equal(_plain(a2, la, b2, lb, d), got)
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("d", [0, 1, 2, 5])
def test_banded_plain_word_edges_matches_pallas(d):
    """The inputs the card's kernel is most likely to get wrong, on which
    chip_smoke.py and tests/test_torch_cuda.py hold it to the plain
    version: 112-wide rows, la and lb at the edges of 4-, 8- and
    16-symbol words, the only difference in the last symbol or in the
    bytes past the lengths, one base deleted near the start.  Here the
    plain version is held to the Pallas kernel on them."""
    rng = np.random.default_rng(90 + d)
    p = pallas_edit.PAIR_BLOCK
    edges = (7, 8, 9, 15, 16, 17, 63, 64, 65, 111, 112)
    a = rng.integers(0, 4, (p, 112), dtype=np.uint8)
    b = a.copy()
    la = np.array(edges, dtype=np.int32)[rng.integers(0, len(edges), p)]
    lb = (la + rng.integers(-d, d + 1, p)).clip(1, 112).astype(np.int32)
    rows = np.arange(p)
    case = rows % 4
    last = np.minimum(la, lb) - 1
    b[rows[case == 1], last[case == 1]] ^= 1
    pad_a = (np.arange(112) >= la[:, None]) & (case == 2)[:, None]
    pad_b = (np.arange(112) >= lb[:, None]) & (case == 2)[:, None]
    a[pad_a] = 0xFF
    b[pad_b] = 0xEE
    b[case == 3, 2:-1] = a[case == 3, 3:]
    got = _plain(a, la, b, lb, d)
    np.testing.assert_array_equal(got, _pallas(a, la, b, lb, d))
    # Rows that are equal, or differ only past the lengths, are within
    # any d at equal lengths; a differing last symbol is not within 0.
    assert got[(case == 0) & (la == lb)].all()
    assert got[(case == 2) & (la == lb)].all()
    assert got[(case == 1) & (la == lb)].all() == (d > 0)
    assert got[case == 3].any() == (d > 0) and not got.all()
    assert ek.LAUNCHES["banded_within_edit_distance"] == 0


@pytest.mark.parametrize("l1,l2", [(12, 12), (9, 15)])
def test_batched_edit_distance_matches_jax(l1, l2):
    rng = np.random.default_rng(l1 * 31 + l2)
    p = 500
    a = rng.integers(0, 5, size=(p, l1), dtype=np.uint8)
    b = rng.integers(0, 5, size=(p, l2), dtype=np.uint8)
    near = rng.random(p) < 0.6
    w = min(l1, l2)
    b[near, :w] = a[near, :w]
    b[near, rng.integers(0, w, p)[near]] = 4
    la = rng.integers(0, l1 + 1, p).astype(np.int32)
    lb = rng.integers(0, l2 + 1, p).astype(np.int32)
    want = np.asarray(jax_edit.batched_edit_distance(a, la, b, lb))
    got = torch_edit.batched_edit_distance(
        torch.from_numpy(a), torch.from_numpy(la), torch.from_numpy(b),
        torch.from_numpy(lb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        torch_edit.batched_within_edit_distance(
            torch.from_numpy(a), torch.from_numpy(la), torch.from_numpy(b),
            torch.from_numpy(lb), 2).numpy(),
        np.asarray(jax_edit.batched_within_edit_distance(a, la, b, lb, 2)))


@pytest.mark.parametrize("d", [1, 2])
def test_edit_verify_indexed_matches_jax(d):
    """Resident keys and index pairs: the port gathers inside the kernel
    wrapper, the JAX package on the device before the Pallas kernel."""
    rng = np.random.default_rng(40 + d)
    pairs = _indel_fuzz(rng, 300, 20)
    keys = [x for x, _ in pairs] + [y for _, y in pairs]
    padded = np.full((len(keys), 32), 0xFF, dtype=np.uint8)
    lens = np.zeros(len(keys), dtype=np.int32)
    for i, k in enumerate(keys):
        padded[i, :len(k)] = np.frombuffer(k.encode(), dtype=np.uint8)
        lens[i] = len(k)
    p = pallas_edit.PAIR_BLOCK
    ci = rng.integers(0, len(keys), p).astype(np.int64)
    cj = rng.integers(0, len(keys), p).astype(np.int64)
    ci[:300] = np.arange(300)
    cj[:300] = np.arange(300, 600)
    want = np.asarray(jax_edit._edit_verify_gathered(
        padded, lens, ci.astype(np.int32), cj.astype(np.int32), d))[:, 0]
    got = torch_edit.edit_verify_indexed(
        torch.from_numpy(padded), torch.from_numpy(lens), ci, cj, d)
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert want[:300].sum() > 100


@pytest.mark.parametrize("packed", [False, True])
def test_edit_verify_indexed_refuses_bad_indices(packed):
    keys = torch.zeros((4, 8 if packed else 16), dtype=torch.uint8)
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(IndexError, match="out of range"):
        torch_edit.edit_verify_indexed(keys, lens, np.array([0, 4]),
                                       np.array([1, 2]), 1, packed=packed)


@pytest.mark.parametrize("width", [2, 16, 30, 112])
def test_pack_nibble_rows_matches_jax(width):
    """Random index matrices (values 0-14) with 0xFF pads past random
    lengths: byte for byte the JAX package's packing; 0xFF packs as 15
    and the even column sits in the high nibble."""
    rng = np.random.default_rng(width)
    matrix = rng.integers(0, 15, (257, width), dtype=np.uint8)
    lengths = rng.integers(0, width + 1, 257)
    matrix[np.arange(width)[None, :] >= lengths[:, None]] = 0xFF
    got = torch_edit.pack_nibble_rows(matrix)
    assert got.dtype == np.uint8 and got.shape == (257, width // 2)
    np.testing.assert_array_equal(got, jax_edit.pack_nibble_rows(matrix))
    unpacked = np.stack([got >> 4, got & 0xF], axis=-1).reshape(257, width)
    np.testing.assert_array_equal(
        unpacked, np.where(matrix == 0xFF, 15, matrix))


@pytest.mark.parametrize("alphabet", [4, 15])
@pytest.mark.parametrize("d", [0, 1, 2])
def test_edit_verify_indexed_packed_matches_unpacked_and_jax(d, alphabet):
    """The nibble-packed key matrix: keys of odd and even real lengths
    (13-20 symbols, indices up to ``alphabet`` - 1) in a 32-wide matrix
    with 0xFF pads.  ``packed=True`` equals ``packed=False``, the JAX
    package's packed and unpacked verifies (its Pallas kernel in
    interpret mode) and the scalar ``within_distance``."""
    from fastqdedup_tpu_torch.distance import within_distance

    rng = np.random.default_rng(100 * alphabet + d)
    n = 300
    base = rng.integers(0, alphabet, (n, 20), dtype=np.uint8)
    keys = []
    for row in base:
        keys.append(row[:rng.integers(13, 21)])
        other = keys[-1].copy()
        for _ in range(rng.integers(0, d + 2)):
            op = rng.integers(0, 3)
            pos = rng.integers(0, len(other))
            if op == 0:
                other[pos] = rng.integers(0, alphabet)
            elif op == 1 and len(other) > 13:
                other = np.delete(other, pos)
            elif len(other) < 20:
                other = np.insert(other, pos, rng.integers(0, alphabet))
        keys.append(other)
    padded = np.full((2 * n, 32), 0xFF, dtype=np.uint8)
    lens = np.zeros(2 * n, dtype=np.int32)
    for i, k in enumerate(keys):
        padded[i, :len(k)] = k
        lens[i] = len(k)
    assert {int(x) % 2 for x in lens} == {0, 1}
    p = pallas_edit.PAIR_BLOCK
    ci = rng.integers(0, 2 * n, p).astype(np.int64)
    cj = rng.integers(0, 2 * n, p).astype(np.int64)
    ci[:n] = 2 * np.arange(n)
    cj[:n] = 2 * np.arange(n) + 1
    packed = torch_edit.pack_nibble_rows(padded)
    t_lens = torch.from_numpy(lens)
    got = torch_edit.edit_verify_indexed(
        torch.from_numpy(packed), t_lens, ci, cj, d, packed=True)
    plain = torch_edit.edit_verify_indexed(
        torch.from_numpy(padded), t_lens, ci, cj, d)
    np.testing.assert_array_equal(got, plain)
    ci32, cj32 = ci.astype(np.int32), cj.astype(np.int32)
    np.testing.assert_array_equal(got, np.asarray(
        jax_edit._edit_verify_gathered_packed(packed, lens, ci32, cj32,
                                              d))[:, 0])
    np.testing.assert_array_equal(got, np.asarray(jax_edit.edit_verify_indexed(
        packed, lens, ci, cj, d, packed=True)))
    np.testing.assert_array_equal(got, np.asarray(
        jax_edit._edit_verify_gathered(padded, lens, ci32, cj32, d))[:, 0])
    strings = [bytes(k + 65).decode("latin-1") for k in keys]
    scalar = [within_distance(strings[i], strings[j], d, True)
              for i, j in zip(ci[:2 * n], cj[:2 * n])]
    np.testing.assert_array_equal(got[:2 * n], scalar)
    assert 0 < got[:n].sum() < n or d == 0


def test_engine_edit_route_packs_when_told(monkeypatch):
    """``engine.PACK_KEY_MATRIX`` with the card's branch forced on the CPU
    device: keys holding byte 0xFF take dense index matrices, which pack;
    the partition equals the unpacked route's and the JAX package's."""
    import random

    rng = random.Random(8)
    symbols = b"\x41\x43\x47\x54\xff"
    keys = set()
    while len(keys) < 400:
        base = bytearray(rng.choice(symbols) for _ in range(16))
        keys.add(bytes(base))
        del base[rng.randrange(16)]
        keys.add(bytes(base))
    keys = sorted(keys)
    monkeypatch.setattr(torch_engine, "_edit_on_card", lambda dev: True)
    packs = []
    inner = torch_edit.pack_nibble_rows
    monkeypatch.setattr(torch_edit, "pack_nibble_rows",
                        lambda m: packs.append(m.shape) or inner(m))
    parts = {}
    for flag in (False, True):
        monkeypatch.setattr(torch_engine, "PACK_KEY_MATRIX", flag)
        part = torch_engine.build_partition(keys, 1, use_edit_distance=True)
        parts[flag] = (part.order.tolist(), part.starts.tolist())
    assert packs == [(len(keys), 16)]
    assert parts[True] == parts[False]
    want = jax_engine.build_partition(keys, 1, use_edit_distance=True)
    assert parts[True] == (want.order.tolist(), want.starts.tolist())


def _edit_groups(seed, n_mol=120, copies=4):
    """Unique keys of lengths 29-31, sorted by length then content:
    30-base molecules and copies with one substitution, deletion or
    insertion."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    keys = set()
    for _ in range(n_mol):
        mol = alphabet[rng.integers(0, 4, 30)]
        keys.add(mol.tobytes())
        for _ in range(copies):
            s = mol.copy()
            op = rng.integers(3)
            pos = int(rng.integers(0, 30))
            if op == 0:
                s[pos] = alphabet[rng.integers(0, 4)]
            elif op == 1:
                s = np.delete(s, pos)
            else:
                s = np.insert(s, pos, alphabet[rng.integers(0, 4)])
            keys.add(s.tobytes())
    keys = sorted(keys, key=lambda k: (len(k), k))
    return keys


def _entries(keys):
    lengths = np.array([len(k) for k in keys])
    matrices, gidx = [], []
    for length in np.unique(lengths):
        idx = np.flatnonzero(lengths == length).astype(np.int64)
        matrices.append(np.frombuffer(b"".join(keys[i] for i in idx),
                                      dtype=np.uint8).reshape(len(idx),
                                                              length))
        gidx.append(idx)
    return matrices, gidx


@pytest.mark.parametrize("d", [1, 2])
def test_edit_candidate_pairs_unsharded_matches_jax(d):
    matrices, gidx = _entries(_edit_groups(7))
    want = jax_bucket.edit_candidate_pairs(matrices, gidx, d)
    got = torch_bucket.edit_candidate_pairs(matrices, gidx, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64 and len(got[0]) > 100


def test_edit_candidate_pairs_sharded_union_is_unsharded():
    matrices, gidx = _entries(_edit_groups(8))
    full = torch_bucket.edit_candidate_pairs(matrices, gidx, 1)
    union = set()
    for pid in range(3):
        want = jax_bucket.edit_candidate_pairs(matrices, gidx, 1,
                                               shard=(pid, 3))
        got = torch_bucket.edit_candidate_pairs(matrices, gidx, 1,
                                                shard=(pid, 3))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        union |= set(zip(got[0].tolist(), got[1].tolist()))
    assert union == set(zip(full[0].tolist(), full[1].tolist()))


@pytest.mark.parametrize("branch", ["numpy", "composite"])
def test_edit_candidate_pairs_join_branches_match_jax(monkeypatch, branch):
    """The JAX package takes its numpy join at this size; the port takes
    the numpy join too, or the composite radix sort with its row
    threshold lowered.  Both give the JAX package's pairs (with a short
    key group, so the complete short-key graph is included)."""
    keys = _edit_groups(9) + [b"AC", b"AG", b"C", b""]
    keys = sorted(set(keys), key=lambda k: (len(k), k))
    matrices, gidx = _entries(keys)
    if branch == "composite":
        from fastqdedup_tpu_torch.native.loader import radix_sort_u64_native
        assert radix_sort_u64_native is not None
        monkeypatch.setattr(torch_bucket, "EDIT_RADIX_MIN_ROWS", 1)
    want = jax_bucket.edit_candidate_pairs(matrices, gidx, 1)
    got = torch_bucket.edit_candidate_pairs(matrices, gidx, 1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_edit_join_runs_matches_jax_on_both_branches(monkeypatch):
    rng = np.random.default_rng(3)
    hashes = rng.integers(0, 40, 3000).astype(np.uint64) << np.uint64(40)
    gids = rng.integers(0, 500, 3000).astype(np.int64)
    sides = rng.integers(0, 2, 3000).astype(np.uint8)
    want = jax_bucket._edit_join_runs(hashes, gids, sides)
    for threshold in (1 << 20, 1):
        monkeypatch.setattr(torch_bucket, "EDIT_RADIX_MIN_ROWS", threshold)
        got = torch_bucket._edit_join_runs(hashes, gids, sides)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
        # Inside a run the gid order may differ; the gids of each
        # (run, side) may not.
        run_of = np.repeat(np.arange(len(want[1])), want[2] - want[1])
        probe = np.arange(len(run_of)) - want[1][run_of] < want[3][run_of]
        key = list(zip(run_of.tolist(), probe.tolist()))
        assert sorted(zip(key, got[0].tolist())) == \
            sorted(zip(key, want[0].tolist()))


def test_edit_candidate_pairs_overflow_raises():
    matrix = np.zeros((1, 8), dtype=np.uint8)
    idx = np.array([torch_bucket._PAIR_BASE], dtype=np.int64)
    with pytest.raises(OverflowError, match="edit-mode"):
        torch_bucket.edit_candidate_pairs([matrix], [idx], 1)


def _force_route(monkeypatch, route):
    if route == "cpu":
        return
    monkeypatch.setattr(torch_engine, "_edit_on_card", lambda dev: True)
    if route == "card-slow-wire":
        # A measured rate of 1 B/s still takes the card's route: the
        # host C DP is never asked.
        monkeypatch.setenv("FASTQDEDUP_H2D_RATE", "1")

        def refuse(*args, **kwargs):
            raise AssertionError("edit verification left the card")

        from fastqdedup_tpu_torch.native import loader
        monkeypatch.setattr(loader, "edit_verify_native", refuse)


@pytest.mark.parametrize("route,d", [
    ("cpu", 1), ("cpu", 2), ("card-resident", 1), ("card-resident", 2),
    ("card-slow-wire", 1),
])
def test_build_partition_edit_matches_jax(monkeypatch, route, d):
    """More than HOST_LIMIT keys of lengths 29-31: the CPU branch
    (full-row DP), and the card's branch forced on the CPU with the key
    matrix resident (indexed kernel wrapper), which a slow measured wire
    does not divert to the host C DP."""
    keys = _edit_groups(11)
    assert len(keys) > torch_engine.HOST_LIMIT
    assert len({len(k) for k in keys}) == 3
    _force_route(monkeypatch, route)
    want = jax_engine.build_partition(keys, d, use_edit_distance=True)
    got = torch_engine.build_partition(keys, d, use_edit_distance=True)
    assert got.num_clusters == want.num_clusters < len(keys)
    for field in ("order", "starts", "ends", "cluster_of", "local_index",
                  "edges_i", "edges_j"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    hamming = torch_engine.build_partition(keys, d)
    assert got.num_clusters < hamming.num_clusters


@pytest.mark.parametrize("query,d", [
    (b"ACGTACGTACGTACGTACGTACGTACGTAC", 1),
    (b"ACGTACGTACGTACGTACGTACGTACGTA", 2), (b"TTTT", 3), (b"", 1),
])
def test_contains_within_edit_matches_jax(query, d):
    keys = _edit_groups(12)
    assert len(keys) > torch_engine.HOST_LIMIT
    assert torch_engine.contains_within(keys, query, d, True) == \
        jax_engine.contains_within(keys, query, d, True)


def test_contains_within_edit_finds_indel_neighbours():
    keys = _edit_groups(13)
    hits = 0
    for k in keys[::40]:
        for probe in (k[1:], k[:5] + b"A" + k[5:], k[:-1] + b"G"):
            want = jax_engine.contains_within(keys, probe, 1, True)
            assert torch_engine.contains_within(keys, probe, 1, True) == \
                want
            hits += want
    assert hits > 0


def test_edit_wrappers_refuse_other_devices_and_negative_d():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    any other device is refused, never routed to the plain version."""
    rows = torch.empty((8, 16), dtype=torch.uint8, device="meta")
    lens = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ek.banded_within_edit_distance(rows, lens, rows, lens, 1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ek.banded_within_edit_distance_indexed(rows, lens, lens, lens, 1)
    cpu_rows = torch.zeros((8, 16), dtype=torch.uint8)
    cpu_lens = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match=">= 0"):
        ek.banded_within_edit_distance(cpu_rows, cpu_lens, cpu_rows,
                                       cpu_lens, -1)
