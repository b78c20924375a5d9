"""Pass 2's dissection of a whole partition (``dissect.dissect_partition``).

Held here: the kept keys against the per-cluster oracle
``dissect.dissect_with_adjacency`` for each built-in method, on one
Hamming length group with clusters of 1, 2, 3-64 and over 64 members and
on edit keys of three lengths; the shards of a multi-process run, whose
union is the one-process answer; a user-supplied strategy that yields
unknown keys and repeats; and the two-member closed form at its edges
(a count tie broken on string order, a strict prefix in edit mode, and
the directional count gate).
"""

import random

import numpy as np
import pytest

from fastqdedup_tpu_torch import dissect
from fastqdedup_tpu_torch.engine import build_partition_groups
from fastqdedup_tpu_torch.pipeline import _finalize_groups

METHODS = sorted(dissect.CLUSTER_DISSECTION_METHODS)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _variants(key, rng, k, alphabet="ACGT", edit=False):
    """Up to ``k`` distinct keys at distance 1 from ``key``."""
    out = set()
    for _ in range(50 * k):
        if len(out) >= k:
            break
        pos = rng.randrange(len(key))
        kind = rng.choice("sid") if edit else "s"
        if kind == "s":
            new = key[:pos] + rng.choice(alphabet.replace(key[pos], "")) \
                + key[pos + 1:]
        elif kind == "i":
            new = key[:pos] + rng.choice(alphabet) + key[pos:]
        else:
            new = key[:pos] + key[pos + 1:]
        if new != key:
            out.add(new)
    return sorted(out)


def _hamming_keys(seed=1, length=14):
    """One length group: singletons, pairs, clusters of 3-64 (a key and
    its neighbours) and one cluster of over 64 (two rings of
    substitutions around one key)."""
    rng = random.Random(seed)

    def fresh():
        return "".join(rng.choice("ACGT") for _ in range(length))

    keys = [fresh() for _ in range(40)]
    for _ in range(30):
        base = fresh()
        keys += [base] + _variants(base, rng, 1)
    for size in (3, 4, 7, 12, 30, 64):
        base = fresh()
        keys += [base] + _variants(base, rng, size - 1)
    base = fresh()
    ring = _variants(base, rng, 3 * length)
    keys += [base] + ring + [v for r in ring[:12]
                             for v in _variants(r, rng, 4)]
    return keys


def _edit_keys(seed=2):
    """Edit keys of lengths 7-9: clusters around 8-mers reached by
    substitutions, insertions and deletions, and one of over 64 (its
    8-mer ring and substitutions of a few of them)."""
    rng = random.Random(seed)

    def fresh():
        return "".join(rng.choice("ACGT") for _ in range(8))

    keys = [fresh() for _ in range(30)]
    for size in (2, 2, 2, 3, 5, 9, 20):
        base = fresh()
        keys += [base] + _variants(base, rng, size - 1, edit=True)
    base = fresh()
    ring = _variants(base, rng, 40, edit=True)
    keys += [base] + ring + [v for r in ring[:10]
                             for v in _variants(r, rng, 4)]
    return keys


def _dissect_input(keys, edit, seed=3, counts=None):
    """(groups, partition) of distinct ``keys`` with counts drawn from 1-4
    (ties are common) unless given."""
    rng = random.Random(seed)
    keys = list(dict.fromkeys(keys))
    if counts is None:
        counts = [rng.randrange(1, 5) for _ in keys]
    raw = [k.encode() for k in keys]
    offsets = np.zeros(len(raw) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in raw], out=offsets[1:])
    groups = _finalize_groups(
        np.frombuffer(b"".join(raw), dtype=np.uint8).copy(), offsets,
        np.asarray(counts, dtype=np.int64),
        np.arange(len(raw), dtype=np.int64))
    part = build_partition_groups(groups, 1, edit)
    return groups, part


def _oracle_mask(groups, part, method):
    """Each cluster through ``dissect_with_adjacency``, marked per group."""
    counts = groups.counts_concat()
    kept = [np.zeros(len(c), dtype=bool) for c in groups.counts]
    index_of = {}
    for g, length in enumerate(groups.lengths):
        raw = groups.voids[g].tobytes()
        for row in range(len(groups.counts[g])):
            index_of[raw[row * length:(row + 1) * length]] = (g, row)
    edges = {}
    for i, j in zip(part.edges_i.tolist(), part.edges_j.tolist()):
        c = int(part.cluster_of[i])
        a, b = int(part.local_index[i]), int(part.local_index[j])
        edges.setdefault(c, set()).add((min(a, b), max(a, b)))
    for c in range(part.num_clusters):
        members = part.order[part.starts[c]:part.ends[c]]
        cluster = [(int(counts[i]), groups.key_bytes(int(i)).decode())
                   for i in members]
        for key in dissect.dissect_with_adjacency(method, cluster,
                                                  edges.get(c, set())):
            g, row = index_of[key.encode()]
            kept[g][row] = True
    return kept


def _dissect(groups, part, method, **kwargs):
    return dissect.dissect_partition(
        groups, part, dissect.CLUSTER_DISSECTION_METHODS[method], 1,
        kwargs.pop("edit", False), **kwargs)


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("data", ["hamming", "edit"])
@pytest.mark.parametrize("method", METHODS)
def test_partition_matches_the_per_cluster_oracle(method, data):
    edit = data == "edit"
    groups, part = _dissect_input(
        _edit_keys() if edit else _hamming_keys(), edit)
    sizes = set(part.sizes().tolist())
    assert {1, 2} <= sizes and max(sizes) > 64
    assert any(3 <= s <= 64 for s in sizes)
    assert len(groups.lengths) == (3 if edit else 1)
    got = _dissect(groups, part, method, edit=edit)
    want = _oracle_mask(groups, part, method)
    assert _same(got, want)
    assert 0 < sum(int(m.sum()) for m in got) < groups.n


@pytest.mark.parametrize("nproc", [2, 3])
@pytest.mark.parametrize("method", METHODS)
def test_shards_union_to_the_one_process_answer(method, nproc):
    groups, part = _dissect_input(_hamming_keys(seed=5), False, seed=6)
    whole = _dissect(groups, part, method)
    calls = []

    def identity(idx):
        calls.append(len(idx))
        return idx

    shards = [_dissect(groups, part, method, shard=(pid, nproc),
                       gather=identity) for pid in range(nproc)]
    assert len(calls) == nproc
    union = [np.logical_or.reduce([s[g] for s in shards])
             for g in range(len(whole))]
    assert _same(union, whole)
    assert not any(_same(s, whole) for s in shards)


def test_custom_strategy_with_unknown_keys_and_repeats():
    """Unknown strings (another length, the same length, an empty one)
    are skipped and repeats mark once: the built-in highest_count's
    answer, on one shard or several (a custom strategy ignores
    ``shard``)."""
    groups, part = _dissect_input(_edit_keys(seed=7), True, seed=8)
    seen = []

    def strategy(cluster, max_distance, use_edit_distance):
        seen.append(len(cluster))
        assert max_distance == 1 and use_edit_distance
        yield "A" * 20
        yield "NNNNNNNN"
        yield ""
        best = max(cluster)[1]
        yield best
        yield best

    want = _dissect(groups, part, "highest_count", edit=True)
    for shard in ((0, 1), (1, 2)):
        seen.clear()
        got = dissect.dissect_partition(groups, part, strategy, 1, True,
                                        shard=shard,
                                        gather=lambda idx: idx)
        assert _same(got, want)
        assert sorted(seen) == sorted(s for s in part.sizes().tolist()
                                      if s >= 2)


def test_two_member_count_tie_breaks_on_string_order():
    """Two-member clusters whose counts tie keep the greater string: the
    first differing byte decides, and a strict prefix (edit mode) loses
    to its longer key, as in Python's str order."""
    pairs = [("AAAAAAAA", "AAAAAAA"), ("ACGTACGT", "ACGTACGA"),
             ("CCCCGGGG", "CCCCGGG"), ("TTGGAACC", "TAGGAACC")]
    keys = [k for pair in pairs for k in pair]
    counts = [1, 1, 2, 2, 3, 3, 1, 1]
    groups, part = _dissect_input(keys, True, counts=counts)
    assert sorted(part.sizes().tolist()) == [2] * len(pairs)
    kept_keys = {}
    for method in METHODS:
        got = _dissect(groups, part, method, edit=True)
        assert _same(got, _oracle_mask(groups, part, method))
        kept_keys[method] = {
            groups.key_bytes(int(groups.starts[g]) + int(r)).decode()
            for g in range(len(got)) for r in np.flatnonzero(got[g])}
    greater = {max(pair) for pair in pairs}
    assert greater == {"AAAAAAAA", "ACGTACGT", "CCCCGGGG", "TTGGAACC"}
    assert kept_keys["adjacency"] == kept_keys["highest_count"] == greater
    # Directional keeps the lesser read where 2c - 1 > count: counts 2, 3.
    assert kept_keys["directional"] == greater | {"ACGTACGA", "CCCCGGG"}


def test_two_member_directional_gate_at_its_edge():
    """Directional absorbs the minor read of a pair iff 2c - 1 <= count
    of the major: at 2c - 1 == count it is absorbed, one count below it
    is kept."""
    pairs = [("ACACACAC", "ACACACAG", 5, 3),   # 2*3-1 == 5: absorbed
             ("GTGTGTGT", "GTGTGTGA", 4, 3),   # 5 > 4: kept
             ("CATCATCA", "CATCATCC", 6, 3),   # 5 < 6: absorbed
             ("TGCATGCA", "TGCATGCC", 9, 5)]   # 9 == 9: absorbed
    keys = [k for a, b, _, _ in pairs for k in (a, b)]
    counts = [c for _, _, ca, cb in pairs for c in (ca, cb)]
    groups, part = _dissect_input(keys, False, counts=counts)
    assert sorted(part.sizes().tolist()) == [2] * len(pairs)
    got = _dissect(groups, part, "directional")
    assert _same(got, _oracle_mask(groups, part, "directional"))
    kept = {groups.key_bytes(int(r)).decode()
            for r in np.flatnonzero(got[0])}
    assert kept == {a for a, _, _, _ in pairs} | {"GTGTGTGA"}
