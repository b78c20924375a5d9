"""The ``--edit`` route's candidate join on the device
(``ops/edit_candidates.py``), its plain PyTorch version against the
host's join (``ops/bucket.host_edit_join``).

Both joins take the window specs of ``bucket.edit_window_plan``.  The
plain version is what the card's kernels are held to
(tests/test_torch_cuda.py, chip_smoke.py); here it must give the host's
composite branch (``EDIT_RADIX_MIN_ROWS`` patched low) array for array:
one 100 bp group, lengths 99-101, d = 1 and 2, keys that share segments,
each shard of three and their union, empty and short-key inputs.  Its
window hash must equal the native C hash on odd widths and offsets, and
the engine's route forced onto it must give the host route's edges.
Every output is an integer array: exact equality throughout.
"""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.trace import Trace
from fastqdedup_tpu_torch import engine
from fastqdedup_tpu_torch.native.loader import hash_rows_native
from fastqdedup_tpu_torch.ops import bucket
from fastqdedup_tpu_torch.ops import edit_candidates as ec
from fastqdedup_tpu_torch.utils import trace

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _keys(seed, n_mol, lengths, indels=False, shared=False):
    """Unique keys of the given lengths: molecules, each beside copies
    with one substitution (and, with ``indels``, one base deleted or
    inserted); with ``shared``, molecules drawn from few halves, so that
    many keys share a segment."""
    rng = np.random.default_rng(seed)
    keys = set()
    halves = [BASES[rng.integers(0, 4, 60)] for _ in range(6)]
    for _ in range(n_mol):
        length = int(rng.choice(lengths))
        if shared:
            mol = np.concatenate([halves[rng.integers(0, 3)],
                                  halves[3 + rng.integers(0, 3)]])[:length]
            mol = mol.copy()
            mol[rng.integers(0, length)] = BASES[rng.integers(0, 4)]
        else:
            mol = BASES[rng.integers(0, 4, length)]
        keys.add(mol.tobytes())
        for _ in range(2):
            copy = mol.copy()
            copy[rng.integers(0, length)] = BASES[rng.integers(0, 4)]
            keys.add(copy.tobytes())
        if indels:
            pos = int(rng.integers(0, length))
            keys.add(mol[:pos].tobytes() + mol[pos + 1:].tobytes())
            keys.add(mol[:pos].tobytes() + b"G" + mol[pos:].tobytes())
    return sorted(keys)


def _entries(keys):
    """The engine's entries (length, matrix, global ids) and the padded
    key matrix the card route holds (0xFF past each key)."""
    lengths = np.array([len(k) for k in keys], dtype=np.int64)
    entries = []
    for length in np.unique(lengths):
        idx = np.flatnonzero(lengths == length)
        matrix = np.frombuffer(b"".join(keys[i] for i in idx),
                               dtype=np.uint8).reshape(len(idx), length)
        entries.append((int(length), matrix, idx))
    l_pad = -(-max(lengths.max(initial=1), 1) // 16) * 16
    padded = np.full((len(keys), l_pad), 0xFF, dtype=np.uint8)
    for length, matrix, idx in entries:
        padded[idx, :length] = matrix
    return entries, padded


def _both_joins(monkeypatch, keys, d, shard=(0, 1)):
    """(host composite branch's codes, plain device join's codes)."""
    monkeypatch.setattr(bucket, "EDIT_RADIX_MIN_ROWS", 1)
    entries, padded = _entries(keys)
    plan = bucket.edit_window_plan([m for _, m, _ in entries],
                                   [i for _, _, i in entries], d, shard)
    assert ec.fits(plan)
    host = bucket.host_edit_join(plan, shard)
    device = ec.join_codes(torch.from_numpy(padded), plan, shard)
    return host, device


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("case", ["one_group_100", "lengths_99_101",
                                  "shared_segments"])
def test_plain_join_equals_host_composite_branch(monkeypatch, case, d):
    keys = {
        "one_group_100": lambda: _keys(1, 400, [100]),
        "lengths_99_101": lambda: _keys(2, 300, [99, 100, 101], indels=True),
        "shared_segments": lambda: _keys(3, 300, [100], shared=True),
    }[case]()
    host, device = _both_joins(monkeypatch, keys, d)
    assert device.dtype == np.int64
    np.testing.assert_array_equal(device, host)
    assert len(host) > 200
    assert (np.diff(host) > 0).all()


def test_plain_join_shards_union_is_unsharded(monkeypatch):
    keys = _keys(4, 300, [99, 100, 101], indels=True)
    _, full = _both_joins(monkeypatch, keys, 1)
    parts = []
    for pid in range(3):
        host, device = _both_joins(monkeypatch, keys, 1, (pid, 3))
        np.testing.assert_array_equal(device, host)
        parts.append(device)
    assert all(0 < len(p) < len(full) for p in parts)
    np.testing.assert_array_equal(np.unique(np.concatenate(parts)), full)


@pytest.mark.parametrize("keys", [
    [],                                        # no keys at all
    [b"A", b"C", b"AC", b"G"],                 # short keys only (<= 2d)
    [b"A", b"CA", b"ACGTACGTAC", b"ACGTACGTAA", b"TTTTTTTTTT"],
], ids=["empty", "short_only", "short_and_long"])
def test_plain_join_on_empty_and_short_keys(monkeypatch, keys):
    monkeypatch.setattr(bucket, "EDIT_RADIX_MIN_ROWS", 1)
    matrices, gidx = [], []
    if keys:
        entries, padded = _entries(keys)
        matrices = [m for _, m, _ in entries]
        gidx = [i for _, _, i in entries]
    else:
        padded = np.zeros((0, 16), dtype=np.uint8)
    plan = bucket.edit_window_plan(matrices, gidx, 1)
    host = bucket.host_edit_join(plan)
    device = ec.join_codes(torch.from_numpy(padded), plan)
    np.testing.assert_array_equal(device, host)
    got = bucket.edit_pairs_of_codes(plan, device)
    want = bucket.edit_candidate_pairs(matrices, gidx, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int64


@pytest.mark.parametrize("length,start,width", [
    (100, 0, 50), (100, 50, 50), (99, 3, 33), (37, 5, 1), (37, 0, 37),
    (101, 49, 52), (24, 7, 9), (16, 1, 15), (150, 13, 71),
])
def test_plain_window_hash_equals_native(length, start, width):
    rng = np.random.default_rng(length + start)
    n = 77
    matrix = rng.integers(0, 256, (n, length), dtype=np.uint8)
    l_pad = -(-length // 16) * 16
    keys = np.full((n + 5, l_pad), 0xFF, dtype=np.uint8)
    ids = rng.permutation(n + 5)[:n]
    keys[ids, :length] = matrix
    for side in (0, 1):
        plan = bucket.EditPlan(np.empty(0, np.int64), [bucket.EditSpec(
            matrix, ids, start, width, 7 * width + start, side)], n + 5)
        specs, id_list = ec.spec_table(plan)
        values, kept = ec.window_hash(
            torch.from_numpy(keys), torch.from_numpy(id_list),
            torch.from_numpy(specs), n, plan.gid_bits)
        h = hash_rows_native(matrix[:, start:start + width],
                             bucket.window_seed(7 * width + start),
                             strong=False)
        low = np.uint64((1 << (plan.gid_bits + 1)) - 1)
        want = (h & ~low) | np.uint64(side << plan.gid_bits) | \
            ids.astype(np.uint64)
        got = (values.numpy() ^ np.int64(-(1 << 63))).view(np.uint64)
        np.testing.assert_array_equal(got, want)
        assert int(kept) == n


def test_plain_window_hash_ownership_matches_host():
    """Under a shard, the kept rows are those whose hash the host's own
    mix gives to the process; the others hold the largest value."""
    from fastqdedup_tpu_torch.parallel.distributed import _mix64

    rng = np.random.default_rng(5)
    matrix = rng.integers(0, 4, (500, 40), dtype=np.uint8)
    ids = np.arange(500)
    plan = bucket.EditPlan(np.empty(0, np.int64), [bucket.EditSpec(
        matrix, ids, 3, 19, 99, 0)], 500)
    specs, id_list = ec.spec_table(plan)
    h = hash_rows_native(matrix[:, 3:22], bucket.window_seed(99),
                         strong=False)
    owner = _mix64(h ^ np.uint64(bucket.EDIT_OWN_SALT)) % np.uint64(3)
    for pid in range(3):
        values, kept = ec.window_hash(
            torch.from_numpy(np.ascontiguousarray(
                np.pad(matrix, ((0, 0), (0, 8)), constant_values=0xFF))),
            torch.from_numpy(id_list), torch.from_numpy(specs), 500,
            plan.gid_bits, (pid, 3))
        mine = owner == pid
        assert int(kept) == int(mine.sum()) > 100
        v = values.numpy()
        assert (v[~mine] == np.iinfo(np.int64).max).all()
        assert (v[mine] != np.iinfo(np.int64).max).all()


def test_plain_join_steps_on_a_hand_made_run():
    """The count and write passes over sorted values: two probes and two
    windows in one run (ids 5, 9 | 5, 2), a window-only run, a probe
    alone, and a row past the kept count."""
    b = 4  # gid_bits

    def value(run, side, gid):
        return ((run << (b + 1)) | (side << b) | gid) ^ (-(1 << 63))

    ordered = torch.tensor([value(1, 0, 5), value(1, 0, 9), value(1, 1, 2),
                            value(1, 1, 5), value(2, 1, 3), value(2, 1, 4),
                            value(3, 0, 7), value(4, 0, 1)])
    kept = torch.tensor([7])
    counts = ec.join_count(ordered, kept, b)
    assert counts.tolist() == [2, 2, 0, 0, 0, 0, 0, 0]
    ends = torch.cumsum(counts, 0)
    codes = ec.join_write(ordered, kept, b, ends, 4)
    base = 1 << 31
    assert codes.tolist() == [5 * base + 9, 2 * base + 5, 2 * base + 9,
                              5 * base + 9]
    assert ec.unique_codes(codes).tolist() == [2 * base + 5, 2 * base + 9,
                                               5 * base + 9]


def test_spec_table_lists_each_group_once():
    keys = _keys(6, 60, [30, 31])
    entries, _ = _entries(keys)
    plan = bucket.edit_window_plan([m for _, m, _ in entries],
                                   [i for _, _, i in entries], 1)
    specs, ids = ec.spec_table(plan)
    assert len(ids) == len(keys)
    assert specs[:, 0].tolist() == np.concatenate(
        [[0], np.cumsum([len(s.gidx) for s in plan.specs])[:-1]]).tolist()
    for row, spec in zip(specs, plan.specs):
        np.testing.assert_array_equal(ids[row[1]:row[1] + row[2]], spec.gidx)
        assert row[3:6].tolist() == [spec.w_start, spec.width, spec.side]


@pytest.mark.parametrize("d", [1, 2])
def test_engine_route_on_the_plain_join_gives_the_host_edges(monkeypatch,
                                                             d):
    """``_edit_edges_entries`` with the card's route forced on the CPU
    (the plain join, then the indexed verification) returns the host
    route's edges; each join counts its rows where it runs."""
    keys = _keys(7, 250, [99, 100, 101], indels=True)
    entries, _ = _entries(keys)
    before = trace.counts()
    want = engine._edit_edges_entries(entries, len(keys), d)
    monkeypatch.setattr(engine, "_edit_on_card", lambda dev: True)
    got = engine._edit_edges_entries(entries, len(keys), d)
    after = trace.counts()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(want[0]) > 300
    rows = sum(len(s.gidx) for s in bucket.edit_window_plan(
        [m for _, m, _ in entries], [i for _, _, i in entries], d).specs)
    for side in ("host", "device"):
        moved = after.get(f"pairs.edit_rows.{side}", 0) - \
            before.get(f"pairs.edit_rows.{side}", 0)
        assert moved == rows


def _span(name, start_ms, end_ms, **counts):
    s = trace.Span(name)
    s.start, s.end, s.job, s.counts = start_ms * 10**6, end_ms * 10**6, 1, \
        counts
    return s


@pytest.mark.parametrize("counts,share", [
    ({"pairs.edit_rows.device": 300, "pairs.edit_rows.host": 100}, 75.0),
    ({"pairs.edit_rows.device": 2_292_816}, 100.0),
    ({"pairs.edit_rows.host": 5}, 0.0),
    ({}, None),
])
def test_device_share_reader(monkeypatch, counts, share):
    ms = 10 ** 6
    run = Trace(traced=(0, 1000 * ms), window=(200 * ms, 1000 * ms),
                jobs=[(200 * ms, 1000 * ms)])
    spans = [_span("pairs.candidates", 100, 150,
                   **{"pairs.edit_rows.host": 7}),
             _span("job", 200, 1000),
             _span("pairs.candidates", 600, 900, **counts)]
    monkeypatch.setattr(trace, "spans", lambda: spans)
    got = harness.read_metric("pairs.edit_candidates_device_share", run)
    assert got == (None if share is None else pytest.approx(share))


def _dense(keys):
    """The keys as alphabet indices (A, C, G, T -> 0-3), which pack."""
    return [np.searchsorted(BASES, np.frombuffer(k, dtype=np.uint8))
            .astype(np.uint8).tobytes() for k in keys]


@pytest.mark.parametrize("d", [1, 2])
def test_plain_join_on_nibble_packed_keys(monkeypatch, d):
    """The key matrix nibble-packed (``engine.PACK_KEY_MATRIX``): the
    window hash reads the bytes the unpacked matrix holds, and the join
    gives the host's codes."""
    from fastqdedup_tpu_torch.ops.edit import pack_nibble_rows

    monkeypatch.setattr(bucket, "EDIT_RADIX_MIN_ROWS", 1)
    keys = _dense(_keys(8, 200, [99, 100, 101], indels=True))
    entries, padded = _entries(keys)
    plan = bucket.edit_window_plan([m for _, m, _ in entries],
                                   [i for _, _, i in entries], d)
    specs, ids = ec.spec_table(plan)
    packed = torch.from_numpy(pack_nibble_rows(padded))
    assert packed.shape[1] * 2 == padded.shape[1]
    plain, kept = ec.window_hash(torch.from_numpy(padded),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(specs), plan.rows,
                                 plan.gid_bits)
    got, got_kept = ec.window_hash(packed, torch.from_numpy(ids),
                                   torch.from_numpy(specs), plan.rows,
                                   plan.gid_bits, packed=True)
    assert torch.equal(got, plain) and int(got_kept) == int(kept)
    codes = ec.join_codes(packed, plan, packed=True)
    np.testing.assert_array_equal(codes, bucket.host_edit_join(plan))
    assert len(codes) > 200


@pytest.mark.parametrize("which", ["keys", "ids", "specs"])
def test_window_hash_rejects_a_view_that_is_not_contiguous(which):
    """The kernel takes a row's pitch from the shape, so a strided view
    (a column slice of the key matrix) is refused on every device."""
    rng = np.random.default_rng(9)
    matrix = rng.integers(0, 4, (40, 32), dtype=np.uint8)
    plan = bucket.EditPlan(np.empty(0, np.int64), [bucket.EditSpec(
        matrix, np.arange(40), 0, 16, 5, side) for side in (0, 1)], 40)
    specs, ids = ec.spec_table(plan)
    args = {"keys": torch.from_numpy(np.pad(matrix, ((0, 0), (0, 8)))),
            "ids": torch.from_numpy(ids),
            "specs": torch.from_numpy(specs)}
    ec.window_hash(args["keys"], args["ids"], args["specs"], 80,
                   plan.gid_bits)
    args[which] = {
        "keys": lambda t: torch.cat([t, t], 1)[:, ::2],
        "ids": lambda t: torch.stack([t, t], 1)[:, 0],
        "specs": lambda t: torch.cat([t, t], 1)[:, :ec.SPEC_WORDS],
    }[which](args[which])
    assert not args[which].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ec.window_hash(args["keys"], args["ids"], args["specs"], 80,
                       plan.gid_bits)


def test_join_codes_refuses_ids_past_the_composite():
    """A plan of 2^29 keys or more does not fit the composite's id bits:
    the device join raises rather than handing the join to the host."""
    matrix = np.zeros((2, 8), dtype=np.uint8)
    plan = bucket.EditPlan(np.empty(0, np.int64), [bucket.EditSpec(
        matrix, np.arange(2), 0, 4, 5, 0)], (1 << 29) + 1)
    assert plan.gid_bits == 30 and not ec.fits(plan)
    with pytest.raises(ValueError, match="id bits"):
        ec.join_codes(torch.zeros((2, 8), dtype=torch.uint8), plan)


def test_engine_route_on_packed_keys_joins_on_the_device(monkeypatch):
    """``engine.PACK_KEY_MATRIX`` on the card's route (forced on the CPU):
    the packed matrix is joined by the device join, never the host's,
    and the edges equal the host route's."""
    keys = _dense(_keys(10, 200, [99, 100, 101], indels=True))
    entries, _ = _entries(keys)
    want = engine._edit_edges_entries(entries, len(keys), 1)
    monkeypatch.setattr(engine, "_edit_on_card", lambda dev: True)
    monkeypatch.setattr(engine, "PACK_KEY_MATRIX", True)
    calls = []
    inner = ec.join_codes
    monkeypatch.setattr(ec, "join_codes",
                        lambda *a: calls.append(a[3]) or inner(*a))
    monkeypatch.setattr(bucket, "host_edit_join", None)
    monkeypatch.setattr(engine, "host_edit_join", None)
    got = engine._edit_edges_entries(entries, len(keys), 1)
    assert calls == [True]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(want[0]) > 200
