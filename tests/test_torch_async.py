"""Pass 2's asynchronous transfers in the port, against the JAX package.

The bucket route builds each batch in pinned memory and uploads it
``non_blocking``; its drain starts every batch's device-to-host copy
before the first wait.  The pair-list route sends int32 index pairs in
one copy to the indexed pair-list kernel.  The edit route enqueues its
key matrix before candidate generation.  On the CPU device none of this
pins or waits (``ops/transfer.py``), so these tests hold the routes'
answers to the JAX package's (its Pallas kernels in interpret mode) and
the order of the steps with spies; a read before a copy lands shows
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s
``async`` phase).  Every output is an index pair or a bit: exact
equality throughout.
"""

import numpy as np
import pytest
import torch

from fastqdedup_tpu import engine as jax_engine
from fastqdedup_tpu.ops import bucket as jax_bucket
from fastqdedup_tpu_torch import engine as torch_engine
from fastqdedup_tpu_torch.ops import bucket as torch_bucket
from fastqdedup_tpu_torch.ops import hamming_kernels as hk
from fastqdedup_tpu_torch.ops import transfer
from fastqdedup_tpu_torch.ops.encode import pack_nibbles

# Rate knobs both packages read: cheap dispatch and no host compare rate
# send buckets of up to 4 keys to the pair-list route and larger ones to
# the bucket kernel, in one call.
BOTH_ROUTES = {"FASTQDEDUP_DISPATCH_S": "1e-9",
               "FASTQDEDUP_H2D_RATE": "1e15",
               "FASTQDEDUP_HOST_RATE": "1.0"}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _bucket_matrix(seed, length=40):
    """Unique uint8 rows: 60 rows with three copies each, every copy one
    symbol off in the second half (buckets of four keys on the first
    pigeonhole segment: the pair-list route), and three families of rows
    sharing their first half (buckets of dozens of keys: the bucket
    kernel)."""
    rng = np.random.default_rng(seed)
    half = np.arange(length // 2, length)

    def near(rows):
        out = rows.copy()
        pos = rng.choice(half, len(rows))
        out[np.arange(len(rows)), pos] = (out[np.arange(len(rows)), pos]
                                          + rng.integers(1, 5, len(rows))) % 5
        return out

    base = rng.integers(0, 5, (60, length), dtype=np.uint8)
    rows = [base] + [near(base) for _ in range(3)]
    for _ in range(3):
        rows.append(near(np.repeat(
            rng.integers(0, 5, (1, length), dtype=np.uint8), 90, axis=0)))
    return np.unique(np.concatenate(rows), axis=0)


def _spy(monkeypatch, module, name, log):
    inner = getattr(module, name)

    def call(*args, **kwargs):
        log.append((name, args))
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, call)


@pytest.mark.parametrize("d", [1, 2])
def test_bucketed_pairs_on_both_routes_match_jax(monkeypatch, d):
    """One call takes the bucket kernel and the pair-list route; its
    pairs are the JAX package's, and each route really ran."""
    for key, value in BOTH_ROUTES.items():
        monkeypatch.setenv(key, value)
    matrix = _bucket_matrix(5)
    log = []
    _spy(monkeypatch, torch_bucket, "rowwise_within_packed_indexed", log)
    _spy(monkeypatch, torch_bucket, "start_host_copy", log)
    want = jax_bucket.hamming_neighbor_pairs_bucketed(matrix, 5, d)
    got = torch_bucket.hamming_neighbor_pairs_bucketed(matrix, 5, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[0]) > 100
    names = {name for name, _ in log}
    assert names == {"rowwise_within_packed_indexed", "start_host_copy"}


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("encoded", [False, True])
def test_pair_verifier_masks_match_jax(d, encoded):
    """``_DevicePairVerifier.verify`` against the JAX package's verifier
    (gather + Pallas kernel in one jitted program): raw bytes through the
    LUT, or alphabet indices; batches of any size, no padding."""
    rng = np.random.default_rng(20 + d)
    matrix = _bucket_matrix(6 + d, length=37)
    lut = None
    if encoded:
        from fastqdedup_tpu_torch.ops.encode import EncodeTable

        lut = EncodeTable("ACGTN").table
        matrix = np.frombuffer(b"ACGTN", dtype=np.uint8)[matrix]
    mine = torch_bucket._DevicePairVerifier(matrix, lut, d)
    theirs = jax_bucket._DevicePairVerifier(matrix, lut, d)
    for p in (1, 777, 8192, 9000):
        gi = rng.integers(0, len(matrix), p)
        gj = np.where(rng.random(p) < 0.5, gi + 1, rng.integers(
            0, len(matrix), p)) % len(matrix)
        got = mine.verify(gi, gj)
        assert got.dtype == np.bool_ and got.shape == (p,)
        np.testing.assert_array_equal(got, theirs.verify(gi, gj))
    assert got.any() and not got.all()


def test_pair_verifier_sends_int32_indices_in_one_copy(monkeypatch):
    """8 B a pair: one upload of an int32 [2, P] tensor and one launch of
    the indexed entry a batch, on views of that one tensor."""
    matrix = _bucket_matrix(7)
    verifier = torch_bucket._DevicePairVerifier(matrix, None, 1)
    log = []
    _spy(monkeypatch, torch_bucket, "upload", log)
    _spy(monkeypatch, torch_bucket, "rowwise_within_packed_indexed", log)
    gi = np.arange(0, 500, dtype=np.int64) % len(matrix)
    verifier.verify(gi, (gi + 1) % len(matrix))
    assert [name for name, _ in log] == ["upload",
                                         "rowwise_within_packed_indexed"]
    uploaded = log[0][1][0]
    assert uploaded.dtype == torch.int32 and uploaded.shape == (2, 500)
    _, gi_dev, gj_dev, _ = log[1][1]
    assert gi_dev.dtype == gj_dev.dtype == torch.int32
    assert gi_dev.data_ptr() == uploaded.data_ptr()
    assert gj_dev.data_ptr() == uploaded.data_ptr() + 500 * 4


@pytest.mark.parametrize("bad", [-1, 40_000])
def test_pair_verifier_refuses_indices_out_of_range(bad):
    matrix = _bucket_matrix(8)
    verifier = torch_bucket._DevicePairVerifier(matrix, None, 1)
    gi = np.array([0, 1, bad])
    with pytest.raises(IndexError, match="out of range"):
        verifier.verify(gi, np.array([1, 2, 3]))
    with pytest.raises(IndexError, match="out of range"):
        verifier.verify(np.array([1, 2, 3]), gi)


@pytest.mark.parametrize("lanes", [5, 13, 19, 27])
def test_indexed_pair_list_plain_equals_gathered_plain(lanes):
    """The indexed entry's plain version is ``index_select`` +
    ``rowwise_within_plain``; rows of 8 symbols a lane, the last lane
    part pad, pairs of equal, near and unrelated rows, repeated
    indices."""
    rng = np.random.default_rng(lanes)
    length = lanes * 8 - 3
    rows = rng.integers(0, 5, (300, length), dtype=np.uint8)
    rows[1::2] = rows[::2]
    hit = np.flatnonzero(rng.random(150) < 0.6) * 2 + 1
    rows[hit, rng.integers(0, length, len(hit))] = 4
    packed = torch.from_numpy(pack_nibbles(rows, lanes).view(np.int32))
    gi = torch.from_numpy(rng.integers(0, 300, 5000).astype(np.int32))
    gj = torch.from_numpy(np.where(rng.random(5000) < 0.7,
                                   gi.numpy() ^ 1,
                                   rng.integers(0, 7, 5000)).astype(np.int32))
    for d in (0, 1, 2):
        got = hk.rowwise_within_packed_indexed(packed, gi, gj, d)
        want = hk.rowwise_within_plain(packed.index_select(0, gi),
                                       packed.index_select(0, gj), d)
        assert got.dtype == torch.bool and got.shape == (5000, 1)
        assert torch.equal(got, want)
        assert 0 < int(got.sum()) < 5000
    assert hk.LAUNCHES["rowwise_within_packed"] == 0  # plain version only


@pytest.mark.parametrize("bad", [-1, 300])
def test_indexed_pair_list_plain_refuses_indices_out_of_range(bad):
    packed = torch.zeros((300, 5), dtype=torch.int32)
    gi = torch.tensor([0, bad], dtype=torch.int32)
    with pytest.raises(IndexError, match="out of range"):
        hk.rowwise_within_packed_indexed(packed, gi, gi.flip(0), 1)


def test_drain_starts_every_copy_before_the_first_wait(monkeypatch):
    """The JAX package starts every ``copy_to_host_async`` first
    (fastqdedup_tpu/ops/bucket.py:560-566): so does the port's drain,
    and each item is read after its own copy started, in order."""
    monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "1e-9")
    monkeypatch.setenv("FASTQDEDUP_H2D_RATE", "1e-9")
    matrix = _bucket_matrix(9)
    members = [np.arange(start, start + 90) for start in (0, 90, 180)]
    launched = [item + (None,) for item in torch_bucket._launch_bucket_batches(
        matrix, members, 128, 5, 1)]
    assert len(launched) == 1
    # Three batches: one per family, as if each were its own launch.
    launched = launched * 3
    log = []
    _spy(monkeypatch, torch_bucket, "start_host_copy", log)
    _spy(monkeypatch, torch_bucket, "host_array", log)
    drained = list(torch_bucket._drain_bucket_batches(launched, matrix))
    assert [name for name, _ in log] == ["start_host_copy"] * 3 + \
        ["host_array"] * 3
    futures = [item[1] for item in launched]
    assert all(args[0] is future
               for (_, args), future in zip(log[:3], futures))
    assert len(drained) == 3 and all(len(gi) for gi, _ in drained)


def test_drain_budget_resolves_oldest_batches_first(monkeypatch):
    """One bucket a batch and a budget below one batch: every launch
    drains its batch at once; the pairs stay the JAX package's."""
    monkeypatch.setattr(torch_bucket, "MAX_INFLIGHT_BYTES", 1)
    monkeypatch.setattr(torch_bucket, "_buckets_per_call", lambda s: 1)
    monkeypatch.setenv("FASTQDEDUP_DISPATCH_S", "1e-9")
    monkeypatch.setenv("FASTQDEDUP_H2D_RATE", "1e-9")
    matrix = _bucket_matrix(10)
    log = []
    _spy(monkeypatch, torch_bucket, "_drain_bucket_batches", log)
    want = jax_bucket.hamming_neighbor_pairs_bucketed(matrix, 5, 1)
    got = torch_bucket.hamming_neighbor_pairs_bucketed(matrix, 5, 1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(log) >= 3 and all(len(args[0]) == 1 for _, args in log)


def test_transfer_helpers_on_the_cpu_device_copy_nothing():
    """On the CPU device an upload is the host tensor and a host copy
    reads the tensor as it is: the bytes of ``.to(cpu)`` and ``.cpu()``."""
    dev = torch.device("cpu")
    host = transfer.staging((3, 4), torch.int32, dev)
    assert not host.is_pinned()
    assert transfer.upload(host, dev) is host
    tensor = torch.arange(12).reshape(3, 4)
    copy = transfer.start_host_copy(tensor)
    assert copy.event is None
    np.testing.assert_array_equal(transfer.host_array(copy), tensor.numpy())


def _indel_keys(seed, n_mol=150, copies=4, length=40):
    """Unique keys of the indel profile: molecules, copies with 15% one
    substitution and 10% one base deleted or inserted, sorted by length
    then content (three length groups)."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    mol = bases[rng.integers(0, 4, (n_mol, length))]
    seqs = mol[rng.integers(0, n_mol, n_mol * copies)]
    hit = np.flatnonzero(rng.random(len(seqs)) < 0.15)
    seqs[hit, rng.integers(0, length, len(hit))] = \
        bases[rng.integers(0, 4, len(hit))]
    rows, lengths = chip_smoke.apply_indels(rng, seqs, 0.1, bases)
    keys = {row[:n].tobytes() for row, n in zip(rows, lengths)}
    keys |= {row.tobytes() for row in mol}
    return sorted(keys, key=lambda k: (len(k), k))


def _entries(keys):
    lengths = np.array([len(k) for k in keys])
    entries = []
    for length in np.unique(lengths):
        idx = np.flatnonzero(lengths == length).astype(np.int64)
        matrix = np.frombuffer(b"".join(keys[i] for i in idx),
                               dtype=np.uint8).reshape(len(idx), length)
        entries.append((int(length), matrix, idx))
    return entries


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("route", ["cpu", "card"])
def test_edit_edges_match_jax_on_the_indel_profile(monkeypatch, route, d):
    """``_edit_edges_entries`` on keys with indels: the CPU device's
    route, and the card's route forced on the CPU (key matrix enqueued
    before candidate generation, indexed verification) give the JAX
    package's edges."""
    keys = _indel_keys(30 + d)
    entries = _entries(keys)
    assert len(entries) == 3
    if route == "card":
        monkeypatch.setattr(torch_engine, "_edit_on_card", lambda dev: True)
    want = jax_engine._edit_edges_entries(entries, len(keys), d)
    got = torch_engine._edit_edges_entries(entries, len(keys), d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[0]) > 100


def test_edit_key_upload_is_enqueued_before_candidates(monkeypatch):
    """The card's route starts its key-matrix copy, then lists the
    candidate windows, then takes the device tensors just before the
    windows are joined against them (ops/edit_candidates) and verified
    (fastqdedup_tpu/engine.py:240-257 enqueues the copy first too)."""
    from fastqdedup_tpu_torch.ops import edit as edit_ops
    from fastqdedup_tpu_torch.ops import edit_candidates

    monkeypatch.setattr(torch_engine, "_edit_on_card", lambda dev: True)
    log = []
    inner_upload = torch_engine._start_key_upload

    def start(keys, lens, dev):
        log.append("upload enqueued")
        result = inner_upload(keys, lens, dev)

        def take():
            log.append("upload taken")
            return result()

        return take

    monkeypatch.setattr(torch_engine, "_start_key_upload", start)
    _spy(monkeypatch, torch_engine, "edit_window_plan", log)
    _spy(monkeypatch, edit_candidates, "join_codes", log)
    _spy(monkeypatch, torch_engine, "host_edit_join", log)
    _spy(monkeypatch, edit_ops, "edit_verify_indexed", log)
    keys = _indel_keys(40)
    torch_engine._edit_edges_entries(_entries(keys), len(keys), 1)
    order = [entry if isinstance(entry, str) else entry[0] for entry in log]
    assert order[:5] == ["upload enqueued", "edit_window_plan",
                         "upload taken", "join_codes",
                         "edit_verify_indexed"]
