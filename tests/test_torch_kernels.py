"""The port's Hamming kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of ``fastqdedup_tpu_torch.ops.hamming_kernels``
computes its plain PyTorch version; these tests hold that version against
the Pallas kernel run in interpret mode (as tests/test_pallas_kernels.py
runs it) and against the XLA bucket formulation, on the same numpy inputs
made from a fixed seed.  Every output is integer or boolean, so the
tolerance is exact equality throughout.

The CUDA kernels themselves are held against these plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from fastqdedup_tpu.ops import pallas_hamming as pallas
from fastqdedup_tpu.ops.bucket import _bucketed_within_padded
from fastqdedup_tpu.ops.encode import pack_nibbles
from fastqdedup_tpu_torch.ops import hamming_kernels as hk


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _bucket_batch(rng, buckets, size, length, max_fill=None, alphabet=5):
    """uint8 [K, S, Lp] of near-duplicate rows, 0xFF-padded in both the
    row and the length dimension, like bucket._launch_bucket_batches."""
    l_pad, _ = hk._pad_dims(length, alphabet)
    batch = np.full((buckets, size, l_pad), 0xFF, dtype=np.uint8)
    base = rng.integers(0, alphabet, size=length, dtype=np.uint8)
    for k in range(buckets):
        fill = int(rng.integers(2, (max_fill or size) + 1))
        rows = np.repeat(base[None], fill, axis=0)
        flips = rng.integers(0, 3, size=fill)
        for i in range(fill):
            pos = rng.integers(0, length, size=flips[i])
            rows[i, pos] = rng.integers(0, alphabet, size=flips[i])
        batch[k, :fill, :length] = rows
    return batch


def _pallas_bucket(batch, length, d, a_pad):
    scalars = np.array([[length, d]], dtype=np.int32)
    return np.asarray(pallas.bucket_within_packed(batch, scalars, a_pad))


@pytest.mark.parametrize("buckets,size,length,d", [
    (64, 128, 20, 1),   # S == 128 and K % G == 0: the grouped body
    (2, 256, 33, 2),    # the tiled body, L not a multiple of 16
    (3, 128, 50, 0),    # K % G != 0 at S == 128: tiled body, d = 0
])
def test_bucket_plain_matches_pallas(buckets, size, length, d):
    """Exact equality with both bodies of the Pallas bucket kernel."""
    rng = np.random.default_rng(100 + size + d)
    batch = _bucket_batch(rng, buckets, size, length, max_fill=size - 5)
    _, a_pad = hk._pad_dims(length, 5)
    want = _pallas_bucket(batch, length, d, a_pad)
    got = hk.bucket_within_packed(torch.from_numpy(batch), length, d,
                                  a_pad).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert hk.LAUNCHES["bucket_within_packed"] == 0  # plain version only


@pytest.mark.parametrize("size", [128, 512])
@pytest.mark.parametrize("length,d,alphabet", [
    (2, 0, 8), (37, 1, 8), (2, 1, 24), (37, 2, 24), (37, 0, 5),
])
def test_bucket_plain_matches_pallas_wider_alphabets(size, length, d,
                                                     alphabet):
    """The plain version the CUDA kernel is judged by, pinned where that
    kernel changes route (alphabet_pad 8 against 24) and at widths that
    fill neither a 16-symbol group nor a 4-symbol word."""
    rng = np.random.default_rng(size + length + alphabet)
    batch = _bucket_batch(rng, 3, size, length, max_fill=size - 5,
                          alphabet=alphabet)
    l_pad, a_pad = hk._pad_dims(length, alphabet)
    assert a_pad == alphabet and batch.shape[2] == l_pad
    want = _pallas_bucket(batch, length, d, a_pad)
    got = hk.pairs_within_plain(torch.from_numpy(batch),
                                torch.from_numpy(batch), length, d,
                                a_pad).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < int(np.unpackbits(want).sum()) < want.size * 8


@pytest.mark.parametrize("length,d", [(20, 1), (50, 2), (17, 0)])
def test_bucket_plain_matches_xla(length, d):
    """Exact equality with the XLA formulation the JAX package runs off
    the TPU (bucket._bucketed_within_padded)."""
    rng = np.random.default_rng(7 + length)
    batch = _bucket_batch(rng, 4, 128, length)
    _, a_pad = hk._pad_dims(length, 5)
    want = np.asarray(_bucketed_within_padded(
        batch, np.array([length, d], dtype=np.int32), a_pad))
    got = hk.bucket_within_packed(torch.from_numpy(batch), length, d,
                                  a_pad).numpy()
    np.testing.assert_array_equal(got, want)


def test_bucket_length_at_most_d_matches_everything():
    """length <= d: pad rows count as within too, exactly as in the
    Pallas kernel (bucket.py handles this case before any launch)."""
    rng = np.random.default_rng(3)
    batch = _bucket_batch(rng, 1, 128, 2, max_fill=40)
    want = _pallas_bucket(batch, 2, 2, 5)
    got = hk.bucket_within_packed(torch.from_numpy(batch), 2, 2, 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0xFF).all()


@pytest.mark.parametrize("n,m,length,alphabet,d", [
    (128, 128, 24, 5, 1), (256, 128, 16, 4, 2), (128, 256, 31, 6, 0),
])
def test_within_tile_plain_matches_pallas(n, m, length, alphabet, d):
    rng = np.random.default_rng(11 + n + m + d)
    a = rng.integers(0, alphabet, size=(n, length), dtype=np.uint8)
    b = np.concatenate([a, a])[:m].copy()
    b[np.arange(m), rng.integers(0, length, size=m)] = rng.integers(
        0, alphabet, size=m)
    a[-3:] = 0xFF  # pad rows match nothing
    want = np.asarray(pallas.within_tile_packed(a, b, alphabet, d))
    got = hk.within_tile_packed(torch.from_numpy(a), torch.from_numpy(b),
                                alphabet, d).numpy()
    assert got.shape == (n, m // 8)
    np.testing.assert_array_equal(got, want)
    # The unpacked convenience form, against the JAX package's.
    from fastqdedup_tpu_torch.ops.hamming import within_tile_kernel
    unpacked = within_tile_kernel(torch.from_numpy(a), torch.from_numpy(b),
                                  alphabet, d)
    assert unpacked.shape == (n, m) and unpacked.dtype == np.bool_
    np.testing.assert_array_equal(
        unpacked, pallas.within_tile_kernel(a, b, alphabet, d))


@pytest.mark.parametrize("length,d", [(24, 1), (7, 2), (40, 0), (100, 1)])
def test_rowwise_plain_matches_pallas(length, d):
    rng = np.random.default_rng(9 + length)
    n = 300
    a = rng.integers(0, 5, size=(n, length), dtype=np.uint8)
    b = a.copy()
    for i in range(n):
        pos = rng.integers(0, length, size=rng.integers(0, 4))
        b[i, pos] = rng.integers(0, 5, size=len(pos))
    lanes = max(-(-length // 8), 1)
    pa = np.zeros((hk.ROW_BLOCK, lanes), dtype=np.uint32)
    pb = np.zeros((hk.ROW_BLOCK, lanes), dtype=np.uint32)
    pa[:n] = pack_nibbles(a, lanes)
    pb[:n] = pack_nibbles(b, lanes)
    pb[n:n + 4] = 0xFFFFFFFF  # every bit of every lane differs
    want = np.asarray(pallas.rowwise_within_packed(pa, pb, d))
    got = hk.rowwise_within_packed(torch.from_numpy(pa.view(np.int32)),
                                   torch.from_numpy(pb.view(np.int32)),
                                   d).numpy()
    assert got.shape == (hk.ROW_BLOCK, 1) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m,length,alphabet,d", [
    (128, 256, 2, 8, 0), (256, 128, 37, 8, 1), (128, 128, 37, 24, 2),
    (128, 384, 2, 24, 1),
])
def test_within_tile_plain_matches_pallas_wider_alphabets(n, m, length,
                                                          alphabet, d):
    rng = np.random.default_rng(n + m + length + alphabet)
    a = rng.integers(0, alphabet, size=(n, length), dtype=np.uint8)
    b = np.concatenate([a, a, a])[:m].copy()
    b[np.arange(m), rng.integers(0, length, size=m)] = rng.integers(
        0, alphabet, size=m)
    a[-3:] = 0xFF
    want = np.asarray(pallas.within_tile_packed(a, b, alphabet, d))
    got = hk.within_tile_packed(torch.from_numpy(a), torch.from_numpy(b),
                                alphabet, d).numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_bounds_count_bytes_and_operations():
    """chip_smoke's bound functions at the main path's shapes: every
    input and output byte once; one int8 multiply-add per pair, position
    and alphabet symbol."""
    import chip_smoke

    buckets = chip_smoke.pairs_within_cost(2048, 128, 128, 64, 50, 5, True)
    assert buckets["bytes"] == 20_971_520
    assert buckets["ops"] == 2 * 2048 * 128 * 128 * 50 * 5 == 16_777_216_000
    bound = chip_smoke.kernel_bound(buckets)
    assert bound["bound_by"] == "operations"
    assert bound["bound_ms"] == pytest.approx(16_777_216_000 / 1979e12 * 1e3)
    tile = chip_smoke.pairs_within_cost(1, 2048, 2048, 112, 100, 5, False)
    assert tile["bytes"] == 983_040 and tile["ops"] == 4_194_304_000
    rowwise = chip_smoke.kernel_bound(chip_smoke.rowwise_cost(1 << 21, 13))
    assert rowwise["bytes"] == 220_200_960
    assert rowwise["bound_by"] == "bytes"
    assert rowwise["bound_ms"] == pytest.approx(220_200_960 / 3.35e12 * 1e3)
    lengths = np.array([100, 100, 100, 0], dtype=np.int32)
    others = np.array([100, 101, 103, 1], dtype=np.int32)
    banded = chip_smoke.banded_cost(lengths, others, 1, 112, True)
    assert banded["bytes"] == 4 * (2 * 112 + 8 + 1 + 8)
    assert banded["ops"] == 4 * (100 + 100 + 0) * 3  # the gap of 3 stops


def test_pack_bits_little_order():
    within = torch.zeros((1, 16), dtype=torch.bool)
    within[0, [0, 3, 8, 15]] = True
    assert hk.pack_bits(within).tolist() == [[0b1001, 0b10000001]]


def test_wrapper_refuses_non_cuda_device():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    any other device is refused, never routed to the plain version."""
    a = torch.empty((128, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hk.within_tile_packed(a, a, 5, 1)
    r = torch.empty((8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hk.rowwise_within_packed(r, r, 1)


def test_smoke_generator_keeps_the_bench_input(tmp_path):
    """``chip_smoke.generate_fastq`` with its options at their defaults
    writes ``bench.generate_fastq``'s bytes (the pinned sha256 values
    rest on that), also when it writes the mate and UMI files in the same
    pass; those two hold one record per read under the same names, and
    ``lowq_rate`` redraws whole reads' qualities in Q2-Q10."""
    import gzip

    import bench
    import chip_smoke

    def read(name):
        with gzip.open(tmp_path / name, "rb") as f:
            return f.read()

    n = 300_000  # more than one block of 250,000, so the streams run on
    bench.generate_fastq(str(tmp_path / "bench.gz"), n, 100, 12)
    chip_smoke.generate_fastq(
        str(tmp_path / "smoke.gz"), n, 100, 12,
        mate_path=str(tmp_path / "mate.gz"),
        umi_path=str(tmp_path / "umi.gz"))
    want = read("bench.gz")
    assert read("smoke.gz") == want
    names = want.split(b"\n")[0::4][:-1]
    for other, width in (("mate.gz", 100), ("umi.gz", 12)):
        lines = read(other).split(b"\n")
        assert lines[0::4][:-1] == names
        assert {len(seq) for seq in lines[1::4]} == {width}
        assert set(b"".join(lines[1::4][:1000])) <= set(b"ACGT")
    chip_smoke.generate_fastq(str(tmp_path / "lowq.gz"), 20_000, 100, 12,
                              lowq_rate=0.05)
    quals = read("lowq.gz").split(b"\n")[3::4]
    low = [q for q in quals if max(q) <= 33 + 10]
    assert 0.03 < len(low) / len(quals) < 0.07
    assert all(min(q) >= 33 + 2 for q in low)
    assert all(min(q) >= 33 + 30 for q in quals if max(q) > 33 + 10)
