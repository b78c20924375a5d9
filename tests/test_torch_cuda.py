"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither jax nor the JAX package, so it runs where only torch is
installed; tests/conftest.py imports jax, so on such a machine run it
with ``python -m pytest --noconftest tests/test_torch_cuda.py``.  All
outputs are bits or bytes: exact equality throughout.
"""

import gzip
import random

import numpy as np
import pytest
import torch

from fastqdedup_tpu_torch.ops import hamming_kernels as hk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _bucket_batch(rng, buckets, size, length):
    """[K, S, Lp] near-duplicate buckets with 0xFF pad rows and columns."""
    l_pad, _ = hk._pad_dims(length, 5)
    rows = np.repeat(rng.integers(0, 5, (buckets, 1, length),
                                  dtype=np.uint8), size, axis=1)
    kk, ss = np.indices((buckets, size))
    sel = rng.random((buckets, size)) < 0.6
    rows[kk[sel], ss[sel], rng.integers(0, length, int(sel.sum()))] = \
        rng.integers(0, 5, int(sel.sum()), dtype=np.uint8)
    batch = np.full((buckets, size, l_pad), 0xFF, dtype=np.uint8)
    batch[:, :, :length] = rows
    fill = rng.integers(2, size + 1, buckets)
    batch[np.arange(size)[None, :] >= fill[:, None]] = 0xFF
    return torch.from_numpy(batch)


@pytest.mark.parametrize("buckets,size,length,d", [
    (64, 128, 50, 1), (4, 512, 50, 1), (2, 2048, 100, 2), (8, 128, 17, 0),
    (4, 128, 2, 2),
])
def test_bucket_kernel_matches_plain(cuda_device, buckets, size, length,
                                     d):
    batch = _bucket_batch(np.random.default_rng(size + d), buckets, size,
                          length)
    _, a_pad = hk._pad_dims(length, 5)
    want = hk.pairs_within_plain(batch, batch, length, d, a_pad)
    before = hk.LAUNCHES["bucket_within_packed"]
    got = hk.bucket_within_packed(batch.to(cuda_device), length, d, a_pad)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert hk.LAUNCHES["bucket_within_packed"] == before + 1


@pytest.mark.parametrize("n,m,length,d", [
    (256, 128, 100, 1), (128, 384, 37, 2), (2048, 2048, 100, 0),
])
def test_tile_kernel_matches_plain(cuda_device, n, m, length, d):
    rng = np.random.default_rng(length + d)
    a = torch.from_numpy(rng.integers(0, 5, (n, length), dtype=np.uint8))
    b = a.repeat(-(-m // n), 1)[:m].clone()
    b[:, 3] = 0
    a[-5:] = 0xFF
    want = hk.within_tile_packed(a, b, 5, d)
    got = hk.within_tile_packed(a.to(cuda_device), b.to(cuda_device), 5, d)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("lanes,d", [(13, 1), (13, 0), (7, 2)])
def test_rowwise_kernel_matches_plain(cuda_device, lanes, d):
    rng = np.random.default_rng(lanes + d)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, (100_000, lanes),
                                      dtype=np.int64).astype(np.int32))
    b = a.clone()
    b[::3, lanes // 2] ^= 0x00F00000
    b[::7, 0] ^= 0x1
    want = hk.rowwise_within_packed(a, b, d)
    got = hk.rowwise_within_packed(a.to(cuda_device), b.to(cuda_device), d)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_kernel_refuses_shapes_it_does_not_take(cuda_device):
    a = torch.zeros((100, 16), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="multiples"):
        hk.within_tile_packed(a, a, 5, 1)


def test_pipeline_on_card_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """The tile sweep forced on (FASTQDEDUP_DEVICE_CUTOVER_S=0): the run
    on the card launches the kernel and writes the bytes the CPU device
    (plain versions) writes."""
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    rng = random.Random(3)
    molecules = ["".join(rng.choice("ACGT") for _ in range(40))
                 for _ in range(300)]
    records = []
    for i in range(1200):
        seq = list(rng.choice(molecules))
        if rng.random() < 0.3:
            seq[rng.randrange(40)] = rng.choice("ACGT")
        records.append(f"@r{i}\n{''.join(seq)}\n+\n{'I' * 40}\n")
    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wt") as f:
        f.write("".join(records))
    monkeypatch.setenv("FASTQDEDUP_DEVICE_CUTOVER_S", "0")
    outs = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", dev)
        before = hk.LAUNCHES["within_tile_packed"]
        out = tmp_path / f"{dev}.fastq.gz"
        deduplicate_cluster([str(src)], [str(out)], None)
        launched = hk.LAUNCHES["within_tile_packed"] - before
        assert launched == (1 if dev == "cuda" else 0)
        with gzip.open(out, "rb") as f:
            outs[dev] = f.read()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]
