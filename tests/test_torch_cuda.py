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

from fastqdedup_tpu_torch.ops import edit_kernels as ek
from fastqdedup_tpu_torch.ops import hamming_kernels as hk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _bucket_batch(rng, buckets, size, length, alphabet=5, l_pad=0):
    """[K, S, Lp] near-duplicate buckets with 0xFF pad rows and columns;
    every third bucket from the second on is pad rows only."""
    l_pad = l_pad or hk._pad_dims(length, alphabet)[0]
    rows = np.repeat(rng.integers(0, alphabet, (buckets, 1, length),
                                  dtype=np.uint8), size, axis=1)
    kk, ss = np.indices((buckets, size))
    sel = rng.random((buckets, size)) < 0.6
    rows[kk[sel], ss[sel], rng.integers(0, length, int(sel.sum()))] = \
        rng.integers(0, alphabet, int(sel.sum()), dtype=np.uint8)
    batch = np.full((buckets, size, l_pad), 0xFF, dtype=np.uint8)
    batch[:, :, :length] = rows
    fill = rng.integers(2, size + 1, buckets)
    fill[1::3] = 0
    batch[np.arange(size)[None, :] >= fill[:, None]] = 0xFF
    return torch.from_numpy(batch)


# Both routes of the all-pairs kernel (tensor cores up to alphabet_pad 8,
# SIMT above) at their edges: widths that fill neither a 16-symbol group
# nor a 4-symbol word, length <= d, Lp 16 and above 256, Lp beyond the
# padded width, one bucket and odd bucket counts, d = 0 to 2.
@pytest.mark.parametrize("buckets,size,length,d,alphabet,l_pad", [
    (64, 128, 50, 1, 5, 0), (4, 512, 50, 1, 5, 0), (2, 2048, 100, 2, 5, 0),
    (8, 128, 17, 0, 5, 0), (4, 128, 2, 2, 5, 0), (1, 128, 16, 0, 5, 16),
    (67, 128, 37, 1, 5, 0), (3, 256, 300, 2, 5, 0), (5, 128, 37, 2, 5, 256),
    (7, 128, 50, 1, 8, 0), (3, 512, 100, 0, 8, 0), (1, 128, 2, 2, 8, 0),
    (7, 128, 50, 1, 12, 0), (3, 256, 37, 0, 24, 0), (2, 128, 300, 2, 24, 0),
    (4, 128, 2, 2, 24, 0),
])
def test_bucket_kernel_matches_plain(cuda_device, buckets, size, length,
                                     d, alphabet, l_pad):
    batch = _bucket_batch(np.random.default_rng(size + d), buckets, size,
                          length, alphabet, l_pad)
    _, a_pad = hk._pad_dims(length, alphabet)
    want = hk.pairs_within_plain(batch, batch, length, d, a_pad)
    before = hk.LAUNCHES["bucket_within_packed"]
    got = hk.bucket_within_packed(batch.to(cuda_device), length, d, a_pad)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.count_nonzero()) < want.numel() or length <= d
    assert hk.LAUNCHES["bucket_within_packed"] == before + 1


@pytest.mark.parametrize("n,m,length,d,alphabet", [
    (256, 128, 100, 1, 5), (128, 384, 37, 2, 5), (2048, 2048, 100, 0, 5),
    (2048, 128, 100, 1, 5), (128, 128, 16, 0, 5), (128, 256, 300, 2, 8),
    (384, 128, 50, 1, 8), (128, 384, 2, 2, 5), (256, 128, 50, 1, 12),
    (128, 256, 37, 2, 24),
])
def test_tile_kernel_matches_plain(cuda_device, n, m, length, d, alphabet):
    rng = np.random.default_rng(length + d)
    a = torch.from_numpy(rng.integers(0, alphabet, (n, length),
                                      dtype=np.uint8))
    b = a.repeat(-(-m // n), 1)[:m].clone()
    b[:, min(3, length - 1)] = 0
    a[-5:] = 0xFF
    want = hk.within_tile_packed(a, b, alphabet, d)
    before = hk.LAUNCHES["within_tile_packed"]
    got = hk.within_tile_packed(a.to(cuda_device), b.to(cuda_device),
                                alphabet, d)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert hk.LAUNCHES["within_tile_packed"] == before + 1


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


@pytest.mark.parametrize("n,m,l_pad", [
    (100, 128, 16), (128, 96, 16), (64, 128, 16), (128, 128, 24),
])
def test_kernel_refuses_shapes_it_does_not_take(cuda_device, n, m, l_pad):
    """Rows and columns in multiples of 128, widths in multiples of 16."""
    a = torch.zeros((1, n, l_pad), dtype=torch.uint8, device=cuda_device)
    b = torch.zeros((1, m, l_pad), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="multiples"):
        hk._pairs_within_launch("within_tile_packed", a, b, l_pad, 1, 5)


def test_kernel_refuses_rows_off_16_bytes(cuda_device):
    a = torch.zeros((128 * 16 + 4,), dtype=torch.uint8,
                    device=cuda_device)[4:].reshape(1, 128, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hk._pairs_within_launch("bucket_within_packed", a, a, 16, 1, 5)


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


def _edit_rows(rng, p, length, d):
    """uint8 [P, Lp] pairs of reads and copies with substitutions and
    indels (lengths length-1..length+1, some |la - lb| > d, some empty),
    random pad bytes past each length."""
    l_pad = -(-(length + 1) // 16) * 16
    a = rng.integers(0, 256, (p, l_pad), dtype=np.uint8)
    b = rng.integers(0, 256, (p, l_pad), dtype=np.uint8)
    a[:, :length + 1] = rng.integers(0, 5, (p, length + 1), dtype=np.uint8)
    b[:, :length + 1] = a[:, :length + 1]
    shift = rng.random(p) < 0.3  # b is a shifted by one: an indel
    b[shift, 1:length + 1] = a[shift, :length]
    for _ in range(d + 1):
        sel = rng.random(p) < 0.4
        b[sel, rng.integers(0, length + 1, int(sel.sum()))] = rng.integers(
            0, 5, int(sel.sum()), dtype=np.uint8)
    la = rng.integers(length - 1, length + 2, p).astype(np.int32)
    lb = (la + rng.integers(-d - 2, d + 3, p)).clip(0, l_pad).astype(
        np.int32)
    la[::97] = 0
    lb[::89] = 0
    return (torch.from_numpy(a), torch.from_numpy(la), torch.from_numpy(b),
            torch.from_numpy(lb))


@pytest.mark.parametrize("d", [0, 1, 2, 3, 4, 6])
def test_edit_kernel_matches_plain(cuda_device, d):
    """Small and large d through the one kernel."""
    a, la, b, lb = _edit_rows(np.random.default_rng(60 + d), 20_000, 100, d)
    want = ek.banded_within_edit_distance(a, la, b, lb, d)
    before = ek.LAUNCHES["banded_within_edit_distance"]
    got = ek.banded_within_edit_distance(
        a.to(cuda_device), la.to(cuda_device), b.to(cuda_device),
        lb.to(cuda_device), d)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < len(want)
    assert ek.LAUNCHES["banded_within_edit_distance"] == before + 1


def _on_card_equals_plain(cuda_device, a, la, b, lb, d):
    want = ek.banded_within_plain(a, la, b, lb, d)
    got = ek.banded_within_edit_distance(
        a.to(cuda_device), la.to(cuda_device), b.to(cuda_device),
        lb.to(cuda_device), d)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    return want


@pytest.mark.parametrize("d", [0, 1, 2, 3, 6])
def test_edit_kernel_at_word_edges(cuda_device, d):
    """la and lb at the edges of the 4- and 16-symbol words a match scan
    reads; per length pair equal strings, the only difference in the last
    symbol, the only difference in the bytes past the lengths, and one
    base deleted near the start."""
    rng = np.random.default_rng(300 + d)
    rows = []
    for la in (7, 8, 9, 15, 16, 17, 63, 64, 65, 111, 112):
        for lb in range(max(la - d, 1), min(la + d, 112) + 1):
            for case in range(4):
                x = rng.integers(0, 4, 112, dtype=np.uint8)
                y = x.copy()
                if case == 1:
                    y[min(la, lb) - 1] ^= 1
                elif case == 2:
                    x[la:] = 0xFF
                    y[lb:] = 0xEE
                elif case == 3:
                    y[2:-1] = x[3:]
                rows.append((x, la, y, lb))
    a = torch.from_numpy(np.stack([r[0] for r in rows]))
    b = torch.from_numpy(np.stack([r[2] for r in rows]))
    la = torch.tensor([r[1] for r in rows], dtype=torch.int32)
    lb = torch.tensor([r[3] for r in rows], dtype=torch.int32)
    want = _on_card_equals_plain(cuda_device, a, la, b, lb, d)
    assert 0 < int(want.sum()) < len(want)


def _rows_of_width(rng, p, width, d):
    """uint8 [P, width] pairs of any width: b is a with substitutions,
    half of them shifted by one base, a quarter unrelated; lengths
    anywhere in [0, width], a third at the full width."""
    a = rng.integers(0, 3, (p, width), dtype=np.uint8)
    b = a.copy()
    shift = rng.random(p) < 0.5
    b[shift, 1:] = a[shift, :-1]
    for _ in range(d + 1):
        sel = np.flatnonzero(rng.random(p) < 0.4)
        b[sel, rng.integers(0, width, len(sel))] = rng.integers(
            0, 3, len(sel), dtype=np.uint8)
    far = rng.random(p) < 0.25
    b[far] = rng.integers(0, 3, (int(far.sum()), width), dtype=np.uint8)
    la = rng.integers(0, width + 1, p)
    la[rng.random(p) < 0.33] = width
    lb = (la + rng.integers(-d - 1, d + 2, p)).clip(0, width)
    return (torch.from_numpy(a), torch.from_numpy(la.astype(np.int32)),
            torch.from_numpy(b), torch.from_numpy(lb.astype(np.int32)))


# Widths off the 16-byte and the 4-byte grid (byte staging), rows wider
# than one round of the warp's copies, d at and above the width (no DP),
# P = 1 and P off the block's 128 pairs, and widths whose rows leave a
# block one warp (2000) and a warp 16 pairs (4000) of shared memory.
@pytest.mark.parametrize("p,width,d", [
    (1, 112, 1), (129, 112, 2), (4099, 100, 1), (1000, 1, 0), (1000, 1, 1),
    (1000, 30, 1), (1000, 30, 3), (1000, 30, 30), (1000, 30, 45),
    (1000, 100, 6), (500, 300, 2), (300, 300, 6), (37, 2000, 3),
    (40, 4000, 2),
])
def test_edit_kernel_any_width_and_count(cuda_device, p, width, d):
    a, la, b, lb = _rows_of_width(np.random.default_rng(p + width + d), p,
                                  width, d)
    _on_card_equals_plain(cuda_device, a, la, b, lb, d)


def test_edit_kernel_refuses_rows_off_4_bytes(cuda_device):
    """The wrapper refuses a base off 4 bytes; a width off 4 bytes with an
    aligned base is taken (byte staging, the cases above)."""
    a, la, b, lb = _rows_of_width(np.random.default_rng(5), 400, 30, 1)
    flat = torch.zeros(400 * 30 + 2, dtype=torch.uint8, device=cuda_device)
    off = flat[2:].view(400, 30)
    off.copy_(a)
    with pytest.raises(ValueError, match="4-byte aligned"):
        ek.banded_within_edit_distance(off, la.to(cuda_device),
                                       b.to(cuda_device),
                                       lb.to(cuda_device), 1)


def test_edit_kernel_refuses_rows_beyond_shared_memory(cuda_device):
    """One pair of 120,000-symbol rows outgrows a block's shared memory:
    the launch is refused, not answered by another route."""
    a = torch.zeros((1, 120_000), dtype=torch.uint8, device=cuda_device)
    la = torch.full((1,), 120_000, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ek.banded_within_edit_distance(a, la, a.clone(), la.clone(), 1)
    # The same rows at d >= L need no DP and no shared memory.
    got = ek.banded_within_edit_distance(a, la, a.clone(), la.clone(),
                                         120_000)
    torch.cuda.synchronize()
    assert bool(got.all())


@pytest.mark.parametrize("d", [0, 1, 2])
@pytest.mark.parametrize("pairs", ["same", "repeated"])
def test_edit_kernel_indexed_equal_and_repeated_indices(cuda_device, pairs,
                                                        d):
    keys, lens, _, _ = _rows_of_width(np.random.default_rng(80 + d), 600,
                                      30, 1)
    rng = np.random.default_rng(d)
    if pairs == "same":
        ci = cj = torch.arange(600, dtype=torch.int32)
    else:
        ci = torch.from_numpy(rng.integers(0, 7, 5000).astype(np.int32))
        cj = torch.from_numpy(rng.integers(0, 600, 5000).astype(np.int32))
    want = ek.banded_within_plain(keys[ci.long()], lens[ci.long()],
                                  keys[cj.long()], lens[cj.long()], d)
    got = ek.banded_within_edit_distance_indexed(
        keys.to(cuda_device), lens.to(cuda_device), ci.to(cuda_device),
        cj.to(cuda_device), d)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if pairs == "same":
        assert bool(want.all())


@pytest.mark.parametrize("d", [1, 5])
def test_edit_kernel_indexed_matches_gathered_plain(cuda_device, d):
    a, la, _, _ = _edit_rows(np.random.default_rng(70 + d), 5_000, 30, d)
    rng = np.random.default_rng(d)
    ci = torch.from_numpy(rng.integers(0, 5_000, 50_000).astype(np.int32))
    cj = (ci + torch.from_numpy(rng.integers(0, 3, 50_000).astype(
        np.int32))) % 5_000
    want = ek.banded_within_plain(a[ci.long()], la[ci.long()],
                                  a[cj.long()], la[cj.long()], d)
    got = ek.banded_within_edit_distance_indexed(
        a.to(cuda_device), la.to(cuda_device), ci.to(cuda_device),
        cj.to(cuda_device), d)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_edit_pipeline_on_card_matches_cpu(cuda_device, tmp_path,
                                           monkeypatch):
    """``--edit`` above HOST_LIMIT keys: the run on the card launches the
    edit kernel (resident key matrix) and writes the CPU run's bytes."""
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    rng = random.Random(9)
    molecules = ["".join(rng.choice("ACGT") for _ in range(40))
                 for _ in range(400)]
    records = []
    for i in range(2000):
        seq = list(rng.choice(molecules))
        pos = rng.randrange(40)
        op = rng.random()
        if op < 0.2:
            del seq[pos]
        elif op < 0.4:
            seq.insert(pos, rng.choice("ACGT"))
        elif op < 0.6:
            seq[pos] = rng.choice("ACGT")
        records.append(f"@r{i}\n{''.join(seq)}\n+\n{'I' * len(seq)}\n")
    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wt") as f:
        f.write("".join(records))
    outs = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", dev)
        before = ek.LAUNCHES["banded_within_edit_distance"]
        out = tmp_path / f"{dev}.fastq.gz"
        deduplicate_cluster([str(src)], [str(out)], None,
                            use_edit_distance=True)
        launched = ek.LAUNCHES["banded_within_edit_distance"] - before
        assert (launched > 0) == (dev == "cuda")
        with gzip.open(out, "rb") as f:
            outs[dev] = f.read()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]


def test_edit_contains_within_on_card_launches_kernel(cuda_device,
                                                      monkeypatch):
    """Edit-mode membership above HOST_LIMIT keys: the card answers
    through the banded kernel, with the CPU device's answers."""
    from fastqdedup_tpu_torch.engine import HOST_LIMIT, contains_within

    rng = random.Random(12)
    keys = sorted({"".join(rng.choice("ACGT") for _ in range(
        rng.randint(28, 32))).encode() for _ in range(HOST_LIMIT + 300)})
    queries = [k[:5] + k[6:] for k in keys[:40]]
    queries += [k[:7] + b"T" + k[7:] for k in keys[40:80]]
    queries += ["".join(rng.choice("ACGT") for _ in range(30)).encode()
                for _ in range(40)]
    answers = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", dev)
        before = ek.LAUNCHES["banded_within_edit_distance"]
        answers[dev] = [contains_within(keys, q, 1, True) for q in queries]
        launched = ek.LAUNCHES["banded_within_edit_distance"] - before
        assert (launched > 0) == (dev == "cuda")
    assert answers["cuda"] == answers["cpu"]
    assert 0 < sum(answers["cpu"]) < len(queries)


@pytest.mark.parametrize("d", [0, 1, 2])
def test_packed_verify_on_card_equals_unpacked(cuda_device, d):
    """``edit_verify_indexed(..., packed=True)`` (rows gathered from the
    nibble-packed key matrix and unpacked by torch ops, then the kernel's
    paired entry) equals ``packed=False`` (the kernel's indexed entry) on
    the card, and the plain version."""
    from fastqdedup_tpu_torch.ops.edit import (
        edit_verify_indexed,
        pack_nibble_rows,
    )

    rng = np.random.default_rng(90 + d)
    a, la, _, _ = _edit_rows(rng, 5_000, 30, d)
    keys = a.numpy() % 15
    keys[np.arange(keys.shape[1])[None, :] >= la.numpy()[:, None]] = 0xFF
    ci = rng.integers(0, 5_000, 50_000)
    cj = (ci + rng.integers(0, 3, 50_000)) % 5_000
    lens = la.to(cuda_device)
    before = ek.LAUNCHES["banded_within_edit_distance"]
    got = edit_verify_indexed(
        torch.from_numpy(pack_nibble_rows(keys)).to(cuda_device), lens, ci,
        cj, d, packed=True)
    plain = edit_verify_indexed(torch.from_numpy(keys).to(cuda_device), lens,
                                ci, cj, d)
    assert ek.LAUNCHES["banded_within_edit_distance"] == before + 2
    np.testing.assert_array_equal(got, plain)
    t_keys = torch.from_numpy(keys)
    want = ek.banded_within_plain(t_keys[ci], la[ci], t_keys[cj], la[cj], d)
    np.testing.assert_array_equal(got, want[:, 0].numpy())


def test_warmup_on_card_counts_apart(cuda_device, monkeypatch, capsys):
    """``warmup()`` returns without error on the card, launches every
    kernel, and counts none of it as real work; ``prewarm_async`` gives
    a thread once per geometry whose join raises nothing, and
    ``prewarm_deflate_async`` one a process."""
    from fastqdedup_tpu_torch import warmup
    from fastqdedup_tpu_torch.ops import kernel_lib
    from fastqdedup_tpu_torch.utils import trace

    from fastqdedup_tpu_torch.ops import deflate_kernels as dk

    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cuda")
    before = {**hk.LAUNCHES, **ek.LAUNCHES, **dk.LAUNCHES}
    warmup.warmup(lengths=(100,), edit_distances=(1, 2))
    assert {**hk.LAUNCHES, **ek.LAUNCHES, **dk.LAUNCHES} == before
    assert set(kernel_lib.WARMUP_LAUNCHES) == set(before)
    assert "kernel library load" in capsys.readouterr().err
    monkeypatch.setattr(warmup, "_prewarmed_geometries", set())
    for edit in (False, True):
        trace.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            thread = warmup.prewarm_async(100, 5, 1, edit)
            thread.join(timeout=120)
        assert not thread.is_alive()
        assert [s.name for s in trace.spans()
                if s.name.startswith("warmup.")] == [
            "warmup.context", "warmup.library", "warmup.launches"]
        assert warmup.prewarm_async(100, 5, 1, edit) is None
    assert {**hk.LAUNCHES, **ek.LAUNCHES, **dk.LAUNCHES} == before
    # The card writer's thread: one deflate launch, counted as warm-up.
    monkeypatch.setattr(warmup, "_deflate_prewarmed", False)
    warm = kernel_lib.WARMUP_LAUNCHES["deflate_members"]
    warmup.prewarm_deflate_async().join(timeout=120)
    assert kernel_lib.WARMUP_LAUNCHES["deflate_members"] == warm + 1
    assert warmup.prewarm_deflate_async() is None
    assert {**hk.LAUNCHES, **ek.LAUNCHES, **dk.LAUNCHES} == before


# --------------------------------------------------------------------- #
# Pass 2's asynchronous transfers (ops/transfer.py)

_BOTH_ROUTES = {"FASTQDEDUP_DISPATCH_S": "1e-9",
                "FASTQDEDUP_H2D_RATE": "1e15",
                "FASTQDEDUP_HOST_RATE": "1.0"}


# The indexed entry's instances: 2 lanes (one 8-byte load a row) and each
# group size at run-time width (1; 3 in groups of 4; 5, 8, 13 and 16 in
# groups of 8; 19, 27 and 32 in groups of 32), and 40, past one lane a
# thread.
INDEXED_LANES = [1, 2, 3, 5, 8, 13, 16, 19, 27, 32, 40]


@pytest.mark.parametrize("lanes", INDEXED_LANES)
@pytest.mark.parametrize("p", [1, 31, 33, 255, 257, 70_001])
def test_rowwise_indexed_entry_matches_plain(cuda_device, p, lanes):
    """The pair-list route's indexed entry against ``index_select`` +
    ``rowwise_within_plain``: P on and off a warp's span of 32 pairs and
    a block of 128, every instance's width, neighbours, random and
    repeated indices, rows 0 and n - 1, self pairs, d = 0 to 3; one
    launch a call, counted under ``rowwise_within_packed``."""
    import chip_smoke

    rng = np.random.default_rng(p + lanes)
    packed, gi, gj = chip_smoke.rowwise_indexed_batch(rng, p, 3000, lanes)
    edges = [(0, 2999), (2999, 0), (0, 0), (2999, 2999), (17, 17)]
    for k, (i, j) in enumerate(edges[:p]):
        gi[-1 - k], gj[-1 - k] = i, j
    for d in range(4):
        want = hk.rowwise_within_plain(packed.index_select(0, gi),
                                       packed.index_select(0, gj), d)
        before = hk.LAUNCHES["rowwise_within_packed"]
        got = hk.rowwise_within_packed_indexed(
            packed.to(cuda_device), gi.to(cuda_device), gj.to(cuda_device), d)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert hk.LAUNCHES["rowwise_within_packed"] == before + 1


@pytest.mark.parametrize("p", [(1 << 19) - 1, (1 << 21) + 5])
def test_rowwise_indexed_entry_13_lanes_large_batches(cuda_device, p):
    """13 lanes (groups of 8 threads) at batches of 2^19 and 2^21 pairs
    and off every span, against the plain version."""
    import chip_smoke

    packed, gi, gj = (t.to(cuda_device) for t in
                      chip_smoke.rowwise_indexed_batch(
                          np.random.default_rng(p), p, 400_000, 13))
    for d in (0, 1, 3):
        want = hk.rowwise_within_plain(packed.index_select(0, gi),
                                       packed.index_select(0, gj), d)
        got = hk.rowwise_within_packed_indexed(packed, gi, gj, d)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("lanes,size,buckets", [
    (13, 6, 5581), (2, 52, 260), (27, 5, 300), (5, 17, 40), (2, 3, 11)])
def test_rowwise_indexed_entry_on_bucket_ordered_pairs(cuda_device, lanes,
                                                       size, buckets):
    """Pairs as the route emits them (every triu pair of each bucket,
    bucket after bucket: ``chip_smoke.rowwise_bucket_batch``), at
    dense's and umi12's largest batches and smaller ones, d = 0 to 2."""
    import chip_smoke

    n = 4 * size * buckets
    packed, gi, gj = (t.to(cuda_device) for t in
                      chip_smoke.rowwise_bucket_batch(
                          np.random.default_rng(size), n, lanes, size,
                          buckets))
    for d in range(3):
        want = hk.rowwise_within_plain(packed.index_select(0, gi),
                                       packed.index_select(0, gj), d)
        got = hk.rowwise_within_packed_indexed(packed, gi, gj, d)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("lanes", [2, 5, 13, 27])
@pytest.mark.parametrize("p", [4099, 70_002])
def test_rowwise_indexed_entry_on_the_routes_index_layout(cuda_device, p,
                                                          lanes):
    """gi and gj as the two rows of one int32 [2, P] tensor, as the route
    uploads them, with P off a multiple of 4 (gj starts 8 bytes past a
    16-byte boundary), on bucket-ordered pairs."""
    import chip_smoke

    rng = np.random.default_rng(p + lanes)
    packed, gi, gj = chip_smoke.rowwise_bucket_batch(rng, 4 * p, lanes, 3,
                                                     p // 3)
    pairs = torch.stack([gi, gj]).to(cuda_device)
    assert pairs[1].data_ptr() % 16 != 0
    packed = packed.to(cuda_device)
    for d in range(3):
        want = hk.rowwise_within_plain(packed.index_select(0, pairs[0]),
                                       packed.index_select(0, pairs[1]), d)
        got = hk.rowwise_within_packed_indexed(packed, pairs[0], pairs[1], d)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_rowwise_indexed_entry_two_lanes_off_eight_bytes(cuda_device):
    """Rows of 2 lanes whose matrix starts 4 bytes past an 8-byte
    boundary: the launcher gives them the instance that reads one lane at
    a time, with the same answers."""
    import chip_smoke

    rng = np.random.default_rng(8)
    packed, gi, gj = chip_smoke.rowwise_indexed_batch(rng, 4099, 900, 2)
    flat = torch.empty(2 * 900 + 1, dtype=torch.int32, device=cuda_device)
    flat[1:] = packed.to(cuda_device).reshape(-1)
    shifted = flat[1:].view(900, 2)
    assert shifted.data_ptr() % 8 == 4
    gi, gj = gi.to(cuda_device), gj.to(cuda_device)
    for d in range(3):
        want = hk.rowwise_within_plain(shifted.index_select(0, gi),
                                       shifted.index_select(0, gj), d)
        got = hk.rowwise_within_packed_indexed(shifted, gi, gj, d)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_delayed_uploads_read_no_bucket_or_pair_list_result_early(
        cuda_device, monkeypatch):
    """Every upload of the bucket and pair-list routes queued behind about
    10 ms of spinning while the host runs ahead, several bucket batches in
    flight: the card's pairs equal the CPU device's exactly."""
    import chip_smoke
    from fastqdedup_tpu_torch.ops import bucket

    for key, value in _BOTH_ROUTES.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(bucket, "_buckets_per_call", lambda s: 2)
    matrix = chip_smoke.delayed_matrix(np.random.default_rng(5))
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")
    want = bucket.hamming_neighbor_pairs_bucketed(matrix, 5, 1)
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cuda")
    before = dict(hk.LAUNCHES)
    undo = chip_smoke.delayed(bucket, "upload")
    try:
        got = bucket.hamming_neighbor_pairs_bucketed(matrix, 5, 1)
    finally:
        undo()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for name in ("bucket_within_packed", "rowwise_within_packed"):
        assert hk.LAUNCHES[name] - before[name] >= 2


def test_delayed_uploads_read_no_edit_answer_early(cuda_device):
    """Edit verification batches with every index upload delayed: the
    card's answers equal the CPU device's exactly."""
    import chip_smoke
    from fastqdedup_tpu_torch.ops import edit as edit_ops

    rng = np.random.default_rng(6)
    keys, lens, ci, cj = chip_smoke.indexed_edit_batch(rng, 1 << 15,
                                                       torch.device("cpu"))
    want = edit_ops.edit_verify_indexed(keys, lens, ci.numpy(), cj.numpy(), 1)
    keys_dev, lens_dev = keys.to(cuda_device), lens.to(cuda_device)
    undo = chip_smoke.delayed(edit_ops, "upload")
    try:
        got = [edit_ops.edit_verify_indexed(
            keys_dev, lens_dev, ci.numpy()[s:s + 4096],
            cj.numpy()[s:s + 4096], 1) for s in range(0, 1 << 15, 4096)]
    finally:
        undo()
    np.testing.assert_array_equal(np.concatenate(got), want)


def test_bucket_and_edit_routes_make_no_synchronizing_call(cuda_device,
                                                           monkeypatch):
    """Under ``torch.cuda.set_sync_debug_mode("warn")`` the bucket route,
    the pair-list route and edit verification make no synchronizing call
    in ops/bucket.py or ops/edit.py: every copy is pinned and
    ``non_blocking``, every result read after its event."""
    import chip_smoke
    from fastqdedup_tpu_torch.ops import bucket
    from fastqdedup_tpu_torch.ops import edit as edit_ops

    for key, value in _BOTH_ROUTES.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cuda")
    matrix = chip_smoke.delayed_matrix(np.random.default_rng(7))
    keys, lens, ci, cj = chip_smoke.indexed_edit_batch(
        np.random.default_rng(8), 1 << 14, cuda_device)

    def run():
        bucket.hamming_neighbor_pairs_bucketed(matrix, 5, 1)
        edit_ops.edit_verify_indexed(keys, lens, ci.cpu().numpy(),
                                     cj.cpu().numpy(), 1)

    sites = chip_smoke.sync_sites(run)
    assert not [site for site in sites
                if site.startswith(("ops/bucket.py", "ops/edit.py"))], sites


def _edit_entries(seed):
    """The edit route's input (``engine._edit_edges_entries``): keys of
    300 molecules of 40 bases, each beside a copy with one base deleted
    and one with a base inserted, grouped by length; and the key count."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    mol = bases[rng.integers(0, 4, (300, 40))]
    keys = {row.tobytes() for row in mol}
    for row in mol:
        pos = int(rng.integers(0, 40))
        keys.add(row[:pos].tobytes() + row[pos + 1:].tobytes())
        keys.add(row[:pos].tobytes() + b"A" + row[pos:].tobytes())
    keys = sorted(keys, key=lambda k: (len(k), k))
    lengths = np.array([len(k) for k in keys])
    entries = []
    for length in np.unique(lengths):
        idx = np.flatnonzero(lengths == length).astype(np.int64)
        entries.append((int(length), np.frombuffer(
            b"".join(keys[i] for i in idx), dtype=np.uint8).reshape(
                len(idx), length), idx))
    return entries, len(keys)


def test_edit_key_upload_matches_cpu(cuda_device, monkeypatch):
    """The edit route's key matrix, sent from the engine's thread while
    candidates are generated, gives the CPU device's edges."""
    from fastqdedup_tpu_torch import engine

    entries, n = _edit_entries(9)
    edges = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", dev)
        edges[dev] = engine._edit_edges_entries(entries, n, 1)
    for got, want in zip(edges["cuda"], edges["cpu"]):
        np.testing.assert_array_equal(got, want)
    assert len(edges["cpu"][0]) > 300


def test_edit_key_upload_wait_is_one_span_a_call(cuda_device, monkeypatch):
    """On the card each call of the edit route waits for its key matrix
    once, inside its verification: one ``pairs.key_upload_wait`` span a
    call, under ``pairs.edit_verify``."""
    from torch.profiler import ProfilerActivity, profile

    from fastqdedup_tpu_torch import engine
    from fastqdedup_tpu_torch.utils import trace

    entries, n = _edit_entries(10)
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cuda")
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                assert len(engine._edit_edges_entries(entries, n, 1)[0])
        spans = trace.spans()
    finally:
        trace.clear()
    by_id = {s.id: s for s in spans}
    waits = [s for s in spans if s.name == "pairs.key_upload_wait"]
    assert len(waits) == 2
    assert all(by_id[s.parent].name == "pairs.edit_verify" for s in waits)


# The deflate kernel (csrc/deflate.cu) and the card writer


def _deflate_inputs():
    """name -> bytes of one window: FASTQ, edge sizes, stored blocks."""
    rng = np.random.default_rng(21)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def fastq(n, seed):
        r = np.random.default_rng(seed)
        return b"".join(
            b"@read%09d\n%s\n+\n%s\n" % (
                i, bytes(r.choice(bases, 100)),
                bytes(33 + r.integers(30, 41, 100, dtype=np.uint8)))
            for i in range(n))

    reads = fastq(6000, 1)
    return {
        "one_byte": b"x",
        "three_bytes": b"abc",
        "one_member": reads[:65280],
        "one_member_and_one_byte": reads[:65281],
        "members_and_a_tail": reads[:3 * 65280 + 12345],
        "full_window": (reads * 7)[:128 * 65280],
        "random": rng.integers(0, 256, 2 * 65280 + 7,
                               dtype=np.uint8).tobytes(),
        "zeros": bytes(65280 + 300),
        "skewed": rng.geometric(0.3, 130000).clip(0, 255)
        .astype(np.uint8).tobytes(),
        "pattern": b"ACGTTGCA" * 9000,
        "mutated_repeats": _mutated_repeats(rng),
    }


def _mutated_repeats(rng):
    """A 257-byte unit repeated over two members with 1 byte in 50
    changed: long matches that end at random places."""
    data = np.resize(rng.integers(0, 256, 257, dtype=np.uint8),
                     2 * 65280 - 11)
    hit = rng.integers(0, len(data), len(data) // 50)
    data[hit] = rng.integers(0, 256, len(hit), dtype=np.uint8)
    return data.tobytes()


@pytest.mark.parametrize("name", sorted(_deflate_inputs()))
def test_deflate_kernel_matches_plain(cuda_device, name):
    from fastqdedup_tpu_torch.ops import deflate_kernels as dk

    data = _deflate_inputs()[name]
    members = dk.members_of(len(data))
    host = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    want_out = torch.zeros(members * dk.OUT_STRIDE, dtype=torch.uint8)
    want_len = torch.zeros(members, dtype=torch.int32)
    dk.deflate_members(host, len(data), want_out, want_len, None)
    out = torch.zeros(members * dk.OUT_STRIDE, dtype=torch.uint8,
                      device=cuda_device)
    lens = torch.zeros(members, dtype=torch.int32, device=cuda_device)
    scratch = torch.empty(dk.scratch_bytes(members), dtype=torch.uint8,
                          device=cuda_device)
    before = dk.LAUNCHES["deflate_members"]
    dk.deflate_members(host.to(cuda_device), len(data), out, lens, scratch)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["deflate_members"] == before + 1
    assert torch.equal(lens.cpu(), want_len)
    got, want = out.cpu().numpy(), want_out.numpy()
    blob = b""
    for i, n in enumerate(want_len.tolist()):
        member = got[i * dk.OUT_STRIDE:i * dk.OUT_STRIDE + n]
        assert np.array_equal(member,
                              want[i * dk.OUT_STRIDE:i * dk.OUT_STRIDE + n])
        blob += member.tobytes()
    assert gzip.decompress(blob) == data


def _pipeline_on_card(tmp_path, name, tag):
    """One run of chip_smoke's pinned input ``name`` on the card: the
    output file's bytes, the deflate launches."""
    import chip_smoke

    from fastqdedup_tpu_torch import dissect
    from fastqdedup_tpu_torch.ops import deflate_kernels as dk
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    files, check, d, method, edit = chip_smoke.INPUTS[name]
    paths = chip_smoke.generate_files(str(tmp_path), files)
    out = str(tmp_path / f"{name}-{tag}.fastq.gz")
    before = dk.LAUNCHES["deflate_members"]
    deduplicate_cluster([paths[f] for f in files], [out], None,
                        max_distance=d, use_edit_distance=edit,
                        cluster_dissection_func=getattr(
                            dissect, f"cluster_dissection_{method}"))
    torch.cuda.synchronize()
    with open(out, "rb") as f:
        return f.read(), dk.LAUNCHES["deflate_members"] - before


@pytest.mark.parametrize("name", ["small", "default", "edit"])
def test_pipeline_on_card_deflates_there_and_keeps_its_pin(
        cuda_device, monkeypatch, tmp_path, name):
    """The card writes the pinned records (decompressed sha256), deflated
    by the kernel, the same file twice, at most 3% over the host
    writer's size."""
    import hashlib

    import chip_smoke

    from fastqdedup_tpu_torch.io.bgzf import ParallelBgzfWriter

    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cuda")
    first, launched = _pipeline_on_card(tmp_path, name, "a")
    second, _ = _pipeline_on_card(tmp_path, name, "b")
    records = gzip.decompress(first)
    assert hashlib.sha256(records).hexdigest() == \
        chip_smoke.EXPECTED_SHA256[name]
    assert launched >= 1
    assert second == first
    host = tmp_path / "host.fastq.gz"
    with ParallelBgzfWriter(str(host)) as writer:
        writer.write(records)
    assert len(first) <= 1.03 * host.stat().st_size
