#!/usr/bin/env python3
"""Kernel benchmark of the PyTorch + CUDA port: each of the four kernels
at the shapes of ``bench_kernels.py`` against the card's bound, and a
sweep of every kernel against host oracles.

    python3 bench_kernels_torch.py            # timing: a JSON line a kernel
    python3 bench_kernels_torch.py --verify   # the oracle sweep

Timing mode needs the card.  After one line naming the device, it prints
per kernel::

    {"kernel": ..., "wall_s": ..., "wall_s_cold": ..., "achieved_top_s":
     ..., "achieved_gb_s": ..., "peak_top_s": ..., "peak_gb_s": ...,
     "pct_speed_of_light": ..., "pairs_per_s": ..., "bound_ms": ..., ...}

``wall_s`` is one launch on the device alone (CUDA-graph replays of 20
launches, inputs L2-warm: ``chip_smoke.graph_ms``); ``wall_s_cold`` is
one launch between two events after a 64 MB buffer was written, so that
the 50 MB L2 holds none of the inputs (median of 20, ``cold_ms``).  The
peaks are an H100's (``chip_smoke.H100_BYTES_PER_S``,
``H100_OPS_PER_S``) and the bound is
``chip_smoke.kernel_bound`` of the bytes and operations counted from the
shapes; ``pct_speed_of_light`` is the bound's share of ``wall_s`` (the
share of the peak of whichever resource bounds the kernel).  The
pair-list kernel is timed through both entries (paired rows, and the
pair-list route's int32 index pairs into a resident matrix), the
indexed entry also on the route's largest batches at 1M reads, triu
pairs bucket after bucket (``chip_smoke.ROUTE_BATCHES``: D, dense's;
U, umi12's).  Then, at
the shapes of ``PERF.md``'s kernel table, one line each for the library
call beside the all-pairs kernel (``chip_smoke.onehot_product``: the JAX
package's one-hot product, ``torch.bmm`` in fp16 for buckets and
``torch._int_mm`` in int8 for the tile, match counts only) and for the
kernel on the same rows, ``wall_s`` and ``wall_s_cold`` as above.

``--verify`` runs the JAX package's sweep (``bench_kernels.py
--verify``: 5 tile, 6 bucket, 3 pair-list and 2 edit geometries), pair
lists in the route's bucket order through the indexed entry (13, 2, 27
and 5 lanes) and the edit kernel at 100 bp with one-base indels at d =
1, 2 and 3,
against numpy all-pairs comparisons and the scalar predicate
``fastqdedup_tpu_torch.distance.within_distance``, and prints ``{"verify":
"ok", "device": ..., "geometries": n}``; a mismatch exits 1 and names the
geometry.  On the card it checks the kernels; with
``FASTQDEDUP_TORCH_DEVICE=cpu`` the wrappers compute their plain
versions, and the sweep holds those to the same oracles (``--reduced``
cuts the batch counts, for the tests).  Without a card, and not asked
for the CPU, the script exits 2.

``BENCH_READ_LEN`` (default 100) sets the read length of timing mode.
"""

import os
import statistics
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

READ_LEN = int(os.environ.get("BENCH_READ_LEN", 100))
FLUSH_BYTES = 64 << 20  # above the H100's 50 MB of L2
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clock


class KernelMismatch(Exception):
    """A kernel (or, on the CPU, its plain version) disagrees with the
    host oracle; the message names the geometry."""


# --------------------------------------------------------------------- #
# --verify: every kernel against host oracles


def _hamming_all_pairs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """int [N, M] exact Hamming distances (host oracle), 256 rows of a
    at a time."""
    out = np.empty((len(a), len(b)), dtype=np.int64)
    for start in range(0, len(a), 256):
        out[start:start + 256] = np.count_nonzero(
            a[start:start + 256, None, :] != b[None, :, :], axis=2)
    return out


def _unpack(packed: torch.Tensor, columns: int) -> np.ndarray:
    return np.unpackbits(packed.cpu().numpy(), axis=-1,
                         bitorder="little")[..., :columns].astype(bool)


def _check(got: np.ndarray, want: np.ndarray, geometry: str) -> None:
    if got.shape != want.shape or not (got == want).all():
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise KernelMismatch(f"{geometry}: {bad} of {want.size} answers "
                             f"differ from the host oracle")


def _edit_rows(rng, n: int, d: int):
    """100 bp pairs as verification meets them after indels: b is a with
    0 to d + 1 substitutions; then each side independently loses or
    gains one base in 40% of rows (lengths 99-101).  Rows padded to 112
    with arbitrary bytes."""
    import chip_smoke

    bases = np.arange(4, dtype=np.uint8)
    a = rng.integers(0, 4, (n, 100), dtype=np.uint8)
    b = a.copy()
    subs = rng.integers(0, d + 2, n)
    for k in range(d + 1):
        rows = np.flatnonzero(subs > k)
        b[rows, rng.integers(0, 100, len(rows))] = rng.integers(
            0, 4, len(rows), dtype=np.uint8)
    a, la = chip_smoke.apply_indels(rng, a, 0.4, bases)
    b, lb = chip_smoke.apply_indels(rng, b, 0.4, bases)
    pad = rng.integers(0, 256, (2, n, 112), dtype=np.uint8)
    for rows, lengths, out in ((a, la, pad[0]), (b, lb, pad[1])):
        real = np.arange(101)[None, :] < lengths[:, None]
        out[:, :101] = np.where(real, rows, out[:, :101])
    return pad[0], la, pad[1], lb


def verify_kernels(dev: torch.device, reduced: bool = False) -> dict:
    """Every kernel on ``dev`` against host oracles, at the geometries of
    ``bench_kernels.verify_kernels`` plus the edit kernel on 100 bp
    pairs with indels.  Returns ``{kernel name: geometries checked}``;
    raises :class:`KernelMismatch` at the first disagreement.  Each
    wrapper launches its kernel on a CUDA ``dev`` and computes its plain
    version on the CPU.  ``reduced`` cuts the batch counts (buckets per
    size class, pairs per batch), never a geometry."""
    import chip_smoke
    from fastqdedup_tpu_torch.distance import within_distance
    from fastqdedup_tpu_torch.ops import edit_kernels as ek
    from fastqdedup_tpu_torch.ops import hamming_kernels as hk
    from fastqdedup_tpu_torch.ops.bucket import _bucketed_within
    from fastqdedup_tpu_torch.ops.encode import pack_nibbles

    rng = np.random.default_rng(99)
    counts = dict.fromkeys(("within_tile_packed", "bucket_within_packed",
                            "rowwise_within_packed",
                            "banded_within_edit_distance"), 0)

    def done(name: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        counts[name] += 1

    # All-pairs tile: 128 x 256 rows with 128 seeded near-duplicates.
    # (151, 5, 3) is Lp 160 on the tensor cores, (64, 12, 2) the SIMT
    # route.
    for length, alphabet, d in ((20, 5, 1), (100, 5, 1), (100, 5, 2),
                                (151, 5, 3), (64, 12, 2)):
        a = rng.integers(0, alphabet, size=(128, length), dtype=np.uint8)
        b = rng.integers(0, alphabet, size=(256, length), dtype=np.uint8)
        b[:128] = a
        flips = rng.integers(0, length, size=128)
        b[np.arange(128), flips] = rng.integers(
            0, alphabet, size=128).astype(np.uint8)
        got = hk.within_tile_packed(torch.from_numpy(a).to(dev),
                                    torch.from_numpy(b).to(dev), alphabet, d)
        _check(_unpack(got, 256), _hamming_all_pairs(a, b) <= d,
               f"tile N=128 M=256 L={length} A={alphabet} d={d}")
        done("within_tile_packed")

    # Buckets through the pipeline's batching (Lp 112 and 160), every
    # size class; rows 0 and 1 of each bucket equal.
    for s, k in ((128, 32), (512, 4), (2048, 2)):
        k = 1 if reduced else k
        for length, d in ((100, 1), (151, 2)):
            batch = rng.integers(0, 5, size=(k, s, length), dtype=np.uint8)
            batch[:, 1] = batch[:, 0]
            got = _unpack(_bucketed_within(batch, 5, d, device=dev), s)
            for bucket in range(k):
                _check(got[bucket],
                       _hamming_all_pairs(batch[bucket], batch[bucket]) <= d,
                       f"buckets S={s} K={k} L={length} d={d}, bucket "
                       f"{bucket}")
            done("bucket_within_packed")

    # Pair lists: 13, 5 and 19 lanes of 8 nibbles; the last lane of 37
    # and 151 symbols is part pad (0xF in both rows: XOR 0).
    rows_per_batch = 1024 if reduced else hk.ROW_BLOCK
    for length, d in ((100, 1), (37, 2), (151, 3)):
        lanes = max(-(-length // 8), 1)
        rows = rng.integers(0, 5, size=(rows_per_batch, length),
                            dtype=np.uint8)
        other = rows.copy()
        # 0-4 distinct positions per row, each moved to another symbol.
        order = np.argsort(rng.random((rows_per_batch, length)), axis=1)
        nmut = rng.integers(0, 5, size=rows_per_batch)
        for k in range(4):
            hit = np.flatnonzero(nmut > k)
            other[hit, order[hit, k]] = (other[hit, order[hit, k]] + 1) % 5
        packed = [torch.from_numpy(pack_nibbles(x, lanes).view(np.int32))
                  .to(dev) for x in (rows, other)]
        got = hk.rowwise_within_packed(packed[0], packed[1], d)
        _check(got.cpu().numpy().reshape(-1),
               (rows != other).sum(axis=1) <= d,
               f"pair list P={rows_per_batch} L={length} lanes={lanes} "
               f"d={d}")
        done("rowwise_within_packed")

    # Pair lists as the route orders them (``chip_smoke.
    # rowwise_bucket_batch``): every triu pair of each bucket, bucket
    # after bucket, through the indexed entry, against a symbol-by-symbol
    # count of the unpacked rows (pad nibbles included).  13 and 2 lanes
    # are dense's and umi12's widths, 27 the umi3 configuration's, 5 a
    # width that no input of the route has (groups of 4).
    for lanes, size, buckets, d in ((13, 6, 400, 1), (2, 52, 12, 1),
                                    (27, 5, 150, 2), (5, 17, 40, 0)):
        buckets = max(buckets // 8, 1) if reduced else buckets
        n = 3 * size * buckets
        packed, gi, gj = chip_smoke.rowwise_bucket_batch(rng, n, lanes, size,
                                                         buckets)
        got = hk.rowwise_within_packed_indexed(packed.to(dev), gi.to(dev),
                                               gj.to(dev), d)
        shifts = 4 * np.arange(8, dtype=np.uint32)
        symbols = ((packed.numpy().view(np.uint32)[:, :, None] >> shifts)
                   & 0xF).reshape(n, -1)
        gi_np, gj_np = gi.numpy(), gj.numpy()
        _check(got.cpu().numpy().reshape(-1),
               (symbols[gi_np] != symbols[gj_np]).sum(axis=1) <= d,
               f"pair list, triu pairs of {buckets} buckets of {size} into "
               f"n={n} rows lanes={lanes} d={d}")
        done("rowwise_within_packed")

    # Edit kernel against the scalar predicate: 24 bp rows, half of them
    # mutated (the JAX sweep's case), then 100 bp rows with one-base
    # indels (lengths 99-101) at d = 1, 2 and 3.
    syms = np.frombuffer(b"ACGT", dtype=np.uint8)

    def text(row: np.ndarray, n: int) -> str:
        return syms[row[:n]].tobytes().decode()

    def edit_case(a, la, b, lb, d, geometry):
        got = ek.banded_within_edit_distance(
            torch.from_numpy(a).to(dev),
            torch.from_numpy(la.astype(np.int32)).to(dev),
            torch.from_numpy(b).to(dev),
            torch.from_numpy(lb.astype(np.int32)).to(dev), d)
        want = np.array([within_distance(text(a[i], la[i]),
                                         text(b[i], lb[i]), d, True)
                         for i in range(len(a))])
        _check(got.cpu().numpy().reshape(-1), want, geometry)
        done("banded_within_edit_distance")

    n = 64 if reduced else 256
    for d in (1, 2):
        a = rng.integers(0, 4, size=(n, 24), dtype=np.uint8)
        la = np.full(n, 24, dtype=np.int64)
        b = a.copy()
        for i in range(0, n, 2):
            b[i, rng.integers(0, 24)] = (b[i, rng.integers(0, 24)] + 1) % 4
        edit_case(a, la, b, la.copy(), d, f"edit P={n} L=24 d={d}")
    n = 64 if reduced else 512
    for d in (1, 2, 3):
        a, la, b, lb = _edit_rows(rng, n, d)
        edit_case(a, la, b, lb, d,
                  f"edit P={n} 100 bp with indels (lengths 99-101, Lp=112) "
                  f"d={d}")
    return counts


# --------------------------------------------------------------------- #
# Timing mode


def cold_ms(fn, flush: torch.Tensor, reps: int = 20) -> list:
    """Times of one call of ``fn`` between two events, each after
    ``flush`` was written, so that no input is in L2.  The device first
    spins for about a millisecond (``torch.cuda._sleep``), long enough
    for the host to queue the write, both events and the call behind
    it: the events then time the kernel on the device, not the host's
    launch path."""
    fn()
    torch.cuda.synchronize()
    times = []
    for value in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.fill_(value)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def kernel_line(label: str, fn, cost: dict, pairs: int,
                flush: torch.Tensor) -> dict:
    import chip_smoke

    warm = statistics.median(chip_smoke.graph_ms(fn))
    cold = statistics.median(cold_ms(fn, flush))
    bound = chip_smoke.kernel_bound(cost)
    ops_peak = chip_smoke.H100_OPS_PER_S[cost["ops_type"]]
    return {
        "kernel": label,
        "wall_s": warm / 1e3,
        "wall_s_cold": cold / 1e3,
        "achieved_top_s": cost["ops"] / (warm / 1e3) / 1e12,
        "achieved_gb_s": cost["bytes"] / (warm / 1e3) / 1e9,
        "peak_top_s": ops_peak / 1e12,
        "ops_type": cost["ops_type"],
        "peak_gb_s": chip_smoke.H100_BYTES_PER_S / 1e9,
        "pct_speed_of_light": 100 * bound["bound_ms"] / warm,
        "pct_speed_of_light_cold": 100 * bound["bound_ms"] / cold,
        "pairs_per_s": pairs / (warm / 1e3) / 1e6,
        "pairs_unit": "M pairs/s",
        **bound,
    }


def time_kernels(dev: torch.device) -> None:
    """One line per kernel at ``bench_kernels.py``'s shapes."""
    import chip_smoke
    from fastqdedup_tpu_torch.ops import edit_kernels as ek
    from fastqdedup_tpu_torch.ops import hamming_kernels as hk
    from fastqdedup_tpu_torch.ops.bucket import (
        SIZE_CLASSES,
        _buckets_per_call,
    )
    from fastqdedup_tpu_torch.ops.edit import EDIT_VERIFY_BATCH
    from fastqdedup_tpu_torch.ops.encode import pack_nibbles

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    l_pad, a_pad = hk._pad_dims(READ_LEN, 5)

    def padded(rows: np.ndarray) -> torch.Tensor:
        width = [(0, 0)] * (rows.ndim - 1) + [(0, l_pad - rows.shape[-1])]
        return torch.from_numpy(np.pad(rows, width, constant_values=0xFF)
                                ).to(dev)

    # The tile sweep on rows already padded to Lp (the wrapper's two
    # padding calls are torch kernels of their own).
    n = m = 2048
    rng = np.random.default_rng(0)
    a = padded(rng.integers(0, 5, size=(1, n, READ_LEN), dtype=np.uint8))
    b = padded(rng.integers(0, 5, size=(1, m, READ_LEN), dtype=np.uint8))
    chip_smoke.emit(kernel_line(
        f"within_tile_packed {n}x{m} L={READ_LEN} (Lp={l_pad}, Ap={a_pad})",
        lambda: hk._pairs_within_launch("within_tile_packed", a, b,
                                        READ_LEN, 1, a_pad),
        chip_smoke.pairs_within_cost(1, n, m, l_pad, READ_LEN, a_pad, False),
        n * m, flush))

    # Pair lists: 2^17 pairs of packed 100 bp rows, d=1.
    p = 1 << 17
    lanes = max(-(-READ_LEN // 8), 1)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 5, size=(p, READ_LEN), dtype=np.uint8)
    pa = torch.from_numpy(pack_nibbles(rows, lanes).view(np.int32)).to(dev)
    pb = torch.from_numpy(pack_nibbles(rows[::-1].copy(), lanes)
                          .view(np.int32)).to(dev)
    chip_smoke.emit(kernel_line(
        f"rowwise_within_packed P={p} lanes={lanes}",
        lambda: hk.rowwise_within_packed(pa, pb, 1),
        chip_smoke.rowwise_cost(p, lanes), p, flush))
    # The pair-list route's launch: the same pairs as int32 index pairs
    # into one resident matrix of their 2 * 2^17 rows.
    packed = torch.cat([pa, pb])
    gi = torch.arange(p, dtype=torch.int32, device=dev)
    gj = gi + p
    chip_smoke.emit(kernel_line(
        f"rowwise_within_packed_indexed P={p} lanes={lanes} into "
        f"n={2 * p} rows",
        lambda: hk.rowwise_within_packed_indexed(packed, gi, gj, 1),
        chip_smoke.rowwise_cost(p, lanes, chip_smoke.distinct_rows(gi, gj)),
        p, flush))
    del packed
    # The route's largest batches at 1M reads (``chip_smoke.
    # ROUTE_BATCHES``): triu pairs of dense's 5,581 buckets of 6 and of
    # umi12's 260 buckets of 52, bucket after bucket.
    for label, n, lanes, size, buckets in chip_smoke.ROUTE_BATCHES:
        packed, gi, gj = (t.to(dev) for t in chip_smoke.rowwise_bucket_batch(
            rng, n, lanes, size, buckets))
        chip_smoke.emit(kernel_line(
            f"rowwise_within_packed_indexed {label}: P={len(gi)} (triu "
            f"pairs of {buckets} buckets of {size}) lanes={lanes} into "
            f"n={n} rows",
            lambda: hk.rowwise_within_packed_indexed(packed, gi, gj, 1),
            chip_smoke.rowwise_cost(len(gi), lanes,
                                    chip_smoke.distinct_rows(gi, gj)),
            len(gi), flush))
        del packed, gi, gj

    # Buckets: every size class at its batch size, L = READ_LEN, d=1.
    rng = np.random.default_rng(2)
    for size_class in SIZE_CLASSES:
        k = _buckets_per_call(size_class)
        batch = padded(rng.integers(0, 5, size=(k, size_class, READ_LEN),
                                    dtype=np.uint8))
        chip_smoke.emit(kernel_line(
            f"bucket_within_packed K={k} S={size_class} L={READ_LEN}",
            lambda: hk.bucket_within_packed(batch, READ_LEN, 1, a_pad),
            chip_smoke.pairs_within_cost(k, size_class, size_class, l_pad,
                                         READ_LEN, a_pad, True),
            k * size_class * size_class, flush))
        del batch

    # Edit, the path's launch: one verification batch of index pairs
    # into a resident matrix of 2^17 keys, rows gathered in the kernel.
    p = EDIT_VERIFY_BATCH
    rng = np.random.default_rng(3)
    n_keys = 1 << 17
    edit_pad = -(-READ_LEN // 16) * 16
    keys = torch.from_numpy(rng.integers(0, 4, size=(n_keys, edit_pad),
                                         dtype=np.uint8)).to(dev)
    lens = torch.full((n_keys,), READ_LEN, dtype=torch.int32, device=dev)
    ci_np = rng.integers(0, n_keys, size=p).astype(np.int32)
    cj_np = rng.integers(0, n_keys, size=p).astype(np.int32)
    ci = torch.from_numpy(ci_np).to(dev)
    cj = torch.from_numpy(cj_np).to(dev)
    lens_np = np.full(n_keys, READ_LEN, dtype=np.int32)
    chip_smoke.emit(kernel_line(
        f"banded_within_edit_distance indexed d=1 P={p} L={READ_LEN} "
        f"(device gather from {n_keys} keys)",
        lambda: ek.banded_within_edit_distance_indexed(keys, lens, ci, cj,
                                                       1),
        chip_smoke.banded_cost(lens_np[ci_np], lens_np[cj_np], 1, edit_pad,
                               chip_smoke.distinct_rows(ci, cj)), p, flush))
    library_lines(dev, flush)


def library_lines(dev: torch.device, flush: torch.Tensor) -> None:
    """The library call beside kernels 1 and 2 at the shapes of
    ``PERF.md``'s kernel table (buckets at the 50-symbol segment
    complement of 100 bp keys, Lp 64; the 2048 x 2048 tile at L=100, Lp
    112): ``chip_smoke.onehot_product``, the JAX package's non-Pallas
    one-hot product, on prebuilt one-hots (``torch.bmm`` in fp16; one
    ``torch._int_mm`` in int8 for the tile), timed as the kernels are,
    beside the kernel on the same rows.  It leaves out the threshold and
    the bit-pack."""
    import chip_smoke
    from fastqdedup_tpu_torch.ops import hamming_kernels as hk

    rng = np.random.default_rng(4)
    cases = [(k, s, 50, False) for s, k in ((128, 2048), (512, 256),
                                            (2048, 16))]
    cases.append((1, 2048, 100, True))
    for k, s, length, tile in cases:
        l_pad, a_pad = hk._pad_dims(length, 5)
        rows = np.full((k, s, l_pad), 0xFF, dtype=np.uint8)
        rows[:, :, :length] = rng.integers(0, 5, (k, s, length),
                                           dtype=np.uint8)
        a = torch.from_numpy(rows).to(dev)
        b = a.clone() if tile else a
        library, what = chip_smoke.onehot_product(a, b, a_pad, tile)
        for label, fn in (("library", library), ("kernel", lambda: (
                hk._pairs_within_launch("within_tile_packed", a, b, length,
                                        1, a_pad) if tile else
                hk.bucket_within_packed(a, length, 1, a_pad)))):
            warm = statistics.median(chip_smoke.graph_ms(fn))
            cold = statistics.median(cold_ms(fn, flush))
            chip_smoke.emit({
                "library_beside": "within_tile_packed" if tile
                else "bucket_within_packed",
                "shape": f"K={k} S={s} L={length} Lp={l_pad} Ap={a_pad}",
                "call": what if label == "library" else label,
                "wall_s": warm / 1e3, "wall_s_cold": cold / 1e3})
        del a, b, library


def main(argv) -> int:
    import chip_smoke

    verify = "--verify" in argv
    dev = chip_smoke.run_device_or_exit("bench_kernels_torch")
    if not verify and dev.type != "cuda":
        print("bench_kernels_torch: timing mode needs the card (only "
              "--verify runs on the CPU)", file=sys.stderr)
        return 2
    described = chip_smoke.describe_device(dev)
    if not verify:
        chip_smoke.emit({"device": described})
        time_kernels(dev)
        return 0
    try:
        counts = verify_kernels(dev, reduced="--reduced" in argv)
    except KernelMismatch as error:
        print(f"bench_kernels_torch: FAILED: {error}", file=sys.stderr,
              flush=True)
        return 1
    chip_smoke.emit({"verify": "ok", "device": described,
                     "geometries": sum(counts.values()), "by_kernel": counts})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
