"""Pigeonhole bucketing: near-duplicate candidate generation.

Counterpart of ``fastqdedup_tpu/ops/bucket.py``: the host hashing,
grouping and crossover code is the JAX package's; the device parts run
on ``runtime.device()`` through the kernels of :mod:`.hamming_kernels`.

This is the replacement for the radix trie's *search* role
(_triemodule.c:380-495).  Two equal-length keys within Hamming distance d
must agree exactly on at least one of any d+1 disjoint segments, so bucketing
keys by (segment index, segment content) and comparing only within buckets
finds every within-distance pair while skipping almost all of the N^2 space.

Within-bucket comparison is batched across buckets into size classes: all
buckets of (padded) size S are stacked into a [K, S, Lp] tensor and one
launch of the all-pairs kernel produces per-bucket packed adjacency.
Each batch's upload (pinned, ``non_blocking``) and launch are enqueued on
the current stream and the host goes on to the next batch; the drain
starts every queued batch's device-to-host copy before it waits on the
first (:mod:`.transfer`).

The ``--edit`` mode's shifted-segment candidates come in two stages:
:func:`edit_window_plan` lists every probe and window row (and the
short-key complete graph), and a join pairs the rows that share a content
hash.  The host's join (:func:`host_edit_join`, numpy and the C radix
sort, as in the JAX package) serves the CPU device;
``engine._edit_edges_entries`` joins on the card, against the key
matrix resident there, when it runs on one (:mod:`.edit_candidates`).
Both joins' candidates are verified by the banded edit-distance kernel
(:mod:`.edit_kernels`) on the card, or the full-row DP on the CPU device.
"""

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.distributed import _mix64
from ..runtime import device as _device
from ..runtime import local_devices
from ..utils import trace
from .hamming_kernels import (
    _pad_dims,
    bucket_within_packed,
    rowwise_within_packed_indexed,
)
from .transfer import host_array, staging, start_host_copy, upload

_PAD_INDEX = 0xFF  # one-hot of an out-of-range index is all-zero


def _row_group_ids(rows: np.ndarray) -> np.ndarray:
    """Dense group id per row of a uint8 matrix (equal rows -> equal id).

    Grouping is by 64-bit content hash: equal rows always share an id,
    and a hash collision merely MERGES two buckets — harmless for
    candidate generation, since the distance kernels verify every pair
    exactly.  np.unique over uint64 is ~20x faster than over void rows
    (memcmp comparisons) at tens of millions of keys.
    """
    if rows.shape[1] == 0:
        return np.zeros(rows.shape[0], dtype=np.int64)
    hashes = _hash_window_rows(rows, rows.shape[1])
    _, inverse = np.unique(hashes, return_inverse=True)
    return inverse.astype(np.int64)


def _bucket_slices(window: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(order, starts, ends) of equal-content buckets of ``window`` rows.

    One u64 content-hash argsort replaces the np.unique + dense-id +
    second-argsort sequence (which sorted the same data twice).  Member
    order within a bucket is irrelevant — pair sets are order-free and
    globally deduped — and bucket ids (run index in hash order) stay
    deterministic across hosts for the ownership partition.
    """
    n = len(window)
    if window.shape[1] == 0 or n == 0:
        return (np.arange(n, dtype=np.int64),
                np.zeros(1, dtype=np.int64),
                np.full(1, n, dtype=np.int64))
    hashes = _hash_window_rows(window, window.shape[1], strong=False)
    return _bucket_slices_of_hashes(hashes)


def _bucket_slices_of_hashes(hashes: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(order, starts, ends) of equal-hash runs.

    Large inputs sort a COMPOSITE ``(hash high bits << idx_bits) | row``
    by VALUE through the C radix (no index-gather passes): 2-3x faster
    than ``np.argsort`` at 31M keys.  Truncating the hash to the top
    ``64 - idx_bits`` bits can only MERGE runs (equal contents stay
    equal), which the exact distance verification undoes — same
    contract as the bucket hash itself — and per-host ownership is
    decided from the FULL per-row hashes before grouping, so a merged
    run never splits across hosts.  Gated to >= 36 hash bits (n <=
    256M): expected spurious merges stay under ~10^6 even at the cap,
    and each merge only costs one extra fast-fail pair verification.
    """
    n = len(hashes)
    if n >= (1 << 20) and n <= (1 << 28):
        try:
            from ..native.loader import radix_sort_u64_native
        except ImportError:
            radix_sort_u64_native = None
        if radix_sort_u64_native is not None:
            idx_bits = max(int(n - 1).bit_length(), 20)
            low_mask = np.uint64((1 << idx_bits) - 1)
            comp = (hashes & ~low_mask) | np.arange(n, dtype=np.uint64)
            radix_sort_u64_native(comp)
            order = (comp & low_mask).astype(np.int64)
            sh = comp >> np.uint64(idx_bits)
            boundaries = np.flatnonzero(sh[1:] != sh[:-1]) + 1
            starts = np.concatenate([[0], boundaries])
            ends = np.concatenate([boundaries, [n]])
            return order, starts, ends
    order = np.argsort(hashes)
    sh = hashes[order]
    boundaries = np.flatnonzero(sh[1:] != sh[:-1]) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [n]])
    return order, starts, ends


def segment_bounds(length: int, num_segments: int) -> List[Tuple[int, int]]:
    """Split [0, length) into ``num_segments`` near-equal contiguous spans."""
    bounds = []
    base, extra = divmod(length, num_segments)
    start = 0
    for s in range(num_segments):
        end = start + base + (1 if s < extra else 0)
        bounds.append((start, end))
        start = end
    return bounds


def _iter_bucket_slices(group_ids: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort rows by group; return (order, starts, ends) of each group."""
    order = np.argsort(group_ids, kind="stable")
    sorted_ids = group_ids[order]
    boundaries = np.flatnonzero(np.diff(sorted_ids)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(group_ids)]])
    return order, starts, ends


def _bucketed_within(batch: np.ndarray, alphabet_size: int,
                     max_distance: int,
                     device: "Optional[torch.device]" = None
                     ) -> torch.Tensor:
    """uint8 [K, S, ceil(S/8)] on ``device`` (default: the run's device):
    bitpacked per-bucket all-pairs Hamming <= max_distance (unpack with
    np.unpackbits bitorder="little").

    ``batch``: uint8 [K, S, L] alphabet indices; padded slots hold
    ``_PAD_INDEX``, which matches nothing, so padded rows are at distance
    L and are filtered by the caller anyway.  L is padded to a multiple of
    16 with ``_PAD_INDEX``; the real length and distance are kernel
    arguments.  A CUDA device runs the kernel, the CPU device its plain
    version (``hamming_kernels.bucket_within_packed``).

    On a CUDA device the padded batch is built in pinned host memory and
    uploaded ``non_blocking`` on the current stream, as the JAX package's
    ``jax.device_put`` returns before its copy lands: the call returns
    with copy and kernel queued, and the host builds the next batch
    meanwhile.  The staging tensor is dropped here; torch's caching host
    allocator keeps its block until the copy has read it.
    """
    k, s, length = batch.shape
    l_pad, a_pad = _pad_dims(length, alphabet_size)
    dev = device if device is not None else _device()
    host = staging((k, s, l_pad), torch.uint8, dev)
    rows = host.numpy()
    rows[:, :, :length] = batch
    rows[:, :, length:] = _PAD_INDEX
    return bucket_within_packed(upload(host, dev), length, max_distance,
                                a_pad)


# Bucket size classes: exactly these S values exist on device, and the
# batch dimension K is fixed per class (the JAX package's geometry, which
# bounded its compiled-program family; the CUDA kernel takes any multiple
# of 128).
SIZE_CLASSES = (128, 512, 2048)

# Largest per-length key count whose i*n+j pair codes fit int64
# (isqrt(2^63)); see hamming_neighbor_pairs_bucketed.
_HAMMING_PAIR_CODE_LIMIT = 3_037_000_499

# Buckets at or below this size are compared on the HOST: a size-s
# bucket holds only s(s-1)/2 pairs for s*L key bytes of device transfer,
# so tiny buckets (the overwhelming majority at production key counts)
# cost more in dispatch round trips and H2D than a vectorized numpy
# compare costs outright — and tens of millions of keys mean thousands
# of batched launches.
HOST_BUCKET_LIMIT = 32

# ---- measured host/device crossover ----------------------------------
#
# Which bucket sizes are cheaper to verify with numpy on the host versus
# batched into device kernels depends on two machine-specific rates, so
# both are MEASURED once per process (override/simulate via env):
#  * FASTQDEDUP_DISPATCH_S  — seconds per device round trip;
#  * FASTQDEDUP_HOST_RATE   — host byte-compare throughput (bytes/s).

_dispatch_cache: List[float] = []
_host_rate_cache: List[float] = []


_h2d_rate_cache: List[float] = []


def measured_h2d_rate() -> float:
    """Host->device bytes/s, measured once per process (override via
    FASTQDEDUP_H2D_RATE); the pair-list route weighs its index upload
    with it."""
    env = os.environ.get("FASTQDEDUP_H2D_RATE")
    if env:
        return float(env)
    if _h2d_rate_cache:
        return _h2d_rate_cache[0]
    import time as _time

    dev = _device()
    payload = torch.zeros(4 << 20, dtype=torch.uint8)
    best = float("inf")
    for _ in range(2):
        t0 = _time.perf_counter()
        payload.to(dev)
        _synchronize(dev)
        best = min(best, _time.perf_counter() - t0)
    _h2d_rate_cache.append(payload.nbytes / best)
    return _h2d_rate_cache[0]


def measured_dispatch_seconds() -> float:
    """Seconds for one tiny device op + fetch (min of 5, cached)."""
    env = os.environ.get("FASTQDEDUP_DISPATCH_S")
    if env:
        return float(env)
    if _dispatch_cache:
        return _dispatch_cache[0]
    import time as _t

    x = torch.zeros((8, 128), dtype=torch.int32, device=_device())
    (x + 1).cpu()  # first-use initialisation
    best = min(_timed(lambda: (x + 1).cpu(), _t) for _ in range(5))
    _dispatch_cache.append(best)
    return best


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        with trace.span("device.wait"):
            torch.cuda.synchronize(dev)


def _timed(fn, _t) -> float:
    t0 = _t.perf_counter()
    fn()
    return _t.perf_counter() - t0


def measured_host_byte_rate() -> float:
    """Host numpy byte-compare throughput in bytes/s (cached probe)."""
    env = os.environ.get("FASTQDEDUP_HOST_RATE")
    if env:
        return float(env)
    if _host_rate_cache:
        return _host_rate_cache[0]
    import time as _t
    a = np.zeros((1 << 14, 256), dtype=np.uint8)
    b = np.ones_like(a)
    (a != b).sum(axis=1)  # warm
    best = min(_timed(lambda: (a != b).sum(axis=1), _t) for _ in range(3))
    rate = a.nbytes / max(best, 1e-9)
    _host_rate_cache.append(rate)
    return rate


def choose_host_bucket_cap(sizes: np.ndarray, length: int,
                           limit: int,
                           device_length: "int | None" = None) -> int:
    """Largest bucket size verified on host, from MEASURED rates.

    For each candidate cap c, the cost of keeping sizes <= c on host is
    their all-pairs byte compares at the measured host rate; the cost of
    pushing them to the device is the extra kernel launches of the
    smallest size class at the measured per-dispatch latency (device
    compute for these sizes is negligible next to the launch).  Sizes
    above the smallest size class are unaffected by the cap.  Returns
    the candidate minimizing the modeled total.
    """
    dispatch = measured_dispatch_seconds()
    host_rate = measured_host_byte_rate()
    first_class = SIZE_CLASSES[0]
    candidates = [c for c in (4, 8, 16, 32, 64, first_class)
                  if c <= min(limit, first_class)]
    if not candidates:
        return min(limit, first_class)
    in_range = sizes[(sizes > 1) & (sizes <= first_class)]
    if not len(in_range):
        return candidates[-1]
    hist = np.bincount(in_range, minlength=first_class + 1)
    svals = np.arange(first_class + 1, dtype=np.float64)
    pair_bytes = hist * svals * (svals - 1) / 2 * max(length, 1)
    per_call = max(_buckets_per_call(first_class), 1)
    # The device path is not free of host work: every bucket padded into
    # the class still costs batch assembly (S * Lp bytes of gather +
    # zero fill) and result extraction (S*S/8 packed D2H, unpacked to
    # S*S bytes and scanned) on the host — device time is noise next
    # to these.  ~S * (Lp + 1.2 * S) bytes per bucket at the measured
    # host rate.
    l_pad = max(-(-max(device_length or length, 1) // 16) * 16, 16)
    dev_bucket_bytes = first_class * (l_pad + 1.2 * first_class)
    best_cap, best_cost = candidates[-1], float("inf")
    for cap in candidates:
        host_cost = pair_bytes[:cap + 1].sum() / host_rate
        dev_buckets = int(hist[cap + 1:].sum())
        dev_cost = (-(-dev_buckets // per_call) * dispatch
                    + dev_buckets * dev_bucket_bytes / host_rate)
        cost = host_cost + dev_cost
        if cost < best_cost:
            best_cap, best_cost = cap, cost
    return best_cap


def _small_bucket_candidates(order: np.ndarray, starts: np.ndarray,
                             selected: np.ndarray, size: int,
                             batch_pairs: int = 1 << 21):
    """Yield (gi, gj) CANDIDATE pair batches for all selected buckets of
    exactly ``size`` members (every within-bucket pair, unverified).

    Member lists gather into a [K, size] index matrix and pair templates
    (triu) expand it to flat (i, j) candidates.
    """
    ii_t, jj_t = np.triu_indices(size, k=1)
    members = order[starts[selected][:, None] +
                    np.arange(size, dtype=np.int64)[None, :]]
    gi_all = members[:, ii_t].ravel()
    gj_all = members[:, jj_t].ravel()
    for start in range(0, len(gi_all), batch_pairs):
        yield (gi_all[start:start + batch_pairs],
               gj_all[start:start + batch_pairs])


def _host_small_bucket_pairs(matrix: np.ndarray, order: np.ndarray,
                             starts: np.ndarray,
                             selected: np.ndarray, size: int,
                             max_distance: int,
                             batch_pairs: int = 1 << 21):
    """Yield (gi, gj) within-distance pairs for all selected buckets of
    exactly ``size`` members — candidates verified by one uint8 row
    compare per batch (threaded C fast-fail when available)."""
    try:
        from ..native.loader import hamming_verify_pairs_native
    except ImportError:
        hamming_verify_pairs_native = None
    for gi, gj in _small_bucket_candidates(order, starts, selected, size,
                                           batch_pairs):
        keep = None
        if hamming_verify_pairs_native is not None:
            # Threaded C with fast-fail exit: no gathered row temporaries.
            keep = hamming_verify_pairs_native(matrix, gi, gj,
                                               max_distance)
        if keep is None:
            mism = np.count_nonzero(matrix[gi] != matrix[gj], axis=1)
            keep = mism <= max_distance
        yield gi[keep], gj[keep]


_PAIR_VERIFY_BATCH = 1 << 21


class _DevicePairVerifier:
    """Device-side verification of explicit candidate pair lists.

    The nibble-packed key matrix uploads ONCE; each batch then ships only
    8 B/pair of int32 indices in one pinned ``non_blocking`` copy, and
    one launch of the indexed rowwise XOR+popcount kernel
    (``hamming_kernels.rowwise_within_packed_indexed``) reads the packed
    rows through them, as the JAX package gathers and verifies in one
    jitted program.  This is the efficient small-bucket device route:
    cost is proportional to pairs with no per-bucket padding, so the
    crossover beats the host C verifier as soon as pairs * L / host_rate
    exceeds the (amortized) pack+upload plus 8 B/pair of wire — the
    dup-dense regime where pairs >> n/2.  Bit-identical to the host
    verify: full-row Hamming <= d.  The packed lanes live as int32 (torch
    has no uint32 ``index_select``); the kernel reads them as unsigned.
    The JAX package pads each batch to a power of two for its compiled
    shapes; the CUDA kernel takes any P, so no pair is padded here.
    """

    def __init__(self, matrix: np.ndarray, encode_lut, max_distance: int):
        n, length = matrix.shape
        lanes = max(-(-length // 8), 1)
        self._device = _device()
        # Packed straight into the pinned upload buffer.
        host = staging((n, lanes), torch.int32, self._device)
        packed = host.numpy().view(np.uint32)
        try:
            from ..native.loader import pack_nibbles_native
            pack_nibbles_native(matrix, lanes, lut=encode_lut, out=packed)
        except (ImportError, ValueError):
            from .encode import pack_nibbles
            idx = matrix if encode_lut is None else encode_lut[matrix]
            packed[:] = pack_nibbles(idx, lanes)
        self._packed = upload(host, self._device)
        self._n = n
        self._d = max_distance

    def verify(self, gi: np.ndarray, gj: np.ndarray) -> np.ndarray:
        """bool mask: full-row Hamming(matrix[gi], matrix[gj]) <= d."""
        p = len(gi)
        if p == 0:
            return np.empty(0, dtype=bool)
        lo = min(int(gi.min()), int(gj.min()))
        hi = max(int(gi.max()), int(gj.max()))
        if lo < 0 or hi >= self._n:
            raise IndexError(f"candidate index out of range [0, {self._n}): "
                             f"{lo}..{hi}")
        host = staging((2, p), torch.int32, self._device)
        pairs = host.numpy()
        pairs[0] = gi
        pairs[1] = gj
        pairs_dev = upload(host, self._device)
        out = rowwise_within_packed_indexed(self._packed, pairs_dev[0],
                                            pairs_dev[1], self._d)
        return host_array(start_host_copy(out[:, 0]))


def _pairlist_device_wins(pairs: int, n: int, length: int,
                          first_use: bool,
                          upload_share: float = 1.0) -> bool:
    """Measured-rate crossover for the explicit-pair-list device route.

    ``upload_share``: fraction of the one-time pack+upload charged to
    THIS decision — the packed matrix serves every segment pass of the
    run, so the first segment charges 1/(d+1) on the expectation that
    the remaining segments carry similar candidate mass (a mis-estimate
    only flips a near-tie, and each later segment re-decides with the
    upload already sunk)."""
    if pairs == 0:
        return False
    host_rate = measured_host_byte_rate()
    h2d = measured_h2d_rate()
    dispatch = measured_dispatch_seconds()
    lanes = max(-(-length // 8), 1)
    host_cost = pairs * length / host_rate
    # 8 B of int32 indices up (one copy a batch) + 1 B back + overhead.
    dev_cost = (-(-pairs // _PAIR_VERIFY_BATCH)) * dispatch \
        + pairs * 9 / h2d
    if first_use:
        # One C pass packs (reads n*L, writes n*4*lanes) + the upload.
        dev_cost += (n * (length + 4 * lanes) / host_rate
                     + n * 4 * lanes / h2d) * upload_share
    return dev_cost < host_cost


def _buckets_per_call(size_class: int) -> int:
    # Cap both the input (K * S * L bytes) and the int32 match tensor
    # (K * S * S * 4 bytes <= ~256 MB) — the matmul intermediate dominates
    # device memory for the large size classes.
    return max(1, min(2048,
                      (1 << 20) // size_class,
                      (1 << 26) // (size_class * size_class)))


def _launch_bucket_batches(matrix: np.ndarray,
                           member_lists: List[np.ndarray],
                           size_class: int, alphabet_size: int,
                           max_distance: int,
                           encode_lut: "np.ndarray | None" = None,
                           exclude_cols: "Tuple[int, int] | None" = None):
    """Enqueue within-bucket all-pairs kernels, yielding
    (members, future, nbytes) as each batch is dispatched: on a CUDA
    device the batch's pinned upload and its kernel are queued and the
    future is the device tensor of its packed result, not yet computed.
    ``nbytes`` (input plus packed output) lets the caller bound the work
    in flight: device memory, and the pinned host staging of the same
    sizes.

    ``exclude_cols=(s, e)``: ship only the COMPLEMENT of columns [s, e)
    — the pigeonhole segment the bucket already agrees on.  Members of a
    (segment, content) bucket match on those columns by construction, so
    comparing the complement computes the same Hamming distance with
    1/(d+1) fewer key bytes per row (d=1: 2x less H2D and compare work).
    Bucket membership is hash-keyed, so the caller must re-verify
    segment equality on every emitted pair (_drain_bucket_batches does)
    to keep the pair set exact under hash collisions.
    """
    length = matrix.shape[1]
    if exclude_cols is not None:
        ex_s, ex_e = exclude_cols
        length -= ex_e - ex_s
    k = _buckets_per_call(size_class)
    devices = local_devices()
    # The kernel keeps its match counts in registers: a batch holds the
    # uint8 input [K,S,Lp] and the packed output [K,S,S/8] on the device,
    # and the same two in pinned host memory until its copies complete
    # (the input's staging, then the drain's result buffer).
    nbytes = k * size_class * (length + size_class // 8)
    for call_index, start in enumerate(
            range(0, len(member_lists), k)):
        chunk = member_lists[start:start + k]
        members = np.full((k, size_class), -1, dtype=np.int64)
        batch = np.full((k, size_class, length), _PAD_INDEX, dtype=np.uint8)
        for b, idx in enumerate(chunk):
            members[b, :len(idx)] = idx
            if exclude_cols is not None:
                batch[b, :len(idx), :ex_s] = matrix[idx, :ex_s]
                batch[b, :len(idx), ex_s:] = matrix[idx, ex_e:]
            else:
                batch[b, :len(idx)] = matrix[idx]
        if encode_lut is not None:
            # Raw-byte rows -> alphabet indices, gathered rows only.  The
            # _PAD_INDEX fill survives: lut[0xFF] is UNASSIGNED == 0xFF
            # whenever this path is active (see engine._encode_entries).
            batch = encode_lut[batch]
        # Bucket batches are independent: round-robin them across the
        # local devices (data parallelism without collectives — the
        # host-side drain copies each result back from its device).
        yield (members, _bucketed_within(
            batch, alphabet_size, max_distance,
            device=devices[call_index % len(devices)]), nbytes)


# Bytes of launched batches (``nbytes`` of _launch_bucket_batches) allowed
# in flight before the launch loop resolves the oldest: this bounds the
# queued work's device memory and its pinned host staging alike.
MAX_INFLIGHT_BYTES = 1 << 29


def _drain_bucket_batches(launched, matrix: "np.ndarray | None" = None):
    """Resolve launched bucket batches into global index pairs.

    Items are ``(members, future, nbytes, seg)``.  Every item's
    device-to-host copy starts before the first wait, as the JAX
    package's drain starts every ``copy_to_host_async`` first
    (``fastqdedup_tpu/ops/bucket.py:560-566``); each item is then read
    only once its own copy has completed (:mod:`.transfer`).  When
    ``seg=(s, e)`` is set the batch was compared on the segment
    COMPLEMENT, and each emitted pair is re-verified for exact equality
    on columns [s, e) here (O(pairs * w) host bytes — emitted pairs are
    near-duplicates, so this is noise next to the kernel).  The check
    makes the pair set exact even when two different segment contents
    share a 64-bit bucket hash."""
    copies = [start_host_copy(future) for _, future, _, _ in launched]
    for (members, _, _, seg), copy in zip(launched, copies):
        s = members.shape[1]
        within = np.unpackbits(host_array(copy), axis=-1,
                               bitorder="little")[..., :s]
        bb, ii, jj = np.nonzero(np.triu(within, k=1))
        gi = members[bb, ii]
        gj = members[bb, jj]
        valid = (gi >= 0) & (gj >= 0)
        gi, gj = gi[valid], gj[valid]
        if seg is not None and matrix is not None and len(gi):
            seg_s, seg_e = seg
            same = (matrix[gi, seg_s:seg_e]
                    == matrix[gj, seg_s:seg_e]).all(axis=1)
            gi, gj = gi[same], gj[same]
        yield gi, gj


def hamming_neighbor_pairs_bucketed(
        matrix: np.ndarray, alphabet_size: int, max_distance: int,
        large_bucket_threshold: int = 2048,
        shard: Tuple[int, int] = (0, 1),
        encode_lut: "np.ndarray | None" = None
        ) -> Tuple[np.ndarray, np.ndarray]:
    """All pairs (i < j) of equal-length rows within Hamming max_distance,
    via pigeonhole bucketing.  Exact (complete) by the pigeonhole principle.

    Buckets are grouped by size class; each class is compared with one
    launch of the all-pairs kernel per [K, S, Lp] batch, enqueued and
    drained after everything is enqueued.  Buckets larger than
    ``large_bucket_threshold`` get a dedicated all-pairs tile sweep.

    ``shard=(process_id, num_processes)``: multi-host partition — each
    bucket's pairs are computed on exactly one host, chosen by a stable
    mix of the bucket's dense content id (identical on every host because
    every host holds the same key table in the same order).  The union of
    all shards' outputs equals the unsharded output.

    ``encode_lut``: when given, ``matrix`` holds RAW key bytes and this
    uint8[256] byte->index table translates the rows gathered for a
    device kernel (host-side hashing/grouping/equality is
    representation-invariant, so only kernel-bound rows pay encoding).
    When None, ``matrix`` already holds alphabet indices.
    """
    from ..parallel.distributed import bucket_owner_mask
    from .hamming import neighbor_pairs

    pid, nproc = shard
    n, length = matrix.shape
    if n > _HAMMING_PAIR_CODE_LIMIT:
        # Dedup codes pack (i, j) as i*n + j in int64; beyond ~3.03e9
        # rows (n^2 > 2^63) the packing would silently wrap.  At ~100 B
        # per unique key that is a ~300 GB single-length key table —
        # shard the input before hitting this.
        raise OverflowError(
            f"too many equal-length unique keys for pair encoding: "
            f"{n} > {_HAMMING_PAIR_CODE_LIMIT}")
    if n < 2:
        return (np.empty(0, dtype=np.int64),) * 2
    if length <= max_distance:
        # Every pair is trivially within distance; complete graph
        # (emitted by host 0 only under sharding).
        if pid != 0:
            return (np.empty(0, dtype=np.int64),) * 2
        ii, jj = np.triu_indices(n, k=1)
        return ii.astype(np.int64), jj.astype(np.int64)

    pair_codes: List[np.ndarray] = []
    launched: List = []
    inflight = 0
    oversized: List[np.ndarray] = []
    dev_verifier: "Optional[_DevicePairVerifier]" = None

    # Multi-host: shard the per-row bucket hashing itself.  Each host
    # hashes only its 1/P row block for EVERY segment, one column
    # all-gather distributes the u64 hashes (8 B/row/segment — far less
    # than re-reading the full key table per segment on every host), and
    # ownership + owned-row compaction run locally from the gathered
    # values with the exact formula of the fused C path
    # (mix64(hash ^ salt_mix) % nproc), so the bucket->host partition is
    # unchanged.  Gated to large tables: each call adds one collective,
    # which only pays for itself once the replicated hash work dominates
    # the collective's latency floor.
    seg_list = segment_bounds(length, max_distance + 1)
    gathered_hashes: "Optional[np.ndarray]" = None
    shard_hash_min = int(os.environ.get(
        "FASTQDEDUP_SHARD_HASH_MIN_ROWS", str(1 << 20)))
    if nproc > 1 and n >= shard_hash_min and _live_process_count() == nproc:
        # The process-count check keeps the single-process simulated
        # sharding contract intact (tests call shard=(p, P) in ONE
        # process, where the all-gather would be a no-op and the
        # gathered block would silently stand in for the full table).
        with trace.span("pairs.hash"):
            blk_lo = pid * n // nproc
            blk_hi = (pid + 1) * n // nproc
            local = np.empty((len(seg_list), blk_hi - blk_lo),
                             dtype=np.int64)
            for si, (a, b) in enumerate(seg_list):
                local[si] = _hash_window_rows(
                    matrix[blk_lo:blk_hi, a:b], b - a,
                    strong=False).view(np.int64)
            from ..parallel.distributed import allgather_int64_cols
            g, _ = allgather_int64_cols(local)
            gathered_hashes = g.view(np.uint64)
            del g  # keep exactly one live view so release() can recycle

    def drain(down_to: int) -> None:
        # Resolve oldest batches until in-flight bytes fall to the target.
        # Their copies all start first; the batches still queued behind
        # them go on computing on the device while the host extracts
        # pairs here.
        nonlocal launched, inflight
        if not launched or inflight <= down_to:
            return
        with trace.span("pairs.drain"):
            while launched and inflight > down_to:
                take = 0
                while take < len(launched) and inflight > down_to:
                    inflight -= launched[take][2]
                    take += 1
                head, launched = launched[:take], launched[take:]
                for gi, gj in _drain_bucket_batches(head, matrix):
                    trace.count("pairs.kept.device", len(gi))
                    pair_codes.append(np.minimum(gi, gj) * n +
                                      np.maximum(gi, gj))

    # Enqueue bucket batches (pinned non_blocking uploads and launches on
    # the current stream: the host builds the next batch while the device
    # copies and computes this one), draining the oldest whenever the
    # bytes in flight would exceed the budget — inputs with many
    # near-threshold buckets must not pile unbounded inputs and outputs
    # onto the device or into pinned host memory.
    for seg_index, (seg_start, seg_end) in enumerate(seg_list):
        window = matrix[:, seg_start:seg_end]
        if gathered_hashes is not None:
            with trace.span("pairs.hash"):
                h = gathered_hashes[seg_index]
                salt_mix = np.uint64(
                    (0x9E3779B97F4A7C15 * (seg_index + 1)) & _MASK64)
                owner = _mix64(h ^ salt_mix)
                owner %= np.uint64(nproc)
                mine = np.flatnonzero(owner == np.uint64(pid))
                hashes = h[mine]
        elif nproc > 1:
            # Ownership is a salted mix of the segment-content hash, so
            # it is computable PER ROW before any grouping: every member
            # of a bucket shares the hash, hence the owner.  Each host
            # then groups only its ~N/P owned rows — the argsort (the
            # expensive part of grouping) shards instead of being
            # replicated on every host.  The fused C path folds hash +
            # owner mix + compaction into one pass (bit-identical
            # ownership); only the raw per-byte hash remains replicated.
            w = window.shape[1]
            seed = (0x9E3779B97F4A7C15 * (w + 0x10001)
                    + 0x85EBCA6B) & _MASK64
            salt_mix = (0x9E3779B97F4A7C15 * (seg_index + 1)) & _MASK64
            with trace.span("pairs.hash"):
                try:
                    from ..native.loader import hash_owner_select_native
                    mine, owned_hashes = hash_owner_select_native(
                        window, seed, salt_mix, pid, nproc)
                    hashes = owned_hashes
                except (ImportError, ValueError):
                    hashes = _hash_window_rows(window, w, strong=False)
                    mine = np.flatnonzero(
                        bucket_owner_mask(hashes, seg_index, pid, nproc))
                    hashes = hashes[mine]
        else:
            with trace.span("pairs.hash"):
                hashes = _hash_window_rows(window, window.shape[1],
                                           strong=False)
            mine = None
        with trace.span("pairs.group"):
            order, starts, ends = _bucket_slices_of_hashes(hashes)
            if mine is not None:
                order = mine[order]
            sizes = ends - starts
            owned = np.ones(len(starts), dtype=bool)
            # Crossover from MEASURED dispatch latency and host compare
            # rate: the slower the round trip, the more small buckets stay
            # on host.
            host_cap = choose_host_bucket_cap(sizes, length,
                                              large_bucket_threshold)
            small = (sizes > 1) & (sizes <= host_cap) & owned
            small_sizes = sizes[small]
            small_pairs = int((small_sizes.astype(np.int64) *
                               (small_sizes - 1) // 2).sum())
            # Explicit-pair-list device route: when the measured rates say
            # shipping 8 B/pair of indices to the rowwise packed kernel
            # beats the host C verifier (dup-dense inputs on a locally-
            # attached chip), verify the small buckets' candidates on
            # device.  Completeness is unaffected — only WHERE candidates
            # are verified changes, and both verifiers compute the same
            # full-row Hamming predicate.
            use_dev_pairs = (
                small_pairs > 0 and alphabet_size <= 16 and n < (1 << 31)
                and _pairlist_device_wins(
                    small_pairs, n, length,
                    first_use=dev_verifier is None,
                    upload_share=1.0 / (max_distance + 1)))
        if small_pairs:
            side = "device" if use_dev_pairs else "host"
            trace.count(f"pairs.candidates.{side}", small_pairs)
            with trace.span(f"pairs.{side}_verify"):
                if use_dev_pairs and dev_verifier is None:
                    dev_verifier = _DevicePairVerifier(matrix, encode_lut,
                                                       max_distance)
                for s in np.unique(small_sizes):
                    selected = np.flatnonzero(small & (sizes == s))
                    if use_dev_pairs:
                        for gi, gj in _small_bucket_candidates(
                                order, starts, selected, int(s)):
                            keep = dev_verifier.verify(gi, gj)
                            gi, gj = gi[keep], gj[keep]
                            trace.count("pairs.kept.device", len(gi))
                            pair_codes.append(np.minimum(gi, gj) * n +
                                              np.maximum(gi, gj))
                        continue
                    for gi, gj in _host_small_bucket_pairs(
                            matrix, order, starts, selected, int(s),
                            max_distance):
                        trace.count("pairs.kept.host", len(gi))
                        pair_codes.append(np.minimum(gi, gj) * n +
                                          np.maximum(gi, gj))
        classes = [c for c in SIZE_CLASSES
                   if host_cap < c <= large_bucket_threshold]
        lower = host_cap
        # Segment-complement comparison: bucket members agree on columns
        # [seg_start, seg_end) (up to bucket-hash collisions, re-checked
        # per emitted pair in _drain_bucket_batches), so device kernels
        # only ship and compare the complement — for d=1 that is 2x less
        # H2D and 2x fewer compares per pair.  d=0 keeps full rows (the
        # complement would be empty).
        seg = (seg_start, seg_end) if max_distance >= 1 else None
        for size_class in classes:
            in_class = (sizes > lower) & (sizes <= size_class) & owned
            lower = size_class
            selected = np.flatnonzero(in_class)
            if not len(selected):
                continue
            in_sizes = sizes[selected].astype(np.int64)
            trace.count("pairs.candidates.device",
                        (in_sizes * (in_sizes - 1) // 2).sum())
            with trace.span("pairs.device_verify"):
                member_lists = [order[starts[b]:ends[b]] for b in selected]
                for item in _launch_bucket_batches(
                        matrix, member_lists, size_class, alphabet_size,
                        max_distance, encode_lut=encode_lut,
                        exclude_cols=seg):
                    launched.append(item + (seg,))
                    inflight += item[2]
                    if inflight > MAX_INFLIGHT_BYTES:
                        drain(MAX_INFLIGHT_BYTES // 2)
        over_cutoff = classes[-1] if classes else host_cap
        for b in np.flatnonzero((sizes > over_cutoff) & owned):
            oversized.append((order[starts[b]:ends[b]], seg))
    if gathered_hashes is not None:
        from ..runtime import release
        del h  # the last per-segment view into the gathered buffer
        release(gathered_hashes)
        gathered_hashes = None
    drain(0)
    # Oversized buckets: dedicated all-pairs sweep per bucket (same
    # segment-complement reduction + per-pair segment re-check).
    if oversized:
        with trace.span("pairs.oversized"):
            for idx, seg in oversized:
                trace.count("pairs.candidates.device",
                            len(idx) * (len(idx) - 1) // 2)
                if seg is not None:
                    seg_s, seg_e = seg
                    rows = np.concatenate(
                        [matrix[idx, :seg_s], matrix[idx, seg_e:]], axis=1)
                else:
                    rows = matrix[idx]
                if encode_lut is not None:
                    rows = encode_lut[rows]
                li, lj = neighbor_pairs(rows, alphabet_size, max_distance)
                gi, gj = idx[li], idx[lj]
                if seg is not None and len(gi):
                    same = (matrix[gi, seg_s:seg_e]
                            == matrix[gj, seg_s:seg_e]).all(axis=1)
                    gi, gj = gi[same], gj[same]
                trace.count("pairs.kept.device", len(gi))
                pair_codes.append(np.minimum(gi, gj) * n +
                                  np.maximum(gi, gj))

    if not pair_codes:
        return (np.empty(0, dtype=np.int64),) * 2
    with trace.span("pairs.dedup"):
        codes = _sorted_unique_codes(np.concatenate(pair_codes))
    return codes // n, codes % n


_MASK64 = (1 << 64) - 1


def _live_process_count() -> int:
    """Actual torch.distributed process count (1 when uninitialised)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def window_seed(salt: int) -> int:
    """The 64-bit start value of :func:`_hash_window_rows` under ``salt``."""
    return (0x9E3779B97F4A7C15 * (salt + 0x10001) + 0x85EBCA6B) & _MASK64


# Salt of the ``--edit`` join's run ownership under sharding: a row is
# process ``_mix64(hash ^ EDIT_OWN_SALT) % nproc``'s.
EDIT_OWN_SALT = 0xD1B54A32D192ED03


def _hash_window_rows(window: np.ndarray, salt: int,
                      strong: bool = True) -> np.ndarray:
    """uint64 [n] content hashes of the rows of a [n, w] uint8 window.

    ``strong=False`` drops the per-column avalanche to one multiply+shift
    (2.5x fewer memory passes) — right for bucket grouping, where a
    collision only merges candidate groups that exact verification
    splits again; keep ``strong=True`` where collisions must stay at the
    2^-64 level (e.g. the dual-hash key ordering).

    Deterministic, so equal contents always collide (no false negatives);
    unequal contents collide with ~2^-64 probability and any such false
    candidate is discarded by the exact DP verification downstream.

    Hot at production scale (tens of millions of 50-100 byte rows, twice
    per segment pass): the native C path reads each row once with the
    loop split across threads; the numpy fallback transposes columns to
    contiguous memory once and runs the mix with in-place ufuncs (zero
    per-column temporaries).  Both produce identical values
    (tests/test_native_io.py pins the equivalence).
    """
    n, w = window.shape
    seed = window_seed(salt)
    if n and w:
        try:
            from ..native.loader import hash_rows_native
            return hash_rows_native(window, seed, strong=strong)
        except (ImportError, ValueError):
            pass
    w8 = -(-w // 8) * 8
    if w8 != w:
        padded = np.zeros((n, w8), dtype=np.uint8)
        padded[:, :w] = window
    else:
        padded = np.ascontiguousarray(window)
    # Column-major copy: each uint64 column is then a contiguous read.
    cols = np.asfortranarray(padded.view(np.uint64).reshape(n, w8 // 8))
    h = np.full(n, seed, dtype=np.uint64)
    tmp = np.empty(n, dtype=np.uint64)
    c33 = np.uint64(33)
    m1 = np.uint64(0xFF51AFD7ED558CCD)
    m2 = np.uint64(0xC4CEB9FE1A85EC53)
    m3 = np.uint64(0x2545F4914F6CDD1D)

    def mix_inplace(x: np.ndarray) -> None:
        np.right_shift(x, c33, out=tmp)
        np.bitwise_xor(x, tmp, out=x)
        np.multiply(x, m1, out=x)
        np.right_shift(x, c33, out=tmp)
        np.bitwise_xor(x, tmp, out=x)
        np.multiply(x, m2, out=x)
        np.right_shift(x, c33, out=tmp)
        np.bitwise_xor(x, tmp, out=x)

    c29 = np.uint64(29)
    for c in range(cols.shape[1]):
        np.bitwise_xor(h, cols[:, c], out=h)
        if strong:
            mix_inplace(h)
            np.multiply(h, m3, out=h)
        else:
            np.multiply(h, m3, out=h)
            np.right_shift(h, c29, out=tmp)
            np.bitwise_xor(h, tmp, out=h)
    mix_inplace(h)
    return h


# Row count from which edit_candidate_pairs (and _edit_join_runs) sort one
# composite u64 per row through the C radix instead of the numpy
# argsort + lexsort join.  Both produce the same pairs; a module constant
# so that tests can take the composite branch at a small size.
EDIT_RADIX_MIN_ROWS = 1 << 20


def _probe_left_pair_codes(start: np.ndarray, end: np.ndarray,
                           n_a: np.ndarray, gid_at) -> np.ndarray:
    """Pair codes from the probe-left enumeration over pairful runs.

    For each run r (``start[r]``..``end[r]``, first ``n_a[r]`` elements
    probes), every probe pairs with everything later in its run — later
    probes (same-segment probe-probe matches) and all windows.
    ``gid_at(positions)`` maps global row positions to key ids.
    Self-pairs are dropped; the caller dedups codes.
    """
    tot_a = int(n_a.sum())
    rep_run = np.repeat(np.arange(len(start), dtype=np.int64), n_a)
    na_off = np.concatenate([[0], np.cumsum(n_a)])
    probe_pos = start[rep_run] + \
        (np.arange(tot_a, dtype=np.int64) - na_off[rep_run])
    cnt = end[rep_run] - probe_pos - 1
    tot_p = int(cnt.sum())
    rep2 = np.repeat(np.arange(tot_a, dtype=np.int64), cnt)
    cnt_off = np.concatenate([[0], np.cumsum(cnt)])
    right_pos = probe_pos[rep2] + 1 + \
        (np.arange(tot_p, dtype=np.int64) - cnt_off[rep2])
    gi = gid_at(probe_pos[rep2])
    gj = gid_at(right_pos)
    keep = gi != gj
    gi, gj = gi[keep], gj[keep]
    return np.minimum(gi, gj) * _PAIR_BASE + np.maximum(gi, gj)


def _edit_join_runs(hashes: np.ndarray, gids: np.ndarray,
                    sides: np.ndarray):
    """Group the salted window hashes into equal-hash runs with probes
    (side 0) ordered before windows (side 1) inside each run.

    Returns ``(sg2, run_starts, run_ends, n_a, n_b)``: gids in
    (run, side) order plus per-run probe/window counts.

    Large inputs sort ONE composite ``hash_high | side | row`` u64 by
    VALUE through the C radix — no argsort index gathers and no second
    lexsort pass (2-3x faster at 10^8 rows).  Truncating the hash to the
    top ``63 - idx_bits`` bits can only MERGE runs, which only ADDS
    candidate pairs for the exact banded-DP verification to discard —
    the same contract as the window hash itself.
    """
    n = len(hashes)
    if n == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e, e, e, e
    idx_bits = max(int(n - 1).bit_length(), 1)
    if n >= EDIT_RADIX_MIN_ROWS and idx_bits + 1 <= 30:
        try:
            from ..native.loader import radix_sort_u64_native
        except ImportError:
            radix_sort_u64_native = None
        if radix_sort_u64_native is not None:
            low_bits = idx_bits + 1
            low_mask = np.uint64((1 << low_bits) - 1)
            comp = hashes & ~low_mask
            comp |= sides.astype(np.uint64) << np.uint64(idx_bits)
            comp |= np.arange(n, dtype=np.uint64)
            radix_sort_u64_native(comp)
            rows = (comp & np.uint64((1 << idx_bits) - 1)).astype(np.int64)
            sg2 = gids[rows]
            ss2 = (comp >> np.uint64(idx_bits)) & np.uint64(1)
            run_key = comp >> np.uint64(low_bits)
            boundaries = np.flatnonzero(run_key[1:] != run_key[:-1]) + 1
            run_starts = np.concatenate([[0], boundaries])
            run_ends = np.concatenate([boundaries, [n]])
            csum = np.concatenate(
                [[0], np.cumsum(ss2, dtype=np.int64)])
            n_b = csum[run_ends] - csum[run_starts]
            n_a = (run_ends - run_starts) - n_b
            return sg2, run_starts, run_ends, n_a, n_b
    # numpy fallback: unstable hash argsort (runs only need equal hashes
    # adjacent), then a stable per-run re-sort putting probes first.
    order = np.argsort(hashes)
    sh, sg, ss = hashes[order], gids[order], sides[order]
    run_starts = np.concatenate(
        [[0], np.flatnonzero(sh[1:] != sh[:-1]) + 1])
    run_ends = np.concatenate([run_starts[1:], [n]])
    run_of = np.repeat(np.arange(len(run_starts)),
                       run_ends - run_starts)
    n_b = np.bincount(run_of, weights=ss,
                      minlength=len(run_starts)).astype(np.int64)
    n_a = (run_ends - run_starts) - n_b
    order2 = np.lexsort((ss, run_of))
    sg2 = sg[order2]
    return sg2, run_starts, run_ends, n_a, n_b


class EditSpec(NamedTuple):
    """One set of hashed window rows of the ``--edit`` join: the window
    ``matrix[:, w_start:w_start + width]`` of every key of one length
    group (global ids ``gidx``), hashed under ``salt``; ``side`` 0 is a
    probe (the key's own pigeonhole segment), 1 a shifted window."""
    matrix: np.ndarray
    gidx: np.ndarray
    w_start: int
    width: int
    salt: int
    side: int


class EditPlan(NamedTuple):
    """What :func:`edit_window_plan` enumerates: the pair codes of the
    short-key complete graph, every window spec, and the global key
    count (which sets ``gid_bits``)."""
    short_codes: np.ndarray
    specs: List[EditSpec]
    total_keys: int

    @property
    def rows(self) -> int:
        return sum(len(spec.gidx) for spec in self.specs)

    @property
    def gid_bits(self) -> int:
        """Low bits of a composite join value that hold the key id."""
        return max(int(max(self.total_keys - 1, 1)).bit_length(), 1)


def edit_window_plan(matrices: List[np.ndarray],
                     group_indices: List[np.ndarray], max_distance: int,
                     shard: Tuple[int, int] = (0, 1)) -> EditPlan:
    """Stage one of the Levenshtein mode's candidate generation: which
    windows exist.  Both joins (:func:`host_edit_join` here, the card's
    in :mod:`.edit_candidates`) take this plan.

    If lev(a, b) <= d then splitting a into d+1 segments leaves at least
    one segment that occurs *exactly* in b, shifted by at most d positions
    (semantics target: reference distances.h:33-88).  Every key therefore
    emits one PROBE row per segment, keyed by (segment width, segment
    start, content), and one WINDOW row per reachable (width, start,
    shift) descriptor; a join of 64-bit content hashes pairs them.
    """
    d = max_distance
    num_segments = d + 1
    pid, _ = shard
    total_keys = max((int(g.max()) + 1 for g in group_indices if len(g)),
                     default=0)
    if total_keys > _PAIR_BASE:
        # Edit-mode codes pack (i, j) as i*2^31 + j in int64; global key
        # indices at or above 2^31 would silently alias.  (The Hamming
        # path has its own, higher limit — see
        # hamming_neighbor_pairs_bucketed.)
        raise OverflowError(
            f"too many unique keys for edit-mode pair encoding: "
            f"{total_keys} > {_PAIR_BASE}")

    # Keys shorter than d+1 have zero-width pigeonhole segments, so the
    # segment-match argument gives no coverage for them.  Any partner
    # within edit distance d of such a key has length <= 2d (else the
    # length gap alone exceeds d), so the short-key set is closed: emit
    # all pairs among keys of length <= 2*max_distance directly.
    short: List[int] = []
    for matrix, gidx in zip(matrices, group_indices):
        if matrix.shape[1] <= 2 * d:
            short.extend(int(i) for i in gidx)
    if pid != 0:
        short = []  # the short-key complete graph is host 0's
    short_codes = np.empty(0, dtype=np.int64)
    if len(short) > 1:
        arr = np.asarray(short, dtype=np.int64)
        ii, jj = np.triu_indices(len(arr), k=1)
        short_codes = np.minimum(arr[ii], arr[jj]) * _PAIR_BASE + \
            np.maximum(arr[ii], arr[jj])

    lengths = [m.shape[1] for m in matrices]
    seg_by_length = {length: segment_bounds(length, num_segments)
                     for length in set(lengths)}

    def salt_of(width: int, seg_start: int) -> int:
        return width * 65536 + seg_start

    specs: List[EditSpec] = []
    for matrix, gidx in zip(matrices, group_indices):
        n, length = matrix.shape
        if n == 0 or length == 0:
            continue
        own_segments = set()
        for seg_start, seg_end in seg_by_length[length]:
            width = seg_end - seg_start
            if width:
                own_segments.add((width, seg_start))
                specs.append(EditSpec(matrix, gidx, seg_start, width,
                                      salt_of(width, seg_start), 0))
        # B-side: every (width, source-segment-start, shifted window
        # start) descriptor reachable from a source length within +-d —
        # EXCEPT descriptors that coincide with one of this matrix's own
        # probe segments: those window rows would duplicate the probe
        # rows byte for byte (same salt, same content), so the join
        # pairs probes against later PROBES in the run instead (the
        # probe-left enumeration), halving the row count for the
        # dominant same-length shift-0 family and eliminating the
        # guaranteed self-match every key otherwise emits.
        descriptors = set()
        for src_length in seg_by_length:
            if abs(src_length - length) > d:
                continue
            for seg_start, seg_end in seg_by_length[src_length]:
                width = seg_end - seg_start
                if width == 0:
                    continue
                for shift in range(-d, d + 1):
                    w_start = seg_start + shift
                    if 0 <= w_start and w_start + width <= length \
                            and not (w_start == seg_start and
                                     (width, seg_start) in own_segments):
                        descriptors.add((width, seg_start, w_start))
        for width, seg_start, w_start in sorted(descriptors):
            specs.append(EditSpec(matrix, gidx, w_start, width,
                                  salt_of(width, seg_start), 1))
    return EditPlan(short_codes, specs, total_keys)


def host_edit_join(plan: EditPlan, shard: Tuple[int, int] = (0, 1)
                   ) -> np.ndarray:
    """Stage two on the host: the ascending unique pair codes
    (``i * 2^31 + j``, i < j) of every probe and window row that share a
    content hash, the short-key graph left out.  Hash collisions can
    only ADD candidates; the exact banded DP verifies every pair.

    ``shard=(pid, nproc)``: each hash RUN is owned by exactly one host
    (a salted mix of the run's content hash — computable per row before
    any grouping, so the sort and join shard to ~1/P each); the union
    of all shards' pairs equals the unsharded output.
    """
    pid, nproc = shard
    specs = plan.specs
    pair_parts: List[np.ndarray] = []
    total_rows = plan.rows
    trace.count("pairs.edit_rows.host", total_rows)
    gid_bits = plan.gid_bits
    try:
        from ..native.loader import radix_sort_u64_native
    except ImportError:
        radix_sort_u64_native = None
    # Window hashes here follow the bucket-grouping contract: a
    # collision (or a truncated-hash run merge below) only ADDS
    # candidate pairs that the exact banded DP discards, so the cheap
    # weak mix is enough.
    own_salt = np.uint64(EDIT_OWN_SALT)
    fallback_runs = None
    if radix_sort_u64_native is not None \
            and total_rows >= EDIT_RADIX_MIN_ROWS and gid_bits + 1 <= 30:
        # Composite value sort: hash_high | side | gid in ONE u64 per
        # row — no hash/gid/side concatenates, no argsort index
        # gathers, no per-run lexsort, and the sorted key IS the join
        # output (gid in the low bits).  Truncating the hash to
        # ``63 - gid_bits`` bits can only merge runs, adding candidates
        # (and under sharding only SPURIOUS cross-owner candidates are
        # dropped: every true window match shares the full hash, hence
        # the owner).  All 8-byte-per-row buffers come from the pool and
        # full-length derived passes reuse ONE scratch.
        from ..runtime import big_empty, release
        low_bits = gid_bits + 1
        low_mask = np.uint64((1 << low_bits) - 1)
        side_bit = np.uint64(1 << gid_bits)
        comp_full = big_empty(total_rows, np.uint64)
        comp = comp_full
        cursor = 0
        for matrix, gidx, w_start, width, salt, side in specs:
            h = _hash_window_rows(matrix[:, w_start:w_start + width],
                                  salt, strong=False)
            g = gidx
            if nproc > 1:
                mine = _mix64(h ^ own_salt) % np.uint64(nproc) \
                    == np.uint64(pid)
                h = h[mine]
                g = gidx[mine]
            k = len(h)
            view = comp[cursor:cursor + k]
            np.bitwise_and(h, ~low_mask, out=view)
            if side:
                np.bitwise_or(view, side_bit, out=view)
            np.bitwise_or(view, g.astype(np.uint64), out=view)
            cursor += k
        if cursor != total_rows:
            comp = comp_full[:cursor]
        radix_sort_u64_native(comp)
        n_rows = len(comp)
        # Only runs whose FIRST element is a probe and whose size is
        # >= 2 can pair (probes sort before windows), and such a run is
        # flagged by its first adjacent pair: left element a probe, both
        # in the same run.  Detect those first-marks with full-array
        # passes, then recover each pairful run's extent by binary
        # search on the sorted composite — per-run tables over ALL runs
        # (mostly size-1 singletons) are never materialized.
        scratch = big_empty(n_rows, np.uint64)
        marks = np.empty(0, dtype=np.int64)
        if n_rows > 1:
            np.right_shift(comp, np.uint64(gid_bits), out=scratch)
            diffbuf = big_empty(n_rows, np.uint64)
            np.subtract(scratch[1:], scratch[:-1], out=diffbuf[1:])
            # a = run_key << 1 | side.  With the LEFT element a probe
            # (even a), a[i] - a[i-1] <= 1 forces the same run: a
            # different run would differ by >= 2.
            adj = np.less_equal(diffbuf[1:], np.uint64(1))
            np.bitwise_and(scratch, np.uint64(1), out=scratch)
            np.logical_and(adj, np.logical_not(scratch[:-1]), out=adj)
            # Marks within a run are contiguous from its second element,
            # so a mark whose predecessor is not marked sits exactly one
            # past the run start.
            first = adj.copy()
            np.logical_and(first[1:], np.logical_not(adj[:-1]),
                           out=first[1:])
            marks = np.flatnonzero(first) + 1
            del adj, first
            release(diffbuf)
            del diffbuf
        if len(marks):
            gid_mask = np.uint64((1 << gid_bits) - 1)
            start = marks - 1
            kq = comp[start] >> np.uint64(low_bits)
            base_val = kq << np.uint64(low_bits)
            # First window of the run / one past the run's last value
            # ((kq+1) << lb would overflow at the top of the hash
            # space, so probe the run's last representable value).
            t1 = np.searchsorted(comp, base_val | side_bit, side="left")
            end = np.searchsorted(comp, base_val | low_mask, side="right")
            _comp = comp
            pair_parts.append(_probe_left_pair_codes(
                start, end, t1 - start,
                lambda pos: (_comp[pos] & gid_mask).astype(np.int64)))
        del comp
        for _buf in (comp_full, scratch):
            release(_buf)
        del comp_full, scratch
    elif specs:
        hashes = np.concatenate(
            [_hash_window_rows(m[:, s:s + w], salt, strong=False)
             for m, _, s, w, salt, _ in specs])
        gids = np.concatenate([g for _, g, *_ in specs]).astype(np.int64)
        sides = np.concatenate(
            [np.full(len(g), side, dtype=np.uint8)
             for _, g, _, _, _, side in specs])
        if nproc > 1:
            # Run ownership from the row's own hash: every member of a
            # hash run shares the hash, hence the owner, so dropping
            # non-owned rows BEFORE the sort shards the expensive
            # argsort/join ~1/P without splitting any run.
            mine = _mix64(hashes ^ own_salt) \
                % np.uint64(nproc) == np.uint64(pid)
            hashes = hashes[mine]
            gids = gids[mine]
            sides = sides[mine]
        fallback_runs = _edit_join_runs(hashes, gids, sides)

    if fallback_runs is not None:
        sg2, run_starts, run_ends, n_a, n_b = fallback_runs
        # Probe-left enumeration (same semantics as the composite
        # branch): every probe pairs with everything later in its run.
        sel = np.flatnonzero((n_a >= 1) & (run_ends - run_starts >= 2))
        if len(sel):
            pair_parts.append(_probe_left_pair_codes(
                run_starts[sel], run_ends[sel],
                np.minimum(n_a[sel], run_ends[sel] - run_starts[sel] - 1),
                lambda pos: sg2[pos]))

    if not pair_parts:
        return np.empty(0, dtype=np.int64)
    return _sorted_unique_codes(np.concatenate(pair_parts))


def edit_pairs_of_codes(plan: EditPlan, codes: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Candidate (i, j) int64 arrays, i < j, ascending by (i, j): a
    join's sorted unique ``codes`` with the plan's short-key graph."""
    if len(plan.short_codes):
        codes = np.union1d(codes, plan.short_codes)
    return _decode_pair_codes(codes)


def edit_candidate_pairs(matrices: List[np.ndarray],
                         group_indices: List[np.ndarray],
                         max_distance: int,
                         shard: Tuple[int, int] = (0, 1)
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Candidate (i, j) global-index pairs for the Levenshtein mode,
    joined on the host: :func:`edit_window_plan`, then
    :func:`host_edit_join`."""
    plan = edit_window_plan(matrices, group_indices, max_distance, shard)
    return edit_pairs_of_codes(plan, host_edit_join(plan, shard))


_PAIR_BASE = 1 << 31


def _decode_pair_codes(codes: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    return codes // _PAIR_BASE, codes % _PAIR_BASE


def _sorted_unique_codes(codes: np.ndarray) -> np.ndarray:
    """Ascending unique of non-negative int64 pair codes.  C radix sort
    when available (~3x numpy's introsort at tens of millions)."""
    if len(codes) < (1 << 20):
        return np.unique(codes)
    try:
        from ..native.loader import radix_sort_u64_native
    except ImportError:
        return np.unique(codes)
    as_u64 = radix_sort_u64_native(codes.astype(np.uint64, copy=True))
    out = as_u64.view(np.int64)
    if len(out) > 1:
        keep = np.empty(len(out), dtype=bool)
        keep[0] = True
        np.not_equal(out[1:], out[:-1], out=keep[1:])
        out = out[keep]
    return out
