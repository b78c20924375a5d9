"""Dense clustering engine: the replacement for the radix trie.

Counterpart of ``fastqdedup_tpu/engine.py``.  Hamming pairs come from
the tile sweep and pigeonhole bucketing (``ops/hamming.py``,
``ops/bucket.py``); Levenshtein (``--edit``) pairs from shifted-segment
candidates verified by the banded edit-distance kernel on the card
(``ops/edit.py``), or by the full-row DP on the CPU device.

The reference extracts duplicate clusters one at a time by BFS over a radix
trie with fast-fail distance walks (``Trie.pop_cluster``,
_triemodule.c:778-897).  Those clusters are exactly the connected components
of the "within distance d" relation over the unique keys with aggregated
counts (see SURVEY.md section 3.2), so this engine computes the entire
partition at once:

1. group unique keys by length (Hamming never links unequal lengths,
   distances.h:16-20);
2. within each group, find all within-distance pairs on device — brute-force
   all-pairs tiles when the group is small, pigeonhole bucketing when large;
3. in edit mode additionally generate shifted-segment candidates across
   length groups and verify with the banded edit-distance kernel;
4. union-find over the resulting edge list -> components.

Each returned cluster carries its member keys, counts, and local adjacency so
the dissection strategies never recompute a distance.
"""

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .ops.bucket import (
    edit_pairs_of_codes,
    edit_window_plan,
    hamming_neighbor_pairs_bucketed,
    host_edit_join,
)
from .ops.components import connected_components_host
from .ops.encode import UNASSIGNED, EncodeTable, keys_to_matrix
from .ops.hamming import neighbor_pairs
from .utils import trace

# Below this group size brute-force tiling beats bucketing overhead
# (one fixed 2048-row tile pair).
BRUTE_FORCE_LIMIT = 2048
# Baseline host threshold (see _host_limit); also the cutoff for the
# scalar edit-distance host path.
HOST_LIMIT = 256

# Host byte-op budget for the brute-force path.  None (default) derives
# it from the MEASURED host compare rate x the device-amortization
# window (FASTQDEDUP_DEVICE_CUTOVER_S, default 1 s, the JAX package's
# setting).  Set a number (or monkeypatch) to pin it.
_HOST_BYTE_OP_BUDGET = None


def _host_byte_op_budget() -> float:
    if _HOST_BYTE_OP_BUDGET is not None:
        return float(_HOST_BYTE_OP_BUDGET)
    import os

    from .ops.bucket import measured_host_byte_rate
    window = float(os.environ.get("FASTQDEDUP_DEVICE_CUTOVER_S", "1.0"))
    return measured_host_byte_rate() * window


def _host_limit(length: int) -> int:
    import math
    return max(HOST_LIMIT,
               int(math.sqrt(_host_byte_op_budget() / max(length, 1))))


def _host_hamming_pairs(matrix: np.ndarray, max_distance: int,
                        block: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Blocked all-pairs on host (numpy): O(N^2 L) byte ops, O(block*N*L)
    memory."""
    n = matrix.shape[0]
    out_i: List[np.ndarray] = []
    out_j: List[np.ndarray] = []
    for start in range(0, n, block):
        rows = matrix[start:start + block]
        distances = (rows[:, None, :] != matrix[None, :, :]).sum(
            axis=2, dtype=np.int32)
        ii, jj = np.nonzero(distances <= max_distance)
        ii = ii + start
        keep = ii < jj
        out_i.append(ii[keep])
        out_j.append(jj[keep])
    if not out_i:
        return (np.empty(0, dtype=np.int64),) * 2
    return (np.concatenate(out_i).astype(np.int64),
            np.concatenate(out_j).astype(np.int64))


@dataclass
class Cluster:
    """One connected component of the within-distance graph."""
    keys: List[bytes]
    counts: np.ndarray          # int64, aligned with keys
    edges: Set[Tuple[int, int]]  # local (i < j) within-distance pairs

    def as_count_string_list(self) -> List[Tuple[int, str]]:
        return [(int(c), k.decode("latin-1"))
                for c, k in zip(self.counts, self.keys)]


def _group_by_length(keys: Sequence[bytes]) -> Dict[int, np.ndarray]:
    lengths = np.fromiter((len(k) for k in keys), dtype=np.int64,
                          count=len(keys))
    groups: Dict[int, np.ndarray] = {}
    for length in np.unique(lengths):
        groups[int(length)] = np.flatnonzero(lengths == length)
    return groups


# Edge computation operates on "entries": (length, uint8 matrix, global
# key indices) per length group — shared by the bytes-key API
# (build_partition) and the zero-copy grouped API (build_partition_groups).
# Matrices hold RAW key bytes (zero-copy views of the key table) unless
# byte 0xFF occurs in a key, in which case _encode_entries swaps in dense
# index matrices for every group; device kernels translate raw rows via
# the EncodeTable LUT at the gather boundary.
Entries = List[Tuple[int, np.ndarray, np.ndarray]]


def _entries_from_keys(keys: Sequence[bytes],
                       groups: Dict[int, np.ndarray],
                       table: EncodeTable) -> Entries:
    """Entries carry RAW byte matrices (see :func:`_encode_entries`)."""
    entries: Entries = []
    for length, idx in sorted(groups.items()):
        raw = np.frombuffer(b"".join(keys[i] for i in idx),
                            dtype=np.uint8).reshape(len(idx), length)
        table.extend_from(raw)
        entries.append((length, raw, idx))
    return _encode_entries(entries, table)


def _encode_entries(entries: Entries, table: EncodeTable) -> Entries:
    """Re-encode raw entries only when raw bytes would be unsafe.

    Entry matrices stay RAW key bytes: every host-side step (content
    hashing, bucket grouping, row equality counts, the banded edit DP)
    only tests byte equality, which any consistent representation
    satisfies — so the matrices can be zero-copy views of the key table
    and the per-key index translation moves to the device boundaries,
    where only the gathered rows that actually reach a kernel pay it.
    The single exception: the 0xFF padding sentinel (one-hot all-zero,
    never equal to a real symbol) requires that no real key byte is
    0xFF.  If one is, fall back to dense index matrices (indices cap at
    253, below the sentinel) for ALL groups — cross-length edit
    candidate hashing compares bytes across groups, so representation
    must be uniform."""
    if table.table[0xFF] == UNASSIGNED:
        return entries
    return [(length, table.encode(matrix), idx)
            for length, matrix, idx in entries]


def _hamming_edges_entries(entries: Entries, table: EncodeTable,
                           max_distance: int,
                           shard: Tuple[int, int] = (0, 1)
                           ) -> Tuple[np.ndarray, np.ndarray]:
    # Raw-byte entries (the normal case, see _encode_entries) translate
    # to alphabet indices only at the device boundaries below, via this
    # LUT over the rows a kernel actually receives.
    lut = table.table if table.table[0xFF] == UNASSIGNED else None
    pid, nproc = shard
    edges_i: List[np.ndarray] = []
    edges_j: List[np.ndarray] = []
    for g, (length, matrix, idx) in enumerate(entries):
        if len(idx) < 2 or length == 0:
            continue
        if len(idx) <= _host_limit(length):
            # Small groups are a single unit of work: owned by one host.
            if g % nproc != pid:
                continue
            li, lj = _host_hamming_pairs(matrix, max_distance)
        elif len(idx) <= BRUTE_FORCE_LIMIT:
            if g % nproc != pid:
                continue
            li, lj = neighbor_pairs(
                matrix if lut is None else lut[matrix],
                table.size, max_distance)
        else:
            # Large groups split at bucket granularity across hosts.
            li, lj = hamming_neighbor_pairs_bucketed(
                matrix, table.size, max_distance, shard=shard,
                encode_lut=lut)
        edges_i.append(idx[li])
        edges_j.append(idx[lj])
    if not edges_i:
        return (np.empty(0, dtype=np.int64),) * 2
    return np.concatenate(edges_i), np.concatenate(edges_j)


def _host_edit_edges(keys: Sequence[bytes], max_distance: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    from .distance import within_distance
    strings = [k.decode("latin-1") for k in keys]
    ii: List[int] = []
    jj: List[int] = []
    for i in range(len(strings)):
        for j in range(i + 1, len(strings)):
            if within_distance(strings[i], strings[j], max_distance,
                               use_edit_distance=True):
                ii.append(i)
                jj.append(j)
    return np.asarray(ii, dtype=np.int64), np.asarray(jj, dtype=np.int64)


# Whether the card's edit route ships the key matrix nibble-packed
# (ops/edit.pack_nibble_rows) when it can: every value at most 14, which
# holds for dense index matrices (keys with byte 0xFF) and not for raw
# ASCII keys.  The JAX package packs because its wire was slow.  Here
# packing loses: on an NVIDIA H100 80GB HBM3 (700 W) packing the 44 MB
# matrix of 1M reads with indels took 99 ms of host time and saved 3 ms of
# copy; the per-batch unpack added 1 ms (chip_smoke.py --packed-keys).
PACK_KEY_MATRIX = False


def _start_key_upload(keys: np.ndarray, lens: np.ndarray, dev):
    """Enqueue the copy of the key matrix and its lengths to ``dev`` and
    return at once: a function that gives ``(keys_dev, lens_dev)``, after
    which a launch on the current stream reads them only once they have
    landed.  The JAX package enqueues a ``device_put`` here, so that the
    copy overlaps candidate generation (fastqdedup_tpu/engine.py:240-257).

    A helper thread copies the pageable arrays on a side stream; the
    function joins it and makes the current stream wait for the side
    stream.  This form is kept over a pinned ``non_blocking`` copy on
    the current stream for what it costs the host to enqueue: 0.9-2.8
    ms against 5.6-25.1 ms to copy the 44 MB matrix of 1M reads with
    indels into pinned memory, on an NVIDIA H100 80GB HBM3 (700 W,
    chip_smoke.py --key-upload 8 edit indel).  It also pins no host
    block the size of the matrix, which torch's caching host allocator
    would keep for the life of the process.  The host time to the first
    verification did not separate the two forms.  On the CPU device
    nothing is copied."""
    import threading

    import torch

    if dev.type != "cuda":
        tensors = (torch.from_numpy(keys), torch.from_numpy(lens))
        return lambda: tensors
    side = torch.cuda.Stream(dev)
    box = {}

    def copy():
        try:
            with torch.cuda.stream(side):
                box["tensors"] = tuple(
                    torch.from_numpy(array).to(dev, non_blocking=True)
                    for array in (keys, lens))
        except BaseException as error:  # raised again at the join
            box["error"] = error

    thread = threading.Thread(target=copy, name="fastqdedup-key-upload")
    thread.start()

    def result():
        thread.join()
        if "error" in box:
            raise box["error"]
        current = torch.cuda.current_stream(dev)
        current.wait_stream(side)
        for tensor in box["tensors"]:
            tensor.record_stream(current)
        return box["tensors"]

    return result


def _edit_on_card(dev) -> bool:
    """Whether edit verification takes the card's route (resident key
    matrix, indexed kernel) on ``dev``: the JAX package's TPU branch."""
    return dev.type == "cuda"


def _edit_edges_entries(entries: Entries, n: int, max_distance: int,
                        shard: Tuple[int, int] = (0, 1)
                        ) -> Tuple[np.ndarray, np.ndarray]:
    from .ops import edit_candidates
    from .ops.edit import (
        EDIT_VERIFY_BATCH,
        edit_verify_indexed,
        pack_nibble_rows,
        within_edit_distance_auto,
    )
    from .runtime import big_empty, device, release

    matrices = [matrix for _, matrix, _ in entries]
    gidx = [idx for _, _, idx in entries]
    dev = device()
    on_card = _edit_on_card(dev)
    with trace.span("pairs.pad"):
        lengths = np.empty(n, dtype=np.int64)
        lmax = 1
        for length, _, idx in entries:
            lengths[idx] = length
            lmax = max(lmax, length)
        # Pad every key to a common width once for gather-based verification.
        # Pooled pages: at 31M x 100 B a fresh allocation here costs seconds
        # of page backing per run on lazily-backed hosts.
        lmax = -(-lmax // 16) * 16
        padded = big_empty((n, lmax), dtype=np.uint8)
        padded.fill(0xFF)
        for length, matrix, idx in entries:
            if length:
                padded[idx, :length] = matrix

        key_upload = None
        # (lmax is a multiple of 16, so the packed rows have whole bytes.)
        keys_packed = on_card and PACK_KEY_MATRIX and \
            max((int(m.max(initial=0)) for m in matrices), default=0) <= 14
        if on_card:
            # The key matrix goes to the card once: its copy is enqueued now,
            # the card joins the candidate windows against it, and each
            # verification batch then sends only indices.
            key_upload = _start_key_upload(
                pack_nibble_rows(padded) if keys_packed else padded,
                lengths.astype(np.int32), dev)
    # Hash-run ownership shards candidate generation (sort + join) AND
    # the DP verification to ~1/P per host; the union of the per-host
    # verified edges is the full edge set (ops/bucket.host_edit_join).
    # On the card the windows are joined there, against the key matrix
    # (ops/edit_candidates), once its copy has landed.
    with trace.span("pairs.candidates"):
        plan = edit_window_plan(matrices, gidx, max_distance, shard)
        if on_card:
            # The span times the host's join of the upload thread; a copy
            # still in flight on the card is waited for by the first
            # launch that reads it.
            with trace.span("pairs.key_upload_wait"):
                keys_dev, lens_dev = key_upload()
            codes = edit_candidates.join_codes(keys_dev, plan, shard,
                                               keys_packed)
        else:
            codes = host_edit_join(plan, shard)
        cand_i, cand_j = edit_pairs_of_codes(plan, codes)
    side = "device" if on_card else "host"
    trace.count(f"pairs.candidates.{side}", len(cand_i))
    if not len(cand_i):
        release(padded)
        return cand_i, cand_j
    keep = np.empty(len(cand_i), dtype=bool)
    batch = EDIT_VERIFY_BATCH
    with trace.span("pairs.edit_verify"):
        if on_card:
            # Device-resident keys + per-batch index pairs: 8 bytes a pair
            # cross the wire instead of ~2 L (ops/edit.edit_verify_indexed).
            for start in range(0, len(cand_i), batch):
                sl = slice(start, start + batch)
                keep[sl] = edit_verify_indexed(
                    keys_dev, lens_dev, cand_i[sl], cand_j[sl],
                    max_distance, packed=keys_packed)
            del keys_dev, lens_dev
        else:
            for start in range(0, len(cand_i), batch):
                sl = slice(start, start + batch)
                keep[sl] = within_edit_distance_auto(
                    padded[cand_i[sl]], lengths[cand_i[sl]],
                    padded[cand_j[sl]], lengths[cand_j[sl]], max_distance)
    release(padded)  # refcount-gated no-op if a tensor still holds it
    trace.count(f"pairs.kept.{side}", int(keep.sum()))
    return cand_i[keep], cand_j[keep]


def _component_labels(n: int, ei: np.ndarray, ej: np.ndarray) -> np.ndarray:
    """Component labels: sparse min-label propagation on the device mesh
    when several local devices are attached (parallel/sharded.py), host
    union-find otherwise (one device gains nothing over union-find)."""
    min_edges = int(os.environ.get("FASTQDEDUP_MESH_MIN_EDGES", "1024"))
    if len(ei) >= min_edges:
        from .parallel.sharded import components_on_mesh
        labels = components_on_mesh(n, ei, ej)
        if labels is not None:
            return labels
    elif os.environ.get("FASTQDEDUP_REQUIRE_MESH", "0") == "1":
        raise RuntimeError(
            f"FASTQDEDUP_REQUIRE_MESH=1 but the edge list ({len(ei)}) is "
            f"below FASTQDEDUP_MESH_MIN_EDGES={min_edges}")
    return connected_components_host(n, ei, ej)


def _assemble_partition(n: int, labels: np.ndarray, ei: np.ndarray,
                        ej: np.ndarray) -> "Partition":
    """Group keys by component label into a :class:`Partition`.

    Native path: O(n) counting sort (labels are component-min indices in
    ``[0, n)``).  Fallback reproduces the identical grouping with a
    stable argsort.
    """
    if n == 0:
        empty = np.empty(0, dtype=np.int64)
        return Partition(empty, empty, empty, ei, ej, empty, empty)
    try:
        # AttributeError covers a stale _fastq_io.so predating the
        # fq_partition_assemble symbol (loader.py binds restypes at
        # import, so the whole module import raises AttributeError).
        from .native.loader import partition_assemble_native
        order, starts, ends, cluster_of, local_index = \
            partition_assemble_native(labels)
    except (ImportError, AttributeError):
        order = np.argsort(labels, kind="stable")
        sorted_labels = labels[order]
        boundaries = np.flatnonzero(np.diff(sorted_labels)) + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [n]])
        sizes = ends - starts
        cluster_of = np.empty(n, dtype=np.int64)
        cluster_of[order] = np.repeat(
            np.arange(len(starts), dtype=np.int64), sizes)
        local_index = np.empty(n, dtype=np.int64)
        local_index[order] = np.arange(n, dtype=np.int64) - \
            np.repeat(starts, sizes)
    return Partition(order, starts, ends, ei, ej, cluster_of, local_index)


@dataclass
class Partition:
    """Raw connected-component partition over unique keys.

    ``order`` lists key indices grouped by component; component c spans
    ``order[starts[c]:ends[c]]``.  ``edges`` is the global within-distance
    pair list (i < j not guaranteed).  Array-first so callers can process
    singleton components without per-component Python objects.
    """
    order: np.ndarray    # int64 [N] key indices grouped by component
    starts: np.ndarray   # int64 [C]
    ends: np.ndarray     # int64 [C]
    edges_i: np.ndarray  # int64 [E]
    edges_j: np.ndarray  # int64 [E]
    cluster_of: np.ndarray  # int64 [N]: component id per key index
    local_index: np.ndarray  # int64 [N]: position within its component

    @property
    def num_clusters(self) -> int:
        return len(self.starts)

    def sizes(self) -> np.ndarray:
        return self.ends - self.starts


def build_partition(keys: Sequence[bytes], max_distance: int,
                    use_edit_distance: bool = False,
                    table: Optional[EncodeTable] = None) -> Partition:
    """Connected components of the within-distance graph, as raw arrays."""
    n = len(keys)
    if table is None:
        table = EncodeTable("ACGTN")
    empty = np.empty(0, dtype=np.int64)
    if n == 0:
        return Partition(empty, empty, empty, empty, empty, empty, empty)
    if max_distance <= 0:
        idx = np.arange(n, dtype=np.int64)
        return Partition(idx, idx, idx + 1, empty, empty, idx,
                         np.zeros(n, dtype=np.int64))
    groups = _group_by_length(keys)
    if use_edit_distance and n <= HOST_LIMIT:
        ei, ej = _host_edit_edges(keys, max_distance)
    else:
        entries = _entries_from_keys(keys, groups, table)
        if use_edit_distance:
            ei, ej = _edit_edges_entries(entries, n, max_distance)
        else:
            ei, ej = _hamming_edges_entries(entries, table, max_distance)

    labels = _component_labels(n, ei, ej)
    return _assemble_partition(n, labels, ei, ej)


def build_clusters(keys: Sequence[bytes], counts: Sequence[int],
                   max_distance: int, use_edit_distance: bool = False,
                   table: Optional[EncodeTable] = None) -> List[Cluster]:
    """Partition unique ``keys`` into within-distance connected components.

    Output-equivalent to repeatedly calling the reference's
    ``Trie.pop_cluster`` until empty (cluster membership and counts match;
    extraction order is not part of the contract — the reference's own tests
    compare clusters as sets, tests/test_trie.py:96-106).
    """
    n = len(keys)
    counts_arr = np.asarray(counts, dtype=np.int64)
    if n == 0:
        return []
    part = build_partition(keys, max_distance, use_edit_distance, table)
    clusters: List[Cluster] = []
    for s, e in zip(part.starts, part.ends):
        members = part.order[s:e]
        clusters.append(Cluster([keys[i] for i in members],
                                counts_arr[members], set()))
    for a, b in zip(part.edges_i.tolist(), part.edges_j.tolist()):
        c = part.cluster_of[a]
        la, lb = int(part.local_index[a]), int(part.local_index[b])
        if la > lb:
            la, lb = lb, la
        clusters[c].edges.add((la, lb))
    return clusters


def contains_within(keys: Sequence[bytes], query: bytes, max_distance: int,
                    use_edit_distance: bool,
                    table: Optional[EncodeTable] = None) -> bool:
    """True iff any key is within ``max_distance`` of ``query``.

    Batch equivalent of the trie's approximate membership test
    (``Trie.contains_sequence``, _triemodule.c:730-758).
    """
    if not keys:
        return False
    if len(keys) <= HOST_LIMIT:
        from .distance import within_distance
        query_str = query.decode("latin-1")
        return any(within_distance(query_str, k.decode("latin-1"),
                                   max_distance, use_edit_distance)
                   for k in keys)
    import torch

    from .runtime import device
    if table is None:
        table = EncodeTable("ACGTN")
    if use_edit_distance:
        # Query and keys share one padded width, so on the card the
        # banded kernel answers; on the CPU the full-row DP does, as the
        # JAX package's batched_within_edit_distance.
        from .ops.edit import within_edit_distance_auto
        lengths = np.fromiter((len(k) for k in keys), dtype=np.int64,
                              count=len(keys))
        near = np.abs(lengths - len(query)) <= max_distance
        cand = [k for k, ok in zip(keys, near) if ok]
        if not cand:
            return False
        lmax = max(max(len(k) for k in cand), len(query), 1)
        padded = np.full((len(cand), lmax), 0xFF, dtype=np.uint8)
        for i, k in enumerate(cand):
            padded[i, :len(k)] = table.encode(
                np.frombuffer(k, dtype=np.uint8))
        q = np.full((len(cand), lmax), 0xFF, dtype=np.uint8)
        q[:, :len(query)] = table.encode(
            np.frombuffer(query, dtype=np.uint8))
        res = within_edit_distance_auto(
            q, np.full(len(cand), len(query), dtype=np.int32), padded,
            lengths[near], max_distance)
        return bool(res.any())
    # Hamming: only keys of identical length can match
    # (distances.h:16-20 — unequal lengths are never within distance).
    if len(query) == 0:
        return any(len(k) == 0 for k in keys)
    same = [k for k in keys if len(k) == len(query)]
    if not same:
        return False
    from .ops.hamming import rowwise_within
    matrix, _ = keys_to_matrix(same, table)
    q = np.broadcast_to(
        table.encode(np.frombuffer(query, dtype=np.uint8)),
        matrix.shape)
    dev = device()
    res = rowwise_within(torch.from_numpy(np.ascontiguousarray(q)).to(dev),
                         torch.from_numpy(matrix).to(dev), table.size,
                         max_distance)
    return bool(res.any())


@dataclass
class KeyGroups:
    """Unique keys as per-length sorted void arrays with aggregate counts.

    The zero-copy interface between pass 1's unique merge and the engine:
    global key index i lives in group g = searchsorted(starts, i, "right")-1
    at row i - starts[g]; group voids are lexicographically sorted, so
    per-length membership tables for the rewrite pass come for free.
    """
    lengths: List[int]          # ascending, no duplicates
    voids: List[np.ndarray]     # sorted void arrays, one per length
    counts: List[np.ndarray]    # int64 arrays aligned with voids
    starts: np.ndarray          # int64 [G]: global index of group start
    n: int
    # Global record index of each key's FIRST occurrence among all input
    # records (aligned with voids); lets pass 3 apply the reference's
    # first-wins rule (__init__.py:203-206) as a stateless equality test,
    # which also makes the rewrite pass embarrassingly parallel across
    # hosts.  None when built through an API that didn't track positions.
    first_pos: Optional[List[np.ndarray]] = None

    def locate(self, index: int) -> Tuple[int, int]:
        g = int(np.searchsorted(self.starts, index, side="right")) - 1
        return g, int(index - self.starts[g])

    def key_bytes(self, index: int) -> bytes:
        g, row = self.locate(index)
        if self.lengths[g] == 0:
            return b""
        return self.voids[g][row].tobytes()

    def counts_concat(self) -> np.ndarray:
        if not self.counts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(self.counts)

    def group_index_of_length(self, length: int) -> Optional[int]:
        import bisect
        g = bisect.bisect_left(self.lengths, length)
        if g < len(self.lengths) and self.lengths[g] == length:
            return g
        return None

    def dispose(self) -> None:
        """Recycle the key-table backing buffers into the runtime pool.

        Call when the run is done with the key table; the release is
        refcount-gated, so a view still alive anywhere turns this into a
        silent no-op rather than aliased memory.  The KeyGroups is
        unusable afterwards."""
        from .runtime import release
        bases: List[np.ndarray] = []
        seen = set()
        for arrs in (self.voids, self.counts, self.first_pos or []):
            for a in arrs:
                base = a
                while isinstance(base.base, np.ndarray):
                    base = base.base
                if id(base) not in seen:
                    seen.add(id(base))
                    bases.append(base)
        # The loop leftovers (`a`, `arrs`, `base`) still bind the LAST
        # member's view/list, which silently blocks ITS recycle below —
        # measured as the first_pos column (240 MiB at 100M reads)
        # re-faulting on every run.
        a = arrs = base = None
        self.voids = []
        self.counts = []
        self.first_pos = None
        self.lengths = []
        while bases:
            release(bases.pop())


def key_groups_from_arrays(lengths: List[int], voids: List[np.ndarray],
                           counts: List[np.ndarray], starts: np.ndarray,
                           n: int,
                           first_pos: Optional[List[np.ndarray]] = None
                           ) -> KeyGroups:
    """A :class:`KeyGroups` from the fields of another (for instance the
    JAX package's): the key table is numpy in both packages, so the
    arrays are taken as they are."""
    return KeyGroups(list(lengths), list(voids), list(counts),
                     np.asarray(starts, dtype=np.int64), int(n),
                     None if first_pos is None else list(first_pos))


@trace.spanned("pairs")
def build_partition_groups(groups: KeyGroups, max_distance: int,
                           use_edit_distance: bool = False,
                           table: Optional[EncodeTable] = None,
                           shard: Tuple[int, int] = (0, 1),
                           byte_presence: Optional[np.ndarray] = None
                           ) -> Partition:
    """Like :func:`build_partition`, but over :class:`KeyGroups` — no
    per-key Python bytes objects are materialized on this path.

    ``shard=(process_id, num_processes)``: in multi-host runs each host
    computes the within-distance pairs for the buckets it owns; the edge
    lists all-gather and dedupe before union-find, so every host derives
    the identical partition.

    ``byte_presence``: optional bool[256] bitmap of byte values occurring
    in the key table (collected during pass 1 by the native accumulator,
    OR-ed across hosts).  When given, the alphabet registers from the
    bitmap and the per-group key-table scans are skipped — at 31M x
    100 bp keys that scan costs seconds per host, replicated.
    """
    if table is None:
        table = EncodeTable("ACGTN")
    n = groups.n
    empty = np.empty(0, dtype=np.int64)
    if n == 0:
        return Partition(empty, empty, empty, empty, empty, empty, empty)
    if max_distance <= 0:
        idx = np.arange(n, dtype=np.int64)
        return Partition(idx, idx, idx + 1, empty, empty, idx,
                         np.zeros(n, dtype=np.int64))
    with trace.span("pairs.alphabet"):
        if byte_presence is not None:
            table.extend_from_presence(byte_presence)
        entries: Entries = []
        for g, length in enumerate(groups.lengths):
            size = len(groups.counts[g])
            idx = np.arange(groups.starts[g], groups.starts[g] + size,
                            dtype=np.int64)
            if length == 0:
                matrix = np.zeros((size, 0), dtype=np.uint8)
            else:
                # Zero-copy view of the key table; _encode_entries decides
                # whether raw bytes are safe (they are unless 0xFF occurs).
                matrix = groups.voids[g].view(np.uint8).reshape(size, length)
                if byte_presence is None:
                    table.extend_from(matrix)
            entries.append((length, matrix, idx))
        entries = _encode_entries(entries, table)
    pid, nproc = shard
    with trace.span("pairs.edges"):
        if use_edit_distance:
            if n <= HOST_LIMIT:
                # Tiny inputs: every host computes the full edge set
                # identically; skip the exchange below.
                keys = [groups.key_bytes(i) for i in range(n)]
                ei, ej = _host_edit_edges(keys, max_distance)
                nproc = 1
            else:
                ei, ej = _edit_edges_entries(entries, n, max_distance, shard)
        else:
            ei, ej = _hamming_edges_entries(entries, table, max_distance,
                                            shard)
        if nproc > 1:
            from .parallel.distributed import allgather_int64_pairs
            ei, ej = allgather_int64_pairs(ei, ej)
            if len(ei):
                # A pair may surface on two hosts (different segment passes);
                # dedupe so per-cluster edge sets stay canonical.  Native
                # radix sort + adjacent-unique (this dedup over the FULL
                # gathered edge list is replicated on every host).
                codes = np.minimum(ei, ej) * np.int64(n) + np.maximum(ei, ej)
                try:
                    from .native.loader import radix_sort_u64_native
                    codes = radix_sort_u64_native(
                        codes.view(np.uint64)).view(np.int64)
                    if len(codes) > 1:
                        keep = np.empty(len(codes), dtype=bool)
                        keep[0] = True
                        np.not_equal(codes[1:], codes[:-1], out=keep[1:])
                        codes = codes[keep]
                except (ImportError, AttributeError):
                    codes = np.unique(codes)
                ei, ej = codes // n, codes % n
    with trace.span("pairs.labels"):
        labels = _component_labels(n, ei, ej)
    with trace.span("pairs.assemble"):
        return _assemble_partition(n, labels, ei, ej)
