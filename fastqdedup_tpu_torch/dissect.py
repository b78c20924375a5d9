"""Cluster dissection: pick representative reads per duplicate cluster.

Implements the three strategies from the UMI-tools paper with the exact
semantics of the reference (/root/reference/src/fastqdedup/__init__.py:60-130):

* ``highest_count`` — keep only the read with the highest count (ties broken
  toward the lexicographically greatest string, via descending tuple sort).
* ``adjacency`` — repeatedly keep the highest-count read and drop every
  remaining read within ``max_distance`` of it.
* ``directional`` — like adjacency, but a read is only absorbed into a
  growing template chain when ``2 * count - 1 <= template_count`` (PCR
  artifact heuristic), and absorbed reads themselves become templates.

The public functions below take ``List[Tuple[count, str]]`` and call a
distance oracle per pair, exactly like the reference API.  The pipeline
calls :func:`dissect_partition` instead, which dissects every cluster of a
partition from its precomputed adjacency (from the pairwise kernels) and
never computes distances; :func:`dissect_with_adjacency` is its
per-cluster oracle.

Key order-independence fact exploited here: the reference's directional
absorption loop (append-while-iterating BFS, __init__.py:78-90) absorbs
exactly the set of reads *reachable* from the origin through directed edges
``u -> v`` with ``2*count(v) - 1 <= count(u)`` and ``dist(u, v) <= d`` among
the reads remaining in that round, so any BFS order yields the same set.
"""

import logging
from typing import (TYPE_CHECKING, Callable, Dict, Iterator, List, Optional,
                    Sequence, Set, Tuple)

import numpy as np

from .distance import within_distance
from .utils import trace

if TYPE_CHECKING:
    from .engine import KeyGroups, Partition

logger = logging.getLogger("fastqdedup")

DEFAULT_MAX_DISTANCE = 1

PairOracle = Callable[[int, int], bool]


def _sorted_indices(cluster: Sequence[Tuple[int, str]]) -> List[int]:
    """Indices of ``cluster`` sorted ascending by (count, string)."""
    return sorted(range(len(cluster)), key=lambda i: cluster[i])


def _directional_rounds(
        cluster: Sequence[Tuple[int, str]],
        neighbor_oracle: PairOracle) -> Iterator[int]:
    """Yield origin indices for the directional method.

    ``neighbor_oracle(i, j)`` must answer "within max_distance?" for cluster
    indices i, j.
    """
    order = _sorted_indices(cluster)
    remaining: List[int] = order[:]  # ascending; origin popped from the end
    while remaining:
        origin = remaining.pop()
        origin_count = cluster[origin][0]
        # BFS closure over count-gated edges among the remaining reads.
        absorbed: Set[int] = set()
        frontier: List[Tuple[int, int]] = [(origin_count, origin)]
        while frontier:
            template_count, template = frontier.pop()
            for idx in remaining:
                if idx in absorbed:
                    continue
                count = cluster[idx][0]
                if 2 * count - 1 <= template_count and \
                        neighbor_oracle(template, idx):
                    absorbed.add(idx)
                    frontier.append((count, idx))
        if absorbed:
            remaining = [i for i in remaining if i not in absorbed]
        yield origin


def _adjacency_rounds(
        cluster: Sequence[Tuple[int, str]],
        neighbor_oracle: PairOracle) -> Iterator[int]:
    """Yield kept indices for the adjacency method."""
    remaining = _sorted_indices(cluster)[::-1]  # descending
    while remaining:
        top = remaining[0]
        yield top
        remaining = [i for i in remaining[1:] if not neighbor_oracle(top, i)]


def _scalar_oracle(cluster: Sequence[Tuple[int, str]], max_distance: int,
                   use_edit_distance: bool) -> PairOracle:
    def oracle(i: int, j: int) -> bool:
        return within_distance(cluster[i][1], cluster[j][1],
                               max_distance, use_edit_distance)
    return oracle


def cluster_dissection_directional(cluster: List[Tuple[int, str]],
                                   max_distance: int = DEFAULT_MAX_DISTANCE,
                                   use_edit_distance: bool = False,
                                   ) -> Iterator[str]:
    """Directional method (UMI-tools): count-gated template chains."""
    oracle = _scalar_oracle(cluster, max_distance, use_edit_distance)
    for origin in _directional_rounds(cluster, oracle):
        yield cluster[origin][1]


def cluster_dissection_adjacency(cluster: List[Tuple[int, str]],
                                 max_distance: int = DEFAULT_MAX_DISTANCE,
                                 use_edit_distance: bool = False,
                                 ) -> Iterator[str]:
    """Adjacency method: greedy max-count peeling of direct neighbors."""
    oracle = _scalar_oracle(cluster, max_distance, use_edit_distance)
    for kept in _adjacency_rounds(cluster, oracle):
        yield cluster[kept][1]


def cluster_dissection_highest_count(cluster: List[Tuple[int, str]],
                                     max_distance: int = DEFAULT_MAX_DISTANCE,
                                     use_edit_distance: bool = False,
                                     ) -> Iterator[str]:
    """Keep only the single read with the highest (count, string)."""
    yield max(cluster)[1]


ClusterDissectionFunc = Callable[[List[Tuple[int, str]], int, bool],
                                 Iterator[str]]
CLUSTER_DISSECTION_METHODS: Dict[str, ClusterDissectionFunc] = {
    "highest_count": cluster_dissection_highest_count,
    "adjacency": cluster_dissection_adjacency,
    "directional": cluster_dissection_directional,
}


def dissect_indices(method: str, counts: np.ndarray, rank: np.ndarray,
                    edges_i: np.ndarray, edges_j: np.ndarray) -> np.ndarray:
    """Vectorized dissection over local member indices — the big-cluster
    path (no per-member Python tuples, no list-scan BFS).

    ``counts``: int64 [m]; ``rank``: int64 [m] ascending lexicographic
    rank of each member's key string (ties in count break toward the
    greatest string, replicating the reference's tuple sort,
    __init__.py:68,99,111); ``edges_i``/``edges_j``: local within-distance
    pairs.  Returns kept local indices.

    Semantics proof sketch for ``directional``: the reference's
    append-while-iterating BFS (__init__.py:78-90) absorbs exactly the set
    of members reachable from the origin through directed edges u -> v
    with ``2*count(v) - 1 <= count(u)`` among the not-yet-absorbed — a
    path-constrained reachability that any BFS order computes identically
    (see module docstring), here as a CSR frontier expansion.
    """
    m = len(counts)
    if m == 0:
        return np.empty(0, dtype=np.int64)
    order = np.lexsort((rank, counts))  # ascending (count, string)
    if method == "highest_count":
        return order[-1:].astype(np.int64)
    # Symmetric CSR adjacency.
    src = np.concatenate([edges_i, edges_j])
    dst = np.concatenate([edges_j, edges_i])
    deg = np.bincount(src, minlength=m)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    adj_order = np.argsort(src, kind="stable")
    indices = dst[adj_order]

    remaining = np.ones(m, dtype=bool)
    kept: List[int] = []
    if method == "adjacency":
        for top in order[::-1]:
            if not remaining[top]:
                continue
            kept.append(int(top))
            remaining[top] = False
            remaining[indices[indptr[top]:indptr[top + 1]]] = False
        return np.asarray(kept, dtype=np.int64)
    if method != "directional":
        raise ValueError(f"Unknown cluster dissection method: {method}")
    for origin in order[::-1]:
        if not remaining[origin]:
            continue
        kept.append(int(origin))
        remaining[origin] = False
        frontier = np.asarray([origin], dtype=np.int64)
        while len(frontier):
            starts = indptr[frontier]
            degs = indptr[frontier + 1] - starts
            total = int(degs.sum())
            if total == 0:
                break
            offsets = np.zeros(len(degs), dtype=np.int64)
            np.cumsum(degs[:-1], out=offsets[1:])
            flat = np.repeat(starts - offsets, degs) + \
                np.arange(total, dtype=np.int64)
            nbr = indices[flat]
            parent = np.repeat(frontier, degs)
            ok = remaining[nbr] & (2 * counts[nbr] - 1 <= counts[parent])
            newly = np.unique(nbr[ok])
            remaining[newly] = False
            frontier = newly
    return np.asarray(kept, dtype=np.int64)


def _csr_expand(indptr: np.ndarray, indices: np.ndarray,
                frontier: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(neighbors, parents) of every frontier node, flattened."""
    starts = indptr[frontier]
    degs = indptr[frontier + 1] - starts
    total = int(degs.sum())
    if total == 0:
        return (np.empty(0, dtype=np.int64),) * 2
    offsets = np.zeros(len(degs), dtype=np.int64)
    np.cumsum(degs[:-1], out=offsets[1:])
    flat = np.repeat(starts - offsets, degs) + \
        np.arange(total, dtype=np.int64)
    return indices[flat], np.repeat(frontier, degs)


def dissect_indices_batched(method: str, counts: np.ndarray,
                            rank: np.ndarray, sizes: np.ndarray,
                            edges_i: np.ndarray, edges_j: np.ndarray
                            ) -> np.ndarray:
    """Dissect MANY clusters at once, lockstep-vectorized.

    ``counts``/``rank``: [M] over the concatenated members of C clusters
    (cluster members contiguous, cluster c spanning ``sizes`` prefix
    sums); ``edges_*``: within-cluster pairs in concatenated coordinates.
    Returns a bool kept-mask [M].

    Clusters are independent, so every round runs for all still-active
    clusters simultaneously: a segment-max picks each cluster's origin,
    and (for ``directional``) one global CSR frontier expansion per BFS
    level absorbs across every cluster at once.  Semantics are exactly
    :func:`dissect_indices` per cluster (shared property tests); the
    point is eliminating per-cluster Python overhead — at tens of
    millions of keys there are ~a million size-3..64 clusters, and a
    per-cluster loop costs minutes in setup alone.
    """
    m = len(counts)
    c = len(sizes)
    kept = np.zeros(m, dtype=bool)
    if m == 0:
        return kept
    cluster_of = np.repeat(np.arange(c, dtype=np.int64), sizes)
    seg_starts = np.zeros(c, dtype=np.int64)
    np.cumsum(sizes[:-1], out=seg_starts[1:])
    # Members ordered by (cluster, count, rank) ascending: each cluster's
    # current origin is its highest remaining position in this order.
    order = np.lexsort((rank, counts, cluster_of))
    src = np.concatenate([edges_i, edges_j])
    dst = np.concatenate([edges_j, edges_i])
    deg = np.bincount(src, minlength=m)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = dst[np.argsort(src, kind="stable")]

    remaining = np.ones(m, dtype=bool)
    positions = np.arange(m, dtype=np.int64)
    while True:
        vals = np.where(remaining[order], positions, -1)
        mx = np.maximum.reduceat(vals, seg_starts)
        active = np.flatnonzero(mx >= 0)
        if not len(active):
            return kept
        origins = order[mx[active]]
        kept[origins] = True
        remaining[origins] = False
        if method == "highest_count":
            return kept  # one representative per cluster, done
        if method == "adjacency":
            nbr, _ = _csr_expand(indptr, indices, origins)
            remaining[nbr] = False
            continue
        if method != "directional":
            raise ValueError(
                f"Unknown cluster dissection method: {method}")
        frontier = origins
        while len(frontier):
            nbr, parent = _csr_expand(indptr, indices, frontier)
            ok = remaining[nbr] & \
                (2 * counts[nbr] - 1 <= counts[parent])
            newly = np.unique(nbr[ok])
            remaining[newly] = False
            frontier = newly


def dissect_with_adjacency(method: str,
                           cluster: Sequence[Tuple[int, str]],
                           edges: Set[Tuple[int, int]]) -> List[str]:
    """Run a dissection method using a precomputed within-distance relation.

    ``edges`` holds unordered cluster-index pairs (i < j) that are within the
    distance threshold — exactly the pairs produced by the candidate +
    verification kernels, so no per-pair distance is ever recomputed here.
    """
    def oracle(i: int, j: int) -> bool:
        return (i, j) in edges if i < j else (j, i) in edges

    if method == "highest_count":
        return [max(cluster)[1]]
    if method == "adjacency":
        return [cluster[i][1] for i in _adjacency_rounds(cluster, oracle)]
    if method == "directional":
        return [cluster[i][1] for i in _directional_rounds(cluster, oracle)]
    raise ValueError(f"Unknown cluster dissection method: {method}")


def _method_name_for(func: ClusterDissectionFunc) -> Optional[str]:
    for name, known in CLUSTER_DISSECTION_METHODS.items():
        if func is known:
            return name
    return None


def _lexicographic_rank(rows: np.ndarray) -> np.ndarray:
    """int64 [m] ascending rank of the rows of a C-contiguous uint8
    matrix in memcmp order.  Threaded C sample sort when available (5-10x
    numpy's void argsort at millions of rows); the rows are distinct
    keys, so the order is total either way."""
    try:
        from .native.loader import rank_rows_native
        return rank_rows_native(rows)
    except (ImportError, ValueError):
        pass
    void = rows.view(np.dtype((np.void, rows.shape[1]))).ravel()
    rank = np.empty(len(rows), dtype=np.int64)
    rank[np.argsort(void, kind="stable")] = np.arange(len(rows),
                                                     dtype=np.int64)
    return rank


def _concat_spans(span_starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The indices of the spans ``[start, start + len)``, concatenated."""
    total = int(lens.sum())
    offs = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    return np.repeat(span_starts - offs, lens) + \
        np.arange(total, dtype=np.int64)


class _KeyTable:
    """Global key indices of a :class:`KeyGroups` as raw bytes, ranks and
    kept-mask entries."""

    def __init__(self, groups: "KeyGroups"):
        self.groups = groups
        # Single length group (the common case): key index == row index,
        # so the ~n-sized searchsorted map and per-call np.unique grouping
        # are skipped entirely — they are replicated on every host at P>1.
        self.single_group = len(groups.lengths) == 1
        self.group_of_key = None if self.single_group else np.searchsorted(
            groups.starts, np.arange(groups.n, dtype=np.int64),
            side="right") - 1
        self._row_maps: Dict[int, Dict[bytes, int]] = {}

    def member_bytes(self, members: np.ndarray) -> np.ndarray:
        """Raw key bytes of ``members`` as a zero-padded uint8 matrix —
        zero-padding makes row-wise lexicographic comparison match Python
        str order across mixed lengths (shorter prefix sorts first)."""
        groups = self.groups
        if self.single_group:
            length = groups.lengths[0]
            if not length:
                return np.zeros((len(members), 1), dtype=np.uint8)
            return groups.voids[0][members].view(np.uint8).reshape(
                len(members), length)
        g = self.group_of_key[members]
        rows = members - groups.starts[g]
        width = max(max((groups.lengths[int(gi)] for gi in np.unique(g)),
                        default=1), 1)
        padded = np.zeros((len(members), width), dtype=np.uint8)
        for gi in np.unique(g):
            length = groups.lengths[int(gi)]
            sel = np.flatnonzero(g == gi)
            if length:
                raw = groups.voids[int(gi)][rows[sel]].view(np.uint8)
                padded[sel, :length] = raw.reshape(len(sel), length)
        return padded

    def rank(self, members: np.ndarray) -> np.ndarray:
        """Ascending lexicographic rank of the members' key strings
        (Python str order across mixed lengths)."""
        return _lexicographic_rank(
            np.ascontiguousarray(self.member_bytes(members)))

    def mark(self, kept_mask: List[np.ndarray], idx: np.ndarray) -> None:
        if self.single_group:
            kept_mask[0][idx] = True
            return
        g = self.group_of_key[idx]
        rows = idx - self.groups.starts[g]
        for gi in np.unique(g):
            kept_mask[gi][rows[g == gi]] = True

    def index_of(self, key: bytes) -> Optional[int]:
        """Global index of ``key``, or None for a string that is no key.

        A user-supplied dissection strategy may yield a string that is not
        one of the cluster's keys; the reference tolerated that (unknown
        hashes simply never matched in pass 3, __init__.py:203-206), so
        unknown keys are skipped, not marked.  Lookup goes through a
        lazily built per-group dict (group order may be hash-based, so
        binary search does not apply); only custom strategies come here.
        """
        groups = self.groups
        g = groups.group_index_of_length(len(key))
        if g is None:
            logger.debug("dissection yielded unknown key of length "
                         f"{len(key)}; ignored")
            return None
        if len(key) == 0:
            return int(groups.starts[g]) if len(groups.counts[g]) else None
        rows_map = self._row_maps.get(g)
        if rows_map is None:
            raw = groups.voids[g].tobytes()
            length = groups.lengths[g]
            rows_map = {raw[i * length:(i + 1) * length]: i
                        for i in range(len(groups.counts[g]))}
            self._row_maps[g] = rows_map
        row = rows_map.get(key)
        if row is None:
            logger.debug("dissection yielded unknown key; ignored")
            return None
        return int(groups.starts[g]) + row


def _two_member_kept(method: str, part: "Partition", sizes: np.ndarray,
                     counts: np.ndarray, keys: _KeyTable, pid: int,
                     nproc: int) -> List[np.ndarray]:
    """Two-member components, closed form: connectivity implies the single
    within-distance edge exists, so adjacency/highest_count keep only the
    max (count, key); directional also keeps the minor read unless the
    count gate 2*c - 1 <= count(origin) absorbs it (reference
    __init__.py:84,99-101).  Count ties break on key bytes (== latin-1
    string order), fetched only when needed."""
    pair_starts = part.starts[sizes == 2][pid::nproc]
    a_idx = part.order[pair_starts]
    b_idx = part.order[pair_starts + 1]
    ca = counts[a_idx]
    cb = counts[b_idx]
    hi_idx = np.where(ca > cb, a_idx, b_idx)
    lo_idx = np.where(ca > cb, b_idx, a_idx)
    ties = np.flatnonzero(ca == cb)
    if len(ties):
        # Count ties are the COMMON case (two count-1 variants), so the
        # string tie-break is vectorized: first differing byte decides
        # (keys are distinct, so one always exists — for a strict-prefix
        # pair, edit mode only, the zero pad loses to any real byte,
        # matching Python str order).  One combined call so both sides
        # share the same pad width (edit-mode pairs can mix lengths).
        both = keys.member_bytes(np.concatenate([a_idx[ties], b_idx[ties]]))
        av = both[:len(ties)]
        bv = both[len(ties):]
        first = np.argmax(av != bv, axis=1)
        sel = np.arange(len(ties))
        swap = ties[av[sel, first] > bv[sel, first]]
        hi_idx[swap] = a_idx[swap]
        lo_idx[swap] = b_idx[swap]
    if method != "directional":
        return [hi_idx]
    return [hi_idx, lo_idx[2 * counts[lo_idx] - 1 > counts[hi_idx]]]


def _big_cluster_kept(method: Optional[str], part: "Partition",
                      big: np.ndarray, counts: np.ndarray, keys: _KeyTable,
                      pid: int, nproc: int,
                      oracle: Callable[[List[Tuple[int, str]]],
                                       Iterator[str]]
                      ) -> List[np.ndarray]:
    """Kept keys of the clusters ``big``: up to 64 members in one lockstep
    batch (built-in methods), the rest one by one — by CSR (built-in) or
    through ``oracle``, the user's strategy on (count, str) tuples."""
    kept: List[np.ndarray] = []
    with trace.span("dissect.batched"):
        # Group the edge list by cluster once (sort + searchsorted spans).
        edge_cluster = part.cluster_of[part.edges_i]
        edge_order = np.argsort(edge_cluster, kind="stable")
        sorted_ec = edge_cluster[edge_order]
        el_i = part.local_index[part.edges_i[edge_order]]
        el_j = part.local_index[part.edges_j[edge_order]]
        span_starts = np.searchsorted(sorted_ec, big)
        span_ends = np.searchsorted(sorted_ec, big + 1)
        big_sizes = part.ends[big] - part.starts[big]
        owned = np.arange(len(big)) % nproc == pid
        # Clusters up to 64 members dissect TOGETHER in one lockstep
        # vectorized pass (dissect_indices_batched): at production scale
        # there are ~a million of them and per-cluster Python setup alone
        # costs minutes.  Larger clusters use the per-cluster CSR path.
        batch_mask = owned & (big_sizes <= 64) if method is not None \
            else np.zeros(len(big), dtype=bool)
        bsel = np.flatnonzero(batch_mask)
        if len(bsel):
            lens = big_sizes[bsel]
            members = part.order[_concat_spans(part.starts[big[bsel]], lens)]
            elens = span_ends[bsel] - span_starts[bsel]
            epos = _concat_spans(span_starts[bsel], elens)
            moffs = np.zeros(len(lens), dtype=np.int64)
            np.cumsum(lens[:-1], out=moffs[1:])
            eoff = np.repeat(moffs, elens)
            kept_b = dissect_indices_batched(
                method, counts[members], keys.rank(members), lens,
                el_i[epos] + eoff, el_j[epos] + eoff)
            kept.append(members[kept_b])
    with trace.span("dissect.large"):
        chosen_keys: List[int] = []
        for k in np.flatnonzero(owned & ~batch_mask):
            c = big[k]
            es, ee = span_starts[k], span_ends[k]
            members = part.order[part.starts[c]:part.ends[c]]
            if method is not None:
                # Index-based vectorized dissection: no per-member Python
                # tuples, CSR BFS instead of list scans — giant clusters
                # (low-complexity libraries) stay near O(edges).
                kept.append(members[dissect_indices(
                    method, counts[members], keys.rank(members),
                    el_i[es:ee], el_j[es:ee])])
                continue
            cluster_list = [(int(counts[i]),
                             keys.groups.key_bytes(int(i)).decode("latin-1"))
                            for i in members]
            # dict.fromkeys: tolerate a custom strategy yielding repeats.
            for string in dict.fromkeys(oracle(cluster_list)):
                index = keys.index_of(string.encode("latin-1"))
                if index is not None:
                    chosen_keys.append(index)
        if chosen_keys:
            kept.append(np.asarray(chosen_keys, dtype=np.int64))
    return kept


@trace.spanned("pass2.dissect")
def dissect_partition(groups: "KeyGroups", part: "Partition",
                      cluster_dissection_func: ClusterDissectionFunc,
                      max_distance: int, use_edit_distance: bool,
                      shard: Tuple[int, int] = (0, 1),
                      gather: Optional[Callable[[np.ndarray],
                                                np.ndarray]] = None
                      ) -> List[np.ndarray]:
    """The kept keys of every cluster of ``part``, as one boolean mask
    per length group of ``groups`` (clusters are disjoint, so each key is
    decided exactly once); pass 3 emits the first occurrences of the
    marked keys.

    Singletons are kept wholesale.  A built-in method takes two-member
    clusters in closed form, clusters of 3-64 members in one lockstep
    batch and larger ones one by one over a CSR adjacency; a
    user-supplied ``cluster_dissection_func`` sees every cluster of two
    or more as the reference's ``(count, str)`` list.

    ``shard=(pid, nproc)``: a built-in method dissects only every
    ``nproc``-th cluster of two or more from ``pid`` on, and ``gather``
    (for instance an all-gather across processes) turns this shard's
    kept key indices into every shard's before they are marked.  A
    user-supplied strategy ignores ``shard``: it runs on every cluster
    wherever it is called (determinism is its documented contract).
    """
    keys = _KeyTable(groups)
    kept_mask = [np.zeros(len(c), dtype=bool) for c in groups.counts]
    sizes = part.sizes()
    with trace.span("dissect.singletons"):
        if keys.single_group and len(part.cluster_of) == groups.n:
            # Vectorized: key row i is a singleton iff its cluster has one
            # member — a sequential gather+compare instead of a ~n-sized
            # random scatter (this mark is inherently global on every
            # host).
            np.logical_or(kept_mask[0], sizes[part.cluster_of] == 1,
                          out=kept_mask[0])
        else:
            keys.mark(kept_mask, part.order[part.starts[sizes == 1]])
    method = _method_name_for(cluster_dissection_func)
    pid, nproc = shard if method is not None else (0, 1)
    counts = groups.counts_concat()
    kept: List[np.ndarray] = []
    if method is not None:
        with trace.span("dissect.two_member"):
            kept += _two_member_kept(method, part, sizes, counts, keys, pid,
                                     nproc)
        big = np.flatnonzero(sizes >= 3)
    else:
        big = np.flatnonzero(sizes >= 2)
    if len(big):
        kept += _big_cluster_kept(
            method, part, big, counts, keys, pid, nproc,
            lambda cluster: cluster_dissection_func(
                cluster, max_distance, use_edit_distance))
    idx = np.concatenate(kept) if kept else np.empty(0, dtype=np.int64)
    if gather is not None:
        idx = gather(idx)
    if len(idx):
        keys.mark(kept_mask, idx)
    return kept_mask
