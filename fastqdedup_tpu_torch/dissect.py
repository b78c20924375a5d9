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
distance oracle per pair, exactly like the reference API.  The pipeline uses
:func:`dissect_with_adjacency` instead, which consumes a precomputed
adjacency (from the TPU pairwise kernels) and never computes distances.

Key order-independence fact exploited here: the reference's directional
absorption loop (append-while-iterating BFS, __init__.py:78-90) absorbs
exactly the set of reads *reachable* from the origin through directed edges
``u -> v`` with ``2*count(v) - 1 <= count(u)`` and ``dist(u, v) <= d`` among
the reads remaining in that round, so any BFS order yields the same set.
"""

from typing import Callable, Dict, Iterator, List, Sequence, Set, Tuple

import numpy as np

from .distance import within_distance

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
