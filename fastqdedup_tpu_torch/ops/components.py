"""Connected components over the within-distance pair graph.

The reference's ``Trie.pop_cluster`` (_triemodule.c:778-897) extracts one
connected component of the "within distance d" relation per call via a BFS of
trie walks.  Here the whole partition is computed at once:

* :func:`connected_components_host` — weighted-ish union-find with path
  halving over the edge list (numpy-backed, O(E alpha(N))).  Used by the
  single-host pipeline where edge lists are sparse.
* :func:`connected_components_device` — min-label propagation with
  pointer doubling in torch ops on a device; the per-shard step of the
  labels across several devices (parallel/sharded.py).
"""

import numpy as np
import torch


def connected_components_host(n: int, pairs_i: np.ndarray,
                              pairs_j: np.ndarray) -> np.ndarray:
    """Component label (smallest member index) per node, int64 [n].

    Native C union-find (path halving, min-index roots; ~100M edges/s,
    GIL-free) when the native library is available; otherwise vectorized
    min-label propagation with pointer doubling — each sweep is a
    handful of O(E)/O(N) numpy ops, O(log N) sweeps.
    """
    labels = np.arange(n, dtype=np.int64)
    if not len(pairs_i):
        return labels
    try:
        from ..native.loader import union_find_native
        return union_find_native(n, pairs_i, pairs_j)
    except ImportError:
        pass
    while True:
        prev = labels
        m = labels.copy()
        np.minimum.at(m, pairs_i, labels[pairs_j])
        np.minimum.at(m, pairs_j, labels[pairs_i])
        # Pointer doubling: chase labels toward the component minimum.
        m = m[m]
        m = m[m]
        if np.array_equal(m, prev):
            return m
        labels = m


def relax_edges(labels: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
    """One hooking step: every edge endpoint takes the smaller label of
    its edge (``labels.at[src].min(m).at[dst].min(m)`` in the JAX
    package).  ``src``/``dst`` are int64 on ``labels``' device."""
    m = torch.minimum(labels[src], labels[dst])
    return labels.scatter_reduce(0, src, m, "amin").scatter_reduce_(
        0, dst, m, "amin")


def connected_components_device(edges: torch.Tensor, edge_mask: torch.Tensor,
                                num_nodes: int) -> torch.Tensor:
    """Min-label propagation over a padded edge list.

    ``edges``: int [E, 2]; ``edge_mask``: bool [E] (False rows ignored).
    Returns int32 labels [num_nodes] on ``edges``' device, each label the
    smallest node index in its component: scatter-min edge relaxation
    alternating with two pointer-doubling hops until no label changes,
    O(log N) rounds.  Masked rows become self-loops on the last node,
    which change nothing.
    """
    dev = edges.device
    last = torch.tensor(num_nodes - 1, dtype=torch.int64, device=dev)
    src = torch.where(edge_mask, edges[:, 0].long(), last)
    dst = torch.where(edge_mask, edges[:, 1].long(), last)
    labels = torch.arange(num_nodes, dtype=torch.int64, device=dev)
    while True:
        new = relax_edges(labels, src, dst)
        # Pointer doubling: label[i] <- label[label[i]] (idempotent chase).
        new = new[new]
        new = new[new]
        if torch.equal(new, labels):
            return new.to(torch.int32)
        labels = new
