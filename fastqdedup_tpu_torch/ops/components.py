"""Connected components over the within-distance pair graph.

The reference's ``Trie.pop_cluster`` (_triemodule.c:778-897) extracts one
connected component of the "within distance d" relation per call via a BFS of
trie walks.  Here the whole partition is computed at once:

* :func:`connected_components_host` — weighted-ish union-find with path
  halving over the edge list (numpy-backed, O(E alpha(N))).  Used by the
  single-host pipeline where edge lists are sparse.

The device label propagation (``connected_components_device`` in the JAX
package), which serves labels across several devices, is not ported yet.
"""

import numpy as np


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
