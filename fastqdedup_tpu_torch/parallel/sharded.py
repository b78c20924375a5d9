"""Component labels across several devices — sparse.

Counterpart of ``fastqdedup_tpu/parallel/sharded.py``.  Pair generation
(pigeonhole buckets -> the bucket kernel, ops/bucket.py) already spreads
across local devices by round-robining bucket batches; this module
supplies the CLUSTERING stage over the resulting sparse edge list:

* :func:`sharded_components_from_edges` — connected-component labels by
  min-label propagation with pointer doubling.  Edges shard row-wise
  over a mesh (a list of devices); every shard relaxes its edges against
  its copy of the labels, the per-shard labels combine each round by an
  element-wise minimum on the first device (the JAX package's ``pmin``),
  and the result goes back to every shard.  Memory is O(N + E/D) per
  device — no dense adjacency anywhere.
* :func:`sharded_dedup_step` — the composed multi-device dedup step:
  bucket-kernel pair generation -> sparse label propagation ->
  highest-count representative selection, i.e. exactly the production
  algorithm.

A mesh may name one device several times: the shards then run one after
another on it, with the same arithmetic.  The engine routes clustering
through :func:`components_on_mesh` when more than one local device is
attached (``runtime.local_device_count``); the host union-find remains
the single-device path.
"""

import logging
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.components import relax_edges

logger = logging.getLogger("fastqdedup")

# Observability for the engine's mesh routing: incremented on every
# successful sharded_components_from_edges call through
# components_on_mesh, so tests can assert the mesh path was actually
# taken (a silent fallback must not ship green).
MESH_COMPONENT_RUNS = 0


def _require_mesh() -> bool:
    """FASTQDEDUP_REQUIRE_MESH=1 turns any mesh fallback into an error.

    Set where the mesh path is expected to carry the clustering pass;
    production leaves it unset so a device failure degrades to the
    (identical-output) host union-find — loudly, via a warning log.
    """
    return os.environ.get("FASTQDEDUP_REQUIRE_MESH", "0") == "1"


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """A 1-D mesh of ``n_devices`` shards (default: the local device
    count) over the process's local devices, dealt round-robin — so a
    mesh wider than the devices puts several shards on one device."""
    from ..runtime import local_device_count, local_devices

    devices = local_devices()
    if n_devices is None:
        n_devices = local_device_count()
    return [devices[i % len(devices)] for i in range(n_devices)]


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _components_on(mesh: List[torch.device], ei: np.ndarray,
                   ej: np.ndarray, n_pad: int) -> torch.Tensor:
    """int64 [n_pad] labels on ``mesh[0]``; ``ei``/``ej`` are padded to a
    multiple of the mesh size and split into equal row-wise slabs."""
    per = len(ei) // len(mesh)
    slabs = [(torch.from_numpy(ei[k * per:(k + 1) * per]).to(dev),
              torch.from_numpy(ej[k * per:(k + 1) * per]).to(dev))
             for k, dev in enumerate(mesh)]
    home = mesh[0]
    labels = torch.arange(n_pad, dtype=torch.int64, device=home)
    while True:
        # Each round: local scatter-min over every shard's edges, an
        # element-wise minimum to combine the shards, then two pointer-
        # doubling hops so long chains converge in O(log N) rounds.
        per_shard = [relax_edges(labels.to(dev), src, dst).to(home)
                     for (src, dst), dev in zip(slabs, mesh)]
        new = torch.stack(per_shard).amin(dim=0)
        new = new[new]
        new = new[new]
        if torch.equal(new, labels):
            return new
        labels = new


def sharded_components_from_edges(n: int, edges_i: np.ndarray,
                                  edges_j: np.ndarray,
                                  mesh: Optional[List[torch.device]] = None
                                  ) -> np.ndarray:
    """int64 [n] min-index component labels over a sparse edge list.

    Output contract matches ops.components.connected_components_host: each
    key's label is the smallest key index in its component.  Shapes pad to
    powers of two, as in the JAX package.
    """
    if mesh is None:
        mesh = make_mesh()
    d = len(mesh)
    n_pad = _pow2_at_least(max(n, 2))
    e_pad = _round_up(_pow2_at_least(max(len(edges_i), 1)), d)
    # Self-loops on a padding node are no-ops under scatter-min.
    ei = np.full(e_pad, n_pad - 1, dtype=np.int64)
    ej = np.full(e_pad, n_pad - 1, dtype=np.int64)
    ei[:len(edges_i)] = edges_i
    ej[:len(edges_j)] = edges_j
    labels = _components_on(mesh, ei, ej, n_pad)
    return labels[:n].cpu().numpy()


def components_on_mesh(n: int, edges_i: np.ndarray, edges_j: np.ndarray
                       ) -> Optional[np.ndarray]:
    """Device component labels when >1 local device is attached, else None.

    The engine calls this before falling back to the host union-find; a
    single device gains nothing from device clustering, but a host with
    several cards keeps the whole pass on the mesh.
    """
    global MESH_COMPONENT_RUNS
    from ..runtime import local_device_count

    count = local_device_count()
    if count <= 1 or n < 2:
        if _require_mesh():
            raise RuntimeError(
                "FASTQDEDUP_REQUIRE_MESH=1 but no multi-device mesh is "
                f"available (local_device_count={count}, n={n})")
        return None
    try:
        labels = sharded_components_from_edges(n, edges_i, edges_j)
    except Exception as exc:
        # A device or transfer failure must not ship silently: log the
        # degradation every time, and raise when the env demands the mesh.
        if _require_mesh():
            raise
        logger.warning(
            "device-mesh clustering failed (%s: %s) — falling back to "
            "host union-find; set FASTQDEDUP_REQUIRE_MESH=1 to make this "
            "fatal", type(exc).__name__, exc)
        return None
    MESH_COMPONENT_RUNS += 1
    return labels


def _representative_pick(labels: torch.Tensor, counts: torch.Tensor,
                         rank: torch.Tensor) -> torch.Tensor:
    """bool [N]: one representative per component — highest count, ties
    broken toward the highest rank (callers pass lexicographic rank,
    reproducing the reference's descending (count, string) sort,
    __init__.py:99-101)."""
    n = labels.shape[0]
    labels = labels.long()
    counts = counts.to(torch.int32)
    rank = rank.to(torch.int32)
    max_count = torch.zeros(n, dtype=torch.int32, device=labels.device) \
        .scatter_reduce(0, labels, counts, "amax")
    is_max = counts == max_count[labels]
    best_rank = torch.full((n,), -1, dtype=torch.int32,
                           device=labels.device).scatter_reduce(
        0, labels, torch.where(is_max, rank, -1), "amax")
    return is_max & (rank == best_rank[labels])


def sharded_dedup_step(matrix: np.ndarray, counts: np.ndarray,
                       rank: np.ndarray, alphabet_size: int,
                       max_distance: int,
                       mesh: Optional[List[torch.device]] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Full multi-device dedup step: cluster labels + highest-count
    representatives for a batch of equal-length encoded keys.

    Composition IS the production pipeline's: pigeonhole bucket kernels
    generate the sparse pair list (batches round-robin across the local
    devices, ops/bucket.py), min-label propagation runs sharded over the
    mesh, and the representative pick is one scatter step on the mesh's
    first device.
    """
    from ..ops.bucket import hamming_neighbor_pairs_bucketed

    if mesh is None:
        mesh = make_mesh()
    n = matrix.shape[0]
    ei, ej = hamming_neighbor_pairs_bucketed(
        matrix, alphabet_size, max_distance)
    labels = sharded_components_from_edges(n, ei, ej, mesh)
    home = mesh[0]
    keep = _representative_pick(
        torch.from_numpy(labels).to(home),
        torch.from_numpy(np.asarray(counts)).to(home),
        torch.from_numpy(np.asarray(rank)).to(home))
    return labels, keep.cpu().numpy()
