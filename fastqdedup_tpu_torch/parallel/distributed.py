"""Process shape and bucket ownership: the single-process subset.

The port runs one process on one device.  Multi-host ingest, key-table
exchange and edge all-gathers (the rest of this module in the JAX
package) are not ported yet, so :func:`process_shape` refuses a job of
more than one process instead of silently computing a partial result.
"""

from typing import Tuple

import numpy as np


def process_shape() -> Tuple[int, int]:
    """(process_id, process_count); (0, 1) unless ``torch.distributed``
    is initialised.  Raises NotImplementedError for more than one
    process: the multi-process exchanges are not ported yet."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    nproc = dist.get_world_size()
    if nproc > 1:
        raise NotImplementedError(
            f"multi-process runs ({nproc} processes) are not ported to "
            f"fastqdedup_tpu_torch yet")
    return dist.get_rank(), nproc


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized (stable across hosts/runs)."""
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


def bucket_owner_mask(bucket_ids: np.ndarray, salt: int,
                      process_id: int, num_processes: int) -> np.ndarray:
    """bool mask: which buckets this host computes pairs for.

    ``bucket_ids`` are per-segment bucket CONTENT hashes (identical on
    every host because they are functions of key bytes alone), so a
    salted integer mix gives a stable, balanced partition with zero
    communication — and because every member row of a bucket shares the
    hash, ownership is decidable per row before any grouping happens.
    Buckets are the unit of distribution — a bucket's pairs never cross
    hosts (SURVEY.md §7 step 9).
    """
    if num_processes <= 1:
        return np.ones(len(bucket_ids), dtype=bool)
    salt_mix = np.uint64((0x9E3779B97F4A7C15 * (salt + 1)) & (2 ** 64 - 1))
    mixed = _mix64(bucket_ids.astype(np.uint64) ^ salt_mix)
    return (mixed % np.uint64(num_processes)) == np.uint64(process_id)
