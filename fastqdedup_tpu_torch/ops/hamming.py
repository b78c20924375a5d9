"""Batched / all-pairs Hamming distance on the device.

Counterpart of ``fastqdedup_tpu/ops/hamming.py``:

* plain torch ops (:func:`pairwise_hamming`, :func:`pairwise_within`,
  :func:`rowwise_within`) for small one-off comparisons;
* :func:`neighbor_pairs` — the 2048-row tile sweep over the all-pairs
  kernel (:func:`.hamming_kernels.within_tile_packed`);
* :func:`verify_pairs` — candidate-pair verification over the rowwise
  nibble-packed kernel (:func:`.hamming_kernels.rowwise_within_packed`).

Inputs are numpy arrays (the engine's key tables); the device is
``runtime.device()``.  Only packed bitmaps come back to the host, where
``np.nonzero`` extracts pairs.
"""

from typing import List, Tuple

import numpy as np
import torch

from ..runtime import device
from .encode import pack_nibbles
from .hamming_kernels import (
    ROW_BLOCK,
    match_counts_plain,
    rowwise_within_packed,
    within_tile_packed,
)


def _match_counts(a: torch.Tensor, b: torch.Tensor, alphabet_size: int
                  ) -> torch.Tensor:
    """int32 [N, M] pairwise match counts between index matrices a [N, L]
    and b [M, L] (one-hot product, see ``match_counts_plain``)."""
    return match_counts_plain(a[None], b[None], alphabet_size)[0].to(
        torch.int32)


def pairwise_hamming(a: torch.Tensor, b: torch.Tensor, alphabet_size: int
                     ) -> torch.Tensor:
    """int32 [N, M] Hamming distances between equal-length index rows."""
    return a.shape[1] - _match_counts(a, b, alphabet_size)


def pairwise_within(a: torch.Tensor, b: torch.Tensor, alphabet_size: int,
                    max_distance: int) -> torch.Tensor:
    """bool [N, M]: Hamming(a_i, b_j) <= max_distance."""
    return pairwise_hamming(a, b, alphabet_size) <= max_distance


def rowwise_within(a: torch.Tensor, b: torch.Tensor, alphabet_size: int,
                   max_distance: int) -> torch.Tensor:
    """bool [N]: Hamming(a_i, b_i) <= max_distance (paired rows)."""
    del alphabet_size
    mismatches = (a != b).sum(dim=1, dtype=torch.int32)
    return mismatches <= max_distance


def _pad_rows(matrix: np.ndarray, target: int) -> np.ndarray:
    if matrix.shape[0] == target:
        return matrix
    # 0xFF matches nothing, so padding rows stay out of the pair list.
    pad = np.full((target - matrix.shape[0], matrix.shape[1]), 0xFF,
                  dtype=matrix.dtype)
    return np.concatenate([matrix, pad], axis=0)


def unpack_within(packed: torch.Tensor) -> np.ndarray:
    """Host-side expansion of a bitpacked tile to bool [N, M]."""
    arr = packed.cpu().numpy()
    return np.unpackbits(arr, axis=1, bitorder="little").astype(bool)


def within_tile_kernel(a: torch.Tensor, b: torch.Tensor, alphabet_size: int,
                       max_distance: int) -> np.ndarray:
    """bool [N, M] all-pairs within-distance: the all-pairs kernel's
    packed tile, unpacked on the host (the unpacked convenience API of
    the JAX package's ``pallas_hamming.within_tile_kernel``)."""
    return unpack_within(within_tile_packed(a, b, alphabet_size,
                                            max_distance))


def neighbor_pairs(matrix: np.ndarray, alphabet_size: int, max_distance: int,
                   tile: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """All index pairs (i < j) of rows of ``matrix`` within ``max_distance``.

    Tiles the [N, N] upper triangle; each tile runs on the device and only
    a packed bitmap tile returns to the host, where ``np.nonzero``
    extracts pairs.  Returns two int64 arrays (rows_i, rows_j).
    """
    n = matrix.shape[0]
    if n < 2:
        return (np.empty(0, dtype=np.int64),) * 2
    dev = device()
    out_i: List[np.ndarray] = []
    out_j: List[np.ndarray] = []
    for i0 in range(0, n, tile):
        a = torch.from_numpy(
            np.ascontiguousarray(_pad_rows(matrix[i0:i0 + tile], tile))
        ).to(dev)
        for j0 in range(i0, n, tile):
            b = torch.from_numpy(
                np.ascontiguousarray(_pad_rows(matrix[j0:j0 + tile], tile))
            ).to(dev)
            within = unpack_within(
                within_tile_packed(a, b, alphabet_size, max_distance))
            ii, jj = np.nonzero(within)
            ii = ii + i0
            jj = jj + j0
            keep = (ii < jj) & (ii < n) & (jj < n)
            out_i.append(ii[keep])
            out_j.append(jj[keep])
    return (np.concatenate(out_i).astype(np.int64),
            np.concatenate(out_j).astype(np.int64))


def verify_pairs(matrix: np.ndarray, pairs_i: np.ndarray,
                 pairs_j: np.ndarray, alphabet_size: int, max_distance: int,
                 batch: int = 1 << 20) -> np.ndarray:
    """bool mask over candidate pairs: full Hamming <= max_distance.

    Used after pigeonhole bucketing to verify candidates.  When the
    alphabet fits in 4 bits the rowwise kernel runs over nibble-packed
    lanes (8 symbols per 32-bit lane); otherwise a torch elementwise
    compare.
    """
    dev = device()
    out = np.empty(len(pairs_i), dtype=bool)
    for start in range(0, len(pairs_i), batch):
        sl = slice(start, start + batch)
        a = matrix[pairs_i[sl]]
        b = matrix[pairs_j[sl]]
        if alphabet_size <= 16:
            lanes = max(-(-matrix.shape[1] // 8), 1)
            p = len(a)
            padded = -(-max(p, 1) // ROW_BLOCK) * ROW_BLOCK
            pa = np.zeros((padded, lanes), dtype=np.uint32)
            pb = np.zeros((padded, lanes), dtype=np.uint32)
            pa[:p] = pack_nibbles(a, lanes)
            pb[:p] = pack_nibbles(b, lanes)
            within = rowwise_within_packed(
                torch.from_numpy(pa.view(np.int32)).to(dev),
                torch.from_numpy(pb.view(np.int32)).to(dev), max_distance)
            out[sl] = within[:p, 0].cpu().numpy()
        else:
            out[sl] = rowwise_within(
                torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
                alphabet_size, max_distance).cpu().numpy()
    return out
