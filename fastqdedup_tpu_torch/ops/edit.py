"""Batched bounded Levenshtein (edit) distance on the device.

Counterpart of ``fastqdedup_tpu/ops/edit.py``.  Replaces the reference's
recursive branch-and-bound (distances.h:33-88) with a vectorised dynamic
program: one DP row of length L2+1 is carried through a loop over the
rows of the edit matrix, vectorised across a batch of string pairs.
Variable lengths are handled by capturing the row value at ``(len_a,
len_b)`` as the loop passes ``len_a``.

Candidate verification on the card goes through the banded kernel
(:mod:`.edit_kernels`): :func:`edit_verify_indexed` gathers rows from a
resident key matrix inside the kernel.  The JAX package's padding of the
pair count and width to canonical geometries (shared TPU compiles) has
no counterpart here: the CUDA kernel takes any P and any width.  Its
nibble-packed key matrix has: :func:`pack_nibble_rows` halves the matrix
on the host and ``edit_verify_indexed(..., packed=True)`` gathers and
unpacks each batch's rows with torch ops before the kernel's paired
entry, as the JAX package unpacks in XLA code outside its Pallas kernel.
Whether the engine ships the packed form is its own decision
(``engine.PACK_KEY_MATRIX``).

Semantics pinned by the reference's truth table (e.g. lev("GC", "AAAGC")
== 3, lev("ABCDE", "ABDEF") == 2).
"""

import numpy as np
import torch

from ..runtime import device
from .edit_kernels import (
    banded_within_edit_distance,
    banded_within_edit_distance_indexed,
)

# Candidate pairs per verification batch (the engine's loop).
EDIT_VERIFY_BATCH = 1 << 16


def batched_edit_distance(a: torch.Tensor, len_a: torch.Tensor,
                          b: torch.Tensor, len_b: torch.Tensor
                          ) -> torch.Tensor:
    """int32 [P] Levenshtein distances between padded index-row pairs.

    ``a``: [P, L1] uint8/int32 alphabet indices, valid prefix ``len_a``.
    ``b``: [P, L2] likewise.  Padding values are ignored.
    """
    p, l1 = a.shape
    l2 = b.shape[1]
    dev = a.device
    len_a = len_a.to(device=dev, dtype=torch.int32)
    len_b = len_b.to(device=dev, dtype=torch.int64)
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    js = torch.arange(l2 + 1, dtype=torch.int32, device=dev)  # [L2+1]
    row = js.expand(p, l2 + 1)  # dp[0, j] = j
    # Answer for len_a == 0 is len_b.
    result = torch.where(len_a == 0, len_b.to(torch.int32),
                         torch.zeros_like(len_a))
    # The JAX gather clamps an index past the row to its last element.
    at_lb = len_b.clamp(0, l2).unsqueeze(1)
    for i in range(1, l1 + 1):
        # Row i: dp[i, 0] = i.
        eq = a[:, i - 1:i] == b  # [P, L2]
        sub = row[:, :-1] + (~eq).to(torch.int32)  # substitution / match
        delete = row[:, 1:] + 1                    # remove from a
        best_nolateral = torch.minimum(sub, delete)  # [P, L2]
        # Insertion (dp[i, j-1] + 1) creates a left-to-right dependence;
        # resolve it with a prefix-min over j:
        #   dp[i, j] = min_k ( cand[k] + (j - k) )  for k <= j
        # where cand[j] = min(sub, delete) and cand[0] = i.
        cand = torch.cat(
            [torch.full((p, 1), i, dtype=torch.int32, device=dev),
             best_nolateral], dim=1)
        running = torch.cummin(cand - js, dim=1).values
        row = running + js
        result = torch.where(len_a == i, row.gather(1, at_lb).squeeze(1),
                             result)
    return result


def batched_within_edit_distance(a: torch.Tensor, len_a: torch.Tensor,
                                 b: torch.Tensor, len_b: torch.Tensor,
                                 max_distance: int) -> torch.Tensor:
    """bool [P]: lev(a_i, b_i) <= max_distance."""
    return batched_edit_distance(a, len_a, b, len_b) <= max_distance


def pack_nibble_rows(padded: np.ndarray) -> np.ndarray:
    """uint8 [n, L] -> [n, L/2] with two values per byte (L even), the
    even column in the high nibble.

    Valid only when every value fits 4 bits; the 0xFF padding byte maps
    to 15 first (pad positions are never read by the DP: the scan stops
    at len_a / len_b)."""
    nib = np.where(padded == 0xFF, np.uint8(15), padded)
    return ((nib[:, ::2] << 4) | nib[:, 1::2]).astype(np.uint8)


def _edit_verify_gathered_packed(keys2: torch.Tensor, lens: torch.Tensor,
                                 ci: torch.Tensor, cj: torch.Tensor,
                                 max_distance: int) -> torch.Tensor:
    """bool [P, 1]: the nibble-packed variant of the indexed verify.
    ``keys2`` [n, Lp/2] holds two alphabet indices per byte (even column
    in the high nibble); the rows of each batch are gathered, unpacked
    (one shift, one mask, one stack) and handed to the kernel's paired
    entry."""

    def unpack(index: torch.Tensor) -> torch.Tensor:
        g = keys2.index_select(0, index)
        pair = torch.stack([g >> 4, g & 0xF], dim=-1)
        return pair.reshape(g.shape[0], g.shape[1] * 2)

    return banded_within_edit_distance(
        unpack(ci), lens.index_select(0, ci), unpack(cj),
        lens.index_select(0, cj), max_distance)


def edit_verify_indexed(keys_dev: torch.Tensor, lens_dev: torch.Tensor,
                        cand_i: np.ndarray, cand_j: np.ndarray,
                        max_distance: int, packed: bool = False
                        ) -> np.ndarray:
    """bool [P]: lev(keys[i], keys[j]) <= d for index pairs.

    ``keys_dev`` [n, Lp] uint8 and ``lens_dev`` [n] int32 stay resident on
    the device; each batch sends its index pairs (8 bytes a pair, int64
    cut to int32 once here) and the kernel gathers the rows itself.
    With ``packed``, ``keys_dev`` is the [n, Lp/2] matrix of
    :func:`pack_nibble_rows` and the rows are gathered and unpacked by
    torch ops before the kernel (:func:`_edit_verify_gathered_packed`)."""
    p = len(cand_i)
    if p == 0:
        return np.empty(0, dtype=bool)
    n = keys_dev.shape[0]
    if n >= 1 << 31:
        raise OverflowError(f"{n} keys do not fit int32 row indices")
    lo = min(int(cand_i.min()), int(cand_j.min()))
    hi = max(int(cand_i.max()), int(cand_j.max()))
    if lo < 0 or hi >= n:
        raise IndexError(f"candidate index out of range [0, {n}): "
                         f"{lo}..{hi}")
    dev = keys_dev.device
    ci = torch.from_numpy(np.asarray(cand_i, dtype=np.int32)).to(dev)
    cj = torch.from_numpy(np.asarray(cand_j, dtype=np.int32)).to(dev)
    fn = _edit_verify_gathered_packed if packed \
        else banded_within_edit_distance_indexed
    out = fn(keys_dev, lens_dev, ci, cj, max_distance)
    return out[:, 0].cpu().numpy()


def within_edit_distance_auto(a: np.ndarray, len_a: np.ndarray,
                              b: np.ndarray, len_b: np.ndarray,
                              max_distance: int) -> np.ndarray:
    """bool [P]: the banded kernel on a CUDA device, the full-row DP on
    the CPU (``runtime.device()``).

    ``a`` and ``b``: uint8 [P, L] of one width (the callers pad both
    sides to one max length); on the card anything else raises in the
    kernel's wrapper."""
    dev = device()
    ta = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    tb = torch.from_numpy(np.ascontiguousarray(b)).to(dev)
    la = torch.from_numpy(np.asarray(len_a, dtype=np.int32)).to(dev)
    lb = torch.from_numpy(np.asarray(len_b, dtype=np.int32)).to(dev)
    if dev.type == "cuda":
        out = banded_within_edit_distance(ta, la, tb, lb, max_distance)
        return out[:, 0].cpu().numpy()
    return batched_within_edit_distance(ta, la, tb, lb,
                                        max_distance).numpy()
