"""Hand-written Hopper kernels that join the ``--edit`` route's window
rows on the card, with their plain PyTorch versions and launch counter.

They replace no TPU kernel: the JAX package joins the windows on the host
(``fastqdedup_tpu/ops/bucket.py``, ``edit_candidate_pairs``), as the
port's host join does (:func:`.bucket.host_edit_join`).  They were added
because that join, a radix sort of one composite value a window row, took
a third of a 2M-read ``--edit`` job on the host while the card, which
already holds the key matrix for verification, was idle.  The CUDA source
is ``csrc/edit_candidates.cu``; the note at its top says what bounds the
kernels on the H100 (bytes) and what the design does about it.

Both joins take the windows from :func:`.bucket.edit_window_plan` and
share nothing else.  :func:`join_codes` runs these steps on the device
the key matrix lies on, each a kernel on the card and its plain version
on the CPU:

1. :func:`window_hash` — one row a key of each spec: the weak hash of
   ``bucket._hash_window_rows(..., strong=False)`` over the window of the
   key's row of the key matrix, plain or nibble-packed
   (``engine.PACK_KEY_MATRIX``) (the spec's seed, 8-byte little-endian
   words with the last zero-extended, multiply and shift-xor, the final
   mix), bit for bit, and the composite ``hash & ~(2^(b+1) - 1) | side <<
   b | id`` of the host's composite branch (``b = plan.gid_bits``), its
   top bit flipped so that a signed sort orders it as unsigned.  Under
   ``shard=(pid, nproc)`` a row is kept where ``mix(hash ^
   EDIT_OWN_SALT) % nproc == pid``, as on the host; any other row holds
   the largest value and the kept rows are counted.
2. :func:`sort_values` — the composites in ascending order
   (``torch.sort``: the JAX package has no kernel here, and a
   hand-written radix sort of the bits above the id was slower on the
   H100, 0.568 ms against 0.444 at 2.5M rows).
3. :func:`join_count` — each kept row's pair count: a probe (side 0)
   pairs with every later row of its run (the same ``hash >> (b + 1)``)
   whose id differs.
4. The inclusive scan of the counts (``torch.cumsum``), then
   :func:`join_write` — the pair codes ``min(i, j) * 2^31 + max(i, j)``,
   row after row in the scan's places.
5. :func:`unique_codes` — sorted and unique; they come back to the host
   in one pinned copy (:mod:`.transfer`).

The same rows, runs and probe-left enumeration as the host's composite
branch, so the codes equal what :func:`.bucket.host_edit_join` returns
from that branch, false candidates of merged runs included.  A wrapper
given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises, never falling back.
"""

from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import trace
from .bucket import EDIT_OWN_SALT, EditPlan, window_seed
from .kernel_lib import (
    check_cuda,
    check_status,
    count_launch,
    in_warmup,
    library,
)
from .transfer import host_array, staging, start_host_copy, upload

LAUNCHES: Dict[str, int] = {"edit_window_hash": 0, "edit_join_count": 0,
                            "edit_join_write": 0}

# int64 words of a spec: first row, first id (in the id list), rows,
# window start, width, side, seed, unused.
SPEC_WORDS = 8
_TOP = -(1 << 63)  # the flipped bit, as an int64


def _signed(value: int) -> int:
    """A 64-bit pattern as the int64 with the same bits."""
    return value - (1 << 64) if value >= 1 << 63 else value


_M1 = _signed(0xFF51AFD7ED558CCD)
_M2 = _signed(0xC4CEB9FE1A85EC53)
_M3 = _signed(0x2545F4914F6CDD1D)


def reset_launches() -> None:
    """Set every count in ``LAUNCHES`` to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fits(plan: EditPlan) -> bool:
    """Whether the composite holds the plan's ids: the host's condition
    for its composite branch (``gid_bits + 1 <= 30``)."""
    return plan.gid_bits + 1 <= 30


def spec_table(plan: EditPlan) -> Tuple[np.ndarray, np.ndarray]:
    """(int64 [S, SPEC_WORDS] specs, int32 ids): each length group's key
    ids once, in the order of the specs' first use, and each spec's rows
    in the order of ``plan.specs``."""
    specs = np.zeros((len(plan.specs), SPEC_WORDS), dtype=np.int64)
    first_id: Dict[int, int] = {}
    groups = []
    row = 0
    n_ids = 0
    for s, spec in enumerate(plan.specs):
        key = id(spec.gidx)
        if key not in first_id:
            first_id[key] = n_ids
            groups.append(spec.gidx)
            n_ids += len(spec.gidx)
        specs[s] = (row, first_id[key], len(spec.gidx), spec.w_start,
                    spec.width, spec.side, _signed(window_seed(spec.salt)),
                    0)
        row += len(spec.gidx)
    ids = np.empty(n_ids, dtype=np.int32)
    at = 0
    for gidx in groups:
        ids[at:at + len(gidx)] = gidx
        at += len(gidx)
    return specs, ids


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix_plain(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _lsr(h, 33)
    h = h * _M1
    h = h ^ _lsr(h, 33)
    h = h * _M2
    return h ^ _lsr(h, 33)


def _umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """int64 bits taken as unsigned, modulo ``m``."""
    return ((_lsr(x, 1) % m) * 2 + (x & 1)) % m


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [n, W] nibble-packed rows (``edit.pack_nibble_rows``) ->
    [n, 2W], 15 back to the 0xFF pad."""
    pair = torch.stack([packed >> 4, packed & 0xF], dim=-1)
    full = pair.reshape(packed.shape[0], packed.shape[1] * 2)
    return torch.where(full == 15, torch.full_like(full, 0xFF), full)


def window_hash_plain(keys: torch.Tensor, ids: torch.Tensor,
                      specs: torch.Tensor, rows: int, gid_bits: int,
                      shard: Tuple[int, int] = (0, 1), packed: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`window_hash`: (int64 [rows] flipped
    composites, int64 [1] kept rows), on ``keys``' device."""
    pid, nproc = shard
    low = gid_bits + 1
    dev = keys.device
    if packed:
        keys = unpack_nibbles(keys)
    out = torch.empty(rows, dtype=torch.int64, device=dev)
    kept = 0
    for first, id0, count, start, width, side, seed, _ in specs.tolist():
        key_ids = ids[id0:id0 + count].long()
        w8 = -(-width // 8) * 8
        window = torch.zeros((count, w8), dtype=torch.uint8, device=dev)
        window[:, :width] = keys[key_ids, start:start + width]
        words = window.view(torch.int64)
        h = torch.full((count,), seed, dtype=torch.int64, device=dev)
        for c in range(w8 // 8):
            h = h ^ words[:, c]
            h = h * _M3
            h = h ^ _lsr(h, 29)
        h = _mix_plain(h)
        value = (h & -(1 << low)) | (side << gid_bits) | key_ids
        if nproc > 1:
            mine = _umod(_mix_plain(h ^ _signed(EDIT_OWN_SALT)), nproc) \
                == pid
            value = torch.where(mine, value, torch.full_like(value, -1))
            kept += int(mine.sum())
        else:
            kept += count
        out[first:first + count] = value ^ _TOP
    return out, torch.tensor([kept], dtype=torch.int64, device=dev)


def window_hash(keys: torch.Tensor, ids: torch.Tensor, specs: torch.Tensor,
                rows: int, gid_bits: int, shard: Tuple[int, int] = (0, 1),
                packed: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 [rows] composites with the top bit flipped, int64 [1] rows
    kept under ``shard``) of every spec's window rows of ``keys``.

    ``keys``: uint8 [n, Lp], Lp a multiple of 8, or with ``packed`` the
    nibble-packed [n, Lp/2] (``edit.pack_nibble_rows``), whose windows
    hash as the unpacked bytes do; ``ids``: int32 key ids; ``specs``:
    int64 [S, SPEC_WORDS] (:func:`spec_table`), whose rows number
    ``rows``.  All three contiguous: the kernel takes a row's pitch from
    the shape."""
    if keys.dtype != torch.uint8 or keys.dim() != 2 \
            or (not packed and keys.shape[1] % 8):
        raise ValueError(f"edit_window_hash: expected a uint8 [n, Lp] key "
                         f"matrix, Lp a multiple of 8 unless packed, got "
                         f"{tuple(keys.shape)}/{keys.dtype}")
    if ids.dtype != torch.int32 or specs.dtype != torch.int64 \
            or specs.dim() != 2 or specs.shape[1] != SPEC_WORDS:
        raise ValueError("edit_window_hash: ids must be int32 and specs "
                         f"int64 [S, {SPEC_WORDS}]")
    if not (keys.is_contiguous() and ids.is_contiguous()
            and specs.is_contiguous()):
        raise ValueError("edit_window_hash: keys, ids and specs must be "
                         "contiguous")
    if keys.device.type == "cpu":
        return window_hash_plain(keys, ids, specs, rows, gid_bits, shard,
                                 packed)
    check_cuda("edit_window_hash", keys, ids, specs)
    out = torch.empty(rows, dtype=torch.int64, device=keys.device)
    kept = torch.zeros(1, dtype=torch.int64, device=keys.device)
    if rows == 0:
        return out, kept
    pid, nproc = shard
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        status = library().fqd_edit_window_hash(
            keys.data_ptr(), keys.shape[1], ids.data_ptr(),
            specs.data_ptr(), specs.shape[0], rows, gid_bits, pid, nproc,
            EDIT_OWN_SALT, int(packed), out.data_ptr(), kept.data_ptr(),
            stream)
    check_status("edit_window_hash", status)
    count_launch(LAUNCHES, "edit_window_hash")
    return out, kept


def sort_values(values: torch.Tensor) -> torch.Tensor:
    """The composites in ascending order (signed order of the flipped
    values: unsigned order of the composites)."""
    return torch.sort(values).values


def _pairs_plain(values: torch.Tensor, gid_bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row of each pair's probe, row of its partner, ids) over the kept
    sorted values, in the kernel's order: by probe row, then partner."""
    n = len(values)
    dev = values.device
    ids = values & ((1 << gid_bits) - 1)
    if n == 0:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, empty, ids
    run = values >> (gid_bits + 1)
    probe = ((values >> gid_bits) & 1) == 0
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = run[1:] != run[:-1]
    starts = torch.nonzero(first)[:, 0]
    ends = torch.cat([starts[1:], torch.tensor([n], device=dev)])
    end_of = ends[torch.cumsum(first.long(), 0) - 1]
    pos = torch.arange(n, device=dev)
    later = torch.where(probe, end_of - pos - 1, torch.zeros_like(pos))
    left = torch.repeat_interleave(pos, later)
    before = torch.cumsum(later, 0) - later
    right = left + 1 + (torch.arange(len(left), device=dev) - before[left])
    keep = ids[left] != ids[right]
    return left[keep], right[keep], ids


def join_count_plain(ordered: torch.Tensor, kept: torch.Tensor,
                     gid_bits: int) -> torch.Tensor:
    """Plain version of :func:`join_count`."""
    left, _, _ = _pairs_plain(ordered[:int(kept)], gid_bits)
    return torch.bincount(left, minlength=len(ordered))


def join_write_plain(ordered: torch.Tensor, kept: torch.Tensor,
                     gid_bits: int, ends: torch.Tensor,
                     total: int) -> torch.Tensor:
    """Plain version of :func:`join_write`."""
    left, right, ids = _pairs_plain(ordered[:int(kept)], gid_bits)
    if len(left) != total or (len(ends) and int(ends[-1]) != total):
        raise ValueError("edit_join_write: the counts' scan does not "
                         "match the pairs")
    gi, gj = ids[left], ids[right]
    return torch.minimum(gi, gj) * (1 << 31) + torch.maximum(gi, gj)


def _join_launch(name: str, ordered: torch.Tensor, kept: torch.Tensor,
                 gid_bits: int, counts, ends, codes) -> None:
    check_cuda(name, *[t for t in (ordered, kept, counts, ends, codes)
                       if t is not None])
    with torch.cuda.device(ordered.device):
        stream = torch.cuda.current_stream(ordered.device).cuda_stream
        status = library().fqd_edit_join(
            ordered.data_ptr(), len(ordered), kept.data_ptr(), gid_bits,
            None if counts is None else counts.data_ptr(),
            None if ends is None else ends.data_ptr(),
            None if codes is None else codes.data_ptr(), stream)
    check_status(name, status)
    count_launch(LAUNCHES, name)


def _check_join(ordered: torch.Tensor, gid_bits: int) -> None:
    if ordered.dtype != torch.int64 or ordered.dim() != 1:
        raise ValueError("edit_join: expected int64 [rows] values")
    if not 1 <= gid_bits <= 29:
        raise ValueError(f"edit_join: gid_bits {gid_bits} outside [1, 29]")


def join_count(ordered: torch.Tensor, kept: torch.Tensor,
               gid_bits: int) -> torch.Tensor:
    """int64 [rows]: the pairs each of the first ``kept`` sorted values
    emits as a probe (0 for a window and past ``kept``)."""
    _check_join(ordered, gid_bits)
    if ordered.device.type == "cpu":
        return join_count_plain(ordered, kept, gid_bits)
    counts = torch.empty_like(ordered)
    if len(ordered):
        _join_launch("edit_join_count", ordered, kept, gid_bits, counts,
                     None, None)
    return counts


def join_write(ordered: torch.Tensor, kept: torch.Tensor, gid_bits: int,
               ends: torch.Tensor, total: int) -> torch.Tensor:
    """int64 [total] pair codes, the pairs of row i at ``[ends[i - 1],
    ends[i])``; ``ends`` is the inclusive scan of :func:`join_count`."""
    _check_join(ordered, gid_bits)
    if ordered.device.type == "cpu":
        return join_write_plain(ordered, kept, gid_bits, ends, total)
    codes = torch.empty(total, dtype=torch.int64, device=ordered.device)
    if total:
        _join_launch("edit_join_write", ordered, kept, gid_bits, None, ends,
                     codes)
    return codes


def unique_codes(codes: torch.Tensor) -> torch.Tensor:
    """The codes ascending, each once."""
    return torch.unique_consecutive(torch.sort(codes).values)


def join_codes(keys: torch.Tensor, plan: EditPlan,
               shard: Tuple[int, int] = (0, 1),
               packed: bool = False) -> np.ndarray:
    """Ascending unique pair codes of the plan's window rows joined on the
    device ``keys`` lies on: :func:`.bucket.host_edit_join`'s composite
    branch.  ``keys``: the key matrix, each key's bytes in its row at its
    global id, nibble-packed where ``packed``.  A plan that does not
    :func:`fit <fits>` (2^29 keys or more) raises: the card has no other
    join."""
    if not fits(plan):
        raise ValueError(f"edit join: {plan.total_keys} keys do not fit "
                         f"the composite's id bits")
    rows = plan.rows
    if not in_warmup():
        trace.count("pairs.edit_rows.device", rows)
    if rows == 0:
        return np.empty(0, dtype=np.int64)
    dev = keys.device
    specs_np, ids_np = spec_table(plan)
    specs_host = staging(specs_np.shape, torch.int64, dev)
    specs_host.numpy()[...] = specs_np
    ids_host = staging(ids_np.shape, torch.int32, dev)
    ids_host.numpy()[...] = ids_np
    values, kept = window_hash(keys, upload(ids_host, dev),
                               upload(specs_host, dev), rows, plan.gid_bits,
                               shard, packed)
    ordered = sort_values(values)
    del values
    ends = torch.cumsum(join_count(ordered, kept, plan.gid_bits), 0)
    total = int(ends[-1])
    if total == 0:
        return np.empty(0, dtype=np.int64)
    codes = join_write(ordered, kept, plan.gid_bits, ends, total)
    return host_array(start_host_copy(unique_codes(codes)))
