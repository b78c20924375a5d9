"""Multi-process initialisation, work partitioning, and vectorized exchange.

Counterpart of ``fastqdedup_tpu/parallel/distributed.py`` over
``torch.distributed``.  Scaling model:

* **several cards, one process** — bucket batches round-robin across the
  process's local CUDA devices (``runtime.local_devices``, ops/bucket.py)
  and component labels run on a mesh of them (parallel/sharded.py).  No
  user action needed.
* **several processes** (one per card, or one per host) — call
  :func:`initialize_distributed` first (or start the job with
  ``torchrun``, whose ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE``
  / ``RANK`` it reads) and run the SAME CLI invocation in every process;
  ``pipeline.deduplicate_cluster`` detects a world size above 1 and
  splits the work:

  - pass 1: input chunks are strided across processes (chunk i belongs
    to process i % P), or BGZF inputs are split by byte range; each
    process aggregates (key -> count, first_pos) for its records and the
    per-process tables merge through a metadata-first exchange
    (:func:`exchange_merge_key_tables`).
  - pass 2: pigeonhole buckets are partitioned by a stable content-id mix
    (:func:`bucket_owner_mask`), each bucket's pairs are computed in
    exactly one process, and the edge lists union through
    :func:`allgather_int64_pairs`.  Union-find + dissection then run
    identically everywhere (big clusters stride across processes with an
    index all-gather).
  - pass 3: each process rewrites its own records; the first-wins rule
    needs no coordination because pass 1 recorded each key's global
    first-occurrence position.

Every exchange moves host bytes: over the TCP socket mesh
(parallel/transport.py) when it is up, otherwise through gloo
collectives on CPU tensors.  Tested by real 2-process runs
(tests/test_torch_distributed.py, tests/test_torch_transport.py) and the
single-process fallbacks.
"""

import atexit
import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# The job's TCPStore when initialize_distributed made it: the socket
# mesh publishes its listener addresses there.
_store = None
_coordinator: Optional[str] = None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join the job's ``torch.distributed`` process group (gloo).
    Idempotent; a no-op for a single process.

    With no arguments it joins through torch's standard environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets them; its agent may already serve the store).
    Otherwise process ``0`` serves a ``TCPStore`` at
    ``coordinator_address`` (``"host:port"``) and every process joins
    through it.
    """
    global _store, _coordinator
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
                and "MASTER_ADDR" in os.environ:
            dist.init_process_group("gloo", init_method="env://")
            atexit.register(_destroy_process_group)
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes <= 1 or coordinator_address is None:
        return
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=datetime.timedelta(seconds=300))
    dist.init_process_group("gloo", store=store, rank=process_id,
                            world_size=num_processes)
    _store = store
    _coordinator = coordinator_address
    atexit.register(_destroy_process_group)


def _destroy_process_group() -> None:
    """Tear the process group down before the interpreter finalizes: a
    gloo group left to the C++ destructors at exit can abort the process
    (``terminate called without an active exception``) after a run that
    succeeded."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def job_store():
    """``(store, coordinator_address)`` of the process group: the one
    :func:`initialize_distributed` made, else the default store of a
    group the caller initialised (address from ``MASTER_ADDR``)."""
    if _store is not None:
        return _store, _coordinator
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None, None
    return (dist.distributed_c10d._get_default_store(),
            os.environ.get("MASTER_ADDR"))


def process_shape() -> Tuple[int, int]:
    """(process_id, process_count); (0, 1) unless ``torch.distributed``
    is initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_for_host(items: Sequence, process_id: Optional[int] = None,
                   num_processes: Optional[int] = None) -> List:
    """The subset of ``items`` this host owns (strided partition)."""
    own_pid, own_nproc = process_shape()
    pid = own_pid if process_id is None else process_id
    nproc = own_nproc if num_processes is None else num_processes
    return [item for index, item in enumerate(items)
            if index % nproc == pid]


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


def _gloo_allgather(array: np.ndarray) -> np.ndarray:
    """[H, ...] stack of every process's ``array`` through one gloo
    all-gather of CPU tensors (torch keeps 64-bit integers whole)."""
    import torch
    import torch.distributed as dist

    local = torch.from_numpy(np.ascontiguousarray(array))
    out = torch.empty((dist.get_world_size(),) + tuple(local.shape),
                      dtype=local.dtype)
    dist.all_gather(list(out.unbind(0)), local)
    return out.numpy()


def _allgather(array: np.ndarray) -> np.ndarray:
    """[H, ...] stack of every process's ``array``.

    TCP mesh when available (all hosts pass the same shape/dtype here —
    sizes, scalars, bitmaps); else the gloo all-gather.
    """
    from .transport import get_mesh
    mesh = get_mesh()
    if mesh is not None:
        blobs = mesh.allgather_blobs(
            np.ascontiguousarray(array).tobytes())
        return np.stack([np.frombuffer(b, dtype=array.dtype)
                         .reshape(array.shape) for b in blobs])
    return _gloo_allgather(array)


def _pad_to(a: np.ndarray, size: int) -> np.ndarray:
    if len(a) == size:
        return a
    out = np.zeros(size, dtype=a.dtype)
    out[:len(a)] = a
    return out


_GATHER_CHUNK = 8 << 20  # bytes per collective call (fixed shape)


def _chunk_mult(size: int) -> int:
    return max(_GATHER_CHUNK,
               -(-size // _GATHER_CHUNK) * _GATHER_CHUNK)


def _allgather_bytes_scatter(buf: np.ndarray, padded: int,
                             dests: List[List[Tuple[np.ndarray, int]]]
                             ) -> None:
    """All-gather a uint8 buffer in fixed 8 MiB chunks, scattering each
    host's stream straight into caller-provided destination views.

    ``dests[h]`` is a list of ``(uint8_view, stream_start)`` segments
    describing where host ``h``'s stream bytes land; ``padded`` must be
    a _GATHER_CHUNK multiple and identical on every host.  Chunks bound
    the gloo staging buffer to ``H x 8 MiB``, and scattering each chunk
    into the final arrays touches every payload byte once (this path
    runs once per pipeline run, so intermediate ``[H, padded]`` buffers
    would be freshly faulted-in memory).

    When the TCP mesh is up (parallel/transport.py) the bytes skip the
    collective entirely: raw sockets need no padding, no chunk dispatch,
    and no intermediate assembly buffers."""
    from .transport import get_mesh
    mesh = get_mesh()
    if mesh is not None:
        mesh.allgather_scatter(buf.view(np.uint8), dests)
        return

    pbuf = _pad_to(buf.view(np.uint8), padded)
    for i in range(0, padded, _GATHER_CHUNK):
        g = _gloo_allgather(pbuf[i:i + _GATHER_CHUNK])
        hi_chunk = i + _GATHER_CHUNK
        for h, segs in enumerate(dests):
            for view, start in segs:
                lo = max(i, start)
                hi = min(hi_chunk, start + len(view))
                if lo < hi:
                    view[lo - start:hi - start] = g[h, lo - i:hi - i]


def allgather_key_tables(key_data: np.ndarray, key_offsets: np.ndarray,
                         counts: np.ndarray, first_pos: np.ndarray,
                         *extra_cols: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Concatenate per-host key-accumulator exports across all processes.

    One size exchange plus one chunked byte all-gather carrying payload
    bytes and every int64 column (lengths, counts, first_pos, extras) —
    O(total table size) traffic and zero per-key Python.
    The same key may appear in several hosts' tables; the caller's
    finalize step collapses duplicates (summing counts, min-ing
    first_pos).  ``extra_cols``: additional per-key int64/uint64 columns
    to gather alongside; each is returned concatenated, in order, after
    the four table arrays.
    Single-process: returns the inputs unchanged.
    """
    if process_shape()[1] == 1:
        return (key_data, key_offsets, counts, first_pos, *extra_cols)
    lengths = np.diff(key_offsets)
    stack_cols = [lengths, counts, first_pos]
    stack_cols += [c.view(np.int64) for c in extra_cols]
    ncols = len(stack_cols)
    n, nbytes = len(counts), len(key_data)
    sizes = _allgather(np.asarray([n, nbytes], dtype=np.int64))
    nhosts = len(sizes)
    local = np.concatenate(
        [np.ascontiguousarray(key_data).view(np.uint8)] +
        [np.ascontiguousarray(c).view(np.uint8) for c in stack_cols])
    padded = _chunk_mult(int((sizes[:, 1] + 8 * ncols * sizes[:, 0]).max()))
    from ..runtime import big_empty
    total_n = int(sizes[:, 0].sum())
    total_b = int(sizes[:, 1].sum())
    out_data = big_empty(total_b, dtype=np.uint8)
    out_cols = big_empty((ncols, total_n), dtype=np.int64)
    dests: List[List[Tuple[np.ndarray, int]]] = []
    n_off = b_off = 0
    for h in range(nhosts):
        hn, hb = int(sizes[h, 0]), int(sizes[h, 1])
        segs = [(out_data[b_off:b_off + hb], 0)]
        pos = hb
        for c in range(ncols):
            segs.append((out_cols[c, n_off:n_off + hn].view(np.uint8), pos))
            pos += 8 * hn
        dests.append(segs)
        n_off += hn
        b_off += hb
    _allgather_bytes_scatter(local, padded, dests)
    out_offsets = np.zeros(total_n + 1, dtype=np.int64)
    np.cumsum(out_cols[0], out=out_offsets[1:])
    gathered_extras = tuple(
        out_cols[3 + i].view(extra_cols[i].dtype)
        for i in range(len(extra_cols)))
    return (out_data, out_offsets, out_cols[1], out_cols[2],
            *gathered_extras)


def allgather_int64_cols(cols: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate a ``[k, n]`` int64 column block across processes.

    Returns ``([k, total], sizes[H])`` — each column concatenated in
    process order, plus the per-host row counts.  Single-process:
    returns the input and ``[n]``.
    """
    k, n = cols.shape
    if process_shape()[1] == 1:
        return cols, np.asarray([n], dtype=np.int64)
    sizes = _allgather(np.asarray([n], dtype=np.int64))[:, 0]
    from ..runtime import big_empty
    total = int(sizes.sum())
    out = big_empty((k, total), dtype=np.int64)
    dests: List[List[Tuple[np.ndarray, int]]] = []
    n_off = 0
    for hn in sizes:
        hn = int(hn)
        segs = []
        pos = 0
        for c in range(k):
            segs.append((out[c, n_off:n_off + hn].view(np.uint8), pos))
            pos += 8 * hn
        dests.append(segs)
        n_off += hn
    local = np.ascontiguousarray(cols, dtype=np.int64) \
        .view(np.uint8).reshape(-1)
    padded = _chunk_mult(8 * k * int(sizes.max()))
    _allgather_bytes_scatter(local, padded, dests)
    return out, sizes


def allgather_uint8(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate a variable-length uint8 buffer across processes.

    Returns ``(data, sizes[H])``.  Single-process passthrough.
    """
    if process_shape()[1] == 1:
        return buf, np.asarray([len(buf)], dtype=np.int64)
    sizes = _allgather(np.asarray([len(buf)], dtype=np.int64))[:, 0]
    from ..runtime import big_empty
    out = big_empty(int(sizes.sum()), dtype=np.uint8)
    dests: List[List[Tuple[np.ndarray, int]]] = []
    off = 0
    for hn in sizes:
        hn = int(hn)
        dests.append([(out[off:off + hn], 0)])
        off += hn
    padded = _chunk_mult(int(sizes.max()))
    _allgather_bytes_scatter(np.ascontiguousarray(buf, dtype=np.uint8),
                             padded, dests)
    return out, sizes


def _owned_meta_merge(g_len: np.ndarray, g_h1: np.ndarray,
                      g_h2: np.ndarray, g_cnt: np.ndarray,
                      g_fp: np.ndarray, pid: int, nproc: int,
                      host_starts: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Merge the gathered-metadata rows this host owns — no key bytes.

    Ownership is ``h1 mod nproc``; key identity is the triple
    ``(length, h1, h2)`` of two independent 64-bit content hashes (a
    false merge needs a simultaneous collision in both — a 2^-128
    event, far below the reference's own 64-bit ``hash()`` kept-set,
    __init__.py:270-276).  Returns ``(rep_gidx, counts, first_pos,
    lengths)`` of the merged keys: summed counts, min first positions,
    zero-count keys dropped.  ``rep_gidx`` is ONE gathered row holding
    each key — its host contributes the payload bytes downstream.  With
    ``host_starts`` (the gathered segment boundaries) the representative
    is drawn pseudo-uniformly among the hosts holding the key (a salted
    hash-mix tournament), balancing payload work; in strided ingest the
    lowest pid saw almost every key, so "smallest row" would put ~all
    payload on host 0.  Deterministic given the gathered arrays, which
    are identical on every host.
    """
    owner = g_h1.view(np.uint64) % np.uint64(nproc)
    sel = np.flatnonzero(owner == np.uint64(pid))
    if not len(sel):
        e64 = np.empty(0, dtype=np.int64)
        return e64, e64.copy(), e64.copy(), e64.copy()
    if host_starts is not None and len(host_starts) > 2:
        # Native path: one hash-aggregation pass replaces the
        # argsort + reduceat + tournament sequence.  Same merge and
        # representative semantics; emission order differs but the
        # caller sorts by representative row, so native and fallback
        # hosts interoperate in one job.
        try:
            from ..native.loader import owned_merge_native
            return owned_merge_native(
                g_len, g_h1.view(np.uint64), g_h2.view(np.uint64),
                g_cnt, g_fp, pid, nproc, host_starts)
        except (ImportError, AttributeError):
            pass
    # Sort on h1 alone (stable radix — ~3x cheaper than a 3-key
    # lexsort); h1 is a strong content hash, so equal-key rows land in
    # one run unless two DISTINCT keys collide in h1.  That rare case
    # would interleave two keys inside one h1 run and split them into
    # broken sub-runs, so it is detected exactly below (any adjacent
    # equal-h1 pair differing in (len, h2)) and falls back to the full
    # 3-key lexsort.  Both paths are deterministic: the gathered arrays
    # are identical on every host.
    order = np.argsort(g_h1[sel].view(np.uint64), kind="stable")
    s = sel[order]
    same_h1 = g_h1[s][1:] == g_h1[s][:-1]
    same = same_h1 & (g_len[s][1:] == g_len[s][:-1]) & \
        (g_h2[s][1:] == g_h2[s][:-1])
    if (same_h1 & ~same).any():
        order = np.lexsort((g_h2[sel].view(np.uint64),
                            g_h1[sel].view(np.uint64), g_len[sel]))
        s = sel[order]
        same = (g_len[s][1:] == g_len[s][:-1]) & \
            (g_h1[s][1:] == g_h1[s][:-1]) & (g_h2[s][1:] == g_h2[s][:-1])
    run_starts = np.concatenate([[0], np.flatnonzero(~same) + 1])
    counts = np.add.reduceat(g_cnt[s], run_starts)
    first_pos = np.minimum.reduceat(g_fp[s], run_starts)
    if host_starts is None or len(host_starts) <= 2:
        # lexsort is stable and sel ascends, so the first row of each
        # run is the smallest gathered index of that key.
        rep_gidx = s[run_starts]
    else:
        # Tournament: each row's priority mixes the key hash with its
        # host id; the run minimum wins.  Every host holding the key is
        # equally likely, spreading the payload contribution evenly.
        host_of = np.searchsorted(host_starts, s, side="right") - 1
        prio = _mix64(g_h1[s].view(np.uint64)
                      ^ ((host_of.astype(np.uint64) + np.uint64(1))
                         * np.uint64(0x9E3779B97F4A7C15)))
        run_lens = np.diff(np.concatenate([run_starts, [len(s)]]))
        run_of = np.repeat(np.arange(len(run_starts)), run_lens)
        prio_min = np.minimum.reduceat(prio, run_starts)
        is_min = prio == prio_min[run_of]
        cand = np.where(is_min, s, np.iinfo(np.int64).max)
        rep_gidx = np.minimum.reduceat(cand, run_starts)
    lengths = g_len[rep_gidx]
    keep = counts > 0
    if not keep.all():
        rep_gidx, counts, first_pos, lengths = \
            rep_gidx[keep], counts[keep], first_pos[keep], lengths[keep]
    return rep_gidx, counts, first_pos, lengths


def _ragged_take(data: np.ndarray, offsets: np.ndarray,
                 rows: np.ndarray) -> np.ndarray:
    """Concatenated bytes of the selected ragged rows, in ``rows`` order.

    Native path: one C memcpy per row.  Numpy fallback gathers per
    distinct row length (a [k, L] index matrix per group) — never an
    index per byte, whose fresh-page faults cost minutes at multi-host
    table sizes.
    """
    lens = offsets[rows + 1] - offsets[rows]
    out_offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lens, out=out_offsets[1:])
    total = int(out_offsets[-1])
    if not total:
        return np.empty(0, dtype=np.uint8)
    try:
        from ..native.loader import gather_ragged_native
        return gather_ragged_native(data, offsets, rows, out_offsets)
    except ImportError:
        pass
    out = np.empty(total, dtype=np.uint8)
    for length in np.unique(lens):
        if length == 0:
            continue
        sel = np.flatnonzero(lens == length)
        span = np.arange(int(length), dtype=np.int64)
        gathered = data[offsets[rows[sel]][:, None] + span[None, :]]
        out_idx = out_offsets[sel][:, None] + span[None, :]
        out[out_idx.ravel()] = gathered.ravel()
    return out


def exchange_merge_key_tables(key_data: np.ndarray,
                              key_offsets: np.ndarray,
                              counts: np.ndarray, first_pos: np.ndarray,
                              h1: np.ndarray, h2: np.ndarray,
                              progress=None
                              ) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]:
    """Merge per-host key tables into one global deduplicated table.

    Metadata-first exchange — three all-gathers, each host merges only
    the keys it owns, and every key's payload bytes cross the wire
    exactly ONCE (from the host holding its representative row):

    1. gather 40 B/row of metadata (length, h1, h2, count, first_pos);
    2. each host collapses its owned share from metadata alone
       (:func:`_owned_meta_merge`) and the merged columns gather back
       (≈32 B per unique key);
    3. each host contributes payload bytes for the representative rows
       it holds, in ascending gathered-row order — the concatenation of
       those streams IS the final table payload, so assembly is a pure
       int64-column permutation, no byte rearrangement.

    Returns ``(data, offsets, counts, first_pos)`` — identical on every
    host, ordered by ascending gathered row index of the representative
    (deterministic).  ``counts`` must already be per-host partials;
    zero-total keys are dropped (quality-filtered everywhere).
    """
    pid, nproc = process_shape()
    if nproc == 1:
        keep = counts > 0
        if keep.all():
            return key_data, key_offsets, counts, first_pos
        rows = np.flatnonzero(keep)
        data = _ragged_take(key_data, key_offsets, rows)
        lens = key_offsets[rows + 1] - key_offsets[rows]
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        return data, offsets, counts[rows], first_pos[rows]

    lengths_local = np.diff(key_offsets)
    meta = np.empty((5, len(counts)), dtype=np.int64)
    meta[0] = lengths_local
    meta[1] = h1.view(np.int64)
    meta[2] = h2.view(np.int64)
    meta[3] = counts
    meta[4] = first_pos
    gathered, sizes = allgather_int64_cols(meta)
    if progress:
        progress("meta-allgather")
    host_starts = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=host_starts[1:])
    rep_gidx, m_cnt, m_fp, m_len = _owned_meta_merge(
        gathered[0], gathered[1].view(np.uint64),
        gathered[2].view(np.uint64), gathered[3], gathered[4],
        pid, nproc, host_starts=host_starts)
    from ..runtime import release
    release(gathered)  # merge outputs are copies; recycle the 40 B/row
    gathered = None
    if progress:
        progress("owned-merge")
    owned_cols = np.empty((4, len(rep_gidx)), dtype=np.int64)
    owned_cols[0] = rep_gidx
    owned_cols[1] = m_cnt
    owned_cols[2] = m_fp
    owned_cols[3] = m_len
    merged, _ = allgather_int64_cols(owned_cols)
    if progress:
        progress("merged-allgather")
    # Final order: ascending representative row index — which groups
    # reps by host (host segments are contiguous index ranges), so the
    # payload streams below concatenate directly into table order.
    # Native path: one fused radix sort + 4-column permute (O(n), ~5x
    # cheaper than argsort + four fancy-index takes — this reorder is
    # ~n total keys of work replicated on EVERY host).
    try:
        from ..native.loader import sort_permute4_native
        rep_all, cnt_all, fp_all, len_all = sort_permute4_native(merged)
    except (ImportError, AttributeError):
        order = np.argsort(merged[0], kind="stable")
        rep_all = merged[0][order]
        cnt_all = merged[1][order]
        fp_all = merged[2][order]
        len_all = merged[3][order]
    release(merged)  # the reorders above are copies
    merged = None
    lo = int(np.searchsorted(rep_all, host_starts[pid]))
    hi = int(np.searchsorted(rep_all, host_starts[pid + 1]))
    my_rows = rep_all[lo:hi] - host_starts[pid]
    my_payload = _ragged_take(key_data, key_offsets, my_rows)
    if progress:
        progress("payload-take")
    data, _ = allgather_uint8(my_payload)
    release(my_payload)  # its bytes now live in the gathered table
    my_payload = None
    if progress:
        progress("payload-allgather")
    offsets = np.zeros(len(rep_all) + 1, dtype=np.int64)
    np.cumsum(len_all, out=offsets[1:])
    # rep_all/len_all are dead here; recycle their pooled buffers so the
    # next run's sort_permute4 outputs re-use them instead of faulting
    # fresh pages.
    release(rep_all)
    release(len_all)
    return data, offsets, cnt_all, fp_all


def or_byte_presence(presence: np.ndarray) -> np.ndarray:
    """bool[256] union of every host's key-byte presence bitmap."""
    if process_shape()[1] == 1:
        return presence
    gathered = _allgather(presence.astype(np.uint8))
    return gathered.any(axis=0)


def allgather_int64(vec: np.ndarray) -> np.ndarray:
    """Concatenate a variable-length int64 vector across processes."""
    if process_shape()[1] == 1:
        return vec
    sizes = _allgather(np.asarray([len(vec)], dtype=np.int64))[:, 0]
    padded = _chunk_mult(int(sizes.max()) * 8)
    out = np.empty(int(sizes.sum()), dtype=np.int64)
    dests: List[List[Tuple[np.ndarray, int]]] = []
    off = 0
    for h in range(len(sizes)):
        hn = int(sizes[h])
        dests.append([(out[off:off + hn].view(np.uint8), 0)])
        off += hn
    _allgather_bytes_scatter(
        np.ascontiguousarray(vec.astype(np.int64)), padded, dests)
    return out


def allgather_int64_pairs(a: np.ndarray, b: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate paired int64 vectors (e.g. edge lists) across hosts."""
    if process_shape()[1] == 1:
        return a, b
    stacked = allgather_int64(np.concatenate(
        [np.asarray([len(a)], dtype=np.int64), a, b]))
    out_a: List[np.ndarray] = []
    out_b: List[np.ndarray] = []
    pos = 0
    while pos < len(stacked):
        n = int(stacked[pos])
        out_a.append(stacked[pos + 1:pos + 1 + n])
        out_b.append(stacked[pos + 1 + n:pos + 1 + 2 * n])
        pos += 1 + 2 * n
    return np.concatenate(out_a), np.concatenate(out_b)


def sum_scalars(*values: int) -> Tuple[int, ...]:
    """Element-wise sum of per-host int scalars (for run statistics)."""
    if process_shape()[1] == 1:
        return values
    gathered = _allgather(np.asarray(values, dtype=np.int64))
    return tuple(int(v) for v in gathered.sum(axis=0))


def barrier(name: str) -> None:
    """Block until every process reaches this point (``name`` labels the
    call site; the mesh and gloo barriers need no tag)."""
    if process_shape()[1] == 1:
        return
    from .transport import get_mesh
    mesh = get_mesh()
    if mesh is not None:
        mesh.allgather_blobs(b"")  # empty exchange == barrier
        return
    import torch.distributed as dist

    dist.barrier()


def merge_kept_keys(local_kept: set) -> set:
    """Union per-host kept-key byte-string sets across processes.

    Compatibility API over :func:`allgather_key_tables` (ragged keys pack
    into one payload + length vector; no per-key Python in the exchange).
    The pipeline itself does not need this — first_pos tracking makes
    kept sets implicit — but external callers mirroring the reference's
    kept-set flow can still merge through it.
    """
    if process_shape()[1] == 1:
        return local_kept
    local = sorted(local_kept)
    lengths = np.fromiter((len(k) for k in local), dtype=np.int64,
                          count=len(local))
    offsets = np.zeros(len(local) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    data = np.frombuffer(b"".join(local), dtype=np.uint8) \
        if local else np.empty(0, dtype=np.uint8)
    ones = np.ones(len(local), dtype=np.int64)
    g_data, g_offsets, _, _ = allgather_key_tables(
        data, offsets, ones, ones)
    raw = g_data.tobytes()
    return {raw[g_offsets[i]:g_offsets[i + 1]]
            for i in range(len(g_offsets) - 1)}


def partition_buckets_by_hash(bucket_keys: Sequence[bytes],
                              num_shards: int) -> List[List[int]]:
    """Assign bucket ids to shards by stable content hash.

    Buckets are the unit of distribution (a bucket's pairs never cross
    hosts for Hamming — SURVEY.md §7 step 9), so this partition makes the
    candidate-generation phase embarrassingly parallel across hosts.
    """
    import zlib

    shards: List[List[int]] = [[] for _ in range(num_shards)]
    for index, key in enumerate(bucket_keys):
        shards[zlib.crc32(key) % num_shards].append(index)
    return shards
