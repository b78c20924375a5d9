"""Runtime configuration: the torch device, the host buffer pool and the
host allocator tuning.

``device()`` names the one device pass 2 runs on
(``FASTQDEDUP_TORCH_DEVICE``, default ``cuda``).  Everything else here is
host memory management shared with the JAX package.
"""

import os
from typing import List, Optional

import numpy as np

from .utils import trace

_allocator_tuned = False

_MADV_POPULATE_WRITE = 23  # Linux 5.14+
_libc = None
_populate_ok = True


def populate(a: np.ndarray) -> None:
    """Pre-fault a numpy buffer in ONE syscall (MADV_POPULATE_WRITE).

    On virtualized hosts with lazily-backed guest memory, per-page
    write faults measure 2-30 s/GiB while a single populate call maps
    the same range at ~0.3 s/GiB (measured here: 14x) — the overhead is
    the fault path, not the zeroing.  No-op (and disabled after the
    first failure) on kernels without MADV_POPULATE_WRITE; disable
    explicitly with FASTQDEDUP_POPULATE=0."""
    global _libc, _populate_ok
    if not _populate_ok or os.environ.get("FASTQDEDUP_POPULATE") == "0":
        return
    try:
        import ctypes

        if _libc is None:
            _libc = ctypes.CDLL(None, use_errno=True)
        addr = a.ctypes.data
        nbytes = a.nbytes
        start = (addr + 4095) & ~4095  # stay inside the allocation
        end = (addr + nbytes) & ~4095
        if end <= start:
            return
        rc = _libc.madvise(ctypes.c_void_p(start),
                           ctypes.c_size_t(end - start),
                           _MADV_POPULATE_WRITE)
        if rc != 0:
            _populate_ok = False
    except Exception:  # pragma: no cover - best-effort
        _populate_ok = False


# ---- process-lifetime buffer pool ------------------------------------
#
# glibc's heap recycling (tune_host_allocator) catches MOST freed big
# buffers, but free-order nondeterminism across worker threads leaves
# 30-110 MB of fresh mappings per pipeline run — each costing up to
# 0.5 s when the host's lazily-backed page-creation weather is bad
# (measured here).  The pool removes the nondeterminism for the hot
# recurring buffers: allocations round up to 4 MiB size classes, callers
# that KNOW their buffer is dead hand it back via :func:`release`, and
# the next same-class request reuses the identical (already backed)
# pages.  Buffers never released just behave as before.

_POOL_GRAN = 1 << 22  # 4 MiB size-class granularity
_POOL_MIN = 8 << 20   # below this, plain np.empty (malloc recycles fine)
_pool: dict = {}
_pool_bytes = 0


def _default_pool_limit() -> int:
    """Pool capacity: 2/5 of RAM, floor 2 GiB.

    At 100M-read scale the recyclable working set (3.1 GiB key table,
    ~7 GiB record arena, parse buffers, exchange columns) far exceeds
    the old fixed 2 GiB cap, so every run re-faulted tens of GiB of
    lazily-backed pages (2-8 s/GiB on this class of host).  Pooled
    buffers stay MAPPED, and mapped pages stay cheap under virtio free
    page reporting — retaining them across runs is the documented
    mitigation (BASELINE.md "Measurement environment"), and a service
    holding its steady-state working set resident is the intent.  RAM/4
    proved exactly one buffer too small at 100M reads: the ~21 GiB of
    parse chunks released at run end filled the cap, so the 3 GiB key
    table — released last, re-needed first — was the one dropped.
    FASTQDEDUP_POOL_LIMIT overrides (bytes)."""
    try:
        page = os.sysconf("SC_PAGE_SIZE")
        phys = os.sysconf("SC_PHYS_PAGES")
        total = page * phys
    except (ValueError, OSError, AttributeError):
        total = 0
    return max(2 * 1024 ** 3, total * 2 // 5)


_pool_limit = int(os.environ.get("FASTQDEDUP_POOL_LIMIT", 0)) or \
    _default_pool_limit()
_pool_lock = None


def _get_pool_lock():
    global _pool_lock
    if _pool_lock is None:
        import threading
        _pool_lock = threading.Lock()
    return _pool_lock


def _pool_take(size_class: int) -> Optional[np.ndarray]:
    global _pool_bytes
    with _get_pool_lock():
        stack = _pool.get(size_class)
        if stack:
            _pool_bytes -= size_class
            return stack.pop()
    return None


def release(arr: Optional[np.ndarray]) -> None:
    """Return a :func:`big_empty` buffer to the pool.

    The caller asserts no OTHER live view aliases the buffer; a
    conservative refcount gate turns a violated assertion into a skipped
    recycle rather than aliased memory.  Non-pool arrays are ignored.
    """
    global _pool_bytes
    if arr is None:
        return
    base = arr.base if isinstance(arr.base, np.ndarray) else arr
    if (not base.flags.owndata or base.dtype != np.uint8
            or base.ndim != 1 or base.nbytes < _POOL_MIN
            or base.nbytes % _POOL_GRAN):
        _reject_debug(arr, base, "shape")
        return
    import sys as _sys
    # Expected refs when no foreign view is alive: getrefcount temp +
    # local `base` + either the passed view's .base pointer (view case)
    # or the `arr` parameter + one caller binding (base case).  Anything
    # above means another view may be alive — keep the memory out of
    # the pool rather than risk aliasing.
    limit = 3 if arr is not base else 4
    if _sys.getrefcount(base) > limit:
        _reject_debug(arr, base, "refcount")
        return
    with _get_pool_lock():
        if _pool_bytes + base.nbytes > _pool_limit:
            _reject_debug(arr, base, "pool-full")
            return
        _pool.setdefault(base.nbytes, []).append(base)
        _pool_bytes += base.nbytes


def _reject_debug(arr: np.ndarray, base: np.ndarray, why: str) -> None:
    """FASTQDEDUP_POOL_DEBUG=1: log rejected recycles of big buffers.

    A rejected release is silent by design (safety beats recycling); this
    makes steady-state pool misses diagnosable without a debugger."""
    if os.environ.get("FASTQDEDUP_POOL_DEBUG") != "1":
        return
    if base.nbytes < _POOL_MIN:
        return
    import sys as _sys
    import traceback
    site = " > ".join(
        f"{os.path.basename(f.filename)}:{f.lineno}"
        for f in traceback.extract_stack()[-4:-2])
    print(f"pool-reject[{why}] {base.nbytes >> 20}MiB "
          f"rc={_sys.getrefcount(base)} owndata={base.flags.owndata} "
          f"via {site}", file=_sys.stderr, flush=True)
    if why == "refcount" and os.environ.get(
            "FASTQDEDUP_POOL_REFTRACE") == "1":
        # Name live frame locals (across all threads) aliasing the base.
        for tid, frame in _sys._current_frames().items():
            f = frame
            while f is not None:
                for name, val in list(f.f_locals.items()):
                    hit = val is base or (
                        isinstance(val, np.ndarray)
                        and val.base is base)
                    if hit:
                        print(f"  alias: thread {tid} "
                              f"{os.path.basename(f.f_code.co_filename)}:"
                              f"{f.f_lineno} {f.f_code.co_name}() "
                              f"local '{name}'",
                              file=_sys.stderr, flush=True)
                f = f.f_back


def big_empty(shape, dtype=np.uint8) -> np.ndarray:
    """``np.empty`` for large buffers: pooled, class-rounded, pre-faulted.

    Large results are VIEWS of a 4 MiB-class-rounded owning uint8 array
    (hand the view — or any view of it — to :func:`release` when the
    buffer is provably dead to recycle its backed pages).  Two measured
    dead ends documented so they are not retried:

    * Hand-mmapped backing (``np.frombuffer`` over ``mmap``) fails:
      numpy routes ufuncs/``np.take`` writing into foreign-buffer
      destinations through a buffered slow path that is 7-10x slower
      than the owned-memory fast path, warm or cold.  Bases must OWN
      their memory (pool bases are plain ``np.empty`` arrays; views of
      an ndarray keep the fast paths).
    * madvise(MADV_HUGEPAGE) backing fails: with ``defrag=madvise`` (a
      common default) hugepage faults do synchronous compaction, which
      under page-cache pressure measured 50+ s/GiB.  numpy does this
      madvise ITSELF on every >= 4 MiB allocation — which was the true
      source of the "random" 5-50 s/GiB first-touch costs chased here;
      :func:`tune_host_allocator` turns it off process-wide."""
    dtype = np.dtype(dtype)
    dims = (shape,) if isinstance(shape, (int, np.integer)) \
        else tuple(shape)
    nbytes = int(np.prod(dims, dtype=np.int64)) * dtype.itemsize
    if nbytes < _POOL_MIN:
        return np.empty(shape, dtype=dtype)
    size_class = -(-nbytes // _POOL_GRAN) * _POOL_GRAN
    base = _pool_take(size_class)
    trace.count("pool.reused_bytes" if base is not None
                else "pool.fresh_bytes", size_class)
    if base is None:
        if os.environ.get("FASTQDEDUP_POOL_DEBUG") == "1":
            import sys as _sys
            import traceback
            site = " > ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}"
                for f in traceback.extract_stack()[-4:-1])
            print(f"pool-miss {size_class >> 20}MiB via {site}",
                  file=_sys.stderr, flush=True)
        base = np.empty(size_class, dtype=np.uint8)
        populate(base)
    return base[:nbytes].view(dtype).reshape(shape)


def tune_host_allocator() -> None:
    """Keep freed large buffers in the process heap (idempotent).

    glibc serves big requests via mmap and munmaps them on free, so every
    per-chunk parse/render buffer is brand-new memory whose first touch
    page-faults.  On virtualized hosts with lazy host-side paging those
    faults can cost seconds per GiB (measured here: 2 GiB alloc+fill is
    16 s cold vs 0.4 s from recycled heap pages — 40x).  Raising
    M_MMAP_THRESHOLD and M_TRIM_THRESHOLD makes malloc retain and reuse
    those buffers, paying the fault cost once per buffer size class
    instead of once per chunk.  Peak RSS is unchanged (the retained pages
    are exactly the working set the run already touched); disable with
    ``FASTQDEDUP_MALLOC_TUNE=0``.
    """
    global _allocator_tuned
    if _allocator_tuned or os.environ.get("FASTQDEDUP_MALLOC_TUNE") == "0":
        return
    _allocator_tuned = True
    try:
        # numpy madvises MADV_HUGEPAGE on every allocation >= 4 MiB.  With
        # THP defrag=madvise (this machine's default) each hugepage fault
        # then does SYNCHRONOUS compaction: a fresh 134 MB np.empty that
        # np.take writes into measured 35-50 s when physical memory is
        # fragmented, vs 1.1 s with the madvise off — and fragmentation
        # builds up over a run, which is why the slowdown looked random.
        # The lost TLB win is noise next to that.  Env override for child
        # processes; the setter for this already-imported process.
        os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
        from numpy._core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:  # pragma: no cover - numpy internals may move
        pass
    try:
        import ctypes

        libc = ctypes.CDLL(None)
        # Route even multi-GiB C allocations (accumulator tables, arena
        # slots) through the heap: mmap-served giants are munmapped on
        # free, so a repeated run re-faults every page (measured at 100M
        # reads: ~5.5 GiB of fresh mappings per run, steady reps 117-131
        # s), while heap-served giants stay mapped under the huge trim
        # threshold and reuse warm pages (same session: ~3.4 GiB fewer
        # fresh mappings, steady reps 100-116 s).  The first-ever fault
        # of brk-grown pages is costlier than mmap's (5-18 vs ~0.8
        # s/GiB here), but that is a one-time cost the steady state
        # amortizes.  FASTQDEDUP_MMAP_THRESHOLD (bytes) overrides —
        # e.g. 134217728 restores the old 128 MiB split for one-shot
        # batch invocations on fragmented hosts.
        mmap_threshold = int(os.environ.get(
            "FASTQDEDUP_MMAP_THRESHOLD", str((1 << 31) - (1 << 12))))
        libc.mallopt(-3, mmap_threshold)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, (1 << 31) - (1 << 12))  # M_TRIM_THRESHOLD
        # M_TRIM_THRESHOLD only governs the main arena's sbrk trim.  The
        # worker threads (parse, inflate, accumulate, render, writer)
        # free their chunk buffers into per-thread arenas, whose
        # heap_trim() releases memory back to the kernel whenever the
        # heap's free top exceeds M_TOP_PAD — so every run re-faulted
        # ~450 MB of just-released pages.  On hosts with lazily-backed
        # guest memory (free-page reporting unbacks released pages
        # within seconds) each re-fault can cost up to ~55 s/GiB
        # (measured here), making identical back-to-back runs swing
        # 0.9 s -> 9 s.  Raising M_TOP_PAD blocks non-main-arena trim,
        # and capping the arena count at one makes every thread recycle
        # the SAME size classes instead of re-growing them per arena
        # (measured: steady-state fresh mappings drop 110k -> 12k pages
        # per 1M-read run).  Allocation rate is low — the pipeline deals
        # in large, infrequent buffers — so the single-arena lock is not
        # contended (utime unchanged across configs).
        libc.mallopt(-2, 256 << 20)  # M_TOP_PAD
        libc.mallopt(-8, 1)  # M_ARENA_MAX
    except Exception:  # pragma: no cover - best-effort, non-glibc hosts
        pass


def device() -> "torch.device":
    """The torch device pass 2 runs on, from ``FASTQDEDUP_TORCH_DEVICE``
    (default ``cuda``).

    Plain ``cuda`` means ``cuda:{LOCAL_RANK % device_count}``: each
    process of a job started with one process per card (``torchrun``
    sets ``LOCAL_RANK``) takes its own card, and processes beyond the
    card count share them.  Asking for CUDA where none is available
    raises: the pipeline never carries on silently on the CPU.  The CPU
    device is for tests and hosts without a card, and must be asked for
    explicitly."""
    import torch

    dev = torch.device(os.environ.get("FASTQDEDUP_TORCH_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FASTQDEDUP_TORCH_DEVICE={dev} but torch.cuda.is_available() "
            f"is False; set FASTQDEDUP_TORCH_DEVICE=cpu to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def local_devices() -> "List[torch.device]":
    """The devices this process spreads its device work over: every
    visible card for a single process asked for plain ``cuda``, else the
    one :func:`device` names (a multi-process job runs one process per
    card; the CPU device is one device)."""
    import torch

    from .parallel.distributed import process_shape

    dev = device()
    if os.environ.get("FASTQDEDUP_TORCH_DEVICE", "cuda") == "cuda" \
            and process_shape()[1] == 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def local_device_count() -> int:
    """How many local devices component labels may shard over; the
    engine takes the device mesh only when this is above 1."""
    return len(local_devices())
