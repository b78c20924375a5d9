"""Bring the card up before the first real run (``python -m
fastqdedup_tpu_torch.warmup``), or beside pass 1 of a run.

Counterpart of ``fastqdedup_tpu/warmup.py``.  The CUDA kernels take any
shape and build once per checkout, so there is no family of programs to
compile ahead.  What the first run of a process pays on a card is the
CUDA context, the load (or the first build) of the kernel library
(:mod:`.ops.kernel_lib`) and the first launch of each kernel.
:func:`warmup` does all of that in the calling thread and reports each
step; :func:`prewarm_async` does it on a thread while pass 1 parses.

The engine's rate probes (``ops/bucket.py``: dispatch seconds, host to
device rate, host compare rate) stay where they are, at their first use
in pass 2: taken beside pass 1's busy cores they would read differently
and could move a bucket from one exact route to the other.

Warm-up launches count in ``kernel_lib.WARMUP_LAUNCHES``, never in the
wrappers' ``LAUNCHES``.  The thread's steps are the spans
``warmup.context``, ``warmup.library`` and ``warmup.launches``
(:mod:`.utils.trace`), children of the span that started the thread.
"""

import sys
import threading
import time
from typing import Optional

import numpy as np

from .utils import trace


def _first_touch(dev) -> None:
    """Create the CUDA context on ``dev`` (a no-op for the CPU device)."""
    import torch

    torch.zeros(1, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_hamming(dev, length: int, alphabet_size: int,
                    max_distance: int) -> None:
    """One launch each of the all-pairs kernel (as a tile and as a batch
    of buckets) and of the pair-list kernel's indexed entry (index pairs
    into a packed matrix, as the pipeline launches it), at a small shape
    of this key length."""
    import torch

    from .ops.encode import pack_nibbles
    from .ops.hamming_kernels import (
        _pad_dims,
        bucket_within_packed,
        rowwise_within_packed_indexed,
        within_tile_packed,
    )

    length = max(length, 1)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, max(min(alphabet_size, 15), 2),
                        size=(128, length), dtype=np.uint8)
    a = torch.from_numpy(rows).to(dev)
    within_tile_packed(a, a, alphabet_size, max_distance)
    l_pad, a_pad = _pad_dims(length, alphabet_size)
    batch = torch.full((2, 128, l_pad), 0xFF, dtype=torch.uint8, device=dev)
    batch[:, :, :length] = a
    bucket_within_packed(batch, length, max_distance, a_pad)
    lanes = max(-(-length // 8), 1)
    packed = torch.from_numpy(pack_nibbles(rows, lanes).view(np.int32)).to(dev)
    index = torch.arange(128, dtype=torch.int32, device=dev)
    rowwise_within_packed_indexed(packed, index, index.flip(0), max_distance)


def _launch_edit(dev, length: int, max_distance: int) -> None:
    """One launch of the edit kernel through each of its entries (paired
    rows, and index pairs into a key matrix) at the padded key length,
    and of each kernel of the card's candidate join over those keys, the
    second half copies of the first with one base changed."""
    import torch

    from .ops import edit_candidates
    from .ops.bucket import edit_window_plan
    from .ops.edit_kernels import (
        banded_within_edit_distance,
        banded_within_edit_distance_indexed,
    )

    length = max(length, 1)
    l_pad = -(-length // 16) * 16
    rng = np.random.default_rng(0)
    host = rng.integers(0, 4, size=(64, l_pad), dtype=np.uint8)
    host[32:] = host[:32]
    host[32:, length - 1] += 1
    keys = torch.from_numpy(host).to(dev)
    lens = torch.full((64,), length, dtype=torch.int32, device=dev)
    index = torch.arange(64, dtype=torch.int32, device=dev)
    banded_within_edit_distance(keys, lens, keys, lens, max_distance)
    banded_within_edit_distance_indexed(keys, lens, index, index.flip(0),
                                        max_distance)
    plan = edit_window_plan([host[:, :length]], [np.arange(64)],
                            max_distance)
    edit_candidates.join_codes(keys, plan)


def _launch_deflate(dev) -> None:
    """One launch of the deflate kernel: a short stream through the card
    writer into memory, after the writer's windows on ``dev`` are
    allocated (pinned host and device buffers, kept for the process)."""
    import io

    from .io.bgzf import DeviceBgzfWriter, prepare_device_windows

    prepare_device_windows(dev)
    with DeviceBgzfWriter(io.BytesIO(), dev) as writer:
        writer.write(b"@warm-up\nACGTACGTACGT\n+\nIIIIIIIIIIII\n")


def warmup(lengths=(32, 64, 128, 160), edit_distances=(1, 2),
           verbose: bool = True) -> None:
    """Create the context on the run's device (``runtime.device()``),
    build the kernel library if it is absent, load it and launch each of
    the four kernels once per key length (the edit kernel once per distance
    too) and the deflate kernel once, then wait for the device.  One line
    per step, with its seconds, goes to stderr.  Raises where the device,
    the build or a launch fails."""
    import torch

    from .ops import kernel_lib
    from .runtime import device

    dev = device()
    on_card = dev.type == "cuda"

    def step(label, fn):
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize(dev)
        if verbose:
            print(f"{label}: {time.perf_counter() - t0:.3f}s",
                  file=sys.stderr, flush=True)

    step(f"context on {dev}", lambda: _first_touch(dev))
    if on_card:
        step("kernel library build (skipped when the built one is current)",
             kernel_lib.build_kernels)
        step("kernel library load", kernel_lib.library)
    with kernel_lib.counting_as_warmup():
        if on_card:
            step("deflate kernel and the card writer's windows",
                 lambda: _launch_deflate(dev))
        for length in lengths:
            step(f"all-pairs and pair-list kernels L={length}",
                 lambda: _launch_hamming(dev, length, 5, 1))
            for d in edit_distances:
                step(f"edit kernel L={length} d={d}",
                     lambda: _launch_edit(dev, length, d))


class PrewarmThread(threading.Thread):
    """The thread :func:`prewarm_async` starts.  :meth:`join` raises
    what its work raised, once, so a build or launch failure reaches the
    run that asked for the warm-up."""

    def __init__(self, work):
        super().__init__(daemon=True, name="fastqdedup-prewarm")
        self._work = work
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._work()
        except BaseException as exc:  # kept, and raised at the join
            self.error = exc

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if not self.is_alive() and self.error is not None:
            error, self.error = self.error, None
            raise error


_prewarmed_geometries: set = set()
_prewarm_lock = threading.Lock()


def prewarm_async(length: int, alphabet_size: int = 5,
                  max_distance: int = 1,
                  use_edit_distance: bool = False
                  ) -> Optional[PrewarmThread]:
    """Create the CUDA context, load the kernel library and launch each
    kernel a dedup run of this geometry needs once (the edit kernel for
    ``use_edit_distance``, else the all-pairs and pair-list kernels), on
    a daemon thread; returns it started.  Run beside pass 1's ingest it
    takes these costs off the path to pass 2.

    The thread names its device explicitly (``runtime.device()``): the
    current CUDA device is a per-thread setting.  The caller joins the
    thread before pass 2 and on its error path, so that no CUDA call is
    in flight when the interpreter exits; the join raises what the work
    raised.

    Returns ``None`` when the run's device is not CUDA (the CPU device
    has nothing to bring up), and ``None`` from the second call on for
    one geometry: the context, the library and the loaded kernels stay
    for the life of the process.
    """
    from .runtime import device

    dev = device()
    if dev.type != "cuda":
        return None
    geometry = (length, alphabet_size, max_distance, use_edit_distance)
    with _prewarm_lock:
        if geometry in _prewarmed_geometries:
            return None
        _prewarmed_geometries.add(geometry)

    def work() -> None:
        import torch

        from .ops import kernel_lib

        with trace.span("warmup.context"):
            _first_touch(dev)
        with trace.span("warmup.library"):
            kernel_lib.library()
        with trace.span("warmup.launches"):
            with kernel_lib.counting_as_warmup():
                if use_edit_distance:
                    _launch_edit(dev, length, max_distance)
                else:
                    _launch_hamming(dev, length, alphabet_size,
                                    max_distance)
            torch.cuda.synchronize(dev)

    thread = PrewarmThread(trace.carry(work))
    thread.start()
    return thread


_deflate_prewarmed = False


def prewarm_deflate_async() -> Optional[PrewarmThread]:
    """Launch the deflate kernel once through the card writer, whose
    windows it allocates (pinned host buffers and their device twins,
    kept for the process), on a daemon thread; returns it started.  The
    pipeline asks for it beside pass 1's ingest where an output takes
    the card writer, and joins it before pass 3, so the pinning is off
    the path to pass 2 and the first job's pass 3 loads no module.

    Returns ``None`` when the run's device is not CUDA, and from the
    second call on: the windows stay for the life of the process.
    """
    global _deflate_prewarmed
    from .runtime import device

    dev = device()
    if dev.type != "cuda":
        return None
    with _prewarm_lock:
        if _deflate_prewarmed:
            return None
        _deflate_prewarmed = True

    def work() -> None:
        import torch

        from .ops import kernel_lib

        with trace.span("warmup.launches"):
            with kernel_lib.counting_as_warmup():
                _launch_deflate(dev)
            torch.cuda.synchronize(dev)

    thread = PrewarmThread(trace.carry(work))
    thread.start()
    return thread


if __name__ == "__main__":
    warmup()
