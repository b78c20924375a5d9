"""The yardstick of the kernels' roofline shares: the card's peaks and the
bytes each kernel's problem must move.

Copied from ``chip_smoke.kernel_bound`` / ``rowwise_cost`` /
``banded_cost`` and cut down to the problem's bytes: each distinct key a
launch compares read once, at 2 bits a base (keys over A, C, G, T), the
edit kernel's key lengths read once (1 byte each), and one result byte a
pair.  No index bytes and no operation term: how pairs reach a kernel,
and how many operations its algorithm spends, belong to one
implementation, and a better one must read as a larger share of the same
bound, never as a smaller bound.
"""

from typing import Iterable

import numpy as np

# Published peak of one H100 SXM (NVIDIA's data sheet, 700 W).
H100_BYTES_PER_S = 3.35e12
BITS_PER_BASE = 2

# The port's device kernels, by the name of the wrapper that launches
# them (the name ``LAUNCHES`` counts under); a profiler row belongs to a
# kernel when its name holds one of these.
DEVICE_KERNELS = {
    "bucket_within_packed": ("pairs_within_mma_kernel",
                             "pairs_within_simt_kernel"),
    "within_tile_packed": ("pairs_within_mma_kernel",
                           "pairs_within_simt_kernel"),
    "rowwise_within_packed": ("rowwise_within_kernel",
                              "rowwise_within_indexed_kernel"),
    "banded_within_edit_distance": ("within_edit_kernel",),
}
ALL_DEVICE_KERNELS = tuple(sorted({name for names in DEVICE_KERNELS.values()
                                   for name in names} | {"empty_kernel"}))


def key_bytes(lengths: Iterable[int]) -> int:
    """Bytes of keys of these lengths at 2 bits a base."""
    lens = np.asarray(list(lengths), dtype=np.int64)
    return int((-(-lens * BITS_PER_BASE // 8)).sum())


def rowwise_bytes(pairs: int, row_lengths: Iterable[int]) -> int:
    """Problem bytes of one pair-list launch: each distinct key (of these
    lengths) once, one result byte a pair."""
    return key_bytes(row_lengths) + pairs


def banded_bytes(pairs: int, row_lengths: Iterable[int]) -> int:
    """Problem bytes of one edit-distance launch: each distinct key and
    its length (1 byte) once, one result byte a pair."""
    lens = list(row_lengths)
    return key_bytes(lens) + len(lens) + pairs


def launch_bytes(launch) -> int:
    """Problem bytes of one recorded launch (``trace.Launch``)."""
    rows = np.unique(np.concatenate([launch.rows_i, launch.rows_j]))
    pairs = len(launch.rows_i)
    if launch.kernel == "banded_within_edit_distance":
        return banded_bytes(pairs, np.asarray(launch.lengths)[rows])
    return rowwise_bytes(pairs, [int(launch.lengths)] * len(rows))


def bound_seconds(nbytes: int) -> float:
    """Least time the card could take to move ``nbytes``."""
    return nbytes / H100_BYTES_PER_S


def matches(event_name: str, names: Iterable[str]) -> bool:
    """Whether a profiler row's name is one of these device kernels."""
    return any(name in event_name for name in names)


def window_share(trace, kernel: str):
    """Percent of its bound that ``kernel`` reaches over the window of a
    traced run: the summed problem bytes of its recorded launches over
    the peak rate, against its summed device time; None where it did not
    run."""
    launches = [x for x in trace.launches if x.kernel == kernel
                and trace.window[0] <= x.at <= trace.window[1]]
    events = trace.window_device("kernel", DEVICE_KERNELS[kernel])
    busy_ns = sum(e.end - e.start for e in events)
    if not launches or not busy_ns:
        return None
    bound_s = bound_seconds(sum(launch_bytes(x) for x in launches))
    return 100.0 * bound_s / (busy_ns / 1e9)
