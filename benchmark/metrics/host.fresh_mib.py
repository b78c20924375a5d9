"""host.fresh_mib: MiB a window job takes from the host as fresh
mappings where the program's buffer pool had no buffer of the size
(the ``pool.fresh_bytes`` counter of ``runtime.big_empty``); the mean
over the window's jobs."""

from benchmark import program_spans


def read(trace):
    counts = program_spans.window_counts(trace)
    if counts is None or not trace.jobs:
        return None
    return counts.get("pool.fresh_bytes", 0) / len(trace.jobs) / 2 ** 20
