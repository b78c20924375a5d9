"""pass3.deflate_device_share: percent of the uncompressed bytes deflated
in the window that the card deflated (the program's
``bytes.deflate.device`` over ``bytes.deflate.device`` plus
``bytes.deflate.host`` counters, counted where each writer takes a
window or a block).  Nothing where nothing was deflated, or where the
program counts neither."""

from benchmark import program_spans


def read(trace):
    counts = program_spans.window_counts(trace)
    if counts is None:
        return None
    device = counts.get("bytes.deflate.device", 0)
    host = counts.get("bytes.deflate.host", 0)
    return 100.0 * device / (device + host) if device + host else None
