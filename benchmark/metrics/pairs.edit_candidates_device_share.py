"""pairs.edit_candidates_device_share: percent of the ``--edit`` route's
window rows joined in the window that the card joined (the program's
``pairs.edit_rows.device`` over ``pairs.edit_rows.device`` plus
``pairs.edit_rows.host`` counters, counted where each join runs).
Nothing where no window row was joined, or where the program counts
neither."""

from benchmark import program_spans


def read(trace):
    counts = program_spans.window_counts(trace)
    if counts is None:
        return None
    device = counts.get("pairs.edit_rows.device", 0)
    host = counts.get("pairs.edit_rows.host", 0)
    return 100.0 * device / (device + host) if device + host else None
