"""pass1.split_share: percent of pass 1's range-reader parts in the
window that were opened at a member split, with no newline count (the
program's ``pass1.parts.split`` over ``pass1.parts.split`` plus
``pass1.parts.counted`` counters, counted where pass 1 plans its
readers).  Nothing where no part was planned, or where the program
counts neither."""

from benchmark import program_spans


def read(trace):
    counts = program_spans.window_counts(trace)
    if counts is None:
        return None
    split = counts.get("pass1.parts.split", 0)
    counted = counts.get("pass1.parts.counted", 0)
    return 100.0 * split / (split + counted) if split + counted else None
