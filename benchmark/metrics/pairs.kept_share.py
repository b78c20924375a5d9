"""pairs.kept_share: percent of the candidate pairs verified in the
window, on the host and on the card, that were within distance (the
program's ``pairs.kept.*`` over ``pairs.candidates.*`` counters): useful
verifications per attempt.  Nothing where no candidate was counted."""

from benchmark import program_spans

SIDES = ("host", "device")


def read(trace):
    counts = program_spans.window_counts(trace)
    if counts is None:
        return None
    candidates = sum(counts.get(f"pairs.candidates.{s}", 0) for s in SIDES)
    kept = sum(counts.get(f"pairs.kept.{s}", 0) for s in SIDES)
    return 100.0 * kept / candidates if candidates else None
