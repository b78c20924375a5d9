"""The comparison that decides ``correct``: the decompressed outputs of
a run's jobs (the first, a sample drawn from the seed, the last; see
``harness.Jobs``) against the plain reference's, record by record.

The number compared is the count of wrong records: those the reference
writes and the output lacks, those the output writes and the reference
does not, copies, and records out of file order; the most over the
compared jobs and their output files.  Its limit is 0: the output is
exact.
"""

import hashlib
from typing import Dict, List, Sequence, Tuple

from .reference.dedup import gunzip

LIMIT = 0


def _records(data: bytes) -> List[bytes]:
    lines = data.split(b"\n")
    return [b"\n".join(lines[i:i + 4]) for i in range(0, len(lines) - 1, 4)]


def records_differing(got: bytes, want: bytes) -> int:
    """Wrong answers in ``got``: the records missing from it or not in
    ``want`` (every record names its read, so records are distinct), a
    record written twice once for each copy, and where both hold the
    same records, those out of place."""
    if got == want:
        return 0
    a, b = _records(got), _records(want)
    sa, sb = set(a), set(b)
    repeats = len(a) - len(sa)
    if sa != sb:
        return len(sa ^ sb) + repeats
    return sum(x != y for x, y in zip(a, b)) + repeats


def first_difference(got: bytes, want: bytes) -> str:
    """Where ``got`` first departs from ``want``, for the log."""
    a, b = _records(got), _records(want)
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return (f"record {i} of {len(a)} (reference {len(b)}): "
                    f"{x[:60]!r} where the reference has {y[:60]!r}")
    return f"{len(a)} records where the reference has {len(b)}"


def compare_jobs(job_outputs: Sequence[Tuple[int, Sequence[str]]],
                 want: Sequence[bytes], log=print) -> int:
    """The most records differing over ``job_outputs`` (job number, the
    job's output paths, one a reference output).  Outputs whose bytes
    repeat an earlier job's are not compared again."""
    worst = 0
    seen: Dict[str, int] = {}
    for number, paths in job_outputs:
        for path, expected in zip(paths, want, strict=True):
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest not in seen:
                got = gunzip(path)
                seen[digest] = records_differing(got, expected)
                if seen[digest]:
                    log(f"job {number}: {seen[digest]} records differ; "
                        f"{first_difference(got, expected)}")
            worst = max(worst, seen[digest])
    return worst
