"""Scalar string-distance predicates (host reference path).

Behavioral parity target: ``/root/reference/src/fastqdedup/distances.h:8-88``
exposed through ``_distancemodule.c:46-93``.  Semantics:

* Hamming: defined only for equal-length strings; unequal lengths are never
  "within distance" (distances.h:16-20).
* Edit (Levenshtein): exact bounded test ``lev(s1, s2) <= max_distance``.
  The reference implements this as a branch-and-bound recursion; we use a
  banded dynamic program (band width ``2*max_distance + 1``), which computes
  the same predicate exactly.  The batched TPU formulation lives in
  ``fastqdedup_tpu.ops.edit``.

These scalar functions are the public drop-in API and the oracle used by the
cluster-dissection strategies; the bulk pipeline never calls them per-pair.
"""

_INF = 1 << 30


def hamming_distance(string1: str, string2: str) -> int:
    """Number of mismatching positions. Strings must have equal length."""
    if len(string1) != len(string2):
        raise ValueError("hamming_distance requires equal-length strings")
    return sum(c1 != c2 for c1, c2 in zip(string1, string2))


def _within_hamming(s1: str, s2: str, max_distance: int) -> bool:
    if len(s1) != len(s2):
        return False
    budget = max_distance
    for c1, c2 in zip(s1, s2):
        if c1 != c2:
            budget -= 1
            if budget < 0:
                return False
    return True


def _within_levenshtein(s1: str, s2: str, max_distance: int) -> bool:
    """Exact test lev(s1, s2) <= max_distance via a banded DP.

    Truth table pinned by the reference's tests
    (/root/reference/tests/test__distance.py:37-60), e.g.
    lev("GC", "AAAGC") == 3 and lev("ABCDE", "ABDEF") == 2.
    """
    len1, len2 = len(s1), len(s2)
    if abs(len1 - len2) > max_distance:
        return False
    if max_distance < 0:
        return False
    # Strip common prefix: consuming equal leading characters never changes
    # the Levenshtein distance.
    start = 0
    while start < len1 and start < len2 and s1[start] == s2[start]:
        start += 1
    s1, s2 = s1[start:], s2[start:]
    len1, len2 = len1 - start, len2 - start
    if not len1 or not len2:
        return max(len1, len2) <= max_distance
    d = max_distance
    # row[j] = distance between s1[:i] and s2[:j], kept only within the band
    # |i - j| <= d; cells outside the band are effectively infinite.
    prev = [j if j <= d else _INF for j in range(len2 + 1)]
    for i in range(1, len1 + 1):
        lo = max(1, i - d)
        hi = min(len2, i + d)
        row = [_INF] * (len2 + 1)
        row[lo - 1] = i if (lo - 1 == 0 and i <= d) else _INF
        for j in range(lo, hi + 1):
            cost = 0 if s1[i - 1] == s2[j - 1] else 1
            best = prev[j - 1] + cost  # substitution / match
            if prev[j] + 1 < best:     # deletion from s1
                best = prev[j] + 1
            if row[j - 1] + 1 < best:  # insertion into s1
                best = row[j - 1] + 1
            row[j] = best
        prev = row
        if min(prev[lo - 1:hi + 1]) > d:
            return False
    return prev[len2] <= d


def within_distance(string1: str, string2: str, max_distance: int,
                    use_edit_distance: bool = False) -> bool:
    """True iff the strings are within ``max_distance`` of each other.

    Drop-in equivalent of ``fastqdedup._distance.within_distance``
    (_distancemodule.c:46-93).
    """
    if not isinstance(string1, str) or not isinstance(string2, str):
        raise TypeError("string1 and string2 must be str")
    if use_edit_distance:
        return _within_levenshtein(string1, string2, max_distance)
    return _within_hamming(string1, string2, max_distance)
