"""Check-key construction from FASTQ records.

Parity target: the reference's slice machinery
(/root/reference/src/fastqdedup/__init__.py:160-167, 364-375): a
``--check-lengths`` string like ``"16,8"`` or ``"4:8,::8"`` becomes one slice
per input file; the dedup key is the concatenation of each file's sequence
sliced by its slice.  The same join function is applied to the quality
strings for the average-error-rate filter.
"""

from typing import Callable, Iterable, List, Optional


def _parse_slice_field(field: str) -> Optional[int]:
    return None if field in ("", "None") else int(field)


def length_string_to_slices(length_string: str) -> List[slice]:
    """Convert ``"8,8:16,::-1"``-style strings to a list of slice objects.

    Comma-separated entries, one per input file; each entry is either a
    plain length ``N`` (meaning ``:N``) or full ``start:stop:step`` slice
    notation with empty/``None`` fields allowed (capability of reference
    ``__init__.py:364-375``).
    """
    return [slice(*map(_parse_slice_field, entry.split(":")))
            for entry in length_string.split(",")]


def joinfunc_from_check_slices(
        check_slices: Iterable[slice]) -> Callable[[Iterable[str]], str]:
    """Build the key function: slice each string, concatenate the pieces."""
    slices = list(check_slices)

    def joinfunc(strings: Iterable[str]) -> str:
        return "".join(string[slc] for string, slc in zip(strings, slices))

    return joinfunc


def make_keyfunc(check_slices: Optional[List[slice]]
                 ) -> Callable[[Iterable[str]], str]:
    """Key function for a list of per-file strings; identity-concat when no
    check slices are given (reference __init__.py:229-232)."""
    if check_slices:
        return joinfunc_from_check_slices(check_slices)
    return "".join
