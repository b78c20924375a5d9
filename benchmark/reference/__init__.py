"""Plain NumPy reference of a fastqdedup run, independent of the program.

It reads the same input files the program read and works out, from
those files alone, what the upstream tool (rhpvorderman/fastqdedup)
writes for the same command line: the quality filter and keys (pass 1),
every pair of distinct keys within the distance, directional (or
adjacency, or highest-count) dissection (pass 2), and the first record
in file order of each kept key (pass 3).  See :mod:`.dedup`.
"""

from .dedup import expected_outputs, parse_args

__all__ = ["expected_outputs", "parse_args"]
