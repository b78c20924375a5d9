"""Record-at-a-time compatibility helpers matching the reference API.

Counterpart of ``fastqdedup_tpu/compat.py``.  These mirror the reference's
streaming helpers exactly (its ``__init__.py:189-206``) for users who
called them directly.  The pipeline itself uses the vectorized chunked
equivalents in ``pipeline.py``.
"""

import contextlib
from typing import Any, Callable, Iterable, List, Set

from .io.fastq import FastqRecord, file_to_fastq_reader
from .io.opener import xopen


def filter_fastq_files_on_set(
        input_files: List[str],
        output_files: List[str],
        filter_set: Set[Any],
        keyfunc: Callable[[Iterable[FastqRecord]], Any]) -> None:
    """Write the first record tuple matching each key in ``filter_set``."""
    input_readers = [file_to_fastq_reader(f) for f in input_files]
    with contextlib.ExitStack() as stack:
        writers = [stack.enter_context(
            contextlib.closing(xopen(f, "wb", compresslevel=1)))
            for f in output_files]
        for records in zip(*input_readers):
            key = keyfunc(records)
            if key in filter_set:
                filter_set.remove(key)
                for writer, record in zip(writers, records):
                    writer.write(record.fastq_bytes())
