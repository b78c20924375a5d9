"""Host I/O: FASTQ parsing/writing with transparent gzip support."""

from .fastq import (  # noqa: F401
    FastqFormatError,
    FastqReader,
    FastqRecord,
    FastqWriter,
    file_to_fastq_reader,
    fastq_files_to_records,
    records_are_mates,
)
from .opener import xopen  # noqa: F401
