"""Native (C) acceleration layer.

Provides a C chunk-parser for FASTQ ingest (built via setuptools /
ctypes; see fastqdedup_tpu/native/_fastq_io.c).  Importing
``read_fastq_chunks_native`` raises ImportError when the extension has not
been built, and callers fall back to the pure-Python parser.
"""

from .loader import read_fastq_chunks_native  # noqa: F401
