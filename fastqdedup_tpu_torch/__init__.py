"""fastqdedup_tpu_torch — the PyTorch + CUDA port of fastqdedup_tpu.

The same deduplication pipeline as ``fastqdedup_tpu``, with pass 2's
device work on a torch device (``FASTQDEDUP_TORCH_DEVICE``, default
``cuda``) through hand-written Hopper kernels (``csrc/hamming.cu`` for
Hamming distance, ``csrc/edit.cu`` for the Levenshtein ``--edit`` mode).
The JAX package stays the reference this port is checked against;
nothing here imports jax.

The public surface mirrors the JAX package's: ``Trie``,
``within_distance``, ``average_error_rate``, the three
``cluster_dissection_*`` strategies, ``length_string_to_slices``,
``deduplicate_cluster``, ``trie_stats``, ``filter_fastq_files_on_set``
and ``main``.
"""

from .dissect import (  # noqa: F401
    CLUSTER_DISSECTION_METHODS,
    ClusterDissectionFunc,
    cluster_dissection_adjacency,
    cluster_dissection_directional,
    cluster_dissection_highest_count,
)
from .distance import hamming_distance, within_distance  # noqa: F401
from .keys import (  # noqa: F401
    joinfunc_from_check_slices,
    length_string_to_slices,
)
from .quality import (  # noqa: F401
    DEFAULT_PHRED_OFFSET,
    average_error_rate,
)
from .trie import Trie  # noqa: F401

__version__ = "0.1.0"

DEFAULT_PREFIX = "fastqdedup_R"
DEFAULT_MAX_DISTANCE = 1
DEFAULT_CLUSTER_DISSECTION = "directional"
DEFAULT_MAX_AVERAGE_ERROR_RATE = 0.001


def __getattr__(name):
    # Lazy imports keep the pipeline, the CLI and the I/O stack out of
    # `import fastqdedup_tpu_torch` until they are asked for.
    if name in ("deduplicate_cluster",):
        from .pipeline import deduplicate_cluster
        return deduplicate_cluster
    if name in ("main", "argument_parser", "initiate_logger"):
        from . import cli
        return getattr(cli, name)
    if name == "trie_stats":
        from .stats import trie_stats
        return trie_stats
    if name == "Timer":
        from .utils.timing import Timer
        return Timer
    if name in ("fastq_files_to_records", "file_to_fastq_reader"):
        from .io import fastq
        return getattr(fastq, name)
    if name == "filter_fastq_files_on_set":
        from .compat import filter_fastq_files_on_set
        return filter_fastq_files_on_set
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
