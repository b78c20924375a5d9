"""Command-line interface.

Exact flag surface of the reference
(/root/reference/src/fastqdedup/__init__.py:305-412): positional FASTQ files,
-l/--check-lengths, -o/--output (repeatable), -p/--prefix, -d/--max-distance,
-e/--max-average-error-rate, -E, --edit, -c/--cluster-dissection-method,
-v/-q verbosity stacking — so reference invocations work unchanged.

Counterpart of ``fastqdedup_tpu/cli.py``; installed as the
``fastqdedup-tpu-torch`` console script.
"""

import argparse
import contextlib
import logging
import os
import resource

from .dissect import CLUSTER_DISSECTION_METHODS
from .keys import length_string_to_slices
from .pipeline import (
    DEFAULT_MAX_AVERAGE_ERROR_RATE,
    DEFAULT_MAX_DISTANCE,
    deduplicate_cluster,
)
from .utils.timing import Timer

DEFAULT_PREFIX = "fastqdedup_R"
DEFAULT_CLUSTER_DISSECTION = "directional"


def initiate_logger(verbose: int = 0, quiet: int = 0) -> None:
    log_level = logging.INFO - 10 * (verbose - quiet)
    logger = logging.getLogger("fastqdedup")
    logger.setLevel(log_level)
    console_handler = logging.StreamHandler()
    console_handler.setLevel(log_level)
    formatter = logging.Formatter(
        "{asctime}:{levelname}:{name}: {message}",
        datefmt="%m/%d/%Y %I:%M:%S",
        style="{")
    console_handler.setFormatter(formatter)
    logger.addHandler(console_handler)


def argument_parser() -> argparse.ArgumentParser:
    # Flags, defaults, metavars and dest names mirror the reference parser
    # (__init__.py:305-361) so existing invocations keep working; the help
    # prose is this project's own.
    parser = argparse.ArgumentParser(
        epilog="Advanced environment knobs (see README for the full list): "
               "FASTQDEDUP_TORCH_DEVICE=<device> picks the torch device "
               "(default cuda; without CUDA the run fails unless cpu is "
               "asked for); FASTQDEDUP_PROFILE=<dir> captures a "
               "torch.profiler trace; FASTQDEDUP_INGEST_READERS=<n> sets "
               "parallel BGZF range readers.")
    parser.add_argument(
        "fastq", metavar="FASTQ", nargs="+",
        help="Input FASTQ file(s): R1, optionally followed by an R2 mate "
             "file and/or a separate UMI file.")
    parser.add_argument(
        "-l", "--check-lengths",
        help="How much of each file's sequence takes part in the duplicate "
             "check, as one comma-separated entry per input file. With "
             "'--check-lengths 16,8' on paired files, only R1's first 16 "
             "and R2's first 8 bases are compared. Python slice syntax is "
             "also accepted ('4:8', '::8').")
    parser.add_argument(
        "-o", "--output", action="append", required=False,
        help="Deduplicated output path; repeat the flag once per input "
             "file ('-o out_R1.fastq.gz -o out_R2.fastq.gz'). When omitted, "
             "names are derived from --prefix.")
    parser.add_argument(
        "-p", "--prefix", default=DEFAULT_PREFIX,
        help=f"Output filename prefix used when no -o options are given "
             f"(files become <prefix><n>.fastq.gz). "
             f"Default: '{DEFAULT_PREFIX}'")
    parser.add_argument(
        "-d", "--max-distance", type=int, default=DEFAULT_MAX_DISTANCE,
        help="Keys that differ by more than this many substitutions "
             "(Hamming distance) count as distinct molecules. "
             f"Default: {DEFAULT_MAX_DISTANCE}.")
    parser.add_argument(
        "-e", "--max-average-error-rate", type=float,
        default=DEFAULT_MAX_AVERAGE_ERROR_RATE,
        help="Drop records whose mean per-base error rate (over the bases "
             "selected by --check-lengths) exceeds this threshold."
             f"Default: {DEFAULT_MAX_AVERAGE_ERROR_RATE}")
    parser.add_argument(
        "-E", "--no-average-error-rate-filter", action="store_const",
        dest="max_average_error_rate", const=1.0,
        help="Disable the per-record error-rate filter entirely.")
    parser.add_argument(
        "--edit", action="store_true",
        help="Compare keys by Levenshtein (edit) distance, which also "
             "tolerates insertions/deletions, instead of Hamming distance.")
    parser.add_argument(
        "-c", "--cluster-dissection-method",
        choices=CLUSTER_DISSECTION_METHODS.keys(),
        default=DEFAULT_CLUSTER_DISSECTION,
        help="Strategy for picking representative reads from a cluster of "
             "near-duplicates: 'highest_count' keeps just the most frequent "
             "read; 'adjacency' repeatedly keeps the most frequent "
             "remaining read and drops everything within the distance "
             "threshold of it; 'directional' (default) additionally "
             "requires a count ratio consistent with PCR/sequencing error "
             "before dropping a read.")
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="More verbose logging (stackable).")
    parser.add_argument("-q", "--quiet", action="count", default=0,
                        help="Less verbose logging (stackable).")
    return parser


@contextlib.contextmanager
def _maybe_profile():
    """Capture a torch.profiler trace when FASTQDEDUP_PROFILE=<dir> is set
    (host and CUDA activity as a Chrome trace; open with Perfetto or
    chrome://tracing).  The reference's only observability was coarse
    phase timers (__init__.py:42-51); those still log at INFO."""
    trace_dir = os.environ.get("FASTQDEDUP_PROFILE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"fastqdedup.{os.getpid()}.trace.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    logging.getLogger("fastqdedup").info(
        f"Wrote torch profiler trace to {path}")


def main() -> None:
    from .runtime import tune_host_allocator
    tune_host_allocator()
    args = argument_parser().parse_args()
    initiate_logger(args.verbose, args.quiet)
    logger = logging.getLogger("fastqdedup")
    # Under torchrun every process joins the job here; a lone process
    # stays single-process.
    from .parallel.distributed import initialize_distributed
    initialize_distributed()

    input_files = args.fastq
    check_slices = (length_string_to_slices(args.check_lengths)
                    if args.check_lengths else None)
    output_files = args.output or [
        args.prefix + str(x) + ".fastq.gz"
        for x in range(1, len(input_files) + 1)]
    cluster_dissection_func = CLUSTER_DISSECTION_METHODS[
        args.cluster_dissection_method]
    distance_name = "Levenshtein" if args.edit else "Hamming"
    timer = Timer()
    logger.info(f"Input files: {', '.join(input_files)}")
    logger.info(f"Output files: {', '.join(output_files)}")
    logger.info(f"Check lengths: {args.check_lengths}")
    logger.info(f"Maximum {distance_name} distance: {args.max_distance}")
    logger.info(f"Maximum average error rate: {args.max_average_error_rate}")
    logger.info(f"Cluster dissection method: "
                f"{args.cluster_dissection_method}")
    with _maybe_profile():
        deduplicate_cluster(input_files, output_files, check_slices,
                            args.max_distance, args.max_average_error_rate,
                            cluster_dissection_func, args.edit)
    resources = resource.getrusage(resource.RUSAGE_SELF)
    logger.info(f"Finished. Total time: {timer.get_difference()}. "
                f"Memory usage: {resources.ru_maxrss / (1024 ** 2):.2} GiB")
