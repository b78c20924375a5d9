#!/usr/bin/env python3
"""Sustained runs of the PyTorch + CUDA port at large inputs: the
counterpart of ``tools/hunt100m.py``.

Generates (once, kept at its path) the standard input of the bench
(``chip_smoke.generate_fastq``: 100 bp, seed 7, 5x duplication, ~15% of
reads with one substitution), then runs the whole dedup pipeline
repeatedly in one process, on the card: the steady state a long-lived
service sees.  Per repetition it prints the wall time, the sha256 of the
decompressed output (all of it, every repetition: the run stops at the
first that differs, or that differs from the JAX package's pinned value
where the input has one: ``default-10m`` / ``edit-10m`` at 10M reads,
``default`` / ``edit`` at 1M), fresh page mappings, CPU time, the peak
host RSS so far, the card's peak allocated memory in the repetition, the
pinned host memory that torch's caching host allocator holds (blocks
rounded up to powers of two; it keeps every block it made) and the
kernel launches; at the end one JSON summary line with the median and
best of the steady repetitions (repetition 0 is the cold one and is left
out of the median) and the host's memory (``/proc/meminfo``), to size a
larger run by.

Usage: python tools/hunt100m_torch.py [reps] [input.fastq.gz]
Env: HUNT_READS (default 10_000_000), HUNT_EDIT=1 for ``--edit``,
HUNT_DEBUG=1 for the pipeline's DEBUG log on stderr.  The input defaults
to ``hunt_<reads>.fastq.gz`` in the temporary directory.  Without a card
it exits 2 (``FASTQDEDUP_TORCH_DEVICE=cpu`` runs it on the CPU device).
"""

import logging
import os
import resource
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def mem_total_bytes() -> int:
    with open("/proc/meminfo") as f:
        for row in f:
            if row.startswith("MemTotal:"):
                return int(row.split()[1]) * 1024
    return 0


def pinned_host_bytes() -> dict:
    """Bytes of pinned host blocks torch's caching host allocator holds
    now and at its peak (empty when this torch does not report them)."""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", dict)()
    return {key: stats[key] for key in ("allocated_bytes.current",
                                        "allocated_bytes.peak")
            if key in stats}


def main() -> int:
    import torch

    import bench_torch
    import chip_smoke

    dev = chip_smoke.run_device_or_exit("hunt100m_torch")
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    n_reads = int(os.environ.get("HUNT_READS", 10_000_000))
    src = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        tempfile.gettempdir(), f"hunt_{n_reads}.fastq.gz")
    use_edit = os.environ.get("HUNT_EDIT") == "1"
    if os.environ.get("HUNT_DEBUG") == "1":
        logging.basicConfig(level=logging.DEBUG,
                            format="%(relativeCreated)8.0fms %(message)s")

    generate_s = None
    if not os.path.exists(src):
        print(f"generating {n_reads} reads at {src} ...", file=sys.stderr)
        t0 = time.perf_counter()
        chip_smoke.generate_fastq(src, n_reads, 100, 12)
        generate_s = time.perf_counter() - t0
        print(f"generated in {generate_s:.0f}s", file=sys.stderr)
    pinned = bench_torch.PINNED.get((n_reads, 100, 12, "directional"))
    expected = chip_smoke.EXPECTED_SHA256[pinned[int(use_edit)]] \
        if pinned else None

    from fastqdedup_tpu_torch.dissect import CLUSTER_DISSECTION_METHODS
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    out = src + (".edit" if use_edit else "") + ".dedup.fastq.gz"
    if dev.type == "cuda":
        torch.cuda.init()  # the allocator's statistics exist from here
    walls, shas, rows = [], set(), []
    for r in range(reps):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        chip_smoke.reset_launch_counts()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        deduplicate_cluster([src], [out], None, 1, 0.001,
                            CLUSTER_DISSECTION_METHODS["directional"],
                            use_edit)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        sha = chip_smoke.decompressed_sha256(out)
        shas.add(sha)
        walls.append(wall)
        row = {"rep": r, "wall_s": wall, "reads_per_s": n_reads / wall,
               "sha256": sha,
               "minflt": ru1.ru_minflt - ru0.ru_minflt,
               "cpu_s": ru1.ru_utime - ru0.ru_utime
               + ru1.ru_stime - ru0.ru_stime,
               "peak_rss_bytes": ru1.ru_maxrss * 1024,
               "device_peak_allocated_bytes":
                   torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else None,
               "pinned_host_bytes": pinned_host_bytes()
                   if dev.type == "cuda" else None,
               "launches": chip_smoke.launch_counts()}
        rows.append(row)
        print(f"rep {r}: {wall:.1f}s  {n_reads / wall / 1e3:.0f}k reads/s"
              f"  sha {sha[:16]}  minflt {row['minflt']}"
              f"  cpu {row['cpu_s']:.0f}s"
              f"  rss {row['peak_rss_bytes'] / 2**30:.2f} GiB", flush=True)
        if len(shas) != 1:
            print(f"hunt100m_torch: output changed between reps: {shas}",
                  file=sys.stderr)
            return 1
        if expected is not None and sha != expected:
            print(f"hunt100m_torch: output sha256 {sha} != the JAX "
                  f"package's {expected}", file=sys.stderr)
            return 1
    steady = walls[1:] or walls
    median = statistics.median(steady)
    chip_smoke.emit({
        "metric": f"{n_reads} reads sustained "
                  f"({'edit' if use_edit else 'hamming'})",
        "device": chip_smoke.describe_device(dev),
        "reads": n_reads,
        "generate_s": generate_s,
        "reps_s": walls,
        "steady_median_s": median,
        "steady_median_reads_per_sec": n_reads / median,
        "best_s": min(walls),
        "best_reads_per_sec": n_reads / min(walls),
        "sha256": sorted(shas)[0],
        "sha256_expected": expected,
        "peak_rss_bytes": max(row["peak_rss_bytes"] for row in rows),
        "device_peak_allocated_bytes": [
            row["device_peak_allocated_bytes"] for row in rows],
        "pinned_host_bytes": [row["pinned_host_bytes"] for row in rows],
        "launches_per_rep": [row["launches"] for row in rows],
        "host_mem_total_bytes": mem_total_bytes(),
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
