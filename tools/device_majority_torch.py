#!/usr/bin/env python3
"""Share of candidate pairs verified on the card, end to end: the
counterpart of ``tools/device_majority.py``.

The host/device crossover of the Hamming path (``ops/bucket.py``) sends
each bucket size, and each pair list, to whichever side is cheaper by
rates it measures once per process: a device round trip
(``FASTQDEDUP_DISPATCH_S``) and the host-to-device copy rate
(``FASTQDEDUP_H2D_RATE``).  This tool runs two realistic inputs of 1M
x 100 bp (``chip_smoke.generate_fastq``, seed 7) end to end, each twice:
with the rates measured on this card, and with the two knobs set to the
JAX tool's figures for a chip attached to its host locally (100 us a
round trip, 8 GB/s), the measured-rate caches cleared between runs.
It sums ``pairs host=H device=D`` over the pipeline's DEBUG lines
(``bucketed-pairs[...]``), checks that both runs of an input write the
same bytes, and prints one JSON line.  It passes when every input holds
parity and more than half of ``deepseq_30x``'s pairs go to the device
under the knobs; otherwise it exits 1.

- ``standard_5x``: the bench profile (5x duplication, 15% of reads with
  one substitution): sparse candidate pairs.
- ``deepseq_30x``: deep amplicon sequencing (30x PCR duplication,
  1% per-base error): a denser candidate graph.

Usage: python tools/device_majority_torch.py [n_reads]
Without a card it exits 2 (``FASTQDEDUP_TORCH_DEVICE=cpu`` runs it on
the CPU device).
"""
import json
import logging
import os
import re
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROFILES = {
    "standard_5x": {"dup_factor": 5, "error_rate": None},
    "deepseq_30x": {"dup_factor": 30, "error_rate": 0.01},
}
# tools/device_majority.py's emulated locally attached chip.
LOCAL_RATES = {"FASTQDEDUP_DISPATCH_S": "0.0001",
               "FASTQDEDUP_H2D_RATE": "8e9"}


class _SplitCapture(logging.Handler):
    """Sums 'pairs host=H device=D' over the DEBUG lines of a run."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.host = 0
        self.device = 0

    def emit(self, record):
        m = re.search(r"pairs host=(\d+) device=(\d+)", record.getMessage())
        if m:
            self.host += int(m.group(1))
            self.device += int(m.group(2))


def run_once(inp: str, out: str, knobs: bool, dev) -> dict:
    import torch

    import chip_smoke
    from fastqdedup_tpu_torch.ops import bucket
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    for key, value in LOCAL_RATES.items():
        if knobs:
            os.environ[key] = value
        else:
            os.environ.pop(key, None)
    # The rates are cached per process: clear them so that the knobs, or
    # their removal, take effect in this run.
    bucket._dispatch_cache.clear()
    bucket._h2d_rate_cache.clear()
    cap = _SplitCapture()
    logger = logging.getLogger("fastqdedup")
    old_level = logger.level
    logger.setLevel(logging.DEBUG)
    logger.addHandler(cap)
    chip_smoke.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        deduplicate_cluster([inp], [out], None, 1, 0.001)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(cap)
        logger.setLevel(old_level)
    return {"wall_s": wall, "pairs_host": cap.host,
            "pairs_device": cap.device,
            "launches": chip_smoke.launch_counts(),
            "sha256": chip_smoke.decompressed_sha256(out)}


def main() -> int:
    import chip_smoke

    dev = chip_smoke.run_device_or_exit("device_majority_torch")
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    workdir = tempfile.mkdtemp(prefix="fastqdedup_devmaj_torch_")
    report = {}
    try:
        for name, profile in PROFILES.items():
            inp = os.path.join(workdir, f"in_{name}.fastq.gz")
            chip_smoke.generate_fastq(inp, n_reads, 100, 12, seed=7,
                                      **profile)
            runs = {}
            for tag, knobs in (("measured_rates", False),
                               ("local_chip_rates", True)):
                out = os.path.join(workdir, f"out_{name}_{tag}.fastq.gz")
                run_once(inp, out, knobs, dev)       # warm
                run = run_once(inp, out, knobs, dev)
                run["reads_per_s"] = n_reads / run["wall_s"]
                runs[tag] = run
                print(f"{name}/{tag}: {run['wall_s']:.2f}s, pairs "
                      f"host={run['pairs_host']} "
                      f"device={run['pairs_device']}", file=sys.stderr)
            local = runs["local_chip_rates"]
            total = local["pairs_host"] + local["pairs_device"]
            report[name] = {
                "device_pair_fraction":
                    local["pairs_device"] / total if total else 0.0,
                "parity": runs["measured_rates"]["sha256"]
                == local["sha256"],
                "runs": runs,
            }
    finally:
        for key in LOCAL_RATES:
            os.environ.pop(key, None)
        shutil.rmtree(workdir, ignore_errors=True)
    ok = (report["deepseq_30x"]["device_pair_fraction"] > 0.5
          and all(r["parity"] for r in report.values()))
    print(json.dumps({
        "metric": "device_majority_e2e",
        "device": chip_smoke.describe_device(dev),
        "n_reads": n_reads,
        "knobs": LOCAL_RATES,
        "configs": report,
        "pass": ok,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
