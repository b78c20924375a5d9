#!/usr/bin/env python3
"""Per-stage profile of a P-process run of the PyTorch + CUDA port (a
developer tool): the counterpart of ``tools/scale_profile.py``.

Launches P pinned processes of one ``torch.distributed`` job on one
generated input, as ``bench_scaling_torch.py`` does (4 BGZF shards,
sharded-input mode, every process on ``cuda:0``), with DEBUG logging,
and keeps every process's whole log as ``scale_P{P}_proc{i}.log`` in
the log directory, so that the stage budget of a multi-process run can
be read again after a change to the pipeline.

Usage: python tools/scale_profile_torch.py [P] [reads] [log directory]
(defaults 4, 8000000 and a new temporary directory).  Env:
SCALE_INPROC_REPS (default 3).  Without a card it exits 2
(``FASTQDEDUP_TORCH_DEVICE=cpu`` runs it on the CPU device).
"""
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import bench_scaling_torch
    import chip_smoke

    dev = chip_smoke.run_device_or_exit("scale_profile_torch")
    nproc = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 8_000_000
    log_dir = sys.argv[3] if len(sys.argv) > 3 else tempfile.mkdtemp(
        prefix="fastqdedup_prof_logs_")
    os.makedirs(log_dir, exist_ok=True)
    os.environ["SCALE_DEBUG"] = "1"
    workdir = tempfile.mkdtemp(prefix="fastqdedup_prof_")
    try:
        shards = bench_scaling_torch.generate_shards(workdir, n_reads, 100,
                                                     12)
        print(f"generated 4x{n_reads // 4} reads in {workdir}",
              file=sys.stderr)
        walls, _, records = bench_scaling_torch.run_config(
            nproc, shards, workdir, dev, log_dir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for p, proc_records in enumerate(records):
        log = os.path.join(log_dir, f"scale_P{nproc}_proc{p}.log")
        print(f"process {p}: log={log} last rep "
              f"{proc_records[-1]['wall_s']:.3f}s", file=sys.stderr)
    chip_smoke.emit({"processes": nproc, "reads": n_reads,
                     "rep_walls_s": walls, "log_dir": log_dir,
                     "device": chip_smoke.describe_device(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
