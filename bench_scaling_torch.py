#!/usr/bin/env python3
"""Several processes of the PyTorch + CUDA port on one card: the
counterpart of ``bench_scaling.py``.

Strong scaling of the whole dedup pipeline across P = 1, 2, 4 processes
in sharded-input mode (``FASTQDEDUP_SHARDED_INPUT=1``: each process owns
its input shard).  The processes join one ``torch.distributed`` job
(gloo, through ``parallel.distributed.initialize_distributed`` on a
localhost port) and each is pinned with ``taskset`` to its share of the
host's cores (8 cores: 8, 4 or 2 a process).  Every process runs on
``cuda:0``: the machine has one card, so the numbers say what the key
exchange, the edge exchange and the multi-process pass 3 cost, not a
speed-up across cards.

Fixed total work: the same reads in 4 BGZF shards (seeds 1000-1003,
``chip_smoke.generate_fastq``); a P-process run gives each process 4/P
shards, concatenated (BGZF files concatenate into a valid BGZF file).
A run's wall time is the slowest process's, from a barrier to the end
of ``deduplicate_cluster``; each process repeats the pipeline
``SCALE_INPROC_REPS`` times and the configuration's time is its best
repetition, over ``SCALE_REPEATS`` launches interleaved across the
process counts.  On every run the outputs of the processes, decompressed
and concatenated in process order, must equal the first configuration's
(the 1-process output) byte for byte, else the script exits 1.

Prints one JSON line::

    {"metric": "scaling_efficiency_4_processes", "value": T(1)/(4 T(4)),
     "walls_s": {...}, "all_walls_s": {...}, "parity": true, ...}

Env knobs: SCALE_READS (default 2000000), SCALE_READ_LEN (100),
SCALE_UMI_LEN (12), SCALE_PROCS ("1,2,4"), SCALE_REPEATS (3),
SCALE_INPROC_REPS (3), SCALE_DEBUG=1 (each process's DEBUG log kept,
as ``tools/scale_profile_torch.py`` does).  Without a card it exits 2
(``FASTQDEDUP_TORCH_DEVICE=cpu`` runs every process on the CPU device).
``--worker`` is a child process started by the script itself.
"""

import gzip
import json
import logging
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SHARDS = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def generate_shards(workdir: str, n_reads: int, read_len: int,
                    umi_len: int) -> list:
    """The 4 BGZF shards of ``n_reads`` reads, seeds 1000-1003."""
    import chip_smoke

    paths = []
    for s in range(SHARDS):
        path = os.path.join(workdir, f"shard{s}.fastq.gz")
        chip_smoke.generate_fastq(path, n_reads // SHARDS, read_len,
                                  umi_len, seed=1000 + s)
        paths.append(path)
    return paths


def core_lists(nproc: int) -> list:
    """Each process's share of the cores this process may run on."""
    cores = sorted(os.sched_getaffinity(0))
    per = max(1, len(cores) // nproc)
    return [[cores[(p * per + c) % len(cores)] for c in range(per)]
            for p in range(nproc)]


def worker(nproc: int, pid: int, port: int, inputs: str,
           output: str) -> int:
    """One process of a P-process run: join the job, run the pipeline
    ``SCALE_INPROC_REPS`` times, each after a barrier, and print one
    ``PROCWALL`` line per repetition."""
    import resource

    import torch

    from fastqdedup_tpu_torch.parallel import distributed
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster
    from fastqdedup_tpu_torch.runtime import device

    import chip_smoke

    if os.environ.get("SCALE_DEBUG") == "1":
        logging.basicConfig(level=logging.DEBUG,
                            format="%(relativeCreated)8.0fms %(message)s")
    if nproc > 1:
        distributed.initialize_distributed(f"127.0.0.1:{port}", nproc, pid)
        if distributed.process_shape() != (pid, nproc):
            raise RuntimeError(f"process group {distributed.process_shape()}"
                               f", expected {(pid, nproc)}")
    dev = device()
    for rep in range(int(os.environ.get("SCALE_INPROC_REPS", "3"))):
        if nproc > 1:
            distributed.barrier(f"scale:{rep}")
        chip_smoke.reset_launch_counts()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        deduplicate_cluster(inputs.split(","), [output], None, 1, 0.001)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        print("PROCWALL", json.dumps({
            "rep": rep, "wall_s": wall, "device": str(dev),
            "minflt": ru1.ru_minflt - ru0.ru_minflt,
            "cpu_s": ru1.ru_utime - ru0.ru_utime
            + ru1.ru_stime - ru0.ru_stime,
            "launches": chip_smoke.launch_counts()}), flush=True)
    return 0


def run_config(nproc: int, shards: list, workdir: str, dev,
               log_dir: str) -> tuple:
    """``nproc`` pinned processes over ``shards``, each writing its log
    into ``log_dir``.  Returns (the slowest process's wall per
    repetition, the output files in process order, each process's
    ``PROCWALL`` records); a process that fails raises."""
    per = len(shards) // nproc
    env = dict(os.environ, PYTHONPATH=HERE, FASTQDEDUP_SHARDED_INPUT="1",
               FASTQDEDUP_TORCH_DEVICE="cuda:0" if dev.type == "cuda"
               else "cpu")
    taskset = shutil.which("taskset")
    port = _free_port()
    procs, outputs, logs = [], [], []
    try:
        for p, cores in enumerate(core_lists(nproc)):
            mine = shards[p * per:(p + 1) * per]
            if len(mine) > 1:
                merged = os.path.join(workdir, f"proc{p}of{nproc}.fastq.gz")
                with open(merged, "wb") as out:
                    for path in mine:
                        with open(path, "rb") as src:
                            shutil.copyfileobj(src, out)
                mine = [merged]
            outputs.append(os.path.join(workdir,
                                        f"out{p}of{nproc}.fastq.gz"))
            logs.append(os.path.join(log_dir, f"scale_P{nproc}_proc{p}.log"))
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   str(nproc), str(p), str(port), ",".join(mine),
                   outputs[-1]]
            if taskset:
                cmd = [taskset, "-c", ",".join(map(str, cores))] + cmd
            with open(logs[-1], "wb") as log:
                procs.append(subprocess.Popen(
                    cmd, env=env, cwd=workdir, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 1800
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    records = []
    for p, (proc, log) in enumerate(zip(procs, logs)):
        with open(log, errors="replace") as f:
            text = f.read()
        if proc.returncode != 0:
            raise RuntimeError(f"process {p}/{nproc} exited with "
                               f"{proc.returncode}:\n{text[-3000:]}")
        records.append([json.loads(row.split(" ", 1)[1])
                         for row in text.splitlines()
                         if row.startswith("PROCWALL ")])
    walls = [max(proc_records[rep]["wall_s"] for proc_records in records)
             for rep in range(len(records[0]))]
    print(json.dumps({"processes": nproc, "rep_walls_s": walls,
                      "cores": core_lists(nproc) if taskset else None,
                      "per_process": records}), file=sys.stderr, flush=True)
    return walls, outputs, records


def main() -> int:
    import chip_smoke

    dev = chip_smoke.run_device_or_exit("bench_scaling_torch")
    n_reads = int(os.environ.get("SCALE_READS", 2_000_000))
    read_len = int(os.environ.get("SCALE_READ_LEN", 100))
    umi_len = int(os.environ.get("SCALE_UMI_LEN", 12))
    proc_counts = [int(p) for p in
                   os.environ.get("SCALE_PROCS", "1,2,4").split(",")]
    repeats = int(os.environ.get("SCALE_REPEATS", 3))
    debug = os.environ.get("SCALE_DEBUG") == "1"
    workdir = tempfile.mkdtemp(prefix="fastqdedup_scale_torch_")
    try:
        shards = generate_shards(workdir, n_reads, read_len, umi_len)
        print(f"generated {SHARDS}x{n_reads // SHARDS} reads in {workdir}",
              file=sys.stderr)
        all_walls = {nproc: [] for nproc in proc_counts}
        reference = None
        for _ in range(repeats):
            for nproc in proc_counts:
                walls, outputs, _ = run_config(nproc, shards, workdir, dev,
                                               workdir)
                all_walls[nproc].append(min(walls))
                merged = b"".join(gzip.open(o, "rb").read() for o in outputs)
                if reference is None:
                    reference = merged
                elif merged != reference:
                    print(f"bench_scaling_torch: the {nproc}-process output "
                          f"differs from the {proc_counts[0]}-process "
                          f"output", file=sys.stderr)
                    return 1
        results = {nproc: min(walls) for nproc, walls in all_walls.items()}
        base = min(results)
        top = max(results)
        eff = results[base] * base / (top * results[top])
        chip_smoke.emit({
            "metric": f"scaling_efficiency_{top}_processes",
            "value": eff,
            "unit": f"T({base})/({top}*T({top})) strong scaling, {n_reads} "
                    f"reads in {SHARDS} BGZF shards, sharded input",
            "note": "one card: every process runs on cuda:0 and they "
                    "share the host's cores, so this is the cost of the "
                    "exchange and of the multi-process pass 3, not a "
                    "speed-up across cards",
            "walls_s": {str(p): w for p, w in results.items()},
            "reads_per_s": {str(p): n_reads / w for p, w in results.items()},
            "all_walls_s": {str(p): w for p, w in all_walls.items()},
            "cores_per_process": {str(p): len(core_lists(p)[0])
                                  for p in proc_counts},
            "pinned": shutil.which("taskset") is not None,
            "parity": True,
            "device": chip_smoke.describe_device(dev),
        })
        return 0
    finally:
        if debug:
            print(f"logs kept in {workdir}", file=sys.stderr)
        else:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3]),
                        int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    sys.exit(main())
