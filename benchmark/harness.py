"""One run of one benchmark cell (see ``benchmark/run.py``).

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``benchmark/configs/<config>.json``: the command line's options and the
reads a job holds) and a traffic mix (``benchmark/traffic/<traffic>.json``:
the generator's parameters).  A per-layer metric ``<name>`` is read by
``benchmark/metrics/<name>.py``.

A run:

1. Set-up.  Two children at once: one looks for the cards and builds the
   port's libraries (``build.py``), one generates the input from the seed
   into a directory under ``TMPDIR`` (``generate.py``).
2. t0.  Import torch and ``fastqdedup_tpu_torch``, run one job: what a
   fresh process of the CLI pays before its first output (on standard
   error).  Then one more job.
3. The window: jobs back to back on the same input, one at a time; a job
   that starts inside ``--seconds`` runs to its end.
4. Peak host memory, then the comparison with the plain reference, then
   the result line.

A job is ``pipeline.deduplicate_cluster`` with the arguments the CLI
(``fastqdedup_tpu_torch.cli``) builds from the configuration's command
line, writing under the run's directory in ``TMPDIR``.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import random
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import compare
from .trace import Tracer, busy_intervals, breakdown, device_events, \
    launch_counts, profiled

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "fastqdedup_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc), or
    now where that cannot be read."""
    now = time.time()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = now - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return started if now - 60 < started <= now else now


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict] = field(default_factory=list)

    @property
    def reads(self) -> int:
        return int(self.config["reads_per_job"])


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration
    and traffic files and the metrics it reports."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic",
                                     cell["traffic"] + ".json"))

    def reported(metric: Dict) -> bool:
        return name in metric.get("workloads", [name])
    return Cell(name, config, traffic, int(cell["chips"]),
                [m for m in bench["end_to_end"] if reported(m)],
                [m for m in bench["per_layer"] if reported(m)])


def read_metric(name: str, trace) -> Optional[float]:
    """The per-layer metric ``name`` from its reader's file."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(trace)


def start_children(cell: Cell, traffic_path: str, seed: int, workdir: str):
    """The set-up children: the card check and build, and the generator."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    build = subprocess.Popen(
        [sys.executable, os.path.join(BENCH, "build.py"), str(cell.chips)],
        stdout=subprocess.PIPE, env=env, cwd=ROOT, text=True)
    gen = subprocess.Popen(
        [sys.executable, os.path.join(BENCH, "generate.py"), traffic_path,
         str(cell.reads), str(seed), workdir],
        stdout=subprocess.PIPE, env=env, cwd=ROOT, text=True)
    return build, gen


def stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


class Jobs:
    """Runs jobs as the CLI would, one at a time.

    Outputs kept for the comparison: the first job's, a sample of the
    later jobs' drawn from the seed (one in three), and the last job's.
    The others are deleted once the next job has ended, seconds after
    they were written, so that little of them reaches the disk."""

    SAMPLE = 1 / 3

    def __init__(self, config: Dict, inputs: List[str], workdir: str,
                 seed: int):
        from fastqdedup_tpu_torch import cli
        from fastqdedup_tpu_torch.dissect import CLUSTER_DISSECTION_METHODS
        from fastqdedup_tpu_torch.keys import length_string_to_slices
        from fastqdedup_tpu_torch.parallel.distributed import \
            initialize_distributed
        from fastqdedup_tpu_torch.runtime import tune_host_allocator

        self.workdir = workdir
        argv = list(config["args"]) + inputs
        for i in range(len(inputs)):
            argv += ["-o", os.path.join(workdir, f"out{i + 1}.fastq.gz")]
        tune_host_allocator()
        args = cli.argument_parser().parse_args(argv)
        cli.initiate_logger(args.verbose, args.quiet)
        initialize_distributed()
        self.outputs = args.output
        self.call = (args.fastq, args.output,
                     length_string_to_slices(args.check_lengths)
                     if args.check_lengths else None,
                     args.max_distance, args.max_average_error_rate,
                     CLUSTER_DISSECTION_METHODS[
                         args.cluster_dissection_method], args.edit)
        self.sample = random.Random(seed)
        self.attempted = 0
        self.failed = 0
        self.kept: List[Tuple[int, List[str]]] = []   # to compare
        self._unsampled: List[str] = []
        self._last = 0

    def run(self) -> bool:
        """One job; False if it raised."""
        import torch

        from fastqdedup_tpu_torch import pipeline

        self.attempted += 1
        number = self.attempted
        try:
            pipeline.deduplicate_cluster(*self.call)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        except Exception as exc:  # a job that raises is counted, not fatal
            log(f"job {number} raised {type(exc).__name__}: {exc}")
            self.failed += 1
            return False
        for path in self._unsampled:
            os.remove(path)
        paths = []
        for i, out in enumerate(self.outputs):
            paths.append(os.path.join(self.workdir,
                                      f"job{number}.out{i + 1}.gz"))
            os.replace(out, paths[-1])
        if number == 1 or self.sample.random() < self.SAMPLE:
            self.kept.append((number, paths))
            self._unsampled = []
        else:
            self._unsampled = paths
            self._last = number
        return True

    def compared(self) -> List[Tuple[int, List[str]]]:
        """(job number, outputs) to compare: the sample and the last
        job's."""
        last = [(self._last, self._unsampled)] if self._unsampled else []
        return self.kept + last


def device_info(chips: int) -> Dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        info["power_limit_w"] = float(smi[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             started: float, require_cuda: bool = True) -> Optional[Dict]:
    """One run of ``cell``; returns the result line's object, or None when
    the cards are missing (``require_cuda``)."""
    workdir = tempfile.mkdtemp(prefix="fqd-bench-")
    try:
        traffic_path = os.path.join(workdir, "traffic.json")
        with open(traffic_path, "w") as f:
            json.dump(cell.traffic, f)
        build, gen = start_children(cell, traffic_path, seed, workdir)
        found = build.stdout.readline()
        status = build.wait()
        stop(build)
        if status == 3 and require_cuda:
            stop(gen)
            log(f"no CUDA device for this cell ({found.strip()}); it needs "
                f"{cell.chips}")
            return None
        if status not in (0, 3):
            stop(gen)
            raise RuntimeError(f"the build child failed ({status})")
        inputs, _ = gen.communicate()
        if gen.returncode != 0:
            raise RuntimeError(f"input generation failed ({gen.returncode})")
        return measure(cell, inputs.split(), workdir, seed, seconds, traced,
                       started, require_cuda)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def measure(cell: Cell, inputs: List[str], workdir: str, seed: int,
            seconds: float, traced: bool, started: float,
            require_cuda: bool) -> Dict:
    t0 = time.perf_counter()
    t0_ns = time.time_ns()
    import torch

    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        raise RuntimeError("the cards went missing after set-up")
    tracer = Tracer() if traced else None
    with profiled(traced) as prof:
        jobs = Jobs(cell.config, inputs, workdir, seed)
        if tracer is not None:
            tracer.install()
        jobs.run()
        first_job_s = time.perf_counter() - t0
        jobs.run()
        before = launch_counts() if traced else {}
        window_start = time.perf_counter()
        setup_s = time.time() - started
        log(f"set-up {setup_s:.3f} s, first job {first_job_s:.3f} s")
        window_ns = time.time_ns()
        window_jobs = []
        with torch.profiler.record_function("bench.window") if traced \
                else contextlib.nullcontext():
            while time.perf_counter() - window_start < seconds:
                start, start_ns = time.perf_counter(), time.time_ns()
                ok = jobs.run()
                end = time.perf_counter()
                window_jobs.append((start_ns, time.time_ns(), ok))
                log(f"job {jobs.attempted}: {end - start:.4f} s"
                    + ("" if ok else " (raised)"))
            window_end = time.perf_counter()
        end_ns = time.time_ns()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if tracer is not None:
        tracer.close()
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    device = device_info(cell.chips) if torch.cuda.is_available() else {
        "platform": "cpu", "kind": "cpu", "count": 0,
        "memory_peak_bytes": 0}
    done = [ok for _, _, ok in window_jobs]
    breakdown_ = None
    if traced:
        trace = tracer.trace
        after = launch_counts()
        trace.counters = {k: v - before.get(k, 0) for k, v in after.items()
                          if v - before.get(k, 0)}
        trace.jobs = [(s, e) for s, e, ok in window_jobs if ok]
        trace.window = (window_ns, end_ns)
        trace.traced = (t0_ns, end_ns)
        trace.device = device_events(prof, window_ns) if prof else []
        busy = busy_intervals(trace.device, *trace.traced)
        device["busy_s"] = sum(e - s for s, e in busy) / 1e9
        device["window_s"] = (trace.traced[1] - trace.traced[0]) / 1e9
        log(f"launches in the window: {trace.counters}")
        metrics = {}
        for metric in cell.per_layer:
            value = read_metric(metric["name"], trace)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
        breakdown_ = breakdown(trace)
    else:
        window_s = window_end - window_start
        values = {
            "reads_per_s": cell.reads * sum(done) / window_s,
            "peak_rss_gib": peak_rss / 2 ** 30,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        raise RuntimeError(f"the run loaded {', '.join(loaded)}")
    from .reference import expected_outputs

    started_ref = time.perf_counter()
    want = expected_outputs(cell.config["args"], inputs)
    numbers = {
        "records_differing": {
            "value": compare.compare_jobs(jobs.compared(), want, log),
            "limit": compare.LIMIT},
        "jobs_failed": {"value": jobs.failed, "limit": 0},
    }
    log(f"reference and comparison {time.perf_counter() - started_ref:.3f}"
        f" s, {len(jobs.compared())} jobs' outputs compared")
    result: Dict = {
        "correct": all(n["value"] <= n["limit"] for n in numbers.values()),
        "attempted": jobs.attempted, "failed": jobs.failed,
        "metrics": metrics, "device": device}
    if breakdown_ is not None:
        result["breakdown"] = breakdown_
    result["compared"] = numbers
    for name, n in numbers.items():
        log(f"compared {name} {n['value']} limit {n['limit']}")
    return result


def main(argv: Optional[List[str]] = None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    # Caches of torch and CUDA inside the checkout, at fixed paths.
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      started)
    if result is None:
        return 2
    print(json.dumps(result), flush=True)
    return 0
