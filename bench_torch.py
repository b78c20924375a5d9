#!/usr/bin/env python3
"""End-to-end benchmark of the PyTorch + CUDA port: reads/s over the
whole ``fastqdedup_tpu_torch`` pipeline on the card, output checked.

The counterpart of ``bench.py``: it generates the same synthetic FASTQ
(``chip_smoke.generate_fastq``, which writes ``bench.generate_fastq``'s
bytes), joins the prewarm of the kernels, runs ``deduplicate_cluster``
with ``bench.py``'s arguments under ``bench.measure_mode``'s rules
(adaptive warm-up, then the steadiest window of 5 runs within a budget
of 12; every run disclosed) and prints ONE JSON line::

    {"metric": ..., "value": reads/s, "unit": "reads/s", "runs_s": [...],
     "all_runs_s": [...], "warm_runs_s": [...], "edit_reads_per_sec": ...,
     ..., "device": {...}, "sha256": ..., "sha256_expected": ...,
     "first_run_s": ..., "prewarm_s": ..., "launches": {...},
     "device_busy_share": ...}

``sha256`` is the sha256 of the decompressed output, which every
measured run must reproduce; for a pinned input (1M or 10M reads of
100 bp, UMI 12, directional; or any ``BENCH_INPUT``) it must also equal
the JAX package's (``chip_smoke.EXPECTED_SHA256``), else the script
exits 1 and prints no line.  ``first_run_s`` is the first warm run (the
first run of the process after the prewarm), ``prewarm_s`` the
synchronous prewarm before it, ``launches`` one measured run's kernel
launches (``warmup_launches`` the prewarm's, counted apart), and
``device_busy_share`` the device time of one more run under
``torch.profiler``, after every timed window, over that run's wall
time.
There is no ``vs_baseline``: ``bench.py``'s is a TPU round's constant.

Env knobs, as ``bench.py``'s: BENCH_READS (default 1000000),
BENCH_READ_LEN (100), BENCH_UMI_LEN (12), BENCH_METHOD (directional),
BENCH_EDIT ("1": the ``--edit`` run is the headline; "0": no edit run;
unset: Hamming headline and the ``edit_*`` fields in the same line).
``BENCH_INPUT=<name>`` instead runs one of ``chip_smoke.INPUTS``
(default, dense, umi12, small, edit, indel, highest, lowq, paired,
umi3, umi12-d2, indel-d2) with its files, check lengths, distance,
method and distance kind, against its pinned sha256.

Without a card it exits 2; ``FASTQDEDUP_TORCH_DEVICE=cpu`` runs it on
the CPU device (for the tests: its line then says ``"platform":
"cpu"`` and its busy share is null).
"""

import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# (reads, read length, UMI length, method) -> the EXPECTED_SHA256 keys of
# the Hamming and the edit run of bench.py's input.
PINNED = {(1_000_000, 100, 12, "directional"): ("default", "edit"),
          (10_000_000, 100, 12, "directional"): ("default-10m", "edit-10m")}


def measure_mode(run_one, n_reads: int, use_edit: bool,
                 warm_src_is_src: bool) -> dict:
    """``bench.measure_mode``'s rules, times unrounded: warm until three
    runs in a row fail to beat the best by 4% (at most 20 runs, 2 above
    2M reads); then measured runs until 5 in a row agree within 1.25x
    (budget 12; 3 of 4 above 2M reads), else the tightest window.
    ``elapsed`` is the best of the measured runs, and of the warm runs
    too where they read the measured input."""
    max_warm = 20 if n_reads <= 2_000_000 else 2
    warm_times = []
    best = float("inf")
    stale = 0
    for w in range(max_warm):
        dt = run_one(use_edit, warm=True, attempt=w)
        warm_times.append(dt)
        if dt < best * 0.96:
            stale = 0
        else:
            stale += 1
            if stale >= 3:
                break
        best = min(best, dt)

    window = 5 if n_reads <= 2_000_000 else 3
    budget = 12 if n_reads <= 2_000_000 else 4
    times: list = []
    pick = None
    for a in range(budget):
        times.append(run_one(use_edit, warm=False, attempt=a))
        if len(times) >= window:
            tail = times[-window:]
            if max(tail) <= 1.25 * min(tail):
                pick = tail
                break
    if pick is None:
        spans = [times[i:i + window]
                 for i in range(len(times) - window + 1)]
        pick = min(spans, key=lambda w: max(w) / min(w))
    candidates = list(times)
    if warm_src_is_src:
        candidates += warm_times
    return {"elapsed": min(candidates), "times": list(pick),
            "all_times": times, "warm_times": warm_times}


def main() -> int:
    import torch

    import chip_smoke

    dev = chip_smoke.run_device_or_exit("bench_torch")
    from fastqdedup_tpu_torch import dissect
    from fastqdedup_tpu_torch.keys import length_string_to_slices
    from fastqdedup_tpu_torch.ops import kernel_lib
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster
    from fastqdedup_tpu_torch.warmup import prewarm_async

    def synchronize():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    name = os.environ.get("BENCH_INPUT")
    if name is not None and name not in chip_smoke.INPUTS:
        print(f"bench_torch: BENCH_INPUT={name!r} is none of "
              f"{sorted(chip_smoke.INPUTS)}", file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="fastqdedup_bench_torch_")
    try:
        if name is not None:
            file_names, check_length, max_distance, method, use_edit = \
                chip_smoke.INPUTS[name]
            files = chip_smoke.generate_files(
                workdir, chip_smoke.files_of([name]))
            srcs = [files[f] for f in file_names]
            n_reads = chip_smoke.FILES[file_names[0]]["n_reads"]
            read_len, umi_len = 100, 12
            slices = length_string_to_slices(check_length) \
                if check_length else None
            also_edit = False
            pinned = {use_edit: name}
            metric = (f"end-to-end dedup throughput of the port (input "
                      f"{name}: {n_reads} reads x {len(srcs)} file(s), "
                      f"{method}, d={max_distance}"
                      f"{', edit' if use_edit else ''})")
        else:
            n_reads = int(os.environ.get("BENCH_READS", 1_000_000))
            read_len = int(os.environ.get("BENCH_READ_LEN", 100))
            umi_len = int(os.environ.get("BENCH_UMI_LEN", 12))
            method = os.environ.get("BENCH_METHOD", "directional")
            edit_env = os.environ.get("BENCH_EDIT")
            use_edit = edit_env == "1"
            also_edit = edit_env is None
            max_distance, slices = 1, None
            srcs = [os.path.join(workdir, "bench.fastq.gz")]
            chip_smoke.generate_fastq(srcs[0], n_reads, read_len, umi_len)
            keys = PINNED.get((n_reads, read_len, umi_len, method))
            pinned = {False: keys[0], True: keys[1]} if keys else {}
            metric = (f"end-to-end dedup throughput of the port "
                      f"({n_reads} reads, {read_len}bp, {method}"
                      f"{', edit' if use_edit else ''})")
        # As bench.py: above 10M reads the warm-up runs on a 10M input of
        # its own.
        warm_srcs = srcs
        if n_reads > 10_000_000:
            warm_srcs = [os.path.join(workdir, "warm.fastq.gz")]
            chip_smoke.generate_fastq(warm_srcs[0], 10_000_000, read_len,
                                      umi_len, seed=11)
        warm_src_is_src = warm_srcs == srcs
        dissection = getattr(dissect, f"cluster_dissection_{method}")
        shas: dict = {}
        launches: dict = {}

        def outputs(edit: bool, warm: bool) -> list:
            tag = "warm" if warm and not warm_src_is_src else \
                ("e" if edit else "h")
            return [os.path.join(workdir, f"out_{tag}_{i}.fastq.gz")
                    for i in range(len(srcs))]

        def run_one(edit: bool, warm: bool, attempt: int) -> float:
            outs = outputs(edit, warm)
            chip_smoke.reset_launch_counts()
            start = time.perf_counter()
            deduplicate_cluster(warm_srcs if warm else srcs, outs, slices,
                                max_distance, 0.001, dissection, edit)
            synchronize()
            seconds = time.perf_counter() - start
            if not warm or (attempt == 0 and warm_src_is_src):
                shas.setdefault(edit, set()).add(
                    chip_smoke.decompressed_sha256(*outs))
            if not warm:
                launches[edit] = chip_smoke.launch_counts()
            return seconds

        def busy_share(edit: bool):
            """(device ms, wall s) of one run under the profiler; the
            device time is null on the CPU device."""
            if dev.type != "cuda":
                return None, None
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            with prof:
                start = time.perf_counter()
                deduplicate_cluster(srcs, outputs(edit, False), slices,
                                    max_distance, 0.001, dissection, edit)
                synchronize()
                seconds = time.perf_counter() - start
            return chip_smoke.profiled_device_ms(prof), seconds

        modes = (False, True) if also_edit else (use_edit,)
        start = time.perf_counter()
        for mode in modes:
            thread = prewarm_async(read_len + umi_len,
                                   max_distance=max_distance,
                                   use_edit_distance=mode)
            if thread is not None:
                thread.join()
        prewarm_s = time.perf_counter() - start

        results = {mode: measure_mode(run_one, n_reads, mode,
                                      warm_src_is_src) for mode in modes}
        # The profiled runs come after every timed window: a run after
        # one under the profiler may be slower.
        for mode in modes:
            device_ms, profiled_s = busy_share(mode)
            results[mode].update(device_ms=device_ms, profiled_s=profiled_s)
        for mode in modes:
            expected = chip_smoke.EXPECTED_SHA256.get(pinned.get(mode))
            if len(shas[mode]) != 1:
                print(f"bench_torch: the {'edit' if mode else 'Hamming'} "
                      f"runs wrote different outputs: {sorted(shas[mode])}",
                      file=sys.stderr)
                return 1
            if expected is not None and shas[mode] != {expected}:
                print(f"bench_torch: {'edit' if mode else 'Hamming'} output "
                      f"sha256 {min(shas[mode])} != the JAX package's "
                      f"{expected}", file=sys.stderr)
                return 1

        def fields(mode: bool, prefix: str) -> dict:
            res = results[mode]
            share = None if res["device_ms"] is None else \
                res["device_ms"] / (res["profiled_s"] * 1e3)
            return {
                f"{prefix}sha256": min(shas[mode]),
                f"{prefix}sha256_expected": chip_smoke.EXPECTED_SHA256.get(
                    pinned.get(mode)),
                f"{prefix}first_run_s": res["warm_times"][0],
                f"{prefix}launches": launches[mode],
                f"{prefix}device_busy_share": share,
                f"{prefix}device_ms_profiled_run": res["device_ms"],
                f"{prefix}profiled_run_s": res["profiled_s"],
            }

        headline = results[use_edit]
        line = {
            "metric": metric,
            "value": n_reads / headline["elapsed"],
            "unit": "reads/s",
            "runs_s": headline["times"],
            "all_runs_s": headline["all_times"],
            "warm_runs_s": headline["warm_times"],
        }
        if also_edit:
            edit_res = results[True]
            line.update({
                "edit_reads_per_sec": n_reads / edit_res["elapsed"],
                "edit_runs_s": edit_res["times"],
                "edit_all_runs_s": edit_res["all_times"],
                "edit_warm_runs_s": edit_res["warm_times"],
            })
        line["device"] = chip_smoke.describe_device(dev)
        for key, value in fields(use_edit, "").items():
            line[key] = value
            if key == "first_run_s":
                line["prewarm_s"] = prewarm_s
        line["warmup_launches"] = dict(kernel_lib.WARMUP_LAUNCHES)
        if also_edit:
            line.update(fields(True, "edit_"))
        chip_smoke.emit(line)
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
