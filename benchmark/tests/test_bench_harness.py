"""The harness on the CPU device at a small size: the job loop, the span
wrappers, the per-layer readers, the roofline arithmetic, the files
``BENCHMARK.json`` names, the runner without a card, and runs whose
timed path is broken, which must come out not correct.

The tests marked ``cuda`` run one small cell on the card."""

import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from benchmark import compare, harness, roofline
from benchmark.reference import dedup
from benchmark.trace import DeviceEvent, Launch, Trace, Tracer, breakdown

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_every_name_in_benchmark_json_resolves_to_its_file():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        config = harness.load_json(os.path.join(ROOT, c["file"]))
        assert set(c["reduced"]) <= set(config)
        assert isinstance(config["args"], list) and config["reads_per_job"]
    for w in b["workloads"]:
        assert w["config"] in configs
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert os.path.isfile(os.path.join(harness.BENCH, "traffic",
                                           w["traffic"] + ".json"))
        cell = harness.load_cell(w["name"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(harness.BENCH, "metrics",
                                           m["name"] + ".py"))
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in b[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])


def test_roofline_counts_problem_bytes_only():
    # 100-base keys are 25 bytes at 2 bits a base; one byte a pair.
    assert roofline.key_bytes([100, 99, 101]) == 25 + 25 + 26
    assert roofline.rowwise_bytes(1_000, [100] * 40) == 40 * 25 + 1_000
    assert roofline.banded_bytes(10, [100, 101]) == 25 + 26 + 2 + 10
    assert roofline.bound_seconds(3.35e12) == pytest.approx(1.0)
    # 14 distinct rows of 100 bases (25 bytes each), 20 pairs.
    rows_i = np.arange(20) % 7
    rows_j = 7 + np.arange(20) % 7
    assert roofline.launch_bytes(Launch(
        "rowwise_within_packed", 5, rows_i, rows_j, 100)) == 14 * 25 + 20
    lens = np.array([99, 100, 101] * 10)
    assert roofline.launch_bytes(Launch(
        "banded_within_edit_distance", 5, np.array([0, 1, 0]),
        np.array([2, 2, 1]), lens)) == 25 + 25 + 26 + 3 + 3
    trace = Trace(window=(0, 10**9))
    # Pairs (k, k + 1): 134,000 distinct rows of 25 bytes, 133,999 pairs.
    many = np.arange(133_999)
    trace.launches = [Launch("rowwise_within_packed", 5, many, many + 1,
                             100)]
    assert roofline.launch_bytes(trace.launches[0]) == \
        134_000 * 25 + 133_999
    trace.device = [DeviceEvent(
        "void (anonymous namespace)::rowwise_within_indexed_kernel<8, "
        "false>(unsigned int const*)", 100, 100 + 4_000, "kernel")]
    # (3,350,000 + 133,999) bytes of bound against 4 us on the card.
    assert roofline.window_share(trace, "rowwise_within_packed") == \
        pytest.approx(100 * (3_350_000 + 133_999) / 3.35e12 / 4e-6)
    assert roofline.window_share(trace, "banded_within_edit_distance") \
        is None


def test_readers_and_breakdown_on_a_made_up_trace():
    ms = 10**6
    trace = Trace(traced=(0, 1000 * ms), window=(200 * ms, 1000 * ms),
                  jobs=[(200 * ms, 600 * ms), (600 * ms, 1000 * ms)])
    for start in (200, 600):
        trace.spans += [("pairs", (start + 100) * ms, (start + 250) * ms),
                        ("pass3", (start + 300) * ms, (start + 390) * ms)]
    trace.device = [
        DeviceEvent("within_edit_kernel", 390 * ms, 392 * ms, "kernel"),
        DeviceEvent("Memcpy HtoD (Pinned -> Device)", 380 * ms, 384 * ms,
                    "copy"),
        DeviceEvent("within_edit_kernel", 50 * ms, 51 * ms, "kernel")]
    read = {name: harness.read_metric(name, trace) for name in (
        "pass1_s", "pairs_s", "dissect_s", "pass3_s", "kernel_ms",
        "device.copy_ms", "device.idle_share")}
    assert read["pass1_s"] == pytest.approx(0.1)
    assert read["pairs_s"] == pytest.approx(0.15)
    assert read["dissect_s"] == pytest.approx(0.05)
    assert read["pass3_s"] == pytest.approx(0.09)
    assert read["kernel_ms"] == pytest.approx(1.0)      # the window's 2 ms
    assert read["device.copy_ms"] == pytest.approx(2.0)
    # The window's 6 ms busy of 800; the first jobs' 1 ms is not counted.
    assert read["device.idle_share"] == pytest.approx(100 * (1 - 6 / 800))
    assert harness.read_metric("banded_within_edit_distance_roofline",
                               trace) is None          # no launch recorded
    out = breakdown(trace)
    assert out["device_ops"] == [["Memcpy HtoD", pytest.approx(0.004)],
                                 ["within_edit_kernel",
                                  pytest.approx(0.003)]]
    # The second job's pairs span (150 ms) has no device work at all;
    # idle from 51 ms to the window (200 ms) is the first two jobs'.
    assert out["idle_gaps"][:2] == [["pairs", pytest.approx(0.15)],
                                    ["first and warm job",
                                     pytest.approx(0.149)]]
    assert all(len(x) == 2 for x in out["idle_gaps"])


def test_tracer_puts_every_name_back():
    from fastqdedup_tpu_torch import engine, pipeline
    from fastqdedup_tpu_torch.ops import bucket, edit

    before = (pipeline.build_partition_groups,
              pipeline._write_from_record_store, pipeline._filter_and_write,
              bucket._DevicePairVerifier.__init__,
              bucket._DevicePairVerifier.verify, engine._start_key_upload,
              edit.edit_verify_indexed)
    tracer = Tracer()
    tracer.install()
    assert pipeline.build_partition_groups is not before[0]
    tracer.close()
    after = (pipeline.build_partition_groups,
             pipeline._write_from_record_store, pipeline._filter_and_write,
             bucket._DevicePairVerifier.__init__,
             bucket._DevicePairVerifier.verify, engine._start_key_upload,
             edit.edit_verify_indexed)
    assert after == before


def small_cell(name: str, reads: int = 20_000) -> harness.Cell:
    """``config.traffic`` with the metrics BENCHMARK.json gives such a
    cell, at ``reads`` reads a job (the pair need not be a cell)."""
    config, traffic = name.split(".")
    b = bench()
    return harness.Cell(
        name, dict(harness.load_json(os.path.join(
            harness.BENCH, "configs", config + ".json")),
            reads_per_job=reads),
        harness.load_json(os.path.join(harness.BENCH, "traffic",
                                       traffic + ".json")), 1,
        [m for m in b["end_to_end"] if "workloads" not in m],
        b["per_layer"])


@pytest.fixture
def cpu_run(tmp_path, monkeypatch):
    """A run of a small cell on the CPU device, the card check skipped."""
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def run(name, traced=False, seed=2**31 + 3, reads=20_000):
        return harness.run_cell(small_cell(name, reads), seed, 0.5, traced,
                                harness.process_start(),
                                require_cuda=False)
    return run


@pytest.mark.parametrize("name", ["hamming-d1.dense", "hamming-d1.default",
                                  "edit-d1.default", "edit-d1.indel"])
def test_cpu_run_is_correct_and_reports_every_metric(cpu_run, name):
    result = cpu_run(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "compared"]
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 3
    assert set(result["metrics"]) == {"reads_per_s", "peak_rss_gib",
                                      "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["compared"] == {
        "records_differing": {"value": 0, "limit": 0},
        "jobs_failed": {"value": 0, "limit": 0}}


def test_cpu_traced_run_reports_span_metrics(cpu_run):
    result = cpu_run("edit-d1.indel", traced=True)
    assert result["correct"]
    assert list(result)[-2:] == ["breakdown", "compared"]
    for name in ("pass1_s", "pairs_s", "dissect_s", "pass3_s",
                 "device.idle_share"):
        assert result["metrics"][name]["value"] >= 0
    assert result["device"]["window_s"] > 0


def test_half_the_reads_left_out_is_not_correct(cpu_run, monkeypatch):
    from fastqdedup_tpu_torch import pipeline
    original = pipeline.deduplicate_cluster

    def half(inputs, outputs, *args):
        halves = []
        for path in inputs:
            data = dedup.gunzip(path)
            cut = data.split(b"\n")
            keep = b"\n".join(cut[:len(cut) // 8 * 4]) + b"\n"
            out = path + ".half.gz"
            import gzip
            with gzip.open(out, "wb", compresslevel=1) as f:
                f.write(keep)
            halves.append(out)
        return original(halves, outputs, *args)
    monkeypatch.setattr(pipeline, "deduplicate_cluster", half)
    result = cpu_run("hamming-d1.dense")
    assert not result["correct"]
    assert result["compared"]["records_differing"]["value"] > 0


def test_an_answer_altered_where_it_is_made_is_not_correct(cpu_run,
                                                            monkeypatch):
    from fastqdedup_tpu_torch import pipeline
    original = pipeline._write_from_record_store

    def drop_one(output_files, groups, kept_mask, *args, **kwargs):
        group = next(g for g, m in enumerate(kept_mask) if m.any())
        kept_mask[group][np.flatnonzero(kept_mask[group])[0]] = False
        return original(output_files, groups, kept_mask, *args, **kwargs)
    monkeypatch.setattr(pipeline, "_write_from_record_store", drop_one)
    result = cpu_run("edit-d1.indel")
    assert not result["correct"]
    assert result["compared"]["records_differing"]["value"] > 0


@pytest.mark.parametrize("args,params", [
    ([], {"dup_factor": 30, "error_rate": 0.005}),
    (["--edit"], {"indel_rate": 0.1}),
    ([], {}),
    (["--edit"], {}),
])
def test_control_search_of_one_segment_is_not_correct(args, params,
                                                       tmp_path):
    """A broken guarantee: the reference with a neighbour search that
    looks at one pigeonhole segment of two, in the program's place."""
    from benchmark.generate import generate_traffic

    paths = generate_traffic({"read_len": 100, "umi_len": 12, **params},
                             20_000, 2**31 + 9, str(tmp_path))
    want = dedup.expected_outputs(args, paths)
    control = dedup.expected_outputs(args, paths, segments=[0])
    assert compare.records_differing(control[0], want[0]) > 0


@pytest.mark.parametrize("traffic", ["dense", "default", "indel"])
def test_reference_in_float32_is_not_correct(traffic, tmp_path):
    """The quality filter's mean error rates in float32, the precision
    below the configuration's float64, in the reference: the traffic's
    reads at the limit tell it apart."""
    from benchmark.generate import generate_traffic

    mix = harness.load_json(os.path.join(harness.BENCH, "traffic",
                                         traffic + ".json"))
    paths = generate_traffic(mix, 100_000, 2**31 + 9, str(tmp_path))
    args = ["--edit"] if traffic == "indel" else []
    want = dedup.expected_outputs(args, paths)
    control = dedup.expected_outputs(args, paths, rate_dtype=np.float32)
    assert compare.records_differing(control[0], want[0]) > 0


@pytest.mark.parametrize("name", ["hamming-d1.dense", "hamming-d1.default"])
def test_program_quality_filter_in_float32_is_not_correct(cpu_run, name,
                                                          monkeypatch):
    """The control: the program's own float32 quality filter
    (``FASTQDEDUP_DEVICE_QUALITY=1``) switched on under a whole run."""
    monkeypatch.setenv("FASTQDEDUP_DEVICE_QUALITY", "1")
    result = cpu_run(name)
    assert not result["correct"]
    assert result["compared"]["records_differing"]["value"] > 0


def test_records_differing_counts_records():
    rec = [b"@r%d\nACGT\n+\nIIII\n" % i for i in range(5)]
    want = b"".join(rec)
    assert compare.records_differing(want, want) == 0
    assert compare.records_differing(b"".join(rec[:4]), want) == 1
    assert compare.records_differing(
        b"".join([rec[0], rec[2], rec[3], rec[4]]), want) == 1
    assert compare.records_differing(
        b"".join([rec[0], rec[2], rec[1], rec[3], rec[4]]), want) == 2
    assert compare.records_differing(want + rec[4], want) == 1
    # An altered record is one missing and one that should not be there.
    assert compare.records_differing(
        want.replace(b"@r3\nACGT", b"@r3\nACGA"), want) == 2


def test_runner_without_a_card_exits_nonzero_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hamming-d1.dense", "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout


def test_runner_needs_the_program(tmp_path):
    """In a directory that holds only the benchmark, a run fails."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hamming-d1.dense", "--seed", "5", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_cell_on_the_card(card, name, tmp_path):
    """One traced run of each cell at its own size, a short window, in a
    process of its own as the check runs it (the port warms up once a
    process: a cell whose window launches nothing is busy on the card
    only in its first job)."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 77), "--seconds", "2", "--trace", "1"], cwd=ROOT,
        env={**os.environ, "TMPDIR": str(tmp_path)}, capture_output=True,
        text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], json.dumps(result)
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    metrics = result["metrics"]
    assert 0 < metrics["device.idle_share"]["value"] <= 100
    for m in harness.load_cell(name).per_layer:
        if "workloads" in m:        # the cells that list them launch
            assert metrics[m["name"]]["value"] > 0
            if m["name"].endswith("_roofline"):
                assert metrics[m["name"]]["value"] < 100
