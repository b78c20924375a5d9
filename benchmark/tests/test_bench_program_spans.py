"""The per-layer metrics that read the program's own spans
(``benchmark/program_spans.py``) in a traced run of a small cell on the
CPU device, as ``test_bench_harness.py`` runs one."""

import os
import tempfile

import pytest

from benchmark import harness

# The program's spans that a run on the CPU device records: not the
# card's waits (pairs.device_wait_s) nor the thread that brings the card
# up (setup.warmup_wait_s).
CPU_PROGRAM_SPAN_METRICS = ("pass1.read_wait_s", "pass1.drain_s",
                            "pass2.finalize_s", "pairs.kept_share",
                            "pass3.writer_wait_s", "host.fresh_mib")
CARD_ONLY = ("pairs.device_wait_s", "setup.warmup_wait_s")


@pytest.fixture
def traced_cpu_run(tmp_path, monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    config = dict(harness.load_json(os.path.join(
        harness.BENCH, "configs", "hamming-d1.json")), reads_per_job=20_000)
    cell = harness.Cell(
        "hamming-d1.dense", config,
        harness.load_json(os.path.join(harness.BENCH, "traffic",
                                       "dense.json")), 1,
        [m for m in bench["end_to_end"] if "workloads" not in m],
        bench["per_layer"])
    return harness.run_cell(cell, 2**31 + 5, 0.5, True,
                            harness.process_start(), require_cuda=False)


def test_every_program_span_metric_is_in_benchmark_json():
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    sources = {m["name"]: m["source"] for m in bench["per_layer"]}
    for name in CPU_PROGRAM_SPAN_METRICS + CARD_ONLY:
        assert sources[name] == "program_span"


def test_cpu_traced_run_reports_program_span_metrics(traced_cpu_run):
    result = traced_cpu_run
    assert result["correct"]
    metrics = result["metrics"]
    for name in CPU_PROGRAM_SPAN_METRICS:
        assert metrics[name]["value"] >= 0, name
    assert 0 < metrics["pairs.kept_share"]["value"] <= 100
    # Inside the wrappers' pass 1: the wait for chunks and the finalize.
    assert metrics["pass1.read_wait_s"]["value"] \
        + metrics["pass2.finalize_s"]["value"] < metrics["pass1_s"]["value"]
    for name in CARD_ONLY:
        assert name not in metrics
