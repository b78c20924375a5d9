"""The port's warm-up module (``fastqdedup_tpu_torch/warmup.py``) on a
host without a card, beside the JAX package's.

On the CPU device there is nothing to bring up: ``prewarm_async`` returns
``None`` as the JAX package's does off its accelerator, and ``warmup()``
runs every kernel's plain version.  What can be pinned without a card is
the thread's contract: one thread per geometry, an exception inside it
raised at the join, launches counted apart from real work, and the
pipeline starting and joining the thread.  The card's side is
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os
import subprocess
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fastqdedup_tpu.warmup as jax_warmup
import fastqdedup_tpu_torch.warmup as torch_warmup
from fastqdedup_tpu_torch.ops import edit_kernels, hamming_kernels, kernel_lib
from fastqdedup_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(torch_warmup, "_prewarmed_geometries", set())
    monkeypatch.setattr(torch_warmup, "_deflate_prewarmed", False)


@pytest.fixture
def fake_card(monkeypatch):
    """``runtime.device()`` answers a CUDA device, and the thread's own
    CUDA calls are no-ops: the thread logic runs without a card while the
    wrappers, given CPU tensors, compute their plain versions."""
    import fastqdedup_tpu_torch.runtime as runtime

    monkeypatch.setattr(runtime, "device",
                        lambda: torch.device("cuda", 0))
    monkeypatch.setattr(torch_warmup, "_first_touch", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(kernel_lib, "library", lambda: None)
    cpu = torch.device("cpu")
    for name in ("_launch_hamming", "_launch_edit", "_launch_deflate"):
        inner = getattr(torch_warmup, name)
        monkeypatch.setattr(
            torch_warmup, name,
            lambda dev, *args, _inner=inner: _inner(cpu, *args))


def test_prewarm_async_returns_none_on_cpu_device():
    """As the JAX package's off its accelerator."""
    assert torch_warmup.prewarm_async(100) is None
    assert torch_warmup.prewarm_async(100, use_edit_distance=True) is None
    assert jax_warmup.prewarm_async(100) is None


def test_same_signatures_as_jax_package():
    import inspect

    for name in ("warmup", "prewarm_async"):
        got = inspect.signature(getattr(torch_warmup, name))
        want = inspect.signature(getattr(jax_warmup, name))
        assert [(p.name, p.default) for p in got.parameters.values()] == \
            [(p.name, p.default) for p in want.parameters.values()]


@pytest.mark.parametrize("edit", [False, True])
def test_second_call_for_one_geometry_returns_none(fake_card, edit):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("caller") as caller:
            first = torch_warmup.prewarm_async(24, 5, 1, edit)
        assert isinstance(first, threading.Thread)
        assert first.name == "fastqdedup-prewarm" and first.daemon
        first.join(timeout=60)
    assert not first.is_alive()
    # The thread's steps are spans under the one that started it.
    steps = [s for s in trace.spans() if s.name.startswith("warmup.")]
    assert [(s.name, s.parent, s.thread) for s in steps] == [
        (name, caller.id, "fastqdedup-prewarm")
        for name in ("warmup.context", "warmup.library", "warmup.launches")]
    assert torch_warmup.prewarm_async(24, 5, 1, edit) is None
    other = torch_warmup.prewarm_async(24, 5, 2, edit)
    assert other is not None
    other.join(timeout=60)
    assert not other.is_alive()


def test_prewarm_deflate_async_returns_none_on_cpu_device():
    assert torch_warmup.prewarm_deflate_async() is None


def test_deflate_prewarm_is_a_thread_of_its_own(fake_card, monkeypatch):
    """The dedup kernels' thread leaves the deflate kernel alone; the
    card writer's thread launches it once, counted as warm-up, in one
    ``warmup.launches`` span under its caller, and only once a process."""
    launched = []
    inner = torch_warmup._launch_deflate

    def spy(dev):
        launched.append(kernel_lib.in_warmup())
        inner(dev)

    monkeypatch.setattr(torch_warmup, "_launch_deflate", spy)
    for edit in (False, True):
        torch_warmup.prewarm_async(24, 5, 1, edit).join(timeout=60)
    assert launched == []
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("caller") as caller:
            thread = torch_warmup.prewarm_deflate_async()
        assert thread.name == "fastqdedup-prewarm" and thread.daemon
        thread.join(timeout=60)
    assert not thread.is_alive() and launched == [True]
    steps = [s for s in trace.spans() if s.name.startswith("warmup.")]
    assert [(s.name, s.parent) for s in steps] == [
        ("warmup.launches", caller.id)]
    assert torch_warmup.prewarm_deflate_async() is None


def test_exception_in_thread_reaches_the_join(fake_card, monkeypatch):
    def broken(dev, *args):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(torch_warmup, "_launch_hamming", broken)
    thread = torch_warmup.prewarm_async(24)
    with pytest.raises(RuntimeError, match="injected launch failure"):
        thread.join(timeout=60)
    assert not thread.is_alive()
    thread.join(timeout=1)  # raised once


def test_warmup_launches_are_counted_apart():
    """Inside ``counting_as_warmup`` a launch adds to ``WARMUP_LAUNCHES``
    and leaves the wrapper's counter alone; outside, and on any other
    thread meanwhile, the wrapper's counter moves."""
    launches = {"k": 0}
    before = kernel_lib.WARMUP_LAUNCHES.get("k", 0)
    seen = []
    with kernel_lib.counting_as_warmup():
        kernel_lib.count_launch(launches, "k")
        other = threading.Thread(
            target=lambda: seen.append(
                kernel_lib.count_launch(launches, "k")))
        other.start()
        other.join(timeout=10)
    assert kernel_lib.WARMUP_LAUNCHES["k"] == before + 1
    assert launches["k"] == 1
    kernel_lib.count_launch(launches, "k")
    assert launches["k"] == 2
    del kernel_lib.WARMUP_LAUNCHES["k"]


def test_warmup_runs_on_cpu_device_and_prints_steps(capsys):
    """``warmup()`` on the CPU device: every wrapper computes its plain
    version, no step fails, no launch is counted anywhere."""
    hamming_kernels.reset_launches()
    edit_kernels.reset_launches()
    torch_warmup.warmup(lengths=(20,), edit_distances=(1, 2))
    steps = capsys.readouterr().err.splitlines()
    assert len(steps) == 4 and all(line.endswith("s") for line in steps)
    assert "context on cpu" in steps[0]
    assert not any(hamming_kernels.LAUNCHES.values())
    assert not any(edit_kernels.LAUNCHES.values())
    torch_warmup.warmup(lengths=(20,), edit_distances=(), verbose=False)
    assert capsys.readouterr().err == ""


def test_pipeline_starts_and_joins_the_thread(tmp_path, monkeypatch):
    """Pass 1 asks for the thread once, after 100,000 records and only
    for ``max_distance`` > 0, with the key length and the run's mode;
    the run joins it; a failure of the thread's work fails the run."""
    import gzip
    import random

    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    rng = random.Random(3)
    molecules = ["".join(rng.choice("ACGT") for _ in range(16))
                 for _ in range(500)]
    src = str(tmp_path / "in.fastq.gz")
    with gzip.open(src, "wt") as f:
        for i in range(120_000):
            f.write(f"@r{i}\n{rng.choice(molecules)}\n+\n{'I' * 16}\n")
    calls, joined = [], []

    class FakeThread:
        def __init__(self, error=None):
            self.error = error

        def join(self, timeout=None):
            joined.append(self)
            if self.error:
                error, self.error = self.error, None
                raise error

    def fake_prewarm(length, alphabet_size=5, max_distance=1,
                     use_edit_distance=False, _error=None):
        calls.append((length, max_distance, use_edit_distance))
        return FakeThread(_error)

    monkeypatch.setattr(torch_warmup, "prewarm_async", fake_prewarm)
    out = str(tmp_path / "out.fastq.gz")
    deduplicate_cluster([src], [out], None, 1, 1.0, chunk_records=20_000)
    assert calls == [(16, 1, False)] and len(joined) == 1
    deduplicate_cluster([src], [out], None, 0, 1.0, chunk_records=20_000)
    assert len(calls) == 1  # d = 0 never reaches the device
    monkeypatch.setattr(
        torch_warmup, "prewarm_async",
        lambda *a, **k: fake_prewarm(*a, **k,
                                     _error=RuntimeError("build failed")))
    with pytest.raises(RuntimeError, match="build failed"):
        deduplicate_cluster([src], [out], None, 2, 1.0,
                            use_edit_distance=True, chunk_records=20_000)
    assert calls[-1] == (16, 2, True) and len(joined) == 2


@pytest.mark.parametrize("out_name, max_distance, asked", [
    ("out.fastq.gz", 1, True), ("out.fastq.gz", 0, True),
    ("out.fastq", 1, False)])
def test_pipeline_prewarms_the_card_writer_for_gz_outputs(
        tmp_path, monkeypatch, out_name, max_distance, asked):
    """Pass 1 asks for the card writer's thread once, after 100,000
    records, only where an output takes the card writer (whatever the
    distance); the run joins it before pass 3 opens the output."""
    import gzip
    import random

    import fastqdedup_tpu_torch.pipeline as pipeline

    rng = random.Random(5)
    src = str(tmp_path / "in.fastq.gz")
    with gzip.open(src, "wt") as f:
        for i in range(110_000):
            seq = "".join(rng.choice("ACGT") for _ in range(12))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * 12}\n")
    out = str(tmp_path / out_name)
    joined = []

    class FakeThread:
        def join(self, timeout=None):
            joined.append(os.path.exists(out))

    monkeypatch.setattr(pipeline, "deflates_on_card",
                        lambda name, level=1: name.endswith(".gz"))
    monkeypatch.setattr(torch_warmup, "prewarm_async",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch_warmup, "prewarm_deflate_async",
                        lambda: FakeThread())
    pipeline.deduplicate_cluster([src], [out], None, max_distance, 1.0,
                                 chunk_records=20_000)
    assert joined == ([False] if asked else [])


def test_pipeline_joins_the_thread_on_its_error_path(tmp_path, monkeypatch):
    """A run that fails after the thread started (here: a record without
    its mate, after 100,000 good pairs) still waits for it."""
    import gzip

    from fastqdedup_tpu_torch.io.fastq import FastqFormatError
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    srcs = [str(tmp_path / f"r{k}.fastq.gz") for k in (1, 2)]
    for k, src in enumerate(srcs, start=1):
        with gzip.open(src, "wt") as f:
            for i in range(130_000):
                name = f"x{i}" if (k == 2 and i == 125_000) else f"r{i}"
                f.write(f"@{name}/{k}\nACGTACGTAC\n+\nIIIIIIIIII\n")
    started = threading.Event()
    release = threading.Event()
    finished = []

    def slow_prewarm(*args, **kwargs):
        def work():
            started.set()
            release.wait(timeout=60)
            finished.append(True)

        thread = torch_warmup.PrewarmThread(work)
        thread.start()
        threading.Timer(0.5, release.set).start()
        return thread

    monkeypatch.setattr(torch_warmup, "prewarm_async", slow_prewarm)
    with pytest.raises(FastqFormatError, match="not mates"):
        deduplicate_cluster(srcs, [str(tmp_path / f"o{k}.fq")
                                   for k in (1, 2)], None, 1, 1.0,
                            chunk_records=20_000)
    assert started.is_set() and finished == [True]


def test_module_runs_without_jax_and_fails_without_a_card(tmp_path):
    """``python -m fastqdedup_tpu_torch.warmup`` in a fresh interpreter
    where ``import jax`` fails: with ``FASTQDEDUP_TORCH_DEVICE=cuda`` and
    no card it exits non-zero with the device error; on the CPU device it
    runs through.  Nothing of JAX or of the JAX package gets imported."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "try:\n"
        "    runpy.run_module('fastqdedup_tpu_torch.warmup',\n"
        "                     run_name='__main__')\n"
        "finally:\n"
        "    bad = [m for m in sys.modules if m == 'fastqdedup_tpu'\n"
        "           or m.startswith('fastqdedup_tpu.')\n"
        "           or m.startswith('jax.')]\n"
        "    assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    results = {}
    for dev in ("cuda", "cpu"):
        env["FASTQDEDUP_TORCH_DEVICE"] = dev
        results[dev] = subprocess.run(
            [sys.executable, "-c", script], env=env, capture_output=True,
            text=True, timeout=300, cwd=tmp_path)
    assert results["cuda"].returncode != 0
    assert "torch.cuda.is_available() is False" in results["cuda"].stderr
    assert "AssertionError" not in results["cuda"].stderr
    assert results["cpu"].returncode == 0, results["cpu"].stderr
    assert "edit kernel L=160 d=2" in results["cpu"].stderr
