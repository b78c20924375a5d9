"""What the benchmark imports.  No module the runner loads imports JAX or
the JAX package, and the plain reference imports nothing of the program,
of ``chip_smoke``, of the ``bench*`` scripts or of the tests.  Names are
compared by their top-level part (before the first dot), whole:
``fastqdedup_tpu_torch`` is not ``fastqdedup_tpu``."""

import ast
import glob
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX = {"jax", "jaxlib", "flax", "fastqdedup_tpu"}


def imported(path: str) -> set:
    """Top-level names of the absolute imports of one source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts: str) -> list:
    return sorted(glob.glob(os.path.join(BENCH, *parts, "**", "*.py"),
                            recursive=True))


def test_no_benchmark_module_imports_jax():
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not imported(path) & JAX, path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = imported(path)
        assert not names & (JAX | {"fastqdedup_tpu_torch", "chip_smoke",
                                   "tests", "benchmark"}), path
        assert not {n for n in names if n.startswith("bench")}, path
        assert names <= {"argparse", "zlib", "concurrent", "typing",
                         "numpy"}, path


def test_a_run_loads_no_jax(tmp_path):
    """A whole run on the CPU device, then the modules it loaded."""
    code = (
        "import json, sys, tempfile\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"tempfile.tempdir = {str(tmp_path)!r}\n"
        "from benchmark import harness\n"
        "cell = harness.load_cell('hamming-d1.dense')\n"
        "cell.config = dict(harness.load_json(harness.BENCH + "
        "'/configs/edit-d1.json'), reads_per_job=5000)\n"
        "r = harness.run_cell(cell, 9, 0.2, True, harness.process_start(),"
        " require_cuda=False)\n"
        "print(json.dumps({'correct': r['correct'], 'modules': sorted("
        "{m.split('.')[0] for m in sys.modules})}))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "FASTQDEDUP_TORCH_DEVICE": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert "fastqdedup_tpu_torch" in out["modules"]
    assert not set(out["modules"]) & JAX
