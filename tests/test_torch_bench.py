"""The port's measurement tools on the CPU device, at tiny sizes.

Each script runs as a child process with ``PYTHONPATH`` set to the
repository alone and ``jax``, ``jaxlib`` and ``fastqdedup_tpu`` made
unimportable, so it can pass only on the port's own code; the oracle
(the JAX package, ``bench.measure_mode``) runs in the test process.
``FASTQDEDUP_TORCH_DEVICE=cpu`` is how a script is asked for the CPU;
without it and without a card every script exits non-zero and prints
no result.
"""

import gzip
import hashlib
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("bench_torch.py", "bench_kernels_torch.py",
           "bench_scaling_torch.py", "tools/hunt100m_torch.py",
           "tools/scale_profile_torch.py", "tools/device_majority_torch.py")


def run_script(tmp_path, script, args=(), env=None, patch="",
               cpu=True, timeout=300):
    """(exit code, stdout, stderr) of ``script`` run with ``args`` in a
    child interpreter; ``patch`` is Python run in the child before the
    script (with the repository importable)."""
    path = os.path.join(REPO, script)
    child = tmp_path / "child.py"
    child.write_text(
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'fastqdedup_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"sys.argv = [{path!r}, *{list(args)!r}]\n"
        + textwrap.dedent(patch)
        + f"\nrunpy.run_path({path!r}, run_name='__main__')\n")
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("XLA_FLAGS", "FASTQDEDUP_TORCH_DEVICE")}
    child_env.update({"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
                      "TMPDIR": str(tmp_path)})
    if cpu:
        child_env["FASTQDEDUP_TORCH_DEVICE"] = "cpu"
    child_env.update(env or {})
    done = subprocess.run([sys.executable, str(child)], env=child_env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=timeout)
    return done.returncode, done.stdout, done.stderr


def last_json(stdout):
    lines = [row for row in stdout.splitlines() if row.startswith("{")]
    assert lines, stdout
    return json.loads(lines[-1])


def jax_sha256(src, edit=False):
    """sha256 of the JAX package's decompressed output on ``src``, with
    ``bench.py``'s arguments."""
    from fastqdedup_tpu.dissect import CLUSTER_DISSECTION_METHODS
    from fastqdedup_tpu.pipeline import deduplicate_cluster

    out = f"{src}.jax{int(edit)}.fastq.gz"
    deduplicate_cluster([src], [out], None, 1, 0.001,
                        CLUSTER_DISSECTION_METHODS["directional"], edit)
    with gzip.open(out, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# --------------------------------------------------------------------- #
# bench_torch.py

BENCH_FIELDS = ["metric", "value", "unit", "runs_s", "all_runs_s",
                "warm_runs_s", "edit_reads_per_sec", "edit_runs_s",
                "edit_all_runs_s", "edit_warm_runs_s", "device", "sha256",
                "sha256_expected", "first_run_s", "prewarm_s", "launches",
                "device_busy_share"]


def test_bench_prints_one_line_with_the_jax_package_bytes(tmp_path):
    import bench

    code, out, err = run_script(tmp_path, "bench_torch.py",
                                env={"BENCH_READS": "3000"})
    assert code == 0, err[-3000:]
    assert len(out.splitlines()) == 1
    line = last_json(out)
    keys = list(line)
    assert [k for k in keys if k in BENCH_FIELDS] == BENCH_FIELDS
    assert "vs_baseline" not in line
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert line["unit"] == "reads/s" and line["value"] > 0
    assert len(line["runs_s"]) == 5 and len(line["edit_runs_s"]) == 5
    assert line["first_run_s"] == line["warm_runs_s"][0]
    assert line["sha256_expected"] is None  # 3000 reads are not pinned
    assert line["device_busy_share"] is None  # no device time on the CPU
    assert set(line["launches"]) == {
        "bucket_within_packed", "within_tile_packed",
        "rowwise_within_packed", "banded_within_edit_distance",
        "deflate_members"}
    # The output is deflated on the card only: the CPU run uses the host.
    assert line["launches"]["deflate_members"] == 0
    src = str(tmp_path / "same.fastq.gz")
    bench.generate_fastq(src, 3000, 100, 12)
    assert line["sha256"] == jax_sha256(src)
    assert line["edit_sha256"] == jax_sha256(src, edit=True)


def test_bench_input_checks_its_pinned_sha256(tmp_path):
    """``BENCH_INPUT=small`` (1,500 reads) runs that input of
    ``chip_smoke.INPUTS`` and holds it to its pin; a wrong pin exits
    non-zero and prints no line."""
    import chip_smoke

    env = {"BENCH_INPUT": "small"}
    code, out, err = run_script(tmp_path, "bench_torch.py", env=env)
    assert code == 0, err[-3000:]
    line = last_json(out)
    assert line["sha256"] == line["sha256_expected"] \
        == chip_smoke.EXPECTED_SHA256["small"]
    assert "edit_runs_s" not in line
    code, out, err = run_script(
        tmp_path, "bench_torch.py", env=env,
        patch="import chip_smoke\n"
              "chip_smoke.EXPECTED_SHA256['small'] = '0' * 64\n")
    assert code != 0
    assert out.strip() == ""
    assert "!= the JAX package's" in err


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_exit_without_a_card_unless_asked_for_the_cpu(tmp_path,
                                                               script):
    code, out, err = run_script(tmp_path, script, cpu=False, timeout=120)
    assert code != 0
    assert out.strip() == ""
    assert "FASTQDEDUP_TORCH_DEVICE=cpu" in err


def _fake_runs(warm, measured):
    """A ``run_one`` that returns the given warm and measured times."""
    queues = {True: list(warm), False: list(measured)}

    def run_one(edit, warm, attempt):
        return queues[warm].pop(0)

    return run_one


@pytest.mark.parametrize("n_reads,warm,measured,warm_is_src", [
    # Warm-up plateaus, then five steady runs.
    (1000, [2.0, 1.5, 1.44, 1.46, 1.47, 1.45],
     [1.3, 1.2, 1.25, 1.21, 1.22, 1.26], True),
    # No window of five within 1.25x: the tightest one, budget 12.
    (1000, [1.0, 1.0, 1.0, 1.0],
     [1.0, 2.0, 1.0, 2.0, 1.3, 2.0, 1.0, 2.0, 1.0, 2.1, 1.0, 2.0], True),
    # The best time is a warm run, counted only where it read the input.
    (1000, [0.5, 0.9, 0.95, 0.97], [1.0, 1.01, 1.02, 1.0, 1.03], True),
    (1000, [0.5, 0.9, 0.95, 0.97], [1.0, 1.01, 1.02, 1.0, 1.03], False),
    # Above 2M reads: 2 warm runs, a window of 3 in a budget of 4.
    (3_000_000, [9.0, 8.0], [7.0, 9.5, 7.1, 7.2], True),
])
def test_measure_mode_copy_picks_what_bench_picks(n_reads, warm, measured,
                                                  warm_is_src):
    import bench
    import bench_torch

    want = bench.measure_mode(_fake_runs(warm, measured), n_reads, False,
                              warm_is_src)
    got = bench_torch.measure_mode(_fake_runs(warm, measured), n_reads,
                                   False, warm_is_src)
    assert got["elapsed"] == want["elapsed"]
    for key in ("times", "all_times", "warm_times"):
        assert [round(t, 2) for t in got[key]] == want[key], key


# --------------------------------------------------------------------- #
# bench_kernels_torch.py --verify


def test_verify_sweep_holds_the_plain_versions_to_the_oracles(tmp_path):
    code, out, err = run_script(tmp_path, "bench_kernels_torch.py",
                                ["--verify", "--reduced"])
    assert code == 0, err[-3000:]
    line = last_json(out)
    assert line["verify"] == "ok" and line["geometries"] == 23
    assert line["by_kernel"] == {
        "within_tile_packed": 5, "bucket_within_packed": 6,
        "rowwise_within_packed": 7, "banded_within_edit_distance": 5}
    assert line["device"]["platform"] == "cpu"


FLIP = """
import torch
from fastqdedup_tpu_torch.ops import edit_kernels, hamming_kernels
module = {module}
inner = module.{name}

def flipped(*args):
    out = inner(*args).clone()
    if {condition}:
        flat = out.view(-1)
        flat[{index}] = ~flat[{index}] if out.dtype == torch.bool \\
            else flat[{index}] ^ 1
    return out

module.{name} = flipped
"""


@pytest.mark.parametrize("module,name,condition,index,geometry", [
    ("hamming_kernels", "pairs_within_plain", "True", 0, "tile N=128"),
    ("hamming_kernels", "pairs_within_plain", "args[0].shape[1] >= 512",
     -1, "buckets S=512"),
    ("hamming_kernels", "rowwise_within_plain", "True", 5, "pair list"),
    ("edit_kernels", "banded_within_plain", "True", 3, "edit P=64 L=24"),
])
def test_verify_sweep_fails_on_one_flipped_bit(tmp_path, module, name,
                                               condition, index, geometry):
    code, out, err = run_script(
        tmp_path, "bench_kernels_torch.py", ["--verify", "--reduced"],
        patch=FLIP.format(module=module, name=name, condition=condition,
                          index=index))
    assert code == 1, err[-3000:]
    assert '"verify"' not in out
    assert "FAILED: " + geometry in err, err[-3000:]


# --------------------------------------------------------------------- #
# tools/hunt100m_torch.py, bench_scaling_torch.py, scale_profile_torch.py,
# device_majority_torch.py


def test_hunt_repeats_with_one_sha256(tmp_path):
    src = tmp_path / "hunt.fastq.gz"
    code, out, err = run_script(tmp_path, "tools/hunt100m_torch.py",
                                ["2", str(src)], {"HUNT_READS": "2000"})
    assert code == 0, err[-3000:]
    summary = last_json(out)
    assert len(summary["reps_s"]) == 2
    assert [row.startswith("rep ") for row in out.splitlines()[:2]] \
        == [True, True]
    assert summary["sha256"] == jax_sha256(str(src))
    assert summary["peak_rss_bytes"] > 0
    assert summary["device_peak_allocated_bytes"] == [None, None]
    assert len(summary["launches_per_rep"]) == 2


def test_scaling_bench_writes_the_one_process_bytes(tmp_path):
    code, out, err = run_script(
        tmp_path, "bench_scaling_torch.py",
        env={"SCALE_READS": "8000", "SCALE_PROCS": "1,2",
             "SCALE_REPEATS": "1", "SCALE_INPROC_REPS": "1"})
    assert code == 0, err[-3000:]
    assert len(out.splitlines()) == 1
    line = last_json(out)
    assert line["metric"] == "scaling_efficiency_2_processes"
    assert line["parity"] is True
    assert set(line["walls_s"]) == {"1", "2"}
    assert "vs_baseline" not in line and "cuda:0" in line["note"]


def test_scale_profile_keeps_each_process_log(tmp_path):
    logs = tmp_path / "logs"
    code, out, err = run_script(
        tmp_path, "tools/scale_profile_torch.py", ["2", "8000", str(logs)],
        {"SCALE_INPROC_REPS": "1"})
    assert code == 0, err[-3000:]
    assert last_json(out)["processes"] == 2
    for p in range(2):
        text = (logs / f"scale_P2_proc{p}.log").read_text()
        assert "spans of job" in text and "PROCWALL" in text


def test_device_majority_holds_parity(tmp_path):
    code, out, err = run_script(tmp_path, "tools/device_majority_torch.py",
                                ["3000"])
    line = last_json(out)
    assert code == (0 if line["pass"] else 1), err[-3000:]
    assert set(line["configs"]) == {"standard_5x", "deepseq_30x"}
    for config in line["configs"].values():
        assert config["parity"] is True
        assert set(config["runs"]) == {"measured_rates", "local_chip_rates"}
