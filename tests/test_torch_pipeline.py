"""End-to-end parity of the port's pipeline with the JAX package's.

``deduplicate_cluster`` of ``fastqdedup_tpu_torch`` and of
``fastqdedup_tpu`` run on the same generated FASTQ files; the outputs
must be byte-identical (exact equality: the whole run is integer and
byte work).  The port runs on the CPU device, where every kernel wrapper
computes its plain PyTorch version.
"""

import gzip
import os
import random
import subprocess
import sys

import pytest

import fastqdedup_tpu.engine as jax_engine
import fastqdedup_tpu_torch.engine as torch_engine
from fastqdedup_tpu.dissect import CLUSTER_DISSECTION_METHODS
from fastqdedup_tpu.keys import length_string_to_slices
from fastqdedup_tpu.pipeline import deduplicate_cluster as jax_dedup
from fastqdedup_tpu_torch.ops import hamming_kernels
from fastqdedup_tpu_torch.pipeline import deduplicate_cluster as torch_dedup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _write_fastq(path, records):
    data = "".join(f"@{name}\n{seq}\n+\n{qual}\n"
                   for name, seq, qual in records)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(data.encode())


def _read_out(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _reads(rng, n, length, dup_rate=0.6, error_rate=0.02, suffix=""):
    reads, molecules = [], []
    for i in range(n):
        if molecules and rng.random() < dup_rate:
            seq = [c if rng.random() >= error_rate else rng.choice("ACGT")
                   for c in rng.choice(molecules)]
            seq = "".join(seq)
        else:
            seq = "".join(rng.choice("ACGT") for _ in range(length))
            molecules.append(seq)
        qual = "".join(chr(33 + rng.randrange(30, 40)) for _ in range(length))
        if rng.random() < 0.05:
            qual = chr(35) * length
        reads.append((f"read{i}{suffix}", seq, qual))
    return reads


def _indel_reads(rng, n, length, suffix=""):
    """Duplicate-heavy reads where copies carry one substitution,
    deletion or insertion, so lengths vary by one around ``length``."""
    reads, molecules = [], []
    for i in range(n):
        if molecules and rng.random() < 0.7:
            seq = list(rng.choice(molecules))
            op = rng.random()
            pos = rng.randrange(len(seq))
            if op < 0.3:
                seq[pos] = rng.choice("ACGT")
            elif op < 0.5:
                del seq[pos]
            elif op < 0.7:
                seq.insert(pos, rng.choice("ACGT"))
            seq = "".join(seq)
        else:
            seq = "".join(rng.choice("ACGT") for _ in range(length))
            molecules.append(seq)
        qual = "".join(chr(33 + rng.randrange(30, 40)) for _ in seq)
        reads.append((f"read{i}{suffix}", seq, qual))
    return reads


def _run_both(tmp_path, inputs, check_slices=None, max_distance=1,
              method="directional", edit=False, max_average_error_rate=0.001,
              suffix=".fastq.gz", chunk_records=53):
    """Both packages on the same files; ``method`` is a name or a
    dissection function.  Outputs must be byte-identical and not empty."""
    paths = []
    for idx, records in enumerate(inputs):
        path = str(tmp_path / f"in{idx}{suffix}")
        _write_fastq(path, records)
        paths.append(path)
    func = CLUSTER_DISSECTION_METHODS[method] \
        if isinstance(method, str) else method
    outs = {}
    for tag, dedup in (("jax", jax_dedup), ("torch", torch_dedup)):
        outs[tag] = [str(tmp_path / f"{tag}{i}{suffix}")
                     for i in range(len(paths))]
        dedup(paths, outs[tag], check_slices, max_distance,
              max_average_error_rate, func, edit,
              chunk_records=chunk_records)
    for want, got in zip(outs["jax"], outs["torch"]):
        want_bytes, got_bytes = _read_out(want), _read_out(got)
        assert got_bytes == want_bytes
        assert got_bytes
    return outs


def test_directional_d1_byte_identical(tmp_path):
    _run_both(tmp_path, [_reads(random.Random(42), 400, 20)])


@pytest.mark.parametrize("method,d", [("directional", 1), ("adjacency", 2)])
def test_forced_device_route_byte_identical(tmp_path, monkeypatch, method,
                                            d):
    """The host brute-force budget pinned low in both engines (as in
    tests/test_pipeline.py's device-path parity test), so the length
    group goes through the tile sweep instead of the host path."""
    for engine in (jax_engine, torch_engine):
        monkeypatch.setattr(engine, "_HOST_BYTE_OP_BUDGET", 1)
        monkeypatch.setattr(engine, "HOST_LIMIT", 8)
    hamming_kernels.reset_launches()
    _run_both(tmp_path, [_reads(random.Random(46), 400, 20)], method=method,
              max_distance=d)
    # On the CPU no kernel launches: the plain versions ran.
    assert not any(hamming_kernels.LAUNCHES.values())


def test_paired_with_check_lengths_byte_identical(tmp_path):
    rng = random.Random(44)
    r1 = _reads(rng, 300, 24, suffix="/1")
    r2 = [(name.replace("/1", "/2"),
           "".join(rng.choice("ACGT") for _ in range(24)), qual)
          for name, _, qual in r1]
    _run_both(tmp_path, [r1, r2],
              check_slices=length_string_to_slices("16,8"))


@pytest.mark.parametrize("method", ["directional", "adjacency",
                                    "highest_count"])
def test_edit_byte_identical(tmp_path, method):
    """``--edit`` above HOST_LIMIT unique keys: the port's candidate
    generation and banded verification (plain version on the CPU) write
    the JAX package's bytes, and differ from the Hamming run."""
    reads = _indel_reads(random.Random(50), 900, 24)
    assert len({seq for _, seq, _ in reads}) > torch_engine.HOST_LIMIT
    edit = _run_both(tmp_path, [reads], method=method, edit=True)
    (tmp_path / "hamming").mkdir()
    hamming = _run_both(tmp_path / "hamming", [reads], method=method)
    with gzip.open(edit["torch"][0], "rb") as fe, \
            gzip.open(hamming["torch"][0], "rb") as fh:
        assert len(fe.read()) < len(fh.read())


def test_edit_paired_with_check_lengths_byte_identical(tmp_path):
    rng = random.Random(51)
    r1 = _indel_reads(rng, 700, 20, suffix="/1")
    r2 = [(name.replace("/1", "/2"),
           "".join(rng.choice("ACGT") for _ in range(20)), "I" * 20)
          for name, _, _ in r1]
    _run_both(tmp_path, [r1, r2],
              check_slices=length_string_to_slices("12,6"), edit=True,
              max_distance=2)


def test_cli_runs_without_jax(tmp_path):
    """The port's CLI in a fresh interpreter where ``import jax`` fails:
    nothing on its path may need jax.  FASTQDEDUP_PROFILE makes it write
    a torch.profiler trace."""
    src = str(tmp_path / "in.fastq.gz")
    _write_fastq(src, _reads(random.Random(5), 300, 20))
    out = str(tmp_path / "out.fastq.gz")
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = ['fastqdedup-tpu-torch', sys.argv[1], '-o', sys.argv[2]]"
        "\n"
        "from fastqdedup_tpu_torch.cli import main\n"
        "main()\n"
        "bad = [m for m in sys.modules if m == 'fastqdedup_tpu'\n"
        "       or m.startswith('fastqdedup_tpu.') or m.startswith('jax.')]\n"
        "assert not bad, bad\n")
    trace_dir = tmp_path / "trace"
    env = dict(os.environ, FASTQDEDUP_TORCH_DEVICE="cpu",
               FASTQDEDUP_PROFILE=str(trace_dir),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", script, src, out],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "distinct reads" in proc.stderr
    assert [p.name for p in trace_dir.iterdir()
            if p.name.endswith(".trace.json")]
    want = str(tmp_path / "want.fastq.gz")
    jax_dedup([src], [want], None)
    with gzip.open(want, "rb") as fw, gzip.open(out, "rb") as fg:
        assert fg.read() == fw.read()


def test_cuda_requested_without_cuda_raises(tmp_path, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = str(tmp_path / "in.fastq.gz")
    _write_fastq(src, _reads(random.Random(6), 20, 12))
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="FASTQDEDUP_TORCH_DEVICE"):
        torch_dedup([src], [str(tmp_path / "out.fastq.gz")], None)


def test_device_quality_filter_byte_identical(tmp_path, monkeypatch):
    """FASTQDEDUP_DEVICE_QUALITY=1 (the float32 device filter, ported as
    ops/phred.py): both packages write the same bytes under it.  Every
    seventh read is all Q30, whose float32 mean sits on the 0.001
    threshold, and 5% are low quality, so the filter drops reads."""
    reads = _reads(random.Random(7), 400, 20)
    reads = [(name, seq, "?" * len(seq) if i % 7 == 0 else qual)
             for i, (name, seq, qual) in enumerate(reads)]
    monkeypatch.setenv("FASTQDEDUP_DEVICE_QUALITY", "1")
    _run_both(tmp_path, [reads])


def test_three_files_umi_adjacency_d2(tmp_path):
    """Two read files and a UMI file, adjacency, d=2, check lengths
    8,8,8 (tests/test_pipeline.py's three-file case)."""
    rng = random.Random(45)
    r1 = _reads(rng, 150, 20)
    r2 = [(name, "".join(rng.choice("ACGT") for _ in range(20)), qual)
          for name, _, qual in r1]
    umi = [(name, "".join(rng.choice("ACGT") for _ in range(8)), "I" * 8)
           for name, _, _ in r1]
    _run_both(tmp_path, [r1, r2, umi],
              check_slices=length_string_to_slices("8,8,8"),
              max_distance=2, method="adjacency")


def test_distance_zero_exact_dedup(tmp_path):
    _run_both(tmp_path, [_reads(random.Random(47), 150, 10, error_rate=0.0)],
              max_distance=0)


def test_uncompressed_output(tmp_path):
    """Plain ``.fastq`` in and out."""
    outs = _run_both(tmp_path, [_reads(random.Random(48), 80, 12)],
                     suffix=".fastq", chunk_records=16)
    with open(outs["torch"][0], "rb") as f:
        assert f.read(1) == b"@"


def test_arity_validation():
    for dedup in (jax_dedup, torch_dedup):
        with pytest.raises(ValueError, match="Amount of output files"):
            dedup(["a.fastq"], [], None)
        with pytest.raises(ValueError, match="Amount of check lengths"):
            dedup(["a.fastq"], ["b.fastq"], [slice(8), slice(8)])


def test_memory_budget_fallback_restreams(tmp_path, monkeypatch):
    """With a 1-byte in-RAM budget the record arena is abandoned after
    its first part, so pass 3 re-streams the input from disk: the same
    bytes, and the JAX package's."""
    records = [(f"r{i} x", "ACGTACGTACGT" if i % 2 else "ACGTACGTACGA",
                "I" * 12) for i in range(50)]
    arena = _run_both(tmp_path, [records], max_average_error_rate=1.0)
    monkeypatch.setenv("FASTQDEDUP_MEMORY_LIMIT", "1")
    (tmp_path / "streamed").mkdir()
    streamed = _run_both(tmp_path / "streamed", [records],
                         max_average_error_rate=1.0)
    assert _read_out(arena["torch"][0]) == _read_out(streamed["torch"][0])


def test_record_arena_paths_byte_identical(tmp_path, monkeypatch):
    """Both pass-3 layouts of the port write the JAX package's bytes:
    record arena (default) and re-stream (the arena over a 1-byte
    budget).  Paired files with Illumina comment headers."""
    reads = _reads(random.Random(17), 400, 24)
    inputs = [[(f"{n} 1:x", s, q) for n, s, q in reads],
              [(f"{n} 2:x", s[::-1], q) for n, s, q in reads]]
    runs = []
    for tag, env in (("arena", {}),
                     ("streamed", {"FASTQDEDUP_MEMORY_LIMIT": "1"})):
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        (tmp_path / tag).mkdir()
        outs = _run_both(tmp_path / tag, inputs)
        runs.append([_read_out(o) for o in outs["torch"]])
    assert runs[0] == runs[1]


def test_custom_dissection_with_unknown_keys(tmp_path):
    """A user-supplied dissection strategy may yield strings that are not
    cluster keys; they are ignored in both packages, neither crashing nor
    marking a neighbouring real key."""

    def weird_strategy(cluster, max_distance, use_edit_distance):
        yield "ZZZZZZZZZZZZZZZZZZZZ"   # unknown, sorts past every key
        yield "AAAAAAAAAAAAAAAAAAAA"   # unknown, insertion point 0
        yield "NOT_A_KEY_LENGTH"       # unknown length entirely
        yield max(cluster)[1]          # one real representative

    _run_both(tmp_path, [_reads(random.Random(47), 120, 20)],
              method=weird_strategy, max_average_error_rate=1.0)


def test_numpy_fallback_accumulator_and_renderer(tmp_path, monkeypatch):
    """Without the native library the port's pure-numpy accumulator and
    renderer write the bytes of its native path and of the JAX package."""
    import fastqdedup_tpu_torch.pipeline as pl

    reads = _reads(random.Random(49), 300, 20)
    native = _run_both(tmp_path, [reads])
    monkeypatch.setattr(pl, "_make_key_accumulator",
                        lambda expected=0: pl._NumpyKeyAccumulator(expected))
    monkeypatch.delattr(
        "fastqdedup_tpu_torch.native.loader.render_records_native")
    # Also force pass 3's searchsorted membership path (no C hash lookup).
    monkeypatch.delattr("fastqdedup_tpu_torch.native.loader.KeyAccumulator")
    fallback = str(tmp_path / "fallback.fastq.gz")
    torch_dedup([str(tmp_path / "in0.fastq.gz")], [fallback], None,
                chunk_records=53)
    assert _read_out(fallback) == _read_out(native["torch"][0])


def test_edit_two_member_mixed_length_count_tie(tmp_path):
    """Edit mode: a two-member cluster whose keys differ in length and
    tie on count breaks the tie on string order (AAAAAAAA and AAAAAAA,
    Levenshtein 1, one read each)."""
    reads = [("r0 x", "AAAAAAAA", "IIIIIIII"),
             ("r1 x", "AAAAAAA", "IIIIIII"),
             ("r2 x", "CCCCCCCC", "IIIIIIII")]
    _run_both(tmp_path, [reads], edit=True, max_average_error_rate=1.0,
              chunk_records=2)
