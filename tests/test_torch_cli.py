"""The port's command line beside the JAX package's (tests/test_cli.py on
``fastqdedup_tpu.cli``): the same flags parse to the same values, the
compressed formats round-trip to the same bytes, and the help text names
every environment knob the port has.  The port runs on the CPU device.
"""

import gzip
import random
import sys

import pytest

from fastqdedup_tpu import cli as jax_cli
from fastqdedup_tpu_torch import cli as torch_cli

ARGUMENT_LISTS = {
    "defaults": ["r1.fastq"],
    "no error rate filter": ["-E", "r1.fastq"],
    "repeatable output": ["-o", "a.fastq", "-o", "b.fastq", "r1.fastq",
                          "r2.fastq"],
    "verbosity stacking": ["-vv", "-q", "r1.fastq"],
    "highest_count": ["-c", "highest_count", "r.fastq"],
    "adjacency": ["-c", "adjacency", "r.fastq"],
    "directional": ["-c", "directional", "r.fastq"],
    "check lengths, distance, edit": ["-l", "16,8", "-d", "2", "--edit",
                                      "r1.fastq", "r2.fastq"],
    "prefix and error rate": ["-p", "out_R", "-e", "0.01", "r1.fastq"],
}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _records(seed, n, length):
    rng = random.Random(seed)
    return "".join(
        f"@r{i}\n{''.join(rng.choice('ACGT') for _ in range(length))}\n"
        f"+\n{'I' * length}\n" for i in range(n)).encode()


def test_defaults():
    args = torch_cli.argument_parser().parse_args(["r1.fastq"])
    assert args.fastq == ["r1.fastq"]
    assert args.max_distance == 1
    assert args.max_average_error_rate == 0.001
    assert args.cluster_dissection_method == "directional"
    assert args.prefix == "fastqdedup_R"
    assert not args.edit
    assert args.output is None


@pytest.mark.parametrize("case", sorted(ARGUMENT_LISTS))
def test_parser_matches_jax_package(case):
    argv = ARGUMENT_LISTS[case]
    got = vars(torch_cli.argument_parser().parse_args(argv))
    want = vars(jax_cli.argument_parser().parse_args(argv))
    assert got == want


def test_parser_values():
    parse = torch_cli.argument_parser().parse_args
    assert parse(["-E", "r1.fastq"]).max_average_error_rate == 1.0
    assert parse(ARGUMENT_LISTS["repeatable output"]).output == [
        "a.fastq", "b.fastq"]
    stacked = parse(["-vv", "-q", "r1.fastq"])
    assert (stacked.verbose, stacked.quiet) == (2, 1)


def test_same_options_as_jax_package():
    """Every option string and default of the JAX package's parser is in
    the port's."""
    def options(parser):
        return {tuple(a.option_strings) or a.dest: (a.default, a.nargs,
                                                    a.choices and
                                                    tuple(a.choices))
                for a in parser._actions}

    assert options(torch_cli.argument_parser()) == \
        options(jax_cli.argument_parser())


def test_epilog_names_every_knob():
    epilog = " ".join(torch_cli.argument_parser().epilog.split())
    for knob in ("FASTQDEDUP_TORCH_DEVICE", "FASTQDEDUP_PROFILE",
                 "FASTQDEDUP_INGEST_READERS", "FASTQDEDUP_DEVICE_QUALITY",
                 "FASTQDEDUP_REQUIRE_MESH"):
        assert knob in epilog
    # The two sentences on the device filter and the mesh are the JAX
    # package's, word for word.
    reference = " ".join(jax_cli.argument_parser().epilog.split())
    start = reference.index("FASTQDEDUP_DEVICE_QUALITY")
    assert reference[start:] in epilog


def test_main_end_to_end_default_output_name(tmp_path, monkeypatch):
    """Default output naming: prefix + 1-based index, in the working
    directory; the bytes are the JAX CLI's."""
    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wb") as f:
        f.write(_records(1, 50, 12))
    payloads = {}
    for tag, cli in (("jax", jax_cli), ("torch", torch_cli)):
        workdir = tmp_path / tag
        workdir.mkdir()
        monkeypatch.chdir(workdir)
        monkeypatch.setattr(sys, "argv", ["fastqdedup", "-q", str(src)])
        cli.main()
        with gzip.open(workdir / "fastqdedup_R1.fastq.gz", "rb") as f:
            payloads[tag] = f.read()
    assert payloads["torch"] == payloads["jax"]
    assert payloads["torch"].startswith(b"@r")


@pytest.mark.parametrize("ext", ["gz", "bz2", "xz", "zst"])
def test_compressed_format_round_trip(ext, tmp_path, monkeypatch):
    """Every codec the opener handles (.gz/.bz2/.xz/.zst) round-trips
    through the port's CLI to the JAX CLI's decompressed bytes."""
    if ext == "zst":
        pytest.importorskip("zstandard")
    from fastqdedup_tpu_torch.io.opener import xopen

    payload = _records(3, 40, 16)
    src = tmp_path / f"in.fastq.{ext}"
    with xopen(str(src), "wb") as f:
        f.write(payload)
    with xopen(str(src), "rb") as f:
        assert f.read() == payload
    results = {}
    for tag, cli in (("jax", jax_cli), ("torch", torch_cli)):
        out = tmp_path / f"{tag}.fastq.{ext}"
        monkeypatch.setattr(sys, "argv", [
            "fastqdedup", "-q", "-o", str(out), str(src)])
        cli.main()
        with xopen(str(out), "rb") as f:
            results[tag] = f.read()
    assert results["torch"] == results["jax"]
    assert results["torch"].startswith(b"@r")
    assert results["torch"].count(b"\n") % 4 == 0
