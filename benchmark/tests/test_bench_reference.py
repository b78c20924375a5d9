"""The plain reference against the JAX package's pinned outputs and
against the port on the CPU device.

Run with ``python -m pytest benchmark/tests -q``.
"""

import gzip
import hashlib
import itertools
import os
import random

import numpy as np
import pytest

from benchmark.generate import generate_traffic
from benchmark.reference import dedup, expected_outputs

# sha256 of the decompressed output of the JAX package's
# deduplicate_cluster on seed-7 1M-read inputs (chip_smoke.EXPECTED_SHA256).
PINNED = {
    "default": (
        [], {},
        "42856e003e1d71bbd68164af0ac03390b57fea4349496557e5fb5bf51a6174fa"),
    "dense": (
        [], {"dup_factor": 30, "error_rate": 0.005},
        "0244e40af1f8594d01b6a67409eb439819cff2c1ee62186e82e1da548c5039cd"),
    "indel": (
        ["--edit"], {"indel_rate": 0.1},
        "12ffb9c23697060591d458f4545556240c7cfba3ea8e762cc6602e582d9cad22"),
}


def traffic(**params):
    return {"read_len": 100, "umi_len": 12, "files": ["reads"], **params}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_reference_reproduces_pinned_sha256(name, tmp_path):
    args, params, want = PINNED[name]
    paths = generate_traffic(traffic(**params), 1_000_000, 7, str(tmp_path))
    got = hashlib.sha256(b"".join(expected_outputs(args, paths)))
    assert got.hexdigest() == want


# Command lines and traffic the reference is held to against the port:
# the benchmark's configurations and mixes, and the other documented
# modes (several files, check lengths, d=2, the other dissections, a
# quality filter that drops reads).
PORT_CASES = [
    ([], {"dup_factor": 30, "error_rate": 0.005}),
    ([], {}),
    ([], {"indel_rate": 0.1}),
    (["--edit"], {"indel_rate": 0.1}),
    (["--edit"], {}),
    (["--edit", "-d", "2"], {"indel_rate": 0.1}),
    (["-l", "12", "-d", "2", "-c", "adjacency"], {}),
    (["-c", "highest_count"], {"dup_factor": 30, "error_rate": 0.005}),
    (["-d", "2", "-c", "adjacency"], {"dup_factor": 30, "error_rate": 0.01}),
    (["-l", "16,8", "-e", "0.0005"], {"lowq_rate": 0.05,
                                      "files": ["reads", "mate"]}),
    (["-l", "::2,4:30,", "-E"], {"files": ["reads", "mate", "umi"]}),
]


@pytest.mark.parametrize("args,params", PORT_CASES,
                         ids=[" ".join(a) + repr(p) for a, p in PORT_CASES])
def test_reference_equals_port_on_cpu(args, params, tmp_path, monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")
    from fastqdedup_tpu_torch import cli, pipeline
    from fastqdedup_tpu_torch.dissect import CLUSTER_DISSECTION_METHODS

    paths = generate_traffic(traffic(**params), 5_000, 2**31 + 11,
                             str(tmp_path))
    outs = [str(tmp_path / f"out{i}.fastq.gz") for i in range(len(paths))]
    a = cli.argument_parser().parse_args(
        args + paths + [x for o in outs for x in ("-o", o)])
    pipeline.deduplicate_cluster(
        paths, outs, cli.length_string_to_slices(a.check_lengths)
        if a.check_lengths else None, a.max_distance,
        a.max_average_error_rate,
        CLUSTER_DISSECTION_METHODS[a.cluster_dissection_method], a.edit)
    got = [gzip.open(o).read() for o in outs]
    want = expected_outputs(args, paths)
    assert got == want
    assert 0 < want[0].count(b"\n") // 4 < 5_000


def scalar_levenshtein(a: bytes, b: bytes) -> int:
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1,
                                       prev + (ca != cb))
    return row[-1]


@pytest.mark.parametrize("d", [0, 1, 2, 3])
def test_levenshtein_within_matches_scalar(d):
    rng = random.Random(d)
    words = []
    for _ in range(300):
        base = [rng.choice(b"ACGT") for _ in range(rng.randrange(0, 12))]
        for _ in range(rng.randrange(0, 4)):
            op = rng.randrange(3)
            pos = rng.randrange(len(base) + 1)
            if op == 0 and base:
                del base[min(pos, len(base) - 1)]
            elif op == 1:
                base.insert(pos, rng.choice(b"ACGT"))
            elif base:
                base[min(pos, len(base) - 1)] = rng.choice(b"ACGT")
        words.append(bytes(base))
    width = max(map(len, words))
    keys = np.zeros((len(words), width), dtype=np.uint8)
    for i, w in enumerate(words):
        keys[i, :len(w)] = np.frombuffer(w, dtype=np.uint8)
    lens = np.array([len(w) for w in words])
    pairs = np.array(list(itertools.combinations(range(len(words)), 2)))
    got = dedup.levenshtein_within(keys, lens, pairs[:, 0], pairs[:, 1], d)
    want = [scalar_levenshtein(words[i], words[j]) <= d for i, j in pairs]
    assert got.tolist() == want


@pytest.mark.parametrize("d,edit", [(1, False), (2, False), (1, True),
                                    (2, True)])
def test_neighbours_finds_every_pair(d, edit):
    rng = np.random.default_rng(d + 10 * edit)
    words = set()
    while len(words) < 400:
        length = int(rng.integers(6, 9)) if edit else 8
        words.add(bytes(rng.choice(np.frombuffer(b"ACG", np.uint8), length)))
    words = sorted(words)
    keys = np.zeros((len(words), 8), dtype=np.uint8)
    for i, w in enumerate(words):
        keys[i, :len(w)] = np.frombuffer(w, dtype=np.uint8)
    lens = np.array([len(w) for w in words])
    ei, ej = dedup.neighbours(keys, lens, d, edit)

    def within(a, b):
        if edit:
            return scalar_levenshtein(a, b) <= d
        return len(a) == len(b) and sum(x != y for x, y in zip(a, b)) <= d
    want = {(i, j) for i, j in itertools.combinations(range(len(words)), 2)
            if within(words[i], words[j])}
    assert set(zip(ei.tolist(), ej.tolist())) == want


def test_key_order_is_python_string_order():
    rng = np.random.default_rng(3)
    words = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                              int(rng.integers(1, 7)))) for _ in range(500)]
    keys = np.zeros((len(words), 6), dtype=np.uint8)
    for i, w in enumerate(words):
        keys[i, :len(w)] = np.frombuffer(w, dtype=np.uint8)
    uniq = np.unique(keys.view("V6").ravel())
    got = [bytes(u).rstrip(b"\0") for u in uniq]
    assert got == sorted(set(words))


def test_gunzip_reads_bgzf_and_plain_gzip(tmp_path):
    data = os.urandom(200_000) + b"x" * 300_000
    plain = tmp_path / "plain.gz"
    with gzip.open(plain, "wb") as f:
        f.write(data[:100])
    with open(plain, "ab") as f:
        f.write(gzip.compress(data[100:]))
    assert dedup.gunzip(str(plain)) == data
    from benchmark.generate import BGZF_EOF, bgzf_block
    bgzf = tmp_path / "blocks.gz"
    with open(bgzf, "wb") as f:
        for i in range(0, len(data), 65280):
            f.write(bgzf_block(data[i:i + 65280]))
        f.write(BGZF_EOF)
    assert dedup.gunzip(str(bgzf)) == data
