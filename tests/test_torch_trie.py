"""The port's ``Trie`` facade, ``trie_stats`` and
``filter_fastq_files_on_set`` against the JAX package's.

The scenarios of tests/test_trie.py run on both packages' ``Trie`` with
the same inputs: membership under both distances, clusters popped one at
a time and all at once (compared as sets: extraction order is not part
of the contract), the stats and memory bookkeeping, and the streaming
filter helper.  Outputs are booleans, counts, strings and bytes: exact
equality throughout.  The port runs on the CPU device.
"""

import gzip
import random

import pytest

import fastqdedup_tpu
import fastqdedup_tpu_torch
from fastqdedup_tpu import Trie as JaxTrie
from fastqdedup_tpu_torch import Trie as TorchTrie
from fastqdedup_tpu_torch import engine as torch_engine

READS = ["AAAA", "AAAA", "AAAC", "AAGC", "AGGC", "CCCG", "CCCG",
         "TTCA", "TTCC", "TTTA", "TTT", "TTC"]


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _both(reads, alphabet=""):
    tries = []
    for cls in (JaxTrie, TorchTrie):
        trie = cls(alphabet)
        for read in reads:
            trie.add_sequence(read)
        tries.append(trie)
    return tries


def _many_reads(seed, n=420):
    """Reads around 16 bases with substitutions and indels: more than
    HOST_LIMIT unique keys, so the engine's device paths run."""
    rng = random.Random(seed)
    molecules = ["".join(rng.choice("ACGT") for _ in range(16))
                 for _ in range(n // 3)]
    reads = []
    for _ in range(n):
        seq = list(rng.choice(molecules))
        op = rng.random()
        pos = rng.randrange(len(seq))
        if op < 0.3:
            seq[pos] = rng.choice("ACGT")
        elif op < 0.45:
            del seq[pos]
        elif op < 0.6:
            seq.insert(pos, rng.choice("ACGT"))
        reads.append("".join(seq))
    return reads


@pytest.mark.parametrize("probe", [
    "CGTACGTA", "CGTACGT", "GTACGTA", "CGTAACGTA", "CCTACGT", "AGTACGTT",
    "TTTT", "",
])
@pytest.mark.parametrize("d", [0, 1, 2])
def test_contains_sequence_matches_jax(probe, d):
    jt, tt = _both(["CGTACGTA", "TTGCAAC", "TTGCA"])
    for edit in (False, True):
        assert tt.contains_sequence(probe, d, use_edit_distance=edit) is \
            jt.contains_sequence(probe, d, use_edit_distance=edit)


@pytest.mark.parametrize("edit", [False, True])
def test_contains_sequence_above_host_limit_matches_jax(edit):
    reads = _many_reads(3)
    jt, tt = _both(reads)
    assert len(set(reads)) > torch_engine.HOST_LIMIT
    rng = random.Random(4)
    probes = [r[1:] for r in reads[:20]] + \
        ["".join(rng.choice("ACGT") for _ in range(16)) for _ in range(10)]
    for probe in probes:
        for d in (1, 2):
            assert tt.contains_sequence(probe, d, edit) is \
                jt.contains_sequence(probe, d, edit)


def _drain(trie, d, edit):
    return [frozenset(c) for c in trie.pop_all_clusters(d, edit)]


@pytest.mark.parametrize("reads_of", ["small", "many"])
@pytest.mark.parametrize("edit", [False, True])
def test_pop_all_clusters_match_jax(reads_of, edit):
    reads = READS if reads_of == "small" else _many_reads(5)
    jt, tt = _both(reads, alphabet="ACGT")
    want = _drain(jt, 1, edit)
    got = _drain(tt, 1, edit)
    assert set(got) == set(want) and len(got) == len(want)
    assert tt.number_of_sequences == jt.number_of_sequences == 0


@pytest.mark.parametrize("edit", [False, True])
def test_pop_cluster_one_at_a_time_matches_jax(edit):
    """The same seed order: each pop returns the same cluster, seed
    first, and the alphabet and sequence count move in step."""
    jt, tt = _both(_many_reads(6))
    while jt.number_of_sequences:
        want = jt.pop_cluster(2, use_edit_distance=edit)
        got = tt.pop_cluster(2, use_edit_distance=edit)
        assert got[0] == want[0]
        assert set(got) == set(want)
        assert tt.number_of_sequences == jt.number_of_sequences
        assert tt.alphabet == jt.alphabet
    with pytest.raises(LookupError):
        tt.pop_cluster(1)


def test_alphabet_and_stats_match_jax():
    jt, tt = _both(["abc", "badabccdaafacb", "bcadac"])
    assert tt.alphabet == jt.alphabet == "abc"
    for reads, alphabet in ((READS, "ACGTN"), (_many_reads(7), "")):
        jt, tt = _both(reads, alphabet)
        assert tt.raw_stats() == jt.raw_stats()
        assert tt.memory_size() == jt.memory_size()
        assert fastqdedup_tpu_torch.trie_stats(tt) == \
            fastqdedup_tpu.trie_stats(jt)
        assert "Total memory usage" in fastqdedup_tpu_torch.trie_stats(tt)


def test_interleaved_ops_match_jax():
    jt, tt = _both(["AAAA", "AAAT"])
    for trie in (jt, tt):
        trie.pop_cluster(1)
        trie.add_sequence("CCCC")
        trie.add_sequence("CCCG")
    assert tt.contains_sequence("CCCA", 1) is jt.contains_sequence("CCCA", 1)
    assert set(tt.pop_cluster(1)) == set(jt.pop_cluster(1))
    assert tt.raw_stats() == jt.raw_stats() == []
    with pytest.raises(ValueError, match="c was repeated"):
        TorchTrie(alphabet="abcc")


def test_filter_fastq_files_on_set_matches_jax(tmp_path):
    rng = random.Random(8)
    paths = []
    for mate in (1, 2):
        records = []
        for i in range(60):
            seq = "".join(rng.choice("ACGT") for _ in range(12))
            records.append(f"@r{i}/{mate}\n{seq}\n+\n{'I' * 12}\n")
        path = tmp_path / f"in{mate}.fastq.gz"
        with gzip.open(path, "wt") as f:
            f.write("".join(records))
        paths.append(str(path))

    def keyfunc(records):
        return "".join(r.sequence[:4] for r in records)

    outs = {}
    for tag, fn in (
            ("jax", fastqdedup_tpu.filter_fastq_files_on_set),
            ("torch", fastqdedup_tpu_torch.filter_fastq_files_on_set)):
        # The key set of every third record pair, consumed by the call.
        keys = set()
        readers = [fastqdedup_tpu_torch.file_to_fastq_reader(p)
                   for p in paths]
        for i, records in enumerate(zip(*readers)):
            if i % 3 == 0:
                keys.add(keyfunc(records))
        outs[tag] = [str(tmp_path / f"{tag}{m}.fastq.gz") for m in (1, 2)]
        fn(paths, outs[tag], keys, keyfunc)
        assert not keys
    for want, got in zip(outs["jax"], outs["torch"]):
        with gzip.open(want, "rb") as fw, gzip.open(got, "rb") as fg:
            data = fg.read()
            assert data == fw.read() and data.count(b"\n@") >= 10
