"""The benchmark's frozen generator against ``chip_smoke.generate_fastq``,
and the port's pass 1 on the files it writes."""

import gzip
import os

import numpy as np
import pytest

from benchmark.generate import generate_fastq
from benchmark.reference import dedup

PROFILES = [{}, {"dup_factor": 30, "error_rate": 0.005},
            {"indel_rate": 0.1}, {"lowq_rate": 0.05}]


@pytest.mark.parametrize("profile", PROFILES, ids=repr)
@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_generator_draws_chip_smokes_records(profile, seed, tmp_path):
    import chip_smoke

    mine = {k: str(tmp_path / f"mine.{k}") for k in ("r", "m", "u")}
    theirs = {k: str(tmp_path / f"theirs.{k}") for k in ("r", "m", "u")}
    generate_fastq(mine["r"], 300_001, 100, 12, seed=seed,
                   mate_path=mine["m"], umi_path=mine["u"], **profile)
    chip_smoke.generate_fastq(theirs["r"], 300_001, 100, 12, seed=seed,
                              mate_path=theirs["m"], umi_path=theirs["u"],
                              **profile)
    for k in mine:
        with gzip.open(mine[k]) as a, gzip.open(theirs[k]) as b:
            assert a.read() == b.read()


def test_port_reads_benchmark_files_by_byte_ranges(tmp_path):
    from fastqdedup_tpu_torch import pipeline

    path = str(tmp_path / "reads.fastq.gz")
    generate_fastq(path, 200_000, 100, 12, seed=3)
    parts = pipeline._plan_local_ranges([path], 4)
    assert parts is not None and len(parts) == 4
    assert sum(plan[0][2] for plan, _ in parts) == 200_000
    assert os.path.getsize(path) > 0


@pytest.mark.parametrize("indel_rate", [0.0, 0.1])
def test_quality_mix_puts_reads_on_both_sides_of_the_limit(indel_rate,
                                                           tmp_path):
    """The traffic's quality mix: a low 3' tail puts a read on either side
    of 0.001, and reads whose mean error rate is 0.001 in decimal sit on
    the limit, where float32 and float64 disagree for some."""
    path = str(tmp_path / "reads.fastq.gz")
    generate_fastq(path, 100_000, 100, 12, seed=2**31 + 5,
                   indel_rate=indel_rate, tail_rate=0.15, edge_rate=0.05)
    lines = dedup.gunzip(path).split(b"\n")[:-1]
    quals = lines[3::4]
    lens = np.array([len(q) for q in quals])
    assert set(lens) == ({100} if not indel_rate else {99, 100, 101})
    width = lens.max()
    padded = np.full((len(quals), width), 33, dtype=np.uint8)
    for i, q in enumerate(quals):
        padded[i, :len(q)] = np.frombuffer(q, dtype=np.uint8)
    rate64 = dedup.error_rates(padded, lens)
    rate32 = dedup.error_rates(padded, lens, dtype=np.float32)
    failed = rate64 > 0.001
    assert 0.12 < failed.mean() < 0.25
    on_edge = np.abs(rate64 - 0.001) < 1e-12
    assert on_edge.sum() > 0.03 * len(quals)
    assert (failed != (rate32 > np.float32(0.001))).sum() > 20
    past = np.arange(width)[None, :] >= lens[:, None]
    assert ((padded == 63) | past).all(axis=1).sum() > 100     # all Q30
