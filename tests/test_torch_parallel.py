"""Component labels across several devices (parallel/sharded.py,
ops/components.py) against the JAX package's.

The port's mesh is a list of torch devices; here every shard sits on the
CPU device, which runs the same code the card runs with several shards
on one card.  The JAX side runs on the 8 virtual CPU devices of
tests/conftest.py.  Labels and keep masks are integers and bits: exact
equality.
"""

import gzip
import logging
import random

import numpy as np
import pytest
import torch

from fastqdedup_tpu.ops.components import \
    connected_components_device as jax_components_device
from fastqdedup_tpu.ops.encode import EncodeTable, keys_to_matrix
from fastqdedup_tpu.ops.labels import dedup_step
from fastqdedup_tpu.parallel import sharded as jax_sharded
from fastqdedup_tpu_torch import runtime
from fastqdedup_tpu_torch.ops.components import (
    connected_components_device,
    connected_components_host,
)
from fastqdedup_tpu_torch.parallel import sharded


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cpu")


def _keys_and_counts(rng, n, length=12):
    seeds, keys = [], []
    while len(keys) < n:
        if seeds and rng.random() < 0.6:
            base = list(rng.choice(seeds))
            base[rng.randrange(length)] = rng.choice("ACGT")
            key = "".join(base)
        else:
            key = "".join(rng.choice("ACGT") for _ in range(length))
            seeds.append(key)
        if key not in keys:
            keys.append(key)
    counts = np.array([rng.randrange(1, 10) for _ in keys], dtype=np.int64)
    return keys, counts


@pytest.mark.parametrize("shards,n,seed", [(8, 64, 13), (8, 101, 13),
                                           (4, 40, 17), (4, 300, 19)])
def test_sharded_dedup_step_matches_jax(shards, n, seed):
    """The port's sharded_dedup_step on ``shards`` CPU shards equals the
    JAX package's on a ``shards``-device mesh and the dense oracle."""
    keys, counts = _keys_and_counts(random.Random(seed), n)
    table = EncodeTable("ACGTN")
    matrix, _ = keys_to_matrix([k.encode() for k in keys], table)
    matrix = np.asarray(matrix)
    rank = np.argsort(np.argsort(keys)).astype(np.int64)

    mesh = sharded.make_mesh(shards)
    assert mesh == [torch.device("cpu")] * shards
    labels, keep = sharded.sharded_dedup_step(matrix, counts, rank,
                                              table.size, 1, mesh)
    want_labels, want_keep = jax_sharded.sharded_dedup_step(
        matrix, counts, rank, table.size, 1, jax_sharded.make_mesh(shards))
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(keep, want_keep)
    dense_labels, dense_keep = dedup_step(matrix, counts, rank,
                                          table.size, 1)
    np.testing.assert_array_equal(labels, np.asarray(dense_labels))
    np.testing.assert_array_equal(keep, np.asarray(dense_keep))
    assert labels.dtype == np.int64 and keep.dtype == bool


def _chain_edges(rng, n, n_edges):
    """Random edges plus long chains, so pointer doubling needs several
    rounds."""
    ei = rng.integers(0, n, n_edges)
    ej = rng.integers(0, n, n_edges)
    chain = np.arange(0, n - 1, 3)
    return (np.concatenate([ei, chain]).astype(np.int64),
            np.concatenate([ej, chain + 1]).astype(np.int64))


@pytest.mark.parametrize("n,n_edges", [(2, 0), (50, 10), (1000, 300)])
def test_connected_components_device_matches_jax(n, n_edges):
    """Both device functions on one padded edge list (masked rows
    included) give the same int32 labels, which equal union-find's."""
    rng = np.random.default_rng(n)
    ei, ej = _chain_edges(rng, n, n_edges)
    pad = 16
    edges = np.zeros((len(ei) + pad, 2), dtype=np.int32)
    edges[:len(ei), 0] = ei
    edges[:len(ei), 1] = ej
    edges[len(ei):] = rng.integers(0, n, (pad, 2))  # masked out
    mask = np.arange(len(edges)) < len(ei)
    want = np.asarray(jax_components_device(edges, mask, num_nodes=n))
    got = connected_components_device(torch.from_numpy(edges),
                                      torch.from_numpy(mask), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  connected_components_host(n, ei, ej))


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_sharded_components_from_edges_equal_union_find(shards):
    rng = np.random.default_rng(shards)
    ei, ej = _chain_edges(rng, 5000, 2500)
    labels = sharded.sharded_components_from_edges(
        5000, ei, ej, sharded.make_mesh(shards))
    np.testing.assert_array_equal(labels,
                                  connected_components_host(5000, ei, ej))
    np.testing.assert_array_equal(
        labels, jax_sharded.sharded_components_from_edges(
            5000, ei, ej, jax_sharded.make_mesh(8)))


def test_engine_takes_mesh_path_on_virtual_mesh(monkeypatch):
    from fastqdedup_tpu_torch.engine import build_clusters

    monkeypatch.setenv("FASTQDEDUP_REQUIRE_MESH", "1")
    monkeypatch.setenv("FASTQDEDUP_MESH_MIN_EDGES", "1")
    monkeypatch.setattr(runtime, "local_device_count", lambda: 8)
    before = sharded.MESH_COMPONENT_RUNS
    keys = [b"AAAA", b"AAAT", b"AATT", b"CCCC", b"CCCA", b"GGGG"]
    clusters = build_clusters(keys, [4, 1, 1, 2, 3, 1], max_distance=1)
    assert sharded.MESH_COMPONENT_RUNS == before + 1
    got = sorted(frozenset(c.keys) for c in clusters)
    assert got == sorted([frozenset(keys[:3]), frozenset(keys[3:5]),
                          frozenset(keys[5:])])


def test_pipeline_mesh_route_writes_jax_bytes(tmp_path, monkeypatch):
    """The whole pipeline with the local-device count patched to 4: the
    labels come from the mesh (MESH_COMPONENT_RUNS goes up, and
    FASTQDEDUP_REQUIRE_MESH=1 forbids the fallback) and the output bytes
    equal the JAX package's."""
    from fastqdedup_tpu.pipeline import deduplicate_cluster as jax_dedup
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    rng = random.Random(23)
    mols = ["".join(rng.choice("ACGT") for _ in range(20))
            for _ in range(150)]
    records = []
    for i in range(1500):
        seq = list(rng.choice(mols))
        for _ in range(rng.randrange(3)):
            seq[rng.randrange(20)] = rng.choice("ACGT")
        records.append(f"@r{i}\n{''.join(seq)}\n+\n{'I' * 20}\n")
    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wt") as f:
        f.write("".join(records))
    want_out, got_out = tmp_path / "jax.fastq.gz", tmp_path / "port.fastq.gz"
    jax_dedup([str(src)], [str(want_out)], None)
    monkeypatch.setenv("FASTQDEDUP_REQUIRE_MESH", "1")
    monkeypatch.setenv("FASTQDEDUP_MESH_MIN_EDGES", "1")
    monkeypatch.setattr(runtime, "local_device_count", lambda: 4)
    before = sharded.MESH_COMPONENT_RUNS
    deduplicate_cluster([str(src)], [str(got_out)], None)
    assert sharded.MESH_COMPONENT_RUNS > before
    want = gzip.open(want_out, "rb").read()
    assert gzip.open(got_out, "rb").read() == want
    assert want


def test_require_mesh_raises_below_edge_threshold(monkeypatch):
    from fastqdedup_tpu_torch.engine import build_clusters

    monkeypatch.setenv("FASTQDEDUP_REQUIRE_MESH", "1")
    monkeypatch.setenv("FASTQDEDUP_MESH_MIN_EDGES", "1000000")
    with pytest.raises(RuntimeError, match="FASTQDEDUP_MESH_MIN_EDGES"):
        build_clusters([b"AAAA", b"AAAT"], [1, 1], max_distance=1)


def test_require_mesh_raises_on_one_device(monkeypatch):
    """Above the edge threshold but with one local device there is no
    mesh: REQUIRE_MESH makes that an error instead of union-find."""
    monkeypatch.setenv("FASTQDEDUP_REQUIRE_MESH", "1")
    assert runtime.local_device_count() == 1
    with pytest.raises(RuntimeError, match="local_device_count=1"):
        sharded.components_on_mesh(4, np.array([0]), np.array([1]))


def test_mesh_fallback_is_loud_and_require_mesh_fatal(monkeypatch, caplog):
    def boom(*a, **k):
        raise ValueError("injected mesh failure")

    monkeypatch.setattr(sharded, "sharded_components_from_edges", boom)
    monkeypatch.setattr(runtime, "local_device_count", lambda: 8)
    ei = np.array([0], dtype=np.int64)
    ej = np.array([1], dtype=np.int64)

    # Default: degrade to host path (None) but WARN.
    monkeypatch.delenv("FASTQDEDUP_REQUIRE_MESH", raising=False)
    with caplog.at_level(logging.WARNING, logger="fastqdedup"):
        assert sharded.components_on_mesh(4, ei, ej) is None
    assert any("falling back to host union-find" in r.message
               for r in caplog.records)

    # Required: the injected failure propagates.
    monkeypatch.setenv("FASTQDEDUP_REQUIRE_MESH", "1")
    with pytest.raises(ValueError, match="injected mesh failure"):
        sharded.components_on_mesh(4, ei, ej)


def test_local_devices_rule(monkeypatch):
    """The CPU device is one device; a process group of one keeps it."""
    assert runtime.local_devices() == [torch.device("cpu")]
    assert sharded.make_mesh() == [torch.device("cpu")]
    monkeypatch.setenv("FASTQDEDUP_TORCH_DEVICE", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            runtime.local_devices()
