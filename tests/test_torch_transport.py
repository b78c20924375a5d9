"""The port's host byte transport (parallel/transport.py) and its
2-process strided and sharded-input runs, against the JAX package.

The socket-mesh tests wire meshes up in-process over socketpairs (no
process group needed) and run collectives concurrently on one thread per
fake process, as in tests/test_transport.py.  The 2-process runs start
two interpreters of one ``torch.distributed`` job on the CPU device
(tests/torch_two_process.py) and compare their merged output, byte for
byte, with the JAX package's single-process output on the same input.
"""

import gzip
import random
import threading
from typing import List

import numpy as np
import pytest

from fastqdedup_tpu.pipeline import deduplicate_cluster as jax_dedup
from fastqdedup_tpu_torch.parallel import transport
from fastqdedup_tpu_torch.parallel.transport import TcpMesh
from torch_two_process import run_two_processes


def _make_meshes(nproc: int) -> List[TcpMesh]:
    import socket

    socks = {}
    for a in range(nproc):
        for b in range(a + 1, nproc):
            sa, sb = socket.socketpair()
            socks[(a, b)] = sa
            socks[(b, a)] = sb
    return [TcpMesh(p, nproc,
                    {q: socks[(p, q)] for q in range(nproc) if q != p})
            for p in range(nproc)]


def _run_all(meshes, fn):
    """Run fn(mesh) concurrently on every mesh; return results in pid
    order, re-raising the first failure."""
    results = [None] * len(meshes)
    errors = []

    def work(i):
        try:
            results[i] = fn(meshes[i])
        except BaseException as exc:  # noqa: BLE001 - test harness
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a collective hung"
    if errors:
        raise errors[0]
    return results


def test_allgather_blobs_orders_by_pid():
    meshes = _make_meshes(3)
    payloads = [b"alpha", b"", b"c" * 100_000]
    got = _run_all(meshes, lambda m: m.allgather_blobs(payloads[m.pid]))
    for per_pid in got:
        assert per_pid == payloads


def test_allgather_blobs_empty_is_barrier():
    meshes = _make_meshes(4)
    got = _run_all(meshes, lambda m: m.allgather_blobs(b""))
    assert all(r == [b""] * 4 for r in got)


def test_allgather_scatter_segments_and_padding():
    """Each host's stream scatters into per-host segment views; bytes
    between/after segments are discarded, and the local stream lands via
    memcpy (no wire)."""
    nproc = 3
    meshes = _make_meshes(nproc)
    rng = np.random.default_rng(7)
    streams = [rng.integers(0, 256, size=n, dtype=np.uint8)
               for n in (100, 0, 57)]

    def run(mesh):
        d0a = np.zeros(30, dtype=np.uint8)
        d0b = np.zeros(40, dtype=np.uint8)
        d2 = np.zeros(57, dtype=np.uint8)
        dests = [[(d0a, 10), (d0b, 50)], [], [(d2, 0)]]
        mesh.allgather_scatter(streams[mesh.pid], dests)
        return d0a, d0b, d2

    for d0a, d0b, d2 in _run_all(meshes, run):
        assert d0a.tobytes() == streams[0][10:40].tobytes()
        assert d0b.tobytes() == streams[0][50:90].tobytes()
        assert d2.tobytes() == streams[2].tobytes()


def test_allgather_scatter_segment_larger_than_stream():
    """A destination view longer than the stream is filled only up to
    the stream's true size (the collective path pads; TCP does not)."""
    meshes = _make_meshes(2)
    streams = [np.arange(20, dtype=np.uint8), np.arange(5, dtype=np.uint8)]

    def run(mesh):
        d_all = [np.full(32, 0xEE, dtype=np.uint8) for _ in range(2)]
        mesh.allgather_scatter(streams[mesh.pid],
                               [[(d_all[0], 0)], [(d_all[1], 0)]])
        return d_all

    for d_all in _run_all(meshes, run):
        assert d_all[0][:20].tobytes() == streams[0].tobytes()
        assert (d_all[0][20:] == 0xEE).all()
        assert d_all[1][:5].tobytes() == streams[1].tobytes()


def test_large_transfer_round_trip():
    """Multi-slice interleaved send path (> 4 MiB per stream)."""
    meshes = _make_meshes(2)
    rng = np.random.default_rng(3)
    streams = [rng.integers(0, 256, size=9 << 20, dtype=np.uint8)
               for _ in range(2)]

    def run(mesh):
        outs = [np.zeros(9 << 20, dtype=np.uint8) for _ in range(2)]
        mesh.allgather_scatter(streams[mesh.pid],
                               [[(outs[0], 0)], [(outs[1], 0)]])
        return outs

    for outs in _run_all(meshes, run):
        for h in range(2):
            assert (outs[h] == streams[h]).all()


def test_sequential_calls_tagged():
    """Back-to-back collectives stay in lockstep via call tags."""
    meshes = _make_meshes(2)

    def run(mesh):
        return [mesh.allgather_blobs(bytes([mesh.pid, i])) for i in range(5)]

    for per_pid in _run_all(meshes, run):
        for i, blobs in enumerate(per_pid):
            assert blobs == [bytes([0, i]), bytes([1, i])]


def test_close_wakes_blocked_peer():
    """close() on one side makes a peer blocked in a collective raise
    instead of hanging — the fail-fast contract abort_mesh relies on."""
    meshes = _make_meshes(2)
    failure = []

    def victim():
        try:
            meshes[0].allgather_blobs(b"x")
        except BaseException as exc:  # noqa: BLE001
            failure.append(exc)

    t = threading.Thread(target=victim)
    t.start()
    meshes[1].close()
    t.join(timeout=30)
    assert not t.is_alive(), "peer stayed blocked after close()"
    assert failure and isinstance(failure[0], (ConnectionError, OSError))


def test_get_mesh_single_process_is_none(monkeypatch):
    monkeypatch.setattr(transport, "_mesh", None)
    monkeypatch.setattr(transport, "_mesh_failed", False)
    assert transport.get_mesh() is None  # no process group here


def test_abort_mesh_idempotent_without_mesh(monkeypatch):
    monkeypatch.setattr(transport, "_mesh", None)
    monkeypatch.setattr(transport, "_mesh_failed", False)
    transport.abort_mesh()
    transport.abort_mesh()
    assert transport._mesh is None and transport._mesh_failed


# --------------------------------------------------------------------- #
# 2-process runs


def _molecule_reads(rng, n, length, n_mols):
    mols = ["".join(rng.choice("ACGT") for _ in range(length))
            for _ in range(n_mols)]
    records = []
    for i in range(n):
        seq = list(rng.choice(mols))
        if rng.random() < 0.25:
            seq[rng.randrange(length)] = rng.choice("ACGT")
        qual = "".join(chr(33 + rng.randrange(25, 40)) for _ in range(length))
        records.append(f"@r{i} c\n{''.join(seq)}\n+\n{qual}\n")
    return records


@pytest.mark.parametrize("shard_hash,transport_on", [
    (False, True), (True, True), (True, False)])
def test_two_process_strided_parity(tmp_path, shard_hash, transport_on):
    """Both processes run the same ``deduplicate_cluster`` call on one
    gzip (not BGZF) input, so chunks stride across them; the merged
    output equals the JAX package's single-process output.
    ``shard_hash`` lowers FASTQDEDUP_SHARD_HASH_MIN_ROWS so the sharded
    bucket-hash all-gather runs; the last case turns the socket mesh off
    (FASTQDEDUP_TCP_TRANSPORT=0), so every exchange goes through gloo."""
    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wt") as f:
        f.write("".join(_molecule_reads(random.Random(77), 800, 24, 60)))
    single_out = tmp_path / "single.fastq.gz"
    jax_dedup([str(src)], [str(single_out)], None, 1, 0.001,
              chunk_records=64)

    dist_out = tmp_path / "dist.fastq.gz"
    env = {}
    if shard_hash:
        env["FASTQDEDUP_SHARD_HASH_MIN_ROWS"] = "1"
    if not transport_on:
        env["FASTQDEDUP_TCP_TRANSPORT"] = "0"
    run_two_processes(tmp_path, f"""
from fastqdedup_tpu_torch.pipeline import deduplicate_cluster
deduplicate_cluster([{str(src)!r}], [{str(dist_out)!r}], None, 1, 0.001,
                    chunk_records=64)
""", env)
    want = gzip.open(single_out, "rb").read()
    assert gzip.open(dist_out, "rb").read() == want
    assert want


def test_two_process_sharded_input_parity(tmp_path):
    """FASTQDEDUP_SHARDED_INPUT=1: every process feeds its own input
    shard; the concatenation of the per-process outputs equals the JAX
    package's single-process run on the concatenated input."""
    records = _molecule_reads(random.Random(55), 900, 22, 50)
    shards = [tmp_path / "shard0.fastq.gz", tmp_path / "shard1.fastq.gz"]
    for path, part in zip(shards, (records[:450], records[450:])):
        with gzip.open(path, "wt") as f:
            f.write("".join(part))
    full = tmp_path / "full.fastq.gz"
    with gzip.open(full, "wt") as f:
        f.write("".join(records))
    single_out = tmp_path / "single.fastq.gz"
    jax_dedup([str(full)], [str(single_out)], None, 1, 0.001,
              chunk_records=64)

    outs = [tmp_path / "out0.fastq.gz", tmp_path / "out1.fastq.gz"]
    run_two_processes(tmp_path, f"""
from fastqdedup_tpu_torch.pipeline import deduplicate_cluster
shards = [{str(shards[0])!r}, {str(shards[1])!r}]
outs = [{str(outs[0])!r}, {str(outs[1])!r}]
deduplicate_cluster([shards[pid]], [outs[pid]], None, 1, 0.001,
                    chunk_records=64)
""", {"FASTQDEDUP_SHARDED_INPUT": "1"})
    merged = gzip.open(outs[0], "rb").read() + gzip.open(outs[1], "rb").read()
    assert merged == gzip.open(single_out, "rb").read()
    assert merged


def test_torchrun_cli_two_processes(tmp_path):
    """The CLI under ``torchrun --nproc-per-node 2``: each process joins
    the job through torch's environment, and the merged output equals
    the JAX package's CLI output."""
    import os
    import signal
    import subprocess
    import sys

    from torch_two_process import PORT_ATTEMPTS, REPO, free_port, \
        port_was_taken

    src = tmp_path / "in.fastq.gz"
    with gzip.open(src, "wt") as f:
        f.write("".join(_molecule_reads(random.Random(9), 1500, 20, 150)))
    want_out = tmp_path / "jax.fastq.gz"
    jax_dedup([str(src)], [str(want_out)], None, 1, 1.0)
    out = tmp_path / "port.fastq.gz"
    env = dict(os.environ, PYTHONPATH=REPO, FASTQDEDUP_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    log = tmp_path / "torchrun.log"
    for _ in range(PORT_ATTEMPTS):  # another test may take the port
        with open(log, "wb") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--nnodes",
                 "1", "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
                 "--master-port", str(free_port()), "-m",
                 "fastqdedup_tpu_torch", "-E", str(src), "-o", str(out)],
                env=env, cwd=tmp_path, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True)
        try:
            proc.wait(timeout=180)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        text = log.read_text(errors="replace")
        if proc.returncode == 0 or not port_was_taken(text):
            break
    assert proc.returncode == 0, text[-3000:]
    assert text.count("Finished.") == 2
    want = gzip.open(want_out, "rb").read()
    assert gzip.open(out, "rb").read() == want
    assert want
