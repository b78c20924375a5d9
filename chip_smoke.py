#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``fastqdedup_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line to stdout:

1. ``device`` — the card's name and power limit;
2. ``build`` — compiles every kernel source (``csrc/*.cu``) with nvcc,
   one process per source, into one library;
3. ``kernel`` — each kernel against its plain PyTorch version on the card,
   exact equality, at the main path's shapes plus edge cases (for the
   all-pairs kernel both of its routes: widths 2 to 300, ``length <= d``,
   alphabets 5 to 24, N != M tiles, buckets of pad rows only, K = 1 and
   odd K, d = 0 to 2; for the edit kernel d = 0, 2, 3 and 6, empty
   strings, length gaps above d, lengths 99/100/101, arbitrary pad bytes,
   lengths at the edges of 4- and 8-symbol words with the only difference
   in the last symbol or in the first pad byte, widths 1, 30, 100 and
   300, d at and above the width, P = 1 and P off the block's pairs, and
   the indexed entry, also with equal and repeated indices; d = 1, 2 and
   6 are timed; ``edit_verify_indexed(..., packed=True)`` on the
   nibble-packed key matrix against ``packed=False``; for the pair-list
   kernel paired rows and its indexed entry, the pair-list route's
   launch, at P off the block with 5, 13, 19 and 27 lanes, and the
   route's largest batches at 1M reads, bucket after bucket
   (``ROUTE_BATCHES``: D, dense's, and U, umi12's, both timed, each
   beside the floor of an empty kernel under the same replays).  A timed
   line carries the kernel's time from
   CUDA-graph replays (``ms``, no host gaps; inputs L2-warm), the time of
   one launch between two events (``ms_one_launch``, which includes the
   host's launch path), the plain version's time taken in turns with it,
   and the kernel's bound on this card: the bytes and operations counted
   from the shapes (``kernel_bound``), the larger of their two times, and
   the share of it the kernel reached; for the all-pairs kernel also
   ``library_ms``, the one-hot product of ``onehot_product`` timed the
   same way (match counts only);
   ``deflate`` — the deflate kernel against its plain version, byte for
   byte, on 9 inputs: FASTQ at a member's edge sizes and one whole
   window of the card writer (``bgzf.DEVICE_WINDOW_MEMBERS`` members),
   random bytes that take stored blocks, zeros, long repeats;
   ``edit-candidates`` — each kernel of the ``--edit`` route's card join
   (``ops/edit_candidates``) against its plain version on the same input
   and the whole join against the host's, byte for byte (the cell's
   traffic and keys with indels, d = 1 and 2, three shards, short keys,
   delayed uploads), then the join at the benchmark cell's shape timed
   step by step beside the host join (``--edit-candidates`` alone);
   ``verify`` — every kernel against host oracles that share no code with
   the port's plain versions (numpy all-pairs comparisons, the scalar
   ``distance.within_distance``) at the 23 geometries of
   ``bench_kernels_torch.verify_kernels`` (the same function as
   ``python3 bench_kernels_torch.py --verify``): tiles at L=151 d=3 (Lp
   160) and at alphabet 12, buckets of every size class at L=100 d=1 and
   L=151 d=2, pair lists of 13, 5 and 19 lanes and in the route's bucket
   order through the indexed entry at 13, 2, 27 and 5 lanes, the edit
   kernel at 24 bp
   and on 100 bp pairs with indels at d = 1 to 3;
4. ``warmup`` — ``fastqdedup_tpu_torch.warmup.warmup()`` once, its steps
   printed; its launches must count apart from real work;
5. ``pipeline`` — ``deduplicate_cluster`` with its defaults (Hamming d=1,
   directional, error rate 0.001) on 1M generated 100 bp reads; the
   sha256 of the decompressed output must equal the JAX package's;
6. ``route`` — further runs so that every kernel is launched by the
   pipeline: a duplicate-dense input, a 12-base check length (UMI-style
   keys, large pigeonhole buckets), a small input whose length group
   the tile sweep takes, and the Levenshtein path (``--edit``) on the
   default input and on an input with indels.  Where the measured-rate
   routing does not reach a kernel, the phase forces it with the
   packages' rate knobs and says so; a forced run must write the same
   bytes as the unforced one.  Launch counts are set to 0 before the
   Hamming runs and again before the edit runs, and read after each;
7. ``configs`` — the documented configurations of the system
   (``BASELINE.json``) that the runs above leave out, each at 1M records
   per file against a sha256 pinned from the JAX package (``CONFIGS``):
   ``highest_count``; a quality filter that drops 5% of the reads;
   paired files with check lengths 16,8; two read files and a UMI file
   with ``adjacency`` and d=2; d=2 ``adjacency`` on 12-base keys;
   ``--edit`` at d=2 on the input with indels (``--edit`` directional
   d=1 is phase 6's ``edit`` and ``indel`` runs).  Several outputs are
   hashed concatenated in order.  Launch counts from 0; every launch's
   shape and distance is recorded at the library's entry points, and the
   phase must have launched the all-pairs kernel at d=2 on buckets of S
   >= 512, the pair-list kernel at d=2 and the edit kernel at d=2,
   forcing as phase 6 does where the measured rates do not reach one;
8. ``api`` — the ``Trie`` facade in Levenshtein mode (membership queries
   and ``pop_all_clusters`` over 2,000 reads with indels) on the card and
   on the CPU device: equal answers, and the card's run, counted from 0,
   launches the edit kernel;
   ``async`` — pass 2's asynchronous transfers: the bucket route
   (several batches in flight), the pair-list route and edit
   verification batches, every upload delayed on the device by about
   10 ms of spinning, must give the CPU device's pairs and answers
   exactly; then the ``umi12`` and ``dense`` runs under
   ``torch.cuda.set_sync_debug_mode("warn")``, with the synchronizing
   calls counted by the line of the port that made them and summed for
   ``ops/bucket.py`` and ``ops/edit.py``;
9. ``distributed`` — two processes of one ``torch.distributed`` job
   (gloo over a ``TCPStore`` on localhost, both on ``cuda:0``) run the
   ``default``, ``umi12`` and ``edit`` inputs (BGZF, so each process
   ingests its byte range) and the default input split into two BGZF
   halves in sharded-input mode.  The merged outputs must have the
   pinned sha256s.  Per process it prints the wall time, the kernel
   launches (counted from 0 before each run) and whether the TCP socket
   mesh was up; then each of the first three runs once more under
   ``torch.profiler`` for the card's busy time.  The umi12 runs must
   launch ``bucket_within_packed`` and the edit runs
   ``banded_within_edit_distance``, summed over both processes;
10. ``mesh`` — component labels of the umi12 run's edge list with
    ``sharded_components_from_edges`` on 2 shards of ``cuda:0`` (and on
    every card when there are several) must equal host union-find;
11. ``quality`` — the default run with ``FASTQDEDUP_DEVICE_QUALITY=1`` on
    the card and on the CPU device must write the same bytes.

Then one ``{"kernels": [...]}`` line (launch counts of phases 5-7 and 9,
times, bounds and errors of phase 3, the ``verify`` phase's geometries a
kernel as ``oracle_geometries``; every path that writes ``.gz`` on the
card must have launched the deflate kernel), the ``nvidia-smi`` name/power-limit line,
and the result line ``{"ok": true, "device": {...}}`` last.  Any failed
check, or a child process that fails, exits non-zero before the result
line.  Without CUDA, or without the package beside this script, it exits
2 and prints no result.  ``--distributed-worker`` and
``--first-run-worker`` are child processes started by the script itself.

Ten shorter runs for measurements, none of which prints a result
line: ``python3 chip_smoke.py --kernels`` stops after phase 3, and
``python3 chip_smoke.py --repeats N default umi12 dense`` runs each named
input once and then N more times (sha256 checked every time) and prints
the seconds of every run with their median;
``python3 chip_smoke.py --phases`` builds the all-pairs kernel with its
phase timestamps compiled in and prints where a block spends a tile;
``python3 chip_smoke.py --rowwise-variants [SOURCE...]`` builds the
pair-list kernel from ``csrc/hamming.cu`` and from each named source
(another tree's ``hamming.cu``) and times them in turns on random and
bucket-ordered pair lists beside the empty kernel's floor; ``python3 chip_smoke.py --pair-list-batches
dense umi12`` runs each named input once and prints every launch of the
pair-list route (pairs, resident rows, lanes, distinct rows, bucket
size and count);
``python3 chip_smoke.py --edit-variants`` builds the edit kernel's
measurement variants (parts of it removed, the band scan in place of the
diagonals, other scan widths) and times them beside the library's build;
``python3 chip_smoke.py --first-run default umi12 edit`` runs each named
input once in a fresh process, with the prewarm thread of pass 1 and with
it stubbed out (with, without, without, with), and prints per process the
seconds of the interpreter and imports, of passes 1 to 3, of the library
load and each rate probe where the run reached them, of the thread's own
steps, and the launch counts; one more process times the parts of
bringing the card up one after the other with nothing else running;
``python3 chip_smoke.py --packed-keys N edit indel`` runs each named
Levenshtein input in N rounds of plain, packed, packed, plain key matrix
(``engine.PACK_KEY_MATRIX``) and prints the run, the packing, the
verification batches and the copy of each form;
``python3 chip_smoke.py --key-upload N edit indel`` runs each named
Levenshtein input in N rounds of the key matrix sent pinned (the form
the engine does not use, kept only in this measurement), from the
engine's thread, from the thread, pinned, and prints per run the host
seconds to the first verification batch;
``python3 chip_smoke.py --sync-counts umi12 dense`` counts the
synchronizing calls of one run of each named input, as the ``async``
phase does (copied over an older checkout's own script, it counts that
tree's).

The expected sha256 values were computed with the JAX package on the CPU
from byte-identical inputs: generate each input with
``generate_fastq`` below (same arguments; the mate and UMI files in the
same call as the default file), run
``fastqdedup_tpu.pipeline.deduplicate_cluster`` on it with the same
files, check slices, ``max_distance`` and dissection function (and
``use_edit_distance=True`` for the edit runs), and hash the gunzipped
outputs, concatenated in the order of the files.  The default input has
no indels, so its ``--edit`` output equals its Hamming output; the indel
input's does not.  The ``configs`` runs took 2 to 46 s each that way, so
none of them was cut below 1M reads.  ``default-10m`` and ``edit-10m``
are the same for 10M reads of the default profile (``generate_fastq(path,
10_000_000, 100, 12)``, seed 7), Hamming and ``use_edit_distance=True``:
11.8 s and 119.6 s that way on an 8-core CPU host; the two are equal,
as the profile has no indels.  No phase of the smoke runs
them: ``tools/hunt100m_torch.py`` and ``bench_torch.py`` at
``BENCH_READS=10000000`` check against them.
"""

import contextlib
import gzip
import hashlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# sha256 of the decompressed output of deduplicate_cluster (defaults, and
# Levenshtein for "edit" and "indel") per run; computed with the JAX
# package on the CPU (see module docstring).
EXPECTED_SHA256 = {
    "default":
        "42856e003e1d71bbd68164af0ac03390b57fea4349496557e5fb5bf51a6174fa",
    "dense":
        "0244e40af1f8594d01b6a67409eb439819cff2c1ee62186e82e1da548c5039cd",
    "umi12":
        "7eaa0bafe2c3a3948680b82cb98bc80f5e447a2bc4eb44abc75d15f001afca52",
    "small":
        "ae02e3b32737a9bffe37dd48c22227fe1e674b006841119235ee124bd0cb16b7",
    "edit":
        "42856e003e1d71bbd68164af0ac03390b57fea4349496557e5fb5bf51a6174fa",
    "indel":
        "12ffb9c23697060591d458f4545556240c7cfba3ea8e762cc6602e582d9cad22",
    # The configs phase; several outputs are hashed concatenated in order.
    "highest":
        "29508c18ddcc97dae7796b090e8094d8216bd9681a057003967a28584d2074d3",
    "lowq":
        "3cc7f0ad88e6cb252a5a30a0188270a8dc0d73a371fb8c87325f48859043a7d9",
    "paired":
        "01827f39c336cb48d28b357837403c065de124950aec3ef0b977bf4425e4cd04",
    "umi3":
        "8632b4dceeeec4f155df360650de44a222e333f9d974a03242b4e1712f4bcd0b",
    "umi12-d2":
        "914ae3f3e7e1293ee3ce4a5b67c8feb77b858885e79f78f253117eeda1000fff",
    "indel-d2":
        "5964556b0ddb5f122ca983f6e5da1c1bd5bae5c635d9ae35264a6408fdd976f5",
    # 10M reads of the default profile; no smoke phase runs these.
    "default-10m":
        "227a073bb572276eff16bd15feeec60ec0164d68db4e894b04cd190955d66a73",
    "edit-10m":
        "227a073bb572276eff16bd15feeec60ec0164d68db4e894b04cd190955d66a73",
}

# Generated files: the keyword arguments of ``generate_fastq`` beside the
# path, 100 bp reads and 12-base UMIs, seed 7.  "default" is the JAX
# package's benchmark input (bench.py), "dense" its deep-sequencing
# profile, "small" one length group small enough for the tile sweep,
# "indel" the default profile with one base deleted or inserted in 10% of
# reads (lengths 99-101), "lowq" the default profile with every quality
# of 5% of the reads in Q2-Q10.  "mate" (second reads) and "umi" (12-base
# UMIs) are written in the same pass as "default", record for record.
FILES = {
    "default": {"n_reads": 1_000_000},
    "dense": {"n_reads": 1_000_000, "dup_factor": 30, "error_rate": 0.005},
    "small": {"n_reads": 1_500},
    "indel": {"n_reads": 1_000_000, "indel_rate": 0.1},
    "lowq": {"n_reads": 1_000_000, "lowq_rate": 0.05},
}
COMPANIONS = {"mate": ("default", "mate_path"), "umi": ("default", "umi_path")}
# Runs: (files, check lengths, max distance, dissection method,
# Levenshtein).  "umi12" dedups the default file on its first 12 bases, as
# UMI-keyed runs do; "edit" is bench.py's --edit run of the default file.
INPUTS = {
    "default": (("default",), None, 1, "directional", False),
    "dense": (("dense",), None, 1, "directional", False),
    "umi12": (("default",), "12", 1, "directional", False),
    "small": (("small",), None, 1, "directional", False),
    "edit": (("default",), None, 1, "directional", True),
    "indel": (("indel",), None, 1, "directional", True),
}
# The ``configs`` phase: the documented configurations of the system
# (BASELINE.json, "configs") that the runs above do not cover, each at 1M
# records per file.  Configuration 5 (--edit, directional, d=1) is the
# "edit" and "indel" runs above.
CONFIGS = {
    # 1: single-end, Hamming d=1, highest_count.
    "highest": (("default",), None, 1, "highest_count", False),
    # 2: single-end, directional, d=1, a quality filter that drops reads.
    "lowq": (("lowq",), None, 1, "directional", False),
    # 3: paired R1 + R2 with --check-lengths 16,8, directional.
    "paired": (("default", "mate"), "16,8", 1, "directional", False),
    # 4: two read files and a UMI file, adjacency, d=2 (212-base keys).
    "umi3": (("default", "mate", "umi"), None, 2, "adjacency", False),
    # 4's distance and method on UMI-style 12-base keys: three 4-base
    # pigeonhole segments, so buckets of hundreds of keys.
    "umi12-d2": (("default",), "12", 2, "adjacency", False),
    # 5 at d=2: the Levenshtein path on the input with indels.
    "indel-d2": (("indel",), None, 2, "directional", True),
}
INPUTS.update(CONFIGS)

# Kernel: (source, the TPU kernel it replaces).
KERNELS = {
    "bucket_within_packed": ("fastqdedup_tpu_torch/csrc/hamming.cu",
                             "fastqdedup_tpu/ops/pallas_hamming.py:335"),
    "within_tile_packed": ("fastqdedup_tpu_torch/csrc/hamming.cu",
                           "fastqdedup_tpu/ops/pallas_hamming.py:135"),
    "rowwise_within_packed": ("fastqdedup_tpu_torch/csrc/hamming.cu",
                              "fastqdedup_tpu/ops/pallas_hamming.py:434"),
    "banded_within_edit_distance": (
        "fastqdedup_tpu_torch/csrc/edit.cu",
        "fastqdedup_tpu/ops/pallas_edit.py:106"),
    "deflate_members": (
        "fastqdedup_tpu_torch/csrc/deflate.cu",
        "none: the JAX package deflates on the host "
        "(fastqdedup_tpu/io/bgzf.py)"),
    **{name: ("fastqdedup_tpu_torch/csrc/edit_candidates.cu",
              "none: the JAX package joins the edit windows on the host "
              "(fastqdedup_tpu/ops/bucket.py)")
       for name in ("edit_window_hash", "edit_join_count",
                    "edit_join_write")},
}
# Paths whose runs must launch each kernel: every path writes .gz on
# the card (the distributed path in its sharded-input job).
KERNEL_PATHS = {"banded_within_edit_distance": ("edit",),
                "deflate_members": ("hamming", "edit", "configs",
                                    "distributed"),
                "edit_window_hash": ("edit", "distributed"),
                "edit_join_count": ("edit", "distributed"),
                "edit_join_write": ("edit", "distributed")}


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates, full
# 700 W power limit): device-memory bytes/s and operations/s by type.
# The int32 rate is not on the data sheet: half of the SM's 128 fp32
# lanes issue integer instructions, and the sheet's 67 TFLOP/s of fp32
# counts two operations per lane and clock.
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {"int8": 1979e12, "int32": 67e12 / 4}
NO_LIBRARY = "none: no single PyTorch call computes this function"


def pairs_within_cost(batch: int, n: int, m: int, l_pad: int, length: int,
                      alphabet_pad: int, same_rows: bool) -> dict:
    """Bytes and operations of the all-pairs kernel: every input row and
    every packed output byte once (a bucket's rows are both operands and
    count once); one int8 multiply-add per pair, real position and
    alphabet symbol, as the one-hot product counts them."""
    rows = n if same_rows else n + m
    return {"bytes": batch * (rows * l_pad + n * m // 8),
            "ops": 2 * batch * n * m * length * alphabet_pad,
            "ops_type": "int8"}


def distinct_rows(gi: torch.Tensor, gj: torch.Tensor) -> int:
    """How many rows of a resident matrix the index pairs ``gi``, ``gj``
    read: each of them is an input the indexed entry must read once."""
    return int(torch.unique(torch.cat([gi, gj])).numel())


def rowwise_cost(p: int, lanes: int, rows: "int | None" = None) -> dict:
    """Bytes and operations of the rowwise kernel: two rows of 32-bit
    lanes read per pair and one byte written per pair; through the
    indexed entry (``rows``: the distinct rows its index pairs read,
    :func:`distinct_rows`) each of those rows once and two int32 indices
    per pair; six integer instructions per lane (xor, two shift-ors,
    mask, popcount, add)."""
    read = 2 * p * lanes * 4 if rows is None else rows * lanes * 4 + 8 * p
    return {"bytes": read + p, "ops": 6 * p * lanes, "ops_type": "int32"}


def onehot_product(a: torch.Tensor, b: torch.Tensor, alphabet_pad: int,
                   int8: bool) -> tuple:
    """The library call that stands beside the all-pairs kernel: the JAX
    package's non-Pallas formulation (``fastqdedup_tpu/ops/bucket.py:
    131-150``), one product of one-hot operands, on one-hots built here
    beforehand.  ``a``, ``b``: uint8 [K, N, Lp] and [K, M, Lp] on the
    card (one tensor for buckets).  Returns (the call, what it is):
    ``torch.bmm`` in fp16 of [K, N, Lp*A] one-hots, or for one tile
    (K = 1) ``torch._int_mm`` in int8.  It computes the match counts
    only: the threshold and the bit-pack are left out."""
    symbols = torch.arange(alphabet_pad, device=a.device, dtype=torch.int16)

    def hot(rows, dtype):
        oh = rows.to(torch.int16).unsqueeze(-1) == symbols
        return oh.reshape(rows.shape[0], rows.shape[1], -1).to(
            dtype).contiguous()

    what = "(match counts only: no threshold, no bit-pack)"
    if int8:
        ha = hot(a, torch.int8)[0]
        hb = ha if b is a else hot(b, torch.int8)[0]
        return (lambda: torch._int_mm(ha, hb.t()),
                f"torch._int_mm int8 {list(ha.shape)} x "
                f"{list(hb.shape)}^T {what}")
    ha = hot(a, torch.float16)
    hb = ha if b is a else hot(b, torch.float16)
    return (lambda: torch.bmm(ha, hb.transpose(1, 2)),
            f"torch.bmm fp16 {list(ha.shape)} x {list(hb.shape)}^T {what}")


def banded_cost(len_a: np.ndarray, len_b: np.ndarray, d: int, l_pad: int,
                rows: "int | None" = None) -> dict:
    """Bytes and operations of the banded edit kernel on these lengths:
    both rows, both lengths and one output byte per pair; through the
    indexed entry (``rows``: the distinct keys its index pairs read,
    :func:`distinct_rows`) each of those keys and its length once and two
    int32 indices per pair; four integer operations (compare, two minima,
    add) per cell of the band, 2d + 1 cells per row of a, for the pairs
    whose lengths differ by at most d (the others stop at once)."""
    p = len(len_a)
    runs = np.abs(len_a.astype(np.int64) - len_b) <= d
    cells = int(len_a[runs].astype(np.int64).sum()) * (2 * d + 1)
    read = p * (2 * l_pad + 8) if rows is None \
        else rows * (l_pad + 4) + 8 * p
    return {"bytes": read + p, "ops": 4 * cells, "ops_type": "int32"}


def kernel_bound(cost: dict) -> dict:
    """The least time the card could take for ``cost``: the larger of its
    bytes over the memory rate and its operations over their peak."""
    by_bytes = cost["bytes"] / H100_BYTES_PER_S * 1e3
    by_ops = cost["ops"] / H100_OPS_PER_S[cost["ops_type"]] * 1e3
    return {"bytes": cost["bytes"], "ops": cost["ops"],
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> list:
    """Each card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()


def run_device_or_exit(script: str) -> torch.device:
    """The device a measurement script runs on: the card, or the CPU
    device where ``FASTQDEDUP_TORCH_DEVICE=cpu`` asks for it (the tests
    do).  Without a card, and not asked for the CPU, it exits 2: no
    measurement falls back to the CPU."""
    want = torch.device(os.environ.get("FASTQDEDUP_TORCH_DEVICE", "cuda"))
    if want.type == "cuda" and not torch.cuda.is_available():
        print(f"{script}: torch.cuda.is_available() is False; it measures "
              f"an NVIDIA GPU (FASTQDEDUP_TORCH_DEVICE=cpu runs it on the "
              f"CPU device)", file=sys.stderr)
        sys.exit(2)
    from fastqdedup_tpu_torch.runtime import device

    return device()


def describe_device(dev: torch.device) -> dict:
    """What a result line says of the device it was measured on."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "name_power_limit": nvidia_smi()}


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def apply_indels(rng, seqs: np.ndarray, rate: float, bases: np.ndarray):
    """uint8 [n, L+1] rows and int64 lengths: ``rate`` of the rows of
    ``seqs`` [n, L] lose one base or gain one random base at a random
    position (half each); the others keep length L."""
    n, length = seqs.shape
    hit = np.flatnonzero(rng.random(n) < rate)
    insert = rng.random(len(hit)) < 0.5
    pos = rng.integers(0, length, len(hit))
    new_base = bases[rng.integers(0, 4, len(hit))]
    out = np.zeros((n, length + 1), dtype=np.uint8)
    out[:, :length] = seqs
    lengths = np.full(n, length, dtype=np.int64)
    cols = np.arange(length + 1)
    # Deletion: column c takes c + 1 from pos on.  Insertion: c - 1 past
    # pos, the new base at pos.
    src = np.where(cols[None, :] < pos[:, None], cols[None, :],
                   np.where(insert[:, None], cols[None, :] - 1,
                            cols[None, :] + 1))
    src = src.clip(0, length - 1)
    moved = np.take_along_axis(seqs[hit], src, axis=1)
    moved[insert, pos[insert]] = new_base[insert]
    out[hit] = moved
    lengths[hit] = np.where(insert, length + 1, length - 1)
    return out, lengths


def fastq_block(start: int, seqs: np.ndarray, quals: np.ndarray,
                digits: int = 9) -> bytes:
    """FASTQ bytes of fixed-width records ``@read<id>``, ids from
    ``start``: one uint8 matrix filled by column slices."""
    count, read_len = seqs.shape
    head_len = 5 + digits + 1               # "@read" + id + "\n"
    block = np.empty((count, head_len + read_len + 3 + read_len + 1),
                     dtype=np.uint8)
    block[:, 0:5] = np.frombuffer(b"@read", dtype=np.uint8)
    ids = np.arange(start, start + count, dtype=np.int64)
    for d in range(digits):
        block[:, 5 + d] = 48 + (ids // 10 ** (digits - 1 - d)) % 10
    block[:, head_len - 1] = 10
    block[:, head_len:head_len + read_len] = seqs
    block[:, head_len + read_len:head_len + read_len + 3] = \
        np.frombuffer(b"\n+\n", dtype=np.uint8)
    qstart = head_len + read_len + 3
    block[:, qstart:qstart + read_len] = quals
    block[:, -1] = 10
    return block.tobytes()


def generate_fastq(path: str, n_reads: int, read_len: int, umi_len: int,
                   seed: int = 7, dup_factor: int = 5,
                   error_rate: "float | None" = None,
                   indel_rate: float = 0.0, lowq_rate: float = 0.0,
                   mate_path: "str | None" = None,
                   umi_path: "str | None" = None) -> None:
    """Copy of the JAX package's ``bench.generate_fastq``: a synthetic
    duplicate-heavy FASTQ written as BGZF through the port's writer.
    With the options below at their defaults the bytes are
    ``bench.generate_fastq``'s.

    ``indel_rate`` > 0 adds one deletion or insertion to that share of
    the reads after the substitutions (``apply_indels``).  ``lowq_rate``
    > 0 redraws every quality of that share of the reads in Q2-Q10, so
    that the quality filter drops them.  ``mate_path`` and ``umi_path``
    name two more files written in the same pass, record for record
    under the same names: the second read of each molecule (``read_len``
    bases, 15% of reads with one substitution) and the molecule's UMI
    (``umi_len`` bases, 5% with one substitution).  They draw from a
    generator of their own (``seed + 1``), so the file at ``path`` keeps
    its bytes."""
    from fastqdedup_tpu_torch.io.bgzf import BgzfWriter

    rng = np.random.default_rng(seed)
    n_molecules = max(n_reads // dup_factor, 1)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    molecules = bases[rng.integers(0, 4, size=(n_molecules, read_len),
                                   dtype=np.uint8)]
    digits = 9
    extra = []      # (writer, molecule pool, share with one substitution)
    if mate_path or umi_path:
        rng2 = np.random.default_rng(seed + 1)
        for extra_path, width, share in ((mate_path, read_len, 0.15),
                                         (umi_path, umi_len, 0.05)):
            pool = bases[rng2.integers(0, 4, size=(n_molecules, width),
                                       dtype=np.uint8)]
            if extra_path:
                extra.append((BgzfWriter(extra_path, compresslevel=1), pool,
                              share))
    with contextlib.ExitStack() as stack:
        f = stack.enter_context(BgzfWriter(path, compresslevel=1))
        for writer, _, _ in extra:
            stack.enter_context(writer)
        step = 250_000
        for start in range(0, n_reads, step):
            stop = min(start + step, n_reads)
            count = stop - start
            picks = rng.integers(0, n_molecules, size=count)
            seqs = molecules[picks]
            if error_rate is None:
                # Default profile: ~15% of reads get one substitution.
                errored = np.flatnonzero(rng.random(count) < 0.15)
                pos = rng.integers(0, read_len, size=len(errored))
                seqs[errored, pos] = bases[
                    rng.integers(0, 4, size=len(errored))]
            else:
                # Per-base substitution model (deep-sequencing profiles).
                err = rng.random(size=seqs.shape) < error_rate
                seqs = np.where(
                    err, bases[rng.integers(0, 4, size=seqs.shape,
                                            dtype=np.uint8)], seqs)
            for writer, pool, share in extra:
                other = pool[picks]
                errored = np.flatnonzero(rng2.random(count) < share)
                pos = rng2.integers(0, other.shape[1], size=len(errored))
                other[errored, pos] = bases[
                    rng2.integers(0, 4, size=len(errored))]
                writer.write(fastq_block(start, other, (33 + rng2.integers(
                    30, 41, size=other.shape, dtype=np.int8)).astype(
                        np.uint8), digits))
            if indel_rate:
                f.write(indel_block(rng, seqs, start, indel_rate, bases,
                                    digits))
                continue
            quals = (33 + rng.integers(
                30, 41, size=(count, read_len),
                dtype=np.int8)).astype(np.uint8)
            if lowq_rate:
                low = np.flatnonzero(rng.random(count) < lowq_rate)
                quals[low] = (33 + rng.integers(
                    2, 11, size=(len(low), read_len),
                    dtype=np.int8)).astype(np.uint8)
            f.write(fastq_block(start, seqs, quals, digits))


def indel_block(rng, seqs: np.ndarray, start: int, rate: float,
                bases: np.ndarray, digits: int) -> bytes:
    """FASTQ bytes of ``seqs`` after ``apply_indels``: records of
    variable length, laid out in one [n, widest] array and flattened
    through a mask of the bytes each record really has."""
    count, read_len = seqs.shape
    seqs, lengths = apply_indels(rng, seqs, rate, bases)
    width = read_len + 1
    quals = (33 + rng.integers(30, 41, size=(count, width),
                               dtype=np.int8)).astype(np.uint8)
    head_len = 5 + digits + 1
    q0 = head_len + width + 3
    full = np.empty((count, q0 + width + 1), dtype=np.uint8)
    full[:, 0:5] = np.frombuffer(b"@read", dtype=np.uint8)
    ids = np.arange(start, start + count, dtype=np.int64)
    for d in range(digits):
        full[:, 5 + d] = 48 + (ids // 10 ** (digits - 1 - d)) % 10
    full[:, head_len - 1] = 10
    full[:, head_len:head_len + width] = seqs
    full[:, head_len + width:q0] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    full[:, q0:q0 + width] = quals
    full[:, -1] = 10
    keep = np.ones(full.shape, dtype=bool)
    short = np.arange(width)[None, :] >= lengths[:, None]
    keep[:, head_len:head_len + width] = ~short
    keep[:, q0:q0 + width] = ~short
    return full[keep].tobytes()


def decompressed_sha256(*paths: str) -> str:
    """sha256 of the decompressed files, concatenated in order."""
    digest = hashlib.sha256()
    for path in paths:
        with gzip.open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 22), b""):
                digest.update(block)
    return digest.hexdigest()


def generate_files(workdir: str, names) -> dict:
    """Generate the named ``FILES`` (and companions) into ``workdir``;
    returns name -> path.  A companion comes from its main file's pass."""
    paths = {name: os.path.join(workdir, f"{name}.fastq.gz")
             for name in names}
    mains = dict.fromkeys(
        COMPANIONS[name][0] if name in COMPANIONS else name
        for name in names)
    for main in mains:
        paths.setdefault(main, os.path.join(workdir, f"{main}.fastq.gz"))
        extra = {arg: paths[name] for name, (owner, arg)
                 in COMPANIONS.items() if owner == main and name in names}
        generate_fastq(paths[main], read_len=100, umi_len=12, seed=7,
                       **FILES[main], **extra)
    return paths


def files_of(names) -> list:
    """Every file the named runs read, each once."""
    return list(dict.fromkeys(f for name in names for f in INPUTS[name][0]))


# --------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions


def event_ms(fn, reps: int = 7) -> list:
    """CUDA-event times of ``reps`` runs of ``fn``, after two warm-up
    runs.  The time runs from one event to the next on the stream, so it
    includes whatever the host spends between them before the device has
    work: right for a plain version of milliseconds, too long for a
    kernel of microseconds."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int = 7) -> float:
    """Median of ``event_ms``."""
    return statistics.median(event_ms(fn, reps))


def graph_ms(fn, inner: int = 20, reps: int = 7) -> list:
    """Times of one call of ``fn`` on the device alone: ``inner`` calls
    captured in a CUDA graph, the graph replayed ``reps`` times between
    events.  The launches follow each other with no host in between, and
    the inputs stay in the L2 cache from one to the next."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return times


def timed_in_turns(kernel_fn, plain_fn) -> dict:
    """Kernel, plain, plain, kernel on one card in one call; medians over
    both turns."""
    k1, p1 = graph_ms(kernel_fn), event_ms(plain_fn, 5)
    p2, k2 = event_ms(plain_fn, 5), graph_ms(kernel_fn)
    return {"ms": statistics.median(k1 + k2),
            "ms_one_launch": cuda_ms(kernel_fn),
            "plain_ms": statistics.median(p1 + p2),
            "timing": "ms: CUDA-graph replays of 20 launches, L2-warm; "
                      "ms_one_launch and plain_ms: one call between two "
                      "events, L2-warm"}


def bit_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference of any output bit (0 when equal)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"shape/dtype {tuple(got.shape)}/{got.dtype} vs "
             f"{tuple(want.shape)}/{want.dtype}")
    if got.dtype == torch.bool:
        return float((got != want).any())
    return float(torch.bitwise_xor(got, want).any())


def bucket_batch(rng, k: int, s: int, length: int, l_pad: int,
                 alphabet: int = 5, empty_every: int = 0):
    """[K, S, Lp] buckets as the pipeline builds them: near-duplicates of
    one row per bucket (0-2 substitutions, symbols below ``alphabet``), a
    random number of 0xFF pad rows, 0xFF past the real width; every
    ``empty_every``-th bucket is pad rows only."""
    rows = np.repeat(rng.integers(0, alphabet, (k, 1, length),
                                  dtype=np.uint8), s, axis=1)
    kk, ss = np.indices((k, s))
    for _ in range(2):
        sel = rng.random((k, s)) < 0.5
        pos = rng.integers(0, length, (k, s))
        rows[kk[sel], ss[sel], pos[sel]] = rng.integers(
            0, alphabet, int(sel.sum()), dtype=np.uint8)
    batch = np.full((k, s, l_pad), 0xFF, dtype=np.uint8)
    batch[:, :, :length] = rows
    fill = rng.integers(2, s + 1, k)
    if empty_every:
        fill[::empty_every] = 0
    batch[np.arange(s)[None, :] >= fill[:, None]] = 0xFF
    return torch.from_numpy(batch)


def tile_pair(rng, n: int, length: int, pad_rows: int, m: int = 0,
              alphabet: int = 5):
    """Rows a [N, L] and b [M, L] (M = N by default): b's rows are rows of
    a with one symbol redrawn, and the last ``pad_rows`` of both are
    0xFF."""
    m = m or n
    a = rng.integers(0, alphabet, (n, length), dtype=np.uint8)
    b = a[rng.integers(0, n, m)].copy()
    pos = rng.integers(0, length, m)
    b[np.arange(m), pos] = rng.integers(0, alphabet, m, dtype=np.uint8)
    if pad_rows:
        a[-pad_rows:] = 0xFF
        b[-pad_rows:] = 0xFF
    return torch.from_numpy(a), torch.from_numpy(b)


def rowwise_pair(rng, p: int, lanes: int):
    a = rng.integers(0, 1 << 32, (p, lanes), dtype=np.uint64).astype(
        np.uint32)
    b = a.copy()
    for _ in range(3):
        rows = np.flatnonzero(rng.random(p) < 0.4)
        lane = rng.integers(0, lanes, len(rows))
        shift = 4 * rng.integers(0, 8, len(rows))
        flip = rng.integers(1, 16, len(rows)).astype(np.uint64) << \
            shift.astype(np.uint64)
        b[rows, lane] ^= flip.astype(np.uint32)
    return (torch.from_numpy(a.view(np.int32)),
            torch.from_numpy(b.view(np.int32)))


def rowwise_indexed_batch(rng, p: int, n: int, lanes: int):
    """One batch of the pair-list route: an int32 [n, lanes] packed
    matrix whose rows 2k and 2k + 1 differ in 0-3 nibbles, and ``p``
    int32 index pairs, most of them such neighbours, a quarter random,
    some repeated.  The last lane holds pad nibbles (0xF) past 8 * lanes
    - 3 symbols."""
    rows = rng.integers(0, 1 << 32, (n, lanes), dtype=np.uint64).astype(
        np.uint32)
    rows[:, -1] |= np.uint32(0xFFF00000)
    rows[1::2] = rows[0:n - n % 2:2]
    odd = np.arange(1, n, 2)
    for _ in range(3):
        hit = odd[rng.random(len(odd)) < 0.4]
        shift = 4 * rng.integers(0, 5, len(hit)).astype(np.uint64)
        flip = rng.integers(1, 16, len(hit)).astype(np.uint64) << shift
        rows[hit, rng.integers(0, lanes, len(hit))] ^= flip.astype(np.uint32)
    gi = 2 * rng.integers(0, n // 2 or 1, p)
    gj = np.minimum(gi + 1, n - 1)
    far = rng.random(p) < 0.25
    gj[far] = rng.integers(0, n, int(far.sum()))
    return (torch.from_numpy(rows.view(np.int32)),
            torch.from_numpy(gi.astype(np.int32)),
            torch.from_numpy(gj.astype(np.int32)))


def bucket_members(rng, n: int, size: int, buckets: int) -> np.ndarray:
    """int64 [buckets, size]: member lists of ``buckets`` buckets of
    ``size`` keys, distinct rows of a matrix of ``n`` drawn at random."""
    return rng.choice(n, size * buckets, replace=False).reshape(buckets,
                                                                size)


def rowwise_bucket_batch(rng, n: int, lanes: int, size: int, buckets: int):
    """One batch of the pair-list route as it reaches the card: an int32
    [n, lanes] nibble-packed matrix of keys of ``8 * lanes - 4`` symbols
    (0-3; the last 4 nibbles pad, 0xF) and, as int32 index pairs, every
    triu pair of each bucket's member list, one bucket after the next,
    in ``ops.bucket._small_bucket_candidates``' order.  The members
    (``bucket_members``, drawn first) of a bucket are near-duplicates:
    one key with 0-2 symbols redrawn each, so answers at d = 1 are
    mixed."""
    from fastqdedup_tpu_torch.ops.encode import pack_nibbles

    members = bucket_members(rng, n, size, buckets)
    length = max(8 * lanes - 4, 1)
    symbols = rng.integers(0, 4, (n, length), dtype=np.uint8)
    symbols[members] = symbols[members[:, :1]]
    for _ in range(2):
        sel = rng.random((buckets, size)) < 0.5
        symbols[members[sel], rng.integers(0, length, int(sel.sum()))] = \
            rng.integers(0, 4, int(sel.sum()), dtype=np.uint8)
    ii, jj = np.triu_indices(size, k=1)
    return (torch.from_numpy(pack_nibbles(symbols, lanes).view(np.int32)),
            torch.from_numpy(members[:, ii].ravel().astype(np.int32)),
            torch.from_numpy(members[:, jj].ravel().astype(np.int32)))


# The pair-list route's largest batches at 1M reads (label, n, lanes,
# bucket size, buckets): dense's (100 bp keys, 342,900 resident, buckets
# of 6) and umi12's (12-base keys, 210,438 resident, buckets of 52).
ROUTE_BATCHES = (("D: dense's largest batch", 342_900, 13, 6, 5_581),
                 ("U: umi12's largest batch", 210_438, 2, 52, 260))


def empty_ms() -> float:
    """Median ``graph_ms`` of an empty kernel of one block of 128 threads:
    the fixed cost of one launch node, the floor under the shortest
    kernels' times."""
    from fastqdedup_tpu_torch.ops import kernel_lib

    lib = kernel_lib.library()

    def launch():
        status = lib.fqd_empty(1, 128,
                               torch.cuda.current_stream().cuda_stream)
        if status != 0:
            fail(f"empty kernel launch returned CUDA error {status}")

    return statistics.median(graph_ms(launch))


def edit_pairs(rng, p: int, d: int, l_pad: int = 112, gap=None):
    """uint8 [P, Lp] read pairs as edit verification meets them: 100 bp
    reads of lengths 99/100/101, partners with substitutions and a share
    shifted by one base (an indel), length gaps up to ``gap`` (d + 2 by
    default), empty strings, and arbitrary bytes past every length."""
    gap = d + 2 if gap is None else gap
    a = rng.integers(0, 256, (p, l_pad), dtype=np.uint8)
    b = rng.integers(0, 256, (p, l_pad), dtype=np.uint8)
    a[:, :101] = rng.integers(0, 5, (p, 101), dtype=np.uint8)
    b[:, :101] = a[:, :101]
    shift = rng.random(p) < 0.3
    b[shift, 1:101] = a[shift, :100]
    for _ in range(d + 1):
        sel = np.flatnonzero(rng.random(p) < 0.4)
        b[sel, rng.integers(0, 101, len(sel))] = rng.integers(
            0, 5, len(sel), dtype=np.uint8)
    la = rng.integers(99, 102, p).astype(np.int32)
    lb = (la + rng.integers(-gap, gap + 1, p)).clip(0, l_pad).astype(
        np.int32)
    la[::97] = 0
    lb[::89] = 0
    return (torch.from_numpy(a), torch.from_numpy(la), torch.from_numpy(b),
            torch.from_numpy(lb))


def edit_edge_pairs(rng, d: int, l_pad: int = 112):
    """Pairs at the edges of the words a match scan reads: la in 7-9,
    15-17, 63-65, 111 and 112, lb within d of it, and per length pair
    equal strings, the only difference in the last symbol, the only
    difference in the bytes past the lengths, and one base deleted near
    the start."""
    rows = []
    for la in (7, 8, 9, 15, 16, 17, 63, 64, 65, 111, 112):
        for lb in range(max(la - d, 1), min(la + d, l_pad) + 1):
            for case in range(4):
                x = rng.integers(0, 4, l_pad, dtype=np.uint8)
                y = x.copy()
                if case == 1:
                    y[min(la, lb) - 1] ^= 1
                elif case == 2:
                    x[la:] = 0xFF
                    y[lb:] = 0xEE
                elif case == 3:
                    y[2:-1] = x[3:]
                rows.append((x, la, y, lb))
    return (torch.from_numpy(np.stack([r[0] for r in rows])),
            torch.tensor([r[1] for r in rows], dtype=torch.int32),
            torch.from_numpy(np.stack([r[2] for r in rows])),
            torch.tensor([r[3] for r in rows], dtype=torch.int32))


def edit_pairs_of_width(rng, p: int, width: int, d: int):
    """uint8 [P, width] pairs of any width: b is a with substitutions,
    half of them also shifted by one base, a quarter unrelated; lengths
    anywhere in [0, width] with gaps around d, a third at the full
    width."""
    a = rng.integers(0, 3, (p, width), dtype=np.uint8)
    b = a.copy()
    shift = rng.random(p) < 0.5
    b[shift, 1:] = a[shift, :-1]
    for _ in range(d + 1):
        sel = np.flatnonzero(rng.random(p) < 0.4)
        b[sel, rng.integers(0, width, len(sel))] = rng.integers(
            0, 3, len(sel), dtype=np.uint8)
    far = rng.random(p) < 0.25
    b[far] = rng.integers(0, 3, (int(far.sum()), width), dtype=np.uint8)
    la = rng.integers(0, width + 1, p)
    la[rng.random(p) < 0.33] = width
    lb = (la + rng.integers(-d - 1, d + 2, p)).clip(0, width)
    return (torch.from_numpy(a), torch.from_numpy(la.astype(np.int32)),
            torch.from_numpy(b), torch.from_numpy(lb.astype(np.int32)))


def indexed_edit_batch(rng, p: int, dev):
    """One verification batch of the edit path: ``p`` index pairs into a
    resident key matrix of 400k keys (about the indel input's unique
    keys).  Keys 2k and 2k + 1 are a near-duplicate pair, lengths at most
    one apart, so nearly every pair runs the whole DP; a quarter of the
    candidates pair random keys."""
    a, la, b, lb = edit_pairs(rng, 200_000, 1, gap=1)
    keys = torch.stack([a, b], dim=1).reshape(400_000, 112).to(dev)
    lens = torch.stack([la, lb], dim=1).reshape(400_000).to(dev)
    ci = 2 * rng.integers(0, 200_000, p)
    cj = ci + 1
    far = rng.random(p) < 0.25
    cj[far] = rng.integers(0, 400_000, int(far.sum()))
    ci = torch.from_numpy(ci.astype(np.int32)).to(dev)
    cj = torch.from_numpy(cj.astype(np.int32)).to(dev)
    return keys, lens, ci, cj


def check_kernels(dev) -> dict:
    """Every kernel on the card against its plain version; returns, per
    kernel, the main shape's times and the largest error seen."""
    from fastqdedup_tpu_torch.ops import edit_kernels as ek
    from fastqdedup_tpu_torch.ops import hamming_kernels as hk

    rng = np.random.default_rng(2024)
    summary = {}

    def record(name, case, got, want, kernel_fn, plain_fn, main,
               timed=None, cost=None, extra=None, library=None):
        err = bit_err(got.cpu(), want.cpu())
        ones = int(want.to(torch.uint8).cpu().numpy().view(np.uint8)
                   .astype(np.uint64).sum()) if want.dtype == torch.bool \
            else int(np.unpackbits(want.cpu().numpy()).sum())
        line = {"phase": "kernel", "name": name, "case": case,
                "max_abs_err": err, "true_outputs": ones}
        if main if timed is None else timed:
            line.update(timed_in_turns(kernel_fn, plain_fn))
            line.update(kernel_bound(cost))
            line["share_of_bound"] = line["bound_ms"] / line["ms"]
            line["library_ms"] = None
            line["library"] = NO_LIBRARY
            if library is not None:
                library_fn, line["library"] = library()
                line["library_ms"] = statistics.median(graph_ms(library_fn))
                line["library_timing"] = "CUDA-graph replays of 20 calls, " \
                    "L2-warm, as ms"
            if extra is not None:
                line.update(extra(line))
        emit(line)
        if err != 0.0:
            fail(f"{name} {case}: kernel disagrees with its plain version")
        if line.get("share_of_bound", 0.0) > 1.05:
            fail(f"{name} {case}: {line['ms']} ms is under the card's "
                 f"bound of {line['bound_ms']} ms")
        entry = summary.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main:
            entry.update({k: v for k, v in line.items() if k not in (
                "phase", "name", "max_abs_err", "true_outputs")})

    # Kernel 1: buckets.  Main path: d=1 on the 50-symbol segment
    # complement of 100 bp keys (Lp 64), the three size classes at their
    # batch sizes, all timed.  Then the edges of both routes (tensor cores
    # up to alphabet_pad 8, SIMT above): widths that fill neither a
    # 16-symbol group nor a word, length <= d, Lp 16 and above 256, wider
    # alphabets, buckets of pad rows only, K = 1 and odd K, d = 0 to 2.
    # (S, K, length, d, alphabet, Lp or 0 for the callers' padding, timed)
    for s, k, length, d, alphabet, l_pad, timed in (
            (128, 2048, 50, 1, 5, 0, True),
            (512, 256, 50, 1, 5, 0, True),
            (2048, 16, 50, 1, 5, 0, True),
            (128, 256, 50, 0, 5, 0, False),
            (128, 256, 50, 2, 5, 0, False),
            (128, 67, 37, 1, 5, 0, False),
            (128, 16, 2, 2, 5, 0, False),
            (128, 3, 100, 1, 5, 0, False),
            (128, 1, 16, 0, 5, 16, False),
            (128, 5, 37, 2, 5, 256, False),
            (256, 3, 300, 1, 5, 0, False),
            (128, 33, 50, 1, 8, 0, False),
            (512, 3, 37, 2, 8, 0, False),
            (128, 33, 50, 1, 12, 0, False),
            (256, 5, 37, 0, 24, 0, False),
            (128, 3, 300, 2, 24, 0, False),
            (128, 4, 2, 2, 24, 0, False)):
        padded, a_pad = hk._pad_dims(length, alphabet)
        l_pad = l_pad or padded
        batch = bucket_batch(rng, k, s, length, l_pad, alphabet,
                             empty_every=0 if timed else 3).to(dev)
        got = hk.bucket_within_packed(batch, length, d, a_pad)
        torch.cuda.synchronize()
        want = hk.pairs_within_plain(batch, batch, length, d, a_pad)
        record("bucket_within_packed",
               f"S={s} K={k} L={length} Lp={l_pad} d={d} Ap={a_pad}", got,
               want, lambda: hk.bucket_within_packed(batch, length, d, a_pad),
               lambda: hk.pairs_within_plain(batch, batch, length, d,
                                             a_pad),
               (s, k) == (128, 2048), timed,
               pairs_within_cost(k, s, s, l_pad, length, a_pad, True),
               library=lambda: onehot_product(batch, batch, a_pad, False))
        del batch, got, want

    # Kernel 2: the 2048 x 2048 tile sweep at 100 bp keys; then N != M,
    # pad rows, both routes and long rows.
    # (N, M, length, d, pad rows, alphabet, main)
    for n, m, length, d, pad, alphabet, main in (
            (2048, 2048, 100, 1, 0, 5, True),
            (2048, 2048, 100, 0, 300, 5, False),
            (256, 256, 37, 2, 40, 5, False),
            (128, 384, 37, 2, 5, 5, False),
            (2048, 128, 100, 1, 0, 8, False),
            (128, 128, 16, 0, 0, 5, False),
            (128, 256, 300, 2, 3, 5, False),
            (256, 128, 50, 1, 7, 24, False),
            (384, 128, 2, 2, 9, 12, False)):
        a, b = tile_pair(rng, n, length, pad, m, alphabet)
        a, b = a.to(dev), b.to(dev)
        got = hk.within_tile_packed(a, b, alphabet, d)
        torch.cuda.synchronize()
        l_pad, a_pad = hk._pad_dims(length, alphabet)
        pa = torch.nn.functional.pad(a, (0, l_pad - length), value=0xFF)
        pb = torch.nn.functional.pad(b, (0, l_pad - length), value=0xFF)
        want = hk.pairs_within_plain(pa[None], pb[None], length, d,
                                     a_pad)[0]
        # Timed on rows already padded to Lp: the wrapper's two padding
        # calls are torch kernels of their own (ms_wrapper has them).
        record("within_tile_packed",
               f"N={n} M={m} L={length} d={d} pad_rows={pad} Ap={a_pad}",
               got, want,
               lambda: hk._pairs_within_launch(
                   "within_tile_packed", pa[None], pb[None], length, d,
                   a_pad),
               lambda: hk.pairs_within_plain(pa[None], pb[None], length,
                                             d, a_pad), main,
               cost=pairs_within_cost(1, n, m, l_pad, length, a_pad, False),
               extra=lambda line: {"ms_wrapper": statistics.median(graph_ms(
                   lambda: hk.within_tile_packed(a, b, alphabet, d)))},
               library=lambda: onehot_product(pa[None], pb[None], a_pad,
                                              True))

    # Kernel 3: pair lists at the verifier's batch (2^21 pairs of 13
    # lanes: 100 bp keys, 8 symbols per lane), paired rows; then the
    # indexed entry the pair-list route launches, at the same batch into
    # a resident matrix of 400k keys (about the dense input's unique
    # keys; main), and at pair counts off the block of 256 with 5, 13,
    # 19 and 27 lanes.
    name = "rowwise_within_packed"
    for p, lanes, d, timed in ((1 << 21, 13, 1, True),
                               (1 << 16, 13, 0, False),
                               (1 << 16, 7, 2, False)):
        a, b = rowwise_pair(rng, p, lanes)
        a, b = a.to(dev), b.to(dev)
        got = hk.rowwise_within_packed(a, b, d)
        torch.cuda.synchronize()
        want = hk.rowwise_within_plain(a, b, d)
        record(name, f"P={p} lanes={lanes} d={d}", got, want,
               lambda: hk.rowwise_within_packed(a, b, d),
               lambda: hk.rowwise_within_plain(a, b, d), False, timed,
               cost=rowwise_cost(p, lanes))
    for p, n, lanes, d, main in ((1 << 21, 400_000, 13, 1, True),
                                 (1 << 16 | 77, 400_000, 13, 2, False),
                                 (1, 50, 5, 1, False),
                                 (1000, 3000, 5, 0, False),
                                 (4099, 3000, 19, 2, False),
                                 (70_001, 90_000, 27, 1, False),
                                 (257, 600, 27, 3, False)):
        packed, gi, gj = rowwise_indexed_batch(rng, p, n, lanes)
        packed, gi, gj = packed.to(dev), gi.to(dev), gj.to(dev)
        got = hk.rowwise_within_packed_indexed(packed, gi, gj, d)
        torch.cuda.synchronize()

        def gathered_plain():
            return hk.rowwise_within_plain(packed.index_select(0, gi),
                                           packed.index_select(0, gj), d)

        record(name, f"indexed: P={p} into n={n} rows lanes={lanes} d={d}",
               got, gathered_plain(),
               lambda: hk.rowwise_within_packed_indexed(packed, gi, gj, d),
               gathered_plain, main,
               cost=rowwise_cost(p, lanes, distinct_rows(gi, gj)))
    # The route's own batches, bucket-ordered (``ROUTE_BATCHES``: D and
    # U), timed beside the main case; their bounds are below a
    # microsecond, so each line also carries the floor under it: an
    # empty kernel of one block under the same replays.
    floor = empty_ms()
    emit({"phase": "kernel", "name": "empty", "case": "1 block of 128 "
          "threads, CUDA-graph replays of 20 launches", "ms": floor})
    d = 1
    for label, n, lanes, size, buckets in ROUTE_BATCHES:
        packed, gi, gj = (t.to(dev) for t in rowwise_bucket_batch(
            rng, n, lanes, size, buckets))
        got = hk.rowwise_within_packed_indexed(packed, gi, gj, d)
        torch.cuda.synchronize()

        def gathered_plain():
            return hk.rowwise_within_plain(packed.index_select(0, gi),
                                           packed.index_select(0, gj), d)

        record(name, f"indexed, {label}: P={len(gi)} (triu pairs of "
               f"{buckets} buckets of {size}) into n={n} rows "
               f"lanes={lanes} d={d}", got, gathered_plain(),
               lambda: hk.rowwise_within_packed_indexed(packed, gi, gj, d),
               gathered_plain, False, True,
               cost=rowwise_cost(len(gi), lanes, distinct_rows(gi, gj)),
               extra=lambda line: {
                   "floor_ms": floor, "floor_share": floor / line["ms"],
                   "ms_above_floor": line["ms"] - floor})

    # Kernel 4: one verification batch of the edit path (2^16 pairs of
    # 100 bp keys padded to 112) at d = 1, 2 and 6, timed, and d = 0 and
    # 3; then extreme lengths, the edges of the words a match scan reads,
    # widths off the 16-byte grid, d at and above the width, P = 1 and P
    # off the block's pairs, and the indexed entry.
    name = "banded_within_edit_distance"
    p = 1 << 16
    for d in (1, 0, 2, 3, 6):
        a, la, b, lb = (t.to(dev) for t in edit_pairs(rng, p, d))
        got = ek.banded_within_edit_distance(a, la, b, lb, d)
        torch.cuda.synchronize()
        want = ek.banded_within_plain(a, la, b, lb, d)
        record(name, f"P={p} Lp=112 lengths 0/99-101 d={d}", got, want,
               lambda: ek.banded_within_edit_distance(a, la, b, lb, d),
               lambda: ek.banded_within_plain(a, la, b, lb, d), False,
               timed=d in (1, 2, 6),
               cost=banded_cost(la.cpu().numpy(), lb.cpu().numpy(), d, 112))
    for d in (1, 6):
        # Lengths anywhere in [0, Lp]: most gaps exceed d.
        a, _, b, _ = edit_pairs(rng, 8192, d)
        la = torch.from_numpy(rng.integers(0, 113, 8192).astype(np.int32))
        lb = (la + torch.from_numpy(rng.integers(-8, 9, 8192).astype(
            np.int32))).clamp(0, 112)
        a, la, b, lb = a.to(dev), la.to(dev), b.to(dev), lb.to(dev)
        got = ek.banded_within_edit_distance(a, la, b, lb, d)
        torch.cuda.synchronize()
        record(name, f"P=8192 Lp=112 lengths 0-112 d={d}", got,
               ek.banded_within_plain(a, la, b, lb, d), None, None, False)
    for d in (0, 1, 2, 3, 6):
        a, la, b, lb = (t.to(dev) for t in edit_edge_pairs(rng, d))
        got = ek.banded_within_edit_distance(a, la, b, lb, d)
        torch.cuda.synchronize()
        record(name, f"P={len(la)} Lp=112 lengths at word edges d={d}", got,
               ek.banded_within_plain(a, la, b, lb, d), None, None, False)
    # (P, width, d): d at and above the width answers without a DP.
    for count, width, d in ((1, 112, 1), (129, 112, 2), (4099, 100, 1),
                            (1000, 1, 0), (1000, 1, 1), (1000, 30, 1),
                            (1000, 30, 3), (1000, 30, 30), (1000, 30, 45),
                            (1000, 100, 6), (500, 300, 2), (300, 300, 6)):
        a, la, b, lb = (t.to(dev)
                        for t in edit_pairs_of_width(rng, count, width, d))
        got = ek.banded_within_edit_distance(a, la, b, lb, d)
        torch.cuda.synchronize()
        record(name, f"P={count} L={width} lengths 0-{width} d={d}", got,
               ek.banded_within_plain(a, la, b, lb, d), None, None, False)
    # The indexed entry on a small matrix of width 30: every key with
    # itself, then few keys drawn again and again.
    keys, lens, _, _ = (t.to(dev)
                        for t in edit_pairs_of_width(rng, 600, 30, 1))
    same = torch.arange(600, dtype=torch.int32, device=dev)
    few = torch.from_numpy(rng.integers(0, 7, 5000).astype(np.int32)).to(dev)
    other = torch.from_numpy(rng.integers(0, 600, 5000).astype(
        np.int32)).to(dev)
    for label, ci, cj in (("ci == cj", same, same),
                          ("repeated indices", few, other)):
        for d in (0, 1, 2):
            got = ek.banded_within_edit_distance_indexed(keys, lens, ci, cj,
                                                         d)
            torch.cuda.synchronize()
            record(name, f"indexed, {label}: P={len(ci)} into n=600 keys "
                   f"L=30 d={d}", got,
                   ek.banded_within_plain(keys[ci.long()], lens[ci.long()],
                                          keys[cj.long()], lens[cj.long()],
                                          d), None, None, False)
    # The path's launch, gathered in the kernel.
    keys, lens, ci, cj = indexed_edit_batch(rng, p, dev)
    got = ek.banded_within_edit_distance_indexed(keys, lens, ci, cj, 1)
    torch.cuda.synchronize()

    def gathered_plain():
        return ek.banded_within_plain(keys[ci.long()], lens[ci.long()],
                                      keys[cj.long()], lens[cj.long()], 1)

    record(name, f"indexed: P={p} into n=400000 keys Lp=112 d=1", got,
           gathered_plain(),
           lambda: ek.banded_within_edit_distance_indexed(keys, lens, ci,
                                                          cj, 1),
           gathered_plain, True,
           cost=banded_cost(lens[ci.long()].cpu().numpy(),
                            lens[cj.long()].cpu().numpy(), 1, 112,
                            distinct_rows(ci, cj)))
    # The nibble-packed key matrix: the same batch with every symbol at
    # most 14 and 0xFF past the lengths, verified from the packed matrix
    # (rows gathered and unpacked by torch ops, then the paired entry)
    # and from the plain one (the indexed entry).
    from fastqdedup_tpu_torch.ops.edit import (
        edit_verify_indexed,
        pack_nibble_rows,
    )
    real = torch.arange(112, device=dev)[None, :] < lens[:, None]
    keys = torch.where(real, keys % 15, 0xFF).to(torch.uint8)
    keys2 = torch.from_numpy(pack_nibble_rows(keys.cpu().numpy())).to(dev)
    ci_np, cj_np = ci.cpu().numpy(), cj.cpu().numpy()
    for d in (0, 1, 2):
        got = edit_verify_indexed(keys2, lens, ci_np, cj_np, d, packed=True)
        want = edit_verify_indexed(keys, lens, ci_np, cj_np, d)
        record(name, f"packed key matrix [400000, 56] against the plain "
               f"one: P={p} d={d}", torch.from_numpy(got),
               torch.from_numpy(want), None, None, False)
    return summary


def deflate_inputs() -> dict:
    """name -> bytes: the deflate kernel's check inputs (FASTQ, the edge
    sizes of a member, a whole window of the card writer, random bytes
    that take stored blocks, a run of zeros)."""
    from fastqdedup_tpu_torch.io.bgzf import DEVICE_WINDOW_MEMBERS

    rng = np.random.default_rng(31)
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (6000, 100))]
    quals = (33 + rng.integers(30, 41, (6000, 100))).astype(np.uint8)
    reads = fastq_block(0, seqs, quals)
    return {"one_byte": b"x", "three_bytes": b"abc",
            "one_member": reads[:65280], "member_and_byte": reads[:65281],
            "members_and_tail": reads[:3 * 65280 + 12345],
            "window": (reads * 7)[:DEVICE_WINDOW_MEMBERS * 65280],
            "random": rng.integers(0, 256, 2 * 65280 + 7,
                                   dtype=np.uint8).tobytes(),
            "zeros": bytes(65280 + 300),
            "mutated_repeats": mutated_repeats(rng)}


def mutated_repeats(rng) -> bytes:
    """A 257-byte unit repeated over two members with 1 byte in 50
    changed: long matches that end at random places, so the deflate
    kernel's greedy parse steps over matches of every length."""
    data = np.resize(rng.integers(0, 256, 257, dtype=np.uint8),
                     2 * 65280 - 11)
    hit = rng.integers(0, len(data), len(data) // 50)
    data[hit] = rng.integers(0, 256, len(hit), dtype=np.uint8)
    return data.tobytes()


def deflate_on(dev, data: bytes, total: int = 0):
    """(members bytes, lengths, launch) of the deflate kernel on ``dev``
    over ``data``; ``launch`` repeats the launch."""
    from fastqdedup_tpu_torch.ops import deflate_kernels as dk

    total = total or len(data)
    members = dk.members_of(total)
    src = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    out = torch.zeros(members * dk.OUT_STRIDE, dtype=torch.uint8, device=dev)
    lens = torch.zeros(members, dtype=torch.int32, device=dev)
    scratch = torch.empty(dk.scratch_bytes(members) if dev.type == "cuda"
                          else 0, dtype=torch.uint8, device=dev)

    def launch():
        dk.deflate_members(src, total, out, lens, scratch)
    launch()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    got = out.cpu().numpy()
    sizes = lens.cpu().tolist()
    return [got[i * dk.OUT_STRIDE:i * dk.OUT_STRIDE + n].tobytes()
            for i, n in enumerate(sizes)], sizes, launch


def check_deflate(dev) -> dict:
    """The deflate kernel against its plain version, byte for byte, and
    every member inflating to its input; returns the inputs checked."""
    from fastqdedup_tpu_torch.ops.deflate_kernels import members_of

    t0 = time.perf_counter()
    inputs = deflate_inputs()
    for name, data in inputs.items():
        got, _, _ = deflate_on(dev, data)
        want, _, _ = deflate_on(torch.device("cpu"), data)
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            fail(f"deflate kernel {name}: member {bad} differs from the "
                 f"plain version ({len(got[bad])} vs {len(want[bad])} bytes)")
        if gzip.decompress(b"".join(got)) != data:
            fail(f"deflate kernel {name}: members do not inflate to the "
                 f"input")
    checked = {"plain_inputs": sorted(inputs),
               "plain_members": sum(members_of(len(data))
                                    for data in inputs.values())}
    emit({"phase": "deflate", **checked, "equal_to_plain": True,
          "seconds": time.perf_counter() - t0})
    return checked


def run_deflate(dev) -> int:
    """``--deflate``: the check, then the kernel at the pipeline's shapes
    (a writer window of 128 members; a job's 1,322 members of the
    benchmark's ``default`` FASTQ and 510 of ``dense`` in one launch):
    one launch between events, L2-warm, beside its bytes bound, the plain
    version's time a member; the card writer and the host writer
    (``ParallelBgzfWriter``: libdeflate if loaded) over a job's bytes."""
    from benchmark.generate import generate_fastq
    from fastqdedup_tpu_torch.io import bgzf
    from fastqdedup_tpu_torch.ops import deflate_kernels as dk

    check_deflate(dev)
    workdir = tempfile.mkdtemp(prefix="deflate_", dir=os.path.join(
        HERE, "fastqdedup_tpu_torch", "build"))
    try:
        jobs = {}
        for traffic, reads, members in (("default", 400_000, 1322),
                                        ("dense", 160_000, 510)):
            spec = json.load(open(os.path.join(
                HERE, "benchmark", "traffic", traffic + ".json")))
            kwargs = {k: v for k, v in spec.items()
                      if not k.endswith("why") and k != "files"}
            path = os.path.join(workdir, traffic + ".fastq.gz")
            generate_fastq(path, reads, seed=2**31 + 9, **kwargs)
            jobs[traffic] = gzip.open(path).read()[:members * dk.BLOCK_SIZE]
        for traffic, data in jobs.items():
            for label, part in (("window", data[:bgzf.DEVICE_WINDOW_MEMBERS
                                            * dk.BLOCK_SIZE]),
                                ("job", data)):
                got, sizes, launch = deflate_on(dev, part)
                out_bytes = sum(sizes)
                cost = {"bytes": len(part) + out_bytes, "ops": 0,
                        "ops_type": "int32"}
                times = event_ms(launch, 7)
                bound = kernel_bound(cost)
                # Every member of the window, the first 4 of the job.
                checked = len(sizes) if label == "window" else 4
                t0 = time.perf_counter()
                want = [dk.bgzf_member_plain(part[i:i + dk.BLOCK_SIZE])
                        for i in range(0, min(len(part),
                                              checked * dk.BLOCK_SIZE),
                                       dk.BLOCK_SIZE)]
                plain_ms = (time.perf_counter() - t0) * 1e3 / len(want)
                if got[:len(want)] != want:
                    fail(f"deflate {traffic} {label}: kernel differs from "
                         f"the plain version")
                emit({"phase": "deflate_time", "traffic": traffic,
                      "shape": label, "members": len(sizes),
                      "input_bytes": len(part), "output_bytes": out_bytes,
                      "ratio": out_bytes / len(part),
                      "ms_one_launch": statistics.median(times),
                      "ms_one_launch_all": times, **bound,
                      "share_of_bound": bound["bound_ms"]
                      / statistics.median(times),
                      "plain_ms_a_member": plain_ms,
                      "members_equal_to_plain": len(want),
                      "timing": "one launch between two events, L2-warm "
                                "after the first; plain: the members "
                                "compared, on the host"})
            for name, make in (("card", lambda f: bgzf.DeviceBgzfWriter(
                    f, dev)), ("host", bgzf.ParallelBgzfWriter)):
                sinks = []
                for _ in range(3):
                    sink = io.BytesIO()
                    t0 = time.perf_counter()
                    with make(sink) as writer:
                        for i in range(0, len(data), 1 << 20):
                            writer.write(data[i:i + (1 << 20)])
                    sinks.append((time.perf_counter() - t0,
                                  len(sink.getvalue())))
                    if gzip.decompress(sink.getvalue()) != data:
                        fail(f"{name} writer output does not inflate")
                emit({"phase": "deflate_writer", "traffic": traffic,
                      "writer": name, "input_bytes": len(data),
                      "seconds": [t for t, _ in sinks],
                      "mb_per_s": len(data) / 1e6 / min(t for t, _ in sinks),
                      "output_bytes": sinks[0][1],
                      "libdeflate": bgzf._libdeflate() is not None,
                      "host_threads": min(4, os.cpu_count() or 1)})
        deflate_cells(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


def deflate_cells(workdir: str, reads: int = 2_000_000) -> None:
    """One job of each benchmark cell (its traffic at 2M reads, its
    configuration's arguments) on the card: the output passes ``gzip
    -t``, and its size beside the host writer's on the same records."""
    from benchmark.generate import generate_traffic
    from fastqdedup_tpu_torch.io import bgzf
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    for config, traffic, edit in (("hamming-d1", "dense", False),
                                  ("edit-d1", "default", True)):
        spec = json.load(open(os.path.join(
            HERE, "benchmark", "traffic", traffic + ".json")))
        inputs = generate_traffic(spec, reads, 2**31 + 13, workdir)
        out = os.path.join(workdir, f"{config}.out.fastq.gz")
        t0 = time.perf_counter()
        deduplicate_cluster(inputs, [out], None, use_edit_distance=edit)
        seconds = time.perf_counter() - t0
        tested = subprocess.run(["gzip", "-t", out], capture_output=True,
                                text=True)
        if tested.returncode != 0:
            fail(f"gzip -t {config}.{traffic}: {tested.stderr}")
        records = gzip.open(out).read()
        host = io.BytesIO()
        with bgzf.ParallelBgzfWriter(host) as writer:
            writer.write(records)
        card_bytes = os.path.getsize(out)
        emit({"phase": "deflate_cells", "cell": f"{config}.{traffic}",
              "job_seconds": seconds, "records_bytes": len(records),
              "card_bytes": card_bytes,
              "host_bytes": len(host.getvalue()),
              "card_over_host": card_bytes / len(host.getvalue()),
              "gzip_t": "ok"})
        if card_bytes > 1.03 * len(host.getvalue()):
            fail(f"{config}.{traffic}: the card's output is more than 3% "
                 f"over the host writer's")
        for path in inputs + [out]:
            os.unlink(path)


# --------------------------------------------------------------------- #
# The --edit route's candidate join on the card (ops/edit_candidates)


def edit_join_keys(seed: int, kind: str, molecules: int):
    """(entries, padded key matrix) of the edit route's input.
    ``"cell"``: the benchmark cell's traffic, ``molecules`` 100 bp
    molecules of 5 reads each, 15% of the reads with one substitution
    (400,000 molecules: 2M reads, about 620,000 unique keys of one length
    group); ``"indel"``: ``molecules`` molecules, each beside a copy with
    one substitution and two copies of which half lose or gain a base
    (lengths 99-101)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    mol = bases[rng.integers(0, 4, (molecules, 100))]
    if kind == "cell":
        hit = rng.integers(0, molecules, int(0.15 * 5 * molecules))
        subs = mol[hit]
        subs[np.arange(len(hit)), rng.integers(0, 100, len(hit))] = \
            bases[rng.integers(0, 4, len(hit))]
        rows = np.unique(np.concatenate([mol, subs]), axis=0)
        keys = [row.tobytes() for row in rows]
    else:
        subs = mol.copy()
        subs[np.arange(molecules), rng.integers(0, 100, molecules)] = \
            bases[rng.integers(0, 4, molecules)]
        moved, lengths = apply_indels(rng, np.concatenate([mol, mol]), 0.5,
                                      bases)
        keys = sorted({row.tobytes() for row in np.concatenate([mol, subs])}
                      | {row[:n].tobytes()
                         for row, n in zip(moved, lengths)})
    lengths = np.array([len(k) for k in keys], dtype=np.int64)
    entries = []
    padded = np.full((len(keys), 112), 0xFF, dtype=np.uint8)
    for length in np.unique(lengths):
        idx = np.flatnonzero(lengths == length)
        matrix = np.frombuffer(b"".join(keys[i] for i in idx),
                               dtype=np.uint8).reshape(len(idx), length)
        padded[idx, :length] = matrix
        entries.append((int(length), matrix, idx))
    return entries, padded


def edit_join_plan(entries, d: int, shard=(0, 1)):
    from fastqdedup_tpu_torch.ops.bucket import edit_window_plan

    return edit_window_plan([m for _, m, _ in entries],
                            [i for _, _, i in entries], d, shard)


def host_join_codes(plan, shard=(0, 1)) -> np.ndarray:
    """The host join's codes from its composite branch, at any size."""
    from fastqdedup_tpu_torch.ops import bucket

    low = bucket.EDIT_RADIX_MIN_ROWS
    bucket.EDIT_RADIX_MIN_ROWS = 1
    try:
        return bucket.host_edit_join(plan, shard)
    finally:
        bucket.EDIT_RADIX_MIN_ROWS = low


def dense_join_keys(entries, padded):
    """The entries and key matrix as alphabet indices (A, C, G, T -> 0-3,
    the pad 0xFF kept), which pack into nibbles."""
    lut = np.full(256, 0xFF, dtype=np.uint8)
    lut[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4)
    return ([(length, lut[matrix], idx) for length, matrix, idx in entries],
            lut[padded])


def plain_join_codes(keys: torch.Tensor, plan) -> np.ndarray:
    """The join's plain steps on ``keys``' device: the plain window hash,
    ``torch.sort``, the plain pair enumeration, the codes' sort and
    unique, one copy back."""
    from fastqdedup_tpu_torch.ops import edit_candidates as ec

    specs, ids = ec.spec_table(plan)
    values, kept = ec.window_hash_plain(
        keys, torch.from_numpy(ids).to(keys.device), torch.from_numpy(specs),
        plan.rows, plan.gid_bits)
    ordered = ec.sort_values(values)
    left, right, gids = ec._pairs_plain(ordered[:int(kept)], plan.gid_bits)
    gi, gj = gids[left], gids[right]
    codes = torch.minimum(gi, gj) * (1 << 31) + torch.maximum(gi, gj)
    return ec.unique_codes(codes).cpu().numpy()


def edit_join_steps(keys: torch.Tensor, plan, shard=(0, 1),
                    packed: bool = False) -> dict:
    """Every step of the card join on ``keys``' device, by name."""
    from fastqdedup_tpu_torch.ops import edit_candidates as ec

    specs, ids = ec.spec_table(plan)
    dev = keys.device
    values, kept = ec.window_hash(keys, torch.from_numpy(ids).to(dev),
                                  torch.from_numpy(specs).to(dev),
                                  plan.rows, plan.gid_bits, shard, packed)
    ordered = ec.sort_values(values)
    counts = ec.join_count(ordered, kept, plan.gid_bits)
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if len(ends) else 0
    codes = ec.join_write(ordered, kept, plan.gid_bits, ends, total)
    return {"values": values, "kept": kept, "sorted": ordered,
            "counts": counts, "codes": codes}


def edit_join_cost(plan, n_keys: int, key_length: int, pairs: int,
                   unique: int) -> dict:
    """Bytes of the card join: the key bytes read once; the composites
    written, sorted (read and written once) and read by both join passes;
    the codes written, sorted and the unique ones written."""
    rows = plan.rows
    return {"bytes": n_keys * key_length + 8 * rows * 4 + 8 * pairs * 3
            + 8 * unique, "ops": 0, "ops_type": "int32"}


def check_edit_candidates(dev) -> dict:
    """The card join's kernels against their plain versions, each step on
    the same input, and the whole join against the host join's composite
    branch, byte for byte: both traffics at d = 1 and 2, each of three
    shards, the key matrix nibble-packed (``engine.PACK_KEY_MATRIX``),
    short keys, and every upload delayed on the stream.  Then the join at
    the cell's shape (``--edit-candidates`` alone): every step timed, the
    whole join beside the host join and the plain join on the card.
    Returns each kernel's line for the kernel table, with the elements
    that differed from the plain version over every case (``mismatches``,
    0 or the run fails)."""
    from fastqdedup_tpu_torch.ops import edit_candidates as ec
    from fastqdedup_tpu_torch.ops.edit import pack_nibble_rows

    t0 = time.perf_counter()
    summary = {name: {"mismatches": 0, "cases": 0} for name in ec.LAUNCHES}
    cases = [("cell", 1, (0, 1), False), ("cell", 2, (0, 1), False),
             ("indel", 1, (0, 1), False), ("indel", 2, (0, 1), False)] + \
        [("indel", 1, (p, 3), False) for p in range(3)] + \
        [("indel", 1, (0, 1), True), ("indel", 2, (1, 3), True),
         ("cell", 1, (0, 1), True)]

    def differing(got, want):
        if got.shape != want.shape:
            return max(got.numel(), want.numel())
        return int((got != want).sum())

    for kind, d, shard, packed in cases:
        entries, padded = edit_join_keys(40 + d, kind, 3000)
        if packed:
            entries, padded = dense_join_keys(entries, padded)
        plan = edit_join_plan(entries, d, shard)
        keys = torch.from_numpy(pack_nibble_rows(padded) if packed
                                else padded)
        got = edit_join_steps(keys.to(dev), plan, shard, packed)
        want = edit_join_steps(keys, plan, shard, packed)
        # Each kernel on the other's input: the plain sort's order.
        ordered = got["sorted"]
        counts = ec.join_count(ordered, got["kept"], plan.gid_bits)
        ends = torch.cumsum(counts, 0)
        codes = ec.join_write(ordered, got["kept"], plan.gid_bits, ends,
                              int(ends[-1]))
        wrong = {
            "edit_window_hash": differing(got["values"].cpu(),
                                          want["values"])
            + abs(int(got["kept"]) - int(want["kept"])),
            "edit_join_count": differing(counts.cpu(), want["counts"]),
            "edit_join_write": differing(codes.cpu(), want["codes"]),
        }
        card = ec.join_codes(keys.to(dev), plan, shard, packed)
        host = host_join_codes(plan, shard)
        case = f"{kind} d={d} shard={shard} packed={packed}"
        emit({"phase": "edit-candidates", "case": case, "keys": len(padded),
              "rows": plan.rows, "kept": int(got["kept"]),
              "pairs": len(got["codes"]), "codes": len(card),
              "mismatches": wrong,
              "join_equal_host": bool(np.array_equal(card, host))})
        for name, count in wrong.items():
            summary[name]["mismatches"] += count
            summary[name]["cases"] += 1
            if count:
                fail(f"{name} disagrees with its plain version ({case})")
        if not np.array_equal(card, host) or not len(host):
            fail(f"card join of {case}: other codes than the host join")
    # Short keys (the host's complete graph, no window) and keys too
    # short for any pair.
    for keys_list in ([b"AC", b"A", b"G"], [b"ACGTAC", b"ACGTAA", b"A"]):
        from fastqdedup_tpu_torch.ops.bucket import (
            edit_candidate_pairs,
            edit_pairs_of_codes,
        )

        lengths = np.array([len(k) for k in keys_list])
        entries = []
        padded = np.full((len(keys_list), 16), 0xFF, dtype=np.uint8)
        for length in np.unique(lengths):
            idx = np.flatnonzero(lengths == length)
            matrix = np.frombuffer(b"".join(keys_list[i] for i in idx),
                                   dtype=np.uint8).reshape(len(idx), length)
            padded[idx, :length] = matrix
            entries.append((int(length), matrix, idx))
        plan = edit_join_plan(entries, 1)
        got = edit_pairs_of_codes(plan, ec.join_codes(
            torch.from_numpy(padded).to(dev), plan))
        want = edit_candidate_pairs([m for _, m, _ in entries],
                                    [i for _, _, i in entries], 1)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            fail(f"card join of short keys {keys_list}: other pairs")
    # Every upload of the join delayed on the stream.
    entries, padded = edit_join_keys(45, "indel", 3000)
    plan = edit_join_plan(entries, 1)
    undo = delayed(ec, "upload")
    try:
        card = ec.join_codes(torch.from_numpy(padded).to(dev), plan)
    finally:
        undo()
    if not np.array_equal(card, host_join_codes(plan)):
        fail("card join with delayed uploads: other codes than the host")
    emit({"phase": "edit-candidates", "check": "short keys, delayed "
          "uploads", "equal": True, "seconds": time.perf_counter() - t0})
    return summary


def time_edit_candidates(dev, summary: dict) -> None:
    """The card join at the cell's shape, against the host join and the
    plain version (on the host's cores, once): every step's time (kernels
    from CUDA-graph replays, L2-warm; the sorts between events; whole
    joins on the host's clock after a synchronize) and its bound."""
    from fastqdedup_tpu_torch.ops import edit_candidates as ec

    t0 = time.perf_counter()
    entries, padded = edit_join_keys(7, "cell", 400_000)
    plan = edit_join_plan(entries, 1)
    gen_s = time.perf_counter() - t0
    keys = torch.from_numpy(padded).to(dev)
    torch.cuda.synchronize()

    def host_join():
        return host_join_codes(plan)

    def card_join():
        return ec.join_codes(keys, plan)

    host_s, card_s = [], []
    for _ in range(3):
        for fn, store in ((card_join, card_s), (host_join, host_s),
                          (host_join, host_s), (card_join, card_s)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            store.append(time.perf_counter() - t)
    host = host_join()
    card = card_join()
    if not np.array_equal(card, host):
        fail("card join at the cell's shape: other codes than the host")
    t = time.perf_counter()
    plain = ec.join_codes(torch.from_numpy(padded), plan)
    plain_s = time.perf_counter() - t
    if not np.array_equal(plain, host):
        fail("plain join at the cell's shape: other codes than the host")
    # The plain steps on the card's tensors (no hand-written kernel), in
    # turns with the card join, on the host's clock after a synchronize.
    plain_card_s, card_turn_s = [], []
    plain_card = plain_join_codes(keys, plan)
    if not np.array_equal(plain_card, host):
        fail("plain join on the card: other codes than the host")
    for _ in range(3):
        for fn, store in ((card_join, card_turn_s),
                          (lambda: plain_join_codes(keys, plan),
                           plain_card_s),
                          (lambda: plain_join_codes(keys, plan),
                           plain_card_s),
                          (card_join, card_turn_s)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            store.append(time.perf_counter() - t)
    plain_card_ms = statistics.median(event_ms(
        lambda: plain_join_codes(keys, plan)))
    steps = edit_join_steps(keys, plan)
    values, kept = steps["values"], steps["kept"]
    ordered, ends = steps["sorted"], torch.cumsum(steps["counts"], 0)
    total = int(ends[-1])
    specs, ids = ec.spec_table(plan)
    specs_dev = torch.from_numpy(specs).to(dev)
    ids_dev = torch.from_numpy(ids).to(dev)
    timed = {
        "edit_window_hash": graph_ms(lambda: ec.window_hash(
            keys, ids_dev, specs_dev, plan.rows, plan.gid_bits)),
        "torch_sort": event_ms(lambda: ec.sort_values(values)),
        "edit_join_count": graph_ms(lambda: ec.join_count(
            ordered, kept, plan.gid_bits)),
        "scan": event_ms(lambda: torch.cumsum(steps["counts"], 0)),
        "edit_join_write": graph_ms(lambda: ec.join_write(
            ordered, kept, plan.gid_bits, ends, total)),
        "unique": event_ms(lambda: ec.unique_codes(steps["codes"])),
    }
    medians = {k: statistics.median(v) for k, v in timed.items()}
    cost = edit_join_cost(plan, len(padded), 100, total, len(card))
    bound = kernel_bound(cost)
    line = {"phase": "edit-candidates", "case": "the cell's shape: 2M "
            "default reads, d=1", "keys": len(padded), "rows": plan.rows,
            "pairs": total, "codes": len(card), "generate_s": gen_s,
            "host_join_s": statistics.median(host_s),
            "card_join_s": statistics.median(card_s),
            "plain_join_s": plain_s,
            "plain_card_join_s": statistics.median(plain_card_s),
            "plain_card_join_runs_s": plain_card_s,
            "card_join_turns_s": card_turn_s,
            "plain_card_join_event_ms": plain_card_ms,
            "host_join_runs_s": host_s, "card_join_runs_s": card_s,
            "steps_ms": medians,
            "steps_timing": "kernels: CUDA-graph replays of 20 launches, "
                            "L2-warm; sorts, scan, unique: one call "
                            "between two events",
            "device_ms": sum(medians.values()),
            **bound}
    line["share_of_bound"] = bound["bound_ms"] / line["device_ms"]
    emit(line)
    for name in ("edit_window_hash", "edit_join_count", "edit_join_write"):
        summary[name].update({"ms": medians[name], "shape": line["case"]})


def check_against_oracles(dev) -> dict:
    """The ``verify`` phase: ``bench_kernels_torch.verify_kernels`` on
    the card; returns the geometries checked, by kernel."""
    from bench_kernels_torch import KernelMismatch, verify_kernels

    t0 = time.perf_counter()
    try:
        counts = verify_kernels(dev)
    except KernelMismatch as error:
        fail(f"verify: {error}")
    emit({"phase": "verify", "seconds": time.perf_counter() - t0,
          "geometries": sum(counts.values()), "by_kernel": counts})
    return counts


def check_warmup() -> None:
    """The ``warmup`` phase: ``warmup()`` once, its steps printed, and no
    launch of it counted as real work."""
    from fastqdedup_tpu_torch.ops import kernel_lib
    from fastqdedup_tpu_torch.warmup import warmup

    before = launch_counts()
    steps = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(steps):
        warmup()
    emit({"phase": "warmup", "seconds": time.perf_counter() - t0,
          "steps": steps.getvalue().splitlines(),
          "warmup_launches": dict(kernel_lib.WARMUP_LAUNCHES)})
    if launch_counts() != before:
        fail("warmup() counted its launches as real work")
    if set(kernel_lib.WARMUP_LAUNCHES) != set(before):
        fail(f"warmup() launched {sorted(kernel_lib.WARMUP_LAUNCHES)}, "
             f"not every kernel")


# --------------------------------------------------------------------- #
# Phases 5-7: the pipeline


@contextlib.contextmanager
def environment(overrides):
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def launch_counts() -> dict:
    """Every kernel's launch count, by name."""
    from fastqdedup_tpu_torch.ops import (deflate_kernels, edit_candidates,
                                          edit_kernels, hamming_kernels)

    return {**hamming_kernels.LAUNCHES, **edit_kernels.LAUNCHES,
            **deflate_kernels.LAUNCHES, **edit_candidates.LAUNCHES}


def reset_launch_counts() -> None:
    from fastqdedup_tpu_torch.ops import (deflate_kernels, edit_candidates,
                                          edit_kernels, hamming_kernels)

    hamming_kernels.reset_launches()
    edit_kernels.reset_launches()
    deflate_kernels.reset_launches()
    edit_candidates.reset_launches()


def run_pipeline(workdir: str, name: str, files: dict, tag: str,
                 overrides=None, phase=None) -> dict:
    """One run of ``INPUTS[name]`` through ``deduplicate_cluster`` on the
    generated ``files``; the sha256 of its decompressed outputs (several
    outputs concatenated in order) must be the pinned one."""
    from fastqdedup_tpu_torch import dissect
    from fastqdedup_tpu_torch.keys import length_string_to_slices
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    file_names, check_length, max_distance, method, edit = INPUTS[name]
    srcs = [files[f] for f in file_names]
    outs = [os.path.join(workdir, f"out_{tag}_{i}.fastq.gz")
            for i in range(len(srcs))]
    slices = length_string_to_slices(check_length) if check_length else None
    n_reads = FILES[file_names[0]]["n_reads"]
    before = launch_counts()
    with environment(overrides or {}):
        t0 = time.perf_counter()
        deduplicate_cluster(
            srcs, outs, slices, max_distance=max_distance,
            cluster_dissection_func=getattr(
                dissect, f"cluster_dissection_{method}"),
            use_edit_distance=edit)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    sha = decompressed_sha256(*outs)
    for out in outs:
        os.unlink(out)
    expected = EXPECTED_SHA256[name]
    line = {"phase": phase or ("pipeline" if name == "default" else "route"),
            "run": tag, "input": name, "files": list(file_names),
            "check_lengths": check_length, "max_distance": max_distance,
            "method": method, "reads": n_reads, "edit": edit,
            "seconds": seconds, "reads_per_s": n_reads / seconds,
            "sha256": sha, "expected_sha256": expected,
            "launches": launches}
    if overrides:
        line["forced"] = overrides
    emit(line)
    if sha != expected:
        fail(f"{tag}: output sha256 {sha} != expected {expected}")
    return line


@contextlib.contextmanager
def launch_shapes(store: list):
    """Record every kernel launch of real work made within the block, at
    the library's C entry points, as ``(entry point, rows, max
    distance)``: ``rows`` is a bucket's or tile's row count S for the
    all-pairs kernel, the lanes of a row for the pair-list kernel, the
    padded width for the edit kernel.  The prewarm thread's launches are
    left out, as they are from ``LAUNCHES``."""
    from fastqdedup_tpu_torch.ops import kernel_lib

    lib = kernel_lib.library()
    # entry point: (position of rows, position of the distance)
    entries = {"fqd_pairs_within_packed": (4, 10),
               "fqd_rowwise_within_packed": (4, 5),
               "fqd_rowwise_within_packed_indexed": (5, 6),
               "fqd_banded_within_edit": (8, 9)}
    inner = {name: getattr(lib, name) for name in entries}

    def spy(name):
        rows_at, d_at = entries[name]

        def call(*args):
            if not kernel_lib.in_warmup():
                store.append((name, int(args[rows_at]), int(args[d_at])))
            return inner[name](*args)

        return call

    for name in entries:
        setattr(lib, name, spy(name))
    try:
        yield
    finally:
        for name, fn in inner.items():
            setattr(lib, name, fn)


# What the configs phase must have launched, on which run it is forced
# where measured-rate routing did not reach it, and with which rate knobs.
CONFIG_LAUNCHES = (
    ("all-pairs kernel at d=2 on buckets of S >= 512",
     lambda name, rows, d: name == "fqd_pairs_within_packed"
     and rows >= 512 and d == 2,
     "umi12-d2", {"FASTQDEDUP_DISPATCH_S": "1e-9",
                  "FASTQDEDUP_H2D_RATE": "1e-9"}),
    ("pair-list kernel at d=2",
     lambda name, rows, d: name.startswith("fqd_rowwise_within_packed")
     and d == 2,
     "umi3", {"FASTQDEDUP_DISPATCH_S": "1e-9",
              "FASTQDEDUP_H2D_RATE": "1e15",
              "FASTQDEDUP_HOST_RATE": "1.0"}),
    ("edit kernel at d=2",
     lambda name, rows, d: name == "fqd_banded_within_edit" and d == 2,
     "indel-d2", None),
)


def shape_counts(shapes: list) -> dict:
    """``"entry point rows=R d=D"`` -> launches."""
    counts: dict = {}
    for name, rows, d in shapes:
        key = f"{name} rows={rows} d={d}"
        counts[key] = counts.get(key, 0) + 1
    return counts


def run_configs(workdir: str, files: dict) -> dict:
    """The ``configs`` phase: every run of ``CONFIGS`` against its pinned
    sha256, launch counts from 0, then the launches of ``CONFIG_LAUNCHES``
    (forced with the rate knobs where the measured rates did not reach
    one; a forced run writes the unforced bytes or fails).  Returns the
    phase's launch counts."""
    reset_launch_counts()
    shapes: list = []
    t0 = time.perf_counter()
    for name in CONFIGS:
        mark = len(shapes)
        with launch_shapes(shapes):
            run_pipeline(workdir, name, files, name, phase="configs")
        emit({"phase": "configs", "run": name,
              "launch_shapes": shape_counts(shapes[mark:])})
    for label, matches, name, overrides in CONFIG_LAUNCHES:
        if any(matches(*shape) for shape in shapes):
            continue
        if overrides is None:
            fail(f"configs: {name!r} did not launch the {label}")
        emit({"phase": "configs", "note": f"measured-rate routing did not "
              f"launch the {label}; forcing it on {name!r}",
              "forced": overrides})
        mark = len(shapes)
        with launch_shapes(shapes):
            run_pipeline(workdir, name, files, f"{name}-forced", overrides,
                         phase="configs")
        emit({"phase": "configs", "run": f"{name}-forced",
              "launch_shapes": shape_counts(shapes[mark:])})
        if not any(matches(*shape) for shape in shapes[mark:]):
            fail(f"configs: forced run of {name!r} did not launch the "
                 f"{label}")
    counts = launch_counts()
    emit({"phase": "configs", "seconds": time.perf_counter() - t0,
          "launches": counts, "launch_shapes": shape_counts(shapes)})
    return counts


@contextlib.contextmanager
def capture_edges(store: list):
    """Record every edge list the engine hands to its component labels,
    as ``(n, edges_i, edges_j)``."""
    from fastqdedup_tpu_torch import engine

    inner = engine._component_labels

    def capture(n, ei, ej):
        store.append((n, ei.copy(), ej.copy()))
        return inner(n, ei, ej)

    engine._component_labels = capture
    try:
        yield
    finally:
        engine._component_labels = inner


def check_trie_api() -> dict:
    """The ``Trie`` facade in Levenshtein mode above the engine's host
    limit, on the card and on the CPU device: the same membership answers
    and clusters.  Launch counts are set to 0 before the card's run and
    read after it; that run must launch the edit kernel."""
    from fastqdedup_tpu_torch import Trie

    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    molecules = bases[rng.integers(0, 4, (400, 60))]
    seqs = molecules[rng.integers(0, 400, 2_000)]
    hit = np.flatnonzero(rng.random(2_000) < 0.3)
    seqs[hit, rng.integers(0, 60, len(hit))] = bases[
        rng.integers(0, 4, len(hit))]
    rows, lengths = apply_indels(rng, seqs, 0.3, bases)
    reads = [row[:n].tobytes().decode() for row, n in zip(rows, lengths)]
    probes, probe_lengths = apply_indels(rng, molecules[:80], 1.0, bases)
    queries = [row[:n].tobytes().decode()
               for row, n in zip(probes, probe_lengths)]
    queries += ["".join(rng.choice(list("ACGT"), 60)) for _ in range(20)]
    answers, counts = {}, {}
    for dev in ("cuda", "cpu"):
        with environment({"FASTQDEDUP_TORCH_DEVICE": dev}):
            trie = Trie()
            for read in reads:
                trie.add_sequence(read)
            reset_launch_counts()
            t0 = time.perf_counter()
            found = [trie.contains_sequence(q, 1, True) for q in queries]
            clusters = {frozenset(c) for c in trie.pop_all_clusters(1, True)}
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts[dev] = launch_counts()
        answers[dev] = (found, clusters)
        emit({"phase": "api", "device": dev, "reads": len(reads),
              "queries": len(queries), "found": sum(found),
              "clusters": len(clusters), "seconds": seconds,
              "launches": counts[dev]})
    if answers["cuda"] != answers["cpu"]:
        fail("Trie in edit mode: the card's answers differ from the CPU's")
    if counts["cuda"]["banded_within_edit_distance"] == 0:
        fail("Trie in edit mode did not launch banded_within_edit_distance")
    return counts["cuda"]


# --------------------------------------------------------------------- #
# Phase 9: two processes of one torch.distributed job


def split_records(src: str, dests, n_first: int) -> None:
    """Write the records of BGZF file ``src`` into two BGZF files: its
    first ``n_first`` records, then the rest."""
    from fastqdedup_tpu_torch.io.bgzf import BgzfWriter

    with gzip.open(src, "rb") as f:
        data = f.read()
    newlines = np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == 10)
    cut = int(newlines[4 * n_first - 1]) + 1
    view = memoryview(data)
    for path, part in zip(dests, (view[:cut], view[cut:])):
        with BgzfWriter(path, compresslevel=1) as f:
            for off in range(0, len(part), 1 << 22):
                f.write(part[off:off + (1 << 22)])


def profiled_device_ms(prof) -> float:
    """Device time of a profiled run: every kernel and copy once (self
    time; the profiler's own buffer rows left out)."""
    total_us = 0.0
    for evt in prof.key_averages():
        if "Activity Buffer" in evt.key:
            continue
        total_us += getattr(evt, "self_device_time_total", None) \
            or getattr(evt, "self_cuda_time_total", 0.0)
    return total_us / 1000.0


def distributed_worker(pid: int, port: int, spec_path: str) -> int:
    """Phase 9's child process: join the 2-process job, run each job of
    the spec (and, where it asks, once more under the profiler), print
    one JSON line per run."""
    sys.path.insert(0, HERE)
    from fastqdedup_tpu_torch import pipeline
    from fastqdedup_tpu_torch.keys import length_string_to_slices
    from fastqdedup_tpu_torch.parallel import distributed
    from fastqdedup_tpu_torch.parallel.transport import get_mesh

    distributed.initialize_distributed(f"127.0.0.1:{port}", 2, pid)
    if distributed.process_shape() != (pid, 2):
        fail(f"worker {pid}: process group {distributed.process_shape()}")
    timers: dict = {}
    plans: list = []

    def timed(name: str, key: str) -> None:
        inner = getattr(distributed, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                timers[key] = timers.get(key, 0.0) + \
                    time.perf_counter() - t0

        setattr(distributed, name, wrapper)

    timed("exchange_merge_key_tables", "key_exchange_s")
    timed("allgather_key_tables", "key_exchange_s")
    timed("allgather_int64_pairs", "edge_exchange_s")
    plan_inner = pipeline._plan_input_ranges

    def plan(*args, **kwargs):
        out = plan_inner(*args, **kwargs)
        plans.append(bool(out))
        return out

    pipeline._plan_input_ranges = plan
    with open(spec_path) as f:
        jobs = json.load(f)

    def run(job, suffix: str, env: dict, profile: bool) -> dict:
        outputs = [o.replace(".fastq.gz", f"{suffix}.fastq.gz")
                   for o in job["outputs"][pid]]
        slices = length_string_to_slices(job["check_length"]) \
            if job["check_length"] else None
        timers.clear()
        plans.clear()
        with environment(env):
            distributed.barrier("smoke:start")
            reset_launch_counts()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) if profile else None
            with prof if prof is not None else contextlib.nullcontext():
                t0 = time.perf_counter()
                pipeline.deduplicate_cluster(job["inputs"][pid], outputs,
                                             slices,
                                             use_edit_distance=job["edit"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            launches = launch_counts()
        line = {"phase": "distributed-process", "run": job["tag"] + suffix,
                "job": job["tag"], "pid": pid, "seconds": seconds,
                "launches": launches, "tcp_mesh_up": get_mesh() is not None,
                "byte_range_plan": plans[-1] if plans else False,
                "outputs": outputs, "profiled": profile, **timers}
        if env != job["env"]:
            line["forced"] = env
        if prof is not None:
            line["device_ms"] = profiled_device_ms(prof)
        emit(line)
        return line

    for job in jobs:
        line = run(job, "", job["env"], False)
        kernel = job["must_launch"]
        if kernel and job["force"]:
            # Both processes take the same decision: it rests on the sum.
            (total,) = distributed.sum_scalars(line["launches"][kernel])
            if total == 0:
                run(job, "_forced", {**job["env"], **job["force"]}, False)
    for job in jobs:
        if job["profile"]:
            run(job, "_profiled", job["env"], True)
    distributed.barrier("smoke:end")
    return 0


def run_distributed(workdir: str, files: dict, single: dict) -> dict:
    """Phase 9: the 2-process job in two child processes of this script.
    Checks every run's merged output against the pinned sha256 and the
    required launches; returns the launches of the unprofiled runs,
    summed over both processes.  ``single`` maps an input to its
    single-process run's seconds in this call."""
    import socket

    halves = [os.path.join(workdir, f"default_half{p}.fastq.gz")
              for p in range(2)]
    t0 = time.perf_counter()
    split_records(files["default"], halves,
                  FILES["default"]["n_reads"] // 2)
    emit({"phase": "distributed", "note": "default input split into two "
          "BGZF files of 500000 records", "seconds": time.perf_counter() - t0})

    def out(tag):
        return os.path.join(workdir, f"dist_{tag}.fastq.gz")

    jobs = []
    for name, kernel, force in (
            ("default", None, None),
            ("umi12", "bucket_within_packed", {
                "FASTQDEDUP_DISPATCH_S": "1e-9",
                "FASTQDEDUP_H2D_RATE": "1e-9"}),
            ("edit", "banded_within_edit_distance", None)):
        (file,), check_length, _, _, edit = INPUTS[name]
        jobs.append({"tag": name, "input": name,
                     "inputs": [[files[file]]] * 2,
                     "outputs": [[out(name)]] * 2,
                     "check_length": check_length, "edit": edit, "env": {},
                     "must_launch": kernel, "force": force, "profile": True})
    jobs.append({"tag": "default-sharded", "input": "default",
                 "inputs": [[halves[0]], [halves[1]]],
                 "outputs": [[out("sharded0")], [out("sharded1")]],
                 "check_length": None, "edit": False,
                 "env": {"FASTQDEDUP_SHARDED_INPUT": "1"},
                 "must_launch": None, "force": None, "profile": False})
    spec = os.path.join(workdir, "dist_jobs.json")
    with open(spec, "w") as f:
        json.dump(jobs, f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=HERE)
    logs = [os.path.join(workdir, f"worker{p}.log") for p in range(2)]
    procs = []
    t0 = time.perf_counter()
    try:
        for p in range(2):
            with open(logs[p], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--distributed-worker", str(p), str(port), spec],
                    env=env, cwd=HERE, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 600
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        fail("distributed: a worker did not finish within 600 s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    phase_s = time.perf_counter() - t0
    lines = []
    for proc, log in zip(procs, logs):
        with open(log, errors="replace") as f:
            text = f.read()
        if proc.returncode != 0:
            print(text[-4000:], file=sys.stderr)
            fail(f"distributed: worker exited with {proc.returncode}")
        lines += [json.loads(row) for row in text.splitlines()
                  if row.startswith('{"phase": "distributed-process"')]
    for line in lines:
        emit(line)
    summed: dict = {}
    by_job = {job["tag"]: job for job in jobs}
    for tag in dict.fromkeys(line["run"] for line in lines):
        pair = sorted((x for x in lines if x["run"] == tag),
                      key=lambda x: x["pid"])
        if [x["pid"] for x in pair] != [0, 1]:
            fail(f"distributed {tag}: not both processes reported")
        job = by_job[pair[0]["job"]]
        digest = hashlib.sha256()
        paths = pair[0]["outputs"] if job["tag"] != "default-sharded" \
            else pair[0]["outputs"] + pair[1]["outputs"]
        for path in paths:
            with gzip.open(path, "rb") as f:
                for block in iter(lambda: f.read(1 << 22), b""):
                    digest.update(block)
        sha = digest.hexdigest()
        expected = EXPECTED_SHA256[job["input"]]
        launches = {k: pair[0]["launches"][k] + pair[1]["launches"][k]
                    for k in pair[0]["launches"]}
        wall = max(x["seconds"] for x in pair)
        line = {"phase": "distributed", "run": tag, "processes": 2,
                "wall_s": wall, "seconds": [x["seconds"] for x in pair],
                "single_process_s": single.get(job["input"]),
                "key_exchange_s": [x.get("key_exchange_s", 0.0)
                                   for x in pair],
                "edge_exchange_s": [x.get("edge_exchange_s", 0.0)
                                    for x in pair],
                "tcp_mesh_up": [x["tcp_mesh_up"] for x in pair],
                "byte_range_plan": [x["byte_range_plan"] for x in pair],
                "launches": launches, "sha256": sha,
                "expected_sha256": expected}
        if pair[0]["profiled"]:
            device_ms = sum(x["device_ms"] for x in pair)
            line["device_ms"] = device_ms
            line["busy_share"] = device_ms / (wall * 1000.0)
        emit(line)
        if sha != expected:
            fail(f"distributed {tag}: sha256 {sha} != expected {expected}")
        if not pair[0]["profiled"]:
            for k, v in launches.items():
                summed[k] = summed.get(k, 0) + v
    for job in jobs:
        kernel = job["must_launch"]
        if kernel and not sum(
                x["launches"][kernel] for x in lines
                if x["job"] == job["tag"] and not x["profiled"]):
            fail(f"distributed {job['tag']}: {kernel} was never launched")
    emit({"phase": "distributed", "seconds": phase_s, "launches": summed})
    return summed


# --------------------------------------------------------------------- #
# Phases 10-11: labels on a mesh of devices, the device quality filter


def check_mesh(n: int, ei: np.ndarray, ej: np.ndarray) -> None:
    from fastqdedup_tpu_torch.ops.components import \
        connected_components_host
    from fastqdedup_tpu_torch.parallel.sharded import \
        sharded_components_from_edges
    from fastqdedup_tpu_torch.runtime import local_device_count

    t0 = time.perf_counter()
    want = connected_components_host(n, ei, ej)
    host_s = time.perf_counter() - t0
    cards = torch.cuda.device_count()
    meshes = {"2 shards on cuda:0": [torch.device("cuda", 0)] * 2}
    if cards > 1:
        meshes[f"one shard on each of {cards} cards"] = [
            torch.device("cuda", i) for i in range(cards)]
    count = local_device_count()
    route = ("not taken here: local_device_count() is 1, so the "
             "pipeline's labels came from host union-find; the mesh "
             "route is pinned by the CPU tests" if count == 1 else
             f"taken by the pipeline above FASTQDEDUP_MESH_MIN_EDGES "
             f"(local_device_count() is {count})")
    for label, mesh in meshes.items():
        sharded_components_from_edges(n, ei, ej, mesh)  # first use
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = sharded_components_from_edges(n, ei, ej, mesh)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        equal = bool(np.array_equal(labels, want))
        emit({"phase": "mesh", "mesh": label,
              "devices": [str(d) for d in mesh], "keys": n,
              "edges": int(len(ei)), "components": int(len(np.unique(want))),
              "seconds": seconds, "host_union_find_s": host_s,
              "equal_to_union_find": equal, "engine_route": route})
        if not equal:
            fail(f"mesh {label}: labels differ from host union-find")


def check_quality(workdir: str, src: str) -> None:
    from fastqdedup_tpu_torch.pipeline import deduplicate_cluster

    shas = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(workdir, f"quality_{dev}.fastq.gz")
        with environment({"FASTQDEDUP_DEVICE_QUALITY": "1",
                          "FASTQDEDUP_TORCH_DEVICE": dev}):
            t0 = time.perf_counter()
            deduplicate_cluster([src], [out], None)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        shas[dev] = decompressed_sha256(out)
        os.unlink(out)
        emit({"phase": "quality", "device": dev, "seconds": seconds,
              "sha256": shas[dev], "equals_host_filter_sha256":
              shas[dev] == EXPECTED_SHA256["default"]})
    if shas["cuda"] != shas["cpu"]:
        fail("quality: the card's device-quality output differs from the "
             "CPU device's")


PHASES = ("stage and descriptors computed, products issued",
          "next stage one-hot into the other buffer", "proxy fence",
          "loads of the stage after issued", "wait for the products",
          "threshold, pack, store", "block barrier", "loop back")


def run_phases(dev) -> int:
    """Where a block of the tensor-core kernel spends a tile: builds
    ``csrc/hamming.cu`` with ``-DFQD_PHASE_TIMES`` into a library of its
    own, launches the main bucket shape (S=128 K=2048 L=50 d=1) and prints
    the median nanoseconds between the kernel's marks over all blocks,
    stages 1 to 5 of each (one stage is one tile at this shape)."""
    import ctypes

    from fastqdedup_tpu_torch.ops import hamming_kernels as hk
    from fastqdedup_tpu_torch.ops import kernel_lib

    lib_path = os.path.join(os.path.dirname(kernel_lib.LIB_PATH),
                            "libfqd_hamming_phases.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    source = os.path.join(HERE, "fastqdedup_tpu_torch", "csrc",
                          "hamming.cu")
    built = subprocess.run(
        [kernel_lib._nvcc(), *kernel_lib._ARCH, "-std=c++17", "-O3",
         "-DFQD_PHASE_TIMES", "-Xcompiler", "-fPIC", "-shared", "-o",
         lib_path, source], capture_output=True, text=True)
    if built.returncode != 0:
        fail(f"nvcc -DFQD_PHASE_TIMES failed:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(lib_path)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.fqd_pairs_within_packed.argtypes = [
        p, p, p, i, i, i, i, i64, i64, i, i, i, p]
    lib.fqd_pairs_within_packed.restype = i
    lib.fqd_phase_times_read.argtypes = [p]
    lib.fqd_phase_times_read.restype = i
    k, s, length, d = 2048, 128, 50, 1
    l_pad, a_pad = hk._pad_dims(length, 5)
    batch = bucket_batch(np.random.default_rng(2024), k, s, length,
                         l_pad).to(dev)
    out = torch.empty((k, s, s // 8), dtype=torch.uint8, device=dev)
    for _ in range(5):
        status = lib.fqd_pairs_within_packed(
            batch.data_ptr(), batch.data_ptr(), out.data_ptr(), k, s, s,
            l_pad, s * l_pad, s * l_pad, length, d, a_pad,
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            fail(f"instrumented launch returned CUDA error {status}")
    torch.cuda.synchronize()
    if not torch.equal(out, hk.pairs_within_plain(batch, batch, length, d,
                                                  a_pad)):
        fail("instrumented kernel disagrees with its plain version")
    times = np.zeros((512, 8, 8), dtype=np.int64)
    status = lib.fqd_phase_times_read(times.ctypes.data)
    if status != 0:
        fail(f"reading the phase times returned CUDA error {status}")
    blocks = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    marks = times[:blocks, 1:7].reshape(blocks, -1)
    spans = np.diff(marks, axis=1)[:, :40].reshape(blocks, 5, 8)
    emit({"phase": "phases", "case": f"S={s} K={k} L={length} d={d}",
          "blocks": blocks, "stages_per_block": k / blocks,
          "median_ns": {name: float(np.median(spans[:, :, j]))
                        for j, name in enumerate(PHASES)},
          "stage_median_ns": float(np.median(
              times[:blocks, 2:7, 0] - times[:blocks, 1:6, 0]))})
    return 0


# Builds of csrc/edit.cu for --edit-variants: (label, nvcc flags, whether
# its answers are the kernel's).
EDIT_VARIANTS = (
    ("library build: diagonals, 16 symbols a step", [], True),
    ("every pair staged before its lengths arrive",
     ["-DFQD_EDIT_STAGE_ALL"], True),
    ("band scan behind the same staging", ["-DFQD_EDIT_BAND_SCAN"], True),
    ("stops after the answers that need no DP",
     ["-DFQD_EDIT_STOP_AFTER=1"], False),
    ("stops after staging", ["-DFQD_EDIT_STOP_AFTER=2"], False),
)


def run_edit_variants(dev) -> int:
    """Where the edit kernel's time goes, and the candidates it was
    chosen from: builds ``csrc/edit.cu`` once per entry of
    ``EDIT_VARIANTS`` into a library of its own, all in parallel, and
    times each (CUDA-graph replays, all variants in turn and then in
    reverse) on the indexed main shape and on the paired batches at d =
    1, 2 and 6.  A variant that computes the whole function must equal
    the plain version."""
    import ctypes

    from fastqdedup_tpu_torch.ops import edit_kernels as ek
    from fastqdedup_tpu_torch.ops import kernel_lib

    build = os.path.dirname(kernel_lib.LIB_PATH)
    os.makedirs(build, exist_ok=True)
    source = os.path.join(HERE, "fastqdedup_tpu_torch", "csrc", "edit.cu")
    paths = [os.path.join(build, f"libfqd_edit_variant{n}.so")
             for n in range(len(EDIT_VARIANTS))]
    procs = [subprocess.Popen(
        [kernel_lib._nvcc(), *kernel_lib._ARCH, "-std=c++17", "-O3", *flags,
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", path,
         source], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for (_, flags, _), path in zip(EDIT_VARIANTS, paths)]
    libs = []
    for (label, flags, _), proc, path in zip(EDIT_VARIANTS, procs, paths):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc {' '.join(flags)} failed:\n{log}")
        emit({"phase": "edit-variants", "variant": label, "flags": flags,
              "ptxas": [row for row in log.splitlines()
                        if "registers" in row or "spill" in row]})
        lib = ctypes.CDLL(path)
        ptr = ctypes.c_void_p
        lib.fqd_banded_within_edit.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ptr]
        lib.fqd_banded_within_edit.restype = ctypes.c_int
        libs.append(lib)

    rng = np.random.default_rng(2024)
    p = 1 << 16
    keys, lens, ci, cj = indexed_edit_batch(rng, p, dev)
    cases = [("indexed: P=65536 into n=400000 keys Lp=112 d=1",
              (keys, lens, keys, lens, ci, cj), 1)]
    for d in (1, 2, 6):
        a, la, b, lb = (t.to(dev) for t in edit_pairs(rng, p, d))
        cases.append((f"P={p} Lp=112 lengths 0/99-101 d={d}",
                      (a, la, b, lb, None, None), d))
    for case, (a, la, b, lb, ci, cj), d in cases:
        if ci is None:
            want = ek.banded_within_plain(a, la, b, lb, d)
        else:
            want = ek.banded_within_plain(a[ci.long()], la[ci.long()],
                                          b[cj.long()], lb[cj.long()], d)
        out = torch.empty((p, 1), dtype=torch.bool, device=dev)

        def launch(lib):
            status = lib.fqd_banded_within_edit(
                a.data_ptr(), la.data_ptr(), b.data_ptr(), lb.data_ptr(),
                None if ci is None else ci.data_ptr(),
                None if cj is None else cj.data_ptr(), out.data_ptr(), p,
                a.shape[1], d, torch.cuda.current_stream().cuda_stream)
            if status != 0:
                fail(f"variant launch returned CUDA error {status}")

        for (label, _, whole), lib in zip(EDIT_VARIANTS, libs):
            out.zero_()
            launch(lib)
            torch.cuda.synchronize()
            if whole and not torch.equal(out, want):
                fail(f"{label}, {case}: disagrees with the plain version")
        order = list(range(len(libs)))
        turns = [[statistics.median(graph_ms(lambda: launch(libs[n])))
                  for n in order]]
        back = [statistics.median(graph_ms(lambda: launch(libs[n])))
                for n in reversed(order)]
        turns.append(back[::-1])
        for n, (label, _, whole) in enumerate(EDIT_VARIANTS):
            emit({"phase": "edit-variants", "case": case, "variant": label,
                  "whole_function": whole,
                  "ms_turns": [turns[0][n], turns[1][n]]})
    return 0


def ptxas_lines(log: str, kernel: str) -> list:
    """What ``nvcc -Xptxas -v`` says of each kernel whose mangled name
    holds ``kernel``: its registers, stack and spills."""
    rows, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and kernel in name and ("registers" in line
                                          or "spill" in line):
            rows.append(f"{name}: {line.strip()}")
    return rows


def run_rowwise_variants(dev, other_sources) -> int:
    """The pair-list kernel's indexed entry against other trees' builds of
    it, in turns: builds ``csrc/hamming.cu`` and each file of
    ``other_sources`` (another tree's ``hamming.cu``, its own directory
    for includes) into a library of its own, all in parallel.  Then
    times the indexed entry of each at the main case (2^21 pairs into
    400k rows, 13 lanes) and at ``ROUTE_BATCHES``, and the paired entry
    at 2^21 pairs of 13 lanes, all libraries in turn and then in reverse
    (CUDA-graph replays, L2-warm), beside the empty kernel's floor.
    Every build must equal the plain version."""
    import ctypes

    from fastqdedup_tpu_torch.ops import hamming_kernels as hk
    from fastqdedup_tpu_torch.ops import kernel_lib

    build = os.path.dirname(kernel_lib.LIB_PATH)
    os.makedirs(build, exist_ok=True)
    sources = [("library build", os.path.join(
        HERE, "fastqdedup_tpu_torch", "csrc", "hamming.cu"))]
    sources += [(f"other tree: {path}", os.path.abspath(path))
                for path in other_sources]
    paths = [os.path.join(build, f"libfqd_rowwise_variant{n}.so")
             for n in range(len(sources))]
    procs = [subprocess.Popen(
        [kernel_lib._nvcc(), *kernel_lib._ARCH, "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", path,
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for (_, src), path in zip(sources, paths)]
    libs = []
    for (label, _), proc, path in zip(sources, procs, paths):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc {label} failed:\n{log}")
        emit({"phase": "rowwise-variants", "variant": label,
              "ptxas": ptxas_lines(log, "rowwise")})
        lib = ctypes.CDLL(path)
        ptr, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.fqd_rowwise_within_packed.argtypes = [ptr, ptr, ptr, i64, i, i,
                                                  ptr]
        lib.fqd_rowwise_within_packed_indexed.argtypes = [
            ptr, ptr, ptr, ptr, i64, i, i, ptr]
        libs.append(lib)

    rng = np.random.default_rng(2024)
    d = 1
    cases = [("T: indexed, P=2097152 into n=400000 rows lanes=13",
              rowwise_indexed_batch(rng, 1 << 21, 400_000, 13))]
    for label, n, lanes, size, buckets in ROUTE_BATCHES:
        batch = rowwise_bucket_batch(rng, n, lanes, size, buckets)
        cases.append((f"{label}: indexed, P={len(batch[1])} into n={n} "
                      f"rows lanes={lanes}", batch))
    cases.append(("paired: P=2097152 lanes=13",
                  rowwise_pair(rng, 1 << 21, 13)))
    emit({"phase": "rowwise-variants", "case": "empty kernel, 1 block",
          "ms": empty_ms()})
    for case, batch in cases:
        batch = [t.to(dev) for t in batch]
        paired = len(batch) == 2
        p = batch[0].shape[0] if paired else batch[1].shape[0]
        lanes = batch[0].shape[1]
        out = torch.empty((p, 1), dtype=torch.bool, device=dev)
        if paired:
            packed = gi = gj = None
            want = hk.rowwise_within_plain(batch[0], batch[1], d)
        else:
            packed, gi, gj = batch
            want = hk.rowwise_within_plain(packed.index_select(0, gi),
                                           packed.index_select(0, gj), d)

        def launch(lib):
            stream = torch.cuda.current_stream().cuda_stream
            if paired:
                status = lib.fqd_rowwise_within_packed(
                    batch[0].data_ptr(), batch[1].data_ptr(),
                    out.data_ptr(), p, lanes, d, stream)
            else:
                status = lib.fqd_rowwise_within_packed_indexed(
                    packed.data_ptr(), gi.data_ptr(), gj.data_ptr(),
                    out.data_ptr(), p, lanes, d, stream)
            if status != 0:
                fail(f"variant launch returned CUDA error {status}")

        for (label, _), lib in zip(sources, libs):
            out.zero_()
            launch(lib)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                fail(f"{label}, {case}: disagrees with the plain version")
        forth = [statistics.median(graph_ms(lambda: launch(lib)))
                 for lib in libs]
        back = [statistics.median(graph_ms(lambda: launch(lib)))
                for lib in reversed(libs)][::-1]
        cost = rowwise_cost(p, lanes) if paired else \
            rowwise_cost(p, lanes, distinct_rows(gi, gj))
        bound = kernel_bound(cost)
        for (label, _), ms in zip(sources, zip(forth, back)):
            emit({"phase": "rowwise-variants", "case": case,
                  "variant": label, "ms_turns": list(ms),
                  "bound_ms": bound["bound_ms"], "bytes": bound["bytes"],
                  "share_of_bound": bound["bound_ms"] / statistics.median(
                      ms)})
        del batch, out, want, packed, gi, gj
    return 0


def run_pair_list_batches(names) -> int:
    """The pair-list route's launches in one run of each named input on
    the card (sha256 checked): per launch of the indexed entry its pairs,
    the resident rows and lanes of its matrix, the distinct rows its
    pairs read, and the size and count of the buckets whose triu pairs
    it verifies (one size a batch, ``ops.bucket._small_bucket_candidates``);
    then per input the launches, the pairs, the bucket sizes and the
    largest batch.  Host-side counts: no time is measured."""
    from fastqdedup_tpu_torch.ops import bucket

    os.environ["FASTQDEDUP_TORCH_DEVICE"] = "cuda"
    workdir = tempfile.mkdtemp(
        prefix="batches_", dir=os.path.join(HERE, "fastqdedup_tpu_torch",
                                            "build"))
    inner_candidates = bucket._small_bucket_candidates
    inner_launch = bucket.rowwise_within_packed_indexed
    try:
        files = generate_files(workdir, files_of(names))
        for name in names:
            batches, launches = [], []

            def candidates(order, starts, selected, size, *args, **kwargs):
                for gi, gj in inner_candidates(order, starts, selected,
                                               size, *args, **kwargs):
                    batches.append((int(size), len(gi) * 2 //
                                    (size * (size - 1))))
                    yield gi, gj

            def launch(packed, gi, gj, d):
                launches.append({
                    "pairs": int(gi.shape[0]), "rows": int(packed.shape[0]),
                    "lanes": int(packed.shape[1]),
                    "distinct_rows": distinct_rows(gi, gj),
                    "bucket_size": batches[-1][0],
                    "buckets": batches[-1][1]})
                return inner_launch(packed, gi, gj, d)

            bucket._small_bucket_candidates = candidates
            bucket.rowwise_within_packed_indexed = launch
            try:
                run_pipeline(workdir, name, files, name,
                             phase="pair-list-batches")
            finally:
                bucket._small_bucket_candidates = inner_candidates
                bucket.rowwise_within_packed_indexed = inner_launch
            largest = max(launches, key=lambda x: x["pairs"], default=None)
            sizes = [x["bucket_size"] for x in launches]
            emit({"phase": "pair-list-batches", "input": name,
                  "launches": len(launches),
                  "pairs": sum(x["pairs"] for x in launches),
                  "rows": sorted({x["rows"] for x in launches}),
                  "lanes": sorted({x["lanes"] for x in launches}),
                  "bucket_sizes": [min(sizes), max(sizes)] if sizes else [],
                  "largest": largest, "every_launch": launches})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


def run_repeats(repeats: int, names) -> int:
    """Each named input once, then ``repeats`` more times in this process;
    one line per input with every run's seconds and the repeats' median.
    No kernel is forced: the routes are the measured-rate ones."""
    os.environ["FASTQDEDUP_TORCH_DEVICE"] = "cuda"
    workdir = tempfile.mkdtemp(
        prefix="repeats_", dir=os.path.join(HERE, "fastqdedup_tpu_torch",
                                            "build"))
    try:
        files = generate_files(workdir, files_of(names))
        for name in names:
            lines = [run_pipeline(workdir, name, files, f"{name}-r{i}")
                     for i in range(repeats + 1)]
            seconds = [line["seconds"] for line in lines]
            emit({"phase": "repeats", "input": name,
                  "first_run_s": seconds[0], "repeat_runs_s": seconds[1:],
                  "median_repeat_s": statistics.median(seconds[1:]),
                  "launches_per_run": lines[-1]["launches"]})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


# --------------------------------------------------------------------- #
# --first-run: what the first run of a process pays


def timed_calls(module, name: str, seconds: dict) -> None:
    """Replace ``module.name`` by a wrapper that adds each call's time to
    ``seconds[name]``."""
    inner = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            seconds[name] = seconds.get(name, 0.0) + \
                time.perf_counter() - t0

    setattr(module, name, wrapper)


PROBES = ("measured_dispatch_seconds", "measured_h2d_rate",
          "measured_host_byte_rate")


def first_run_worker(started: float, spawned: str, variant: str,
                     name: str, workdir: str) -> int:
    """One fresh process of ``--first-run``.  ``isolated``: the parts of
    bringing the card up, one after the other in an idle process, no
    pipeline.  ``prewarm`` / ``no-prewarm``: the named run once, with the
    prewarm thread or with ``prewarm_async`` stubbed to start none; the
    probes and the library load are timed where the run reaches them."""
    import logging

    line = {"phase": "first-run", "variant": variant, "input": name,
            "interpreter_and_imports_s": started - float(spawned)}
    sys.path.insert(0, HERE)
    os.environ["FASTQDEDUP_TORCH_DEVICE"] = "cuda"
    from fastqdedup_tpu_torch import warmup
    from fastqdedup_tpu_torch.ops import bucket, kernel_lib
    from fastqdedup_tpu_torch.runtime import device

    t_start = time.perf_counter()
    if variant == "isolated":
        dev = device()
        steps = [("context_s", lambda: warmup._first_touch(dev)),
                 ("library_load_s", kernel_lib.library)]
        steps += [(f"{probe}_s", getattr(bucket, probe)) for probe in PROBES]
        steps += [
            ("first_hamming_launches_s",
             lambda: warmup._launch_hamming(dev, 100, 5, 1)),
            ("first_edit_launches_s",
             lambda: warmup._launch_edit(dev, 100, 1))]
        for key, fn in steps:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            line[key] = time.perf_counter() - t0
        line["whole_s"] = time.perf_counter() - t_start
        emit(line)
        return 0

    in_situ: dict = {}
    for probe in PROBES:
        timed_calls(bucket, probe, in_situ)
    from fastqdedup_tpu_torch.ops import edit_kernels, hamming_kernels
    for module in (kernel_lib, hamming_kernels, edit_kernels):
        timed_calls(module, "library", in_situ)
    # The prewarm thread's steps but the library's load, which
    # ``in_run_s`` holds: the context and the first launches.
    prewarm_steps: dict = {}
    if variant == "no-prewarm":
        warmup.prewarm_async = lambda *args, **kwargs: None
    else:
        for step in ("_first_touch", "_launch_hamming", "_launch_edit"):
            timed_calls(warmup, step, prewarm_steps)
    marks = []

    class Marks(logging.Handler):
        def emit(self, record):
            marks.append((time.perf_counter(), record.getMessage()))

    logger = logging.getLogger("fastqdedup")
    logger.setLevel(logging.INFO)
    logger.addHandler(Marks())
    with open(os.path.join(workdir, "files.json")) as f:
        files = json.load(f)
    t0 = time.perf_counter()
    run = run_pipeline(workdir, name, files,
                       f"{name}-{variant}-{os.getpid()}")
    ends = {word: t for t, message in marks
            for word in ("Processed", "Found", "Filtered")
            if message.startswith(word)}
    if len(ends) != 3:
        fail(f"first-run: pass marks missing in {marks}")
    line.update({
        "pass1_s": ends["Processed"] - t0,
        "pass2_s": ends["Found"] - ends["Processed"],
        "pass3_s": ends["Filtered"] - ends["Found"],
        "run_s": run["seconds"],
        "whole_s": started - float(spawned) + time.perf_counter() - t_start,
        "in_run_s": in_situ,
        "prewarm_thread_s": prewarm_steps or None,
        "launches": run["launches"],
        "warmup_launches": dict(kernel_lib.WARMUP_LAUNCHES),
        "sha256_held": run["sha256"] == run["expected_sha256"]})
    emit(line)
    return 0


def run_first_runs(names) -> int:
    """``--first-run NAME...``: each named run once in a fresh process,
    with the prewarm thread, without, without, with; and one process
    that times the parts of bringing the card up in isolation.  The
    kernel library is built before (a first build is the ``build``
    line's seconds)."""
    workdir = tempfile.mkdtemp(
        prefix="first_", dir=os.path.join(HERE, "fastqdedup_tpu_torch",
                                          "build"))
    try:
        files = generate_files(workdir, files_of(names))
        with open(os.path.join(workdir, "files.json"), "w") as f:
            json.dump(files, f)
        # One run here first, so that no child builds the native ingest
        # library or finds its input outside the page cache.
        run_pipeline(workdir, names[0], files, "parent")
        jobs = [("isolated", "none")] + [
            (variant, name) for name in names
            for variant in ("prewarm", "no-prewarm", "no-prewarm",
                            "prewarm")]
        for variant, name in jobs:
            done = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--first-run-worker", repr(time.time()), variant, name,
                 workdir], env=dict(os.environ, PYTHONPATH=HERE), cwd=HERE,
                capture_output=True, text=True, timeout=600)
            if done.returncode != 0:
                print(done.stderr[-4000:], file=sys.stderr)
                fail(f"first-run {variant} {name}: exit {done.returncode}")
            sys.stdout.write(done.stdout)
            sys.stdout.flush()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


# --------------------------------------------------------------------- #
# --packed-keys: the edit route's key matrix, nibble-packed or plain


def run_packed_keys(rounds: int, names) -> int:
    """``--packed-keys ROUNDS NAME...``: each named Levenshtein run in
    ``rounds`` rounds of plain, packed, packed, plain
    (``engine.PACK_KEY_MATRIX`` off and on), every sha256 checked.  The
    keys of these inputs are raw ASCII, which does not pack, so both
    forms get their entries as dense alphabet indices first (timed as
    ``encode_s``, paid by both).  Per run: the whole run, the edit-edge
    step, the packing and the verification batches; and once per input
    the copy of a matrix of the plain and of the packed size.  Every run,
    packed or not, must join its candidates on the card
    (``edit_window_hash`` launched)."""
    from fastqdedup_tpu_torch import engine
    from fastqdedup_tpu_torch.ops import edit as edit_ops
    from fastqdedup_tpu_torch.ops import edit_candidates

    os.environ["FASTQDEDUP_TORCH_DEVICE"] = "cuda"
    dev = torch.device("cuda", 0)
    stats: dict = {}
    shape: dict = {}
    for fn in ("pack_nibble_rows", "edit_verify_indexed"):
        timed_calls(edit_ops, fn, stats)
    inner = engine._edit_edges_entries

    def dense_entries(entries, n, max_distance, shard=(0, 1)):
        t0 = time.perf_counter()
        present = np.zeros(256, dtype=bool)
        for _, matrix, _ in entries:
            present |= np.bincount(matrix.reshape(-1), minlength=256) > 0
        lut = (np.cumsum(present) - 1).astype(np.uint8)
        dense = [(length, lut[matrix], idx)
                 for length, matrix, idx in entries]
        t1 = time.perf_counter()
        out = inner(dense, n, max_distance, shard)
        stats["encode_s"] = t1 - t0
        stats["edit_edges_s"] = time.perf_counter() - t1
        shape["n"] = n
        shape["width"] = -(-max(length for length, _, _ in entries)
                           // 16) * 16
        return out

    engine._edit_edges_entries = dense_entries
    workdir = tempfile.mkdtemp(
        prefix="packed_", dir=os.path.join(HERE, "fastqdedup_tpu_torch",
                                           "build"))
    try:
        files = generate_files(workdir, files_of(names))
        for name in names:
            if not INPUTS[name][4]:
                fail(f"--packed-keys: {name!r} is not a Levenshtein run")
            run_pipeline(workdir, name, files, f"{name}-first")
            rows = {False: [], True: []}
            for turn in range(rounds):
                for packed in (False, True, True, False):
                    engine.PACK_KEY_MATRIX = packed
                    stats.clear()
                    joins = edit_candidates.LAUNCHES["edit_window_hash"]
                    line = run_pipeline(workdir, name, files,
                                        f"{name}-t{turn}-p{int(packed)}")
                    if edit_candidates.LAUNCHES["edit_window_hash"] \
                            == joins:
                        fail(f"--packed-keys {name} packed={packed}: the "
                             f"candidates were not joined on the card")
                    rows[packed].append({"run_s": line["seconds"],
                                         **stats})
            engine.PACK_KEY_MATRIX = False
            copies = {}
            for label, width in (("plain", shape["width"]),
                                 ("packed", shape["width"] // 2)):
                matrix = torch.zeros((shape["n"], width), dtype=torch.uint8)
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    matrix.to(dev)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                copies[label] = {"bytes": matrix.numel(), "copy_s": times}
            for packed in (False, True):
                keys = sorted({k for row in rows[packed] for k in row})
                emit({"phase": "packed-keys", "input": name,
                      "packed": packed, "runs": len(rows[packed]),
                      "median_s": {k: statistics.median(
                          row.get(k, 0.0) for row in rows[packed])
                          for k in keys},
                      "run_s": [row["run_s"] for row in rows[packed]],
                      "copy": copies["packed" if packed else "plain"]})
    finally:
        engine._edit_edges_entries = inner
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


# --------------------------------------------------------------------- #
# The async phase, --sync-counts and --key-upload: pass 2's transfers


# About 10 ms of spinning at the H100's clock: far longer than the host
# takes to queue the next batch, so a result read before its copy landed,
# or a staging buffer handed out again before its copy read it, shows.
DELAY_CYCLES = 20_000_000


def sync_sites(fn) -> dict:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and
    count each synchronizing CUDA call it makes, by the innermost line of
    the port's package on the caller's stack (``"ops/bucket.py:NNN"``),
    or ``"elsewhere"``."""
    import traceback
    import warnings

    package = os.path.join(HERE, "fastqdedup_tpu_torch") + os.sep
    sites: dict = {}
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        previous = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if "synchronizing CUDA operation" not in str(message):
                return previous(message, category, filename, lineno, file,
                                line)
            site = "elsewhere"
            for frame in reversed(traceback.extract_stack()[:-1]):
                if frame.filename.startswith(package):
                    site = (f"{os.path.relpath(frame.filename, package)}:"
                            f"{frame.lineno}")
                    break
            sites[site] = sites.get(site, 0) + 1

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def sync_counts(workdir: str, files: dict, names, phase: str) -> dict:
    """One run of each named input under :func:`sync_sites` (the rate
    probes of pass 2 already measured by an earlier run in this
    process); per input the synchronizing calls made in ``ops/bucket.py``
    and ``ops/edit.py`` (and ``ops/transfer.py``, where results are
    waited for), every site, and the run's launches."""
    counts = {}
    for name in names:
        lines = []
        sites = sync_sites(lambda: lines.append(run_pipeline(
            workdir, name, files, f"{name}-sync", phase=phase)))
        by_file = {path: sum(n for site, n in sites.items()
                             if site.startswith(path + ":"))
                   for path in ("ops/bucket.py", "ops/edit.py",
                                "ops/transfer.py")}
        counts[name] = by_file
        emit({"phase": phase, "input": name, "syncs": by_file,
              "syncs_total": sum(sites.values()), "sites": sites,
              "launches": lines[0]["launches"]})
    return counts


def delayed(module, name: str):
    """Make ``module.name`` (an upload) queue :data:`DELAY_CYCLES` of
    spinning on the current stream before its copy; returns the undo."""
    inner = getattr(module, name)

    def slow(host, dev):
        with torch.cuda.device(dev):
            torch.cuda._sleep(DELAY_CYCLES)
        return inner(host, dev)

    setattr(module, name, slow)
    return lambda: setattr(module, name, inner)


def delayed_matrix(rng, length: int = 50) -> np.ndarray:
    """Unique uint8 keys for the delayed-stream check: 3,000 keys with
    three copies each one symbol off in the second half (buckets of four
    on the first segment: the pair-list route), and 24 families of 300
    keys sharing their first half (buckets for the all-pairs kernel)."""
    half = np.arange(length // 2, length)

    def near(rows):
        out = rows.copy()
        pos = rng.choice(half, len(rows))
        at = np.arange(len(rows))
        out[at, pos] = (out[at, pos] + rng.integers(1, 5, len(rows))) % 5
        return out

    base = rng.integers(0, 5, (3000, length), dtype=np.uint8)
    rows = [base] + [near(base) for _ in range(3)]
    for _ in range(24):
        rows.append(near(np.repeat(
            rng.integers(0, 5, (1, length), dtype=np.uint8), 300, axis=0)))
    return np.unique(np.concatenate(rows), axis=0)


def check_delayed_stream() -> dict:
    """Every upload of the bucket route, the pair-list route and the edit
    verification delayed on the device (:func:`delayed`) while the host
    runs ahead: the card's pairs and answers must equal the CPU device's
    (plain versions) exactly.  A result read before its copy landed, or a
    pinned staging block reused before its copy read it, would differ.
    Several bucket batches are in flight at once (two buckets a batch)."""
    from fastqdedup_tpu_torch.ops import bucket
    from fastqdedup_tpu_torch.ops import edit as edit_ops

    rng = np.random.default_rng(12)
    matrix = delayed_matrix(rng)
    knobs = {"FASTQDEDUP_DISPATCH_S": "1e-9", "FASTQDEDUP_H2D_RATE": "1e15",
             "FASTQDEDUP_HOST_RATE": "1.0"}
    per_call = bucket._buckets_per_call
    bucket._buckets_per_call = lambda size_class: 2
    results, counts = {}, {}
    try:
        for dev in ("cpu", "cuda"):
            with environment({**knobs, "FASTQDEDUP_TORCH_DEVICE": dev}):
                undo = delayed(bucket, "upload") if dev == "cuda" \
                    else (lambda: None)
                before = launch_counts()
                t0 = time.perf_counter()
                try:
                    results[dev] = bucket.hamming_neighbor_pairs_bucketed(
                        matrix, 5, 1)
                finally:
                    undo()
                seconds = time.perf_counter() - t0
                after = launch_counts()
            counts[dev] = {k: after[k] - before[k] for k in after}
            emit({"phase": "async", "check": "delayed stream, bucket and "
                  "pair-list routes", "device": dev, "keys": len(matrix),
                  "pairs": len(results[dev][0]), "seconds": seconds,
                  "launches": counts[dev]})
    finally:
        bucket._buckets_per_call = per_call
    for got, want in zip(results["cuda"], results["cpu"]):
        if not np.array_equal(got, want):
            fail("async: delayed bucket and pair-list batches gave other "
                 "pairs than the CPU device")
    for kernel in ("bucket_within_packed", "rowwise_within_packed"):
        if counts["cuda"][kernel] < 2:
            fail(f"async: the delayed run launched {kernel} "
                 f"{counts['cuda'][kernel]} times, not several")
    # The edit route: index batches of one resident key matrix.
    dev = torch.device("cuda", 0)
    keys, lens, ci, cj = indexed_edit_batch(rng, 1 << 16, torch.device("cpu"))
    keys_dev, lens_dev = keys.to(dev), lens.to(dev)
    ci_np, cj_np = ci.numpy(), cj.numpy()
    undo = delayed(edit_ops, "upload")
    try:
        got = [edit_ops.edit_verify_indexed(keys_dev, lens_dev,
                                            ci_np[s:s + 8192],
                                            cj_np[s:s + 8192], 1)
               for s in range(0, len(ci_np), 8192)]
    finally:
        undo()
    want = edit_ops.edit_verify_indexed(keys, lens, ci_np, cj_np, 1)
    if not np.array_equal(np.concatenate(got), want):
        fail("async: delayed edit verification gave other answers than "
             "the CPU device")
    emit({"phase": "async", "check": "delayed stream, edit verification",
          "batches": len(got), "pairs": len(want),
          "true_answers": int(want.sum())})
    return counts["cuda"]


def run_sync_counts(names) -> int:
    """``--sync-counts NAME...``: each named input once to measure the
    rate probes, then once under :func:`sync_sites`.  The function also
    runs on an older checkout of the port (copy this script over its
    own): the two trees' counts in one call."""
    os.environ["FASTQDEDUP_TORCH_DEVICE"] = "cuda"
    workdir = tempfile.mkdtemp(
        prefix="sync_", dir=os.path.join(HERE, "fastqdedup_tpu_torch",
                                         "build"))
    try:
        files = generate_files(workdir, files_of(names))
        for name in names:
            run_pipeline(workdir, name, files, f"{name}-first")
        sync_counts(workdir, files, names, "sync-counts")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


def run_key_upload(rounds: int, names) -> int:
    """``--key-upload ROUNDS NAME...``: each named Levenshtein run in
    ``rounds`` rounds of the key matrix sent pinned, from the engine's
    thread (``engine._start_key_upload``), from the thread, pinned,
    every sha256 checked.  The pinned form, which the engine does not
    use, builds both arrays in pinned host memory and copies them
    ``non_blocking`` on the current stream.  Per run: the host seconds
    from entering the edit-edge step to the first verification batch
    (``to_first_verify_s``), within them the enqueue of the copy
    (``upload_start_s``) and the wait for it (``upload_wait_s``), the
    edit-edge step and the whole run."""
    from fastqdedup_tpu_torch import engine
    from fastqdedup_tpu_torch.ops import edit as edit_ops
    from fastqdedup_tpu_torch.ops.transfer import staging, upload

    def pinned(keys: np.ndarray, lens: np.ndarray, dev):
        tensors = []
        for array in (keys, lens):
            host = staging(array.shape, torch.from_numpy(array).dtype, dev)
            host.numpy()[...] = array
            tensors.append(upload(host, dev))
        return lambda: tuple(tensors)

    os.environ["FASTQDEDUP_TORCH_DEVICE"] = "cuda"
    marks: dict = {}
    inner_edges = engine._edit_edges_entries
    inner_start = engine._start_key_upload
    inner_verify = edit_ops.edit_verify_indexed
    forms = {"pinned": pinned, "thread": inner_start}

    def edges(*args, **kwargs):
        marks["enter"] = time.perf_counter()
        out = inner_edges(*args, **kwargs)
        marks["edges_s"] = time.perf_counter() - marks["enter"]
        return out

    def timed_start(form):
        def start(*args):
            t0 = time.perf_counter()
            result = forms[form](*args)
            marks["upload_start_s"] = time.perf_counter() - t0

            def wait():
                t1 = time.perf_counter()
                tensors = result()
                marks["upload_wait_s"] = time.perf_counter() - t1
                return tensors

            return wait

        return start

    def verify(*args, **kwargs):
        marks.setdefault("first_verify", time.perf_counter())
        return inner_verify(*args, **kwargs)

    engine._edit_edges_entries = edges
    edit_ops.edit_verify_indexed = verify
    workdir = tempfile.mkdtemp(
        prefix="keys_", dir=os.path.join(HERE, "fastqdedup_tpu_torch",
                                         "build"))
    try:
        files = generate_files(workdir, files_of(names))
        for name in names:
            if not INPUTS[name][4]:
                fail(f"--key-upload: {name!r} is not a Levenshtein run")
            run_pipeline(workdir, name, files, f"{name}-first")
            rows: dict = {form: [] for form in forms}
            for turn in range(rounds):
                for form in ("pinned", "thread", "thread", "pinned"):
                    engine._start_key_upload = timed_start(form)
                    marks.clear()
                    line = run_pipeline(workdir, name, files,
                                        f"{name}-t{turn}-{form}")
                    rows[form].append({
                        "run_s": line["seconds"],
                        "edges_s": marks["edges_s"],
                        "to_first_verify_s":
                            marks["first_verify"] - marks["enter"],
                        "upload_start_s": marks["upload_start_s"],
                        "upload_wait_s": marks["upload_wait_s"]})
            for form, runs in rows.items():
                emit({"phase": "key-upload", "input": name, "form": form,
                      "runs": runs, "median_s": {
                          key: statistics.median(run[key] for run in runs)
                          for key in runs[0]}})
    finally:
        engine._edit_edges_entries = inner_edges
        engine._start_key_upload = inner_start
        edit_ops.edit_verify_indexed = inner_verify
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "fastqdedup_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(fastqdedup_tpu_torch/ not found beside it)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fastqdedup_tpu_torch.ops import kernel_lib

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib, log = kernel_lib.build_kernels()
    emit({"phase": "build", "library": os.path.relpath(lib, HERE),
          "seconds": time.perf_counter() - t0,
          "log": [line for line in log.splitlines() if line.strip()]})

    if argv[:1] == ["--repeats"]:
        return run_repeats(int(argv[1]), argv[2:])
    if argv[:1] == ["--first-run"]:
        return run_first_runs(argv[1:])
    if argv[:1] == ["--packed-keys"]:
        return run_packed_keys(int(argv[1]), argv[2:])
    if argv[:1] == ["--sync-counts"]:
        return run_sync_counts(argv[1:])
    if argv[:1] == ["--key-upload"]:
        return run_key_upload(int(argv[1]), argv[2:])
    if argv == ["--phases"]:
        return run_phases(dev)
    if argv == ["--edit-variants"]:
        return run_edit_variants(dev)
    if argv[:1] == ["--pair-list-batches"]:
        return run_pair_list_batches(argv[1:])
    if argv[:1] == ["--rowwise-variants"]:
        return run_rowwise_variants(dev, argv[1:])
    if argv == ["--deflate"]:
        return run_deflate(dev)
    if argv == ["--edit-candidates"]:
        time_edit_candidates(dev, check_edit_candidates(dev))
        return 0
    summary = check_kernels(dev)
    summary["deflate_members"] = check_deflate(dev)
    summary.update(check_edit_candidates(dev))
    time_edit_candidates(dev, summary)
    if argv == ["--kernels"]:
        return 0
    oracle_geometries = check_against_oracles(dev)

    os.environ["FASTQDEDUP_TORCH_DEVICE"] = "cuda"
    check_warmup()
    from fastqdedup_tpu_torch.ops.bucket import measured_h2d_rate

    # The rate the Hamming routes weigh copies with.
    emit({"phase": "route", "measured_h2d_bytes_per_s": measured_h2d_rate()})
    workdir = tempfile.mkdtemp(
        prefix="smoke_", dir=os.path.join(HERE, "fastqdedup_tpu_torch",
                                          "build"))
    try:
        t0 = time.perf_counter()
        files = generate_files(workdir, files_of(INPUTS))
        emit({"phase": "generate", "files": sorted(files),
              "seconds": time.perf_counter() - t0})

        def run(name, tag, overrides=None):
            return run_pipeline(workdir, name, files, tag, overrides)

        def run_until_launched(kernel, name, overrides):
            line = run(name, name)
            if line["launches"][kernel] == 0:
                emit({"phase": "route", "note":
                      f"measured-rate routing did not launch {kernel} on "
                      f"input {name!r}; forcing it", "forced": overrides})
                if run(name, f"{name}-forced",
                       overrides)["launches"][kernel] == 0:
                    fail(f"forced run of {name!r} did not launch {kernel}")
            return line

        # The Hamming path: counts from 0, read after its runs.  The
        # single-process seconds of default, umi12 and edit are the
        # baseline of the 2-process runs in phase 9; the umi12 edge list
        # feeds phase 10.
        reset_launch_counts()
        run("default", "default-first")
        single = {"default": run("default", "default-repeat")["seconds"]}
        forced_runs = (
            ("rowwise_within_packed", "dense", {
                "FASTQDEDUP_DISPATCH_S": "1e-9",
                "FASTQDEDUP_H2D_RATE": "1e15",
                "FASTQDEDUP_HOST_RATE": "1.0"}),
            ("bucket_within_packed", "umi12", {
                "FASTQDEDUP_DISPATCH_S": "1e-9",
                "FASTQDEDUP_H2D_RATE": "1e-9"}),
            ("within_tile_packed", "small", {
                "FASTQDEDUP_DEVICE_CUTOVER_S": "0"}),
        )
        umi12_edges: list = []
        for kernel, name, overrides in forced_runs:
            with capture_edges(umi12_edges if name == "umi12" else []):
                line = run_until_launched(kernel, name, overrides)
            single[name] = line["seconds"]
        hamming_launches = launch_counts()
        # The Levenshtein path: counts from 0 again.  On the card every
        # candidate batch goes to the kernel.
        reset_launch_counts()
        for name in ("edit", "indel"):
            line = run(name, name)
            single[name] = line["seconds"]
            if line["launches"]["banded_within_edit_distance"] == 0:
                fail(f"{name}: the pipeline did not launch "
                     f"banded_within_edit_distance")
        edit_launches = launch_counts()
        # The documented configurations, counts from 0 once more.
        config_launches = run_configs(workdir, files)
        # The Trie API: a second entry point of the Levenshtein path,
        # with counts of its own.
        check_trie_api()
        # Pass 2's asynchronous transfers: delayed uploads read nothing
        # early, and the synchronizing calls left in a run.
        t0 = time.perf_counter()
        check_delayed_stream()
        syncs = sync_counts(workdir, files, ("umi12", "dense"), "async")
        emit({"phase": "async", "seconds": time.perf_counter() - t0,
              "syncs": syncs})
        # Two processes, each counting from 0 before every run.
        distributed_launches = run_distributed(workdir, files, single)
        check_mesh(*max(umi12_edges, key=lambda e: len(e[1])))
        check_quality(workdir, files["default"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    by_path = {
        name: {"hamming": hamming_launches[name],
               "edit": edit_launches[name],
               "configs": config_launches[name],
               "distributed": distributed_launches.get(name, 0)}
        for name in KERNELS}
    for name, counts in by_path.items():
        for path in KERNEL_PATHS.get(name, ("hamming",)):
            if counts[path] == 0:
                fail(f"the {path} path never launched {name}")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "oracle_geometries": oracle_geometries.get(name, 0),
         **summary[name]}
        for name, (source, replaces) in KERNELS.items()]})
    for line in smi:
        print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--first-run-worker"]:
        sys.exit(first_run_worker(time.time(), *sys.argv[2:]))
    if sys.argv[1:2] == ["--distributed-worker"]:
        sys.exit(distributed_worker(int(sys.argv[2]), int(sys.argv[3]),
                                    sys.argv[4]))
    sys.exit(main(sys.argv[1:]))
