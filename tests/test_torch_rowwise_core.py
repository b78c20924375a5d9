"""The arithmetic of the port's indexed pair-list kernel, built for the
host.

``fastqdedup_tpu_torch/csrc/rowwise.cuh`` holds everything of
``rowwise_within_indexed_kernel`` (``csrc/hamming.cu``) but the loads and
the shuffles themselves: the group of threads a pair is shared by, which
pair a group takes at each step, which lanes of a row each thread reads,
the nibble fold and popcount of a lane, the transposed reduction and the
``<= d`` test.  It compiles as plain C++ too, so this file builds it
with the host's C++ compiler behind a shim that plays a warp of 32
threads in lock step (every shuffle reads the other threads' values of
the same step) and holds it against ``index_select`` +
``rowwise_within_plain`` (itself pinned to the Pallas kernel by
tests/test_torch_kernels.py).  Outputs are bools: exact equality.  Skips
where no C++ compiler is installed; the CUDA build of the same header is
held against the plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fastqdedup_tpu_torch.ops import hamming_kernels as hk
from fastqdedup_tpu_torch.ops import kernel_lib

SHIM = r"""
#include <cstdint>
#include <vector>
#include "rowwise.cuh"

using namespace fqd_rowwise;

// The transposed reduction of one group of g threads: values[t * g + s]
// is thread t's count of step s; afterwards values[t * g] is thread t's
// result.
static void reduce_group(std::vector<std::vector<int>>& count, int first,
                         int g) {
  std::vector<int> sent(g);
  for (int half = g / 2; half >= 1; half /= 2) {
    for (int j = 0; j < half; ++j) {
      for (int r = 0; r < g; ++r) {
        const std::vector<int>& v = count[first + r];
        sent[r] = reduce_send(v[j], v[j + half], reduce_mask(r, half));
      }
      for (int r = 0; r < g; ++r) {
        std::vector<int>& v = count[first + r];
        v[j] = reduce_keep(v[j], v[j + half], reduce_mask(r, half)) +
               sent[r ^ half];
      }
    }
  }
}

extern "C" void host_reduce(int g, int* values) {
  std::vector<std::vector<int>> count(g, std::vector<int>(g));
  for (int t = 0; t < g; ++t)
    for (int s = 0; s < g; ++s) count[t][s] = values[t * g + s];
  reduce_group(count, 0, g);
  for (int t = 0; t < g; ++t) values[t * g] = count[t][0];
}

// The indexed kernel, one warp's span of 32 pairs after another.
extern "C" int host_indexed(const uint32_t* packed, const int* gi,
                            const int* gj, uint8_t* out, long long p,
                            int lanes, int d) {
  const int g = group_size(lanes);
  if (kSpan % g) return 1;
  const int loads = loads_per_row(lanes, g);
  for (long long base = 0; base < p; base += kSpan) {
    int own_i[kSpan], own_j[kSpan];
    for (int t = 0; t < kSpan; ++t) {
      const bool mine = base + t < p;
      own_i[t] = mine ? gi[base + t] : 0;
      own_j[t] = mine ? gj[base + t] : 0;
    }
    std::vector<std::vector<int>> count(kSpan, std::vector<int>(g, 0));
    for (int t = 0; t < kSpan; ++t) {
      const int group = t / g, rank = t % g;
      for (int k = 0; k < loads; ++k) {
        const int lane = lane_of(rank, k, g);
        if (lane >= lanes) continue;
        for (int s = 0; s < g; ++s) {
          const int q = pair_of(group, s, g);  // the shuffles' source
          const uint32_t a = packed[(long long)own_i[q] * lanes + lane];
          const uint32_t b = packed[(long long)own_j[q] * lanes + lane];
          count[t][s] += lane_mismatches(a ^ b);
        }
      }
    }
    for (int first = 0; first < kSpan; first += g) {
      reduce_group(count, first, g);
    }
    for (int t = 0; t < kSpan && base + t < p; ++t) {
      out[base + t] = within(count[t][0], d) ? 1 : 0;
    }
  }
  return 0;
}
"""

# The widths the route launches (2, 13, 27), the edges of each group
# size (1, 2; 3, 4; 5, 16; 17, 32), and widths past 32 lanes, where a
# thread reads several lanes of a row.
LANES = [1, 2, 3, 4, 5, 8, 9, 13, 16, 17, 27, 32, 33, 40, 65]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    compiler = shutil.which("g++") or shutil.which("c++") \
        or shutil.which("clang++")
    if compiler is None:
        pytest.skip("needs a C++ compiler to build csrc/rowwise.cuh for "
                    "the host")
    work = tmp_path_factory.mktemp("rowwise_core")
    src = work / "shim.cpp"
    src.write_text(SHIM)
    lib_path = work / "librowwise_core.so"
    csrc = os.path.dirname(kernel_lib.sources()[0])
    subprocess.run([compiler, "-std=c++17", "-O1", "-fPIC", "-shared",
                    "-x", "c++", "-I", csrc, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr = ctypes.c_void_p
    lib.host_indexed.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_int]
    lib.host_indexed.restype = ctypes.c_int
    lib.host_reduce.argtypes = [ctypes.c_int, ptr]
    lib.host_reduce.restype = None
    return lib


def _indexed(host, packed, gi, gj, d):
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    gi = np.ascontiguousarray(gi, dtype=np.int32)
    gj = np.ascontiguousarray(gj, dtype=np.int32)
    out = np.zeros(len(gi), dtype=np.uint8)
    status = host.host_indexed(packed.ctypes.data, gi.ctypes.data,
                               gj.ctypes.data, out.ctypes.data, len(gi),
                               packed.shape[1], d)
    assert status == 0
    return out.astype(bool)[:, None]


def _plain(packed, gi, gj, d):
    rows = torch.from_numpy(np.ascontiguousarray(packed).view(np.int32))
    return hk.rowwise_within_plain(
        rows.index_select(0, torch.from_numpy(gi.astype(np.int64))),
        rows.index_select(0, torch.from_numpy(gj.astype(np.int64))),
        d).numpy()


def _near_rows(rng, n, lanes):
    """uint32 [n, lanes] nibble-packed rows in pairs 2k, 2k + 1 that
    differ in 0-4 nibbles; symbols 0-3, the last 4 nibbles pad (0xF)."""
    rows = rng.integers(0, 4, (n, 8 * lanes), dtype=np.uint32)
    rows[:, max(8 * lanes - 4, 1):] = 0xF
    rows[1::2] = rows[0:n - n % 2:2]
    for _ in range(4):
        hit = np.flatnonzero(rng.random(n) < 0.35) | 1
        hit = hit[hit < n]
        rows[hit, rng.integers(0, 8 * lanes, len(hit))] = rng.integers(
            0, 16, len(hit), dtype=np.uint32)
    return _pack(rows)


def _pack(symbols):
    n, width = symbols.shape
    shifts = (4 * np.arange(8, dtype=np.uint32))
    return (symbols.reshape(n, width // 8, 8) << shifts).sum(
        axis=2, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("lanes", LANES)
def test_host_core_matches_plain(host, lanes):
    """Neighbour rows 2k, 2k + 1 with 0-4 differing nibbles, random
    pairs, repeated and self pairs, rows 0 and n - 1; P off the span of
    32; d = 0 to 3."""
    rng = np.random.default_rng(700 + lanes)
    n, p = 600, 1000 + lanes
    packed = _near_rows(rng, n, lanes)
    gi = 2 * rng.integers(0, n // 2, p)
    gj = gi + 1
    far = rng.random(p) < 0.25
    gj[far] = rng.integers(0, n, int(far.sum()))
    gi[:5], gj[:5] = [0, n - 1, 7, 7, 0], [n - 1, 0, 7, 7, 0]
    gi[-3:], gj[-3:] = 3, 3
    for d in range(4):
        want = _plain(packed, gi, gj, d)
        np.testing.assert_array_equal(_indexed(host, packed, gi, gj, d),
                                      want)
        assert want.any() and not want.all()


@pytest.mark.parametrize("lanes", LANES)
def test_host_core_equal_pad_and_all_different_rows(host, lanes):
    """Equal rows (within at every d), rows that differ only in pad
    nibbles (as many mismatches as pad nibbles differ: the kernel gives
    pads no special case), rows that differ in every nibble."""
    rng = np.random.default_rng(lanes)
    symbols = rng.integers(0, 4, (4, 8 * lanes), dtype=np.uint32)
    pad = min(4, 8 * lanes)
    symbols[:, -pad:] = 0xF
    other_pad = symbols.copy()
    other_pad[:, -pad:] = rng.integers(4, 15, (4, pad), dtype=np.uint32)
    packed = np.concatenate([_pack(symbols), _pack(other_pad),
                             ~_pack(symbols)])
    gi = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3], dtype=np.int32)
    gj = gi + np.repeat([0, 4, 8], 4).astype(np.int32)
    for d in range(4):
        got = _indexed(host, packed, gi, gj, d)
        np.testing.assert_array_equal(got, _plain(packed, gi, gj, d))
        assert got[:4].all() and not got[8:].any()
        assert got[4:8].all() == (pad <= d)


@pytest.mark.parametrize("p", [1, 31, 32, 33, 257])
def test_host_core_span_edges(host, p):
    """P below, at and off the warp's span of 32, at 13 lanes (groups of
    8), 27 (groups of 32) and 2 (one thread a pair)."""
    rng = np.random.default_rng(p)
    for lanes in (2, 13, 27):
        packed = _near_rows(rng, 64, lanes)
        gi = rng.integers(0, 64, p).astype(np.int32)
        gj = (gi ^ 1).astype(np.int32)
        for d in (0, 1):
            np.testing.assert_array_equal(_indexed(host, packed, gi, gj, d),
                                          _plain(packed, gi, gj, d))


@pytest.mark.parametrize("lanes,size", [(13, 6), (2, 52), (27, 5), (5, 17),
                                        (2, 3), (40, 9), (16, 40)])
def test_host_core_bucket_ordered_pairs(host, lanes, size):
    """Pairs as the route emits them (every triu pair of each bucket,
    bucket after bucket: ``chip_smoke.rowwise_bucket_batch``): runs of
    one a row, rows read again and again."""
    import chip_smoke

    packed, gi, gj = chip_smoke.rowwise_bucket_batch(
        np.random.default_rng(size), 40 * size, lanes, size, 30)
    packed = packed.numpy().view(np.uint32)
    gi, gj = gi.numpy(), gj.numpy()
    for d in range(3):
        want = _plain(packed, gi, gj, d)
        np.testing.assert_array_equal(_indexed(host, packed, gi, gj, d),
                                      want)
        assert want.any() and not want.all()


@pytest.mark.parametrize("g", [1, 4, 8, 16, 32])
def test_transposed_reduction_leaves_step_r_at_rank_r(host, g):
    """After g - 1 exchanges thread r holds the group's sum of step r."""
    rng = np.random.default_rng(g)
    values = rng.integers(0, 256, (g, g)).astype(np.int32)
    got = values.copy()
    host.host_reduce(g, got.ctypes.data)
    np.testing.assert_array_equal(got[:, 0], values.sum(axis=0))
