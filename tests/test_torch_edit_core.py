"""The arithmetic of the port's CUDA edit kernel, built for the host.

``fastqdedup_tpu_torch/csrc/edit_lv.cuh`` holds everything of
``csrc/edit.cu`` but the copy of rows into shared memory: the answers
that need no DP, the four-symbols-a-step match scan and the
furthest-reaching-diagonals test.  It compiles as plain C++ too, so this
file builds it with the host's C++ compiler behind a per-pair shim that
lays rows out as the kernel does (its row pitches, noise wherever the
kernel copies nothing, a long b repeating its last byte) and holds it
against ``banded_within_plain`` (itself pinned to the Pallas kernel by
tests/test_torch_edit.py).  Outputs are bools: exact equality.  Skips
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

from fastqdedup_tpu_torch.ops import edit_kernels as ek
from fastqdedup_tpu_torch.ops import kernel_lib

SHIM = r"""
#include <cstdint>
#include <cstring>
#include <vector>
#include "edit_lv.cuh"

extern "C" int host_within(const uint8_t* a, const int* len_a,
                           const uint8_t* b, const int* len_b,
                           uint8_t* out, long long p, int length, int d,
                           int noise) {
  const bool dp = d < length;  // the launcher's rule
  const long long pitch_a = dp ? fqd_edit::a_pitch_words(length) : 4;
  const long long pitch_b = dp ? fqd_edit::b_pitch_words(length, d) : 4;
  // b's row follows a's, as in the kernel: a scan on a diagonal below 0
  // reads the words before b's row.
  std::vector<uint4> rows((pitch_a + pitch_b + 3) / 4 + 1);
  uint32_t* row_a = (uint32_t*)rows.data();
  uint32_t* row_b = row_a + pitch_a;
  std::vector<int> diagonals(dp ? 2 * (size_t)d + 1 : 1);
  for (long long t = 0; t < p; ++t) {
    const int la = len_a[t], lb = len_b[t];
    int answer = fqd_edit::trivial_answer(la, lb, d, length);
    if (answer < 0 && !dp) answer = 0;
    if (answer < 0) {
      memset(row_a, noise, 4 * pitch_a);
      memset(row_b, noise ^ 0x5A, 4 * pitch_b);
      memcpy(row_a, a + t * length, length);
      memcpy(row_b, b + t * length, length);
      uint8_t* bytes_b = (uint8_t*)row_b;
      if (4 * pitch_b < (long long)lb + 16) return 1;  // no room: a bug
      for (int x = length; x < lb; ++x) bytes_b[x] = bytes_b[length - 1];
      answer = fqd_edit::within_distance(row_a, row_b, la, lb, d,
                                         diagonals.data(), 1) ? 1 : 0;
    }
    out[t] = (uint8_t)answer;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_within(tmp_path_factory):
    compiler = shutil.which("g++") or shutil.which("c++") \
        or shutil.which("clang++")
    if compiler is None:
        pytest.skip("needs a C++ compiler to build csrc/edit_lv.cuh for "
                    "the host")
    work = tmp_path_factory.mktemp("edit_core")
    src = work / "shim.cpp"
    src.write_text(SHIM)
    lib_path = work / "libedit_core.so"
    csrc = os.path.dirname(kernel_lib.sources()[0])
    subprocess.run([compiler, "-std=c++17", "-O1", "-fPIC", "-shared",
                    "-x", "c++", "-I", csrc, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr = ctypes.c_void_p
    lib.host_within.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int64,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.host_within.restype = ctypes.c_int

    def run(a, la, b, lb, d, noise=0xA7):
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        la = np.ascontiguousarray(la, dtype=np.int32)
        lb = np.ascontiguousarray(lb, dtype=np.int32)
        out = np.zeros(len(a), dtype=np.uint8)
        status = lib.host_within(a.ctypes.data, la.ctypes.data,
                                 b.ctypes.data, lb.ctypes.data,
                                 out.ctypes.data, len(a), a.shape[1], d,
                                 noise)
        assert status == 0
        return out.astype(bool)[:, None]

    return run


def _plain(a, la, b, lb, d):
    return ek.banded_within_plain(
        torch.from_numpy(a), torch.from_numpy(la), torch.from_numpy(b),
        torch.from_numpy(lb), d).numpy()


def _related_rows(rng, p, width, alphabet, edits):
    """uint8 [P, width] rows a and b: b is a with up to ``edits``
    substitutions, deletions or insertions near random positions; a
    quarter of the pairs are unrelated."""
    a = rng.integers(0, alphabet, (p, width), dtype=np.uint8)
    b = a.copy()
    for row in range(p):
        if row % 4 == 3:
            b[row] = rng.integers(0, alphabet, width, dtype=np.uint8)
            continue
        for _ in range(rng.integers(0, edits + 1)):
            pos = int(rng.integers(0, width))
            op = rng.integers(3)
            if op == 0:
                b[row, pos] = rng.integers(0, alphabet)
            elif op == 1:
                b[row, pos:-1] = b[row, pos + 1:].copy()
            else:
                b[row, pos + 1:] = b[row, pos:-1].copy()
                b[row, pos] = rng.integers(0, alphabet)
    return a, b


@pytest.mark.parametrize("width,d", [
    (1, 0), (1, 1), (2, 1), (3, 2), (4, 1), (5, 0), (5, 3), (7, 2),
    (8, 1), (9, 1), (16, 2), (17, 3), (30, 1), (30, 4), (33, 6),
    (64, 2), (100, 1), (112, 1), (112, 3), (112, 6), (40, 12), (12, 11),
])
def test_host_core_matches_plain_any_lengths(host_within, width, d):
    """Lengths anywhere in [0, width], gaps around d, every alignment of
    the first symbol of a match scan."""
    rng = np.random.default_rng(1000 * width + d)
    p = 3000
    a, b = _related_rows(rng, p, width, 3, d + 1)
    la = rng.integers(0, width + 1, p).astype(np.int32)
    lb = (la + rng.integers(-d - 1, d + 2, p)).clip(0, width).astype(
        np.int32)
    full = rng.random(p) < 0.3
    la[full] = width
    lb[full] = np.clip(width - rng.integers(0, d + 1, int(full.sum())), 0,
                       width)
    want = _plain(a, la, b, lb, d)
    np.testing.assert_array_equal(host_within(a, la, b, lb, d), want)
    # Other bytes past the lengths and other noise around the rows.
    a2 = np.where(np.arange(width) < la[:, None], a, np.uint8(0xFF))
    b2 = np.where(np.arange(width) < lb[:, None], b, np.uint8(0))
    np.testing.assert_array_equal(host_within(a2, la, b2, lb, d, 0), want)
    assert want.any() and (d >= width or not want.all())


@pytest.mark.parametrize("d", [0, 1, 2, 5])
def test_host_core_matches_plain_at_word_edges(host_within, d):
    """la and lb at the edges of 4- and 8-symbol words, the only
    difference in the last symbol or in the first pad byte."""
    rng = np.random.default_rng(40 + d)
    edges = [7, 8, 9, 15, 16, 17, 63, 64, 65, 111, 112]
    rows = []
    for la in edges:
        for gap in range(-d, d + 1):
            lb = la + gap
            if not 1 <= lb <= 112:
                continue
            for case in range(4):
                x = rng.integers(0, 4, 112, dtype=np.uint8)
                y = x.copy()
                if case == 1:    # the last symbol of a differs
                    y[min(la, lb) - 1] ^= 1
                elif case == 2:  # only pad bytes differ
                    x[la:] = 0xFF
                    y[lb:] = 0xEE
                elif case == 3:  # one base deleted near the start
                    y[2:-1] = x[3:]
                rows.append((x, la, y, lb))
    a = np.stack([r[0] for r in rows])
    b = np.stack([r[2] for r in rows])
    la = np.array([r[1] for r in rows], dtype=np.int32)
    lb = np.array([r[3] for r in rows], dtype=np.int32)
    want = _plain(a, la, b, lb, d)
    np.testing.assert_array_equal(host_within(a, la, b, lb, d), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("width,d", [(1, 1), (4, 4), (6, 9), (30, 30),
                                     (30, 200)])
def test_host_core_distance_at_or_above_width(host_within, width, d):
    rng = np.random.default_rng(width + d)
    p = 500
    a, b = _related_rows(rng, p, width, 4, 2)
    la = rng.integers(0, width + 1, p).astype(np.int32)
    lb = rng.integers(0, width + 1, p).astype(np.int32)
    want = _plain(a, la, b, lb, d)
    np.testing.assert_array_equal(host_within(a, la, b, lb, d), want)
    assert want.all()


@pytest.mark.parametrize("width,d", [(8, 1), (12, 3), (30, 2), (112, 1)])
def test_host_core_lengths_outside_the_rows(host_within, width, d):
    """Lengths the callers never pass: negative, la above the width
    (false), lb above it (b repeats its last byte), as the plain version
    answers them."""
    rng = np.random.default_rng(7 * width + d)
    p = 2000
    a, b = _related_rows(rng, p, width, 2, d)
    b[::2, -3:] = b[::2, -1:]
    a[::2, -3:] = b[::2, -1:]
    la = rng.integers(width - d - 1, width + 2, p).astype(np.int32)
    lb = rng.integers(width - d - 1, width + d + 2, p).astype(np.int32)
    la[::11] = -1
    lb[::13] = -2
    la[::17] = 0
    want = _plain(a, la, b, lb, d)
    np.testing.assert_array_equal(host_within(a, la, b, lb, d), want)
    assert want[lb > width].any() and not want[lb > width].all()
