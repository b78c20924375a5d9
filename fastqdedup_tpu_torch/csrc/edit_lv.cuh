// The arithmetic of the edit-distance kernel (csrc/edit.cu), apart from
// how rows reach shared memory: the answers that need no DP, the match
// scan over packed symbols, and the furthest-reaching-diagonals test.
//
// It compiles as CUDA device code and, unchanged, as plain C++ (the few
// intrinsics it uses are given below for that case), so a host build can
// hold it against the plain PyTorch version on any input
// (tests/test_torch_edit_core.py).

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define FQD_EDIT_FN __device__ __forceinline__
#define FQD_EDIT_HOST_FN __host__ __device__ inline
#else
#include <algorithm>
#define FQD_EDIT_FN inline
#define FQD_EDIT_HOST_FN inline
using std::max;
using std::min;
// Byte s of the eight bytes {x, y} (x low) per selector nibble, as PRMT.
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t selector) {
  const uint64_t both = ((uint64_t)y << 32) | x;
  uint32_t out = 0;
  for (int n = 0; n < 4; ++n) {
    const uint32_t s = (selector >> (4 * n)) & 7;
    out |= (uint32_t)((both >> (8 * s)) & 0xFF) << (8 * n);
  }
  return out;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
#endif

namespace fqd_edit {

// A diagonal no path has reached.  Adding 1 once per error keeps it
// negative for every d the launcher admits.
constexpr int kNone = -(1 << 28);

// 1 or 0 where the answer needs no DP, -1 where it does.  After -1:
// 1 <= la <= length, 1 <= lb <= la + d, |lb - la| <= d < max(la, lb).
FQD_EDIT_FN int trivial_answer(int la, int lb, int d, int length) {
  if (la == 0) return lb <= d ? 1 : 0;
  // The band scan over `length` rows never reaches row la.
  if (la < 0 || la > length) return 0;
  // The target cell j = lb lies outside the band, or left of j = 0.
  if (lb < 0 || lb - la > d || la - lb > d) return 0;
  // Deleting one string and inserting the other is within d.
  if (max(la, lb) <= d) return 1;
  return -1;
}

// Symbols one step of the match scan compares: one 16-byte word of a.
constexpr int kStepSymbols = 16;

// Words of a pair's a row in shared memory: whole 16-byte words, an odd
// number of them, so that the 16-byte loads of eight neighbouring lanes
// fall into different banks.  The launcher on the host calls it too.
FQD_EDIT_HOST_FN long long a_pitch_words(long long length) {
  return 4 * (((length + 15) / 16) | 1);
}

// Words of a pair's b row: `length` symbols, `d` more that a b of length
// up to length + d repeats, and the four words after the one holding the
// last symbol, which a scan step reads; odd, so that the 4-byte loads of
// a warp's lanes fall into different banks.
FQD_EDIT_HOST_FN long long b_pitch_words(long long length, long long d) {
  return ((length + d + 3) / 4 + 4) | 1;
}

// Bits of a word that hold symbols at or after byte `from` of the word
// (all of them for from <= 0, none for from >= 4).
FQD_EDIT_FN uint32_t bytes_from(int from) {
  const int skip = min(max(from, 0), 4);
  return skip == 4 ? 0u : 0xFFFFFFFFu << (8 * skip);
}

// One step of the match scan: the 16 symbols of the 16-byte word *pa
// against the 16 symbols of b from byte (select & 3) of pb[0], as four
// words that are zero where the symbols agree.  All six loads are issued
// before any is used, so a step waits for shared memory once; PRMT shifts
// b to a's alignment.
struct Differences {
  uint32_t w0, w1, w2, w3;
};

FQD_EDIT_FN Differences compare_step(const uint4* pa, const uint32_t* pb,
                                     uint32_t select) {
  const uint4 wa = *pa;
  const uint32_t b0 = pb[0], b1 = pb[1], b2 = pb[2], b3 = pb[3], b4 = pb[4];
  return {wa.x ^ __byte_perm(b0, b1, select),
          wa.y ^ __byte_perm(b1, b2, select),
          wa.z ^ __byte_perm(b2, b3, select),
          wa.w ^ __byte_perm(b3, b4, select)};
}

// The furthest row i' <= limit such that a[i..i') == b[i + k..i' + k), 16
// symbols a step.  a is a pair's row as 16-byte words (16-byte aligned), b
// as 32-bit words.  The scan starts at the 16-byte word of a that holds
// symbol i, with the symbols before i masked in its first step, and ends
// at the first step with a difference.  The words may hold anything past
// the lengths, and the words of b before its row (read when k < 0)
// anything at all: symbols before i are masked and the result is cut to
// `limit`, so no such byte reaches an answer.
FQD_EDIT_FN int extend(const uint32_t* a, const uint32_t* b, int i, int k,
                       int limit) {
  if (i >= limit) return i;
  const int first = i & (kStepSymbols - 1);  // symbols of the step before i
  i -= first;
  const int j = i + k;  // may be negative; >> and & round down alike
  const uint4* pa = (const uint4*)a + (i >> 4);
  const uint32_t* pb = b + (j >> 2);
  const uint32_t select = 0x3210u + 0x1111u * (uint32_t)(j & 3);
  Differences x = compare_step(pa, pb, select);
  x.w0 &= bytes_from(first);
  x.w1 &= bytes_from(first - 4);
  x.w2 &= bytes_from(first - 8);
  x.w3 &= bytes_from(first - 12);
  for (;;) {
    if ((x.w0 | x.w1 | x.w2 | x.w3) != 0) {
      uint32_t word = x.w0;
      int base = 0;
      if (word == 0) {
        word = x.w1;
        base = 4;
      }
      if (word == 0) {
        word = x.w2;
        base = 8;
      }
      if (word == 0) {
        word = x.w3;
        base = 12;
      }
      i += base + ((__ffs((int)word) - 1) >> 3);
      break;
    }
    i += kStepSymbols;
    if (i >= limit) break;
    pa += 1;
    pb += 4;
    x = compare_step(pa, pb, select);
  }
  return min(i, limit);
}

// lev(a[:la], b[:lb]) <= d for a pair that trivial_answer sent on, by
// furthest-reaching diagonals (Ukkonen; Landau and Vishkin).  After e
// errors fr[k] is the furthest row i of a reached on diagonal k (cell
// (i, i + k)):
//     fr_e[k] = extend(max(fr_{e-1}[k] + 1,      substitution
//                          fr_{e-1}[k - 1],      insertion
//                          fr_{e-1}[k + 1] + 1)) deletion
// cut to min(la, lb - k), and the answer is true once fr_e[lb - la]
// reaches la for some e <= d.  At step e only diagonals with |k| <= e
// that can still reach the target, |lb - la - k| <= d - e, are taken: a
// predecessor of such a diagonal was one at step e - 1, and together with
// d < max(la, lb) the rule keeps every diagonal taken inside the matrix.
// A diagonal left out keeps an older value, which is a row reached with
// fewer errors and so never too far.
//
// fr holds 2d + 1 values, fr[(k + d) * stride], and is updated in place
// in ascending k with the two old neighbours carried in registers.
// a and b are the pair's rows as extend() takes them.
FQD_EDIT_FN bool within_distance(const uint32_t* a, const uint32_t* b,
                                 int la, int lb, int d, int* fr,
                                 int stride) {
  const int delta = lb - la;
  for (int k = 0; k <= 2 * d; ++k) fr[k * stride] = kNone;
  for (int e = 0; e <= d; ++e) {
    const int lo = max(-e, delta - (d - e));
    const int hi = min(e, delta + (d - e));
    int prev = lo > -d ? fr[(lo - 1 + d) * stride] : kNone;
    int cur = fr[(lo + d) * stride];
    for (int k = lo; k <= hi; ++k) {
      const int next = k < d ? fr[(k + 1 + d) * stride] : kNone;
      int best = e == 0 ? 0 : max(max(cur + 1, prev), next + 1);
      if (best >= 0) {
        const int limit = min(la, lb - k);
        best = extend(a, b, min(best, limit), k, limit);
        fr[(k + d) * stride] = best;
        if (k == delta && best >= la) return true;
      }
      prev = cur;
      cur = next;
    }
  }
  return false;
}

}  // namespace fqd_edit
