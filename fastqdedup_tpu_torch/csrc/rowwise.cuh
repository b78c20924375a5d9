// The arithmetic of the pair-list kernel's indexed entry
// (rowwise_within_indexed_kernel in csrc/hamming.cu): how a warp shares
// its span of 32 pairs among groups of threads, which lanes of a row each
// thread of a group reads, the nibble fold and popcount of one lane, the
// transposed reduction that leaves each thread holding one pair's count,
// and the <= d test.
//
// It compiles as CUDA device code and, unchanged, as plain C++, so a host
// build can play a warp through these functions and hold the result
// against the plain PyTorch version on any input
// (tests/test_torch_rowwise_core.py).

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define FQD_ROWWISE_FN __host__ __device__ __forceinline__
#else
#define FQD_ROWWISE_FN inline
#endif

namespace fqd_rowwise {

// Pairs a warp takes as one span: thread t loads the indices of pair t
// (coalesced) and, after the reduction, writes pair t's answer.
constexpr int kSpan = 32;

// Threads that share one pair, by row width in 32-bit lanes.  A row of
// one or two lanes is one thread's (one 8-byte load where the rows are
// 8-byte aligned); a wider row is spread over a group of 4, 8 or 32
// threads, a lane or two each, so that one load instruction of the warp
// asks for 16 to 32 contiguous bytes of each of several rows instead of
// one word of 32 rows.  Rows of 9 to 16 lanes (13: 100 bp keys) take
// groups of 8, two loads a row a thread: on the route's bucket-ordered
// pairs that beat groups of 16, one load a row a thread, which win only
// on pairs that share no rows (PERF.md).  Rows wider than 32 lanes
// take several lanes a thread.
FQD_ROWWISE_FN constexpr int group_size(int lanes) {
  return lanes <= 2 ? 1 : lanes <= 4 ? 4 : lanes <= 16 ? 8 : 32;
}

// A group of size g handles the span's pairs group * g .. group * g + g - 1,
// one a step; at step s it works on this pair of the span.  After the
// reduction thread `group * g + s` holds that pair's count, so the writes
// of a warp are 32 consecutive bytes.
FQD_ROWWISE_FN constexpr int pair_of(int group, int step, int g) {
  return group * g + step;
}

// The lane of a row that thread `rank` of a group of size g reads on its
// k-th load (it reads nothing where the lane is at or past the row's end).
FQD_ROWWISE_FN constexpr int lane_of(int rank, int k, int g) {
  return rank + k * g;
}

// Loads of a row one thread issues for a row of `lanes` lanes.
FQD_ROWWISE_FN constexpr int loads_per_row(int lanes, int g) {
  return (lanes + g - 1) / g;
}

FQD_ROWWISE_FN int popcount(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Symbols that differ in one lane of 8 nibble-packed symbols, given the
// XOR of the two lanes.  Bit 3 of each nibble of (x & 7) + 7 is set where
// the nibble's low three bits are not all zero (no carry leaves a
// nibble), and x's own bit 3 covers the rest: one bit per non-zero
// nibble, from five integer instructions with the XOR and the popcount.
// Pad nibbles (0xF past a key's end) take part like any other symbol.
FQD_ROWWISE_FN int lane_mismatches(uint32_t x) {
  return popcount((((x & 0x77777777u) + 0x77777777u) | x) & 0x88888888u);
}

// The transposed reduction over a group of g threads, each holding g
// partial counts, one per step.  At stage `half` (g/2, g/4, ..., 1) a
// thread holds 2 * half counts, v[0 .. 2 * half); for each j < half it
// keeps v[j + half] where bit `half` of its rank is set and v[j]
// otherwise, sends the other one to the thread whose rank differs in
// that bit, and adds what that thread sends into v[j].  After the last
// stage, v[0] of rank r is the group's sum of step r: g - 1 exchanges in
// all, where a butterfly per step would take g * log2(g).  The choice is
// made with a mask, not a select, so the counts stay in registers.
FQD_ROWWISE_FN int reduce_mask(int rank, int half) {
  return (rank & half) ? -1 : 0;
}

// What a thread sends at (half, j): lo = v[j], hi = v[j + half].
FQD_ROWWISE_FN int reduce_send(int lo, int hi, int mask) {
  return hi + ((lo - hi) & mask);
}

// What it keeps, to add the partner's value to.
FQD_ROWWISE_FN int reduce_keep(int lo, int hi, int mask) {
  return lo - ((lo - hi) & mask);
}

// Hamming distance at most d.
FQD_ROWWISE_FN bool within(int mismatches, int max_distance) {
  return mismatches <= max_distance;
}

}  // namespace fqd_rowwise
