// Levenshtein "within distance" kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel banded_within_edit_distance / _banded_body
// of fastqdedup_tpu/ops/pallas_edit.py.  Per pair p:
//     out[p] = lev(a_p[:la_p], b_p[:lb_p]) <= d
// with that kernel's answers on every input: la == 0 answers lb <= d, la
// outside [0, L] or lb < 0 or |la - lb| > d is false, a b longer than L
// repeats its last byte, and nothing past la or lb reaches a result, so
// pad bytes never matter.
//
// The TPU kernel scanned a band of 2d + 1 DP cells through all L rows of
// 4096 pairs folded onto vector registers.  On the H100 a batch of 2^16
// pairs is less than one wave, so the launch lasts as long as one warp's
// chain of dependent steps, and the rows are gathered through indices from
// a matrix far larger than L1.  The design shortens the chain and pays the
// memory latency once:
// * A warp owns 32 pairs.  Each lane reads its pair's indices and lengths
//   and settles what needs no DP (trivial_answer); those pairs stage
//   nothing.
// * Staging: the warp copies the rows of its remaining pairs into shared
//   memory, one row of each side per step with the lanes side by side on
//   the row's 4-byte words (cp.async), so every load of the warp is in
//   flight at once and a row's sectors are read whole.  The loop is
//   unrolled and a step is six instructions: measured, staging is bound
//   by the instructions a warp issues, not by bytes (16-byte copies were
//   slower).  Rows whose width or base is not a multiple of 4 bytes take
//   byte loads on the same path.  Only the warp synchronises, never the
//   block.
// * The test is furthest-reaching diagonals (edit_lv.cuh): for e = 0..d,
//   the furthest row reached on each diagonal that can still end in the
//   target cell, matches extended 16 symbols a step from the staged rows
//   (one 16-byte load of a, five 4-byte loads of b, four PRMT to align b,
//   four XOR).  A near-duplicate pair at d = 1 takes about 14 steps where
//   the band scan took 100 rows of 3 cells; a pair of unrelated reads
//   stops after d + 1 short scans.
// * Row pitches keep the loads off each other's banks while the lanes
//   scan in step: a's is an odd number of 16-byte words, b's an odd
//   number of 4-byte words.
// * One kernel for every d: the 2d + 1 diagonals of a lane's pair live in
//   shared memory at run-time width beside its rows (k-major, lanes side
//   by side).  No scratch in device memory, no variant per d.
// * d >= L needs no DP for lengths within [0, L] (trivial_answer), so the
//   launch then stages nothing; a b longer than L is answered false there.
//
// What holds it on the H100 (chip_smoke.py --edit-variants, 2^16 index
// pairs into 400k keys, L = 112, d = 1, 7.3 us in all): 3.0 us until the
// indices and lengths have arrived (2.0 us with paired rows: a launch
// this short is mostly its own start and end), 2.0 us of staging, 2.3 us
// of diagonals, where lanes scan from different offsets after the first
// error and their loads meet in the banks.
//
// Shared memory sets the occupancy (ptxas: 40 registers a thread, no
// spill, no static shared memory): a pair takes pitch_a + pitch_b + 2d +
// 1 words, 256 bytes at L = 112 and d = 1, so a block of 4 warps takes 32
// KB and 7 blocks fit an SM's 227 KB, 28 of its 64 warps.  2^16 pairs are
// 3.9 such blocks an SM, 16 warps: one lane a pair cannot fill more, and
// more lanes a pair would issue more instructions, which is what bounds
// the kernel.  Where 32 pairs a warp exceed the limit (L or d in the
// thousands) a warp takes 16, 8, .. 1 pairs; where one pair exceeds it
// (about 2 L + 9 d bytes above 227 KB) the entry point returns
// cudaErrorInvalidValue.
//
// One entry point serves both wrappers: with index arrays ci / cj a lane
// gathers its rows from a resident key matrix (the engine's verification
// batches: one launch, no index_select); with null index pointers pair p
// reads row p of a and b.  It launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "edit_lv.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr long long kDefaultSharedBytes = 48 * 1024;
constexpr long long kMaxSharedBytes = 232448;  // a block's limit on sm_90
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// How a row reaches shared memory.
enum Staging : int {
  kNoDp = 0,   // d >= L: no pair within the contract needs its rows
  kBytes = 1,  // any width and base
  kWords = 2,  // width and both bases multiples of 4 bytes
};

// Four bytes from device memory to the shared-memory address `to`.
__device__ __forceinline__ void cp_async_word(unsigned to,
                                              const uint8_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Builds for measurements only (chip_smoke.py --edit-variants); none of
// them is the library's.  FQD_EDIT_STOP_AFTER=1 ends a warp after the
// answers that need no DP and 2 after staging, with every other pair
// false; FQD_EDIT_STAGE_ALL stages every pair's rows before its lengths
// have arrived; FQD_EDIT_BAND_SCAN swaps the diagonals for the band scan
// below at d = 1, 2, 3 and 6.
#ifndef FQD_EDIT_STOP_AFTER
#define FQD_EDIT_STOP_AFTER 0
#endif
#ifdef FQD_EDIT_STAGE_ALL
constexpr bool kStageAll = true;
#else
constexpr bool kStageAll = false;
#endif

#ifdef FQD_EDIT_BAND_SCAN
// The other candidate for the DP, kept to be timed against the diagonals:
// the Pallas kernel's band of W = 2d + 1 cells through rows 1..la, the
// band and the W bytes of b it touches in registers, values saturated at
// d + 1, one byte of each staged row read per DP row.
template <int D>
__device__ bool band_scan(const uint8_t* a, const uint8_t* b, int la,
                          int lb) {
  constexpr int W = 2 * D + 1;
  constexpr int kCap = D + 1;
  int band[W];
  int win[W];  // win[k] = b[j - 1] for the cell j = i - D + k
#pragma unroll
  for (int k = 0; k < W; ++k) {
    band[k] = k - D >= 0 ? min(k - D, kCap) : kCap;
    win[k] = b[max(k - D, 0)];
  }
  for (int i = 1; i <= la; ++i) {
    const int ai = a[i - 1];
    int left = kCap;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = i - D + k;
      int best = band[k] + (ai != win[k] ? 1 : 0);
      if (k + 1 < W) best = min(best, band[k + 1] + 1);
      if (k > 0) best = min(best, left + 1);
      best = min(best, kCap);
      if (j < 1 || j > lb) best = kCap;
      if (j == 0) best = min(i, kCap);
      band[k] = best;
      left = best;
    }
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) win[k] = win[k + 1];
    win[W - 1] = b[i + D];
  }
  const int target = lb - la + D;
  int value = kCap;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k == target) value = band[k];
  }
  return value <= D;
}
#endif

// blockDim.x = 32 * warps; dynamic shared memory = warps * pairs_per_warp
// * (pitch_a + pitch_b + 2 * d + 1) words: per warp the a rows, the b
// rows, then the diagonals.  pitch_a is a multiple of 4 and pitch_b and
// 2 * d + 1 are odd, so a warp's share is a multiple of 4 words unless it
// holds one pair, and then the block holds one warp: every a row starts
// on 16 bytes.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
within_edit_kernel(const uint8_t* __restrict__ a,
                   const int* __restrict__ len_a,
                   const uint8_t* __restrict__ b,
                   const int* __restrict__ len_b,
                   const int* __restrict__ ci, const int* __restrict__ cj,
                   uint8_t* __restrict__ out, long long p, int length, int d,
                   int pitch_a, int pitch_b, int pairs_per_warp,
                   int staging) {
  extern __shared__ uint4 shared_memory[];  // 16-byte aligned
  uint32_t* shared_words = (uint32_t*)shared_memory;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int ppw = pairs_per_warp;
  uint32_t* rows_a =
      shared_words + (size_t)warp * ppw *
                         ((size_t)pitch_a + pitch_b + 2 * (size_t)d + 1);
  uint32_t* rows_b = rows_a + (size_t)ppw * pitch_a;
  int* diagonals = (int*)(rows_b + (size_t)ppw * pitch_b);

  const long long t = ((long long)blockIdx.x * warps + warp) * ppw + lane;
  const bool active = lane < ppw && t < p;
  int ra = 0, rb = 0;  // row numbers: p and the indices fit 31 bits
  int la = 0, lb = 0;
  if (active) {
    ra = ci ? ci[t] : (int)t;
    rb = cj ? cj[t] : (int)t;
    la = len_a[ra];
    lb = len_b[rb];
  }
  int answer = 0;
  if (active && !kStageAll) {
    answer = fqd_edit::trivial_answer(la, lb, d, length);
  }
  const bool stage = staging != kNoDp && FQD_EDIT_STOP_AFTER != 1 &&
                     (kStageAll ? active : answer < 0);
  const unsigned stage_mask = __ballot_sync(kFullMask, stage);
  if (stage_mask != 0) {
    if (staging == kWords) {
      // One row of each side per step, lane w on word w; rows wider than
      // 32 words take the rest in the loop after.  Staging is bound by
      // the instructions issued, so a step is two shuffles, two address
      // multiply-adds and two predicated copies.
      const bool in_row = 4 * lane < length;
      const uint8_t* lane_a = a + 4 * lane;
      const uint8_t* lane_b = b + 4 * lane;
      const unsigned to_a =
          (unsigned)__cvta_generic_to_shared(rows_a + lane);
      const unsigned to_b =
          (unsigned)__cvta_generic_to_shared(rows_b + lane);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const long long row_a = __shfl_sync(kFullMask, ra, r);
        const long long row_b = __shfl_sync(kFullMask, rb, r);
        if (in_row && ((stage_mask >> r) & 1u) != 0) {
          cp_async_word(to_a + 4u * (unsigned)(r * pitch_a),
                        lane_a + row_a * length);
          cp_async_word(to_b + 4u * (unsigned)(r * pitch_b),
                        lane_b + row_b * length);
        }
      }
      if (length > 128) {
        for (int r = 0; r < ppw; ++r) {
          if (((stage_mask >> r) & 1u) == 0) continue;
          const long long row_a = __shfl_sync(kFullMask, ra, r);
          const long long row_b = __shfl_sync(kFullMask, rb, r);
          for (int w = lane + 32; 4 * w < length; w += 32) {
            cp_async_word(to_a + 4u * (unsigned)(r * pitch_a + w - lane),
                          lane_a + row_a * length + 4 * (w - lane));
            cp_async_word(to_b + 4u * (unsigned)(r * pitch_b + w - lane),
                          lane_b + row_b * length + 4 * (w - lane));
          }
        }
      }
      cp_async_wait_all();
    } else {
      for (int r = 0; r < ppw; ++r) {
        if (((stage_mask >> r) & 1u) == 0) continue;
        const uint8_t* from_a =
            a + (long long)__shfl_sync(kFullMask, ra, r) * length;
        const uint8_t* from_b =
            b + (long long)__shfl_sync(kFullMask, rb, r) * length;
        uint8_t* to_a = (uint8_t*)(rows_a + (size_t)r * pitch_a);
        uint8_t* to_b = (uint8_t*)(rows_b + (size_t)r * pitch_b);
        for (int x = lane; x < length; x += 32) {
          to_a[x] = __ldg(from_a + x);
          to_b[x] = __ldg(from_b + x);
        }
      }
    }
    __syncwarp();
  }
  if (active && kStageAll) {
    answer = fqd_edit::trivial_answer(la, lb, d, length);
  }
  if (answer < 0 && stage && FQD_EDIT_STOP_AFTER == 0) {
    const uint32_t* my_a = rows_a + (size_t)lane * pitch_a;
    uint32_t* my_b = rows_b + (size_t)lane * pitch_b;
    // lb <= la + d <= L + d: the pitch has room.
    for (int x = length; x < lb; ++x) {
      ((uint8_t*)my_b)[x] = ((uint8_t*)my_b)[length - 1];
    }
    bool within;
#ifdef FQD_EDIT_BAND_SCAN
    const uint8_t* bytes_a = (const uint8_t*)my_a;
    const uint8_t* bytes_b = (const uint8_t*)my_b;
    switch (d) {
      case 1: within = band_scan<1>(bytes_a, bytes_b, la, lb); break;
      case 2: within = band_scan<2>(bytes_a, bytes_b, la, lb); break;
      case 3: within = band_scan<3>(bytes_a, bytes_b, la, lb); break;
      case 6: within = band_scan<6>(bytes_a, bytes_b, la, lb); break;
      default:
#endif
        within = fqd_edit::within_distance(my_a, my_b, la, lb, d,
                                           diagonals + lane, ppw);
#ifdef FQD_EDIT_BAND_SCAN
    }
#endif
    answer = within ? 1 : 0;
  }
  if (active) out[t] = (uint8_t)max(answer, 0);
}

}  // namespace

extern "C" {

// a: uint8 [na, length] rows, len_a: int32 [na]; b / len_b likewise.
// ci, cj: int32 [p] row indices into a and b, or both null for pair p =
// row p of each.  out: uint8 [p], 1 where lev <= max_distance.
int fqd_banded_within_edit(const void* a, const void* len_a, const void* b,
                           const void* len_b, const void* ci,
                           const void* cj, void* out, long long p,
                           int length, int max_distance, void* stream) {
  if (p <= 0) return (int)cudaGetLastError();
  if (max_distance < 0 || length < 0 || p > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int d = max_distance;
  int staging = kNoDp;
  long long pitch_a = 0;
  long long pitch_b = 0;
  long long pair_bytes = 0;  // kNoDp launches use no shared memory
  if (d < length) {
    const bool words = length % 4 == 0 && (uintptr_t)a % 4 == 0 &&
                       (uintptr_t)b % 4 == 0;
    staging = words ? kWords : kBytes;
    pitch_a = fqd_edit::a_pitch_words(length);
    pitch_b = fqd_edit::b_pitch_words(length, d);
    pair_bytes = 4 * (pitch_a + pitch_b + 2 * (long long)d + 1);
  }
  int pairs_per_warp = 32;
  while (pairs_per_warp > 1 && pairs_per_warp * pair_bytes > kMaxSharedBytes) {
    pairs_per_warp /= 2;
  }
  int warps = kWarpsPerBlock;
  while (warps > 1 &&
         warps * pairs_per_warp * pair_bytes > kDefaultSharedBytes) {
    warps /= 2;
  }
  const long long shared_bytes = warps * pairs_per_warp * pair_bytes;
  if (shared_bytes > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t status = cudaFuncSetAttribute(
        within_edit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared_bytes);
    if (status != cudaSuccess) return (int)status;
  }
  const long long block_pairs = (long long)warps * pairs_per_warp;
  const long long blocks = (p + block_pairs - 1) / block_pairs;
  within_edit_kernel<<<(unsigned)blocks, 32 * warps, (size_t)shared_bytes,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const int*)len_a, (const uint8_t*)b,
      (const int*)len_b, (const int*)ci, (const int*)cj, (uint8_t*)out, p,
      length, d, (int)pitch_a, (int)pitch_b, pairs_per_warp, staging);
  return (int)cudaGetLastError();
}

}  // extern "C"
