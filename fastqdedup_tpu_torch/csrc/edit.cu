// Banded Levenshtein "within distance" kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel banded_within_edit_distance / _banded_body
// of fastqdedup_tpu/ops/pallas_edit.py.  Per pair p:
//     out[p] = lev(a_p[:la_p], b_p[:lb_p]) <= d
// computed as the banded dynamic program of that kernel: a band of
// W = 2d + 1 cells per DP row, band[k] holding dp[i][j] with j = i - d + k,
// diagonal predecessor band[k], deletion band[k + 1], insertion the new
// band[k - 1].  The rules are the Pallas kernel's: INF = 1 << 20, row 0
// is j (INF for j < 0), a cell with j < 1 or j > lb is INF and then the
// cell j == 0 is i, b is read at clip(j - 1, 0, L - 1), the answer is the
// band cell lb - la + d of row la (INF, so false, outside the band), and
// la == 0 answers lb <= d.  Nothing past la or lb is read into a result,
// so the pad bytes never matter.
//
// The TPU kernel folded 4096 pairs onto [8, 512] vector registers and ran
// every pair through all L rows.  Here one thread owns one pair:
// * d <= 4 compiles W in (template over d): the band and a sliding window
//   of the W bytes of b that the band touches live in registers, so a DP
//   row costs one byte load of a, one of b, and about 3W integer ops;
// * d > 4 takes W at run time with the band in a [W, P] int32 scratch
//   the wrapper allocates (coalesced: neighbouring threads hold
//   neighbouring pairs).  The band is cut to d' = min(d, L): for lengths
//   within [0, L] a band of d' already covers every cell, so every d runs
//   on the card;
// * a thread stops after row la (the answer is fixed there), and a pair
//   with |la - lb| > d is answered false before any DP.
// What bounds it on the H100: integer issue rate (about 3W ops per DP
// cell, la * W cells per pair), and the rows of a and b are read at a
// stride of L bytes between neighbouring threads (served from L1/L2; the
// 45 MB key matrix of a 1M-read input fits the 50 MB L2).  Warps diverge
// where la differs.  Later work: bit-parallel Myers/Hyyro over 64-bit
// words, or one warp per pair.
//
// One entry point serves both wrappers: with index arrays ci / cj the
// thread gathers its rows from a resident key matrix (the engine's
// verification batches: one launch, no index_select); with null index
// pointers pair p reads row p of a and b.  It launches on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kInf = 1 << 20;
constexpr int kThreads = 128;

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// 1 or 0 where the answer needs no DP, -1 where it does.
__device__ __forceinline__ int trivial_answer(int la, int lb, int d,
                                              int length) {
  if (la == 0) return lb <= d ? 1 : 0;
  // Row la is never reached by the band scan over L rows.
  if (la < 0 || la > length) return 0;
  // The target cell j = lb lies outside the band, or left of j = 0.
  if (lb < 0 || abs(lb - la) > d) return 0;
  return -1;
}

struct Pair {
  const uint8_t* a;
  const uint8_t* b;
  int la;
  int lb;
};

__device__ __forceinline__ Pair load_pair(
    const uint8_t* a, const int* len_a, const uint8_t* b, const int* len_b,
    const int* ci, const int* cj, long long t, int length) {
  const long long ra = ci ? (long long)ci[t] : t;
  const long long rb = cj ? (long long)cj[t] : t;
  return {a + ra * length, b + rb * length, len_a[ra], len_b[rb]};
}

template <int D>
__global__ void __launch_bounds__(kThreads)
banded_fixed_kernel(const uint8_t* __restrict__ a,
                    const int* __restrict__ len_a,
                    const uint8_t* __restrict__ b,
                    const int* __restrict__ len_b,
                    const int* __restrict__ ci, const int* __restrict__ cj,
                    uint8_t* __restrict__ out, long long p, int length) {
  constexpr int W = 2 * D + 1;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p) return;
  const Pair q = load_pair(a, len_a, b, len_b, ci, cj, t, length);
  const int early = trivial_answer(q.la, q.lb, D, length);
  if (early >= 0) {
    out[t] = (uint8_t)early;
    return;
  }
  int band[W];
  int win[W];  // win[k] = b[clip(j - 1)] for the cell j = i - D + k
#pragma unroll
  for (int k = 0; k < W; ++k) {
    band[k] = k - D >= 0 ? k - D : kInf;
    win[k] = __ldg(q.b + clip(k - D, 0, length - 1));
  }
  for (int i = 1; i <= q.la; ++i) {
    const int ai = __ldg(q.a + i - 1);
    int left = kInf;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = i - D + k;
      int best = band[k] + (ai != win[k] ? 1 : 0);
      if (k + 1 < W) best = min(best, band[k + 1] + 1);
      if (k > 0) best = min(best, left + 1);
      if (j < 1 || j > q.lb) best = kInf;
      if (j == 0) best = i;
      band[k] = best;  // band[k + 1] still holds row i - 1
      left = best;
    }
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) win[k] = win[k + 1];
    win[W - 1] = __ldg(q.b + clip(i + D, 0, length - 1));
  }
  const int target = q.lb - q.la + D;
  int value = kInf;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k == target) value = band[k];
  }
  out[t] = value <= D ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
banded_runtime_kernel(const uint8_t* __restrict__ a,
                      const int* __restrict__ len_a,
                      const uint8_t* __restrict__ b,
                      const int* __restrict__ len_b,
                      const int* __restrict__ ci, const int* __restrict__ cj,
                      uint8_t* __restrict__ out, long long p, int length,
                      int d, int band_d, int* __restrict__ scratch) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p) return;
  const Pair q = load_pair(a, len_a, b, len_b, ci, cj, t, length);
  const int early = trivial_answer(q.la, q.lb, d, length);
  if (early >= 0) {
    out[t] = (uint8_t)early;
    return;
  }
  const int w = 2 * band_d + 1;
  int* band = scratch + t;  // band[k] at band[k * p]
  for (int k = 0; k < w; ++k) band[k * p] = k - band_d >= 0 ? k - band_d : kInf;
  for (int i = 1; i <= q.la; ++i) {
    const int ai = __ldg(q.a + i - 1);
    int left = kInf;
    int next = band[0];
    for (int k = 0; k < w; ++k) {
      const int j = i - band_d + k;
      const int diag = next;
      int best = diag + (ai != __ldg(q.b + clip(j - 1, 0, length - 1)) ? 1 : 0);
      if (k + 1 < w) {
        next = band[(k + 1) * p];
        best = min(best, next + 1);
      }
      if (k > 0) best = min(best, left + 1);
      if (j < 1 || j > q.lb) best = kInf;
      if (j == 0) best = i;
      band[k * p] = best;
      left = best;
    }
  }
  const int target = q.lb - q.la + band_d;
  const int value = target >= 0 && target < w ? band[target * p] : kInf;
  out[t] = value <= d ? 1 : 0;
}

template <int D>
void launch_fixed(const uint8_t* a, const int* len_a, const uint8_t* b,
                  const int* len_b, const int* ci, const int* cj,
                  uint8_t* out, long long p, int length, unsigned blocks,
                  cudaStream_t stream) {
  banded_fixed_kernel<D><<<blocks, kThreads, 0, stream>>>(
      a, len_a, b, len_b, ci, cj, out, p, length);
}

}  // namespace

extern "C" {

// a: uint8 [na, length] rows, len_a: int32 [na]; b / len_b likewise.
// ci, cj: int32 [p] row indices into a and b, or both null for pair p =
// row p of each.  out: uint8 [p], 1 where lev <= max_distance.  For
// max_distance > 4, scratch is int32 [2 * band_d + 1, p] with band_d =
// min(max_distance, length); it is unused (may be null) otherwise.
int fqd_banded_within_edit(const void* a, const void* len_a, const void* b,
                           const void* len_b, const void* ci,
                           const void* cj, void* out, long long p,
                           int length, int max_distance, int band_d,
                           void* scratch, void* stream) {
  if (p <= 0) return (int)cudaGetLastError();
  if (max_distance < 0 || length < 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((p + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* pa = (const uint8_t*)a;
  const uint8_t* pb = (const uint8_t*)b;
  const int* pla = (const int*)len_a;
  const int* plb = (const int*)len_b;
  const int* pci = (const int*)ci;
  const int* pcj = (const int*)cj;
  uint8_t* po = (uint8_t*)out;
  switch (max_distance) {
    case 0: launch_fixed<0>(pa, pla, pb, plb, pci, pcj, po, p, length, blocks, s); break;
    case 1: launch_fixed<1>(pa, pla, pb, plb, pci, pcj, po, p, length, blocks, s); break;
    case 2: launch_fixed<2>(pa, pla, pb, plb, pci, pcj, po, p, length, blocks, s); break;
    case 3: launch_fixed<3>(pa, pla, pb, plb, pci, pcj, po, p, length, blocks, s); break;
    case 4: launch_fixed<4>(pa, pla, pb, plb, pci, pcj, po, p, length, blocks, s); break;
    default:
      if (scratch == nullptr || band_d < 0 || band_d > max_distance) {
        return (int)cudaErrorInvalidValue;
      }
      banded_runtime_kernel<<<blocks, kThreads, 0, s>>>(
          pa, pla, pb, plb, pci, pcj, po, p, length, max_distance, band_d,
          (int*)scratch);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
