// Hamming "within distance" kernels for NVIDIA Hopper (sm_90a).
//
// Two __global__ kernels replace the three Pallas TPU kernels of
// fastqdedup_tpu/ops/pallas_hamming.py:
//
// * pairs_within_kernel serves both bucket_within_packed (a == b, one
//   bucket per batch entry) and within_tile_packed (one batch entry, two
//   row sets).  Both compute the same packed all-pairs tile:
//       out[z, i, c] bit k  =  length - matches(a[z, i], b[z, 8c + k]) <= d
//   where a position matches when a == b and a < alphabet_pad (so the pad
//   symbol 0xFF matches nothing).  The TPU kernels counted matches as an
//   int8 one-hot matmul on the MXU and bit-packed with a second matmul;
//   here each thread compares 4 symbols per instruction (__vcmpeq4 masked
//   by __vcmpltu4) and packs its 8 columns with shifts.
//   Bound on the H100: integer compare throughput (about 4 integer
//   instructions per 4 symbols per pair).  The design keeps every operand
//   in shared memory or registers: a block stages 32 a-rows and 128 b-rows
//   one 64-symbol chunk of Lp at a time, so shared memory stays at ~12 KB
//   whatever Lp or the bucket size, and reads of b are warp broadcasts.
//
// * rowwise_within_kernel replaces rowwise_within_packed: per pair of
//   nibble-packed rows (8 symbols per 32-bit lane), XOR, collapse each
//   nibble to one bit, popcount, sum over lanes, test <= d.
//   Bound on the H100: device-memory bytes (8 B read per lane per pair,
//   about 6 instructions per lane).  One thread per pair reads its row
//   directly from the row-major [P, lanes] layout; no transpose.
//
// Entry points take raw device pointers and PyTorch's current stream,
// allocate nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;             // output rows per block: one per lane
constexpr int kColBytes = 16;         // output bytes per row: one per warp
constexpr int kCols = kColBytes * 8;  // 128 output columns per block
constexpr int kChunkWords = 16;       // Lp staged per pass: 64 symbols

__global__ void __launch_bounds__(kRows * kColBytes)
pairs_within_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    uint8_t* __restrict__ out,
                    int n, int m, int lp_words,
                    long long a_batch_words, long long b_batch_words,
                    int min_matches, uint32_t alphabet4) {
  // One word of padding per a-row: lanes read sa[lane][w] at an odd
  // stride, so the 32 lanes of a warp hit 32 different banks.
  __shared__ uint32_t sa[kRows][kChunkWords + 1];
  __shared__ uint32_t sv[kRows][kChunkWords + 1];  // 0xFF per a byte < Ap
  __shared__ uint32_t sb[kCols][kChunkWords];

  const int lane = threadIdx.x;  // output row within the tile
  const int byte = threadIdx.y;  // output byte (8 columns) within the tile
  const int tid = byte * kRows + lane;
  const int nthreads = kRows * kColBytes;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const long long z = blockIdx.z;
  const uint32_t* a_rows = a + z * a_batch_words + (long long)row0 * lp_words;
  const uint32_t* b_rows = b + z * b_batch_words + (long long)col0 * lp_words;

  int count[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) count[j] = 0;

  for (int w0 = 0; w0 < lp_words; w0 += kChunkWords) {
    const int cw = min(kChunkWords, lp_words - w0);
    for (int t = tid; t < kRows * cw; t += nthreads) {
      const int r = t / cw;
      const int w = t - r * cw;
      const uint32_t v = a_rows[(long long)r * lp_words + w0 + w];
      sa[r][w] = v;
      sv[r][w] = __vcmpltu4(v, alphabet4);
    }
    for (int t = tid; t < kCols * cw; t += nthreads) {
      const int r = t / cw;
      const int w = t - r * cw;
      sb[r][w] = b_rows[(long long)r * lp_words + w0 + w];
    }
    __syncthreads();
    for (int w = 0; w < cw; ++w) {
      const uint32_t av = sa[lane][w];
      const uint32_t valid = sv[lane][w];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // 0xFF per matching valid byte: 8 bits per match.
        count[j] += __popc(__vcmpeq4(av, sb[byte * 8 + j][w]) & valid);
      }
    }
    __syncthreads();
  }

  // length - matches <= d  <=>  matches >= length - d.
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bits |= ((count[j] >> 3) >= min_matches ? 1u : 0u) << j;
  }
  const long long out_row = z * n + row0 + lane;
  out[out_row * (m / 8) + blockIdx.x * kColBytes + byte] = (uint8_t)bits;
}

__global__ void rowwise_within_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b,
                                      uint8_t* __restrict__ out,
                                      long long p, int lanes,
                                      int max_distance) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const uint32_t* ra = a + i * lanes;
  const uint32_t* rb = b + i * lanes;
  int mismatches = 0;
  for (int k = 0; k < lanes; ++k) {
    // A non-zero XOR nibble collapses to exactly one set bit.
    uint32_t x = ra[k] ^ rb[k];
    x |= x >> 2;
    x |= x >> 1;
    mismatches += __popc(x & 0x11111111u);
  }
  out[i] = mismatches <= max_distance ? 1 : 0;
}

}  // namespace

extern "C" {

// a: uint8 [batch, n, lp], b: uint8 [batch, m, lp], both 4-byte aligned
// with lp a multiple of 4; out: uint8 [batch, n, m / 8].  n must be a
// multiple of 32 and m a multiple of 128 (the wrapper checks).
int fqd_pairs_within_packed(const void* a, const void* b, void* out,
                            int batch, int n, int m, int lp,
                            long long a_batch_stride,
                            long long b_batch_stride, int length,
                            int max_distance, int alphabet_pad,
                            void* stream) {
  const dim3 block(kRows, kColBytes);
  const dim3 grid(m / kCols, n / kRows, batch);
  const uint32_t alphabet4 = 0x01010101u * (uint32_t)alphabet_pad;
  pairs_within_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint8_t*)out, n, m, lp / 4,
      a_batch_stride / 4, b_batch_stride / 4, length - max_distance,
      alphabet4);
  return (int)cudaGetLastError();
}

// a, b: 32-bit lanes [p, lanes], row-major; out: bool [p].
int fqd_rowwise_within_packed(const void* a, const void* b, void* out,
                              long long p, int lanes, int max_distance,
                              void* stream) {
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((p + threads - 1) / threads);
  if (blocks > 0) {
    rowwise_within_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint8_t*)out, p, lanes,
        max_distance);
  }
  return (int)cudaGetLastError();
}

const char* fqd_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
