// Candidate join of the --edit route for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package joins the shifted-segment
// windows on the host (fastqdedup_tpu/ops/bucket.py, a numpy sort of the
// window hashes), and so did the port, in ops/bucket.host_edit_join.  The
// host's radix sort of some 2.3M composite values took a third of each
// 2M-read job while the card, which already holds the key matrix for
// verification, sat idle.  ops/edit_candidates.py states the rule both
// versions apply, step by step; its plain PyTorch version gives the same
// values as these kernels.
//
// Two kernels, and the sorts between them on the caller's side
// (torch.sort):
// * edit_window_hash_kernel: one thread a window row, over every spec of
//   the job in one launch.  A spec (8 int64 words: first row, first id in
//   the id list, rows, window start, width, side, seed) names the rows
//   of one length group and one window; a thread finds its spec by binary
//   search over the specs' first rows, reads its key's window from the
//   resident key matrix in aligned 8-byte words (two words and a funnel
//   shift where the window is not 8-byte aligned, the last word
//   zero-extended; from a nibble-packed matrix, byte by byte, each
//   unpacked) and hashes it as ops/bucket._hash_window_rows does
//   with strong=False, bit for bit.  It writes the composite value
//   hash_high | side << gid_bits | id with its top bit flipped, so that a
//   signed 64-bit sort orders the values as unsigned.  Under sharding a
//   row the process does not own writes the flipped all-ones value,
//   which sorts last, and the owned rows are counted.
// * edit_join_kernel: over the sorted composites, one thread a row.  A
//   probe (side 0) pairs with every later row of its run (same hash_high)
//   whose id differs: the probe-left enumeration of the host's join.  In
//   the count pass each thread writes its pair count; the caller's
//   inclusive scan of the counts gives each thread its place, and the
//   write pass writes the codes min(i, j) * 2^31 + max(i, j) in the same
//   order.  Most rows end after one comparison with their neighbour.
//
// Bound: bytes.  At the benchmark's shape (625k keys of 100 bytes, 2.5M
// window rows of 50 bytes, 256k pairs) the key bytes read once, the
// composites written, sorted, read twice by the join, and the codes: 0.15
// GB, 45 us at 3.35 TB/s.  A thread reads its row's window alone (rows
// are 112 bytes apart, so a warp's loads touch 32 rows); the windows of
// one key overlap and the matrix is read by four specs in turn, so most
// of those loads hit L2.  The design keeps the work to one pass over the
// key matrix and two over the composites, and leaves the sorts to
// torch.sort: on an H100 (700 W) the hash took 0.115 ms, the two join
// passes 0.014 and 0.015, the sort 0.444, the codes' sort and unique
// 0.255, where a hand-written LSD radix sort of the bits above the id (8
// bits a pass, a histogram and a stable scatter launch a pass) took 0.568
// in place of the sort (chip_smoke.py --edit-candidates).  The whole join
// took 4 ms of the host's time against 0.67 s for the host's join.
//
// The entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;
constexpr int kSpecWords = 8;
constexpr unsigned long long kTop = 1ULL << 63;

__device__ __forceinline__ unsigned long long mix(unsigned long long h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDULL;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ULL;
  h ^= h >> 33;
  return h;
}

// The weak row hash of fq_hash_rows (strong = 0) over row[start, start +
// width): 8-byte little-endian words, the last one zero-extended.
__device__ __forceinline__ unsigned long long window_hash(
    const unsigned long long* row, int start, int width,
    unsigned long long seed) {
  unsigned long long h = seed;
  for (int done = 0; done < width; done += 8) {
    const int pos = start + done;
    const int nbytes = min(8, width - done);
    const int shift = pos & 7;
    const unsigned long long* at = row + (pos >> 3);
    unsigned long long word = __ldg(at) >> (8 * shift);
    if (shift && shift + nbytes > 8) {
      word |= __ldg(at + 1) << (64 - 8 * shift);
    }
    if (nbytes < 8) word &= (1ULL << (8 * nbytes)) - 1;
    h ^= word;
    h *= 0x2545F4914F6CDD1DULL;
    h ^= h >> 29;
  }
  return mix(h);
}

// The same hash over a nibble-packed row (ops/edit.pack_nibble_rows: two
// values a byte, the even column in the high nibble, 15 for the 0xFF
// pad): each byte of the window unpacked in turn.
__device__ __forceinline__ unsigned long long packed_window_hash(
    const uint8_t* row, int start, int width, unsigned long long seed) {
  unsigned long long h = seed;
  for (int done = 0; done < width; done += 8) {
    const int nbytes = min(8, width - done);
    unsigned long long word = 0;
    for (int b = 0; b < nbytes; ++b) {
      const int col = start + done + b;
      const unsigned byte = __ldg(row + (col >> 1));
      const unsigned nib = col & 1 ? byte & 0xF : byte >> 4;
      word |= (unsigned long long)(nib == 15 ? 0xFF : nib) << (8 * b);
    }
    h ^= word;
    h *= 0x2545F4914F6CDD1DULL;
    h ^= h >> 29;
  }
  return mix(h);
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads) edit_window_hash_kernel(
    const uint8_t* __restrict__ keys, long long pitch,
    const int* __restrict__ ids, const long long* __restrict__ specs,
    int n_specs, long long rows, int gid_bits, int pid, int nproc,
    unsigned long long own_salt, unsigned long long* __restrict__ out,
    unsigned long long* __restrict__ owned) {
  __shared__ unsigned long long block_owned;
  if (threadIdx.x == 0) block_owned = 0;
  __syncthreads();
  const unsigned long long low_mask = (1ULL << (gid_bits + 1)) - 1;
  unsigned long long mine = 0;
  for (long long r = blockIdx.x * (long long)kThreads + threadIdx.x;
       r < rows; r += (long long)gridDim.x * kThreads) {
    int lo = 0;
    int hi = n_specs - 1;
    while (lo < hi) {  // the last spec whose first row is <= r
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(specs + mid * kSpecWords) <= r) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const long long* spec = specs + lo * kSpecWords;
    const long long k = r - __ldg(spec);
    const long long id = __ldg(ids + __ldg(spec + 1) + k);
    const int start = (int)__ldg(spec + 3);
    const int width = (int)__ldg(spec + 4);
    const unsigned long long seed = (unsigned long long)__ldg(spec + 6);
    const unsigned long long h =
        kPacked ? packed_window_hash(keys + id * pitch, start, width, seed)
                : window_hash(reinterpret_cast<const unsigned long long*>(
                                  keys + id * pitch),
                              start, width, seed);
    unsigned long long value = ~0ULL;
    if (nproc <= 1 || mix(h ^ own_salt) % (unsigned long long)nproc ==
                          (unsigned long long)pid) {
      value = (h & ~low_mask) |
              ((unsigned long long)__ldg(spec + 5) << gid_bits) |
              (unsigned long long)id;
      ++mine;
    }
    out[r] = value ^ kTop;
  }
  if (mine) atomicAdd(&block_owned, mine);
  __syncthreads();
  if (threadIdx.x == 0 && block_owned) atomicAdd(owned, block_owned);
}

// Count pass (ends == null): counts[i] = the pairs row i emits.  Write
// pass: the codes of row i at [ends[i - 1], ends[i]).
__global__ void __launch_bounds__(kThreads) edit_join_kernel(
    const unsigned long long* __restrict__ sorted, long long rows,
    const unsigned long long* __restrict__ valid, int gid_bits,
    long long* __restrict__ counts, const long long* __restrict__ ends,
    long long* __restrict__ codes) {
  const long long n = min((long long)*valid, rows);
  const unsigned long long id_mask = (1ULL << gid_bits) - 1;
  const int low_bits = gid_bits + 1;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < rows; i += (long long)gridDim.x * kThreads) {
    long long emitted = 0;
    long long at = ends && i ? ends[i - 1] : 0;
    if (i < n) {
      const unsigned long long v = sorted[i];
      if (!((v >> gid_bits) & 1)) {  // a probe
        const unsigned long long run = v >> low_bits;
        const long long gi = (long long)(v & id_mask);
        for (long long j = i + 1; j < n; ++j) {
          const unsigned long long w = sorted[j];
          if ((w >> low_bits) != run) break;
          const long long gj = (long long)(w & id_mask);
          if (gj == gi) continue;
          if (ends) {
            codes[at++] = gi < gj ? (gi << 31) + gj : (gj << 31) + gi;
          } else {
            ++emitted;
          }
        }
      }
    }
    if (!ends) counts[i] = emitted;
  }
}

unsigned blocks_for(long long rows) {
  long long blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" {

// keys: uint8 [n, pitch] key matrix, nibble-packed where packed != 0
// (pitch a multiple of 8 and the matrix 8-byte aligned where it is not);
// ids: int32 key ids, every spec's rows at [spec[1], spec[1] +
// spec[2]); specs: int64 [n_specs][8], ascending first rows from 0;
// out: uint64 [rows]; owned: one uint64 the owned rows are added to.
int fqd_edit_window_hash(const void* keys, long long pitch, const void* ids,
                         const void* specs, int n_specs, long long rows,
                         int gid_bits, int pid, int nproc,
                         unsigned long long own_salt, int packed, void* out,
                         void* owned, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  if (n_specs <= 0 || (!packed && (pitch % 8 || (uintptr_t)keys % 8)) ||
      gid_bits < 1 || gid_bits > 62) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = packed ? edit_window_hash_kernel<true>
                       : edit_window_hash_kernel<false>;
  kernel<<<blocks_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)keys, pitch, (const int*)ids, (const long long*)specs,
      n_specs, rows, gid_bits, pid, nproc, own_salt,
      (unsigned long long*)out, (unsigned long long*)owned);
  return (int)cudaGetLastError();
}

// sorted: uint64 [rows], the first *valid of them the join's values in
// ascending order.  ends == null: counts[rows] int64 receives each row's
// pair count.  Otherwise ends is the inclusive scan of those counts and
// codes (int64) receives the pairs.
int fqd_edit_join(const void* sorted, long long rows, const void* valid,
                  int gid_bits, void* counts, const void* ends, void* codes,
                  void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  if (gid_bits < 1 || gid_bits > 31) return (int)cudaErrorInvalidValue;
  edit_join_kernel<<<blocks_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)sorted, rows,
      (const unsigned long long*)valid, gid_bits, (long long*)counts,
      (const long long*)ends, (long long*)codes);
  return (int)cudaGetLastError();
}

}  // extern "C"
