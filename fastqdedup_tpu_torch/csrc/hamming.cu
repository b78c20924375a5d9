// Hamming "within distance" kernels for NVIDIA Hopper (sm_90a).
//
// They replace the three Pallas TPU kernels of
// fastqdedup_tpu/ops/pallas_hamming.py:
//
// * fqd_pairs_within_packed serves both bucket_within_packed (a == b, one
//   bucket per batch entry) and within_tile_packed (one batch entry, two
//   row sets).  Both compute the same packed all-pairs tile:
//       out[z, i, c] bit k  =  length - matches(a[z, i], b[z, 8c + k]) <= d
//   where a position matches when a == b and a < alphabet_pad (so the pad
//   symbol 0xFF matches nothing).  alphabet_pad alone picks one of two
//   routes:
//
//   - 5 to 8 (DNA, and any alphabet of up to 8 symbols): the tensor
//     cores, pairs_within_mma_kernel.  Like the TPU kernels it counts
//     matches as an int8 one-hot product, here wgmma m64n128k32 s8 x s8
//     -> s32 with both operands in shared memory and the sums in
//     registers.  A block one-hots 16 positions of a row at a time into
//     alphabet_pad planes of 16 bytes (one prmt per 4 symbols and plane:
//     the symbols are the selector, the plane's pool holds a single 1),
//     laid out as wgmma core matrices without swizzle, so a quarter warp
//     writes 128 contiguous bytes.  Symbols at or above 8 select nothing,
//     planes at or above alphabet_pad do not exist: the pad rule costs
//     nothing.  The epilogue thresholds the accumulator fragments and packs
//     them with 8 shuffles per 2 rows x 128 columns; no int32 count ever
//     reaches device memory (the TPU kernel's second, bit-packing product
//     is not carried over).  Blocks are persistent, two to an SM, each on
//     a run of consecutive tiles, with the next stage's rows loaded a
//     stage ahead and two shared-memory buffers.  wgmma was chosen over
//     mma.sync because only it reaches the int8 peak and because its
//     unswizzled shared-memory layout turned out to be what the prmt
//     expansion writes anyway.
//     Bound on the H100: int8 operations (2 * pairs * length *
//     alphabet_pad at 1,979 TOP/s).  What holds it at about a third of
//     that: issuing the products occupies a warpgroup for as long as they
//     take (it runs only a little ahead of the tensor cores), so the
//     expansion and the epilogue (about 80 instructions a 16-symbol piece
//     and 170 a thread and tile) overlap them only through other warps,
//     and the 64 accumulators a thread holds leave room for 16 warps on
//     an SM: too few to hide the latencies of that integer work, which
//     then takes as long as the products.  Producer warps, two consumer
//     warpgroups taking turns, and four independent one-warpgroup blocks
//     were each tried and came out within 3% of this form or slower.
//     16-position planes also make the depth ceil(length / 16) * 16 *
//     alphabet_pad, 320 bytes where length 50 needs 250.
//
//   - any other alphabet_pad: pairs_within_simt_kernel.  A thread owns one
//     output row and 8 columns; per pair and 4-symbol word it XORs, turns
//     zero bytes into 0x80 flags (carry-free), masks with the row's
//     valid-symbol flags and adds the flags to a counter with one byte
//     lane per symbol position; the lanes are summed once per staged chunk
//     of 16 words.  Only words holding real columns are walked.  Bound:
//     integer instructions (6 per pair and word, plus one shared-memory
//     load per 8).  The kernel this replaced spent 9 per pair and word:
//     the shared-memory load, 5 for __vcmpeq4 (it is emulated: two LOP3,
//     IADD3, LOP3, PRMT), the valid-mask AND, POPC (16 lanes per SM and
//     clock) and the add, and spilled its chunk counter to the stack.
//
// * rowwise_within_kernel replaces rowwise_within_packed: per pair of
//   nibble-packed rows (8 symbols per 32-bit lane), XOR, collapse each
//   nibble to one bit, popcount, sum over lanes, test <= d.  One thread
//   per pair reads its two rows from the row-major [P, lanes] layout.
//   Bound on the H100: device-memory bytes (8 B read per lane per pair,
//   about 6 instructions per lane).
//
// * rowwise_within_indexed_kernel is the same function over int32 index
//   pairs into one resident [n, lanes] matrix: the pair-list route's
//   launch, where the JAX package gathers with jnp.take and verifies in
//   one jitted program.  Its bound counts 8 B of indices a pair and each
//   distinct row once; the kernel gathers two rows a pair, and at the
//   route's shapes the rows sit in L2 and are read again and again (a
//   row of a bucket of s keys by s - 1 pairs).  What holds it below the
//   bound on the H100 (PERF.md): on pairs that share no rows, the
//   sectors its gathers read from L2 (a 52-byte row spans 2.5 sectors of
//   32 B on average, two rows a pair); on the route's batches of 10^4 to
//   10^5 pairs, a launch's fixed cost and one round trip for the indices
//   before the rows' loads can start.  The design:
//   - a warp takes a span of 32 consecutive pairs (128 at 2 lanes, four
//     a thread) and loads their indices coalesced;
//   - a group of threads shares a pair (rowwise.cuh: group_size), so one
//     load instruction asks for 16 to 32 contiguous bytes of each of
//     several rows, where one thread a pair asked for one word of 32
//     rows; at 2 lanes a thread is a pair and reads a row in one 8-byte
//     load;
//   - a thread issues the loads of both rows of up to 16 steps, a pair
//     each, before it folds any of them, one lane of each row a round,
//     the width at run time (an instance of 13 lanes with both rounds'
//     loads in flight was 8% slower on random pairs and 4% faster on
//     dense's batch: PERF.md);
//   - a transposed reduction (g - 1 shuffles for g pairs) leaves thread
//     t with pair t's count, so a warp writes 32 consecutive bytes;
//   - rows read again by the pairs of a span come from L1.  Staging each
//     block's distinct rows in shared memory behind a hash table was
//     slower at every shape measured (atomics on one slot serialize where
//     many pairs share a row), and so was taking a step's a row from the
//     step before in registers (PERF.md).
//
// Entry points take raw device pointers and PyTorch's current stream,
// allocate nothing, do not synchronise, and return the first CUDA error.
//
// Built with -DFQD_PHASE_TIMES (chip_smoke.py --phases does, into a
// library of its own), the tensor-core kernel also records %globaltimer at
// the phase boundaries of each block's first 8 stages, read back through
// fqd_phase_times_read.

#include <cuda_runtime.h>

#include <cstdint>

#include "rowwise.cuh"

#ifdef FQD_PHASE_TIMES
constexpr int kTimedBlocks = 512, kTimedStages = 8, kTimedMarks = 8;
__device__ long long fqd_phase_times[kTimedBlocks * kTimedStages *
                                     kTimedMarks];
#define FQD_MARK(k)                                                       \
  if (tid == 0 && index < kTimedStages && blockIdx.x < kTimedBlocks) {    \
    long long t;                                                          \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                 \
    fqd_phase_times[(blockIdx.x * kTimedStages + index) * kTimedMarks +   \
                    (k)] = t;                                             \
  }
#else
#define FQD_MARK(k)
#endif

namespace {

// ---- tensor-core route (alphabet_pad 5 to 8) -------------------------- //

constexpr int kTile = 128;      // output rows and columns per block
constexpr int kThreads = 256;   // two warpgroups, 64 output rows each
constexpr int kMmaMinAlphabet = 5;  // alphabet_pad the tensor-core route takes
constexpr int kMmaMaxAlphabet = 8;
// Shared-memory operand tile: [16 row groups][units][8 rows][16 B].  A
// unit is one symbol's one-hot plane over 16 positions: 16 bytes of depth
// for 8 rows, which is exactly one wgmma core matrix.  A stage of the
// pipeline is 40 KB: four 16-position groups of one operand where every
// tile is a whole bucket (a == b, S = 128), else two groups of both.
constexpr int kUnitBytes = 128;
constexpr int kStageBytes = 40960;
constexpr int kMmaSmemBytes = 2 * kStageBytes;  // two stages in flight
// 16-byte row pieces of one stage that a thread loads and expands.
constexpr int kItems = 2;

template <bool kBuckets>
struct Geometry {
  static constexpr int kOperands = kBuckets ? 1 : 2;
  static constexpr int kGroups = kBuckets ? 4 : 2;  // at alphabet_pad <= 5
  static constexpr int kUnits = 5 * kGroups;
  static constexpr int kRowGroupBytes = kUnits * kUnitBytes;
  static constexpr int kOperandBytes = (kTile / 8) * kRowGroupBytes;
  static_assert(kOperands * kOperandBytes == kStageBytes, "stage size");
  static_assert(kOperands * kTile * kGroups == kItems * kThreads, "items");
};

__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t selector) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(selector));
  return d;
}

// Four symbols (one per byte of v) as the four selector nibbles of a prmt
// that reads an 8-byte pool: nibble = symbol for symbols 0..7, and 8 | x
// for any symbol above 7, which makes prmt replicate the sign bit of a
// pool byte.  Pool bytes are 0 or 1, so such a symbol expands to zero.
__device__ __forceinline__ uint32_t symbol_selector(uint32_t v) {
  const uint32_t u = v | (v >> 1);
  // Bit 3 of each byte: any of the symbol's bits 3..7 (all taken from
  // inside the byte, so neighbours do not leak in).
  const uint32_t high = (u | (u >> 2) | (v >> 4)) & 0x08080808u;
  const uint32_t w = (v & 0x07070707u) | high;
  return prmt(w | (w >> 4), 0u, 0x4420u);
}

struct Problem {
  const uint8_t* a;
  const uint8_t* b;
  uint8_t* out;
  int n, m, lp;
  long long a_batch_bytes, b_batch_bytes;
  int groups;       // position groups holding real columns
  int chunk_shift;  // log2 of the position groups per stage
  int ap;
  int min_matches;
  int tiles;        // batch * (n / 128) * (m / 128)
};

// Where a block stands in its run of consecutive output tiles (columns
// fastest, then rows, then batch entries) and in the tile's depth.
struct Cursor {
  int tx, ty, z;
  int chunk;
};

// (Where every tile is a whole bucket, kBuckets, tx and ty stay 0 and the
// compiler drops what depends on them.)
template <bool kBuckets>
__device__ __forceinline__ Cursor advance(const Problem& p, Cursor c) {
  const int chunks = (p.groups + (1 << p.chunk_shift) - 1) >> p.chunk_shift;
  const bool next_tile = c.chunk + 1 == chunks;
  c.chunk = next_tile ? 0 : c.chunk + 1;
  if (kBuckets) {
    c.z += next_tile;
    return c;
  }
  c.tx += next_tile;
  const bool next_row = c.tx == p.m / kTile;
  c.tx = next_row ? 0 : c.tx;
  c.ty += next_row;
  const bool next_entry = c.ty == p.n / kTile;
  c.ty = next_entry ? 0 : c.ty;
  c.z += next_entry;
  return c;
}

// One step of a block's work: `groups` position groups from g0 of the
// rows of one output tile.
struct Stage {
  const uint8_t* a_rows;
  const uint8_t* b_rows;
  uint8_t* out_tile;  // byte of output row 0, column 0 of the tile
  int g0;
  int groups;
  bool one_tile;  // a diagonal tile of a bucket: one expansion is both operands
  bool last;      // the tile's last stage: the epilogue follows
};

template <bool kBuckets>
__device__ __forceinline__ Stage stage_at(const Problem& p, const Cursor& c) {
  const int chunks = (p.groups + (1 << p.chunk_shift) - 1) >> p.chunk_shift;
  const int row0 = kBuckets ? 0 : c.ty * kTile;
  const int col0 = kBuckets ? 0 : c.tx * kTile;
  Stage s;
  s.a_rows = p.a + c.z * p.a_batch_bytes + (long long)row0 * p.lp;
  s.b_rows = kBuckets
                 ? s.a_rows
                 : p.b + c.z * p.b_batch_bytes + (long long)col0 * p.lp;
  s.out_tile =
      p.out + ((long long)c.z * p.n + row0) * (p.m / 8) + col0 / 8;
  s.g0 = c.chunk << p.chunk_shift;
  s.groups = min(1 << p.chunk_shift, p.groups - s.g0);
  s.one_tile = kBuckets || s.a_rows == s.b_rows;
  s.last = c.chunk == chunks - 1;
  return s;
}

// A thread's share of every stage: item c = tid + 256 * k is row (c / 8 /
// chunk) * 8 + c % 8, position group (c / 8) % chunk of operand a, then
// the same of operand b (chunk: the position groups per stage, a power of
// two).  Consecutive threads take the 8 rows of a row group, then the next
// position group, so a warp reads whole rows and every quarter warp
// writes one contiguous 128-byte core matrix.
struct Item {
  bool in_tile;
  int operand, g;
  int row_bytes;   // offset of the 16 symbols in the tile's rows, at g0 = 0
  int tile_bytes;  // offset of plane 0 in the stage's shared memory
};

template <bool kBuckets>
__device__ __forceinline__ Item item_at(const Problem& p, int k, int tid) {
  using G = Geometry<kBuckets>;
  const int per_operand = kTile << p.chunk_shift;
  const int c = tid + k * kThreads;
  Item it;
  it.operand = c >= per_operand;
  const int i = c - it.operand * per_operand;
  const int r8 = i & 7;
  const int row_group = i >> (3 + p.chunk_shift);
  it.g = (i >> 3) & ((1 << p.chunk_shift) - 1);
  it.in_tile = row_group < kTile / 8;
  it.row_bytes = (row_group * 8 + r8) * p.lp + it.g * 16;
  it.tile_bytes = it.operand * G::kOperandBytes +
                  row_group * G::kRowGroupBytes + it.g * p.ap * kUnitBytes +
                  r8 * 16;
  return it;
}

__device__ __forceinline__ bool in_stage(const Item& it, const Stage& s) {
  return it.in_tile && it.g < s.groups && !(it.operand && s.one_tile);
}

__device__ __forceinline__ void load_stage(const Stage& s,
                                           const Item (&items)[kItems],
                                           uint4 (&raw)[kItems]) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (in_stage(items[k], s)) {
      const uint8_t* rows = items[k].operand ? s.b_rows : s.a_rows;
      raw[k] = __ldg(reinterpret_cast<const uint4*>(
          rows + items[k].row_bytes + s.g0 * 16));
    }
  }
}

// The one-hot plane of symbol kSymbol over 16 positions.
template <int kSymbol>
__device__ __forceinline__ void store_plane(uint8_t* dst, uint32_t s0,
                                            uint32_t s1, uint32_t s2,
                                            uint32_t s3) {
  // The pool of the plane: byte kSymbol is 1, the other seven are 0.
  constexpr uint32_t lo = kSymbol < 4 ? 1u << (8 * (kSymbol & 3)) : 0u;
  constexpr uint32_t hi = kSymbol < 4 ? 0u : 1u << (8 * (kSymbol & 3));
  *reinterpret_cast<uint4*>(dst + kSymbol * kUnitBytes) = make_uint4(
      prmt(lo, hi, s0), prmt(lo, hi, s1), prmt(lo, hi, s2), prmt(lo, hi, s3));
}

// One-hot the loaded rows into the stage's operand tiles.
template <bool kBuckets>
__device__ __forceinline__ void expand_stage(const Stage& s, const Problem& p,
                                             int tid,
                                             const Item (&items)[kItems],
                                             const uint4 (&raw)[kItems],
                                             uint8_t* tiles) {
  using G = Geometry<kBuckets>;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (in_stage(items[k], s)) {
      const uint32_t s0 = symbol_selector(raw[k].x);
      const uint32_t s1 = symbol_selector(raw[k].y);
      const uint32_t s2 = symbol_selector(raw[k].z);
      const uint32_t s3 = symbol_selector(raw[k].w);
      uint8_t* dst = tiles + items[k].tile_bytes;
      store_plane<0>(dst, s0, s1, s2, s3);
      store_plane<1>(dst, s0, s1, s2, s3);
      store_plane<2>(dst, s0, s1, s2, s3);
      store_plane<3>(dst, s0, s1, s2, s3);
      store_plane<4>(dst, s0, s1, s2, s3);
      if (p.ap > 5) {  // this route's alphabet_pad is 5 to 8
        store_plane<5>(dst, s0, s1, s2, s3);
        if (p.ap > 6) store_plane<6>(dst, s0, s1, s2, s3);
        if (p.ap > 7) store_plane<7>(dst, s0, s1, s2, s3);
      }
    }
  }
  // The product walks the depth two units (32 bytes) at a time.
  const int units = s.groups * p.ap;
  if ((units & 1) && (tid < kTile || !s.one_tile)) {
    const int r = tid & (kTile - 1);
    *reinterpret_cast<uint4*>(tiles + (tid >> 7) * G::kOperandBytes +
                              (r >> 3) * G::kRowGroupBytes +
                              units * kUnitBytes + (r & 7) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// wgmma descriptor of an operand tile: depth-major ("K-major"), no
// swizzle.  The next 16 bytes of depth lie kUnitBytes on (leading byte
// offset), the next 8 rows row_group_bytes on (stride byte offset).
__device__ __forceinline__ uint64_t operand_descriptor(const uint8_t* tile,
                                                       int row_group_bytes) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(tile);
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(kUnitBytes >> 4) << 16) |
         ((uint64_t)(row_group_bytes >> 4) << 32);
}

#define FQD_ACC4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define FQD_ACC16(i) FQD_ACC4(i), FQD_ACC4(i + 4), FQD_ACC4(i + 8), \
                     FQD_ACC4(i + 12)

// d[64 rows x 128 columns, int32] = a[64 x 32 bytes] * b[128 x 32 bytes]^T
// (+ d unless `accumulate` is 0).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t a,
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : FQD_ACC16(0), FQD_ACC16(16), FQD_ACC16(32), FQD_ACC16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving or copying accumulators across the
// asynchronous product.
__device__ __forceinline__ void accumulator_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Threshold the accumulators of one 64 x 128 warpgroup tile and store
// them bit-packed.  Accumulator i of a thread is output row 16 * warp +
// lane / 4 + 8 * h, column 8 * j + 2 * (lane % 4) + e, with i = 4 * j +
// 2 * h + e.  A thread gathers its bits of both rows into four 32-bit
// words each (length - matches <= d  <=>  matches >= length - d); the four
// lanes of a quad then hold disjoint bits of the same two rows.
__device__ __forceinline__ void store_within(const int (&acc)[64],
                                             int min_matches, uint8_t* out_tile,
                                             int row_bytes, int tid) {
  const int lane = tid & 31;
  const int quad = lane & 3;
  uint32_t bits[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int word = 0; word < 4; ++word) {
      uint32_t v = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // One compare and one predicated OR per accumulator.
          asm("{\n.reg .pred p;\nsetp.ge.s32 p, %1, %2;\n"
              "@p or.b32 %0, %0, %3;\n}"
              : "+r"(v)
              : "r"(acc[(word * 4 + jj) * 4 + h * 2 + e]), "r"(min_matches),
                "r"(1u << (8 * jj + e)));
        }
      }
      bits[h][word] = v << (2 * quad);
    }
  }
  // Lanes 0 and 2 of a quad collect row h = 0, lanes 1 and 3 row h = 1;
  // then lane 0 merges lane 2's half and lane 1 lane 3's.
  uint32_t keep[4];
#pragma unroll
  for (int word = 0; word < 4; ++word) {
    const bool odd = quad & 1;
    const uint32_t send = odd ? bits[0][word] : bits[1][word];
    keep[word] = (odd ? bits[1][word] : bits[0][word]) |
                 __shfl_xor_sync(0xFFFFFFFFu, send, 1);
  }
#pragma unroll
  for (int word = 0; word < 4; ++word) {
    keep[word] |= __shfl_xor_sync(0xFFFFFFFFu, keep[word], 2);
  }
  if (quad < 2) {
    const int row = (tid >> 5) * 16 + (lane >> 2) + 8 * quad;
    *reinterpret_cast<uint4*>(out_tile + (long long)row * row_bytes) =
        make_uint4(keep[0], keep[1], keep[2], keep[3]);
  }
}

// A persistent block walks a run of consecutive output tiles stage by
// stage through two shared-memory buffers.  The products of stage s are
// issued first; the threads then one-hot stage s + 1 into the other buffer
// and, after the proxy fence (which would otherwise wait for them), start
// the loads of stage s + 2.  Issuing the products holds a warpgroup for
// most of their duration, so what overlaps them is mainly the other
// block on the SM; what the order buys is that no load is waited for.
template <bool kBuckets>
__global__ void __launch_bounds__(kThreads, 2)
pairs_within_mma_kernel(const Problem p) {
  using G = Geometry<kBuckets>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int chunks = (p.groups + (1 << p.chunk_shift) - 1) >> p.chunk_shift;
  const int first_tile = (long long)p.tiles * blockIdx.x / gridDim.x;
  const int end_tile = (long long)p.tiles * (blockIdx.x + 1) / gridDim.x;
  const int stages = (end_tile - first_tile) * chunks;
  Cursor cursor;
  cursor.tx = first_tile % (p.m / kTile);
  cursor.ty = first_tile / (p.m / kTile) % (p.n / kTile);
  cursor.z = first_tile / ((p.m / kTile) * (p.n / kTile));
  cursor.chunk = 0;

  Item items[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) items[k] = item_at<kBuckets>(p, k, tid);

  uint4 raw[kItems];
  load_stage(stage_at<kBuckets>(p, cursor), items, raw);
  expand_stage<kBuckets>(stage_at<kBuckets>(p, cursor), p, tid, items, raw,
                         smem);
  // The product reads shared memory through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (stages > 1) {
    load_stage(stage_at<kBuckets>(p, advance<kBuckets>(p, cursor)), items,
               raw);
  }
  __syncthreads();

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int index = 0; index < stages; ++index) {
    // Recomputed from the cursor every time: a stage carried in registers
    // across iterations makes the compiler treat the products below as
    // divergent and serialize them.
    FQD_MARK(0)
    const Stage now = stage_at<kBuckets>(p, cursor);
    cursor = advance<kBuckets>(p, cursor);
    uint8_t* tiles = smem + (index & 1) * kStageBytes;
    uint64_t desc_a = operand_descriptor(
        tiles + (tid >> 7) * (kTile / 16) * G::kRowGroupBytes,
        G::kRowGroupBytes);
    uint64_t desc_b = operand_descriptor(
        now.one_tile ? tiles : tiles + G::kOperandBytes, G::kRowGroupBytes);
    accumulator_fence(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    // A tile's first product overwrites the accumulators: no other
    // instruction ever writes them, which would serialize the products.
    int accumulate = now.g0 != 0;
    for (int step = (now.groups * p.ap + 1) >> 1; step > 0; --step) {
      wgmma_m64n128k32_s8(acc, desc_a, desc_b, accumulate);
      accumulate = 1;
      desc_a += (2 * kUnitBytes) >> 4;
      desc_b += (2 * kUnitBytes) >> 4;
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    FQD_MARK(1)  // products issued
    if (index + 1 < stages) {
      expand_stage<kBuckets>(stage_at<kBuckets>(p, cursor), p, tid, items, raw,
                             smem + ((index + 1) & 1) * kStageBytes);
      FQD_MARK(2)  // next stage expanded
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      FQD_MARK(3)  // fenced
      if (index + 2 < stages) {
        load_stage(stage_at<kBuckets>(p, advance<kBuckets>(p, cursor)),
                   items, raw);
      }
    }
    FQD_MARK(4)  // loads issued
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    accumulator_fence(acc);
    FQD_MARK(5)  // products done
    if (now.last) {
      store_within(acc, p.min_matches, now.out_tile, p.m / 8, tid);
    }
    FQD_MARK(6)  // thresholded and stored
    // Every warpgroup is done with this stage's buffer, and the next
    // stage's is written.
    __syncthreads();
    FQD_MARK(7)
  }
}

// ---- SIMT route (any other alphabet_pad) ------------------------------ //

constexpr int kRows = 32;             // output rows per block: one per lane
constexpr int kColBytes = 16;         // output bytes per row: one per warp
constexpr int kCols = kColBytes * 8;  // 128 output columns per block
constexpr int kChunkWords = 16;       // width staged per pass: 64 symbols

__global__ void __launch_bounds__(kRows * kColBytes)
pairs_within_simt_kernel(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b,
                         uint8_t* __restrict__ out, int n, int m,
                         int lp_words, int words, long long a_batch_words,
                         long long b_batch_words, int min_matches,
                         uint32_t alphabet4) {
  // One word of padding per a-row: lanes read sa[lane][w] at an odd
  // stride, so the 32 lanes of a warp hit 32 different banks.
  __shared__ uint32_t sa[kRows][kChunkWords + 1];
  __shared__ uint32_t sv[kRows][kChunkWords + 1];  // 0x80 per a byte < Ap
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

  for (int w0 = 0; w0 < words; w0 += kChunkWords) {
    const int cw = min(kChunkWords, words - w0);
    for (int t = tid; t < kRows * cw; t += nthreads) {
      const int r = t / cw;
      const int w = t - r * cw;
      const uint32_t v = a_rows[(long long)r * lp_words + w0 + w];
      sa[r][w] = v;
      sv[r][w] = __vcmpltu4(v, alphabet4) & 0x80808080u;
    }
    for (int t = tid; t < kCols * cw; t += nthreads) {
      const int r = t / cw;
      const int w = t - r * cw;
      sb[r][w] = b_rows[(long long)r * lp_words + w0 + w];
    }
    __syncthreads();
    // One counter per byte lane: a word adds at most 1 to each, and a
    // chunk has at most 16 words, so the four lanes sum below 256.
    uint32_t lanes[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) lanes[j] = 0;
    for (int w = 0; w < cw; ++w) {
      const uint32_t av = sa[lane][w];
      const uint32_t valid = sv[lane][w];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // Bit 7 of each byte of t: that byte of x is not zero.
        const uint32_t x = av ^ sb[byte * 8 + j][w];
        const uint32_t t = ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
        lanes[j] += (~t & valid) >> 7;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) count[j] += (lanes[j] * 0x01010101u) >> 24;
    __syncthreads();
  }

  // length - matches <= d  <=>  matches >= length - d.
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bits |= (count[j] >= min_matches ? 1u : 0u) << j;
  }
  const long long out_row = z * n + row0 + lane;
  out[out_row * (m / 8) + blockIdx.x * kColBytes + byte] = (uint8_t)bits;
}

// Symbols that differ between two nibble-packed rows of `lanes` lanes.
__device__ __forceinline__ int nibble_mismatches(
    const uint32_t* __restrict__ ra, const uint32_t* __restrict__ rb,
    int lanes) {
  int mismatches = 0;
  for (int k = 0; k < lanes; ++k) {
    mismatches += fqd_rowwise::lane_mismatches(ra[k] ^ rb[k]);
  }
  return mismatches;
}

__global__ void rowwise_within_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b,
                                      uint8_t* __restrict__ out,
                                      long long p, int lanes,
                                      int max_distance) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const int mismatches = nibble_mismatches(a + i * lanes, b + i * lanes,
                                           lanes);
  out[i] = mismatches <= max_distance ? 1 : 0;
}

// ---- indexed pair lists (the pair-list route) ------------------------- //

namespace rw = fqd_rowwise;

constexpr int kRowwiseThreads = 128;  // four warps, a span of pairs each
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// Steps whose row loads a thread issues before it folds the first.
constexpr int kStepsInFlight = 16;
// Pairs a thread takes at 2 lanes, where a thread is a group.
constexpr int kTwoLaneRounds = 4;

// The answer for pair i of rows gi[i] and gj[i] of one resident packed
// matrix.  A warp takes the span of kSpan pairs from `base`, G threads a
// pair (rowwise.cuh); TWO_LANES: rows of two lanes, 8-byte aligned, one
// thread a pair and kTwoLaneRounds spans a warp.  Every thread of a warp
// with pairs runs to the end, as the shuffles need the whole warp.  A
// pair past the end reads row 0, which exists: some real pair indexes
// the matrix.
template <int G, bool TWO_LANES>
__global__ void __launch_bounds__(kRowwiseThreads)
rowwise_within_indexed_kernel(const uint32_t* __restrict__ packed,
                              const int* __restrict__ gi,
                              const int* __restrict__ gj,
                              uint8_t* __restrict__ out, long long p,
                              int lanes, int max_distance) {
  static_assert(G == 1 || !TWO_LANES, "two lanes are one thread's");
  constexpr int kRounds = TWO_LANES ? kTwoLaneRounds : 1;
  const int t = threadIdx.x % rw::kSpan;
  const long long base =
      ((long long)blockIdx.x * kRowwiseThreads + threadIdx.x - t) * kRounds;
  if (base >= p) return;  // a whole warp

  if constexpr (TWO_LANES) {
    // One 8-byte load a row, pairs t, t + 32, ... of the span, every load
    // in flight before the first fold.  The 32 pairs of one load
    // instruction are consecutive, so their shared a rows are one
    // request.
    int ia[kRounds], ib[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const long long i = base + rw::kSpan * r + t;
      ia[r] = i < p ? gi[i] : 0;
      ib[r] = i < p ? gj[i] : 0;
    }
    uint2 a[kRounds], b[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      a[r] = __ldg((const uint2*)packed + ia[r]);
      b[r] = __ldg((const uint2*)packed + ib[r]);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const long long i = base + rw::kSpan * r + t;
      const int count = rw::lane_mismatches(a[r].x ^ b[r].x) +
                        rw::lane_mismatches(a[r].y ^ b[r].y);
      if (i < p) out[i] = rw::within(count, max_distance) ? 1 : 0;
    }
  } else {
    constexpr int kChunk = G < kStepsInFlight ? G : kStepsInFlight;
    const bool mine = base + t < p;
    const int own_i = mine ? gi[base + t] : 0;
    const int own_j = mine ? gj[base + t] : 0;
    const int group = t / G, rank = t % G;
    int count[G];
#pragma unroll
    for (int s = 0; s < G; ++s) count[s] = 0;
#pragma unroll
    for (int s0 = 0; s0 < G; s0 += kChunk) {
      // The rows of the group's pairs at steps s0 .. s0 + kChunk - 1,
      // from the threads that loaded their indices.
      int ia[kChunk], ib[kChunk];
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const int q = rw::pair_of(group, s0 + s, G);
        ia[s] = G == 1 ? own_i : __shfl_sync(kFullMask, own_i, q);
        ib[s] = G == 1 ? own_j : __shfl_sync(kFullMask, own_j, q);
      }
      // One lane of each row of the chunk's steps at a time, the loads
      // of both rows of every step in flight before the first fold.
#pragma unroll 1
      for (int k = 0; k < rw::loads_per_row(lanes, G); ++k) {
        const int lane = rw::lane_of(rank, k, G);
        const bool real = lane < lanes;
        uint32_t wa[kChunk], wb[kChunk];
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {
          wa[s] = real ? __ldg(packed + (long long)ia[s] * lanes + lane) : 0u;
          wb[s] = real ? __ldg(packed + (long long)ib[s] * lanes + lane) : 0u;
        }
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {
          count[s0 + s] += rw::lane_mismatches(wa[s] ^ wb[s]);
        }
      }
    }
    // Thread t ends with the count of pair t of the span.
#pragma unroll
    for (int half = G / 2; half >= 1; half /= 2) {
      const int mask = rw::reduce_mask(rank, half);
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const int sent = __shfl_xor_sync(
            kFullMask, rw::reduce_send(count[j], count[j + half], mask),
            half);
        count[j] = rw::reduce_keep(count[j], count[j + half], mask) + sent;
      }
    }
    if (mine) out[base + t] = rw::within(count[0], max_distance) ? 1 : 0;
  }
}

template <int G, bool TWO_LANES = false>
void launch_indexed(const void* packed, const void* gi, const void* gj,
                    void* out, long long p, int lanes, int max_distance,
                    cudaStream_t stream) {
  constexpr long long kBlockPairs =
      (long long)kRowwiseThreads * (TWO_LANES ? kTwoLaneRounds : 1);
  const long long blocks = (p + kBlockPairs - 1) / kBlockPairs;
  if (blocks > 0) {
    rowwise_within_indexed_kernel<G, TWO_LANES>
        <<<(unsigned int)blocks, kRowwiseThreads, 0, stream>>>(
            (const uint32_t*)packed, (const int*)gi, (const int*)gj,
            (uint8_t*)out, p, lanes, max_distance);
  }
}

// Nothing: the fixed cost of one launch, the floor under the shortest
// kernels' times (chip_smoke.py).
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// a: uint8 [batch, n, lp], b: uint8 [batch, m, lp], rows 16-byte aligned
// with lp a multiple of 16 and 0xFF in every column at or past `length`;
// out: uint8 [batch, n, m / 8].  n and m must be multiples of 128 (the
// wrapper checks).  alphabet_pad alone picks the route: from 5 to 8 the
// tensor-core kernel, otherwise the SIMT kernel.
int fqd_pairs_within_packed(const void* a, const void* b, void* out,
                            int batch, int n, int m, int lp,
                            long long a_batch_stride,
                            long long b_batch_stride, int length,
                            int max_distance, int alphabet_pad,
                            void* stream) {
  const int min_matches = length - max_distance;
  const int width = length < lp ? length : lp;  // the real columns
  if (alphabet_pad >= kMmaMinAlphabet && alphabet_pad <= kMmaMaxAlphabet) {
    const long long tiles = (long long)batch * (n / kTile) * (m / kTile);
    if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    // Every tile a whole bucket: one operand per stage, four groups deep.
    const bool buckets = a == b && n == kTile && m == kTile &&
                         a_batch_stride == b_batch_stride;
    const auto kernel = buckets ? pairs_within_mma_kernel<true>
                                : pairs_within_mma_kernel<false>;
    int device = 0, sms = 0;
    cudaError_t status = cudaGetDevice(&device);
    if (status == cudaSuccess) {
      status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
    }
    if (status == cudaSuccess) {
      status = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
    }
    if (status != cudaSuccess) return (int)status;
    Problem p;
    p.a = (const uint8_t*)a;
    p.b = (const uint8_t*)b;
    p.out = (uint8_t*)out;
    p.n = n;
    p.m = m;
    p.lp = lp;
    p.a_batch_bytes = a_batch_stride;
    p.b_batch_bytes = b_batch_stride;
    p.groups = width > 16 ? (width + 15) / 16 : 1;
    p.ap = alphabet_pad;
    // Position groups per stage: 4 or 2 up to alphabet_pad 5, half above.
    p.chunk_shift = (buckets ? 2 : 1) - (alphabet_pad > 5 ? 1 : 0);
    p.min_matches = min_matches;
    p.tiles = (int)tiles;
    // Two blocks fit an SM (registers and shared memory).
    const int blocks = tiles < 2 * sms ? (int)tiles : 2 * sms;
    if (blocks > 0) {
      kernel<<<blocks, kThreads, kMmaSmemBytes, (cudaStream_t)stream>>>(p);
    }
  } else {
    const dim3 block(kRows, kColBytes);
    const dim3 grid(m / kCols, n / kRows, batch);
    const uint32_t alphabet4 = 0x01010101u * (uint32_t)alphabet_pad;
    pairs_within_simt_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint8_t*)out, n, m, lp / 4,
        (width + 3) / 4, a_batch_stride / 4, b_batch_stride / 4, min_matches,
        alphabet4);
  }
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

// packed: 32-bit lanes [n, lanes], row-major; gi, gj: int32 [p] row
// indices in [0, n) (the caller checks); out: bool [p].  Any width:
// 2 lanes in 8-byte aligned rows have an instance of their own, every
// other width the instance of its group size.
int fqd_rowwise_within_packed_indexed(const void* packed, const void* gi,
                                      const void* gj, void* out, long long p,
                                      int lanes, int max_distance,
                                      void* stream) {
  if (p > 0x7FFFFFFFLL * kRowwiseThreads) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 2 && (uintptr_t)packed % 8 == 0) {
    launch_indexed<1, true>(packed, gi, gj, out, p, lanes, max_distance, s);
    return (int)cudaGetLastError();
  }
  const int g = rw::group_size(lanes);
  if (g == 1) {
    launch_indexed<1>(packed, gi, gj, out, p, lanes, max_distance, s);
  } else if (g == 4) {
    launch_indexed<4>(packed, gi, gj, out, p, lanes, max_distance, s);
  } else if (g == 8) {
    launch_indexed<8>(packed, gi, gj, out, p, lanes, max_distance, s);
  } else {
    launch_indexed<32>(packed, gi, gj, out, p, lanes, max_distance, s);
  }
  return (int)cudaGetLastError();
}

// One launch of an empty kernel of `blocks` blocks of `threads` threads.
int fqd_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

#ifdef FQD_PHASE_TIMES
// dst: host buffer for [512 blocks][8 stages][8 marks] int64 nanoseconds.
int fqd_phase_times_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, fqd_phase_times,
                                   sizeof(fqd_phase_times));
}
#endif

const char* fqd_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
