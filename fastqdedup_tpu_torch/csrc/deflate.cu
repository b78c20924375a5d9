// BGZF deflate kernel for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package deflates its outputs on the
// host (fastqdedup_tpu/io/bgzf.py), and so did the port.  Pass 3 of a job
// writes tens of MB of FASTQ as BGZF, independent gzip members of at most
// 65,280 input bytes, and the host's compressor threads set the pace of
// the pass while the card is idle.  This kernel deflates a window of
// members, one thread block a member, under the rule that
// ops/deflate_kernels.py states and its plain version applies: the two
// give the same bytes.
//
// Bound: the bytes read and written, about 1.45 bytes a input byte at
// level-1 ratios, 37 us for a job's 86 MB at 3.35 TB/s.  A member's work
// is a chain of phases, a few of them serial (a hash table walked in
// order, a greedy parse, Huffman codes), so a block takes as long as its
// serial steps and the launch as long as one block: one wave of up to
// 132 members.  The design keeps each member's work in shared memory
// (about 214 KB: one block an SM) and each serial step on one warp or
// one thread:
// * Load: the member into shared memory with 16-byte loads, zero-padded.
// * Candidates: warp 0 walks the member in chunks of 32 positions, in
//   order; each lane hashes its position's 4 bytes, __match_any_sync
//   gives it the nearest earlier lane of its chunk with the same hash,
//   and a lane with none reads a hash table in shared memory (the latest
//   position of each of 2^15 hashes), which each group's last lane then
//   writes.  The nearest earlier position with the same hash,
//   deterministically.  The other 31 warps compute the CRC-32
//   meanwhile: per-thread CRCs of 66-byte pieces, shifted by the bytes
//   after them and XORed (zlib's CRC combine).
// * Lengths (all threads): each position extends its candidate, 4 bytes
//   a step, to at most 258 bytes.
// * Parse: one thread walks the greedy parse from position 0 and marks
//   each token's start in a bitmap.
// * Codes: symbol counts with shared-memory atomics; symbols ranked by
//   (count, symbol) in parallel; Huffman lengths on one thread for each
//   table (lit/len and distance at once, on two warps), limited to 15
//   bits; the header on one thread.
// * Bits: every thread owns 64 positions; a block-wide exclusive scan of
//   its tokens' bit counts places them, and atomicOr writes them into the
//   shared output words.  A block longer than the member's bytes plus 5
//   becomes a stored block.
// * Write: the 18-byte BGZF header, the payload and the trailer into the
//   member's slot of the output, its length beside it.
//
// The serial steps (the candidate walk, the parse, the header) are hidden
// behind the host: the card writer's window of 128 members takes one
// wave, shorter than the host's gather of the next window.
//
// The entry point launches on the caller's stream, allocates nothing
// (the candidate positions go to the caller's scratch, 2 bytes a
// position), does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 65280;         // input bytes of a full member
constexpr int kStride = 65536;        // output bytes a member may take
constexpr int kThreads = 1024;
constexpr int kSpan = 64;             // positions a thread owns for tokens
constexpr int kCrcSpan = 66;          // bytes a CRC thread takes (31 warps)
constexpr int kHashBits = 15;
constexpr int kWindow = 32768;
constexpr int kMaxMatch = 258;
constexpr int kTooFar = 4096;
constexpr uint16_t kNone = 0xFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kCrcPoly = 0xEDB88320u;
constexpr int kInBytes = 65536 + 16;  // the member, zero-padded
constexpr int kLenBytes = 65536;      // match length - 3 a position
constexpr int kOutWords = 16384 + 64; // payload bits; the hash table first
constexpr int kStartWords = 2048;     // a bit a position: token starts
constexpr int kLitSyms = 286;
constexpr int kDistSyms = 30;
constexpr int kClSyms = 19;

__constant__ uint8_t kClOrder[kClSyms] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                          11, 4, 12, 3, 13, 2, 14, 1, 15};

struct Small {
  uint32_t lfreq[288];
  uint32_t dfreq[32];
  uint32_t cfreq[20];
  uint32_t lweight[2 * kLitSyms];
  uint32_t dweight[2 * kDistSyms];
  uint32_t crc_table[256];
  uint32_t x2n[32];
  uint32_t warp_sums[32];
  uint32_t crc_xor;
  int header_bits;
  int total_bits;
  int used_l;
  int used_d;
  uint16_t lparent[2 * kLitSyms];
  uint16_t dparent[2 * kDistSyms];
  uint16_t lsorted[288];
  uint16_t dsorted[32];
  uint16_t csorted[20];
  uint16_t lcode[288];
  uint16_t dcode[32];
  uint16_t ccode[20];
  uint8_t llen[288];
  uint8_t dlen[32];
  uint8_t clen[20];
  uint8_t item_sym[kLitSyms + kDistSyms];
  uint8_t item_extra[kLitSyms + kDistSyms];
};

constexpr size_t kSharedBytes = kInBytes + kLenBytes + 4 * kOutWords +
                                4 * kStartWords + sizeof(Small);

__device__ __forceinline__ uint32_t load4(const uint32_t* w, int p) {
  return __funnelshift_r(w[p >> 2], w[(p >> 2) + 1], (p & 3) * 8);
}

__device__ __forceinline__ uint32_t hash4(uint32_t v) {
  return (v * 0x1E35A7BDu) >> (32 - kHashBits);
}

__device__ __forceinline__ int len_code(int length) {
  if (length == kMaxMatch) return 28;
  const int x = length - 3;
  if (x < 8) return x;
  const int k = 31 - __clz(x);
  return 4 * (k - 1) + ((x >> (k - 2)) & 3);
}

__device__ __forceinline__ int len_extra_bits(int code) {
  return (code < 8 || code == 28) ? 0 : (code - 4) >> 2;
}

__device__ __forceinline__ int len_base(int code) {
  if (code < 8) return code + 3;
  if (code == 28) return kMaxMatch;
  return 3 + ((4 + (code & 3)) << len_extra_bits(code));
}

__device__ __forceinline__ int dist_code(int dist) {
  const int x = dist - 1;
  if (x < 4) return x;
  const int k = 31 - __clz(x);
  return 2 * k + ((x >> (k - 1)) & 1);
}

__device__ __forceinline__ int dist_extra_bits(int code) {
  return code < 4 ? 0 : (code >> 1) - 1;
}

__device__ __forceinline__ int dist_base(int code) {
  return code < 4 ? code + 1
                  : 1 + ((2 + (code & 1)) << dist_extra_bits(code));
}

// OR `bits` bits of `value` into the LSB-first stream at bit `pos`.
__device__ __forceinline__ void put_bits(uint32_t* words, int pos,
                                         uint32_t value, int bits) {
  if (bits == 0) return;
  const int w = pos >> 5;
  const int sh = pos & 31;
  atomicOr(&words[w], value << sh);
  if (sh + bits > 32) atomicOr(&words[w + 1], value >> (32 - sh));
}

// zlib's GF(2) product modulo the CRC polynomial (a != 0).
__device__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t m = 1u << 31;
  uint32_t p = 0;
  for (;;) {
    if (a & m) {
      p ^= b;
      if ((a & (m - 1)) == 0) break;
    }
    m >>= 1;
    b = (b & 1) ? (b >> 1) ^ kCrcPoly : b >> 1;
  }
  return p;
}

// The CRC register `crc` after `bytes` more zero bytes.
__device__ uint32_t crc_shift(const uint32_t* x2n, uint32_t crc,
                              uint32_t bytes) {
  uint32_t p = 1u << 31;  // x^0
  int k = 3;
  while (bytes) {
    if (bytes & 1) p = multmodp(x2n[k & 31], p);
    bytes >>= 1;
    ++k;
  }
  return multmodp(p, crc);
}

// Huffman lengths of one table on one thread: `sorted` holds its n >= 2
// used symbols by (count, symbol).  The rule of ops/deflate_kernels.py:
// two queues, a leaf before a node of equal weight, depths limited to
// `limit` by miniz's rule, lengths handed out shortest to the most
// frequent.
__device__ void huffman_lengths(const uint16_t* sorted, int n,
                                const uint32_t* freq, int nsym, int limit,
                                uint32_t* weight, uint16_t* parent,
                                uint8_t* lengths) {
  for (int s = 0; s < nsym; ++s) lengths[s] = 0;
  for (int i = 0; i < n; ++i) weight[i] = freq[sorted[i]];
  int leaf = 0;
  int node = n;
  for (int next = n; next < 2 * n - 1; ++next) {
    int pick[2];
    for (int k = 0; k < 2; ++k) {
      if (leaf < n && (node >= next || weight[leaf] <= weight[node])) {
        pick[k] = leaf++;
      } else {
        pick[k] = node++;
      }
    }
    weight[next] = weight[pick[0]] + weight[pick[1]];
    parent[pick[0]] = (uint16_t)next;
    parent[pick[1]] = (uint16_t)next;
  }
  weight[2 * n - 2] = 0;  // depths from here on
  for (int i = 2 * n - 3; i >= 0; --i) weight[i] = weight[parent[i]] + 1;
  int count[16] = {0};
  bool over = false;
  for (int i = 0; i < n; ++i) {
    int d = (int)weight[i];
    if (d > limit) {
      d = limit;
      over = true;
    }
    ++count[d];
  }
  if (over) {
    uint32_t total = 0;
    for (int i = 1; i <= limit; ++i) total += (uint32_t)count[i] << (limit - i);
    while (total != (1u << limit)) {
      --count[limit];
      for (int i = limit - 1; i > 0; --i) {
        if (count[i]) {
          --count[i];
          count[i + 1] += 2;
          break;
        }
      }
      --total;
    }
  }
  int j = n;
  for (int bits = 1; bits <= limit; ++bits) {
    for (int c = count[bits]; c > 0; --c) lengths[sorted[--j]] = (uint8_t)bits;
  }
}

// Canonical codes, bit-reversed for the LSB-first stream.
__device__ void canonical_codes(const uint8_t* lengths, int nsym,
                                uint16_t* codes) {
  int count[16] = {0};
  for (int s = 0; s < nsym; ++s) ++count[lengths[s]];
  count[0] = 0;
  int next[16];
  int code = 0;
  for (int bits = 1; bits < 16; ++bits) {
    code = (code + count[bits - 1]) << 1;
    next[bits] = code;
  }
  for (int s = 0; s < nsym; ++s) {
    const int l = lengths[s];
    if (l) codes[s] = (uint16_t)(__brev((uint32_t)next[l]++) >> (32 - l));
  }
}

// At least two used symbols: the lowest unused ones get a count of 1.
__device__ int force_two(uint32_t* freq, int nsym) {
  int used = 0;
  for (int s = 0; s < nsym; ++s) used += freq[s] != 0;
  for (int k = 0; used < 2; ++k) {
    if (freq[k] == 0) {
      freq[k] = 1;
      ++used;
    }
  }
  return used;
}

// sorted[rank] = symbol, rank by (count, symbol) among used symbols; one
// thread a symbol.
__device__ __forceinline__ void rank_symbol(const uint32_t* freq, int nsym,
                                            int s, uint16_t* sorted) {
  const uint32_t f = freq[s];
  if (f == 0) return;
  int r = 0;
  for (int j = 0; j < nsym; ++j) {
    const uint32_t g = freq[j];
    r += g != 0 && (g < f || (g == f && j < s));
  }
  sorted[r] = (uint16_t)s;
}

__global__ void __launch_bounds__(kThreads, 1)
    deflate_kernel(const uint8_t* __restrict__ in, long long total,
                   uint8_t* __restrict__ out, int* __restrict__ out_len,
                   uint16_t* __restrict__ cand_all) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_in = smem;
  const uint32_t* w_in = reinterpret_cast<const uint32_t*>(smem);
  uint8_t* s_len = smem + kInBytes;
  uint32_t* s_out = reinterpret_cast<uint32_t*>(smem + kInBytes + kLenBytes);
  uint16_t* head = reinterpret_cast<uint16_t*>(s_out);
  uint32_t* s_start = s_out + kOutWords;
  Small& s = *reinterpret_cast<Small*>(s_start + kStartWords);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long member = blockIdx.x;
  const int n = (int)min((long long)kBlock, total - member * kBlock);
  const uint8_t* src = in + member * kBlock;
  uint16_t* cand = cand_all + member * kStride;

  // Load, zero-pad, clear the tables.
  const int full = n >> 4;
  for (int i = tid; i < full; i += kThreads) {
    reinterpret_cast<uint4*>(s_in)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  for (int i = full * 16 + tid; i < kInBytes; i += kThreads) {
    s_in[i] = i < n ? src[i] : 0;
  }
  for (int i = tid; i < kOutWords; i += kThreads) s_out[i] = kFull;  // head
  for (int i = tid; i < 288; i += kThreads) s.lfreq[i] = 0;
  if (tid < 32) s.dfreq[tid] = 0;
  if (tid < 20) s.cfreq[tid] = 0;
  if (tid < 256) {
    uint32_t c = tid;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kCrcPoly : c >> 1;
    s.crc_table[tid] = c;
  }
  if (tid == 0) {
    uint32_t p = 1u << 30;  // x^1
    s.x2n[0] = p;
    for (int k = 1; k < 32; ++k) s.x2n[k] = p = multmodp(p, p);
    s.crc_xor = 0;
  }
  __syncthreads();
  if (tid == 0) s.lfreq[256] = 1;  // end of block

  const int m = n - 3;  // positions with 4 bytes to hash
  if (warp == 0) {
    // Chunks of 32 positions in order: within a chunk the nearest earlier
    // lane with the same hash; a lane with none (its group's first) reads
    // the hash table, which holds each hash's latest position, and the
    // group's last lane writes it.
    for (int c = 0; 32 * c < m; ++c) {
      const int p = 32 * c + lane;
      const bool act = p < m;
      const uint32_t h = act ? hash4(load4(w_in, p)) : 0xFFFFFFFFu;
      const uint32_t same = __match_any_sync(kFull, h);
      const uint32_t lower = same & ((1u << lane) - 1u);
      if (act) cand[p] = lower ? (uint16_t)(32 * c + 31 - __clz(lower))
                               : head[h];
      __syncwarp();
      if (act && (same >> lane) == 1u) head[h] = (uint16_t)p;
      __syncwarp();
    }
  } else {
    // CRC-32 of 66-byte pieces, each shifted past the bytes after it.
    const int lo = (tid - 32) * kCrcSpan;
    const int hi = min(lo + kCrcSpan, n);
    if (lo < hi) {
      uint32_t c = 0;
      for (int i = lo; i < hi; ++i) {
        c = (c >> 8) ^ s.crc_table[(c ^ s_in[i]) & 0xFF];
      }
      c = crc_shift(s.x2n, c, (uint32_t)(n - hi));
      atomicXor(&s.crc_xor, c);
    }
  }
  __syncthreads();

  // Match lengths; the output words are cleared (the hash table is done).
  for (int p = tid; p < n; p += kThreads) {
    int l = 0;
    if (p < m) {
      const int c = cand[p];
      if (c != kNone && p - c <= kWindow && load4(w_in, c) == load4(w_in, p)) {
        const int cap = min(kMaxMatch, n - p);
        l = 4;
        while (l < cap) {
          const uint32_t x = load4(w_in, c + l) ^ load4(w_in, p + l);
          if (x) {
            l += (__ffs(x) - 1) >> 3;
            break;
          }
          l += 4;
        }
        l = min(l, cap);
        if (l == 4 && p - c > kTooFar) l = 0;
      }
    }
    s_len[p] = (uint8_t)(l ? l - 3 : 0);
  }
  for (int i = tid; i < kOutWords; i += kThreads) s_out[i] = 0;
  for (int i = tid; i < kStartWords; i += kThreads) s_start[i] = 0;
  __syncthreads();

  // Greedy parse on one thread: a bit a token start.
  if (tid == 0) {
    uint32_t bits = 0;
    int word = 0;
    for (int p = 0; p < n;) {
      if ((p >> 5) != word) {
        s_start[word] = bits;
        bits = 0;
        word = p >> 5;
      }
      bits |= 1u << (p & 31);
      const int l8 = s_len[p];
      p += l8 ? l8 + 3 : 1;
    }
    s_start[word] = bits;
  }
  __syncthreads();

  // Symbol counts; every thread takes the tokens of its 64 positions.
  const int own = tid * kSpan;
  for (int w = 0; w < kSpan / 32; ++w) {
    uint32_t word = s_start[(own >> 5) + w];
    while (word) {
      const int p = own + 32 * w + __ffs(word) - 1;
      word &= word - 1;
      const int l8 = s_len[p];
      if (l8 == 0) {
        atomicAdd(&s.lfreq[s_in[p]], 1u);
      } else {
        atomicAdd(&s.lfreq[257 + len_code(l8 + 3)], 1u);
        atomicAdd(&s.dfreq[dist_code(p - cand[p])], 1u);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    s.used_l = force_two(s.lfreq, kLitSyms);
    s.used_d = force_two(s.dfreq, kDistSyms);
  }
  __syncthreads();
  if (tid < kLitSyms) rank_symbol(s.lfreq, kLitSyms, tid, s.lsorted);
  if (tid >= 512 && tid < 512 + kDistSyms) {
    rank_symbol(s.dfreq, kDistSyms, tid - 512, s.dsorted);
  }
  __syncthreads();
  if (tid == 0) {
    huffman_lengths(s.lsorted, s.used_l, s.lfreq, kLitSyms, 15, s.lweight,
                    s.lparent, s.llen);
  } else if (tid == 32) {
    huffman_lengths(s.dsorted, s.used_d, s.dfreq, kDistSyms, 15, s.dweight,
                    s.dparent, s.dlen);
  }
  __syncthreads();
  if (tid == 0) {
    // The header: table sizes, the code-length code, the code lengths.
    int hlit = kLitSyms;
    while (hlit > 257 && s.llen[hlit - 1] == 0) --hlit;
    int hdist = kDistSyms;
    while (hdist > 1 && s.dlen[hdist - 1] == 0) --hdist;
    const int all = hlit + hdist;
    int items = 0;
    int a = 0;
    while (a < all) {
      const int x = a < hlit ? s.llen[a] : s.dlen[a - hlit];
      int e = a + 1;
      while (e < all && (e < hlit ? s.llen[e] : s.dlen[e - hlit]) == x) ++e;
      if (x == 0) {
        while (e - a >= 11) {
          const int extra = min(e - a - 11, 127);
          s.item_sym[items] = 18;
          s.item_extra[items++] = (uint8_t)extra;
          a += 11 + extra;
        }
        if (e - a >= 3) {
          const int extra = min(e - a - 3, 7);
          s.item_sym[items] = 17;
          s.item_extra[items++] = (uint8_t)extra;
          a += 3 + extra;
        }
      } else if (e - a >= 4) {
        s.item_sym[items] = (uint8_t)x;
        s.item_extra[items++] = 0;
        ++a;
        while (e - a >= 3) {
          const int extra = min(e - a - 3, 3);
          s.item_sym[items] = 16;
          s.item_extra[items++] = (uint8_t)extra;
          a += 3 + extra;
        }
      }
      while (a < e) {
        s.item_sym[items] = (uint8_t)x;
        s.item_extra[items++] = 0;
        ++a;
      }
    }
    for (int i = 0; i < items; ++i) ++s.cfreq[s.item_sym[i]];
    const int used_c = force_two(s.cfreq, kClSyms);
    int sorted_n = 0;
    for (int sym = 0; sym < kClSyms; ++sym) {
      if (s.cfreq[sym] == 0) continue;
      int i = sorted_n++;
      while (i > 0 && s.cfreq[s.csorted[i - 1]] > s.cfreq[sym]) {
        s.csorted[i] = s.csorted[i - 1];
        --i;
      }
      s.csorted[i] = (uint16_t)sym;
    }
    huffman_lengths(s.csorted, used_c, s.cfreq, kClSyms, 7, s.lweight,
                    s.lparent, s.clen);
    int hclen = kClSyms;
    while (hclen > 4 && s.clen[kClOrder[hclen - 1]] == 0) --hclen;
    canonical_codes(s.llen, kLitSyms, s.lcode);
    canonical_codes(s.dlen, kDistSyms, s.dcode);
    canonical_codes(s.clen, kClSyms, s.ccode);
    int pos = 0;
    put_bits(s_out, pos, 1, 1);  // the last block
    put_bits(s_out, pos + 1, 2, 2);  // dynamic codes
    put_bits(s_out, pos + 3, hlit - 257, 5);
    put_bits(s_out, pos + 8, hdist - 1, 5);
    put_bits(s_out, pos + 13, hclen - 4, 4);
    pos += 17;
    for (int i = 0; i < hclen; ++i, pos += 3) {
      put_bits(s_out, pos, s.clen[kClOrder[i]], 3);
    }
    for (int i = 0; i < items; ++i) {
      const int sym = s.item_sym[i];
      put_bits(s_out, pos, s.ccode[sym], s.clen[sym]);
      pos += s.clen[sym];
      const int extra_bits = sym == 18 ? 7 : sym == 17 ? 3 : sym == 16 ? 2 : 0;
      put_bits(s_out, pos, s.item_extra[i], extra_bits);
      pos += extra_bits;
    }
    s.header_bits = pos;
  }
  __syncthreads();

  // Bits of this thread's tokens, placed by a block-wide scan.
  uint32_t mine = 0;
  for (int w = 0; w < kSpan / 32; ++w) {
    uint32_t word = s_start[(own >> 5) + w];
    while (word) {
      const int p = own + 32 * w + __ffs(word) - 1;
      word &= word - 1;
      const int l8 = s_len[p];
      if (l8 == 0) {
        mine += s.llen[s_in[p]];
      } else {
        const int lc = len_code(l8 + 3);
        const int dc = dist_code(p - cand[p]);
        mine += s.llen[257 + lc] + len_extra_bits(lc) + s.dlen[dc] +
                dist_extra_bits(dc);
      }
    }
  }
  uint32_t scan = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, scan, d);
    if (lane >= d) scan += up;
  }
  if (lane == 31) s.warp_sums[warp] = scan;
  __syncthreads();
  if (warp == 0) {
    uint32_t t = s.warp_sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += up;
    }
    s.warp_sums[lane] = t;  // inclusive over warps
    if (lane == 31) s.total_bits = s.header_bits + (int)t + s.llen[256];
  }
  __syncthreads();
  const int total_bits = s.total_bits;
  const bool stored = (total_bits + 7) / 8 > n + 5;
  if (!stored) {
    int pos = s.header_bits + (int)(scan - mine) +
              (warp ? (int)s.warp_sums[warp - 1] : 0);
    for (int w = 0; w < kSpan / 32; ++w) {
      uint32_t word = s_start[(own >> 5) + w];
      while (word) {
        const int p = own + 32 * w + __ffs(word) - 1;
        word &= word - 1;
        const int l8 = s_len[p];
        if (l8 == 0) {
          const int lit = s_in[p];
          put_bits(s_out, pos, s.lcode[lit], s.llen[lit]);
          pos += s.llen[lit];
        } else {
          const int length = l8 + 3;
          const int dist = p - cand[p];
          const int lc = len_code(length);
          const int dc = dist_code(dist);
          put_bits(s_out, pos, s.lcode[257 + lc], s.llen[257 + lc]);
          pos += s.llen[257 + lc];
          put_bits(s_out, pos, length - len_base(lc), len_extra_bits(lc));
          pos += len_extra_bits(lc);
          put_bits(s_out, pos, s.dcode[dc], s.dlen[dc]);
          pos += s.dlen[dc];
          put_bits(s_out, pos, dist - dist_base(dc), dist_extra_bits(dc));
          pos += dist_extra_bits(dc);
        }
      }
    }
    if (tid == kThreads - 1) put_bits(s_out, pos, s.lcode[256], s.llen[256]);
  }
  __syncthreads();

  // The member: header, payload, CRC-32 and ISIZE.
  const int payload = stored ? n + 5 : (total_bits + 7) / 8;
  uint8_t* dst = out + member * kStride;
  const uint8_t* bits = reinterpret_cast<const uint8_t*>(s_out);
  for (int i = tid; i < payload; i += kThreads) {
    int v;
    if (!stored) {
      v = bits[i];
    } else if (i >= 5) {
      v = s_in[i - 5];
    } else {  // BFINAL, stored; LEN and NLEN
      const int len = i < 3 ? n : n ^ 0xFFFF;
      v = i == 0 ? 1 : (i & 1) ? len & 0xFF : len >> 8;
    }
    dst[18 + i] = (uint8_t)v;
  }
  if (tid == 0) {
    const uint8_t header[16] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff,
                                6,    0,    'B', 'C', 2, 0};
    for (int i = 0; i < 16; ++i) dst[i] = header[i];
    const int size = 18 + payload + 8;
    dst[16] = (uint8_t)((size - 1) & 0xFF);
    dst[17] = (uint8_t)((size - 1) >> 8);
    const uint32_t crc = ~(crc_shift(s.x2n, 0xFFFFFFFFu, (uint32_t)n) ^
                           s.crc_xor);
    uint8_t* tail = dst + 18 + payload;
    for (int i = 0; i < 4; ++i) {
      tail[i] = (uint8_t)(crc >> (8 * i));
      tail[4 + i] = (uint8_t)((uint32_t)n >> (8 * i));
    }
    out_len[member] = size;
  }
}

}  // namespace

extern "C" {

// in: uint8, the window's `total` bytes, 16-byte aligned; member i is
// bytes [i * 65280, min(total, (i + 1) * 65280)).  out: uint8, 65,536
// bytes a member; out_len: int32, one a member; scratch: 2 bytes a
// position of 65,536 a member.
int fqd_deflate_members(const void* in, long long total, void* out,
                        void* out_len, void* scratch, void* stream) {
  if (total <= 0) return (int)cudaGetLastError();
  const long long members = (total + kBlock - 1) / kBlock;
  if (members > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const cudaError_t status = cudaFuncSetAttribute(
      deflate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSharedBytes);
  if (status != cudaSuccess) return (int)status;
  deflate_kernel<<<(unsigned)members, kThreads, kSharedBytes,
                   (cudaStream_t)stream>>>(
      (const uint8_t*)in, total, (uint8_t*)out, (int*)out_len,
      (uint16_t*)scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
