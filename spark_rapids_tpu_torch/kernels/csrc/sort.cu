// Stable lexicographic sort of 32-bit operands with a row-index payload:
// the port of the TPU kernel spark_rapids_tpu/kernels/sort.py
// sort_with_payload (body _build at :72, pallas_call at :84).
//
// What it computes: the arrays a_0 .. a_{m-1} (int32 or uint32 keys) and
// the int32 payload a_m reordered so that the tuples (a_0[i], ...,
// a_{m-1}[i]) ascend and equal tuples keep their input order. Keys are
// ordered as their flipped words (xor 0x80000000 for int32, 0 for uint32).
// With the iota payload every caller passes, that is bit for bit
// lax.sort(operands + [payload], num_keys=m), which the TPU kernel got from
// a bitonic network with the payload as the last compare key; here the
// payload is carried through the permutation and is never compared.
//
// What bounds it on an H100: bytes. The floor reads and writes every
// array once; a comparison network touches every array O(log^2 n) times.
// The operands the engine passes are mostly narrow (live and null flags
// of 1 bit, dictionary codes, the 8-bit hi word of a 40-bit key), so the
// bits that can change the order are far fewer than 32 per operand, and
// each radix pass costs a read and a write of an 8-byte key and a 4-byte
// row index per row.
//
// Design: a stable LSD radix sort over those bits only.
//  1. survey: one launch ORs and ANDs each operand's flipped words (warp
//     reductions, one atomicOr / atomicAnd per block) and checks whether
//     the payload is the iota; OR ^ AND marks the B bits that vary. The
//     wrapper reads these 2m + 1 words back: the sort's one host sync.
//     From them it plans the packed layout (runs of varying bits, first
//     operand most significant) and the 8-bit digit passes
//     (kernels/sort.py radix_plan).
//  2. pack: one launch per 64-bit word of the packed key writes each
//     row's word and the histogram of its first digit (warp-aggregated
//     shared atomics). B > 64 takes ceil(B / 64) words, least significant
//     first; a later word is packed through the running permutation (the
//     multiword path).
//  3. digit passes, onesweep style: one launch per digit. A CTA takes a
//     tile of 4096 keys by an atomic tile counter (so that look-back never
//     waits on a tile that has not started), ranks them stably in shared
//     memory (__match_any_sync and popc among the lanes below, then warps
//     in order), publishes its per-digit counts and finds the counts
//     before it by decoupled look-back (flag and count in one 32-bit word,
//     relaxed gpu-scope loads and stores), reorders the tile in shared
//     memory while the look-back loads are in flight, and writes each
//     digit's run
//     coalesced into the ping-pong buffer. It also counts the next digit
//     of its keys, so that only the first digit of a word needs a pass of
//     its own over the keys. The first pass takes the row index from the
//     position.
//  4. the last digit pass writes the outputs instead of keys: an operand
//     whose varying bits all lie in the last sorted word is unpacked from
//     the key (its other bits are the survey's AND), any other array is
//     read through the row index, and an iota payload is the row index.
//     With no varying bit, one launch copies the arrays.
//  5. small n (at most one tile): one CTA runs survey, plan, pack, every
//     digit pass and the gather in shared memory in one launch, with no
//     host sync.
// The wrapper allocates every buffer (keys, indices, ping-pong copies,
// histograms, look-back words); the kernels allocate nothing. No library
// sort is called.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxArrays = 32;             // operands + the payload
constexpr int kThreads = 256;              // one bin per thread
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // keys per thread
constexpr int kUnroll = 4;                 // rows per thread per step (survey, pack)
constexpr int kTile = kThreads * kItems;   // keys per CTA
constexpr int kBins = 256;                 // 8-bit digits
constexpr int kMaxDigits = 8;              // digits of one 64-bit word
constexpr int kMaxWordSegs = 64;           // runs that land in one word
constexpr int kMaxWords = 16;              // 31 operands x 32 bits
constexpr int kMaxSegs = (kMaxArrays - 1) * 16 + kMaxWords;
constexpr uint32_t kFull = 0xffffffffu;
// look-back word: flag in the top two bits, a count below (n < 2^30)
constexpr uint32_t kFlagAggregate = 1u << 30;
constexpr uint32_t kFlagPrefix = 2u << 30;
constexpr uint32_t kCountMask = (1u << 30) - 1;
constexpr int64_t kMaxRows = (1 << 30) - 1;

struct Arrays {
  const uint32_t* in[kMaxArrays];
  uint32_t* out[kMaxArrays];
  uint32_t flip[kMaxArrays];
  int n_arr;  // operands, then the payload
};

// A run of varying bits: operand (5 bits), source shift (5), length - 1
// (5), packed word (4), destination shift (6); kernels/sort.py
// encode_segments writes the same layout.
__device__ __forceinline__ int seg_operand(uint32_t s) { return s & 31; }
__device__ __forceinline__ int seg_src(uint32_t s) { return (s >> 5) & 31; }
__device__ __forceinline__ int seg_len(uint32_t s) { return ((s >> 10) & 31) + 1; }
__device__ __forceinline__ int seg_word(uint32_t s) { return (s >> 15) & 15; }
__device__ __forceinline__ int seg_dst(uint32_t s) { return (s >> 19) & 63; }

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Look-back words are read and written as single 32-bit words at gpu
// scope; each carries its own flag and count, so no other memory has to
// be ordered with them.
__device__ __forceinline__ uint32_t ld_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t digit_of(uint64_t key, int shift, int width) {
  return static_cast<uint32_t>(key >> shift) & ((1u << width) - 1u);
}

// One word of a row's packed key: its runs of varying bits, each shifted
// into place. Runs of one operand are adjacent, so each operand is read
// once.
__device__ __forceinline__ uint64_t pack_word(const Arrays& a, uint32_t row,
                                              const uint32_t* segs, int nseg) {
  uint64_t w = 0;
  int last = -1;
  uint32_t v = 0;
  for (int s = 0; s < nseg; ++s) {
    const uint32_t sg = segs[s];
    const int k = seg_operand(sg);
    if (k != last) {
      v = __ldg(a.in[k] + row) ^ a.flip[k];
      last = k;
    }
    const int len = seg_len(sg);
    const uint32_t mask = len == 32 ? kFull : (1u << len) - 1u;
    w |= static_cast<uint64_t>((v >> seg_src(sg)) & mask) << seg_dst(sg);
  }
  return w;
}

// Exclusive scan of one value per thread over the CTA (kThreads values);
// tmp holds kWarps words. Every thread must call it.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before += tmp[w];
  __syncthreads();
  return before + x - v;
}

// Stable rank of a warp's keys by digit: item j of lane l sits at warp
// position j * 32 + l. rank[j] counts the keys of the same digit at
// earlier positions of this warp; hist (this warp's kBins counters,
// zeroed) ends as the warp's count of each digit. Items at or past
// `valid` take no part.
__device__ __forceinline__ void rank_warp(const uint64_t (&key)[kItems], int shift,
                                          int width, int valid, uint32_t* hist,
                                          uint32_t (&rank)[kItems]) {
  const int lane = threadIdx.x & 31;
  const uint32_t lt = lanemask_lt();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j * 32 >= valid) break;  // the same for every lane of the warp
    const bool ok = j * 32 + lane < valid;
    const uint32_t d = ok ? digit_of(key[j], shift, width) : kBins;
    const uint32_t peers = __match_any_sync(kFull, d);
    const int leader = 31 - __clz(peers);
    uint32_t base = 0;
    if (ok && lane == leader) {
      base = hist[d];
      hist[d] = base + __popc(peers);
    }
    base = __shfl_sync(kFull, base, leader);
    rank[j] = base + __popc(peers & lt);
    __syncwarp();
  }
}

// After rank_warp: turn the warp counts of bin t (= threadIdx.x) into
// exclusive offsets across warps and return the tile's count of bin t.
__device__ __forceinline__ uint32_t warp_offsets(uint32_t* s_warp) {
  uint32_t total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_warp[w * kBins + threadIdx.x];
    s_warp[w * kBins + threadIdx.x] = total;
    total += c;
  }
  return total;
}

struct Survey {
  Arrays a;       // the operands, then the payload
  int n_ops;
  int64_t n;
  uint32_t* out;  // [n_ops] OR, [n_ops] AND, [1] payload is an iota
                  // (preset to 0, ~0 and ~0)
};

__global__ void __launch_bounds__(kThreads) survey_bits(Survey p) {
  __shared__ uint32_t s_or[kMaxArrays], s_and[kMaxArrays], s_iota;
  const int t = threadIdx.x, lane = t & 31;
  if (t < p.n_ops) {
    s_or[t] = 0u;
    s_and[t] = kFull;
  }
  if (t == 0) s_iota = 1u;
  __syncthreads();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + t;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  for (int k = 0; k <= p.n_ops; ++k) {
    const uint32_t* in = p.a.in[k];
    const uint32_t flip = p.a.flip[k];
    uint32_t o = 0u, an = kFull;
    bool iota = true;
    for (int64_t i0 = first; i0 < p.n; i0 += stride) {
      uint32_t v[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int64_t i = i0 + q * kThreads;
        v[q] = i < p.n ? __ldg(in + i) : 0u;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int64_t i = i0 + q * kThreads;
        if (i < p.n) {
          if (k < p.n_ops) {
            o |= v[q] ^ flip;
            an &= v[q] ^ flip;
          } else {
            iota = iota && v[q] == static_cast<uint32_t>(i);
          }
        }
      }
    }
    if (k < p.n_ops) {
      o = __reduce_or_sync(kFull, o);
      an = __reduce_and_sync(kFull, an);
      if (lane == 0) {
        atomicOr(&s_or[k], o);
        atomicAnd(&s_and[k], an);
      }
    } else if (!__all_sync(kFull, iota) && lane == 0) {
      s_iota = 0u;
    }
  }
  __syncthreads();
  if (t < p.n_ops) {
    atomicOr(&p.out[t], s_or[t]);
    atomicAnd(&p.out[p.n_ops + t], s_and[t]);
  }
  if (t == 0 && s_iota == 0u) atomicAnd(&p.out[2 * p.n_ops], 0u);
}

struct Pack {
  Arrays a;
  uint64_t* key;        // [n], written
  const uint32_t* idx;  // [n] the running permutation (later words), or null
  uint32_t* hist;       // [kBins] counts of the word's first digit, accumulated
  int64_t n;
  int nseg, shift, width;
  uint32_t seg[kMaxWordSegs];
};

__global__ void __launch_bounds__(kThreads) pack_hist(Pack p) {
  __shared__ uint32_t s_hist[kBins];
  __shared__ uint32_t s_seg[kMaxWordSegs];
  const int t = threadIdx.x;
  s_hist[t] = 0u;
  if (t < p.nseg) s_seg[t] = p.seg[t];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  // the loop bound is uniform over the CTA, so whole warps match digits
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll; base < p.n;
       base += stride) {
    bool ok[kUnroll];
    uint32_t row[kUnroll], v[kUnroll];
    uint64_t key[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int64_t i = base + q * kThreads + t;
      ok[q] = i < p.n;
      row[q] = !ok[q] ? 0u : p.idx ? p.idx[i] : static_cast<uint32_t>(i);
      key[q] = 0;
    }
    // the runs of one operand are adjacent: each operand is read once
    int last = -1;
    for (int s = 0; s < p.nseg; ++s) {
      const uint32_t sg = s_seg[s];
      const int k = seg_operand(sg);
      if (k != last) {
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          v[q] = ok[q] ? __ldg(p.a.in[k] + row[q]) ^ p.a.flip[k] : 0u;
        }
        last = k;
      }
      const int len = seg_len(sg);
      const uint32_t mask = len == 32 ? kFull : (1u << len) - 1u;
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        key[q] |= static_cast<uint64_t>((v[q] >> seg_src(sg)) & mask) << seg_dst(sg);
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int64_t i = base + q * kThreads + t;
      if (ok[q]) p.key[i] = key[q];
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const uint32_t dg = digit_of(key[q], p.shift, p.width);
      const uint32_t peers = __match_any_sync(kFull, ok[q] ? dg : kBins);
      if (ok[q] && (t & 31) == 31 - __clz(peers)) atomicAdd(&s_hist[dg], __popc(peers));
    }
  }
  __syncthreads();
  if (s_hist[t] != 0u) atomicAdd(&p.hist[t], s_hist[t]);
}

// Where a digit pass writes: the keys and row indices of the next pass.
// write_tile stores a reordered tile, each digit's run to consecutive
// addresses (s_delta: global minus local start of each digit).
struct KeyOut {
  uint64_t* key;
  uint32_t* idx;
  __device__ __forceinline__ void write_tile(const uint64_t* s_key, const uint32_t* s_idx,
                                             const int32_t* s_delta, int tile_n, int shift,
                                             int width) const {
    for (int i = threadIdx.x; i < tile_n; i += kThreads) {
      const uint64_t k = s_key[i];
      const int64_t g = static_cast<int64_t>(s_delta[digit_of(k, shift, width)]) + i;
      key[g] = k;
      idx[g] = s_idx[i];
    }
  }
};

// Where the last digit pass (or, with no pass, finish_rows) writes: the
// outputs. An operand whose varying bits all lie in the last sorted word
// is its constant bits with those bits put back from the key; any other
// array is read through the row index, except an iota payload, which is
// the row index itself.
struct Finish {
  Arrays a;
  uint32_t gather;            // bit k: array k is read through the row index
  uint32_t base[kMaxArrays];  // an unpacked operand's constant bits (AND)
  uint8_t seg_lo[kMaxArrays], seg_hi[kMaxArrays];  // its runs in seg[]
  uint32_t seg[kMaxWordSegs];

  // array k of a row with this key and row index r
  __device__ __forceinline__ uint32_t value(int k, uint64_t key, uint32_t r) const {
    if ((gather >> k) & 1u) return __ldg(a.in[k] + r);
    if (k == a.n_arr - 1) return r;
    uint32_t v = base[k];
    for (int s = seg_lo[k]; s < seg_hi[k]; ++s) {
      const uint32_t sg = seg[s];
      const int len = seg_len(sg);
      const uint32_t mask = len == 32 ? kFull : (1u << len) - 1u;
      v |= (static_cast<uint32_t>(key >> seg_dst(sg)) & mask) << seg_src(sg);
    }
    return v ^ a.flip[k];
  }

  // array by array, so that each output takes kItems stores in a row
  __device__ __forceinline__ void write_tile(const uint64_t* s_key, const uint32_t* s_idx,
                                             const int32_t* s_delta, int tile_n, int shift,
                                             int width) const {
    uint64_t key[kItems];
    uint32_t r[kItems], g[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int i = threadIdx.x + q * kThreads;
      key[q] = i < tile_n ? s_key[i] : 0u;
      r[q] = i < tile_n ? s_idx[i] : 0u;
      g[q] = i < tile_n ? static_cast<uint32_t>(s_delta[digit_of(key[q], shift, width)] + i) : 0u;
    }
    for (int k = 0; k < a.n_arr; ++k) {
      uint32_t* out = a.out[k];
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        if (static_cast<int>(threadIdx.x) + q * kThreads < tile_n) out[g[q]] = value(k, key[q], r[q]);
      }
    }
  }
};

struct Pass {
  const uint64_t* key_in;
  const uint32_t* idx_in;  // null: the row index is the position (first pass)
  const uint32_t* hist;    // [kBins] global count of each digit
  uint32_t* next_hist;     // [kBins] the next digit's counts, accumulated; or null
  uint32_t* status;        // [tiles][kBins] look-back words, zeroed
  uint32_t* counter;       // tile ids handed out, zeroed
  int64_t n;
  int shift, width, next_shift, next_width;
};

// shared memory of one tile: keys, indices, warp counts, bin starts, the
// global-minus-local offset of each bin, the next digit's counts, scan
// scratch and the tile id
constexpr size_t kTileSmem = kTile * 8 + kTile * 4 + kWarps * kBins * 4 +
                             kBins * 4 + kBins * 4 + kBins * 4 + (kWarps + 1) * 4;

template <class Out>
__global__ void __launch_bounds__(kThreads) onesweep_pass(Pass p, Out out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_key = reinterpret_cast<uint64_t*>(smem);
  uint32_t* s_idx = reinterpret_cast<uint32_t*>(s_key + kTile);
  uint32_t* s_warp = s_idx + kTile;
  uint32_t* s_start = s_warp + kWarps * kBins;
  int32_t* s_delta = reinterpret_cast<int32_t*>(s_start + kBins);
  uint32_t* s_next = reinterpret_cast<uint32_t*>(s_delta + kBins);
  uint32_t* s_tmp = s_next + kBins;  // kWarps + tile id
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t == 0) s_tmp[kWarps] = atomicAdd(p.counter, 1u);
  for (int i = t; i < kWarps * kBins; i += kThreads) s_warp[i] = 0u;
  s_next[t] = 0u;
  // where each digit's run starts in the output (block scan has barriers)
  const uint32_t bin_start = block_exclusive_scan(p.hist[t], s_tmp);
  const uint32_t tile = s_tmp[kWarps];
  const int64_t base = static_cast<int64_t>(tile) * kTile;
  const int tile_n = static_cast<int>(p.n - base < kTile ? p.n - base : kTile);
  const int wpos = warp * 32 * kItems;

  uint64_t key[kItems];
  uint32_t idx[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int pos = wpos + j * 32 + lane;
    key[j] = pos < tile_n ? p.key_in[base + pos] : 0u;
    idx[j] = pos >= tile_n ? 0u
             : p.idx_in ? p.idx_in[base + pos] : static_cast<uint32_t>(base + pos);
  }
  rank_warp(key, p.shift, p.width, tile_n - wpos, s_warp + warp * kBins, rank);
  __syncthreads();
  const uint32_t total = warp_offsets(s_warp);
  const uint32_t local_start = block_exclusive_scan(total, s_tmp);
  s_start[t] = local_start;

  // publish this tile's count of bin t, and start reading the tiles
  // before it (decoupled look-back) while the tile is reordered
  uint32_t* status = p.status + static_cast<size_t>(tile) * kBins + t;
  st_status(status, tile == 0 ? kFlagPrefix | (bin_start + total) : kFlagAggregate | total);
  int64_t j = static_cast<int64_t>(tile) - 1;
  uint32_t back = tile > 0 ? ld_status(status - kBins) : 0u;
  __syncthreads();

  // reorder the tile by digit in shared memory (local offsets only)
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = wpos + i * 32 + lane;
    if (pos < tile_n) {
      const uint32_t d = digit_of(key[i], p.shift, p.width);
      const uint32_t at = s_start[d] + s_warp[warp * kBins + d] + rank[i];
      s_key[at] = key[i];
      s_idx[at] = idx[i];
      // the next digit's counts of this tile, while the keys are at hand
      if (p.next_hist) atomicAdd(&s_next[digit_of(key[i], p.next_shift, p.next_width)], 1u);
    }
  }
  // finish the look-back: sum aggregates in order up to the first
  // prefix, and wait where a tile has published nothing yet
  uint32_t global_start = bin_start;
  if (tile > 0) {
    uint32_t excl = 0;
    for (;;) {
      if (back != 0u) {
        excl += back & kCountMask;
        if (back & kFlagPrefix) break;
        --j;
      }
      back = ld_status(p.status + static_cast<size_t>(j) * kBins + t);
    }
    global_start = excl;
    st_status(status, kFlagPrefix | (excl + total));
  }
  s_delta[t] = static_cast<int32_t>(global_start - local_start);
  __syncthreads();
  if (p.next_hist && s_next[t] != 0u) atomicAdd(&p.next_hist[t], s_next[t]);

  out.write_tile(s_key, s_idx, s_delta, tile_n, p.shift, p.width);
}

// The outputs when no digit pass ran (no bit varies): row i is row i.
__global__ void finish_rows(Finish f, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int k = 0; k < f.a.n_arr; ++k) f.a.out[k][i] = f.value(k, 0u, static_cast<uint32_t>(i));
}

// Runs of varying bits from the survey, first operand most significant,
// split where a run crosses a 64-bit word; kernels/sort.py radix_plan is
// the same walk. Returns B.
__device__ int plan_segments(const uint32_t* s_or, const uint32_t* s_and, int n_ops,
                             uint32_t* segs, int* nseg) {
  int p = 0, ns = 0;
  for (int k = n_ops - 1; k >= 0; --k) {
    uint32_t v = s_or[k] ^ s_and[k];
    while (v != 0u) {
      const int lo = __ffs(v) - 1;
      const uint32_t sh = v >> lo;
      const int len = sh == kFull ? 32 : __ffs(~sh) - 1;
      const uint32_t run = len == 32 ? kFull : (1u << len) - 1u;
      v &= ~(run << lo);
      int src = lo, rem = len;
      while (rem > 0) {
        const int word = p >> 6, dst = p & 63;
        const int l = rem < 64 - dst ? rem : 64 - dst;
        segs[ns++] = static_cast<uint32_t>(k) | static_cast<uint32_t>(src) << 5 |
                     static_cast<uint32_t>(l - 1) << 10 |
                     static_cast<uint32_t>(word) << 15 | static_cast<uint32_t>(dst) << 19;
        p += l;
        src += l;
        rem -= l;
      }
    }
  }
  *nseg = ns;
  return p;
}

constexpr size_t kSmallSmem = kTile * 8 + kTile * 4 + kWarps * kBins * 4 + kBins * 4 +
                              kMaxSegs * 4 + (kMaxWords + 1) * 4 + 2 * kMaxArrays * 4 +
                              (kWarps + 2) * 4;

// The whole sort of n <= kTile rows in one CTA: survey, plan, and per
// word (least significant first) pack through the running permutation
// and one stable pass per digit, all in shared memory; then the gather.
// survey_out, unless null, gets the OR and AND words.
__global__ void __launch_bounds__(kThreads) sort_small(Arrays a, int n, uint32_t* survey_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_key = reinterpret_cast<uint64_t*>(smem);
  uint32_t* s_idx = reinterpret_cast<uint32_t*>(s_key + kTile);
  uint32_t* s_warp = s_idx + kTile;
  uint32_t* s_start = s_warp + kWarps * kBins;
  uint32_t* s_seg = s_start + kBins;
  int* s_wseg = reinterpret_cast<int*>(s_seg + kMaxSegs);  // first run of each word
  uint32_t* s_or = reinterpret_cast<uint32_t*>(s_wseg + kMaxWords + 1);
  uint32_t* s_and = s_or + kMaxArrays;
  uint32_t* s_tmp = s_and + kMaxArrays;  // kWarps + B
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_ops = a.n_arr - 1;

  if (t < n_ops) {
    s_or[t] = 0u;
    s_and[t] = kFull;
  }
  for (int i = t; i < n; i += kThreads) s_idx[i] = static_cast<uint32_t>(i);
  __syncthreads();
  for (int k = 0; k < n_ops; ++k) {
    uint32_t o = 0u, an = kFull;
    for (int i = t; i < n; i += kThreads) {
      const uint32_t v = __ldg(a.in[k] + i) ^ a.flip[k];
      o |= v;
      an &= v;
    }
    o = __reduce_or_sync(kFull, o);
    an = __reduce_and_sync(kFull, an);
    if (lane == 0) {
      atomicOr(&s_or[k], o);
      atomicAnd(&s_and[k], an);
    }
  }
  __syncthreads();
  if (t == 0) {
    int ns = 0;
    const int bits = plan_segments(s_or, s_and, n_ops, s_seg, &ns);
    const int words = (bits + 63) / 64;
    int s = 0;
    for (int w = 0; w <= words; ++w) {
      while (s < ns && seg_word(s_seg[s]) < w) ++s;
      s_wseg[w] = s;
    }
    s_wseg[words] = ns;
    s_tmp[kWarps] = static_cast<uint32_t>(bits);
  }
  if (survey_out && t < n_ops) {
    survey_out[t] = s_or[t];
    survey_out[n_ops + t] = s_and[t];
  }
  __syncthreads();
  const int bits = static_cast<int>(s_tmp[kWarps]);
  const int words = (bits + 63) / 64;
  const int wpos = warp * 32 * kItems;

  uint64_t key[kItems];
  uint32_t idx[kItems], rank[kItems];
  for (int w = 0; w < words; ++w) {
    const uint32_t* segs = s_seg + s_wseg[w];
    const int nseg = s_wseg[w + 1] - s_wseg[w];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int pos = wpos + j * 32 + lane;
      idx[j] = pos < n ? s_idx[pos] : 0u;
      key[j] = pos < n ? pack_word(a, idx[j], segs, nseg) : 0u;
    }
    const int wbits = bits - 64 * w < 64 ? bits - 64 * w : 64;
    for (int shift = 0; shift < wbits; shift += 8) {
      const int width = wbits - shift < 8 ? wbits - shift : 8;
      for (int i = t; i < kWarps * kBins; i += kThreads) s_warp[i] = 0u;
      __syncthreads();
      rank_warp(key, shift, width, n - wpos, s_warp + warp * kBins, rank);
      __syncthreads();
      const uint32_t total = warp_offsets(s_warp);
      s_start[t] = block_exclusive_scan(total, s_tmp);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (wpos + j * 32 + lane < n) {
          const uint32_t d = digit_of(key[j], shift, width);
          const uint32_t at = s_start[d] + s_warp[warp * kBins + d] + rank[j];
          s_key[at] = key[j];
          s_idx[at] = idx[j];
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int pos = wpos + j * 32 + lane;
        if (pos < n) {
          key[j] = s_key[pos];
          idx[j] = s_idx[pos];
        }
      }
    }
  }
  __syncthreads();
  for (int i = t; i < n; i += kThreads) {
    const uint32_t r = s_idx[i];
    for (int k = 0; k < a.n_arr; ++k) a.out[k][i] = __ldg(a.in[k] + r);
  }
}

Arrays make_arrays(void* const* in_ptrs, void* const* out_ptrs, const uint32_t* flips,
                   int n_arr) {
  Arrays a;
  a.n_arr = n_arr;
  for (int k = 0; k < kMaxArrays; ++k) {
    a.in[k] = k < n_arr ? static_cast<const uint32_t*>(in_ptrs[k]) : nullptr;
    a.out[k] = k < n_arr && out_ptrs ? static_cast<uint32_t*>(out_ptrs[k]) : nullptr;
    a.flip[k] = k < n_arr ? flips[k] : 0u;
  }
  return a;
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

// the dynamic shared memory limits, raised once per process
cudaError_t raise_smem_limits() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    done = cudaFuncSetAttribute(onesweep_pass<KeyOut>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kTileSmem));
    if (done == cudaSuccess) {
      done = cudaFuncSetAttribute(onesweep_pass<Finish>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kTileSmem));
    }
    if (done == cudaSuccess) {
      done = cudaFuncSetAttribute(sort_small, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kSmallSmem));
    }
  }
  return done;
}

// CTAs for n rows at kUnroll rows per thread, at most cap
unsigned grid_for(int64_t n, int64_t cap) {
  const int64_t blocks = (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  return static_cast<unsigned>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// Rows that the one-CTA path takes (srt_sort_small).
int srt_small_rows() { return kTile; }

// Rows that the planned path takes at most (look-back counts are 30 bits).
int64_t srt_max_rows() { return kMaxRows; }

// 32-bit words of scratch srt_sort_planned needs for n rows and npass
// digit passes: histograms, tile counters and look-back words.
int64_t srt_scratch_words(int64_t n, int npass) {
  return static_cast<int64_t>(npass) * (kBins + 1 + tiles_of(n) * kBins);
}

// The whole sort of n <= srt_small_rows() rows in one launch. in_ptrs /
// out_ptrs: n_arr device pointers (host arrays) to n 32-bit words each,
// the payload last; flips: n_arr masks (0x80000000 for int32, 0 for
// uint32). survey_out: null, or 2 * (n_arr - 1) words for the OR and
// AND words of the survey. Returns cudaGetLastError().
int srt_sort_small(void* const* in_ptrs, void* const* out_ptrs, const uint32_t* flips,
                   int n_arr, int64_t n, void* survey_out, void* stream) {
  if (n_arr < 1 || n_arr > kMaxArrays || n < 1 || n > kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = raise_smem_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_small<<<1, kThreads, kSmallSmem, static_cast<cudaStream_t>(stream)>>>(
      make_arrays(in_ptrs, out_ptrs, flips, n_arr), static_cast<int>(n),
      static_cast<uint32_t*>(survey_out));
  return static_cast<int>(cudaGetLastError());
}

// OR and AND of each operand's flipped words into out[0, 2 * n_ops), and
// in out[2 * n_ops] whether the payload (array n_arr - 1) is the iota
// 0, 1, ..., n - 1 (nonzero) or not (0).
int srt_survey(void* const* in_ptrs, const uint32_t* flips, int n_arr, int64_t n, void* out,
               void* stream) {
  if (n_arr < 2 || n_arr > kMaxArrays || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_ops = n_arr - 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* words = static_cast<uint32_t*>(out);
  cudaError_t err = cudaMemsetAsync(words, 0, sizeof(uint32_t) * n_ops, st);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(words + n_ops, 0xff, sizeof(uint32_t) * (n_ops + 1), st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  Survey p;
  p.a = make_arrays(in_ptrs, nullptr, flips, n_arr);
  p.n_ops = n_ops;
  p.n = n;
  p.out = words;
  survey_bits<<<grid_for(n, 1024), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The sort by a plan (kernels/sort.py radix_plan): segs holds nseg
// encoded runs, pass_word / pass_shift / pass_width its npass digit
// passes, word by word from the least significant. and_words: each
// operand's AND from the survey; payload_iota: the survey's iota word.
// keys: 2n uint64, idx: 2n uint32, scratch: srt_scratch_words(n, npass)
// words; all device memory from the caller. With no passes the outputs
// are copies of the inputs. Returns the first CUDA error.
int srt_sort_planned(void* const* in_ptrs, void* const* out_ptrs, const uint32_t* flips,
                     int n_arr, int64_t n, const uint32_t* segs, int nseg,
                     const int* pass_word, const int* pass_shift, const int* pass_width,
                     int npass, const uint32_t* and_words, int payload_iota, void* keys,
                     void* idx, void* scratch, int64_t scratch_words, void* stream) {
  if (n_arr < 1 || n_arr > kMaxArrays || n < 1 || n > kMaxRows || nseg < 0 ||
      nseg > kMaxSegs || npass < 0 || npass > kMaxWords * kMaxDigits ||
      scratch_words < srt_scratch_words(n, npass)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int d = 0; d < npass; ++d) {
    if (pass_width[d] < 1 || pass_width[d] > 8 || pass_shift[d] < 0 ||
        pass_shift[d] + pass_width[d] > 64 || pass_word[d] < 0 || pass_word[d] >= kMaxWords ||
        (d > 0 && pass_word[d] < pass_word[d - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Arrays a = make_arrays(in_ptrs, out_ptrs, flips, n_arr);
  cudaError_t err = raise_smem_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  uint64_t* kbuf[2] = {static_cast<uint64_t*>(keys), static_cast<uint64_t*>(keys) + n};
  uint32_t* ibuf[2] = {static_cast<uint32_t*>(idx), static_cast<uint32_t*>(idx) + n};
  uint32_t* hist = static_cast<uint32_t*>(scratch);
  uint32_t* counters = hist + static_cast<int64_t>(npass) * kBins;
  uint32_t* status = counters + npass;
  const int64_t tiles = tiles_of(n);
  if (npass > 0) {
    err = cudaMemsetAsync(scratch, 0, sizeof(uint32_t) * srt_scratch_words(n, npass), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the outputs: unpack the operands whose runs all lie in the last
  // sorted word, read the others through the row index
  Finish fin;
  fin.a = a;
  fin.gather = payload_iota ? 0u : 1u << (n_arr - 1);
  const int top = npass > 0 ? pass_word[npass - 1] : -1;
  int ntop = 0;
  for (int k = 0; k < n_arr - 1; ++k) {
    fin.base[k] = and_words[k];
    fin.seg_lo[k] = static_cast<uint8_t>(ntop);
    for (int s = 0; s < nseg; ++s) {
      if (static_cast<int>(segs[s] & 31) != k) continue;
      if (static_cast<int>((segs[s] >> 15) & 15) != top) {
        fin.gather |= 1u << k;
      } else {
        if (ntop == kMaxWordSegs) return static_cast<int>(cudaErrorInvalidValue);
        fin.seg[ntop++] = segs[s];
      }
    }
    fin.seg_hi[k] = static_cast<uint8_t>(ntop);
  }
  if (npass == 0) {
    finish_rows<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        fin, n);
    return static_cast<int>(cudaGetLastError());
  }
  int cur = 0;
  for (int first = 0; first < npass;) {
    const int word = pass_word[first];
    int last = first;
    while (last < npass && pass_word[last] == word) ++last;
    if (last - first > kMaxDigits) return static_cast<int>(cudaErrorInvalidValue);
    Pack pk;
    pk.a = a;
    pk.key = kbuf[cur];
    pk.idx = first > 0 ? ibuf[cur] : nullptr;
    pk.hist = hist + static_cast<int64_t>(first) * kBins;
    pk.n = n;
    pk.shift = pass_shift[first];
    pk.width = pass_width[first];
    pk.nseg = 0;
    for (int s = 0; s < nseg; ++s) {
      if (static_cast<int>((segs[s] >> 15) & 15) != word) continue;
      if (pk.nseg == kMaxWordSegs) return static_cast<int>(cudaErrorInvalidValue);
      pk.seg[pk.nseg++] = segs[s];
    }
    pack_hist<<<grid_for(n, 1056), kThreads, 0, st>>>(pk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int d = first; d < last; ++d) {
      Pass ps;
      ps.key_in = kbuf[cur];
      ps.idx_in = d > 0 ? ibuf[cur] : nullptr;
      ps.hist = hist + static_cast<int64_t>(d) * kBins;
      const bool next = d + 1 < last;
      ps.next_hist = next ? hist + static_cast<int64_t>(d + 1) * kBins : nullptr;
      ps.next_shift = next ? pass_shift[d + 1] : 0;
      ps.next_width = next ? pass_width[d + 1] : 1;
      ps.status = status + static_cast<int64_t>(d) * tiles * kBins;
      ps.counter = counters + d;
      ps.n = n;
      ps.shift = pass_shift[d];
      ps.width = pass_width[d];
      const unsigned grid = static_cast<unsigned>(tiles);
      if (d + 1 < npass) {
        onesweep_pass<KeyOut><<<grid, kThreads, kTileSmem, st>>>(
            ps, KeyOut{kbuf[cur ^ 1], ibuf[cur ^ 1]});
      } else {
        onesweep_pass<Finish><<<grid, kThreads, kTileSmem, st>>>(ps, fin);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      cur ^= 1;
    }
    first = last;
  }
  return static_cast<int>(cudaSuccess);
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
