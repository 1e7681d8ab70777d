// Row compaction in one pass: the port of the TPU kernel
// spark_rapids_tpu/kernels/compact.py gather_compact (pallas_call at :112),
// with the scan of `keep` that its caller (ops/scatter32.py compact_pairs:
// cumsum(keep) - 1 and the kept count) ran before it folded in.
//
// What it computes: given keep[capacity] (bool) and column streams (data
// or validity, 1/2/4/8-byte elements), every stream compacted to its
// kept-row prefix, out[j] = in[i_j] for j < new_n where i_j is the j-th
// kept row in row order, out[j] = 0 for j >= new_n, and new_n, the number
// of kept rows (a device int32).
//
// What bounds it on an H100: bytes. keep is read once, every stream is
// read once and every output slot is written once: capacity * (1 + 2 *
// row bytes).
//
// Design: one launch, no scratch pass and nothing before it on the
// stream. Each CTA takes a tile of kTile rows in the order of an atomic
// ticket counter, so every tile before it has started and the look-back
// never waits on a tile that is not running. A warp ranks its kept rows
// by __ballot_sync/__popc, 32 rows at a time, and the CTA adds the warps'
// counts. The tile publishes its count at once (an aggregate), and warp 0
// reads the words of the 32 tiles before it together, adding counts back
// to the nearest tile that has published its inclusive prefix (decoupled
// look-back, as csrc/sort.cu's onesweep pass does), then publishes its
// own prefix. The tile writes its kept rows to [offset, offset + kept) in
// row order and its dropped rows' zeros to the matching slots of the
// tail, [capacity - dropped_incl, capacity - dropped_excl): over all
// tiles the heads and tails cover [0, capacity) exactly once. The last
// tile writes new_n. Elements move at their native width (the TPU kernel
// split 64-bit columns into 32-bit limbs for its gathers).
//
// The moves are loads whose latency little else hides: a thread holds
// kItems rows, a CTA is capped at 80 registers so three fit an SM, and
// each warp asks L2 for its rows of the next stream while it moves the
// current one (and for the first stream while the tile is ranked and looks
// back), so a stream's loads mostly find their lines in L2. Where the
// tiles are fewer than the CTAs the card holds at once, each tile's
// streams split into groups, one CTA a group: every CTA of a tile ranks
// the tile and looks back alike, and only the first publishes.
//
// The stream descriptors ride in the launch as a __grid_constant__
// parameter (up to kMaxStreams (src, dst, size) triples, about 1 KB of
// the 4 KB parameter space), so nothing is copied to the device for them.
// Beyond kMaxStreams streams, the first launch also writes the gather map
// sel[j] = i_j, and each further group of up to kMaxStreams streams is one
// gather launch through it.
//
// Scratch: one 64-bit look-back word per tile, the launch's epoch in the
// top 32 bits (a new one every launch, from the host), then the prefix
// flag, then a 31-bit count (capacity < 2^31). A word left by an earlier
// launch carries an older epoch and reads as unpublished, so the words are
// never cleared between launches; the ticket counter is reset to 0 by the
// CTA that draws the last ticket, when every other CTA has drawn its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                 // rows per thread
constexpr int kTile = kThreads * kItems;  // rows per CTA
constexpr int kMaxStreams = 64;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint64_t kPrefix = 1ull << 31;
constexpr uint64_t kCountMask = kPrefix - 1;
constexpr int64_t kMaxCapacity = 0x7fffffffLL;
constexpr int kCtasPerSm = 3;  // at __launch_bounds__(kThreads, 3)

struct Streams {
  const void* src[kMaxStreams];
  void* dst[kMaxStreams];
  unsigned char log2size[kMaxStreams];
  int n;
};

struct Scan {
  const unsigned char* keep;
  int* new_n;
  int* sel;            // the gather map, or null
  uint64_t* status;    // one look-back word per tile
  unsigned* counter;   // tickets handed out; 0 between launches
  uint64_t epoch;      // this launch's epoch, in the top 32 bits
  int64_t capacity;
  unsigned tiles;
  int groups;          // CTAs per tile, each moving per_group streams
  int per_group;
};

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Look-back words are single 64-bit words read and written at gpu scope;
// each carries its own epoch, flag and count, so no other memory has to be
// ordered with them.
__device__ __forceinline__ uint64_t ld_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// Ask L2 for this warp's rows of stream s, one 128-byte line a lane at a
// time, so that their loads find them there.
__device__ __forceinline__ void prefetch_stream(const Streams& st, int s,
                                                int64_t first_row, int rows,
                                                int lane) {
  const int shift = st.log2size[s];
  const char* p = static_cast<const char*>(st.src[s]) + (first_row << shift);
  for (int off = lane * 128; off < (rows << shift); off += 32 * 128)
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p + off));
}

// One stream's rows of the tile: kept rows to the head, zeros to the tail.
template <typename U>
__device__ __forceinline__ void move_tile(const void* src_v, void* dst_v,
                                          int64_t base, int first, int tile_n,
                                          uint32_t keep_bits,
                                          const uint32_t* rank, int64_t head,
                                          int64_t tail) {
  const U* src = static_cast<const U*>(src_v) + base;
  U* dst = static_cast<U*>(dst_v);
  U v[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int pos = first + j * 32;
    v[j] = (keep_bits >> j & 1u) ? __ldcs(src + pos) : U(0);
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int pos = first + j * 32;
    if (pos < tile_n) {
      if (keep_bits >> j & 1u) dst[head + rank[j]] = v[j];
      else dst[tail + (pos - static_cast<int>(rank[j]))] = U(0);
    }
  }
}

__device__ __forceinline__ void move_stream(const Streams& st, int s, int64_t base,
                                            int first, int tile_n,
                                            uint32_t keep_bits,
                                            const uint32_t* rank, int64_t head,
                                            int64_t tail) {
  switch (st.log2size[s]) {
    case 0:
      move_tile<unsigned char>(st.src[s], st.dst[s], base, first, tile_n,
                               keep_bits, rank, head, tail);
      break;
    case 1:
      move_tile<unsigned short>(st.src[s], st.dst[s], base, first, tile_n,
                                keep_bits, rank, head, tail);
      break;
    case 2:
      move_tile<unsigned int>(st.src[s], st.dst[s], base, first, tile_n,
                              keep_bits, rank, head, tail);
      break;
    default:
      move_tile<unsigned long long>(st.src[s], st.dst[s], base, first, tile_n,
                                    keep_bits, rank, head, tail);
      break;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
compact_tiles(const __grid_constant__ Scan sc, const __grid_constant__ Streams st) {
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_ticket, s_excl;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    const uint32_t ticket = atomicAdd(sc.counter, 1u);
    // every other CTA has drawn its ticket
    if (ticket == sc.tiles * sc.groups - 1) *sc.counter = 0u;
    s_ticket = ticket;
  }
  __syncthreads();
  // tickets go out tile by tile, so the first CTA of every earlier tile,
  // the one that publishes, has started
  const uint32_t tile = s_ticket / sc.groups;
  const int group = static_cast<int>(s_ticket % sc.groups);
  const bool publish = group == 0;
  const int s_begin = group * sc.per_group;
  const int s_end = min(st.n, s_begin + sc.per_group);
  const int64_t base = static_cast<int64_t>(tile) * kTile;
  const int tile_n = static_cast<int>(sc.capacity - base < kTile ? sc.capacity - base : kTile);
  // row (base + first + 32 j) is this thread's row j: warps take 512
  // consecutive rows, lanes neighbouring ones
  const int first = warp * 32 * kItems + lane;
  // the warp's rows of the tile, fetched into L2 a stream ahead of their
  // loads (the first stream's while the tile is ranked and looks back)
  const int warp_rows = min(32 * kItems, tile_n - (first - lane));
  if (s_begin < s_end) prefetch_stream(st, s_begin, base + first - lane, warp_rows, lane);

  unsigned char k8[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int pos = first + j * 32;
    k8[j] = pos < tile_n ? sc.keep[base + pos] : 0;
  }
  const uint32_t lt = lanemask_lt();
  uint32_t keep_bits = 0u, count = 0u, rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t m = __ballot_sync(kFull, k8[j] != 0);
    rank[j] = count + __popc(m & lt);
    count += __popc(m);
    keep_bits |= static_cast<uint32_t>(k8[j] != 0) << j;
  }
  if (lane == 0) s_warp[warp] = count;
  __syncthreads();
  uint32_t warp_off = 0u, tile_kept = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_warp[w];
    warp_off += w < warp ? c : 0u;
    tile_kept += c;
  }

  if (warp == 0) {
    uint64_t* status = sc.status + tile;
    uint32_t excl = 0u;
    if (tile == 0) {
      if (publish && lane == 0) st_status(status, sc.epoch | kPrefix | tile_kept);
    } else {
      if (publish && lane == 0) st_status(status, sc.epoch | tile_kept);
      // lane l reads tile (j - l): the 32 tiles before, nearest in lane 0
      int64_t j = static_cast<int64_t>(tile) - 1;
      for (;;) {
        const int64_t at = j - lane;
        const uint64_t w = at >= 0 ? ld_status(sc.status + at) : (sc.epoch | kPrefix);
        if (!__all_sync(kFull, (w >> 32) == (sc.epoch >> 32))) continue;
        const uint32_t prefixes = __ballot_sync(kFull, (w & kPrefix) != 0u);
        const int nearest = prefixes ? __ffs(prefixes) - 1 : 31;
        uint32_t c = lane <= nearest ? static_cast<uint32_t>(w & kCountMask) : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
        excl += c;
        if (prefixes) break;
        j -= 32;
      }
      if (publish && lane == 0) st_status(status, sc.epoch | kPrefix | (excl + tile_kept));
    }
    if (lane == 0) {
      s_excl = excl;
      if (publish && tile == sc.tiles - 1) *sc.new_n = static_cast<int>(excl + tile_kept);
    }
  }
  __syncthreads();
  const int64_t head = s_excl;
  // dropped rows before this tile, and up to its end
  const int64_t dropped_incl = base - head + (tile_n - static_cast<int>(tile_kept));
  const int64_t tail = sc.capacity - dropped_incl;
#pragma unroll
  for (int j = 0; j < kItems; ++j) rank[j] += warp_off;

  if (sc.sel && publish) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (keep_bits >> j & 1u) sc.sel[head + rank[j]] = static_cast<int>(base + first + j * 32);
    }
  }
  for (int s = s_begin; s < s_end; ++s) {
    if (s + 1 < s_end) prefetch_stream(st, s + 1, base + first - lane, warp_rows, lane);
    move_stream(st, s, base, first, tile_n, keep_bits, rank, head, tail);
  }
}

// Streams past the first launch's: out[j] = in[sel[j]] below new_n, zero
// at and above it. blockIdx.y picks the stream.
template <typename U>
__device__ __forceinline__ void gather_one(const void* src, void* dst, int64_t j,
                                           int i, bool live) {
  static_cast<U*>(dst)[j] = live ? static_cast<const U*>(src)[i] : U(0);
}

__global__ void gather_streams(const __grid_constant__ Streams st,
                               const int* __restrict__ sel,
                               const int* __restrict__ new_n, int64_t capacity) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= capacity) return;
  const int s = blockIdx.y;
  const bool live = j < static_cast<int64_t>(*new_n);
  const int i = live ? sel[j] : 0;
  switch (st.log2size[s]) {
    case 0: gather_one<unsigned char>(st.src[s], st.dst[s], j, i, live); break;
    case 1: gather_one<unsigned short>(st.src[s], st.dst[s], j, i, live); break;
    case 2: gather_one<unsigned int>(st.src[s], st.dst[s], j, i, live); break;
    default: gather_one<unsigned long long>(st.src[s], st.dst[s], j, i, live); break;
  }
}

int log2_size(int64_t itemsize) {
  switch (itemsize) {
    case 1: return 0;
    case 2: return 1;
    case 4: return 2;
    case 8: return 3;
    default: return -1;
  }
}

}  // namespace

extern "C" {

int srt_compact_tile_rows() { return kTile; }
int srt_compact_max_streams() { return kMaxStreams; }

// keep: (capacity,) bool; descs: a HOST array of 3 * nstreams int64, the
// streams' device pointers, then their outputs' device pointers, then
// their element sizes (1, 2, 4 or 8); new_n: a device int32;
// sel: (capacity,) int32 scratch when nstreams > kMaxStreams, else null;
// status: ceil(capacity / kTile) uint64 look-back words and counter: one
// uint32, both zeroed once when allocated and used by one stream at a
// time; epoch: nonzero, a new one each launch on these words. Returns
// cudaGetLastError().
int srt_compact(const void* keep, int64_t capacity, const int64_t* descs,
                int nstreams, void* new_n, void* sel, void* status, void* counter,
                uint32_t epoch, void* stream) {
  if (capacity < 1 || capacity > kMaxCapacity || nstreams < 0 || epoch == 0u ||
      (nstreams > kMaxStreams && sel == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* srcs = descs;
  const int64_t* dsts = descs + nstreams;
  const int64_t* itemsizes = descs + 2 * nstreams;
  for (int s = 0; s < nstreams; ++s) {
    if (log2_size(itemsizes[s]) < 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const unsigned tiles = static_cast<unsigned>((capacity + kTile - 1) / kTile);
  Scan sc;
  sc.keep = static_cast<const unsigned char*>(keep);
  sc.new_n = static_cast<int*>(new_n);
  sc.sel = nstreams > kMaxStreams ? static_cast<int*>(sel) : nullptr;
  sc.status = static_cast<uint64_t*>(status);
  sc.counter = static_cast<unsigned*>(counter);
  sc.epoch = static_cast<uint64_t>(epoch) << 32;
  sc.capacity = capacity;
  sc.tiles = tiles;
  // CTAs per tile: enough to fill the card's resident CTAs when tiles are
  // few, each with at least one stream of the first launch
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int first_n = nstreams < kMaxStreams ? nstreams : kMaxStreams;
  const int64_t want = (static_cast<int64_t>(sms) * kCtasPerSm + tiles - 1) / tiles;
  const int groups0 = static_cast<int>(want < first_n ? want : first_n);
  sc.per_group = groups0 > 1 ? (first_n + groups0 - 1) / groups0 : (first_n > 0 ? first_n : 1);
  sc.groups = first_n > 0 ? (first_n + sc.per_group - 1) / sc.per_group : 1;
  for (int g = 0; g == 0 || g < nstreams; g += kMaxStreams) {
    Streams st;
    st.n = nstreams - g < kMaxStreams ? nstreams - g : kMaxStreams;
    for (int s = 0; s < st.n; ++s) {
      st.src[s] = reinterpret_cast<const void*>(srcs[g + s]);
      st.dst[s] = reinterpret_cast<void*>(dsts[g + s]);
      st.log2size[s] = static_cast<unsigned char>(log2_size(itemsizes[g + s]));
    }
    if (g == 0) {
      compact_tiles<<<tiles * sc.groups, kThreads, 0, cs>>>(sc, st);
    } else {
      const dim3 grid(static_cast<unsigned>((capacity + kThreads - 1) / kThreads),
                      static_cast<unsigned>(st.n));
      gather_streams<<<grid, kThreads, 0, cs>>>(st, sc.sel, sc.new_n, capacity);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
