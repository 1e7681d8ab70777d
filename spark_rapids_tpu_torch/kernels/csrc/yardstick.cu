// Yardsticks: kernels the port does not call. chip_smoke.py builds this
// file beside the port's kernels and times these at the main path's shapes,
// next to the port's own kernels, so that one run measures both forms on
// the same card:
//
// * srt_probe_full_walk: the hash probe before the early exit (one thread
//   per probe row; a rowid load and, on an occupied slot, a load from a
//   separate int64 key table per attempt; stops only at a hit);
// * srt_probe_slot16: the probe over 16-byte {int64 key, int32 rowid, pad}
//   slots packed from build_table's two arrays (one sector per attempt,
//   64 MiB at H = 2^22), stopping at the first empty slot like
//   csrc/hashprobe.cu; the packing pass runs in the same call;
// * srt_gather_compact_two_pass: the compaction that takes pos =
//   cumsum(keep) - 1 and new_n from the caller and a device array of
//   (src, dst, itemsize) descriptors, and runs a scatter that inverts pos
//   and then a gather of one thread per (row, stream).
// * srt_onehot_partials_select_add: the partial sums before the ranked
//   form: one CTA of 128 threads a 1024-row block, nseg select-adds per
//   element and a shuffle tree per (warp, segment, column);
// * srt_fused_minmax_row_atomics: MIN/MAX before the runs: a fill kernel,
//   one row a thread per grid-stride step (validity, gid, value, a read of
//   the current result and the atomic, one after another) on signed keys,
//   and a finishing kernel for doubles.
//
// The salts and the slot function are csrc/hashprobe.cu's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAttempts = 8;

__constant__ uint32_t kSaltHi[kMaxAttempts] = {
    0x9E3779B1u, 0xC2B2AE3Du, 0x165667B1u, 0xD6E8FEB9u,
    0x2545F491u, 0xB5297A4Du, 0x1B56C4E9u, 0x846CA68Bu};
__constant__ uint32_t kSaltLo[kMaxAttempts] = {
    0x85EBCA77u, 0x27D4EB2Fu, 0x9E3779B9u, 0xCA9B0A93u,
    0x8F4C2D17u, 0x68E31DA5u, 0x7FEB352Du, 0xC2B2AE35u};

__device__ __forceinline__ uint32_t slot_of(uint32_t hi, uint32_t lo,
                                            int attempt, uint32_t mask) {
  uint32_t h = (hi * kSaltHi[attempt]) ^ (lo * kSaltLo[attempt]);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h & mask;
}

__global__ void probe_full_walk(const int64_t* __restrict__ keys,
                                const uint8_t* __restrict__ valid,
                                const int32_t* __restrict__ table_row,
                                const int64_t* __restrict__ table_key,
                                int32_t* __restrict__ out, int64_t n,
                                uint32_t mask, int attempts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t rowid = -1;
    if (valid[i]) {
      const int64_t x = keys[i];
      const uint32_t hi = static_cast<uint32_t>(static_cast<uint64_t>(x) >> 32);
      const uint32_t lo = static_cast<uint32_t>(static_cast<uint64_t>(x));
      for (int a = 0; a < attempts; ++a) {
        const uint32_t s = slot_of(hi, lo, a, mask);
        const int32_t r = __ldg(table_row + s);
        if (r >= 0 && __ldg(table_key + s) == x) {
          rowid = r;
          break;
        }
      }
    }
    out[i] = rowid;
  }
}

__global__ void pack_slots(const int32_t* __restrict__ table_row,
                           const int64_t* __restrict__ table_key,
                           longlong2* __restrict__ slots, int64_t H) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s < H) slots[s] = make_longlong2(table_key[s], table_row[s]);
}

__global__ void probe_slot16(const int64_t* __restrict__ keys,
                             const uint8_t* __restrict__ valid,
                             const longlong2* __restrict__ slots,
                             int32_t* __restrict__ out, int64_t n,
                             uint32_t mask, int attempts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t rowid = -1;
    if (valid[i]) {
      const int64_t x = keys[i];
      const uint32_t hi = static_cast<uint32_t>(static_cast<uint64_t>(x) >> 32);
      const uint32_t lo = static_cast<uint32_t>(static_cast<uint64_t>(x));
      for (int a = 0; a < attempts; ++a) {
        const longlong2 e = __ldg(slots + slot_of(hi, lo, a, mask));
        const int32_t r = static_cast<int32_t>(e.y);
        if (r < 0) break;
        if (e.x == x) {
          rowid = r;
          break;
        }
      }
    }
    out[i] = rowid;
  }
}

struct StreamDesc {
  int64_t src;
  int64_t dst;
  int64_t itemsize;
};

__global__ void invert_positions(const uint8_t* __restrict__ keep,
                                 const int32_t* __restrict__ pos,
                                 int32_t* __restrict__ sel, int64_t capacity) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < capacity && keep[i]) sel[pos[i]] = static_cast<int32_t>(i);
}

template <typename U>
__device__ __forceinline__ void move(const StreamDesc& d, int64_t j, int32_t s,
                                     bool live) {
  U* dst = reinterpret_cast<U*>(d.dst);
  dst[j] = live ? reinterpret_cast<const U*>(d.src)[s] : U(0);
}

__global__ void gather_desc_streams(const StreamDesc* __restrict__ descs,
                                    const int32_t* __restrict__ sel,
                                    const int32_t* __restrict__ new_n,
                                    int64_t capacity) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= capacity) return;
  const StreamDesc d = descs[blockIdx.y];
  const bool live = j < static_cast<int64_t>(*new_n);
  const int32_t s = live ? sel[j] : 0;
  switch (d.itemsize) {
    case 1: move<uint8_t>(d, j, s, live); break;
    case 2: move<uint16_t>(d, j, s, live); break;
    case 4: move<uint32_t>(d, j, s, live); break;
    default: move<uint64_t>(d, j, s, live); break;
  }
}

int probe_blocks(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks > 132 * 64 ? 132 * 64 : blocks);
}

// the partial sums before the ranked form (csrc/segreduce.cu)
namespace select_add {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;  // kThreads * kRowsPerThread = 1024 rows
constexpr int kMaxSegments = 32;
constexpr int kColChunk = 8;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
onehot_partials_kernel(const T* __restrict__ x, const int32_t* __restrict__ gid,
                       T* __restrict__ out, int nseg, int c, int block,
                       int64_t row_stride, int64_t col_stride) {
  __shared__ T wpart[kWarps * kMaxSegments * kColChunk];
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * kColChunk;
  const int nj = min(kColChunk, c - j0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 = static_cast<int64_t>(b) * block;

  int g[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = threadIdx.x + i * kThreads;
    g[i] = r < block ? gid[row0 + r] : -1;
  }

  for (int jj = 0; jj < nj; ++jj) {
    const int j = j0 + jj;
    T v[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = threadIdx.x + i * kThreads;
      v[i] = r < block ? x[(row0 + r) * row_stride + j * col_stride] : T(0);
    }
    for (int s = 0; s < nseg; ++s) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        acc += (g[i] == s) ? v[i] : T(0);
      }
      acc = warp_sum(acc);
      if (lane == 0) wpart[(warp * kMaxSegments + s) * kColChunk + jj] = acc;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nseg * nj; k += kThreads) {
    const int s = k / nj;
    const int jj = k % nj;
    T acc = wpart[s * kColChunk + jj];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      acc += wpart[(w * kMaxSegments + s) * kColChunk + jj];
    }
    out[(static_cast<int64_t>(b) * nseg + s) * c + j0 + jj] = acc;
  }
}


}  // namespace select_add

// MIN/MAX before the runs (csrc/minmax.cu)
namespace row_atomics {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr long long kMag = 0x7fffffffffffffffLL;
constexpr long long kI64Min = -0x7fffffffffffffffLL - 1;
constexpr long long kInfBits = 0x7ff0000000000000LL;
constexpr long long kNanKey = 0x7ff8000000000000LL;  // its own key
// key(-inf): bits 0xfff0000000000000 ^ kMag
constexpr long long kNegInfKey = static_cast<long long>(0x800fffffffffffffULL);

__device__ __forceinline__ long long f64_key(long long b) {
  if ((b & kMag) > kInfBits) return kNanKey;  // any NaN, either sign
  return b ^ ((b >> 63) & kMag);
}

template <bool kMin>
__device__ __forceinline__ long long pick(long long a, long long b) {
  return kMin ? (b < a ? b : a) : (b > a ? b : a);
}

template <bool kMin>
__device__ __forceinline__ void reduce_into(long long* p, long long v) {
  const long long cur = *reinterpret_cast<volatile long long*>(p);
  if (kMin ? v < cur : v > cur) {
    if (kMin) {
      atomicMin(p, v);
    } else {
      atomicMax(p, v);
    }
  }
}

template <bool kMin, bool kF64>
__host__ __device__ __forceinline__ long long identity() {
  return kMin ? kMag : (kF64 ? kNegInfKey : kI64Min);
}

template <bool kMin, bool kF64>
__global__ void __launch_bounds__(kThreads)
minmax_rows(const long long* __restrict__ vals,
            const uint8_t* __restrict__ valid,
            const int32_t* __restrict__ gid, long long* __restrict__ out,
            int64_t n, int nseg) {
  const long long ident = identity<kMin, kF64>();
  const int lane = threadIdx.x & 31;
  int pend_g = -1;
  long long pend = ident;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // base is uniform over the CTA, so every lane of a warp runs the same
  // iterations and the full-mask shuffles below are safe
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int g = -1;
    long long k = ident;
    if (i < n && valid[i]) {
      const int gi = gid[i];
      if (gi >= 0 && gi < nseg) {
        g = gi;
        k = kF64 ? f64_key(vals[i]) : vals[i];
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long ko = __shfl_up_sync(0xffffffffu, k, off);
      const int go = __shfl_up_sync(0xffffffffu, g, off);
      if (lane >= off && go == g) k = pick<kMin>(k, ko);
    }
    const int g_next = __shfl_down_sync(0xffffffffu, g, 1);
    if (g >= 0 && (lane == 31 || g_next != g)) {
      if (g == pend_g) {
        pend = pick<kMin>(pend, k);
      } else {
        if (pend_g >= 0) reduce_into<kMin>(out + pend_g, pend);
        pend_g = g;
        pend = k;
      }
    }
  }
  if (pend_g >= 0) reduce_into<kMin>(out + pend_g, pend);
}

__global__ void fill_identity(long long* __restrict__ out, int nseg,
                              long long ident) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < nseg) out[s] = ident;
}

// keys -> double bits; a min's identity key becomes +inf
template <bool kMin>
__global__ void keys_to_f64(long long* __restrict__ out, int nseg) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  const long long k = out[s];
  out[s] = (kMin && k == kMag) ? kInfBits : (k ^ ((k >> 63) & kMag));
}

template <bool kMin, bool kF64>
cudaError_t launch(const void* vals, const void* valid, const void* gid,
                   void* out, int64_t n, int nseg, cudaStream_t st) {
  long long* o = static_cast<long long*>(out);
  const int seg_blocks = (nseg + kThreads - 1) / kThreads;
  fill_identity<<<seg_blocks, kThreads, 0, st>>>(o, nseg,
                                                 identity<kMin, kF64>());
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    const auto* v = static_cast<const long long*>(vals);
    const auto* ok = static_cast<const uint8_t*>(valid);
    const auto* g = static_cast<const int32_t*>(gid);
    minmax_rows<kMin, kF64><<<static_cast<unsigned>(blocks), kThreads, 0,
                              st>>>(v, ok, g, o, n, nseg);
  }
  if (kF64) keys_to_f64<kMin><<<seg_blocks, kThreads, 0, st>>>(o, nseg);
  return cudaGetLastError();
}


}  // namespace row_atomics

}  // namespace

extern "C" {

// keys: (n,) int64; valid: (n,) bool; table_row: (H,) int32; table_key:
// (H,) int64 (build_table's outputs); out: (n,) int32.
int srt_probe_full_walk(const void* keys, const void* valid, const void* table_row,
                        const void* table_key, void* out, int64_t n, int64_t H,
                        int attempts, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (attempts < 1 || attempts > kMaxAttempts || H < 1 || (H & (H - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  probe_full_walk<<<probe_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(table_row), static_cast<const int64_t*>(table_key),
      static_cast<int32_t*>(out), n, static_cast<uint32_t>(H - 1), attempts);
  return static_cast<int>(cudaGetLastError());
}

// As srt_probe_full_walk, with slots: (H,) 16-byte scratch that the call
// fills from table_row and table_key before it probes.
int srt_probe_slot16(const void* keys, const void* valid, const void* table_row,
                     const void* table_key, void* slots, void* out, int64_t n,
                     int64_t H, int attempts, void* stream) {
  if (attempts < 1 || attempts > kMaxAttempts || H < 1 || (H & (H - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pack_slots<<<static_cast<unsigned>((H + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const int32_t*>(table_row), static_cast<const int64_t*>(table_key),
      static_cast<longlong2*>(slots), H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  probe_slot16<<<probe_blocks(n), kThreads, 0, st>>>(
      static_cast<const int64_t*>(keys), static_cast<const uint8_t*>(valid),
      static_cast<const longlong2*>(slots), static_cast<int32_t*>(out), n,
      static_cast<uint32_t>(H - 1), attempts);
  return static_cast<int>(cudaGetLastError());
}

// keep: (capacity,) bool; pos: (capacity,) int32; sel: (capacity,) int32
// scratch; new_n: device int32; descs: device array of nstreams (src, dst,
// itemsize) int64 triples.
int srt_gather_compact_two_pass(const void* keep, const void* pos, void* sel,
                                const void* new_n, const void* descs, int nstreams,
                                int64_t capacity, void* stream) {
  if (capacity <= 0) return static_cast<int>(cudaSuccess);
  if (nstreams < 0 || nstreams > 65535 || capacity > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nblk = static_cast<unsigned>((capacity + kThreads - 1) / kThreads);
  invert_positions<<<nblk, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(keep), static_cast<const int32_t*>(pos),
      static_cast<int32_t*>(sel), capacity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nstreams == 0) return static_cast<int>(err);
  const dim3 grid(nblk, static_cast<unsigned>(nstreams));
  gather_desc_streams<<<grid, kThreads, 0, st>>>(
      static_cast<const StreamDesc*>(descs), static_cast<const int32_t*>(sel),
      static_cast<const int32_t*>(new_n), capacity);
  return static_cast<int>(cudaGetLastError());
}

// As csrc/segreduce.cu's srt_onehot_partials.
int srt_onehot_partials_select_add(const void* x, const void* gid, void* out,
                                   int64_t nb, int nseg, int c, int block,
                                   int64_t row_stride, int64_t col_stride,
                                   int is_f64, void* stream) {
  namespace sa = select_add;
  if (nb <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  if (nseg < 1 || nseg > sa::kMaxSegments || block < 1 ||
      block > sa::kThreads * sa::kRowsPerThread || nb > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(nb),
                  (c + sa::kColChunk - 1) / sa::kColChunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    sa::onehot_partials_kernel<double><<<grid, sa::kThreads, 0, st>>>(
        static_cast<const double*>(x), static_cast<const int32_t*>(gid),
        static_cast<double*>(out), nseg, c, block, row_stride, col_stride);
  } else {
    sa::onehot_partials_kernel<float><<<grid, sa::kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(gid),
        static_cast<float*>(out), nseg, c, block, row_stride, col_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// As csrc/minmax.cu's srt_fused_minmax, without the ticket.
int srt_fused_minmax_row_atomics(const void* vals, const void* valid,
                                 const void* gid, void* out, int64_t n,
                                 int nseg, int is_min, int is_f64,
                                 void* stream) {
  namespace ra = row_atomics;
  if (nseg < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (is_min) {
    rc = is_f64 ? ra::launch<true, true>(vals, valid, gid, out, n, nseg, st)
                : ra::launch<true, false>(vals, valid, gid, out, n, nseg, st);
  } else {
    rc = is_f64 ? ra::launch<false, true>(vals, valid, gid, out, n, nseg, st)
                : ra::launch<false, false>(vals, valid, gid, out, n, nseg, st);
  }
  return static_cast<int>(rc);
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
