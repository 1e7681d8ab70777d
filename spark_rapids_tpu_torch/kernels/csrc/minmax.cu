// Per-segment MIN/MAX of native 64-bit values: the port of the TPU kernel
// spark_rapids_tpu/kernels/segreduce.py fused_minmax (pallas_call at :108)
// together with its caller ops/segsum.py segment_minmax_64, whose semantics
// it keeps.
//
// What it computes: out[s] = min (or max) of vals[r] over the rows r with
// valid[r] and gid[r] == s, for int64 or float64 vals. Rows that are
// invalid or whose gid lies outside [0, nseg) add nothing. Empty segments
// hold the identity: INT64_MAX / INT64_MIN, +inf / -inf. Doubles follow
// Spark's order: -0.0 < 0.0 (signed zeros are ordered, not merged) and NaN
// is greater than every other value, so max is NaN when the segment holds
// any NaN and min is NaN only when every valid row is NaN; a NaN result is
// the canonical 0x7ff8000000000000 whatever the payloads were.
//
// The TPU kernel reduced two 32-bit limbs in two passes (high limb, then
// the low limb among rows tied with the winner), because the TPU has no
// 64-bit compare. Hopper compares and atomically reduces 64-bit integers
// natively, so one pass suffices on unsigned order-preserving keys:
// an int64 v has key v ^ 2^63; a double with bits b has key ~b when b is
// negative and b ^ 2^63 otherwise, and every NaN has the canonical NaN's
// key (0xfff8..., above every other double's). Min and max are exact, so
// the result repeats bit for bit whatever the order of the atomics.
// The identities are all-ones (min) and zero (max), so one memset
// initialises the output; no value's key is either, so the finishing map
// turns them into the identities above and every other key back into its
// value.
//
// What bounds it on an H100: bytes where the rows of a segment lie
// together (a global aggregate, sorted gids). Each row reads its validity
// (1 B), and a valid row its gid (4 B) and value (8 B); the output is
// nseg * 8 B. Where gids are random (q8's group-by: 2.5M rows into 2^18
// segments) the atomics bound it: each valid row reads its segment's
// result from L2, and each row that improves on what it read issues a
// 64-bit atomic.
//
// Design:
// - Each thread takes a run of 8 consecutive rows: their validity in one
//   8-byte load, then the 16-byte loads of their gids (four a load) and
//   values (two a load), all issued together and each only where one of
//   the rows it covers is valid, so a dead tail costs one byte a row.
//   Inputs that are not 16-byte aligned, and the last partial run, load
//   row by row.
// - The thread folds runs of equal gid in registers. A global aggregate or
//   sorted gids collapse to one run a thread. Every run but the thread's
//   last is flushed in row order: read the current result, and issue the
//   atomic only where the run improves on it (a result only moves one
//   way, so a stale read never skips a needed update).
// - The threads' last runs meet in a warp-segmented scan (5 shuffle
//   steps); the last lane of each run of equal gids keeps the result
//   pending while its next steps carry the same gid, and flushes it, read
//   first, when the gid changes and once at the end. So a global
//   aggregate issues about one atomic a warp.
// - Up to kFoldMax segments, the CTA that draws the last ticket applies
//   the finishing map (the ticket counter is reset by that CTA, so it is 0
//   between launches); above that, a second launch does.
// On an H100, 16-row runs whose reads all went out before their atomics
// (128 registers a thread, and reads made before other rows' atomics
// land, so fewer skips) were slower at q8's shape than 8-row runs flushed
// in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kRun = 8;                       // rows a thread takes at once
constexpr int kRowsPerCta = kThreads * kRun;  // 2048
constexpr int kMaxBlocks = 132 * 8;
constexpr int kFoldMax = 4096;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kSign = 0x8000000000000000ULL;
constexpr u64 kMag = 0x7fffffffffffffffULL;
constexpr u64 kInfBits = 0x7ff0000000000000ULL;
constexpr u64 kNegInfBits = 0xfff0000000000000ULL;
constexpr u64 kNanKey = 0xfff8000000000000ULL;  // the canonical NaN's key

template <bool kF64>
__device__ __forceinline__ u64 key_of(u64 b) {
  if (!kF64) return b ^ kSign;
  if ((b & kMag) > kInfBits) return kNanKey;  // any NaN, either sign
  return (b & kSign) ? ~b : (b ^ kSign);
}

template <bool kMin, bool kF64>
__device__ __forceinline__ u64 value_of(u64 u) {
  if (!kF64) return u ^ kSign;
  if (kMin && u == ~0ULL) return kInfBits;    // empty: +inf
  if (!kMin && u == 0ULL) return kNegInfBits;  // empty: -inf
  return (u & kSign) ? (u ^ kSign) : ~u;
}

template <bool kMin>
__device__ __forceinline__ u64 pick(u64 a, u64 b) {
  return kMin ? (b < a ? b : a) : (b > a ? b : a);
}

template <bool kMin>
__device__ __forceinline__ void atomic_pick(u64* p, u64 v) {
  if (kMin) {
    atomicMin(p, v);
  } else {
    atomicMax(p, v);
  }
}

template <bool kMin>
__device__ __forceinline__ void reduce_into(u64* p, u64 v) {
  const u64 cur = __ldcg(p);
  if (kMin ? v < cur : v > cur) atomic_pick<kMin>(p, v);
}

// g[i] = the gid of row r0 + i where that row is valid and inside
// [0, nseg), else -1; k[i] its key
template <bool kF64, bool kVec>
__device__ __forceinline__ void load_run(const u64* __restrict__ vals,
                                         const uint8_t* __restrict__ valid,
                                         const int32_t* __restrict__ gid,
                                         int64_t r0, int64_t n, int nseg,
                                         int (&g)[kRun], u64 (&k)[kRun]) {
  if (kVec && r0 + kRun <= n) {
    const uint2 vb = __ldcs(reinterpret_cast<const uint2*>(valid + r0));
    const unsigned w[kRun / 4] = {vb.x, vb.y};
    int4 gq[kRun / 4];
    ulonglong2 vq[kRun / 2];
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      gq[q] = w[q] ? __ldcs(reinterpret_cast<const int4*>(gid + r0) + q)
                   : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int p = 0; p < kRun / 2; ++p) {
      const unsigned half = (w[p / 2] >> (16 * (p % 2))) & 0xffffu;
      vq[p] = half ? __ldcs(reinterpret_cast<const ulonglong2*>(vals + r0) + p)
                   : make_ulonglong2(0ULL, 0ULL);
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const bool ok = (w[i / 4] >> (8 * (i % 4))) & 0xffu;
      const int4 q = gq[i / 4];
      const int gi = (i % 4 == 0) ? q.x : (i % 4 == 1) ? q.y
                   : (i % 4 == 2) ? q.z : q.w;
      g[i] = (ok && gi >= 0 && gi < nseg) ? gi : -1;
      k[i] = key_of<kF64>((i % 2 == 0) ? vq[i / 2].x : vq[i / 2].y);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int64_t r = r0 + i;
    g[i] = -1;
    k[i] = 0;
    if (r < n && valid[r]) {
      const int gi = gid[r];
      if (gi >= 0 && gi < nseg) {
        g[i] = gi;
        k[i] = key_of<kF64>(vals[r]);
      }
    }
  }
}

template <bool kMin, bool kF64, bool kVec, bool kFold>
__global__ void __launch_bounds__(kThreads)
minmax_runs(const u64* __restrict__ vals, const uint8_t* __restrict__ valid,
            const int32_t* __restrict__ gid, u64* __restrict__ out, int64_t n,
            int nseg, unsigned* __restrict__ ticket) {
  const int lane = threadIdx.x & 31;
  int pend_g = -1;
  u64 pend = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerCta;
  // base is uniform over the CTA, so every lane of a warp runs the same
  // iterations and the full-mask shuffles below are safe
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kRowsPerCta;
       base < n; base += stride) {
    int g[kRun];
    u64 k[kRun];
    load_run<kF64, kVec>(vals, valid, gid, base + threadIdx.x * kRun, n, nseg,
                         g, k);
    // fold forward: k[i] becomes the fold of its run up to row i
    int last_g = -1;
    u64 last = 0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (g[i] >= 0) {
        if (g[i] == last_g) k[i] = pick<kMin>(k[i], last);
        last_g = g[i];
        last = k[i];
      }
    }
    // keep g[i] only where row i ends a run that is not the thread's last
    int next_g = -1;
#pragma unroll
    for (int i = kRun - 1; i >= 0; --i) {
      if (g[i] >= 0) {
        const bool flush = next_g >= 0 && next_g != g[i];
        next_g = g[i];
        if (!flush) g[i] = -1;
      }
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (g[i] >= 0) reduce_into<kMin>(out + g[i], k[i]);
    }
    // the threads' last runs: a warp-segmented scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const u64 ko = __shfl_up_sync(kFull, last, off);
      const int go = __shfl_up_sync(kFull, last_g, off);
      if (lane >= off && go == last_g) last = pick<kMin>(last, ko);
    }
    const int g_next = __shfl_down_sync(kFull, last_g, 1);
    if (last_g >= 0 && (lane == 31 || g_next != last_g)) {
      if (last_g == pend_g) {
        pend = pick<kMin>(pend, last);
      } else {
        if (pend_g >= 0) reduce_into<kMin>(out + pend_g, pend);
        pend_g = last_g;
        pend = last;
      }
    }
  }
  if (pend_g >= 0) reduce_into<kMin>(out + pend_g, pend);
  if (!kFold) return;
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    s_last = t == gridDim.x - 1;
    if (s_last) *ticket = 0u;  // every other CTA has drawn its ticket
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int s = threadIdx.x; s < nseg; s += kThreads) {
    out[s] = value_of<kMin, kF64>(__ldcg(out + s));
  }
}

template <bool kMin, bool kF64>
__global__ void minmax_finish(u64* __restrict__ out, int nseg) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < nseg) out[s] = value_of<kMin, kF64>(out[s]);
}

template <bool kMin, bool kF64, bool kVec>
cudaError_t launch(const void* vals, const void* valid, const void* gid,
                   void* out, int64_t n, int nseg, unsigned* ticket,
                   cudaStream_t st) {
  u64* o = static_cast<u64*>(out);
  cudaError_t err = cudaMemsetAsync(o, kMin ? 0xff : 0,
                                    static_cast<size_t>(nseg) * sizeof(u64), st);
  if (err != cudaSuccess) return err;
  int64_t blocks = (n + kRowsPerCta - 1) / kRowsPerCta;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const auto* v = static_cast<const u64*>(vals);
  const auto* ok = static_cast<const uint8_t*>(valid);
  const auto* g = static_cast<const int32_t*>(gid);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (nseg <= kFoldMax) {
    minmax_runs<kMin, kF64, kVec, true><<<grid, kThreads, 0, st>>>(
        v, ok, g, o, n, nseg, ticket);
    return cudaGetLastError();
  }
  minmax_runs<kMin, kF64, kVec, false><<<grid, kThreads, 0, st>>>(
      v, ok, g, o, n, nseg, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  minmax_finish<kMin, kF64><<<(nseg + kThreads - 1) / kThreads, kThreads, 0,
                              st>>>(o, nseg);
  return cudaGetLastError();
}

template <bool kMin, bool kF64>
cudaError_t launch_aligned(const void* vals, const void* valid,
                           const void* gid, void* out, int64_t n, int nseg,
                           unsigned* ticket, cudaStream_t st) {
  const bool vec = ((reinterpret_cast<uintptr_t>(vals) |
                     reinterpret_cast<uintptr_t>(valid) |
                     reinterpret_cast<uintptr_t>(gid)) & 15) == 0;
  return vec ? launch<kMin, kF64, true>(vals, valid, gid, out, n, nseg,
                                        ticket, st)
             : launch<kMin, kF64, false>(vals, valid, gid, out, n, nseg,
                                         ticket, st);
}

}  // namespace

extern "C" {

// vals: (n,) int64 or float64 (is_f64); valid: (n,) bool; gid: (n,) int32;
// out: (nseg,) of vals' type; ticket: one device word, 0 before the first
// launch on it (each launch leaves it 0). Launches on one ticket must not
// overlap: one ticket per stream. Returns the first CUDA error of the
// memset and the launches.
int srt_fused_minmax(const void* vals, const void* valid, const void* gid,
                     void* out, int64_t n, int nseg, int is_min, int is_f64,
                     void* ticket, void* stream) {
  if (nseg < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* t = static_cast<unsigned*>(ticket);
  cudaError_t rc;
  if (is_min) {
    rc = is_f64 ? launch_aligned<true, true>(vals, valid, gid, out, n, nseg, t, st)
                : launch_aligned<true, false>(vals, valid, gid, out, n, nseg, t, st);
  } else {
    rc = is_f64 ? launch_aligned<false, true>(vals, valid, gid, out, n, nseg, t, st)
                : launch_aligned<false, false>(vals, valid, gid, out, n, nseg, t, st);
  }
  return static_cast<int>(rc);
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
