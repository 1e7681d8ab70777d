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
// natively, so one pass suffices: a double maps to an order-preserving
// signed key, key = b ^ (b < 0 ? 0x7fff_ffff_ffff_ffff : 0) on its bits b,
// every NaN maps to the canonical NaN's key (the greatest key of any
// double), and the keys reduce with 64-bit atomicMin/atomicMax. Min and
// max are exact, so the result repeats bit for bit whatever the order in
// which the atomics arrive. The identity of a double min is INT64_MAX, a
// key above NaN's, which the finishing pass turns into +inf.
//
// What bounds it on an H100: bytes. Each row reads its value (8 B), its
// validity (1 B) and its gid (4 B) once; the output is nseg * 8 B.
//
// The trap is contention: a global aggregate aims every row at one
// segment, a skewed key aims many at a few, and an atomic per row would
// serialize on those addresses. So no row issues its own atomic:
// - within a warp, a segmented scan over the lanes (5 shuffle steps) folds
//   each row into the lanes above it that carry the same gid, and only the
//   last lane of a run of equal gids holds the run's result (min and max
//   are idempotent, so a row folded twice is harmless);
// - each lane keeps that result pending while its next runs carry the
//   same gid (a global aggregate, sorted gids) and flushes it when the
//   gid changes and once at the end;
// - a flush first reads the current value and skips the atomic when it
//   cannot improve it (the value only moves one way, so a stale read
//   never skips a needed update).
// Per-CTA shared accumulators for few segments gained nothing over this
// on an H100 (2^24 rows in one segment, half or all of them valid: the
// same time within 2%), so there are none.
// Invalid rows and rows past the segment range issue no atomic at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" {

// vals: (n,) int64 or float64 (is_f64); valid: (n,) bool; gid: (n,) int32;
// out: (nseg,) of vals' type. Returns cudaGetLastError() after the
// launches.
int srt_fused_minmax(const void* vals, const void* valid, const void* gid,
                     void* out, int64_t n, int nseg, int is_min, int is_f64,
                     void* stream) {
  if (nseg < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (is_min) {
    rc = is_f64 ? launch<true, true>(vals, valid, gid, out, n, nseg, st)
                : launch<true, false>(vals, valid, gid, out, n, nseg, st);
  } else {
    rc = is_f64 ? launch<false, true>(vals, valid, gid, out, n, nseg, st)
                : launch<false, false>(vals, valid, gid, out, n, nseg, st);
  }
  return static_cast<int>(rc);
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
