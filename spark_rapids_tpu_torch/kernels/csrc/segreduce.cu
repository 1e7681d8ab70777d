// Per-(row block, segment) partial sums: the port of the TPU kernel
// spark_rapids_tpu/kernels/segreduce.py onehot_partials (pallas_call at
// :145), which ops/segsum.py::batched_segment_sum_f64 reduces over blocks.
//
// What it computes: out[b, s, j] = sum of x[r, j] over the rows r of block
// b (rows b*block .. b*block+block-1) whose gid[r] == s. x is (capacity, c)
// with any element strides (the caller passes column-major: one column's
// rows contiguous), f64 or f32; gid is int32; out is (nb, nseg, c) in x's
// type.
// Rows whose gid lies outside [0, nseg) contribute nothing, as in the
// one-hot contraction of the TPU kernel.
//
// What bounds it on an H100: bytes. Each input element is read once
// (capacity * (c * sizeof(T) + 4) bytes) and the output is small
// (nb * nseg * c), so the floor is the read at 3.35 TB/s.
//
// The TPU kernel built a (block, nseg) one-hot tile in VMEM and contracted
// it on the MXU: work per element grows with nseg, which the matrix unit
// absorbs. On Hopper that contraction is nseg select-adds per element and a
// warp shuffle tree per (warp, segment, column), more than the byte floor
// at q1's 16 segments. Here the work per element does not depend on nseg:
//
// 1. rank: one CTA of 256 threads takes a block of up to 1024 rows, four
//    a thread (rows t, t+256, ...: a warp reads 32 consecutive rows of a
//    column-major x). The rows are put in a stable counting-sort order by
//    gid: __match_any_sync gives each row its rank among the rows of its
//    32-row chunk with the same gid and each chunk its per-segment count;
//    an exclusive scan of the counts in (segment, chunk) order gives every
//    row its place and every segment a contiguous range.
// 2. stage: one column at a time, each thread writes its rows' values to
//    their places in shared memory; the next column's loads are issued
//    before this one is summed, and the first column's before the scan.
// 3. sum: one warp per segment adds its range, each lane every 32nd value
//    in order, then a fixed shuffle tree; empty ranges write 0.
// A CTA holds 8 KB of staged doubles and 32 registers a thread, so eight
// CTAs (2048 threads) share an SM: the loads of some overlap the ranking
// and summing of others. (Staging four columns at a time, with 63
// registers and four CTAs an SM, was slower on an H100 at q1's and q2's
// shapes.)
//
// No float atomics: every addition's order is fixed by the launch shape
// and the stable ranks, so two runs give the same bits (torch's CUDA
// index_add_ on f64 does not). The order differs from a row-order sum by
// at most a 1024-term reassociation, well inside rtol 1e-12 of each
// partial's absolute mass in f64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kMaxBlock = kThreads * kRowsPerThread;  // 1024 rows
constexpr int kChunks = kMaxBlock / 32;               // 32-row chunks
constexpr int kMaxSegments = 32;
constexpr unsigned kFull = 0xffffffffu;

// v[i] = column j of the thread's row i where that row is used, else 0
template <typename T>
__device__ __forceinline__ void load_column(T (&v)[kRowsPerThread],
                                            const T* __restrict__ x,
                                            const int (&g)[kRowsPerThread],
                                            int64_t row0, int j,
                                            int64_t row_stride,
                                            int64_t col_stride) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t r = row0 + threadIdx.x + i * kThreads;
    v[i] = g[i] >= 0 ? __ldcs(x + r * row_stride + j * col_stride) : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
partials_block(const T* __restrict__ x, const int32_t* __restrict__ gid,
               T* __restrict__ out, int nseg, int c, int block,
               int64_t row_stride, int64_t col_stride) {
  // per-(segment, chunk) row counts, then their exclusive scan in place;
  // the last word is the total
  __shared__ int scan[kMaxSegments * kChunks + 1];
  __shared__ int warp_total[kWarps];
  __shared__ T staged[kMaxBlock];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block;

  for (int f = threadIdx.x; f <= kMaxSegments * kChunks; f += kThreads) {
    scan[f] = 0;
  }
  int g[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = threadIdx.x + i * kThreads;
    g[i] = r < block ? __ldcs(gid + row0 + r) : -1;
  }
  __syncthreads();
  int pos[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (g[i] < 0 || g[i] >= nseg) g[i] = -1;
    const unsigned peers = __match_any_sync(kFull, g[i]);
    pos[i] = __popc(peers & ((1u << lane) - 1u));  // rank in the chunk
    if (g[i] >= 0 && pos[i] == 0) {
      scan[g[i] * kChunks + i * kWarps + warp] = __popc(peers);
    }
  }
  T v[kRowsPerThread];
  load_column(v, x, g, row0, 0, row_stride, col_stride);
  __syncthreads();

  // exclusive scan of the 1024 counts: four consecutive a thread
  {
    const int f0 = threadIdx.x * 4;
    const int a0 = scan[f0], a1 = scan[f0 + 1], a2 = scan[f0 + 2],
              a3 = scan[f0 + 3];
    const int mine = a0 + a1 + a2 + a3;
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int excl = incl - mine;
    for (int w = 0; w < warp; ++w) excl += warp_total[w];
    scan[f0] = excl;
    scan[f0 + 1] = excl + a0;
    scan[f0 + 2] = excl + a0 + a1;
    scan[f0 + 3] = excl + a0 + a1 + a2;
    if (threadIdx.x == kThreads - 1) scan[kMaxSegments * kChunks] = excl + mine;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (g[i] >= 0) pos[i] += scan[g[i] * kChunks + i * kWarps + warp];
  }

  for (int j = 0; j < c; ++j) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      if (g[i] >= 0) staged[pos[i]] = v[i];
    }
    __syncthreads();
    if (j + 1 < c) load_column(v, x, g, row0, j + 1, row_stride, col_stride);
    for (int s = warp; s < nseg; s += kWarps) {
      const int a = scan[s * kChunks];
      const int e = scan[(s + 1) * kChunks];
      T acc = T(0);
      if (a < e) {  // uniform over the warp
        for (int q = a + lane; q < e; q += 32) acc += staged[q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc += __shfl_down_sync(kFull, acc, off);
        }
      }
      if (lane == 0) {
        out[(static_cast<int64_t>(blockIdx.x) * nseg + s) * c + j] = acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// x: (nb * block, c) with element strides (row_stride, col_stride);
// gid: (nb * block,) int32; out: (nb, nseg, c) contiguous. is_f64 selects
// double (1) or float (0). Returns cudaGetLastError() after the launch.
int srt_onehot_partials(const void* x, const void* gid, void* out, int64_t nb,
                        int nseg, int c, int block, int64_t row_stride,
                        int64_t col_stride, int is_f64, void* stream) {
  if (nb <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  if (nseg < 1 || nseg > kMaxSegments || block < 1 || block > kMaxBlock ||
      nb > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    partials_block<double><<<grid, kThreads, 0, st>>>(
        static_cast<const double*>(x), static_cast<const int32_t*>(gid),
        static_cast<double*>(out), nseg, c, block, row_stride, col_stride);
  } else {
    partials_block<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(gid),
        static_cast<float*>(out), nseg, c, block, row_stride, col_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
