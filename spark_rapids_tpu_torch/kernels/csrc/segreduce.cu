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
// (capacity * (c * sizeof(T) + 4) bytes) and the output is tiny
// (nb * nseg * c), so the floor is the read at 3.35 TB/s. The arithmetic
// is nseg select-adds per element, which the FP64 pipes absorb at q1's
// nseg = 16.
//
// Design: one CTA of 128 threads per row block (block <= 1024, so each
// thread owns at most 8 rows, held in registers: their gids once, then
// one column's values at a time; with column-major x a warp's load of one
// column is 32 consecutive elements). For every (segment, column) a thread
// adds its own rows in row order, the warp combines the 32 lane sums with
// a fixed shuffle tree, and after one barrier the four warp sums are added
// in warp order. No float atomics: the order of every addition is fixed by
// the launch shape, so two runs give the same bits (torch's CUDA
// index_add_ on f64 does not). The TPU kernel built a (block, nseg) one-hot
// tile in VMEM and contracted it on the MXU; here the one-hot is the
// predicate gid == s on registers, and nothing segment-shaped touches
// device memory except the partials. Columns beyond kColChunk ride
// blockIdx.y so the shared partials stay within the default 48 KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" {

// x: (nb * block, c) with element strides (row_stride, col_stride);
// gid: (nb * block,) int32; out: (nb, nseg, c) contiguous. is_f64 selects
// double (1) or float (0). Returns cudaGetLastError() after the launch.
int srt_onehot_partials(const void* x, const void* gid, void* out, int64_t nb,
                        int nseg, int c, int block, int64_t row_stride,
                        int64_t col_stride, int is_f64, void* stream) {
  if (nb <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  if (nseg < 1 || nseg > kMaxSegments || block < 1 ||
      block > kThreads * kRowsPerThread || nb > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(nb), (c + kColChunk - 1) / kColChunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    onehot_partials_kernel<double><<<grid, kThreads, 0, st>>>(
        static_cast<const double*>(x), static_cast<const int32_t*>(gid),
        static_cast<double*>(out), nseg, c, block, row_stride, col_stride);
  } else {
    onehot_partials_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(gid),
        static_cast<float*>(out), nseg, c, block, row_stride, col_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
