// Stable lexicographic sort of 32-bit operands with a row-index payload:
// the port of the TPU kernel spark_rapids_tpu/kernels/sort.py
// sort_with_payload (body _build at :72, pallas_call at :84).
//
// What it computes: the arrays a_0 .. a_{m-1} (int32 or uint32 keys, then
// the int32 payload last) reordered so that the tuples
// (a_0[i], ..., a_{m-1}[i]) ascend. The payload is a unique row-index iota
// (the ops/ordering.py lex_sort contract) and is compared as the last key,
// so every tuple is unique and the one ascending order is exactly the
// stable sort of the keys that carries the payload along.
//
// What bounds it on an H100: bytes, moved many times. A bitonic network
// over n = 2^p elements runs p(p+1)/2 compare-exchange substages, each of
// which touches every element once; the floor for the sort itself (read
// and write each array once) is far below that.
//
// Design: a bitonic network, as the TPU kernel ran, with the substages
// placed by partner distance. While the distance is at least the shared
// tile, one launch of bitonic_global runs one substage over device memory
// (one thread per compare-exchange pair). Every substage below the tile
// runs inside bitonic_shared: a CTA loads its tile of every array into
// shared memory once, runs all those substages between barriers, and
// writes the tile back. The first bitonic_shared launch sorts each tile
// outright (all substages up to the tile width). Keys are compared as
// unsigned words after xor with a per-array mask (0x80000000 for a signed
// array), which orders int32 and uint32 alike. The TPU kernel kept all
// operands resident in VMEM for the whole network; 227 KB of shared memory
// cannot hold a large sort, so only the short-distance substages stay on
// chip here. A first launch copies the inputs into the outputs, which are
// then sorted in place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxArrays = 32;
constexpr int kMaxTile = 2048;               // threads per CTA = tile / 2
constexpr int kSharedBudget = 96 * 1024;     // bytes of shared memory per CTA
constexpr int kThreads = 256;

struct Arrays {
  uint32_t* ptr[kMaxArrays];
  uint32_t flip[kMaxArrays];
  int n;
};

struct ConstArrays {
  const uint32_t* ptr[kMaxArrays];
};

__global__ void copy_arrays(ConstArrays src, Arrays dst, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int k = 0; k < dst.n; ++k) dst.ptr[k][i] = src.ptr[k][i];
}

// tuple(i) > tuple(l) over the flipped words
__device__ __forceinline__ bool tuple_greater_global(const Arrays& a, int64_t i,
                                                     int64_t l) {
  for (int k = 0; k < a.n; ++k) {
    const uint32_t x = a.ptr[k][i] ^ a.flip[k];
    const uint32_t y = a.ptr[k][l] ^ a.flip[k];
    if (x != y) return x > y;
  }
  return false;
}

// one substage at partner distance j inside bitonic blocks of width k
__global__ void bitonic_global(Arrays a, int64_t n, int64_t k, int64_t j) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const int64_t i = 2 * j * (t / j) + (t % j);  // lower index of the pair
  const int64_t l = i + j;
  const bool asc = (i & k) == 0;
  const bool swap = asc ? tuple_greater_global(a, i, l)
                        : tuple_greater_global(a, l, i);
  if (swap) {
    for (int m = 0; m < a.n; ++m) {
      const uint32_t x = a.ptr[m][i];
      a.ptr[m][i] = a.ptr[m][l];
      a.ptr[m][l] = x;
    }
  }
}

// Every substage with partner distance below the tile, for bitonic block
// widths k_lo, 2*k_lo, ..., k_hi, on one tile per CTA (blockDim = tile/2).
__global__ void bitonic_shared(Arrays a, int tile, int64_t k_lo, int64_t k_hi) {
  extern __shared__ uint32_t sm[];  // [a.n][tile], flipped words
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  const int nt = blockDim.x;
  for (int m = 0; m < a.n; ++m) {
    for (int e = threadIdx.x; e < tile; e += nt) {
      sm[m * tile + e] = a.ptr[m][base + e] ^ a.flip[m];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;  // pair index within the tile
  for (int64_t k = k_lo; k <= k_hi; k <<= 1) {
    const int jstart = static_cast<int>((k < tile ? k : tile) / 2);
    for (int j = jstart; j >= 1; j >>= 1) {
      const int li = 2 * j * (t / j) + (t % j);
      const int ll = li + j;
      const bool asc = ((base + li) & k) == 0;
      int cmp = 0;  // sign of tuple(li) - tuple(ll)
      for (int m = 0; m < a.n && cmp == 0; ++m) {
        const uint32_t x = sm[m * tile + li];
        const uint32_t y = sm[m * tile + ll];
        cmp = (x > y) - (x < y);
      }
      if (asc ? cmp > 0 : cmp < 0) {
        for (int m = 0; m < a.n; ++m) {
          const uint32_t x = sm[m * tile + li];
          sm[m * tile + li] = sm[m * tile + ll];
          sm[m * tile + ll] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int m = 0; m < a.n; ++m) {
    for (int e = threadIdx.x; e < tile; e += nt) {
      a.ptr[m][base + e] = sm[m * tile + e] ^ a.flip[m];
    }
  }
}

}  // namespace

extern "C" {

// in_ptrs / out_ptrs: n_arr device pointers (host arrays) to n 32-bit
// words each; flips: n_arr masks (0x80000000 for int32, 0 for uint32).
// n must be a power of two >= 2. Returns cudaGetLastError().
int srt_sort_with_payload(void* const* in_ptrs, void* const* out_ptrs,
                          const uint32_t* flips, int n_arr, int64_t n,
                          void* stream) {
  if (n_arr < 1 || n_arr > kMaxArrays || n < 2 || (n & (n - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ConstArrays src;
  Arrays a;
  a.n = n_arr;
  for (int m = 0; m < kMaxArrays; ++m) {
    src.ptr[m] = m < n_arr ? static_cast<const uint32_t*>(in_ptrs[m]) : nullptr;
    a.ptr[m] = m < n_arr ? static_cast<uint32_t*>(out_ptrs[m]) : nullptr;
    a.flip[m] = m < n_arr ? flips[m] : 0u;
  }
  int64_t tile = kMaxTile;
  while (tile > 2 && static_cast<int64_t>(n_arr) * tile * 4 > kSharedBudget) {
    tile >>= 1;
  }
  if (tile > n) tile = n;
  const size_t smem = static_cast<size_t>(n_arr) * tile * 4;
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t copy_blocks = (n + kThreads - 1) / kThreads;
  copy_arrays<<<static_cast<unsigned>(copy_blocks), kThreads, 0, st>>>(src, a, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const unsigned tiles = static_cast<unsigned>(n / tile);
  const unsigned tthreads = static_cast<unsigned>(tile / 2);
  bitonic_shared<<<tiles, tthreads, smem, st>>>(a, static_cast<int>(tile), 2, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t pair_blocks = (n / 2 + kThreads - 1) / kThreads;
  for (int64_t k = 2 * tile; k <= n; k <<= 1) {
    for (int64_t j = k / 2; j >= tile; j >>= 1) {
      bitonic_global<<<static_cast<unsigned>(pair_blocks), kThreads, 0, st>>>(
          a, n, k, j);
    }
    bitonic_shared<<<tiles, tthreads, smem, st>>>(a, static_cast<int>(tile), k, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
