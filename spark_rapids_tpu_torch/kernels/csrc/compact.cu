// Row compaction through one gather map: the port of the TPU kernel
// spark_rapids_tpu/kernels/compact.py gather_compact (pallas_call at :112).
//
// What it computes: given keep[capacity] (bool), pos[i] = (number of kept
// rows before and at i) - 1, and new_n = number of kept rows (a device
// scalar), every column stream (data or validity, 1/2/4/8-byte elements)
// is compacted to its kept-row prefix: out[j] = in[sel[j]] for j < new_n,
// where sel inverts pos over the kept rows, and out[j] = 0 for j >= new_n.
//
// What bounds it on an H100: bytes. The scatter reads keep and pos and
// writes new_n indices; the gather reads new_n indices and the kept rows
// of every stream and writes every output slot once.
//
// Design: two launches on the caller's stream. invert_positions writes
// sel[pos[i]] = i for each kept row i (an i32 scatter of row indices,
// never of column data; the TPU kernel did the same scatter in XLA just
// before its body). gather_streams then runs one thread per (output row,
// stream): blockIdx.y picks the stream from a small device array of
// (src, dst, element size) descriptors, so every column and every
// validity mask of the table compacts in the same launch. Elements move
// at their native width: the TPU kernel split 64-bit columns into 32-bit
// limbs because its gathers were 32-bit; the H100 loads 8 bytes natively.
// sel is read only below new_n, where the scatter wrote every slot, so it
// needs no zero fill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void gather_streams(const StreamDesc* __restrict__ descs,
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

}  // namespace

extern "C" {

// keep: (capacity,) bool; pos: (capacity,) int32; sel: (capacity,) int32
// scratch; new_n: device int32 scalar; descs: device array of nstreams
// (src, dst, itemsize) int64 triples. Returns cudaGetLastError().
int srt_gather_compact(const void* keep, const void* pos, void* sel,
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
  gather_streams<<<grid, kThreads, 0, st>>>(
      static_cast<const StreamDesc*>(descs), static_cast<const int32_t*>(sel),
      static_cast<const int32_t*>(new_n), capacity);
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
