// Bounded-attempt hash-table probe: the port of the TPU kernel
// spark_rapids_tpu/kernels/hashprobe.py probe_rowids (pallas_call at :139).
//
// What it computes: for every probe row i, the build rowid stored in the
// first of `attempts` salted slots whose entry holds a row (>= 0) and the
// probe row's exact 64-bit key, else -1. An invalid probe row yields -1.
//
// The table is the one kernels/hashprobe.py build_table fills: per slot a
// rowid (int32, -1 when empty) and the key (int64) of the row placed there.
// Slots are the reference's: the key splits in registers into its high
// and low 32-bit words (the reference's two-limb layout, ops/limbs.py
// split_i64_hi_lo, read as unsigned), and each attempt mixes them with
// that attempt's pair of odd multipliers and a murmur-style finalizer in
// unsigned 32-bit arithmetic. The same slots mean the same table and the
// same failure flag as the reference's build, bit for bit.
//
// What bounds it on an H100: bytes. Each probe row reads its key (8 B)
// and validity (1 B) and writes its rowid (4 B); each attempt gathers one
// rowid (4 B) and, on an occupied slot, one key (8 B) from the table.
//
// Design: one thread per probe row, a grid-stride loop, the probe loop
// in registers, and a break at the first hit. The TPU kernel held the
// whole table in VMEM per row block and evaluated every attempt for the
// whole block; on Hopper the table stays in device memory (L2 holds the
// hot part) and each thread stops at its first hit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAttempts = 8;

// per-attempt (hi, lo) multipliers: kernels/hashprobe.py _SALTS
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

__global__ void probe_rows(const int64_t* __restrict__ keys,
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

}  // namespace

extern "C" {

// keys: (n,) int64; valid: (n,) bool; table_row: (H,) int32;
// table_key: (H,) int64; out: (n,) int32; H a power of two;
// 1 <= attempts <= 8. Returns cudaGetLastError().
int srt_probe_rowids(const void* keys, const void* valid, const void* table_row,
                     const void* table_key, void* out, int64_t n, int64_t H,
                     int attempts, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (attempts < 1 || attempts > kMaxAttempts || H < 1 || (H & (H - 1)) ||
      H > (int64_t(1) << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride past 64 waves
  probe_rows<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int64_t*>(keys), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(table_row),
      static_cast<const int64_t*>(table_key), static_cast<int32_t*>(out), n,
      static_cast<uint32_t>(H - 1), attempts);
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
