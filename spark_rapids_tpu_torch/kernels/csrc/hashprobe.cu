// Bounded-attempt hash-table probe: the port of the TPU kernel
// spark_rapids_tpu/kernels/hashprobe.py probe_rowids (pallas_call at :139).
//
// What it computes: for every probe row i, the build rowid stored in the
// first of `attempts` salted slots whose entry holds a row (>= 0) with the
// probe row's exact 64-bit key, else -1. An invalid probe row yields -1.
//
// The table is the rowid array kernels/hashprobe.py build_table fills (per
// slot an int32 rowid, -1 when empty). The key of an occupied slot is
// build_keys[rowid]: the build stores row r's key in the slot that holds r,
// so build_keys[table_row[s]] equals the reference's stored key limbs for
// every occupied slot s. Slots are the reference's: the key splits in
// registers into its high and low 32-bit words (ops/limbs.py
// split_i64_hi_lo, read as unsigned), and each attempt mixes them with that
// attempt's pair of odd multipliers and a murmur-style finalizer in
// unsigned 32-bit arithmetic.
//
// Why the walk may stop at the first EMPTY slot. The build fills slots in
// rounds and never empties one. Take a row placed at attempt k. At every
// attempt j < k its slot was either occupied at the start of round j, or
// empty, in which case the row scatter-maxed into it, lost, and the round's
// winner holds it from then on. So every slot of attempts 0..k-1 of a
// placed row's key is occupied in the final table. A probe whose
// attempt-j slot is empty therefore has no row with its key at attempt j
// or later, and no hit before j (it would have stopped there): the full
// walk's answer is -1, as the early exit's. The first hit is unchanged, a
// duplicated key's first hit included, and rows left homeless by the build
// are in no slot, so the rowids are the full walk's bit for bit.
//
// What bounds it on an H100: bytes. Each probe row reads its key (8 B) and
// validity (1 B) and writes its rowid (4 B); the table is read where the
// walk goes: per attempt one rowid (4 B) and, on an occupied slot, one
// build key (8 B), each a random 32-byte sector.
//
// Design: the rowid table (4 B a slot) and the build keys (8 B a build
// row) are the only gather sources, so at the join's shapes both fit in
// the 50 MB L2 together (16 MiB + 16 MiB at H = 2^22 and 2^21 build rows),
// where a {key, rowid} slot table of 16 B a slot would not (64 MiB). The
// probe keys, validity and rowids stream with evict-first hints so they
// pass through L2 without pushing the table out. Each thread takes kRows
// probe rows a warp-width apart (coalesced) and walks them in lockstep:
// per attempt it issues all their rowid loads, then all their key loads,
// so the dependent random loads of kRows rows are in flight together. Most
// rows stop at the first attempt: at the join's loads (about 0.14) a miss
// visits about 1.16 slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;  // probe rows per thread, walked in lockstep
constexpr int kMaxAttempts = 8;

// per-attempt (hi, lo) multipliers: kernels/hashprobe.py _SALTS
__constant__ uint32_t kSaltHi[kMaxAttempts] = {
    0x9E3779B1u, 0xC2B2AE3Du, 0x165667B1u, 0xD6E8FEB9u,
    0x2545F491u, 0xB5297A4Du, 0x1B56C4E9u, 0x846CA68Bu};
__constant__ uint32_t kSaltLo[kMaxAttempts] = {
    0x85EBCA77u, 0x27D4EB2Fu, 0x9E3779B9u, 0xCA9B0A93u,
    0x8F4C2D17u, 0x68E31DA5u, 0x7FEB352Du, 0xC2B2AE35u};

__device__ __forceinline__ uint32_t slot_of(long long x, int attempt,
                                            uint32_t mask) {
  const uint32_t hi = static_cast<uint32_t>(static_cast<unsigned long long>(x) >> 32);
  const uint32_t lo = static_cast<uint32_t>(static_cast<unsigned long long>(x));
  uint32_t h = (hi * kSaltHi[attempt]) ^ (lo * kSaltLo[attempt]);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h & mask;
}

__global__ void __launch_bounds__(kThreads)
probe_rows(const long long* __restrict__ keys,
           const unsigned char* __restrict__ valid,
           const int* __restrict__ table_row,
           const long long* __restrict__ build_keys, int* __restrict__ out,
           int64_t n, uint32_t mask, int attempts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * kRows;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kRows + threadIdx.x;
       base < n; base += stride) {
    long long x[kRows];
    int res[kRows];
    bool walking[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t i = base + static_cast<int64_t>(k) * kThreads;
      walking[k] = i < n && __ldcs(valid + i) != 0;
      x[k] = walking[k] ? __ldcs(keys + i) : 0;
      res[k] = -1;
    }
    for (int a = 0; a < attempts; ++a) {
      int r[kRows];
      long long kk[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        r[k] = walking[k] ? __ldg(table_row + slot_of(x[k], a, mask)) : -1;
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        kk[k] = r[k] >= 0 ? __ldg(build_keys + r[k]) : 0;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (walking[k] && (r[k] < 0 || kk[k] == x[k])) {
          res[k] = r[k];  // the hit, or -1 at the first empty slot
          walking[k] = false;
        }
        any |= walking[k];
      }
      if (!any) break;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t i = base + static_cast<int64_t>(k) * kThreads;
      if (i < n) __stcs(out + i, res[k]);
    }
  }
}

}  // namespace

extern "C" {

// keys: (n,) int64; valid: (n,) bool; table_row: (H,) int32 from
// build_table over build_keys; build_keys: int64, indexed by rowid;
// out: (n,) int32; H a power of two; 1 <= attempts <= 8. Returns
// cudaGetLastError().
int srt_probe_rowids(const void* keys, const void* valid, const void* table_row,
                     const void* build_keys, void* out, int64_t n, int64_t H,
                     int attempts, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (attempts < 1 || attempts > kMaxAttempts || H < 1 || (H & (H - 1)) ||
      H > (int64_t(1) << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t blocks = (n + kThreads * kRows - 1) / (kThreads * kRows);
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past 32 waves
  probe_rows<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const long long*>(keys), static_cast<const unsigned char*>(valid),
      static_cast<const int*>(table_row), static_cast<const long long*>(build_keys),
      static_cast<int*>(out), n, static_cast<uint32_t>(H - 1), attempts);
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
