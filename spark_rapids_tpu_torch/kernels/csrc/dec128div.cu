// DECIMAL128 division: the quotient (Divide, HALF_UP), the remainder
// (Remainder, Java's sign) and the positive modulus (Pmod) of two decimal
// columns, one thread a row. This is CUDA work beyond the five TPU kernels:
// the reference computes these quotients on its host with Python ints
// (spark_rapids_tpu/ops/decimal.py:427-432 _host_op of DecimalDivide, :675
// _host_op of DecimalRemainder) and its device form only takes DECIMAL64
// (:434-460).
//
// What it computes, for each row i with valid[i]:
//   A = |a_i| * pow_a, B = |b_i| * pow_b (pow_a, pow_b: powers of ten the
//   host passes as words of a Python int; a is the dividend, b the divisor)
//   Divide:    q = floor(A / B), plus one where 2 (A mod B) >= B (HALF_UP on
//              the magnitude), with the sign of a / b;
//   Remainder: A mod B with the sign of a (Java's %);
//   Pmod:      ((a % b) + b) % b with Java's %: the remainder r, or r + b
//              where r is not 0 and its sign differs from b's.
// A zero divisor, or a result whose magnitude is at least bound (10^p of the
// result type), gives an invalid row (Spark's null, non-ANSI). Invalid rows
// write 0.
//
// Sizes (Spark's result-type rules): a Divide's numerator |a| * 10^up
// reaches 10^82 < 2^273 (decimal(38,0) / decimal(38,38): up = 44), nine
// 32-bit words, over a divisor below 10^38 < 2^127, four words. A
// Remainder's operands, rescaled to the common scale, reach 10^76 < 2^253
// (decimal(38,0) % decimal(38,38)): eight words each.
//
// Design: each row loads its operands' 128-bit magnitudes as four 32-bit
// words, multiplies them by the constant powers (schoolbook, 64-bit
// products) and divides with Knuth's algorithm D (TAOCP 4.3.1; the
// formulation of Hacker's Delight, divmnu): normalise by the divisor's
// leading zeros, estimate each quotient word from the top two words over the
// divisor's top word in 64 bits, correct it at most twice, multiply and
// subtract, add back in the rare case the estimate was one too large. A
// one-word divisor takes the short division. Everything lives in the
// thread's registers and local arrays; no shared memory, no
// synchronisation.
//
// What bounds it on an H100: bytes at S1's shape (decimal(32,4) /
// decimal(15,2), a 4-word numerator over a 2-word divisor: a few hundred
// integer operations a row). Each row reads 2 x 16 bytes of operands and a
// validity byte and writes 16 bytes and a validity byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNumWords = 9;   // numerator words at most
constexpr int kDivWords = 8;   // divisor words at most
constexpr int kPowWords = 5;   // 10^44 < 2^147

enum Mode { kDivide = 0, kRemainder = 1, kPmod = 2 };

// A power of ten as little-endian 32-bit words.
struct Pow {
  uint32_t w[kPowWords];
  int n;
};

// The magnitude of a 128-bit two's-complement (hi, lo) as four words.
__device__ inline bool load_magnitude(int64_t hi, int64_t lo, uint32_t* w) {
  uint64_t h = static_cast<uint64_t>(hi), l = static_cast<uint64_t>(lo);
  const bool neg = hi < 0;
  if (neg) {
    l = ~l + 1;
    h = ~h + (l == 0 ? 1 : 0);
  }
  w[0] = static_cast<uint32_t>(l);
  w[1] = static_cast<uint32_t>(l >> 32);
  w[2] = static_cast<uint32_t>(h);
  w[3] = static_cast<uint32_t>(h >> 32);
  return neg;
}

// out[0 .. 4 + p.n) = a[0..4) * p; returns the word count without leading
// zero words.
__device__ inline int mul_pow(const uint32_t* a, const Pow& p, uint32_t* out,
                              int cap) {
  for (int i = 0; i < cap; ++i) out[i] = 0;
  for (int i = 0; i < 4; ++i) {
    uint64_t carry = 0;
    for (int j = 0; j < p.n; ++j) {
      const uint64_t t = static_cast<uint64_t>(a[i]) * p.w[j] + out[i + j] +
                         carry;
      out[i + j] = static_cast<uint32_t>(t);
      carry = t >> 32;
    }
    if (i + p.n < cap) out[i + p.n] = static_cast<uint32_t>(carry);
  }
  int n = cap;
  while (n > 0 && out[n - 1] == 0) --n;
  return n;
}

// Knuth's algorithm D: q = u / v, r = u mod v for an m-word u and an n-word
// v (v[n-1] != 0). q must hold kNumWords zeroed words and r kDivWords
// zeroed words.
__device__ void divmod(const uint32_t* u, int m, const uint32_t* v, int n,
                       uint32_t* q, uint32_t* r) {
  if (m < n) {
    for (int i = 0; i < m; ++i) r[i] = u[i];
    return;
  }
  if (n == 1) {
    uint64_t k = 0;
    for (int j = m - 1; j >= 0; --j) {
      const uint64_t t = (k << 32) | u[j];
      q[j] = static_cast<uint32_t>(t / v[0]);
      k = t - static_cast<uint64_t>(q[j]) * v[0];
    }
    r[0] = static_cast<uint32_t>(k);
    return;
  }
  const int s = __clz(v[n - 1]);
  uint32_t vn[kDivWords];
  uint32_t un[kNumWords + 1];
  for (int i = n - 1; i > 0; --i) {
    vn[i] = (v[i] << s) |
            static_cast<uint32_t>((static_cast<uint64_t>(v[i - 1]) << s) >> 32);
  }
  vn[0] = v[0] << s;
  un[m] = static_cast<uint32_t>((static_cast<uint64_t>(u[m - 1]) << s) >> 32);
  for (int i = m - 1; i > 0; --i) {
    un[i] = (u[i] << s) |
            static_cast<uint32_t>((static_cast<uint64_t>(u[i - 1]) << s) >> 32);
  }
  un[0] = u[0] << s;
  const uint64_t b = 1ull << 32;
  for (int j = m - n; j >= 0; --j) {
    const uint64_t num = (static_cast<uint64_t>(un[j + n]) << 32) |
                         un[j + n - 1];
    uint64_t qhat = num / vn[n - 1];
    uint64_t rhat = num - qhat * vn[n - 1];
    while (qhat >= b ||
           qhat * vn[n - 2] > ((rhat << 32) | un[j + n - 2])) {
      qhat -= 1;
      rhat += vn[n - 1];
      if (rhat >= b) break;
    }
    int64_t k = 0, t;
    for (int i = 0; i < n; ++i) {
      const uint64_t p = qhat * vn[i];
      t = static_cast<int64_t>(un[i + j]) - k -
          static_cast<int64_t>(p & 0xFFFFFFFFull);
      un[i + j] = static_cast<uint32_t>(t);
      k = static_cast<int64_t>(p >> 32) - (t >> 32);
    }
    t = static_cast<int64_t>(un[j + n]) - k;
    un[j + n] = static_cast<uint32_t>(t);
    q[j] = static_cast<uint32_t>(qhat);
    if (t < 0) {  // the estimate was one too large: add the divisor back
      q[j] -= 1;
      uint64_t c = 0;
      for (int i = 0; i < n; ++i) {
        const uint64_t s2 = static_cast<uint64_t>(un[i + j]) + vn[i] + c;
        un[i + j] = static_cast<uint32_t>(s2);
        c = s2 >> 32;
      }
      un[j + n] += static_cast<uint32_t>(c);
    }
  }
  for (int i = 0; i < n - 1; ++i) {
    r[i] = static_cast<uint32_t>(
        ((static_cast<uint64_t>(un[i + 1]) << 32) | un[i]) >> s);
  }
  r[n - 1] = un[n - 1] >> s;
}

// -1, 0 or 1 as x compares with y (both w words).
__device__ inline int cmp_words(const uint32_t* x, const uint32_t* y, int w) {
  for (int i = w - 1; i >= 0; --i) {
    if (x[i] != y[i]) return x[i] < y[i] ? -1 : 1;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
dec128div_kernel(const int64_t* __restrict__ a_hi,
                 const int64_t* __restrict__ a_lo,
                 const int64_t* __restrict__ b_hi,
                 const int64_t* __restrict__ b_lo,
                 const uint8_t* __restrict__ valid,
                 int64_t* __restrict__ o_hi, int64_t* __restrict__ o_lo,
                 uint8_t* __restrict__ o_valid, int64_t n, int mode, Pow pa,
                 Pow pb, uint64_t bound_hi, uint64_t bound_lo) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= n) return;
  bool ok = valid[row] != 0;
  uint32_t am[4], bm[4];
  const bool an = load_magnitude(a_hi[row], a_lo[row], am);
  const bool bn = load_magnitude(b_hi[row], b_lo[row], bm);
  uint32_t u[kNumWords], v[kDivWords];
  const int m = mul_pow(am, pa, u, kNumWords);
  const int nv = mul_pow(bm, pb, v, kDivWords);
  ok = ok && nv > 0;  // a zero divisor gives null
  uint32_t q[kNumWords], r[kDivWords], d[kDivWords];
  for (int i = 0; i < kNumWords; ++i) q[i] = 0;
  for (int i = 0; i < kDivWords; ++i) r[i] = 0;
  if (ok) divmod(u, m, v, nv, q, r);
  // d = v - r (r < v), the distance to the next multiple of the divisor
  uint64_t borrow = 0;
  for (int i = 0; i < kDivWords; ++i) {
    const uint64_t t = static_cast<uint64_t>(v[i]) - r[i] - borrow;
    d[i] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1;
  }
  const uint32_t* res;
  bool neg;
  int words;
  if (mode == kDivide) {
    if (cmp_words(r, d, kDivWords) >= 0) {  // 2r >= v: round the magnitude up
      for (int i = 0; i < kNumWords; ++i) {
        if (++q[i] != 0) break;
      }
    }
    res = q;
    words = kNumWords;
    neg = an != bn;
  } else {
    bool r_zero = true;
    for (int i = 0; i < kDivWords; ++i) r_zero = r_zero && r[i] == 0;
    res = r;
    neg = an;
    if (mode == kPmod && !r_zero && an != bn) {
      res = d;  // |r + b| = |b| - |r|, with b's sign
      neg = bn;
    }
    words = kDivWords;
  }
  bool high_zero = true;
  for (int i = 4; i < words; ++i) high_zero = high_zero && res[i] == 0;
  uint64_t lo = (static_cast<uint64_t>(res[1]) << 32) | res[0];
  uint64_t hi = (static_cast<uint64_t>(res[3]) << 32) | res[2];
  ok = ok && high_zero && (hi < bound_hi || (hi == bound_hi && lo < bound_lo));
  if (neg) {
    lo = ~lo + 1;
    hi = ~hi + (lo == 0 ? 1 : 0);
  }
  o_hi[row] = ok ? static_cast<int64_t>(hi) : 0;
  o_lo[row] = ok ? static_cast<int64_t>(lo) : 0;
  o_valid[row] = ok ? 1 : 0;
}

Pow make_pow(uint64_t w0, uint64_t w1, uint64_t w2) {
  Pow p;
  const uint64_t src[3] = {w0, w1, w2};
  for (int i = 0; i < kPowWords; ++i) {
    p.w[i] = static_cast<uint32_t>(src[i / 2] >> (32 * (i % 2)));
  }
  p.n = kPowWords;
  while (p.n > 1 && p.w[p.n - 1] == 0) --p.n;
  return p;
}

}  // namespace

extern "C" {

// a_hi, a_lo, b_hi, b_lo: (n,) int64, each operand's signed 128-bit value
// (a DECIMAL64 passes its value as lo and its sign as hi); valid: (n,) bool;
// o_hi, o_lo: (n,) int64; o_valid: (n,) bool. mode: 0 divide, 1 remainder,
// 2 pmod. pow_a and pow_b: the operands' powers of ten as three 64-bit
// words each, least significant first (below 2^160); bound: 10^p as two
// 64-bit words. Returns cudaGetLastError() after the launch.
int srt_dec128_divide(const void* a_hi, const void* a_lo, const void* b_hi,
                      const void* b_lo, const void* valid, void* o_hi,
                      void* o_lo, void* o_valid, int64_t n, int mode,
                      uint64_t pa0, uint64_t pa1, uint64_t pa2, uint64_t pb0,
                      uint64_t pb1, uint64_t pb2, uint64_t bound_hi,
                      uint64_t bound_lo, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (mode < kDivide || mode > kPmod) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pow pa = make_pow(pa0, pa1, pa2), pb = make_pow(pb0, pb1, pb2);
  // the products must fit the word arrays
  if (4 + pa.n > kNumWords || 4 + pb.n > kDivWords ||
      (mode != kDivide && 4 + pa.n > kDivWords)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dec128div_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int64_t*>(a_hi), static_cast<const int64_t*>(a_lo),
      static_cast<const int64_t*>(b_hi), static_cast<const int64_t*>(b_lo),
      static_cast<const uint8_t*>(valid), static_cast<int64_t*>(o_hi),
      static_cast<int64_t*>(o_lo), static_cast<uint8_t*>(o_valid), n, mode,
      pa, pb, bound_hi, bound_lo);
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
