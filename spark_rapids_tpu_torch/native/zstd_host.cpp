// Zstandard (RFC 8878) for the port's file codecs: a decoder of the whole
// frame format (no dictionaries) and a simple encoder. ORC streams and
// Parquet pages compressed with ZSTD decode through it.
//
// Decoder: concatenated and skippable frames; the window descriptor and the
// single-segment flag; Raw, RLE and Compressed blocks; literals that are raw,
// RLE, Huffman-coded in one or four streams, or treeless (the previous
// block's Huffman table); FSE tables in predefined, RLE, compressed and
// repeat modes; sequence execution with the three repeat offsets; the XXH64
// content checksum, checked when a frame has one. Every read and write is
// bounds-checked: a corrupt or truncated frame returns a negative code.
//
// Encoder: greedy LZ77 over a hash table of 4-byte prefixes, each block's
// sequences coded with the predefined FSE distributions and its literals
// Huffman-coded (weights stored directly, so for literal bytes below 129),
// RLE or raw; a block that does not shrink goes out Raw. Frames carry their
// content size.
//
// C ABI (ctypes):
//   int64 srt_zstd_content_size(src, n)          -> summed content size of
//         every frame, -1 when a frame does not state it, < -1 on error
//   int64 srt_zstd_decompress(src, n, dst, cap)  -> bytes written, or
//         -1 corrupt, -2 dst too small, -3 unsupported (a dictionary)
//   int64 srt_zstd_compress_bound(n)
//   int64 srt_zstd_compress(src, n, dst, cap, checksum) -> bytes or -1

#include <cstdint>
#include <algorithm>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int64_t kCorrupt = -1;
constexpr int64_t kTooSmall = -2;
constexpr int64_t kUnsupported = -3;
constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr int kBlockMax = 1 << 17;

struct Fail {
  int64_t code;
};

inline void need(bool ok, int64_t code = kCorrupt) {
  if (!ok) throw Fail{code};
}

inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// -- XXH64 --------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}

inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, int64_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(len);
  while (end - p >= 8) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= static_cast<uint64_t>(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// -- bit readers ----------------------------------------------------------------

// Forward little-endian bits (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos = 0;  // in bits
  ForwardBits(const uint8_t* src, int64_t len) : p(src), n(len) {}
  uint32_t read(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i, ++pos) {
      int64_t byte = pos >> 3;
      need(byte < n);
      v |= static_cast<uint32_t>((p[byte] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t peek(int bits) {
    int64_t save = pos;
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i, ++pos) {
      int64_t byte = pos >> 3;
      if (byte < n) v |= static_cast<uint32_t>((p[byte] >> (pos & 7)) & 1) << i;
    }
    pos = save;
    return v;
  }
};

// Backward bits (Huffman and FSE streams): read from the end toward the
// start, the stream's last byte holding a 1 bit that marks its end; bits
// past the start read as zeros and count as overflow.
struct BackBits {
  const uint8_t* p;
  int64_t len;
  int64_t left;  // bits not yet read (may go negative: overflow)
  BackBits(const uint8_t* src, int64_t n) : p(src), len(n) {
    need(n > 0);
    uint8_t last = src[n - 1];
    need(last != 0);
    left = n * 8 - (8 - highbit(last));
  }
  uint64_t read(int n) {
    if (n == 0) return 0;
    uint64_t v = peek(n);
    left -= n;
    return v;
  }
  uint64_t peek(int n) const {
    if (n == 0) return 0;
    if (left >= n) return bits(left - n, n);
    if (left <= 0) return 0;
    // the first `left` bits of the stream, shifted up: zeros past the start
    return bits(0, static_cast<int>(left)) << (n - left);
  }
  // bits [lo, lo + n) of the stream, n <= 56
  uint64_t bits(int64_t lo, int n) const {
    int64_t byte = lo >> 3;
    int shift = static_cast<int>(lo & 7);
    uint64_t v;
    if (byte + 8 <= len) {
      v = rd64(p + byte) >> shift;
    } else {
      v = 0;
      for (int64_t i = byte, k = 0; i < len; ++i, ++k)
        v |= static_cast<uint64_t>(p[i]) << (8 * k);
      v >>= shift;
    }
    return v & ((1ULL << n) - 1);
  }
  bool overflow() const { return left < 0; }
  bool done() const { return left == 0; }
};

// -- FSE ------------------------------------------------------------------------

struct FseEntry {
  uint16_t sym;
  uint8_t bits;
  uint32_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> cells;
  bool ready = false;
};

void build_fse(FseTable& t, const int16_t* norm, int nsym, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.cells.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(nsym);
  uint32_t high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.cells[high--].sym = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = norm[s] > 0 ? norm[s] : 0;
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[pos].sym = static_cast<uint16_t>(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  need(pos == 0);
  for (uint32_t u = 0; u < size; ++u) {
    uint16_t s = t.cells[u].sym;
    uint32_t x = next[s]++;
    need(x > 0);
    int nb = log - highbit(x);
    t.cells[u].bits = static_cast<uint8_t>(nb);
    t.cells[u].base = (x << nb) - size;
  }
  t.ready = true;
}

// Reads a normalized-count table description; returns bytes used.
int64_t read_fse_description(const uint8_t* src, int64_t n, int max_sym,
                             int max_log, int16_t* norm, int* nsym,
                             int* log_out) {
  ForwardBits br(src, n);
  int log = static_cast<int>(br.read(4)) + 5;
  need(log <= max_log);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = br.read(2);
        n0 += static_cast<int>(r);
        if (r != 3) break;
      }
      need(n0 <= max_sym);
      while (sym < n0) norm[sym++] = 0;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t v = br.peek(nb);
    if (static_cast<int>(v & (threshold - 1)) < max) {
      count = static_cast<int>(v & (threshold - 1));
      br.read(nb - 1);
    } else {
      count = static_cast<int>(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.read(nb);
    }
    --count;
    remaining -= count < 0 ? -count : count;
    need(remaining >= 1);
    norm[sym++] = static_cast<int16_t>(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  need(remaining == 1);
  *nsym = sym;
  *log_out = log;
  need((br.pos + 7) / 8 <= n);
  return (br.pos + 7) / 8;
}

// -- the predefined distributions and code tables (RFC 8878 3.1.1.3.2) ----

const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                              9,  10, 11,  12,  13,  14,   15,   16,   18,
                              20, 22, 24,  28,  32,  40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Predefined {
  FseTable ll, ml, of;
  Predefined() {
    build_fse(ll, kLLNorm, 36, 6);
    build_fse(ml, kMLNorm, 53, 6);
    build_fse(of, kOFNorm, 29, 5);
  }
};

const Predefined& predefined() {
  static const Predefined p;
  return p;
}

// -- Huffman --------------------------------------------------------------------

struct HufEntry {
  uint8_t sym;
  uint8_t bits;
};

struct HufTable {
  int log = 0;
  std::vector<HufEntry> cells;
  bool ready = false;
};

// Reads the tree description; returns bytes used.
int64_t read_huffman(const uint8_t* src, int64_t n, HufTable& t) {
  need(n >= 1);
  uint8_t weights[256];
  std::memset(weights, 0, sizeof(weights));
  int nw = 0;
  int64_t used;
  uint32_t head = src[0];
  if (head < 128) {
    // FSE-compressed weights: `head` bytes
    need(head >= 1 && 1 + static_cast<int64_t>(head) <= n);
    int16_t norm[256];
    int nsym = 0, log = 0;
    int64_t d = read_fse_description(src + 1, head, 255, 6, norm, &nsym, &log);
    FseTable ft;
    build_fse(ft, norm, nsym, log);
    need(d < head);
    BackBits bb(src + 1 + d, head - d);
    uint32_t s1 = static_cast<uint32_t>(bb.read(log));
    uint32_t s2 = static_cast<uint32_t>(bb.read(log));
    for (;;) {
      need(nw <= 253);
      const FseEntry& e1 = ft.cells[s1];
      weights[nw++] = static_cast<uint8_t>(e1.sym);
      s1 = e1.base + static_cast<uint32_t>(bb.read(e1.bits));
      if (bb.overflow()) {
        weights[nw++] = static_cast<uint8_t>(ft.cells[s2].sym);
        break;
      }
      const FseEntry& e2 = ft.cells[s2];
      weights[nw++] = static_cast<uint8_t>(e2.sym);
      s2 = e2.base + static_cast<uint32_t>(bb.read(e2.bits));
      if (bb.overflow()) {
        weights[nw++] = static_cast<uint8_t>(ft.cells[s1].sym);
        break;
      }
    }
    used = 1 + head;
  } else {
    nw = static_cast<int>(head) - 127;
    int64_t bytes = (nw + 1) / 2;
    need(1 + bytes <= n);
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + bytes;
  }
  // the last weight is implied: the weights' sum must reach a power of 2
  uint32_t sum = 0;
  for (int i = 0; i < nw; ++i) {
    need(weights[i] <= 11);
    if (weights[i]) sum += 1u << (weights[i] - 1);
  }
  need(sum > 0);
  int maxbits = highbit(sum) + 1;
  need(maxbits <= 11);
  uint32_t rest = (1u << maxbits) - sum;
  need(rest > 0 && (rest & (rest - 1)) == 0);
  need(nw < 256);
  weights[nw++] = static_cast<uint8_t>(highbit(rest) + 1);
  // the decoding table: weight 1 first, symbols in order within a weight
  uint32_t rank_count[13] = {0};
  for (int i = 0; i < nw; ++i) rank_count[weights[i]]++;
  uint32_t start[13] = {0};
  uint32_t next = 0;
  for (int w = 1; w <= maxbits; ++w) {
    start[w] = next;
    next += rank_count[w] << (w - 1);
  }
  need(next == (1u << maxbits));
  t.log = maxbits;
  t.cells.assign(1u << maxbits, HufEntry{0, 0});
  for (int s = 0; s < nw; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = 1u << (w - 1);
    HufEntry e{static_cast<uint8_t>(s), static_cast<uint8_t>(maxbits + 1 - w)};
    for (uint32_t u = start[w]; u < start[w] + len; ++u) t.cells[u] = e;
    start[w] += len;
  }
  t.ready = true;
  return used;
}

void huffman_stream(const HufTable& t, const uint8_t* src, int64_t n,
                    uint8_t* out, int64_t count) {
  BackBits bb(src, n);
  for (int64_t i = 0; i < count; ++i) {
    const HufEntry& e = t.cells[bb.peek(t.log)];
    out[i] = e.sym;
    bb.left -= e.bits;
    need(bb.left >= 0);
  }
  need(bb.done());
}

// -- the frame decoder ----------------------------------------------------------

struct State {
  HufTable huf;
  FseTable ll, ml, of;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

// Reads one sequence table's mode and description; returns bytes used.
int64_t seq_table(int mode, const uint8_t* src, int64_t n, FseTable& t,
                  const FseTable& pre, int max_sym, int max_log) {
  if (mode == 0) {
    t = pre;
    return 0;
  }
  if (mode == 1) {
    need(n >= 1 && src[0] <= max_sym);
    t.log = 0;
    t.cells.assign(1, FseEntry{src[0], 0, 0});
    t.ready = true;
    return 1;
  }
  if (mode == 2) {
    int16_t norm[64];
    int nsym = 0, log = 0;
    int64_t used = read_fse_description(src, n, max_sym, max_log, norm,
                                        &nsym, &log);
    build_fse(t, norm, nsym, log);
    return used;
  }
  need(t.ready);  // repeat: the previous block's table
  return 0;
}

void compressed_block(State& st, const uint8_t* src, int64_t n, uint8_t* dst,
                      int64_t cap, int64_t frame_start, int64_t* op_io) {
  int64_t op = *op_io;
  // literals section
  need(n >= 1);
  int ltype = src[0] & 3, sfmt = (src[0] >> 2) & 3;
  int64_t regen = 0, csize = 0, hsize = 0;
  int streams = 1;
  if (ltype < 2) {
    if ((sfmt & 1) == 0) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (sfmt == 1) {
      hsize = 2;
      need(n >= 2);
      regen = (src[0] >> 4) + (static_cast<int64_t>(src[1]) << 4);
    } else {
      hsize = 3;
      need(n >= 3);
      regen = (src[0] >> 4) + (static_cast<int64_t>(src[1]) << 4) +
              (static_cast<int64_t>(src[2]) << 12);
    }
  } else {
    streams = sfmt == 0 ? 1 : 4;
    if (sfmt < 2) {
      hsize = 3;
      need(n >= 3);
      uint32_t h = src[0] | (src[1] << 8) | (src[2] << 16);
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
    } else if (sfmt == 2) {
      hsize = 4;
      need(n >= 4);
      uint32_t h = rd32(src);
      regen = (h >> 4) & 0x3FFF;
      csize = (h >> 18) & 0x3FFF;
    } else {
      hsize = 5;
      need(n >= 5);
      uint64_t h = rd32(src) | (static_cast<uint64_t>(src[4]) << 32);
      regen = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) & 0x3FFFF;
    }
  }
  need(regen <= kBlockMax);
  st.lits.resize(static_cast<size_t>(regen) + 8);
  uint8_t* lits = st.lits.data();
  int64_t pos = hsize;
  if (ltype == 0) {
    need(pos + regen <= n);
    std::memcpy(lits, src + pos, static_cast<size_t>(regen));
    pos += regen;
  } else if (ltype == 1) {
    need(pos + 1 <= n);
    std::memset(lits, src[pos], static_cast<size_t>(regen));
    pos += 1;
  } else {
    need(pos + csize <= n);
    const uint8_t* lp = src + pos;
    int64_t lsize = csize;
    if (ltype == 2) {
      int64_t used = read_huffman(lp, lsize, st.huf);
      lp += used;
      lsize -= used;
    } else {
      need(st.huf.ready);
    }
    if (streams == 1) {
      huffman_stream(st.huf, lp, lsize, lits, regen);
    } else {
      need(lsize >= 6);
      int64_t s1 = lp[0] | (lp[1] << 8), s2 = lp[2] | (lp[3] << 8),
              s3 = lp[4] | (lp[5] << 8);
      int64_t s4 = lsize - 6 - s1 - s2 - s3;
      need(s4 >= 1);
      int64_t each = (regen + 3) / 4;
      int64_t last = regen - 3 * each;
      need(last >= 0);
      const uint8_t* q = lp + 6;
      huffman_stream(st.huf, q, s1, lits, each);
      huffman_stream(st.huf, q + s1, s2, lits + each, each);
      huffman_stream(st.huf, q + s1 + s2, s3, lits + 2 * each, each);
      huffman_stream(st.huf, q + s1 + s2 + s3, s4, lits + 3 * each, last);
    }
    pos += csize;
  }
  // sequences section
  need(pos < n);
  int64_t nseq = src[pos++];
  if (nseq >= 128) {
    if (nseq < 255) {
      need(pos < n);
      nseq = ((nseq - 128) << 8) + src[pos++];
    } else {
      need(pos + 2 <= n);
      nseq = src[pos] + (static_cast<int64_t>(src[pos + 1]) << 8) + 0x7F00;
      pos += 2;
    }
  }
  int64_t lit_at = 0;
  if (nseq > 0) {
    need(pos < n);
    uint8_t modes = src[pos++];
    need((modes & 3) == 0);
    const Predefined& pre = predefined();
    pos += seq_table(modes >> 6, src + pos, n - pos, st.ll, pre.ll, 35, 9);
    pos += seq_table((modes >> 4) & 3, src + pos, n - pos, st.of, pre.of, 31,
                     8);
    pos += seq_table((modes >> 2) & 3, src + pos, n - pos, st.ml, pre.ml, 52,
                     9);
    need(pos < n);
    BackBits bb(src + pos, n - pos);
    uint32_t sll = static_cast<uint32_t>(bb.read(st.ll.log));
    uint32_t sof = static_cast<uint32_t>(bb.read(st.of.log));
    uint32_t sml = static_cast<uint32_t>(bb.read(st.ml.log));
    for (int64_t i = 0; i < nseq; ++i) {
      const FseEntry& el = st.ll.cells[sll];
      const FseEntry& eo = st.of.cells[sof];
      const FseEntry& em = st.ml.cells[sml];
      uint32_t ofcode = eo.sym;
      need(ofcode <= 31 && em.sym <= 52 && el.sym <= 35);
      uint64_t ov = (1ULL << ofcode) + bb.read(ofcode);
      uint64_t ml = kMLBase[em.sym] + bb.read(kMLBits[em.sym]);
      uint64_t ll = kLLBase[el.sym] + bb.read(kLLBits[el.sym]);
      need(!bb.overflow());
      uint64_t offset;
      if (ov > 3) {
        offset = ov - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = static_cast<uint32_t>(offset);
      } else {
        uint32_t idx = static_cast<uint32_t>(ov - 1) + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = st.rep[0];
        } else {
          offset = idx == 3 ? st.rep[0] - 1 : st.rep[idx];
          if (idx != 1) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = static_cast<uint32_t>(offset);
        }
      }
      if (i + 1 < nseq) {
        sll = el.base + static_cast<uint32_t>(bb.read(el.bits));
        sml = em.base + static_cast<uint32_t>(bb.read(em.bits));
        sof = eo.base + static_cast<uint32_t>(bb.read(eo.bits));
        need(!bb.overflow());
      }
      // execute: literals, then the match
      need(static_cast<int64_t>(ll) <= regen - lit_at);
      need(static_cast<int64_t>(ll + ml) <= cap - op, kTooSmall);
      std::memcpy(dst + op, lits + lit_at, static_cast<size_t>(ll));
      lit_at += static_cast<int64_t>(ll);
      op += static_cast<int64_t>(ll);
      need(offset > 0 && static_cast<int64_t>(offset) <= op - frame_start);
      const uint8_t* m = dst + op - offset;
      if (offset >= ml) {
        std::memcpy(dst + op, m, static_cast<size_t>(ml));
      } else if (offset >= 8) {
        // overlapping: 8-byte steps read only bytes already written
        uint8_t* d = dst + op;
        uint64_t k = 0;
        for (; k + 8 <= ml; k += 8) std::memcpy(d + k, m + k, 8);
        for (; k < ml; ++k) d[k] = m[k];
      } else {
        for (uint64_t k = 0; k < ml; ++k) dst[op + k] = m[k];
      }
      op += static_cast<int64_t>(ml);
    }
    need(bb.done());
  } else {
    need(pos == n);
  }
  int64_t rest = regen - lit_at;
  need(rest <= cap - op, kTooSmall);
  std::memcpy(dst + op, lits + lit_at, static_cast<size_t>(rest));
  op += rest;
  *op_io = op;
}

struct FrameHeader {
  int64_t size;       // header bytes
  int64_t content;    // -1 when not stated
  bool checksum;
};

FrameHeader frame_header(const uint8_t* src, int64_t n) {
  need(n >= 5);
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  need(((fhd >> 3) & 1) == 0);
  int did_flag = fhd & 3;
  int64_t pos = 5;
  if (!single) {
    need(pos < n);
    uint8_t wd = src[pos++];
    need((wd >> 3) + 10 <= 41);
  }
  static const int kDid[4] = {0, 1, 2, 4};
  need(pos + kDid[did_flag] <= n);
  uint32_t did = 0;
  for (int i = 0; i < kDid[did_flag]; ++i) did |= src[pos + i] << (8 * i);
  pos += kDid[did_flag];
  need(did == 0, kUnsupported);
  int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  need(pos + fcs_bytes <= n);
  int64_t content = -1;
  if (fcs_bytes) {
    uint64_t v = 0;
    for (int i = 0; i < fcs_bytes; ++i)
      v |= static_cast<uint64_t>(src[pos + i]) << (8 * i);
    if (fcs_bytes == 2) v += 256;
    need(v < (1ULL << 62));
    content = static_cast<int64_t>(v);
  }
  pos += fcs_bytes;
  return FrameHeader{pos, content, static_cast<bool>((fhd >> 2) & 1)};
}

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

int64_t decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t ip = 0, op = 0;
  need(n > 0);
  while (ip < n) {
    need(n - ip >= 4);
    uint32_t magic = rd32(src + ip);
    if (skippable(magic)) {
      need(n - ip >= 8);
      int64_t len = rd32(src + ip + 4);
      need(len <= n - ip - 8);
      ip += 8 + len;
      continue;
    }
    need(magic == kMagic);
    FrameHeader fh = frame_header(src + ip, n - ip);
    ip += fh.size;
    int64_t frame_start = op;
    State st;
    for (;;) {
      need(n - ip >= 3);
      uint32_t bh = src[ip] | (src[ip + 1] << 8) | (src[ip + 2] << 16);
      ip += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      int64_t size = bh >> 3;
      if (type == 0) {
        need(size <= n - ip);
        need(size <= cap - op, kTooSmall);
        std::memcpy(dst + op, src + ip, static_cast<size_t>(size));
        op += size;
        ip += size;
      } else if (type == 1) {
        need(ip < n);
        need(size <= cap - op, kTooSmall);
        std::memset(dst + op, src[ip], static_cast<size_t>(size));
        op += size;
        ip += 1;
      } else if (type == 2) {
        need(size <= n - ip && size <= kBlockMax);
        compressed_block(st, src + ip, size, dst, cap, frame_start, &op);
        ip += size;
      } else {
        throw Fail{kCorrupt};
      }
      if (last) break;
    }
    if (fh.content >= 0) need(op - frame_start == fh.content);
    if (fh.checksum) {
      need(n - ip >= 4);
      uint32_t want = rd32(src + ip);
      uint32_t got = static_cast<uint32_t>(
          xxh64(dst + frame_start, op - frame_start, 0));
      need(want == got);
      ip += 4;
    }
  }
  return op;
}

// -- the encoder ----------------------------------------------------------------

// Forward bit writer (the encoder's side of a backward stream).
struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;
  uint64_t acc = 0;
  int nacc = 0;
  BitWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}
  inline void add(uint64_t v, int n) {
    if (n == 0) return;
    acc |= (v & ((n == 64) ? ~0ULL : ((1ULL << n) - 1))) << nacc;
    nacc += n;
    while (nacc >= 8) {
      need(pos < cap);
      out[pos++] = static_cast<uint8_t>(acc);
      acc >>= 8;
      nacc -= 8;
    }
  }
  int64_t close() {
    add(1, 1);
    if (nacc > 0) {
      need(pos < cap);
      out[pos++] = static_cast<uint8_t>(acc);
      acc = 0;
      nacc = 0;
    }
    return pos;
  }
};

// The encoding map of one predefined table: for symbol s and the next
// decoder state x, the state u that emits s and reaches x.
struct FseEncoder {
  const FseTable* t;
  int nsym;
  std::vector<uint16_t> map;  // [s * size + x]
  std::vector<uint16_t> first;
  FseEncoder(const FseTable& tab, int ns) : t(&tab), nsym(ns) {
    uint32_t size = 1u << tab.log;
    map.assign(static_cast<size_t>(ns) * size, 0);
    first.assign(ns, 0xFFFF);
    for (uint32_t u = 0; u < size; ++u) {
      const FseEntry& e = tab.cells[u];
      if (first[e.sym] == 0xFFFF) first[e.sym] = static_cast<uint16_t>(u);
      for (uint32_t x = e.base; x < e.base + (1u << e.bits); ++x)
        map[e.sym * size + x] = static_cast<uint16_t>(u);
    }
  }
};

struct Encoders {
  FseEncoder ll, ml, of;
  uint8_t llcode[64];
  uint8_t mlcode[128];
  Encoders()
      : ll(predefined().ll, 36), ml(predefined().ml, 53),
        of(predefined().of, 29) {
    for (int v = 0; v < 64; ++v) {
      int c = 0;
      while (c + 1 < 36 && kLLBase[c + 1] <= static_cast<uint32_t>(v)) ++c;
      llcode[v] = static_cast<uint8_t>(c);
    }
    for (int v = 0; v < 128; ++v) {
      int c = 0;
      while (c + 1 < 53 && kMLBase[c + 1] <= static_cast<uint32_t>(v + 3)) ++c;
      mlcode[v] = static_cast<uint8_t>(c);
    }
  }
};

const Encoders& encoders() {
  static const Encoders e;
  return e;
}

struct Seq {
  uint32_t ll, ml, off;
};

inline int ll_code(uint32_t ll, const Encoders& E) {
  return ll < 64 ? E.llcode[ll] : highbit(ll) + 19;
}

inline int ml_code(uint32_t ml, const Encoders& E) {
  uint32_t b = ml - 3;
  return b < 128 ? E.mlcode[b] : highbit(b) + 36;
}

// The header of a Raw (type 0) or RLE (type 1) literals section.
int64_t literals_header(uint8_t* out, int64_t size, int type) {
  if (size < 32) {
    out[0] = static_cast<uint8_t>((size << 3) | type);
    return 1;
  }
  if (size < 4096) {
    out[0] = static_cast<uint8_t>(((size & 15) << 4) | 4 | type);
    out[1] = static_cast<uint8_t>(size >> 4);
    return 2;
  }
  out[0] = static_cast<uint8_t>(((size & 15) << 4) | 12 | type);
  out[1] = static_cast<uint8_t>((size >> 4) & 0xFF);
  out[2] = static_cast<uint8_t>(size >> 12);
  return 3;
}

constexpr int kHufMaxBits = 11;

// Huffman code lengths of the byte counts `freq`, at most kHufMaxBits
// long: a Huffman tree, its counts halved (none below 1) until it is
// shallow enough. Returns the longest length (0 when under 2 symbols).
int huffman_lengths(const uint32_t* freq, uint8_t* len) {
  std::vector<uint64_t> f(freq, freq + 256);
  for (;;) {
    // nodes: 0-255 leaves, then internal ones
    std::vector<uint64_t> w;
    std::vector<int> parent;
    std::vector<std::pair<uint64_t, int>> heap;
    for (int s = 0; s < 256; ++s) {
      w.push_back(f[s]);
      parent.push_back(-1);
      if (f[s]) heap.push_back({f[s], s});
    }
    if (heap.size() < 2) return 0;
    auto cmp = [](const std::pair<uint64_t, int>& a,
                  const std::pair<uint64_t, int>& b) { return a > b; };
    std::make_heap(heap.begin(), heap.end(), cmp);
    while (heap.size() > 1) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      auto a = heap.back();
      heap.pop_back();
      std::pop_heap(heap.begin(), heap.end(), cmp);
      auto b = heap.back();
      heap.pop_back();
      int node = static_cast<int>(w.size());
      w.push_back(a.first + b.first);
      parent.push_back(-1);
      parent[a.second] = node;
      parent[b.second] = node;
      heap.push_back({a.first + b.first, node});
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
    int maxlen = 0;
    for (int s = 0; s < 256; ++s) {
      int d = 0;
      if (f[s])
        for (int x = s; parent[x] >= 0; x = parent[x]) ++d;
      len[s] = static_cast<uint8_t>(d);
      if (d > maxlen) maxlen = d;
    }
    if (maxlen <= kHufMaxBits) return maxlen;
    for (int s = 0; s < 256; ++s)
      if (f[s]) f[s] = (f[s] >> 1) | 1;
  }
}

// A Huffman-coded literals section (type 2, direct weights), or -1 when
// one does not fit the form (a symbol past 128 in the weights, fewer than
// two symbols) or does not shrink the literals.
int64_t huffman_literals(const uint8_t* lits, int64_t n, uint8_t* out) {
  if (n < 64) return -1;
  uint32_t freq[256] = {0};
  for (int64_t i = 0; i < n; ++i) freq[lits[i]]++;
  uint8_t len[256];
  int maxbits = huffman_lengths(freq, len);
  if (maxbits == 0) return -1;
  int last = 255;
  while (!len[last]) --last;
  if (last > 128) return -1;
  // weights of symbols 0..last-1 (the last one is implied), 4 bits each
  uint8_t w[256];
  for (int s = 0; s <= last; ++s)
    w[s] = len[s] ? static_cast<uint8_t>(maxbits + 1 - len[s]) : 0;
  // codes as the decoder's table assigns them: weight 1 first, symbols
  // in order within a weight
  uint32_t count[kHufMaxBits + 2] = {0};
  for (int s = 0; s <= last; ++s) count[w[s]]++;
  uint32_t start[kHufMaxBits + 2] = {0};
  uint32_t next = 0;
  for (int k = 1; k <= maxbits; ++k) {
    start[k] = next;
    next += count[k] << (k - 1);
  }
  uint32_t code[256];
  for (int s = 0; s <= last; ++s) {
    if (!w[s]) continue;
    code[s] = start[w[s]] >> (w[s] - 1);
    start[w[s]] += 1u << (w[s] - 1);
  }
  const int streams = n <= 1023 ? 1 : 4;
  const int hsize = streams == 1 ? 3 : (n <= 16383 ? 4 : 5);
  int64_t pos = hsize;
  out[pos++] = static_cast<uint8_t>(127 + last);
  for (int s = 0; s < last; s += 2)
    out[pos++] = static_cast<uint8_t>((w[s] << 4) | (s + 1 < last ? w[s + 1] : 0));
  const int64_t each = (n + 3) / 4;
  int64_t jump = 0;
  if (streams == 4) {
    jump = pos;
    pos += 6;
  }
  for (int k = 0; k < streams; ++k) {
    int64_t lo = streams == 1 ? 0 : k * each;
    int64_t hi = streams == 1 ? n : (k == 3 ? n : lo + each);
    if (pos + (hi - lo) * kHufMaxBits / 8 + 8 >= n) return -1;
    BitWriter bw(out + pos, n - pos);
    for (int64_t i = hi - 1; i >= lo; --i)
      bw.add(code[lits[i]], maxbits + 1 - w[lits[i]]);
    int64_t size = bw.close();
    if (streams == 4 && k < 3) {
      if (size > 65535) return -1;
      out[jump + 2 * k] = static_cast<uint8_t>(size);
      out[jump + 2 * k + 1] = static_cast<uint8_t>(size >> 8);
    }
    pos += size;
  }
  const int64_t csize = pos - hsize;
  if (pos >= n - n / 32) return -1;
  const int sfmt = streams == 1 ? 0 : hsize - 2;
  const uint64_t h = 2 | (sfmt << 2) | (static_cast<uint64_t>(n) << 4) |
                     (static_cast<uint64_t>(csize)
                      << (hsize == 3 ? 14 : hsize == 4 ? 18 : 22));
  for (int i = 0; i < hsize; ++i) out[i] = static_cast<uint8_t>(h >> (8 * i));
  return pos;
}

// The literals section: Huffman-coded where that shrinks it, RLE for one
// repeated byte, else raw. Returns its size.
int64_t literals_section(const uint8_t* lits, int64_t n, uint8_t* out) {
  bool same = n > 1;
  for (int64_t i = 1; same && i < n; ++i) same = lits[i] == lits[0];
  if (same) {
    int64_t pos = literals_header(out, n, 1);
    out[pos] = lits[0];
    return pos + 1;
  }
  int64_t got = huffman_literals(lits, n, out);
  if (got > 0) return got;
  int64_t pos = literals_header(out, n, 0);
  std::memcpy(out + pos, lits, static_cast<size_t>(n));
  return pos + n;
}

// One compressed block body from its literals and sequences; returns its
// size, or -1 when it would not be smaller than `limit`.
int64_t encode_block(const uint8_t* lits, int64_t nlits,
                     const std::vector<Seq>& seqs, uint8_t* out,
                     int64_t limit) {
  const Encoders& E = encoders();
  int64_t need_bytes = 3 + nlits + 4 + static_cast<int64_t>(seqs.size()) * 12 + 16;
  std::vector<uint8_t> buf(static_cast<size_t>(need_bytes));
  uint8_t* p = buf.data();
  int64_t pos = literals_section(lits, nlits, p);
  int64_t nseq = static_cast<int64_t>(seqs.size());
  if (nseq < 128) {
    p[pos++] = static_cast<uint8_t>(nseq);
  } else if (nseq < 0x7F00) {
    p[pos++] = static_cast<uint8_t>((nseq >> 8) + 128);
    p[pos++] = static_cast<uint8_t>(nseq & 0xFF);
  } else {
    p[pos++] = 255;
    p[pos++] = static_cast<uint8_t>((nseq - 0x7F00) & 0xFF);
    p[pos++] = static_cast<uint8_t>((nseq - 0x7F00) >> 8);
  }
  if (nseq > 0) {
    p[pos++] = 0;  // every table predefined
    BitWriter bw(p + pos, need_bytes - pos);
    const uint32_t lsize = 1u << E.ll.t->log, msize = 1u << E.ml.t->log,
                   osize = 1u << E.of.t->log;
    uint32_t sll = 0, sml = 0, sof = 0;
    for (int64_t i = nseq - 1; i >= 0; --i) {
      const Seq& s = seqs[static_cast<size_t>(i)];
      int lc = ll_code(s.ll, E), mc = ml_code(s.ml, E);
      uint32_t ov = s.off + 3;
      int oc = highbit(ov);
      if (i == nseq - 1) {
        sll = E.ll.first[lc];
        sml = E.ml.first[mc];
        sof = E.of.first[oc];
      } else {
        uint32_t u;
        u = E.of.map[oc * osize + sof];
        bw.add(sof - E.of.t->cells[u].base, E.of.t->cells[u].bits);
        sof = u;
        u = E.ml.map[mc * msize + sml];
        bw.add(sml - E.ml.t->cells[u].base, E.ml.t->cells[u].bits);
        sml = u;
        u = E.ll.map[lc * lsize + sll];
        bw.add(sll - E.ll.t->cells[u].base, E.ll.t->cells[u].bits);
        sll = u;
      }
      bw.add(s.ll - kLLBase[lc], kLLBits[lc]);
      bw.add(s.ml - kMLBase[mc], kMLBits[mc]);
      bw.add(ov - (1u << oc), oc);
    }
    bw.add(sml, E.ml.t->log);
    bw.add(sof, E.of.t->log);
    bw.add(sll, E.ll.t->log);
    pos += bw.close();
  }
  if (pos >= limit) return -1;
  std::memcpy(out, p, static_cast<size_t>(pos));
  return pos;
}

constexpr int kHashLog = 17;
constexpr int64_t kWindow = 1 << 23;  // the window of a multi-segment frame
constexpr int64_t kSingleSegmentMax = 1 << 23;

inline uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> (32 - kHashLog); }

int64_t compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                 bool checksum) {
  int64_t op = 0;
  // frame header
  bool single = n <= kSingleSegmentMax;
  int fcs_flag;
  if (single && n < 256) {
    fcs_flag = 0;
  } else if (n < 65536 + 256) {
    fcs_flag = 1;
  } else if (n < (1LL << 32)) {
    fcs_flag = 2;
  } else {
    fcs_flag = 3;
  }
  need(cap >= 18);
  uint32_t magic = kMagic;
  std::memcpy(dst, &magic, 4);
  op = 4;
  dst[op++] = static_cast<uint8_t>((fcs_flag << 6) | (single ? 32 : 0) |
                                   (checksum ? 4 : 0));
  if (!single) dst[op++] = static_cast<uint8_t>((23 - 10) << 3);
  int fcs_bytes = fcs_flag == 0 ? 1 : (1 << fcs_flag);
  uint64_t fcs = static_cast<uint64_t>(n) - (fcs_flag == 1 ? 256 : 0);
  for (int i = 0; i < fcs_bytes; ++i)
    dst[op++] = static_cast<uint8_t>(fcs >> (8 * i));
  std::vector<uint32_t> table(1u << kHashLog, 0xFFFFFFFFu);
  std::vector<Seq> seqs;
  std::vector<uint8_t> lits;
  std::vector<uint8_t> block(kBlockMax + 1024);
  int64_t start = 0;
  do {
    int64_t bsize = n - start < kBlockMax ? n - start : kBlockMax;
    int64_t bend = start + bsize;
    bool last = bend == n;
    seqs.clear();
    lits.clear();
    int64_t ip = start, anchor = start;
    const int64_t limit = bend - 8;  // room for the 4-byte reads
    while (ip < limit) {
      uint32_t cur = rd32(src + ip);
      uint32_t h = hash4(cur);
      uint32_t cand = table[h];
      table[h] = static_cast<uint32_t>(ip);
      if (cand == 0xFFFFFFFFu || ip - cand > kWindow - 1 ||
          rd32(src + cand) != cur) {
        ++ip;
        continue;
      }
      int64_t m = cand + 4, c = ip + 4;
      while (c < bend && src[c] == src[m]) {
        ++c;
        ++m;
      }
      // back up over equal bytes before the match
      int64_t back = ip;
      int64_t cb = cand;
      while (back > anchor && cb > 0 && src[back - 1] == src[cb - 1]) {
        --back;
        --cb;
      }
      uint32_t ll = static_cast<uint32_t>(back - anchor);
      lits.insert(lits.end(), src + anchor, src + back);
      seqs.push_back(Seq{ll, static_cast<uint32_t>(c - back),
                         static_cast<uint32_t>(back - cb)});
      ip = c;
      anchor = ip;
      if (ip - 2 > start && ip < limit)
        table[hash4(rd32(src + ip - 2))] = static_cast<uint32_t>(ip - 2);
    }
    lits.insert(lits.end(), src + anchor, src + bend);
    int64_t body = -1;
    if (!seqs.empty() || bsize > 0) {
      body = encode_block(lits.data(), static_cast<int64_t>(lits.size()),
                          seqs, block.data(), bsize);
    }
    need(cap - op >= 3 + (body < 0 ? bsize : body));
    uint32_t bh;
    if (body < 0) {
      bh = (static_cast<uint32_t>(bsize) << 3) | (last ? 1 : 0);
      dst[op++] = static_cast<uint8_t>(bh);
      dst[op++] = static_cast<uint8_t>(bh >> 8);
      dst[op++] = static_cast<uint8_t>(bh >> 16);
      std::memcpy(dst + op, src + start, static_cast<size_t>(bsize));
      op += bsize;
    } else {
      bh = (static_cast<uint32_t>(body) << 3) | (2 << 1) | (last ? 1 : 0);
      dst[op++] = static_cast<uint8_t>(bh);
      dst[op++] = static_cast<uint8_t>(bh >> 8);
      dst[op++] = static_cast<uint8_t>(bh >> 16);
      std::memcpy(dst + op, block.data(), static_cast<size_t>(body));
      op += body;
    }
    start = bend;
  } while (start < n);
  if (checksum) {
    need(cap - op >= 4);
    uint32_t h = static_cast<uint32_t>(xxh64(src, n, 0));
    std::memcpy(dst + op, &h, 4);
    op += 4;
  }
  return op;
}

}  // namespace

extern "C" {

int64_t srt_zstd_content_size(const uint8_t* src, int64_t n) {
  try {
    int64_t ip = 0, total = 0;
    bool known = true;
    need(n > 0);
    while (ip < n) {
      need(n - ip >= 4);
      uint32_t magic = rd32(src + ip);
      if (skippable(magic)) {
        need(n - ip >= 8);
        int64_t len = rd32(src + ip + 4);
        need(len <= n - ip - 8);
        ip += 8 + len;
        continue;
      }
      need(magic == kMagic);
      FrameHeader fh = frame_header(src + ip, n - ip);
      if (fh.content < 0) known = false;
      else total += fh.content;
      ip += fh.size;
      // walk the blocks to the next frame
      for (;;) {
        need(n - ip >= 3);
        uint32_t bh = src[ip] | (src[ip + 1] << 8) | (src[ip + 2] << 16);
        ip += 3;
        int type = (bh >> 1) & 3;
        int64_t size = bh >> 3;
        need(type != 3);
        int64_t body = type == 1 ? 1 : size;
        need(body <= n - ip);
        ip += body;
        if (bh & 1) break;
      }
      if (fh.checksum) {
        need(n - ip >= 4);
        ip += 4;
      }
    }
    return known ? total : -1;
  } catch (const Fail& f) {
    return f.code == kCorrupt ? -4 : f.code - 2;
  } catch (...) {
    return -4;
  }
}

int64_t srt_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap) {
  try {
    return decompress(src, n, dst, cap);
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {
    return kCorrupt;
  }
}

int64_t srt_zstd_compress_bound(int64_t n) {
  return n + (n >> 7) + 3 * (n / kBlockMax + 1) + 32;
}

int64_t srt_zstd_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap, int32_t checksum) {
  try {
    return compress(src, n, dst, cap, checksum != 0);
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
