// The LZ4 block codec (compress and bounds-checked decompress) of the
// port's file codecs: ORC's LZ4 chunks, Parquet's LZ4_RAW pages and the
// blocks inside Parquet's legacy (Hadoop-framed) LZ4 pages. A copy of the
// repository's shuffle codec (`native/lz4codec.cpp`), written from the
// public block-format spec: token (literal length << 4 | match length - 4),
// 255-extension lengths, 2-byte little-endian offsets, minimum match 4, the
// last 5 bytes always literals, no match starting within the final 12
// bytes.
//
// C ABI (ctypes):
//   int64 srt_lz4_compress_bound(int64 n)
//   int64 srt_lz4_compress(src, n, dst, dst_cap)    -> compressed size or -1
//   int64 srt_lz4_decompress(src, n, dst, dst_cap)  -> decompressed size or -1

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMinMatch = 4;
constexpr int kLastLiterals = 5;   // spec: last 5 bytes are always literals
constexpr int kMfLimit = 12;       // spec: no match within last 12 bytes
constexpr int kHashLog = 16;
constexpr uint32_t kHashSize = 1u << kHashLog;
constexpr uint32_t kMaxOffset = 65535;

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - kHashLog);
}

}  // namespace

extern "C" {

int64_t srt_lz4_compress_bound(int64_t n) {
  // worst case: incompressible data expands by 1 byte per 255 + token/lens
  return n + n / 255 + 16;
}

int64_t srt_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                     int64_t dst_cap) {
  // positions are stored as uint32 in the hash table; larger inputs would
  // wrap and could emit offsets into the wrong window — refuse them
  if (n < 0 || n >= (1ll << 32) || dst_cap < srt_lz4_compress_bound(n)) return -1;
  uint8_t* op = dst;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  const uint8_t* anchor = src;

  if (n >= kMfLimit) {
    const uint8_t* const mflimit = iend - kMfLimit;
    uint32_t table[kHashSize];
    std::memset(table, 0xff, sizeof(table));  // 0xffffffff = empty

    while (ip < mflimit) {
      // find a match via single-entry hash table
      uint32_t h = hash4(read32(ip));
      uint32_t cand = table[h];
      table[h] = static_cast<uint32_t>(ip - src);
      const uint8_t* match = src + cand;
      if (cand == 0xffffffffu || ip - match > kMaxOffset ||
          read32(match) != read32(ip)) {
        ++ip;
        continue;
      }
      // extend the match forward (stay clear of the final literals region)
      const uint8_t* const matchlimit = iend - kLastLiterals;
      const uint8_t* mp = match + kMinMatch;
      const uint8_t* cp = ip + kMinMatch;
      while (cp < matchlimit && *cp == *mp) {
        ++cp;
        ++mp;
      }
      int64_t match_len = cp - ip;
      int64_t lit_len = ip - anchor;

      // token + literal length
      uint8_t* token = op++;
      if (lit_len >= 15) {
        *token = 15 << 4;
        int64_t rem = lit_len - 15;
        while (rem >= 255) {
          *op++ = 255;
          rem -= 255;
        }
        *op++ = static_cast<uint8_t>(rem);
      } else {
        *token = static_cast<uint8_t>(lit_len << 4);
      }
      std::memcpy(op, anchor, static_cast<size_t>(lit_len));
      op += lit_len;

      // offset
      uint32_t offset = static_cast<uint32_t>(ip - match);
      *op++ = static_cast<uint8_t>(offset & 0xff);
      *op++ = static_cast<uint8_t>(offset >> 8);

      // match length (stored as len - 4)
      int64_t ml = match_len - kMinMatch;
      if (ml >= 15) {
        *token |= 15;
        ml -= 15;
        while (ml >= 255) {
          *op++ = 255;
          ml -= 255;
        }
        *op++ = static_cast<uint8_t>(ml);
      } else {
        *token |= static_cast<uint8_t>(ml);
      }

      ip += match_len;
      anchor = ip;
      if (ip < mflimit) {
        // re-prime the table at ip-2 to catch overlapping sequences
        table[hash4(read32(ip - 2))] = static_cast<uint32_t>(ip - 2 - src);
      }
    }
  }

  // trailing literals
  int64_t lit_len = iend - anchor;
  uint8_t* token = op++;
  if (lit_len >= 15) {
    *token = 15 << 4;
    int64_t rem = lit_len - 15;
    while (rem >= 255) {
      *op++ = 255;
      rem -= 255;
    }
    *op++ = static_cast<uint8_t>(rem);
  } else {
    *token = static_cast<uint8_t>(lit_len << 4);
  }
  std::memcpy(op, anchor, static_cast<size_t>(lit_len));
  op += lit_len;
  return op - dst;
}

int64_t srt_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  if (n == 0) return dst_cap == 0 ? 0 : -1;

  for (;;) {
    if (ip >= iend) return -1;
    uint32_t token = *ip++;

    // literals
    int64_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit_len += b;
      } while (b == 255);
    }
    if (lit_len > iend - ip || lit_len > oend - op) return -1;
    std::memcpy(op, ip, static_cast<size_t>(lit_len));
    ip += lit_len;
    op += lit_len;
    if (ip == iend) break;  // last sequence is literals-only

    // offset
    if (iend - ip < 2) return -1;
    uint32_t offset = ip[0] | (static_cast<uint32_t>(ip[1]) << 8);
    ip += 2;
    if (offset == 0 || offset > op - dst) return -1;

    // match length
    int64_t match_len = (token & 15) + kMinMatch;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        match_len += b;
      } while (b == 255);
    }
    if (match_len > oend - op) return -1;
    const uint8_t* match = op - offset;
    if (offset >= static_cast<uint32_t>(match_len)) {
      std::memcpy(op, match, static_cast<size_t>(match_len));
      op += match_len;
    } else {
      // overlapping copy must run byte-by-byte (RLE-style back-reference)
      for (int64_t i = 0; i < match_len; ++i) op[i] = match[i];
      op += match_len;
    }
  }
  return op - dst;
}

}  // extern "C"
