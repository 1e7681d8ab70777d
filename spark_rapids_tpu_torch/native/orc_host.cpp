// ORC's run-length streams, decode and encode (io/orc_format.py): byte RLE
// (booleans are its bits), integer RLE v1 and v2 (SHORT_REPEAT, DIRECT,
// PATCHED_BASE, DELTA; signed by zigzag or unsigned; 1-64 bit widths) and
// the unbounded zigzag base-128 varints of DECIMAL (up to 128 bits). Every
// read is bounds-checked: a corrupt or truncated stream returns -1.
//
// C ABI (ctypes):
//   int64 srt_orc_byte_rle_decode(src, n, count, out_u8)        -> bytes used
//   int64 srt_orc_int_rle_decode(src, n, count, version, signed, out_i64)
//   int64 srt_orc_varint128_decode(src, n, count, lo_u64, hi_i64)
//   int64 srt_orc_byte_rle_encode(vals_u8, count, out, cap)     -> bytes
//   int64 srt_orc_int_rle_encode(vals_i64, count, signed, out, cap)
//   int64 srt_orc_varint128_encode(lo_u64, hi_i64, count, out, cap)

#include <cstdint>
#include <cstring>

namespace {

struct Fail {};

inline void need(bool ok) {
  if (!ok) throw Fail{};
}

struct In {
  const uint8_t* p;
  int64_t n;
  int64_t pos = 0;
  In(const uint8_t* src, int64_t len) : p(src), n(len) {}
  inline uint8_t byte() {
    need(pos < n);
    return p[pos++];
  }
  uint64_t uvarint() {
    uint64_t v = 0;
    for (int shift = 0;; shift += 7) {
      need(shift < 64);
      uint8_t b = byte();
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
    }
  }
  int64_t svarint() {
    uint64_t u = uvarint();
    return static_cast<int64_t>((u >> 1) ^ (~(u & 1) + 1));
  }
  uint64_t be(int bytes) {
    uint64_t v = 0;
    for (int i = 0; i < bytes; ++i) v = (v << 8) | byte();
    return v;
  }
};

// Big-endian bit-packed values of `width` bits (1-64), a run's worth,
// starting on a byte boundary and ending padded to one.
void unpack(In& in, int64_t count, int width, uint64_t* out) {
  int64_t bits = count * width;
  need((bits + 7) / 8 <= in.n - in.pos);
  const uint8_t* p = in.p + in.pos;
  int64_t bitpos = 0;
  for (int64_t i = 0; i < count; ++i) {
    uint64_t v = 0;
    int left = width;
    while (left > 0) {
      int64_t byte = bitpos >> 3;
      int off = static_cast<int>(bitpos & 7);
      int avail = 8 - off;
      int take = left < avail ? left : avail;
      uint64_t chunk = (p[byte] >> (avail - take)) & ((1u << take) - 1);
      v = (take == 64 ? 0 : (v << take)) | chunk;
      left -= take;
      bitpos += take;
    }
    out[i] = v;
  }
  in.pos += (bits + 7) / 8;
}

inline int64_t unzigzag(uint64_t u) {
  return static_cast<int64_t>((u >> 1) ^ (~(u & 1) + 1));
}

inline uint64_t zigzag(int64_t v) {
  return (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
}

int decode_width(int code) {
  static const int kWide[8] = {26, 28, 30, 32, 40, 48, 56, 64};
  return code < 24 ? code + 1 : kWide[code - 24];
}

int closest_fixed_bits(int n) {
  if (n == 0) return 1;
  if (n <= 24) return n;
  if (n <= 26) return 26;
  if (n <= 28) return 28;
  if (n <= 30) return 30;
  if (n <= 32) return 32;
  if (n <= 40) return 40;
  if (n <= 48) return 48;
  if (n <= 56) return 56;
  return 64;
}

int encode_width(int w) {
  if (w <= 24) return w - 1;
  switch (w) {
    case 26: return 24;
    case 28: return 25;
    case 30: return 26;
    case 32: return 27;
    case 40: return 28;
    case 48: return 29;
    case 56: return 30;
    default: return 31;
  }
}

void int_rle_v1(In& in, int64_t count, bool sign, int64_t* out) {
  int64_t got = 0;
  while (got < count) {
    uint8_t c = in.byte();
    if (c < 128) {
      int64_t run = c + 3;
      need(run <= count - got);
      int64_t delta = static_cast<int8_t>(in.byte());
      uint64_t base = sign ? static_cast<uint64_t>(in.svarint()) : in.uvarint();
      for (int64_t i = 0; i < run; ++i)
        out[got++] = static_cast<int64_t>(base + static_cast<uint64_t>(i * delta));
    } else {
      int64_t lit = 256 - c;
      need(lit <= count - got);
      for (int64_t i = 0; i < lit; ++i)
        out[got++] = sign ? in.svarint() : static_cast<int64_t>(in.uvarint());
    }
  }
}

void int_rle_v2(In& in, int64_t count, bool sign, int64_t* out) {
  int64_t got = 0;
  uint64_t* u = reinterpret_cast<uint64_t*>(out);
  while (got < count) {
    uint8_t first = in.byte();
    int kind = first >> 6;
    if (kind == 0) {  // SHORT_REPEAT
      int width = ((first >> 3) & 7) + 1;
      int64_t run = (first & 7) + 3;
      need(run <= count - got);
      uint64_t v = in.be(width);
      int64_t val = sign ? unzigzag(v) : static_cast<int64_t>(v);
      for (int64_t i = 0; i < run; ++i) out[got++] = val;
    } else if (kind == 1) {  // DIRECT
      int width = decode_width((first >> 1) & 0x1F);
      int64_t len = ((static_cast<int64_t>(first & 1) << 8) | in.byte()) + 1;
      need(len <= count - got);
      unpack(in, len, width, u + got);
      if (sign)
        for (int64_t i = 0; i < len; ++i) out[got + i] = unzigzag(u[got + i]);
      got += len;
    } else if (kind == 2) {  // PATCHED_BASE
      int width = decode_width((first >> 1) & 0x1F);
      int64_t len = ((static_cast<int64_t>(first & 1) << 8) | in.byte()) + 1;
      need(len <= count - got);
      uint8_t third = in.byte();
      int bw = ((third >> 5) & 7) + 1;
      int pw = decode_width(third & 0x1F);
      uint8_t fourth = in.byte();
      int pgw = ((fourth >> 5) & 7) + 1;
      int pll = fourth & 0x1F;
      uint64_t raw = in.be(bw);
      uint64_t mask = 1ULL << (bw * 8 - 1);
      int64_t base = static_cast<int64_t>(raw & ~mask);
      if (raw & mask) base = -base;
      unpack(in, len, width, u + got);
      need(pw + pgw <= 64);
      uint64_t patches[32];
      unpack(in, pll, closest_fixed_bits(pw + pgw), patches);
      uint64_t pmask = pw == 64 ? ~0ULL : ((1ULL << pw) - 1);
      int64_t at = 0;
      for (int k = 0; k < pll; ++k) {
        uint64_t gap = pw == 64 ? 0 : (patches[k] >> pw);
        uint64_t patch = patches[k] & pmask;
        at += static_cast<int64_t>(gap);
        if (gap == 255 && patch == 0) continue;  // a gap with no patch
        need(at < len);
        u[got + at] |= width >= 64 ? 0 : (patch << width);
      }
      for (int64_t i = 0; i < len; ++i)
        out[got + i] = static_cast<int64_t>(static_cast<uint64_t>(base) + u[got + i]);
      got += len;
    } else {  // DELTA
      int code = (first >> 1) & 0x1F;
      int width = code ? decode_width(code) : 0;
      int64_t len = ((static_cast<int64_t>(first & 1) << 8) | in.byte()) + 1;
      need(len <= count - got);
      uint64_t v0 = sign ? static_cast<uint64_t>(in.svarint()) : in.uvarint();
      int64_t dbase = in.svarint();
      out[got] = static_cast<int64_t>(v0);
      if (width == 0) {
        for (int64_t i = 1; i < len; ++i)
          out[got + i] = static_cast<int64_t>(static_cast<uint64_t>(out[got + i - 1]) +
                                              static_cast<uint64_t>(dbase));
      } else {
        need(len >= 2);
        out[got + 1] = static_cast<int64_t>(v0 + static_cast<uint64_t>(dbase));
        unpack(in, len - 2, width, u + got + 2);
        for (int64_t i = 2; i < len; ++i) {
          uint64_t prev = static_cast<uint64_t>(out[got + i - 1]);
          out[got + i] = static_cast<int64_t>(dbase < 0 ? prev - u[got + i] : prev + u[got + i]);
        }
      }
      got += len;
    }
  }
}

// -- encoders -------------------------------------------------------------------

struct Out {
  uint8_t* p;
  int64_t cap;
  int64_t pos = 0;
  Out(uint8_t* o, int64_t c) : p(o), cap(c) {}
  inline void byte(uint8_t b) {
    need(pos < cap);
    p[pos++] = b;
  }
  void uvarint(uint64_t v) {
    while (v >= 0x80) {
      byte(static_cast<uint8_t>(v | 0x80));
      v >>= 7;
    }
    byte(static_cast<uint8_t>(v));
  }
};

inline int bit_len(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }

void pack(Out& o, const uint64_t* vals, int64_t count, int width) {
  uint64_t acc = 0;
  int nacc = 0;
  for (int64_t i = 0; i < count; ++i) {
    int left = width;
    uint64_t v = vals[i];
    while (left > 0) {
      int take = left < 8 - nacc ? left : 8 - nacc;
      uint64_t chunk = (v >> (left - take)) & ((1u << take) - 1);
      acc = (acc << take) | chunk;
      nacc += take;
      left -= take;
      if (nacc == 8) {
        o.byte(static_cast<uint8_t>(acc));
        acc = 0;
        nacc = 0;
      }
    }
  }
  if (nacc) o.byte(static_cast<uint8_t>(acc << (8 - nacc)));
}

void encode_v2(const int64_t* v, int64_t n, bool sign, Out& o) {
  uint64_t lits[512];
  int64_t i = 0;
  while (i < n) {
    // a run of equal values
    int64_t r = 1;
    while (i + r < n && v[i + r] == v[i] && r < 512) ++r;
    if (r >= 3) {
      uint64_t z = sign ? zigzag(v[i]) : static_cast<uint64_t>(v[i]);
      if (r <= 10) {
        int w = (bit_len(z) + 7) / 8;
        if (w == 0) w = 1;
        o.byte(static_cast<uint8_t>(((w - 1) << 3) | (r - 3)));
        for (int k = w - 1; k >= 0; --k) o.byte(static_cast<uint8_t>(z >> (8 * k)));
      } else {
        o.byte(static_cast<uint8_t>((3 << 6) | ((r - 1) >> 8)));
        o.byte(static_cast<uint8_t>((r - 1) & 0xFF));
        o.uvarint(z);
        o.uvarint(0);  // delta base 0: a run
      }
      i += r;
      continue;
    }
    // a fixed-delta run of 8 or more
    if (i + 1 < n) {
      __int128 d = static_cast<__int128>(v[i + 1]) - v[i];
      if (d >= INT64_MIN && d <= INT64_MAX && d != 0) {
        int64_t k = 2;
        while (i + k < n && k < 512 &&
               static_cast<__int128>(v[i + k]) - v[i + k - 1] == d)
          ++k;
        if (k >= 8) {
          o.byte(static_cast<uint8_t>((3 << 6) | ((k - 1) >> 8)));
          o.byte(static_cast<uint8_t>((k - 1) & 0xFF));
          o.uvarint(sign ? zigzag(v[i]) : static_cast<uint64_t>(v[i]));
          o.uvarint(zigzag(static_cast<int64_t>(d)));
          i += k;
          continue;
        }
      }
    }
    // literals, up to where a run of 3 equal values starts
    int64_t k = 0;
    int maxbits = 0;
    while (i + k < n && k < 512) {
      if (k > 0 && i + k + 2 < n && v[i + k] == v[i + k + 1] &&
          v[i + k] == v[i + k + 2])
        break;
      uint64_t z = sign ? zigzag(v[i + k]) : static_cast<uint64_t>(v[i + k]);
      lits[k++] = z;
      int b = bit_len(z);
      if (b > maxbits) maxbits = b;
    }
    int width = closest_fixed_bits(maxbits);
    o.byte(static_cast<uint8_t>((1 << 6) | (encode_width(width) << 1) | ((k - 1) >> 8)));
    o.byte(static_cast<uint8_t>((k - 1) & 0xFF));
    pack(o, lits, k, width);
    i += k;
  }
}

}  // namespace

extern "C" {

int64_t srt_orc_byte_rle_decode(const uint8_t* src, int64_t n, int64_t count,
                                uint8_t* out) {
  try {
    In in(src, n);
    int64_t got = 0;
    while (got < count) {
      uint8_t c = in.byte();
      if (c < 128) {
        int64_t run = c + 3;
        need(run <= count - got);
        uint8_t b = in.byte();
        std::memset(out + got, b, static_cast<size_t>(run));
        got += run;
      } else {
        int64_t lit = 256 - c;
        need(lit <= count - got && lit <= in.n - in.pos);
        std::memcpy(out + got, in.p + in.pos, static_cast<size_t>(lit));
        in.pos += lit;
        got += lit;
      }
    }
    return in.pos;
  } catch (...) {
    return -1;
  }
}

int64_t srt_orc_int_rle_decode(const uint8_t* src, int64_t n, int64_t count,
                               int32_t version, int32_t sign, int64_t* out) {
  try {
    In in(src, n);
    if (version == 1)
      int_rle_v1(in, count, sign != 0, out);
    else
      int_rle_v2(in, count, sign != 0, out);
    return in.pos;
  } catch (...) {
    return -1;
  }
}

int64_t srt_orc_varint128_decode(const uint8_t* src, int64_t n, int64_t count,
                                 uint64_t* lo, int64_t* hi) {
  try {
    In in(src, n);
    for (int64_t i = 0; i < count; ++i) {
      unsigned __int128 u = 0;
      for (int shift = 0;; shift += 7) {
        need(shift < 133);
        uint8_t b = in.byte();
        u |= static_cast<unsigned __int128>(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
      }
      unsigned __int128 neg = -(u & 1);
      unsigned __int128 s = (u >> 1) ^ neg;
      lo[i] = static_cast<uint64_t>(s);
      hi[i] = static_cast<int64_t>(static_cast<uint64_t>(s >> 64));
    }
    return in.pos;
  } catch (...) {
    return -1;
  }
}

int64_t srt_orc_byte_rle_encode(const uint8_t* v, int64_t n, uint8_t* dst,
                                int64_t cap) {
  try {
    Out o(dst, cap);
    int64_t i = 0;
    while (i < n) {
      int64_t r = 1;
      while (i + r < n && v[i + r] == v[i] && r < 130) ++r;
      if (r >= 3) {
        o.byte(static_cast<uint8_t>(r - 3));
        o.byte(v[i]);
        i += r;
        continue;
      }
      int64_t k = 0;
      while (i + k < n && k < 128) {
        if (i + k + 2 < n && v[i + k] == v[i + k + 1] && v[i + k] == v[i + k + 2])
          break;
        ++k;
      }
      if (k == 0) k = 1;
      o.byte(static_cast<uint8_t>(256 - k));
      for (int64_t j = 0; j < k; ++j) o.byte(v[i + j]);
      i += k;
    }
    return o.pos;
  } catch (...) {
    return -1;
  }
}

int64_t srt_orc_int_rle_encode(const int64_t* v, int64_t n, int32_t sign,
                               uint8_t* dst, int64_t cap) {
  try {
    Out o(dst, cap);
    encode_v2(v, n, sign != 0, o);
    return o.pos;
  } catch (...) {
    return -1;
  }
}

int64_t srt_orc_varint128_encode(const uint64_t* lo, const int64_t* hi,
                                 int64_t n, uint8_t* dst, int64_t cap) {
  try {
    Out o(dst, cap);
    for (int64_t i = 0; i < n; ++i) {
      __int128 s = static_cast<__int128>(
          (static_cast<unsigned __int128>(static_cast<uint64_t>(hi[i])) << 64) | lo[i]);
      unsigned __int128 z = (static_cast<unsigned __int128>(s) << 1) ^
                            static_cast<unsigned __int128>(s >> 127);
      while (z >= 0x80) {
        o.byte(static_cast<uint8_t>(static_cast<uint8_t>(z) | 0x80));
        z >>= 7;
      }
      o.byte(static_cast<uint8_t>(z));
    }
    return o.pos;
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
