// Host-side Parquet codecs for spark_rapids_tpu_torch's own Parquet reader
// and writer (io/parquet_format.py): raw Snappy (the block format Parquet
// stores, no framing), the RLE / bit-packed hybrid of levels and
// dictionary indices, PLAIN BYTE_ARRAY values (4-byte little-endian
// lengths) to and from a contiguous buffer with offsets, and the padding
// of variable-length values into fixed-width rows that numpy turns into
// str objects without a Python loop, and the DELTA encodings:
// DELTA_BINARY_PACKED (blocks of miniblocks, little-endian bit-packed
// deltas over a zigzag min delta) and the prefix-and-suffix rebuild of
// DELTA_BYTE_ARRAY.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC, at first use, by
// spark_rapids_tpu_torch/native/__init__.py into the package's _build/.
// Every function returns a negative value on malformed input; none reads
// or writes outside the sizes it is given.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint8_t* put_varint(uint8_t* out, uint64_t v) {
    while (v >= 0x80) {
        *out++ = static_cast<uint8_t>(v | 0x80);
        v >>= 7;
    }
    *out++ = static_cast<uint8_t>(v);
    return out;
}

// varint at src[*pos]; false when it runs past n or past 64 bits
inline bool get_varint(const uint8_t* src, int64_t n, int64_t* pos,
                       uint64_t* v) {
    uint64_t acc = 0;
    int shift = 0;
    while (true) {
        if (*pos >= n || shift > 63) return false;
        const uint8_t b = src[(*pos)++];
        acc |= static_cast<uint64_t>(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    *v = acc;
    return true;
}

uint8_t* emit_literal(uint8_t* out, const uint8_t* lit, int64_t len) {
    const int64_t m = len - 1;
    if (m < 60) {
        *out++ = static_cast<uint8_t>(m << 2);
    } else {
        int nbytes = m < (1 << 8) ? 1 : m < (1 << 16) ? 2
                     : m < (1 << 24) ? 3 : 4;
        *out++ = static_cast<uint8_t>((59 + nbytes) << 2);
        for (int k = 0; k < nbytes; ++k)
            *out++ = static_cast<uint8_t>(m >> (8 * k));
    }
    std::memcpy(out, lit, static_cast<size_t>(len));
    return out + len;
}

// one copy element of 4..64 bytes
uint8_t* emit_copy_upto64(uint8_t* out, int64_t offset, int64_t len) {
    if (len < 12 && offset < 2048) {
        *out++ = static_cast<uint8_t>(1 | ((len - 4) << 2)
                                      | ((offset >> 8) << 5));
        *out++ = static_cast<uint8_t>(offset & 0xFF);
    } else {
        *out++ = static_cast<uint8_t>(2 | ((len - 1) << 2));
        *out++ = static_cast<uint8_t>(offset & 0xFF);
        *out++ = static_cast<uint8_t>(offset >> 8);
    }
    return out;
}

uint8_t* emit_copy(uint8_t* out, int64_t offset, int64_t len) {
    while (len >= 68) {
        out = emit_copy_upto64(out, offset, 64);
        len -= 64;
    }
    if (len > 64) {
        out = emit_copy_upto64(out, offset, 60);
        len -= 60;
    }
    return emit_copy_upto64(out, offset, len);
}

}  // namespace

extern "C" {

// -- Snappy ------------------------------------------------------------------

// The uncompressed length a Snappy block declares, or -1.
int64_t srt_snappy_uncompressed_length(const uint8_t* src, int64_t n) {
    int64_t pos = 0;
    uint64_t v;
    if (!get_varint(src, n, &pos, &v) || v > (1ull << 40)) return -1;
    return static_cast<int64_t>(v);
}

// Decompress a raw Snappy block into dst (cap bytes, at least the
// declared length). Returns the bytes written, or -1.
int64_t srt_snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap) {
    int64_t pos = 0;
    uint64_t want;
    if (!get_varint(src, n, &pos, &want)) return -1;
    if (static_cast<int64_t>(want) > cap) return -1;
    int64_t op = 0;
    while (pos < n) {
        const uint8_t tag = src[pos++];
        const int kind = tag & 3;
        if (kind == 0) {
            int64_t len = tag >> 2;
            if (len >= 60) {
                const int nb = static_cast<int>(len - 59);
                if (pos + nb > n) return -1;
                len = 0;
                for (int k = 0; k < nb; ++k)
                    len |= static_cast<int64_t>(src[pos + k]) << (8 * k);
                pos += nb;
            }
            len += 1;
            if (pos + len > n || op + len > static_cast<int64_t>(want))
                return -1;
            std::memcpy(dst + op, src + pos, static_cast<size_t>(len));
            pos += len;
            op += len;
            continue;
        }
        int64_t len, offset;
        if (kind == 1) {
            if (pos + 1 > n) return -1;
            len = 4 + ((tag >> 2) & 7);
            offset = (static_cast<int64_t>(tag >> 5) << 8) | src[pos];
            pos += 1;
        } else if (kind == 2) {
            if (pos + 2 > n) return -1;
            len = 1 + (tag >> 2);
            offset = src[pos] | (static_cast<int64_t>(src[pos + 1]) << 8);
            pos += 2;
        } else {
            if (pos + 4 > n) return -1;
            len = 1 + (tag >> 2);
            offset = static_cast<int64_t>(load32(src + pos));
            pos += 4;
        }
        if (offset <= 0 || offset > op
            || op + len > static_cast<int64_t>(want))
            return -1;
        uint8_t* d = dst + op;
        const uint8_t* s = d - offset;
        if (offset >= len) {
            std::memcpy(d, s, static_cast<size_t>(len));
        } else {
            for (int64_t k = 0; k < len; ++k) d[k] = s[k];
        }
        op += len;
    }
    return op == static_cast<int64_t>(want) ? op : -1;
}

// Worst-case size of srt_snappy_compress's output for n input bytes.
int64_t srt_snappy_max_compressed_length(int64_t n) {
    return 32 + n + n / 6;
}

// Compress n bytes into one raw Snappy block (greedy matches over a
// 2^14-entry hash of 4-byte windows, offsets under 64 KiB). dst holds
// srt_snappy_max_compressed_length(n) bytes. Returns the bytes written.
int64_t srt_snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
    uint8_t* out = put_varint(dst, static_cast<uint64_t>(n));
    constexpr int kBits = 14;
    std::vector<int64_t> table(1 << kBits, -1);
    int64_t i = 0, lit = 0;
    while (i + 4 <= n) {
        const uint32_t v = load32(src + i);
        const uint32_t h = (v * 0x1E35A7BDu) >> (32 - kBits);
        const int64_t cand = table[h];
        table[h] = i;
        if (cand >= 0 && i - cand <= 65535 && load32(src + cand) == v) {
            int64_t len = 4;
            while (i + len < n && src[cand + len] == src[i + len]) ++len;
            if (i > lit) out = emit_literal(out, src + lit, i - lit);
            out = emit_copy(out, i - cand, len);
            i += len;
            lit = i;
            if (i - 1 + 4 <= n) {
                const uint32_t w = load32(src + i - 1);
                table[(w * 0x1E35A7BDu) >> (32 - kBits)] = i - 1;
            }
        } else {
            ++i;
        }
    }
    if (n > lit) out = emit_literal(out, src + lit, n - lit);
    return out - dst;
}

// -- RLE / bit-packed hybrid -------------------------------------------------

// Decode `count` values of `bit_width` bits (0..32) from the hybrid
// encoding in src[0:n] into out. Returns the bytes consumed, or -1.
int64_t srt_rle_decode(const uint8_t* src, int64_t n, int32_t bit_width,
                       int64_t count, int32_t* out) {
    if (bit_width < 0 || bit_width > 32) return -1;
    const uint64_t mask = bit_width == 32 ? 0xFFFFFFFFull
                                          : ((1ull << bit_width) - 1);
    int64_t pos = 0, produced = 0;
    while (produced < count) {
        uint64_t header;
        if (!get_varint(src, n, &pos, &header)) return -1;
        if (header & 1) {
            const int64_t groups = static_cast<int64_t>(header >> 1);
            const int64_t nbytes = groups * bit_width;
            const int64_t avail = n - pos < nbytes ? n - pos : nbytes;
            const int64_t nvals = groups * 8;
            for (int64_t j = 0; j < nvals && produced < count; ++j) {
                const int64_t bitpos = j * bit_width;
                const int64_t byte = bitpos >> 3;
                const int shift = static_cast<int>(bitpos & 7);
                uint64_t word = 0;
                const int need = (shift + bit_width + 7) >> 3;
                if (bit_width > 0 && byte + need > avail) return -1;
                for (int k = 0; k < need; ++k)
                    word |= static_cast<uint64_t>(src[pos + byte + k])
                            << (8 * k);
                out[produced++] = static_cast<int32_t>(
                    (word >> shift) & mask);
            }
            pos += avail;
        } else {
            const int64_t run = static_cast<int64_t>(header >> 1);
            const int vbytes = (bit_width + 7) / 8;
            if (pos + vbytes > n) return -1;
            uint64_t value = 0;
            for (int k = 0; k < vbytes; ++k)
                value |= static_cast<uint64_t>(src[pos + k]) << (8 * k);
            pos += vbytes;
            const int32_t v = static_cast<int32_t>(value & mask);
            for (int64_t k = 0; k < run && produced < count; ++k)
                out[produced++] = v;
        }
    }
    return pos;
}

// Encode `count` values of `bit_width` bits: runs of 8 or more equal
// values as RLE runs, the rest in bit-packed groups of 8 (only the last
// group padded with zeros). dst holds cap bytes. Returns the bytes
// written, or -1 when cap is too small.
int64_t srt_rle_encode(const int32_t* vals, int64_t count, int32_t bit_width,
                       uint8_t* dst, int64_t cap) {
    if (bit_width < 0 || bit_width > 32) return -1;
    uint8_t* out = dst;
    uint8_t* const end = dst + cap;
    const int vbytes = (bit_width + 7) / 8;
    int64_t i = 0;
    while (i < count) {
        int64_t j = i + 1;
        while (j < count && vals[j] == vals[i]) ++j;
        if (j - i >= 8) {
            if (end - out < 10 + vbytes) return -1;
            out = put_varint(out, static_cast<uint64_t>(j - i) << 1);
            for (int k = 0; k < vbytes; ++k)
                *out++ = static_cast<uint8_t>(
                    static_cast<uint32_t>(vals[i]) >> (8 * k));
            i = j;
            continue;
        }
        const int64_t start = i;
        int64_t groups = 0;
        while (i < count && groups < 63) {
            if (groups > 0) {
                int64_t k = i + 1;
                while (k < count && vals[k] == vals[i] && k - i < 8) ++k;
                if (k - i >= 8) break;
            }
            i += 8;
            ++groups;
        }
        const int64_t nbytes = groups * bit_width;
        if (end - out < 10 + nbytes) return -1;
        out = put_varint(out, (static_cast<uint64_t>(groups) << 1) | 1);
        std::memset(out, 0, static_cast<size_t>(nbytes));
        for (int64_t j2 = 0; j2 < groups * 8; ++j2) {
            const int64_t src_i = start + j2;
            const uint64_t v = src_i < count
                ? static_cast<uint64_t>(static_cast<uint32_t>(vals[src_i]))
                : 0;
            const int64_t bitpos = j2 * bit_width;
            for (int b = 0; b < bit_width; ++b) {
                if (v >> b & 1) {
                    const int64_t bp = bitpos + b;
                    out[bp >> 3] |= static_cast<uint8_t>(1u << (bp & 7));
                }
            }
        }
        out += nbytes;
        if (i > count) i = count;
    }
    return out - dst;
}

// -- PLAIN BYTE_ARRAY ---------------------------------------------------------

// Split `count` PLAIN BYTE_ARRAY values (4-byte LE length, then bytes)
// from src[0:n] into a contiguous buffer `data` (n bytes suffice) and
// offsets[count + 1]. Returns the bytes consumed, or -1.
int64_t srt_byte_array_unpack(const uint8_t* src, int64_t n, int64_t count,
                              uint8_t* data, int64_t* offsets) {
    int64_t pos = 0;
    offsets[0] = 0;
    for (int64_t i = 0; i < count; ++i) {
        if (pos + 4 > n) return -1;
        const int64_t len = static_cast<int64_t>(load32(src + pos));
        pos += 4;
        if (pos + len > n) return -1;
        std::memcpy(data + offsets[i], src + pos, static_cast<size_t>(len));
        offsets[i + 1] = offsets[i] + len;
        pos += len;
    }
    return pos;
}

// The inverse: `count` values from data/offsets into PLAIN layout in dst
// (4 * count + offsets[count] bytes). Returns the bytes written.
int64_t srt_byte_array_pack(const uint8_t* data, const int64_t* offsets,
                            int64_t count, uint8_t* dst) {
    uint8_t* out = dst;
    for (int64_t i = 0; i < count; ++i) {
        const uint32_t len = static_cast<uint32_t>(offsets[i + 1]
                                                   - offsets[i]);
        std::memcpy(out, &len, 4);
        std::memcpy(out + 4, data + offsets[i], len);
        out += 4 + len;
    }
    return out - dst;
}

// Copy values rows[0:k] (each at most `width` bytes) into out, one
// zero-padded row of `width` bytes each. flags[0] is set when a value
// holds a byte >= 0x80 (not ASCII), flags[1] when a value ends in a zero
// byte (a fixed-width row cannot carry it). Returns 0, or -1 when a value
// is wider than `width`.
int64_t srt_pad_rows(const uint8_t* data, const int64_t* offsets,
                     const int64_t* rows, int64_t k, int64_t width,
                     uint8_t* out, int32_t* flags) {
    std::memset(out, 0, static_cast<size_t>(k * width));
    int32_t non_ascii = 0, trailing_nul = 0;
    for (int64_t i = 0; i < k; ++i) {
        const int64_t r = rows[i];
        const int64_t a = offsets[r], len = offsets[r + 1] - offsets[r];
        if (len > width) return -1;
        const uint8_t* s = data + a;
        uint8_t* d = out + i * width;
        std::memcpy(d, s, static_cast<size_t>(len));
        for (int64_t b = 0; b < len; ++b) non_ascii |= s[b] >> 7;
        if (len > 0 && s[len - 1] == 0) trailing_nul = 1;
    }
    flags[0] = non_ascii;
    flags[1] = trailing_nul;
    return 0;
}

// DELTA_BINARY_PACKED: `count` values into out (64-bit arithmetic that
// wraps, which INT32 columns truncate). Returns the bytes the encoding
// took (its last miniblock read whole, padding included), or -1.
int64_t srt_delta_binary_decode(const uint8_t* src, int64_t n, int64_t count,
                                int64_t* out) {
    int64_t pos = 0;
    uint64_t block, minis, total, first;
    if (!get_varint(src, n, &pos, &block) || !get_varint(src, n, &pos, &minis)
        || !get_varint(src, n, &pos, &total)
        || !get_varint(src, n, &pos, &first))
        return -1;
    if (minis == 0 || block == 0 || block % minis != 0 || block > (1 << 20)
        || static_cast<int64_t>(total) < count)
        return -1;
    const uint64_t per_mini = block / minis;
    if (per_mini % 8 != 0) return -1;
    uint64_t prev = (first >> 1) ^ (~(first & 1) + 1);
    if (count == 0) return pos;
    out[0] = static_cast<int64_t>(prev);
    int64_t got = 1;
    std::vector<uint8_t> widths(static_cast<size_t>(minis));
    while (got < static_cast<int64_t>(total)) {
        uint64_t zmin;
        if (!get_varint(src, n, &pos, &zmin)) return -1;
        const uint64_t min_delta = (zmin >> 1) ^ (~(zmin & 1) + 1);
        if (static_cast<int64_t>(minis) > n - pos) return -1;
        std::memcpy(widths.data(), src + pos, static_cast<size_t>(minis));
        pos += static_cast<int64_t>(minis);
        for (uint64_t m = 0; m < minis && got < static_cast<int64_t>(total);
             ++m) {
            const int w = widths[m];
            if (w > 64) return -1;
            const int64_t bytes = static_cast<int64_t>(per_mini * w / 8);
            if (bytes > n - pos) return -1;
            const uint8_t* p = src + pos;
            for (uint64_t k = 0; k < per_mini &&
                 got < static_cast<int64_t>(total); ++k) {
                uint64_t v = 0;
                const uint64_t bit = k * static_cast<uint64_t>(w);
                for (int b = 0; b < w;) {
                    const uint64_t at = bit + b;
                    const int off = static_cast<int>(at & 7);
                    const int take = (8 - off) < (w - b) ? (8 - off) : (w - b);
                    const uint64_t chunk =
                        (p[at >> 3] >> off) & ((1u << take) - 1);
                    v |= chunk << b;
                    b += take;
                }
                prev += min_delta + v;
                if (got < count) out[got] = static_cast<int64_t>(prev);
                ++got;
            }
            pos += bytes;
        }
    }
    return pos;
}

// DELTA_BYTE_ARRAY: value i is the first prefix[i] bytes of value i - 1,
// then suffix i (sdata[soffs[i]:soffs[i + 1]]). Writes the values
// contiguously into out (cap bytes) with offsets[count + 1]; returns their
// total bytes, -1 on a prefix longer than the value before, -2 when out is
// too small.
int64_t srt_delta_byte_array(const int64_t* prefix, int64_t count,
                             const uint8_t* sdata, const int64_t* soffs,
                             uint8_t* out, int64_t cap, int64_t* offsets) {
    int64_t at = 0, prev_at = 0, prev_len = 0;
    offsets[0] = 0;
    for (int64_t i = 0; i < count; ++i) {
        const int64_t pre = prefix[i];
        const int64_t slen = soffs[i + 1] - soffs[i];
        if (pre < 0 || pre > prev_len || slen < 0) return -1;
        if (pre + slen > cap - at) return -2;
        std::memmove(out + at, out + prev_at, static_cast<size_t>(pre));
        std::memcpy(out + at + pre, sdata + soffs[i], static_cast<size_t>(slen));
        prev_at = at;
        prev_len = pre + slen;
        at += prev_len;
        offsets[i + 1] = at;
    }
    return at;
}

}  // extern "C"
