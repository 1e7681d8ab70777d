// The port's text codec on the host: the CSV record tokenizer, the typed
// field parsers, the JSON scanner and the value formatters of the text
// writers (spark_rapids_tpu_torch/io/text_format.py drives them).
//
// Every function takes and fills flat numpy buffers through a plain C
// interface. A span is bytes [off[i], off[i + 1]) of a text buffer; the
// parsers and formatters take the indices of the spans to work on, so a
// column is the spans of one field position over the good rows.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <system_error>
#include <unordered_map>
#include <vector>

namespace {

inline bool is_digit(uint8_t c) { return c >= '0' && c <= '9'; }

inline int lower(int c) { return (c >= 'A' && c <= 'Z') ? c + 32 : c; }

bool ieq(const uint8_t* s, int64_t n, const char* word) {
    const int64_t k = static_cast<int64_t>(std::strlen(word));
    if (n != k) return false;
    for (int64_t i = 0; i < n; ++i)
        if (lower(s[i]) != word[i]) return false;
    return true;
}

// Arrow's numeric trimming: spaces and tabs at both ends.
void trim_st(const uint8_t*& s, int64_t& n) {
    while (n > 0 && (s[0] == ' ' || s[0] == '\t')) { ++s; --n; }
    while (n > 0 && (s[n - 1] == ' ' || s[n - 1] == '\t')) --n;
}

// -- integers -----------------------------------------------------------------

// Arrow's integer syntax: trimmed, an optional '-', decimal digits, or an
// unsigned 0x/0X hexadecimal of the type's width (its bits taken as two's
// complement, as Arrow does). False on overflow of [lo, hi].
bool parse_int(const uint8_t* s, int64_t n, int64_t lo, int64_t hi,
               int64_t* out) {
    trim_st(s, n);
    if (n == 0) return false;
    if (n > 2 && s[0] == '0' && (s[1] == 'x' || s[1] == 'X')) {
        uint64_t v = 0;
        for (int64_t i = 2; i < n; ++i) {
            const int c = lower(s[i]);
            int d;
            if (c >= '0' && c <= '9') d = c - '0';
            else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
            else return false;
            if (v > (UINT64_MAX >> 4)) return false;
            v = (v << 4) | static_cast<uint64_t>(d);
        }
        const uint64_t umax = 2 * static_cast<uint64_t>(hi) + 1;
        if (v > umax) return false;
        *out = v > static_cast<uint64_t>(hi)
            ? static_cast<int64_t>(v - umax - 1) : static_cast<int64_t>(v);
        return true;
    }
    bool neg = false;
    if (s[0] == '-') { neg = true; ++s; --n; }
    if (n == 0) return false;
    uint64_t v = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (!is_digit(s[i])) return false;
        const uint64_t d = s[i] - '0';
        if (v > (UINT64_MAX - d) / 10) return false;
        v = v * 10 + d;
    }
    if (neg) {
        if (v > static_cast<uint64_t>(INT64_MAX) + 1) return false;
        const int64_t x = v == static_cast<uint64_t>(INT64_MAX) + 1
            ? INT64_MIN : -static_cast<int64_t>(v);
        if (x < lo) return false;
        *out = x;
        return true;
    }
    if (v > static_cast<uint64_t>(hi)) return false;
    *out = static_cast<int64_t>(v);
    return true;
}

// -- floating point -----------------------------------------------------------

// A correctly rounded parse of s[0:n] in full (std::from_chars); a value
// out of range reads as strtod gives it (an infinity, zero or a
// subnormal), as Arrow's parser does.
template <typename F>
bool from_chars_full(const char* a, const char* b, F* out) {
    F v{};
    auto r = std::from_chars(a, b, v, std::chars_format::general);
    if (r.ptr != b) return false;
    if (r.ec == std::errc::result_out_of_range) {
        std::string tmp(a, b);
        char* end = nullptr;
        const double d = std::strtod(tmp.c_str(), &end);
        if (end != tmp.c_str() + tmp.size()) return false;
        v = static_cast<F>(d);
        if constexpr (sizeof(F) == 4) {
            if (std::isfinite(d) && std::fabs(d) > 3.4028235e38)
                v = d > 0 ? INFINITY : -INFINITY;
        }
    } else if (r.ec != std::errc()) {
        return false;
    }
    *out = v;
    return true;
}

// Arrow's float syntax: trimmed, an optional sign, then a decimal number
// ("1.", ".5", exponents) or nan / inf / infinity in any case.
template <typename F>
bool parse_float(const uint8_t* s, int64_t n, F* out) {
    trim_st(s, n);
    if (n == 0) return false;
    bool neg = false;
    const uint8_t* body = s;
    int64_t m = n;
    if (body[0] == '+' || body[0] == '-') {
        neg = body[0] == '-';
        ++body;
        --m;
    }
    if (m == 0) return false;
    if (ieq(body, m, "nan")) { *out = static_cast<F>(NAN); return true; }
    if (ieq(body, m, "inf") || ieq(body, m, "infinity")) {
        *out = neg ? -static_cast<F>(INFINITY) : static_cast<F>(INFINITY);
        return true;
    }
    // only digits, one '.', and an exponent remain valid
    for (int64_t i = 0; i < m; ++i) {
        const uint8_t c = body[i];
        if (!(is_digit(c) || c == '.' || c == 'e' || c == 'E' || c == '+'
              || c == '-'))
            return false;
    }
    if (!is_digit(body[0]) && body[0] != '.') return false;
    F v;
    if (!from_chars_full(reinterpret_cast<const char*>(body),
                         reinterpret_cast<const char*>(body + m), &v))
        return false;
    *out = neg ? -v : v;
    return true;
}

// -- dates and timestamps -----------------------------------------------------

int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
    y -= m <= 2;
    const int64_t era = (y >= 0 ? y : y - 399) / 400;
    const int64_t yoe = y - era * 400;
    const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + doe - 719468;
}

void civil_from_days(int64_t z, int64_t* y, int64_t* m, int64_t* d) {
    z += 719468;
    const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
    const int64_t doe = z - era * 146097;
    const int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
    const int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
    const int64_t mp = (5 * doy + 2) / 153;
    *d = doy - (153 * mp + 2) / 5 + 1;
    *m = mp + (mp < 10 ? 3 : -9);
    *y = yoe + era * 400 + (*m <= 2);
}

bool leap(int64_t y) { return (y % 4 == 0 && y % 100 != 0) || y % 400 == 0; }

int64_t month_days(int64_t y, int64_t m) {
    static const int k[12] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
    return m == 2 && leap(y) ? 29 : k[m - 1];
}

bool digits(const uint8_t* s, int k, int64_t* out) {
    int64_t v = 0;
    for (int i = 0; i < k; ++i) {
        if (!is_digit(s[i])) return false;
        v = v * 10 + (s[i] - '0');
    }
    *out = v;
    return true;
}

// "YYYY-MM-DD" at s (exactly 10 bytes) -> days since the epoch.
bool ymd(const uint8_t* s, int64_t* days) {
    int64_t y, m, d;
    if (!digits(s, 4, &y) || s[4] != '-' || !digits(s + 5, 2, &m)
        || s[7] != '-' || !digits(s + 8, 2, &d))
        return false;
    if (m < 1 || m > 12 || d < 1 || d > month_days(y, m)) return false;
    *days = days_from_civil(y, m, d);
    return true;
}

bool parse_date(const uint8_t* s, int64_t n, int32_t* out) {
    trim_st(s, n);
    int64_t days;
    if (n != 10 || !ymd(s, &days)) return false;
    *out = static_cast<int32_t>(days);
    return true;
}

enum : uint8_t {
    TS_OK = 1, TS_ZONE = 2, TS_FRAC = 4, TS_SUBMICRO = 8,
};

// Arrow's ISO 8601 timestamp: YYYY-MM-DD, then optionally [T ]HH[:MM[:SS
// [.f{1,9}]]], then optionally Z or +-HH[[:]MM]. Untrimmed. Returns the
// status bits (0 when it does not parse) and the UTC micros (floored).
uint8_t parse_ts(const uint8_t* s, int64_t n, int64_t* micros) {
    int64_t days;
    if (n < 10 || !ymd(s, &days)) return 0;
    uint8_t st = TS_OK;
    int64_t secs = days * 86400, frac_ns = 0;
    int64_t i = 10;
    if (i == n) {
        *micros = secs * 1000000;
        return st;
    }
    if (s[i] != 'T' && s[i] != ' ') return 0;
    ++i;
    int64_t hh, mm = 0, ss = 0;
    if (i + 2 > n || !digits(s + i, 2, &hh) || hh > 23) return 0;
    i += 2;
    if (i < n && s[i] == ':') {
        if (i + 3 > n || !digits(s + i + 1, 2, &mm) || mm > 59) return 0;
        i += 3;
        if (i < n && s[i] == ':') {
            if (i + 3 > n || !digits(s + i + 1, 2, &ss) || ss > 59) return 0;
            i += 3;
            if (i < n && s[i] == '.') {
                ++i;
                int k = 0;
                while (i < n && is_digit(s[i])) {
                    if (++k > 9) return 0;
                    frac_ns = frac_ns * 10 + (s[i] - '0');
                    ++i;
                }
                if (k == 0) return 0;
                for (int j = k; j < 9; ++j) frac_ns *= 10;
                st |= TS_FRAC;
                if (frac_ns % 1000) st |= TS_SUBMICRO;
            }
        }
    }
    secs += hh * 3600 + mm * 60 + ss;
    if (i < n) {
        if (s[i] == 'Z') {
            ++i;
        } else if (s[i] == '+' || s[i] == '-') {
            const int64_t sign = s[i] == '-' ? -1 : 1;
            ++i;
            int64_t zh, zm = 0;
            if (i + 2 > n || !digits(s + i, 2, &zh) || zh > 23) return 0;
            i += 2;
            if (i < n) {
                if (s[i] == ':') ++i;
                if (i + 2 > n || !digits(s + i, 2, &zm) || zm > 59) return 0;
                i += 2;
            }
            secs -= sign * (zh * 3600 + zm * 60);
        } else {
            return 0;
        }
        if (i != n) return 0;
        st |= TS_ZONE;
    }
    *micros = secs * 1000000 + frac_ns / 1000;
    return st;
}

// HH:MM[:SS[.f]] (Arrow's time32/time64 inference; the scan raises on it).
bool parse_time(const uint8_t* s, int64_t n) {
    trim_st(s, n);
    int64_t hh, mm, ss;
    if (n < 5 || !digits(s, 2, &hh) || hh > 23 || s[2] != ':'
        || !digits(s + 3, 2, &mm) || mm > 59)
        return false;
    if (n == 5) return true;
    if (n < 8 || s[5] != ':' || !digits(s + 6, 2, &ss) || ss > 59)
        return false;
    if (n == 8) return true;
    if (s[8] != '.' || n == 9 || n > 18) return false;
    for (int64_t i = 9; i < n; ++i)
        if (!is_digit(s[i])) return false;
    return true;
}

// strptime over the directives %Y %y %m %d %H %M %S %p (and literal bytes;
// a space in the format matches any run of whitespace), as the vendored
// strptime behind Arrow's timestamp_parsers reads them; the whole value
// must be consumed. %f matches nothing (Arrow's strptime has no %f).
bool parse_strptime(const uint8_t* s, int64_t n, const uint8_t* f,
                    int64_t fn, int64_t* micros) {
    int64_t y = 1900, mo = 1, d = 1, h = 0, mi = 0, se = 0;
    int pm = -1;
    int64_t i = 0;
    auto num = [&](int maxw, int64_t* out) {
        int k = 0;
        int64_t v = 0;
        while (k < maxw && i < n && is_digit(s[i])) {
            v = v * 10 + (s[i] - '0');
            ++i;
            ++k;
        }
        *out = v;
        return k > 0;
    };
    for (int64_t j = 0; j < fn; ++j) {
        const uint8_t c = f[j];
        if (c == ' ' || (c >= 0x09 && c <= 0x0d)) {
            while (i < n && (s[i] == ' ' || (s[i] >= 0x09 && s[i] <= 0x0d)))
                ++i;
            continue;
        }
        if (c != '%' || j + 1 >= fn) {
            if (i >= n || s[i] != c) return false;
            ++i;
            continue;
        }
        const uint8_t dch = f[++j];
        int64_t v;
        switch (dch) {
            case 'Y': if (!num(4, &v)) return false; y = v; break;
            case 'y':
                if (!num(2, &v)) return false;
                y = v < 69 ? 2000 + v : 1900 + v;
                break;
            case 'm': if (!num(2, &v) || v < 1 || v > 12) return false;
                mo = v; break;
            case 'd': if (!num(2, &v) || v < 1 || v > 31) return false;
                d = v; break;
            case 'H': if (!num(2, &v) || v > 23) return false; h = v; break;
            case 'M': if (!num(2, &v) || v > 59) return false; mi = v; break;
            case 'S': if (!num(2, &v) || v > 60) return false; se = v; break;
            case 'p':
                if (i + 2 <= n && ieq(s + i, 2, "am")) pm = 0;
                else if (i + 2 <= n && ieq(s + i, 2, "pm")) pm = 1;
                else return false;
                i += 2;
                break;
            case '%': if (i >= n || s[i] != '%') return false; ++i; break;
            default: return false;
        }
    }
    if (i != n) return false;
    if (pm == 1 && h < 12) h += 12;
    if (pm == 0 && h == 12) h = 0;
    if (d > month_days(y, mo)) return false;
    *micros = ((days_from_civil(y, mo, d) * 86400) + h * 3600 + mi * 60 + se)
        * 1000000;
    return true;
}

// A decimal text (sign, digits, fraction, exponent) as an unscaled 128-bit
// value at `scale`; false when digits would be lost or the precision is
// exceeded.
bool parse_decimal(const uint8_t* s, int64_t n, int scale, int precision,
                   __int128* out) {
    trim_st(s, n);
    if (n == 0) return false;
    bool neg = false;
    int64_t i = 0;
    if (s[0] == '+' || s[0] == '-') { neg = s[0] == '-'; ++i; }
    std::string dig;
    int64_t point = -1, nd = 0;
    for (; i < n && (is_digit(s[i]) || s[i] == '.'); ++i) {
        if (s[i] == '.') {
            if (point >= 0) return false;
            point = nd;
        } else {
            dig.push_back(static_cast<char>(s[i]));
            ++nd;
        }
    }
    if (nd == 0) return false;
    int64_t exp10 = 0;
    if (i < n && (s[i] == 'e' || s[i] == 'E')) {
        ++i;
        bool eneg = false;
        if (i < n && (s[i] == '+' || s[i] == '-')) { eneg = s[i] == '-'; ++i; }
        if (i >= n) return false;
        for (; i < n; ++i) {
            if (!is_digit(s[i]) || exp10 > 100000) return false;
            exp10 = exp10 * 10 + (s[i] - '0');
        }
        if (eneg) exp10 = -exp10;
    }
    if (i != n) return false;
    // value = dig * 10^(exp10 - frac_digits); unscaled = value * 10^scale
    const int64_t frac = point < 0 ? 0 : nd - point;
    int64_t shift = exp10 - frac + scale;
    while (shift < 0 && !dig.empty() && dig.back() == '0') {
        dig.pop_back();
        ++shift;
    }
    if (shift < 0 && !dig.empty()) {
        // a nonzero digit below the scale would be lost
        bool any = false;
        for (char c : dig) any |= c != '0';
        if (any) return false;
        dig.clear();
    }
    __int128 v = 0;
    const __int128 limit = [] {
        __int128 x = 1;
        for (int k = 0; k < 38; ++k) x *= 10;
        return x;
    }();
    for (char c : dig) {
        v = v * 10 + (c - '0');
        if (v >= limit) return false;
    }
    for (int64_t k = 0; k < shift; ++k) {
        v *= 10;
        if (v >= limit) return false;
    }
    __int128 pmax = 1;
    for (int k = 0; k < precision; ++k) pmax *= 10;
    if (v >= pmax) return false;
    *out = neg ? -v : v;
    return true;
}

// -- formatting ---------------------------------------------------------------

// Shortest round-trip digits of a finite nonzero |v|: writes the digits to
// `dg` and returns the count; *e is the decimal exponent of the first digit.
template <typename F>
int shortest(F v, char* dg, int* e) {
    char buf[64];
    auto r = std::to_chars(buf, buf + sizeof(buf), v,
                           std::chars_format::scientific);
    const char* p = buf;
    if (*p == '-') ++p;
    int k = 0;
    for (; p < r.ptr && *p != 'e'; ++p)
        if (*p != '.') dg[k++] = *p;
    int ex = 0;
    std::from_chars(p + 1 + (p[1] == '+' ? 1 : 0), r.ptr, ex);
    *e = ex;
    return k;
}

// Arrow's float text (double-conversion ToShortest with positional form
// for exponents in [-6, 10), "e+X" otherwise; "nan", "inf", "-0").
template <typename F>
int fmt_arrow_float(F v, char* o) {
    if (std::isnan(v)) { std::memcpy(o, "nan", 3); return 3; }
    char* p = o;
    if (std::signbit(v)) *p++ = '-';
    if (std::isinf(v)) { std::memcpy(p, "inf", 3); return (p - o) + 3; }
    if (v == 0) { *p++ = '0'; return p - o; }
    char dg[40];
    int e;
    const int k = shortest(std::fabs(v), dg, &e);
    if (e >= -6 && e < 10) {
        if (e >= 0) {
            for (int i = 0; i <= e; ++i) *p++ = i < k ? dg[i] : '0';
            if (k > e + 1) {
                *p++ = '.';
                for (int i = e + 1; i < k; ++i) *p++ = dg[i];
            }
        } else {
            *p++ = '0';
            *p++ = '.';
            for (int i = 0; i < -e - 1; ++i) *p++ = '0';
            for (int i = 0; i < k; ++i) *p++ = dg[i];
        }
        return p - o;
    }
    *p++ = dg[0];
    if (k > 1) {
        *p++ = '.';
        for (int i = 1; i < k; ++i) *p++ = dg[i];
    }
    *p++ = 'e';
    *p++ = e < 0 ? '-' : '+';
    auto r = std::to_chars(p, p + 8, e < 0 ? -e : e);
    return r.ptr - o;
}

// Python's repr(float): positional for exponents in [-4, 16) with at least
// one fractional digit, else "d.ddde+XX" (two exponent digits at least).
// json_specials spells NaN / Infinity / -Infinity as json.dumps does.
int fmt_py_float(double v, bool json_specials, char* o) {
    if (std::isnan(v)) {
        const char* w = json_specials ? "NaN" : "nan";
        std::memcpy(o, w, 3);
        return 3;
    }
    char* p = o;
    if (std::isinf(v)) {
        const char* w = json_specials ? (v > 0 ? "Infinity" : "-Infinity")
                                      : (v > 0 ? "inf" : "-inf");
        const int k = static_cast<int>(std::strlen(w));
        std::memcpy(o, w, k);
        return k;
    }
    if (std::signbit(v)) *p++ = '-';
    if (v == 0) { std::memcpy(p, "0.0", 3); return (p - o) + 3; }
    char dg[40];
    int e;
    const int k = shortest(std::fabs(v), dg, &e);
    if (e >= -4 && e < 16) {
        if (e >= 0) {
            for (int i = 0; i <= e; ++i) *p++ = i < k ? dg[i] : '0';
            *p++ = '.';
            if (k > e + 1) {
                for (int i = e + 1; i < k; ++i) *p++ = dg[i];
            } else {
                *p++ = '0';
            }
        } else {
            *p++ = '0';
            *p++ = '.';
            for (int i = 0; i < -e - 1; ++i) *p++ = '0';
            for (int i = 0; i < k; ++i) *p++ = dg[i];
        }
        return p - o;
    }
    *p++ = dg[0];
    if (k > 1) {
        *p++ = '.';
        for (int i = 1; i < k; ++i) *p++ = dg[i];
    }
    *p++ = 'e';
    *p++ = e < 0 ? '-' : '+';
    const int ae = e < 0 ? -e : e;
    if (ae < 10) *p++ = '0';
    auto r = std::to_chars(p, p + 8, ae);
    return r.ptr - o;
}

int put2(char* p, int64_t v) {
    p[0] = static_cast<char>('0' + v / 10);
    p[1] = static_cast<char>('0' + v % 10);
    return 2;
}

int fmt_date(int64_t days, char* o) {
    int64_t y, m, d;
    civil_from_days(days, &y, &m, &d);
    char* p = o;
    if (y < 0) { *p++ = '-'; y = -y; }
    if (y < 1000) {
        p += std::snprintf(p, 8, "%04lld", static_cast<long long>(y));
    } else {
        auto r = std::to_chars(p, p + 12, y);
        p = r.ptr;
    }
    *p++ = '-';
    p += put2(p, m);
    *p++ = '-';
    p += put2(p, d);
    return p - o;
}

// style 0: Arrow's CSV text of timestamp[us, UTC] ("... HH:MM:SS.ffffffZ");
// 1: Python's str(datetime) ("... HH:MM:SS[.ffffff]");
// 2: Arrow's text of timestamp[s] ("... HH:MM:SS").
int fmt_ts(int64_t micros, int style, char* o) {
    int64_t secs = micros / 1000000, us = micros % 1000000;
    if (us < 0) { us += 1000000; --secs; }
    int64_t days = secs / 86400, sod = secs % 86400;
    if (sod < 0) { sod += 86400; --days; }
    char* p = o + fmt_date(days, o);
    *p++ = ' ';
    p += put2(p, sod / 3600);
    *p++ = ':';
    p += put2(p, sod / 60 % 60);
    *p++ = ':';
    p += put2(p, sod % 60);
    if (style == 0 || (style == 1 && us != 0)) {
        p += std::snprintf(p, 8, ".%06lld", static_cast<long long>(us));
    }
    if (style == 0) *p++ = 'Z';
    return p - o;
}

int fmt_i128(__int128 v, char* o) {
    char tmp[48];
    int k = 0;
    const bool neg = v < 0;
    unsigned __int128 u = neg ? -static_cast<unsigned __int128>(v)
                              : static_cast<unsigned __int128>(v);
    do {
        tmp[k++] = static_cast<char>('0' + static_cast<int>(u % 10));
        u /= 10;
    } while (u);
    char* p = o;
    if (neg) *p++ = '-';
    while (k) *p++ = tmp[--k];
    return p - o;
}

// Arrow's decimal text: the unscaled value with a point `scale` digits
// from the right ("-0.05", "123.40", "7").
int fmt_decimal(__int128 v, int scale, char* o) {
    char digs[48];
    const int k = fmt_i128(v < 0 ? -v : v, digs);
    char* p = o;
    if (v < 0) *p++ = '-';
    if (scale <= 0) {
        std::memcpy(p, digs, k);
        return (p - o) + k;
    }
    if (k <= scale) {
        *p++ = '0';
        *p++ = '.';
        for (int i = 0; i < scale - k; ++i) *p++ = '0';
        std::memcpy(p, digs, k);
        return (p - o) + k;
    }
    std::memcpy(p, digs, k - scale);
    p += k - scale;
    *p++ = '.';
    std::memcpy(p, digs + k - scale, scale);
    return (p - o) + scale;
}

// -- JSON ---------------------------------------------------------------------

enum JKind : uint8_t {
    J_NULL = 0, J_TRUE = 1, J_FALSE = 2, J_INT = 3, J_FLOAT = 4,
    J_STRING = 5, J_OBJECT = 6, J_ARRAY = 7, J_NONSTD = 8,
};

enum JErr : int64_t {
    E_SYNTAX = -1, E_NOT_OBJECT = -2, E_DUP_KEY = -3, E_TOO_BIG = -4,
    E_DEPTH = -5, E_CAPACITY = -6,
};

inline bool jws(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

struct JParser {
    const uint8_t* s;
    int64_t n;
    int64_t i = 0;
    bool allow_nonstd = false;  // rapidjson's kParseNanAndInfFlag (Arrow)
    bool check_range = false;   // a float past DBL_MAX is an error
    std::string* sink = nullptr;  // where a string's text is unescaped to

    void ws() { while (i < n && jws(s[i])) ++i; }

    static void put_utf8(std::string* o, uint32_t cp) {
        if (!o) return;
        if (cp < 0x80) {
            o->push_back(static_cast<char>(cp));
        } else if (cp < 0x800) {
            o->push_back(static_cast<char>(0xC0 | (cp >> 6)));
            o->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
        } else if (cp < 0x10000) {
            o->push_back(static_cast<char>(0xE0 | (cp >> 12)));
            o->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
            o->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
        } else {
            o->push_back(static_cast<char>(0xF0 | (cp >> 18)));
            o->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
            o->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
            o->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
        }
    }

    bool hex4(uint32_t* out) {
        if (i + 4 > n) return false;
        uint32_t v = 0;
        for (int k = 0; k < 4; ++k) {
            const int c = lower(s[i + k]);
            int d;
            if (c >= '0' && c <= '9') d = c - '0';
            else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
            else return false;
            v = (v << 4) | static_cast<uint32_t>(d);
        }
        i += 4;
        *out = v;
        return true;
    }

    // s[i] == '"': the string's bytes unescaped to dst (dst's capacity is
    // at least the text's own length); *len gets their count. A string
    // without escapes is one copy.
    bool string_to(uint8_t* dst, int64_t* len) {
        const int64_t a = i + 1;
        const uint8_t* q = static_cast<const uint8_t*>(
            std::memchr(s + a, '"', static_cast<size_t>(n - a)));
        if (q) {
            const int64_t b = q - s;
            bool plain = true;
            for (int64_t k = a; k < b && plain; ++k)
                plain = s[k] != '\\' && s[k] >= 0x20;
            if (plain) {
                std::memcpy(dst, s + a, static_cast<size_t>(b - a));
                *len = b - a;
                i = b + 1;
                return true;
            }
        }
        std::string tmp;
        if (!string(&tmp)) return false;
        std::memcpy(dst, tmp.data(), tmp.size());
        *len = static_cast<int64_t>(tmp.size());
        return true;
    }

    // s[i] == '"'; unescapes into `o` (may be null).
    bool string(std::string* o) {
        ++i;
        while (i < n) {
            const uint8_t c = s[i];
            if (c == '"') { ++i; return true; }
            if (c < 0x20) return false;
            if (c != '\\') {
                if (o) o->push_back(static_cast<char>(c));
                ++i;
                continue;
            }
            if (++i >= n) return false;
            const uint8_t e = s[i++];
            switch (e) {
                case '"': if (o) o->push_back('"'); break;
                case '\\': if (o) o->push_back('\\'); break;
                case '/': if (o) o->push_back('/'); break;
                case 'b': if (o) o->push_back('\b'); break;
                case 'f': if (o) o->push_back('\f'); break;
                case 'n': if (o) o->push_back('\n'); break;
                case 'r': if (o) o->push_back('\r'); break;
                case 't': if (o) o->push_back('\t'); break;
                case 'u': {
                    uint32_t cp;
                    if (!hex4(&cp)) return false;
                    if (cp >= 0xD800 && cp <= 0xDBFF) {
                        uint32_t lo;
                        if (i + 2 > n || s[i] != '\\' || s[i + 1] != 'u')
                            return false;
                        i += 2;
                        if (!hex4(&lo) || lo < 0xDC00 || lo > 0xDFFF)
                            return false;
                        cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                    } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
                        return false;
                    }
                    put_utf8(o, cp);
                    break;
                }
                default: return false;
            }
        }
        return false;
    }

    bool word(const char* w) {
        const int64_t k = static_cast<int64_t>(std::strlen(w));
        if (i + k > n || std::memcmp(s + i, w, k) != 0) return false;
        i += k;
        return true;
    }

    // A number or a non-standard constant; returns its kind or 255.
    uint8_t number() {
        const int64_t a = i;
        if (s[i] == 'N') return allow_nonstd && word("NaN") ? uint8_t{J_NONSTD} : uint8_t{255};
        if (s[i] == 'I')
            return allow_nonstd && word("Infinity") ? uint8_t{J_NONSTD} : uint8_t{255};
        if (s[i] == '-') {
            ++i;
            if (i < n && s[i] == 'I')
                return allow_nonstd && word("Infinity") ? uint8_t{J_NONSTD} : uint8_t{255};
        }
        if (i >= n) return 255;
        const int64_t int_start = i;
        if (s[i] == '0') {
            ++i;
        } else if (s[i] >= '1' && s[i] <= '9') {
            while (i < n && is_digit(s[i])) ++i;
        } else {
            return 255;
        }
        const int64_t int_digits = i - int_start;
        int64_t exp10 = 0;
        uint8_t kind = J_INT;
        if (i < n && s[i] == '.') {
            ++i;
            if (i >= n || !is_digit(s[i])) return 255;
            while (i < n && is_digit(s[i])) ++i;
            kind = J_FLOAT;
        }
        if (i < n && (s[i] == 'e' || s[i] == 'E')) {
            ++i;
            bool eneg = false;
            if (i < n && (s[i] == '+' || s[i] == '-')) eneg = s[i++] == '-';
            if (i >= n || !is_digit(s[i])) return 255;
            while (i < n && is_digit(s[i])) {
                if (exp10 < 100000) exp10 = exp10 * 10 + (s[i] - '0');
                ++i;
            }
            if (eneg) exp10 = -exp10;
            kind = J_FLOAT;
        }
        // only a value of 10^308 or more can overflow a double
        if (check_range && kind == J_FLOAT && int_digits + exp10 > 308) {
            double v;
            auto r = std::from_chars(reinterpret_cast<const char*>(s + a),
                                     reinterpret_cast<const char*>(s + i), v);
            if (r.ec == std::errc::result_out_of_range) {
                std::string tmp(reinterpret_cast<const char*>(s + a), i - a);
                if (std::isinf(std::strtod(tmp.c_str(), nullptr)))
                    return 254;
            }
        }
        return kind;
    }

    // Any value, its text not kept; 0 ok, else an error code.
    int64_t skip(int depth) {
        if (depth > 512) return E_DEPTH;
        ws();
        if (i >= n) return E_SYNTAX;
        const uint8_t c = s[i];
        if (c == '{' || c == '[') {
            const uint8_t close = c == '{' ? '}' : ']';
            ++i;
            ws();
            if (i < n && s[i] == close) { ++i; return 0; }
            for (;;) {
                if (c == '{') {
                    ws();
                    if (i >= n || s[i] != '"' || !string(nullptr))
                        return E_SYNTAX;
                    ws();
                    if (i >= n || s[i] != ':') return E_SYNTAX;
                    ++i;
                }
                const int64_t r = skip(depth + 1);
                if (r) return r;
                ws();
                if (i < n && s[i] == ',') { ++i; continue; }
                if (i < n && s[i] == close) { ++i; return 0; }
                return E_SYNTAX;
            }
        }
        if (c == '"') return string(nullptr) ? int64_t{0} : int64_t{E_SYNTAX};
        if (word("true") || word("false") || word("null")) return 0;
        const uint8_t k = number();
        if (k == 254) return E_TOO_BIG;
        return k == 255 ? int64_t{E_SYNTAX} : int64_t{0};
    }
};

}  // namespace

extern "C" {

// -- CSV ----------------------------------------------------------------------

// Drop every line (split on \n) whose left-stripped text starts with the
// comment bytes; the kept lines join with \n. Returns the output length.
int64_t srt_filter_comment_lines(const uint8_t* s, int64_t n,
                                 const uint8_t* cm, int64_t cn, uint8_t* out) {
    int64_t o = 0, a = 0;
    bool first = true;
    while (a <= n) {
        int64_t b = a;
        while (b < n && s[b] != '\n') ++b;
        int64_t k = a;
        while (k < b && (s[k] == ' ' || (s[k] >= 0x09 && s[k] <= 0x0d))) ++k;
        const bool drop = b - k >= cn && std::memcmp(s + k, cm, cn) == 0;
        if (!drop) {
            if (!first) out[o++] = '\n';
            std::memcpy(out + o, s + a, b - a);
            o += b - a;
            first = false;
        }
        a = b + 1;
    }
    return o;
}

// Tokenize delimited text as Arrow's CSV parser does: empty lines are
// skipped; \n, \r\n and \r end a record outside quotes; a quote opens a
// quoted section only at a field's start, and inside one a doubled quote
// (double_quote) is a literal quote while a single one closes it; the
// escape byte (< 0 for none) makes the next byte literal anywhere, an
// escaped newline included. Field contents (unquoted, unescaped) go to
// `out`; field k is out[field_off[k]:field_off[k + 1]], quoted[k] says
// whether it started with a quote. Row r holds fields [row_first[r],
// row_first[r + 1]) and spans s[row_raw[2r]:row_raw[2r + 1]]. Returns the
// row count (*nf_out the field count), or -1 when a capacity is short.
int64_t srt_csv_tokenize(const uint8_t* s, int64_t n, int32_t delim,
                         int32_t quote, int32_t escape, int32_t double_quote,
                         uint8_t* out, int64_t* field_off, uint8_t* quoted,
                         int64_t cap_f, int64_t* row_first, int64_t* row_raw,
                         int64_t cap_r, int64_t* nf_out) {
    int64_t i = 0, o = 0, nf = 0, nr = 0;
    while (i < n) {
        if (s[i] == '\n') { ++i; continue; }
        if (s[i] == '\r') {
            ++i;
            if (i < n && s[i] == '\n') ++i;
            continue;
        }
        if (nr >= cap_r) return -1;
        row_first[nr] = nf;
        row_raw[2 * nr] = i;
        int64_t raw_end = -1;
        for (;;) {
            if (nf >= cap_f) return -1;
            field_off[nf] = o;
            uint8_t q = 0;
            bool in_quote = false, end_field = false;
            if (quote >= 0 && i < n && s[i] == quote) {
                q = 1;
                in_quote = true;
                ++i;
            }
            while (i < n) {
                const uint8_t c = s[i];
                if (escape >= 0 && c == escape) {
                    if (i + 1 < n) out[o++] = s[i + 1];
                    i += 2;
                    continue;
                }
                if (in_quote) {
                    if (c == quote) {
                        if (double_quote && i + 1 < n && s[i + 1] == quote) {
                            out[o++] = c;
                            i += 2;
                            continue;
                        }
                        in_quote = false;
                        ++i;
                        continue;
                    }
                    out[o++] = c;
                    ++i;
                    continue;
                }
                if (c == delim) { ++i; end_field = true; break; }
                if (c == '\n') { raw_end = i; ++i; break; }
                if (c == '\r') {
                    raw_end = i;
                    ++i;
                    if (i < n && s[i] == '\n') ++i;
                    break;
                }
                out[o++] = c;
                ++i;
            }
            if (i > n) i = n;
            quoted[nf++] = q;
            if (!end_field) break;
            if (i >= n) {
                // a delimiter ending the text: one more (empty) field
                if (nf >= cap_f) return -1;
                field_off[nf] = o;
                quoted[nf++] = 0;
                break;
            }
        }
        if (raw_end < 0) {
            // the text ended the row (inside quotes, maybe): its final
            // line break is not the row's
            raw_end = i;
            while (raw_end > row_raw[2 * nr]
                   && (s[raw_end - 1] == '\n' || s[raw_end - 1] == '\r'))
                --raw_end;
        }
        row_raw[2 * nr + 1] = raw_end;
        ++nr;
    }
    field_off[nf] = o;
    row_first[nr] = nf;
    *nf_out = nf;
    return nr;
}

// null[i] = span idx[i] is unquoted and equals one of the null spellings
// (nulls[noff[k]:noff[k + 1]]). quoted may be null (nothing quoted).
void srt_null_mask(const uint8_t* buf, const int64_t* off,
                   const uint8_t* quoted, const int64_t* idx, int64_t n,
                   const uint8_t* nulls, const int64_t* noff, int32_t nn,
                   uint8_t* null_out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t f = idx[i];
        uint8_t hit = 0;
        if (!(quoted && quoted[f])) {
            const int64_t a = off[f], len = off[f + 1] - off[f];
            for (int32_t k = 0; k < nn && !hit; ++k) {
                const int64_t kl = noff[k + 1] - noff[k];
                hit = kl == len && std::memcmp(buf + a, nulls + noff[k], len) == 0;
            }
        }
        null_out[i] = hit;
    }
}

// Arrow's CSV type inference over the spans idx[0:n] (non-null values):
// the first kind in Arrow's order that every value parses as. Returns
// 1 int64, 2 bool, 3 double, 4 date32, 5 time, 6 timestamp[s],
// 7 timestamp[ns], 8 timestamp[s, UTC], 9 timestamp[ns, UTC], 10 string;
// 0 when n == 0 (the null type).
int64_t srt_csv_infer(const uint8_t* buf, const int64_t* off,
                      const int64_t* idx, int64_t n) {
    if (n == 0) return 0;
    uint32_t cand = 0x3FE;  // bits 1..9; string (10) always fits
    for (int64_t i = 0; i < n && cand; ++i) {
        const uint8_t* s = buf + off[idx[i]];
        const int64_t len = off[idx[i] + 1] - off[idx[i]];
        int64_t iv;
        double dv;
        int32_t d32;
        if ((cand & 2) && !parse_int(s, len, INT64_MIN, INT64_MAX, &iv))
            cand &= ~2u;
        if ((cand & 4)) {
            static const char* tv[] = {"1", "True", "TRUE", "true",
                                       "0", "False", "FALSE", "false"};
            bool ok = false;
            for (const char* w : tv)
                ok |= static_cast<int64_t>(std::strlen(w)) == len
                      && std::memcmp(s, w, len) == 0;
            if (!ok) cand &= ~4u;
        }
        if ((cand & 8) && !parse_float(s, len, &dv)) cand &= ~8u;
        if ((cand & 16) && !parse_date(s, len, &d32)) cand &= ~16u;
        if ((cand & 32) && !parse_time(s, len)) cand &= ~32u;
        if (cand & 0x3C0) {
            int64_t us;
            const uint8_t st = parse_ts(s, len, &us);
            const bool ok = st & TS_OK, zone = st & TS_ZONE,
                       frac = st & TS_FRAC;
            if (!(ok && !zone && !frac)) cand &= ~64u;
            if (!(ok && !zone)) cand &= ~128u;
            if (!(ok && zone && !frac)) cand &= ~256u;
            if (!(ok && zone)) cand &= ~512u;
        }
    }
    for (int k = 1; k <= 9; ++k)
        if (cand & (1u << k)) return k;
    return 10;
}

// Parse spans idx[0:n] as `kind`, writing values to `out` and status[i]
// (0 = does not parse). Returns the count that do not parse.
//   1 integer (arg: byte width 1/2/4/8) -> int64
//   2 double, 3 float (Arrow's syntax) -> double / float
//   4 bool (Arrow's spellings) -> uint8
//   5 date32 (YYYY-MM-DD) -> int32 days
//   6 ISO timestamp -> int64 UTC micros; status carries the TS_* bits
//   7 decimal (arg: scale | precision << 8) -> int64 (hi, lo) pairs
int64_t srt_parse(const uint8_t* buf, const int64_t* off, const int64_t* idx,
                  int64_t n, int32_t kind, int64_t arg, void* out,
                  uint8_t* status) {
    int64_t bad = 0;
    int64_t lo = INT64_MIN, hi = INT64_MAX;
    if (kind == 1 && arg < 8) {
        hi = (int64_t{1} << (8 * arg - 1)) - 1;
        lo = -hi - 1;
    }
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* s = buf + off[idx[i]];
        const int64_t len = off[idx[i] + 1] - off[idx[i]];
        uint8_t st = 0;
        switch (kind) {
            case 1: st = parse_int(s, len, lo, hi,
                                   static_cast<int64_t*>(out) + i); break;
            case 2: st = parse_float(s, len, static_cast<double*>(out) + i);
                break;
            case 3: st = parse_float(s, len, static_cast<float*>(out) + i);
                break;
            case 4: {
                static const char* tv[] = {"1", "True", "TRUE", "true"};
                static const char* fv[] = {"0", "False", "FALSE", "false"};
                for (int k = 0; k < 4 && !st; ++k) {
                    const int64_t tl = static_cast<int64_t>(std::strlen(tv[k]));
                    const int64_t fl = static_cast<int64_t>(std::strlen(fv[k]));
                    if (tl == len && std::memcmp(s, tv[k], len) == 0) {
                        static_cast<uint8_t*>(out)[i] = 1;
                        st = 1;
                    } else if (fl == len && std::memcmp(s, fv[k], len) == 0) {
                        static_cast<uint8_t*>(out)[i] = 0;
                        st = 1;
                    }
                }
                break;
            }
            case 5: st = parse_date(s, len, static_cast<int32_t*>(out) + i);
                break;
            case 6: st = parse_ts(s, len, static_cast<int64_t*>(out) + i);
                break;
            case 7: {
                __int128 v;
                st = parse_decimal(s, len, static_cast<int>(arg & 0xFF),
                                   static_cast<int>(arg >> 8), &v);
                if (st) {
                    int64_t* o = static_cast<int64_t*>(out) + 2 * i;
                    o[0] = static_cast<int64_t>(v >> 64);
                    o[1] = static_cast<int64_t>(
                        static_cast<uint64_t>(static_cast<unsigned __int128>(v)));
                }
                break;
            }
            default: return -1;
        }
        status[i] = st;
        bad += st == 0;
    }
    return bad;
}

// strptime spans idx[0:n] with the format fmt[0:fn] -> int64 micros.
int64_t srt_parse_strptime(const uint8_t* buf, const int64_t* off,
                           const int64_t* idx, int64_t n, const uint8_t* fmt,
                           int64_t fn, int64_t* out, uint8_t* status) {
    int64_t bad = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* s = buf + off[idx[i]];
        const int64_t len = off[idx[i] + 1] - off[idx[i]];
        status[i] = parse_strptime(s, len, fmt, fn, out + i);
        bad += status[i] == 0;
    }
    return bad;
}

// Distinct spans of idx[0:n] by bytes: codes[i] numbers span i's value in
// first-appearance order, first[c] is the position in idx of value c's
// first span. Returns the number of distinct values.
int64_t srt_span_dedup(const uint8_t* buf, const int64_t* off,
                       const int64_t* idx, int64_t n, int64_t* codes,
                       int64_t* first) {
    std::unordered_map<std::string_view, int64_t> seen;
    seen.reserve(static_cast<size_t>(n < 1024 ? 1024 : n / 4));
    int64_t k = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t f = idx[i];
        std::string_view v(reinterpret_cast<const char*>(buf + off[f]),
                           static_cast<size_t>(off[f + 1] - off[f]));
        auto it = seen.try_emplace(v, k);
        if (it.second) first[k++] = i;
        codes[i] = it.first->second;
    }
    return k;
}

// Copy spans idx[0:n] contiguously: out[out_off[i]:out_off[i + 1]].
void srt_gather_spans(const uint8_t* buf, const int64_t* off,
                      const int64_t* idx, int64_t n, uint8_t* out,
                      int64_t* out_off) {
    int64_t o = 0;
    out_off[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t a = off[idx[i]], len = off[idx[i] + 1] - a;
        std::memcpy(out + o, buf + a, static_cast<size_t>(len));
        o += len;
        out_off[i + 1] = o;
    }
}

// -- JSON ---------------------------------------------------------------------

// Scan a stream of JSON objects (whitespace-separated, one row each), as
// Arrow's JSON reader takes them. For each top-level member: val_row (its
// row), val_key (its key, numbered in order of first appearance), kind
// (J_*) and its text (a string unescaped to UTF-8, a number as written;
// nothing for other kinds) at out[val_off[v]:val_off[v + 1]]. Keys go to
// keys[key_off[k]:key_off[k + 1]]. info = {values, rows, keys, error
// offset}. Returns 0, or a negative error code (E_*). allow_nonstd takes
// NaN / Infinity / -Infinity as numbers (kind J_NONSTD).
int64_t srt_json_scan(const uint8_t* s, int64_t n, int32_t allow_nonstd,
                      uint8_t* out, int64_t* val_off, uint8_t* kind,
                      int64_t* val_row, int32_t* val_key, int64_t cap_v,
                      uint8_t* keys, int64_t* key_off, int64_t cap_k,
                      int64_t* info) {
    JParser p{s, n};
    p.allow_nonstd = allow_nonstd != 0;
    p.check_range = true;
    std::unordered_map<std::string, int32_t> key_ids;
    std::vector<int64_t> last_row;
    std::vector<int32_t> prev;  // the key ids of the last row, in order
    std::string key;
    int64_t o = 0, nv = 0, nr = 0, kb = 0;
    key_off[0] = 0;
    auto fail = [&](int64_t code) {
        info[0] = nv; info[1] = nr;
        info[2] = static_cast<int64_t>(key_ids.size());
        info[3] = p.i;
        return code;
    };
    for (;;) {
        p.ws();
        if (p.i >= n) break;
        if (s[p.i] != '{') return fail(E_NOT_OBJECT);
        ++p.i;
        p.ws();
        if (p.i < n && s[p.i] == '}') {
            ++p.i;
            ++nr;
            continue;
        }
        size_t pos = 0;
        for (;;) {
            p.ws();
            if (p.i >= n || s[p.i] != '"') return fail(E_SYNTAX);
            // the common case: the key the previous row had here, written
            // the same way (no escapes)
            int32_t kid = -1;
            if (pos < prev.size()) {
                const int32_t want = prev[pos];
                const int64_t kl = key_off[want + 1] - key_off[want];
                const int64_t a = p.i + 1;
                if (a + kl < n && s[a + kl] == '"'
                    && std::memcmp(s + a, keys + key_off[want], kl) == 0
                    && std::memchr(s + a, '\\', kl) == nullptr) {
                    kid = want;
                    p.i = a + kl + 1;
                }
            }
            if (kid < 0) {
                key.clear();
                if (!p.string(&key)) return fail(E_SYNTAX);
            }
            p.ws();
            if (p.i >= n || s[p.i] != ':') return fail(E_SYNTAX);
            ++p.i;
            p.ws();
            if (p.i >= n) return fail(E_SYNTAX);
            if (kid < 0) {
                auto it = key_ids.find(key);
                if (it != key_ids.end()) {
                    kid = it->second;
                } else {
                    kid = static_cast<int32_t>(key_ids.size());
                    if (kid >= cap_k) return fail(E_CAPACITY);
                    key_ids.emplace(key, kid);
                    std::memcpy(keys + kb, key.data(), key.size());
                    kb += static_cast<int64_t>(key.size());
                    key_off[kid + 1] = kb;
                    last_row.push_back(-1);
                }
            }
            if (pos < prev.size()) prev[pos] = kid;
            else prev.push_back(kid);
            ++pos;
            if (last_row[kid] == nr) return fail(E_DUP_KEY);
            last_row[kid] = nr;
            if (nv >= cap_v) return fail(E_CAPACITY);
            val_off[nv] = o;
            const uint8_t c = s[p.i];
            uint8_t k;
            if (c == '{' || c == '[') {
                const int64_t r = p.skip(0);
                if (r) return fail(r);
                k = c == '{' ? J_OBJECT : J_ARRAY;
            } else if (c == '"') {
                int64_t len;
                if (!p.string_to(out + o, &len)) return fail(E_SYNTAX);
                o += len;
                k = J_STRING;
            } else if (p.word("true")) {
                k = J_TRUE;
            } else if (p.word("false")) {
                k = J_FALSE;
            } else if (p.word("null")) {
                k = J_NULL;
            } else {
                const int64_t a = p.i;
                k = p.number();
                if (k == 254) return fail(E_TOO_BIG);
                if (k == 255) return fail(E_SYNTAX);
                std::memcpy(out + o, s + a, p.i - a);
                o += p.i - a;
            }
            kind[nv] = k;
            val_row[nv] = nr;
            val_key[nv] = kid;
            ++nv;
            p.ws();
            if (p.i < n && s[p.i] == ',') { ++p.i; continue; }
            if (p.i < n && s[p.i] == '}') { ++p.i; break; }
            return fail(E_SYNTAX);
        }
        ++nr;
    }
    val_off[nv] = o;
    info[0] = nv;
    info[1] = nr;
    info[2] = static_cast<int64_t>(key_ids.size());
    info[3] = -1;
    return 0;
}

// The line normalisation of a JSON-lines file that did not parse whole:
// lines (split on \n, \r\n, \r) are stripped of ASCII whitespace; an empty
// one is dropped; a line that is one JSON value (standard JSON: NaN and
// Infinity are malformed) is kept as it was; a malformed one becomes {}
// (permissive) or is dropped. The kept lines join with \n (out needs
// 2 * n + 2 bytes). Returns the output length.
int64_t srt_json_normalize(const uint8_t* s, int64_t n, int32_t permissive,
                           uint8_t* out) {
    int64_t o = 0, a = 0;
    bool first = true;
    while (a < n) {
        int64_t b = a;
        while (b < n && s[b] != '\n' && s[b] != '\r') ++b;
        const int64_t next = (b < n && s[b] == '\r' && b + 1 < n
                              && s[b + 1] == '\n') ? b + 2 : b + 1;
        int64_t x = a, y = b;
        auto ws = [](uint8_t c) {
            return c == ' ' || (c >= 0x09 && c <= 0x0d);
        };
        while (x < y && ws(s[x])) ++x;
        while (y > x && ws(s[y - 1])) --y;
        if (y > x) {
            JParser p{s + x, y - x};
            p.allow_nonstd = false;
            p.check_range = false;
            bool ok = p.skip(0) == 0;
            if (ok) {
                p.ws();
                ok = p.i == p.n;
            }
            if (ok || permissive) {
                if (!first) out[o++] = '\n';
                first = false;
                if (ok) {
                    std::memcpy(out + o, s + a, b - a);
                    o += b - a;
                } else {
                    out[o++] = '{';
                    out[o++] = '}';
                }
            }
        }
        a = next;
    }
    return o;
}

// -- formatters ---------------------------------------------------------------

// Each writes value i's text to out[off[i]:off[i + 1]] and returns the
// total length; out needs the stated bytes a value.

// int64 decimal text (20 bytes a value).
int64_t srt_fmt_i64(const int64_t* v, int64_t n, uint8_t* out, int64_t* off) {
    int64_t o = 0;
    off[0] = 0;
    char* b = reinterpret_cast<char*>(out);
    for (int64_t i = 0; i < n; ++i) {
        auto r = std::to_chars(b + o, b + o + 24, v[i]);
        o = r.ptr - b;
        off[i + 1] = o;
    }
    return o;
}

// Doubles (32 bytes a value): style 0 Arrow's text, 1 Python's repr,
// 2 json.dumps (repr with NaN / Infinity / -Infinity).
int64_t srt_fmt_f64(const double* v, int64_t n, int32_t style, uint8_t* out,
                    int64_t* off) {
    int64_t o = 0;
    off[0] = 0;
    char* b = reinterpret_cast<char*>(out);
    for (int64_t i = 0; i < n; ++i) {
        o += style == 0 ? fmt_arrow_float(v[i], b + o)
                        : fmt_py_float(v[i], style == 2, b + o);
        off[i + 1] = o;
    }
    return o;
}

// Floats in Arrow's text (shortest float digits; 32 bytes a value).
int64_t srt_fmt_f32(const float* v, int64_t n, uint8_t* out, int64_t* off) {
    int64_t o = 0;
    off[0] = 0;
    char* b = reinterpret_cast<char*>(out);
    for (int64_t i = 0; i < n; ++i) {
        o += fmt_arrow_float(v[i], b + o);
        off[i + 1] = o;
    }
    return o;
}

// Booleans as true / false (5 bytes a value).
int64_t srt_fmt_bool(const uint8_t* v, int64_t n, uint8_t* out,
                     int64_t* off) {
    int64_t o = 0;
    off[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        const char* w = v[i] ? "true" : "false";
        const int64_t k = v[i] ? 4 : 5;
        std::memcpy(out + o, w, k);
        o += k;
        off[i + 1] = o;
    }
    return o;
}

// Dates as YYYY-MM-DD (16 bytes a value).
int64_t srt_fmt_date(const int32_t* v, int64_t n, uint8_t* out,
                     int64_t* off) {
    int64_t o = 0;
    off[0] = 0;
    char* b = reinterpret_cast<char*>(out);
    for (int64_t i = 0; i < n; ++i) {
        o += fmt_date(v[i], b + o);
        off[i + 1] = o;
    }
    return o;
}

// Timestamps (micros) in fmt_ts's styles (40 bytes a value).
int64_t srt_fmt_ts(const int64_t* v, int64_t n, int32_t style, uint8_t* out,
                   int64_t* off) {
    int64_t o = 0;
    off[0] = 0;
    char* b = reinterpret_cast<char*>(out);
    for (int64_t i = 0; i < n; ++i) {
        o += fmt_ts(v[i], style, b + o);
        off[i + 1] = o;
    }
    return o;
}

// Decimals from (hi, lo) int64 limb pairs, Arrow's text at `scale` (48
// bytes a value); scale < 0 writes the unscaled integer.
int64_t srt_fmt_decimal(const int64_t* limbs, int64_t n, int32_t scale,
                        uint8_t* out, int64_t* off) {
    int64_t o = 0;
    off[0] = 0;
    char* b = reinterpret_cast<char*>(out);
    for (int64_t i = 0; i < n; ++i) {
        const __int128 v = (static_cast<__int128>(limbs[2 * i]) << 64)
            | static_cast<__int128>(static_cast<uint64_t>(limbs[2 * i + 1]));
        o += scale < 0 ? fmt_i128(v, b + o) : fmt_decimal(v, scale, b + o);
        off[i + 1] = o;
    }
    return o;
}

// Escape UTF-8 texts: style 0 CSV (in double quotes, a quote doubled;
// out needs 2 * len + 2), 1 json.dumps (in double quotes, ensure_ascii:
// \" \\ \n \r \t \b \f, other controls and every non-ASCII code point as
// \uxxxx, astral ones as a surrogate pair; out needs 6 * len + 2), 2 Hive
// escape.delim (the escape, the delimiter and \n each preceded by the
// escape; out needs 2 * len).
int64_t srt_escape(const uint8_t* data, const int64_t* off, int64_t n,
                   int32_t style, int32_t delim, int32_t esc, uint8_t* out,
                   int64_t* out_off) {
    static const char hexd[] = "0123456789abcdef";
    int64_t o = 0;
    out_off[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* s = data + off[i];
        const int64_t len = off[i + 1] - off[i];
        if (style == 0) {
            out[o++] = '"';
            for (int64_t j = 0; j < len; ++j) {
                if (s[j] == '"') out[o++] = '"';
                out[o++] = s[j];
            }
            out[o++] = '"';
        } else if (style == 1) {
            out[o++] = '"';
            int64_t j = 0;
            while (j < len) {
                uint32_t cp = s[j];
                int k = 1;
                if (cp >= 0xF0 && j + 3 < len) {
                    cp = ((cp & 0x07) << 18) | ((s[j + 1] & 0x3F) << 12)
                        | ((s[j + 2] & 0x3F) << 6) | (s[j + 3] & 0x3F);
                    k = 4;
                } else if (cp >= 0xE0 && j + 2 < len) {
                    cp = ((cp & 0x0F) << 12) | ((s[j + 1] & 0x3F) << 6)
                        | (s[j + 2] & 0x3F);
                    k = 3;
                } else if (cp >= 0xC0 && j + 1 < len) {
                    cp = ((cp & 0x1F) << 6) | (s[j + 1] & 0x3F);
                    k = 2;
                }
                j += k;
                auto u4 = [&](uint32_t u) {
                    out[o++] = '\\';
                    out[o++] = 'u';
                    out[o++] = hexd[(u >> 12) & 15];
                    out[o++] = hexd[(u >> 8) & 15];
                    out[o++] = hexd[(u >> 4) & 15];
                    out[o++] = hexd[u & 15];
                };
                const char* short_esc = nullptr;
                switch (cp) {
                    case '"': short_esc = "\\\""; break;
                    case '\\': short_esc = "\\\\"; break;
                    case '\n': short_esc = "\\n"; break;
                    case '\r': short_esc = "\\r"; break;
                    case '\t': short_esc = "\\t"; break;
                    case '\b': short_esc = "\\b"; break;
                    case '\f': short_esc = "\\f"; break;
                    default: break;
                }
                if (short_esc) {
                    out[o++] = short_esc[0];
                    out[o++] = short_esc[1];
                } else if (cp < 0x20 || cp > 0x7E) {
                    if (cp >= 0x10000) {
                        const uint32_t v = cp - 0x10000;
                        u4(0xD800 | (v >> 10));
                        u4(0xDC00 | (v & 0x3FF));
                    } else {
                        u4(cp);
                    }
                } else {
                    out[o++] = static_cast<uint8_t>(cp);
                }
            }
            out[o++] = '"';
        } else {
            for (int64_t j = 0; j < len; ++j) {
                const uint8_t c = s[j];
                if (esc >= 0 && (c == esc || c == delim || c == '\n'))
                    out[o++] = static_cast<uint8_t>(esc);
                out[o++] = c;
            }
        }
        out_off[i + 1] = o;
    }
    return o;
}

// Lay out rows: for each row, `open`, then each column's text (or its null
// text, or nothing at all when skip_nulls) preceded by its prefix and, from
// the second written column on, by `sep`; then `close`. valid[c] may be
// null (all valid). With out null, only measures. Returns the length.
int64_t srt_assemble(int32_t ncols, const uint8_t* const* bufs,
                     const int64_t* const* offs, const uint8_t* const* valids,
                     const uint8_t* const* nulltext, const int64_t* nulllen,
                     const uint8_t* const* prefix, const int64_t* prefixlen,
                     int64_t nrows, const uint8_t* open, int64_t openlen,
                     const uint8_t* sep, int64_t seplen, const uint8_t* close,
                     int64_t closelen, int32_t skip_nulls, uint8_t* out) {
    int64_t o = 0;
    auto put = [&](const uint8_t* p, int64_t k) {
        if (out && k) std::memcpy(out + o, p, static_cast<size_t>(k));
        o += k;
    };
    for (int64_t r = 0; r < nrows; ++r) {
        put(open, openlen);
        bool any = false;
        for (int32_t c = 0; c < ncols; ++c) {
            const bool ok = !valids[c] || valids[c][r];
            if (!ok && skip_nulls) continue;
            if (any) put(sep, seplen);
            any = true;
            put(prefix[c], prefixlen[c]);
            if (ok) put(bufs[c] + offs[c][r], offs[c][r + 1] - offs[c][r]);
            else put(nulltext[c], nulllen[c]);
        }
        put(close, closelen);
    }
    return o;
}

}  // extern "C"
