// Native string dictionary codec (a copy of the repo-root
// native/strcodec.cpp for spark_rapids_tpu_torch).
//
// The host-side ORDER-PRESERVING dictionary encode
// (columnar/column.py encode_sorted_dict) ranks the distinct strings of a
// column here once there are many of them. The Python side converts the object array to numpy's
// fixed-width UTF-32 representation in C (astype('U')); this codec sorts
// row indices by code-point order (== UTF-8 byte order == Spark's
// UTF8String.compareTo order), dedupes, and assigns dictionary codes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC, at first use, by
// spark_rapids_tpu_torch/native/__init__.py into the package's _build/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// `chars` is an (n x width) row-major array of UTF-32 code points with
// NUL padding (numpy 'U' layout). Outputs: codes[i] = dictionary code of
// row i; dict_row[k] = a row index holding dictionary entry k. Returns
// the dictionary size, or -1 on error.
int64_t encode_sorted_dict_u32(const uint32_t* chars,
                               int64_t n,
                               int64_t width,
                               int32_t* codes,
                               int64_t* dict_row) {
    if (n <= 0) return 0;
    std::vector<int32_t> order(static_cast<size_t>(n));
    std::iota(order.begin(), order.end(), 0);

    const uint32_t* base = chars;
    auto cmp = [base, width](int32_t a, int32_t b) {
        const uint32_t* pa = base + static_cast<int64_t>(a) * width;
        const uint32_t* pb = base + static_cast<int64_t>(b) * width;
        for (int64_t k = 0; k < width; ++k) {
            if (pa[k] != pb[k]) return pa[k] < pb[k];
        }
        return false;
    };
    std::sort(order.begin(), order.end(), cmp);

    auto eq = [base, width](int32_t a, int32_t b) {
        return std::memcmp(base + static_cast<int64_t>(a) * width,
                           base + static_cast<int64_t>(b) * width,
                           static_cast<size_t>(width) * 4) == 0;
    };

    int64_t ndict = 0;
    int32_t prev_row = -1;
    for (int64_t j = 0; j < n; ++j) {
        const int32_t row = order[j];
        if (prev_row < 0 || !eq(row, prev_row)) {
            dict_row[ndict++] = row;
            prev_row = row;
        }
        codes[row] = static_cast<int32_t>(ndict - 1);
    }
    return ndict;
}

}  // extern "C"
