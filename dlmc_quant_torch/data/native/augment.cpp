// Host batch assembly for dlmc_quant_torch's array datasets.
//
// One threaded pass fuses what the numpy path does in five: gather (fancy
// index) -> 1/255 scale -> zero-pad random crop -> horizontal flip ->
// mean/std normalize, writing float32 NHWC.
//
// Crop offsets and flip decisions are drawn by the caller from its numpy
// Generator and passed in.  Every float operation is the numpy path's, in
// its order: x / 255, then (x - mean) / std, each a correctly rounded
// float32 division, so the two paths give the same bits.  (Multiplying by
// 1/std instead, as the JAX package's copy does, moves a value by up to
// one ulp.)
//
// Build (done at first use by native/__init__.py, into native/_build/):
//   g++ -O3 -shared -fPIC -std=c++17 -o libdlmcq_data_<hash>.so \
//       augment.cpp -lpthread
// ABI: plain C, loaded through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct AugArgs {
    const void*    images;     // (n_total, h, w, c) uint8 or float32
    int            is_u8;
    int64_t        h, w, c;
    const int64_t* idx;        // (n,) gather indices
    int64_t        n;
    int            pad;        // zero-pad width (0 = no crop)
    const int32_t* oy;         // (n,) crop offsets in [0, 2*pad]
    const int32_t* ox;
    const uint8_t* flip;       // (n,) 1 = horizontal flip
    const float*   mean;       // (c,) or nullptr
    const float*   stdv;       // (c,)
    int            scale255;   // divide by 255 (u8-range inputs)
    float*         out;        // (n, h, w, c) float32
};

template <typename T>
inline float to_f32(T v, bool scale255) {
    return scale255 ? float(v) / 255.0f : float(v);
}

template <typename T>
void augment_range(const AugArgs& a, int64_t lo, int64_t hi) {
    const int64_t h = a.h, w = a.w, c = a.c;
    const int64_t row = w * c, img_sz = h * row;
    const bool s255 = a.scale255 != 0;
    const int p = a.pad;
    for (int64_t i = lo; i < hi; ++i) {
        const T* img = static_cast<const T*>(a.images) + a.idx[i] * img_sz;
        float* dst = a.out + i * img_sz;
        const bool flip = a.flip && a.flip[i];
        // the crop window in padded coordinates: rows [oy, oy + h) of the
        // (h + 2p, w + 2p) zero-padded image are source rows [oy - p, ...)
        const int64_t oy = p ? a.oy[i] - p : 0, ox = p ? a.ox[i] - p : 0;
        // the visible source columns [x0, x1) in output coordinates
        const int64_t x0 = std::max<int64_t>(0, -ox);
        const int64_t x1 = std::min<int64_t>(w, w - ox);
        for (int64_t y = 0; y < h; ++y) {
            float* drow = dst + y * row;
            const int64_t sy = y + oy;
            if (sy < 0 || sy >= h || x1 <= x0) {
                std::memset(drow, 0, sizeof(float) * row);
                continue;
            }
            const T* srow = img + sy * row;
            std::memset(drow, 0, sizeof(float) * x0 * c);
            std::memset(drow + x1 * c, 0, sizeof(float) * (w - x1) * c);
            const T* s = srow + (x0 + ox) * c;
            for (int64_t j = 0; j < (x1 - x0) * c; ++j)
                drow[x0 * c + j] = to_f32(s[j], s255);
            if (flip) {
                for (int64_t x = 0; x < w / 2; ++x)
                    for (int64_t k = 0; k < c; ++k)
                        std::swap(drow[x * c + k], drow[(w - 1 - x) * c + k]);
            }
        }
        if (a.mean) {
            for (int64_t j = 0; j < img_sz; ++j) {
                const int64_t k = j % c;
                dst[j] = (dst[j] - a.mean[k]) / a.stdv[k];
            }
        }
    }
}

void run(const AugArgs& a, int64_t lo, int64_t hi) {
    if (a.is_u8) augment_range<uint8_t>(a, lo, hi);
    else         augment_range<float>(a, lo, hi);
}

}  // namespace

extern "C" {

// Returns 0 on success.
int dlmcq_augment(const void* images, int is_u8, int64_t h, int64_t w,
                  int64_t c, const int64_t* idx, int64_t n, int pad,
                  const int32_t* oy, const int32_t* ox, const uint8_t* flip,
                  const float* mean, const float* stdv, int scale255,
                  int n_threads, float* out) {
    const AugArgs a{images, is_u8, h, w, c, idx, n, pad, oy, ox, flip,
                    mean, stdv, scale255, out};
    if (n_threads <= 1 || n < 2 * n_threads) {
        run(a, 0, n);
        return 0;
    }
    std::vector<std::thread> ts;
    const int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int64_t lo = 0; lo < n; lo += chunk) {
        const int64_t hi = std::min<int64_t>(n, lo + chunk);
        ts.emplace_back([&a, lo, hi] { run(a, lo, hi); });
    }
    for (auto& t : ts) t.join();
    return 0;
}

// The ABI's version, checked by the Python side.
int dlmcq_abi_version() { return 1; }

}  // extern "C"
