// Native host-side scan, pack and encode kernels for coverage uploads.
//
// This package's copy of degnorm_tpu/io/native/pack_kernel.cpp.  The
// engine packs integral coverage into int16 buckets (data/buckets.py):
// dn_int16able_many decides whether every matrix qualifies, in one threaded
// pass, and dn_pack_i16 casts the ragged matrices into the padded bucket.
// dn_nib_encode is a 4-bit delta encoder of an int16 bucket (position-axis
// deltas of pileup coverage almost always fit 4 bits); chip_smoke.py phase
// upload times it, with the device decode, against the direct upload the
// engine uses (the encoded upload lost there; PERF.md).  numpy
// (data/buckets.py, data/encode.py) remains the semantic source of truth
// of the scan and the pack; tests assert byte-equality.
//
// C ABI via ctypes; all buffers are caller-allocated numpy arrays.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Exc {
    int64_t idx;
    int32_t val;
};

}  // namespace

extern "C" {

// All values integral and in [0, 32766]?  (data/encode.py::int16able)
int dn_f32_int16able(const float* x, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        float v = x[i];
        if (!(v >= 0.0f && v < 32767.0f) || (float)(int64_t)v != v)
            return 0;
    }
    return 1;
}

int dn_f64_int16able(const double* x, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        double v = x[i];
        if (!(v >= 0.0 && v < 32767.0) || (double)(int64_t)v != v)
            return 0;
    }
    return 1;
}

// Batched scan over many ragged arrays in one call (one ctypes call per
// gene costs more than the scan itself at 20k+ genes).  dtype_code:
// 0 = float32, 1 = float64.  Early-exits across threads on first failure.
int dn_int16able_many(const void* const* ptrs, const int64_t* sizes,
                      int64_t n_arrays, int dtype_code, int n_threads) {
    std::atomic<bool> bad{false};
    n_threads = std::max(1, std::min(n_threads, 16));
    if (n_arrays < n_threads) n_threads = (int)std::max<int64_t>(n_arrays, 1);
    auto work = [&](int t) {
        int64_t a0 = n_arrays * t / n_threads;
        int64_t a1 = n_arrays * (t + 1) / n_threads;
        for (int64_t a = a0; a < a1; a++) {
            if (bad.load(std::memory_order_relaxed)) return;
            int ok = dtype_code == 0
                ? dn_f32_int16able((const float*)ptrs[a], sizes[a])
                : dn_f64_int16able((const double*)ptrs[a], sizes[a]);
            if (!ok) {
                bad.store(true, std::memory_order_relaxed);
                return;
            }
        }
    };
    if (n_threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < n_threads; t++) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }
    return bad.load() ? 0 : 1;
}

// Cast-pack ragged float coverage matrices into one padded int16 bucket:
// out[g, s, 0:lens[g]] = (int16) mats[g][s, :].  dtype_code: 0 = float32,
// 1 = float64.  Values must already be validated int16able
// (dn_int16able_many); padding stays untouched (caller provides calloc'd
// zeros, so unwritten pages are never faulted in).
void dn_pack_i16(const void* const* ptrs, const int64_t* lens,
                 int64_t n_genes, int64_t p, int64_t W, int dtype_code,
                 int16_t* out, int n_threads) {
    n_threads = std::max(1, std::min(n_threads, 16));
    if (n_genes < n_threads) n_threads = (int)std::max<int64_t>(n_genes, 1);
    auto work = [&](int t) {
        int64_t g0 = n_genes * t / n_threads;
        int64_t g1 = n_genes * (t + 1) / n_threads;
        for (int64_t g = g0; g < g1; g++) {
            const int64_t L = lens[g];
            for (int64_t s = 0; s < p; s++) {
                int16_t* dst = out + (g * p + s) * W;
                if (dtype_code == 0) {
                    const float* src = (const float*)ptrs[g] + s * L;
                    for (int64_t j = 0; j < L; j++)
                        dst[j] = (int16_t)src[j];
                } else {
                    const double* src = (const double*)ptrs[g] + s * L;
                    for (int64_t j = 0; j < L; j++)
                        dst[j] = (int16_t)src[j];
                }
            }
        }
    };
    if (n_threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < n_threads; t++) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }
}

// 4-bit delta encode of an int16 (G, p, W) coverage bucket (leading g_enc
// genes; trailing padding genes are all-zero and left untouched — caller
// provides calloc'd outputs).
//
//   first:   (G, p) int16        — column 0
//   nib:     (G, p, (W-1+1)/2) uint8 — two clipped deltas per byte, low
//            nibble = even delta index (chip_smoke.py::nib_decode reads
//            it so)
//   exc_idx: (exc_cap,) int64    — flat indices into the (G, p, W-1)
//            delta space for deltas outside [-8, 7]
//   exc_val: (exc_cap,) int32    — true_delta - clipped_delta
//
// Returns the exception count, or -1 when it would exceed exc_cap.
int64_t dn_nib_encode(const int16_t* F, int64_t g_enc, int64_t p, int64_t W,
                      int16_t* first, uint8_t* nib,
                      int64_t* exc_idx, int32_t* exc_val, int64_t exc_cap,
                      int n_threads) {
    if (W < 2 || g_enc <= 0) return 0;
    const int64_t Wm1 = W - 1;
    const int64_t nb = (Wm1 + 1) / 2;
    n_threads = std::max(1, std::min(n_threads, 16));
    if (g_enc < n_threads) n_threads = (int)g_enc;

    std::vector<std::vector<Exc>> excs(n_threads);
    std::atomic<bool> over{false};

    auto work = [&](int t) {
        int64_t g0 = g_enc * t / n_threads;
        int64_t g1 = g_enc * (t + 1) / n_threads;
        auto& local = excs[t];
        for (int64_t g = g0; g < g1 && !over.load(std::memory_order_relaxed);
             g++) {
            for (int64_t s = 0; s < p; s++) {
                const int64_t r = g * p + s;
                const int16_t* row = F + r * W;
                first[r] = row[0];
                uint8_t* out = nib + r * nb;
                const int64_t base = r * Wm1;
                uint8_t byte = 0;
                int16_t prev = row[0];
                for (int64_t j = 0; j < Wm1; j++) {
                    const int16_t cur = row[j + 1];
                    const int32_t d = (int32_t)cur - (int32_t)prev;
                    prev = cur;
                    int32_t c = d < -8 ? -8 : (d > 7 ? 7 : d);
                    if (c != d) local.push_back({base + j, d - c});
                    byte |= (uint8_t)(c & 0xF) << ((j & 1) * 4);
                    if (j & 1) {
                        out[j >> 1] = byte;
                        byte = 0;
                    }
                }
                if (Wm1 & 1) out[Wm1 >> 1] = byte;
                if ((int64_t)local.size() > exc_cap)
                    over.store(true, std::memory_order_relaxed);
            }
        }
    };

    if (n_threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < n_threads; t++) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }

    int64_t total = 0;
    for (auto& v : excs) total += (int64_t)v.size();
    if (over.load() || total > exc_cap) return -1;
    int64_t k = 0;
    for (auto& v : excs)        // thread ranges are ordered -> deterministic
        for (const Exc& e : v) {
            exc_idx[k] = e.idx;
            exc_val[k] = e.val;
            k++;
        }
    return total;
}

}  // extern "C"
