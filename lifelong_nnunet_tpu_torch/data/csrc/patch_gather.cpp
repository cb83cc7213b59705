// Patch gather of the training input pipeline, on the host.
//
// Extracts training patches from float32 case arrays ([C+1, X, Y, Z], C
// contiguous modalities then the segmentation channel, usually memmapped)
// into a channels-first batch: data [B, C, px, py, pz] float32 and seg
// [B, px, py, pz] int8.  Out-of-volume voxels are 0 (data) and -1 (seg),
// and the seg value is the float cast to int8, as the numpy path of
// data/sampler.py computes them.  The batch's samples are shared out over
// std::threads; nothing here touches Python, so the caller (ctypes, which
// releases the interpreter lock) runs it beside the train step.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Job {
    const float* src;      // [C+1, X, Y, Z] contiguous
    int64_t shape[4];      // C+1, X, Y, Z
    int64_t origin[3];     // may be negative or past the end (padding)
    int64_t patch[3];
    float* out_data;       // [C, px, py, pz]
    int8_t* out_seg;       // [px, py, pz]
};

void gather_one(const Job& j) {
    const int64_t X = j.shape[1], Y = j.shape[2], Z = j.shape[3];
    const int64_t n_mod = j.shape[0] - 1;
    const int64_t px = j.patch[0], py = j.patch[1], pz = j.patch[2];
    const int64_t plane = Y * Z, vol = X * plane, out_vol = px * py * pz;
    const int64_t z0 = j.origin[2];
    const int64_t lo = std::min<int64_t>(pz, std::max<int64_t>(0, -z0));
    const int64_t hi = std::max<int64_t>(lo, std::min<int64_t>(pz, Z - z0));

    for (int64_t i = 0; i < px; ++i) {
        const int64_t sx = j.origin[0] + i;
        for (int64_t jy = 0; jy < py; ++jy) {
            const int64_t sy = j.origin[1] + jy;
            const int64_t row = (i * py + jy) * pz;
            int8_t* ds = j.out_seg + row;
            const bool inside = sx >= 0 && sx < X && sy >= 0 && sy < Y && lo < hi;
            if (!inside) {
                for (int64_t c = 0; c < n_mod; ++c)
                    std::memset(j.out_data + c * out_vol + row, 0, sizeof(float) * pz);
                std::memset(ds, 0xFF, pz);  // -1
                continue;
            }
            const int64_t base = sx * plane + sy * Z + z0;
            for (int64_t c = 0; c < n_mod; ++c) {
                float* dd = j.out_data + c * out_vol + row;
                std::memset(dd, 0, sizeof(float) * lo);
                std::memcpy(dd + lo, j.src + c * vol + base + lo, sizeof(float) * (hi - lo));
                std::memset(dd + hi, 0, sizeof(float) * (pz - hi));
            }
            const float* sg = j.src + n_mod * vol + base;
            std::memset(ds, 0xFF, lo);
            for (int64_t k = lo; k < hi; ++k) ds[k] = static_cast<int8_t>(sg[k]);
            std::memset(ds + hi, 0xFF, pz - hi);
        }
    }
}

}  // namespace

extern "C" {

// case_ptrs:   [B] pointers to the samples' case arrays
// case_shapes: [B * 4] (C+1, X, Y, Z) of each; every case has the same C
// origins:     [B * 3] signed patch origins
// patch:       [3]
// out_data:    [B, C, px, py, pz] float32
// out_seg:     [B, px, py, pz] int8
void gather_patches_cf(const float* const* case_ptrs, const int64_t* case_shapes,
                       const int64_t* origins, const int64_t* patch,
                       int64_t num_samples, int64_t n_threads,
                       float* out_data, int8_t* out_seg) {
    const int64_t sstride = patch[0] * patch[1] * patch[2];
    const int64_t dstride = (case_shapes[0] - 1) * sstride;
    std::vector<Job> jobs(num_samples);
    for (int64_t b = 0; b < num_samples; ++b) {
        Job& j = jobs[b];
        j.src = case_ptrs[b];
        for (int d = 0; d < 4; ++d) j.shape[d] = case_shapes[b * 4 + d];
        for (int d = 0; d < 3; ++d) {
            j.origin[d] = origins[b * 3 + d];
            j.patch[d] = patch[d];
        }
        j.out_data = out_data + b * dstride;
        j.out_seg = out_seg + b * sstride;
    }
    const int64_t nt = std::min<int64_t>(std::max<int64_t>(1, n_threads), num_samples);
    if (nt <= 1) {
        for (const auto& j : jobs) gather_one(j);
        return;
    }
    std::atomic<int64_t> next(0);
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int64_t t = 0; t < nt; ++t) {
        threads.emplace_back([&jobs, &next]() {
            for (int64_t i = next.fetch_add(1); i < static_cast<int64_t>(jobs.size());
                 i = next.fetch_add(1))
                gather_one(jobs[i]);
        });
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
