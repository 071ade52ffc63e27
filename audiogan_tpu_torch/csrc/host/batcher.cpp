// The host batcher's row gather (data/corpus.py::HostBatcher), the port's
// copy of the reference's native batch assembly, with its C ABI: the rows
// of the packed int16 corpus [n_clips, store_len] that a step's indices
// select, copied into one contiguous buffer, one memcpy per row, the rows
// split over threads in contiguous ranges. The caller computes the (seed,
// step)-pure indices, so the result is numpy's clips[idx], byte for byte.
//
// Built with g++ into a shared library (kernels/_build.py::build_host) and
// loaded with ctypes (data/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

int32_t ag_batcher_abi_version() { return 1; }

// out[i, :] = clips[idx[i], :] for i in [0, n_idx). Returns n_idx, or -1
// for a null or invalid argument, an out-of-range index among them (all
// checked before any row is copied).
int64_t ag_gather_rows(const int16_t* clips, int64_t n_clips,
                       int64_t store_len, const int64_t* idx, int64_t n_idx,
                       int16_t* out, int32_t n_threads) {
    if (clips == nullptr || idx == nullptr || out == nullptr || n_clips <= 0 ||
        store_len <= 0 || n_idx < 0) {
        return -1;
    }
    for (int64_t i = 0; i < n_idx; ++i) {
        if (idx[i] < 0 || idx[i] >= n_clips) return -1;
    }
    const size_t row_bytes = static_cast<size_t>(store_len) * sizeof(int16_t);
    auto copy_range = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            std::memcpy(out + i * store_len, clips + idx[i] * store_len,
                        row_bytes);
        }
    };
    const int64_t want = n_threads > 0
                             ? n_threads
                             : static_cast<int64_t>(std::max(
                                   1u, std::thread::hardware_concurrency()));
    const int64_t workers = std::max<int64_t>(1, std::min(want, n_idx));
    if (workers == 1) {
        copy_range(0, n_idx);
        return n_idx;
    }
    std::vector<std::thread> pool;
    pool.reserve(workers);
    const int64_t chunk = (n_idx + workers - 1) / workers;
    for (int64_t w = 0; w < workers; ++w) {
        const int64_t lo = w * chunk;
        const int64_t hi = std::min(n_idx, lo + chunk);
        if (lo >= hi) break;
        pool.emplace_back(copy_range, lo, hi);
    }
    for (auto& t : pool) t.join();
    return n_idx;
}

}  // extern "C"
