// Host build of the kernels' per-row code, for the CPU tests: the same
// NABWA_HD source that nvcc compiles into kernels C1 (dfs.cu) and C2
// (cal_width.cu), compiled by a host C++ compiler and run row by row with
// the kernels' argument layouts.  It is not part of the kernel library.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libhost.so host_harness.cpp

#include "dfs_read.cuh"

extern "C" int nabwa_host_occ4(const void* bank, uint32_t primary,
                               const void* ks, int n, void* out) {
    for (int i = 0; i < n; ++i)
        nabwa::occ4((const uint32_t*)bank, primary, ((const uint32_t*)ks)[i],
                    (uint32_t*)out + 4 * (size_t)i);
    return 0;
}

extern "C" int nabwa_host_cal_width(const uint32_t* params, const void* bwt,
                                    const void* queries, const void* lengths,
                                    int B, int L, void* width, void* bid) {
    const nabwa::FmParams p = nabwa::fm_params(params);
    for (int row = 0; row < B; ++row)
        nabwa::cal_width_row(
            p, (const uint32_t*)bwt, (const int32_t*)queries + (size_t)row * L,
            ((const int32_t*)lengths)[row], L,
            (int32_t*)width + (size_t)row * (L + 1),
            (int32_t*)bid + (size_t)row * (L + 1));
    return 0;
}

extern "C" int nabwa_host_dfs(const uint32_t* params, const void* bwt_cat,
                              const void* seqs, const void* lengths,
                              const void* widths, const void* bids,
                              const void* seed_widths, const void* seed_bids,
                              const void* has_seed, const void* max_diff,
                              void* slots, void* planes, void* out, int B) {
    const nabwa::DfsParams p = nabwa::dfs_params(params);
    for (int b = 0; b < B; ++b)
        nabwa::dfs_read(
            p, (const uint32_t*)bwt_cat,
            nabwa::read_io(p, (const int32_t*)seqs, (const int32_t*)lengths,
                           (const int32_t*)widths, (const int32_t*)bids,
                           (const int32_t*)seed_widths,
                           (const int32_t*)seed_bids,
                           (const int32_t*)has_seed,
                           (const int32_t*)max_diff, (int32_t*)slots,
                           (int32_t*)planes, (int32_t*)out, b, B));
    return 0;
}
