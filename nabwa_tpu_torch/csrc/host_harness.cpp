// Host build of the kernels' per-row code, for the CPU tests: the same
// NABWA_HD source that nvcc compiles into kernels C1 (dfs.cu), C2
// (cal_width.cu), C3 (sa_lookup.cu), C4 (banded_global.cu), C5
// (local_fwd.cu) and C6 (extend.cu), compiled by a host C++ compiler and
// run row by row with the kernels' argument layouts; and the probe
// kernels' helpers (probes.cuh: the int32 arithmetic, C8's row indices,
// C9's and C10's counts and expansion), one value at a time.  It is not
// part of the kernel library.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libhost.so host_harness.cpp

#include <vector>

#include "dfs_read.cuh"
#include "dp_global.cuh"
#include "extend.cuh"
#include "local_sw.cuh"
#include "probes.cuh"

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

extern "C" int nabwa_host_sa_lookup(const uint32_t* params, const void* bank,
                                    const void* sa, uint32_t intv,
                                    const void* rows, int n, void* out) {
    const nabwa::FmParams p = nabwa::fm_params(params);
    for (int i = 0; i < n; ++i)
        ((uint32_t*)out)[i] = nabwa::sa_lookup_row(
            p, (const uint32_t*)bank, (const uint32_t*)sa, intv,
            ((const uint32_t*)rows)[i]);
    return 0;
}

extern "C" int nabwa_host_banded_global(const int32_t* params,
                                        const void* s1, const void* s2,
                                        const void* len1, const void* len2,
                                        const void* b1, const void* b2,
                                        int B, int L1, int L2, void* tb,
                                        void* score, void* ctype) {
    const nabwa::DpParams p = nabwa::dp_params(params);
    std::vector<int32_t> state(3 * ((size_t)L1 + 1));
    for (int b = 0; b < B; ++b) {
        nabwa::DpPair q;
        q.s1 = (const int32_t*)s1 + (size_t)b * (L1 + 1);
        q.s2 = (const int32_t*)s2 + (size_t)b * (L2 + 1);
        q.len1 = ((const int32_t*)len1)[b];
        q.len2 = ((const int32_t*)len2)[b];
        q.b1 = ((const int32_t*)b1)[b];
        q.b2 = ((const int32_t*)b2)[b];
        q.M = state.data();
        q.I = q.M + L1 + 1;
        q.D = q.I + L1 + 1;
        q.stride = 1;
        q.tb = (uint8_t*)tb + (size_t)b * (L2 + 1) * (L1 + 1);
        nabwa::banded_global_pair(p, L1, L2, q, (int32_t*)score + b,
                                  (int32_t*)ctype + b);
    }
    return 0;
}

extern "C" int nabwa_host_local_fwd(const int32_t* params, const void* s1,
                                    const void* s2, const void* len1,
                                    const void* len2, int B, int L1, int L2,
                                    void* score, void* end_i, void* end_j) {
    const nabwa::LocalParams p = nabwa::local_params(params);
    std::vector<int32_t> state(2 * ((size_t)L1 + 1));
    for (int b = 0; b < B; ++b)
        nabwa::local_fwd_pair(
            p, (const int32_t*)s1 + (size_t)b * (L1 + 1),
            ((const int32_t*)len1)[b],
            (const int32_t*)s2 + (size_t)b * (L2 + 1),
            ((const int32_t*)len2)[b], state.data(), state.data() + L1 + 1,
            1, (int32_t*)score + b, (int32_t*)end_i + b,
            (int32_t*)end_j + b);
    return 0;
}

extern "C" int nabwa_host_extend(const int32_t* params, const void* s1,
                                 const void* s2, const void* len1,
                                 const void* len2, const void* g0,
                                 const void* bw, int B, int L1, int L2,
                                 void* score, void* end_i, void* end_j,
                                 void* cells) {
    const nabwa::ExtendParams p = nabwa::extend_params(params);
    std::vector<int32_t> state(2 * ((size_t)L1 + 2));
    for (int b = 0; b < B; ++b)
        nabwa::extend_job(
            p, (const int32_t*)s1 + (size_t)b * (L1 + 2),
            ((const int32_t*)len1)[b],
            (const int32_t*)s2 + (size_t)b * (L2 + 1),
            ((const int32_t*)len2)[b], ((const int32_t*)g0)[b],
            ((const int32_t*)bw)[b], state.data(), state.data() + L1 + 2, 1,
            (int32_t*)score + b, (int32_t*)end_i + b, (int32_t*)end_j + b,
            (int32_t*)cells + b);
    return 0;
}

namespace pr = nabwa::probe;

// The probe kernels' helpers (probes.cuh), one value at a time over n
// values.  op: 0 wadd, 1 wsub, 2 wmul, 3 floor_mod (b > 0).
extern "C" int nabwa_host_probe_binop(int op, const int32_t* a,
                                      const int32_t* b, int n,
                                      int32_t* out) {
    if (op < 0 || op > 3) return 1;
    for (int i = 0; i < n; ++i)
        out[i] = op == 0   ? pr::wadd(a[i], b[i])
                 : op == 1 ? pr::wsub(a[i], b[i])
                 : op == 2 ? pr::wmul(a[i], b[i])
                           : pr::floor_mod(a[i], b[i]);
    return 0;
}

extern "C" int nabwa_host_probe_lcg_next(const int32_t* s, int n,
                                         int32_t* out) {
    for (int i = 0; i < n; ++i) out[i] = pr::lcg_next(s[i]);
    return 0;
}

extern "C" int nabwa_host_probe_dma_vec_row(const int32_t* c,
                                            const int32_t* t,
                                            const int32_t* n_rows, int n,
                                            int32_t* out) {
    for (int i = 0; i < n; ++i)
        out[i] = pr::dma_vec_row(c[i], t[i], n_rows[i]);
    return 0;
}

extern "C" int nabwa_host_probe_shape_word_count(const int32_t* x,
                                                 const int32_t* w,
                                                 const int32_t* w0,
                                                 const int32_t* w1, int n,
                                                 int32_t* out) {
    for (int i = 0; i < n; ++i)
        out[i] = pr::shape_word_count(x[i], w[i], w0[i], w1[i]);
    return 0;
}

extern "C" int nabwa_host_probe_shape_expand(const int32_t* e0,
                                             const int32_t* e1,
                                             const int32_t* cnt_k,
                                             const int32_t* cnt_l, int n,
                                             int32_t* a, int32_t* b) {
    for (int i = 0; i < n; ++i)
        pr::shape_expand(e0[i], e1[i], cnt_k[i], cnt_l[i], a + i, b + i);
    return 0;
}

// each word's counts alone (from 0)
extern "C" int nabwa_host_probe_pallas_word_counts(const int32_t* x, int n,
                                                   int32_t* c1,
                                                   int32_t* c3) {
    for (int i = 0; i < n; ++i) {
        uint32_t u1 = 0, u3 = 0;
        pr::pallas_word_counts(x[i], &u1, &u3);
        c1[i] = (int32_t)u1;
        c3[i] = (int32_t)u3;
    }
    return 0;
}
