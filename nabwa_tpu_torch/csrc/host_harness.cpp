// Host build of the kernels' per-row code, for the CPU tests: the same
// NABWA_HD source that nvcc compiles into kernels C1 (dfs.cu), C2
// (cal_width.cu), C3 (sa_lookup.cu), C4 (banded_global.cu), C5
// (local_fwd.cu) and C6 (extend.cu), compiled by a host C++ compiler and
// run row by row with the kernels' argument layouts, C1's, C4's, C5's and
// C6's warp kernels and C2's lane groups also lane by lane (the `_lanes`
// and `_group` entry points; the serial forms stay as their oracles); and
// the probe
// kernels' helpers (probes.cuh: the int32 arithmetic, C8's row indices,
// C9's and C10's counts and expansion, C9's lean counts and push, C12's
// grid and the row each warp copies at each step, C13's slot of a pop,
// C16's
// popcount, C17's and C18's slot of a round, C19's step of a body, C21's
// pushed fields, C23's value update and its lane form's groups, C24's
// step, C25's and C26's steps, C30's source int4, C32's rotation source,
// C34's trip count and its grid form's threads), one value at a time.
// It is not part of the kernel library.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libhost.so host_harness.cpp

#include <algorithm>
#include <vector>

#include "dfs_read.cuh"
#include "dfs_warp.cuh"
#include "dp_global.cuh"
#include "extend.cuh"
#include "local_sw.cuh"
#include "probes.cuh"
#include "sa_walk.cuh"

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

// occ4(bank, primary, k)[c] as a half of a C2 group counts it: the parts
// of its CAL_WIDTH_HALF lanes summed
extern "C" int nabwa_host_occ_group(const void* bank, uint32_t primary,
                                    const void* ks, const void* cs, int n,
                                    void* out) {
    for (int i = 0; i < n; ++i) {
        uint32_t sum = 0;
        for (int sub = 0; sub < nabwa::CAL_WIDTH_HALF; ++sub)
            sum += nabwa::occ_lane_part(
                (const uint32_t*)bank, primary, ((const uint32_t*)ks)[i],
                ((const uint32_t*)cs)[i], sub);
        ((uint32_t*)out)[i] = sum;
    }
    return 0;
}

// C2's lane groups (cal_width.cu) lane by lane: each step, every lane's
// part of the two counts (`occ_lane_part`, lane g of G on side g / H),
// each half's parts summed as the group's shuffles sum them, every lane's
// interval moved by the two counts, lane i mod G writing column i.
extern "C" int nabwa_host_cal_width_group(const uint32_t* params,
                                          const void* bwt,
                                          const void* queries,
                                          const void* lengths, int B, int L,
                                          void* width, void* bid) {
    constexpr int G = nabwa::CAL_WIDTH_GROUP, H = nabwa::CAL_WIDTH_HALF;
    const nabwa::FmParams p = nabwa::fm_params(params);
    uint32_t k[G], l[G], part[G];
    int32_t cur[G];
    for (int row = 0; row < B; ++row) {
        const int32_t* q = (const int32_t*)queries + (size_t)row * L;
        const int len = ((const int32_t*)lengths)[row];
        int32_t* wo = (int32_t*)width + (size_t)row * (L + 1);
        int32_t* bo = (int32_t*)bid + (size_t)row * (L + 1);
        for (int g = 0; g < G; ++g) {
            k[g] = 0;
            l[g] = p.seq_len;
            cur[g] = 0;
        }
        for (int i = 0; i <= L; ++i) {
            if (i < L) {
                const int c = i < len ? q[i] : 4;
                for (int g = 0; g < G; ++g)
                    part[g] = nabwa::cal_width_looks_up(i, len, c)
                        ? nabwa::occ_lane_part(
                              (const uint32_t*)bwt, p.primary,
                              g / H ? l[g] : k[g] - 1u, (uint32_t)c, g % H)
                        : 0;
                uint32_t ok = 0, ol = 0;
                for (int g = 0; g < H; ++g) {
                    ok += part[g];
                    ol += part[H + g];
                }
                for (int g = 0; g < G; ++g)
                    nabwa::cal_width_advance(p, i, len, c, ok, ol, &k[g],
                                             &l[g], &cur[g]);
            }
            const int g = i % G;
            nabwa::cal_width_column(i, len, L, k[g], l[g], cur[g], wo + i,
                                    bo + i);
        }
    }
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

// C1's warp kernel (dfs.cu) lane by lane: `dfs_read_warp` with nl lanes
// run one after another in lane order, their values combined as the
// warp's intrinsics combine them (a shuffle reads lane src's value, ballot
// bit l is lane l's).
struct HostWarp {
    int nl;

    template <class T>
    struct Val {
        T v[32];
        T& operator[](int i) { return v[i]; }
        const T& operator[](int i) const { return v[i]; }
    };

    int lanes() const { return nl; }

    template <class F>
    void each(F f) const {
        for (int l = 0; l < nl; ++l) f(l);
    }

    int32_t min(const Val<int32_t>& x) const {
        int32_t m = x[0];
        for (int l = 1; l < nl; ++l) m = std::min(m, x[l]);
        return m;
    }

    int sum(const Val<int>& x) const {
        int s = 0;
        for (int l = 0; l < nl; ++l) s += x[l];
        return s;
    }

    bool any(const Val<bool>& x) const {
        bool a = false;
        for (int l = 0; l < nl; ++l) a |= x[l];
        return a;
    }

    uint32_t ballot(const Val<bool>& x) const {
        uint32_t m = 0;
        for (int l = 0; l < nl; ++l) m |= (uint32_t)x[l] << l;
        return m;
    }

    int first_lane(uint32_t mask) const { return __builtin_ffs(mask) - 1; }

    int shfl(const Val<int>& x, int src) const { return x[src]; }

    void sync() const {}

    struct OccLoad {
        const uint32_t* bank;
        uint32_t prim, k, l;
    };

    OccLoad occ_load(const uint32_t* bank, uint32_t prim, uint32_t k,
                     uint32_t l) const {
        return OccLoad{bank, prim, k, l};
    }

    void occ_count(const OccLoad& o, uint32_t ck4[4], uint32_t cl4[4]) const {
        nabwa::occ4(o.bank, o.prim, o.k, ck4);
        nabwa::occ4(o.bank, o.prim, o.l, cl4);
    }
};

// nl lanes (1..32).  form 0: one state buffer that every read reuses, as
// a block's warps reuse their share of shared memory; form 1: a region a
// read in one scratch, as in device memory.  Both start as junk, so a read
// of state the search did not write first shows in the result.
extern "C" int nabwa_host_dfs_lanes(const uint32_t* params,
                                    const void* bwt_cat, const void* seqs,
                                    const void* lengths, const void* widths,
                                    const void* bids, const void* seed_widths,
                                    const void* seed_bids,
                                    const void* has_seed,
                                    const void* max_diff, void* out, int B,
                                    int nl, int form) {
    if (nl < 1 || nl > 32 || (form != 0 && form != 1)) return 1;
    const nabwa::DfsParams p = nabwa::dfs_params(params);
    const size_t words = nabwa::dfs_state_bytes(p) / 4;
    std::vector<int32_t> state(words * (form ? std::max(B, 1) : 1));
    uint32_t junk = 0x9E3779B9u;
    for (int32_t& v : state) {
        junk = junk * 1664525u + 1013904223u;
        v = (int32_t)junk;
    }
    for (int b = 0; b < B; ++b)
        nabwa::dfs_read_warp(
            HostWarp{nl}, p, (const uint32_t*)bwt_cat,
            nabwa::warp_io(p, (const int32_t*)seqs, (const int32_t*)lengths,
                           (const int32_t*)widths, (const int32_t*)bids,
                           (const int32_t*)seed_widths,
                           (const int32_t*)seed_bids,
                           (const int32_t*)has_seed,
                           (const int32_t*)max_diff,
                           state.data() + (form ? words * b : 0),
                           (int32_t*)out, b));
    return 0;
}

// bytes of one read's state at these parameters (dfs_state_bytes)
extern "C" long long nabwa_host_dfs_state_bytes(const uint32_t* params) {
    return (long long)nabwa::dfs_state_bytes(nabwa::dfs_params(params));
}

// C3 with the kernel's argument layout (nabwa_sa_lookup).
extern "C" int nabwa_host_sa_lookup(const uint32_t* params, const void* bank0,
                                    const void* bank1, const void* sa0,
                                    const void* sa1, uint32_t intv,
                                    const void* rows, int n, int n0,
                                    void* out) {
    const nabwa::SaStrand st[2] = {
        {(const uint32_t*)bank0, (const uint32_t*)sa0, params[4]},
        {(const uint32_t*)bank1, (const uint32_t*)sa1, params[5]}};
    const uint32_t l2[4] = {params[0], params[1], params[2], params[3]};
    const uint32_t* r = (const uint32_t*)rows;
    uint32_t* o = (uint32_t*)out;
    for (int i = 0; i < n; ++i) {
        const nabwa::SaStrand& s = st[i < n0 ? 0 : 1];
        o[i] = nabwa::is_pow2(intv)
            ? nabwa::sa_walk_row(s, l2, nabwa::intv_pow2(intv), r[i])
            : nabwa::sa_walk_row(s, l2, nabwa::intv_magic(intv), r[i]);
    }
    return 0;
}

// C3's interval test at sa_intv d: k / d and whether k is sampled, for
// each k, through the instantiation the kernel takes for d
extern "C" int nabwa_host_intv_quot(uint32_t d, const void* ks, int n,
                                    void* quot, void* sampled) {
    for (int i = 0; i < n; ++i) {
        const uint32_t k = ((const uint32_t*)ks)[i];
        if (nabwa::is_pow2(d)) {
            const nabwa::IntvPow2 iv = nabwa::intv_pow2(d);
            ((uint32_t*)quot)[i] = iv.quot(k);
            ((uint8_t*)sampled)[i] = iv.sampled(k);
        } else {
            const nabwa::IntvMagic iv = nabwa::intv_magic(d);
            ((uint32_t*)quot)[i] = iv.quot(k);
            ((uint8_t*)sampled)[i] = iv.sampled(k);
        }
    }
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

// C5's warp kernel (local_fwd.cu) lane by lane at nl lanes of K cells.
// form 0, the register form: lane l's chunk [1 + l K, 1 + (l+1) K) stays in
// its LocalChunk from row to row (nl K must cover len1); form 1, the wide
// form: each row in passes of nl K cells, the row's h and e in a buffer.
// hd of a chunk's first cell is the left lane's last h before any lane's
// step 1, F's carry-in the lanes' u maxima to its left, as the shuffles
// give them; the job's best cell the least (j, i) among the lanes at the
// largest score.
template <int K>
static void local_fwd_lanes(const nabwa::LocalParams& p, const int32_t* s1,
                            int len1, const int32_t* s2, int len2, int nl,
                            int form, int32_t* state, int32_t* out) {
    std::vector<nabwa::LocalChunk<K>> c(nl);
    std::vector<nabwa::LocalBest> best(nl, nabwa::local_best());
    std::vector<int32_t> x(nl), hd(nl);
    std::vector<int> lo(nl), n(nl);
    int32_t* h = state;
    int32_t* e = state + len1 + 1;
    for (int i = 0; i <= len1; ++i) h[i] = e[i] = 0;
    for (int l = 0; l < nl; ++l)
        for (int k = 0; k < K; ++k) c[l].h[k] = c[l].e[k] = 0;
    const int width = form == 0 ? nl * K : len1;
    for (int j = 1; j <= len2; ++j) {
        const int32_t* sub = p.mat + 5 * s2[j];
        int32_t t = nabwa::LOCAL_NEGF, hd_carry = 0;
        for (int base = 1; base <= std::max(width, 1); base += nl * K) {
            if (base > len1 && form != 0) break;
            for (int l = 0; l < nl; ++l) {
                lo[l] = base + l * K;
                n[l] = std::max(0, std::min(K, len1 + 1 - lo[l]));
                if (form != 0)
                    for (int k = 0; k < K; ++k) {
                        c[l].h[k] = k < n[l] ? h[lo[l] + k] : 0;
                        c[l].e[k] = k < n[l] ? e[lo[l] + k] : 0;
                    }
            }
            for (int l = 0; l < nl; ++l)
                hd[l] = l == 0 ? hd_carry : c[l - 1].h[K - 1];
            hd_carry = c[nl - 1].h[K - 1];
            for (int l = 0; l < nl; ++l)
                x[l] = nabwa::local_chunk_pre<K>(p, sub, s1 + lo[l], lo[l],
                                                 n[l], hd[l], c[l]);
            for (int l = 0; l < nl; ++l) {
                nabwa::local_chunk_cells<K>(p, j, lo[l], n[l], t, c[l],
                                            best[l]);
                t = nabwa::lsw_max(t, x[l]);
            }
            if (form != 0)
                for (int l = 0; l < nl; ++l)
                    for (int k = 0; k < n[l]; ++k) {
                        h[lo[l] + k] = c[l].h[k];
                        e[lo[l] + k] = c[l].e[k];
                    }
        }
    }
    nabwa::LocalBest all = best[0];
    for (int l = 1; l < nl; ++l)
        if (nabwa::local_best_before(best[l], all)) all = best[l];
    out[0] = all.best;
    out[1] = all.bi;
    out[2] = all.bj;
}

// nl lanes (1..32) of k cells (2, 4, 8 or 16) in form 0 (registers;
// refused unless nl k covers L1) or 1 (passes over a state buffer)
extern "C" int nabwa_host_local_fwd_lanes(const int32_t* params,
                                          const void* s1, const void* s2,
                                          const void* len1, const void* len2,
                                          int B, int L1, int L2, int nl,
                                          int k, int form, void* score,
                                          void* end_i, void* end_j) {
    if (nl < 1 || nl > 32 || (form != 0 && form != 1)) return 1;
    if (k != 2 && k != 4 && k != 8 && k != 16) return 1;
    if (form == 0 && nl * k < L1) return 1;
    const nabwa::LocalParams p = nabwa::local_params(params);
    std::vector<int32_t> state(2 * ((size_t)L1 + 1));
    for (int b = 0; b < B; ++b) {
        int l1 = ((const int32_t*)len1)[b], l2 = ((const int32_t*)len2)[b];
        l1 = std::max(0, std::min(l1, L1));
        l2 = std::max(0, std::min(l2, L2));
        const int32_t* a = (const int32_t*)s1 + (size_t)b * (L1 + 1);
        const int32_t* q = (const int32_t*)s2 + (size_t)b * (L2 + 1);
        int32_t out[3];
        switch (k) {
        case 2: local_fwd_lanes<2>(p, a, l1, q, l2, nl, form, state.data(),
                                   out); break;
        case 4: local_fwd_lanes<4>(p, a, l1, q, l2, nl, form, state.data(),
                                   out); break;
        case 8: local_fwd_lanes<8>(p, a, l1, q, l2, nl, form, state.data(),
                                   out); break;
        default: local_fwd_lanes<16>(p, a, l1, q, l2, nl, form,
                                     state.data(), out); break;
        }
        ((int32_t*)score)[b] = out[0];
        ((int32_t*)end_i)[b] = out[1];
        ((int32_t*)end_j)[b] = out[2];
    }
    return 0;
}

// C5's form at L1 columns (local_sw.cuh `local_form`), as local_fwd.cu's
// nabwa_local_form gives it: form[0] the form, form[1] the cells a lane
extern "C" int nabwa_host_local_form(int L1, int smem_budget, int* form) {
    form[0] = nabwa::local_form(L1, smem_budget < 0 ? 0 : smem_budget,
                                form + 1);
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
            ((const int32_t*)bw)[b], state.data(), state.data() + L1 + 2,
            (int32_t*)score + b, (int32_t*)end_i + b, (int32_t*)end_j + b,
            (int32_t*)cells + b);
    return 0;
}

// C6's warp kernel (extend.cu) lane by lane: each row's window in passes
// of nl lanes of K cells, every lane's step 1 before any lane's step 2, the
// scan's carry-in, the left lane's h and the row's reductions combined in
// lane order, as the warp's shuffles and redux.sync combine them.
template <int K>
static void extend_job_lanes(const nabwa::ExtendParams& p, const int32_t* s1,
                             int len1, const int32_t* s2, int len2,
                             int32_t g0, int32_t bw, int nl, int32_t* hd,
                             int32_t* ev, int32_t* out) {
    for (int i = 0; i <= len1 + 1; ++i) {
        hd[i] = i == 1 ? g0 : 0;
        ev[i] = 0;
    }
    std::vector<nabwa::ExtendChunk<K>> c(nl);
    std::vector<nabwa::ExtendRowLane> red(nl);
    std::vector<int> lo(nl), n(nl);
    std::vector<int32_t> x(nl);
    int32_t best = 0, bi = 0, bj = 0, n_cells = 0;
    int start = 1, end = 2;
    for (int j = 1; j <= len2; ++j) {
        int sn, en;
        nabwa::extend_window(j, bw, len1, start, end, &sn, &en);
        if (sn >= en) break;
        const int32_t* sub = p.mat + 5 * s2[j];
        std::fill(red.begin(), red.end(), nabwa::extend_row_lane());
        int32_t t = nabwa::EXTEND_NEGF, h_carry = 0;
        for (int base = sn; base < en; base += nl * K) {
            for (int l = 0; l < nl; ++l) {
                n[l] = nabwa::extend_lane_cells(base, l, K, en, &lo[l]);
                x[l] = nabwa::extend_chunk_load<K>(p, sub, s1, hd, ev, lo[l],
                                                   n[l], c[l]);
            }
            for (int l = 0; l < nl; ++l) {
                nabwa::extend_chunk_cells<K>(p, sn, lo[l], n[l], t, c[l],
                                             red[l]);
                t = nabwa::ext_max(t, x[l]);
            }
            for (int l = 0; l < nl; ++l)
                nabwa::extend_chunk_store<K>(
                    lo[l], n[l], en, l == 0 ? h_carry : c[l - 1].h[K - 1],
                    c[l], hd, ev);
            h_carry = c[nl - 1].h[K - 1];
        }
        nabwa::ExtendRowLane all = red[0];
        for (int l = 1; l < nl; ++l) {
            all.first = std::min(all.first, red[l].first);
            all.last = std::max(all.last, red[l].last);
            all.best = std::max(all.best, red[l].best);
        }
        all.arg = 0x7FFFFFFF;
        for (int l = 0; l < nl; ++l)
            if (red[l].best == all.best)
                all.arg = std::min(all.arg, red[l].arg);
        n_cells += en - sn;
        if (!nabwa::extend_row_end(all, j, &best, &bi, &bj, &start, &end))
            break;
    }
    out[0] = best - 1;
    out[1] = bi;
    out[2] = bj;
    out[3] = n_cells;
}

// nl lanes (1..1024) of k cells (1 or 4; the card runs 32 of EXTEND_K)
extern "C" int nabwa_host_extend_lanes(const int32_t* params, const void* s1,
                                       const void* s2, const void* len1,
                                       const void* len2, const void* g0,
                                       const void* bw, int B, int L1, int L2,
                                       int nl, int k, void* score,
                                       void* end_i, void* end_j,
                                       void* cells) {
    if (nl < 1 || nl > 1024 || (k != 1 && k != 4)) return 1;
    const nabwa::ExtendParams p = nabwa::extend_params(params);
    std::vector<int32_t> state(2 * ((size_t)L1 + 2));
    for (int b = 0; b < B; ++b) {
        int l1 = ((const int32_t*)len1)[b], l2 = ((const int32_t*)len2)[b];
        l1 = std::max(0, std::min(l1, L1));
        l2 = std::max(0, std::min(l2, L2));
        const int32_t* a = (const int32_t*)s1 + (size_t)b * (L1 + 2);
        const int32_t* q = (const int32_t*)s2 + (size_t)b * (L2 + 1);
        const int32_t g = ((const int32_t*)g0)[b], w = ((const int32_t*)bw)[b];
        int32_t out[4];
        if (k == 1)
            extend_job_lanes<1>(p, a, l1, q, l2, g, w, nl, state.data(),
                                state.data() + L1 + 2, out);
        else
            extend_job_lanes<4>(p, a, l1, q, l2, g, w, nl, state.data(),
                                state.data() + L1 + 2, out);
        ((int32_t*)score)[b] = out[0];
        ((int32_t*)end_i)[b] = out[1];
        ((int32_t*)end_j)[b] = out[2];
        ((int32_t*)cells)[b] = out[3];
    }
    return 0;
}

// C4's warp kernel (banded_global.cu) lane by lane, as it runs with the
// state in device memory (lattice bytes written directly): each row's
// sweep in passes of nl lanes of K columns, the diagonal, M[i-1] and D's
// carry-in taken from the left lane in lane order, as the warp's shuffles
// take them.
template <int K>
static void banded_global_lanes(const nabwa::DpParams& p, int L1, int L2,
                                const int32_t* s1, const int32_t* s2,
                                int len1, int len2, int b1, int b2, int nl,
                                int32_t* M, int32_t* I, int32_t* D,
                                uint8_t* tb, int32_t* score,
                                int32_t* ctype) {
    const size_t W = (size_t)L1 + 1;
    for (int i = 0; i <= L1; ++i) {
        M[i] = i == 0 ? 0 : nabwa::DP_NEG;
        I[i] = nabwa::DP_NEG;
        D[i] = (i >= 1 && i <= b1 - 1) ? -p.go - p.gend * i : nabwa::DP_NEG;
        tb[i] = 0;
    }
    std::vector<nabwa::DpChunk<K>> c(nl);
    std::vector<int> lo(nl), n(nl);
    std::vector<int32_t> x(nl);
    int plo = 0, phi = b1 - 1 > 0 ? b1 - 1 : 0;
    for (int j = 1; j <= L2; ++j) {
        uint8_t* dst = tb + (size_t)j * W;
        if (j > len2) {
            std::fill(dst, dst + W, 0);
            continue;
        }
        const nabwa::DpRow r = nabwa::dp_row(p, len1, len2, b1, b2, j);
        int c0, c1;
        nabwa::dp_sweep(p, L1, r.start, r.end, plo, phi, &c0, &c1);
        plo = r.start;
        phi = r.end;
        const int32_t* sub = p.mat + 5 * s2[j];
        int32_t pm_c = nabwa::DP_NEG, pi_c = nabwa::DP_NEG,
                pd_c = nabwa::DP_NEG, m_c = nabwa::DP_NEG, t = nabwa::DP_NEG;
        for (int base = c0; base <= c1; base += nl * K) {
            for (int l = 0; l < nl; ++l) {
                n[l] = nabwa::dp_lane_cells(base, l, K, c1, &lo[l]);
                nabwa::dp_chunk_load<K>(M, I, D, lo[l], n[l], c[l]);
            }
            for (int l = 0; l < nl; ++l) {
                const bool first = l == 0;
                nabwa::dp_chunk_mi<K>(
                    p, r, sub, s1, lo[l], n[l],
                    first ? pm_c : c[l - 1].mp[K - 1],
                    first ? pi_c : c[l - 1].ip[K - 1],
                    first ? pd_c : c[l - 1].dp[K - 1], c[l]);
            }
            for (int l = 0; l < nl; ++l)
                x[l] = nabwa::dp_chunk_u<K>(
                    p, r, lo[l], n[l], l == 0 ? m_c : c[l - 1].m[K - 1],
                    c[l]);
            for (int l = 0; l < nl; ++l) {
                nabwa::dp_chunk_d<K>(r, lo[l], t, c[l]);
                t = nabwa::dp_max(t, x[l]);
            }
            for (int l = 0; l < nl; ++l) {
                nabwa::dp_chunk_store<K>(lo[l], n[l], c[l], M, I, D);
                for (int k = 0; k < n[l]; ++k)
                    dst[lo[l] + k] = (uint8_t)c[l].bits[k];
            }
            pm_c = c[nl - 1].mp[K - 1];
            pi_c = c[nl - 1].ip[K - 1];
            pd_c = c[nl - 1].dp[K - 1];
            m_c = c[nl - 1].m[K - 1];
        }
        for (int i = 0; i <= L1; ++i)
            if (i < c0 || i > c1) dst[i] = 0;
    }
    const int e = len1 < 0 ? 0 : (len1 > L1 ? L1 : len1);
    nabwa::dp_end_cell(M[e], I[e], D[e], score, ctype);
}

// nl lanes (1..1024) of k columns (1 or 4; the card runs 32 of DP_K)
extern "C" int nabwa_host_banded_global_lanes(
    const int32_t* params, const void* s1, const void* s2, const void* len1,
    const void* len2, const void* b1, const void* b2, int B, int L1, int L2,
    int nl, int k, void* tb, void* score, void* ctype) {
    if (nl < 1 || nl > 1024 || (k != 1 && k != 4)) return 1;
    const nabwa::DpParams p = nabwa::dp_params(params);
    std::vector<int32_t> state(3 * ((size_t)L1 + 1));
    int32_t* M = state.data();
    for (int b = 0; b < B; ++b) {
        const int32_t* a = (const int32_t*)s1 + (size_t)b * (L1 + 1);
        const int32_t* q = (const int32_t*)s2 + (size_t)b * (L2 + 1);
        const int n1 = ((const int32_t*)len1)[b];
        const int n2 = ((const int32_t*)len2)[b];
        const int w1 = ((const int32_t*)b1)[b], w2 = ((const int32_t*)b2)[b];
        uint8_t* t = (uint8_t*)tb + (size_t)b * (L2 + 1) * (L1 + 1);
        int32_t* sc = (int32_t*)score + b;
        int32_t* ct = (int32_t*)ctype + b;
        if (k == 1)
            banded_global_lanes<1>(p, L1, L2, a, q, n1, n2, w1, w2, nl, M,
                                   M + L1 + 1, M + 2 * (L1 + 1), t, sc, ct);
        else
            banded_global_lanes<4>(p, L1, L2, a, q, n1, n2, w1, w2, nl, M,
                                   M + L1 + 1, M + 2 * (L1 + 1), t, sc, ct);
    }
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

extern "C" int nabwa_host_probe_lcg_jump(const int32_t* s, const int64_t* k,
                                         int n, int32_t* out) {
    for (int i = 0; i < n; ++i) out[i] = pr::lcg_jump(s[i], k[i]);
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

// C9's lean form: the counts of the 8 block words of each 128-word row,
// each word read where the warp fetches it (component i & 3 of lane
// shape_block_lane), out[8 r + i]
extern "C" int nabwa_host_probe_shape_block_counts(const int32_t* rows, int n,
                                                   int32_t* out) {
    for (int r = 0; r < n; ++r) {
        const int32_t* row = rows + 128 * (size_t)r;
        for (int i = 0; i < 8; ++i) {
            const int32_t src = pr::shape_block_lane(row[0], i);
            out[8 * r + i] = pr::shape_block_count(row[4 * src + (i & 3)], i,
                                                   (row[1] >> 4) & 7);
        }
    }
    return 0;
}

// C9's lean push: the candidate the free slot of rank r takes under the
// valid mask, read as the warp reads it (lane push_lane(r) of the lanes'
// push_nth), 9 for none
extern "C" int nabwa_host_probe_push_take(const int32_t* valid,
                                          const int32_t* rank, int n,
                                          int32_t* out) {
    for (int i = 0; i < n; ++i)
        out[i] = pr::push_nth((uint32_t)valid[i], pr::push_lane(rank[i]));
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

// C12's grid form: its blocks for each (bb, warps, max_blocks), and for
// each (block, warp, step) of a grid of `blocks` blocks of `warps` warps the
// output row copied and, where that row lies below 2 bb, the word of idx
// (idx_w words a row) that holds its table row's index, else -1
extern "C" int nabwa_host_probe_loads_blocks(const int32_t* bb,
                                             const int32_t* warps,
                                             const int32_t* max_blocks, int n,
                                             int32_t* out) {
    for (int i = 0; i < n; ++i)
        out[i] = pr::loads_blocks(bb[i], warps[i], max_blocks[i]);
    return 0;
}

extern "C" int nabwa_host_probe_loads_rows(const int32_t* block,
                                           const int32_t* warp,
                                           const int32_t* step, int n,
                                           int32_t warps, int32_t blocks,
                                           int32_t bb, int32_t idx_w,
                                           int64_t* row, int64_t* idx_at) {
    for (int i = 0; i < n; ++i) {
        row[i] = pr::loads_out_row(block[i], warp[i], step[i], warps, blocks);
        idx_at[i] = row[i] < 2 * (int64_t)bb
                        ? pr::loads_idx_at(row[i], bb, idx_w) : -1;
    }
    return 0;
}

// each slot alone: its new key and what it adds to e1 (from 0)
extern "C" int nabwa_host_probe_pop_take(const int32_t* key, const int32_t* f,
                                         const int32_t* mk, int n,
                                         int32_t* out_key, int32_t* out_e1) {
    for (int i = 0; i < n; ++i) {
        uint32_t e1 = 0;
        out_key[i] = pr::pop_take(key[i], f[i], mk[i], &e1);
        out_e1[i] = (int32_t)e1;
    }
    return 0;
}

// C16's popcount of each value
extern "C" int nabwa_host_probe_popcount32(const int32_t* x, int n,
                                           int32_t* out) {
    for (int i = 0; i < n; ++i) out[i] = (int32_t)pr::popcount32(x[i]);
    return 0;
}

// C17's and C18's slot of a round: each key against its row minimum m
extern "C" int nabwa_host_probe_while_step(const int32_t* key,
                                           const int32_t* m, int n,
                                           int32_t* out) {
    for (int i = 0; i < n; ++i) out[i] = pr::while_step(key[i], m[i]);
    return 0;
}

// C17's and C18's grid form on x int32 [rows, 128], each row played over
// its 32 lanes of 4 slots: a round takes every lane's while_lane_min,
// their minimum (the card's redux.sync), then every lane's
// while_lane_round.  row_sums[r] is row r's sum (lane 0's; every lane's
// must agree, else -1), *acc the rows' sums added as uint32 (C17's
// carry).
extern "C" int nabwa_host_probe_while_rows(const int32_t* x, int rows,
                                           int rounds, int32_t* row_sums,
                                           int32_t* acc) {
    uint32_t total = 0;
    for (int r = 0; r < rows; ++r) {
        int32_t k[32][4];
        uint32_t sum[32] = {};
        for (int l = 0; l < 32; ++l)
            for (int j = 0; j < 4; ++j) k[l][j] = x[(size_t)r * 128 + 4 * l + j];
        for (int it = 0; it < rounds; ++it) {
            int32_t m = pr::while_lane_min(k[0]);
            for (int l = 1; l < 32; ++l)
                m = std::min(m, pr::while_lane_min(k[l]));
            for (int l = 0; l < 32; ++l) pr::while_lane_round(k[l], m, &sum[l]);
        }
        for (int l = 1; l < 32; ++l)
            if (sum[l] != sum[0]) return -1;
        row_sums[r] = (int32_t)sum[0];
        total += sum[0];
    }
    *acc = (int32_t)total;
    return 0;
}

// C19's step j of each value p
extern "C" int nabwa_host_probe_body_step(const int32_t* p, const int32_t* j,
                                          int n, int32_t* out) {
    for (int i = 0; i < n; ++i) out[i] = pr::body_step(p[i], j[i]);
    return 0;
}

// C21's field k (0..4) of each pushed value v
extern "C" int nabwa_host_probe_push_fields(const int32_t* v,
                                            const int32_t* k, int n,
                                            int32_t* out) {
    for (int i = 0; i < n; ++i) out[i] = pr::push_fields(v[i], k[i]);
    return 0;
}

// C23's update of each value v from its neighbour `next`
extern "C" int nabwa_host_probe_spill_update(const int32_t* v,
                                             const int32_t* next, int n,
                                             int32_t* out) {
    for (int i = 0; i < n; ++i) out[i] = pr::spill_update(v[i], next[i]);
    return 0;
}

// C23's lane form on n elements x: each element's K values over a group
// of `lanes` lanes, played lane by lane.  A round first reads, for every
// lane, the first value of lane spill_next_lane (an array read in place
// of the card's shuffle, so every lane sees the old value), then runs
// each lane's spill_lane_round; the sum is each lane's spill_lane_sum,
// then log2 lanes xor steps over the group as the card's shuffles take
// it.  Returns -1 (nothing written) unless lanes is a power of two
// dividing k.
extern "C" int nabwa_host_probe_spill_lanes(const int32_t* x, int n, int k,
                                            int lanes, int t,
                                            int32_t* out) {
    if (k < 1 || lanes < 1 || (lanes & (lanes - 1)) || k % lanes) return -1;
    const int m = k / lanes;
    std::vector<int32_t> v(k), next(lanes);
    std::vector<uint32_t> acc(lanes), sw(lanes);
    for (int e = 0; e < n; ++e) {
        for (int l = 0; l < lanes; ++l)
            pr::spill_lane_init(x[e], l, m, &v[(size_t)l * m]);
        for (int it = 0; it < t; ++it) {
            for (int l = 0; l < lanes; ++l)
                next[l] = v[(size_t)pr::spill_next_lane(l, lanes) * m];
            for (int l = 0; l < lanes; ++l)
                pr::spill_lane_round(&v[(size_t)l * m], m, next[l]);
        }
        for (int l = 0; l < lanes; ++l)
            acc[l] = pr::spill_lane_sum(&v[(size_t)l * m], m);
        for (int d = lanes >> 1; d; d >>= 1) {
            for (int l = 0; l < lanes; ++l) sw[l] = acc[l ^ d];
            for (int l = 0; l < lanes; ++l) acc[l] += sw[l];
        }
        out[e] = (int32_t)acc[0];
    }
    return 0;
}

// C24's step of each value v
extern "C" int nabwa_host_probe_colops_step(const int32_t* v, int n,
                                            int32_t* out) {
    for (int i = 0; i < n; ++i) out[i] = pr::colops_step(v[i]);
    return 0;
}

// C25's step i of each value v
extern "C" int nabwa_host_probe_p7_step(const int32_t* v, const int32_t* i,
                                        int n, int32_t* out) {
    for (int k = 0; k < n; ++k) out[k] = pr::p7_step(v[k], i[k]);
    return 0;
}

// C26's step i of each value v against its row's scalar a
extern "C" int nabwa_host_probe_p8_step(const int32_t* v, const int32_t* a,
                                        const int32_t* i, int n,
                                        int32_t* out) {
    for (int k = 0; k < n; ++k) out[k] = pr::p8_step(v[k], a[k], i[k]);
    return 0;
}

// C30's source int4 of x for out's int4 q, x of `quads` int4 a row
extern "C" int nabwa_host_probe_relayout_src(const int32_t* q,
                                            const int32_t* quads, int n,
                                            int32_t* out) {
    for (int k = 0; k < n; ++k) out[k] = pr::relayout_src(q[k], quads[k]);
    return 0;
}

// C32's source word of word c of a row of n words rotated by sh
extern "C" int nabwa_host_probe_roll_src(const int32_t* c, const int32_t* sh,
                                        const int32_t* words, int n,
                                        int32_t* out) {
    for (int k = 0; k < n; ++k) out[k] = pr::roll_src(c[k], sh[k], words[k]);
    return 0;
}

// C32's lane form on x int32 [rows, 128], each row played over its 32
// lanes of 4 words (lane L words L + 32 k): a round takes every lane's
// p2_lane_min (sh 64 and 32), then for sh = 16, 8, 4, 2, 1 reads every
// lane's value from lane p2_roll_lane (an array read before any lane
// updates, in place of the card's shuffle) and takes the minimum, then
// adds each lane's value to its four words (wrapping).  m gets the value
// each word's lane holds at the end of the first round's rotations, out
// the words after `rounds` rounds.
extern "C" int nabwa_host_probe_p2_roll_lanes(const int32_t* x, int rows,
                                              int rounds, int32_t* m,
                                              int32_t* out) {
    for (int r = 0; r < rows; ++r) {
        int32_t w[32][4], a[32], from[32];
        for (int l = 0; l < 32; ++l)
            for (int k = 0; k < 4; ++k) w[l][k] = x[(size_t)r * 128 + l + 32 * k];
        for (int it = 0; it < rounds; ++it) {
            for (int l = 0; l < 32; ++l) a[l] = pr::p2_lane_min(w[l]);
            for (int sh = 16; sh; sh >>= 1) {
                for (int l = 0; l < 32; ++l) from[l] = a[pr::p2_roll_lane(l, sh)];
                for (int l = 0; l < 32; ++l) a[l] = std::min(a[l], from[l]);
            }
            if (it == 0)
                for (int c = 0; c < 128; ++c) m[(size_t)r * 128 + c] = a[c % 32];
            for (int l = 0; l < 32; ++l)
                for (int k = 0; k < 4; ++k) w[l][k] = pr::wadd(w[l][k], a[l]);
        }
        for (int l = 0; l < 32; ++l)
            for (int k = 0; k < 4; ++k) out[(size_t)r * 128 + l + 32 * k] = w[l][k];
    }
    return 0;
}

// C35's staged form on x int32 [rows, depth] times w float32 [depth,
// width] in tiles of KT words, played block by block: for each tile,
// every thread's p6_stage, then (the barrier) every thread's p6_dot
template <int KT>
void p6_staged(const int32_t* x, const float* w, int rows, int depth,
               int width, float* out) {
    constexpr int threads = pr::P6_ROWS * pr::P6_COLS, pitch = KT + pr::P6_PAD;
    const int64_t col_blocks = (width + pr::P6_COLS - 1) / pr::P6_COLS;
    const int64_t blocks =
        ((int64_t)rows + pr::P6_ROWS - 1) / pr::P6_ROWS * col_blocks;
    std::vector<float> xs((size_t)pr::P6_ROWS * pitch, -1.0f);
    std::vector<float> ws((size_t)pr::P6_COLS * pitch, -1.0f);
    for (int64_t b = 0; b < blocks; ++b) {
        int64_t r0, c0;
        pr::p6_origin(b, col_blocks, &r0, &c0);
        float acc[threads] = {};
        for (int k0 = 0; k0 < depth; k0 += KT) {
            for (int t = 0; t < threads; ++t)
                pr::p6_stage<KT, threads>(x, w, rows, depth, width, r0, c0,
                                          k0, std::min(KT, depth - k0), t,
                                          pitch, xs.data(), ws.data());
            for (int t = 0; t < threads; ++t)
                acc[t] = pr::p6_dot<KT>(
                    acc[t], &xs[(size_t)(t / pr::P6_COLS) * pitch],
                    &ws[(size_t)(t % pr::P6_COLS) * pitch]);
        }
        for (int t = 0; t < threads; ++t) {
            const int64_t r = r0 + t / pr::P6_COLS, c = c0 + t % pr::P6_COLS;
            if (r < rows && c < width) out[r * width + c] = acc[t];
        }
    }
}

// C35's staged form in tiles of kt words: 128 (the kernel's), 8 or 4.
// Returns -1 (nothing written) for another kt.
extern "C" int nabwa_host_probe_p6_staged(const int32_t* x, const float* w,
                                          int rows, int depth, int width,
                                          int kt, float* out) {
    switch (kt) {
        case 128: p6_staged<128>(x, w, rows, depth, width, out); return 0;
        case 8: p6_staged<8>(x, w, rows, depth, width, out); return 0;
        case 4: p6_staged<4>(x, w, rows, depth, width, out); return 0;
        default: return -1;
    }
}

// C34's inner trip count from each s[0, 0]
extern "C" int nabwa_host_probe_p5_trips(const int32_t* s, int n,
                                         int32_t* out) {
    for (int k = 0; k < n; ++k) out[k] = pr::p5_trips(s[k]);
    return 0;
}

// C34's grid form on s = x of n words: thread q's 4 words (4 q ..,
// zeros past n) and its copy of x[0] through `rounds` outer rounds
// (p5_words), the words below n written back
extern "C" int nabwa_host_probe_p5_words(const int32_t* x, int n, int rounds,
                                         int32_t* out) {
    for (int at = 0; at < n; at += 4) {
        int32_t w[4];
        for (int k = 0; k < 4; ++k) w[k] = at + k < n ? x[at + k] : 0;
        pr::p5_words(x[0], rounds, w, 4);
        for (int k = 0; k < 4 && at + k < n; ++k) out[at + k] = w[k];
    }
    return 0;
}
