// The per-pair banded global alignment of kernel C4: aln_global_core's
// score, end type and traceback lattice (stdaln.c:345-525), exactly as
// nabwa_tpu/ops/dp.py:31 `_banded_global_device` lays them out.
//
// The lattice is padded: every column 0..L1 of every row 1..len2 is
// computed, in and out of the band, because the jnp version writes the
// traceback bits of out-of-band cells too (from NEG comparisons; Dt just
// past the band edge depends on the M value just inside it).  Rows past
// len2 are zero.  tb bits: 0-1 Mt, 2 It, 3 Dt.  Arithmetic is int32 with
// NEG = MINOR_INF (stdaln.h), as in the jnp version; no value overflows.
//
// Within a row, D[i] = max(M[i-1]-go, D[i-1]) - ext is carried as a running
// max of U[i] = (M[i-1]-go) + ext*(i-1), the jnp version's cummax.
//
// NABWA_HD: nvcc compiles it for the card, a host C++ compiler for the CPU
// test harness.

#pragma once

#include <cstddef>
#include <cstdint>

#ifndef NABWA_HD
#if defined(__CUDACC__)
#define NABWA_HD __host__ __device__ __forceinline__
#else
#define NABWA_HD inline
#endif
#endif

namespace nabwa {

constexpr int32_t DP_NEG = -1073741823;    // MINOR_INF
constexpr uint32_t DP_FROM_M = 0, DP_FROM_I = 1, DP_FROM_D = 2;

// go, ge, gap_end and the 5x5 score matrix.  gend < 0 falls back to ge
// (the set_end_* macros; nabwa_tpu/ops/dp.py:46).
struct DpParams {
    int32_t go, ge, gend;
    int32_t mat[25];
};

NABWA_HD DpParams dp_params(const int32_t* w) {
    DpParams p;
    p.go = w[0];
    p.ge = w[1];
    p.gend = w[2] >= 0 ? w[2] : w[1];
    for (int j = 0; j < 25; ++j) p.mat[j] = w[3 + j];
    return p;
}

// One pair.  s1: L1+1 reference codes, s2: L2+1 read codes, both 1-based
// (index 0 unused), codes 0..4.  M/I/D: one row of state, column i at
// [i * stride] (the kernel interleaves the pairs of a batch so that
// neighbouring threads touch neighbouring words).  tb: (L2+1) x (L1+1).
struct DpPair {
    const int32_t* s1;
    const int32_t* s2;
    int len1, len2, b1, b2;
    int32_t* M;
    int32_t* I;
    int32_t* D;
    size_t stride;
    uint8_t* tb;
};

NABWA_HD void banded_global_pair(const DpParams& p, int L1, int L2,
                                 const DpPair& q, int32_t* score,
                                 int32_t* ctype) {
    const size_t st = q.stride;
    const size_t W = (size_t)L1 + 1;
    // row 0 (stdaln.c:393-399): M[0,0] = 0, D from M[0,0] over 1..b1-1
    for (int i = 0; i <= L1; ++i) {
        q.M[i * st] = i == 0 ? 0 : DP_NEG;
        q.I[i * st] = DP_NEG;
        q.D[i * st] = (i >= 1 && i <= q.b1 - 1) ? -p.go - p.gend * i
                                                : DP_NEG;
        q.tb[i] = 0;
    }
    const int tmp_end = q.b2 < q.len2 ? q.b2 : q.len2 - 1;
    const bool var_row = q.b2 == q.len2;     // the part-1 last-row variant
    for (int j = 1; j <= L2; ++j) {
        uint8_t* tbr = q.tb + (size_t)j * W;
        if (j > q.len2) {                    // frozen state, zero row
            for (int i = 0; i <= L1; ++i) tbr[i] = 0;
            continue;
        }
        const bool part1 = j <= tmp_end;
        const bool last_row = j == q.len2 && !var_row;
        const bool is_var = j == q.len2 && var_row;
        const int start = (part1 || is_var) ? 0 : j - q.b2 + 1;
        const int end = j + q.b1 - 1 < q.len1 ? j + q.b1 - 1 : q.len1;
        // gap_end on I at the band's right edge past len1 or on the last
        // row, and on D along the last row
        const bool i_end_gend = j + q.b1 - 1 > q.len1 || last_row;
        const int32_t dext = (is_var || last_row) ? p.gend : p.ge;
        const int d_lo = start > 1 ? start : 1;
        const int32_t* sub = p.mat + 5 * q.s2[j];
        int32_t pm = DP_NEG, pi = DP_NEG, pd = DP_NEG;   // row j-1, col i-1
        int32_t m_left = DP_NEG, d_left = DP_NEG;        // row j, col i-1
        int32_t t = DP_NEG;                              // running max of U
        for (int i = 0; i <= L1; ++i) {
            const bool in_band = i >= start && i <= end;
            const int32_t mp = q.M[i * st], ip = q.I[i * st],
                          dp = q.D[i * st];
            // M from the diagonal, ties M >= I, I > D (set_M)
            const bool m_ge_i = pm >= pi, m_ge_d = pm >= pd, i_gt_d = pi > pd;
            const int32_t best = m_ge_i ? (m_ge_d ? pm : pd)
                                        : (i_gt_d ? pi : pd);
            const uint32_t mt = m_ge_i ? (m_ge_d ? DP_FROM_M : DP_FROM_D)
                                       : (i_gt_d ? DP_FROM_I : DP_FROM_D);
            const int32_t m = (in_band && i >= 1) ? best + sub[q.s1[i]]
                                                  : DP_NEG;
            // I from above, same column (set_i / set_end_i)
            const bool at_end = i == end;
            const bool i_ok = in_band && (!at_end || i_end_gend || i == 0);
            const int32_t iext = (i == 0 || at_end) ? p.gend : p.ge;
            const bool from_m = mp - p.go > ip;
            const int32_t iv = i_ok ? (from_m ? mp - p.go : ip) - iext
                                    : DP_NEG;
            // D from the left (set_d / set_end_d)
            const int32_t a = i == 0 ? DP_NEG : m_left - p.go;
            const bool d_ok = in_band && i >= d_lo;
            const int32_t u = d_ok ? a + dext * (i - 1) : DP_NEG;
            t = u > t ? u : t;
            const int32_t d = d_ok ? t - dext * i : DP_NEG;
            const uint32_t dt = a > d_left ? 1u : 0u;
            tbr[i] = (uint8_t)(mt | (from_m ? 4u : 0u) | (dt << 3));
            pm = mp;
            pi = ip;
            pd = dp;
            q.M[i * st] = m;
            q.I[i * st] = iv;
            q.D[i * st] = d;
            m_left = m;
            d_left = d;
        }
    }
    // the end cell (len2, len1): the state is frozen past row len2
    const int l1 = q.len1 < 0 ? 0 : q.len1 > L1 ? L1 : q.len1;
    const int32_t mn = q.M[l1 * st], in = q.I[l1 * st], dn = q.D[l1 * st];
    int32_t s = mn;
    uint32_t ct = DP_FROM_M;
    if (in > s) ct = DP_FROM_I;
    s = in > s ? in : s;
    if (dn > s) ct = DP_FROM_D;
    s = dn > s ? dn : s;
    *score = s;
    *ctype = (int32_t)ct;
}

}  // namespace nabwa
