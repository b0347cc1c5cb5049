// The per-pair banded global alignment of kernel C4: aln_global_core's
// score, end type and traceback lattice (stdaln.c:345-525), exactly as
// nabwa_tpu/ops/dp.py:31 `_banded_global_device` lays them out.
//
// The lattice is padded: every column 0..L1 of every row 1..len2 has its
// bits, in and out of the band, because the jnp version writes the
// traceback bits of out-of-band cells too (from NEG comparisons; Dt just
// past the band edge depends on the M value just inside it).  Rows past
// len2 are zero, and so is row 0.  tb bits: 0-1 Mt, 2 It, 3 Dt.
// Arithmetic is int32 with NEG = MINOR_INF (stdaln.h), as in the jnp
// version: values fall to about NEG - go - dext L1, which stays above
// INT32_MIN while go + dext L1 < 2^30 (gap penalties of a few hundred and
// L1 up to ~10^6 leave a wide margin).
//
// Within a row, D[i] = max(M[i-1]-go, D[i-1]) - ext is carried as a running
// max t of U[i] = (M[i-1]-go) + ext*(i-1), the jnp version's cummax; t
// starts at NEG (U itself can fall below it: M[i-1] = NEG gives
// NEG - go), and D[i] = t - ext*i.
//
// Two forms of the same DP.  `banded_global_pair` sweeps each whole row in
// one thread: the serial reference the CPU tests build with g++.  The
// kernel gives each pair a warp and runs the functions below it on one
// lane's K contiguous columns (`DpChunk`), in passes of 32 K columns: M and
// I need only the previous row (at i-1 and i), the left lane's last
// column gives the diagonal, and D's running max is an inclusive max-scan
// of the lanes' maxima of U carried in as `t`.  Everything a lane needs
// from another is passed in, so the CPU tests run a row lane by lane in
// order, combining the carries as the warp's shuffles do, at any number
// of lanes (csrc/host_harness.cpp).
//
// The kernel sweeps only the columns whose bits or state can differ from
// those of a cell far from the band (`dp_sweep`).  Far from it, the
// previous row's M, I and D at i-1 and at i and this row's M and D at i-1
// are all NEG: Mt = 0 (NEG >= NEG), It = 0 (NEG - go > NEG is false),
// Dt = 0 (NEG - go > NEG is false) and the new state is NEG.  So a row's
// sweep is the hull of [start, end + 1] of its band and of the previous
// row's (row 0's: [0, b1 - 1]), each cell of it computed by the full rule,
// and every other column of the row gets 0 and keeps its NEG.  With
// go < 0 those compares turn true, and the whole row is swept.
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
// (index 0 unused), codes 0..4.  M/I/D: one row of state, L1+1 entries
// each.  tb: (L2+1) x (L1+1).
struct DpPair {
    const int32_t* s1;
    const int32_t* s2;
    int len1, len2, b1, b2;
    int32_t* M;
    int32_t* I;
    int32_t* D;
    uint8_t* tb;
};

NABWA_HD void banded_global_pair(const DpParams& p, int L1, int L2,
                                 const DpPair& q, int32_t* score,
                                 int32_t* ctype) {
    const size_t W = (size_t)L1 + 1;
    // row 0 (stdaln.c:393-399): M[0,0] = 0, D from M[0,0] over 1..b1-1
    for (int i = 0; i <= L1; ++i) {
        q.M[i] = i == 0 ? 0 : DP_NEG;
        q.I[i] = DP_NEG;
        q.D[i] = (i >= 1 && i <= q.b1 - 1) ? -p.go - p.gend * i
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
            const int32_t mp = q.M[i], ip = q.I[i],
                          dp = q.D[i];
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
            q.M[i] = m;
            q.I[i] = iv;
            q.D[i] = d;
            m_left = m;
            d_left = d;
        }
    }
    // the end cell (len2, len1): the state is frozen past row len2
    const int l1 = q.len1 < 0 ? 0 : q.len1 > L1 ? L1 : q.len1;
    const int32_t mn = q.M[l1], in = q.I[l1], dn = q.D[l1];
    int32_t s = mn;
    uint32_t ct = DP_FROM_M;
    if (in > s) ct = DP_FROM_I;
    s = in > s ? in : s;
    if (dn > s) ct = DP_FROM_D;
    s = dn > s ? dn : s;
    *score = s;
    *ctype = (int32_t)ct;
}

// ---- one lane's share of a row (the warp kernel) ----

// columns a lane takes in one pass of a row
constexpr int DP_K = 4;

NABWA_HD int32_t dp_max(int32_t a, int32_t b) { return a > b ? a : b; }

// Row j's values, the same for every column (stdaln.c:400-460 as
// nabwa_tpu/ops/dp.py:31 computes them): the band [start, end], D's first
// column, D's extension and whether I takes gap_end at the band's end.
struct DpRow {
    int start, end, d_lo;
    int32_t dext;
    bool i_end_gend;
};

NABWA_HD DpRow dp_row(const DpParams& p, int len1, int len2, int b1, int b2,
                      int j) {
    const int tmp_end = b2 < len2 ? b2 : len2 - 1;
    const bool var_row = b2 == len2;
    const bool part1 = j <= tmp_end;
    const bool last_row = j == len2 && !var_row;
    const bool is_var = j == len2 && var_row;
    DpRow r;
    r.start = (part1 || is_var) ? 0 : j - b2 + 1;
    r.end = j + b1 - 1 < len1 ? j + b1 - 1 : len1;
    r.d_lo = r.start > 1 ? r.start : 1;
    r.dext = (is_var || last_row) ? p.gend : p.ge;
    r.i_end_gend = j + b1 - 1 > len1 || last_row;
    return r;
}

// The columns [*c0, *c1] of row j to compute (empty when *c1 < *c0): the
// hull of [lo, hi + 1] over this row's band [lo, hi] and the previous
// row's [plo, phi] (empty ones left out), within [0, L1]; all of [0, L1]
// when go < 0.
NABWA_HD void dp_sweep(const DpParams& p, int L1, int lo, int hi, int plo,
                       int phi, int* c0, int* c1) {
    int a = L1 + 1, b = -1;
    if (p.go < 0) {
        a = 0;
        b = L1;
    }
    if (lo <= hi) {
        a = lo < a ? lo : a;
        b = hi + 1 > b ? hi + 1 : b;
    }
    if (plo <= phi) {
        a = plo < a ? plo : a;
        b = phi + 1 > b ? phi + 1 : b;
    }
    *c0 = a < 0 ? 0 : a;
    *c1 = b > L1 ? L1 : b;
}

// The columns [lo, lo + n) of a pass that one lane takes (n in 0..K).
NABWA_HD int dp_lane_cells(int base, int lane, int k, int c1, int* lo) {
    *lo = base + lane * k;
    const int n = c1 + 1 - *lo;
    return n < 0 ? 0 : (n > k ? k : n);
}

// One lane's columns of a row: the previous row's state there, this row's
// M, I, M[i-1] - go (a), the new D and the traceback bits.
template <int K>
struct DpChunk {
    int32_t mp[K], ip[K], dp[K];
    int32_t m[K], iv[K], a[K], d[K];
    uint32_t bits[K];
};

// Step 1: the lane's reads of the previous row's state (NEG for k >= n).
template <int K>
NABWA_HD void dp_chunk_load(const int32_t* M, const int32_t* I,
                            const int32_t* D, int lo, int n, DpChunk<K>& c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        c.mp[k] = k < n ? M[lo + k] : DP_NEG;
        c.ip[k] = k < n ? I[lo + k] : DP_NEG;
        c.dp[k] = k < n ? D[lo + k] : DP_NEG;
    }
}

// Step 2: M and I of the first n columns, given the previous row's state
// at lo - 1 (pm, pi, pd: NEG left of column 0), with Mt and It.  s1: the
// reference codes, int32 or bytes.
template <int K, class Code>
NABWA_HD void dp_chunk_mi(const DpParams& p, const DpRow& r,
                          const int32_t* sub, const Code* s1, int lo,
                          int n, int32_t pm, int32_t pi, int32_t pd,
                          DpChunk<K>& c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = lo + k;
        const bool in_band = i >= r.start && i <= r.end;
        // M from the diagonal, ties M >= I, I > D (set_M)
        const bool m_ge_i = pm >= pi, m_ge_d = pm >= pd, i_gt_d = pi > pd;
        const int32_t best = m_ge_i ? (m_ge_d ? pm : pd) : (i_gt_d ? pi : pd);
        const uint32_t mt = m_ge_i ? (m_ge_d ? DP_FROM_M : DP_FROM_D)
                                   : (i_gt_d ? DP_FROM_I : DP_FROM_D);
        c.m[k] = (k < n && in_band && i >= 1) ? best + sub[s1[i]] : DP_NEG;
        // I from above, same column (set_i / set_end_i)
        const bool at_end = i == r.end;
        const bool i_ok = in_band && (!at_end || r.i_end_gend || i == 0);
        const int32_t iext = (i == 0 || at_end) ? p.gend : p.ge;
        const bool from_m = c.mp[k] - p.go > c.ip[k];
        c.iv[k] = i_ok ? (from_m ? c.mp[k] - p.go : c.ip[k]) - iext : DP_NEG;
        c.bits[k] = mt | (from_m ? 4u : 0u);
        pm = c.mp[k];
        pi = c.ip[k];
        pd = c.dp[k];
    }
}

// Step 3: a = M[i-1] - go (NEG at column 0), given this row's M at lo - 1
// (m_left); returns the lane's max of U over its first n columns, from
// NEG.
template <int K>
NABWA_HD int32_t dp_chunk_u(const DpParams& p, const DpRow& r, int lo, int n,
                            int32_t m_left, DpChunk<K>& c) {
    int32_t agg = DP_NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = lo + k;
        c.a[k] = i == 0 ? DP_NEG : m_left - p.go;
        m_left = c.m[k];
        const bool d_ok = i >= r.d_lo && i <= r.end;
        if (k < n && d_ok) agg = dp_max(agg, c.a[k] + r.dext * (i - 1));
    }
    return agg;
}

// Step 4: D and Dt, given t, the running max of U over the row's columns
// left of lo (from NEG): D at lo - 1 is t - dext (lo - 1) where it is in
// the band, else NEG.  Each column's lattice byte is c.bits.
template <int K>
NABWA_HD void dp_chunk_d(const DpRow& r, int lo, int32_t t, DpChunk<K>& c) {
    const int il = lo - 1;
    int32_t d_left = (il >= r.d_lo && il <= r.end) ? t - r.dext * il : DP_NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = lo + k;
        const bool d_ok = i >= r.d_lo && i <= r.end;
        const int32_t u = d_ok ? c.a[k] + r.dext * (i - 1) : DP_NEG;
        t = u > t ? u : t;
        c.d[k] = d_ok ? t - r.dext * i : DP_NEG;
        c.bits[k] |= (c.a[k] > d_left ? 1u : 0u) << 3;
        d_left = c.d[k];
    }
}

// Step 5: the lane's writes of the new state.
template <int K>
NABWA_HD void dp_chunk_store(int lo, int n, const DpChunk<K>& c, int32_t* M,
                             int32_t* I, int32_t* D) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (k < n) {
            M[lo + k] = c.m[k];
            I[lo + k] = c.iv[k];
            D[lo + k] = c.d[k];
        }
    }
}

// The end cell (len2, len1) from the final state at l1: score and ctype.
NABWA_HD void dp_end_cell(int32_t mn, int32_t in, int32_t dn, int32_t* score,
                          int32_t* ctype) {
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
