// The local Smith-Waterman forward pass of kernel C5: the best score of
// aln_local_core's forward lattice (stdaln.c:556-637) and its cell,
// exactly as nabwa_tpu/ops/dp.py:404 `_local_fwd_device` computes them
// (mate rescue of sampe, bwa_sw_core bwape.c:433-517).
//
// The recurrence, row j over columns 1..len1, q = gap open, r = gap ext:
//   hd      = h[j-1][i-1]                     (0 at column 1)
//   hp0     = max(hd + mat[s2[j]][s1[i]], 0)
//   e       = h[j-1][i] > q+r ? max(e[j-1][i] - r, h[j-1][i] - q - r) : 0
//             (the E chain is gated per column: the C's NT_LOCAL_SCORE
//             packing drops e when h does not fit)
//   hpre    = max(hp0, e)                     (the pre-F h)
//   g       = NEGF at column 1, else max(g - r, hcut[i-1])
//   f       = max(g, 0),  hcut = max(hpre - q - r, 0)
//   h       = max(hpre, f)
// F comes from the pre-F h: g is the running max that the jnp version
// takes as a cummax along the row.  It is not rewritten into the C's
// freeze-over-zero rule, which the jnp docstring argues is equal; the tests
// hold this code to the jnp function.  The best cell is the first cell in
// row-major order that attains the maximum (strict '>' in a sequential
// scan); score starts at 0, so a window with no positive cell gives
// (0, 0, 0).  Rows past len2 and columns past len1 are never computed:
// the jnp version masks them (its padding is code 4) and they cannot reach
// a cell inside.  The scalar model's overflow reduce
// (LOCAL_OVERFLOW_THRESHOLD 32000, refmodel/local_aln_scalar.py:23) is not
// in the jnp function, so it is not here either: scores stay below
// 11 * len2.
//
// Two forms of the same pass.  `local_fwd_pair` walks a row cell by cell
// in one thread: the serial reference the CPU tests build with g++.  The
// kernel gives each job a warp and cuts the window's columns into chunks of
// K contiguous cells, lane l taking [base + l K, base + (l+1) K), and runs
// the functions below it on one lane's chunk (`LocalChunk`).  With
// u[k] = hcut[k] + r k, g at column i > 1 is
//   g = max_{1 <= k < i} u[k] - r (i - 1),
// an exclusive max-scan of u along the row: each lane's max of u, scanned
// across the lanes (the carry-in `t`), then carried through its cells; at
// column 1 t is NEGF and g = NEGF - 0 as in the serial pass.  hd at a
// chunk's first column is the left lane's last h of row j-1, taken before
// that lane overwrites it.  Each lane keeps its own best cell with strict
// '>' over its cells in row-major order; the first row-major cell at the
// job's maximum is then the least (j, i) among the lanes at the maximum.
// Everything a lane needs from another is passed in, so the CPU tests run
// a job lane by lane in lane order, combining the carries as the warp's
// shuffles do, at any number of lanes (csrc/host_harness.cpp).
//
// int32 without wrap: u = hcut + r i stays below 2^31 while r (len1 + 1)
// plus the largest score does (r <= 2^10 and len1 < 2^20 leave a wide
// margin).
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

constexpr int32_t LOCAL_NEGF = -(1 << 29);

// gap open q, gap extension r and the 5x5 score matrix
struct LocalParams {
    int32_t q, r;
    int32_t mat[25];
};

NABWA_HD LocalParams local_params(const int32_t* w) {
    LocalParams p;
    p.q = w[0];
    p.r = w[1];
    for (int j = 0; j < 25; ++j) p.mat[j] = w[2 + j];
    return p;
}

// One pair.  s1: reference window codes, 1-based (index 0 unused), len1 of
// them; s2: read codes, 1-based, len2 of them.  h/e: one row of state,
// column i at [i * stride] (the kernel interleaves the pairs of a batch so
// that neighbouring threads touch neighbouring words), len1+1 entries.
NABWA_HD void local_fwd_pair(const LocalParams& p, const int32_t* s1,
                             int len1, const int32_t* s2, int len2,
                             int32_t* h, int32_t* e, size_t stride,
                             int32_t* score, int32_t* end_i,
                             int32_t* end_j) {
    const int32_t qr = p.q + p.r, r = p.r;
    for (int i = 0; i <= len1; ++i) {
        h[i * stride] = 0;
        e[i * stride] = 0;
    }
    int32_t best = 0, bi = 0, bj = 0;
    for (int j = 1; j <= len2; ++j) {
        const int32_t* sub = p.mat + 5 * s2[j];
        int32_t hd = 0;                   // h[j-1][i-1]
        int32_t g = LOCAL_NEGF;           // F's running max
        int32_t hcut_left = 0;            // hcut[i-1]
        for (int i = 1; i <= len1; ++i) {
            const int32_t hp = h[i * stride], ep = e[i * stride];
            int32_t hp0 = hd + sub[s1[i]];
            hp0 = hp0 > 0 ? hp0 : 0;
            int32_t ev = 0;
            if (hp > qr) {
                const int32_t a = ep - r, b = hp - qr;
                ev = a > b ? a : b;
            }
            const int32_t hpre = hp0 > ev ? hp0 : ev;
            if (i > 1) {
                const int32_t gd = g - r;
                g = gd > hcut_left ? gd : hcut_left;
            }
            const int32_t f = g > 0 ? g : 0;
            const int32_t hv = hpre > f ? hpre : f;
            const int32_t hc = hpre - qr;
            hcut_left = hc > 0 ? hc : 0;
            hd = hp;
            h[i * stride] = hv;
            e[i * stride] = ev;
            if (hv > best) {
                best = hv;
                bi = i;
                bj = j;
            }
        }
    }
    *score = best;
    *end_i = bi;
    *end_j = bj;
}

// ---- one lane's chunk of a row (the warp kernel) ----

// cells a lane takes at most in the register form: windows up to
// 32 LOCAL_K_MAX columns keep the whole row in the warp's registers (a
// register form of 32 cells a lane was no faster on the H100 than the
// wide form's passes at 513-1,024 columns; PERF.md gives both times)
constexpr int LOCAL_K_MAX = 16;
// cells a lane takes in each pass of a wider window's row
constexpr int LOCAL_K_WIDE = 16;

NABWA_HD int32_t lsw_max(int32_t a, int32_t b) { return a > b ? a : b; }

// The register form's cells a lane for windows of L1 columns: the smallest
// of 2, 4, 8, 16 whose 32 lanes cover L1; 0 when none does (the wide
// form, in passes of 32 LOCAL_K_WIDE cells).
NABWA_HD int local_lane_k(int L1) {
    for (int k = 2; k <= LOCAL_K_MAX; k <<= 1)
        if (32 * k >= L1) return k;
    return 0;
}

// A warp's row state in the wide form at L1 columns, in bytes: h and e,
// then the window's codes as bytes, rounded up to 16.
NABWA_HD size_t local_wide_bytes(int L1) {
    return (9 * ((size_t)L1 + 1) + 15) & ~(size_t)15;
}

// C5's form at windows of L1 columns, with at most smem_budget bytes of
// shared memory for one warp's row state: the register form
// (LOCAL_REGISTERS, local_lane_k cells a lane), else the wide form with
// the row state in shared memory (LOCAL_SHARED) if it fits the budget and
// in device memory (LOCAL_DEVICE) if not, LOCAL_K_WIDE cells a lane.  *k
// gets the cells a lane.
enum { LOCAL_REGISTERS = 0, LOCAL_SHARED = 1, LOCAL_DEVICE = 2 };

NABWA_HD int local_form(int L1, size_t smem_budget, int* k) {
    *k = local_lane_k(L1);
    if (*k) return LOCAL_REGISTERS;
    *k = LOCAL_K_WIDE;
    return local_wide_bytes(L1) <= smem_budget ? LOCAL_SHARED : LOCAL_DEVICE;
}

// One lane's chunk: h and e of its cells, row j-1's until step 1, then
// row j's e and pre-F h, then (after step 2) row j's h.  Cells k >= n are
// outside the window: they hold 0 and take no part.
template <int K>
struct LocalChunk {
    int32_t h[K], e[K];
};

// A lane's best cell so far: strict '>' over its cells in row-major order.
struct LocalBest {
    int32_t best, bi, bj;
};

NABWA_HD LocalBest local_best() {
    LocalBest b;
    b.best = b.bi = b.bj = 0;
    return b;
}

// Step 1: row j's gated e and pre-F h of the lane's n cells from lo, given
// sub (the score matrix's row of s2[j]), the lane's window codes `code`
// (any indexable of K codes) and hd_in, h[j-1][lo-1].  Returns the lane's
// max of u (NEGF for no cell).
template <int K, class Codes>
NABWA_HD int32_t local_chunk_pre(const LocalParams& p, const int32_t* sub,
                                 const Codes& code, int lo, int n,
                                 int32_t hd_in, LocalChunk<K>& c) {
    const int32_t qr = p.q + p.r, r = p.r;
    int32_t agg = LOCAL_NEGF, hd = hd_in;
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int k = 0; k < K; ++k) {
        if (k < n) {
            const int32_t hp = c.h[k], ep = c.e[k];
            const int32_t hp0 = lsw_max(hd + sub[code[k]], 0);
            const int32_t ev = hp > qr ? lsw_max(ep - r, hp - qr) : 0;
            const int32_t hpre = lsw_max(hp0, ev);
            c.e[k] = ev;
            c.h[k] = hpre;
            agg = lsw_max(agg, lsw_max(hpre - qr, 0) + r * (lo + k));
            hd = hp;
        }
    }
    return agg;
}

// Step 2: given t, the max of u over the row's cells left of lo (NEGF for
// none), F and h of the lane's cells, and the lane's best cell.
template <int K>
NABWA_HD void local_chunk_cells(const LocalParams& p, int j, int lo, int n,
                                int32_t t, LocalChunk<K>& c, LocalBest& best) {
    const int32_t qr = p.q + p.r, r = p.r;
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int k = 0; k < K; ++k) {
        if (k < n) {
            const int i = lo + k;
            const int32_t hpre = c.h[k];
            const int32_t h = lsw_max(hpre, lsw_max(t - r * (i - 1), 0));
            c.h[k] = h;
            t = lsw_max(t, lsw_max(hpre - qr, 0) + r * i);
            if (h > best.best) {
                best.best = h;
                best.bi = i;
                best.bj = j;
            }
        }
    }
}

// Whether lane a's best cell goes before lane b's in the job's answer: the
// higher score, then the first in row-major order.
NABWA_HD bool local_best_before(const LocalBest& a, const LocalBest& b) {
    if (a.best != b.best) return a.best > b.best;
    if (a.bj != b.bj) return a.bj < b.bj;
    return a.bi < b.bi;
}

}  // namespace nabwa
