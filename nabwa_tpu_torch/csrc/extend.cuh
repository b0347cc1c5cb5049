// The per-job extension pass of kernel C6: the forward pass of
// aln_extend_core (stdaln.c:862-970) with an initial score g0 and a band
// that narrows to the positive cells, returning (score - 1, end_i, end_j),
// exactly as nabwa_tpu/ops/dp.py:264 `_extend_device` computes them (the
// C's `path_len == 0` mode, all bwasw's extend_left/rght consume,
// bwtsw2_aux.c:80-164).
//
// State, as in the jnp function: hd[i] = h[j-1][i-1] (the C's rolling
// eh_h, one column shifted), ev[i] = e[j-1][i], both len1+2 entries,
// zero but hd[1] = g0; the window [start, end) starts at [1, 2).  Row j,
// q = gap open, r = gap extension, q+r = qr:
//   sn = max(start, j - bw, 1),  en = min(end, j + bw, len1 + 1)
//   sn >= en: the job stops (the jnp `dead` row; sn > en cannot be reached
//             from a live row, and it would stop the job there too)
//   for i in [sn, en):
//     h0   = hd[i] > 0 ? hd[i] + mat[s2[j]][s1[i]] : 0
//     hpre = max(h0, ev[i])                       (the pre-F h)
//     g    = NEGF at i == sn, else max(g - r, hcut[i-1]),
//            hcut = max(hpre - qr, 0);  f = max(g, 0)
//     h    = max(hpre, f)
//     ev[i] = max(ev[i] - r, max(h - qr, 0))      (from the final h)
//     hd[i] = h[i-1]                              (0 at i == sn)
//   hd[en] = h[en-1], ev[en] = 0
// F comes from the pre-F h: g is the running max the jnp version takes as a
// cummax along the row.  The row's best cell is the first one at its
// maximum and replaces the job's best only when strictly greater; the
// next window is [first positive cell, last positive cell + 3).  The job
// stops after a row with no positive cell and after row len2.  Only the
// window's cells are computed (at most 2 bw + 1 a row); the jnp function
// masks every other cell of its padded row, and those never reach a
// window cell.  The state is zeroed over [0, len1+1] first, because a
// window that shrank and grew again reads cells written rows before, as
// the jnp function's persistent state does.
//
// Two forms of the same pass.  `extend_job` walks a row's window cell by
// cell in one thread: the serial reference the CPU tests build with g++.
// The kernel gives each job a warp and a row's window to its lanes, and
// runs the functions below it on one lane's cells (`ExtendChunk`): the
// window is cut into passes of 32 K cells, lane l taking the K cells from
// base + l K.  With hcut[k] + r k = u[k], g at i > sn is
//   g = max_{sn <= k < i} u[k] - r (i - 1),
// an exclusive max-scan of u along the row: each lane's max of u, scanned
// across the lanes (the carry-in `t`), then carried through its cells.
// hd[i] = h[i-1] takes the left lane's last h.  Everything a lane needs
// from another is passed in, so the CPU tests run a row lane by lane in
// order, combining the carries as the warp's shuffles do, at any number
// of lanes (csrc/host_harness.cpp).
//
// int32 without wrap: u = hcut + r i stays below 2^31 while r (len1 + 1)
// plus the largest score does (r <= 2^10 and len1 < 2^20 leave a wide
// margin); the scan's identity is NEGF = -2^29, and g is not formed from
// it: at i == sn g is NEGF itself, as in the serial pass.
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

constexpr int32_t EXTEND_NEGF = -(1 << 29);

// gap open q, gap extension r and the 5x5 score matrix
struct ExtendParams {
    int32_t q, r;
    int32_t mat[25];
};

NABWA_HD ExtendParams extend_params(const int32_t* w) {
    ExtendParams p;
    p.q = w[0];
    p.r = w[1];
    for (int j = 0; j < 25; ++j) p.mat[j] = w[2 + j];
    return p;
}

// One job, serially.  s1: target codes, 1-based (index 0 unused), len1 of
// them; s2: query codes, 1-based, len2 of them; g0 the initial score, bw
// the band.  hd/ev: the row state, len1+2 entries each.  Writes (score -
// 1, end_i, end_j) and the number of window cells computed.
NABWA_HD void extend_job(const ExtendParams& p, const int32_t* s1, int len1,
                         const int32_t* s2, int len2, int32_t g0, int32_t bw,
                         int32_t* hd, int32_t* ev, int32_t* score,
                         int32_t* end_i, int32_t* end_j, int32_t* cells) {
    const int32_t qr = p.q + p.r, r = p.r;
    for (int i = 0; i <= len1 + 1; ++i) {
        hd[i] = 0;
        ev[i] = 0;
    }
    hd[1] = g0;
    int32_t best = 0, bi = 0, bj = 0, n_cells = 0;
    int start = 1, end = 2;
    for (int j = 1; j <= len2; ++j) {
        int sn = j - bw > 1 ? j - bw : 1;
        if (start > sn) sn = start;
        int en = j + bw < len1 + 1 ? j + bw : len1 + 1;
        if (end < en) en = end;
        if (sn >= en) break;
        const int32_t* sub = p.mat + 5 * s2[j];
        int32_t h_left = 0;               // h[i-1], 0 left of the window
        int32_t g = EXTEND_NEGF;          // F's running max
        int32_t hcut_left = 0;            // max(hpre[i-1] - qr, 0)
        int32_t row_best = 0;
        int ns = -1, ne = -1, row_arg = 0;
        for (int i = sn; i < en; ++i) {
            const int32_t hdi = hd[i], evi = ev[i];
            const int32_t h0 = hdi > 0 ? hdi + sub[s1[i]] : 0;
            const int32_t hpre = h0 > evi ? h0 : evi;
            if (i > sn) {
                const int32_t gd = g - r;
                g = gd > hcut_left ? gd : hcut_left;
            }
            const int32_t f = g > 0 ? g : 0;
            const int32_t h = hpre > f ? hpre : f;
            const int32_t hc = h - qr > 0 ? h - qr : 0;
            const int32_t ed = evi - r;
            ev[i] = ed > hc ? ed : hc;
            hd[i] = h_left;
            hcut_left = hpre - qr > 0 ? hpre - qr : 0;
            if (h > 0) {
                if (ns < 0) ns = i;
                ne = i;
                if (h > row_best) {
                    row_best = h;
                    row_arg = i;
                }
            }
            h_left = h;
        }
        n_cells += en - sn;
        hd[en] = h_left;
        ev[en] = 0;
        if (ns < 0) break;
        if (row_best > best) {
            best = row_best;
            bi = row_arg;
            bj = j;
        }
        start = ns;
        end = ne + 3;
    }
    *score = best - 1;
    *end_i = bi;
    *end_j = bj;
    *cells = n_cells;
}

// ---- one lane's share of a row (the warp kernel) ----

// cells a lane takes in one pass of a row
constexpr int EXTEND_K = 4;

NABWA_HD int32_t ext_max(int32_t a, int32_t b) { return a > b ? a : b; }

// Row j's window [sn, en) from the band and the previous row's span.
NABWA_HD void extend_window(int j, int32_t bw, int len1, int start, int end,
                            int* sn, int* en) {
    int s = j - bw > 1 ? j - bw : 1;
    if (start > s) s = start;
    int e = j + bw < len1 + 1 ? j + bw : len1 + 1;
    if (end < e) e = end;
    *sn = s;
    *en = e;
}

// The cells [lo, lo + n) of a pass that one lane takes (n in 0..K).
NABWA_HD int extend_lane_cells(int base, int lane, int k, int en, int* lo) {
    *lo = base + lane * k;
    const int n = en - *lo;
    return n < 0 ? 0 : (n > k ? k : n);
}

// One lane's cells of a row: the previous row's e, the pre-F h, u and,
// after `extend_chunk_cells`, the final h and the new e (in ev).
template <int K>
struct ExtendChunk {
    int32_t ev[K], hpre[K], u[K], h[K];
};

// What the warp reduces over a row: the first and last positive cells
// (INT32_MAX and -1 when none) and the first cell at the largest h.
struct ExtendRowLane {
    int32_t first, last, best, arg;
};

NABWA_HD ExtendRowLane extend_row_lane() {
    ExtendRowLane r;
    r.first = 0x7FFFFFFF;
    r.last = -1;
    r.best = 0;
    r.arg = 0;
    return r;
}

// Step 1: the lane's reads of the previous row and s1 (target codes, int32
// or bytes), hpre and u; returns the lane's max of u (NEGF for no cell).
// Cells k >= n are set to 0 and take no part.
template <int K, class Code>
NABWA_HD int32_t extend_chunk_load(const ExtendParams& p, const int32_t* sub,
                                   const Code* s1, const int32_t* hd,
                                   const int32_t* ev, int lo, int n,
                                   ExtendChunk<K>& c) {
    const int32_t qr = p.q + p.r;
    int32_t agg = EXTEND_NEGF;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        c.ev[k] = c.hpre[k] = c.u[k] = c.h[k] = 0;
        if (k < n) {
            const int i = lo + k;
            const int32_t hdi = hd[i], evi = ev[i];
            const int32_t h0 = hdi > 0 ? hdi + sub[s1[i]] : 0;
            c.ev[k] = evi;
            c.hpre[k] = ext_max(h0, evi);
            c.u[k] = ext_max(c.hpre[k] - qr, 0) + p.r * i;
            agg = ext_max(agg, c.u[k]);
        }
    }
    return agg;
}

// Step 2: given t, the max of u over the window's cells left of lo (NEGF
// for none), F, h and the new e of the lane's cells, and the lane's
// share of the row's reductions.
template <int K>
NABWA_HD void extend_chunk_cells(const ExtendParams& p, int sn, int lo, int n,
                                 int32_t t, ExtendChunk<K>& c,
                                 ExtendRowLane& red) {
    const int32_t qr = p.q + p.r, r = p.r;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (k < n) {
            const int i = lo + k;
            const int32_t g = i == sn ? EXTEND_NEGF : t - r * (i - 1);
            const int32_t h = ext_max(c.hpre[k], ext_max(g, 0));
            c.h[k] = h;
            c.ev[k] = ext_max(c.ev[k] - r, ext_max(h - qr, 0));
            t = ext_max(t, c.u[k]);
            if (h > 0) {
                if (red.first > i) red.first = i;
                red.last = i;
                if (h > red.best) {
                    red.best = h;
                    red.arg = i;
                }
            }
        }
    }
}

// Step 3: the lane's writes of the new row, h_left being h at lo - 1 (0
// at sn); then the lane holding en - 1 writes hd[en] and ev[en].
template <int K>
NABWA_HD void extend_chunk_store(int lo, int n, int en, int32_t h_left,
                                 const ExtendChunk<K>& c, int32_t* hd,
                                 int32_t* ev) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (k < n) {
            hd[lo + k] = h_left;
            ev[lo + k] = c.ev[k];
            h_left = c.h[k];
        }
    }
    if (n > 0 && lo + n == en) {
        hd[en] = h_left;
        ev[en] = 0;
    }
}

// After row j, with the row's reductions over every lane: the job's best
// (replaced only by a strictly larger row best) and the next window;
// false when the job stops.
NABWA_HD bool extend_row_end(const ExtendRowLane& row, int j, int32_t* best,
                             int32_t* bi, int32_t* bj, int* start, int* end) {
    if (row.last < 0) return false;
    if (row.best > *best) {
        *best = row.best;
        *bi = row.arg;
        *bj = j;
    }
    *start = row.first;
    *end = row.last + 3;
    return true;
}

}  // namespace nabwa
