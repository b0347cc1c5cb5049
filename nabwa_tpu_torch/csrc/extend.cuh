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
// window cell.  The scratch is zeroed over [0, len1+1] first, because a
// window that shrank and grew again reads cells written rows before, as
// the jnp function's persistent state does.
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

// One job.  s1: target codes, 1-based (index 0 unused), len1 of them; s2:
// query codes, 1-based, len2 of them; g0 the initial score, bw the band.
// hd/ev: the row state, column i at [i * stride] (the kernel interleaves
// the jobs of a batch so that neighbouring threads touch neighbouring
// words), len1+2 entries each.  Writes (score - 1, end_i, end_j) and the
// number of window cells computed.
NABWA_HD void extend_job(const ExtendParams& p, const int32_t* s1, int len1,
                         const int32_t* s2, int len2, int32_t g0, int32_t bw,
                         int32_t* hd, int32_t* ev, size_t stride,
                         int32_t* score, int32_t* end_i, int32_t* end_j,
                         int32_t* cells) {
    const int32_t qr = p.q + p.r, r = p.r;
    for (int i = 0; i <= len1 + 1; ++i) {
        hd[i * stride] = 0;
        ev[i * stride] = 0;
    }
    hd[stride] = g0;
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
            const int32_t hdi = hd[i * stride], evi = ev[i * stride];
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
            ev[i * stride] = ed > hc ? ed : hc;
            hd[i * stride] = h_left;
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
        hd[en * stride] = h_left;
        ev[en * stride] = 0;
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

}  // namespace nabwa
