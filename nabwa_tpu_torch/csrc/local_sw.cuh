// The per-pair local Smith-Waterman forward pass of kernel C5: the best
// score of aln_local_core's forward lattice (stdaln.c:556-637) and its
// cell, exactly as nabwa_tpu/ops/dp.py:404 `_local_fwd_device` computes
// them (mate rescue of sampe, bwa_sw_core bwape.c:433-517).
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

}  // namespace nabwa
