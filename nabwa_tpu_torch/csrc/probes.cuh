// The per-read and per-copy arithmetic of the probe kernels C7-C10
// (probe_rowload.cu, probe_dma.cu, probe_dfs_shape.cu): int32 arithmetic
// that wraps as jnp's does, the floor modulo of jnp's `%`, the row indices
// of scripts/probe_dma.py, and the staged-row counts and the candidate
// expansion of the two DFS-iteration mocks.
//
// Signed overflow is undefined in C++, and jnp's int32 `+`, `-` and `*`
// wrap: they go through uint32_t here and are cast back.  `>>` stays on
// int32_t, arithmetic as jnp's is (probe_dfs_shape.py:82, :87).
//
// Everything here is NABWA_HD, so the host harness (host_harness.cpp)
// compiles the same source for the CPU tests.

#pragma once

#include <cstdint>

#include "occ.cuh"

namespace nabwa {
namespace probe {

constexpr int32_t FREE_KEY = 0x7FFFFFFF;

NABWA_HD int32_t wadd(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

NABWA_HD int32_t wsub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

NABWA_HD int32_t wmul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}

// jnp's `%` for n > 0: the result takes the divisor's sign, where C's `%`
// takes the dividend's.  Equal to ((x % n) + n) % n without its overflow
// for n above 2^30.
NABWA_HD int32_t floor_mod(int32_t x, int32_t n) {
    const int32_t r = x % n;
    return r < 0 ? r + n : r;
}

// one step of probe_dma.py's register LCG (:50)
NABWA_HD int32_t lcg_next(int32_t s) {
    return wadd(wmul(s, 1103515245), 12345) & 0x7FFFFFFF;
}

// column c of probe_dma.py's (8, 128) index vector at iteration t (:40-41);
// every one of its 8 rows holds the same values
NABWA_HD int32_t dma_vec_row(int32_t c, int32_t t, int32_t n_rows) {
    return floor_mod(wadd(wmul(c, 12345), wmul(t, 1103515245)), n_rows);
}

// probe_dfs_shape.py:60-72 for word w of a staged 128-word row whose first
// two words are w0 and w1: the masked popcounts of the word, 0 outside the
// row's 8-word block
NABWA_HD int32_t shape_word_count(int32_t x, int32_t w, int32_t w0,
                                  int32_t w1) {
    const int32_t rel = w - (w0 & 7) * 16;
    if (rel < 4 || rel >= 12) return 0;
    const int32_t wordoff = (w1 >> 4) & 7;
    const int32_t vm = rel - 4 < wordoff ? -1
                       : rel - 4 == wordoff ? -65536 : 0;
    const uint32_t lo = (uint32_t)(x & vm & 0x55555555);
    const uint32_t hi = (uint32_t)((x >> 1) & vm & 0x55555555);
    const uint32_t p1 = popc(lo), p2 = popc(hi), p3 = popc(lo & hi);
    return (int32_t)(p1 - p3 + p2 + p3 * 2);
}

// probe_dfs_shape.py:78-87: the ten rounds of column arithmetic from the
// popped entry's first two fields and the two rows' counts.  Candidate j is
// a + j, pushed when bit j of b is 0.
NABWA_HD void shape_expand(int32_t e0, int32_t e1, int32_t cnt_k,
                           int32_t cnt_l, int32_t* a_out, int32_t* b_out) {
    int32_t a = wadd(e0, cnt_k);
    int32_t b = wadd(e1, cnt_l);
    for (int32_t j = 0; j < 10; ++j) {
        a = a > b ? wsub(a, b) : wadd(a, j);
        b = b ^ (a >> 2);
        a = wadd(a, b & 15);
        const int32_t cap = wadd(a, 37);
        b = b < cap ? b : cap;
    }
    *a_out = a;
    *b_out = b;
}

// probe_pallas.py:258-263 for one word of the bank-0 row: adds its
// popcount of lo to c1 and of lo & hi to c3
NABWA_HD void pallas_word_counts(int32_t x, uint32_t* c1, uint32_t* c3) {
    const uint32_t lo = (uint32_t)(x & 0x55555555);
    const uint32_t hi = (uint32_t)((x >> 1) & 0x55555555);
    *c1 += popc(lo);
    *c3 += popc(lo & hi);
}

}  // namespace probe
}  // namespace nabwa
