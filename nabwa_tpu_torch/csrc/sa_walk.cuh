// The per-row bwt_sa walk of kernel C3 (bwt.c:72-81): from a suffix-array
// row, invPsi steps (bwt.h:71-75) to a sampled row, then that row's sample
// plus the step count.  Semantics are those of
// nabwa_tpu/ops/sa_lookup.py:34 (`_sa_lookup_impl`): uint32 rows and
// unsigned compares, the `$` row (k == primary) steps to row 0, and row 0's
// sample is the reference's -1, so the sum wraps like `sa + (-1)`.
//
// A step is one lookup in one 48 B Occ block (occ.cuh): for k != primary
// the base at string position kk (k > primary ? k - 1 : k) and occ4(k)'s
// row are the same kk, so the base is read from the block's own bwt word,
// not loaded again.  The block is three 16 B pieces (the four counters,
// bwt words 4-7, words 8-11), loaded together.  Only base c is counted
// (`count_base`), and l2[c] + counter[c] is picked from four sums made
// before c is known, so nothing on a step's chain indexes an array with
// c.
//
// The interval test has no division: a power of two (the index default)
// masks and shifts (`IntvPow2`), any other interval divides by a
// multiply-high reciprocal (`IntvMagic`), exact for every uint32 row.
//
// Everything here is NABWA_HD: nvcc compiles it into sa_lookup.cu, and the
// host harness builds the same source for the CPU tests.

#pragma once

#include "occ.cuh"

namespace nabwa {

NABWA_HD uint32_t mulhi(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    return __umulhi(a, b);
#else
    return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// sa_intv = 1 << shift: sampled rows are those with k & mask == 0
struct IntvPow2 {
    uint32_t mask, shift;
    NABWA_HD bool sampled(uint32_t k) const { return (k & mask) == 0; }
    NABWA_HD uint32_t quot(uint32_t k) const { return k >> shift; }
};

// any sa_intv d >= 2: k / d as mulhi by m = floor(2^(32+s) / d) - 2^32 + 1,
// s = ceil(log2 d), then (t + ((k - t) >> 1)) >> (s - 1) (Granlund and
// Montgomery's round-up method), exact for every uint32 k
struct IntvMagic {
    uint32_t d, m, s1;
    NABWA_HD uint32_t quot(uint32_t k) const {
        const uint32_t t = mulhi(m, k);
        return (t + ((k - t) >> 1)) >> s1;
    }
    NABWA_HD bool sampled(uint32_t k) const { return quot(k) * d == k; }
};

NABWA_HD bool is_pow2(uint32_t d) { return d != 0 && (d & (d - 1)) == 0; }

NABWA_HD IntvPow2 intv_pow2(uint32_t d) {
    uint32_t shift = 0;
    while ((1u << shift) < d) ++shift;
    return IntvPow2{d - 1, shift};
}

// d in [3, 2^31), not a power of two
NABWA_HD IntvMagic intv_magic(uint32_t d) {
    uint32_t s = 0;
    while ((1ull << s) < d) ++s;
    const uint64_t m = ((uint64_t)1 << (32 + s)) / d - ((uint64_t)1 << 32)
                       + 1;
    return IntvMagic{d, (uint32_t)m, s - 1};
}

// One strand's bank, sampled suffix array and `$` row.
struct SaStrand {
    const uint32_t* bank;
    const uint32_t* sa;
    uint32_t primary;
};

// v[sel] for sel in 0..3, a tree of selects (no indexed array)
NABWA_HD uint32_t pick4(const uint32_t v[4], uint32_t sel) {
    const uint32_t lo = sel & 1 ? v[1] : v[0];
    const uint32_t hi = sel & 1 ? v[3] : v[2];
    return sel & 2 ? hi : lo;
}

// the $-removed row of k != primary: occ4's and the base's row
NABWA_HD uint32_t sa_kk(uint32_t k, uint32_t primary) {
    return k > primary ? k - 1 : k;
}

// the base at row kk, read from the piece holding its word
NABWA_HD uint32_t sa_piece_base(const uint32_t w[4], uint32_t kk) {
    return (pick4(w, (kk >> 4) & 3) >> ((~kk & 15u) << 1)) & 3u;
}

// Base c's count in bwt piece `piece` (1 or 2: words 4-7 or 8-11 of kk's
// block) over the positions up to kk.
NABWA_HD uint32_t sa_piece_count(const uint32_t w[4], uint32_t kk,
                                 uint32_t c, int piece) {
    const uint32_t word_off = (kk >> 4) & 7, within = kk & 15;
    uint32_t n = 0;
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int m = 0; m < 4; ++m) {
        const uint32_t j = 4 * (piece - 1) + m;
        const uint32_t valid = j < word_off ? 16
                             : j == word_off ? within + 1 : 0;
        n += count_base(w[m], c, valid);
    }
    return n;
}

// invPsi(k) = l2[c] + occ4(k)[c] for k != primary: the block's three
// pieces loaded at once, the base from its own word, one count, and
// l2[c] + counter[c] picked from the four sums.
NABWA_HD uint32_t sa_step(const SaStrand& s, const uint32_t l2[4],
                          uint32_t k) {
    const uint32_t kk = sa_kk(k, s.primary);
    const uint32_t* blk = s.bank + (size_t)(kk >> 7) * 12;
    uint32_t w0[4], w1[4], w2[4];
    load_piece(blk, 0, w0);
    load_piece(blk, 1, w1);
    load_piece(blk, 2, w2);
    const uint32_t c = (kk >> 6) & 1 ? sa_piece_base(w2, kk)
                                     : sa_piece_base(w1, kk);
    const uint32_t base[4] = {l2[0] + w0[0], l2[1] + w0[1], l2[2] + w0[2],
                              l2[3] + w0[3]};
    return pick4(base, c) + sa_piece_count(w1, kk, c, 1)
           + sa_piece_count(w2, kk, c, 2);
}

// bwt_sa for one row k <= seq_len.
template <class Intv>
NABWA_HD uint32_t sa_walk_row(const SaStrand& s, const uint32_t l2[4],
                              const Intv& iv, uint32_t k) {
    uint32_t steps = 0;
    while (!iv.sampled(k)) {
        k = k == s.primary ? 0 : sa_step(s, l2, k);
        ++steps;
    }
    const uint32_t q = iv.quot(k);
    return steps + (q == 0 ? NEG1 : s.sa[q]);
}

}  // namespace nabwa
