// The per-read and per-copy arithmetic of the probe kernels C7-C35
// (probe_rowload.cu, probe_dma.cu, probe_dfs_shape.cu, probe_pallas2.cu,
// probe_pallas.cu, probe_spill.cu, probe_colops.cu, probe_pallas3.cu):
// int32 arithmetic that wraps as jnp's does, the floor modulo of jnp's
// `%`, the row indices of scripts/probe_dma.py, the staged-row counts and
// the candidate expansion of the two DFS-iteration mocks (and C9's lean
// form's count from the block's side and its push from the slots' side),
// the rows of probe_pallas2.py's row loads that each warp copies, one slot
// of its pop and the fields of its scalar push, the popcount of
// probe_pallas.py's probe 3, one slot and a lane's share of a row's round
// of its probes 4 and 4b, one step of probe 4c's body, one value's update
// of probe_spill.py and a lane's round of C23's lane form, one step of
// probe_colops.py, one step of probe_pallas3.py's p7 and p8, the source
// of p4's relayout, the source word of p2's rotation and a lane's step of
// C32's lane form, p5's trip count and a thread's rounds of C34's grid
// form, and C35's staging of a tile and its sums in index order.
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

// the state of that LCG k >= 0 steps after s.  The mask keeps the low 31
// bits of a wrapped product, so a step is s -> (a s + c) mod 2^31 and k
// steps are one affine map (A_k, C_k) mod 2^31, built here by squaring
// in log2(k) steps (mod 2^32, which 2^31 divides).  k = 0 leaves s as it
// is, unmasked.
NABWA_HD int32_t lcg_jump(int32_t s, int64_t k) {
    if (k <= 0) return s;
    uint32_t a_k = 1, c_k = 0, a = 1103515245u, c = 12345u;
    for (; k; k >>= 1) {
        if (k & 1) {
            a_k *= a;
            c_k = c_k * a + c;
        }
        c = c * a + c;
        a *= a;
    }
    return (int32_t)((a_k * (uint32_t)s + c_k) & 0x7FFFFFFFu);
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

// probe_dfs_shape.py:59-73 from the block's side.  A staged row's count is
// the sum of shape_word_count over its 8-word block, words 4 to 11 past
// (w0 & 7) * 16, and nothing else.  Block word i (0..7) lies in component
// i & 3 of lane shape_block_lane(w0, i) of a warp holding the row as one
// int4 a lane, and shape_block_count is its count: i against the word
// offset, (w1 >> 4) & 7, gives its mask vm, and since vm's bits are equal in
// each bit pair, p1 - p3 + p2 + 2 p3 is popc(x & vm) + popc(x & (x >> 1)
// & vm & 0x55555555).  Only w0's low 3 bits matter.
NABWA_HD int32_t shape_block_lane(int32_t w0, int32_t i) {
    return (w0 & 7) * 4 + 1 + (i >> 2);
}

NABWA_HD int32_t shape_block_count(int32_t x, int32_t i, int32_t wordoff) {
    const int32_t vm = i < wordoff ? -1 : i == wordoff ? -65536 : 0;
    return (int32_t)(popc((uint32_t)(x & vm))
                     + popc((uint32_t)(x & (x >> 1) & vm & 0x55555555)));
}

// probe_dfs_shape.py:104-118 from the slots' side: the free slot of
// inclusive rank r (1-based, in slot order) takes the r-th valid
// candidate, the r-th set bit of `valid` (~b & 0x1FF), when r is at most
// its popcount; none otherwise.  push_nth(valid, t) is that bit for
// r = t + 1, and 9 when fewer than t + 1 bits are set: the count of
// positions q < 9 whose inclusive prefix of valid holds at most t bits
// (9 less those holding more, each a sign bit, for t >= 0).  Lane t of a
// warp computes it for t = lane, and a slot of rank r reads
// lane push_lane(r): ranks past 9 read lane 9, whose answer is 9.
NABWA_HD int32_t push_nth(uint32_t valid, int32_t t) {
    int32_t more = 0;      // minus the prefixes holding more than t bits
    for (int32_t q = 0; q < 9; ++q)
        more += (t - (int32_t)popc(valid & ((2u << q) - 1u))) >> 31;
    return 9 + more;
}

NABWA_HD int32_t push_lane(int32_t r) {
    return (r < 10 ? r : 10) - 1;
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

// C12's grid form (probe_pallas2.py:55): blocks of `warps` warps, each warp
// copying one of the 2 bb output rows a step.  The grid: enough blocks for
// one row a warp, at most max_blocks (then the warps walk on by the grid's
// width of warps a step).
NABWA_HD int32_t loads_blocks(int32_t bb, int32_t warps, int32_t max_blocks) {
    const int64_t need = (2 * (int64_t)bb + warps - 1) / warps;
    return need < max_blocks ? (int32_t)need : max_blocks;
}

// the output row that warp `warp` of block `block` copies at step `step`
// of a grid of `blocks` such blocks; a warp stops at its first row past
// 2 bb, and the rows rise with the step, so that row masks the ragged edge
NABWA_HD int64_t loads_out_row(int32_t block, int32_t warp, int32_t step,
                               int32_t warps, int32_t blocks) {
    return ((int64_t)step * blocks + block) * warps + warp;
}

// where output row r reads its table row's index: idx[r, 0] for r < bb,
// idx[r - bb, 1] after, in an idx of idx_w words a row
NABWA_HD int64_t loads_idx_at(int64_t r, int32_t bb, int32_t idx_w) {
    return r < bb ? r * idx_w : (r - bb) * idx_w + 1;
}

// probe_pallas2.py:191-193 for one slot of the pop: a slot equal to its
// row's minimum mk adds its f to the row's sum e1 (wrapping) and is
// cleared; any other slot stays
NABWA_HD int32_t pop_take(int32_t key, int32_t f, int32_t mk, uint32_t* e1) {
    if (key != mk) return key;
    *e1 += (uint32_t)f;
    return FREE_KEY;
}

// probe_pallas.py:100 (`lax.population_count` of an int32): the set bits
// of all 32, the sign bit included
NABWA_HD uint32_t popcount32(int32_t x) {
    return popc((uint32_t)x);
}

// probe_pallas.py:126-127 and :165-166 for one slot of a round: a slot
// equal to its row's minimum m gets + 7 (wrapping), any other stays
NABWA_HD int32_t while_step(int32_t key, int32_t m) {
    return key == m ? wadd(key, 7) : key;
}

// A round of C17's and C18's row (probe_pallas.cu) over a warp, lane l
// holding the row's slots 4 l .. 4 l + 3 in k[0..3]: the lane's minimum
// (while_lane_min), the row's minimum m over the warp's lanes (one
// redux.sync on the card), then while_lane_round: each of the lane's keys
// against m and m's add into the row's sum.  The sum is uint32, so that
// it wraps as jnp's int32 sum does, and every lane holds the same one.
// C17's carry is the rows' sums added as uint32, in any order.
NABWA_HD int32_t while_lane_min(const int32_t* k) {
    const int32_t a = k[0] < k[1] ? k[0] : k[1];
    const int32_t b = k[2] < k[3] ? k[2] : k[3];
    return a < b ? a : b;
}

NABWA_HD void while_lane_round(int32_t* k, int32_t m, uint32_t* sum) {
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = while_step(k[j], m);
    *sum += (uint32_t)m;
}

// probe_pallas.py:202-204, step j (>= 0) of probe 4c's inner loop: + j
// where the low 3 bits equal j % 8 (wrapping), then p ^= p >> 3
// (arithmetic) and p += p << 1 (wrapping)
NABWA_HD int32_t body_step(int32_t p, int32_t j) {
    if ((p & 7) == j % 8) p = wadd(p, j);
    p = p ^ (p >> 3);
    return wadd(p, (int32_t)((uint32_t)p << 1));
}

// probe_pallas2.py:124-129, field k (0..4) of a push of candidate v: v,
// v + 1, v ^ 3, v - 7, v * 3, wrapping
NABWA_HD int32_t push_fields(int32_t v, int32_t k) {
    switch (k) {
        case 0: return v;
        case 1: return wadd(v, 1);
        case 2: return v ^ 3;
        case 3: return wsub(v, 7);
        default: return wmul(v, 3);
    }
}

// probe_spill.py:31-32, value v's update from its neighbour `next` (the
// old v_{(i+1) mod K}): (v * 3 + 1) ^ (next >> 2), wrapping, arithmetic
NABWA_HD int32_t spill_update(int32_t v, int32_t next) {
    return wadd(wmul(v, 3), 1) ^ (next >> 2);
}

// C23's lane form (probe_spill.cu): an element's K values over a group of
// `lanes` lanes (a power of two dividing K), lane l of the group holding
// the m = K / lanes values v_{l m} .. v_{l m + m - 1} in order, from
// spill_lane_init.  A round needs one value the lane does not hold: the
// old v_{(l + 1) m mod K}, the first value of lane spill_next_lane(l) (its
// own v_0 in a one-lane group), read before any lane updates (a shuffle
// within the group on the card).  spill_lane_round takes it as `next`
// and updates the lane's values in place in index order: v_j's neighbour
// v_{j + 1} is still the old value when v_j is written, and the last
// value takes `next`.  The element's sum is the lanes' spill_lane_sum
// added over the group in any order (uint32 wraps).
NABWA_HD void spill_lane_init(int32_t x0, int32_t l, int32_t m, int32_t* v) {
#pragma unroll
    for (int32_t j = 0; j < m; ++j) v[j] = wadd(x0, l * m + j);
}

NABWA_HD int32_t spill_next_lane(int32_t l, int32_t lanes) {
    return (l + 1) & (lanes - 1);
}

NABWA_HD void spill_lane_round(int32_t* v, int32_t m, int32_t next) {
#pragma unroll
    for (int32_t j = 0; j + 1 < m; ++j) v[j] = spill_update(v[j], v[j + 1]);
    v[m - 1] = spill_update(v[m - 1], next);
}

NABWA_HD uint32_t spill_lane_sum(const int32_t* v, int32_t m) {
    uint32_t acc = 0;
#pragma unroll
    for (int32_t j = 0; j < m; ++j) acc += (uint32_t)v[j];
    return acc;
}

// probe_colops.py:30, one of the K dependent steps: (v * 3 + 1) ^ (v >> 2)
NABWA_HD int32_t colops_step(int32_t v) {
    return spill_update(v, v);
}

// probe_pallas3.py:207, step i of p7's 200: (v + i) ^ (v >> 2), wrapping
NABWA_HD int32_t p7_step(int32_t v, int32_t i) {
    return wadd(v, i) ^ (v >> 2);
}

// probe_pallas3.py:228, step i of p8's 30 against the row's scalar a:
// where(v > a, v - a, v + i), wrapping
NABWA_HD int32_t p8_step(int32_t v, int32_t a, int32_t i) {
    return v > a ? wsub(v, a) : wadd(v, i);
}

// probe_pallas3.py:142, p4's relayout out = x[:, :16].reshape(R / 8, 128)
// read four words at a time: out's int4 q is x's int4 q % 4 of row q / 4
// (each out row holds the first 16 words of 8 rows of x, in order), for x
// of `quads` int4 a row.  The result is an int4 of x, so it fits when x
// holds fewer than 2^31 words.
NABWA_HD int32_t relayout_src(int32_t q, int32_t quads) {
    return (q >> 2) * quads + (q & 3);
}

// probe_pallas3.py:99, p2's `pltpu.roll(m, sh, 1)` over a row of n words
// moves word c to (c + sh) mod n, as np.roll does: word c of the rotated
// row is word (c - sh) mod n of m, for c and sh in [0, n)
NABWA_HD int32_t roll_src(int32_t c, int32_t sh, int32_t n) {
    return floor_mod(c - sh, n);
}

// C32's lane form (probe_pallas3.cu): a 128-word row over a warp, lane L
// holding words L + 32 k in w[k].  roll(m, 64) takes word L + 32 k from
// word L + 32 (k - 2) mod 128 and roll(m, 32) from L + 32 (k - 1): both
// sources lie in the lane, and after the two minima every register of the
// lane holds the minimum of its four words (p2_lane_min).  From then on a
// lane's registers agree, so roll(m, sh) for sh < 32 gives each word of
// lane L the value of lane p2_roll_lane(L, sh) = (L - sh) mod 32, where
// its source roll_src(L + 32 k, sh, 128) lies, whatever its register.
NABWA_HD int32_t p2_lane_min(const int32_t* w) {
    const int32_t a = w[0] < w[2] ? w[0] : w[2];   // sh 64
    const int32_t b = w[1] < w[3] ? w[1] : w[3];
    return a < b ? a : b;                          // sh 32
}

NABWA_HD int32_t p2_roll_lane(int32_t lane, int32_t sh) {
    return (lane - sh) & 31;
}

// probe_pallas3.py:161, the inner trip count of p5's outer round from
// s[0, 0]: (s & 3) + 1 on the int32 bit pattern, 1-4 for a negative s too
NABWA_HD int32_t p5_trips(int32_t s00) {
    return (s00 & 3) + 1;
}

// probe_pallas3.py:159-166 for one thread of C34's grid form, holding nw
// words w of s and its own copy s00 of s[0, 0]: `rounds` outer rounds,
// each reading its inner trip count from s00 and then adding j to s00
// and to each word for j < trips (wrapping).  Every word gets the same
// adds, so s00 follows s[0, 0] and every thread takes the same trips.
NABWA_HD void p5_words(int32_t s00, int32_t rounds, int32_t* w, int32_t nw) {
    for (int32_t it = 0; it < rounds; ++it) {
        const int32_t trips = p5_trips(s00);
        for (int32_t j = 0; j < trips; ++j) {
            s00 = wadd(s00, j);
#pragma unroll
            for (int32_t k = 0; k < nw; ++k) w[k] = wadd(w[k], j);
        }
    }
}

// C35's staged form (probe_pallas3.cu): a block of P6_ROWS x P6_COLS
// threads, thread t its out element (t / P6_COLS, t % P6_COLS) of the
// block's tile, whose origin p6_origin gives (blocks in row-major order
// over ceil(R / P6_ROWS) x `col_blocks` tiles).  Over K in tiles of KT
// words, the block stages its P6_ROWS rows of x as float32 and its
// P6_COLS columns of w, transposed, each column's KT words in a row, both
// at a pitch of KT + P6_PAD words (p6_stage), behind a barrier; then each
// thread adds its products in index order (p6_dot).
constexpr int32_t P6_ROWS = 4;
constexpr int32_t P6_COLS = 8;
// pitch - KT: the P6_ROWS rows' (P6_COLS columns') word k in 4 distinct
// banks apart, so a warp's reads of one k meet no bank twice
constexpr int32_t P6_PAD = 4;

NABWA_HD void p6_origin(int64_t block, int64_t col_blocks, int64_t* r0,
                        int64_t* c0) {
    *r0 = block / col_blocks * P6_ROWS;
    *c0 = block % col_blocks * P6_COLS;
}

NABWA_HD float p6_float(int32_t v) {
#if defined(__CUDA_ARCH__)
    return __int2float_rn(v);
#else
    return (float)v;
#endif
}

// acc + a b, rounded twice: never contracted into one FMA
NABWA_HD float p6_step(float acc, float a, float b) {
#if defined(__CUDA_ARCH__)
    return __fadd_rn(acc, __fmul_rn(a, b));
#else
    const volatile float p = a * b;
    return acc + p;
#endif
}

// four words from p, 16-byte aligned: one int4 load on the card
NABWA_HD void p6_load4(const int32_t* p, int32_t* v) {
#if defined(__CUDA_ARCH__)
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
#else
    for (int j = 0; j < 4; ++j) v[j] = p[j];
#endif
}

NABWA_HD void p6_load4(const float* p, float* v) {
#if defined(__CUDA_ARCH__)
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
#else
    for (int j = 0; j < 4; ++j) v[j] = p[j];
#endif
}

// v[i] = p[i] for i < n and zero past it: one 16-byte load where all four
// are wanted and `vec` says p is 16-byte aligned, else word by word
template <typename T>
NABWA_HD void p6_quad(const T* p, int64_t n, bool vec, T* v) {
    if (vec && n >= 4) {
        p6_load4(p, v);
        return;
    }
#pragma unroll
    for (int32_t i = 0; i < 4; ++i) v[i] = i < n ? p[i] : T(0);
}

// thread t of THREADS: its share of words k0 .. k0 + kn - 1 (kn <= KT) of
// x's rows r0 .. r0 + P6_ROWS - 1 (x int32 [rows, depth]) and of w's
// columns c0 .. c0 + P6_COLS - 1 (w float32 [depth, width]), all its
// loads first and then its stores, so that its loads are in flight
// together: x's quads t, t + THREADS, ... (quad q: row q / (KT / 4),
// words 4 (q % (KT / 4)) ..) as float32 into xs, row rr at rr pitch; w's
// quads t, t + THREADS, ... (quad q: row q / (P6_COLS / 4), columns 4 (q %
// (P6_COLS / 4)) ..) into ws, column c at c pitch.  A quad of x (w) is
// one int4 (float4) load where depth (width) is a multiple of 4, which
// puts it on a 16-byte boundary, and it lies whole inside x (w).  Words
// past kn, x's rows or w's columns stage as zeros: a tile shorter than KT
// adds products of +0, which leave each sum as it is (a sum that starts
// at +0 never becomes -0).
template <int32_t KT, int32_t THREADS>
NABWA_HD void p6_stage(const int32_t* x, const float* w, int64_t rows,
                       int64_t depth, int64_t width, int64_t r0, int64_t c0,
                       int64_t k0, int32_t kn, int32_t t, int32_t pitch,
                       float* xs, float* ws) {
    constexpr int32_t row_quads = KT / 4, w_quads = P6_COLS / 4;
    constexpr int32_t x_all = P6_ROWS * row_quads, w_all = KT * w_quads;
    constexpr int32_t nx = (x_all + THREADS - 1) / THREADS;
    constexpr int32_t nw = (w_all + THREADS - 1) / THREADS;
    static_assert(KT % 4 == 0, "whole quads a tile row");
    int32_t xv[nx][4];
    float wv[nw][4];
#pragma unroll
    for (int32_t j = 0; j < nx; ++j) {
        const int32_t q = t + j * THREADS;
        const int32_t rr = q / row_quads, k = 4 * (q % row_quads);
        const bool in = q < x_all && r0 + rr < rows;
        p6_quad(x + (in ? (r0 + rr) * depth + k0 + k : 0), in ? kn - k : 0,
                depth % 4 == 0, xv[j]);
    }
#pragma unroll
    for (int32_t j = 0; j < nw; ++j) {
        const int32_t q = t + j * THREADS;
        const int32_t k = q / w_quads, c = 4 * (q % w_quads);
        const bool in = q < w_all && k < kn;
        p6_quad(w + (in ? (k0 + k) * width + c0 + c : 0),
                in ? width - c0 - c : 0, width % 4 == 0, wv[j]);
    }
#pragma unroll
    for (int32_t j = 0; j < nx; ++j) {
        const int32_t q = t + j * THREADS;
        if (q >= x_all) break;
        float* dst = xs + q / row_quads * pitch + 4 * (q % row_quads);
#pragma unroll
        for (int32_t i = 0; i < 4; ++i) dst[i] = p6_float(xv[j][i]);
    }
#pragma unroll
    for (int32_t j = 0; j < nw; ++j) {
        const int32_t q = t + j * THREADS;
        if (q >= w_all) break;
        const int32_t k = q / w_quads, c = 4 * (q % w_quads);
#pragma unroll
        for (int32_t i = 0; i < 4; ++i) ws[(c + i) * pitch + k] = wv[j][i];
    }
}

// acc plus a[k] b[k] for k < N in index order, unrolled, so that every
// load issues ahead of the chain of adds
template <int32_t N>
NABWA_HD float p6_dot(float acc, const float* a, const float* b) {
#pragma unroll
    for (int32_t k = 0; k < N; ++k) acc = p6_step(acc, a[k], b[k]);
    return acc;
}

}  // namespace probe
}  // namespace nabwa
