// FM-index rank (Occ) functions and bwt_cal_width of kernel C2 (the serial
// row and one lane's share of a lane group's row), on the reference's
// interleaved 12-word (48 B) blocks: 4 checkpoint counters + 8 words of
// 2-bit bases, MSB first, per 128 bases (bwt.h:61-68, bwt_bwtupdate_core,
// bwtmisc.c:125-152).  The bwt_sa walk of kernel C3 is in sa_walk.cuh.
//
// Semantics are those of nabwa_tpu/ops/occ.py:47-84 (occ4) and
// native/dfsgap.cpp:71-140: positions are uint32 (unsigned compares, so
// they hold past 2^31), k >= primary skips the `$` row (bwt.c:99,167), and
// k == (uint32)-1 counts nothing (bwt.c:98,163).
//
// Everything here is NABWA_HD: nvcc compiles it for the card, and a host
// C++ compiler can compile the same source for a CPU harness.

#pragma once

#include <cstddef>
#include <cstdint>

#if defined(__CUDACC__)
#define NABWA_HD __host__ __device__ __forceinline__
#else
#define NABWA_HD inline
#endif

namespace nabwa {

constexpr uint32_t NEG1 = 0xFFFFFFFFu;

NABWA_HD uint32_t popc(uint32_t x) {
#if defined(__CUDA_ARCH__)
    return (uint32_t)__popc(x);
#else
    return (uint32_t)__builtin_popcount(x);
#endif
}

// One 48 B block, read as three 16 B loads on the card.
struct Block {
    uint32_t w[12];
};

NABWA_HD void load_block(const uint32_t* bank, uint32_t kk, Block* b) {
    const uint32_t* p = bank + (size_t)(kk >> 7) * 12;
#if defined(__CUDA_ARCH__)
    const uint4* q = reinterpret_cast<const uint4*>(p);
    uint4 a = __ldg(q), c = __ldg(q + 1), d = __ldg(q + 2);
    b->w[0] = a.x; b->w[1] = a.y; b->w[2] = a.z; b->w[3] = a.w;
    b->w[4] = c.x; b->w[5] = c.y; b->w[6] = c.z; b->w[7] = c.w;
    b->w[8] = d.x; b->w[9] = d.y; b->w[10] = d.z; b->w[11] = d.w;
#else
    for (int j = 0; j < 12; ++j) b->w[j] = p[j];
#endif
}

// occ4's counts at row kk (k with the `$` row skipped) from kk's block b.
NABWA_HD void occ4_block(const Block& b, uint32_t kk, uint32_t cnt[4]) {
    uint32_t word_off = (kk >> 4) & 7, within = kk & 15;
    uint32_t c1 = 0, c2 = 0, c3 = 0;
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (uint32_t j = 0; j < 8; ++j) {
        uint32_t vmask = j < word_off ? 0xFFFFFFFFu
                       : j == word_off ? (0xFFFFFFFFu << ((15 - within) * 2))
                       : 0u;
        uint32_t w = b.w[4 + j];
        uint32_t lo = w & vmask & 0x55555555u;
        uint32_t hi = (w >> 1) & vmask & 0x55555555u;
        c1 += popc(lo);
        c2 += popc(hi);
        c3 += popc(lo & hi);
    }
    c1 -= c3;
    c2 -= c3;
    uint32_t n_valid = word_off * 16 + within + 1;
    cnt[0] = b.w[0] + (n_valid - c1 - c2 - c3);
    cnt[1] = b.w[1] + c1;
    cnt[2] = b.w[2] + c2;
    cnt[3] = b.w[3] + c3;
}

// Counts of each base in BWT[0..k] on one bank (bwt_occ4, bwt.c:159-176).
NABWA_HD void occ4(const uint32_t* bank, uint32_t primary, uint32_t k,
                   uint32_t cnt[4]) {
    if (k == NEG1) {
        cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
        return;
    }
    uint32_t kk = k >= primary ? k - 1 : k;
    Block b;
    load_block(bank, kk, &b);
    occ4_block(b, kk, cnt);
}

// The FM parameters cal_width takes by value: l2[5], primary, seq_len.
struct FmParams {
    uint32_t l2[5];
    uint32_t primary;
    uint32_t seq_len;
};

NABWA_HD FmParams fm_params(const uint32_t* words) {
    FmParams p;
    for (int j = 0; j < 5; ++j) p.l2[j] = words[j];
    p.primary = words[5];
    p.seq_len = words[6];
    return p;
}

// bwt_cal_width (bwtaln.c:52-76) for one row of L codes read left to
// right: w_out/b_out get L+1 values.  Columns past `len` repeat the final
// interval, column L is 0, and column `len` holds the sentinel (w=0,
// bid=final+1), as nabwa_tpu/ops/occ.py:141 lays them out.
NABWA_HD void cal_width_row(const FmParams& p, const uint32_t* bwt,
                            const int32_t* q, int len, int L,
                            int32_t* w_out, int32_t* b_out) {
    uint32_t k = 0, l = p.seq_len;
    int32_t cur = 0;
    for (int i = 0; i < L; ++i) {
        if (i < len) {
            const int c = q[i];
            bool restart = c < 0 || c > 3;
            if (!restart) {
                uint32_t ck[4], cl[4];
                occ4(bwt, p.primary, k - 1u, ck);
                occ4(bwt, p.primary, l, cl);
                const uint32_t nk = p.l2[c] + ck[c] + 1u;
                const uint32_t nl = p.l2[c] + cl[c];
                restart = nk > nl;
                k = nk;
                l = nl;
            }
            if (restart) {
                k = 0;
                l = p.seq_len;
                ++cur;
            }
        }
        w_out[i] = (int32_t)(l - k + 1u);
        b_out[i] = cur;
    }
    w_out[L] = 0;
    b_out[L] = 0;
    if (len >= 0 && len <= L) {
        w_out[len] = 0;
        b_out[len] = cur + 1;
    }
}

// ---- one lane's share of a lane group's cal_width row (kernel C2) ----
//
// A row goes to a group of CAL_WIDTH_GROUP = 8 lanes: the first half, 4
// lanes, counts base c at k-1, the second half at l.  Lane `sub` of a half
// reads piece `sub` of the row's Occ block, a 16 B load: piece 0 the four
// counters, pieces 1 and 2 the bwt words 4-7 and 8-11; lane 3 reads
// nothing.  It counts only base c in its words, over the valid positions,
// and the counter lane adds cnt[c]; the half's sum is occ4(k)[c].  The
// count of A over the valid positions equals occ4_block's n_valid - c1 -
// c2 - c3.  (A group of 4 lanes, one of them loading two pieces, was
// slower on the H100; PERF.md gives both times.)
constexpr int CAL_WIDTH_GROUP = 8;
constexpr int CAL_WIDTH_HALF = CAL_WIDTH_GROUP / 2;

// 16 bytes of an Occ block: its piece `piece` (0..2) as four words
NABWA_HD void load_piece(const uint32_t* blk, int piece, uint32_t w[4]) {
#if defined(__CUDA_ARCH__)
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(blk) + piece);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
#else
    for (int m = 0; m < 4; ++m) w[m] = blk[4 * piece + m];
#endif
}

// Positions of base c among the first `valid` (0..16) positions of a
// packed word, MSB first.
NABWA_HD uint32_t count_base(uint32_t w, uint32_t c, uint32_t valid) {
    // fields equal to c become 11: xor with ~c in every field
    const uint32_t x = w ^ (0xFFFFFFFFu - 0x55555555u * c);
    const uint32_t vmask = valid >= 16 ? 0xFFFFFFFFu
                         : valid == 0 ? 0u
                         : 0xFFFFFFFFu << ((16 - valid) * 2);
    return popc(x & (x >> 1) & 0x55555555u & vmask);
}

// Lane `sub` (0..CAL_WIDTH_HALF-1) of a half: its part of occ4(bank,
// primary, k)[c], c in 0..3.  k == (uint32)-1 counts nothing; the `$` row
// is skipped.
NABWA_HD uint32_t occ_lane_part(const uint32_t* bank, uint32_t primary,
                                uint32_t k, uint32_t c, int sub) {
    if (k == NEG1 || sub >= 3) return 0;
    const uint32_t kk = k >= primary ? k - 1 : k;
    const uint32_t* blk = bank + (size_t)(kk >> 7) * 12;
    uint32_t w[4];
    load_piece(blk, sub, w);
    if (sub == 0)
        return c == 0 ? w[0] : c == 1 ? w[1] : c == 2 ? w[2] : w[3];
    const uint32_t word_off = (kk >> 4) & 7, within = kk & 15;
    uint32_t part = 0;
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int m = 0; m < 4; ++m) {
        const uint32_t j = 4 * (sub - 1) + m;
        const uint32_t valid = j < word_off ? 16
                             : j == word_off ? within + 1 : 0;
        part += count_base(w[m], c, valid);
    }
    return part;
}

// One step of a row, given the group's counts ok = occ4(k-1)[c] and
// ol = occ4(l)[c] (any values where the step looks nothing up): the
// interval and the bid as cal_width_row moves them.  Whether the step
// looks up is `cal_width_looks_up`.
NABWA_HD bool cal_width_looks_up(int i, int len, int c) {
    return i < len && c >= 0 && c <= 3;
}

NABWA_HD void cal_width_advance(const FmParams& p, int i, int len, int c,
                                uint32_t ok, uint32_t ol, uint32_t* k,
                                uint32_t* l, int32_t* cur) {
    if (i >= len) return;
    bool restart = c < 0 || c > 3;
    if (!restart) {
        const uint32_t l2c = c == 0 ? p.l2[0] : c == 1 ? p.l2[1]
                           : c == 2 ? p.l2[2] : p.l2[3];
        const uint32_t nk = l2c + ok + 1u, nl = l2c + ol;
        restart = nk > nl;
        *k = nk;
        *l = nl;
    }
    if (restart) {
        *k = 0;
        *l = p.seq_len;
        ++*cur;
    }
}

// Column i's (width, bid) after step i (i < L) or at column L: the
// sentinel (0, final + 1) at column len, 0 at column L otherwise, as
// cal_width_row lays them out.
NABWA_HD void cal_width_column(int i, int len, int L, uint32_t k, uint32_t l,
                               int32_t cur, int32_t* w, int32_t* b) {
    if (i == len) {
        *w = 0;
        *b = cur + 1;
    } else if (i == L) {
        *w = 0;
        *b = 0;
    } else {
        *w = (int32_t)(l - k + 1u);
        *b = cur;
    }
}

}  // namespace nabwa
