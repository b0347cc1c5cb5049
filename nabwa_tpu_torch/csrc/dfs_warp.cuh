// Kernel C1's search as a warp per read: the same bwt_match_gap
// (bwtgap.c:104-266) as the serial `dfs_read` of dfs_read.cuh, with a
// read's state in one block of memory that its warp's lanes share, and the
// loops over that state spread over the lanes.
//
// `dfs_read_warp<W>` is written once for both the card and the CPU tests.
// Its control flow and scalar state (md, best_score, n_entries, the
// pending exact step, ...) are warp-uniform: every lane computes them
// alike.  Its per-lane work runs inside `w.each`, and the lanes meet only
// in W's collectives: a minimum, a sum, `any`, a ballot, a shuffle from
// one lane, the occ4 pair's counts, and `sync` between one lane's writes
// to the state and another lane's reads.  W is the warp itself on the card
// (dfs.cu, 32 lanes, the intrinsics) or, in the CPU harness
// (host_harness.cpp), a loop over nl lanes in lane order that combines
// their values as the intrinsics do.  `W::Val<T>` holds one value a lane:
// a register on the card, an array of nl on the host.
//
// One iteration, as in dfs_read:
//   pop      lane j scans the live slots j, j + nl, ... for its least
//            key; the warp's minimum, the first lane holding it (keys are
//            unique: the 16-bit sequence field), that lane's slot by
//            shuffle; lane f moves field f of the last entry into the hole;
//   occ4     the (k-1, l) pair's two blocks are loaded by two lanes as
//            soon as the entry is known, and counted, the counts shuffled
//            to all lanes, only after the checks and the expansion's
//            set-up, which the loads' latency thereby covers;
//   hit      the tandem-repeat test an `any` over the hit list; the gap
//            shadow in passes of nl columns, the running count of
//            w == x a ballot prefix count carried from pass to pass;
//   expand   lane t builds candidate t in the C's order (t = 0: the
//            insertion, 1-4: deletions c = 0..3, 5-8: (mis)matches j =
//            1..4) in passes of nl (one on the card); the kept ones are
//            compacted by ballot rank, slot n_entries + rank with sequence
//            seq_ctr + rank, the serial loop's bits.
//
// NABWA_HD: nvcc compiles it for the card, a host C++ compiler for the CPU
// tests.

#pragma once

#include "dfs_read.cuh"

namespace nabwa {

// no slot: above every key, since scores stay below 0x7FFF
constexpr int32_t DFS_NO_KEY = 0x7FFFFFFF;
// candidates of one expansion
constexpr int DFS_CANDS = 9;

// One read's state, int32 words: the stack (key, info, cnt, sk, sl, [S]
// each), the two strands' width and bid planes ([2][L+1] each), their seed
// width and bid planes ([2][SL1] each), the read's codes ([2][L]) and the
// hit list (meta, k, l, score, [H] each).
NABWA_HD size_t dfs_state_words(const DfsParams& p) {
    return 5 * (size_t)p.S + 4 * ((size_t)p.L + 1) + 4 * (size_t)p.SL1
           + 2 * (size_t)p.L + 4 * (size_t)p.H;
}

// bytes of one read's state, a multiple of 16 (ops/dfs_cuda.py
// `dfs_smem_bytes` mirrors it)
NABWA_HD size_t dfs_state_bytes(const DfsParams& p) {
    return (4 * dfs_state_words(p) + 15) & ~(size_t)15;
}

struct WarpIO {
    const int32_t* seq;      // [2, L] codes
    int len, max_diff;
    bool has_seed;
    const int32_t* w_in;     // [2, L+1] widths (uint32 bits)
    const int32_t* b_in;     // [2, L+1] bids
    const int32_t* sw_in;    // [2, SL1] seed widths
    const int32_t* sb_in;    // [2, SL1] seed bids
    int32_t* state;          // dfs_state_bytes, 16-byte aligned
    int32_t* out;            // [4H+5] packed result row
};

struct DfsState {
    int32_t* key;
    int32_t* info;
    int32_t* cnt;
    uint32_t* sk;
    uint32_t* sl;
    int32_t* w;              // [2][L+1], strand a at w + a (L+1)
    int32_t* bid;
    int32_t* sw;             // [2][SL1]
    int32_t* sb;
    int32_t* seq;            // [2][L]
    int32_t* hits;           // meta [H], k [H], l [H], score [H]
};

NABWA_HD DfsState dfs_state(const DfsParams& p, int32_t* st) {
    const size_t S = p.S, LP1 = (size_t)p.L + 1, SL1 = p.SL1;
    DfsState s;
    s.key = st;
    s.info = st + S;
    s.cnt = st + 2 * S;
    s.sk = reinterpret_cast<uint32_t*>(st + 3 * S);
    s.sl = reinterpret_cast<uint32_t*>(st + 4 * S);
    s.w = st + 5 * S;
    s.bid = s.w + 2 * LP1;
    s.sw = s.bid + 2 * LP1;
    s.sb = s.sw + 2 * SL1;
    s.seq = s.sb + 2 * SL1;
    s.hits = s.seq + 2 * (size_t)p.L;
    return s;
}

// The per-read views of one batch: seqs [B, 2, L], widths/bids [B, 2,
// L+1], seed planes [B, 2, SL1], out [B, 4H+5]; `state` is the read's.
NABWA_HD WarpIO warp_io(const DfsParams& p, const int32_t* seqs,
                        const int32_t* lengths, const int32_t* widths,
                        const int32_t* bids, const int32_t* seed_widths,
                        const int32_t* seed_bids, const int32_t* has_seed,
                        const int32_t* max_diff, int32_t* state,
                        int32_t* out, int b) {
    const size_t L = p.L, LP1 = L + 1, SL1 = p.SL1;
    WarpIO r;
    r.seq = seqs + (size_t)b * 2 * L;
    r.len = lengths[b];
    r.max_diff = max_diff[b];
    r.has_seed = has_seed[b] != 0;
    r.w_in = widths + (size_t)b * 2 * LP1;
    r.b_in = bids + (size_t)b * 2 * LP1;
    r.sw_in = seed_widths + (size_t)b * 2 * SL1;
    r.sb_in = seed_bids + (size_t)b * 2 * SL1;
    r.state = state;
    r.out = out + (size_t)b * (4 * p.H + 5);
    return r;
}

// bits of the lanes below `lane`, and of those up to it
NABWA_HD uint32_t lane_mask_lt(int lane) { return (1u << lane) - 1u; }
NABWA_HD uint32_t lane_mask_le(int lane) { return (2u << lane) - 1u; }

// a[b] for b in 0..3 by selects, so that the card keeps a in registers
NABWA_HD uint32_t pick4(const uint32_t* a, int b) {
    return b == 0 ? a[0] : b == 1 ? a[1] : b == 2 ? a[2] : a[3];
}

// ---- one lane's share of each step ----

// The copy-in: the planes and the codes from the inputs, the hit list
// zeroed.
NABWA_HD void dfs_lane_load(const DfsParams& p, const WarpIO& r,
                            const DfsState& s, int lane, int nl) {
    const int np = 2 * (p.L + 1), ns = 2 * p.SL1, nh = 4 * p.H;
    for (int j = lane; j < np; j += nl) {
        s.w[j] = r.w_in[j];
        s.bid[j] = r.b_in[j];
    }
    for (int j = lane; j < ns; j += nl) {
        s.sw[j] = r.sw_in[j];
        s.sb[j] = r.sb_in[j];
    }
    for (int j = lane; j < 2 * p.L; j += nl) s.seq[j] = r.seq[j];
    for (int j = lane; j < nh; j += nl) s.hits[j] = 0;
}

// The lane's count of N (code > 3) among seq[0..n).
NABWA_HD int dfs_lane_n_count(const int32_t* seq, int n, int lane, int nl) {
    int c = 0;
    for (int i = lane; i < n; i += nl) c += seq[i] > 3;
    return c;
}

// The lane's least key among the live slots lane, lane + nl, ... below n,
// and its slot (DFS_NO_KEY and -1 for none).
NABWA_HD int32_t dfs_lane_min(const int32_t* key, int n, int lane, int nl,
                              int* slot) {
    int32_t m = DFS_NO_KEY;
    int at = -1;
    for (int j = lane; j < n; j += nl)
        if (key[j] < m) {
            m = key[j];
            at = j;
        }
    *slot = at;
    return m;
}

// The pop's hole filled from the last live slot: field f (0..4: key,
// info, cnt, sk, sl; the stack's five [S] arrays lie back to back).
NABWA_HD void dfs_move(const DfsParams& p, const DfsState& s, int f,
                       int last, int hole) {
    int32_t* a = s.key + (size_t)f * p.S;
    a[hole] = a[last];
}

// Whether the lane's share of the first n hits holds the interval (k, l).
NABWA_HD bool dfs_lane_in_hits(const DfsState& s, int H, int n, uint32_t k,
                               uint32_t l, int lane, int nl) {
    bool f = false;
    for (int j = lane; j < n; j += nl)
        f |= (uint32_t)s.hits[H + j] == k && (uint32_t)s.hits[2 * H + j] == l;
    return f;
}

// gap_shadow (bwtgap.c:81-91) at column j below lim: whether w[j] == x,
// then the column's update given jc, the count of columns <= j with
// w == x.
NABWA_HD bool dfs_shadow_eq(const int32_t* wa, int j, int lim, uint32_t x) {
    return j < lim && (uint32_t)wa[j] == x;
}

NABWA_HD void dfs_shadow_write(const DfsParams& p, int32_t* wa, int32_t* ba,
                               int j, int lim, uint32_t x, uint32_t jc) {
    if (j >= lim) return;
    const uint32_t w = (uint32_t)wa[j];
    if (w == x) {
        wa[j] = (int32_t)(p.seq_len - jc);
        ba[j] = 1;
    } else if (w > x) {
        wa[j] = (int32_t)(w - x);
    }
}

// What an expansion's candidates are built from (dfs_read's expansion up
// to its candidate loop), and l2[0..3].
struct DfsExpand {
    int i2, nmm, go, ge, go_open, is_i, is_d, sc, md, bound;
    bool ins_ok, del_ok, mm_all, exact_only;
    uint32_t k, l;
    uint32_t ck4[4], cl4[4], l2[4];
};

// The expansion's set-up (bwtgap.c:201-218) of the popped entry (its
// info, cnt, k, l and budget m): all an expansion's candidates are built
// from but the occ4 counts.
NABWA_HD void dfs_expand_setup(const DfsParams& p, const WarpIO& r,
                               const DfsState& s, int e_info, int e_cnt,
                               uint32_t e_k, uint32_t e_l, int m, int md,
                               int best_score, DfsExpand* x) {
    const int L = p.L, LP1 = p.L + 1, SL1 = p.SL1;
    const bool gape = p.mode & MODE_GAPE;
    const bool nonstop = p.mode & MODE_NONSTOP;
    const bool loggap = p.mode & MODE_LOGGAP;
    const int e_a = (e_info >> 16) & 1, e_i = e_info & 0xFFFF;
    const int e_nmm = e_cnt & 0xFF, e_go = (e_cnt >> 8) & 0xFF;
    const int e_ge = (e_cnt >> 16) & 0xFF;
    const int e_state = (e_cnt >> 24) & 3;
    const int i2 = e_i - 1;
    const uint32_t occ_width = e_l - e_k + 1u;
    const int32_t* bid_row = s.bid + e_a * LP1;
    const int32_t* w_row = s.w + e_a * LP1;
    bool allow_diff = true, allow_m = true;
    if (i2 > 0) {
        const int b1 = gat(bid_row, i2 - 1, LP1);
        const int b2 = gat(bid_row, i2, LP1);
        allow_diff = !(b1 > m - 1);
        allow_m = !(b1 == m - 1 && b2 == m - 1
                    && gat(w_row, i2 - 1, LP1) == gat(w_row, i2, LP1));
    }
    // seed bounds (bwtgap.c:210-214)
    const int ii = r.has_seed ? i2 - (r.len - p.seed_len) : -1;
    if (i2 > 0 && ii > 0) {
        const int m_seed = p.max_seed_diff - (e_nmm + e_go)
                           - (gape ? e_ge : 0);
        const int32_t* sb = s.sb + e_a * SL1;
        const int32_t* sw = s.sw + e_a * SL1;
        const int s1 = gat(sb, ii - 1, SL1);
        const int s2 = gat(sb, ii, SL1);
        if (s1 > m_seed - 1) allow_diff = false;
        if (s1 == m_seed - 1 && s2 == m_seed - 1
            && gat(sw, ii - 1, SL1) == gat(sw, ii, SL1))
            allow_m = false;
    }
    // indel gating (bwtgap.c:217-218)
    const int vsum = e_go + e_ge;
    const int tmp = loggap ? int_log2(vsum) / 2 + 1 : vsum;
    const bool ind_ok = allow_diff && i2 >= p.indel_end_skip + tmp
                        && r.len - i2 >= p.indel_end_skip + tmp;
    const bool is_m = e_state == STATE_M, is_i = e_state == STATE_I;
    const bool is_d = e_state == STATE_D;
    const bool can_open = is_m && e_go < p.max_gapo;
    const bool can_ext_i = is_i && e_ge < p.max_gape;
    const bool can_ext_d =
        is_d && e_ge < p.max_gape
        && (e_go + e_ge < md || occ_width < (uint32_t)p.max_del_occ);
    x->i2 = i2;
    x->nmm = e_nmm;
    x->go = e_go;
    x->ge = e_ge;
    x->go_open = e_go + is_m;
    x->is_i = is_i;
    x->is_d = is_d;
    x->sc = gat(s.seq + e_a * L, i2, L);
    x->md = md;
    x->bound = nonstop ? 0x7FFFFFFF : best_score + p.s_mm;
    x->ins_ok = ind_ok && (can_open || can_ext_i);
    x->del_ok = ind_ok && (can_open || can_ext_d);
    x->mm_all = allow_diff && allow_m;
    x->exact_only = !x->mm_all && x->sc < 4;
    x->k = e_k;
    x->l = e_l;
    for (int c = 0; c < 4; ++c) x->l2[c] = p.l2[c];
}

// Candidate t (0..8) in the C's order -- 0 the insertion, 1-4 the
// deletions of base t-1, 5-8 the (mis)match of base (sc + t - 4) & 3 --
// and whether it is pushed: it exists and passes `keep`.  Written without
// a branch on t, so that the nine lanes run it together.
NABWA_HD bool dfs_cand(const DfsParams& p, const DfsExpand& x, int t,
                       Cand* c) {
    const bool ins = t == 0, del = t >= 1 && t <= 4;
    const bool mm = t >= 5 && t < DFS_CANDS;
    const int jm = t - 4;
    const int b = del ? t - 1 : (x.sc + jm) & 3;
    const uint32_t nk = pick4(x.l2, b) + pick4(x.ck4, b) + 1u;
    const uint32_t nl = pick4(x.l2, b) + pick4(x.cl4, b);
    const bool is_mm = jm != 4 || x.sc > 3;
    c->i = del ? x.i2 + 1 : x.i2;
    c->nmm = mm ? x.nmm + is_mm : x.nmm;
    c->go = mm ? x.go : x.go_open;
    c->ge = x.ge + (ins ? x.is_i : del ? x.is_d : 0);
    c->state = ins ? STATE_I : del ? STATE_D : STATE_M;
    c->k = ins ? x.k : nk;
    c->l = ins ? x.l : nl;
    c->diff = !mm || is_mm;
    const bool ok = ins   ? x.ins_ok
                    : del ? x.del_ok && nk <= nl
                    : mm  ? nk <= nl && (x.mm_all || (x.exact_only && jm == 4))
                          : false;
    return ok && keep(p, *c, x.md, x.bound);
}

// Candidate c of strand a pushed into `slot` with sequence number seq.
NABWA_HD void dfs_push(const DfsParams& p, const DfsState& s, int slot,
                       int seq, int a, const Cand& c) {
    const int csc = aln_score(p, c.nmm, c.go, c.ge);
    const int ldp = c.diff ? c.i : 0;
    s.key[slot] = (csc << 16) | (0xFFFF - seq);
    s.info[slot] = (ldp << 17) | (a << 16) | c.i;
    s.cnt[slot] = c.nmm | (c.go << 8) | (c.ge << 16) | (c.state << 24);
    s.sk[slot] = c.k;
    s.sl[slot] = c.l;
}

// ---- the whole read ----

template <class W>
NABWA_HD void dfs_read_warp(const W& w, const DfsParams& p,
                            const uint32_t* bwt_cat, const WarpIO& r) {
    using I32 = typename W::template Val<int32_t>;
    using Int = typename W::template Val<int>;
    using Bool = typename W::template Val<bool>;
    using Cands = typename W::template Val<Cand>;
    const int S = p.S, H = p.H, L = p.L, LP1 = p.L + 1;
    const int nl = w.lanes();
    const bool gape = p.mode & MODE_GAPE;
    const bool nonstop = p.mode & MODE_NONSTOP;
    const DfsState s = dfs_state(p, r.state);
    int32_t* hit_meta = s.hits;
    int32_t* hit_k = s.hits + H;
    int32_t* hit_l = s.hits + 2 * H;
    int32_t* hit_score = s.hits + 3 * H;
    w.each([&](int lane) { dfs_lane_load(p, r, s, lane, nl); });

    int md = r.max_diff;
    int best_score = aln_score(p, md + 1, p.max_gapo + 1, p.max_gape + 1);
    int32_t best_cnt = 0;
    int n_aln = 0, hw = 0, fin = 0, iters = 0;
    bool done = false, overflow = false;
    bool pend = false;
    int pend_i = 0, pend_cnt = 0, pend_a = 0, pend_ldp = 0;
    uint32_t pend_k = 0, pend_l = 0;
    int n_entries = 0, seq_ctr = 0;

    // too many Ns -> no search at all (bwtgap.c:118-123)
    Int n_part;
    const int n_seq = r.len < L ? r.len : L;
    w.each([&](int lane) {
        n_part[lane] = dfs_lane_n_count(r.seq, n_seq, lane, nl);
    });
    const int n_count = w.sum(n_part);
    done = n_count > md || r.len <= 0;
    if (!done) {
        // the two strand seeds (bwtgap.c:127-128); a=1 pops first
        w.each([&](int lane) {
            if (lane == 0)
                for (int a = 0; a < 2; ++a) {
                    s.key[a] = 0xFFFF - a;
                    s.info[a] = (a << 16) | r.len;
                    s.cnt[a] = 0;
                    s.sk[a] = 0;
                    s.sl[a] = p.seq_len;
                }
        });
        n_entries = seq_ctr = 2;
    }
    w.sync();

    while (!done) {
        const bool in_pend = pend;
        bool popped = false, expand = false, direct_hit = false;
        int e_info = 0, e_cnt = 0, m = 0;
        int32_t kmin = 0;
        uint32_t e_k = 0, e_l = 0;

        if (!in_pend) {
            // stack checks (bwtgap.c:139-141)
            hw = hw > n_entries ? hw : n_entries;
            if (n_entries == 0 || n_entries > p.max_entries) {
                // never pop an empty stack: no slot is read
                done = true;
            } else {
                // pop the minimum key (gap_pop, bwtgap.c:66-79)
                I32 lk;
                Int lj;
                w.each([&](int lane) {
                    lk[lane] = dfs_lane_min(s.key, n_entries, lane, nl,
                                            &lj[lane]);
                });
                kmin = w.min(lk);
                Bool at_min;
                w.each([&](int lane) { at_min[lane] = lk[lane] == kmin; });
                const int jmin = w.shfl(lj, w.first_lane(w.ballot(at_min)));
                e_info = s.info[jmin];
                e_cnt = s.cnt[jmin];
                e_k = s.sk[jmin];
                e_l = s.sl[jmin];
                const int last = n_entries - 1;
                w.sync();
                w.each([&](int lane) {
                    for (int f = lane; f < 5; f += nl)
                        dfs_move(p, s, f, last, jmin);
                });
                n_entries = last;
                w.sync();
                popped = true;
            }
        }

        // one (k-1, l) occ4 pair serves the pending step or the expansion;
        // its two block loads start here, to be on their way while the
        // checks and the expansion's set-up run
        const int oa = in_pend ? pend_a : ((e_info >> 16) & 1);
        const uint32_t* bank = oa == 0 ? bwt_cat + p.rev_word_offset : bwt_cat;
        const uint32_t prim = oa == 0 ? p.primary_rev : p.primary_fwd;
        typename W::OccLoad blocks;
        if (in_pend || popped)
            blocks = w.occ_load(bank, prim, (in_pend ? pend_k : e_k) - 1u,
                                in_pend ? pend_l : e_l);

        if (popped) {
            const int e_score = (int)((uint32_t)kmin >> 16);
            const int e_a = (e_info >> 16) & 1, e_i = e_info & 0xFFFF;
            const int e_nmm = e_cnt & 0xFF, e_go = (e_cnt >> 8) & 0xFF;
            const int e_ge = (e_cnt >> 16) & 0xFF;
            const int e_state = (e_cnt >> 24) & 3;
            // best-score stop (bwtgap.c:144)
            if (!nonstop && e_score > best_score + p.s_mm) {
                done = true;
            } else {
                // budget (bwtgap.c:146-148)
                m = md - (e_nmm + e_go) - (gape ? e_ge : 0);
                bool proc = m >= 0;
                // width lower bound (bwtgap.c:156)
                if (proc && e_i > 0
                    && m < gat(s.bid + e_a * LP1, e_i - 1, LP1))
                    proc = false;
                if (proc) {
                    // hit / exact path / expand (bwtgap.c:158-164)
                    const bool exact_ok = gape || e_state == STATE_M
                                          || e_ge == p.max_gape;
                    if (e_i == 0) {
                        direct_hit = true;
                    } else if (m == 0 && exact_ok) {
                        pend = true;
                        pend_i = e_i;
                        pend_k = e_k;
                        pend_l = e_l;
                        pend_a = e_a;
                        pend_ldp = (int)((uint32_t)e_info >> 17);
                        pend_cnt = e_cnt;
                    } else {
                        expand = true;
                    }
                }
            }
        }

        DfsExpand x;
        if (expand)
            dfs_expand_setup(p, r, s, e_info, e_cnt, e_k, e_l, m, md,
                             best_score, &x);
        uint32_t ck4[4] = {0, 0, 0, 0}, cl4[4] = {0, 0, 0, 0};
        if (in_pend || expand) w.occ_count(blocks, ck4, cl4);

        // pending exact-match step (bwt_match_exact_alt, one base)
        bool pend_hit = false;
        if (in_pend) {
            const int pc = gat(s.seq + pend_a * L, pend_i - 1, L);
            const int cc = pc < 0 ? 0 : (pc > 3 ? 3 : pc);
            const uint32_t nk = pick4(p.l2, cc) + pick4(ck4, cc) + 1u;
            const uint32_t nl2 = pick4(p.l2, cc) + pick4(cl4, cc);
            if (pc > 3 || nk > nl2) {
                pend = false;
            } else {
                pend_k = nk;
                pend_l = nl2;
                pend_i -= 1;
                if (pend_i == 0) {
                    pend_hit = true;
                    pend = false;
                }
            }
        }

        // hit processing (bwtgap.c:166-199)
        if (direct_hit || pend_hit) {
            const int h_cnt = direct_hit ? e_cnt : pend_cnt;
            const int h_a = direct_hit ? (e_info >> 16) & 1 : pend_a;
            const int h_ldp =
                direct_hit ? (int)((uint32_t)e_info >> 17) : pend_ldp;
            const uint32_t h_k = direct_hit ? e_k : pend_k;
            const uint32_t h_l = direct_hit ? e_l : pend_l;
            const int h_nmm = h_cnt & 0xFF, h_go = (h_cnt >> 8) & 0xFF;
            const int h_ge = (h_cnt >> 16) & 0xFF;
            const int h_score = aln_score(p, h_nmm, h_go, h_ge);
            if (n_aln == 0) {
                best_score = h_score;
                const int nbd = h_nmm + h_go + (gape ? h_ge : 0);
                if (!nonstop) md = nbd + 1 < md ? nbd + 1 : md;
            }
            const bool eq_best = h_score == best_score;
            const uint32_t x = h_l - h_k + 1u;
            if (!eq_best && best_cnt > p.max_top2) {
                done = true;
            } else {
                if (eq_best) best_cnt = (int32_t)((uint32_t)best_cnt + x);
                // tandem-repeat dedup (bwtgap.c:179-183): only a gapped
                // hit consults it
                bool in_hits = false;
                if (h_go > 0) {
                    Bool f;
                    w.each([&](int lane) {
                        f[lane] = dfs_lane_in_hits(s, H, n_aln, h_k, h_l,
                                                   lane, nl);
                    });
                    in_hits = w.any(f);
                }
                if (!in_hits) {
                    // gap_shadow (bwtgap.c:81-91) in passes of nl columns
                    int32_t* wa = s.w + h_a * LP1;
                    int32_t* ba = s.bid + h_a * LP1;
                    const int lim = h_ldp < LP1 ? h_ldp : LP1;
                    uint32_t carry = 0;
                    for (int base = 0; base < lim; base += nl) {
                        Bool eq;
                        w.each([&](int lane) {
                            eq[lane] = dfs_shadow_eq(wa, base + lane, lim, x);
                        });
                        const uint32_t mask = w.ballot(eq);
                        w.each([&](int lane) {
                            dfs_shadow_write(
                                p, wa, ba, base + lane, lim, x,
                                carry + popc(mask & lane_mask_le(lane)));
                        });
                        carry += popc(mask);
                    }
                    if (n_aln >= H) {
                        // full hit list: flagged, the search goes on as
                        // in the lockstep engine
                        overflow = true;
                    } else {
                        w.each([&](int lane) {
                            if (lane == 0) {
                                hit_meta[n_aln] =
                                    (h_cnt & 0xFFFFFF) | (h_a << 24);
                                hit_k[n_aln] = (int32_t)h_k;
                                hit_l[n_aln] = (int32_t)h_l;
                                hit_score[n_aln] = h_score;
                            }
                        });
                        ++n_aln;
                    }
                    w.sync();
                }
            }
        }

        // expansion (bwtgap.c:201-259)
        if (expand) {
            const int e_a = (e_info >> 16) & 1;
            for (int c = 0; c < 4; ++c) {
                x.ck4[c] = ck4[c];
                x.cl4[c] = cl4[c];
            }

            // the candidates in passes of nl (one on the card) and the
            // kept ones' count; then, if they fit, their pushes
            const int passes = (DFS_CANDS + nl - 1) / nl;
            Cands c[DFS_CANDS];
            uint32_t mask[DFS_CANDS];
            int nc = 0;
#pragma unroll
            for (int q = 0; q < passes; ++q) {
                Bool kept;
                w.each([&](int lane) {
                    kept[lane] = dfs_cand(p, x, q * nl + lane, &c[q][lane]);
                });
                mask[q] = w.ballot(kept);
                nc += (int)popc(mask[q]);
            }
            // slot-pool exhaustion or the 16-bit seq counter running out
            // flag the read for the next tier
            if (nc > S - n_entries || seq_ctr + nc > 0xFFFF) {
                overflow = true;
                done = true;
            } else {
                int carry = 0;
#pragma unroll
                for (int q = 0; q < passes; ++q) {
                    w.each([&](int lane) {
                        if ((mask[q] >> lane) & 1u) {
                            const int rank = carry
                                + (int)popc(mask[q] & lane_mask_lt(lane));
                            dfs_push(p, s, n_entries + rank, seq_ctr + rank,
                                     e_a, c[q][lane]);
                        }
                    });
                    carry += (int)popc(mask[q]);
                }
                n_entries += nc;
                seq_ctr += nc;
                w.sync();
            }
        }

        ++iters;
        if (done) fin = iters;
        // iteration cap: the read is flagged for the next tier
        if (iters >= p.max_iters && !done) {
            overflow = true;
            done = true;
        }
    }

    w.each([&](int lane) {
        for (int j = lane; j < 4 * H; j += nl) r.out[j] = s.hits[j];
        if (lane == 0) {
            r.out[4 * H] = n_aln;
            r.out[4 * H + 1] = hw;
            r.out[4 * H + 2] = overflow ? 1 : 0;
            r.out[4 * H + 3] = fin;
            r.out[4 * H + 4] = iters;
        }
    });
}

}  // namespace nabwa
