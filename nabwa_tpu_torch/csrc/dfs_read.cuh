// The per-read search of kernel C1 (bwt_match_gap, bwtgap.c:104-266), in
// NABWA_HD code: nvcc compiles it into the kernel of dfs.cu, and a host
// C++ compiler compiles the same source for the CPU tests
// (host_harness.cpp).  Its semantics are those of the jnp lockstep engine
// nabwa_tpu/ops/dfs.py:103-575 and of nabwa_tpu_torch/ops/dfs.py.

#pragma once

#include "occ.cuh"

namespace nabwa {

constexpr int STATE_M = 0, STATE_I = 1, STATE_D = 2;
constexpr int MODE_GAPE = 0x01, MODE_LOGGAP = 0x04, MODE_NONSTOP = 0x10;

// Field order matches DFS_PARAMS in nabwa_tpu_torch/ops/dfs_cuda.py.
struct DfsParams {
    uint32_t l2[5];
    uint32_t primary_fwd, primary_rev, seq_len, rev_word_offset;
    int s_mm, s_gapo, s_gape, max_gape, max_gapo, indel_end_skip,
        max_del_occ, max_entries, max_top2, max_seed_diff, seed_len, mode;
    int S, H, L, SL1, max_iters;
};
constexpr int N_PARAMS = 26;
static_assert(sizeof(DfsParams) == N_PARAMS * 4, "DfsParams layout");

// DfsParams from the wrapper's N_PARAMS uint32 words, in field order.
NABWA_HD DfsParams dfs_params(const uint32_t* words) {
    DfsParams p;
    uint32_t* dst = reinterpret_cast<uint32_t*>(&p);
    for (int j = 0; j < N_PARAMS; ++j) dst[j] = words[j];
    return p;
}

struct ReadIO {
    const int32_t* seq[2];      // [L] codes per strand
    int len, max_diff;
    bool has_seed;
    const int32_t* w_in;        // [2, L+1] widths (uint32 bits)
    const int32_t* b_in;        // [2, L+1] bids
    const int32_t* sw[2];       // [SL1] seed widths
    const int32_t* sb[2];       // [SL1] seed bids
    int32_t* w[2];              // [L+1] mutable width planes
    int32_t* bid[2];            // [L+1] mutable bid planes
    int32_t* key;               // [S] stack entries, n_entries live
    int32_t* info;              // ldp << 17 | a << 16 | i
    int32_t* cnt;               // n_mm | go << 8 | ge << 16 | state << 24
    uint32_t* sk;
    uint32_t* sl;
    int32_t* out;               // [4H+5] packed result row
};

struct Cand {
    int i, nmm, go, ge, state;
    uint32_t k, l;
    bool diff;
};

NABWA_HD int gat(const int32_t* row, int pos, int width) {
    return (pos >= 0 && pos < width) ? row[pos] : 0;
}

NABWA_HD int int_log2(int v) {
    int n = 0;
    for (int t = 1; t < 16; ++t) n += v >= (1 << t);
    return n;
}

NABWA_HD int aln_score(const DfsParams& p, int m, int o, int e) {
    return m * p.s_mm + o * p.s_gapo + e * p.s_gape;
}

// the push-time prune of nabwa_tpu/ops/dfs.py:498-514: max_diff and
// best_score only tighten, so a candidate already past either bound can
// never contribute when popped
NABWA_HD bool keep(const DfsParams& p, const Cand& t, int md, int bound) {
    const int diff = t.nmm + t.go + ((p.mode & MODE_GAPE) ? t.ge : 0);
    return diff <= md && aln_score(p, t.nmm, t.go, t.ge) <= bound;
}

NABWA_HD void dfs_read(const DfsParams& p, const uint32_t* bwt_cat,
                       const ReadIO& r) {
    const int S = p.S, H = p.H, L = p.L, LP1 = p.L + 1, SL1 = p.SL1;
    const bool gape = p.mode & MODE_GAPE;
    const bool nonstop = p.mode & MODE_NONSTOP;
    const bool loggap = p.mode & MODE_LOGGAP;
    int32_t* hit_meta = r.out;
    int32_t* hit_k = r.out + H;
    int32_t* hit_l = r.out + 2 * H;
    int32_t* hit_score = r.out + 3 * H;
    for (int j = 0; j < 4 * H; ++j) r.out[j] = 0;
    for (int s = 0; s < 2; ++s)
        for (int j = 0; j < LP1; ++j) {
            r.w[s][j] = r.w_in[s * LP1 + j];
            r.bid[s][j] = r.b_in[s * LP1 + j];
        }

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
    int n_count = 0;
    for (int i = 0; i < r.len && i < L; ++i) n_count += r.seq[0][i] > 3;
    done = n_count > md || r.len <= 0;
    if (!done) {
        // the two strand seeds (bwtgap.c:127-128); a=1 pops first
        for (int a = 0; a < 2; ++a) {
            r.key[a] = 0xFFFF - a;
            r.info[a] = (a << 16) | r.len;
            r.cnt[a] = 0;
            r.sk[a] = 0;
            r.sl[a] = p.seq_len;
        }
        n_entries = seq_ctr = 2;
    }

    while (!done) {
        const bool in_pend = pend;
        bool expand = false, direct_hit = false;
        int e_info = 0, e_cnt = 0, m = 0;
        uint32_t e_k = 0, e_l = 0;

        if (!in_pend) {
            // stack checks (bwtgap.c:139-141)
            hw = hw > n_entries ? hw : n_entries;
            if (n_entries == 0 || n_entries > p.max_entries) {
                // never pop an empty stack: no slot is read
                done = true;
            } else {
                // pop the minimum key (gap_pop, bwtgap.c:66-79)
                int jmin = 0;
                int32_t kmin = r.key[0];
                for (int j = 1; j < n_entries; ++j)
                    if (r.key[j] < kmin) {
                        kmin = r.key[j];
                        jmin = j;
                    }
                e_info = r.info[jmin];
                e_cnt = r.cnt[jmin];
                e_k = r.sk[jmin];
                e_l = r.sl[jmin];
                const int last = n_entries - 1;
                r.key[jmin] = r.key[last];
                r.info[jmin] = r.info[last];
                r.cnt[jmin] = r.cnt[last];
                r.sk[jmin] = r.sk[last];
                r.sl[jmin] = r.sl[last];
                n_entries = last;

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
                    if (proc && e_i > 0 && m < gat(r.bid[e_a], e_i - 1, LP1))
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
        }

        // one (k-1, l) occ4 pair serves the pending step or the expansion
        uint32_t ck4[4] = {0, 0, 0, 0}, cl4[4] = {0, 0, 0, 0};
        if (in_pend || expand) {
            const int oa = in_pend ? pend_a : ((e_info >> 16) & 1);
            const uint32_t* bank =
                oa == 0 ? bwt_cat + p.rev_word_offset : bwt_cat;
            const uint32_t prim = oa == 0 ? p.primary_rev : p.primary_fwd;
            nabwa::occ4(bank, prim, (in_pend ? pend_k : e_k) - 1u, ck4);
            nabwa::occ4(bank, prim, in_pend ? pend_l : e_l, cl4);
        }

        // pending exact-match step (bwt_match_exact_alt, one base)
        bool pend_hit = false;
        if (in_pend) {
            const int pc = gat(r.seq[pend_a], pend_i - 1, L);
            const int cc = pc < 0 ? 0 : (pc > 3 ? 3 : pc);
            const uint32_t nk = p.l2[cc] + ck4[cc] + 1u;
            const uint32_t nl = p.l2[cc] + cl4[cc];
            if (pc > 3 || nk > nl) {
                pend = false;
            } else {
                pend_k = nk;
                pend_l = nl;
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
                // tandem-repeat dedup (bwtgap.c:179-183)
                bool in_hits = false;
                for (int j = 0; j < n_aln; ++j)
                    in_hits |= (uint32_t)hit_k[j] == h_k
                               && (uint32_t)hit_l[j] == h_l;
                if (!(h_go > 0 && in_hits)) {
                    // gap_shadow (bwtgap.c:81-91)
                    int32_t* wa = r.w[h_a];
                    int32_t* ba = r.bid[h_a];
                    const int lim = h_ldp < LP1 ? h_ldp : LP1;
                    uint32_t jc = 0;
                    for (int j = 0; j < lim; ++j) {
                        const uint32_t w = (uint32_t)wa[j];
                        if (w == x) {
                            ++jc;
                            wa[j] = (int32_t)(p.seq_len - jc);
                            ba[j] = 1;
                        } else if (w > x) {
                            wa[j] = (int32_t)(w - x);
                        }
                    }
                    if (n_aln >= H) {
                        // full hit list: flagged, the search goes on as
                        // in the lockstep engine
                        overflow = true;
                    } else {
                        hit_meta[n_aln] = (h_cnt & 0xFFFFFF) | (h_a << 24);
                        hit_k[n_aln] = (int32_t)h_k;
                        hit_l[n_aln] = (int32_t)h_l;
                        hit_score[n_aln] = h_score;
                        ++n_aln;
                    }
                }
            }
        }

        // expansion (bwtgap.c:201-259)
        if (expand) {
            const int e_a = (e_info >> 16) & 1, e_i = e_info & 0xFFFF;
            const int e_nmm = e_cnt & 0xFF, e_go = (e_cnt >> 8) & 0xFF;
            const int e_ge = (e_cnt >> 16) & 0xFF;
            const int e_state = (e_cnt >> 24) & 3;
            const int i2 = e_i - 1;
            const uint32_t occ_width = e_l - e_k + 1u;
            const int32_t* bid_row = r.bid[e_a];
            const int32_t* w_row = r.w[e_a];
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
                const int s1 = gat(r.sb[e_a], ii - 1, SL1);
                const int s2 = gat(r.sb[e_a], ii, SL1);
                if (s1 > m_seed - 1) allow_diff = false;
                if (s1 == m_seed - 1 && s2 == m_seed - 1
                    && gat(r.sw[e_a], ii - 1, SL1) == gat(r.sw[e_a], ii, SL1))
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
            const int go_open = e_go + is_m;
            const int sc = gat(r.seq[e_a], i2, L);

            // candidates in the C's order: ins, del c=0..3, mm j=1..4
            Cand c[9];
            int nc = 0;
            const int bound = nonstop ? 0x7FFFFFFF : best_score + p.s_mm;
            if (ind_ok && (can_open || can_ext_i)) {
                Cand t = {i2, e_nmm, go_open, e_ge + is_i, STATE_I, e_k, e_l,
                          true};
                if (keep(p, t, md, bound)) c[nc++] = t;
            }
            for (int b = 0; b < 4; ++b) {
                const uint32_t dk = p.l2[b] + ck4[b] + 1u;
                const uint32_t dl = p.l2[b] + cl4[b];
                if (ind_ok && (can_open || can_ext_d) && dk <= dl) {
                    Cand t = {i2 + 1, e_nmm, go_open, e_ge + is_d, STATE_D,
                              dk, dl, true};
                    if (keep(p, t, md, bound)) c[nc++] = t;
                }
            }
            const bool mm_all = allow_diff && allow_m;
            const bool exact_only = !mm_all && sc < 4;
            for (int jm = 1; jm <= 4; ++jm) {
                const int b = (sc + jm) & 3;
                const bool is_mm = jm != 4 || sc > 3;
                const uint32_t mk = p.l2[b] + ck4[b] + 1u;
                const uint32_t ml = p.l2[b] + cl4[b];
                if (mk <= ml && (mm_all || (exact_only && jm == 4))) {
                    Cand t = {i2, e_nmm + is_mm, e_go, e_ge, STATE_M, mk, ml,
                              is_mm};
                    if (keep(p, t, md, bound)) c[nc++] = t;
                }
            }
            // slot-pool exhaustion or the 16-bit seq counter running out
            // flag the read for the next tier
            if (nc > S - n_entries || seq_ctr + nc > 0xFFFF) {
                overflow = true;
                done = true;
            } else {
                for (int t = 0; t < nc; ++t) {
                    const int slot = n_entries + t;
                    const int csc = aln_score(p, c[t].nmm, c[t].go, c[t].ge);
                    const int ldp = c[t].diff ? c[t].i : 0;
                    r.key[slot] = (csc << 16) | (0xFFFF - seq_ctr - t);
                    r.info[slot] = (ldp << 17) | (e_a << 16) | c[t].i;
                    r.cnt[slot] = c[t].nmm | (c[t].go << 8) | (c[t].ge << 16)
                                  | (c[t].state << 24);
                    r.sk[slot] = c[t].k;
                    r.sl[slot] = c[t].l;
                }
                n_entries += nc;
                seq_ctr += nc;
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

    r.out[4 * H] = n_aln;
    r.out[4 * H + 1] = hw;
    r.out[4 * H + 2] = overflow ? 1 : 0;
    r.out[4 * H + 3] = fin;
    r.out[4 * H + 4] = iters;
}

// The per-read views of one batch (the layouts the wrapper allocates):
// seqs [B, 2, L], widths/bids [B, 2, L+1], seed planes [B, 2, SL1],
// slots [B, 5, S], planes [2, B, 2, L+1], out [B, 4H+5].
NABWA_HD ReadIO read_io(const DfsParams& p, const int32_t* seqs,
                        const int32_t* lengths, const int32_t* widths,
                        const int32_t* bids, const int32_t* seed_widths,
                        const int32_t* seed_bids, const int32_t* has_seed,
                        const int32_t* max_diff, int32_t* slots,
                        int32_t* planes, int32_t* out, int b, int B) {
    const int L = p.L, LP1 = p.L + 1, SL1 = p.SL1, S = p.S;
    ReadIO r;
    r.seq[0] = seqs + (size_t)b * 2 * L;
    r.seq[1] = r.seq[0] + L;
    r.len = lengths[b];
    r.max_diff = max_diff[b];
    r.has_seed = has_seed[b] != 0;
    r.w_in = widths + (size_t)b * 2 * LP1;
    r.b_in = bids + (size_t)b * 2 * LP1;
    r.sw[0] = seed_widths + (size_t)b * 2 * SL1;
    r.sw[1] = r.sw[0] + SL1;
    r.sb[0] = seed_bids + (size_t)b * 2 * SL1;
    r.sb[1] = r.sb[0] + SL1;
    r.w[0] = planes + (size_t)b * 2 * LP1;
    r.w[1] = r.w[0] + LP1;
    r.bid[0] = planes + (size_t)B * 2 * LP1 + (size_t)b * 2 * LP1;
    r.bid[1] = r.bid[0] + LP1;
    int32_t* base = slots + (size_t)b * 5 * S;
    r.key = base;
    r.info = base + S;
    r.cnt = base + 2 * S;
    r.sk = reinterpret_cast<uint32_t*>(base + 3 * S);
    r.sl = reinterpret_cast<uint32_t*>(base + 4 * S);
    r.out = out + (size_t)b * (4 * p.H + 5);
    return r;
}

}  // namespace nabwa
