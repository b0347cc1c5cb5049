"""Bounded gapped DFS over the FM-index (bwt_match_gap, bwtgap.c:104-266).

`dfs_match_gap_plain` is the plain PyTorch version: a line-for-line port
of the JAX package's lockstep engine (`nabwa_tpu/ops/dfs.py:103-575`).
The whole batch advances together; each outer iteration pops, or advances
the pending exact-match state of, one entry per live read, as masked
tensor ops over [B, S] slot arrays.  The per-read stack is a slot pool
whose key `score << 16 | 0xFFFF - seq` makes the minimum key the C's pop
order (lowest score, LIFO within a score).

`dfs_match_gap` dispatches on the device of the reads: CPU tensors run the
plain version, CUDA tensors launch the kernel of `csrc/dfs.cu`
(`ops/dfs_cuda.py`), and any other device raises.  Both return the same
packed int32 [B, 4H+5] result (layout in `unpack_result`).

Positions are uint32, held here as int64 values masked to 32 bits, so
every position compare is unsigned.
"""

import torch

from ..constants import (BWA_MODE_GAPE, BWA_MODE_LOGGAP, BWA_MODE_NONSTOP,
                         STATE_D, STATE_I, STATE_M)
from .occ import M32, cal_width_planes, occ4, select_base, u32

_I64 = torch.int64
FREE = 0x7FFFFFFF


def _s32(v):
    """Wrap int64 values to the int32 range (two's complement)."""
    return ((v + (1 << 31)) & M32) - (1 << 31)


def _int_log2(v):
    """int_log2 (bwtgap.c:93-102) for small non-negative values."""
    t = 1 << torch.arange(1, 16, device=v.device)
    return (v[..., None] >= t).sum(-1)


def _gather(row, pos):
    """row[b, pos[b]]; 0 where pos is out of range."""
    W = row.shape[1]
    ok = (pos >= 0) & (pos < W)
    v = row.gather(1, pos.clamp(0, W - 1)[:, None])[:, 0]
    return torch.where(ok, v, 0)


def aln_device_step(bwt_cat, bwt_fwd, bwt_rev, rev_word_offset, primary_fwd,
                    primary_rev, l2, seq_len, seqs, lengths, seed_seqs,
                    seed_lengths, has_seed, max_diff, **statics):
    """cal_width on both strands, for the reads and their seed suffixes
    (one launch of C2 on the card), then the DFS
    (`nabwa_tpu/ops/dfs.py:75`)."""
    widths, bids, seed_widths, seed_bids = cal_width_planes(
        bwt_fwd, bwt_rev, l2, primary_fwd, primary_rev, seq_len, seqs,
        lengths, seed_seqs, seed_lengths)
    return dfs_match_gap(bwt_cat, rev_word_offset, primary_fwd, primary_rev,
                         l2, seq_len, seqs, lengths, widths, bids,
                         seed_widths, seed_bids, has_seed, max_diff,
                         **statics)


def dfs_match_gap(bwt_cat, rev_word_offset, primary_fwd, primary_rev, l2,
                  seq_len, seqs, lengths, widths, bids, seed_widths,
                  seed_bids, has_seed, max_diff, **statics):
    """The DFS for a batch: plain version on CPU tensors, the CUDA kernel
    on CUDA tensors."""
    if seqs.device.type == "cpu":
        fn = dfs_match_gap_plain
    elif seqs.device.type == "cuda":
        from .dfs_cuda import dfs_match_gap_cuda as fn
    else:
        raise ValueError(f"dfs_match_gap: no kernel for device "
                         f"{seqs.device}")
    return fn(bwt_cat, rev_word_offset, primary_fwd, primary_rev, l2,
              seq_len, seqs, lengths, widths, bids, seed_widths, seed_bids,
              has_seed, max_diff, **statics)


def dfs_match_gap_plain(bwt_cat, rev_word_offset, primary_fwd, primary_rev,
                        l2, seq_len, seqs, lengths, widths, bids,
                        seed_widths, seed_bids, has_seed, max_diff, *, s_mm,
                        s_gapo, s_gape, max_gape, max_gapo, indel_end_skip,
                        max_del_occ, max_entries, max_top2, max_seed_diff,
                        seed_len, mode, stack_cap, hits_cap, max_iters):
    """Run the DFS for a batch, plain PyTorch.

    bwt_cat: int32 [Wf+Wr], forward then reverse interleaved BWT.
    seqs: int32 [B, 2, L] (seq / rseq codes, reversed-read orientation).
    lengths: int32 [B]; widths/bids: int32 [B, 2, L+1]; seed_*: [B, 2,
    SL+1]; has_seed: bool or int [B]; max_diff: int32 [B] per-read budget;
    max_gapo is the batch-clamped scalar (bwtaln.c:105).  l2 (5 counts),
    primary_*, seq_len: uint32 ints.  Returns the packed int32 [B, 4H+5]
    result (`nabwa_tpu/ops/dfs.py:568-574`).
    """
    dev = seqs.device
    B, _, L = seqs.shape
    S, H, LP1 = stack_cap, hits_cap, L + 1
    gape_mode = bool(mode & BWA_MODE_GAPE)
    nonstop = bool(mode & BWA_MODE_NONSTOP)
    loggap = bool(mode & BWA_MODE_LOGGAP)
    seq_len = int(seq_len) & M32
    primary_fwd = int(primary_fwd) & M32
    primary_rev = int(primary_rev) & M32
    l2v = torch.tensor([int(v) & M32 for v in l2], dtype=_I64, device=dev)
    seqs = seqs.to(_I64)
    lengths = lengths.to(_I64)
    has_seed = has_seed.to(torch.bool)
    s_iota = torch.arange(S, device=dev)
    h_iota = torch.arange(H, device=dev)
    lp_iota = torch.arange(LP1, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=_I64, device=dev)

    def aln_score(m, o, e):
        return m * s_mm + o * s_gapo + e * s_gape

    md = max_diff.to(_I64)
    s_key = torch.full((B, S), FREE, dtype=_I64, device=dev)
    s_info = zeros(B, S)       # ldp << 17 | a << 16 | i
    s_cnt = zeros(B, S)        # n_mm | go << 8 | ge << 16 | state << 24
    s_k = zeros(B, S)
    s_l = zeros(B, S)
    best_score = aln_score(md + 1, max_gapo + 1, max_gape + 1)
    best_cnt = zeros(B)
    n_aln = zeros(B)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    hw = zeros(B)
    pend = torch.zeros(B, dtype=torch.bool, device=dev)
    pend_i, pend_k, pend_l = zeros(B), zeros(B), zeros(B)
    pend_cnt, pend_a, pend_ldp = zeros(B), zeros(B), zeros(B)
    fin = zeros(B)
    iters = 0
    # per-strand D(i) planes, mutated by gap_shadow
    w0, w1 = u32(widths[:, 0, :]), u32(widths[:, 1, :])
    bid0, bid1 = bids[:, 0, :].to(_I64), bids[:, 1, :].to(_I64)
    hit_meta, hit_k, hit_l, hit_score = (zeros(B, H), zeros(B, H),
                                         zeros(B, H), zeros(B, H))

    # too many Ns in seq[0] -> no search at all (bwtgap.c:118-123)
    n_count = ((seqs[:, 0, :] > 3)
               & (torch.arange(L, device=dev) < lengths[:, None])).sum(1)
    done = (n_count > md) | (lengths <= 0)
    # the two strand seeds (bwtgap.c:127-128), both score 0; a=1 pops
    # first like the C (its key 0xFFFE is the smaller)
    seedable = ~done
    s_key[:, 0] = torch.where(seedable, 0xFFFF, FREE)
    s_key[:, 1] = torch.where(seedable, 0xFFFE, FREE)
    s_info[:, 0] = torch.where(seedable, lengths, 0)
    s_info[:, 1] = torch.where(seedable, (1 << 16) | lengths, 0)
    s_l[:, 0:2] = torch.where(seedable, seq_len, 0)[:, None]
    seq_ctr = torch.where(seedable, 2, 0)
    n_entries = seq_ctr.clone()

    seq_fwd, seq_rev = seqs[:, 0, :], seqs[:, 1, :]
    sw0_p, sw1_p = u32(seed_widths[:, 0, :]), u32(seed_widths[:, 1, :])
    sb0_p = seed_bids[:, 0, :].to(_I64)
    sb1_p = seed_bids[:, 1, :].to(_I64)

    def occ4_lane(k, a):
        """occ4 against bwts[1-a] per lane (bwtgap.c:149): a=0 -> reverse
        bank, a=1 -> forward bank."""
        offs = torch.where(a == 0, rev_word_offset, 0)
        prim = torch.where(a == 0, primary_rev, primary_fwd)
        return occ4(bwt_cat, prim, seq_len, k, word_offset=offs)

    def get_seq(a, pos):
        return _gather(torch.where((a == 0)[:, None], seq_fwd, seq_rev), pos)

    while bool((~done).any()):
        active = ~done
        in_pend = pend & active
        do_stack = active & ~pend

        # ---- stack checks (bwtgap.c:139-141) ----
        hw = torch.where(do_stack, torch.maximum(hw, n_entries), hw)
        empty = n_entries == 0
        over_cap = n_entries > max_entries
        done = done | (do_stack & (empty | over_cap))
        do_pop = do_stack & ~empty & ~over_cap

        # ---- pop: the minimum key (gap_pop, bwtgap.c:66-79); keys are
        # unique per live entry.  Empty lanes give garbage, masked by
        # do_pop below ----
        min_key, j = s_key.min(dim=1)
        e_score = min_key >> 16
        jj = j[:, None]
        e_info = s_info.gather(1, jj)[:, 0]
        e_cnt = s_cnt.gather(1, jj)[:, 0]
        e_k = s_k.gather(1, jj)[:, 0]
        e_l = s_l.gather(1, jj)[:, 0]
        s_key = torch.where((s_iota == jj) & do_pop[:, None], FREE, s_key)
        n_entries = n_entries - do_pop.to(_I64)

        e_a = (e_info >> 16) & 1
        e_ldp = e_info >> 17
        e_i = e_info & 0xFFFF
        e_nmm = e_cnt & 0xFF
        e_go = (e_cnt >> 8) & 0xFF
        e_ge = (e_cnt >> 16) & 0xFF
        e_state = (e_cnt >> 24) & 3

        a0 = (e_a == 0)[:, None]
        w_row = torch.where(a0, w0, w1)
        bid_row = torch.where(a0, bid0, bid1)

        # ---- best-score stop (bwtgap.c:144) ----
        if not nonstop:
            brk = do_pop & (e_score > best_score + s_mm)
            done = done | brk
            do_pop = do_pop & ~brk

        # ---- budget (bwtgap.c:146-148) ----
        m = md - (e_nmm + e_go)
        if gape_mode:
            m = m - e_ge
        proc = do_pop & (m >= 0)

        # ---- width lower bound (bwtgap.c:156) ----
        proc = proc & ~((e_i > 0) & (m < _gather(bid_row, e_i - 1)))

        # ---- hit / exact-path / expand split (bwtgap.c:158-164) ----
        direct_hit = proc & (e_i == 0)
        if gape_mode:
            exact_ok = torch.ones_like(proc)
        else:
            exact_ok = (e_state == STATE_M) | (e_ge == max_gape)
        need_exact = proc & ~direct_hit & (m == 0) & exact_ok
        expand = proc & ~direct_hit & ~need_exact

        pend = pend | need_exact
        pend_i = torch.where(need_exact, e_i, pend_i)
        pend_k = torch.where(need_exact, e_k, pend_k)
        pend_l = torch.where(need_exact, e_l, pend_l)
        pend_a = torch.where(need_exact, e_a, pend_a)
        pend_ldp = torch.where(need_exact, e_ldp, pend_ldp)
        pend_cnt = torch.where(need_exact, e_cnt, pend_cnt)

        # ---- one (k-1, l) occ4 pair per lane serves the pending step
        # and the expansion: a lane is pending or popping, never both ----
        occ_a = torch.where(in_pend, pend_a, e_a)
        occ_k = torch.where(in_pend, pend_k, e_k) - 1
        occ_l = torch.where(in_pend, pend_l, e_l)
        cnt = occ4_lane(torch.stack([occ_k, occ_l]), occ_a[None])
        cnt_k4, cnt_l4 = cnt[0], cnt[1]

        # ---- pending exact-match step (bwt_match_exact_alt, one base) ----
        pc = get_seq(pend_a, pend_i - 1)
        cc = pc.clamp(max=3)
        l2c = l2v[cc]
        nk = (l2c + select_base(cnt_k4, cc) + 1) & M32
        nl = (l2c + select_base(cnt_l4, cc)) & M32
        pfail = in_pend & ((pc > 3) | (nk > nl))
        pstep = in_pend & ~pfail
        pend_k = torch.where(pstep, nk, pend_k)
        pend_l = torch.where(pstep, nl, pend_l)
        pend_i = torch.where(pstep, pend_i - 1, pend_i)
        pend_hit = pstep & (pend_i == 0)
        pend = pend & ~(pend_hit | pfail)

        # ---- hit processing (bwtgap.c:166-199) ----
        hit_now = direct_hit | pend_hit
        h_cnt = torch.where(direct_hit, e_cnt, pend_cnt)
        h_nmm = h_cnt & 0xFF
        h_go = (h_cnt >> 8) & 0xFF
        h_ge = (h_cnt >> 16) & 0xFF
        h_a = torch.where(direct_hit, e_a, pend_a)
        h_ldp = torch.where(direct_hit, e_ldp, pend_ldp)
        h_k = torch.where(direct_hit, e_k, pend_k)
        h_l = torch.where(direct_hit, e_l, pend_l)
        h_score = aln_score(h_nmm, h_go, h_ge)

        first_hit = hit_now & (n_aln == 0)
        new_best_diff = h_nmm + h_go + (h_ge if gape_mode else 0)
        best_score = torch.where(first_hit, h_score, best_score)
        if not nonstop:
            md = torch.where(first_hit,
                             torch.minimum(new_best_diff + 1, md), md)
        eq_best = h_score == best_score
        x = (h_l - h_k + 1) & M32
        brk2 = hit_now & ~eq_best & (best_cnt > max_top2)
        best_cnt = _s32(best_cnt + torch.where(hit_now & eq_best, _s32(x), 0))
        done = done | brk2
        add_lane = hit_now & ~brk2
        # tandem-repeat dedup (bwtgap.c:179-183)
        in_hits = ((hit_k == h_k[:, None]) & (hit_l == h_l[:, None])
                   & (h_iota < n_aln[:, None])).any(1)
        do_add = add_lane & ~((h_go > 0) & in_hits)

        # gap_shadow (bwtgap.c:81-91) on the h_a-strand planes
        ha0 = (h_a == 0)[:, None]
        wa = torch.where(ha0, w0, w1)
        bida = torch.where(ha0, bid0, bid1)
        shadow = do_add[:, None] & (lp_iota < h_ldp[:, None])
        eq = shadow & (wa == x[:, None])
        gt = shadow & (wa > x[:, None])
        jc = eq.to(_I64).cumsum(1)
        wa_new = torch.where(gt, (wa - x[:, None]) & M32,
                             torch.where(eq, (seq_len - jc) & M32, wa))
        bida_new = torch.where(eq, 1, bida)
        upd0 = do_add[:, None] & ha0
        upd1 = do_add[:, None] & ~ha0
        w0 = torch.where(upd0, wa_new, w0)
        w1 = torch.where(upd1, wa_new, w1)
        bid0 = torch.where(upd0, bida_new, bid0)
        bid1 = torch.where(upd1, bida_new, bid1)

        # append the hit at n_aln; a full hit list flags the read
        hof = do_add & (n_aln >= H)
        overflow = overflow | hof
        write_hit = do_add & ~hof
        hmask = write_hit[:, None] & (h_iota == n_aln[:, None])
        meta = (h_cnt & 0xFFFFFF) | (h_a << 24)
        hit_meta = torch.where(hmask, meta[:, None], hit_meta)
        hit_k = torch.where(hmask, h_k[:, None], hit_k)
        hit_l = torch.where(hmask, h_l[:, None], hit_l)
        hit_score = torch.where(hmask, h_score[:, None], hit_score)
        n_aln = n_aln + write_hit.to(_I64)

        # ---- expansion (bwtgap.c:201-259) ----
        i2 = e_i - 1
        occ_width = (e_l - e_k + 1) & M32
        bid_i2m1 = _gather(bid_row, i2 - 1)
        bid_i2 = _gather(bid_row, i2)
        w_i2m1 = _gather(w_row, i2 - 1)
        w_i2 = _gather(w_row, i2)
        inner = i2 > 0
        allow_diff = ~inner | ~(bid_i2m1 > m - 1)
        allow_m = ~inner | ~((bid_i2m1 == m - 1) & (bid_i2 == m - 1)
                             & (w_i2m1 == w_i2))
        # seed bounds (bwtgap.c:210-214)
        ii = torch.where(has_seed, i2 - (lengths - seed_len), -1)
        sbid_row = torch.where(a0, sb0_p, sb1_p)
        sw_row = torch.where(a0, sw0_p, sw1_p)
        m_seed = max_seed_diff - (e_nmm + e_go) - (e_ge if gape_mode else 0)
        sbid_iim1 = _gather(sbid_row, ii - 1)
        seed_gate = inner & (ii > 0)
        allow_diff = allow_diff & ~(seed_gate & (sbid_iim1 > m_seed - 1))
        allow_m = allow_m & ~(seed_gate & (sbid_iim1 == m_seed - 1)
                              & (_gather(sbid_row, ii) == m_seed - 1)
                              & (_gather(sw_row, ii - 1)
                                 == _gather(sw_row, ii)))

        # indel gating (bwtgap.c:217-218)
        vsum = e_go + e_ge
        tmp = _int_log2(vsum) // 2 + 1 if loggap else vsum
        ind_ok = (allow_diff & (i2 >= indel_end_skip + tmp)
                  & (lengths - i2 >= indel_end_skip + tmp))

        is_m = e_state == STATE_M
        is_i = e_state == STATE_I
        is_d = e_state == STATE_D
        can_open = is_m & (e_go < max_gapo)
        can_ext_i = is_i & (e_ge < max_gape)
        can_ext_d = (is_d & (e_ge < max_gape)
                     & ((e_go + e_ge < md) | (occ_width < max_del_occ)))
        go_open = e_go + is_m.to(_I64)
        sc = get_seq(e_a, i2)

        # candidate pushes, exact C order: ins, del c=0..3, mm j=1..4;
        # each is (valid, i, k, l, nmm, go, ge, state, is_diff)
        one = torch.ones_like(expand)
        cands = [(expand & ind_ok & (can_open | can_ext_i), i2, e_k, e_l,
                  e_nmm, go_open, e_ge + is_i.to(_I64), STATE_I, one)]
        for c in range(4):
            dk = (l2v[c] + cnt_k4[:, c] + 1) & M32
            dl = (l2v[c] + cnt_l4[:, c]) & M32
            cands.append((expand & ind_ok & (can_open | can_ext_d)
                          & (dk <= dl), i2 + 1, dk, dl, e_nmm, go_open,
                          e_ge + is_d.to(_I64), STATE_D, one))
        mm_all = allow_diff & allow_m
        exact_only = ~mm_all & (sc < 4)
        for jm in range(1, 5):
            c = (sc + jm) & 3
            is_mm = (sc > 3) | (jm != 4)
            l2c = l2v[c]
            mk = (l2c + select_base(cnt_k4, c) + 1) & M32
            ml = (l2c + select_base(cnt_l4, c)) & M32
            v = expand & (mk <= ml) & (mm_all | (exact_only & (jm == 4)))
            cands.append((v, i2, mk, ml, e_nmm + is_mm.to(_I64), e_go, e_ge,
                          STATE_M, is_mm))

        def col(f):
            return torch.stack([torch.broadcast_to(torch.as_tensor(
                c[f], device=dev), (B,)) for c in cands], dim=1)

        valid, ci, ck, cl = col(0), col(1), col(2), col(3)
        cnmm, cgo, cge, cstate, cdiff = col(4), col(5), col(6), col(7), col(8)

        # push-time prune (nabwa_tpu/ops/dfs.py:498-514): max_diff and
        # best_score only tighten, so a candidate already over either
        # bound can never contribute when popped
        keep = cnmm + cgo + (cge if gape_mode else 0) <= md[:, None]
        csc = aln_score(cnmm, cgo, cge)
        if not nonstop:
            keep = keep & (csc <= (best_score + s_mm)[:, None])
        valid = valid & keep

        n_push = valid.sum(1)
        # slot-pool exhaustion or the 16-bit seq counter running out flag
        # the read for the retry tier / host drain
        sovf = expand & ((n_push > S - n_entries)
                         | (seq_ctr + n_push > 0xFFFF))
        overflow = overflow | sovf
        done = done | sovf
        valid = valid & ~sovf[:, None]

        vi = valid.to(_I64)
        cinfo = (torch.where(cdiff, ci, 0) << 17) | (e_a[:, None] << 16) | ci
        ccnt = cnmm | (cgo << 8) | (cge << 16) | (cstate << 24)
        prefix = vi.cumsum(1) - vi
        ckey = (csc << 16) | (0xFFFF - seq_ctr[:, None] - prefix)

        # candidate j goes to the (prefix_j + 1)-th free slot
        free = s_key == FREE
        frank = free.to(_I64).cumsum(1)
        for jc_ in range(len(cands)):
            mj = (valid[:, jc_:jc_ + 1] & free
                  & (frank == prefix[:, jc_:jc_ + 1] + 1))
            s_key = torch.where(mj, ckey[:, jc_:jc_ + 1], s_key)
            s_info = torch.where(mj, cinfo[:, jc_:jc_ + 1], s_info)
            s_cnt = torch.where(mj, ccnt[:, jc_:jc_ + 1], s_cnt)
            s_k = torch.where(mj, ck[:, jc_:jc_ + 1], s_k)
            s_l = torch.where(mj, cl[:, jc_:jc_ + 1], s_l)
        n_pushed = vi.sum(1)
        n_entries = n_entries + n_pushed
        seq_ctr = seq_ctr + n_pushed

        iters += 1
        fin = torch.where(active & done, iters, fin)
        # iteration cap: leftover reads are flagged for the next tier
        if iters >= max_iters:
            overflow = overflow | ~done
            done = torch.ones_like(done)

    cols = [hit_meta, hit_k, hit_l, hit_score, n_aln[:, None], hw[:, None],
            overflow.to(_I64)[:, None], fin[:, None],
            torch.full_like(fin, iters)[:, None]]
    return _s32(torch.cat(cols, dim=1)).to(torch.int32)


def unpack_result(packed, hits_cap):
    """Split the packed result into the logical outputs (works on numpy
    arrays and tensors alike)."""
    H = hits_cap
    return {
        "hit_meta": packed[:, 0:H],
        "hit_k": packed[:, H:2 * H],
        "hit_l": packed[:, 2 * H:3 * H],
        "hit_score": packed[:, 3 * H:4 * H],
        "n_aln": packed[:, 4 * H],
        "hw": packed[:, 4 * H + 1],
        "overflow": packed[:, 4 * H + 2] != 0,
        "iters": packed[0, 4 * H + 4] if packed.shape[0] else 0,
        "fin": packed[:, 4 * H + 3],
    }
