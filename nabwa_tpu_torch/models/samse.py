"""The `samse` workflow on the port's engine: the counterpart of
nabwa_tpu/models/post_native.py:831 `samse_bytes` (bwa_sai2sam_se_core,
bwase.c:654-721), one chunk of reads to SAM bytes.

Steps, in the reference's order:
  1. select   hit selection and multi enumeration with the shared drand48
              stream (native `se_select_batch`, the stream's one consumer)
  2. sa       SA rows -> pac coordinates (bwa_cal_pac_pos):
              `engine.sa_rows_both`, one kernel C3 launch for both strands
              on a CUDA engine
  3. mapQ     vectorised bwa_approx_mapQ
  4. refine   gapped refinement (bwa_refine_gapped): the banded global DP of
              `ops/dp.py`, kernel C4 on CUDA, and the backtrace on the host
  4c. colour  colour space only (`ntpac`, bwase.c:383-401): `colour_step`
              decodes the matched rows with `refmodel.cs2nt.cs2nt_batch`,
              writes the decoded codes, qualities and lengths back, and
              refines the gapped slots and every row with a cigar again,
              against the `.nt` pac with is_end_correct=0 (C4 again)
  5. md       MD/NM (native `md_batch`; against the `.nt` pac in colour
              space)
  6. trim     quality-trim cigar correction (bwa_correct_trimmed), not in
              colour space (bwase.c:418)
  7. emit     SAM text (native `sam_emit_batch`)

Steps 1, 5 and 7 run in the native host library (native/post.cpp).
`host_reference=True` runs steps 2 and 4 on the host instead, with the
pieces the JAX package uses off its accelerator (the native `bwt_sa_batch`
walk and `aln_global_native`): the reference the card's output is held
against.  Only that argument chooses it; nothing falls back to it.

The per-read host steps that the JAX package keeps in
nabwa_tpu/models/samse.py (`SeqState`, `refine_window`,
`refine_gapped_core`, `correct_trimmed`, `sam_header`, `G_LOG_N`,
`coor_pac2real` for bwasw, and `aln2seq_core`, `approx_mapQ` and
`cal_pac_pos` for bam2bam's pass-1 writer) are copied here; the sampe
driver uses them too.

`seconds` sums host seconds per part over calls: select (steps 1 and 3),
sa, dp (windows, packing, the copy to the device and the DP to its end),
dp_backtrace (the lattice copy back, backtraces, cigars), cs2nt (step
4c's decode and write-back; its refine books to dp and dp_backtrace), md,
emit (steps 6 and 7).  On the host reference route sa and dp are the native
walks.
"""

import math
import time

import numpy as np
import torch

from ..constants import (BWA_AVG_ERR, BWA_TYPE_NO_MATCH, BWA_TYPE_REPEAT,
                         BWA_TYPE_UNIQUE)
from ..index import native
from ..io.fastq import ReadBatch
from ..io.sai import AlnColumn
from ..ops import dp
from ..ops.sa_lookup import sa_lookup_plain
from ..refmodel.aln_scalar import cal_maxdiff
from ..refmodel.cs2nt import cs2nt_batch
from ..refmodel.stdaln_scalar import (ALN_PARAM_BWA, FROM_D, FROM_I, FROM_M,
                                      FROM_S, path2cigar32)
from ..utils.rand48 import Rand48
from .post_native import (F_C1, F_C2, F_CLIP_LEN, F_FULL_LEN, F_LEN, F_MAPQ,
                          F_NGE, F_NGO, F_NMM, F_POS, F_SA, F_SEQ_Q,
                          F_STRAND, F_TYPE, NF, bns_emit_arrays, flat,
                          maxdiff_for, pack_recs, post_threads)

_NEG1 = 0xFFFFFFFF

seconds = dict.fromkeys(("select", "sa", "dp", "dp_backtrace", "cs2nt",
                         "md", "emit"), 0.0)


# --- per-read host steps, copied from nabwa_tpu/models/samse.py ---

def _make_g_log_n():
    """g_log_n table (bwase_initialize, bwase.c:613-617)."""
    t = np.zeros(256, dtype=np.int32)
    for i in range(1, 256):
        t[i] = int(4.343 * math.log(i) + 0.5)
    return t


G_LOG_N = _make_g_log_n()


class SeqState:
    """Mutable per-read alignment state (the bwa_seq_t fields samse and
    sampe use)."""

    __slots__ = ("read", "type", "c1", "c2", "n_mm", "n_gapo", "n_gape",
                 "strand", "score", "sa", "pos", "mapQ", "seQ", "cigar",
                 "md", "nm", "multi", "n_multi", "extra_flag", "len",
                 "max_entries")

    def __init__(self, read):
        self.read = read
        self.len = read.len
        self.type = BWA_TYPE_NO_MATCH
        self.c1 = self.c2 = 0
        self.n_mm = self.n_gapo = self.n_gape = 0
        self.strand = 0
        self.score = 0
        self.sa = 0
        self.pos = 0
        self.mapQ = self.seQ = 0
        self.cigar = None          # list of (op, len) or None
        self.md = None
        self.nm = 0
        self.multi = []
        self.n_multi = 0
        self.extra_flag = 0
        self.max_entries = 0


def aln2seq_core(alns, s, rng, n_multi=0):
    """bwa_aln2seq_core (bwase.c:19-95) with set_main: reservoir-sample the
    primary hit among score ties (weighted by interval size), count c1/c2,
    optionally enumerate multi-hits.  rng is the shared Rand48 stream —
    call order is part of the output contract."""
    if not alns:
        s.type = BWA_TYPE_NO_MATCH
        s.c1 = s.c2 = 0
        return
    # alns are (n_mm, n_gapo, n_gape, a, k, l, score) tuples
    best = alns[0][6]
    cnt = 0
    i = 0
    drand48 = rng.drand48
    while i < len(alns):
        n_mm, n_gapo, n_gape, a, k, l, score = alns[i]
        if score > best:
            break
        w = l - k + 1
        if drand48() * (w + cnt) > float(cnt):
            s.n_mm = n_mm
            s.n_gapo = n_gapo
            s.n_gape = n_gape
            s.strand = a
            s.score = score
            s.sa = k + int(w * drand48())
        cnt += w
        i += 1
    s.c1 = cnt
    while i < len(alns):
        cnt += alns[i][5] - alns[i][4] + 1
        i += 1
    s.c2 = cnt - s.c1
    s.type = BWA_TYPE_REPEAT if s.c1 > 1 else BWA_TYPE_UNIQUE

    if n_multi:
        n_occ = sum(q[5] - q[4] + 1 for q in alns)
        s.multi = []
        s.n_multi = 0
        if n_occ > n_multi + 1:  # too many -> none (bwase.c:54-57)
            return
        rest = n_occ
        multi = []
        for q in alns:
            sz = q[5] - q[4] + 1
            if sz <= rest:
                for l in range(q[4], q[5] + 1):
                    multi.append(dict(pos=l, gap=q[1] + q[2],
                                      mm=q[0], strand=q[3],
                                      cigar=None, n_cigar=0))
                rest -= sz
            else:
                # unreachable given the cap above (bwase.c:75 comment)
                break
        multi = [m for m in multi if m["pos"] != s.sa]
        s.multi = multi[:n_multi] if len(multi) >= n_multi else multi
        s.n_multi = len(s.multi)


def approx_mapQ(s, mm):
    """bwa_approx_mapQ (bwase.c:113-122)."""
    if s.c1 == 0:
        return 23
    if s.c1 > 1:
        return 0
    if s.n_mm == mm:
        return 25
    if s.c2 == 0:
        return 37
    n = 255 if s.c2 >= 255 else s.c2
    return 0 if 23 < G_LOG_N[n] else 23 - G_LOG_N[n]


def cal_pac_pos(sa_rows_both, rev_len, states, max_mm, fnr):
    """bwa_cal_pac_pos (bwase.c:156-183) over SeqStates, the SA rows of
    both strands in one `sa_rows_both([rows0, rows1])` call
    (`engine.sa_rows_both`, or `sa_rows_both_native` on the host reference
    route).  Reverse-strand primary hits and multis resolve on the forward
    BWT; forward-strand ones on the reverse BWT with the rev_len - (sa +
    len) flip."""
    jobs = ([], [])                 # per strand a: (state, multi slot, row)
    for s in states:
        if s.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
            jobs[s.strand].append((s, -1, s.sa))
        for j, m in enumerate(s.multi):
            jobs[m["strand"]].append((s, j, m["pos"]))
    vals = sa_rows_both([np.array([t[2] for t in jobs[a]], dtype=np.uint32)
                         for a in (0, 1)])
    for a in (1, 0):
        for (s, j, _), v in zip(jobs[a], vals[a].tolist()):
            if not a:
                v = (rev_len - (v + s.len)) & _NEG1
            if j < 0:
                s.pos = v
            else:
                s.multi[j]["pos"] = v
    md_cache = {}
    for s in states:
        if s.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
            if fnr > 0.0:
                max_diff = md_cache.get(s.len)
                if max_diff is None:
                    max_diff = md_cache[s.len] = cal_maxdiff(
                        s.len, BWA_AVG_ERR, fnr)
            else:
                max_diff = max_mm
            s.seQ = s.mapQ = approx_mapQ(s, max_diff)


def refine_window(l_pac, pac, seq_codes, pos, ext, is_end_correct=True):
    """The reference-window slice of refine_gapped_core (bwase.c:193-207).
    Returns (ref_seq, __pos)."""
    length = len(seq_codes)
    # uint32 pos past l_pac is a wrapped negative (bwase.c:197)
    pos_u = pos & _NEG1
    __pos = pos_u if pos_u <= l_pac else int(np.int32(np.uint32(pos_u)))
    ref_len = length + abs(ext)
    if ext > 0:
        lo = __pos
        hi = min(__pos + ref_len, l_pac)
    else:
        x = __pos + (length if is_end_correct else ref_len)
        lo = max(x - ref_len, 0)
        hi = min(x, l_pac)
    ref_seq = pac[lo:hi] if hi > lo else np.zeros(0, dtype=np.uint8)
    return ref_seq, __pos


def refine_gapped_core(l_pac, pac, seq_codes, pos, ext, path,
                       is_end_correct=True):
    """refine_gapped_core (bwase.c:189-237) given the DP's path over the
    job's window.  seq_codes: forward-oriented read codes against the
    reference strand.  Returns (cigar list, new_pos)."""
    _, __pos = refine_window(l_pac, pac, seq_codes, pos, ext,
                             is_end_correct)
    cigar = path2cigar32(path)
    if not cigar:
        return [], __pos

    if ext < 0 and is_end_correct:  # fix forward-strand coordinate
        ll = 0
        for op, ln in cigar:
            if op == FROM_D:
                ll -= ln
            elif op == FROM_I:
                ll += ln
        __pos += ll

    if cigar[0][0] == FROM_D:  # 5' deletion
        __pos += cigar[0][1]
        cigar = cigar[1:]
    if cigar and cigar[-1][0] == FROM_D:  # 3' deletion
        cigar = cigar[:-1]
    # I at either end becomes S (bwase.c:230-232)
    if cigar and cigar[-1][0] == FROM_I:
        cigar[-1] = (FROM_S, cigar[-1][1])
    if cigar and cigar[0][0] == FROM_I:
        cigar[0] = (FROM_S, cigar[0][1])
    return cigar, __pos


def correct_trimmed(s):
    """bwa_correct_trimmed (bwase.c:320-354)."""
    r = s.read
    if s.len == r.full_len:
        return
    extra = r.full_len - s.len
    if s.strand == 0:
        if s.cigar and s.cigar[-1][0] == FROM_S:
            s.cigar[-1] = (FROM_S, s.cigar[-1][1] + extra)
        else:
            if s.cigar is None:
                s.cigar = [(FROM_M, s.len)]
            s.cigar = list(s.cigar) + [(FROM_S, extra)]
    else:
        if s.cigar and s.cigar[0][0] == FROM_S:
            s.cigar[0] = (FROM_S, s.cigar[0][1] + extra)
        else:
            if s.cigar is None:
                s.cigar = [(FROM_M, s.len)]
            s.cigar = [(FROM_S, extra)] + list(s.cigar)
    s.len = r.full_len


def sam_header(bns, rg_line=None, version="0.5.10-evan.6.3-nabwa"):
    lines = ["@SQ\tSN:%s\tLN:%d" % (a.name, a.length) for a in bns.anns]
    if rg_line:
        lines.append(rg_line)
    lines.append("@PG\tID:bwa\tPN:bwa\tVN:%s" % version)
    return "\n".join(lines) + "\n"


def coor_pac2real(bns, pac_coor, length):
    """bns_coor_pac2real (bntseq.c:272-306): (seqid, nn)."""
    anns = bns.anns
    left, mid, right = 0, 0, bns.n_seqs
    while left < right:
        mid = (left + right) >> 1
        if pac_coor >= anns[mid].offset:
            if mid == bns.n_seqs - 1:
                break
            if pac_coor < anns[mid + 1].offset:
                break
            left = mid + 1
        else:
            right = mid
    seqid = mid
    # hole overlap count (single overlapping hole, as in the reference)
    left, right = 0, bns.n_holes
    nn = 0
    holes = bns.ambs
    while left < right:
        hmid = (left + right) >> 1
        h = holes[hmid]
        if pac_coor >= h.offset + h.length:
            left = hmid + 1
        elif pac_coor + length <= h.offset:
            right = hmid
        else:
            if pac_coor >= h.offset:
                nn += (h.offset + h.length - pac_coor
                       if h.offset + h.length < pac_coor + length else length)
            else:
                nn += (h.length if h.offset + h.length < pac_coor + length
                       else length - (h.offset - pac_coor))
            break
    return seqid, nn


# --- the samse steps ---

class Chunk:
    """One chunk's columnar samse state: the native emitter's [n, NF]
    record table, the multi-hit slots (n_occ + 1 a read), and the cigars
    of refined rows and multi slots."""

    def __init__(self, reads, lens, state, stride, multi):
        self.reads = reads
        self.n = len(reads)
        self.colsrc = reads if isinstance(reads, ReadBatch) else None
        self.lens = lens
        self.state = state
        self.stride = stride
        (self.multi_pos, self.multi_gap, self.multi_mm, self.multi_strand,
         self.multi_n) = multi
        mslot, mlen = [], []
        for i in np.nonzero(self.multi_n)[0].tolist():
            for m in range(self.multi_n[i]):
                mslot.append(i * stride + m)
                mlen.append(lens[i])
        self.mslot = np.array(mslot, dtype=np.int64)
        self.mlen = np.array(mlen, dtype=np.int64)
        self.m_strand = (self.multi_strand[self.mslot] != 0 if len(mslot)
                         else np.zeros(0, dtype=bool))
        self.cigars = {}
        self.mcigars = {}
        self._fwd = {}

    @property
    def matched(self):
        return self.state[:, F_TYPE] != BWA_TYPE_NO_MATCH

    @property
    def strand(self):
        return self.state[:, F_STRAND] != 0

    def fwd_codes(self, i):
        """Read i's codes in forward orientation (cached)."""
        c = self._fwd.get(i)
        if c is None:
            c = self.reads[i].seq[::-1]
            self._fwd[i] = c
        return c


def select(reads, per_read_alns, n_occ, rng):
    """Step 1: hit selection and multi enumeration (exact drand48
    stream); advances rng."""
    n = len(reads)
    state = np.zeros((n, NF), dtype=np.int64)
    if isinstance(reads, ReadBatch):
        # columnar batch: length columns come straight off the offsets
        lens = reads.clip_lens()
        state[:, F_LEN] = lens
        state[:, F_FULL_LEN] = reads.full_lens()
        state[:, F_CLIP_LEN] = lens
    else:
        lens = np.array([r.len for r in reads], dtype=np.int64)
        state[:, F_LEN] = lens
        state[:, F_FULL_LEN] = [r.full_len for r in reads]
        state[:, F_CLIP_LEN] = [r.clip_len for r in reads]
    if isinstance(per_read_alns, AlnColumn):
        recs, counts = per_read_alns.columns()
    else:
        recs, counts = pack_recs(per_read_alns)
    stride = n_occ + 1
    multi = (np.zeros(n * stride, dtype=np.uint64),
             np.zeros(n * stride, dtype=np.int32),
             np.zeros(n * stride, dtype=np.int32),
             np.zeros(n * stride, dtype=np.int32),
             np.zeros(n, dtype=np.int32))
    rngst = np.array([rng.x], dtype=np.uint64)
    native.lib().se_select_batch(n, recs, counts, state.reshape(-1), rngst,
                                 1, n_occ, *multi)
    rng.x = int(rngst[0])
    return Chunk(reads, lens, state, stride, multi)


def sa_requests(ch):
    """The SA rows step 2 asks for: [(a, sel, msel, rows)] per strand a
    (1 forward, 0 reverse) with rows to look up; sel picks the reads, msel
    the multi slots, and rows holds the reads' rows then the slots'."""
    matched, strand = ch.matched, ch.strand
    out = []
    for a in (1, 0):
        sel = matched & (strand if a else ~strand)
        msel = ((ch.m_strand if a else ~ch.m_strand) if len(ch.mslot)
                else np.zeros(0, dtype=bool))
        rows = np.concatenate([
            ch.state[sel, F_SA].astype(np.uint32),
            ch.multi_pos[ch.mslot[msel]].astype(np.uint32)])
        if len(rows):
            out.append((a, sel, msel, rows))
    return out


def sa_rows_native(index, a, rows):
    """The host reference of `engine.sa_rows` on strand a's index (uint32
    rows -> raw uint32 values): the shared native bwt_sa walk.  That walk
    tests for a sampled row by masking with sa_intv - 1, which is the C's
    modulo only for a power of two; at any other interval the rows walk
    with the modulo of the plain PyTorch `sa_lookup` on the host."""
    fm = index.fwd if a else index.rev
    intv = int(fm.sa_intv)
    if intv & (intv - 1) == 0:
        return native.bwt_sa_batch(fm.bwt, fm.primary, index.fwd.l2,
                                   fm.seq_len, fm.sa, intv, rows)
    ix = index.on_host
    k = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.uint32)
                         .view(np.int32))
    out = sa_lookup_plain(ix.bwt_fwd if a else ix.bwt_rev, ix.l2,
                          ix.primary_fwd if a else ix.primary_rev,
                          ix.seq_len, ix.sa_fwd if a else ix.sa_rev,
                          ix.sa_intv, k)
    return out.numpy().view(np.uint32)


def sa_rows_both_native(index, rows):
    """The host reference of `engine.sa_rows_both`: `sa_rows_native` on
    each strand's rows (rows[a] on strand a)."""
    return [sa_rows_native(index, a, r) if len(r)
            else np.zeros(0, dtype=np.uint32) for a, r in enumerate(rows)]


def sa_rows_both_fn(engine, host_reference):
    """The both-strand SA walk of a route: `engine.sa_rows_both` (one C3
    launch on a CUDA engine), or the host reference's
    `sa_rows_both_native`."""
    if host_reference:
        return lambda rows: sa_rows_both_native(engine.index, rows)
    return engine.sa_rows_both


def sa_coords(engine, ch, host_reference=False):
    """Step 2: SA rows -> pac coordinates (bwase.c:156-183), both strands
    in one walk; reverse-strand positions are flipped by `rev.seq_len - (v
    + len)` here."""
    rev_len = engine.index.rev.seq_len
    state, lens = ch.state, ch.lens
    reqs = sa_requests(ch)
    rows = [np.zeros(0, dtype=np.uint32)] * 2
    for a, _, _, r in reqs:
        rows[a] = r
    vals = sa_rows_both_fn(engine, host_reference)(rows)
    for a, sel, msel, _ in reqs:
        v = vals[a].astype(np.int64)
        k = int(sel.sum())
        pv, mv = v[:k], v[k:]
        slots = ch.mslot[msel]
        if a:
            state[sel, F_POS] = pv
            ch.multi_pos[slots] = mv.astype(np.uint64)
        else:
            state[sel, F_POS] = (rev_len - (pv + lens[sel])) & _NEG1
            ch.multi_pos[slots] = \
                ((rev_len - (mv + ch.mlen[msel])) & _NEG1).astype(np.uint64)


def approx_mapq(ch, opt):
    """Step 3: vectorised bwa_approx_mapQ (bwase.c:113-122)."""
    state = ch.state
    md_arr = maxdiff_for(ch.lens, opt.fnr, opt.max_diff)
    c1 = state[:, F_C1]
    c2 = state[:, F_C2]
    g = G_LOG_N[np.minimum(c2, 255)]
    mq = np.where(c1 == 0, 23,
                  np.where(c1 > 1, 0,
                           np.where(state[:, F_NMM] == md_arr, 25,
                                    np.where(c2 == 0, 37,
                                             np.where(23 < g, 0, 23 - g)))))
    matched = ch.matched
    state[matched, F_MAPQ] = mq[matched]
    state[matched, F_SEQ_Q] = mq[matched]


def gapped_jobs(ch):
    """Step 4's jobs, gapped multi slots first, then gapped reads:
    [(apply, seq_codes, pos, ext)], apply(cigar, new_pos) storing the
    result (nabwa_tpu/models/post_native.py:927-963)."""
    state, strand = ch.state, ch.strand
    jobs = []
    for o in ch.mslot.tolist():
        if ch.multi_gap[o] == 0:
            continue
        i = o // ch.stride
        seqc = ch.reads[i].rseq if ch.multi_strand[o] else ch.fwd_codes(i)

        def apply_m(cig, newpos, o=o):
            ch.mcigars[o] = cig
            ch.multi_pos[o] = newpos

        jobs.append((apply_m, seqc, int(ch.multi_pos[o]),
                     (1 if ch.multi_strand[o] else -1) * int(ch.multi_gap[o])))
    gap_rows = np.nonzero(ch.matched & (state[:, F_NGO] > 0))[0]
    for i in gap_rows.tolist():
        seqc = ch.reads[i].rseq if strand[i] else ch.fwd_codes(i)

        def apply_s(cig, newpos, i=i):
            ch.cigars[i] = cig if cig else None
            state[i, F_POS] = newpos

        jobs.append((apply_s, seqc, int(state[i, F_POS]),
                     (1 if strand[i] else -1)
                     * int(state[i, F_NGO] + state[i, F_NGE])))
    return jobs


def refine_pairs(jobs, pac, l_pac, is_end_correct=True):
    """The (reference window, read) pair of every job (bwase.c:193-207)."""
    return [(refine_window(l_pac, pac, seqc, pos, ext, is_end_correct)[0],
             np.asarray(seqc)) for _, seqc, pos, ext in jobs]


def refine_jobs(jobs, pac, l_pac, device, host_reference=False,
                parts=None, is_end_correct=True):
    """Solve (apply, seq_codes, pos, ext) refinement jobs with the banded
    global DP on `device` (nabwa_tpu/models/samse.py:480-496), or with the
    native DP when host_reference is set, and apply each result.
    is_end_correct=False is colour space's second round against the `.nt`
    pac.  Host seconds go to parts["dp"] and parts["dp_backtrace"] (this
    module's `seconds` when parts is None)."""
    if not jobs:
        return
    parts = seconds if parts is None else parts
    t0 = time.perf_counter()
    pairs = refine_pairs(jobs, pac, l_pac, is_end_correct)
    parts["dp"] += time.perf_counter() - t0
    if host_reference:
        res = dp.banded_global_native(pairs, ALN_PARAM_BWA, seconds=parts)
    else:
        res = dp.banded_global_batch(pairs, ALN_PARAM_BWA, device,
                                     seconds=parts)
    t0 = time.perf_counter()
    for (apply, seqc, pos, ext), (_, path) in zip(jobs, res):
        apply(*refine_gapped_core(l_pac, pac, seqc, pos, ext, path=path,
                                  is_end_correct=is_end_correct))
    parts["dp_backtrace"] += time.perf_counter() - t0


def ragged_take(src, starts, lens, flags=None):
    """(flat, offsets) of the uint8 slices src[starts[i]:starts[i] +
    lens[i]] by the native ragged gather: flags[i] 1 reverses slice i, 3
    reverses and complements it."""
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = len(lens)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    out = np.empty(int(off[-1]), dtype=np.uint8)
    flags = (np.zeros(n, dtype=np.uint8) if flags is None
             else np.ascontiguousarray(flags, dtype=np.uint8))
    native.lib().gather_rows_u8(
        np.ascontiguousarray(src, dtype=np.uint8),
        np.ascontiguousarray(starts, dtype=np.int64), lens, flags, n, out,
        off, post_threads())
    return out, off


def clipped_columns(reads):
    """(codes, quals, off): each read's codes and ASCII qualities over its
    clipped length, in the read's own orientation (`r.seq[::-1]` and the
    head of `r.qual`)."""
    if isinstance(reads, ReadBatch):
        lens = reads.clip_lens()
        starts = reads.seq_off[reads.lo:reads.hi]
        codes, off = ragged_take(reads.codes_flat, starts, lens)
        quals, _ = ragged_take(reads.qual_flat, starts, lens)
        return codes, quals, off
    codes, off = flat([r.seq[::-1] for r in reads])
    quals, _ = flat([r.qual[:len(r.seq)] for r in reads])
    return codes, quals, off


def _revcomp(codes):
    return np.where(codes < 4, 3 - codes, codes)[::-1]


def colour_step(ch, clipped, full, l_pac, ntpac, device,
                host_reference=False, parts=None):
    """Step 4c, colour space (bwase.c:383-401) on a samse `Chunk` or a
    sampe `PairChunk`: cs2nt on every matched row, then the second refine
    round against the `.nt` pac with is_end_correct=0 over the gapped
    multi slots and the rows with a cigar.  clipped: `clipped_columns` of
    the rows; full: the rows' (codes, offsets) and (quals, offsets) as
    the emitter takes them.  Writes F_LEN and F_FULL_LEN (the decoded
    length) and returns (seqs, codes, quals): the rows' reference-forward
    codes for `md` (decoded rows only) and the emitter's columns with the
    decoded rows' codes and qualities in their original orientation."""
    parts = seconds if parts is None else parts
    t0 = time.perf_counter()
    state = ch.state
    codes, quals, off = clipped
    rows = np.nonzero(ch.matched)[0]
    strand = ch.strand
    lens = off[1:] - off[:-1]
    c_sel, o_sel = ragged_take(codes, off[rows], lens[rows])
    q_sel, _ = ragged_take(quals, off[rows], lens[rows])
    dec, dq, doff = cs2nt_batch(c_sel, q_sel, o_sel, strand[rows],
                                state[rows, F_POS],
                                [ch.cigars.get(i) for i in rows.tolist()],
                                l_pac, ntpac)
    n = doff[1:] - doff[:-1]
    state[rows, F_LEN] = n
    state[rows, F_FULL_LEN] = n
    # the emitter's columns: decoded rows in their original orientation
    # (reversed and complemented on the reverse strand), the rest as read
    rs = strand[rows].astype(np.uint8)
    dec_o, doff_o = ragged_take(dec, doff[:-1], n, 3 * rs)
    dq_o, _ = ragged_take(dq, doff[:-1], n, rs)
    cols = []
    for (src, soff), new in ((full[0], dec_o), (full[1], dq_o)):
        starts, slen = soff[:-1].copy(), soff[1:] - soff[:-1]
        starts[rows] = len(src) + doff_o[:-1]
        slen[rows] = n
        cols.append(ragged_take(np.concatenate([src, new]), starts, slen))
    mlen = np.zeros(len(state), dtype=np.int64)
    mlen[rows] = n
    mstart = np.zeros(len(state), dtype=np.int64)
    mstart[rows] = doff[:-1]
    seqs = ragged_take(dec, mstart, mlen)
    parts["cs2nt"] += time.perf_counter() - t0

    # the second round (bwase.c:390-399): a slot on the row's strand reads
    # the decoded codes, one on the other strand their reverse complement
    t0 = time.perf_counter()
    rf = {int(i): dec[doff[k]:doff[k + 1]] for k, i in enumerate(rows)}
    jobs = []
    for o in ch.mslot.tolist():
        if ch.multi_gap[o] == 0:
            continue
        i = o // ch.stride
        same = bool(ch.multi_strand[o]) == bool(strand[i])
        seqc = rf[i] if same else _revcomp(rf[i])

        def apply_m(cig, newpos, o=o):
            ch.mcigars[o] = cig
            ch.multi_pos[o] = newpos

        jobs.append((apply_m, seqc, int(ch.multi_pos[o]),
                     (1 if ch.multi_strand[o] else -1) * int(ch.multi_gap[o])))
    for i in rows.tolist():
        if not ch.cigars.get(i):
            continue

        def apply_s(cig, newpos, i=i):
            ch.cigars[i] = cig if cig else None
            state[i, F_POS] = newpos

        jobs.append((apply_s, rf[i], int(state[i, F_POS]),
                     (1 if strand[i] else -1)
                     * int(state[i, F_NGO] + state[i, F_NGE])))
    parts["dp"] += time.perf_counter() - t0
    refine_jobs(jobs, ntpac, l_pac, device, host_reference, parts,
                is_end_correct=False)
    return seqs, cols[0], cols[1]


def cigar_flat(cigars, n, extra=None, n_extra=0):
    """Flat int32 cigar words and offsets: rows 0..n-1 from `cigars`, then
    (when given) n_extra multi slots from `extra`, whose offsets follow."""
    counts = np.zeros(n, dtype=np.int64)
    for i, cg in cigars.items():
        if cg:
            counts[i] = 2 * len(cg)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    parts = [(cigars, off)]
    if extra is not None:
        mcounts = np.zeros(n_extra, dtype=np.int64)
        for o, cg in extra.items():
            if cg:
                mcounts[o] = 2 * len(cg)
        moff = np.zeros(n_extra + 1, dtype=np.int64)
        np.cumsum(mcounts, out=moff[1:])
        moff += off[-1]
        parts.append((extra, moff))
    cig = np.zeros(int(parts[-1][1][-1]), dtype=np.int32)
    for src, o in parts:
        for i, cg in src.items():
            if cg:
                cig[o[i]:o[i + 1]] = np.array(cg, dtype=np.int32).reshape(-1)
    return cig, np.concatenate([o for _, o in parts])


def md(ch, bns, pac, seqs=None):
    """Step 5: MD/NM with ambiguity holes (native md_batch); returns the
    MD text buffer and its offsets.  seqs: the rows' reference-forward
    codes (flat, offsets) where they are not the reads' own (colour
    space's decoded rows)."""
    n, strand = ch.n, ch.strand
    if seqs is not None:
        seq_flat, seq_off = seqs
    elif ch.colsrc is not None:
        seq_flat, seq_off = ch.colsrc.aligned_codes(strand)
    else:
        seq_flat, seq_off = flat([
            (ch.reads[i].rseq if strand[i] else ch.fwd_codes(i))
            for i in range(n)])
    cig, cig_off = cigar_flat(ch.cigars, n)
    _, _, _, _, amb_off, amb_len, amb_chr = bns_emit_arrays(bns)
    md_cap = int(seq_off[-1]) * 2 + 24 * n + 16
    md_buf = np.empty(md_cap, dtype=np.uint8)
    md_off = np.zeros(n + 1, dtype=np.int64)
    rc = native.lib().md_batch(n, ch.state.reshape(-1), seq_flat, seq_off,
                               cig, cig_off, pac, bns.l_pac, len(bns.ambs),
                               amb_off, amb_len, amb_chr, md_buf, md_cap,
                               md_off, post_threads())
    if rc != 0:
        raise RuntimeError(f"native md_batch failed ({rc})")
    return md_buf, md_off


def correct_trim(ch):
    """Step 6: bwa_correct_trimmed (bwase.c:320-354) on the rows whose
    clipped length is below the full length."""
    state = ch.state
    for i in np.nonzero(ch.lens < state[:, F_FULL_LEN])[0].tolist():
        s = SeqState(ch.reads[i])
        s.strand = int(state[i, F_STRAND])
        s.cigar = list(ch.cigars[i]) if ch.cigars.get(i) else None
        s.len = int(state[i, F_LEN])
        correct_trimmed(s)
        ch.cigars[i] = s.cigar
        state[i, F_LEN] = s.len


def emit_rows(state, mate_idx, names, bcs, codes, quals, cigars, mcigars,
              multi, stride, md_buf, md_off, bns, opt, rg_id):
    """SAM text of the rows of `state` (native sam_emit_batch,
    bwa_print_sam1 bwase.c:458-592), shared by samse and sampe.  mate_idx:
    each row's mate row or -1; names, bcs, codes, quals: (flat, offsets)
    columns; multi: (pos, gap, mm, strand, n) slots, `stride` a row."""
    n = len(state)
    cig, cig_off = cigar_flat(cigars, n, mcigars, n * stride)
    ann_off, ann_len, ann_names, ann_name_off, amb_off, amb_len, \
        amb_chr = bns_emit_arrays(bns)
    rg = rg_id.encode() if rg_id else b""
    rg_arr = (np.frombuffer(rg, dtype=np.uint8) if rg
              else np.zeros(0, dtype=np.uint8))
    args = (n, state.reshape(-1), np.ascontiguousarray(mate_idx,
                                                       dtype=np.int64),
            *names, *bcs, cig, cig_off, md_buf, md_off, *codes, *quals,
            *multi, stride, bns.n_seqs, ann_off, ann_len, ann_names,
            ann_name_off, len(bns.ambs), amb_off, amb_len, amb_chr,
            bns.l_pac, opt.mode, opt.max_top2, rg_arr, len(rg))
    lib = native.lib()
    cap = int(codes[1][-1]) * 3 + int(md_off[-1]) + 256 * n + 1024
    out = np.empty(cap, dtype=np.uint8)
    total = lib.sam_emit_batch(*args, out, cap, post_threads())
    if total > cap:
        out = np.empty(int(total), dtype=np.uint8)
        total = lib.sam_emit_batch(*args, out, int(total), post_threads())
    return out[:total].tobytes()


def emit_columns(ch):
    """The emitter's (codes, offsets) and (quals, offsets) columns of a
    samse chunk: each read's untrimmed codes and qualities."""
    if ch.colsrc is not None:
        return ch.colsrc.code_bytes(), ch.colsrc.qual_bytes()
    return (flat([r.full_codes for r in ch.reads]),
            flat([(r.qual.tobytes() if r.qual is not None else b"")
                  for r in ch.reads]))


def emit(ch, bns, opt, rg_id, md_buf, md_off, cols=None):
    """Step 7: the chunk's SAM text, no mates.  cols: the (codes, quals)
    columns where they are not `emit_columns(ch)` (colour space)."""
    n, reads = ch.n, ch.reads
    codes, quals = cols if cols is not None else emit_columns(ch)
    if ch.colsrc is not None:
        names = ch.colsrc.name_bytes()
        bcs = (np.zeros(0, np.uint8), np.zeros(n + 1, np.int64))
    else:
        names = flat([r.name.encode() for r in reads])
        bcs = flat([r.bc.encode() if r.bc else b"" for r in reads])
    multi = (ch.multi_pos, ch.multi_gap, ch.multi_mm, ch.multi_strand,
             ch.multi_n)
    return emit_rows(ch.state, np.full(n, -1, dtype=np.int64), names, bcs,
                     codes, quals, ch.cigars, ch.mcigars, multi, ch.stride,
                     md_buf, md_off, bns, opt, rg_id)


def samse_bytes(engine, reads, per_read_alns, opt, n_occ=3, rng=None,
                rg_id=None, ntpac=None, host_reference=False):
    """samse for one chunk on the port's engine: the SAM text as bytes, one
    newline-terminated line per read.  rng is the shared drand48 stream
    (a fresh one seeded from the index when None); ntpac, the unpacked
    `.nt` pac, turns on colour space (step 4c); host_reference runs steps
    2 and 4 on the host's native walks (see the module docstring)."""
    if not len(reads):
        return b""
    index = engine.index
    bns, pac = index.bns, index.pac
    if rng is None:
        rng = Rand48(bns.seed)
    t0 = time.perf_counter()
    ch = select(reads, per_read_alns, n_occ, rng)
    t1 = time.perf_counter()
    sa_coords(engine, ch, host_reference)
    t2 = time.perf_counter()
    approx_mapq(ch, opt)
    t3 = time.perf_counter()
    jobs = gapped_jobs(ch)
    t4 = time.perf_counter()
    refine_jobs(jobs, pac, bns.l_pac, engine.device, host_reference)
    seqs = cols = None
    if ntpac is not None:
        seqs, *cols = colour_step(ch, clipped_columns(reads),
                                  emit_columns(ch), bns.l_pac, ntpac,
                                  engine.device, host_reference)
    t5 = time.perf_counter()
    md_buf, md_off = md(ch, bns, pac if ntpac is None else ntpac, seqs)
    t6 = time.perf_counter()
    if ntpac is None:          # trim correction is Illumina-only
        correct_trim(ch)
    blob = emit(ch, bns, opt, rg_id, md_buf, md_off, cols)
    t7 = time.perf_counter()
    seconds["select"] += (t1 - t0) + (t3 - t2)
    seconds["sa"] += t2 - t1
    seconds["dp"] += t4 - t3         # refine_jobs books its own parts
    seconds["md"] += t6 - t5
    seconds["emit"] += t7 - t6
    return blob
