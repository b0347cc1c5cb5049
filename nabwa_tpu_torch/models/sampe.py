"""The `sampe` workflow on the port's engine: the counterpart of
nabwa_tpu/models/post_native.py:425 `sampe_bytes` (bwa_sai2sam_pe_core,
bwape.c:660-762), one chunk of read pairs to SAM bytes.

The two ends live interleaved in one [2n, NF] state table (row 2i end 0,
row 2i+1 end 1: the emit order).  Steps, in the reference's order:
  1. select   hit selection with the shared drand48 stream (native
              `se_select_batch`, no multi slots yet)
  2. sa       SA rows -> positions of the chosen hits (`engine.sa_rows`,
              kernel C3 on a CUDA engine), then mapQ
  3. isize    insert-size inference (`infer_isize_core`)
  4. pairing  every hit interval expanded to positions (C3, the wide-
              interval memo `pos_memo` carried across chunks), then the
              native per-pair sweep `pe_pairing_batch`
  5. multi    multi-hit enumeration (native `se_multi_batch`), their SA
              rows through C3
  6. rescue   mate rescue (bwa_paired_sw): the `paired_sw1_gen` generators
              in lockstep rounds, each round's local-SW jobs solved by
              `ops.dp.local_sw_batch` (forward lattice: kernel C5; reverse
              pass: native; path: kernel C4), on per-pair proxies written
              back into the table
  7. refine   gapped refinement of the rows that rescue did not place and
              of the gapped multi slots (`models.samse.refine_jobs`, C4)
  8. md, trim, emit  native MD/NM, quality-trim fix-ups, native SAM
              emission with mate_idx = row ^ 1

`host_reference=True` runs the SA, rescue and DP steps on the native host
code instead (the `bwt_sa_batch` walk, `local_fwd_native`,
`aln_global_native`): the reference the card's output is held against.
Only that argument chooses it; nothing falls back to it.  Colour space
(`ntpac`, BWA_PET_SOLID) is not ported and raises.

The rescue generators, `infer_isize_core`, `IsizeInfo` and `hash_64` (for
bam2bam's counter RNG) are copied from nabwa_tpu/models/sampe.py.
`seconds` sums host seconds per part over calls: select (with mapQ), sa,
isize, pairing, multi, rescue_drive (the rescue's generators, proxies and
write-back), rescue_fwd, rescue_rev and rescue_path
(`ops.dp.local_sw_batch`'s parts), dp and dp_backtrace (the refine step,
as in `models.samse`), md and emit (with the trim fix-ups).
"""

import math
import time

import numpy as np

from ..constants import (BWA_PET_STD, BWA_TYPE_MATESW, BWA_TYPE_NO_MATCH,
                         SAM_FPD, SAM_FPP, SAM_FR1, SAM_FR2)
from ..index import native
from ..io.fastq import ReadBatch
from ..io.sai import AlnColumn
from ..ops import dp
from ..refmodel.stdaln_scalar import (ALN_PARAM_BWA, FROM_D, FROM_I, FROM_M,
                                      FROM_S, path2cigar32)
from . import samse as se
from .post_native import (F_C1, F_C2, F_CLIP_LEN, F_FULL_LEN, F_LEN, F_MAPQ,
                          F_NGE, F_NGO, F_NMM, F_POS, F_SA, F_SCORE,
                          F_SEQ_Q, F_STRAND, F_TYPE, F_XFLAG, NF,
                          bns_emit_arrays, build_pair_keys, flat,
                          interleave_flats, pack_recs, post_threads)

OUTLIER_BOUND = 2.0     # bwape.h:34
SW_MIN_MATCH_LEN = 20   # bwape.h:36
SW_MIN_MAPQ = 17        # bwape.h:37

_NEG1 = 0xFFFFFFFF
_U64MAX = (1 << 64) - 1

seconds = dict.fromkeys(("select", "sa", "isize", "pairing", "multi",
                         "rescue_drive", "rescue_fwd", "rescue_rev",
                         "rescue_path", "dp", "dp_backtrace", "md", "emit"),
                        0.0)
# the parts `ops.dp.local_sw_batch` books while it solves rescue jobs
RESCUE_SOLVE = ("rescue_fwd", "rescue_rev", "rescue_path")


# --- copied from nabwa_tpu/models/sampe.py ---

def hash_64(key):
    """hash_64 (bwape.c:43-54), 64-bit wrapping."""
    M = _U64MAX
    key = (key + (~(key << 32) & M)) & M
    key ^= key >> 22
    key = (key + (~(key << 13) & M)) & M
    key ^= key >> 8
    key = (key + (key << 3)) & M
    key ^= key >> 15
    key = (key + (~(key << 27) & M)) & M
    key ^= key >> 31
    return key


def _clog(x):
    """C log(): log(0) = -inf instead of raising."""
    return -math.inf if x == 0.0 else math.log(x)


def _cint(x):
    """C (int) conversion of a double on x86: out-of-range/inf/nan
    saturate to INT_MIN via cvttsd2si."""
    if math.isnan(x) or math.isinf(x) or not (-2**31 <= x < 2**31):
        return -2**31
    return int(x)


class IsizeInfo:
    """isize_info_t (bwape.h:16-20)."""

    def __init__(self):
        self.avg = -1.0
        self.std = -1.0
        self.ap_prior = 0.0
        self.low = 0
        self.high = 0
        self.high_bayesian = 0


def infer_isize_core(isizes, max_len, ap_prior, L):
    """infer_isize (bwape.c:74-178) over the collected candidate lengths.
    Returns (IsizeInfo, 0 or -1)."""
    ii = IsizeInfo()
    tot = len(isizes)
    if tot < 20:
        return ii, -1
    isizes = np.sort(np.asarray(isizes, dtype=np.uint64))
    p25 = int(isizes[int(tot * 0.25 + 0.5)])
    p50 = int(isizes[int(tot * 0.50 + 0.5)])   # noqa: F841 (printed by C)
    p75 = int(isizes[int(tot * 0.75 + 0.5)])
    tmp = int(p25 - OUTLIER_BOUND * (p75 - p25) + .499)
    ii.low = tmp if tmp > max_len else max_len
    ii.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + .499)
    sel = isizes[(isizes >= ii.low) & (isizes <= ii.high)]
    n = len(sel)
    x = int(sel.sum())
    ii.avg = x / n
    # sequential double accumulation in sorted order from the C's
    # ii->std = -1.0 start (bwape.c:84,125): the rounding order is part of
    # the output
    std_acc = -1.0
    skewness = 0.0
    kurtosis = 0.0
    for v in sel.tolist():
        tmp = (v - ii.avg) * (v - ii.avg)
        std_acc += tmp
        skewness += tmp * (v - ii.avg)
        kurtosis += tmp * tmp
    # C float semantics: sqrt of a negative is NaN (a zero-variance library
    # leaves std_acc at -1.0) and flows to the isnan reset below
    var = std_acc / n
    with np.errstate(divide="ignore", invalid="ignore"):
        kurtosis = float(np.float64(kurtosis) / n / np.float64(var * var)
                         - 3)
        ii.std = float(np.sqrt(np.float64(var)))
        skewness = float(np.float64(skewness) / n
                         / np.float64(ii.std ** 3))
    y = 1.0
    while y < 10.0:
        if .5 * math.erfc(y / math.sqrt(2)) < ap_prior / L * (y * ii.std
                                                              + ii.avg):
            break
        y += 0.01
    hb = y * ii.std + ii.avg + .499
    # (bwtint_t)(NaN) on x86-64: cvttsd2si -> INT64_MIN, truncated to 0
    ii.high_bayesian = 0 if math.isnan(hb) else int(hb)
    n_ap = int((isizes > ii.high_bayesian).sum())
    ii.ap_prior = .01 * (n_ap + .01) / tot
    if ii.ap_prior < ap_prior:
        ii.ap_prior = ap_prior
    if math.isnan(ii.std) or p75 > 100000:
        ii.low = ii.high = ii.high_bayesian = 0
        ii.avg = ii.std = -1.0
        return ii, -1
    return ii, 0


def sw_core_gen(l_pac, pac, seq_codes, beg, reglen):
    """bwa_sw_core (bwape.c:433-517) as a generator: yields the one
    local-SW job (ref_seq, seq_codes) and expects (score, path) sent back,
    so callers batch the DP across pairs.  Returns (cigar, new_beg, cnt)
    or (None, beg, 0)."""
    length = len(seq_codes)
    if reglen < SW_MIN_MATCH_LEN or l_pac - beg < length:
        return None, beg, 0
    x = int((np.asarray(seq_codes) >= 4).sum())
    if x / length >= 0.25 or length - x < SW_MIN_MATCH_LEN:
        return None, beg, 0
    hi = min(beg + reglen, l_pac)
    ref_seq = pac[beg:hi]
    score, path = yield (ref_seq, seq_codes)
    if score < 0 or path is None:
        return None, beg, 0
    cigar = path2cigar32(path)
    if not cigar:
        return None, beg, 0
    x = y = 0
    for op, ln in cigar:
        if op == FROM_M:
            x += ln
            y += ln
        elif op == FROM_D:
            x += ln
        else:
            y += ln
    if x < SW_MIN_MATCH_LEN or y < SW_MIN_MATCH_LEN:
        return None, beg, 0
    # update cigar and coordinate (bwape.c:476-493)
    first = path[-1]   # start cell
    beg += (first[1] if first[1] else 1) - 1
    start = (first[2] if first[2] else 1) - 1
    end = path[0][2]
    if start:
        cigar = [(FROM_S, start)] + cigar
    if end < length:
        cigar = cigar + [(FROM_S, length - end)]
    # recompute counts (bwape.c:495-513)
    n_mm = n_gapo = n_gape = 0
    xx = (first[1] - 1) if first[1] else 0
    yy = (first[2] - 1) if first[2] else 0
    for op, ln in cigar:
        if op == FROM_M:
            for k in range(ln):
                if ref_seq[xx + k] < 4 and seq_codes[yy + k] < 4 \
                        and ref_seq[xx + k] != seq_codes[yy + k]:
                    n_mm += 1
            xx += ln
            yy += ln
        elif op == FROM_D:
            xx += ln
            n_gapo += 1
            n_gape += ln - 1
        elif op == FROM_I:
            yy += ln
            n_gapo += 1
            n_gape += ln - 1
    cnt = (n_mm << 16) | (n_gapo << 8) | n_gape
    return cigar, beg, cnt


def paired_sw1_gen(bns, pac, p, popt, ii, counters):
    """bwa_paired_sw1 (bwape.c:519-633), standard pairs; local-SW DPs via
    yield."""
    if not ((p[0].mapQ >= SW_MIN_MAPQ or p[1].mapQ >= SW_MIN_MAPQ)
            and (p[0].extra_flag & SAM_FPP) == 0):
        return
    is_singleton = 1 if (p[0].type == BWA_TYPE_NO_MATCH
                         or p[1].type == BWA_TYPE_NO_MATCH) else 0
    counters["n_tot"][is_singleton] += 1
    mq_adjust = [255, 255]
    cigar = [None, None]
    beg = [0, 0]
    end = [0, 0]
    cnt = [0, 0]
    for k in (0, 1):
        ref = p[1 - k]
        mate = p[k]
        if ref.type == BWA_TYPE_NO_MATCH:
            return
        rd = mate.read
        if ref.strand == 0:
            # __set_rght_coor (bwape.c:531-536): a is truncated to int64
            # first; b is computed from the truncated a
            a = int(ref.pos + ii.avg - 3 * ii.std - mate.len * 1.5)
            b = int(a + 6 * ii.std + 2 * mate.len)
            if a < ref.pos + ref.len:
                a = ref.pos + ref.len
            if b > bns.l_pac:
                b = bns.l_pac
            seq = rd.rseq
        else:
            # __set_left_coor (bwape.c:538-543)
            a = int(ref.pos + ref.len - ii.avg - 3 * ii.std
                    - mate.len * 0.5)
            b = int(a + 6 * ii.std + 2 * mate.len)
            if a < 0:
                a = 0
            if b > ref.pos:
                b = ref.pos
            seq = rd.seq[::-1]  # forward orientation
        beg[k], end[k] = a, b
        cigar[k], beg[k], cnt[k] = yield from sw_core_gen(
            bns.l_pac, pac, seq, beg[k], end[k] - beg[k])
        if cigar[k] and p[k].type != BWA_TYPE_NO_MATCH:
            # re-evaluate (bwape.c:588-600)
            clip = 0
            if cigar[k][0][0] == FROM_S:
                clip += cigar[k][0][1]
            if cigar[k][-1][0] == FROM_S:
                clip += cigar[k][-1][1]
            s_old = int((p[k].n_mm * 9 + p[k].n_gapo * 13
                         + p[k].n_gape * 2) / 3. * 8. + .499)
            s_new = int((((cnt[k] >> 16) * 9 + ((cnt[k] >> 8) & 0xFF) * 13
                          + (cnt[k] & 0xFF) * 2 + clip * 3) / 3. * 8.)
                        + .499)
            # the C adds the raw double to the int accumulator
            s_old = _cint(s_old + (-4.343 * _clog(ii.ap_prior / bns.l_pac)))
            s_new += int(-4.343 * math.log(.5 * math.erfc(1.5 / math.sqrt(2))
                                           + .499))
            if s_old < s_new:
                mq_adjust[k] = s_new - s_old
                cigar[k] = None
            else:
                mq_adjust[k] = s_old - s_new

    k = -1
    mapq = 0
    if cigar[0] and cigar[1]:
        k = 0 if p[0].mapQ < p[1].mapQ else 1
        mapq = abs(p[1].mapQ - p[0].mapQ)
    elif cigar[0]:
        k = 0
        mapq = p[1].mapQ
    elif cigar[1]:
        k = 1
        mapq = p[0].mapQ
    if k >= 0 and p[k].pos != beg[k]:
        counters["n_mapped"][is_singleton] += 1
        tmp = int(p[1 - k].mapQ) - p[k].mapQ // 2 - 8
        if tmp <= 0:
            tmp = 1
        if mapq > tmp:
            mapq = tmp
        p[k].mapQ = p[1 - k].mapQ = mapq
        p[k].seQ = p[1 - k].seQ = min(p[1 - k].seQ, mapq)
        if p[k].mapQ > mq_adjust[k]:
            p[k].mapQ = mq_adjust[k]
        if p[k].seQ > mq_adjust[k]:
            p[k].seQ = mq_adjust[k]
        p[k].cigar = cigar[k]
        # __set_fixed (bwape.c:545-553)
        p[k].type = BWA_TYPE_MATESW
        p[k].pos = beg[k]
        p[k].seQ = p[1 - k].seQ
        p[k].strand = 1 - p[1 - k].strand
        p[k].n_mm = cnt[k] >> 16
        p[k].n_gapo = (cnt[k] >> 8) & 0xFF
        p[k].n_gape = cnt[k] & 0xFF
        p[k].extra_flag |= SAM_FPP
        p[1 - k].extra_flag |= SAM_FPP


def rescue_rounds(bns, pac, pairs, popt, iis, counters):
    """The generators of bwa_paired_sw (bwape.c:635-658), one per pair,
    started: a list of (generator, first job).  iis: one IsizeInfo per
    pair, or one for all of them."""
    if not isinstance(iis, (list, tuple)):
        iis = [iis] * len(pairs)
    live = []
    for p, ii in zip(pairs, iis):
        g = paired_sw1_gen(bns, pac, p, popt, ii, counters)
        try:
            live.append((g, next(g)))
        except StopIteration:
            pass
    return live


def paired_sw_batch(bns, pac, pairs, popt, iis, counters, solve):
    """The bwa_paired_sw rescue loop with the local-SW DPs batched: drives
    the generators in lockstep rounds and solves each round's jobs with
    `solve(jobs) -> [(score, path, subo), ...]`.  Results equal the
    sequential loop: each job is a pure function of the pre-rescue
    state.  iis: one IsizeInfo per pair (bam2bam's per-read-group
    estimates), or one for all of them (sampe's chunk estimate)."""
    live = rescue_rounds(bns, pac, pairs, popt, iis, counters)
    while live:
        solved = solve([j for _, j in live])
        nxt = []
        for (g, _), (score, path, _s) in zip(live, solved):
            try:
                nxt.append((g, g.send((score, path))))
            except StopIteration:
                pass
        live = nxt


# --- the sampe steps ---

# the SeqState attribute behind each state column `PairChunk.of_rows` fills
_STATE_FIELDS = ((F_TYPE, "type"), (F_STRAND, "strand"), (F_POS, "pos"),
                 (F_MAPQ, "mapQ"), (F_SEQ_Q, "seQ"), (F_C1, "c1"),
                 (F_C2, "c2"), (F_NMM, "n_mm"), (F_NGO, "n_gapo"),
                 (F_NGE, "n_gape"), (F_XFLAG, "extra_flag"), (F_SA, "sa"),
                 (F_SCORE, "score"), (F_LEN, "len"))


def _per_pair(iis, n, attr, dtype):
    """One IsizeInfo field per pair, from a list of them or from one."""
    if isinstance(iis, (list, tuple)):
        return np.array([getattr(ii, attr) for ii in iis], dtype=dtype)
    return np.full(n, getattr(iis, attr), dtype=dtype)

class PairChunk:
    """One chunk's columnar sampe state: the interleaved [2n, NF] table,
    the record words and offsets of both ends' hits, multi-hit slots, and
    the cigars of refined or rescued rows and of multi slots.  bam2bam's
    pass 2 builds one with `of_rows`, its singletons as rows after the
    pairs'; the steps below take either."""

    def __init__(self, reads, per_read_alns):
        n = len(reads[0])
        if len(reads[1]) != n or len(per_read_alns[0]) != n \
                or len(per_read_alns[1]) != n:
            raise ValueError("the two ends differ in read count")
        self.n = n
        n2 = 2 * n
        self.colsrc = None
        if isinstance(reads[0], ReadBatch) and isinstance(reads[1],
                                                          ReadBatch):
            self.colsrc = reads
        else:
            self._flat = [reads[j][i] for i in range(n) for j in (0, 1)]
        self.reads = reads
        state = np.zeros((n2, NF), dtype=np.int64)
        lens = np.empty(n2, dtype=np.int64)
        if self.colsrc is not None:
            lens[0::2] = reads[0].clip_lens()
            lens[1::2] = reads[1].clip_lens()
            state[0::2, F_FULL_LEN] = reads[0].full_lens()
            state[1::2, F_FULL_LEN] = reads[1].full_lens()
            state[:, F_CLIP_LEN] = lens
        else:
            lens[:] = [r.len for r in self._flat]
            state[:, F_FULL_LEN] = [r.full_len for r in self._flat]
            state[:, F_CLIP_LEN] = [r.clip_len for r in self._flat]
        state[:, F_LEN] = lens
        state[:, F_XFLAG] = SAM_FPD | SAM_FR2
        state[0::2, F_XFLAG] = SAM_FPD | SAM_FR1
        self.state, self.lens = state, lens
        if isinstance(per_read_alns[0], AlnColumn) and isinstance(
                per_read_alns[1], AlnColumn):
            # the raw .sai words are the kernels' record layout: interleave
            # the two ends' byte columns with one native gather
            r0, c0 = per_read_alns[0].columns()
            r1, c1 = per_read_alns[1].columns()
            counts = np.empty(n2, dtype=np.int32)
            counts[0::2] = c0
            counts[1::2] = c1
            o0 = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(c0.astype(np.int64) * 16, out=o0[1:])
            o1 = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(c1.astype(np.int64) * 16, out=o1[1:])
            rb, _ = interleave_flats(r0.view(np.uint8), o0,
                                     r1.view(np.uint8), o1)
            recs = np.ascontiguousarray(rb).view(np.uint32) if len(rb) \
                else np.zeros(0, dtype=np.uint32)
        else:
            recs, counts = pack_recs([per_read_alns[j][i] for i in range(n)
                                      for j in (0, 1)])
        self._hits(recs, counts)

    @classmethod
    def of_rows(cls, states, alns, n_pairs):
        """A chunk over rows whose hits are already chosen and positioned
        (bam2bam's pass 2): `states` the rows' SeqStates, the two ends of
        n_pairs pairs interleaved first and singletons after; `alns` each
        row's hits."""
        pc = cls.__new__(cls)
        pc.n, pc.colsrc, pc.reads = n_pairs, None, None
        pc._flat = [s.read for s in states]
        state = np.zeros((len(states), NF), dtype=np.int64)
        for fi, attr in _STATE_FIELDS:
            state[:, fi] = [getattr(s, attr) for s in states]
        state[:, F_FULL_LEN] = [r.full_len for r in pc._flat]
        state[:, F_CLIP_LEN] = [r.clip_len for r in pc._flat]
        pc.state, pc.lens = state, state[:, F_LEN].copy()
        pc._hits(*pack_recs(alns))
        return pc

    def _hits(self, recs, counts):
        """The hit records and offsets, empty multi slots and cigars."""
        rows = len(self.state)
        self.recs, self.counts = recs, counts
        self.hit_off = np.zeros(rows + 1, dtype=np.int64)
        np.cumsum(counts, out=self.hit_off[1:])
        self.stride = 1
        self.multi_pos = np.zeros(rows, dtype=np.uint64)
        self.multi_gap = np.zeros(rows, dtype=np.int32)
        self.multi_mm = np.zeros(rows, dtype=np.int32)
        self.multi_strand = np.zeros(rows, dtype=np.int32)
        self.multi_n = np.zeros(rows, dtype=np.int32)
        self.mslot = np.zeros(0, dtype=np.int64)
        self.cigars = {}
        self.mcigars = {}
        self._fwd = {}

    def read(self, row):
        """The Read of interleaved row `row`."""
        if self.colsrc is not None:
            return self.colsrc[row & 1][row >> 1]
        return self._flat[row]

    @property
    def matched(self):
        return self.state[:, F_TYPE] != BWA_TYPE_NO_MATCH

    @property
    def strand(self):
        return self.state[:, F_STRAND] != 0

    def fwd_codes(self, row):
        """Row's read codes in forward orientation (cached)."""
        c = self._fwd.get(row)
        if c is None:
            c = self.read(row).seq[::-1]
            self._fwd[row] = c
        return c


def sa_rows_fn(engine, host_reference):
    """The SA walk of a route: `engine.sa_rows` (C3 on a CUDA engine), or
    the host reference's `samse.sa_rows_native`."""
    if host_reference:
        return lambda a, rows: se.sa_rows_native(engine.index, a, rows)
    return engine.sa_rows


def select(reads, per_read_alns, rng):
    """Step 1 (bwape.c:316-338): the chosen hit of every end, the exact
    drand48 stream (end inner, pair outer); advances rng."""
    pc = PairChunk(reads, per_read_alns)
    n2 = 2 * pc.n
    rngst = np.array([rng.x], dtype=np.uint64)
    dummy_u64 = np.zeros(n2, dtype=np.uint64)
    dummy_i32 = np.zeros(n2, dtype=np.int32)
    native.lib().se_select_batch(n2, pc.recs, pc.counts,
                                 pc.state.reshape(-1), rngst, 1, 0,
                                 dummy_u64, dummy_i32, dummy_i32, dummy_i32,
                                 np.zeros(n2, dtype=np.int32))
    rng.x = int(rngst[0])
    return pc


def sa_coords(engine, pc, host_reference=False):
    """Step 2 (bwape.c:330-338): the chosen hits' SA rows -> positions,
    reverse-strand positions flipped by `rev.seq_len - (v + len)`."""
    sa_rows = sa_rows_fn(engine, host_reference)
    state, lens = pc.state, pc.lens
    rev_len = engine.index.rev.seq_len
    matched, strand = pc.matched, pc.strand
    for a in (1, 0):
        sel = matched & (strand if a else ~strand)
        if not sel.any():
            continue
        vals = sa_rows(a, state[sel, F_SA].astype(np.uint32)) \
            .astype(np.int64)
        if a:
            state[sel, F_POS] = vals
        else:
            state[sel, F_POS] = (rev_len - (vals + lens[sel])) & _NEG1


def infer_isize(pc, popt, seq_len, last_ii=None):
    """Step 3 (bwape.c:341-346): the chunk's insert-size estimate, the last
    chunk's where this one has none, reset by `-A`."""
    p0, p1 = pc.state[0::2], pc.state[1::2]
    good = (p0[:, F_MAPQ] >= 20) & (p1[:, F_MAPQ] >= 20)
    x_lo = p1[:, F_POS] + p1[:, F_LEN] - p0[:, F_POS]
    x_hi = p0[:, F_POS] + p0[:, F_LEN] - p1[:, F_POS]
    x = np.where(p0[:, F_POS] < p1[:, F_POS], x_lo, x_hi)
    isizes = x[good & (x < 100000)]
    max_len = int(pc.lens.max(initial=1))
    ii, _ = infer_isize_core(isizes, max_len, popt.ap_prior, seq_len)
    if ii.avg < 0.0 and last_ii is not None and last_ii.avg > 0.0:
        ii = last_ii
    if popt.force_isize:
        ii.low = ii.high = 0
        ii.avg = ii.std = -1.0
    return ii


def pairing(engine, pc, gopt, popt, iis, pos_memo, host_reference=False):
    """Step 4 (bwape.c:349-398): every hit interval of the gated pairs
    expanded to positions (wide intervals through `pos_memo`), then the
    native per-pair pairing sweep over the sorted keys.  iis: one
    IsizeInfo for all pairs, or one per pair."""
    n = pc.n
    if n == 0:
        return
    flat_keys, key_off = build_pair_keys(
        sa_rows_fn(engine, host_reference), engine.index.rev.seq_len,
        pc.state, pc.recs, pc.counts, pc.hit_off, n, popt.max_occ,
        pos_memo)
    native.lib().pe_pairing_batch(
        n, flat_keys, key_off, pc.recs, 4 * pc.hit_off,
        pc.state.reshape(-1), 0, popt.max_isize, gopt.s_mm,
        _per_pair(iis, n, "high", np.int64),
        _per_pair(iis, n, "high_bayesian", np.int64),
        _per_pair(iis, n, "avg", np.float64),
        _per_pair(iis, n, "std", np.float64))


def multi_hits(engine, pc, popt, host_reference=False):
    """Step 5 (bwape.c:400-413): multi-hit enumeration (native
    se_multi_batch) for the paired rows, then the slots' SA rows ->
    positions.  Rows after the pairs' (bam2bam's singletons) get none."""
    if not (popt.N_multi or popt.n_multi) or pc.n == 0:
        return
    state, n2, rows = pc.state, 2 * pc.n, len(pc.state)
    typ = state[:n2, F_TYPE]
    mate_typ = typ.reshape(pc.n, 2)[:, ::-1].reshape(-1)
    fpp = (state[:n2, F_XFLAG] & SAM_FPP) != 0
    cond = (~fpp) & (mate_typ != BWA_TYPE_NO_MATCH)
    nm2 = np.where(cond,
                   np.where(state[:n2, F_C1] + state[:n2, F_C2] - 1
                            > popt.N_multi, popt.n_multi, popt.N_multi),
                   popt.n_multi)
    nm = np.zeros(rows, dtype=np.int32)
    nm[:n2] = np.where(typ != BWA_TYPE_NO_MATCH, nm2, 0)
    stride = int(max(popt.n_multi, popt.N_multi)) + 1
    pc.stride = stride
    pc.multi_pos = np.zeros(rows * stride, dtype=np.uint64)
    pc.multi_gap = np.zeros(rows * stride, dtype=np.int32)
    pc.multi_mm = np.zeros(rows * stride, dtype=np.int32)
    pc.multi_strand = np.zeros(rows * stride, dtype=np.int32)
    native.lib().se_multi_batch(rows, pc.recs, pc.counts, state.reshape(-1),
                                nm, stride, pc.multi_pos, pc.multi_gap,
                                pc.multi_mm, pc.multi_strand, pc.multi_n)
    mslot, mlen = [], []
    for i in np.nonzero(pc.multi_n)[0].tolist():
        for m in range(pc.multi_n[i]):
            mslot.append(i * stride + m)
            mlen.append(pc.lens[i])
    pc.mslot = np.array(mslot, dtype=np.int64)
    if not len(mslot):
        return
    mlen = np.array(mlen, dtype=np.int64)
    sa_rows = sa_rows_fn(engine, host_reference)
    rev_len = engine.index.rev.seq_len
    m_strand = pc.multi_strand[pc.mslot] != 0
    for a in (1, 0):
        msel = m_strand if a else ~m_strand
        if not msel.any():
            continue
        slots = pc.mslot[msel]
        vals = sa_rows(a, pc.multi_pos[slots].astype(np.uint32)) \
            .astype(np.int64)
        if a:
            pc.multi_pos[slots] = vals.astype(np.uint64)
        else:
            pc.multi_pos[slots] = \
                ((rev_len - (vals + mlen[msel])) & _NEG1).astype(np.uint64)


def rescue_pairs(pc):
    """The candidate pairs of step 6 as per-row SeqState proxies
    (post_native.py:629-653): [(pair, (proxy0, proxy1))]."""
    n2 = 2 * pc.n
    p0, p1 = pc.state[0:n2:2], pc.state[1:n2:2]
    mq_pair = np.maximum(p0[:, F_MAPQ], p1[:, F_MAPQ])
    cand = np.nonzero((mq_pair >= SW_MIN_MAPQ)
                      & ((p0[:, F_XFLAG] & SAM_FPP) == 0))[0]
    out = []
    for i in cand.tolist():
        pp = []
        for row in (2 * i, 2 * i + 1):
            s = se.SeqState(pc.read(row))
            st = pc.state[row]
            s.type = int(st[F_TYPE])
            s.strand = int(st[F_STRAND])
            s.pos = int(st[F_POS])
            s.mapQ = int(st[F_MAPQ])
            s.seQ = int(st[F_SEQ_Q])
            s.n_mm = int(st[F_NMM])
            s.n_gapo = int(st[F_NGO])
            s.n_gape = int(st[F_NGE])
            s.extra_flag = int(st[F_XFLAG])
            s.len = int(st[F_LEN])
            pp.append(s)
        out.append((i, pp))
    return out


def rescue(pc, bns, pac, popt, iis, device, host_reference=False,
           parts=None):
    """Step 6 (bwa_paired_sw, bwape.c:635-658) on the candidate pairs'
    proxies, written back into the table (post_native.py:654-670).  iis:
    one IsizeInfo for all pairs, or one per pair; the DP's seconds go to
    `parts` (default: `seconds`).  Returns the counters {"n_tot",
    "n_mapped"}."""
    counters = {"n_tot": [0, 0], "n_mapped": [0, 0]}
    prox = rescue_pairs(pc)
    if not prox:
        return counters
    parts = seconds if parts is None else parts
    if host_reference:
        def solve(jobs):
            return dp.local_sw_native(jobs, ALN_PARAM_BWA, thres=1,
                                      seconds=parts)
    else:
        def solve(jobs):
            return dp.local_sw_batch(jobs, ALN_PARAM_BWA, device, thres=1,
                                     seconds=parts)
    if isinstance(iis, (list, tuple)):
        iis = [iis[i] for i, _ in prox]
    paired_sw_batch(bns, pac, [pp for _, pp in prox], popt, iis, counters,
                    solve)
    for i, pp in prox:
        for j, s in enumerate(pp):
            row = 2 * i + j
            st = pc.state[row]
            st[F_TYPE] = s.type
            st[F_STRAND] = s.strand
            st[F_POS] = s.pos
            st[F_MAPQ] = s.mapQ
            st[F_SEQ_Q] = s.seQ
            st[F_NMM] = s.n_mm
            st[F_NGO] = s.n_gapo
            st[F_NGE] = s.n_gape
            st[F_XFLAG] = s.extra_flag
            if s.cigar:
                pc.cigars[row] = s.cigar
    return counters


def gapped_jobs(pc):
    """Step 7's jobs (bwape.c:725-726), gapped multi slots first, then the
    gapped rows that rescue did not place: [(apply, seq_codes, pos,
    ext)]."""
    state = pc.state
    strand = pc.strand        # pairing and rescue may have moved strands
    jobs = []
    for o in pc.mslot.tolist():
        if pc.multi_gap[o] == 0:
            continue
        i = o // pc.stride
        seqc = pc.read(i).rseq if pc.multi_strand[o] else pc.fwd_codes(i)

        def apply_m(cig, newpos, o=o):
            pc.mcigars[o] = cig
            pc.multi_pos[o] = newpos

        jobs.append((apply_m, seqc, int(pc.multi_pos[o]),
                     (1 if pc.multi_strand[o] else -1)
                     * int(pc.multi_gap[o])))
    typ = state[:, F_TYPE]
    gap_rows = np.nonzero((typ != BWA_TYPE_NO_MATCH)
                          & (typ != BWA_TYPE_MATESW)
                          & (state[:, F_NGO] > 0))[0]
    for i in gap_rows.tolist():
        seqc = pc.read(i).rseq if strand[i] else pc.fwd_codes(i)

        def apply_s(cig, newpos, i=i):
            pc.cigars[i] = cig if cig else None
            state[i, F_POS] = newpos

        jobs.append((apply_s, seqc, int(state[i, F_POS]),
                     (1 if strand[i] else -1)
                     * int(state[i, F_NGO] + state[i, F_NGE])))
    return jobs


def md(pc, bns, pac):
    """Step 8a: MD/NM with ambiguity holes (native md_batch); the MD text
    buffer and its offsets."""
    n2, strand = len(pc.state), pc.strand
    if pc.colsrc is not None:
        f0, o0 = pc.colsrc[0].aligned_codes(strand[0::2])
        f1, o1 = pc.colsrc[1].aligned_codes(strand[1::2])
        seq_flat, seq_off = interleave_flats(f0, o0, f1, o1)
    else:
        seq_flat, seq_off = flat([
            (pc.read(i).rseq if strand[i] else pc.fwd_codes(i))
            for i in range(n2)])
    cig, cig_off = se.cigar_flat(pc.cigars, n2)
    _, _, _, _, amb_off, amb_len, amb_chr = bns_emit_arrays(bns)
    md_cap = int(seq_off[-1]) * 2 + 24 * n2 + 16
    md_buf = np.empty(md_cap, dtype=np.uint8)
    md_off = np.zeros(n2 + 1, dtype=np.int64)
    rc = native.lib().md_batch(n2, pc.state.reshape(-1), seq_flat, seq_off,
                               cig, cig_off, pac, bns.l_pac, len(bns.ambs),
                               amb_off, amb_len, amb_chr, md_buf, md_cap,
                               md_off, post_threads())
    if rc != 0:
        raise RuntimeError(f"native md_batch failed ({rc})")
    return md_buf, md_off


def correct_trim(pc):
    """Step 8b: bwa_correct_trimmed (bwase.c:320-354) on the rows whose
    clipped length is below the full length."""
    state = pc.state
    for i in np.nonzero(pc.lens < state[:, F_FULL_LEN])[0].tolist():
        s = se.SeqState(pc.read(i))
        s.strand = int(state[i, F_STRAND])
        s.cigar = list(pc.cigars[i]) if pc.cigars.get(i) else None
        s.len = int(state[i, F_LEN])
        se.correct_trimmed(s)
        pc.cigars[i] = s.cigar
        state[i, F_LEN] = s.len


def emit(pc, bns, gopt, rg_id, md_buf, md_off):
    """Step 8c: the chunk's SAM text, the two ends of a pair on
    neighbouring lines (native sam_emit_batch, mate_idx = row ^ 1)."""
    n, n2 = pc.n, 2 * pc.n
    if pc.colsrc is not None:
        # columnar batches carry no barcodes
        c0, c1 = pc.colsrc
        names = interleave_flats(*c0.name_bytes(), *c1.name_bytes())
        bcs = (np.zeros(0, dtype=np.uint8), np.zeros(n2 + 1, dtype=np.int64))
        codes = interleave_flats(*c0.code_bytes(), *c1.code_bytes())
        quals = interleave_flats(*c0.qual_bytes(), *c1.qual_bytes())
    else:
        reads = [pc.read(i) for i in range(n2)]
        # the bc concat quirk (bwape.c:731-740)
        bc = [r.bc.encode() if r.bc else b"" for r in reads]
        for i in range(n):
            if bc[2 * i] or bc[2 * i + 1]:
                bc[2 * i] = bc[2 * i + 1] = bc[2 * i] + bc[2 * i + 1]
        names = flat([r.name.encode() for r in reads])
        bcs = flat(bc)
        codes = flat([r.full_codes for r in reads])
        quals = flat([(r.qual.tobytes() if r.qual is not None else b"")
                      for r in reads])
    multi = (pc.multi_pos, pc.multi_gap, pc.multi_mm, pc.multi_strand,
             pc.multi_n)
    return se.emit_rows(pc.state, np.arange(n2, dtype=np.int64) ^ 1, names,
                        bcs, codes, quals, pc.cigars, pc.mcigars, multi,
                        pc.stride, md_buf, md_off, bns, gopt, rg_id)


def sampe_bytes(engine, reads, per_read_alns, gopt, popt, rng, rg_id=None,
                last_ii=None, pos_memo=None, ntpac=None,
                host_reference=False):
    """sampe for one chunk on the port's engine.  reads: (reads0, reads1);
    per_read_alns: (alns0, alns1); rng: the shared drand48 stream;
    last_ii: the previous chunk's IsizeInfo; pos_memo: the wide-interval
    memo carried across chunks.  Returns (SAM bytes, IsizeInfo)."""
    if ntpac is not None or popt.type != BWA_PET_STD:
        raise NotImplementedError(
            "colour-space sampe (BWA_PET_SOLID) is not yet ported to "
            "nabwa_tpu_torch")
    if pos_memo is None:
        pos_memo = {}
    index = engine.index
    bns, pac = index.bns, index.pac
    t0 = time.perf_counter()
    pc = select(reads, per_read_alns, rng)
    t1 = time.perf_counter()
    sa_coords(engine, pc, host_reference)
    t2 = time.perf_counter()
    se.approx_mapq(pc, gopt)
    t3 = time.perf_counter()
    ii = infer_isize(pc, popt, index.fwd.seq_len, last_ii)
    t4 = time.perf_counter()
    seconds["select"] += (t1 - t0) + (t3 - t2)
    seconds["sa"] += t2 - t1
    seconds["isize"] += t4 - t3
    if pc.n == 0:
        return b"", ii
    pairing(engine, pc, gopt, popt, ii, pos_memo, host_reference)
    t5 = time.perf_counter()
    multi_hits(engine, pc, popt, host_reference)
    t6 = time.perf_counter()
    solved = sum(seconds[k] for k in RESCUE_SOLVE)
    if popt.is_sw and ii.avg >= 0.0:
        rescue(pc, bns, pac, popt, ii, engine.device, host_reference)
    t7 = time.perf_counter()
    seconds["rescue_drive"] += (t7 - t6) - (
        sum(seconds[k] for k in RESCUE_SOLVE) - solved)
    jobs = gapped_jobs(pc)
    seconds["dp"] += time.perf_counter() - t7
    se.refine_jobs(jobs, pac, bns.l_pac, engine.device, host_reference,
                   parts=seconds)
    t8 = time.perf_counter()
    md_buf, md_off = md(pc, bns, pac)
    t9 = time.perf_counter()
    correct_trim(pc)
    blob = emit(pc, bns, gopt, rg_id, md_buf, md_off)
    t10 = time.perf_counter()
    seconds["pairing"] += t5 - t4
    seconds["multi"] += t6 - t5
    seconds["md"] += t9 - t8
    seconds["emit"] += t10 - t9
    return blob, ii
