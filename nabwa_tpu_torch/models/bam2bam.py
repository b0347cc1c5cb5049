"""The bam2bam workflow on the port's engine: the counterpart of
nabwa_tpu/models/bam2bam.py `bam2bam` (bwa_bam2bam_core,
bam2bam.c:1728-1940), unaligned BAM in, aligned BAM out.

Two passes over chunks of logical records (a pair or a singleton), each
chunk a job for the local worker threads of `parallel.scheduler` or, with
`port`, for remote `worker` processes (`parallel.net`), results released
to an ordered writer:
  pass 1   `pass1_work`: the chunk's reads through `engine.run_chunk` with
           per-read semantics (each read's own max_diff and clamped
           max_gapo; kernels C2 and C1 on a CUDA engine)
  writer   `apply_align`, in record order: the drand48 hit sampling
           (`aln2seq_core`), the SA rows -> positions (`cal_pac_pos`,
           `engine.sa_rows_both`: one C3 launch a chunk for both
           strands) and the per-read-group insert-size
           histograms
  barrier  one IsizeInfo per read group (`infer_isize_hist`; a group with
           too few pairs gets none, and its pairs `NullIsize`)
  pass 2   `pass2_work`, columnar, through sampe's steps (`models.sampe`,
           on a `PairChunk.of_rows` table): the native pairing sweep over
           every hit interval expanded to positions (C3), multi hits (C3),
           mate rescue with each pair's own read group's estimate
           (forward lattice C5, path C4), gapped refinement (C4), native
           MD/NM and the quality-trim fix-ups; then the native BAM splice
           into fresh records (`bam_update_batch`)
  writer   `apply_finish`: BGZF level 2 out, in record order.

Copied from nabwa_tpu/models/bam2bam.py with their semantics: `Pair`,
`bam1_to_reads_batch`, `try_get_sai`, `read_bam_pairs`,
`erase_unwanted_tags`, `unique`, `infer_isize_hist`, `NullIsize`,
`improve_isize_est`, `find_pp_tag`, `print_header_text`, `pass1_work` and
`_pass2_work_columnar` (here `pass2_work`, its steps shared with sampe).
Not ported: the per-object pass 2 `_pass2_work_obj` (the JAX package's
oracle for the columnar one, and its fallback when the native library is
missing, which the port never allows).

`port` serves the chunk leases to remote `worker` processes on that TCP
port, as nabwa_tpu/models/bam2bam.py:1108-1114 does (the ZeroMQ work
stream's analog, bam2bam.c:1808-1812); `prefix` is the index path the
config handshake ships.  Local threads and remote workers drain one
scheduler; `n_workers=0` with a port leaves all chunk compute to the
workers (`bam2bam -t 0 -p PORT`).  The writers, and with them the drand48
sampling and `cal_pac_pos` (C3) between the passes, stay at the
coordinator on its own engine, in record order, so the output does not
depend on which worker ran which chunk.  The lease is `NABWA_LEASE_S`
seconds (default 90, the reference's resend sweep, bam2bam.c:8).

`host_reference=True` runs the DFS on the shared host engine, the SA walk
with `samse.sa_rows_both_native` and the DPs through the native solvers: the
reference the card's output is held against.  Only that argument chooses
it; nothing falls back to it.

`seconds` holds the StageTimers totals of the last call ("read + pass 1
align", "pass 2 finish", "write output"), `telemetry` its scheduler
counters (pass1_resends, pass1_dups, pass2_resends, pass2_dups);
`pass2_seconds` sums pass 2's
host seconds per step over its chunks and workers (pairing, multi,
rescue_drive, the rescue DP's rescue_fwd/rescue_rev/rescue_path, refine
and its dp/dp_backtrace, md, splice).
"""

import math
import os
import struct
import sys
import threading
import time

import numpy as np

from ..constants import SAM_FDP, SAM_FQC, SAM_FSR, SAM_FSU
from ..index import native
from ..io import bam as bamio
from ..io import sai as saiio
from ..io.bam import BAM_FPAIRED, BAM_FREAD1, BAM_FREAD2, BAM_FUNMAP, BamRec
from ..io.fastq import Read, trim_read
from ..parallel.scheduler import run_distributed
from ..utils.log import Counters, RateEMA, StageTimers
from ..utils.rand48 import Rand48
from . import sampe as pe
from . import samse as se
from .post_native import bns_emit_arrays, flat

MAX_ISIZE = 100000  # insert_size.c:47

EOF_KIND, SINGLETON, PROPER_PAIR = 0, 1, 2
PRISTINE, ALIGNED, POSITIONED, FINISHED = 0, 1, 2, 3

seconds = {}
telemetry = {}
PASS2_PARTS = ("pairing", "multi", "rescue_drive", "rescue_fwd",
               "rescue_rev", "rescue_path", "refine", "dp", "dp_backtrace",
               "md", "splice")
pass2_seconds = dict.fromkeys(PASS2_PARTS, 0.0)
_pass2_lock = threading.Lock()


class Pair:
    """bam_pair_t (bwtaln.h:124-130)."""

    __slots__ = ("recno", "kind", "phase", "recs", "states", "alns", "hw",
                 "side")

    def __init__(self, kind, recs):
        self.kind = kind
        self.recs = recs
        self.phase = PRISTINE
        self.states = [None, None]
        self.alns = [None, None]
        self.hw = [0, 0]
        self.side = None      # pre-computed .sai alignments (sideload)


def bam1_to_reads_batch(recs, is_comp=True, trim_qual=0):
    """bam1_to_seq (bwaseqio.c:272-307) over a whole chunk -> io.fastq.Read
    objects: one nybble decode + qual clamp over the concatenated record
    bytes, per-read zero-copy views."""
    n = len(recs)
    if n == 0:
        return []
    lq = np.empty(n, dtype=np.int64)
    seq_parts = []
    qual_parts = []
    for i, r in enumerate(recs):
        L = r.l_qseq
        lq[i] = L
        so = r.seq_off()
        nb = (L + 1) // 2
        mv = memoryview(r.data)
        seq_parts.append(mv[so:so + nb])
        qual_parts.append(mv[so + nb:so + nb + L])
    nb_arr = (lq + 1) // 2
    seq_cat = np.frombuffer(b"".join(seq_parts), dtype=np.uint8)
    q_cat = np.minimum(np.frombuffer(b"".join(qual_parts), dtype=np.uint8)
                       .astype(np.int16) + 33, 126).astype(np.uint8)
    dec = np.empty(seq_cat.size * 2, dtype=np.uint8)
    dec[0::2] = seq_cat >> 4
    dec[1::2] = seq_cat & 0xF
    dec = bamio.NT16_NT4[dec]
    dco = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(2 * nb_arr, out=dco[1:])
    qo = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lq, out=qo[1:])
    # restore original orientation for reverse-mapped inputs, in place
    for i, r in enumerate(recs):
        if r.flag & SAM_FSR:
            a, L = int(dco[i]), int(lq[i])
            codes = dec[a:a + L]
            tmp = codes[::-1].copy()
            codes[:] = np.where(tmp < 4, 3 - tmp, tmp)
            quals = q_cat[int(qo[i]):int(qo[i + 1])]
            quals[:] = quals[::-1].copy()
    comp = np.where(dec < 4, 3 - dec, dec).astype(np.uint8) if is_comp \
        else dec
    out = []
    for i, r in enumerate(recs):
        a, L = int(dco[i]), int(lq[i])
        codes = dec[a:a + L]
        quals = q_cat[int(qo[i]):int(qo[i + 1])]
        ln = trim_read(trim_qual, codes, quals, L) if trim_qual >= 1 \
            else L
        out.append(Read(name=r.qname, seq=codes[:ln][::-1],
                        rseq=comp[a:a + ln][::-1], qual=quals,
                        full_len=L, clip_len=ln, full_codes=codes, bc=""))
    return out


def try_get_sai(sai_streams, c):
    """try_get_sai (bwaseqio.c:323-338): pull the next record from sideload
    stream c; returns list-of-aln-tuples or None (stream absent/ended)."""
    f = sai_streams.get(c) if sai_streams else None
    if f is None:
        return None
    hdr = f.read(4)
    if len(hdr) == 4:
        (naln,) = struct.unpack("<i", hdr)
        body = f.read(16 * naln) if naln >= 0 else b""
        if naln >= 0 and len(body) == 16 * naln:
            recs = np.frombuffer(body, dtype=saiio.ALN_DTYPE)
            return saiio.aln_records_to_tuples(recs)
    print(f"[read_bam_pair] note: sai file {c} has ended.", file=sys.stderr)
    f.close()
    sai_streams[c] = None
    return None


def read_bam_pairs(reader, allow_broken=False, drop_aligned=False,
                   sai_streams=None):
    """read_bam_pair loop (bwaseqio.c:345-494).  Yields Pair objects.

    sai_streams: optional {0: f, 1: f, 2: f} of open .sai record streams
    (positioned past the header) — matching records enter the pipeline
    already in phase ALIGNED (bwaseqio.c:466-483)."""
    pending = None
    while True:
        rec = pending if pending is not None else reader.read1()
        pending = None
        if rec is None:
            return
        if not (rec.flag & BAM_FPAIRED):
            p = Pair(SINGLETON, [rec, None])
        else:
            mate = reader.read1()
            if mate is None:
                if allow_broken:
                    return
                raise IOError("got a paired read and hit EOF")
            f1 = rec.flag & (BAM_FPAIRED | BAM_FREAD1 | BAM_FREAD2)
            f2 = mate.flag & (BAM_FPAIRED | BAM_FREAD1 | BAM_FREAD2)
            if rec.qname == mate.qname:
                if f1 == (BAM_FPAIRED | BAM_FREAD1) and \
                        f2 == (BAM_FPAIRED | BAM_FREAD2):
                    p = Pair(PROPER_PAIR, [rec, mate])
                elif f2 == (BAM_FPAIRED | BAM_FREAD1) and \
                        f1 == (BAM_FPAIRED | BAM_FREAD2):
                    p = Pair(PROPER_PAIR, [mate, rec])
                elif allow_broken:
                    rec.flag = (rec.flag & ~BAM_FREAD2) | BAM_FPAIRED \
                        | BAM_FREAD1
                    mate.flag = (mate.flag & ~BAM_FREAD1) | BAM_FPAIRED \
                        | BAM_FREAD2
                    p = Pair(PROPER_PAIR, [rec, mate])
                else:
                    raise IOError("pair flags wrong for %s" % rec.qname)
            else:
                # lone mate: discard first, retry with second
                if not allow_broken:
                    raise IOError("lone mate %s" % rec.qname)
                pending = mate
                continue
        if drop_aligned:
            # skip while either end is already aligned (bwaseqio.c:469-473)
            aligned0 = not (p.recs[0].flag & BAM_FUNMAP)
            aligned1 = p.kind == PROPER_PAIR and \
                not (p.recs[1].flag & BAM_FUNMAP)
            if aligned0 or aligned1:
                continue
        # .sai sideload (bwaseqio.c:475-483)
        if sai_streams:
            if p.kind == SINGLETON:
                a0 = try_get_sai(sai_streams, 0)
                if a0 is not None:
                    p.side = [a0, None]
                    p.phase = ALIGNED
            else:
                a1 = try_get_sai(sai_streams, 1)
                a2 = try_get_sai(sai_streams, 2)
                if a1 is not None and a2 is not None:
                    p.side = [a1, a2]
                    p.phase = ALIGNED
        # QC-fail propagation (bwaseqio.c:486-489)
        if p.kind == PROPER_PAIR:
            p.recs[0].flag |= p.recs[1].flag & SAM_FQC
            p.recs[1].flag |= p.recs[0].flag & SAM_FQC
        for i in range(p.kind):
            erase_unwanted_tags(p.recs[i])
        yield p


def _tag_unwanted(a, b):
    return ((a in b"ASCN" and b == 77)            # ?M
            or (a == 77 and b == 68)              # MD
            or (a == 88 and chr(b) in "01ACGMNOT")  # X?
            or (a == 89 and b == 81))             # YQ


def erase_unwanted_tags(rec: BamRec):
    """erase_unwanted_tags (bwaseqio.c:413-464): drop AM NM CM SM MD X0 X1
    XA XC XG XM XN XO XT YQ.  Scan-first: typical unaligned input (RG/BC
    only) strips nothing, so the common case does no copies at all."""
    d = rec.data
    p = rec.aux_off()
    n = len(d)
    while p < n:
        if _tag_unwanted(d[p], d[p + 1]):
            break
        p = bamio._skip_tag(d, p)
    if p >= n:
        return
    out = bytearray(d[:p])
    while p < n:
        q = bamio._skip_tag(d, p)
        if not _tag_unwanted(d[p], d[p + 1]):
            out += d[p:q]
        p = q
    rec.data = out


def unique(p, skip_duplicates):
    """bam2bam.c:595-606."""
    if not skip_duplicates:
        return True
    if p.kind == SINGLETON:
        return not (p.recs[0].flag & SAM_FDP)
    return not (p.recs[0].flag & SAM_FDP) and \
        not (p.recs[1].flag & SAM_FDP)


def infer_isize_hist(hist, ap_prior, L, rg=None, report=True):
    """infer_isize_hist (insert_size.c:50-139).  hist: int array MAX_ISIZE.
    Returns IsizeInfo or None (unusable).  Prints the reference's
    [infer_isize] report lines (insert_size.c:65-67,129-137) when
    report=True."""
    rg_s = rg if rg else "(null)"
    ii = pe.IsizeInfo()
    tot = int(hist.sum())
    if tot < 20:
        if report:
            print(f"[infer_isize] {rg_s}: too few good pairs",
                  file=sys.stderr)
        return None
    cum = 0
    p25 = p50 = p75 = 0
    for i in range(MAX_ISIZE):
        cum2 = cum + int(hist[i])
        if cum <= tot * 0.25 + 0.5 < cum2:
            p25 = i
        if cum <= tot * 0.50 + 0.5 < cum2:
            p50 = i
        if cum <= tot * 0.75 + 0.5 < cum2:
            p75 = i
        cum = cum2
    tmp = int(p25 - pe.OUTLIER_BOUND * (p75 - p25) + .499)
    ii.low = tmp if tmp > 1 else 1
    ii.high = int(p75 + pe.OUTLIER_BOUND * (p75 - p25) + .499)
    n = 0
    x = 0
    for i in range(MAX_ISIZE):
        if ii.low <= i <= ii.high:
            n += int(hist[i])
            x += int(hist[i]) * i
    ii.avg = x / n
    std_acc = -1.0  # ii->std initialised to -1.0 (insert_size.c:60,100)
    skew = kurt = 0.0
    for i in range(MAX_ISIZE):
        if ii.low <= i <= ii.high and hist[i]:
            t = (i - ii.avg) * (i - ii.avg)
            std_acc += t * int(hist[i])
            skew += t * (i - ii.avg) * int(hist[i])
            kurt += t * t * int(hist[i])
    kurt = kurt / n / (std_acc / n * std_acc / n) - 3
    ii.std = math.sqrt(std_acc / n)
    skew = skew / n / (ii.std * ii.std * ii.std)
    y = 1.0
    while y < 10.0:
        if .5 * math.erfc(y / math.sqrt(2)) < ap_prior / L * (
                y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + .499)
    n_ap = int(hist[ii.high_bayesian + 1:].sum()) \
        if ii.high_bayesian + 1 < MAX_ISIZE else 0
    ii.ap_prior = .01 * (n_ap + .01) / tot
    if ii.ap_prior < ap_prior:
        ii.ap_prior = ap_prior
    if report:
        print(f"[infer_isize] {rg_s}: qu({p25}, {p50}, {p75})",
              file=sys.stderr, end="")
    if math.isnan(ii.std) or p75 > MAX_ISIZE:
        if report:
            print(" -- not useable", file=sys.stderr)
        return None
    if report:
        print(" bound(%d,%d), num/avg/std/kur/skw %d/%.3f/%.3f/%.3f/%.3f,"
              " ap %.2e, max %d, %.2f sigma"
              % (ii.low, ii.high, n, ii.avg, ii.std, skew, kurt,
                 ii.ap_prior, ii.high_bayesian, y), file=sys.stderr)
    return ii


class NullIsize(pe.IsizeInfo):
    """static null_ii — zero-initialised (bam2bam.c globals)."""

    def __init__(self):
        super().__init__()
        self.avg = 0.0
        self.std = 0.0
        self.ap_prior = 0.0


def improve_isize_est(hists, p, ap_prior, L):
    """improve_isize_est (insert_size.c:141-165)."""
    s = p.states
    if p.kind < 1 or s[0].mapQ < 20:
        return
    if p.kind > 1 and s[1].mapQ < 20:
        return
    if p.kind == 1:
        ln = s[0].len
    elif s[0].pos < s[1].pos:
        ln = s[1].pos + s[1].len - s[0].pos
    else:
        ln = s[0].pos + s[0].len - s[1].pos
    if ln < 0 or ln >= MAX_ISIZE:
        return
    rg = p.recs[0].get_rg()
    h = hists.get(rg)
    if h is None:
        h = np.zeros(MAX_ISIZE, dtype=np.int64)
        hists[rg] = h
    h[ln] += 1


def pass1_work(engine, gopt, payload, host_reference=False):
    """Phase-1 chunk job (align): build per-record read states and run the
    DFS with per-read semantics.  Pure: returns data for the ordered
    writer (pair_aln, bam2bam.c:882-909)."""
    out = []
    jobs = []
    all_recs = [recs[j] for pi, kind, recs, uniq, side in payload["items"]
                for j in range(kind)]
    all_reads = bam1_to_reads_batch(all_recs, True, gopt.trim_qual)
    ri = 0
    for pi, kind, recs, uniq, side in payload["items"]:
        states = [se.SeqState(all_reads[ri + j]) for j in range(kind)]
        ri += kind
        out.append((pi, kind, states, side))
        if uniq and side is None:
            for j in range(kind):
                jobs.append((len(out) - 1, j))
    reads = [out[oi][2][j].read for oi, j in jobs]
    results = engine.run_chunk(reads, per_read_semantics=True,
                               host_reference=host_reference)
    alns = [[[] for _ in range(kind)] for pi, kind, _, _ in out]
    hws = [[0, 0] for _ in out]
    for i, (pi, kind, states, side) in enumerate(out):
        if side is not None:       # pre-computed .sai (phase aligned)
            for j in range(kind):
                alns[i][j] = side[j]
    for (oi, j), (a, hw) in zip(jobs, results):
        alns[oi][j] = a
        hws[oi][j] = hw
    return [(pi, states, alns[i], hws[i])
            for i, (pi, kind, states, _) in enumerate(out)]


def pass2_work(engine, gopt, popt, iinfos, payload, host_reference=False):
    """Phase-2 chunk job (finish), columnar (nabwa_tpu/models/bam2bam.py
    `_pass2_work_columnar`): one [R, NF] state matrix over the chunk
    (paired rows first, interleaved ends; singletons after), the native
    pairing/multi kernels, proxy-based mate rescue, refine/MD/trim, and
    the native BAM splice into FRESH records, so a redelivered chunk is
    idempotent.  `popt.type` BWA_PET_SOLID pairs and rescues in the SOLiD
    orientation, as the JAX pass 2 does (it has no colour decoding).
    Returns ([(recno, records)], rescue counters)."""
    parts = dict.fromkeys(PASS2_PARTS, 0.0)
    try:
        return _pass2(engine, gopt, popt, iinfos, payload, host_reference,
                      parts)
    finally:
        with _pass2_lock:
            for k, v in parts.items():
                pass2_seconds[k] += v


def _pass2(engine, gopt, popt, iinfos, payload, host_reference, parts):
    """sampe's steps 4-8b (`models.sampe`) on one table of the chunk's
    rows, each pair with its own read group's estimate, then the splice."""
    lib = native.lib()
    bns = engine.index.bns
    pac = engine.index.pac
    skip_duplicates = payload["skip_duplicates"]
    debug_bam = payload["debug_bam"]
    null_ii = NullIsize()
    counters = {"n_tot": [0, 0], "n_mapped": [0, 0]}

    out = []
    paired = []
    singles = []
    done = set()
    for pi, p in payload["items"]:
        out.append((pi, p))
        if unique(p, skip_duplicates):
            done.add(id(p))
            (singles if p.kind == SINGLETON else paired).append(p)
    n_p = len(paired)
    rows = [(p, j) for p in paired for j in (0, 1)] \
        + [(p, 0) for p in singles]
    R = len(rows)
    if R == 0:
        return [(pi, p.recs[:p.kind]) for pi, p in out], counters

    t0 = time.perf_counter()
    rows_states = [p.states[j] for p, j in rows]
    pc = pe.PairChunk.of_rows(rows_states, [p.alns[j] or [] for p, j in rows],
                              n_p)
    iis = [iinfos.get(p.recs[0].get_rg(), null_ii) for p in paired]
    pe.pairing(engine, pc, gopt, popt, iis, {}, host_reference)
    t1 = time.perf_counter()
    parts["pairing"] += t1 - t0
    pe.multi_hits(engine, pc, popt, host_reference)
    t2 = time.perf_counter()
    parts["multi"] += t2 - t1
    solved = sum(parts[k] for k in pe.RESCUE_SOLVE)
    counters = pe.rescue(pc, bns, pac, popt, iis, engine.device,
                         host_reference, parts)
    t3 = time.perf_counter()
    parts["rescue_drive"] += (t3 - t2) - (
        sum(parts[k] for k in pe.RESCUE_SOLVE) - solved)
    refine_dp = parts["dp"] + parts["dp_backtrace"]
    se.refine_jobs(pe.gapped_jobs(pc), pac, bns.l_pac, engine.device,
                   host_reference, parts=parts)
    t4 = time.perf_counter()
    parts["refine"] += (t4 - t3) - (parts["dp"] + parts["dp_backtrace"]
                                    - refine_dp)
    md_buf, md_off = pe.md(pc, bns, pac)
    t5 = time.perf_counter()
    parts["md"] += t5 - t4
    pe.correct_trim(pc)

    # --- native BAM splice into fresh records ---
    mate_idx = np.full(R, -1, dtype=np.int64)
    if n_p:
        mate_idx[:2 * n_p] = np.arange(2 * n_p, dtype=np.int64) ^ 1
    rec_objs = [p.recs[j] for p, j in rows]
    in_flag = np.array([r.flag for r in rec_objs], dtype=np.int64)
    in_l_qname = np.array([r.l_qname for r in rec_objs], dtype=np.int64)
    in_n_cigar = np.array([r.n_cigar for r in rec_objs], dtype=np.int64)
    in_l_qseq = np.array([r.l_qseq for r in rec_objs], dtype=np.int64)
    in_data, in_off = flat([r.data for r in rec_objs])
    # flat cigars post-trim, multi cigars appended (the emit layout)
    cig, cig_off_full = se.cigar_flat(pc.cigars, R, pc.mcigars,
                                      R * pc.stride)
    max_ent = np.array([getattr(s, "max_entries", 0) or 0
                        for s in rows_states], dtype=np.int32)
    out_fields = np.zeros((R, 9), dtype=np.int64)
    out_off = np.zeros(R + 1, dtype=np.int64)
    cap = (int(in_off[-1]) + int(md_off[-1]) + 200 * R
           + 64 * int(pc.multi_n.sum()) + 1024)
    blob = np.empty(cap, dtype=np.uint8)
    ann_off, ann_len, ann_names, ann_name_off, amb_off, amb_len, _ = \
        bns_emit_arrays(bns)
    args = (R, pc.state.reshape(-1), mate_idx,
            in_flag, in_l_qname, in_n_cigar, in_l_qseq, in_data, in_off,
            cig, cig_off_full, md_buf, md_off,
            pc.multi_pos, pc.multi_gap, pc.multi_mm, pc.multi_strand,
            pc.multi_n, pc.stride, max_ent, 1 if debug_bam else 0,
            bns.n_seqs, ann_off, ann_len, ann_names, ann_name_off,
            len(bns.ambs), amb_off, amb_len, bns.l_pac,
            gopt.mode, gopt.max_top2)
    total = lib.bam_update_batch(*args, out_fields.reshape(-1), blob,
                                 cap, out_off)
    if total > cap:
        blob = np.empty(int(total), dtype=np.uint8)
        total = lib.bam_update_batch(*args, out_fields.reshape(-1),
                                     blob, int(total), out_off)

    def mk_rec(row, old):
        nr = BamRec()
        nr.l_qname = old.l_qname
        nr.l_qseq = old.l_qseq
        f = out_fields[row]
        nr.flag = int(f[0])
        nr.tid = int(f[1])
        nr.pos = int(f[2])
        nr.bin = int(f[3])
        nr.qual = int(f[4])
        nr.mtid = int(f[5])
        nr.mpos = int(f[6])
        nr.isize = int(f[7])
        nr.n_cigar = int(f[8])
        nr.data = bytearray(
            blob[int(out_off[row]):int(out_off[row + 1])].tobytes())
        return nr

    row_of = {}
    for i, p in enumerate(paired):
        row_of[id(p)] = 2 * i
    for k, p in enumerate(singles):
        row_of[id(p)] = 2 * n_p + k
    result = []
    for pi, p in out:
        if id(p) not in done:
            result.append((pi, p.recs[:p.kind]))
        elif p.kind == SINGLETON:
            r0 = row_of[id(p)]
            result.append((pi, [mk_rec(r0, p.recs[0])]))
        else:
            r0 = row_of[id(p)]
            result.append((pi, [mk_rec(r0, p.recs[0]),
                                mk_rec(r0 + 1, p.recs[1])]))
    parts["splice"] += time.perf_counter() - t5
    return result, counters


def bam2bam(engine, in_bam, out_bam, gopt, popt, rng, argv=None,
            version="ref", only_aligned=False, broken_input=False,
            skip_duplicates=False, drop_aligned=False, debug_bam=False,
            n_workers=1, chunk_size=4096, worker_wrapper=None,
            rng_mode="drand48", sai_streams=None, tmp_dir=None,
            host_reference=False, port=None, prefix=None):
    """Two-pass bam2bam (bwa_bam2bam_core, bam2bam.c:1728-1940), driven
    through the chunk-lease scheduler over `n_workers` local threads that
    share `engine` and, with `port`, remote workers (see the module
    docstring).  Returns the rescue counters {"n_tot", "n_mapped"}.

    The drand48 hit sampling runs in the ordered pass-1 writer in strict
    record order (rng_mode="drand48", the sequential reference's call
    order), so the output does not depend on the workers.
    rng_mode="counter" instead derives an independent rand48 stream per
    logical record from hash_64(seed ^ recno): output is then invariant
    under any processing order and chunk size.

    worker_wrapper(wid, fn) lets tests inject failures/stragglers around
    the chunk jobs.  tmp_dir is accepted as the JAX package's signature
    has it, and unused.  host_reference: see the module docstring."""
    # chunk workers run concurrently: cap each one's native engine so
    # n_workers x hardware_concurrency does not oversubscribe the box
    if n_workers > 1:
        engine.native_threads = max(1, (os.cpu_count() or 1) // n_workers)

    bns = engine.index.bns
    reader = bamio.BamReader(in_bam)
    timers = StageTimers("bam2bam")
    tally = Counters()
    sa_rows_both = se.sa_rows_both_fn(engine, host_reference)
    rev_len = engine.index.rev.seq_len

    pairs = []

    coordinator = None
    if port is not None:
        from ..parallel.net import Coordinator
        coordinator = Coordinator(port, {
            "gap_opt": gopt.pack(), "pe_opt": popt.pack(),
            "prefix": prefix or "",
        })
    # the lease: long enough that a legitimately slow chunk is never
    # re-issued to a second worker (the reference's 90 s resend sweep,
    # bam2bam.c:8,1577-1601); the worker-kill tests shorten it
    lease_s = float(os.environ.get("NABWA_LEASE_S", "90"))

    # ---- PASS 1: align, chunk-distributed; the input BAM is parsed by a
    # producer thread and chunks stream into the scheduler as they fill
    # (bam2bam.c:1462-1530) ----
    chunks1 = []

    def produce_chunks(append):
        buf = []

        def flush():
            append({"items": [(pi, pairs[pi].kind,
                               pairs[pi].recs[:pairs[pi].kind],
                               unique(pairs[pi], skip_duplicates),
                               pairs[pi].side)
                              for pi in buf]})
            buf.clear()
        for p in read_bam_pairs(reader, allow_broken=broken_input,
                                drop_aligned=drop_aligned,
                                sai_streams=sai_streams):
            p.recno = len(pairs)
            pairs.append(p)
            buf.append(p.recno)
            if len(buf) >= chunk_size:
                flush()
        if buf:
            flush()

    def work_align(cid, payload):
        return pass1_work(engine, gopt, payload, host_reference)

    # The drand48 sampling + SA->position walk + isize histograms run in
    # the ordered pass-1 writer: chunks release strictly in record order,
    # so the rng stream and histogram sums are those of a sequential run.
    hists = {}

    def apply_align(cid, res):
        chunk_pairs = []
        for pi, states, alns, hws in res:
            p = pairs[pi]
            for j in range(p.kind):
                p.states[j] = states[j]
                p.alns[j] = alns[j]
                p.hw[j] = hws[j]
                states[j].max_entries = hws[j]
            chunk_pairs.append(p)
        pos_states = []
        for p in chunk_pairs:
            if not unique(p, skip_duplicates):
                continue
            if rng_mode == "counter":
                r = Rand48()
                r.x = pe.hash_64((bns.seed ^ p.recno)
                                 & 0xFFFFFFFFFFFFFFFF) & ((1 << 48) - 1)
            else:
                r = rng
            if p.kind == SINGLETON:
                se.aln2seq_core(p.alns[0], p.states[0], r,
                                n_multi=popt.max_occ_se)
            else:
                for j in range(2):
                    st = p.states[j]
                    st.n_multi = 0
                    st.multi = []
                    se.aln2seq_core(p.alns[j], st, r)
            pos_states.extend(p.states[j] for j in range(p.kind))
        se.cal_pac_pos(sa_rows_both, rev_len, pos_states, gopt.max_diff,
                       gopt.fnr)
        for p in chunk_pairs:
            if unique(p, skip_duplicates):
                improve_isize_est(hists, p, popt.ap_prior,
                                  engine.index.fwd.seq_len)
            p.phase = POSITIONED

    with timers("read + pass 1 align"):
        _, sched1 = run_distributed(chunks1, work_align,
                                    n_workers=n_workers,
                                    writer=apply_align,
                                    worker_wrapper=worker_wrapper,
                                    producer=produce_chunks,
                                    coordinator=coordinator, phase=1,
                                    lease_s=lease_s)
    idx_chunks = [list(range(i, min(i + chunk_size, len(pairs))))
                  for i in range(0, len(pairs), chunk_size)]
    tally.bump("pass1_resends", sched1.total_resends)
    tally.bump("pass1_dups", sched1.total_dups)

    # ---- barrier: infer_all_isizes (bam2bam.c:1856-1870); the per-RG
    # histograms were accumulated in record order by the pass-1 writer --
    iinfos = {}
    for rg, h in hists.items():
        ii = infer_isize_hist(h, popt.ap_prior, engine.index.fwd.seq_len,
                              rg=rg)
        if ii is not None:
            iinfos[rg] = ii
    # ---- PASS 2: finish (pairing + rescue + refine), chunk-distributed --
    chunks2 = [{"items": [(pi, pairs[pi]) for pi in idxs],
                "skip_duplicates": skip_duplicates,
                "debug_bam": debug_bam}
               for idxs in idx_chunks]

    def work_finish(cid, payload):
        return pass2_work(engine, gopt, popt, iinfos, payload,
                          host_reference)

    counters = {"n_tot": [0, 0], "n_mapped": [0, 0]}
    ema = RateEMA("bam2bam")

    # Output streams from the ordered pass-2 writer: records release in
    # input order, so BGZF compression/IO overlaps the remaining chunks'
    # compute instead of running as a serial stage after the pass.
    header_text = print_header_text(bns, reader.text, argv or [], version)
    refs = [(a.name, a.length) for a in bns.anns]
    out_f = open(out_bam, "wb")
    bam_w = bamio.BgzfWriter(out_f, level=2)
    payload = bytearray(b"BAM\x01")
    t = header_text.encode("latin1")
    payload += struct.pack("<i", len(t)) + t
    payload += struct.pack("<i", len(refs))
    for name, ln in refs:
        nb = name.encode() + b"\x00"
        payload += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    bam_w.write(bytes(payload))

    def apply_finish(cid, res):
        recs_list, cnt = res
        for k in range(2):
            counters["n_tot"][k] += cnt["n_tot"][k]
            counters["n_mapped"][k] += cnt["n_mapped"][k]
        for pi, recs in recs_list:
            p = pairs[pi]
            p.recs[:p.kind] = recs
            p.phase = FINISHED
            ema.update(pi)
            if only_aligned and any(recs[i].flag & SAM_FSU
                                    for i in range(p.kind)):
                continue
            for rec in recs:
                bam_w.write(rec.encode())

    with timers("pass 2 finish"):
        _, sched2 = run_distributed(chunks2, work_finish,
                                    n_workers=n_workers,
                                    writer=apply_finish,
                                    worker_wrapper=worker_wrapper,
                                    coordinator=coordinator, phase=2,
                                    ctx=iinfos, lease_s=lease_s)
    tally.bump("pass2_resends", sched2.total_resends)
    tally.bump("pass2_dups", sched2.total_dups)

    # mate-rescue tallies in the reference's format (bam2bam.c:1208-1214)
    print("[bwa_paired_sw] %d out of %d Q%d singletons are mated."
          % (counters["n_mapped"][1], counters["n_tot"][1], 17),
          file=sys.stderr)
    print("[bwa_paired_sw] %d out of %d Q%d discordant pairs are fixed."
          % (counters["n_mapped"][0], counters["n_tot"][0], 17),
          file=sys.stderr)

    # ---- output BAM: flush the streaming writer ----
    with timers("write output"):
        bam_w.close()
        out_f.close()
    if coordinator is not None:
        coordinator.close()
    ema.final(len(pairs))
    tally.report("bam2bam")
    timers.report_all()
    seconds.clear()
    seconds.update(timers.totals)
    telemetry.clear()
    telemetry.update(tally)
    return counters


def find_pp_tag(header_text):
    """find_pp_tag (bam2bam.c:212-271): (pp, id)."""
    present = []
    linked = []
    for line in header_text.split("\n"):
        if line.startswith("@PG"):
            for field in line.split("\t"):
                if field.startswith("ID:"):
                    present.append(field[3:])
                elif field.startswith("PP:"):
                    linked.append(field[3:])
    pp = None
    for k in present:
        if k not in linked:
            pp = k
            break
    myid = "bwa"
    n = 1
    while myid in present:
        myid = "bwa-%d" % n
        n += 1
    return pp, myid


def print_header_text(bns, oldhdr, argv, version):
    """bwa_print_header_text (bam2bam.c:164-200)."""
    pp, myid = find_pp_tag(oldhdr)
    out = ["@HD\tVN:1.4\n@PG\tID:%s%s\tPN:bwa\tVN:%s%s" % (
        myid, ("\tPP:" + pp) if pp else "", version,
        "\tCL:" if argv else "")]
    for i, a in enumerate(argv):
        out.append("%s%c" % (a, "\n" if i == len(argv) - 1 else " "))
    for a in bns.anns:
        out.append("@SQ\tSN:%s\tLN:%d\n" % (a.name, a.length))
    for line in oldhdr.split("\n"):
        if not line:
            continue
        if line.startswith("@SQ") or line.startswith("@HD"):
            continue
        out.append(line + "\n")
    return "".join(out)
