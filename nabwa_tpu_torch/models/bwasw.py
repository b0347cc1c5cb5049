"""The `bwasw` long-read workflow on the port's engine: the counterpart of
nabwa_tpu/models/bwasw.py:1230 `bwasw` (bsw2_aln, bwtsw2_aux.c:460-607),
reads to SAM bytes, byte-identical with it.

The per-read steps of the JAX package's object route (`aln_one`) run in
stages over the whole batch, split as native/bsw2aln.cpp:810-988 splits
them, so that the kernels take the work of many reads per launch and the
drand48 stream is drawn in read order:
  prep  each read's adjusted t/bw (`_adjusted_opt`), whether it has
        ambiguous bases, its codes
  A     forward index, reads without ambiguous bases (no random draws):
        per read and strand the read's own index (`Bwtl`) and the native
        DAG x trie core `bsw2_core_u32`; the SA rows of every read's hits
        through one `engine.sa_rows` (kernel C3 on a CUDA engine);
        `resolve_duphits`, `chain_filter`; the left extensions of every
        read through one `ops.dp.extend_batch` (kernel C6), applied per
        read in the C's order with its coverage check; `merge_hits`,
        `resolve_duphits`; the right extensions through C6; the two
        strands merged.  This is bsw2_aln1_core up to its final
        `resolve_query_overlaps`.
  A2    the same on the reverse index for every read of A whose list has a
        hit with n_seeds < t_seeds: it holds every read that will need the
        reverse pass, since `resolve_query_overlaps` drops hits and
        changes G/G2 but never n_seeds.
  B     in read order, the only drand48 consumer: the ambiguous bases'
        draws, `resolve_query_overlaps`, the reverse-pass decision, the
        coordinate flip, `flag_fr`, `merge_hits`, `resolve_duphits`,
        `resolve_query_overlaps` (bwtsw2_aux.c:486-520).  A read with
        ambiguous bases runs its A and A2 stages here, once its draws are
        made, on the same kernels (launches of a few jobs).
  C     the cigars of every hit of every read through one
        `ops.dp.banded_global_batch` (kernel C4), each pair with its read's
        band, gap_end = r; then `fix_cigar` and `print_hits`.

`host_reference=True` runs the native whole-batch driver `bsw2_aln_batch`
instead (the JAX package's default route, nabwa_tpu/models/bwasw.py:1146),
with an explicit thread count: the reference the card's output is held
against.  Only that argument chooses it; nothing falls back to it.

Copied from nabwa_tpu/models/bwasw.py: `Bsw2Opt`, `Hit`, `resolve_duphits`
(its SA rows asked for by `duphit_rows` and handed in, so one launch serves
a batch), `resolve_query_overlaps`, the chaining filter, `_gen_ap`,
`_left_target`, the extension bookkeeping, `merge_hits`, `flag_fr`,
`fix_cigar`, `print_hits` and `_adjusted_opt`; `Bwtl` computes the same
arrays with numpy.  The DAG x trie core stays the native one, on the
host, as in the JAX package; its Python twin is not copied.

`seconds` sums host seconds per part over calls: prep, core (`Bwtl` and
the native core), sa (C3 and the copies), hits (duplicate resolution,
chaining, the extension jobs and their bookkeeping, merges), extend
(`extend_batch`: packing, C6, the copy back), replay (stage B without the
A stages it runs), dp and dp_backtrace (`banded_global_batch`), cigar
(the cigar jobs and paths) and emit (`fix_cigar`, `print_hits`).  On the
host reference route the native driver's time is booked under "native".
"""

import math
import time

import numpy as np

from ..index import native
from ..index.pack import NT4
from ..index.sa import suffix_array
from ..ops import dp
from ..refmodel.stdaln_scalar import AlnParam, path2cigar32
from ..utils.ksort import introsort
from .samse import coor_pac2real

MASK_LEVEL = 0.90

NT_COMP = {c: r for c, r in zip("ACGTNacgtn-", "TGCANtgcan-")}

seconds = dict.fromkeys(("prep", "core", "sa", "hits", "extend", "replay",
                         "dp", "dp_backtrace", "cigar", "emit", "native"),
                        0.0)


class Bsw2Opt:
    """bsw2opt_t defaults (bsw2_init_opt, bwtsw2_aux.c:48-57)."""

    def __init__(self):
        self.a = 1
        self.b = 3
        self.q = 5
        self.r = 2
        self.t = 30
        self.bw = 50
        self.z = 1
        self.is_ = 3
        self.t_seeds = 5
        self.hard_clip = 0
        self.mask_level = np.float32(0.50)
        self.yita = 5.5
        self.coef = 5.5
        self.qr = self.q + self.r
        self.chunk_size = 10000000

    def copy(self):
        import copy
        return copy.copy(self)


class Bwtl:
    """bwtl_t (bwt_lite.c:9-54): the full-SA FM-index of one read, as the
    arrays the native core reads (suffix array with the sentinel row,
    primary, L2 and the cumulative occ per position)."""

    def __init__(self, seq):
        seq = np.asarray(seq, dtype=np.uint8)
        n = len(seq)
        self.seq_len = n
        self.sa = np.concatenate(([n], suffix_array(seq))).astype(np.int64)
        self.primary = int(np.nonzero(self.sa == 0)[0][0])
        s = seq[self.sa - 1]              # row of suffix 0 dropped below
        bwt = np.delete(s, self.primary)
        self.cum = np.zeros((n + 1, 4), dtype=np.int64)
        np.cumsum(bwt[:, None] == np.arange(4), axis=0, out=self.cum[1:])
        self.L2 = np.zeros(5, dtype=np.int64)
        self.L2[1:] = np.cumsum(self.cum[n])


class Hit:
    """bsw2hit_t."""

    __slots__ = ("k", "l", "flag", "n_seeds", "len", "G", "G2", "beg", "end")

    def copy(self):
        h = Hit.__new__(Hit)
        h.k = self.k
        h.l = self.l
        h.flag = self.flag
        h.n_seeds = self.n_seeds
        h.len = self.len
        h.G = self.G
        h.G2 = self.G2
        h.beg = self.beg
        h.end = self.end
        return h


def _hits_of(rows):
    out = []
    for row in rows:
        h = Hit.__new__(Hit)
        (h.k, h.l, h.flag, h.n_seeds, h.len, h.G, h.G2, h.beg,
         h.end) = row
        out.append(h)
    return out


def _hitG_lt(a, b):
    return a.G > b.G


def core_hits(opt, target, fm):
    """The native DAG x trie core (native/bsw2core.cpp, bsw2_core
    bwtsw2_core.c:429-594) of one read strand `target` (a Bwtl) against
    the genome index `fm`: (hits, narrow hits) before the SA resolution.
    When the narrow list overflows, the core runs again at the exact size,
    as native/bsw2aln.cpp:666-677 does."""
    n = target.seq_len
    args = (np.ascontiguousarray(target.sa, dtype=np.int64),
            np.ascontiguousarray(target.L2, dtype=np.int64),
            np.ascontiguousarray(target.cum, dtype=np.int32).reshape(-1),
            int(target.primary), int(n),
            np.ascontiguousarray(fm.bwt, dtype=np.uint32),
            np.uint32(fm.primary), np.ascontiguousarray(fm.l2,
                                                        dtype=np.uint32),
            np.uint32(fm.seq_len), int(opt.a), int(opt.b), int(opt.q),
            int(opt.r), int(opt.bw), int(opt.z), int(opt.t), int(opt.is_))
    cap = 16 * n + 64
    for _ in range(2):
        hits = np.zeros((2 * n, 9), dtype=np.int64)
        b1 = np.zeros((max(cap, 1), 9), dtype=np.int64)
        b1_n = np.zeros(1, dtype=np.int64)
        rc = native.lib().bsw2_core_u32(*args, hits.reshape(-1),
                                         b1.reshape(-1), cap, b1_n)
        if rc == 0:
            return (_hits_of(hits.tolist()),
                    _hits_of(b1[:int(b1_n[0])].tolist()))
        cap = int(b1_n[0])
    raise RuntimeError("bsw2_core_u32 failed at the exact narrow-hit size")


def duphit_rows(b, IS):
    """The SA rows `resolve_duphits` on the genome index looks up for list
    b, in its order (nabwa_tpu/models/bwasw.py:323-330)."""
    rows = []
    for p in b:
        if p.l - p.k + 1 <= IS:
            rows.extend(range(p.k, p.l + 1))
        elif p.G > 0:
            rows.append(p.k)
    return rows


def resolve_duphits(b, IS, vals=None):
    """bsw2_resolve_duphits (bwtsw2_core.c:261-327).  vals: None for the
    call without a genome index, else an iterator over the SA values of
    `duphit_rows(b, IS)`, which it consumes.  b: list of Hit (mutated)."""
    if not b:
        return b
    if vals is not None:
        new = []
        for p in b:
            if p.l - p.k + 1 <= IS:
                for _ in range(p.k, p.l + 1):
                    h = p.copy()
                    h.k = next(vals)
                    h.l = 0
                    new.append(h)
            elif p.G > 0:
                h = p.copy()
                h.k = next(vals)
                h.l = 0
                h.flag |= 1
                new.append(h)
        b = new
    introsort(b, _hitG_lt)
    n = len(b)
    stop = n
    i = 1
    while i < n:
        p = b[i]
        if p.G == 0:
            stop = i
            break
        for j in range(i):
            q = b[j]
            compatible = True
            if q.G == 0:
                continue
            if p.l == 0 and q.l == 0:
                qol = min(p.end, q.end) - max(p.beg, q.beg)
                if qol < 0:
                    qol = 0
                if (np.float32(qol) / np.float32(p.end - p.beg)
                        > np.float32(MASK_LEVEL)
                        or np.float32(qol) / np.float32(q.end - q.beg)
                        > np.float32(MASK_LEVEL)):
                    tol = min(p.k + p.len, q.k + q.len) - max(p.k, q.k)
                    if (tol / p.len > MASK_LEVEL
                            or tol / q.len > MASK_LEVEL):
                        compatible = False
            if not compatible:
                p.G = 0
                break
        i += 1
    return [h for h in b[:stop] if h.G != 0]


def resolve_query_overlaps(b, mask_level, rng):
    """bsw2_resolve_query_overlaps (bwtsw2_core.c:329-378): one drand48
    draw for a non-empty list."""
    if not b:
        return b
    introsort(b, _hitG_lt)
    G0 = b[0].G
    i = 1
    while i < len(b) and b[i].G == G0:
        i += 1
    j = int(i * rng.drand48())
    if j:
        b[0], b[j] = b[j], b[0]
    n = len(b)
    stop = n
    for i in range(1, n):
        p = b[i]
        all_compat = True
        if p.G == 0:
            stop = i
            break
        for j in range(i):
            q = b[j]
            if q.G == 0:
                continue
            tol = 0
            qol = min(p.end, q.end) - max(p.beg, q.beg)
            if qol < 0:
                qol = 0
            if p.l == 0 and q.l == 0:
                tol = min(p.k + p.len, q.k + q.len) - max(p.k, q.k)
                if tol < 0:
                    tol = 0
            fol = np.float32(qol) / min(p.end - p.beg, q.end - q.beg)
            compatible = fol < mask_level or (
                tol > 0 and qol < p.end - p.beg and qol < q.end - q.beg)
            if not compatible:
                if q.G2 < p.G:
                    q.G2 = p.G
                all_compat = False
        if not all_compat:
            p.G = 0
    return [h for h in b[:stop] if h.G != 0]


# --- bwtsw2_chain.c: the chaining filter ---

class _Chain:
    __slots__ = ("tbeg", "tend", "qbeg", "qend", "flag", "idx", "chain")

    def __init__(self):
        self.tbeg = self.tend = 0
        self.qbeg = self.qend = 0
        self.flag = 0
        self.idx = 0
        self.chain = -1


def _hsaip_lt(a, b):
    return a.qbeg < b.qbeg


def _chaining(opt, shift, z, chain):
    """chaining (bwtsw2_chain.c:16-42)."""
    introsort(z, _hsaip_lt)
    m = 0
    for p in z:
        k = m - 1
        while k >= 0:
            q = chain[k]
            x = p.qbeg - q.qbeg
            y = p.tbeg - q.tbeg
            if y > 0 and x - y <= opt.bw and y - x <= opt.bw:
                if p.qend > q.qend:
                    q.qend = p.qend
                if p.tend > q.tend:
                    q.tend = p.tend
                q.chain += 1
                p.chain = shift + k
                break
            k -= 1
        if k < 0:
            c = _Chain()
            c.tbeg, c.tend = p.tbeg, p.tend
            c.qbeg, c.qend = p.qbeg, p.qend
            c.flag = p.flag
            c.chain = 1
            c.idx = p.chain = shift + m
            chain.append(c)
            m += 1
    return m


def chain_filter(opt, length, b):
    """bsw2_chain_filter (bwtsw2_chain.c:44-107).  b = [hits0, hits1]
    (narrow hits of the two strands); returns filtered lists."""
    n = [len(b[0]), len(b[1])]
    if n[0] + n[1] == 0:
        return b
    z = [[], []]
    for k in range(2):
        for i, p in enumerate(b[k]):
            q = _Chain()
            q.flag = k
            q.idx = i
            q.tbeg, q.tend = p.k, p.k + p.len
            q.chain = -1
            q.qbeg, q.qend = p.beg, p.end
            z[k].append(q)
    chain = []
    m0 = _chaining(opt, 0, z[0], chain)
    chain1 = []
    m1 = _chaining(opt, m0, z[1], chain1)
    for p in chain1:
        tmp = p.qbeg
        p.qbeg = length - p.qend
        p.qend = length - tmp
    chain = chain + chain1
    flag = [0] * (m0 + m1)
    introsort(chain, _hsaip_lt)
    for k in range(1, m0 + m1):
        p = chain[k]
        for j in range(k):
            q = chain[j]
            if flag[q.idx]:
                continue
            if q.qend >= p.qend and q.chain > p.chain * opt.t_seeds * 2:
                flag[p.idx] = 1
                break
    for k in range(2):
        for p in z[k]:
            if flag[p.chain]:
                b[k][p.idx].G = 0
    for k in range(2):
        b[k] = [h for h in b[k] if h.G]
    return b


# --- bwtsw2_aux.c: extension, cigar, merging, SAM ---

def _gen_ap(opt):
    """__gen_ap (bwtsw2_aux.c:69-76): 5x5 matrix, gap_end = r."""
    m = np.full((5, 5), -opt.b, dtype=np.int64)
    for i in range(4):
        m[i, i] = opt.a
    return AlnParam(opt.q, opt.r, opt.r, m, 5, opt.bw)


def _hit_end_lt(a, b):
    return a.end > b.end


def _left_target(opt, p, lq, pac, l_pac, is_rev, rquery):
    """Upstream-reference window + query segment for one left extension
    (bwtsw2_aux.c:96-117).  Depends only on p's own pre-extension fields."""
    lt = ((p.beg + 1) // 2 * opt.a + opt.r) // opt.r + lq
    if lt > p.k:
        lt = p.k
    # upstream ref, reversed (k = p.k-1 down to 1; k=0 not considered,
    # the C FIXME)
    idxs = np.arange(p.k - 1, max(p.k - 1 - lt, 0), -1)
    if is_rev:
        tgt = pac[l_pac - 1 - idxs] if len(idxs) else np.zeros(0, np.uint8)
    else:
        tgt = pac[idxs] if len(idxs) else np.zeros(0, np.uint8)
    qseg = rquery[lq - p.beg:lq] if p.beg else rquery[lq:lq]
    return tgt, qseg


def _right_target(opt, p, lq, pac, l_pac, is_rev, query):
    """Downstream-reference window + query segment for one right extension
    (bwtsw2_aux.c:140-151)."""
    lt = ((lq - p.beg + 1) // 2 * opt.a + opt.r) // opt.r + lq
    hi = min(p.k + lt, l_pac)
    if is_rev:
        idxs = np.arange(p.k, hi)
        tgt = pac[l_pac - 1 - idxs] if len(idxs) else np.zeros(0, np.uint8)
    else:
        tgt = pac[p.k:hi]
    return tgt, query[p.beg:lq]


def apply_left(b, ext):
    """bsw2_extend_left's bookkeeping (bwtsw2_aux.c:80-129) on list b, in
    the order the jobs were made (sorted by end): n_seeds from the hits
    that cover each hit, and the extension `ext[i]` = (score, end_i,
    end_j) of every uncovered hit i applied where it raises G."""
    for i, p in enumerate(b):
        p.n_seeds = 1
        if p.l or p.k == 0:
            continue
        score = 0
        for j in range(i):
            q = b[j]
            if q.beg <= p.beg and q.k <= p.k and q.k + q.len >= p.k + p.len:
                if q.n_seeds < (1 << 14) - 2:
                    q.n_seeds += 1
                score += 1
        if score:
            continue
        score, ei, ej = ext[i]
        if score > p.G:
            p.G = score
            p.len += ei
            p.beg -= ej
            p.k -= ei


def merge_hits(b, l, is_reverse):
    """merge_hits (bwtsw2_aux.c:230-250): b[1] folded into b[0]."""
    for p in b[1]:
        if is_reverse:
            x = p.beg
            p.beg = l - p.end
            p.end = l - x
            p.flag |= 0x10
        b[0].append(p)
    b[1] = []
    return b[0]


def flag_fr(b):
    """flag_fr (bwtsw2_aux.c:279-300)."""
    for p in b[0]:
        p.flag |= 0x10000
    for p in b[1]:
        p.flag |= 0x20000
    for p in b[0]:
        for q in b[1]:
            if (q.beg == p.beg and q.end == p.end and q.k == p.k
                    and q.len == p.len and q.G == p.G):
                q.flag |= 0x30000
                p.flag |= 0x30000
                break


def fix_cigar(bns, p, cigar):
    """fix_cigar (bwtsw2_aux.c:312-382): split alignments bridging two
    reference sequences.  Mutates p; returns new cigar."""
    seqid, _ = coor_pac2real(bns, p.k, p.len)
    coor = p.k - bns.anns[seqid].offset
    refl = bns.anns[seqid].length
    x, y = coor, 0
    for op, ln in cigar:
        if op in (1, 4, 5):
            y += ln
        elif op == 2:
            x += ln
        else:
            x += ln
            y += ln
    lq = y
    if x <= refl:
        return cigar
    nc = 0
    mq = [0, 0]
    nlen = [0, 0]
    cn = []
    kk = 0
    x, y = coor, 0
    for op, ln in cigar:
        if op in (4, 5, 1):
            y += ln
            cn.append((op, ln))
        elif op == 2:
            if x + ln >= refl and nc == 0:
                cn.append((4, lq - y))
                nc = len(cn)
                cn.append((4, y))
                kk = p.k + (x + ln - refl)
                nlen[0] = x - coor
                nlen[1] = p.len - nlen[0] - ln
            else:
                cn.append((op, ln))
            x += ln
        elif op == 0:
            if x + ln >= refl and nc == 0:
                cn.append((0, refl - x))
                cn.append((4, lq - y - (refl - x)))
                nc = len(cn)
                mq[0] += refl - x
                cn.append((4, y + (refl - x)))
                if x + ln - refl:
                    cn.append((0, x + ln - refl))
                mq[1] += x + ln - refl
                kk = bns.anns[seqid].offset + refl
                nlen[0] = refl - coor
                nlen[1] = p.len - nlen[0]
            else:
                cn.append((op, ln))
                mq[1 if nc else 0] += ln
            x += ln
            y += ln
    if mq[0] > mq[1]:
        p.len = nlen[0]
        return cn[:nc]
    p.k = kk
    p.len = nlen[1]
    return cn[nc:]


def print_hits(bns, opt, name, seq_str, qual_str, b, cigars):
    """print_hits (bwtsw2_aux.c:386-451): one read's SAM text."""
    out = []
    if b is None or len(b) == 0:
        line = "%s\t4\t*\t0\t0\t*\t*\t0\t0\t%s" % (name, seq_str)
        line += "\t%s" % qual_str if qual_str else "\t*"
        out.append(line + "\n")
        return "".join(out)
    lq = len(seq_str)
    for i, p in enumerate(b):
        seqid, coor, nn = -1, -1, 0
        cig = cigars[i]
        if p.l == 0:
            cig = cigars[i] = fix_cigar(bns, p, cig)
            seqid, nn = coor_pac2real(bns, p.k, p.len)
            coor = p.k - bns.anns[seqid].offset
        line = "%s\t%d" % (name, p.flag & 0x10)
        line += "\t%s\t%d" % (bns.anns[seqid].name if seqid >= 0 else "*",
                              coor + 1)
        if p.l == 0:
            c = np.float32(1.0)
            subo = p.G2 if p.G2 > opt.t else opt.t
            if (p.flag >> 16) in (1, 2):
                c = np.float32(c * np.float32(.5))
            if p.n_seeds < 2:
                c = np.float32(c * np.float32(.2))
            qual = int(float(c) * (p.G - subo) * (250.0 / p.G
                                                  + 0.03 / opt.a) + .499)
            if qual > 250:
                qual = 250
            if p.flag & 1:
                qual = 0
            line += "\t%d\t" % qual
            ops = "MIDNHHP" if opt.hard_clip else "MIDNSHP"
            line += "".join("%d%c" % (ln, ops[op]) for op, ln in cig)
        else:
            line += "\t0\t*"
        line += "\t*\t0\t0\t"
        beg, end = 0, lq
        if opt.hard_clip:
            if cig and cig[0][0] == 4:
                beg += cig[0][1]
            if cig and cig[-1][0] == 4:
                end -= cig[-1][1]
        if p.flag & 0x10:
            line += "".join(NT_COMP.get(seq_str[lq - 1 - j], "N")
                            for j in range(beg, end))
        else:
            line += seq_str[beg:end]
        if qual_str:
            line += "\t"
            if p.flag & 0x10:
                line += "".join(qual_str[lq - 1 - j] for j in range(beg, end))
            else:
                line += qual_str[beg:end]
        else:
            line += "\t*"
        line += "\tAS:i:%d\tXS:i:%d\tXF:i:%d\tXE:i:%d\tXN:i:%d" % (
            p.G, p.G2, p.flag >> 16, p.n_seeds, nn)
        if p.l:
            line += "\tXI:i:%d" % (p.l - p.k + 1)
        out.append(line + "\n")
    return "".join(out)


def _adjusted_opt(opt0, l):
    """Per-read t/bw adjustment (bwtsw2_aux.c:472-485); print_hits reads
    the adjusted t for the mapQ subo floor."""
    opt = opt0.copy()
    if opt.t < math.log(l) * opt.coef:
        opt.t = int(math.log(l) * opt.coef + .499)
    k = (l * opt.a - 2 * opt.q) // (2 * opt.r + opt.a)
    i = (l * opt.a - opt.a - opt.t) // opt.r
    if k > i:
        k = i
    if k < 1:
        k = 1
    opt.bw = min(opt0.bw, k)
    return opt


def sam_sq(bns):
    """The @SQ lines bsw2_aln writes first (bwtsw2_aux.c:606-607)."""
    return "".join("@SQ\tSN:%s\tLN:%d\n" % (a.name, a.length)
                   for a in bns.anns).encode()


# --- the staged driver ---

class ReadCtx:
    """One read through the stages: its input, adjusted options, the four
    strand code arrays (bwtsw2_aux.c:488-497), the hit lists before the
    final overlap resolution of the forward (`pre`) and reverse (`pre_rev`)
    passes, and the final hits and cigars."""

    __slots__ = ("name", "seq_str", "qual_str", "l", "raw", "has_amb", "opt",
                 "seq", "seq1", "rseq0", "rseq1", "pre", "pre_rev", "hits",
                 "cigars")

    def __init__(self, opt0, name, seq_str, qual_str):
        self.name, self.seq_str, self.qual_str = name, seq_str, qual_str
        self.l = len(seq_str)
        self.raw = NT4[np.frombuffer(seq_str.encode(), dtype=np.uint8)]
        self.has_amb = bool((self.raw >= 4).any())
        self.opt = _adjusted_opt(opt0, self.l)
        self.pre = self.pre_rev = self.hits = self.cigars = None

    def fill_strands(self, rng):
        """The four strand arrays, each ambiguous base replaced by one
        drand48 draw in read order; returns the number of draws."""
        seq = self.raw.copy()
        amb = np.nonzero(seq >= 4)[0]
        for i in amb.tolist():
            seq[i] = int(rng.drand48() * 4)
        self.seq, self.rseq0 = seq, seq[::-1].copy()
        self.seq1, self.rseq1 = 3 - self.rseq0, 3 - seq
        return len(amb)


def _stage_a(index, engine, reads, is_rev, parts):
    """bsw2_aln1_core (bwtsw2_aux.c:252-276) up to its final
    resolve_query_overlaps, for every read of `reads` at once on the
    forward (is_rev false) or reverse index: one C3 launch for the SA rows,
    one C6 launch for the left and one for the right extensions.  Returns
    each read's merged hit list."""
    fm = index.rev if is_rev else index.fwd
    pac, l_pac = index.pac, index.bns.l_pac
    t0 = time.perf_counter()
    seqs = [((R.rseq0, R.rseq1) if is_rev else (R.seq, R.seq1))
            for R in reads]
    raw = [[core_hits(R.opt, Bwtl(s[k]), fm) for k in range(2)]
           for R, s in zip(reads, seqs)]
    t1 = time.perf_counter()
    rows = []
    for R, pair in zip(reads, raw):
        for hits, narrow in pair:
            rows += duphit_rows(hits, R.opt.is_)
            rows += duphit_rows(narrow, R.opt.is_)
    # each distinct row once (the 2 l empty hits of a strand all ask for
    # row 0)
    uniq, inv = np.unique(np.asarray(rows, dtype=np.uint32),
                          return_inverse=True)
    vals = iter(engine.sa_rows(0 if is_rev else 1, uniq)[inv].tolist())
    t2 = time.perf_counter()
    parts["core"] += t1 - t0
    parts["sa"] += t2 - t1

    # duplicates, chaining, and the left extension jobs of every read
    ap = _gen_ap(reads[0].opt)
    lists, jobs, g0s, bws = [], [], [], []
    for R, s, pair in zip(reads, seqs, raw):
        ball, bnar = [], []
        for hits, narrow in pair:
            ball.append(resolve_duphits(hits, R.opt.is_, vals))
            bnar.append(resolve_duphits(narrow, R.opt.is_, vals))
        bnar = chain_filter(R.opt, R.l, bnar)
        for k in range(2):
            introsort(bnar[k], _hit_end_lt)
            rquery = s[k][::-1]
            for p in bnar[k]:
                if p.l or p.k == 0:
                    continue
                jobs.append(_left_target(R.opt, p, R.l, pac, l_pac, is_rev,
                                         rquery))
                g0s.append(p.G)
                bws.append(R.opt.bw)
        lists.append((ball, bnar))
    t3 = time.perf_counter()
    parts["hits"] += t3 - t2
    res = iter(dp.extend_batch(jobs, ap, g0s, engine.device, bws=bws,
                               seconds=parts))

    # apply them in the C's order; merge, resolve, right extension jobs
    t4 = time.perf_counter()
    jobs, g0s, bws, merged = [], [], [], []
    for R, s, (ball, bnar) in zip(reads, seqs, lists):
        out = []
        for k in range(2):
            b = bnar[k]
            apply_left(b, {i: next(res) for i, p in enumerate(b)
                           if not (p.l or p.k == 0)})
            m = resolve_duphits(merge_hits([ball[k], b], R.l, 0), 0)
            for p in m:
                if p.l:
                    continue
                jobs.append(_right_target(R.opt, p, R.l, pac, l_pac, is_rev,
                                          s[k]))
                g0s.append(1)
                bws.append(R.opt.bw)
            out.append(m)
        merged.append(out)
    t5 = time.perf_counter()
    parts["hits"] += t5 - t4
    res = iter(dp.extend_batch(jobs, ap, g0s, engine.device, bws=bws,
                               seconds=parts))
    t6 = time.perf_counter()
    for R, out in zip(reads, merged):
        for m in out:
            for p in m:
                if p.l:
                    continue
                score, ei, ej = next(res)
                if score >= p.G:
                    p.G = score
                    p.len = ei
                    p.end = ej + p.beg
    lists = [merge_hits(out, R.l, 1) for R, out in zip(reads, merged)]
    parts["hits"] += time.perf_counter() - t6
    return lists


def _replay(index, engine, ctxs, opt0, rng, parts):
    """Stage B (bwtsw2_aux.c:486-520, native/bsw2aln.cpp:888-935): every
    drand48 draw, in read order."""
    bns = index.bns
    for R in ctxs:
        t0 = time.perf_counter()
        n_amb = R.fill_strands(rng) if R.has_amb else 0
        if R.l - n_amb < R.opt.t:
            R.hits = None
            parts["replay"] += time.perf_counter() - t0
            continue
        inline = 0.0
        if R.has_amb:
            t1 = time.perf_counter()
            R.pre = _stage_a(index, engine, [R], False, parts)[0]
            inline += time.perf_counter() - t1
        b0 = resolve_query_overlaps(R.pre, opt0.mask_level, rng)
        if any(h.n_seeds < opt0.t_seeds for h in b0):
            if R.pre_rev is None:
                t1 = time.perf_counter()
                R.pre_rev = _stage_a(index, engine, [R], True, parts)[0]
                inline += time.perf_counter() - t1
            b1 = resolve_query_overlaps(R.pre_rev, opt0.mask_level, rng)
            for p in b1:
                x = p.beg
                p.beg = R.l - p.end
                p.end = R.l - x
                if p.l == 0:
                    p.k = bns.l_pac - (p.k + p.len)
            pair = [b0, b1]
            flag_fr(pair)
            b0 = resolve_duphits(merge_hits(pair, R.l, 0), 0)
            b0 = resolve_query_overlaps(b0, opt0.mask_level, rng)
        R.hits = b0
        parts["replay"] += time.perf_counter() - t0 - inline


def _cigars(index, engine, ctxs, opt0, parts):
    """Stage C: gen_cigar (bwtsw2_aux.c:167-216) for every hit of every
    read through one `banded_global_batch`, each pair with its read's
    band."""
    t0 = time.perf_counter()
    pac, ap = index.pac, _gen_ap(opt0)
    jobs, bws, metas = [], [], []
    for R in ctxs:
        if not R.hits:
            continue
        R.cigars = [[] for _ in R.hits]
        for i, p in enumerate(R.hits):
            if p.l:
                continue
            rev = p.flag & 0x10
            beg = R.l - p.end if rev else p.beg
            end = R.l - p.beg if rev else p.end
            jobs.append((pac[p.k:p.k + p.len],
                         (R.seq1 if rev else R.seq)[beg:end]))
            bws.append(R.opt.bw)
            metas.append((R, i, beg, end))
    parts["cigar"] += time.perf_counter() - t0
    res = dp.banded_global_batch(jobs, ap, engine.device, band_widths=bws,
                                 seconds=parts)
    t0 = time.perf_counter()
    for (R, i, beg, end), (_, path) in zip(metas, res):
        cig = path2cigar32(path)
        if beg != 0:
            cig = [(4, beg)] + cig
        if end < R.l:
            cig = cig + [(4, R.l - end)]
        R.cigars[i] = cig
    parts["cigar"] += time.perf_counter() - t0


def _native_batch(index, reads, opt, rng, threads):
    """The native whole-batch driver (native/bsw2aln.cpp:810-988): hits
    and cigars per read, the rng advanced past every draw."""
    fwd, rev = index.fwd, index.rev
    codes = np.concatenate([
        NT4[np.frombuffer(s.encode(), dtype=np.uint8)] for _, s, _ in reads
    ]).astype(np.uint8)
    offs = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum([len(s) for _, s, _ in reads], out=offs[1:])
    iopt = np.array([opt.a, opt.b, opt.q, opt.r, opt.t, opt.bw, opt.z,
                     opt.is_, opt.t_seeds, opt.hard_clip], dtype=np.int32)
    state = np.array([rng.x], dtype=np.uint64)
    hits_cap = 64 * len(reads) + 1024
    hit_cnt = np.zeros(len(reads), dtype=np.int64)
    hits = np.zeros((hits_cap, 9), dtype=np.int64)
    cig_cap = 8192 * len(reads) + 65536
    cig = np.zeros((cig_cap, 2), dtype=np.int32)
    cig_cnt = np.zeros(hits_cap, dtype=np.int64)

    def fm_args(fm):
        return (np.ascontiguousarray(fm.bwt, dtype=np.uint32),
                np.uint32(fm.primary),
                np.ascontiguousarray(fm.l2, dtype=np.uint32),
                np.uint32(fm.seq_len),
                np.ascontiguousarray(fm.sa, dtype=np.uint32),
                np.int32(fm.sa_intv))

    htot = native.lib().bsw2_aln_batch(
        *fm_args(fwd), *fm_args(rev),
        np.ascontiguousarray(index.pac, dtype=np.uint8),
        np.int64(index.bns.l_pac), codes, offs, np.int64(len(reads)),
        iopt, np.float32(opt.mask_level), float(opt.coef), state,
        np.int32(threads), hit_cnt, hits.reshape(-1), np.int64(hits_cap),
        cig.reshape(-1), np.int64(cig_cap), cig_cnt)
    if htot < 0:
        raise RuntimeError("bsw2_aln_batch: output overflow or an "
                           "unmodelled core overflow")
    rng.x = int(state[0])
    out, hi, ci = [], 0, 0
    rows, cig_l = hits.tolist(), cig.tolist()
    for n in hit_cnt.tolist():
        b, cigars = _hits_of(rows[hi:hi + n]), []
        for h in range(hi, hi + n):
            m = int(cig_cnt[h])
            cigars.append([(op, ln) for op, ln in cig_l[ci:ci + m]])
            ci += m
        hi += n
        out.append((b, cigars))
    return out


def bwasw_bytes(index, reads, opt, engine, rng, host_reference=False,
                threads=0):
    """SAM records of bwasw over reads [(name, seq, qual or None), ...]
    (without the @SQ lines, `sam_sq`).  engine: the `AlnEngine` whose
    device runs the kernels (C3 through `engine.sa_rows`, C4, C6); rng:
    the drand48 stream (Rand48(11) in bwa, bwtsw2_main.c:19), advanced
    past every draw.  host_reference=True runs the native whole-batch
    driver on `threads` host threads (0: one per core) instead."""
    parts = seconds
    reads = list(reads)
    if any(len(s) == 0 for _, s, _ in reads):
        raise ValueError("bwasw: a read of length 0")
    t0 = time.perf_counter()
    ctxs = [ReadCtx(opt, *r) for r in reads]
    parts["prep"] += time.perf_counter() - t0
    if host_reference:
        t0 = time.perf_counter()
        for R, (b, cigars) in zip(ctxs, _native_batch(index, reads, opt, rng,
                                                      threads)):
            R.hits, R.cigars = b, cigars
        parts["native"] += time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        todo = []
        for R in ctxs:
            if not R.has_amb:
                R.fill_strands(None)
                if R.l >= R.opt.t:
                    todo.append(R)
        parts["prep"] += time.perf_counter() - t0
        if todo:
            for R, b in zip(todo, _stage_a(index, engine, todo, False,
                                           parts)):
                R.pre = b
            rev = [R for R in todo
                   if any(h.n_seeds < opt.t_seeds for h in R.pre)]
            if rev:
                for R, b in zip(rev, _stage_a(index, engine, rev, True,
                                              parts)):
                    R.pre_rev = b
        _replay(index, engine, ctxs, opt, rng, parts)
        _cigars(index, engine, ctxs, opt, parts)
    t0 = time.perf_counter()
    out = "".join(print_hits(index.bns, R.opt, R.name, R.seq_str,
                             R.qual_str, R.hits, R.cigars) for R in ctxs)
    parts["emit"] += time.perf_counter() - t0
    return out.encode()
