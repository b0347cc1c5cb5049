"""Color-space → nucleotide decoding (cs2nt.c) for SOLiD reads: the port's
copy of nabwa_tpu/refmodel/cs2nt.py (`NTNT2CS`, `cs2nt_dp`,
`cs2nt_nt_qual`, `cs2nt_core`), the plain reference, and `cs2nt_batch`,
the columnar form the port's samse and sampe run.

After a color read is aligned against the color-space index, the decoded
nucleotide sequence is recovered by a tiny 4-state DP over the aligned
columns (cs2nt_DP, cs2nt.c:36-78): state = nucleotide at position k,
penalty COLOR_MM(19)-or-quality per color mismatch and NUCL_MM(25) per
reference mismatch, so two consistent color changes are preferred over
one nt change unless the color quality is high.  New base qualities come
from the two flanking color matches (cs2nt_nt_qual, cs2nt.c:80-110).

cs2nt_core mirrors bwa_cs2nt_core (cs2nt.c:113-191) on SeqState/Read,
minding this package's orientation conventions: Read.seq holds the
reversed search-form codes (C's pre-refine p->seq), Read.rseq the
forward-oriented reverse complement, Read.qual the original-orientation
ASCII qualities.

cs2nt_batch runs the same decode over many rows at once: the rows'
columns are laid out in [rows, columns] matrices, and the DP steps column
by column over a [rows, 4, 4] score cube, each row masked past its own
length; the backtrace and the qualities are vectorised the same way.
"""

import numpy as np

from ..constants import BWA_TYPE_NO_MATCH
from .stdaln_scalar import FROM_I, FROM_M, FROM_S

COLOR_MM = 19
NUCL_MM = 25

# nst_ntnt2cs_table (cs2nt.c:27)
NTNT2CS = np.array([4, 0, 0, 1, 0, 2, 3, 4, 0, 3, 2, 4, 1, 4, 4, 4],
                   dtype=np.int64)


def cs2nt_dp(nt_ref, cs_read):
    """cs2nt_DP (cs2nt.c:36-78).  nt_ref: int[size+1] codes 0..4;
    cs_read: int[size] packed color<<6|qual (qual 63 = N).  Returns
    nt_read int[size+1]."""
    size = len(cs_read)
    h = np.zeros(8, dtype=np.int64)
    bt = np.zeros((size + 1, 4), dtype=np.int8)
    if nt_ref[0] >= 4:
        h[:4] = 0
    else:
        h[:4] = NUCL_MM
        h[nt_ref[0]] = 0
    curr, last = 1, 0
    for k in range(1, size + 1):
        q = int(cs_read[k - 1]) & 0x3F
        col = int(cs_read[k - 1]) >> 6
        pen_c = COLOR_MM if q < COLOR_MM else q
        refk = int(nt_ref[k])
        for x in range(4):
            mn, ymin = 0x7FFFFFFF, 0
            for y in range(4):
                s = int(h[(last << 2) | y])
                if q != 63 and col != NTNT2CS[(1 << x) | (1 << y)]:
                    s += pen_c
                if refk < 4 and refk != x:
                    s += NUCL_MM
                if s < mn:
                    mn, ymin = s, y
            h[(curr << 2) | x] = mn
            bt[k, x] = ymin
        last, curr = curr, 1 - curr
    nt = np.zeros(size + 1, dtype=np.uint8)
    hmin, xmin = 0x7FFFFFFF, 0
    for x in range(4):
        if h[(last << 2) | x] < hmin:
            hmin, xmin = int(h[(last << 2) | x]), x
    nt[size] = xmin
    for k in range(size - 1, -1, -1):
        nt[k] = bt[k + 1, nt[k + 1]]
    return nt


def cs2nt_nt_qual(nt_read, cs_read):
    """cs2nt_nt_qual (cs2nt.c:80-110).  Returns packed base<<6|qual array
    of length size-1 (positions 1..size-1 of nt_read)."""
    size = len(cs_read)
    t = np.zeros(size, dtype=np.int64)
    c1 = int(nt_read[0])
    for k in range(1, size + 1):
        c2 = int(nt_read[k])
        t[k - 1] = 4 if (c1 >= 4 or c2 >= 4) \
            else int(NTNT2CS[(1 << c1) | (1 << c2)])
        c1 = c2
    out = np.zeros(size + 1, dtype=np.int64)
    for k in range(1, size):
        qk = int(cs_read[k]) & 0x3F
        qk1 = int(cs_read[k - 1]) & 0x3F
        if t[k - 1] == cs_read[k - 1] >> 6 and t[k] == cs_read[k] >> 6:
            q = qk1 + qk + 10
        elif t[k - 1] == cs_read[k - 1] >> 6:
            q = qk1 - qk
        elif t[k] == cs_read[k] >> 6:
            q = qk - qk1
        else:
            q = 0
        q = max(0, min(60, q))
        out[k] = (int(nt_read[k]) << 6) | q
        if qk1 == 63 or qk == 63:
            out[k] = 0
    return out[1:size]


def cs2nt_core(s, l_pac, ntpac):
    """bwa_cs2nt_core (cs2nt.c:113-191) on a SeqState.  ntpac: unpacked
    nucleotide pac codes.  Rewrites the read's seq/rseq/qual in place
    with the decoded nucleotides and shortens len by one."""
    if s.type == BWA_TYPE_NO_MATCH:
        return
    r = s.read
    # the strand-of-reference-forward color read (C's post-refine seq)
    seq = r.rseq if s.strand else r.seq[::-1]
    qual = r.qual
    L = s.len

    def csbase(i):
        q = int(qual[L - 1 - i if s.strand else i]) - 33
        if q > 60:
            q = 60
        if seq[i] > 3:
            q = 63
        return (int(seq[i]) << 6) | q

    nt_ref = [4 if s.pos == 0 else int(ntpac[s.pos - 1])]
    cs_read = []
    if not s.cigar:
        for i in range(L):
            cs_read.append(csbase(i))
            nt_ref.append(int(ntpac[s.pos + i])
                          if s.pos + i < l_pac else 4)
    else:
        x, y = s.pos, 0
        for op, ln in s.cigar:
            if op == FROM_M:
                for _ in range(ln):
                    cs_read.append(csbase(y))
                    nt_ref.append(int(ntpac[x]) if x < l_pac else 4)
                    x += 1
                    y += 1
            elif op == FROM_I:
                for _ in range(ln):
                    cs_read.append(csbase(y))
                    nt_ref.append(4)
                    y += 1
            elif op == FROM_S:
                y += ln
            else:
                x += ln
    nt_ref = np.asarray(nt_ref, dtype=np.int64)
    cs_read = np.asarray(cs_read, dtype=np.int64)
    size = len(cs_read)

    nt_read = cs2nt_dp(nt_ref, cs_read)
    packed = cs2nt_nt_qual(nt_read, cs_read)

    n = size - 1
    dec = np.empty(n, dtype=np.uint8)      # decoded, ref-forward
    dq = np.empty(n, dtype=np.uint8)       # new quals, ref-forward ascii
    for i in range(n):
        if (packed[i] & 0x3F) == 63:
            dq[i] = 33
            dec[i] = 4
        else:
            dq[i] = (packed[i] & 0x3F) + 33
            dec[i] = packed[i] >> 6
    comp = np.where(dec < 4, 3 - dec, dec).astype(np.uint8)
    if s.strand:
        # rseq := decoded; seq := reversed(revcomp(decoded)) = comp(dec)
        r.rseq = dec
        r.seq = comp
        r.qual = dq[::-1].copy()
    else:
        r.seq = dec[::-1].copy()
        r.rseq = comp[::-1].copy()
        r.qual = dq
    r.full_len = n
    # the print path reads full_codes (original orientation, C prints
    # p->seq over full_len) — now the decoded nucleotides
    r.full_codes = r.seq[::-1].copy()
    s.len = n


# --- the columnar form ---

# colour of each (x, y) nucleotide pair, [4, 4]
_PAIR_COLOUR = NTNT2CS[(1 << np.arange(4)[:, None]) | (1 << np.arange(4))]
# rows a block of the lockstep DP takes at most
BLOCK_ROWS = 4096


def _cigar_columns(cigar, pos):
    """The aligned columns of one gapped row, as cs2nt_core walks its
    cigar: (read index, reference position or -1) for every M and I
    column; S skips the read, D the reference."""
    ys, xs = [], []
    x, y = pos, 0
    for op, ln in cigar:
        if op == FROM_M:
            ys.append(np.arange(y, y + ln))
            xs.append(np.arange(x, x + ln))
            x += ln
            y += ln
        elif op == FROM_I:
            ys.append(np.arange(y, y + ln))
            xs.append(np.full(ln, -1))
            y += ln
        elif op == FROM_S:
            y += ln
        else:
            x += ln
    if not ys:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    return (np.concatenate(ys).astype(np.int64),
            np.concatenate(xs).astype(np.int64))


def _dp_block(cs, nt_ref, size):
    """cs2nt_dp and cs2nt_nt_qual on a block of rows in lockstep.  cs:
    [R, S] packed colour<<6|qual; nt_ref: [R, S+1]; size: [R] each row's
    columns (S at most).  Returns the packed base<<6|qual of positions
    1..size-1, [R, S-1] (past a row's size-1 the values are junk)."""
    R, S = cs.shape
    rows = np.arange(R)
    q = cs & 0x3F
    col = cs >> 6
    # each column's penalty of (x, y): the colour's (0 where its quality
    # is 63, an N) where the pair's colour is not the read's, and the
    # reference's where x is not its base; a column adds at most 60 + 25,
    # so short reads score in 16 bits
    dt = np.int16 if (60 + NUCL_MM) * (S + 1) < 2 ** 15 else np.int32
    pen_c = np.where(q == 63, 0, np.where(q < COLOR_MM, COLOR_MM, q)) \
        .astype(dt).T
    # off[c, y, x] marks the (x, y) pairs whose colour is not c
    off = (np.arange(5)[:, None, None] != _PAIR_COLOUR.T).astype(dt)
    x4 = np.arange(4)
    ref = nt_ref[:, 1:].T[:, None, :, None]
    pen = off[col.T].transpose(0, 2, 1, 3) * pen_c[:, None, :, None]
    pen += np.where((ref < 4) & (ref != x4), dt(NUCL_MM),
                    dt(0))                                 # [S, y, R, x]
    ref0 = nt_ref[:, :1]
    h = np.where(ref0 >= 4, 0, np.where(x4 == ref0, 0, NUCL_MM)).astype(dt)
    bt = np.zeros((S + 1, R, 4), dtype=np.int8)
    for k in range(1, S + 1):
        pk = pen[k - 1]
        # the first y of the least score, as `s < mn` takes it
        mn = h[:, 0, None] + pk[0]
        ymin = np.zeros((R, 4), dtype=np.int8)
        for y in (1, 2, 3):
            sy = h[:, y, None] + pk[y]
            ymin = np.where(sy < mn, np.int8(y), ymin)
            np.minimum(mn, sy, out=mn)
        live = (k <= size)[:, None]
        h = np.where(live, mn, h)
        bt[k] = ymin
    nt = np.zeros((S + 1, R), dtype=np.int64)
    nt[size, rows] = h.argmin(axis=1)
    for k in range(S - 1, -1, -1):
        back = bt[k + 1, rows, nt[k + 1]]
        nt[k] = np.where(k < size, back, nt[k])
    nt = nt.T
    # cs2nt_nt_qual: t[k - 1] is the colour of nt[k - 1], nt[k]
    t = np.where((nt[:, :-1] >= 4) | (nt[:, 1:] >= 4), 4,
                 NTNT2CS[(1 << np.minimum(nt[:, :-1], 3))
                         | (1 << np.minimum(nt[:, 1:], 3))])
    m_prev = t[:, :-1] == col[:, :-1]       # k = 1..S-1: t[k-1] matches
    m_here = t[:, 1:] == col[:, 1:]         # t[k] matches
    qk1, qk = q[:, :-1], q[:, 1:]
    qual = np.where(m_prev & m_here, qk1 + qk + 10,
                    np.where(m_prev, qk1 - qk,
                             np.where(m_here, qk - qk1, 0)))
    qual = np.clip(qual, 0, 60)
    out = (nt[:, 1:S] << 6) | qual
    return np.where((qk1 == 63) | (qk == 63), 0, out)


def cs2nt_batch(codes, quals, off, strand, pos, cigars, l_pac, ntpac):
    """bwa_cs2nt_core over many matched rows at once, equal to
    `cs2nt_core` on every row.

    codes, quals, off: each row's colour codes and ASCII qualities over
    its clipped length, in the read's own orientation (`r.seq[::-1]` and
    `r.qual`), flat with offsets; strand, pos: the rows' hits; cigars: one
    cigar (a list of (op, len)) or None a row.  Ungapped rows take their
    reference from one gather of the `.nt` pac; gapped rows from their
    cigars.  Returns (dec, dq, doff): each row's decoded nucleotide codes
    and ASCII qualities, reference-forward, flat with offsets (a row of
    `size` aligned columns decodes to size - 1)."""
    R = len(strand)
    off = np.asarray(off, dtype=np.int64)
    strand = np.asarray(strand, dtype=bool)
    pos = np.asarray(pos, dtype=np.int64)
    L = off[1:] - off[:-1]
    size = L.copy()
    gapped = {}
    for r in range(R):
        if cigars[r]:
            gapped[r] = _cigar_columns(cigars[r], int(pos[r]))
            size[r] = len(gapped[r][0])
    n_out = np.maximum(size - 1, 0)
    doff = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(n_out, out=doff[1:])
    dec = np.zeros(int(doff[-1]), dtype=np.uint8)
    dq = np.zeros(int(doff[-1]), dtype=np.uint8)
    codes = np.asarray(codes, dtype=np.int64)
    quals = np.asarray(quals, dtype=np.int64)
    order = np.argsort(size, kind="stable")
    for b in range(0, R, BLOCK_ROWS):
        blk = order[b:b + BLOCK_ROWS]
        S = max(int(size[blk].max()), 1)
        j = np.arange(S)
        # the read index (reference-forward) and reference position of
        # each column; ungapped rows first, gapped rows from their cigars
        ys = np.broadcast_to(j, (len(blk), S)).copy()
        xs = pos[blk, None] + j
        for i, r in enumerate(blk.tolist()):
            if r in gapped:
                y, x = gapped[r]
                ys[i, :len(y)] = y
                xs[i, :len(x)] = x
        live = j < size[blk, None]
        Lb = L[blk, None]
        ri = np.where(strand[blk, None], Lb - 1 - ys, ys)
        fi = off[blk, None] + np.clip(ri, 0, np.maximum(Lb - 1, 0))
        fi = np.where(live & (Lb > 0), fi, 0)
        c = codes[fi] if len(codes) else np.zeros_like(fi)
        qv = np.minimum((quals[fi] if len(quals) else fi) - 33, 60)
        qv = np.where(c > 3, 63, qv)
        cs = np.where(live, (c << 6) | qv, 0)
        nt_ref = np.full((len(blk), S + 1), 4, dtype=np.int64)
        p0 = pos[blk]
        nt_ref[:, 0] = np.where(p0 == 0, 4,
                                ntpac[np.clip(p0 - 1, 0, l_pac - 1)])
        inref = live & (xs >= 0) & (xs < l_pac)
        nt_ref[:, 1:] = np.where(inref, ntpac[np.where(inref, xs, 0)], 4)
        packed = _dp_block(cs, nt_ref, size[blk])
        # rows of size - 1 decoded positions, in row order of the block
        n_blk = n_out[blk]
        keep = np.arange(S - 1) < n_blk[:, None]
        dst = (doff[blk, None] + np.arange(S - 1))[keep]
        pk = packed[keep]
        nq = (pk & 0x3F) == 63
        dec[dst] = np.where(nq, 4, pk >> 6)
        dq[dst] = np.where(nq, 33, (pk & 0x3F) + 33)
    return dec, dq, doff
