"""stdaln.c's parameters, its scalar banded global DP and the path helper:
the port's copy of nabwa_tpu/refmodel/stdaln_scalar.py (the traceback
types, MINOR_INF, the MAQ and BLAST score matrices, `AlnParam`,
`ALN_PARAM_BWA`, `aln_global_core` and `path2cigar32`).

`aln_global_core` (stdaln.c:345-525) is the banded 3-state affine-gap
global DP with a separate `gap_end` penalty for terminal gaps and the
M>=I, I>D traceback preference (set_M, stdaln.c:260-275).  It serves the
host tool `stdsw` (`models/stdsw.py`) and `refmodel/local_aln_scalar.py`
only; the pipelines' DP is `ops/dp.py` (kernel C4).
"""

import numpy as np

FROM_M, FROM_I, FROM_D, FROM_S = 0, 1, 2, 3
MINOR_INF = -1073741823

# score matrices (stdaln.c:206-220)
ALN_SM_MAQ = np.array([
    [11, -19, -19, -19, -13],
    [-19, 11, -19, -19, -13],
    [-19, -19, 11, -19, -13],
    [-19, -19, -19, 11, -13],
    [-13, -13, -13, -13, -13]], dtype=np.int64)

ALN_SM_BLAST = np.array([
    [1, -3, -3, -3, -2],
    [-3, 1, -3, -3, -2],
    [-3, -3, 1, -3, -2],
    [-3, -3, -3, 1, -2],
    [-2, -2, -2, -2, -2]], dtype=np.int64)


class AlnParam:
    def __init__(self, gap_open, gap_ext, gap_end, matrix, row, band_width):
        self.gap_open = gap_open
        self.gap_ext = gap_ext
        self.gap_end = gap_end
        self.matrix = matrix
        self.row = row
        self.band_width = band_width


# aln_param_bwa (stdaln.c:227)
ALN_PARAM_BWA = AlnParam(26, 9, 5, ALN_SM_MAQ, 5, 50)


def aln_global_core(seq1, seq2, ap):
    """Banded global alignment.  seq1 = reference window, seq2 = read (base
    codes, 4 = N).  Returns (score, path) where path is a list of
    (ctype, i, j) from the last cell back to origin — matching the C path
    array layout (stdaln.c:495-513).
    """
    len1, len2 = len(seq1), len(seq2)
    if len1 == 0 or len2 == 0:
        return 0, []
    go, ge, gend = ap.gap_open, ap.gap_ext, ap.gap_end
    b = ap.band_width
    mat = ap.matrix

    if len1 > len2:
        b1, b2 = len1 - len2 + b, b
    else:
        b1, b2 = b, len2 - len1 + b
    b1 = min(b1, len1)
    b2 = min(b2, len2)

    # 1-based sequences
    s1 = np.concatenate(([0], np.asarray(seq1, dtype=np.int64)))
    s2 = np.concatenate(([0], np.asarray(seq2, dtype=np.int64)))

    NEG = MINOR_INF
    # score rows (rolling) and full traceback matrix
    M = np.full((len2 + 1, len1 + 1), NEG, dtype=np.int64)
    I = np.full((len2 + 1, len1 + 1), NEG, dtype=np.int64)
    D = np.full((len2 + 1, len1 + 1), NEG, dtype=np.int64)
    Mt = np.zeros((len2 + 1, len1 + 1), dtype=np.int8)
    It = np.zeros((len2 + 1, len1 + 1), dtype=np.int8)
    Dt = np.zeros((len2 + 1, len1 + 1), dtype=np.int8)

    def set_m(j, i, sc):
        pm, pi, pd = M[j - 1, i - 1], I[j - 1, i - 1], D[j - 1, i - 1]
        if pm >= pi:
            if pm >= pd:
                M[j, i] = pm + sc
                Mt[j, i] = FROM_M
            else:
                M[j, i] = pd + sc
                Mt[j, i] = FROM_D
        else:
            if pi > pd:
                M[j, i] = pi + sc
                Mt[j, i] = FROM_I
            else:
                M[j, i] = pd + sc
                Mt[j, i] = FROM_D
        return M[j, i]

    def set_i(j, i, ext):
        # I comes from the row above, same column (consumes seq2)
        pm, pi = M[j - 1, i], I[j - 1, i]
        if pm - go > pi:
            It[j, i] = FROM_M
            I[j, i] = pm - go - ext
        else:
            It[j, i] = FROM_I
            I[j, i] = pi - ext

    def set_end_i(j, i):
        set_i(j, i, gend) if gend >= 0 else set_i(j, i, ge)

    def set_d(j, i, ext):
        pm, pd = M[j, i - 1], D[j, i - 1]
        if pm - go > pd:
            Dt[j, i] = FROM_M
            D[j, i] = pm - go - ext
        else:
            Dt[j, i] = FROM_D
            D[j, i] = pd - ext

    def set_end_d(j, i):
        set_d(j, i, gend) if gend >= 0 else set_d(j, i, ge)

    # first row (stdaln.c:393-399): only D filled for i in 1..b1-1
    M[0, 0] = 0
    for i in range(1, b1):
        set_end_d(0, i)

    # part 1: j = 1..min(b2, len2-1) (stdaln.c:402-420)
    tmp_end = b2 if b2 < len2 else len2 - 1
    j = 1
    while j <= tmp_end:
        set_end_i(j, 0)
        end = (j + b1 - 1) if (j + b1 <= len1 + 1) else len1
        for i in range(1, end):
            set_m(j, i, mat[s2[j], s1[i]])
            set_i(j, i, ge)
            set_d(j, i, ge)
        set_m(j, end, mat[s2[j], s1[end]])
        set_d(j, end, ge)
        if j + b1 - 1 > len1:
            set_end_i(j, end)
        j += 1

    # part-1 last-row variant (stdaln.c:422-440)
    if j == len2 and b2 != len2 - 1:
        set_end_i(j, 0)
        end = (j + b1 - 1) if (j + b1 <= len1 + 1) else len1
        for i in range(1, end):
            set_m(j, i, mat[s2[j], s1[i]])
            set_i(j, i, ge)
            set_end_d(j, i)
        set_m(j, end, mat[s2[j], s1[end]])
        set_end_d(j, end)
        if j + b1 - 1 > len1:
            set_end_i(j, end)
        j += 1

    # part 2 (stdaln.c:443-456)
    while j <= len2 - b2 + 1:
        end = j + b1 - 1
        for i in range(j - b2 + 1, end):
            set_m(j, i, mat[s2[j], s1[i]])
            set_i(j, i, ge)
            set_d(j, i, ge)
        set_m(j, end, mat[s2[j], s1[end]])
        set_d(j, end, ge)
        j += 1

    # part 3 (stdaln.c:459-471)
    while j < len2:
        for i in range(j - b2 + 1, len1):
            set_m(j, i, mat[s2[j], s1[i]])
            set_i(j, i, ge)
            set_d(j, i, ge)
        set_m(j, len1, mat[s2[j], s1[len1]])
        set_end_i(j, len1)
        set_d(j, len1, ge)
        j += 1

    # last row (stdaln.c:473-485)
    if j == len2:
        for i in range(j - b2 + 1, len1):
            set_m(j, i, mat[s2[j], s1[i]])
            set_i(j, i, ge)
            set_end_d(j, i)
        set_m(j, len1, mat[s2[j], s1[len1]])
        set_end_i(j, len1)
        set_end_d(j, len1)

    # backtrace (stdaln.c:487-514)
    i, jj = len1, len2
    mx, typ, ctype = M[jj, i], Mt[jj, i], FROM_M
    if I[jj, i] > mx:
        mx, typ, ctype = I[jj, i], It[jj, i], FROM_I
    if D[jj, i] > mx:
        mx, typ, ctype = D[jj, i], Dt[jj, i], FROM_D
    path = [(ctype, i, jj)]
    while i or jj:
        if ctype == FROM_M:
            i -= 1
            jj -= 1
        elif ctype == FROM_I:
            jj -= 1
        else:
            i -= 1
        ctype = typ
        if typ == FROM_M:
            typ = Mt[jj, i]
        elif typ == FROM_I:
            typ = It[jj, i]
        else:
            typ = Dt[jj, i]
        path.append((ctype, i, jj))
        if not (i or jj):
            break
    return int(mx), path[:-1]


def path2cigar32(path):
    """aln_path2cigar32 (stdaln.c:1009-1039): path (last-to-first) → list of
    (op, length) in reference order."""
    if not path:
        return []
    out = []
    for ctype, _, _ in reversed(path):
        if out and out[-1][0] == ctype:
            out[-1][1] += 1
        else:
            out.append([ctype, 1])
    return [(op, ln) for op, ln in out]
