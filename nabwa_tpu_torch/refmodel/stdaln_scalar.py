"""stdaln.c's parameters and path helpers: the port's copy of the names of
nabwa_tpu/refmodel/stdaln_scalar.py that the port uses (the traceback
types, MINOR_INF, the MAQ score matrix, `AlnParam`, `ALN_PARAM_BWA` and
`path2cigar32`).  The scalar DP itself is not copied: the port's DP is
`ops/dp.py`, held against the JAX package in the tests."""

import numpy as np

FROM_M, FROM_I, FROM_D, FROM_S = 0, 1, 2, 3
MINOR_INF = -1073741823

# score matrix (stdaln.c:206-220)
ALN_SM_MAQ = np.array([
    [11, -19, -19, -19, -13],
    [-19, 11, -19, -19, -13],
    [-19, -19, 11, -19, -13],
    [-19, -19, -19, 11, -13],
    [-13, -13, -13, -13, -13]], dtype=np.int64)


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
