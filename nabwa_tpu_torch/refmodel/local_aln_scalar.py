"""Scalar model of aln_local_core (stdaln.c:529-761) — banded local SW with
the packed h/e rows, the `f` freeze-across-zero-cells behaviour, the reverse
banded pass, and the bandwidth-doubling global-DP path recovery.  Exact
semantics (C array indices kept literally).  The port's copy of
nabwa_tpu/refmodel/local_aln_scalar.py, for the host tool `stdsw`
(`models/stdsw.py`); the pipelines' mate rescue runs `ops/dp.py`
(kernels C5 and C4).

C's eh[] packs (h << 16 | e); here split into eh_h/eh_e with the same
indices.  In the forward pass, eh[i-1] is written with (h of current row at
column i-1, e of current row at column i) — the offset storage the C pointer
walk produces.

The three phases are exposed separately (local_fwd / local_rev /
local_path), as in the JAX package.
"""

import numpy as np

from .stdaln_scalar import FROM_M, AlnParam, aln_global_core

LOCAL_OVERFLOW_THRESHOLD = 32000
LOCAL_OVERFLOW_REDUCE = 16000


def local_fwd(seq1, seq2, ap):
    """Forward full-width SW scan (stdaln.c:556-637).  Returns
    (score_f, end_i, end_j, suba) where suba[j] is row j's best cell
    (used for the suboptimal-score report)."""
    len1, len2 = len(seq1), len(seq2)
    q = ap.gap_open
    r = ap.gap_ext
    qr = q + r
    mat = ap.matrix

    s1 = np.concatenate(([0], np.asarray(seq1, dtype=np.int64)))
    s2 = np.concatenate(([0], np.asarray(seq2, dtype=np.int64)))
    prof = mat[:, s1]  # prof[c][i] = mat[c, seq1[i]] (1-based i)

    tmp_len = len1 + 1
    eh_h = [0] * tmp_len
    eh_e = [0] * tmp_len
    suba = [0] * (len2 + 1)

    # scores stay far below the C overflow threshold for short-read inputs;
    # the rebase path (stdaln.c:587-606) is therefore not modelled
    assert 11 * max(len2, 1) < LOCAL_OVERFLOW_THRESHOLD

    score_f = 0
    end_i = end_j = 0
    for j in range(1, len2 + 1):
        subo = 0
        last_h = f = 0
        sa_row = prof[s2[j]]
        for i in range(1, tmp_len):
            # s = eh + i - 1
            curr_h = eh_h[i - 1] + int(sa_row[i])
            if curr_h < 0:
                curr_h = 0
            if last_h > 0:
                f = f - r if f > last_h - q else last_h - qr
                if curr_h < f:
                    curr_h = f
            if eh_h[i] > qr:  # packed *(s+1) >= (qr+1)<<16
                curr_last_h = eh_h[i]
                e = eh_e[i - 1] - r if eh_e[i - 1] > curr_last_h - q \
                    else curr_last_h - qr
                if curr_h < e:
                    curr_h = e
                eh_h[i - 1] = last_h
                eh_e[i - 1] = e
            else:
                eh_h[i - 1] = last_h
                eh_e[i - 1] = 0
            last_h = curr_h
            if subo < curr_h:
                subo = curr_h
            if score_f < curr_h:
                score_f = curr_h
                end_i, end_j = i, j
        eh_h[tmp_len - 1] = last_h
        eh_e[tmp_len - 1] = 0
        suba[j] = subo
    return score_f, end_i, end_j, suba


def local_rev(seq1, seq2, ap, score_f, end_i, end_j):
    """Reverse banded pass (stdaln.c:639-696) locating the start cell.
    Returns (score_r, start_i, start_j) with score_r already reduced by
    the q+r the C seeds into the first cell, or None when end_i/end_j
    is 0 (no local match)."""
    if end_i == 0 or end_j == 0:
        return None
    len1 = len(seq1)
    q = ap.gap_open
    r = ap.gap_ext
    qr = q + r
    mat = ap.matrix
    max_score = int(mat.max())

    s1 = np.concatenate(([0], np.asarray(seq1, dtype=np.int64)))
    s2 = np.concatenate(([0], np.asarray(seq2, dtype=np.int64)))
    prof = mat[:, s1]

    eh_h = [0] * (len1 + 1)
    eh_e = [0] * (len1 + 1)
    score_r = int(mat[s1[end_i], s2[end_j]])
    start_i, start_j = end_i, end_j
    eh_h[end_i] = qr + score_r
    eh_e[end_i] = 0
    start = end_i - 1
    end = max(end_i - 3, 0)

    j = end_j - 1
    while j != 0:
        last_h = f = 0
        sa_row = prof[s2[j]]
        i = start
        broke = False
        while i != end:
            # s = eh + i + 1
            curr_h = eh_h[i + 1] + int(sa_row[i])
            if curr_h < 0:
                curr_h = 0
            if last_h > 0:
                f = f - r if f > last_h - q else last_h - qr
                if curr_h < f:
                    curr_h = f
            curr_last_h = eh_h[i]
            e = eh_e[i + 1] - r if eh_e[i + 1] > curr_last_h - q \
                else curr_last_h - qr
            if e < 0:
                e = 0
            if curr_h < e:
                curr_h = e
            eh_h[i + 1] = last_h
            eh_e[i + 1] = e
            last_h = curr_h
            if score_r < curr_h:
                score_r = curr_h
                start_i, start_j = i, j
                if score_r - qr == score_f:
                    broke = True
                    break
            i -= 1
        # the statement after the inner loop (stdaln.c:690) runs in both the
        # normal-exit and break cases, at the current s position
        eh_h[i + 1] = last_h
        eh_e[i + 1] = 0
        if broke:
            break
        # band boundaries (stdaln.c:692-695), using the current j
        if eh_h[start] <= qr:
            start -= 1
        if start <= 0:
            start = 0
        end = start_i - (start_j - j) - \
            (score_r + (start_j - j) * max_score) // r - 1
        if end <= 0:
            end = 0
        j -= 1
    return score_r - qr, start_i, start_j


def local_subo(suba, start_j, end_j, len2):
    """Suboptimal score outside the found segment (stdaln.c:707-716)."""
    tmp2 = 0
    tmp = int(start_j - .33 * (end_j - start_j) + .499)
    for jj in range(1, tmp + 1):
        tmp2 = max(tmp2, suba[jj])
    tmp = int(end_j + .33 * (end_j - start_j) + .499)
    for jj in range(tmp, len2 + 1):
        tmp2 = max(tmp2, suba[jj])
    return tmp2


def local_path(seq1, seq2, ap, score_f, score_r, start_i, start_j,
               end_i, end_j, global_core=None):
    """Bandwidth-doubling global DP for the path (stdaln.c:723-745).
    Returns (score, path) or (-1, None) when no band reproduces the
    score.  `global_core(s1, s2, ap)` defaults to the scalar kernel."""
    gc = global_core or aln_global_core
    jmax = max(end_i - start_i, end_j - start_j) + 1
    i_band = ap.band_width
    while True:
        ap_real = AlnParam(ap.gap_open, ap.gap_ext, -1, ap.matrix,
                           ap.row, i_band)
        score_g, path = gc(np.asarray(seq1)[start_i - 1:end_i],
                           np.asarray(seq2)[start_j - 1:end_j], ap_real)
        if score_g == score_r or score_f == score_g:
            break
        if i_band > jmax:
            break
        i_band <<= 1
    if score_r > score_g and score_f > score_g:
        return -1, None
    path = [(ct, i + start_i - 1, j + start_j - 1) for ct, i, j in path]
    return score_g, path


def aln_local_core(seq1, seq2, ap, _thres=1, want_subo=False):
    """Returns (score, path, subo).  path is last-to-first [(ctype, i, j)]
    from the global re-alignment (only when _thres > 0), or None when below
    threshold / no local match.
    """
    len1, len2 = len(seq1), len(seq2)
    if len1 == 0 or len2 == 0:
        return -1, None, 0
    thres = _thres if _thres > 0 else -_thres

    score_f, end_i, end_j, suba = local_fwd(seq1, seq2, ap)
    if score_f < thres:
        return score_f, None, 0

    rev = local_rev(seq1, seq2, ap, score_f, end_i, end_j)
    if rev is None:
        return score_f, None, 0
    score_r, start_i, start_j = rev

    subo_out = local_subo(suba, start_j, end_j, len2) if want_subo else 0

    if _thres > 0:
        score, path = local_path(seq1, seq2, ap, score_f, score_r,
                                 start_i, start_j, end_i, end_j)
        if path is None:
            return -1, None, subo_out
        return score, path, subo_out
    return score_f, [(FROM_M, end_i, end_j), (FROM_M, start_i, start_j)], \
        subo_out
