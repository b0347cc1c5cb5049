"""Suffix array / BWT construction (host, offline): the port's copy of the
parts of nabwa_tpu/index/sa.py that `index.build`, the index tools of the
CLI (`pac2bwt`, `bwtupdate`, `bwt2sa`) and bwasw's per-read index
(`models/bwasw.py::Bwtl`) use.

Output parity with the reference's is_bwt (is.c:187-218) +
bwt_bwtupdate_core (bwtmisc.c:125-152) + bwt_cal_sa (bwt.c:48-70): the BWT
string, the checkpoint-interleaved .bwt layout and the sampled SA are
bit-identical.  The suffix array and the invPsi walk are the native
library's (SA-IS, native/sais.cpp; native/bwtwalk.cpp); there is no NumPy
fallback.
"""

import numpy as np

from ..constants import OCC_INTERVAL, SA_INTERVAL
from . import native


def suffix_array(codes):
    """Suffix array of codes (values 0..3), the shorter suffix smaller on
    prefix ties (nabwa_tpu/index/sa.py:15): the native SA-IS."""
    return native.suffix_array_native(codes)


def bwt_from_codes(codes):
    """(BWT string without `$`, primary, L2, SA_full): is_bwt semantics
    (is.c:204-218, nabwa_tpu/index/sa.py:56).  SA_full = [n] ++ SA(T);
    BWT row i is T[SA_full[i]-1]; the row whose suffix starts at 0 (the
    `$` row) is `primary` and is removed from the string."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    sa = native.suffix_array_native(codes)
    primary = int(np.flatnonzero(sa == 0)[0]) + 1  # +1: sentinel row
    sa_full = np.concatenate(([n], sa))
    rows = np.delete(sa_full, primary)  # drop the '$' row
    bwt = codes[rows - 1]
    counts = np.bincount(codes, minlength=4)[:4]
    l2 = np.zeros(5, dtype=np.uint32)
    l2[1:] = np.cumsum(counts)
    return bwt.astype(np.uint8), primary, l2, sa_full


def bwt_and_sample_from_codes(codes, sa_intv=SA_INTERVAL):
    """The BWT string and the sampled SA derived from the raw suffix array
    in chunks (no sa_full concatenation, no deleted-row copy)."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    if n == 0:
        raise ValueError("empty sequence")
    sa = native.suffix_array_native(codes)
    # row of the suffix starting at 0 (+1 for the sentinel row SA_full[0])
    primary = int(np.argmin(sa)) + 1
    bwt = np.empty(n, dtype=np.uint8)
    bwt[0] = codes[n - 1]      # sentinel row: char before suffix n
    CH = 1 << 26
    # sa_full = [n] ++ sa with the '$' row at `primary` dropped: rows
    # [1, primary) map to sa[0:primary-1], rows [primary, n) to sa[primary:]
    for lo in range(0, primary - 1, CH):
        hi = min(primary - 1, lo + CH)
        bwt[1 + lo:1 + hi] = codes[sa[lo:hi] - 1]
    for lo in range(primary, n, CH):
        hi = min(n, lo + CH)
        bwt[lo:hi] = codes[sa[lo:hi] - 1]
    counts = np.zeros(4, dtype=np.int64)
    for lo in range(0, n, CH):
        counts += np.bincount(codes[lo:lo + CH], minlength=4)[:4]
    l2 = np.zeros(5, dtype=np.uint32)
    l2[1:] = np.cumsum(counts)
    # sampled SA: sa_full[j*intv] = sa[j*intv - 1] for j >= 1 (bwt.c:48-70)
    n_sa = (n + sa_intv) // sa_intv
    samp = np.empty(n_sa, dtype=np.uint32)
    if n_sa > 1:
        idx = np.arange(1, n_sa, dtype=np.int64) * sa_intv - 1
        samp[1:] = sa[idx].astype(np.uint32)
    samp[0] = np.uint32(0xFFFFFFFF)
    return bwt, primary, l2, samp


def pack_bwt_words(bwt):
    """Pack BWT base codes into uint32 words, 16 bases per word, base i at
    bits (15 - i%16)*2 (bwtmisc.c:97-98), in chunks."""
    bwt = np.asarray(bwt)
    n = len(bwt)
    n_words = (n + 15) >> 4
    out = np.empty(n_words, dtype=np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    CH = 1 << 22    # words per chunk
    for w0 in range(0, n_words, CH):
        w1 = min(n_words, w0 + CH)
        seg = bwt[w0 * 16:w1 * 16]
        if len(seg) < (w1 - w0) * 16:
            seg = np.concatenate(
                [seg, np.zeros((w1 - w0) * 16 - len(seg), dtype=bwt.dtype)])
        q = seg.astype(np.uint32).reshape(-1, 16)
        out[w0:w1] = (q << shifts[None, :]).sum(axis=1, dtype=np.uint32)
    return out


def unpack_bwt_words(words, seq_len):
    """Inverse of `pack_bwt_words`: uint32 words -> base codes."""
    w = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    codes = ((w[:, None] >> shifts[None, :]) & 3).reshape(-1)
    return codes[:seq_len].astype(np.uint8)


def cal_sa_from_bwt(bwt_interleaved, primary, l2, seq_len,
                    intv=SA_INTERVAL):
    """bwt_cal_sa (bwt.c:48-70) on an interleaved-Occ BWT through the
    native invPsi walk; the sampled array with the leading -1 sentinel."""
    out = np.asarray(native.cal_sa_native(bwt_interleaved, primary, l2,
                                          seq_len, intv), dtype=np.uint32)
    out[0] = np.uint32(0xFFFFFFFF)
    return out


def interleave_occ(bwt_words, bwt, seq_len):
    """bwt_bwtupdate_core equivalent (bwtmisc.c:125-152): per 128-base
    block, 4 uint32 cumulative counts (occ before the block) then 8 uint32
    BWT words; a trailing 4-word checkpoint carries the final counts."""
    bwt = np.asarray(bwt, dtype=np.uint8)
    bwt_words = np.asarray(bwt_words, dtype=np.uint32)
    n_occ = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL + 1
    plain_words = (seq_len + 15) >> 4
    out_size = plain_words + n_occ * 4
    out = np.zeros(out_size, dtype=np.uint32)

    # cumulative counts of each base before each 128-bp block, in chunks
    n_blocks = n_occ - 1  # full/partial data blocks
    per = np.zeros((n_blocks, 4), dtype=np.uint32)
    BC = 1 << 20    # blocks per chunk
    for b0 in range(0, n_blocks, BC):
        b1 = min(n_blocks, b0 + BC)
        seg = bwt[b0 * OCC_INTERVAL:b1 * OCC_INTERVAL]
        want = (b1 - b0) * OCC_INTERVAL
        if len(seg) < want:
            seg = np.concatenate(
                [seg, np.full(want - len(seg), 255, dtype=np.uint8)])
        seg2 = seg.reshape(b1 - b0, OCC_INTERVAL)
        for c in range(4):
            per[b0:b1, c] = (seg2 == c).sum(axis=1, dtype=np.uint32)
    cum = np.zeros((n_blocks + 1, 4), dtype=np.uint32)
    np.cumsum(per, axis=0, out=cum[1:])
    del per

    # layout: [cnt4 | 8 words] per full block, partial tail words, final
    # checkpoint, written as array views
    n_full = plain_words >> 3
    main = out[:n_full * 12].reshape(n_full, 12) if n_full else \
        out[:0].reshape(0, 12)
    main[:, :4] = cum[:n_full]
    main[:, 4:] = bwt_words[:n_full * 8].reshape(-1, 8)
    k = n_full * 12
    r_words = plain_words - n_full * 8
    if r_words:
        out[k:k + 4] = cum[n_full]
        out[k + 4:k + 4 + r_words] = bwt_words[n_full * 8:]
        k += 4 + r_words
    out[k:k + 4] = cum[n_blocks]
    k += 4
    if k != out_size:
        raise AssertionError("inconsistent bwt_size")
    return out
