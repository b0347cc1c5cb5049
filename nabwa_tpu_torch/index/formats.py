""".bwt / .sa binary file formats, bit-compatible with the reference
(bwt_dump_bwt / bwt_dump_sa / restore, bwtio.c:17-37,147-217): the port's
copy of nabwa_tpu/index/formats.py."""

import numpy as np

from ..constants import OCC_INTERVAL, SA_INTERVAL


def write_bwt(path, primary, l2, bwt_interleaved):
    """.bwt = primary u32, L2[1..4] u32, interleaved words (bwtio.c:17-25)."""
    with open(path, "wb") as f:
        np.asarray([primary], dtype=np.uint32).tofile(f)
        np.asarray(l2[1:5], dtype=np.uint32).tofile(f)
        np.asarray(bwt_interleaved, dtype=np.uint32).tofile(f)


def read_bwt(path):
    """Returns (primary, l2[5], bwt_interleaved, seq_len); the words are a
    read-only memmap view, paged in as the search touches them."""
    raw = np.memmap(path, dtype=np.uint32, mode="r")
    primary = int(raw[0])
    l2 = np.zeros(5, dtype=np.uint32)
    l2[1:] = raw[1:5]
    bwt = raw[5:]
    seq_len = int(l2[4])
    # bwt_restore_bwt's size reconstruction
    n_occ = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL + 1
    expect = ((seq_len + 15) >> 4) + 4 * n_occ
    if len(bwt) != expect:
        raise ValueError(f"{path}: {len(bwt)} words, expected {expect}")
    return primary, l2, bwt, seq_len


def write_plain_bwt(path, primary, l2, words):
    """Pre-bwtupdate .bwt: primary, L2[1..4], (seq_len+15)>>4 plain 2-bit
    words, what `pac2bwt` writes before `bwtupdate` interleaves the Occ
    checkpoints (bwtmisc.c:119, bwt_dump_bwt bwtio.c:17-25)."""
    with open(path, "wb") as f:
        np.asarray([primary], dtype=np.uint32).tofile(f)
        np.asarray(l2[1:5], dtype=np.uint32).tofile(f)
        np.asarray(words, dtype=np.uint32).tofile(f)


def read_plain_bwt(path):
    """Returns (primary, l2[5], plain_words, seq_len)."""
    raw = np.fromfile(path, dtype=np.uint32)
    primary = int(raw[0])
    l2 = np.zeros(5, dtype=np.uint32)
    l2[1:] = raw[1:5]
    words = raw[5:].copy()
    seq_len = int(l2[4])
    if len(words) != (seq_len + 15) >> 4:
        raise ValueError(f"{path}: {len(words)} words, expected "
                         f"{(seq_len + 15) >> 4}")
    return primary, l2, words, seq_len


def write_sa(path, primary, l2, sa, seq_len, sa_intv=SA_INTERVAL):
    """.sa = primary, L2[1..4], sa_intv, seq_len, sa[1:] (bwtio.c:27-37)."""
    with open(path, "wb") as f:
        np.asarray([primary], dtype=np.uint32).tofile(f)
        np.asarray(l2[1:5], dtype=np.uint32).tofile(f)
        np.asarray([sa_intv, seq_len], dtype=np.uint32).tofile(f)
        np.asarray(sa[1:], dtype=np.uint32).tofile(f)


def read_sa(path):
    """Returns (sampled SA with the leading -1, sa_intv, primary, seq_len),
    checking the header like bwt_restore_sa (bwtio.c:79-87)."""
    raw = np.memmap(path, dtype=np.uint32, mode="r")
    sa_intv = int(raw[5])
    seq_len = int(raw[6])
    n_sa = (seq_len + sa_intv) // sa_intv
    body = raw[7:]
    if len(body) != n_sa - 1:
        raise ValueError(f"{path}: {len(body)} samples, expected {n_sa - 1}")
    sa = np.empty(n_sa, dtype=np.uint32)
    sa[0] = np.uint32(0xFFFFFFFF)
    sa[1:] = body
    return sa, sa_intv, int(raw[0]), seq_len
