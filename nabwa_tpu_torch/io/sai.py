""".sai stream format, bit-compatible with the reference: the port's copy of
the readers and the block writer of nabwa_tpu/io/sai.py.

Layout (bwtaln.c:387,242-246): one raw gap_opt_t (64 B), then per read an
int32 n_aln followed by n_aln × bwt_aln1_t records.  bwt_aln1_t
(bwtaln.h:41-45) is 16 B: u32 bitfield (n_mm | n_gapo<<8 | n_gape<<16 |
a<<24), u32 k, u32 l, i32 score.
"""

import struct

import numpy as np

from ..index import native
from ..options import GAP_OPT_SIZE, GapOpt

ALN_DTYPE = np.dtype([("meta", "<u4"), ("k", "<u4"), ("l", "<u4"),
                      ("score", "<i4")])

# aln-record tuple layout
A_NMM, A_NGO, A_NGE, A_A, A_K, A_L, A_SCORE = range(7)


def _columns(recs):
    meta = recs["meta"].astype(np.int64)
    return ((meta & 0xFF).tolist(), ((meta >> 8) & 0xFF).tolist(),
            ((meta >> 16) & 0xFF).tolist(), ((meta >> 24) & 1).tolist(),
            recs["k"].astype(np.int64).tolist(),
            recs["l"].astype(np.int64).tolist(),
            recs["score"].astype(np.int64).tolist())


def aln_records_to_tuples(recs):
    """One read's records → list of (n_mm, n_gapo, n_gape, a, k, l, score)."""
    if not len(recs):
        return []
    return list(zip(*_columns(recs)))


def pack_aln_block(per_read_alns):
    """Serialize a chunk of per-read tuple lists to the .sai record stream
    (n_aln + records per read)."""
    lens = [len(a) for a in per_read_alns]
    total = sum(lens)
    flat = [h for alns in per_read_alns for h in alns]
    recs = np.zeros(total, dtype=ALN_DTYPE)
    if total:
        cols = np.array(flat, dtype=np.int64).T
        recs["meta"] = ((cols[A_NMM] & 0xFF) | ((cols[A_NGO] & 0xFF) << 8)
                        | ((cols[A_NGE] & 0xFF) << 16)
                        | ((cols[A_A] & 1) << 24)).astype(np.uint32)
        recs["k"] = cols[A_K].astype(np.uint32)
        recs["l"] = cols[A_L].astype(np.uint32)
        recs["score"] = cols[A_SCORE].astype(np.int32)
    # interleave: per read an i32 count then its 16 B records
    out = bytearray()
    rb = recs.tobytes()
    pos = 0
    for n in lens:
        out += struct.pack("<i", n)
        if n:
            out += rb[pos:pos + 16 * n]
            pos += 16 * n
    return bytes(out)


class AlnColumn:
    """Columnar .sai chunk: the raw u32 record words (the bwt_aln1_t stream
    is the native kernels' record layout) + per-read counts.  Indexing
    materializes per-read tuple lists lazily."""

    __slots__ = ("recs", "counts", "off", "lo", "hi")

    def __init__(self, recs, counts, off=None, lo=0, hi=None):
        self.recs = recs            # u32 [4*total], 4 words per record
        self.counts = counts        # i32 [n]
        if off is None:
            off = np.zeros(len(counts) + 1, dtype=np.int64)
            np.cumsum(counts, out=off[1:])
        self.off = off
        self.lo = lo
        self.hi = len(counts) if hi is None else hi

    def __len__(self):
        return self.hi - self.lo

    def columns(self):
        """(recs u32 flat rebased to this window, counts i32)."""
        a, b = int(self.off[self.lo]), int(self.off[self.hi])
        return (np.ascontiguousarray(self.recs[4 * a:4 * b]),
                np.ascontiguousarray(self.counts[self.lo:self.hi]))

    def __getitem__(self, i):
        if isinstance(i, slice):
            a, b, step = i.indices(len(self))
            assert step == 1
            return AlnColumn(self.recs, self.counts, self.off,
                             self.lo + a, self.lo + b)
        if i < 0:
            i += len(self)
        j = self.lo + i
        a, b = int(self.off[j]), int(self.off[j + 1])
        if a == b:
            return []
        return aln_records_to_tuples(
            self.recs[4 * a:4 * b].view(ALN_DTYPE))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def read_sai_columnar(path):
    """Native one-pass .sai scan -> (GapOpt, AlnColumn), or (opt, None)
    when the scan rejects the stream (the caller then uses the tuple
    reader)."""
    with open(path, "rb") as f:
        data = f.read()
    opt = GapOpt.unpack(data[:GAP_OPT_SIZE])
    body = np.frombuffer(data, dtype=np.uint8, offset=GAP_OPT_SIZE)
    max_reads = len(body) // 4 + 1
    counts = np.zeros(max_reads, dtype=np.int32)
    recs = np.empty(len(body), dtype=np.uint8)
    n = native.lib().sai_scan(body, len(body), max_reads, counts, recs,
                              len(recs))
    if n < 0:
        return opt, None
    total = int(counts[:n].astype(np.int64).sum())
    return opt, AlnColumn(
        np.ascontiguousarray(recs[:16 * total]).view(np.uint32),
        counts[:n])


def read_sai_tuples(path):
    """Returns (GapOpt, list of per-read aln-tuple lists) with one flat
    record pass."""
    with open(path, "rb") as f:
        data = f.read()
    opt = GapOpt.unpack(data[:GAP_OPT_SIZE])
    pos = GAP_OPT_SIZE
    counts = []
    parts = []
    unpack = struct.unpack_from
    while pos < len(data):
        (n,) = unpack("<i", data, pos)
        pos += 4
        counts.append(n)
        if n:
            parts.append(data[pos:pos + 16 * n])
            pos += 16 * n
    flat = np.frombuffer(b"".join(parts), dtype=ALN_DTYPE)
    tuples = list(zip(*_columns(flat))) if len(flat) else []
    out = []
    p = 0
    for n in counts:
        out.append(tuples[p:p + n])
        p += n
    return opt, out
