"""Minimal BAM/BGZF I/O with the reference's semantics: the port's copy of
nabwa_tpu/io/bam.py.

Read side mirrors bamlite (bamlite.c:73-201): plain gzip-stream parsing of
the BAM container.  Write side mirrors the fork's bgzf.c usage: BGZF blocks
at compression level 2 ('w2', bam2bam.c:2063) with the standard EOF marker.
Records are kept exactly like bam1_t — a fixed core plus one mutable `data`
blob (qname|cigar|seq4|qual|aux) — so the record surgery of bam2bam.c
(revcom_bam1, tag pushers, cigar resize) ports one-to-one.
"""

import struct
import zlib

import numpy as np

# bam_nt16_nt4_table (bwaseqio.c:10)
NT16_NT4 = np.array([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4],
                    dtype=np.uint8)
NT16_STR = "=ACMGRSVTWYHKDBN"
# revcom1 (bam2bam.c:109-126): full 8-bit reversal swaps + complements both
# nt16 nybbles at once
REVCOM1 = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))

BAM_FPAIRED = 1
BAM_FUNMAP = 4
BAM_FREAD1 = 64
BAM_FREAD2 = 128

_CORE = struct.Struct("<iiIIiiii")  # tid,pos,(bin|qual|l_qname),(flag|n_cigar),l_qseq,mtid,mpos,isize


class BamRec:
    """bam1_t equivalent: core fields + raw data blob."""

    __slots__ = ("tid", "pos", "bin", "qual", "l_qname", "flag", "n_cigar",
                 "l_qseq", "mtid", "mpos", "isize", "data")

    def __init__(self):
        self.tid = self.pos = -1
        self.bin = self.qual = self.l_qname = 0
        self.flag = self.n_cigar = self.l_qseq = 0
        self.mtid = self.mpos = -1
        self.isize = 0
        self.data = bytearray()

    # --- data layout accessors (bamlite.h macros) ---
    @property
    def qname(self):
        return bytes(self.data[:self.l_qname - 1]).decode()

    def cigar_off(self):
        return self.l_qname

    def seq_off(self):
        return self.l_qname + 4 * self.n_cigar

    def qual_off(self):
        return self.seq_off() + (self.l_qseq + 1) // 2

    def aux_off(self):
        return self.qual_off() + self.l_qseq

    def cigar_list(self):
        off = self.cigar_off()
        out = []
        for i in range(self.n_cigar):
            (v,) = struct.unpack_from("<I", self.data, off + 4 * i)
            out.append((v & 0xF, v >> 4))
        return out

    def seq_nt4(self):
        """l_qseq nt4 codes from the 4-bit packed sequence."""
        off = self.seq_off()
        nb = (self.l_qseq + 1) // 2
        # zero-copy view of the record buffer (the unpack below copies)
        b = np.frombuffer(self.data, dtype=np.uint8, count=nb, offset=off)
        out = np.empty(nb * 2, dtype=np.uint8)
        out[0::2] = b >> 4
        out[1::2] = b & 0xF
        return NT16_NT4[out[:self.l_qseq]]

    def quals(self):
        off = self.qual_off()
        return np.frombuffer(self.data, dtype=np.uint8,
                             count=self.l_qseq, offset=off).copy()

    def get_rg(self):
        """bam_get_rg (bamlite.c:157-201)."""
        d = self.data
        p = self.aux_off()
        n = len(d)
        while p + 4 < n:
            if d[p] == ord("R") and d[p + 1] == ord("G"):
                if d[p + 2] == ord("Z"):
                    e = d.index(0, p + 3)
                    return bytes(d[p + 3:e]).decode()
                if d[p + 2] == ord("A"):
                    return chr(d[p + 3])
            p = _skip_tag(d, p)
        return ""

    def encode(self):
        y = (self.bin << 16) | (self.qual << 8) | self.l_qname
        z = (self.flag << 16) | self.n_cigar
        core = _CORE.pack(self.tid, self.pos, y, z, self.l_qseq,
                          self.mtid, self.mpos, self.isize)
        block = core + bytes(self.data)
        return struct.pack("<I", len(block)) + block

    # tuple state: the default __slots__ pickle walks a per-slot dict,
    # which dominated the coordinator's chunk serialization time in
    # distributed bam2bam (thousands of records per chunk payload)
    def __getstate__(self):
        return (self.tid, self.pos, self.bin, self.qual, self.l_qname,
                self.flag, self.n_cigar, self.l_qseq, self.mtid,
                self.mpos, self.isize, bytes(self.data))

    def __setstate__(self, st):
        (self.tid, self.pos, self.bin, self.qual, self.l_qname,
         self.flag, self.n_cigar, self.l_qseq, self.mtid, self.mpos,
         self.isize, d) = st
        self.data = bytearray(d)


def _skip_tag(d, p):
    """Advance past one aux tag starting at p (tag layout per SAM spec)."""
    t = d[p + 2]
    tu = t & ~0x20
    if tu in (ord("C"), ord("A")):
        return p + 4
    if tu == ord("S"):
        return p + 5
    if tu in (ord("I"), ord("F")):
        return p + 7
    if tu == ord("D"):
        return p + 11
    if tu in (ord("Z"), ord("H")):
        e = d.index(0, p + 3)
        return e + 1
    if tu == ord("B"):
        count = struct.unpack_from("<i", d, p + 4)[0]
        et = d[p + 3] & ~0x20
        esz = {ord("C"): 1, ord("A"): 1, ord("S"): 2, ord("I"): 4,
               ord("F"): 4, ord("D"): 8}[et]
        return p + 8 + esz * count
    raise ValueError(f"bad aux type {chr(t)}")


# ---------------------------------------------------------------------------
# BGZF / gzip containers
# ---------------------------------------------------------------------------

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class BgzfWriter:
    """BGZF writer at compression level 2 (bgzf.c via 'w2').

    Compression runs on a dedicated thread (async=True, the default):
    write() only appends to a buffer and hands full 64 KB blocks to the
    compressor queue — zlib releases the GIL, so the deflate work
    overlaps the caller's compute instead of serializing inside e.g.
    bam2bam's ordered writer lock.  Block boundaries (and therefore the
    output bytes) are identical to the synchronous path."""

    MAX_BLOCK = 0x10000 - 256  # conservative input per block

    def __init__(self, fileobj, level=2, use_async=True):
        self.f = fileobj
        self.level = level
        self.buf = bytearray()
        self._q = None
        if use_async:
            import queue
            import threading
            self._q = queue.Queue(maxsize=64)
            self._err = []
            self._t = threading.Thread(target=self._pump, daemon=True)
            self._t.start()

    def _pump(self):
        try:
            while True:
                chunk = self._q.get()
                if chunk is None:
                    return
                self.f.write(self._deflate(chunk))
        except Exception as e:
            self._err.append(e)
            while self._q.get() is not None:
                pass

    def _deflate(self, chunk):
        co = zlib.compressobj(self.level, zlib.DEFLATED, -15, 8)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 25 + 1  # header 12 + xtra 6 + crc 4 + isize 4
        xlen = 6
        hdr = struct.pack("<4BI2B2H2BH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF,
                          xlen, ord("B"), ord("C"), 2, bsize - 1)
        crc = zlib.crc32(chunk) & 0xFFFFFFFF
        return hdr + cdata + struct.pack("<II", crc, len(chunk))

    def write(self, data):
        self.buf += data
        while len(self.buf) >= self.MAX_BLOCK:
            self._flush_block(self.MAX_BLOCK)

    def _flush_block(self, n):
        chunk = bytes(self.buf[:n])
        del self.buf[:n]
        if self._q is not None:
            self._q.put(chunk)
        else:
            self.f.write(self._deflate(chunk))

    def close(self):
        while self.buf:
            self._flush_block(min(len(self.buf), self.MAX_BLOCK))
        if self._q is not None:
            self._q.put(None)
            self._t.join()
            if self._err:
                raise self._err[0]
        self.f.write(BGZF_EOF)


def bgzf_decompress(data):
    """Decompress a BGZF/gzip byte stream fully (multi-member aware).

    BGZF members carry their compressed size in the BC extra subfield
    (SAM spec 4.1), so the fast path walks the block table directly and
    decompresses exact slices on a small thread pool (zlib releases the
    GIL).  The old decompressobj loop re-sliced the whole remaining
    buffer per 64 KB member — O(n^2) memcpy, ~1 s on a 200k-record
    input.  Non-BGZF gzip falls back to the streaming loop."""
    n = len(data)
    blocks = []
    pos = 0
    while pos + 18 <= n:
        if data[pos:pos + 4] != b"\x1f\x8b\x08\x04":
            blocks = None
            break
        (xlen,) = struct.unpack_from("<H", data, pos + 10)
        bsize = None
        q, qend = pos + 12, pos + 12 + xlen
        while q + 4 <= qend:
            si1, si2, slen = data[q], data[q + 1], \
                struct.unpack_from("<H", data, q + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", data, q + 4)[0] + 1
                break
            q += 4 + slen
        if bsize is None or pos + bsize > n:
            blocks = None
            break
        blocks.append((pos, bsize))
        pos += bsize
    if blocks is not None and pos == n:
        def one(b):
            s, ln = b
            return zlib.decompress(data[s:s + ln], 31)
        if len(blocks) > 64:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(4) as ex:
                return b"".join(ex.map(one, blocks, chunksize=32))
        return b"".join(one(b) for b in blocks)
    out = bytearray()
    pos = 0
    while pos < len(data):
        d = zlib.decompressobj(31)
        out += d.decompress(data[pos:])
        rest = d.unused_data
        if not rest:
            break
        pos = len(data) - len(rest)
    return bytes(out)


# ---------------------------------------------------------------------------
# BAM container
# ---------------------------------------------------------------------------

class BamReader:
    """bamlite-equivalent reader over a fully-decompressed BAM byte string."""

    def __init__(self, path):
        with open(path, "rb") as f:
            raw = f.read()
        self.blob = bgzf_decompress(raw)
        assert self.blob[:4] == b"BAM\x01", "not a BAM file"
        (l_text,) = struct.unpack_from("<i", self.blob, 4)
        self.text = self.blob[8:8 + l_text].decode("latin1")
        p = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", self.blob, p)
        p += 4
        self.refs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", self.blob, p)
            p += 4
            name = self.blob[p:p + l_name - 1].decode()
            p += l_name
            (l_ref,) = struct.unpack_from("<i", self.blob, p)
            p += 4
            self.refs.append((name, l_ref))
        self.pos = p

    def read1(self):
        """bam_read1 (bamlite.c:125-155)."""
        if self.pos + 4 > len(self.blob):
            return None
        (block_len,) = struct.unpack_from("<i", self.blob, self.pos)
        p = self.pos + 4
        rec = BamRec()
        tid, bpos, y, z, l_qseq, mtid, mpos, isize = _CORE.unpack_from(
            self.blob, p)
        rec.tid = tid
        rec.pos = bpos
        rec.bin = y >> 16
        rec.qual = (y >> 8) & 0xFF
        rec.l_qname = y & 0xFF
        rec.flag = z >> 16
        rec.n_cigar = z & 0xFFFF
        rec.l_qseq = l_qseq
        rec.mtid = mtid
        rec.mpos = mpos
        rec.isize = isize
        data_len = block_len - 32
        rec.data = bytearray(self.blob[p + 32:p + 32 + data_len])
        self.pos = p + block_len
        return rec


def make_bam(path, refs, records, text="", level=2):
    """Write a BAM file (used to build test inputs and for bam2bam output).

    refs: [(name, length)]; records: iterable of BamRec.
    """
    with open(path, "wb") as f:
        w = BgzfWriter(f, level=level)
        payload = bytearray()
        payload += b"BAM\x01"
        t = text.encode("latin1")
        payload += struct.pack("<i", len(t)) + t
        payload += struct.pack("<i", len(refs))
        for name, ln in refs:
            nb = name.encode() + b"\x00"
            payload += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        w.write(bytes(payload))
        for rec in records:
            w.write(rec.encode())
        w.close()


def sam_to_bamrec(name, flag, tid, pos, mapq, cigar, mtid, mpos, isize, seq,
                  qual, tags=b""):
    """Build a BamRec from SAM-ish fields (test-input construction).

    seq: ASCII bases; qual: phred (0-based ints) or ASCII-33 string.
    """
    rec = BamRec()
    rec.flag = flag
    rec.tid = tid
    rec.pos = pos
    rec.qual = mapq
    rec.mtid = mtid
    rec.mpos = mpos
    rec.isize = isize
    rec.l_qseq = len(seq)
    qn = name.encode() + b"\x00"
    rec.l_qname = len(qn)
    rec.n_cigar = len(cigar)
    data = bytearray(qn)
    for op, ln in cigar:
        data += struct.pack("<I", (ln << 4) | op)
    nt16 = {c: NT16_STR.index(c) if c in NT16_STR else 15
            for c in "ACGTN=MRSVWYHKDB"}
    packed = bytearray()
    for i in range(0, len(seq), 2):
        hi = nt16.get(seq[i], 15) << 4
        lo = nt16.get(seq[i + 1], 15) if i + 1 < len(seq) else 0
        packed.append(hi | lo)
    data += packed
    if isinstance(qual, str):
        data += bytes(ord(c) - 33 for c in qual)
    else:
        data += bytes(qual)
    data += tags
    rec.data = data
    rec.bin = reg2bin(pos, pos + max(1, len(seq))) if tid >= 0 else 0
    return rec


def reg2bin(beg, end):
    """bam_reg2bin (bam2bam.c:324-333)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return 4681 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return 585 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return 73 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return 9 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return 1 + (beg >> 26)
    return 0
