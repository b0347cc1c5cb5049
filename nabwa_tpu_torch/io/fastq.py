"""FASTQ/FASTA read input with the reference's exact preparation semantics
(bwa_read_seq, bwaseqio.c:181-251): the port's copy of
nabwa_tpu/io/fastq.py, without BAM input (`read_bam_batch`).

- base → nt4 code via nst_nt4_table
- optional Illumina-1.3 qual shift (-I), Casava filter (-Y), barcode split
  (-B), BWA-style quality trimming (-q)
- `seq`  = REVERSED read codes (searched on the reverse BWT)
- `rseq` = reversed complement (complement iff BWA_MODE_COMPREAD)
- read names lose a trailing /1 or /2
"""

import dataclasses
import gzip

import numpy as np

from ..constants import (BWA_MODE_COMPREAD, BWA_MODE_IL13, BWA_MODE_CFY,
                         BWA_MIN_RDLEN, BWA_MAX_BCLEN)
from ..index import native
from ..index.pack import NT4

BARCODE_LOW_QUAL = 13  # bwaseqio.c:179


@dataclasses.dataclass
class Read:
    name: str
    seq: np.ndarray      # reversed nt4 codes, trimmed length (len,)
    rseq: np.ndarray     # reversed (complemented) codes, trimmed length
    qual: np.ndarray     # ascii quals (phred+33), ORIGINAL orientation, or None
    full_len: int
    clip_len: int
    full_codes: np.ndarray = None   # untrimmed nt4 codes, original orientation
    bc: str = ""

    @property
    def len(self):
        return len(self.seq)

    # compact pickle: four small-ndarray pickles per read dominated the
    # distributed coordinator's pass-2 payload serialization; raw bytes
    # round-trip ~5x faster at these sizes
    def __getstate__(self):
        return (self.name, self.seq.tobytes(), self.rseq.tobytes(),
                None if self.qual is None else self.qual.tobytes(),
                self.full_len, self.clip_len,
                None if self.full_codes is None
                else self.full_codes.tobytes(), self.bc)

    def __setstate__(self, st):
        # bytearray keeps the rebuilt arrays writeable (np.frombuffer over
        # pickled bytes is read-only — locally built Reads are writeable,
        # and the asymmetry would surface only on the network path)
        (self.name, seq, rseq, qual, self.full_len, self.clip_len,
         fc, self.bc) = st
        self.seq = np.frombuffer(bytearray(seq), dtype=np.uint8)
        self.rseq = np.frombuffer(bytearray(rseq), dtype=np.uint8)
        self.qual = None if qual is None \
            else np.frombuffer(bytearray(qual), dtype=np.uint8)
        self.full_codes = None if fc is None \
            else np.frombuffer(bytearray(fc), dtype=np.uint8)


def _open(path):
    with open(path, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
    return gzip.open(path, "rb") if gz else open(path, "rb")


class FastqIter:
    """Iterator over (name, comment, seq_bytes, qual_bytes) records.

    Bulk-parses the file in 8 MB chunks with one split per chunk instead
    of four readline() calls per record (~4 µs/record → well under 1 µs
    via take_raw): the FASTQ reader sits on the hot path of every driver
    (bwa_read_seq, bwaseqio.c:181-251, is plain C and effectively free
    by comparison)."""

    CHUNK = 1 << 23

    def __init__(self, path):
        self._f = _open(path)
        self._tail = b""
        self._lines = []
        self._li = 0
        self._eof = False

    def _refill(self):
        pending = self._lines[self._li:]
        self._li = 0
        data = self._f.read(self.CHUNK)
        if not data:
            self._eof = True
            self._lines = pending + ([self._tail] if self._tail else [])
            self._tail = b""
            return
        buf = self._tail + data
        new = buf.split(b"\n")
        self._tail = new.pop()
        self._lines = pending + new

    def _nextline(self):
        while True:
            while self._li >= len(self._lines):
                if self._eof:
                    return None
                self._refill()
            ln = self._lines[self._li]
            self._li += 1
            if ln.endswith(b"\r"):
                ln = ln[:-1]
            if ln:
                return ln

    def __iter__(self):
        return self

    def __next__(self):
        r = self.take_raw(1)
        if not r:
            raise StopIteration
        return r[0]

    def take_raw(self, n):
        """Up to n raw (name, comment, seq, qual) tuples in one frame."""
        out = []
        append = out.append
        while len(out) < n:
            # fast inner loop over the resident line buffer: plain
            # 4-line '@' records with no CRs or blank lines
            lines = self._lines
            li = self._li
            nl = len(lines) - 4
            while li <= nl and len(out) < n:
                hdr = lines[li]
                if not hdr or hdr[0] != 64 or hdr[-1] == 13:   # '@', '\r'
                    break
                seq = lines[li + 1]
                qual = lines[li + 3]
                if (seq and seq[-1] == 13) or (qual and qual[-1] == 13) \
                        or not lines[li + 2]:
                    break
                li += 4
                sp = hdr.split(None, 1)
                append((sp[0][1:].decode(),
                        sp[1].decode() if len(sp) > 1 else None, seq, qual))
            self._li = li
            if len(out) >= n:
                break
            # slow path: one record via line-at-a-time parsing
            hdr = self._nextline()
            if hdr is None:
                break
            if hdr.startswith(b"@"):
                seq = self._nextline()
                self._nextline()  # '+'
                qual = self._nextline()
                sp = hdr[1:].split(None, 1)
                append((sp[0].decode(),
                        sp[1].decode() if len(sp) > 1 else None,
                        seq or b"", qual or b""))
            elif hdr.startswith(b">"):  # FASTA: gather until next header
                seq_parts = []
                while True:
                    while self._li >= len(self._lines):
                        if self._eof:
                            break
                        self._refill()
                    if self._li >= len(self._lines):
                        break
                    ln = self._lines[self._li]
                    if ln.startswith(b">") or ln.startswith(b"@"):
                        break
                    self._li += 1
                    if ln.endswith(b"\r"):
                        ln = ln[:-1]
                    seq_parts.append(ln)
                sp = hdr[1:].split(None, 1)
                append((sp[0].decode(),
                        sp[1].decode() if len(sp) > 1 else None,
                        b"".join(seq_parts), None))
        return out


def iter_fastq(path):
    return FastqIter(path)


class ReadBatch:
    """Columnar batch of prepared reads (native fastq_parse output):
    flat nt4 codes / quals / names + offsets, clip lengths.  The post
    kernels consume the arrays directly; the sequence protocol
    materializes `Read` objects lazily for the rare per-object paths
    (mate-rescue proxies, refinement jobs, trim fix-ups)."""

    __slots__ = ("names_flat", "name_off", "codes_flat", "seq_off",
                 "qual_flat", "clip", "is_comp", "lo", "hi")

    def __init__(self, names_flat, name_off, codes_flat, seq_off,
                 qual_flat, clip, is_comp, lo=0, hi=None):
        self.names_flat = names_flat
        self.name_off = name_off
        self.codes_flat = codes_flat
        self.seq_off = seq_off
        self.qual_flat = qual_flat
        self.clip = clip
        self.is_comp = is_comp
        self.lo = lo
        self.hi = len(clip) if hi is None else hi

    def __len__(self):
        return self.hi - self.lo

    def window(self, a, b):
        b = min(b, len(self))
        return ReadBatch(self.names_flat, self.name_off, self.codes_flat,
                         self.seq_off, self.qual_flat, self.clip,
                         self.is_comp, self.lo + a, self.lo + b)

    # --- columnar accessors (row-relative to this window) ---
    def full_lens(self):
        o = self.seq_off
        return (o[self.lo + 1:self.hi + 1] - o[self.lo:self.hi]) \
            .astype(np.int64)

    def clip_lens(self):
        return self.clip[self.lo:self.hi].astype(np.int64)

    def name_bytes(self):
        """(flat, off) of this window's names, off rebased to 0."""
        o = self.name_off
        a, b = int(o[self.lo]), int(o[self.hi])
        return self.names_flat[a:b], \
            (o[self.lo:self.hi + 1] - a).astype(np.int64)

    def code_bytes(self):
        """(flat, off) of this window's untrimmed nt4 codes."""
        o = self.seq_off
        a, b = int(o[self.lo]), int(o[self.hi])
        return self.codes_flat[a:b], \
            (o[self.lo:self.hi + 1] - a).astype(np.int64)

    def qual_bytes(self):
        o = self.seq_off
        a, b = int(o[self.lo]), int(o[self.hi])
        return self.qual_flat[a:b], \
            (o[self.lo:self.hi + 1] - a).astype(np.int64)

    def aligned_codes(self, strand, use_clip=True):
        """(flat, off) of per-row search-orientation codes: row i is
        codes[:clip] forward when strand[i] is false, its reverse
        (complement iff COMPREAD mode) otherwise — the `r.rseq if strand
        else r.seq[::-1]` chunks of the object pipeline, built by one
        threaded native ragged gather."""
        lens = self.clip_lens() if use_clip else self.full_lens()
        off = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        st = np.asarray(strand, dtype=bool)
        flags = (st.astype(np.uint8)
                 * np.uint8(3 if self.is_comp else 1))
        out = np.empty(int(off[-1]), dtype=np.uint8)
        native.lib().gather_rows_u8(
            self.codes_flat, np.ascontiguousarray(
                self.seq_off[self.lo:self.hi]),
            lens, flags, len(lens), out, off, 0)
        return out, off

    def __getitem__(self, i):
        if isinstance(i, slice):
            a, b, step = i.indices(len(self))
            assert step == 1
            return self.window(a, b)
        if i < 0:
            i += len(self)
        j = self.lo + i
        o0, o1 = int(self.seq_off[j]), int(self.seq_off[j + 1])
        codes = self.codes_flat[o0:o1]
        ln = int(self.clip[j])
        fwd = codes[:ln]
        if self.is_comp:
            rseq = np.where(fwd < 4, 3 - fwd, fwd)[::-1].astype(np.uint8)
        else:
            rseq = fwd[::-1]
        n0, n1 = int(self.name_off[j]), int(self.name_off[j + 1])
        return Read(name=self.names_flat[n0:n1].tobytes().decode(),
                    seq=fwd[::-1], rseq=rseq,
                    qual=self.qual_flat[o0:o1],
                    full_len=o1 - o0, clip_len=ln,
                    full_codes=codes, bc="")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class ColumnarFastq:
    """Whole-file native FASTQ load with pull(n, trim_qual) windows.

    Returns None from open() when the input needs the generic reader
    (BAM, FASTA, gzip bombs, barcode mode, CR line endings, multi-line
    records)."""

    MAX_BYTES = 4 << 30

    def __init__(self, data, mode):
        self._data = data
        self._mode = mode
        self._batch = None
        self._cur = 0
        self._tq = None

    @classmethod
    def open(cls, path, mode):
        if (mode >> 24) & 0xFF:          # barcode split: generic reader
            return None
        try:
            import os
            if os.path.getsize(path) > cls.MAX_BYTES:
                return None
            with open(path, "rb") as f:
                head = f.read(2)
                if head == b"\x1f\x8b":
                    import gzip
                    with gzip.open(path, "rb") as g:
                        data = g.read()
                else:
                    data = head + f.read()
        except OSError:
            return None
        if not data or data[:1] != b"@":
            return None
        return cls(data, mode)

    def _parse(self, trim_qual):
        lib = native.lib()
        data = np.frombuffer(self._data, dtype=np.uint8)
        nb = len(data)
        max_reads = self._data.count(b"\n") // 4 + 2
        name_flat = np.empty(nb, dtype=np.uint8)
        name_off = np.zeros(max_reads + 1, dtype=np.int64)
        codes_flat = np.empty(nb, dtype=np.uint8)
        seq_off = np.zeros(max_reads + 1, dtype=np.int64)
        qual_flat = np.empty(nb, dtype=np.uint8)
        clip = np.zeros(max_reads, dtype=np.int32)
        flags = (1 if self._mode & BWA_MODE_IL13 else 0) \
            | (2 if self._mode & BWA_MODE_CFY else 0)
        n = lib.fastq_parse(data, nb, max_reads, flags, int(trim_qual),
                            name_flat, name_off, codes_flat, seq_off,
                            qual_flat, clip)
        if n < 0:
            return None
        self._batch = ReadBatch(
            name_flat, name_off[:n + 1], codes_flat, seq_off[:n + 1],
            qual_flat, clip[:n],
            bool(self._mode & BWA_MODE_COMPREAD))
        self._tq = trim_qual
        self._data = None
        return self._batch

    def pull(self, n, trim_qual):
        if self._batch is None:
            if self._data is None or self._parse(trim_qual) is None:
                return None            # caller falls back permanently
        assert trim_qual == self._tq, "trim_qual changed between pulls"
        w = self._batch.window(self._cur, self._cur + n)
        self._cur += len(w)
        return w


def trim_read(trim_qual, codes, quals, full_len):
    """bwa_trim_read (bwaseqio.c:110-123): BWA-style partial-sum trimming.
    Returns new length."""
    if trim_qual < 1 or quals is None:
        return full_len
    s, mx, max_l = 0, 0, full_len - 1
    for l in range(full_len - 1, BWA_MIN_RDLEN - 2, -1):
        s += trim_qual - (int(quals[l]) - 33)
        if s < 0:
            break
        if s > mx:
            mx, max_l = s, l
    return max_l + 1


def read_fastq_batch(it, n_needed, mode=BWA_MODE_COMPREAD, trim_qual=0):
    """Pull up to n_needed prepared reads from iter_fastq iterator.

    Collects the raw records first, then prepares the whole batch with a
    handful of NumPy passes (one NT4 gather, one complement, one
    vectorized quality-trim) instead of ~8 small array ops per read."""
    is_comp = bool(mode & BWA_MODE_COMPREAD)
    is_64 = bool(mode & BWA_MODE_IL13)
    cfy = bool(mode & BWA_MODE_CFY)
    l_bc = (mode >> 24) & 0xFF
    if l_bc > BWA_MAX_BCLEN:
        raise ValueError("barcode too long")

    names, seqs, quals = [], [], []
    take = getattr(it, "take_raw", None)
    while len(names) < n_needed:
        if take is not None:
            chunk = take(min(n_needed - len(names), 1 << 16))
        else:
            chunk = []
            for rec in it:
                chunk.append(rec)
                if len(chunk) >= n_needed - len(names):
                    break
        if not chunk:
            break
        for name, comment, seq, qual in chunk:
            if cfy and comment:
                ci = comment.find(":")
                if ci >= 0 and ci + 1 < len(comment) \
                        and comment[ci + 1] == "Y":
                    continue
            if len(seq) <= l_bc:
                continue
            names.append(name)
            seqs.append(seq)
            quals.append(qual)
    n = len(names)
    if not n:
        return []

    lens = [len(s) for s in seqs]
    all_codes = NT4[np.frombuffer(b"".join(seqs), dtype=np.uint8)]
    all_comp = np.where(all_codes < 4, 3 - all_codes,
                        all_codes).astype(np.uint8) if is_comp else all_codes

    have_qual = all(quals) and all(len(q) == l for q, l in zip(quals, lens))
    if have_qual:
        all_q = np.frombuffer(b"".join(quals), dtype=np.uint8)
        if is_64:
            all_q = all_q - np.uint8(31)
    clip = lens
    if trim_qual >= 1 and have_qual:
        clip = list(lens)
        pos = 0
        for i in range(n):
            q = all_q[pos:pos + lens[i]]
            pos += lens[i]
            s, mx, max_l = 0, 0, lens[i] - 1
            for l in range(lens[i] - 1, BWA_MIN_RDLEN - 2, -1):
                s += trim_qual - (int(q[l]) - 33)
                if s < 0:
                    break
                if s > mx:
                    mx, max_l = s, l
            clip[i] = max_l + 1

    out = []
    append = out.append
    s0 = 0
    for i in range(n):
        ln = clip[i]
        s1 = s0 + lens[i]
        q = all_q[s0:s1] if have_qual else \
            (np.frombuffer(quals[i], dtype=np.uint8) - (np.uint8(31) if
             is_64 else np.uint8(0)) if quals[i] else None)
        bc = ""
        if l_bc:
            seq_b = seqs[i]
            bcs = []
            for j in range(l_bc):
                low = q is not None and q[j] - 33 < BARCODE_LOW_QUAL
                ch = chr(seq_b[j])
                bcs.append(ch.lower() if low else ch.upper())
            bc = "".join(bcs)
            s0 = s0 + l_bc
            if q is not None:
                q = q[l_bc:]
            # re-derive clip against the barcode-stripped read
            codes_i = all_codes[s0:s1]
            ln = trim_read(trim_qual, codes_i, q, len(codes_i)) \
                if q is not None else len(codes_i)
        codes = all_codes[s0:s1]
        fwd = codes[:ln]
        rseq = all_comp[s0:s0 + ln][::-1] if is_comp else fwd[::-1]
        name = names[i]
        if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
            name = name[:-2]
        append(Read(name=name, seq=fwd[::-1], rseq=rseq,
                    qual=q, full_len=s1 - s0, clip_len=ln,
                    full_codes=codes, bc=bc))
        s0 = s1
    return out
