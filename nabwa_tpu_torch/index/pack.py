"""FASTA → 2-bit packed reference (.pac) + annotations (.ann) + ambiguity
holes (.amb), and the colour-space conversion `pac2cspac`: the port's copy of
nabwa_tpu/index/pack.py.

Exact behavioral parity with bns_fasta2bntseq (reference bntseq.c:166-257):
ambiguous bases are recorded as holes (runs of the *same* raw character,
bntseq.c:207-222) and replaced by lrand48()&3 pseudo-random bases from a
stream seeded with srand48(11) (bntseq.c:181-182,225), which makes all
downstream output deterministic.  The .pac tail layout (pad byte + l_pac%4
byte, bntseq.c:240-251) is reproduced so files are byte-identical with the
reference's.
"""

import dataclasses

import numpy as np

from ..utils.rand48 import Rand48
from ..constants import PAC_SEED

# nst_nt4_table (bntseq.c:39-56): A/a=0 C/c=1 G/g=2 T/t=3, '-'=5, other=4.
NT4 = np.full(256, 4, dtype=np.uint8)
for _c, _v in zip(b"ACGT", range(4)):
    NT4[_c] = _v
    NT4[_c + 32] = _v  # lowercase
NT4[ord("-")] = 5


@dataclasses.dataclass
class SeqAnn:
    name: str
    anno: str
    gi: int
    offset: int
    length: int
    n_ambs: int


@dataclasses.dataclass
class Hole:
    offset: int
    length: int
    amb: str  # the raw ambiguity character


@dataclasses.dataclass
class BntSeq:
    """Host-side reference metadata (bntseq_t parity, bntseq.h:40-62)."""

    l_pac: int
    seed: int
    anns: list
    ambs: list

    @property
    def n_seqs(self):
        return len(self.anns)

    @property
    def n_holes(self):
        return len(self.ambs)


def parse_fasta(path):
    """Yield (name, comment_or_None, seq_bytes) per record; gzip-aware."""
    import gzip

    opener = gzip.open if _is_gzip(path) else open
    name = comment = None
    chunks = []
    with opener(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, comment, b"".join(chunks)
                hdr = line[1:]
                sp = hdr.split(None, 1)
                name = sp[0].decode() if sp else ""
                comment = sp[1].decode() if len(sp) > 1 else None
                chunks = []
            elif name is not None:
                chunks.append(line)
    if name is not None:
        yield name, comment, b"".join(chunks)


def _is_gzip(path):
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def fasta_to_pac(fa_path, prefix):
    """bwa fa2pac equivalent.  Writes prefix.pac/.ann/.amb; returns BntSeq.

    The random N-fill consumes one lrand48 draw per ambiguous base in input
    order, exactly like the reference's packing loop (bntseq.c:205-234).
    """
    rng = Rand48(PAC_SEED)
    anns, holes = [], []
    codes_parts = []
    l_pac = 0
    for name, comment, seq in parse_fasta(fa_path):
        raw = np.frombuffer(seq, dtype=np.uint8)
        codes = NT4[raw].copy()
        amb_mask = codes >= 4
        amb_idx = np.flatnonzero(amb_mask)
        # Hole runs: consecutive positions with the *same raw character*
        # extend a hole (bntseq.c:209 compares lasts == seq->seq.s[i]).
        n_ambs = 0
        if amb_idx.size:
            prev_pos = None
            prev_chr = None
            for pos in amb_idx.tolist():
                ch = raw[pos]
                if prev_pos == pos - 1 and prev_chr == ch:
                    holes[-1].length += 1
                else:
                    holes.append(Hole(l_pac + pos, 1, chr(ch)))
                    n_ambs += 1
                prev_pos, prev_chr = pos, ch
            # Random substitution, one draw per ambiguous base in order.
            fill = rng.lrand48_array(amb_idx.size) & np.uint64(3)
            codes[amb_idx] = fill.astype(np.uint8)
        anns.append(SeqAnn(name=name,
                           anno=comment if comment is not None else "(null)",
                           gi=0, offset=l_pac, length=len(seq),
                           n_ambs=n_ambs))
        codes_parts.append(codes)
        l_pac += len(seq)
    if l_pac == 0:
        raise ValueError("zero length sequence")
    codes = np.concatenate(codes_parts)
    bns = BntSeq(l_pac=l_pac, seed=PAC_SEED, anns=anns, ambs=holes)
    write_pac(str(prefix) + ".pac", codes)
    dump_ann_amb(bns, prefix)
    return bns, codes


def pack_codes(codes):
    """2-bit pack base codes (big-endian within byte: base i at bits
    (3-i%4)*2, bntseq.c:231)."""
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes & 3
    q = padded.reshape(-1, 4)
    return (q[:, 0] << 6 | q[:, 1] << 4 | q[:, 2] << 2 | q[:, 3]).astype(np.uint8)


_UNPACK_LUT = None


def _unpack_lut():
    """256-entry uint32 LUT: byte b -> its 4 base codes as one LE word."""
    global _UNPACK_LUT
    if _UNPACK_LUT is None:
        b = np.arange(256, dtype=np.uint8)
        lut = np.empty((256, 4), dtype=np.uint8)
        lut[:, 0] = b >> 6
        lut[:, 1] = (b >> 4) & 3
        lut[:, 2] = (b >> 2) & 3
        lut[:, 3] = b & 3
        _UNPACK_LUT = lut.reshape(-1).view(np.uint32)
    return _UNPACK_LUT


def unpack_pac(pac_bytes, l_pac):
    """Inverse of pack_codes: byte array → base codes of length l_pac.
    One flat np.take of uint32 LUT words (a [256,4] row fancy-index goes
    through numpy's mapiter at ~0.25 µs/row — ~50x slower at chr scale)."""
    b = np.asarray(pac_bytes, dtype=np.uint8)
    return np.take(_unpack_lut(), b).view(np.uint8)[:l_pac]


def write_pac(path, codes):
    """Write .pac with the reference's tail convention (bntseq.c:240-251):
    packed bytes, an extra zero byte iff l_pac%4==0, then a byte l_pac%4."""
    l_pac = len(codes)
    data = pack_codes(codes).tobytes()
    with open(path, "wb") as f:
        f.write(data)
        if l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l_pac % 4]))


def read_pac(path):
    """Unpacked base codes for a .pac file, as a read-only memmap.

    The codes are materialized once to `<path>.codes` (atomic rename) and
    memmapped afterwards: loads become lazy page-ins, and co-located
    worker processes share ONE physical copy through the page cache —
    the same trick as the reference's USE_MMAP index loader for cluster
    deployments (bwtio.c:39-143, bam2bam.c:818-843).  Falls back to an
    in-RAM unpack when the directory is read-only."""
    import os
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    # bwa_seq_len (bwtmisc.c:43-54): l_pac = (file_size - 2) * 4 + last_byte.
    l_pac = (len(raw) - 2) * 4 + int(raw[-1])
    cache = path + ".codes"
    try:
        st_pac = os.stat(path)
        ok = False
        if os.path.exists(cache):
            st_c = os.stat(cache)
            ok = (st_c.st_size == l_pac
                  and st_c.st_mtime >= st_pac.st_mtime)
        if not ok:
            tmp = cache + ".%d~" % os.getpid()
            codes = unpack_pac(raw[:-1], l_pac)
            with open(tmp, "wb") as f:
                codes.tofile(f)
            os.replace(tmp, cache)
        return np.memmap(cache, dtype=np.uint8, mode="r")
    except OSError:
        return unpack_pac(raw[:-1], l_pac)


def reverse_pac(prefix, as_memmap=False):
    """bwa_pac_rev_core equivalent (.pac → .rpac, reversed NOT complemented,
    bwtmisc.c:168-193).  as_memmap=True returns the reversed codes as a
    read-only memmap of the .rpac.codes cache instead of a 1 B/char
    anonymous array — big-genome builds keep only file-backed (evictable)
    pages resident."""
    codes = read_pac(str(prefix) + ".pac")
    rcodes = codes[::-1].copy()
    # The reference writes floor(l_pac/4)+1 packed bytes + ct byte
    # (bwtmisc.c:175,188-190) — same layout as write_pac produces.
    write_pac(str(prefix) + ".rpac", rcodes)
    if as_memmap:
        del rcodes, codes
        return read_pac(str(prefix) + ".rpac")
    return rcodes


# nst_color_space_table (bwtmisc.c:207): cs code of base pair
# (1<<b1 | 1<<b2) — 0 same, 1 A<->C/G<->T, 2 A<->G/C<->T, 3 A<->T/C<->G
CS_TABLE = np.array([4, 0, 0, 1, 0, 2, 3, 4, 0, 3, 2, 4, 1, 4, 4, 4],
                    dtype=np.uint8)


def pac2cspac(nt_prefix, cs_prefix):
    """bwa_pac2cspac (bwtmisc.c:215-254): convert a nucleotide index
    prefix to a color-space one — cspac[0] keeps the first nt base,
    cspac[i] = color(nt[i-1], nt[i]); .ann/.amb copied verbatim."""
    bns = restore_ann_amb(nt_prefix)
    nt = read_pac(str(nt_prefix) + ".pac")
    cs = np.empty_like(nt)
    cs[0] = nt[0]
    cs[1:] = CS_TABLE[(1 << nt[:-1].astype(np.int16))
                      | (1 << nt[1:].astype(np.int16))]
    dump_ann_amb(bns, cs_prefix)
    write_pac(str(cs_prefix) + ".pac", cs)
    return bns, cs


def dump_ann_amb(bns, prefix):
    """bns_dump equivalent (bntseq.c:58-86)."""
    with open(str(prefix) + ".ann", "w") as f:
        f.write("%d %d %u\n" % (bns.l_pac, bns.n_seqs, bns.seed))
        for p in bns.anns:
            f.write("%d %s" % (p.gi, p.name))
            if p.anno:
                f.write(" %s\n" % p.anno)
            else:
                f.write("\n")
            f.write("%d %d %d\n" % (p.offset, p.length, p.n_ambs))
    with open(str(prefix) + ".amb", "w") as f:
        f.write("%d %d %u\n" % (bns.l_pac, bns.n_seqs, bns.n_holes))
        for h in bns.ambs:
            f.write("%d %d %c\n" % (h.offset, h.length, h.amb))


def restore_ann_amb(prefix):
    """bns_restore equivalent (bntseq.c:88-148), text parsing."""
    anns = []
    with open(str(prefix) + ".ann") as f:
        toks = f.readline().split()
        l_pac, n_seqs, seed = int(toks[0]), int(toks[1]), int(toks[2])
        for _ in range(n_seqs):
            line1 = f.readline().rstrip("\n").split(" ", 2)
            gi = int(line1[0])
            name = line1[1]
            anno = line1[2] if len(line1) > 2 else ""
            toks = f.readline().split()
            anns.append(SeqAnn(name=name, anno=anno, gi=gi,
                               offset=int(toks[0]), length=int(toks[1]),
                               n_ambs=int(toks[2])))
    holes = []
    with open(str(prefix) + ".amb") as f:
        toks = f.readline().split()
        assert int(toks[0]) == l_pac and int(toks[1]) == n_seqs, \
            "inconsistent .ann and .amb files"
        n_holes = int(toks[2])
        for _ in range(n_holes):
            toks = f.readline().split()
            holes.append(Hole(int(toks[0]), int(toks[1]), toks[2][0]))
    return BntSeq(l_pac=l_pac, seed=seed, anns=anns, ambs=holes)
