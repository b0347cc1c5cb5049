"""`stdsw` — standalone SW/NW aligner over FASTA pairs (simple_dp.c).

Behavioral port of `bwa stdsw`: every short sequence (second file) is
aligned against every long sequence (first file) with the blast
parameters (gap_end forced 0, band = len1+len2), locally by default or
globally with -g, on both strands unless -f/-r; hits scoring >= -T are
printed in the reference's 4-line format (header+cigar, then the long
sequence row, match row, short row) — simple_dp.c:90-128.

Output is byte-identical to the reference for local alignments,
including the loop-index aliasing quirk in aln_1seq (simple_dp.c:104:
the cigar printf reuses the long-sequence loop index, so after a
printed hit the scan resumes from index n_cigar); for -g the reference
prints an *uninitialized* subo field (stdaln.c:232-239 never sets it),
which we print as 0.

The DP itself runs through the scalar stdaln models: this subcommand
is a debugging tool, not a pipeline hot path (its reference is host C
too), and runs no kernel; the pipelines' DP is ops/dp.py.  The port's
copy of nabwa_tpu/models/stdsw.py.
"""

import sys

import numpy as np

from ..refmodel.stdaln_scalar import (ALN_SM_BLAST, FROM_I, FROM_M,
                                      AlnParam, aln_global_core,
                                      path2cigar32)
from ..refmodel.local_aln_scalar import aln_local_core

# aln_sm_blosum62 (stdaln.c:105-128), standard BLOSUM62 with */X rows
ALN_SM_BLOSUM62 = np.array([
    [4, -1, -2, -2, 0, -1, -1, 0, -2, -1, -1, -1, -1, -2, -1, 1, 0, -3, -2, 0, -4, 0],
    [-1, 5, 0, -2, -3, 1, 0, -2, 0, -3, -2, 2, -1, -3, -2, -1, -1, -3, -2, -3, -4, -1],
    [-2, 0, 6, 1, -3, 0, 0, 0, 1, -3, -3, 0, -2, -3, -2, 1, 0, -4, -2, -3, -4, -1],
    [-2, -2, 1, 6, -3, 0, 2, -1, -1, -3, -4, -1, -3, -3, -1, 0, -1, -4, -3, -3, -4, -1],
    [0, -3, -3, -3, 9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1, -4, -2],
    [-1, 1, 0, 0, -3, 5, 2, -2, 0, -3, -2, 1, 0, -3, -1, 0, -1, -2, -1, -2, -4, -1],
    [-1, 0, 0, 2, -4, 2, 5, -2, 0, -3, -3, 1, -2, -3, -1, 0, -1, -3, -2, -2, -4, -1],
    [0, -2, 0, -1, -3, -2, -2, 6, -2, -4, -4, -2, -3, -3, -2, 0, -2, -2, -3, -3, -4, -1],
    [-2, 0, 1, -1, -3, 0, 0, -2, 8, -3, -3, -1, -2, -1, -2, -1, -2, -2, 2, -3, -4, -1],
    [-1, -3, -3, -3, -1, -3, -3, -4, -3, 4, 2, -3, 1, 0, -3, -2, -1, -3, -1, 3, -4, -1],
    [-1, -2, -3, -4, -1, -2, -3, -4, -3, 2, 4, -2, 2, 0, -3, -2, -1, -2, -1, 1, -4, -1],
    [-1, 2, 0, -1, -3, 1, 1, -2, -1, -3, -2, 5, -1, -3, -1, 0, -1, -3, -2, -2, -4, -1],
    [-1, -1, -2, -3, -1, 0, -2, -3, -2, 1, 2, -1, 5, 0, -2, -1, -1, -1, -1, 1, -4, -1],
    [-2, -3, -3, -3, -2, -3, -3, -3, -1, 0, 0, -3, 0, 6, -4, -2, -2, 1, 3, -1, -4, -1],
    [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4, 7, -1, -1, -4, -3, -2, -4, -2],
    [1, -1, 1, 0, -1, 0, 0, 0, -1, -2, -2, 0, -1, -2, -1, 4, 1, -3, -2, -2, -4, 0],
    [0, -1, 0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1, 1, 5, -2, -2, 0, -4, 0],
    [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1, 1, -4, -3, -2, 11, 2, -3, -4, -2],
    [-2, -2, -2, -3, -2, -1, -2, -3, 2, -1, -1, -2, -1, 3, -3, -2, -2, 2, 7, -1, -4, -1],
    [0, -3, -3, -3, -1, -2, -2, -3, -3, 3, 1, -2, 1, -1, -2, -2, 0, -3, -1, 4, -4, -1],
    [-4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, 1, -4],
    [0, -1, -1, -1, -2, -1, -1, -1, -1, -1, -1, -1, -1, -1, -2, 0, 0, -2, -1, -1, -4, -1],
], dtype=np.int64)

# aln_nt4_table (stdaln.c:54-71): char -> 0..3, N=4, '-'=5
_NT4 = np.full(256, 4, dtype=np.uint8)
for _c, _v in zip(b"AGCT", (0, 2, 1, 3)):
    _NT4[_c] = _v
    _NT4[_c + 32] = _v
_NT4[ord("-")] = 5

# aln_aa_table (stdaln.c:74-91): char -> 0..19, *=20, X=21, '-'=22
_AA = np.full(256, 21, dtype=np.uint8)
for _i, _c in enumerate(b"ARNDCQEGHILKMFPSTWYV*X"):
    _AA[_c] = _i
    if _i < 20:
        _AA[_c + 32] = _i
_AA[ord("-")] = 22

# aln_rev_table (simple_dp.c:24-41): IUPAC reverse-complement of chars
_REV = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGTUMRWSYKVHDBXN", b"TGCAAKYWSRMBDHVXN"):
    _REV[_a] = _b
    _REV[_a + 32] = _b + 32


def revseq(s):
    """revseq (simple_dp.c:44-53): in-place char revcomp, returned new."""
    a = np.frombuffer(s, dtype=np.uint8)
    return _REV[a][::-1].tobytes()


def read_fasta_chars(path):
    """Plain FASTA reader keeping original sequence characters."""
    import gzip
    opener = gzip.open if open(path, "rb").read(2) == b"\x1f\x8b" else open
    seqs = []
    name, parts = None, []
    with opener(path, "rb") as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    seqs.append((name, b"".join(parts)))
                name = line[1:].split()[0].decode()
                parts = []
            elif line and name is not None:
                parts.append(line)
    if name is not None:
        seqs.append((name, b"".join(parts)))
    return seqs


def stdaln_aux(seq1, seq2, ap, is_global, thres):
    """aln_stdaln_aux (stdaln.c:762-845) for local/global types.

    seq1/seq2 are byte strings of original characters.  Returns dict with
    score, subo, start/end (1-based, 0->1 like the C), cigar, out rows —
    or None when a local alignment scores below `thres`.
    """
    table = _NT4 if ap.row < 10 else _AA
    s1 = table[np.frombuffer(seq1, dtype=np.uint8)].astype(np.int64)
    s2 = table[np.frombuffer(seq2, dtype=np.uint8)].astype(np.int64)

    subo = 0
    if is_global:
        score, path = aln_global_core(s1, s2, ap)
    else:
        score, path, subo = aln_local_core(s1, s2, ap, _thres=thres,
                                           want_subo=True)
        if path is None:
            return None

    out1 = bytearray()
    out2 = bytearray()
    outm = bytearray()
    for ctype, i, j in reversed(path):
        if ctype == FROM_M:
            out1.append(seq1[i - 1])
            out2.append(seq2[j - 1])
            outm.append(ord("|") if (s1[i - 1] == s2[j - 1]
                                     and s1[i - 1] != ap.row) else ord(" "))
        elif ctype == FROM_I:
            out1.append(ord("-"))
            out2.append(seq2[j - 1])
            outm.append(ord(" "))
        else:
            out1.append(seq1[i - 1])
            out2.append(ord("-"))
            outm.append(ord(" "))

    first = path[-1]
    last = path[0]
    return dict(
        score=score, subo=subo,
        start1=first[1] if first[1] else 1, end1=last[1],
        start2=first[2] if first[2] else 1, end2=last[2],
        cigar=path2cigar32(path),
        out1=bytes(out1), out2=bytes(out2), outm=bytes(outm))


def run_stdsw(long_fa, short_fa, is_global=False, thres=1, strand=3,
              aa=False, out=None):
    """bwa_stdsw (simple_dp.c:129-162)."""
    out = out or sys.stdout
    if aa:
        strand = 1
        ap = AlnParam(10, 2, 2, ALN_SM_BLOSUM62, 22, 50)
    else:
        ap = AlnParam(5, 2, 2, ALN_SM_BLAST, 5, 50)
    ap.gap_end = 0

    longs = read_fasta_chars(long_fa)
    print(f"[load_seqs] {len(longs)} sequences are loaded.",
          file=sys.stderr)

    def aln_1seq(name, s, sym):
        # faithful to the i-aliasing in aln_1seq (simple_dp.c:90-108):
        # after a printed hit the long-seq scan resumes at index n_cigar
        i = 0
        while i < len(longs):
            pname, pseq = longs[i]
            ap.band_width = len(s) + len(pseq)
            r = stdaln_aux(s, pseq, ap, is_global, thres)
            if r is not None and (r["score"] >= thres or is_global):
                cig = "".join(f"{ln}{'MDI'[op]}" for op, ln in r["cigar"])
                out.write(f">{pname}\t{r['start1']}\t{r['end1']}\t{name}"
                          f"\t{sym}\t{r['start2']}\t{r['end2']}"
                          f"\t{r['score']}\t{r['subo']}\t{cig}\n")
                out.write(r["out2"].decode() + "\n")
                out.write(r["outm"].decode() + "\n")
                out.write(r["out1"].decode() + "\n")
                i = len(r["cigar"])
            i += 1

    for name, s in read_fasta_chars(short_fa):
        if strand & 1:
            aln_1seq(name, s, "+")
        if strand & 2:
            aln_1seq(name, revseq(s), "-")
    return 0
