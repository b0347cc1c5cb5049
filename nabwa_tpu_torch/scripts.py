"""Python ports of the reference's offline Perl converters
(xa2multi.pl, qualfa2fq.pl, solid2fastq.pl): the port's copy of
nabwa_tpu/scripts.py."""

import gzip
import re
import sys


def xa2multi(lines):
    """xa2multi.pl: expand XA:Z alternative hits into extra SAM lines."""
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    out = []
    for line in lines:
        line = line.rstrip("\n")
        m = re.search(r"\tXA:Z:(\S+)", line)
        out.append(line + "\n")
        if not m:
            continue
        t = line.split("\t")
        for hit in re.finditer(r"([^,;]+),([-+]\d+),([^,]+),(\d+);", m.group(1)):
            chrom, pos, cigar, nm = hit.group(1), int(hit.group(2)), \
                hit.group(3), hit.group(4)
            mchr = "=" if t[6] == chrom else t[6]  # noqa: F841 (perl quirk)
            seq, phred = t[9], t[10]
            if ((int(t[1]) & 0x10) > 0) != (pos < 0):
                seq = seq[::-1].translate(comp)
                phred = phred[::-1]
            flag = 0x100 | (int(t[1]) & 0x6E9) | (0x10 if pos < 0 else 0)
            out.append("\t".join(
                [t[0], str(flag), chrom, str(abs(pos)), "0", cigar, t[6],
                 t[7], "0", seq, phred, "NM:i:%s" % nm]) + "\n")
    return "".join(out)


def _open(path):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def qualfa2fq(fa_path, qual_path, out=sys.stdout):
    """qualfa2fq.pl: FASTA + .qual → FASTQ (60-col quality lines)."""
    def records(path):
        name = None
        body = []
        with _open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    if name is not None:
                        yield name, body
                    name = line[1:]
                    body = []
                else:
                    body.append(line)
            if name is not None:
                yield name, body

    for (n1, seq_lines), (n2, qual_lines) in zip(records(fa_path),
                                                 records(qual_path)):
        out.write("@%s\n" % n1)
        for s in seq_lines:
            out.write(s + "\n")
        out.write("+\n")
        q = "".join(chr(int(x) + 33) for x in " ".join(qual_lines).split())
        for i in range(0, len(q), 60):
            out.write(q[i:i + 60] + "\n")


def solid2fastq(title, prefix):
    """solid2fastq.pl: SOLiD csfasta/qual → (paired) fastq.gz files."""
    import os

    suff = ["F3.csfasta", "F3_QV.qual", "R3.csfasta", "R3_QV.qual"]

    def opener(fn):
        if not os.path.exists(fn) and os.path.exists(fn + ".gz"):
            return gzip.open(fn + ".gz", "rt")
        return open(fn)

    def reader(fhs, fhq, i):
        """read1(): yields (key, fastq_record)."""
        while True:
            line = fhs.readline()
            if not line:
                return
            t = fhq.readline()
            m = re.match(r">(\d+)_(\d+)_(\d+)_[FR]3", line)
            if m:
                key = "%.4d_%.4d_%.4d" % tuple(int(x) for x in m.groups())
                name = "%s:%s_%s_%s/%d" % (prefix, *m.groups(), i)
                s = fhs.readline()[2:].translate(
                    str.maketrans("0123.", "ACGTN"))
                q = fhq.readline()
                q = re.sub(r"-1\b", "0", q)
                q = re.sub(r"^(\d+)\s*", "", q)
                q = re.sub(r"(\d+)\s*", lambda x: chr(int(x.group(1)) + 33), q)
                yield key, "@%s\n%s+\n%s\n" % (name, s, q)

    paired = os.path.exists(title + suff[2]) or \
        os.path.exists(title + suff[2] + ".gz")
    if not paired:
        with opener(title + suff[0]) as fs, opener(title + suff[1]) as fq, \
                gzip.open(prefix + ".single.fastq.gz", "wt") as w:
            for _, rec in reader(fs, fq, 1):
                w.write(rec)
        return
    fs1, fq1 = opener(title + suff[0]), opener(title + suff[1])
    fs2, fq2 = opener(title + suff[2]), opener(title + suff[3])
    w2 = gzip.open(prefix + ".read2.fastq.gz", "wt")
    w1 = gzip.open(prefix + ".read1.fastq.gz", "wt")
    ws = gzip.open(prefix + ".single.fastq.gz", "wt")
    r1 = reader(fs1, fq1, 1)   # F3: named /1, written to read2 file
    r2 = reader(fs2, fq2, 2)   # R3: named /2, written to read1 file
    df = next(r1, None)
    dr = next(r2, None)
    while df and dr:
        if df[0] == dr[0]:
            w2.write(df[1])
            w1.write(dr[1])
            df = next(r1, None)
            dr = next(r2, None)
        elif df[0] <= dr[0]:
            ws.write(df[1])
            df = next(r1, None)
        else:
            ws.write(dr[1])
            dr = next(r2, None)
    while df:
        ws.write(df[1])
        df = next(r1, None)
    while dr:
        ws.write(dr[1])
        dr = next(r2, None)
    for f in (fs1, fq1, fs2, fq2, w1, w2, ws):
        f.close()
