"""The port's small host tools on the CPU, held byte for byte to the JAX
package's functions called directly on the same inputs: `stdsw` (also
`sw`; local on both strands, `-T`, `-g -f`, `-r`, `-p`), `xa2multi`,
`qualfa2fq` and `solid2fastq` (paired with unmatched reads on both sides,
and single).  The port runs through its CLI (`qualfa2fq` and
`solid2fastq`, and `xa2multi` on standard input, in a process of their
own), its standard output and files compared with what
`nabwa_tpu.models.stdsw` and `nabwa_tpu.scripts` write.  Inputs are drawn with numpy from seeds
51-56.  The tools run no kernel.  Tolerance: exact (the gzip files of
solid2fastq compared decompressed: their headers carry the write time).
"""

import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from nabwa_tpu import scripts as jscripts
from nabwa_tpu.models import stdsw as jstdsw
from nabwa_tpu_torch import cli as port_cli

from . import genomes
from .test_torch_smoke import REPO


def _port(argv, cwd=REPO, stdin=None):
    """The port's CLI in a process of its own: its standard output."""
    res = subprocess.run([sys.executable, "-m", "nabwa_tpu_torch", *argv],
                         cwd=cwd, env=dict(os.environ, PYTHONPATH=str(REPO)),
                         input=stdin, capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    return res.stdout


def _mutated_queries(seq):
    """Slices of `seq` with a substitution, one reverse-complemented, one
    with a 3-base deletion, and one unrelated."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    s1 = bytearray(seq[100:180])
    s1[40] = ord("A") if s1[40] != ord("A") else ord("C")
    s3 = bytearray(seq[500:560])
    del s3[20:23]
    junk = genomes.random_genome(70, seed=53)[1][0]
    return [(b"q1", bytes(s1)), (b"q2", seq[300:390].translate(comp)[::-1]),
            (b"q3", bytes(s3)), (b"q4", junk)]


@pytest.fixture(scope="module")
def sw_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("stdsw")
    fa, seqs = genomes.random_genome(1600, seed=51, n_seqs=2)
    (d / "long.fa").write_bytes(fa)
    shorts = _mutated_queries(seqs[0]) + _mutated_queries(seqs[1])[:2]
    (d / "short.fa").write_bytes(b"".join(b">%s\n%s\n" % (n, s)
                                          for n, s in shorts))
    g = bytearray(seqs[0][50:150])
    g[10] = ord("G") if g[10] != ord("G") else ord("T")
    (d / "glong.fa").write_bytes(b">g\n" + seqs[0][:200] + b"\n")
    (d / "gshort.fa").write_bytes(b">q\n" + bytes(g) + b"\n")
    rng = np.random.default_rng(52)
    aas = b"ARNDCQEGHILKMFPSTWYV"
    prot = bytes(aas[int(i)] for i in rng.integers(0, 20, 300))
    p = bytearray(prot[40:120])
    p[10] = ord("W") if p[10] != ord("W") else ord("C")
    p[30] = ord("H") if p[30] != ord("H") else ord("K")
    (d / "plong.fa").write_bytes(b">prot\n" + prot + b"\n")
    (d / "pshort.fa").write_bytes(b">q\n" + bytes(p) + b"\n")
    return d


CASES = {
    "local": (["-T", "20"], "long.fa", "short.fa",
              dict(is_global=False, thres=20, strand=3, aa=False)),
    "local_t1": ([], "long.fa", "short.fa",
                 dict(is_global=False, thres=1, strand=3, aa=False)),
    "reverse": (["-r", "-T", "15"], "long.fa", "short.fa",
                dict(is_global=False, thres=15, strand=2, aa=False)),
    "global": (["-g", "-f"], "glong.fa", "gshort.fa",
               dict(is_global=True, thres=1, strand=1, aa=False)),
    "protein": (["-p", "-T", "30"], "plong.fa", "pshort.fa",
                dict(is_global=False, thres=30, strand=3, aa=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stdsw_matches_jax(sw_inputs, case, capsys):
    flags, long_fa, short_fa, kw = CASES[case]
    d = sw_inputs
    want = io.StringIO()
    assert jstdsw.run_stdsw(str(d / long_fa), str(d / short_fa), out=want,
                            **kw) == 0
    cmd = "sw" if case == "local_t1" else "stdsw"
    capsys.readouterr()
    assert port_cli.main([cmd, *flags, str(d / long_fa),
                          str(d / short_fa)]) == 0
    got = capsys.readouterr().out.encode()
    assert got == want.getvalue().encode()
    if case in ("local", "protein", "global"):
        assert got.count(b"\n>") + got.startswith(b">") >= 1


def _sam_with_xa(rng, n):
    """SAM lines with and without XA:Z alternative hits on both strands."""
    lines = ["@SQ\tSN:c1\tLN:5000", "@SQ\tSN:c2\tLN:5000"]
    comp = str.maketrans("ACGT", "TGCA")
    for i in range(n):
        seq = "".join("ACGT"[int(b)] for b in rng.integers(0, 4, 30))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 40, 30))
        flag = int(rng.choice([0, 16, 0x41 | 0x20, 0x91, 0x4]))
        if flag & 0x10:
            seq = seq.translate(comp)[::-1]
        fields = [f"r{i}", str(flag), "c1", str(int(rng.integers(1, 4000))),
                  "25", "30M", "=" if i % 3 else "c2",
                  str(int(rng.integers(1, 4000))), "0", seq, qual,
                  "XT:A:R"]
        if i % 4:
            hits = "".join(
                f"{'c1' if rng.random() < 0.5 else 'c2'},"
                f"{'-' if rng.random() < 0.5 else '+'}"
                f"{int(rng.integers(1, 4000))},30M,{int(rng.integers(0, 3))};"
                for _ in range(int(rng.integers(1, 4))))
            fields.append("XA:Z:" + hits)
        lines.append("\t".join(fields))
    return "\n".join(lines) + "\n"


def test_xa2multi_matches_jax(tmp_path, capsys):
    sam = _sam_with_xa(np.random.default_rng(54), 40)
    (tmp_path / "in.sam").write_text(sam)
    want = jscripts.xa2multi(io.StringIO(sam))
    assert want.count("\n") > sam.count("\n")
    capsys.readouterr()
    assert port_cli.main(["xa2multi", str(tmp_path / "in.sam")]) == 0
    assert capsys.readouterr().out == want
    assert _port(["xa2multi"], stdin=sam.encode()) == want.encode()


def test_qualfa2fq_matches_jax(tmp_path):
    rng = np.random.default_rng(55)
    fa, qual = [], []
    for i in range(12):
        n = int(rng.integers(20, 150))
        seq = "".join("ACGTN"[int(b)] for b in rng.integers(0, 5, n))
        q = [str(int(v)) for v in rng.integers(0, 41, n)]
        fa.append(f">s{i} desc\n" + "\n".join(seq[k:k + 60]
                                                for k in range(0, n, 60)))
        qual.append(f">s{i} desc\n" + "\n".join(" ".join(q[k:k + 25])
                                                 for k in range(0, n, 25)))
    (tmp_path / "in.fa").write_text("\n".join(fa) + "\n")
    with gzip.open(tmp_path / "in.qual.gz", "wt") as f:
        f.write("\n".join(qual) + "\n")
    want = io.StringIO()
    jscripts.qualfa2fq(str(tmp_path / "in.fa"), str(tmp_path / "in.qual.gz"),
                       out=want)
    got = _port(["qualfa2fq", str(tmp_path / "in.fa"),
                 str(tmp_path / "in.qual.gz")])
    assert got == want.getvalue().encode() and got.count(b"\n@") == 11


def _solid(path_title, side, keys, rng, gz=False):
    """A SOLiD csfasta and its _QV.qual for `side` (F3 or R3)."""
    cs, qv = [], []
    for a, b, c in keys:
        name = f">{a}_{b}_{c}_{side}"
        n = int(rng.integers(20, 36))
        cs += [name, "T" + "".join("0123."[int(v)]
                                   for v in rng.integers(0, 5, n))]
        q = [str(int(v)) for v in rng.integers(-1, 35, n)]
        qv += [name, " ".join(q)]
    suffix = {"F3": ("F3.csfasta", "F3_QV.qual"),
              "R3": ("R3.csfasta", "R3_QV.qual")}[side]
    for body, suf in zip((cs, qv), suffix):
        text = "\n".join(body) + "\n"
        p = f"{path_title}{suf}"
        if gz:
            with gzip.open(p + ".gz", "wt") as f:
                f.write(text)
        else:
            with open(p, "w") as f:
                f.write(text)


def _gunzipped(prefix):
    out = {}
    for kind in ("read1", "read2", "single"):
        p = f"{prefix}.{kind}.fastq.gz"
        if os.path.exists(p):
            with gzip.open(p, "rb") as f:
                out[kind] = f.read()
    return out


@pytest.mark.parametrize("paired", [True, False])
def test_solid2fastq_matches_jax(tmp_path, paired, monkeypatch):
    rng = np.random.default_rng(56)
    keys = sorted({(int(a), int(b), int(c)) for a, b, c in
                   rng.integers(1, 60, size=(30, 3))})
    f3 = [k for i, k in enumerate(keys) if i % 5 != 1]
    r3 = [k for i, k in enumerate(keys) if i % 7 != 2]
    title = str(tmp_path / "run_")
    _solid(title, "F3", f3, rng, gz=True)
    if paired:
        _solid(title, "R3", r3, rng)
    # the output prefix is also the reads' name prefix: the same relative
    # one in two directories
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jscripts.solid2fastq(title, "out")
    _port(["solid2fastq", title, "out"], cwd=tmp_path / "port")
    want = _gunzipped(tmp_path / "jax" / "out")
    got = _gunzipped(tmp_path / "port" / "out")
    assert sorted(want) == (["read1", "read2", "single"] if paired
                            else ["single"])
    assert got == want
    assert all(want.values())
