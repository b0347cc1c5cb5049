"""Colour space (SOLiD) on the port, end to end on the CPU, held byte for
byte to `nabwa_tpu`: `index -c` and `pac2cspac` (every index file), `aln
-c` (`.sai` bytes), colour-space `samse` (cs2nt decoding, the second
refine round against the `.nt` pac, no trim correction) and `sampe`
(BWA_PET_SOLID pairing, mate rescue in the SOLiD orientation), on the
port's card-route code with `--device cpu` and on its host reference
route.  `cs2nt_batch`, the columnar decode, equals `cs2nt_core` on every
row of a seeded random draw.  The indexes come from the JAX package's
`build_index(color=True)` or the port's CLI, never from the oracle
binary.

Colour reads are drawn from the genome as tests/test_colorspace.py draws
them: a fragment of read length + 1 bases, either strand, turned into its
colours (written ACGT, as solid2fastq writes them), colour errors, an `N`
colour in some reads (a `.`), and where asked a 1-base indel in the
fragment (so the colour alignment is gapped) or a low-quality tail (for
`-q 20`).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from nabwa_tpu import cli as ref_cli
from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex as JaxIndex
from nabwa_tpu.index.pack import pac2cspac as ref_pac2cspac
from nabwa_tpu.index.pack import read_pac as jax_read_pac
from nabwa_tpu.io import sai as jax_sai
from nabwa_tpu.io.fastq import Read as JaxRead
from nabwa_tpu.models import sampe as jsampe
from nabwa_tpu.models.aln import AlnEngine as JaxEngine
from nabwa_tpu.models.samse import SeqState as JaxSeqState
from nabwa_tpu.options import PeOpt as JaxPeOpt
from nabwa_tpu.refmodel.cs2nt import cs2nt_core as jax_cs2nt_core
from nabwa_tpu.utils.rand48 import Rand48 as JaxRand48
from nabwa_tpu_torch import cli as port_cli
from nabwa_tpu_torch.index.fmindex import BwaIndex
from nabwa_tpu_torch.index.pack import read_pac
from nabwa_tpu_torch.io import sai
from nabwa_tpu_torch.io.fastq import Read as PortRead
from nabwa_tpu_torch.models import sampe as msampe
from nabwa_tpu_torch.models import samse as msamse
from nabwa_tpu_torch.models.aln import AlnEngine
from nabwa_tpu_torch.options import PeOpt
from nabwa_tpu_torch.refmodel import cs2nt
from nabwa_tpu_torch.utils.rand48 import Rand48

from . import genomes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDEX_EXTS = (".nt.pac", ".nt.ann", ".nt.amb", ".pac", ".ann", ".amb",
              ".rpac", ".bwt", ".rbwt", ".sa", ".rsa")
CODE = np.full(256, 0, dtype=np.int64)
CODE[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4)
# nst_color_space_table: the colour of two adjacent bases
CS = np.array([4, 0, 0, 1, 0, 2, 3, 4, 0, 3, 2, 4, 1, 4, 4, 4])
COMP = bytes.maketrans(b"ACGTN", b"TGCAN")
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def to_colours(frag):
    """The colours (0-3) of a nucleotide fragment's adjacent pairs; N
    bases count as A."""
    c = CODE[np.frombuffer(frag, dtype=np.uint8)]
    return CS[(1 << c[:-1]) | (1 << c[1:])]


def colour_read(rng, frag, err, dot, low_tail):
    """(colour text, quality text) of a fragment: colour errors at rate
    err, an N colour with probability dot, and a tail of qualities 2-9
    over the last fifth with probability low_tail."""
    cols = to_colours(frag)
    hit = rng.random(len(cols)) < err
    cols[hit] = (cols[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    text = bytearray(b"ACGT"[c] for c in cols)
    if rng.random() < dot:
        text[int(rng.integers(0, len(text)))] = ord("N")
    qual = bytearray((33 + rng.integers(20, 40, len(cols))).astype(np.uint8))
    if rng.random() < low_tail:
        k = len(qual) // 5
        qual[-k:] = (33 + rng.integers(2, 10, k)).astype(np.uint8).tobytes()
    return bytes(text), bytes(qual)


def colour_reads(g, n, read_len, seed, err=0.02, dot=0.1, indel=0.0,
                 low_tail=0.0, name="cs"):
    """FASTQ text of n colour reads of read_len colours from genome text
    g; a fraction `indel` of the fragments carry a 1-base insertion or
    deletion in their middle third."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        start = int(rng.integers(0, len(g) - read_len - 3))
        frag = bytearray(g[start:start + read_len + 2])
        if rng.random() < indel:
            j = int(rng.integers(read_len // 3, 2 * read_len // 3))
            if rng.random() < 0.5:
                del frag[j]
            else:
                frag.insert(j, b"ACGT"[int(rng.integers(0, 4))])
        frag = bytes(frag[:read_len + 1])
        if rng.random() < 0.5:
            frag = frag.translate(COMP)[::-1]
        text, qual = colour_read(rng, frag, err, dot, low_tail)
        out.append(b"@%s%d\n%s\n+\n%s\n" % (name.encode(), i, text, qual))
    return b"".join(out)


def colour_pairs(g, n, read_len, seed, isize=300, std=30, err=0.02,
                 n_rescue=0):
    """FASTQ text of both ends of n colour pairs in the orientation
    BWA_PET_SOLID pairs (F3/R3: both ends on one strand, end 1 to the
    right of end 0 on the forward strand), and the FASTA text of a decoy
    contig.  The last n_rescue pairs' end 2 carries three colour errors
    among its first 12 colours (more than `aln`'s seed allows at its true
    place) and an exact copy on the decoy, so `aln` maps it there and only
    the rescue places it beside end 1 (XT:A:M), as tests/test_torch_sampe.py
    builds such mates in nucleotide space."""
    rng = np.random.default_rng(seed)
    fq = ([], [])
    decoy = []
    for i in range(n):
        isz = max(int(rng.normal(isize, std)), read_len + 10)
        start = int(rng.integers(0, len(g) - isz - 2))
        left = g[start:start + read_len + 1]
        right = g[start + isz - read_len - 1:start + isz]
        ends = (left, right)
        if rng.random() < 0.5:
            ends = (right.translate(COMP)[::-1], left.translate(COMP)[::-1])
        for e in (0, 1):
            if e == 1 and i >= n - n_rescue:
                cols = to_colours(ends[e])
                for j in rng.choice(12, 3, replace=False):
                    cols[j] = (cols[j] + int(rng.integers(1, 4))) % 4
                # the bases whose colours these are: a colour is the XOR
                # of its two bases' codes
                first = CODE[ends[e][0]]
                nt = np.concatenate([[first], first ^ np.bitwise_xor
                                     .accumulate(cols)])
                decoy.append(ACGT[rng.integers(0, 4, 150)].tobytes())
                decoy.append(ACGT[nt].tobytes())
                text = bytes(b"ACGT"[c] for c in cols)
                qual = b"I" * len(cols)
            else:
                text, qual = colour_read(rng, ends[e], err, 0.05, 0.0)
            fq[e].append(b"@cp%d/%d\n%s\n+\n%s\n" % (i, e + 1, text, qual))
    seq = b"".join(decoy) + ACGT[rng.integers(0, 4, 150)].tobytes()
    decoy_fa = b">decoy\n" + b"\n".join(seq[i:i + 70]
                                        for i in range(0, len(seq), 70))
    return b"".join(fq[0]), b"".join(fq[1]), decoy_fa + b"\n"


def _genome_text(fa):
    return b"".join(ln for ln in fa.split(b"\n")
                    if not ln.startswith(b">"))


def _duplicated_halves():
    rng = np.random.default_rng(25)
    half = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 8000)]
    seq = np.concatenate([half, half]).tobytes()
    fa = b">dup chrom\n" + b"\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + b"\n"
    return fa


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A genome of two contigs with N holes and a genome of two equal
    halves (multi hits), each indexed in colour space by the JAX
    package."""
    d = tmp_path_factory.mktemp("colour")
    fa, _ = genomes.random_genome(40000, seed=2001, n_frac=0.005, n_seqs=2)
    (d / "g.fa").write_bytes(fa)
    build_index(str(d / "g.fa"), color=True)
    (d / "dup.fa").write_bytes(_duplicated_halves())
    build_index(str(d / "dup.fa"), color=True)
    return d


def _jax_aln(d, prefix, fq, out, *extra):
    assert ref_cli.main(["aln", "-c", *extra, str(d / prefix), str(d / fq),
                         "-f", str(d / out)]) == 0
    return (d / out).read_bytes()


def _port_aln(d, prefix, fq, out, *extra):
    assert port_cli.main(["aln", "--device", "cpu", "-c", *extra,
                          str(d / prefix), str(d / fq), "-f",
                          str(d / out)]) == 0
    return (d / out).read_bytes()


# --- index -c and pac2cspac ---

def test_index_c_matches_jax(genome, tmp_path):
    """`index -c` through the port's CLI writes all eleven files of
    `nabwa_tpu.index.build.build_index(color=True)`."""
    (tmp_path / "p.fa").write_bytes((genome / "g.fa").read_bytes())
    assert port_cli.main(["index", "-c", str(tmp_path / "p.fa")]) == 0
    for ext in INDEX_EXTS:
        assert (tmp_path / ("p.fa" + ext)).read_bytes() == \
            (genome / ("g.fa" + ext)).read_bytes(), ext


def test_pac2cspac_matches_jax(genome, tmp_path):
    """`pac2cspac <nt prefix> <cs prefix>` writes the `.pac`, `.ann` and
    `.amb` of `nabwa_tpu.index.pack.pac2cspac`; one argument is a usage
    error."""
    nt = str(genome / "g.fa.nt")
    assert port_cli.main(["pac2cspac", nt, str(tmp_path / "port")]) == 0
    ref_pac2cspac(nt, str(tmp_path / "jax"))
    for ext in (".pac", ".ann", ".amb"):
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes() == \
            (genome / f"g.fa{ext}").read_bytes(), ext
    assert port_cli.main(["pac2cspac", nt]) == 1


# --- aln -c ---

ALN_SETS = {
    "35bp": (35, dict(seed=2011)),
    "50bp": (50, dict(seed=2012, indel=0.3)),
    "q20": (50, dict(seed=2013, low_tail=0.5)),
}


@pytest.fixture(scope="module")
def aligned(genome):
    """Each read set of ALN_SETS (96 reads) with its JAX `.sai`."""
    g = _genome_text((genome / "g.fa").read_bytes())
    for name, (rlen, kw) in ALN_SETS.items():
        (genome / f"{name}.fq").write_bytes(colour_reads(g, 96, rlen, **kw))
        _jax_aln(genome, "g.fa", f"{name}.fq", f"{name}.sai",
                 *(["-q", "20"] if name == "q20" else []))
    return genome


@pytest.mark.parametrize("name", list(ALN_SETS))
def test_aln_c_matches_jax(aligned, name):
    extra = ["-q", "20"] if name == "q20" else []
    got = _port_aln(aligned, "g.fa", f"{name}.fq", f"{name}.port.sai",
                    *extra)
    assert got == (aligned / f"{name}.sai").read_bytes()
    opt, per_read = sai.read_sai_tuples(str(aligned / f"{name}.sai"))
    assert not opt.mode & 0x02                 # no complement: colour
    assert sum(1 for a in per_read if a) >= 80


# --- samse ---

@pytest.fixture(scope="module")
def multi(genome):
    """96 colour reads on the duplicated-halves genome, gapped and with N
    colours, and their JAX `.sai`."""
    g = _genome_text((genome / "dup.fa").read_bytes())
    (genome / "dup.fq").write_bytes(colour_reads(g, 96, 40, seed=2021,
                                                 indel=0.3, dot=0.3))
    _jax_aln(genome, "dup.fa", "dup.fq", "dup.sai")
    return genome


# name: (prefix, reads, .sai, samse options)
SAMSE_SETS = {
    "35bp": ("g.fa", "35bp", []),
    "gapped": ("g.fa", "50bp", []),
    "q20": ("g.fa", "q20", []),
    "multi": ("dup.fa", "dup", ["-n", "3"]),
}


@pytest.fixture(scope="module")
def jax_samse(aligned, multi):
    """name -> the JAX CLI's colour-space SAM of SAMSE_SETS[name]."""
    cache = {}

    def run(name):
        if name not in cache:
            d = aligned
            prefix, rs, extra = SAMSE_SETS[name]
            out = d / f"{name}.jax.sam"
            assert ref_cli.main(["samse", *extra, str(d / prefix),
                                 str(d / f"{rs}.sai"), str(d / f"{rs}.fq"),
                                 "-f", str(out)]) == 0
            cache[name] = out.read_bytes()
        return cache[name]
    return run


@pytest.mark.parametrize("name", list(SAMSE_SETS))
def test_samse_colour_matches_jax(aligned, jax_samse, name):
    d = aligned
    prefix, rs, extra = SAMSE_SETS[name]
    args = [str(d / prefix), str(d / f"{rs}.sai"), str(d / f"{rs}.fq")]
    want = jax_samse(name)
    assert port_cli.main(["samse", "--device", "cpu", *extra, *args, "-f",
                          str(d / f"{name}.port.sam")]) == 0
    got = (d / f"{name}.port.sam").read_bytes()
    assert got == want
    body = [ln.split(b"\t") for ln in got.splitlines()
            if not ln.startswith(b"@")]
    assert len(body) == 96
    mapped = [f for f in body if f[2] != b"*"]
    assert len(mapped) >= 60
    # decoded: as many qualities as bases, a colour-space CM tag
    assert all(len(f[9]) == len(f[10]) for f in mapped)
    if name != "q20":
        rlen = max(len(f[9]) for f in body if f[2] == b"*")
        assert all(len(f[9]) <= rlen - 1 for f in mapped)
    assert any(b"CM:i:" in b"\t".join(f) for f in mapped)
    if name == "gapped":
        assert any(b"I" in f[5] or b"D" in f[5] for f in mapped)
    if name == "multi":
        assert any(b"XA:Z:" in b"\t".join(f) for f in mapped)


@pytest.mark.parametrize("name", ["gapped", "q20", "multi"])
def test_samse_colour_routes(aligned, jax_samse, name):
    """samse_bytes on the card route (the plain versions on the CPU) and on
    the host reference route, from the CLI's columnar reads and from a
    list of Read objects: each equals the JAX package's SAM, and the
    decode books its own seconds."""
    from nabwa_tpu_torch.io import fastq
    d = aligned
    prefix, rs, extra = SAMSE_SETS[name]
    n_occ = int(extra[1]) if extra else 3
    want = jax_samse(name)
    idx = BwaIndex.load(str(d / prefix))
    opt, per_read = sai.read_sai_tuples(str(d / f"{rs}.sai"))
    ntpac = read_pac(str(d / prefix) + ".nt.pac")
    eng = AlnEngine(idx, opt, "cpu")
    header = msamse.sam_header(idx.bns).encode()
    columnar = port_cli.open_reads(str(d / f"{rs}.fq"), opt.mode)(
        1000, opt.trim_qual)
    objects = list(columnar)
    for reads in (columnar, objects):
        for ref_route in (False, True):
            before = msamse.seconds["cs2nt"]
            body = msamse.samse_bytes(eng, reads, per_read, opt,
                                      n_occ=n_occ, rng=Rand48(idx.bns.seed),
                                      ntpac=ntpac,
                                      host_reference=ref_route)
            assert header + body == want, (type(reads), ref_route)
            assert msamse.seconds["cs2nt"] > before
    assert isinstance(columnar, fastq.ReadBatch)


def test_samse_colour_space_needs_nt_pac(aligned, tmp_path):
    """A colour `.sai` on an index without `<prefix>.nt.pac` stops with an
    error and writes no SAM."""
    d = aligned
    for ext in (".pac", ".ann", ".amb", ".bwt", ".sa", ".rbwt", ".rsa"):
        (tmp_path / f"g.fa{ext}").write_bytes((d / f"g.fa{ext}")
                                              .read_bytes())
    out = tmp_path / "out.sam"
    with pytest.raises(FileNotFoundError):
        port_cli.main(["samse", "--device", "cpu", str(tmp_path / "g.fa"),
                       str(d / "35bp.sai"), str(d / "35bp.fq"), "-f",
                       str(out)])
    assert not out.exists()


# --- sampe ---

@pytest.fixture(scope="module")
def paired(genome):
    """112 colour pairs on a contig and a decoy contig (pe.fa, indexed in
    colour space by the JAX package), 16 of them with a mate only the
    rescue places, and both ends' JAX `.sai`."""
    fa, seqs = genomes.random_genome(40000, seed=2030)
    fq1, fq2, decoy = colour_pairs(seqs[0], 112, 40, seed=2031, n_rescue=16)
    (genome / "pe.fa").write_bytes(fa + decoy)
    build_index(str(genome / "pe.fa"), color=True)
    (genome / "p1.fq").write_bytes(fq1)
    (genome / "p2.fq").write_bytes(fq2)
    for e in (1, 2):
        _jax_aln(genome, "pe.fa", f"p{e}.fq", f"p{e}.sai")
    return genome


def _pe_args(d):
    return [str(d / "pe.fa"), str(d / "p1.sai"), str(d / "p2.sai"),
            str(d / "p1.fq"), str(d / "p2.fq")]


@pytest.mark.parametrize("opts", [[], ["-s"], ["-n", "3", "-N", "5"]],
                         ids=["rescue", "no_rescue", "multi"])
def test_sampe_colour_matches_jax(paired, opts):
    d = paired
    tag = "_".join(o.strip("-") for o in opts) or "plain"
    jax_sam, port_sam = d / f"pe_{tag}.jax.sam", d / f"pe_{tag}.port.sam"
    assert ref_cli.main(["sampe", *opts, *_pe_args(d), "-f",
                         str(jax_sam)]) == 0
    assert port_cli.main(["sampe", "--device", "cpu", *opts, *_pe_args(d),
                          "-f", str(port_sam)]) == 0
    got = port_sam.read_bytes()
    assert got == jax_sam.read_bytes()
    body = [ln.split(b"\t") for ln in got.splitlines()
            if not ln.startswith(b"@")]
    assert len(body) == 224
    proper = sum(1 for f in body if int(f[1]) & 2)
    assert proper >= 0.7 * len(body)
    rescued = sum(1 for f in body if b"XT:A:M" in b"\t".join(f))
    if opts == ["-s"]:
        assert rescued == 0
    else:
        assert rescued >= 8


def test_sampe_colour_routes(paired):
    """sampe_bytes with BWA_PET_SOLID on the card route (plain versions on
    the CPU) and on the host reference route: the JAX package's SAM."""
    d = paired
    want = d / "pe_routes.jax.sam"
    assert ref_cli.main(["sampe", *_pe_args(d), "-f", str(want)]) == 0
    idx = BwaIndex.load(str(d / "pe.fa"))
    opt0, per0 = sai.read_sai_tuples(str(d / "p1.sai"))
    opt, per1 = sai.read_sai_tuples(str(d / "p2.sai"))
    ntpac = read_pac(str(d / "pe.fa.nt.pac"))
    eng = AlnEngine(idx, opt, "cpu")
    reads = tuple(port_cli.open_reads(str(d / f"p{e}.fq"), opt.mode)(
        1000, opt.trim_qual) for e in (1, 2))
    header = msamse.sam_header(idx.bns).encode()
    for ref_route in (False, True):
        popt = PeOpt()
        popt.type = 2                         # BWA_PET_SOLID
        before = msampe.seconds["cs2nt"]
        blob, ii = msampe.sampe_bytes(eng, reads, (per0, per1), opt, popt,
                                      Rand48(idx.bns.seed), ntpac=ntpac,
                                      host_reference=ref_route)
        assert header + blob == want.read_bytes(), ref_route
        assert msampe.seconds["cs2nt"] > before
        assert ii.avg > 0


def test_sampe_colour_two_chunks_carry_isize_and_memo(genome):
    """Colour sampe (BWA_PET_SOLID, the `.nt` pac) over two chunks in turn,
    100 pairs then 12 (too few for an insert-size estimate of their own),
    with the insert size and the wide-interval memo carried over, as the
    CLI carries them: each chunk's bytes equal `nabwa_tpu`'s sampe called
    the same way.  The pairs lie around a tandem repeat, so reads inside it
    have SA intervals of ~1,200 rows and go through the memo."""
    d = genome
    rng = np.random.default_rng(2061)
    unit = ACGT[rng.integers(0, 4, 37)].tobytes()
    seq = (ACGT[rng.integers(0, 4, 30000)].tobytes() + unit * 1200
           + ACGT[rng.integers(0, 4, 30000)].tobytes())
    fq1, fq2, _ = colour_pairs(seq, 112, 40, seed=2062, isize=200, std=20)
    (d / "tr.fa").write_bytes(b">tandem\n" + b"\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + b"\n")
    build_index(str(d / "tr.fa"), color=True)
    for e, fq in ((1, fq1), (2, fq2)):
        (d / f"tr{e}.fq").write_bytes(fq)
        _jax_aln(d, "tr.fa", f"tr{e}.fq", f"tr{e}.sai")
    prefix = str(d / "tr.fa")
    jidx, idx = JaxIndex.load(prefix), BwaIndex.load(prefix)
    _, jalns0 = jax_sai.read_sai_tuples(str(d / "tr1.sai"))
    jopt, jalns1 = jax_sai.read_sai_tuples(str(d / "tr2.sai"))
    _, alns0 = sai.read_sai_tuples(str(d / "tr1.sai"))
    opt, alns1 = sai.read_sai_tuples(str(d / "tr2.sai"))
    jreads = [ref_cli._open_reads(str(d / f"tr{e}.fq"), jopt.mode)(
        1000, jopt.trim_qual) for e in (1, 2)]
    reads = [port_cli.open_reads(str(d / f"tr{e}.fq"), opt.mode)(
        1000, opt.trim_qual) for e in (1, 2)]
    jntpac = jax_read_pac(prefix + ".nt.pac")
    ntpac = read_pac(prefix + ".nt.pac")
    jpopt, popt = JaxPeOpt(), PeOpt()
    jpopt.type = popt.type = 2                    # BWA_PET_SOLID
    jeng, eng = JaxEngine(jidx, jopt), AlnEngine(idx, opt, "cpu")
    jrng, prng = JaxRand48(idx.bns.seed), Rand48(idx.bns.seed)
    jmemo, memo = {}, {}
    jii = ii = None
    for lo, hi in ((0, 100), (100, 112)):
        want, jii_new = jsampe.sampe(
            jeng, (jreads[0][lo:hi], jreads[1][lo:hi]),
            (jalns0[lo:hi], jalns1[lo:hi]), jopt, jpopt, jrng, last_ii=jii,
            pos_memo=jmemo, ntpac=jntpac)
        if not isinstance(want, bytes):
            want = "".join(ln + "\n" for ln in want).encode("latin1")
        got, ii_new = msampe.sampe_bytes(
            eng, (reads[0][lo:hi], reads[1][lo:hi]),
            (alns0[lo:hi], alns1[lo:hi]), opt, popt, prng, last_ii=ii,
            pos_memo=memo, ntpac=ntpac)
        assert got == want, (lo, hi)
        assert (ii_new.avg, ii_new.std, ii_new.high) == \
            (jii_new.avg, jii_new.std, jii_new.high)
        if lo:
            assert ii_new is ii and jii_new is jii
        jii, ii = jii_new, ii_new
        assert prng.x == jrng.x
    assert ii.avg > 0
    assert memo and sorted(memo) == sorted(jmemo)
    assert all(np.array_equal(memo[k], jmemo[k]) for k in memo)
    body = [ln.split(b"\t") for ln in got.splitlines()]
    assert len(body) == 24 and any(int(f[1]) & 2 for f in body)


# --- cs2nt_batch ---

def _random_rows(rng, n, l_pac, lengths=(8, 60)):
    """Seeded rows for the decode: either strand, cigars with I, D and S,
    N colours, pos 0 and windows that run past l_pac."""
    rows = []
    for r in range(n):
        L = int(rng.integers(*lengths))
        codes = rng.integers(0, 4, L).astype(np.uint8)
        codes[rng.random(L) < 0.05] = 4
        qual = rng.integers(33, 80, L).astype(np.uint8)
        strand = int(rng.integers(0, 2))
        u = rng.random()
        pos = 0 if u < 0.1 else (l_pac - int(rng.integers(1, 30))
                                 if u < 0.25
                                 else int(rng.integers(1, l_pac - 80)))
        cigar = None
        if rng.random() < 0.5:
            cigar, y = [], 0
            if rng.random() < 0.3:
                k = int(rng.integers(1, 3))
                cigar.append((3, k))
                y += k
            while y < L - 2:
                op = int(rng.choice([0, 0, 0, 1, 2]))
                if op == 2 and (not cigar or cigar[-1][0] != 0):
                    op = 0
                ln = int(rng.integers(1, 6))
                if op != 2:
                    ln = min(ln, L - 2 - y)
                    y += ln
                cigar.append((op, ln))
            if cigar[-1][0] == 2:
                cigar.append((0, 1))
                y += 1
            if y < L:
                cigar.append((3, L - y))
        rows.append((codes, qual, strand, pos, cigar))
    return rows


def test_cs2nt_batch_equals_core():
    """The columnar decode equals `cs2nt_core`, the port's copy and the
    JAX package's, on every row: decoded codes, qualities and length."""
    rng = np.random.default_rng(2041)
    l_pac = 700
    ntpac = rng.integers(0, 4, l_pac).astype(np.uint8)
    # and a few rows too long for the DP's 16-bit scores
    rows = _random_rows(rng, 600, l_pac) + _random_rows(rng, 6, l_pac,
                                                        (390, 480))
    assert {r[2] for r in rows} == {0, 1}
    assert sum(r[3] == 0 for r in rows) and sum(r[3] > l_pac - 60
                                                for r in rows)
    assert {op for r in rows if r[4] for op, _ in r[4]} == {0, 1, 2, 3}
    off = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum([len(r[0]) for r in rows], out=off[1:])
    dec, dq, doff = cs2nt.cs2nt_batch(
        np.concatenate([r[0] for r in rows]),
        np.concatenate([r[1] for r in rows]), off, [r[2] for r in rows],
        [r[3] for r in rows], [r[4] for r in rows], l_pac, ntpac)
    for i, (codes, qual, strand, pos, cigar) in enumerate(rows):
        got = (dec[doff[i]:doff[i + 1]], dq[doff[i]:doff[i + 1]])
        for Rd, St, core in ((JaxRead, JaxSeqState, jax_cs2nt_core),
                             (PortRead, msamse.SeqState, cs2nt.cs2nt_core)):
            rd = Rd(name="r", seq=codes[::-1].copy(), rseq=codes[::-1].copy(),
                    qual=qual.copy(), full_len=len(codes),
                    clip_len=len(codes), full_codes=codes.copy(), bc="")
            s = St(rd)
            s.type, s.strand, s.pos, s.cigar = 1, strand, pos, cigar
            core(s, l_pac, ntpac)
            want_dec = rd.rseq if strand else rd.seq[::-1]
            want_q = rd.qual[::-1] if strand else rd.qual
            assert s.len == len(got[0]), i
            assert np.array_equal(got[0], want_dec), i
            assert np.array_equal(got[1], want_q), i


def test_cs2nt_batch_blocks_and_empty():
    """Rows across several lockstep blocks of mixed lengths give the same
    decode as one row a call; no rows give empty columns."""
    rng = np.random.default_rng(2042)
    l_pac = 400
    ntpac = rng.integers(0, 4, l_pac).astype(np.uint8)
    rows = _random_rows(rng, 2 * 37 + 5, l_pac)
    old = cs2nt.BLOCK_ROWS
    cs2nt.BLOCK_ROWS = 37
    try:
        off = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum([len(r[0]) for r in rows], out=off[1:])
        cols = (np.concatenate([r[0] for r in rows]),
                np.concatenate([r[1] for r in rows]), off,
                [r[2] for r in rows], [r[3] for r in rows],
                [r[4] for r in rows], l_pac, ntpac)
        dec, dq, doff = cs2nt.cs2nt_batch(*cols)
    finally:
        cs2nt.BLOCK_ROWS = old
    for i, r in enumerate(rows):
        o = np.array([0, len(r[0])])
        d1, q1, _ = cs2nt.cs2nt_batch(r[0], r[1], o, [r[2]], [r[3]], [r[4]],
                                      l_pac, ntpac)
        assert np.array_equal(dec[doff[i]:doff[i + 1]], d1)
        assert np.array_equal(dq[doff[i]:doff[i + 1]], q1)
    e = np.zeros(0, dtype=np.uint8)
    dec, dq, doff = cs2nt.cs2nt_batch(e, e, np.zeros(1, np.int64), [], [],
                                      [], l_pac, ntpac)
    assert len(dec) == len(dq) == 0 and list(doff) == [0]


# --- bam2bam's pass 2 with BWA_PET_SOLID ---

def solid_nt_pairs(g, n, read_len, seed, n_rescue, isize=250, std=25):
    """FASTQ text of both ends of n nucleotide pairs in the SOLiD
    orientation (both ends on one strand), 1 % substitutions, and the
    FASTA text of a decoy contig: the last n_rescue pairs' end 2 carries
    three substitutions in its 32-base seed, past its first four bases,
    and an exact copy on the decoy, so `aln` maps it there and its pair
    goes to the rescue."""
    rng = np.random.default_rng(seed)
    fq = ([], [])
    decoy = []
    for i in range(n):
        isz = max(int(rng.normal(isize, std)), read_len + 10)
        start = int(rng.integers(0, len(g) - isz))
        ends = (g[start:start + read_len], g[start + isz - read_len:
                                             start + isz])
        if rng.random() < 0.5:
            ends = (ends[1].translate(COMP)[::-1],
                    ends[0].translate(COMP)[::-1])
        for e in (0, 1):
            r = bytearray(ends[e])
            rescue = e == 1 and i >= n - n_rescue
            hit = (np.isin(np.arange(read_len),
                           4 + rng.choice(28, 3, replace=False))
                   if rescue else rng.random(read_len) < 0.01)
            for j in np.nonzero(hit)[0]:
                r[j] = ACGT[(CODE[r[j]] + int(rng.integers(1, 4))) % 4]
            if rescue:
                decoy.append(ACGT[rng.integers(0, 4, 150)].tobytes())
                decoy.append(bytes(r))
            fq[e].append(b"@sp%d/%d\n%s\n+\n%s\n"
                         % (i, e + 1, bytes(r), b"I" * read_len))
    seq = b"".join(decoy) + ACGT[rng.integers(0, 4, 150)].tobytes()
    decoy_fa = b">decoy\n" + b"\n".join(seq[i:i + 70]
                                        for i in range(0, len(seq), 70))
    return b"".join(fq[0]), b"".join(fq[1]), decoy_fa + b"\n"


def test_pass2_solid_matches_jax(tmp_path, monkeypatch):
    """bam2bam's pass 2 with `popt.type` BWA_PET_SOLID (the SOLiD pairing
    and rescue orientation) on the port equals
    `nabwa_tpu.models.bam2bam._pass2_work_columnar` called directly: the
    JAX run's pass 2 calls it in place of its dispatcher, and both runs'
    BAM bytes and rescue counters agree."""
    from nabwa_tpu.index.fmindex import BwaIndex as JaxIndex
    from nabwa_tpu.models import bam2bam as jb2b
    from nabwa_tpu.models.aln import AlnEngine as JaxEngine
    from nabwa_tpu.options import GapOpt as JaxGapOpt
    from nabwa_tpu.options import PeOpt as JaxPeOpt
    from nabwa_tpu.utils.rand48 import Rand48 as JaxRand48
    from nabwa_tpu_torch.io import bam as pbam
    from nabwa_tpu_torch.models import bam2bam as pb2b
    from nabwa_tpu_torch.options import GapOpt

    from .test_bam2bam import dump_records
    from .test_torch_bam2bam import _header, _pairs

    fa, seqs = genomes.random_genome(50000, seed=2061)
    fq1, fq2, decoy = solid_nt_pairs(seqs[0], 120, 50, 2062, n_rescue=8)
    (tmp_path / "g.fa").write_bytes(fa + decoy)
    build_index(str(tmp_path / "g.fa"))
    pbam.make_bam(str(tmp_path / "in.bam"), [], _pairs(fq1, fq2, "rg1"),
                  text=_header(["rg1"]))
    calls = {"jax": [], "port": []}

    def jax_pass2(engine, gopt, popt, iinfos, payload):
        assert popt.type == 2
        out = jb2b._pass2_work_columnar(engine, gopt, popt, iinfos, payload)
        calls["jax"].append(out[1])
        return out

    port_pass2 = pb2b.pass2_work

    def port_wrapped(engine, gopt, popt, iinfos, payload, *args, **kw):
        assert popt.type == 2
        out = port_pass2(engine, gopt, popt, iinfos, payload, *args, **kw)
        calls["port"].append(out[1])
        return out

    monkeypatch.delenv("NABWA_B2B_OBJ", raising=False)
    monkeypatch.setattr(jb2b, "pass2_work", jax_pass2)
    monkeypatch.setattr(pb2b, "pass2_work", port_wrapped)
    jopt, jpopt = JaxGapOpt(), JaxPeOpt()
    jpopt.type = 2
    jidx = JaxIndex.load(str(tmp_path / "g.fa"))
    jb2b.bam2bam(JaxEngine(jidx, jopt), str(tmp_path / "in.bam"),
                 str(tmp_path / "jax.bam"), jopt, jpopt,
                 JaxRand48(jidx.bns.seed), argv=["bam2bam"], version="ref")
    opt, popt = GapOpt(), PeOpt()
    popt.type = 2
    idx = BwaIndex.load(str(tmp_path / "g.fa"))
    pb2b.bam2bam(AlnEngine(idx, opt, "cpu"), str(tmp_path / "in.bam"),
                 str(tmp_path / "port.bam"), opt, popt,
                 Rand48(idx.bns.seed), argv=["bam2bam"], version="ref")
    assert calls["jax"] and calls["port"]
    assert calls["port"] == calls["jax"]
    got = (tmp_path / "port.bam").read_bytes()
    assert got == (tmp_path / "jax.bam").read_bytes()
    # SOLiD-oriented pairs pair properly; the decoy-mapped mates' pairs go
    # to the rescue (whose SOLiD branch reads an Illumina mate's codes
    # uncomplemented, so it places none of them, as in the JAX package)
    _, recs = dump_records(str(tmp_path / "port.bam"))
    assert sum(1 for r in recs if r[4] & 2) >= 0.8 * len(recs)
    assert sum(c["n_tot"][0] + c["n_tot"][1] for c in calls["port"]) >= 4


# --- without the reference package ---

def test_colour_without_jax(paired, tmp_path):
    """With `nabwa_tpu` and jax blocked, a fresh interpreter builds the
    colour index with the port's CLI and runs `aln -c` -> `samse` and `aln
    -c` x 2 -> `sampe` on the CPU; every output equals `nabwa_tpu`'s."""
    d = paired
    g = _genome_text((d / "pe.fa").read_bytes())
    (tmp_path / "pe.fa").write_bytes((d / "pe.fa").read_bytes())
    (tmp_path / "r.fq").write_bytes(colour_reads(g, 96, 45, seed=2051,
                                                 indel=0.2))
    p = {"pe.fa": str(tmp_path / "pe.fa"), "r.fq": str(tmp_path / "r.fq"),
         "p1.fq": str(d / "p1.fq"), "p2.fq": str(d / "p2.fq")}
    out = {n: str(tmp_path / f"port_{n}") for n in (
        "r.sai", "p1.sai", "p2.sai", "se.sam", "pe.sam")}
    code = (
        "import sys; sys.modules['jax'] = sys.modules['nabwa_tpu'] = None\n"
        "from nabwa_tpu_torch.cli import main\n"
        f"assert main(['index', '-c', {p['pe.fa']!r}]) == 0\n"
        f"for fq, s in (({p['r.fq']!r}, {out['r.sai']!r}), "
        f"({p['p1.fq']!r}, {out['p1.sai']!r}), ({p['p2.fq']!r}, "
        f"{out['p2.sai']!r})):\n"
        f"    assert main(['aln', '--device', 'cpu', '-c', {p['pe.fa']!r}, "
        "fq, '-f', s]) == 0\n"
        f"assert main(['samse', '--device', 'cpu', {p['pe.fa']!r}, "
        f"{out['r.sai']!r}, {p['r.fq']!r}, '-f', {out['se.sam']!r}]) == 0\n"
        f"assert main(['sampe', '--device', 'cpu', {p['pe.fa']!r}, "
        f"{out['p1.sai']!r}, {out['p2.sai']!r}, {p['p1.fq']!r}, "
        f"{p['p2.fq']!r}, '-f', {out['pe.sam']!r}]) == 0\n"
        "assert not [m for m, v in sys.modules.items() if v is not None "
        "and m.split('.')[0] in ('jax', 'nabwa_tpu')]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    for ext in INDEX_EXTS:
        assert (tmp_path / ("pe.fa" + ext)).read_bytes() == \
            (d / ("pe.fa" + ext)).read_bytes(), ext
    ref = {n: str(tmp_path / f"jax_{n}") for n in out}
    g_ref = str(d / "pe.fa")
    for fq, s in (("r.fq", "r.sai"), ("p1.fq", "p1.sai"),
                  ("p2.fq", "p2.sai")):
        assert ref_cli.main(["aln", "-c", g_ref, p[fq], "-f", ref[s]]) == 0
    assert ref_cli.main(["samse", g_ref, ref["r.sai"], p["r.fq"], "-f",
                         ref["se.sam"]]) == 0
    assert ref_cli.main(["sampe", g_ref, ref["p1.sai"], ref["p2.sai"],
                         p["p1.fq"], p["p2.fq"], "-f", ref["pe.sam"]]) == 0
    for n in out:
        with open(out[n], "rb") as a, open(ref[n], "rb") as b:
            assert a.read() == b.read(), n
    assert open(out["pe.sam"], "rb").read().count(b"XT:A:M") >= 8
