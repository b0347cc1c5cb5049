"""The port's `sampe` slice end to end on the CPU: `python -m
nabwa_tpu_torch sampe --device cpu` must write SAM byte-identical to
`nabwa_tpu sampe` on the same genome, reads and `.sai` files (the JAX
package's own `aln` output).

Pair sets of 96-120 pairs from `tests/test_sampe.make_pairs`: broken mates
(half scrambled, half moved far: the rescue path runs on every candidate
pair), the same with `-s` (no rescue), the duplicated-halves genome
(repeat pairing), mates with a 1-base indel (gapped refinement, reads of
unequal length), and mates that only mate rescue places (each such mate
has three substitutions in its 32-base seed against its true place and an
exact copy on a decoy contig, so `aln` maps it to the decoy and the rescue
finds it beside its partner: XT:A:M).  The host reference route gives the
same bytes, and two chunks in turn carry the insert-size estimate and the
wide-interval memo (a tandem repeat of 1,200 copies) as `nabwa_tpu`'s
driver does.  The SAM bytes are the whole contract: exact equality.
"""

import numpy as np
import pytest

from nabwa_tpu import cli as ref_cli
from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.io import fastq, sai
from nabwa_tpu.models import sampe as jsampe
from nabwa_tpu.models.aln import AlnEngine as JaxEngine
from nabwa_tpu.models.samse import sam_header
from nabwa_tpu.options import GapOpt, PeOpt
from nabwa_tpu.utils.rand48 import Rand48
from nabwa_tpu_torch import cli as port_cli
from nabwa_tpu_torch.models import sampe as msampe
from nabwa_tpu_torch.models.aln import AlnEngine

from . import genomes
from .test_sampe import make_pairs

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _fasta(contigs):
    out = b""
    for name, s in contigs:
        out += b">%s\n%s\n" % (name, b"\n".join(s[i:i + 70]
                                                for i in range(0, len(s), 70)))
    return out


def _indel_mates(fq, frac, seed):
    """A 1-base deletion or insertion in the middle third of a fraction of
    the reads (quality strings follow the length)."""
    rng = np.random.default_rng(seed)
    lines = fq.split(b"\n")
    for r in range(0, len(lines) - 1, 4):
        if rng.random() >= frac:
            continue
        s, q = bytearray(lines[r + 1]), bytearray(lines[r + 3])
        j = int(rng.integers(len(s) // 3, 2 * len(s) // 3))
        if rng.random() < 0.5:
            del s[j], q[j]
        else:
            s.insert(j, ACGT[int(rng.integers(0, 4))])
            q.insert(j, q[j])
        lines[r + 1], lines[r + 3] = bytes(s), bytes(q)
    return b"\n".join(lines)


def _rescued_mates(n_pairs, read_len, seed, frac=0.25):
    """Pairs whose mate carries three seed substitutions against its true
    place and has an exact copy on a second (decoy) contig."""
    rng = np.random.default_rng(seed)
    seq = ACGT[rng.integers(0, 4, size=60000)].tobytes()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    decoy, fq1, fq2 = [], [], []
    for i in range(n_pairs):
        isize = int(rng.normal(250, 25))
        start = int(rng.integers(0, len(seq) - isize))
        r1 = seq[start:start + read_len]
        r2 = bytearray(seq[start + isize - read_len:start + isize][::-1]
                       .translate(comp))
        if rng.random() < frac:
            for j in rng.choice(32, 3, replace=False):
                r2[j] = ACGT[(b"ACGT".index(r2[j])
                              + int(rng.integers(1, 4))) % 4]
            decoy.append(ACGT[rng.integers(0, 4, size=150)].tobytes()
                         + bytes(r2))
        q = b"I" * read_len
        fq1.append(b"@p%d/1\n%s\n+\n%s\n" % (i, r1, q))
        fq2.append(b"@p%d/2\n%s\n+\n%s\n" % (i, bytes(r2), q))
    decoy.append(ACGT[rng.integers(0, 4, size=150)].tobytes())
    return (_fasta([(b"main", seq), (b"decoy", b"".join(decoy))]),
            b"".join(fq1), b"".join(fq2))


def _duplicated_halves():
    rng = np.random.default_rng(17)
    half = rng.integers(0, 4, size=15000)
    seq = ACGT[np.concatenate([half, half,
                               rng.integers(0, 4, size=15000)])].tobytes()
    fq1, fq2 = make_pairs(seq, 100, 40, 200, 25, 19, err_rate=0.01,
                          frac_broken=0.05)
    return _fasta([(b"dup", seq)]), fq1, fq2


def _tandem_repeat():
    """Random flanks around 1,200 copies of a 37-base unit: reads inside
    the repeat have SA intervals of ~1,200 rows, which go through the
    wide-interval memo (MIN_HASH_WIDTH 1000)."""
    rng = np.random.default_rng(71)
    unit = ACGT[rng.integers(0, 4, size=37)].tobytes()
    seq = (ACGT[rng.integers(0, 4, size=30000)].tobytes() + unit * 1200
           + ACGT[rng.integers(0, 4, size=30000)].tobytes())
    fq1, fq2 = make_pairs(seq, 112, 40, 200, 20, 72, err_rate=0.01)
    return _fasta([(b"tandem", seq)]), fq1, fq2


def _random_set(seed, n_pairs, read_len, frac_broken):
    fa, seqs = genomes.random_genome(60000, seed=seed)
    fq1, fq2 = make_pairs(seqs[0], n_pairs, read_len, 250, 30, seed + 1,
                          err_rate=0.01, frac_broken=frac_broken)
    return fa, fq1, fq2


def _indel_set():
    fa, fq1, fq2 = _random_set(331, 100, 60, 0.05)
    return fa, _indel_mates(fq1, 0.4, 332), _indel_mates(fq2, 0.4, 333)


DATA = {
    "broken": lambda: _random_set(301, 120, 50, 0.2),
    "repeats": _duplicated_halves,
    "indels": _indel_set,
    "rescued": lambda: _rescued_mates(120, 50, 311),
}
# name: (data, sampe options)
SETS = {
    "broken": ("broken", []),
    "no_rescue": ("broken", ["-s"]),
    "repeats": ("repeats", []),
    "indels": ("indels", []),
    "rescued": ("rescued", []),
}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    cache = {}

    def make(name):
        key = SETS[name][0]
        if key not in cache:
            d = tmp_path_factory.mktemp(key)
            fa, fq1, fq2 = DATA[key]()
            (d / "g.fa").write_bytes(fa)
            (d / "r1.fq").write_bytes(fq1)
            (d / "r2.fq").write_bytes(fq2)
            build_index(str(d / "g.fa"))
            for end in (1, 2):
                assert ref_cli.main(["aln", str(d / "g.fa"),
                                     str(d / f"r{end}.fq"), "-f",
                                     str(d / f"r{end}.sai")]) == 0
            cache[key] = d
        return cache[key]
    return make


def _args(d):
    return [str(d / n) for n in ("g.fa", "r1.sai", "r2.sai", "r1.fq",
                                 "r2.fq")]


def _jax_sampe(d, opts, out):
    assert ref_cli.main(["sampe", *opts, *_args(d), "-f", str(out)]) == 0
    return out.read_bytes()


def _port_sampe(d, opts, out):
    assert port_cli.main(["sampe", "--device", "cpu", *opts, *_args(d),
                          "-f", str(out)]) == 0
    return out.read_bytes()


def _tags(sam, prefix):
    return [t for ln in sam.splitlines() if not ln.startswith(b"@")
            for t in ln.split(b"\t") if t.startswith(prefix)]


@pytest.mark.parametrize("name", list(SETS))
def test_sampe_cli_matches_jax(made, name):
    d = made(name)
    opts = SETS[name][1]
    want = _jax_sampe(d, opts, d / f"ref_{name}.sam")
    got = _port_sampe(d, opts, d / f"port_{name}.sam")
    assert len(got) == len(want) and got == want
    lines = [ln for ln in got.splitlines() if not ln.startswith(b"@")]
    assert len(lines) >= 192
    flags = [int(ln.split(b"\t")[1]) for ln in lines]
    assert sum(1 for f in flags if f & 0x2) >= len(lines) // 2
    cigars = [ln.split(b"\t")[5] for ln in lines]
    if name == "indels":
        assert sum(1 for c in cigars if b"I" in c or b"D" in c) >= 20
    if name == "repeats":
        assert b"XT:A:R" in _tags(got, b"XT:A:")
    if name == "rescued":
        assert _tags(got, b"XT:A:").count(b"XT:A:M") >= 10


@pytest.mark.parametrize("name", ["rescued", "indels"])
def test_host_reference_route_matches(made, name):
    """sampe_bytes on the host reference route and on the engine's device
    (the plain versions on the CPU), from lists of Read objects and
    per-read tuples: both equal the JAX package's SAM, and the rescue
    parts are timed."""
    d = made(name)
    want = _jax_sampe(d, [], d / f"ref_route_{name}.sam")
    idx = BwaIndex.load(str(d / "g.fa"))
    opt0, alns0 = sai.read_sai_tuples(str(d / "r1.sai"))
    opt, alns1 = sai.read_sai_tuples(str(d / "r2.sai"))
    reads = [fastq.read_fastq_batch(fastq.iter_fastq(str(d / f"r{e}.fq")),
                                    1000, trim_qual=o.trim_qual)
             for e, o in ((1, opt0), (2, opt))]
    eng = AlnEngine(idx, opt, "cpu")
    header = sam_header(idx.bns).encode()
    for ref_route in (True, False):
        before = dict(msampe.seconds)
        body, ii = msampe.sampe_bytes(eng, tuple(reads), (alns0, alns1), opt,
                                      PeOpt(), Rand48(idx.bns.seed),
                                      host_reference=ref_route)
        assert header + body == want
        assert ii.avg > 0
        for part in ("select", "sa", "pairing", "rescue_fwd", "rescue_rev",
                     "rescue_path", "md", "emit"):
            assert msampe.seconds[part] > before[part], part
        if name == "indels":
            assert msampe.seconds["dp"] > before["dp"]


def test_two_chunks_carry_isize_and_memo(tmp_path):
    """Two chunks in turn, 100 pairs then 12 (too few for an insert-size
    estimate of their own), with the insert size and the wide-interval memo
    carried over: each chunk's bytes equal `nabwa_tpu`'s sampe called the
    same way."""
    fa, fq1, fq2 = _tandem_repeat()
    (tmp_path / "g.fa").write_bytes(fa)
    (tmp_path / "r1.fq").write_bytes(fq1)
    (tmp_path / "r2.fq").write_bytes(fq2)
    build_index(str(tmp_path / "g.fa"))
    idx = BwaIndex.load(str(tmp_path / "g.fa"))
    opt, popt = GapOpt(), PeOpt()
    jeng = JaxEngine(idx, opt)
    reads, alns = [], []
    for end in (1, 2):
        rd = fastq.read_fastq_batch(
            fastq.iter_fastq(str(tmp_path / f"r{end}.fq")), 1000)
        reads.append(rd)
        alns.append([a for a, _ in jeng.run_chunk(rd)])
    eng = AlnEngine(idx, opt, "cpu")
    jrng, rng = Rand48(idx.bns.seed), Rand48(idx.bns.seed)
    jmemo, memo = {}, {}
    jii = ii = None
    for lo, hi in ((0, 100), (100, 112)):
        r = (reads[0][lo:hi], reads[1][lo:hi])
        a = (alns[0][lo:hi], alns[1][lo:hi])
        want, jii_new = jsampe.sampe(jeng, r, a, opt, popt, jrng,
                                     last_ii=jii, pos_memo=jmemo)
        got, ii_new = msampe.sampe_bytes(eng, r, a, opt, popt, rng,
                                         last_ii=ii, pos_memo=memo)
        assert got == want
        assert (ii_new.avg, ii_new.std, ii_new.high) == \
            (jii_new.avg, jii_new.std, jii_new.high)
        if lo:
            assert ii_new is ii and jii_new is jii
        jii, ii = jii_new, ii_new
        assert rng.x == jrng.x
    assert memo and sorted(memo) == sorted(jmemo)
    assert all(np.array_equal(memo[k], jmemo[k]) for k in memo)


def test_sampe_options_match_jax(made):
    """-n/-N (multi hits), -a, -o, -c, -A and -r as in the JAX CLI."""
    d = made("repeats")
    opts = ["-n", "5", "-N", "8", "-a", "400", "-o", "5000", "-c", "0.001",
            "-A", "-r", r"@RG\tID:pe1\tSM:s"]
    want = _jax_sampe(d, opts, d / "ref_opts.sam")
    got = _port_sampe(d, opts, d / "port_opts.sam")
    assert got == want and b"RG:Z:pe1" in got


def test_sampe_cuda_device_required(made, monkeypatch):
    """`--device cuda` (the default) without a CUDA device exits non-zero
    and never falls back to the CPU."""
    d = made("broken")
    monkeypatch.setattr(port_cli.torch.cuda, "is_available", lambda: False)
    out = d / "nocuda.sam"
    rc = port_cli.main(["sampe", *_args(d), "-f", str(out)])
    assert rc != 0 and not out.exists()


def test_sampe_colour_space_not_ported(made):
    """Colour space is ported: on a colour index of the same genome
    (`build_index(color=True)`), both ends' colour `.sai` of `nabwa_tpu aln
    -c` go through the port's `sampe` (BWA_PET_SOLID pairing, cs2nt
    decoding) to the bytes of `nabwa_tpu sampe`."""
    from .test_torch_colour import colour_pairs
    d = made("broken")
    cs = str(d / "cs.fa")
    build_index(str(d / "g.fa"), cs, color=True)
    g = b"".join(ln for ln in (d / "g.fa").read_bytes().split(b"\n")
                 if not ln.startswith(b">"))
    fqs = colour_pairs(g, 100, 40, seed=861)[:2]
    for e, fq in zip((1, 2), fqs):
        (d / f"colour{e}.fq").write_bytes(fq)
        assert ref_cli.main(["aln", "-c", cs, str(d / f"colour{e}.fq"),
                             "-f", str(d / f"colour{e}.sai")]) == 0
    args = [cs, str(d / "colour1.sai"), str(d / "colour2.sai"),
            str(d / "colour1.fq"), str(d / "colour2.fq")]
    assert ref_cli.main(["sampe", *args, "-f", str(d / "colour.jax.sam")]) == 0
    assert port_cli.main(["sampe", "--device", "cpu", *args, "-f",
                          str(d / "colour.sam")]) == 0
    got = (d / "colour.sam").read_bytes()
    assert got == (d / "colour.jax.sam").read_bytes()
    flags = [int(ln.split(b"\t")[1]) for ln in got.splitlines()
             if not ln.startswith(b"@")]
    assert len(flags) == 200 and sum(1 for f in flags if f & 2) >= 140
