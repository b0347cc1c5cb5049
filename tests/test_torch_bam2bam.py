"""The port's `bam2bam` slice on the CPU: `python -m nabwa_tpu_torch bam2bam
--device cpu` must write BAM files byte-identical to
`nabwa_tpu.models.bam2bam.bam2bam` called directly on the same index and
unaligned BAM, on both of the JAX package's pass-2 routes (the columnar
default and the per-object one, `NABWA_B2B_OBJ=1`).

Input sets, each an unaligned BAM of 80 records or more built with the
port's `io/bam.py` from reads drawn with numpy from a seed:
  dist      the fixture of tests/test_bam2bam_dist.py: 50 kbp, 70 pairs
            (10 % broken mates) and 18 singletons, seeds 301-303;
  groups    two read groups, rg1 at insert size 250 +- 30 and rg2 at
            500 +- 50 with too few pairs for an estimate (its pairs rescue
            with the null estimate), in one rescue batch;
  rescued   mates only the rescue places through a decoy contig (as
            tests/test_torch_sampe.py builds them), N bases in some reads;
  per_read  `-q 20 -n 0.04 -o 3` on reads of 36, 60 and 100 bp with
            low-quality tails, so each read's own max_diff and clamped
            max_gapo split the reads into groups;
  flags     `--only-aligned --skip-duplicates --broken-input` on records
            flagged as duplicates, unmappable pairs, a lone mate, a pair
            with wrong flags and a paired read cut off by the end of file.
A sixth set, `repeats` (a genome whose first 15 kbp occur twice, so reads
there have equal-scoring hits), holds the counter-mode RNG to the JAX
package's.  Each index comes from `nabwa_tpu.index.build.build_index`.
The port runs on the CPU device, so C1-C5 run as their plain PyTorch
versions.
Tolerance: exact, whole files.

The scheduler cases are the port's twins of tests/test_bam2bam_dist.py:
four workers on chunks of 16, injected chunk failures and a straggler,
and counter-mode RNG across chunk sizes each equal the sequential run
(the counter-mode bytes also equal nabwa_tpu's, and `hash_64` its).
Module cases hold `AlnEngine.run_chunk(per_read_semantics=True)`,
`paired_sw_batch` with one estimate per pair and `io/bam.py` to the JAX
package; the host reference route, a jax-blocked interpreter, a non-power-
of-two `sa_intv`, `aln -b` and the CLI's refusals complete the slice.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nabwa_tpu import cli as ref_cli
from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex as JaxIndex
from nabwa_tpu.io import bam as jbam
from nabwa_tpu.io import fastq as jfastq
from nabwa_tpu.models import bam2bam as jb2b
from nabwa_tpu.models import sampe as jsampe
from nabwa_tpu.models import samse as jsamse
from nabwa_tpu.models.aln import AlnEngine as JaxEngine
from nabwa_tpu.options import GapOpt as JaxGapOpt
from nabwa_tpu.options import PeOpt as JaxPeOpt
from nabwa_tpu.refmodel.fm_scalar import ScalarFm
from nabwa_tpu.utils.rand48 import Rand48 as JaxRand48
from nabwa_tpu_torch import cli as port_cli
from nabwa_tpu_torch.index.fmindex import BwaIndex
from nabwa_tpu_torch.io import bam as pbam
from nabwa_tpu_torch.io import fastq as pfastq
from nabwa_tpu_torch.models import aln as maln
from nabwa_tpu_torch.models import bam2bam as pb2b
from nabwa_tpu_torch.models import sampe as psampe
from nabwa_tpu_torch.models import samse as psamse
from nabwa_tpu_torch.models.aln import AlnEngine
from nabwa_tpu_torch.ops import dp as pdp
from nabwa_tpu_torch.options import GapOpt, PeOpt
from nabwa_tpu_torch.refmodel.stdaln_scalar import ALN_PARAM_BWA
from nabwa_tpu_torch.utils.rand48 import Rand48

from . import genomes
from .test_bam2bam import dump_records
from .test_sampe import make_pairs
from .test_torch_sampe import _rescued_mates
from .test_torch_smoke import BLOCKED, REPO

PAIR1 = pbam.BAM_FPAIRED | pbam.BAM_FREAD1 | 8
PAIR2 = pbam.BAM_FPAIRED | pbam.BAM_FREAD2 | 8
DUP = 0x400


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (see tests/test_torch_extend.py):
    the plain versions are loops of small tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- input sets ---

def _fq_records(fq):
    lines = fq.strip().split(b"\n")
    for i in range(0, len(lines), 4):
        yield (lines[i][1:].decode().split("/")[0], lines[i + 1].decode(),
               lines[i + 3].decode())


def _rec(name, flag, seq, qual, rg):
    """An unaligned record (the layout of tests/test_bam2bam.py's input)."""
    r = pbam.sam_to_bamrec(name, flag | pbam.BAM_FUNMAP, -1, -1, 0, [], -1,
                           -1, 0, seq, qual, b"RGZ%s\x00" % rg.encode())
    r.bin = 0
    return r


def _pairs(fq1, fq2, rg):
    out = []
    for (n1, s1, q1), (n2, s2, q2) in zip(_fq_records(fq1),
                                          _fq_records(fq2)):
        out += [_rec(n1, PAIR1, s1, q1, rg), _rec(n2, PAIR2, s2, q2, rg)]
    return out


def _singles(fq, rg):
    return [_rec(n, 0, s, q, rg) for n, s, q in _fq_records(fq)]


def _header(rgs):
    return "@HD\tVN:1.4\n" + "".join(f"@RG\tID:{g}\tSM:s{g}\n" for g in rgs)


def _low_quality_tails(fq, seed, frac=0.5):
    """Quality 2 ('#') over a random tail of a fraction of the reads, so
    -q 20 trims them to lengths between 35 bp and their full length."""
    rng = np.random.default_rng(seed)
    lines = fq.split(b"\n")
    for r in range(0, len(lines) - 1, 4):
        if rng.random() < frac:
            q = bytearray(lines[r + 3])
            cut = int(rng.integers(5, max(6, len(q) - 35)))
            q[len(q) - cut:] = b"#" * cut
            lines[r + 3] = bytes(q)
    return b"\n".join(lines)


def _with_n(fq, every=7):
    lines = fq.split(b"\n")
    for k, r in enumerate(range(0, len(lines) - 1, 4)):
        if k % every == 0:
            s = bytearray(lines[r + 1])
            s[10:12] = b"NN"
            lines[r + 1] = bytes(s)
    return b"\n".join(lines)


def _dist_genome():
    return genomes.random_genome(50000, seed=301)


def _set_dist():
    fa, seqs = _dist_genome()
    fq1, fq2 = make_pairs(seqs[0], 70, 50, 250, 30, 302, err_rate=0.01,
                          frac_broken=0.1)
    singles = genomes.sample_reads(seqs[0], 18, 40, seed=303, err_rate=0.02)
    return fa, _pairs(fq1, fq2, "rg1") + _singles(singles, "rg1"), ["rg1"]


def _set_groups():
    fa, seqs = _dist_genome()
    a1, a2 = make_pairs(seqs[0], 60, 50, 250, 30, 322, err_rate=0.01,
                        frac_broken=0.1)
    b1, b2 = make_pairs(seqs[0], 14, 50, 500, 50, 323, err_rate=0.01,
                        frac_broken=0.3)
    return (fa, _pairs(a1, a2, "rg1") + _pairs(b1, b2, "rg2"),
            ["rg1", "rg2"])


def _set_rescued():
    fa, fq1, fq2 = _rescued_mates(90, 50, 331)
    return fa, _pairs(_with_n(fq1), fq2, "rg1"), ["rg1"]


def _set_per_read():
    fa, seqs = _dist_genome()
    fq1, fq2 = make_pairs(seqs[0], 30, 60, 250, 30, 341, err_rate=0.01,
                          frac_broken=0.1)
    g1, g2 = make_pairs(seqs[0], 10, 100, 300, 30, 342, err_rate=0.01)
    s36 = genomes.sample_reads(seqs[0], 16, 36, seed=343, err_rate=0.01)
    recs = (_pairs(_low_quality_tails(fq1, 344), fq2, "rg1")
            + _pairs(g1, _low_quality_tails(g2, 345), "rg1")
            + _singles(s36, "rg1"))
    return fa, recs, ["rg1"]


def _set_flags():
    fa, seqs = _dist_genome()
    fq1, fq2 = make_pairs(seqs[0], 56, 50, 250, 30, 351, err_rate=0.01,
                          frac_broken=0.1)
    junk = genomes.random_genome(4000, seed=352)[1][0]
    j1, j2 = make_pairs(junk, 6, 50, 250, 30, 353)
    singles = genomes.sample_reads(seqs[0], 14, 40, seed=354, err_rate=0.02)
    recs = _pairs(fq1, fq2, "rg1")
    for i in range(0, len(recs), 18):           # duplicates, either end
        recs[i + (i // 18) % 2].flag |= DUP
    recs[21].flag = (recs[21].flag & ~pbam.BAM_FREAD2) | pbam.BAM_FREAD1
    del recs[41]                                # a lone mate
    recs += _pairs(j1, j2, "rg1")               # unmappable pairs
    sg = _singles(singles, "rg1")
    for i in range(0, len(sg), 5):
        sg[i].flag |= DUP
    name, s, q = next(_fq_records(j1))
    recs += sg + [_rec(name, PAIR1, s, q, "rg1")]   # cut off by the EOF
    return fa, recs, ["rg1"]


def _set_repeats():
    """A genome whose first 15 kbp occur twice: reads from there have two
    equal-scoring hits, so the hit each one reports depends on the RNG."""
    rng = np.random.default_rng(311)
    half = rng.integers(0, 4, size=15000)
    codes = np.concatenate([half, half, rng.integers(0, 4, size=20000)])
    seq = genomes.BASES[codes].tobytes()
    fa = b">dup\n" + b"\n".join(seq[i:i + 70]
                                for i in range(0, len(seq), 70)) + b"\n"
    fq1, fq2 = make_pairs(seq, 60, 40, 200, 25, 312, err_rate=0.01,
                          frac_broken=0.05)
    singles = genomes.sample_reads(seq, 24, 40, seed=313, err_rate=0.01)
    return fa, _pairs(fq1, fq2, "rg1") + _singles(singles, "rg1"), ["rg1"]


DATA = {"dist": _set_dist, "groups": _set_groups, "rescued": _set_rescued,
        "per_read": _set_per_read, "flags": _set_flags,
        "repeats": _set_repeats}
# name: (CLI flags, GapOpt fields, bam2bam keywords) of the JAX call
SETS = {
    "dist": ([], {}, {}),
    "groups": ([], {}, {}),
    "rescued": ([], {}, {}),
    "per_read": (["-q", "20", "-n", "0.04", "-o", "3"],
                 dict(trim_qual=20, fnr=0.04, max_diff=-1, max_gapo=3), {}),
    "flags": (["--only-aligned", "--skip-duplicates", "--broken-input"], {},
              dict(only_aligned=True, skip_duplicates=True,
                   broken_input=True)),
}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """name -> directory with g.fa (indexed by nabwa_tpu's build_index) and
    in.bam, made once per module."""
    cache = {}

    def make(name):
        if name not in cache:
            d = tmp_path_factory.mktemp(name)
            fa, recs, rgs = DATA[name]()
            assert len(recs) >= 80
            (d / "g.fa").write_bytes(fa)
            build_index(str(d / "g.fa"))
            pbam.make_bam(str(d / "in.bam"), [], recs, text=_header(rgs))
            cache[name] = d
        return cache[name]
    return make


def _jax_b2b(d, out, argv, opt_fields=None, prefix="g.fa", **kw):
    """nabwa_tpu.models.bam2bam.bam2bam called directly: a JAX AlnEngine,
    Rand48 seeded from the index, the reference's version string."""
    opt, popt = JaxGapOpt(), JaxPeOpt()
    for k, v in (opt_fields or {}).items():
        setattr(opt, k, v)
    idx = JaxIndex.load(str(d / prefix))
    jb2b.bam2bam(JaxEngine(idx, opt), str(d / "in.bam"), str(out), opt,
                 popt, JaxRand48(idx.bns.seed), argv=argv, version="ref",
                 **kw)
    return out.read_bytes()


def _port_b2b(d, out, engine=None, prefix="g.fa", **kw):
    """The port's bam2bam called directly, argv ["bam2bam"]."""
    idx = BwaIndex.load(str(d / prefix))
    opt = engine.opt if engine is not None else GapOpt()
    eng = engine or AlnEngine(idx, opt, "cpu")
    pb2b.bam2bam(eng, str(d / "in.bam"), str(out), opt, PeOpt(),
                 Rand48(idx.bns.seed), argv=["bam2bam"], **kw)
    return out.read_bytes()


def _blob(path):
    return pbam.bgzf_decompress(path.read_bytes())


@pytest.mark.parametrize("name", list(SETS))
def test_bam2bam_cli_matches_jax(made, name, monkeypatch, tmp_path,
                                 capsys):
    d = made(name)
    flags, opt_fields, kw = SETS[name]
    out = tmp_path / "port.bam"
    rest = ["-g", str(d / "g.fa"), *flags, "-f", str(out), str(d / "in.bam")]
    assert port_cli.main(["bam2bam", "--device", "cpu", *rest]) == 0
    err = capsys.readouterr().err
    got = out.read_bytes()
    argv = ["bam2bam"] + rest
    monkeypatch.delenv("NABWA_B2B_OBJ", raising=False)
    want = _jax_b2b(d, tmp_path / "col.bam", argv, opt_fields, **kw)
    monkeypatch.setenv("NABWA_B2B_OBJ", "1")
    want_obj = _jax_b2b(d, tmp_path / "obj.bam", argv, opt_fields, **kw)
    assert got == want
    assert got == want_obj
    text, recs = dump_records(str(out))
    assert (text, recs) == dump_records(str(tmp_path / "col.bam"))
    mapped = [r for r in recs if not r[4] & 4]
    assert len(mapped) >= 60
    blob = _blob(out)
    if name == "groups":
        assert "ID:rg2" in text and b"RGZrg2" in blob
        assert "rg1: qu(" in err and "rg2: too few good pairs" in err
    if name == "rescued":
        assert blob.count(b"XTAM") >= 10
    if name == "flags":
        n_in = len(dump_records(str(d / "in.bam"))[1])
        assert len(recs) < n_in - 12
        assert all(not r[4] & 4 for r in recs)          # --only-aligned
    if name == "per_read":
        trimmed = blob.count(b"XCi")
        assert trimmed >= 10


# --- the scheduler, the port's twins of tests/test_bam2bam_dist.py ---

@pytest.fixture(scope="module")
def sequential(made, tmp_path_factory):
    """The dist set through the port's bam2bam, one worker, the default
    engine on the plain versions."""
    d = made("dist")
    return _port_b2b(d, tmp_path_factory.mktemp("seq") / "seq.bam")


def _host_run(d, out, **kw):
    """The host reference route: the scheduler cases below test chunking,
    redelivery and the RNG streams, which no route changes, at host
    speed."""
    return _port_b2b(d, out, host_reference=True, **kw)


def test_workers_match_sequential(made, sequential, tmp_path):
    d = made("dist")
    got = _host_run(d, tmp_path / "dist.bam", n_workers=4, chunk_size=16)
    assert got == sequential


def test_worker_threads_share_the_engine(made, sequential, tmp_path):
    """Four worker threads on one engine's device tiers (the plain
    versions here) give the sequential bytes, and the engine's tier
    counters equal a one-worker run's on the same chunks: they change only
    under the engine's lock.  Tier 0 is capped at 32 iterations without a
    retry tier, so the reads it flags go to the bit-exact host drain and
    the case stays quick."""
    d = made("dist")
    counts = []
    for n_workers in (1, 4):
        eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(), "cpu",
                        retry_stack_cap=256, max_iters=32)
        got = _port_b2b(d, tmp_path / f"t{n_workers}.bam", engine=eng,
                        n_workers=n_workers, chunk_size=32)
        assert got == sequential
        counts.append((eng.tier0_reads, eng.retry_reads,
                       eng.host_drain_reads))
        assert eng.native_threads == (0 if n_workers == 1 else
                                      max(1, (os.cpu_count() or 1) // 4))
    assert counts[0] == counts[1]
    assert sum(counts[0]) == 158 and counts[0][0] > 0 and counts[0][2] > 0


def test_injected_failures_match_sequential(made, sequential, tmp_path):
    """Worker 0 fails the first attempt of every chunk it picks up; worker
    1 is a straggler.  Redelivery gives the sequential bytes."""
    d = made("dist")
    filed = set()
    lock = threading.Lock()

    def chaotic(wid, fn):
        def wrapped(cid, payload):
            if wid == 0:
                with lock:
                    first = cid not in filed
                    filed.add(cid)
                if first:
                    raise RuntimeError("injected chunk loss")
            if wid == 1:
                time.sleep(0.02)
            return fn(cid, payload)
        return wrapped

    got = _host_run(d, tmp_path / "chaos.bam", n_workers=4, chunk_size=8,
                    worker_wrapper=chaotic)
    assert filed and got == sequential


def test_counter_rng_chunk_invariant(made, tmp_path):
    """rng_mode="counter" on reads with equal-scoring hits: one stream per
    record, so the bytes do not change with the chunk size or the number
    of workers; they equal nabwa_tpu's counter-mode bam2bam, and differ
    from the shared drand48 stream's (so the mode is not ignored)."""
    d = made("repeats")
    a = _host_run(d, tmp_path / "a.bam", chunk_size=1000,
                  rng_mode="counter")
    b = _host_run(d, tmp_path / "b.bam", n_workers=4, chunk_size=7,
                  rng_mode="counter")
    assert a == b
    want = _jax_b2b(d, tmp_path / "jax.bam", ["bam2bam"], chunk_size=7,
                    rng_mode="counter")
    assert a == want
    drand = _host_run(d, tmp_path / "drand48.bam")
    assert drand == _jax_b2b(d, tmp_path / "jax48.bam", ["bam2bam"])
    ra, rd = dump_records(str(tmp_path / "a.bam"))[1], \
        dump_records(str(tmp_path / "drand48.bam"))[1]
    assert len(ra) == len(rd) == 144
    assert sum(x != y for x, y in zip(ra, rd)) >= 5


def test_hash_64_matches_jax():
    """The counter RNG's seed hash (bwape.c:43-54) equals nabwa_tpu's on
    keys across the 64-bit range, wrap-around included."""
    rng = np.random.default_rng(315)
    keys = [0, 1, 2, 0xFFFFFFFF, 1 << 32, (1 << 63) - 1, 1 << 63,
            (1 << 64) - 1] + [int(k) for k in rng.integers(
                0, 1 << 63, 500, dtype=np.uint64)] + [
        (int(k) << 1) | 1 for k in rng.integers(0, 1 << 63, 500,
                                                dtype=np.uint64)]
    got = [psampe.hash_64(k) for k in keys]
    assert got == [jsampe.hash_64(k) for k in keys]
    assert len(set(got)) == len(keys) and max(got) < 1 << 64


def test_host_reference_route_matches(made, sequential, tmp_path):
    """host_reference=True (the native DFS, SA walk and DPs) gives the
    plain route's bytes, and its DFS ran on the host engine."""
    d = made("dist")
    idx = BwaIndex.load(str(d / "g.fa"))
    eng = AlnEngine(idx, GapOpt(), "cpu")
    got = _port_b2b(d, tmp_path / "host.bam", engine=eng,
                    host_reference=True)
    assert got == sequential
    assert eng.seconds["drain"] > 0 and eng.tier0_reads == 0
    assert set(pb2b.seconds) == {"read + pass 1 align", "pass 2 finish",
                                 "write output"}


# --- module cases ---

def _mixed_reads(seed):
    fa, seqs = _dist_genome()
    fq = b"".join(genomes.sample_reads(seqs[0], n, ln, seed=seed + k,
                                       err_rate=0.02, indel_rate=0.3)
                  for k, (n, ln) in enumerate(((30, 36), (30, 60),
                                               (24, 100))))
    return fa, fq


@pytest.mark.parametrize("case", ["fnr", "clamped"])
def test_run_chunk_per_read_matches_jax(tmp_path, case):
    """Per-read semantics on 84 reads of 36, 60 and 100 bp: with -n 0.04
    and -o 3 each read's max_diff splits them into two groups; with an
    integer -n 1 below -o 2 every read is clamped to one gap open.  Every
    read's hits equal the JAX engine's, through tier 0 at its default cap
    (the reads it flags drained on the host, not retried, to keep the case
    quick) and on the host reference route; the host route's high-water
    marks equal the JAX engine's too, which on the CPU drains every group
    on the same host engine (the device tiers count theirs as the JAX
    device DFS does, tests/test_torch_dfs.py)."""
    fa, fq = _mixed_reads(361)
    (tmp_path / "g.fa").write_bytes(fa)
    (tmp_path / "r.fq").write_bytes(fq)
    build_index(str(tmp_path / "g.fa"))
    fields = (dict(fnr=0.04, max_diff=-1, max_gapo=3) if case == "fnr"
              else dict(fnr=-1.0, max_diff=1, max_gapo=2))
    opt, jopt = GapOpt(**fields), JaxGapOpt(**fields)
    reads = pfastq.read_fastq_batch(pfastq.iter_fastq(str(tmp_path / "r.fq")),
                                    1000)
    jreads = jfastq.read_fastq_batch(
        jfastq.iter_fastq(str(tmp_path / "r.fq")), 1000)
    lens = np.array([r.len for r in reads], dtype=np.int32)
    _, groups = maln.per_read_groups(opt, lens)
    if case == "fnr":
        assert sorted(g.max_gapo for g, _ in groups) == [2, 3]
    else:
        assert [g.max_gapo for g, _ in groups] == [1]
    idx = BwaIndex.load(str(tmp_path / "g.fa"))
    eng = AlnEngine(idx, opt, "cpu", retry_stack_cap=256, max_iters=768)
    got = eng.run_chunk(reads, per_read_semantics=True)
    host = AlnEngine(idx, opt, "cpu").run_chunk(
        reads, per_read_semantics=True, host_reference=True)
    want = JaxEngine(JaxIndex.load(str(tmp_path / "g.fa")), jopt).run_chunk(
        jreads, per_read_semantics=True)
    assert len(got) == len(host) == len(want) == 84
    for i, ((a, _), (h, hw), (b, jhw)) in enumerate(zip(got, host, want)):
        want_hits = [tuple(map(int, x)) for x in b]
        assert [tuple(map(int, x)) for x in a] == want_hits, i
        assert [tuple(map(int, x)) for x in h] == want_hits, i
        assert int(hw) == int(jhw), i
    assert sum(1 for a, _ in got if a) >= (70 if case == "fnr" else 40)
    assert eng.tier0_reads >= 60


def test_paired_sw_batch_per_pair_isize(tmp_path):
    """One IsizeInfo per pair: mates 250 bp from their anchor are rescued
    with an estimate of 250 +- 20 and missed with one of 600 +- 10, in
    the same batch; every state field equals the JAX package's
    paired_sw_batch on the same pairs."""
    rng = np.random.default_rng(371)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = acgt[rng.integers(0, 4, 60000)].tobytes()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    fa = b">g\n" + b"\n".join(seq[i:i + 70] for i in range(0, len(seq), 70))
    (tmp_path / "g.fa").write_bytes(fa + b"\n")
    build_index(str(tmp_path / "g.fa"))
    n, ln = 24, 50
    starts = rng.integers(1000, 58000, n)
    isz = rng.normal(250, 20, n).astype(int)
    fqs = [[], []]
    for i in range(n):
        r1 = seq[starts[i]:starts[i] + ln]
        e = starts[i] + isz[i]
        r2 = seq[e - ln:e][::-1].translate(comp)
        for end, r in enumerate((r1, r2)):
            fqs[end].append(b"@p%d\n%s\n+\n%s\n" % (i, r, b"I" * ln))
    for end in (0, 1):
        (tmp_path / f"r{end}.fq").write_bytes(b"".join(fqs[end]))

    def states(fastq, SeqState, IsizeInfo):
        reads = [fastq.read_fastq_batch(
            fastq.iter_fastq(str(tmp_path / f"r{end}.fq")), 100)
            for end in (0, 1)]
        pairs, iis = [], []
        for i in range(n):
            s0, s1 = SeqState(reads[0][i]), SeqState(reads[1][i])
            s0.type, s0.pos, s0.strand = 1, int(starts[i]), 0
            s1.type, s1.pos, s1.strand = 1, int(rng_far[i]), 1
            s0.mapQ = s0.seQ = 37
            s1.mapQ = s1.seQ = 23
            s0.extra_flag, s1.extra_flag = 0x41, 0x81
            pairs.append((s0, s1))
            ii = IsizeInfo()
            ii.avg, ii.std, ii.ap_prior = ((250.0, 20.0, 1e-5) if i % 3
                                           else (600.0, 10.0, 1e-5))
            ii.low, ii.high, ii.high_bayesian = 100, 400, 420
            iis.append(ii)
        return pairs, iis

    rng_far = rng.integers(1000, 58000, n)
    bns = BwaIndex.load(str(tmp_path / "g.fa"))
    jbns = JaxIndex.load(str(tmp_path / "g.fa"))
    got, iis = states(pfastq, psamse.SeqState, psampe.IsizeInfo)
    want, jiis = states(jfastq, jsamse.SeqState, jsampe.IsizeInfo)
    counters = {"n_tot": [0, 0], "n_mapped": [0, 0]}
    jcounters = {"n_tot": [0, 0], "n_mapped": [0, 0]}
    psampe.paired_sw_batch(
        bns.bns, bns.pac, got, PeOpt(), iis, counters,
        lambda jobs: pdp.local_sw_batch(jobs, ALN_PARAM_BWA, "cpu", thres=1))
    jsampe.paired_sw_batch(jbns.bns, jbns.pac, want, JaxPeOpt(), jiis,
                           jcounters)
    assert counters == jcounters
    fields = ("type", "pos", "strand", "mapQ", "seQ", "n_mm", "n_gapo",
              "n_gape", "extra_flag", "cigar")
    for p, q in zip(got, want):
        for s, t in zip(p, q):
            assert [getattr(s, f) for f in fields] == \
                [getattr(t, f) for f in fields]
    placed = [i for i, p in enumerate(got) if p[1].type == 3]
    assert len(placed) >= 8 and all(i % 3 for i in placed)


def _records(rng, n):
    recs = []
    for i in range(n):
        ln = int(rng.integers(1, 160))
        seq = "".join("ACGTN"[int(c)] for c in rng.integers(0, 5, ln))
        qual = [int(q) for q in rng.integers(2, 41, ln)]
        cig = [(0, ln)] if i % 3 else []
        tags = b"RGZg%d\x00" % (i % 2) + b"XTAU" + b"NMi" + bytes(4)
        recs.append((f"r{i}", 0x41 if i % 2 else 0, i % 4 - 1, i * 37, 60,
                     cig, -1, -1, 0, seq, qual, tags))
    return recs


def test_bam_round_trip_and_bytes_match_jax(tmp_path):
    """make_bam -> BamReader gives the records back (core fields, data,
    read group); the file's bytes equal nabwa_tpu.io.bam's on the same
    records, over several BGZF blocks."""
    rng = np.random.default_rng(381)
    spec = _records(rng, 700)
    refs = [("c1", 5000), ("c2", 300000)]
    text = "@HD\tVN:1.4\n@RG\tID:g0\n@RG\tID:g1\n"
    mine = [pbam.sam_to_bamrec(*r) for r in spec]
    theirs = [jbam.sam_to_bamrec(*r) for r in spec]
    pbam.make_bam(str(tmp_path / "p.bam"), refs, mine, text=text)
    jbam.make_bam(str(tmp_path / "j.bam"), refs, theirs, text=text)
    raw = (tmp_path / "p.bam").read_bytes()
    assert raw == (tmp_path / "j.bam").read_bytes()
    assert raw.count(b"\x1f\x8b\x08\x04") >= 3 and raw.endswith(
        pbam.BGZF_EOF)
    rd = pbam.BamReader(str(tmp_path / "p.bam"))
    assert rd.text == text and rd.refs == refs
    for i, r in enumerate(mine):
        b = rd.read1()
        assert [getattr(b, f) for f in pbam.BamRec.__slots__] == \
            [getattr(r, f) for f in pbam.BamRec.__slots__]
        assert b.get_rg() == f"g{i % 2}"
        assert b.cigar_list() == spec[i][5]
    assert rd.read1() is None


def test_bgzf_and_reg2bin_match_jax():
    """BGZF blocks of one large write, the decompression back, and
    reg2bin at every binning level equal nabwa_tpu.io.bam's."""
    import io
    rng = np.random.default_rng(383)
    payload = rng.integers(0, 7, 300000).astype(np.uint8).tobytes()
    outs = []
    for mod in (pbam, jbam):
        f = io.BytesIO()
        w = mod.BgzfWriter(f, level=2)
        w.write(payload[:1000])
        w.write(payload[1000:])
        w.close()
        outs.append(f.getvalue())
    assert outs[0] == outs[1]
    assert pbam.bgzf_decompress(outs[0]) == payload
    for beg, end in ((0, 1), (16383, 16390), (100000, 200000),
                     (1 << 20, (1 << 23) + 5), (5, 1 << 27)):
        assert pbam.reg2bin(beg, end) == jbam.reg2bin(beg, end)


# --- a non-power-of-two sa_intv ---

def _index_24(d):
    """The dist genome indexed at sa_intv 24 beside its default index."""
    fa, _ = _dist_genome()
    (d / "g24.fa").write_bytes(fa)
    build_index(str(d / "g24.fa"), sa_intv=24)
    idx = BwaIndex.load(str(d / "g24.fa"))
    assert idx.fwd.sa_intv == 24
    return idx


def test_samse_sa_intv_24(made, tmp_path, monkeypatch):
    """samse on an index sampled every 24 rows: the native batch walk masks
    with sa_intv - 1, so the host reference route walks with the modulo
    instead.  The SA rows equal ScalarFm.sa; the port's samse, on the card
    route's plain versions and on the host reference route, equals
    nabwa_tpu's samse on the same genome's default index (the JAX
    package's host walk takes powers of two only)."""
    d = made("dist")
    idx = _index_24(d)
    for a in (1, 0):
        fm = idx.fwd if a else idx.rev
        rows = np.arange(0, fm.seq_len + 1, 37, dtype=np.uint32)
        sfm = ScalarFm(fm.bwt, fm.primary, fm.l2, fm.seq_len, fm.sa,
                       fm.sa_intv)
        want = np.array([sfm.sa(int(r)) for r in rows], dtype=np.uint32)
        np.testing.assert_array_equal(psamse.sa_rows_native(idx, a, rows),
                                      want)
    fa, seqs = _dist_genome()
    (tmp_path / "r.fq").write_bytes(genomes.sample_reads(
        seqs[0], 96, 60, seed=391, err_rate=0.02, indel_rate=0.4))
    sai = tmp_path / "r.sai"
    monkeypatch.setenv("NABWA_FORCE_NATIVE", "1")   # its bit-exact host DFS
    assert ref_cli.main(["aln", str(d / "g.fa"), str(tmp_path / "r.fq"),
                         "-f", str(sai)]) == 0
    assert ref_cli.main(["samse", str(d / "g.fa"), str(sai),
                         str(tmp_path / "r.fq"), "-f",
                         str(tmp_path / "ref.sam")]) == 0
    want = (tmp_path / "ref.sam").read_bytes()
    assert port_cli.main(["samse", "--device", "cpu", str(d / "g24.fa"),
                          str(sai), str(tmp_path / "r.fq"), "-f",
                          str(tmp_path / "port.sam")]) == 0
    assert (tmp_path / "port.sam").read_bytes() == want
    opt, per_read = port_cli.read_sai(str(sai))
    reads = port_cli.open_reads(str(tmp_path / "r.fq"), opt.mode)(1000, 0)
    body = psamse.samse_bytes(AlnEngine(idx, opt, "cpu"), reads, per_read,
                              opt, host_reference=True)
    assert psamse.sam_header(idx.bns).encode() + body == want


def test_bam2bam_sa_intv_24(made, sequential, tmp_path):
    """bam2bam on the index sampled every 24 rows, on the plain route and
    on the host reference route, equals the port's and nabwa_tpu's output
    on the default index."""
    d = made("dist")
    _index_24(d)
    want = _jax_b2b(d, tmp_path / "jax.bam", ["bam2bam"])
    assert sequential == want
    plain = _port_b2b(d, tmp_path / "p24.bam", prefix="g24.fa")
    host = _port_b2b(d, tmp_path / "h24.bam", prefix="g24.fa",
                     host_reference=True)
    assert plain == want and host == want


# --- the CLI and the import rule ---

def test_bam2bam_without_jax(made, tmp_path):
    """A fresh interpreter with nabwa_tpu and jax blocked runs the port's
    bam2bam CLI on the CPU; the BAM equals nabwa_tpu's."""
    d = made("dist")
    out = tmp_path / "nojax.bam"
    rest = ["-g", str(d / "g.fa"), "-f", str(out), str(d / "in.bam")]
    code = (BLOCKED + "from nabwa_tpu_torch.cli import main\n"
            f"assert main(['bam2bam', '--device', 'cpu', *{rest!r}]) == 0\n"
            "assert not [m for m, v in sys.modules.items() if v is not None "
            "and m.split('.')[0] in ('jax', 'nabwa_tpu')]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO),
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    want = _jax_b2b(d, tmp_path / "jax.bam", ["bam2bam"] + rest)
    assert out.read_bytes() == want


def test_bam2bam_cuda_device_required(made, monkeypatch, capsys, tmp_path):
    """`--device cuda` (the default) without a CUDA device exits non-zero
    with the other commands' error and writes nothing."""
    d = made("dist")
    monkeypatch.setattr(port_cli.torch.cuda, "is_available", lambda: False)
    out = tmp_path / "nocuda.bam"
    rc = port_cli.main(["bam2bam", "-g", str(d / "g.fa"), "-f", str(out),
                        str(d / "in.bam")])
    assert rc != 0 and not out.exists()
    assert "no CUDA device is available" in capsys.readouterr().err


def test_bam2bam_remote_workers_not_ported(made, capsys, tmp_path):
    d = made("dist")
    out = tmp_path / "p.bam"
    rc = port_cli.main(["bam2bam", "--device", "cpu", "-p", "5555", "-g",
                        str(d / "g.fa"), "-f", str(out), str(d / "in.bam")])
    assert rc != 0 and not out.exists()
    assert "not yet ported" in capsys.readouterr().err


def test_bam2bam_sai_sideload_matches_jax(made, tmp_path, monkeypatch):
    """`-0/-1/-2`: the singletons' and each end's alignments come from .sai
    files (`aln -b -0/-1/-2`, whose header the options are recovered
    from), so pass 1 runs no DFS; the port's BAM equals nabwa_tpu's
    bam2bam CLI on the same arguments."""
    d = made("dist")
    monkeypatch.setenv("NABWA_FORCE_NATIVE", "1")
    sai = {}
    for c in (0, 1, 2):
        sai[c] = tmp_path / f"s{c}.sai"
        assert ref_cli.main(["aln", "-b", f"-{c}", str(d / "g.fa"),
                             str(d / "in.bam"), "-f", str(sai[c])]) == 0
    out = tmp_path / "out.bam"
    rest = ["-g", str(d / "g.fa"), "-0", str(sai[0]), "-1", str(sai[1]),
            "-2", str(sai[2]), "-f", str(out), str(d / "in.bam")]
    assert ref_cli.main(["bam2bam", *rest]) == 0
    want = out.read_bytes()
    eng_calls = []
    real = AlnEngine.run_chunk
    monkeypatch.setattr(AlnEngine, "run_chunk", lambda self, reads, **kw: (
        eng_calls.append(len(reads)), real(self, reads, **kw))[1])
    assert port_cli.main(["bam2bam", "--device", "cpu", *rest]) == 0
    assert out.read_bytes() == want
    assert not any(eng_calls)               # every record was sideloaded


@pytest.mark.parametrize("sel", [["-b"], ["-b", "-0"]])
def test_aln_bam_input_matches_jax(made, tmp_path, sel, monkeypatch):
    """`aln -b` (every record) and `aln -b -0` (singletons only) on an
    unaligned BAM: the .sai bytes equal nabwa_tpu's aln -b (on its
    bit-exact host DFS)."""
    d = made("dist")
    want, got = tmp_path / "ref.sai", tmp_path / "port.sai"
    monkeypatch.setenv("NABWA_FORCE_NATIVE", "1")
    assert ref_cli.main(["aln", *sel, str(d / "g.fa"), str(d / "in.bam"),
                         "-f", str(want)]) == 0
    assert port_cli.main(["aln", "--device", "cpu", *sel, str(d / "g.fa"),
                          str(d / "in.bam"), "-f", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_bytes()) > 64 + 4 * 18
