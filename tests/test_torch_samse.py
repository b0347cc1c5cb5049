"""The port's `samse` slice end to end on the CPU: `python -m
nabwa_tpu_torch samse --device cpu` must write SAM byte-identical to
`nabwa_tpu samse` on the same genome, reads and `.sai` (the JAX package's
own `aln` output).

Read sets of 96 reads (batches of ~80+ reads are where scatter and
drand48-order bugs show): exact, mismatched, gapped (indels in half the
reads), a genome with N holes, quality-trimmed reads (`aln -q 30`), and the
duplicated-halves genome of tests/test_samse.py for repeats, multi hits
and XA tags.  The SAM bytes are the whole contract: exact equality.  The
host reference route of `samse_bytes` (native SA walk and native DP) must
give the same bytes.
"""

import numpy as np
import pytest

from nabwa_tpu import cli as ref_cli
from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.io import fastq, sai
from nabwa_tpu.models.samse import sam_header
from nabwa_tpu.utils.rand48 import Rand48
from nabwa_tpu_torch import cli as port_cli
from nabwa_tpu_torch.models import samse as msamse
from nabwa_tpu_torch.models.aln import AlnEngine

from . import genomes


def _duplicated_halves():
    rng = np.random.default_rng(5)
    half = rng.integers(0, 4, size=8000)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[np.concatenate([half,
                                                               half])]
    fa = b">dup chrom\n" + b"\n".join(
        seq.tobytes()[i:i + 70] for i in range(0, len(seq), 70)) + b"\n"
    return fa, seq.tobytes()


# name: (genome, read length, sample_reads options, aln options)
SETS = {
    "exact": (dict(n=20000, seed=801), 36, dict(seed=802), []),
    "mismatch": (dict(n=30000, seed=811), 50,
                 dict(seed=812, err_rate=0.03), []),
    "gapped": (dict(n=30000, seed=821), 70,
               dict(seed=822, err_rate=0.02, indel_rate=0.5), []),
    "n_holes": (dict(n=20000, seed=831, n_frac=0.02), 40,
                dict(seed=832, err_rate=0.02, indel_rate=0.3), []),
    "trimmed": (dict(n=30000, seed=841), 60,
                dict(seed=842, err_rate=0.02, indel_rate=0.3), ["-q", "30"]),
    "repeats": (None, 36, dict(seed=6), []),
}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    cache = {}

    def make(name):
        if name not in cache:
            gen, rlen, rkw, aln_args = SETS[name]
            d = tmp_path_factory.mktemp(name)
            if gen is None:
                fa, seq = _duplicated_halves()
            else:
                fa, seqs = genomes.random_genome(gen["n"], seed=gen["seed"],
                                                 n_frac=gen.get("n_frac", 0))
                seq = seqs[0]
            (d / "g.fa").write_bytes(fa)
            (d / "r.fq").write_bytes(genomes.sample_reads(seq, 96, rlen,
                                                          **rkw))
            build_index(str(d / "g.fa"))
            assert ref_cli.main(["aln"] + aln_args + [
                str(d / "g.fa"), str(d / "r.fq"), "-f", str(d / "r.sai")]) == 0
            assert ref_cli.main(["samse", str(d / "g.fa"), str(d / "r.sai"),
                                 str(d / "r.fq"), "-f",
                                 str(d / "ref.sam")]) == 0
            cache[name] = d
        return cache[name]
    return make


def _port_samse(d, out, *extra):
    assert port_cli.main(["samse", "--device", "cpu", *extra,
                          str(d / "g.fa"), str(d / "r.sai"), str(d / "r.fq"),
                          "-f", str(out)]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("name", list(SETS))
def test_samse_cli_matches_jax(made, name):
    d = made(name)
    want = (d / "ref.sam").read_bytes()
    got = _port_samse(d, d / "port.sam")
    assert len(got) == len(want) and got == want
    lines = [ln for ln in got.splitlines() if not ln.startswith(b"@")]
    assert len(lines) == 96
    cigars = [ln.split(b"\t")[5] for ln in lines]
    if name == "gapped":
        assert sum(1 for c in cigars if b"I" in c or b"D" in c) >= 20
    if name == "trimmed":
        assert any(b"S" in c for c in cigars)
    if name == "repeats":
        assert any(b"XA:Z:" in ln for ln in lines)


@pytest.mark.parametrize("name", ["gapped", "n_holes", "repeats"])
def test_host_reference_route_matches(made, name):
    """samse_bytes on the host reference route and on the engine's device
    (the plain versions on the CPU), from a list of Read objects and
    per-read tuples: both equal the JAX package's SAM."""
    d = made(name)
    idx = BwaIndex.load(str(d / "g.fa"))
    opt, per_read = sai.read_sai_tuples(str(d / "r.sai"))
    reads = fastq.read_fastq_batch(fastq.iter_fastq(str(d / "r.fq")), 1000,
                                   trim_qual=opt.trim_qual)
    eng = AlnEngine(idx, opt, "cpu")
    want = (d / "ref.sam").read_bytes()
    header = sam_header(idx.bns).encode()
    for ref_route in (True, False):
        before = dict(msamse.seconds)
        body = msamse.samse_bytes(eng, reads, per_read, opt,
                                  rng=Rand48(idx.bns.seed),
                                  host_reference=ref_route)
        assert header + body == want
        assert msamse.seconds["select"] > before["select"]
        if name == "gapped":
            assert msamse.seconds["dp"] > before["dp"]


def test_samse_options_match_jax(made):
    """-n (multi hits listed) and -r (read group) as in the JAX CLI."""
    d = made("repeats")
    rg = r"@RG\tID:grp1\tSM:s"
    ref = d / "ref_opts.sam"
    assert ref_cli.main(["samse", "-n", "5", "-r", rg, str(d / "g.fa"),
                         str(d / "r.sai"), str(d / "r.fq"), "-f",
                         str(ref)]) == 0
    got = _port_samse(d, d / "port_opts.sam", "-n", "5", "-r", rg)
    assert got == ref.read_bytes() and b"RG:Z:grp1" in got


def test_samse_cuda_device_required(made, monkeypatch):
    """`--device cuda` (the default) without a CUDA device exits non-zero
    and never falls back to the CPU."""
    d = made("exact")
    monkeypatch.setattr(port_cli.torch.cuda, "is_available", lambda: False)
    out = d / "nocuda.sam"
    rc = port_cli.main(["samse", str(d / "g.fa"), str(d / "r.sai"),
                        str(d / "r.fq"), "-f", str(out)])
    assert rc != 0 and not out.exists()


def test_samse_colour_space_not_ported(made):
    """Colour space is ported: on a colour index of the same genome
    (`build_index(color=True)`), a colour `.sai` of `nabwa_tpu aln -c`
    goes through the port's `samse` (cs2nt decoding against the `.nt`
    pac) to the bytes of `nabwa_tpu samse`."""
    from .test_torch_colour import colour_reads
    d = made("exact")
    cs = str(d / "cs.fa")
    build_index(str(d / "g.fa"), cs, color=True)
    g = b"".join(ln for ln in (d / "g.fa").read_bytes().split(b"\n")
                 if not ln.startswith(b">"))
    fq = d / "colour.fq"
    fq.write_bytes(colour_reads(g, 96, 36, seed=851, indel=0.2))
    assert ref_cli.main(["aln", "-c", cs, str(fq), "-f",
                         str(d / "colour.sai")]) == 0
    args = [cs, str(d / "colour.sai"), str(fq)]
    assert ref_cli.main(["samse", *args, "-f", str(d / "colour.jax.sam")]) == 0
    assert port_cli.main(["samse", "--device", "cpu", *args, "-f",
                          str(d / "colour.sam")]) == 0
    got = (d / "colour.sam").read_bytes()
    assert got == (d / "colour.jax.sam").read_bytes()
    assert got.count(b"\tCM:i:") >= 60
