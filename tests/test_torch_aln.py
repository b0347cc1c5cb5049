"""The port's `aln` slice end to end on the CPU: `python -m
nabwa_tpu_torch aln --device cpu` must write a `.sai` byte-identical to
`nabwa_tpu aln` on the same genome and reads.

96 reads on a ~30 kbp genome with substitutions and indels (batches of
~80+ reads are where scatter and ordering bugs show).  The `.sai` bytes
are the whole contract: exact equality.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from nabwa_tpu import cli as ref_cli
from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.io import fastq, sai
from nabwa_tpu.options import GapOpt
from nabwa_tpu_torch import cli as port_cli
from nabwa_tpu_torch.models.aln import AlnEngine

from . import genomes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("aln")
    fa, seqs = genomes.random_genome(30000, seed=501)
    fq = genomes.sample_reads(seqs[0], 96, 70, seed=502, err_rate=0.02,
                              indel_rate=0.3)
    (d / "g.fa").write_bytes(fa)
    (d / "r.fq").write_bytes(fq)
    build_index(str(d / "g.fa"))
    ref = d / "ref.sai"
    assert ref_cli.main(["aln", str(d / "g.fa"), str(d / "r.fq"),
                         "-f", str(ref)]) == 0
    return d, ref.read_bytes()


def test_aln_cli_matches_jax(data):
    d, want = data
    out = d / "port.sai"
    assert port_cli.main(["aln", "--device", "cpu", str(d / "g.fa"),
                          str(d / "r.fq"), "-f", str(out)]) == 0
    got = out.read_bytes()
    assert len(got) == len(want) and got == want
    _, per_read = sai.read_sai(str(out))
    assert len(per_read) == 96 and sum(1 for a in per_read if len(a)) > 80


def test_aln_tiers_and_host_drain_match_jax(data):
    """A small tier-0 stack and iteration cap send reads through the retry
    tier, and a small retry stack sends some on to the native host drain;
    the output stays byte-identical."""
    d, want = data
    idx = BwaIndex.load(str(d / "g.fa"))
    reads = fastq.read_fastq_batch(fastq.iter_fastq(str(d / "r.fq")), 1000)
    opt = GapOpt()
    eng = AlnEngine(idx, opt, "cpu", stack_cap=12, retry_stack_cap=40,
                    tier0_max_iters=60, max_iters=100000)
    res = eng.run_chunk(reads, device_batch=64)
    got = opt.pack() + sai.pack_aln_block([a for a, _ in res])
    assert got == want
    assert eng.tier0_reads > 0 and eng.retry_reads > 0
    assert eng.host_drain_reads > 0
    assert eng.tier0_reads + eng.retry_reads + eng.host_drain_reads == 96


def test_aln_columnar_batch_matches_list(data):
    """A columnar ReadBatch (the CLI's native FASTQ path) and a list of
    Read objects give the same results."""
    d, _ = data
    idx = BwaIndex.load(str(d / "g.fa"))
    opt = GapOpt()
    pull = ref_cli._open_reads(str(d / "r.fq"), opt.mode)
    batch = pull(1000, 0)
    assert hasattr(batch, "code_bytes")
    eng = AlnEngine(idx, opt, "cpu")
    a = eng.run_chunk(batch, device_batch=48)
    b = eng.run_chunk(list(batch), device_batch=48)
    assert a == b


def test_aln_without_jax(data):
    """The port imports no JAX: with jax blocked, a fresh interpreter runs
    the port's `aln` on the CPU and writes the same `.sai`."""
    d, want = data
    out = d / "nojax.sai"
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import nabwa_tpu_torch\n"
        "from nabwa_tpu_torch.cli import main\n"
        f"rc = main(['aln', '--device', 'cpu', {str(d / 'g.fa')!r}, "
        f"{str(d / 'r.fq')!r}, '-f', {str(out)!r}])\n"
        "assert 'jax' not in [m.split('.')[0] for m, v in "
        "sys.modules.items() if v is not None]\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert out.read_bytes() == want


def test_aln_cuda_device_required(data, monkeypatch):
    """`--device cuda` (the default) without a CUDA device exits non-zero
    and never falls back to the CPU."""
    d, _ = data
    monkeypatch.setattr(port_cli.torch.cuda, "is_available", lambda: False)
    out = d / "nocuda.sai"
    rc = port_cli.main(["aln", str(d / "g.fa"), str(d / "r.fq"), "-f",
                        str(out)])
    assert rc != 0 and not out.exists()


@pytest.mark.parametrize("cmd", ["samse", "sampe", "index", "bam2bam"])
def test_other_commands_not_ported(cmd):
    """Commands outside the port exit non-zero; `samse` and `sampe`,
    ported since, exit non-zero on this malformed call (no device, or a
    usage error)."""
    try:
        rc = port_cli.main([cmd, "x"])
    except SystemExit as e:
        rc = e.code
    assert rc != 0


def test_per_read_semantics_not_ported(data):
    """bam2bam's per-read semantics are ported now: at the default options
    every read falls in one group, whose hits are the batch path's
    (tests/test_torch_bam2bam.py holds split groups to the JAX engine)."""
    d, _ = data
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(), "cpu")
    reads = fastq.read_fastq_batch(fastq.iter_fastq(str(d / "r.fq")), 4)
    per_read = eng.run_chunk(reads, per_read_semantics=True)
    assert [a for a, _ in per_read] == [a for a, _ in eng.run_chunk(reads)]
    assert len(per_read) == 4


def test_sa_rows_matches_host_walk(data):
    d, _ = data
    idx = BwaIndex.load(str(d / "g.fa"))
    eng = AlnEngine(idx, GapOpt(), "cpu")
    rows = np.random.default_rng(503).integers(
        0, idx.fwd.seq_len + 1, size=64).astype(np.uint32)
    from nabwa_tpu.refmodel.fm_scalar import ScalarFm
    for a, fm in ((1, idx.fwd), (0, idx.rev)):
        sfm = ScalarFm(fm.bwt, fm.primary, fm.l2, fm.seq_len, fm.sa,
                       fm.sa_intv)
        want = np.array([sfm.sa(int(r)) for r in rows], dtype=np.uint32)
        np.testing.assert_array_equal(eng.sa_rows(a, rows), want)
