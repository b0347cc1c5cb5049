"""The port's `bwasw` slice end to end on the CPU: `python -m
nabwa_tpu_torch bwasw --device cpu` must write SAM byte-identical to
`nabwa_tpu.models.bwasw.bwasw` on both of its routes (the native
whole-batch driver, its default, and the per-read object route,
`NABWA_BWASW_OBJ=1`), on the same index and reads.

Read sets follow the long-read model of tests/test_bwasw.py (substitutions,
an indel, chimeric tails, a run of N, either strand):
  contigs  80 reads of 500 bp on a two-contig genome, 4 more across the
           contig boundary, so that `fix_cigar` splits their alignments;
  long     16 reads of 1 kb, a quarter of them with N bases;
  options  40 reads of 300 bp under `-H -m 0.3 -N 3 -w 20`.
Between them they hold reads with N bases (run in stage B on the
kernels' plain versions) and reads that take the reverse-index pass
(XF:i: tags).  The host reference route of `bwasw_bytes` must give the
same bytes; `--device cuda` without a card exits with an error; and a
fresh interpreter with `nabwa_tpu` and jax blocked runs the port's index
build and `bwasw`.  SAM bytes are the whole contract: exact equality.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.models import bwasw as jbw
from nabwa_tpu_torch import cli as port_cli
from nabwa_tpu_torch.index.fmindex import BwaIndex as PortIndex
from nabwa_tpu_torch.models import bwasw as mbw
from nabwa_tpu_torch.utils.rand48 import Rand48

from . import genomes
from .test_bwasw import make_long_reads
from .test_torch_extend import one_torch_thread  # noqa: F401 (autouse)
from .test_torch_smoke import BLOCKED, REPO

# name: (genome kwargs, reads kwargs, bwasw options)
SETS = {
    "contigs": (dict(n=80000, seed=601, n_seqs=2),
                dict(n_reads=80, read_len=500, seed=602, with_n=0.03), []),
    "long": (dict(n=120000, seed=701),
             dict(n_reads=16, read_len=1000, seed=702, err=0.03, indel=0.5,
                  with_n=0.25), []),
    "options": (dict(n=60000, seed=711),
                dict(n_reads=40, read_len=300, seed=712, with_n=0.05),
                ["-H", "-m", "0.3", "-N", "3", "-w", "20"]),
}
N_BRIDGING = 4
# seconds to wait for the JAX package's native library to load whole
NATIVE_WAIT_S = 600


def _bridging_reads(seqs, seed):
    """Reads of 500 bp whose middle is the boundary between the first two
    contigs, a few substitutions each."""
    rng = np.random.default_rng(seed)
    joined = np.frombuffer(seqs[0] + seqs[1], dtype=np.uint8).copy()
    b = len(seqs[0])
    out = []
    for i in range(N_BRIDGING):
        lo = b - int(rng.integers(180, 320))
        r = joined[lo:lo + 500].copy()
        err = rng.random(len(r)) < 0.02
        r[err] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                               err.sum())]
        out.append(b"@bridge%d\n%s\n+\n%s\n" % (i, r.tobytes(),
                                                b"I" * len(r)))
    return b"".join(out)


def _read_tuples(fq):
    lines = fq.decode().strip().split("\n")
    return [(lines[i][1:], lines[i + 1], lines[i + 3])
            for i in range(0, len(lines), 4)]


def _jax_opt(args):
    opt = jbw.Bsw2Opt()
    it = iter(args)
    for a in it:
        if a == "-H":
            opt.hard_clip = 1
        elif a == "-m":
            opt.mask_level = np.float32(next(it))
        elif a == "-N":
            opt.t_seeds = int(next(it))
        elif a == "-w":
            opt.bw = int(next(it))
    return opt


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library, whole and loaded in this process.
    Its loader (`nabwa_tpu.index.native._load`) runs g++ straight into
    native/build/ with no lock across processes and caches a failed load:
    a test process that reads the library while another process's g++ is
    writing it keeps None, and the JAX package's native routes then return
    None.  So wait here until the library loads, clearing that cached
    failure between tries; the JAX package's files stay as they are."""
    from nabwa_tpu.index import native
    deadline = time.monotonic() + NATIVE_WAIT_S
    while native._load() is None:
        if time.monotonic() > deadline:
            pytest.fail(f"the JAX package's native library did not load "
                        f"within {NATIVE_WAIT_S} s")
        time.sleep(1)
        with native._load_lock:
            native._checked = False
    return native._lib


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """Per set: the directory with genome, index and reads, and the port
    CLI's SAM on the CPU (each made once)."""
    cache = {}

    def make(name):
        if name not in cache:
            gen, rkw, opts = SETS[name]
            d = tmp_path_factory.mktemp(name)
            fa, seqs = genomes.random_genome(gen["n"], seed=gen["seed"],
                                             n_seqs=gen.get("n_seqs", 1))
            fq = make_long_reads(seqs[0], **rkw)
            if gen.get("n_seqs", 1) > 1:
                fq += _bridging_reads(seqs, gen["seed"] + 7)
            (d / "g.fa").write_bytes(fa)
            (d / "r.fq").write_bytes(fq)
            build_index(str(d / "g.fa"))
            out = d / "port.sam"
            assert port_cli.main(["bwasw", "--device", "cpu", *opts,
                                  str(d / "g.fa"), str(d / "r.fq"), "-f",
                                  str(out)]) == 0
            cache[name] = (d, out.read_bytes())
        return cache[name]
    return make


@pytest.mark.parametrize("route", ["native", "objects"])
@pytest.mark.parametrize("name", list(SETS))
def test_bwasw_cli_matches_jax(jax_native, made, monkeypatch, name, route):
    d, got = made(name)
    taken = []
    if route == "objects":
        monkeypatch.setenv("NABWA_BWASW_OBJ", "1")
        fn = jbw.aln_one
    else:
        monkeypatch.delenv("NABWA_BWASW_OBJ", raising=False)
        fn = jbw._bwasw_native_batch

    def counted(*args):
        out = fn(*args)
        taken.append(out is not None)
        return out

    monkeypatch.setattr(jbw, fn.__name__, counted)
    reads = _read_tuples((d / "r.fq").read_bytes())
    want = jbw.bwasw(BwaIndex.load(str(d / "g.fa")), reads,
                     _jax_opt(SETS[name][2])).encode()
    assert all(taken) and len(taken) == (len(reads) if route == "objects"
                                         else 1)
    assert len(got) == len(want) and got == want
    records = [ln for ln in got.splitlines() if not ln.startswith(b"@")]
    assert len({ln.split(b"\t")[0] for ln in records}) == len(reads)


def test_sets_cover_n_bases_reverse_pass_and_split(made):
    """Reads with N bases, hits flagged by the reverse-index pass, and the
    bridging reads split at the contig boundary (soft-clipped)."""
    n_amb = rev = 0
    for name in SETS:
        d, sam = made(name)
        n_amb += sum("N" in s for _, s, _ in
                     _read_tuples((d / "r.fq").read_bytes()))
        rev += sum(1 for ln in sam.splitlines()
                   if b"\tXF:i:0\t" not in ln and b"XF:i:" in ln)
    assert n_amb >= 5 and rev >= 10
    _, sam = made("contigs")
    bridged = [ln.split(b"\t") for ln in sam.splitlines()
               if ln.startswith(b"bridge")]
    assert len(bridged) >= N_BRIDGING
    assert sum(1 for f in bridged if b"S" in f[5]) >= N_BRIDGING


@pytest.mark.parametrize("name", list(SETS))
def test_host_reference_route_matches(made, name):
    """bwasw_bytes on the native whole-batch route, two threads, gives the
    CLI's bytes; the route's time lands under seconds["native"]."""
    d, got = made(name)
    idx = PortIndex.load(str(d / "g.fa"))
    opt = mbw.Bsw2Opt()
    jopt = _jax_opt(SETS[name][2])
    for key in ("hard_clip", "mask_level", "t_seeds", "bw"):
        setattr(opt, key, getattr(jopt, key))
    before = mbw.seconds["native"]
    body = mbw.bwasw_bytes(idx, _read_tuples((d / "r.fq").read_bytes()),
                           opt, None, Rand48(11), host_reference=True,
                           threads=2)
    assert mbw.sam_sq(idx.bns) + body == got
    assert mbw.seconds["native"] > before


def test_bwasw_cuda_device_required(made, monkeypatch):
    """`--device cuda` (the default) without a CUDA device exits non-zero
    and never falls back to the CPU; the aliases name the same command."""
    d, _ = made("options")
    monkeypatch.setattr(port_cli.torch.cuda, "is_available", lambda: False)
    out = d / "nocuda.sam"
    for cmd in ("bwasw", "bwtsw2", "dbwtsw"):
        rc = port_cli.main([cmd, str(d / "g.fa"), str(d / "r.fq"), "-f",
                            str(out)])
        assert rc != 0 and not out.exists()


def test_bwasw_without_jax(tmp_path):
    """With `nabwa_tpu` and jax blocked, a fresh interpreter builds the
    index with the port and runs its `bwasw` on the CPU; the SAM equals
    `nabwa_tpu`'s."""
    fa, seqs = genomes.random_genome(50000, seed=721)
    fq = make_long_reads(seqs[0], 12, 600, 722, with_n=0.2)
    (tmp_path / "g.fa").write_bytes(fa)
    (tmp_path / "r.fq").write_bytes(fq)
    g, r, out = (str(tmp_path / n) for n in ("g.fa", "r.fq", "port.sam"))
    code = (BLOCKED + "from nabwa_tpu_torch.cli import main\n"
            "from nabwa_tpu_torch.index.build import build_index\n"
            f"build_index({g!r})\n"
            f"assert main(['bwtsw2', '--device', 'cpu', {g!r}, {r!r}, "
            f"'-f', {out!r}]) == 0\n"
            "assert not [m for m, v in sys.modules.items() if v is not None "
            "and m.split('.')[0] in ('jax', 'nabwa_tpu')]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO),
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    want = jbw.bwasw(BwaIndex.load(g), _read_tuples(fq))
    with open(out, "rb") as f:
        assert f.read() == want.encode()
