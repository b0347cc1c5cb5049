"""The port's `index` and index tools on the CPU, held byte for byte to
`nabwa_tpu` called directly on the same inputs.

Genomes (drawn with numpy from a seed by tests/genomes.py):
  multi   three contigs of 12,000 bp with N runs (1 % N, lowercase bases),
          seed 41;
  odd     one contig of 29,999 bp, a length no power of two divides,
          seed 42.
`python -m nabwa_tpu_torch index` must write the eight files of
`nabwa_tpu.index.build.build_index` (and `-p` the same at another prefix);
the chain fa2pac -> pac_rev -> pac2bwt -> bwtupdate -> bwt2sa (at -i 32
and 24) and pac2bwtgen must write the files `nabwa_tpu.cli`'s `cmd_*`
write on the same inputs; `index -c` and `pac2cspac` (colour space) the
files of `build_index(color=True)` and `nabwa_tpu.index.pack.pac2cspac`.
The tools run no kernel, so there is no device.  Tolerance: exact, whole
files.
"""

import os
import subprocess
import sys

import pytest

from nabwa_tpu import cli as ref_cli
from nabwa_tpu.index.build import build_index
from nabwa_tpu_torch import cli as port_cli

from . import genomes
from .test_torch_smoke import REPO

INDEX_EXTS = (".pac", ".rpac", ".ann", ".amb", ".bwt", ".rbwt", ".sa",
              ".rsa")
GENOMES = {"multi": dict(n=36000, seed=41, n_frac=0.01, n_seqs=3,
                         lowercase_frac=0.1),
           "odd": dict(n=29999, seed=42)}


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    d = tmp_path_factory.mktemp("idxtools")
    out = {}
    for name, kw in GENOMES.items():
        fa, _ = genomes.random_genome(**kw)
        (d / f"{name}.fa").write_bytes(fa)
        out[name] = d / f"{name}.fa"
    return out


def _same_files(a, b, exts):
    for ext in exts:
        assert (a.parent / (a.name + ext)).read_bytes() == \
            (b.parent / (b.name + ext)).read_bytes(), ext


@pytest.mark.parametrize("name", list(GENOMES))
def test_index_cli_matches_jax(fastas, name, tmp_path):
    """`python -m nabwa_tpu_torch index` in a process of its own, and
    `index -p PREFIX -a bwtsw` in this one, against build_index."""
    want = tmp_path / "jax"
    build_index(str(fastas[name]), str(want))
    port = tmp_path / "port.fa"
    port.write_bytes(fastas[name].read_bytes())
    res = subprocess.run([sys.executable, "-m", "nabwa_tpu_torch", "index",
                          str(port)], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    _same_files(port, want, INDEX_EXTS)
    other = tmp_path / "other"
    assert port_cli.main(["index", "-a", "bwtsw", "-p", str(other),
                          str(fastas[name])]) == 0
    _same_files(other, want, INDEX_EXTS)


@pytest.mark.parametrize("name", list(GENOMES))
def test_tool_chain_matches_jax(fastas, name, tmp_path):
    """fa2pac, pac_rev, pac2bwt [-d], bwtupdate, bwt2sa -i 32 / -i 24 and
    pac2bwtgen: each step's file equals nabwa_tpu.cli's on the same
    input."""
    fa = str(fastas[name])
    files = {}
    for side, main in (("jax", ref_cli.main), ("port", port_cli.main)):
        p = tmp_path / side
        assert main(["fa2pac", fa, str(p)]) == 0
        assert main(["pac_rev", str(p) + ".pac"]) == 0
        assert main(["pac2bwt", "-d", str(p) + ".pac", str(p) + ".bwt"]) == 0
        assert main(["pac2bwtgen", str(p) + ".pac", str(p) + ".gen"]) == 0
        files[side, "plain"] = (tmp_path / f"{side}.bwt").read_bytes()
        assert main(["bwtupdate", str(p) + ".bwt"]) == 0
        for intv in (32, 24):
            assert main(["bwt2sa", "-i", str(intv), str(p) + ".bwt",
                         f"{p}.sa{intv}"]) == 0
    for ext in (".pac", ".ann", ".amb", ".rpac", ".gen", ".bwt", ".sa32",
                ".sa24"):
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes(), ext
    assert files["port", "plain"] == files["jax", "plain"]
    assert (tmp_path / "port.gen").read_bytes() == files["port", "plain"]
    # the interleaved .bwt and the -i 32 .sa are those of the whole index
    build_index(fa, str(tmp_path / "whole"))
    assert (tmp_path / "port.bwt").read_bytes() == \
        (tmp_path / "whole.bwt").read_bytes()
    assert (tmp_path / "port.sa32").read_bytes() == \
        (tmp_path / "whole.sa").read_bytes()


def test_bwtupdate_without_argument():
    assert port_cli.main(["bwtupdate"]) == 1


@pytest.mark.parametrize("argv", [["index", "-c", "x.fa"],
                                  ["pac2cspac", "nt", "cs"]])
def test_colour_space_refused(argv, fastas, tmp_path):
    """Colour space is ported: `index -c` writes the eleven files of
    `nabwa_tpu.index.build.build_index(color=True)` (the `.nt` pac and its
    annotations, then the colour index), and `pac2cspac <nt prefix> <cs
    prefix>` the `.pac`, `.ann` and `.amb` of
    `nabwa_tpu.index.pack.pac2cspac`, on the genome with N runs and three
    contigs."""
    from nabwa_tpu.index.pack import pac2cspac
    fa = fastas["multi"].read_bytes()
    (tmp_path / "x.fa").write_bytes(fa)
    (tmp_path / "want.fa").write_bytes(fa)
    build_index(str(tmp_path / "want.fa"), color=True)
    if argv[0] == "index":
        assert port_cli.main([argv[0], argv[1],
                              str(tmp_path / argv[2])]) == 0
        exts = [".nt.pac", ".nt.ann", ".nt.amb", *INDEX_EXTS]
        got, want = "x.fa", "want.fa"
    else:
        nt = str(tmp_path / "want.fa.nt")
        assert port_cli.main([argv[0], nt, str(tmp_path / argv[2])]) == 0
        pac2cspac(nt, str(tmp_path / "jax_cs"))
        exts = [".pac", ".ann", ".amb"]
        got, want = argv[2], "jax_cs"
        for ext in exts:
            assert (tmp_path / f"want.fa{ext}").read_bytes() == \
                (tmp_path / f"{want}{ext}").read_bytes(), ext
    for ext in exts:
        assert (tmp_path / f"{got}{ext}").read_bytes() == \
            (tmp_path / f"{want}{ext}").read_bytes(), ext
