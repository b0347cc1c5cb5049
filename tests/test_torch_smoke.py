"""What the port and its on-card smoke script may import, and how the script
ends without a CUDA device.

No file of the port and not `chip_smoke.py` imports the reference package
`nabwa_tpu` or jax: the port keeps its own copies of the host modules it
needs, and its index build writes the same files as the reference's.
`chip_smoke.py` imports the port, `tests/genomes.py`, torch, numpy and the
standard library.  With `nabwa_tpu` and jax blocked, every port module
imports and `aln` -> `samse` and `aln` x 2 -> `sampe` run end to end on the
CPU.  Without a CUDA device, or copied alone into an empty directory, the
script exits non-zero and prints nothing on standard output.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from . import genomes

REPO = pathlib.Path(__file__).resolve().parents[1]
SMOKE_ALLOWED = {"argparse", "collections", "json", "os", "pathlib",
                 "subprocess", "sys", "tempfile", "threading", "time",
                 "numpy", "torch", "nabwa_tpu_torch", "tests"}


def _imported_roots(path):
    """(root package, full name) of every import in a Python file; relative
    imports are resolved against the file's package."""
    tree = ast.parse(path.read_text(), str(path))
    pkg = path.relative_to(REPO).parent.parts
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = ".".join(pkg[:len(pkg) - node.level + 1])
                name = base + ("." + node.module if node.module else "")
            else:
                name = node.module
            out.append((name.split(".")[0], name))
    return out


def test_smoke_imports_only_the_port():
    for root, name in _imported_roots(REPO / "chip_smoke.py"):
        assert root in SMOKE_ALLOWED, f"chip_smoke.py imports {name}"
        if root == "tests":
            assert name in ("tests", "tests.genomes"), name


PORT_FILES = sorted(str(p.relative_to(REPO))
                    for p in (REPO / "nabwa_tpu_torch").rglob("*.py"))
BLOCKED = "import sys; sys.modules['jax'] = sys.modules['nabwa_tpu'] = None\n"


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_port_reaches_reference_only_through_host(path):
    """No file of the port, and not the smoke script, imports the reference
    package or jax (the port has no facade over `nabwa_tpu` any more)."""
    for root, name in _imported_roots(REPO / path):
        assert root not in ("jax", "nabwa_tpu"), f"{path} imports {name}"


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_smoke_fails_without_card_or_checkout(tmp_path, where):
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "FAIL" in res.stderr


def test_host_loads_no_reference_device_code():
    """A fresh interpreter with `nabwa_tpu` and jax blocked imports every
    port module, and none of either package is loaded."""
    mods = ", ".join(
        "nabwa_tpu_torch." + str(p.relative_to(REPO / "nabwa_tpu_torch"))
        [:-3].replace(os.sep, ".")
        for p in sorted((REPO / "nabwa_tpu_torch").rglob("*.py"))
        if p.name not in ("__init__.py", "__main__.py"))
    code = (BLOCKED + f"import {mods}\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "m.split('.')[0] in ('jax', 'nabwa_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_samse_without_jax(tmp_path):
    """With `nabwa_tpu` and jax blocked, a fresh interpreter builds the
    index with the port and runs its `aln` -> `samse` and `aln` x 2 ->
    `sampe` on the CPU; the `.sai` and SAM files equal `nabwa_tpu`'s."""
    from nabwa_tpu import cli as ref_cli

    from .test_sampe import make_pairs
    fa, seqs = genomes.random_genome(40000, seed=901)
    (tmp_path / "g.fa").write_bytes(fa)
    (tmp_path / "r.fq").write_bytes(genomes.sample_reads(
        seqs[0], 96, 60, seed=902, err_rate=0.02, indel_rate=0.4))
    fq1, fq2 = make_pairs(seqs[0], 96, 50, 250, 30, 903, err_rate=0.01,
                          frac_broken=0.1)
    (tmp_path / "r1.fq").write_bytes(fq1)
    (tmp_path / "r2.fq").write_bytes(fq2)
    g, r, r1, r2 = (str(tmp_path / n) for n in ("g.fa", "r.fq", "r1.fq",
                                                 "r2.fq"))
    port = {n: str(tmp_path / f"port_{n}") for n in (
        "r.sai", "r1.sai", "r2.sai", "se.sam", "pe.sam")}
    code = (
        BLOCKED + "from nabwa_tpu_torch.cli import main\n"
        "from nabwa_tpu_torch.index.build import build_index\n"
        f"build_index({g!r})\n"
        f"for fq, sai in (({r!r}, {port['r.sai']!r}), ({r1!r}, "
        f"{port['r1.sai']!r}), ({r2!r}, {port['r2.sai']!r})):\n"
        "    assert main(['aln', '--device', 'cpu', "
        f"{g!r}, fq, '-f', sai]) == 0\n"
        f"assert main(['samse', '--device', 'cpu', {g!r}, {port['r.sai']!r}, "
        f"{r!r}, '-f', {port['se.sam']!r}]) == 0\n"
        f"assert main(['sampe', '--device', 'cpu', {g!r}, "
        f"{port['r1.sai']!r}, {port['r2.sai']!r}, {r1!r}, {r2!r}, '-f', "
        f"{port['pe.sam']!r}]) == 0\n"
        "assert not [m for m, v in sys.modules.items() if v is not None "
        "and m.split('.')[0] in ('jax', 'nabwa_tpu')]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = {n: str(tmp_path / f"ref_{n}") for n in port}
    for fq, sai in ((r, "r.sai"), (r1, "r1.sai"), (r2, "r2.sai")):
        assert ref_cli.main(["aln", g, fq, "-f", ref[sai]]) == 0
    assert ref_cli.main(["samse", g, ref["r.sai"], r, "-f",
                         ref["se.sam"]]) == 0
    assert ref_cli.main(["sampe", g, ref["r1.sai"], ref["r2.sai"], r1, r2,
                         "-f", ref["pe.sam"]]) == 0
    for n in port:
        with open(port[n], "rb") as a, open(ref[n], "rb") as b:
            assert a.read() == b.read(), n


INDEX_EXTS = (".pac", ".rpac", ".ann", ".amb", ".bwt", ".rbwt", ".sa", ".rsa")


@pytest.mark.parametrize("n,n_frac,n_seqs", [(30000, 0.03, 1),
                                             (24001, 0.0, 4)])
def test_build_index_matches_reference(tmp_path, n, n_frac, n_seqs):
    """The port's index build writes every index file byte-identical to
    `nabwa_tpu.index.build.build_index`: a genome with N holes, and one of
    several contigs whose length is not a multiple of 4."""
    from nabwa_tpu.index.build import build_index as ref_build
    from nabwa_tpu_torch.index.build import build_index
    fa, _ = genomes.random_genome(n, seed=911 + n_seqs, n_frac=n_frac,
                                  n_seqs=n_seqs)
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "g.fa").write_bytes(fa)
    build_index(str(tmp_path / "port" / "g.fa"))
    ref_build(str(tmp_path / "ref" / "g.fa"))
    for ext in INDEX_EXTS:
        got = (tmp_path / "port" / ("g.fa" + ext)).read_bytes()
        want = (tmp_path / "ref" / ("g.fa" + ext)).read_bytes()
        assert got == want, ext
    assert b"N" in fa.split(b"\n", 1)[1] or n_seqs > 1
