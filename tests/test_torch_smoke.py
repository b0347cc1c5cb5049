"""What the port and its on-card smoke script may import, and how the script
ends without a CUDA device.

The port reaches the reference package's jax-free host code through
`nabwa_tpu_torch/host.py` only, and that module loads nothing of the
reference's device code (`nabwa_tpu.ops`, `nabwa_tpu.parallel`,
`nabwa_tpu.models.aln`); `chip_smoke.py` imports the port,
`tests/genomes.py`, torch, numpy and the standard library, never the
reference package or jax.  With jax blocked, `aln` then `samse` run end to
end on the CPU.  Without a CUDA device, or copied alone into an empty
directory, the script exits non-zero and prints nothing on standard
output.
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
SMOKE_ALLOWED = {"argparse", "json", "os", "pathlib", "subprocess", "sys",
                 "tempfile", "time", "numpy", "torch", "nabwa_tpu_torch",
                 "tests"}


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


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_reaches_reference_only_through_host(path):
    for root, name in _imported_roots(REPO / path):
        assert root != "jax", f"{path} imports {name}"
        if root == "nabwa_tpu":
            assert path == os.path.join("nabwa_tpu_torch", "host.py"), \
                f"{path} imports {name}"


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
    """Every port module imported with jax blocked: nothing under
    nabwa_tpu.ops or nabwa_tpu.parallel, nor nabwa_tpu.models.aln, is
    loaded (statically: host.py names none of them)."""
    for _, name in _imported_roots(REPO / "nabwa_tpu_torch" / "host.py"):
        assert not name.startswith(("nabwa_tpu.ops", "nabwa_tpu.parallel")) \
            and name != "nabwa_tpu.models.aln", name
    mods = ", ".join(
        "nabwa_tpu_torch." + str(p.relative_to(REPO / "nabwa_tpu_torch"))
        [:-3].replace(os.sep, ".")
        for p in sorted((REPO / "nabwa_tpu_torch").rglob("*.py"))
        if p.name not in ("__init__.py", "__main__.py"))
    code = ("import sys; sys.modules['jax'] = None\n"
            f"import {mods}\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "(m.startswith(('nabwa_tpu.ops', 'nabwa_tpu.parallel', 'jax')) "
            "or m == 'nabwa_tpu.models.aln')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_samse_without_jax(tmp_path):
    """With jax blocked, a fresh interpreter runs the port's `aln` and
    `samse` on the CPU; the SAM equals `nabwa_tpu samse` on that `.sai`."""
    from nabwa_tpu import cli as ref_cli
    fa, seqs = genomes.random_genome(20000, seed=901)
    (tmp_path / "g.fa").write_bytes(fa)
    (tmp_path / "r.fq").write_bytes(genomes.sample_reads(
        seqs[0], 96, 60, seed=902, err_rate=0.02, indel_rate=0.4))
    g, r, s, o = (str(tmp_path / n) for n in ("g.fa", "r.fq", "r.sai",
                                               "port.sam"))
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from nabwa_tpu_torch.cli import main\n"
        "from nabwa_tpu_torch.host import build_index\n"
        f"build_index({g!r})\n"
        f"assert main(['aln', '--device', 'cpu', {g!r}, {r!r}, '-f', "
        f"{s!r}]) == 0\n"
        f"rc = main(['samse', '--device', 'cpu', {g!r}, {s!r}, {r!r}, "
        f"'-f', {o!r}])\n"
        "assert 'jax' not in [m.split('.')[0] for m, v in "
        "sys.modules.items() if v is not None]\n"
        "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = tmp_path / "ref.sam"
    assert ref_cli.main(["samse", g, s, r, "-f", str(ref)]) == 0
    assert (tmp_path / "port.sam").read_bytes() == ref.read_bytes()
