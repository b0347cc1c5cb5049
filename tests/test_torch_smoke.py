"""What the port and its on-card smoke script may import, and how the script
ends without a CUDA device.

The port reaches the reference package's jax-free host code through
`nabwa_tpu_torch/host.py` only; `chip_smoke.py` imports the port,
`tests/genomes.py`, torch, numpy and the standard library, never the
reference package or jax.  Without a CUDA device, or copied alone into
an empty directory, the script exits non-zero and prints nothing on
standard output.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

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
