"""What the port and its on-card smoke script may import, and how the script
ends without a CUDA device.

No file of the port and not `chip_smoke.py` imports the reference package
`nabwa_tpu` or jax, and no file of the port imports the tests: the port
keeps its own copies of the host modules it needs, and its index build
writes the same files as the reference's.
`chip_smoke.py` imports the port, `tests/genomes.py`, torch, numpy and the
standard library, and `compare.py` the same, `inspect` and
`chip_smoke.py`.  With
`nabwa_tpu` and jax blocked, every port module imports and `aln` ->
`samse` and `aln` x 2 -> `sampe` run end to end on the CPU.  Without a CUDA device, or copied alone into an empty directory, the
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
                 "signal", "socket", "subprocess", "sys", "tempfile",
                 "threading", "time", "numpy", "torch", "nabwa_tpu_torch",
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


def test_compare_imports_only_the_port():
    """`compare.py` imports what the smoke script may, `inspect`,
    `importlib` (to load the smoke script beside it under another name)
    and the smoke script itself."""
    for root, name in _imported_roots(REPO / "compare.py"):
        assert root in SMOKE_ALLOWED | {"chip_smoke", "importlib",
                                        "inspect"}, \
            f"compare.py imports {name}"


def test_compare_refuses_an_unknown_mode():
    """`compare.py` names its modes and exits 2 on another, before it
    imports anything of a checkout."""
    res = subprocess.run([sys.executable, "compare.py", "c4", str(REPO)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 2 and not res.stdout
    assert "{c3,aln,launch,c9,c23,c34,c17,c32}" in res.stderr


PORT_FILES = sorted(str(p.relative_to(REPO))
                    for p in (REPO / "nabwa_tpu_torch").rglob("*.py"))
BLOCKED = "import sys; sys.modules['jax'] = sys.modules['nabwa_tpu'] = None\n"


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py",
                                  "compare.py"])
def test_port_reaches_reference_only_through_host(path):
    """No file of the port, and not the smoke script, imports the reference
    package or jax (the port has no facade over `nabwa_tpu` any more)."""
    for root, name in _imported_roots(REPO / path):
        assert root not in ("jax", "nabwa_tpu"), f"{path} imports {name}"


def test_port_imports_no_tests():
    """The rule covers the mesh and the entry points, and no file of the
    port imports the repository's tests: its data come from the port."""
    assert {"nabwa_tpu_torch/parallel/mesh.py",
            "nabwa_tpu_torch/entry.py"} <= set(PORT_FILES)
    for path in PORT_FILES:
        for root, name in _imported_roots(REPO / path):
            assert root != "tests", f"{path} imports {name}"


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


def _smoke_module():
    """chip_smoke.py imported as a module (its top level needs no card)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_cpu",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stage_split_of_known_stamps():
    """`stage_split` on stamps made up here: each stage's median, p90 and
    share of the summed cycles, the iteration's median, the calibration
    chains' cycles a step and the SM clock from the clock64 and
    %globaltimer spans."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.probes import probe_dfs_shape as pds
    cs = _smoke_module()
    bb, iters = 4, 10
    base = np.array([100, 400, 200, 300, 100])          # a stage's cycles
    stages = np.broadcast_to(base, (bb, iters, 5)).copy()
    stages[:, :, 1] += np.arange(iters)                 # loads 400..409
    cal = np.zeros((bb, len(pds.CAL)), dtype=np.int64)
    steps = [pds.CAL_STEPS[k] for k in ("imad", "colops", "redux", "shfl",
                                        "lds")]
    cal[:, :5] = np.array([4, 10, 30, 25, 30]) * np.array(steps)
    cal[:, 5], cal[:, 6] = 1_980_000, 1_000_000
    out = cs.stage_split(torch.from_numpy(stages.astype(np.int32)),
                         torch.from_numpy(cal.astype(np.int32)))
    st = out["stages"]
    assert list(st) == list(pds.STAGES)
    assert st["pop"]["median"] == 100 and st["push"]["p90"] == 100
    assert st["loads"]["median"] == 404.5
    assert st["loads"]["p90"] == np.percentile(400 + np.arange(iters), 90)
    total = stages.sum()
    assert st["counts"]["share"] == 200 * bb * iters / total
    assert abs(sum(v["share"] for v in st.values()) - 1) < 1e-12
    assert out["iteration"]["median"] == 1104.5
    assert out["latency_cycles"] == {"imad": 4, "colops": 10, "redux": 30,
                                     "shfl": 25, "lds": 30}
    assert out["sm_clock_ghz"] == 1.98


def test_chain_bounds_price_each_path():
    """`chain_bounds` prices each kernel's dependent path at the measured
    latencies: C9's C9_CHAIN steps an iteration, C24's 2 T K, C23's 2 T,
    C25's 400 integer steps, C34's load and 226 integer steps (both
    forms); ns = cycles / GHz, an L2 row load at C12's serial load.  C34's
    witness gets its one SM's shared-memory ceiling: s read and written
    an inner round at 128 bytes a clock.  C17 and C18 (both forms): a
    load and 50 rounds of 2 minima, a redux.sync, a compare and a select,
    C17's carry a shared load and a redux.sync more; their witnesses one
    SM's issue ceiling, WHILE_WITNESS_ISSUE instructions a warp and round
    over 4 schedulers.  A load, then: C13 50 rounds of 9 integer steps
    and 2 redux.syncs; C19 6,000 integer steps; C21 2 a push of its
    busiest row, an add and a shared load's latency; C31-C33 50 rounds of
    3 steps and a redux.sync, 8 (C32's witness 13) and 5 shuffles, 9 and
    a shared load; C10 a load and 100 iterations of a shuffle, 10 integer
    steps, an L2 row load and a redux.sync; C35 2 + 128 fp32 steps, each
    at the IMAD's latency.  C10, C32 (both forms) and C35 get their queued
    time over the chain."""
    cs = _smoke_module()
    lat = {"imad": 4.0, "colops": 8.0, "redux": 30.0, "shfl": 20.0,
           "lds": 32.0}
    timed = {"queued_ms": 0.01, "witness_queued_ms": 0.03}
    probes = {
        "probe_dfs_shape": {"latency_cycles": lat, "sm_clock_ghz": 2.0,
                            "iters": 200,
                            "shapes": [{"queued_ms": 0.2,
                                        "witness_queued_ms": 0.3}]},
        "probe_loads": {"serial_ns_per_load": 170.0},
        "probe_colops": {"t": 2000, "k": 64}, "probe_spill": {"t": 2000},
        "probe_p7": {}, "probe_p5": {"inner_rounds": 126, "words": 32768},
        "probe_while_scratch": dict(timed), "probe_while_vector": dict(timed),
        "probe_pop": {}, "probe_body_scale": {},
        "probe_scalar_push": {"max_row_pushes": 140},
        "probe_p2_native": {}, "probe_p2_roll": dict(timed),
        "probe_p2_subl": {}, "probe_p6": dict(timed),
        "probe_pallas_dfs_shape": dict(timed)}
    cs.chain_bounds(probes)
    c = cs.C9_CHAIN
    per_iter = (c["int"] * 4 + c["redux"] * 30 + c["shfl"] * 20) / 2.0 + 170
    assert probes["probe_dfs_shape"]["chain_bound_ms"] == \
        pytest.approx(200 * per_iter * 1e-6)
    assert probes["probe_dfs_shape"]["chain_ns_per_iter"] == \
        pytest.approx(per_iter)
    sh = probes["probe_dfs_shape"]["shapes"][0]
    assert sh["queued_over_chain"] == pytest.approx(0.2 / (per_iter * 2e-4))
    assert probes["probe_colops"]["chain_bound_ms"] == \
        pytest.approx(2 * 2000 * 64 * 2.0 * 1e-6)
    assert probes["probe_spill"]["chain_bound_ms"] == \
        pytest.approx(2 * 2000 * 2.0 * 1e-6)
    assert probes["probe_p7"]["chain_bound_ms"] == \
        pytest.approx(400 * 2.0 * 1e-6)
    assert probes["probe_p5"]["chain_steps"] == {"load": 1, "int": 226}
    assert probes["probe_p5"]["chain_bound_ms"] == \
        pytest.approx((170 + 226 * 2.0) * 1e-6)
    assert probes["probe_p5"]["witness_smem_ceiling_ms"] == \
        pytest.approx(126 * 2048 / 2.0 * 1e-6)
    # ns a step at 2 GHz: int and fp32 2, redux.sync 15, shuffle 10, shared
    # load 16; a load 170
    want = {
        "probe_while_vector": ({"load": 1, "int": 200, "redux": 50},
                               170 + 200 * 2 + 50 * 15),
        "probe_while_scratch": ({"load": 1, "int": 200, "redux": 51,
                                 "lds": 1}, 170 + 200 * 2 + 51 * 15 + 16),
        "probe_pop": ({"load": 1, "int": 450, "redux": 100},
                      170 + 450 * 2 + 100 * 15),
        "probe_body_scale": ({"load": 1, "int": 6000}, 170 + 6000 * 2),
        "probe_scalar_push": ({"load": 1, "int": 281, "lds": 1},
                              170 + 281 * 2 + 16),
        "probe_p2_native": ({"load": 1, "int": 150, "redux": 50},
                            170 + 150 * 2 + 50 * 15),
        "probe_p2_roll": ({"load": 1, "int": 400, "shfl": 250},
                          170 + 400 * 2 + 250 * 10),
        "probe_pallas_dfs_shape": (
            {"load": 101, "int": 1000, "redux": 100, "shfl": 100},
            101 * 170 + 1000 * 2 + 100 * 15 + 100 * 10),
        "probe_p2_subl": ({"load": 1, "int": 450, "lds": 50},
                          170 + 450 * 2 + 50 * 16),
        "probe_p6": ({"load": 1, "fp32": 130}, 170 + 130 * 2)}
    for name, (steps, ns) in want.items():
        assert probes[name]["chain_steps"] == steps, name
        assert probes[name]["chain_bound_ms"] == pytest.approx(ns * 1e-6)
    roll = probes["probe_p2_roll"]
    assert roll["witness_chain_steps"] == {"load": 1, "int": 650,
                                           "shfl": 250}
    wit_ns = 170 + 650 * 2 + 250 * 10
    assert roll["witness_chain_bound_ms"] == pytest.approx(wit_ns * 1e-6)
    assert roll["witness_queued_over_chain"] == \
        pytest.approx(0.03 / (wit_ns * 1e-6))
    for name in ("probe_p2_roll", "probe_p6", "probe_pallas_dfs_shape"):
        assert probes[name]["queued_over_chain"] == pytest.approx(
            0.01 / (want[name][1] * 1e-6)), name
    for name, per_warp in cs.WHILE_WITNESS_ISSUE.items():
        e = probes[name]
        assert e["witness_issue_ceiling_ms"] == pytest.approx(
            50 * per_warp * 32 / 4 / 2.0 * 1e-6)
        assert e["queued_over_chain"] == pytest.approx(
            0.01 / e["chain_bound_ms"])
        assert e["witness_queued_over_chain"] == pytest.approx(
            0.03 / e["chain_bound_ms"])


def test_sass_loops_finds_backward_branches():
    """`compare.py`'s `sass_loops` counts a loop's body from its backward
    branch's target to the branch, for a hex target (an encoding comment
    after it; `BRA.DIV`'s after its register) and for a label, and skips
    forward branches and a branch to itself; `sass_counts` reads them from
    `cuobjdump -sass` text."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("compare_here",
                                                  REPO / "compare.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    code = [(0x00, ["MOV", "R1,", "c[0x0][0x28]", ";"]),
            (0x10, ["ISETP.GE.AND", "P0,", "PT,", "R0,", "0x1,", "PT", ";"]),
            (0x20, ["BRA", "0x60", ";"]),
            (0x30, ["IADD3", "R2,", "R2,", "0x1,", "RZ", ";"]),
            (0x40, ["IMNMX", "R3,", "R3,", "R2,", "PT", ";"]),
            (0x50, ["BRA", "0x30", ";", "/*", "0xfffffff400dc0947", "*/"]),
            (0x60, ["REDUX.MIN.S32", "UR4,", "R3", ";"]),
            (0x70, ["BRA", "`(.L_x_1)", ";"]),
            (0x80, ["BRA.DIV", "UR4,", "0x10", ";"]),
            (0x90, ["BRA", "0x90;"])]
    want = [{"from": "0x30", "to": "0x50", "instructions": 3},
            {"from": "0x30", "to": "0x70", "instructions": 5},
            {"from": "0x10", "to": "0x80", "instructions": 8}]
    assert mod.sass_loops(code, {".L_x_1": 3}) == want
    text = "\n".join(
        ["        Function : _Z6kernelv"]
        + [f"        /*{a:04x}*/    {' '.join(w)}" for a, w in code[:9]])
    got = mod.sass_counts(text)["_Z6kernelv"]
    assert got["instructions"] == 9 and got["by_opcode"]["BRA"] == 4
    assert got["loops"] == want[:1] + want[2:]
