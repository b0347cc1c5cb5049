"""Probes 1, 1b, 3, 4, 7 and 8 of scripts/probe_pallas3.py (`nabwa_tpu_torch.
probes.probe_pallas3`) against the JAX script on the CPU, and the entry
point of all nine (probes 2, 5 and 6 are held to the script in
tests/test_torch_probe_pallas3_reduce.py).

The script is loaded in Pallas interpret mode with `np.random` seeded and
its `timeit` replaced by one call that records the jitted `run`, its
inputs and its result.  The plain versions must equal the script's kernel
exactly (int32) at the script's inputs and, through the captured `run`,
at edge inputs.  Probes 1 and 1b (the scalar-indexed row copies) and 3
(the gather along the rows) at indices that hit both ends of the table,
repeat four rows, or are all one row, with table values over all of
int32 (probe 1 also with its unread lanes 2-127 at INT32_MIN), and probe
3 at a permutation of each column; out-of-range indices are refused
before dispatch, since interpret mode wraps or clamps them where a
gather would not.  Probe 4 (the relayout) at int32 edges.  Probe 7 at
its four shapes and probe 8 on [256, 128], at seeded random int32 with
values within 8 of INT32_MAX and INT32_MIN (probe 7's v + i wraps) and,
for probe 8, scalars a near both ends and negative (v - a wraps) and
equal to plane values (the where's tie goes to v + i).  Kernels C25's
and C26's steps and C30's source int4, `p7_step`, `p8_step` and
`relayout_src` of csrc/probes.cuh built by g++, equal the plain formulas
value by value.  The entry point prints the script's lines for each
probe and, with no name, for all nine in the script's order, whose names
are exactly the script's; a name the script lacks exits non-zero as no
such probe; a missing card, CPU tensors, misaligned inputs and shapes
the kernels do not take are refused.
"""

import ast
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabwa_tpu_torch.probes import common
from nabwa_tpu_torch.probes import probe_pallas3 as p3

# fixtures and helpers shared with the other probe ports' tests
from .test_torch_probe_pallas import _misaligned, _on_card
from .test_torch_probe_spill import masked
from .test_torch_probes import (_call, _i32, _t, host,  # noqa: F401
                                one_torch_thread, script)

REPO = p3.__file__.rsplit("/nabwa_tpu_torch/", 1)[0]
CPU = torch.device("cpu")
I32_MAX, I32_MIN = 2**31 - 1, -2**31
EDGES = [I32_MAX - d for d in range(8)] + [I32_MIN + d for d in range(8)]
# the script's result lines, numbers aside (`masked`)
P7_LINES = ["P7 200 ops on (1, 256):#us", "P7 200 ops on (256, 1):#us",
            "P7 200 ops on (8, 256):#us", "P7 200 ops on (8, 512):#us"]
P8_LINES = ["P8 30 col-broadcast ops on [256,128]:#us"]
P1_LINES = ["P1 lane-1 scalar read:#us ok=True"]
P1B_LINES = ["P1b two-col scalar reads 512 loads:#us ok=True"]
P3_LINES = ["P3 take_along_axis sublanes:#us ok=True"]
P4_LINES = ["P4 reshape [512,16]->[64,128]:#us ok=True"]
P2_LINES = [f"P2 min-reduce[{k}] 50 iters:#ms (#us/iter)"
            for k in ("native", "roll", "subl")]
P5_LINES = ["P5 dyn-trip inner fori 50 outers:#ms"]
P6_LINES = ["P6 matmul-ones reduce [512,128]:#us ok=True"]
LINES = {"1": P1_LINES, "1b": P1B_LINES, "2": P2_LINES, "3": P3_LINES,
         "4": P4_LINES, "5": P5_LINES, "6": P6_LINES, "7": P7_LINES,
         "8": P8_LINES}


def _load(script, monkeypatch, capsys, seed, probe):
    """Run probe `probe` of the script once with np.random seeded; returns
    (what each of its timeit calls saw: the jitted `run`, its inputs and
    its result; the lines the probe printed)."""
    np.random.seed(seed)
    mod = script("probe_pallas3")
    capsys.readouterr()                       # the import's devices line
    seen = []

    def timeit(f, *args, n=20):
        r = f(*args)
        seen.append({"run": f, "args": [np.asarray(a) for a in args],
                     "r": np.asarray(r)})
        return 0.0, r
    monkeypatch.setattr(mod, "timeit", timeit)
    getattr(mod, probe)()
    lines = capsys.readouterr().out.splitlines()
    assert seen and not any("FAILED" in ln for ln in lines), lines
    return seen, lines


def _run(call, *args):
    return np.asarray(call["run"](*(jnp.asarray(a) for a in args)))


def _indices(rng, rows, shape, case):
    """int32 indices in [0, rows) of `shape` for `case`: "ends" puts row 0
    and the last row at two of every three places, "repeats" draws from
    four rows only, "same" is one row everywhere."""
    i = rng.integers(0, rows, shape)
    flat = i.reshape(-1)
    if case == "ends":
        flat[0::3] = 0
        flat[1::3] = rows - 1
    elif case == "repeats":
        i = rng.integers(0, 4, shape) * (rows // 4) + 7
    elif case == "same":
        i = np.full(shape, rows // 2)
    return i.astype(np.int32)


def _table(rng, shape):
    """A seeded int32 table over all of int32, the edges in its first
    row."""
    t = rng.integers(I32_MIN, I32_MAX, shape, endpoint=True)
    t[0, :16] = EDGES
    return t.astype(np.int32)


COPY_CASES = ["script", "ends", "repeats", "same"]


@pytest.mark.parametrize("case", COPY_CASES)
def test_p1_matches_jax(script, monkeypatch, capsys, case):
    (call,), lines = _load(script, monkeypatch, capsys, 1303, "p1")
    assert masked(lines) == P1_LINES
    i, t = call["args"]
    assert i.shape == (p3.P1_ROUNDS, 128) and t.shape == p3.P1_TABLE
    want = call["r"]
    if case != "script":
        rng = np.random.default_rng(1303)
        i = _indices(rng, len(t), i.shape, case)
        i[:, 2:] = I32_MIN                  # lanes the probe never reads
        t = _table(rng, t.shape)
        want = _run(call, i, t)
    got = p3.p1(*common.tensors(CPU, i, t))
    assert got.dtype == torch.int32 and got.shape == (2 * len(i), 128)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate([t[i[:, 0]], t[i[:, 1]]]))


@pytest.mark.parametrize("case", COPY_CASES)
def test_p1b_matches_jax(script, monkeypatch, capsys, case):
    (call,), lines = _load(script, monkeypatch, capsys, 1304, "p1b")
    assert masked(lines) == P1B_LINES
    i, j, t = call["args"]
    assert i.shape == j.shape == (p3.P1_ROUNDS, 1)
    want = call["r"]
    if case != "script":
        rng = np.random.default_rng(1304)
        i = _indices(rng, len(t), i.shape, case)
        j = _indices(rng, len(t), j.shape, case)[::-1].copy()
        t = _table(rng, t.shape)
        want = _run(call, i, j, t)
    got = p3.p1b(*common.tensors(CPU, i, j, t))
    assert got.dtype == torch.int32 and got.shape == (2 * len(i), 128)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate([t[i[:, 0]], t[j[:, 0]]]))


@pytest.mark.parametrize("case", COPY_CASES + ["perm"])
def test_p3_matches_jax(script, monkeypatch, capsys, case):
    (call,), lines = _load(script, monkeypatch, capsys, 1305, "p3")
    assert masked(lines) == P3_LINES
    x, i = call["args"]
    assert x.shape == p3.P3_X and i.shape == p3.P3_I
    want = call["r"]
    if case != "script":
        rng = np.random.default_rng(1305)
        x = _table(rng, x.shape)
        if case == "perm":           # distinct rows down each column
            i = np.stack([rng.permutation(len(x))[:len(i)]
                          for _ in range(i.shape[1])], 1).astype(np.int32)
        else:
            i = _indices(rng, len(x), i.shape, case)
        want = _run(call, x, i)
    got = p3.p3(*common.tensors(CPU, x, i))
    assert got.dtype == torch.int32 and got.shape == i.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(x, i, axis=0))


@pytest.mark.parametrize("case", ["script", "edges"])
def test_p4_matches_jax(script, monkeypatch, capsys, case):
    (call,), lines = _load(script, monkeypatch, capsys, 1306, "p4")
    assert masked(lines) == P4_LINES
    x, = call["args"]
    assert x.shape == p3.P4_X
    want = call["r"]
    if case == "edges":
        x = _table(np.random.default_rng(1306), x.shape)
        x[:, :16] = EDGES            # every out word an int32 edge
        x[1::2, :16] = x[1::2, :16][:, ::-1]
        want = _run(call, x)
    got = p3.p4(*common.tensors(CPU, x))
    assert got.dtype == torch.int32 and got.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("bad", [-1, "rows", I32_MIN])
@pytest.mark.parametrize("probe", ["p1", "p1b", "p3"])
def test_indices_out_of_range_refused(probe, bad, on_card):
    """Interpret mode wraps or clamps an index outside the table (p1 reads
    row 15 of a 16-row table for -1 and 99 alike), so the dispatchers
    refuse one before any copy: on the CPU, and before any launch for
    tensors on the card (a launch here would fail to build, not refuse)."""
    rows = 4096 if probe != "p3" else p3.P3_X[0]
    make = _on_card if on_card else _zeros
    t = make(rows, 128)
    i = _zeros(8, 128 if probe != "p1b" else 1)
    i[5, 1 if probe == "p1" else 0] = rows if bad == "rows" else bad
    if on_card:
        i = i.as_subclass(type(t))
    call = {"p1": lambda: p3.p1(i, t),
            "p1b": lambda: p3.p1b(torch.zeros_like(i), i, t),
            "p3": lambda: p3.p3(t, i)}[probe]
    with pytest.raises(ValueError, match=r"indices outside \[0, "):
        call()


def test_p1_reads_only_lanes_0_and_1():
    """Probe 1 reads lanes 0 and 1 of each index row (:38, :40); the
    others may hold anything."""
    t = torch.arange(16 * 128, dtype=torch.int32).view(16, 128)
    i = torch.full((4, 128), -7, dtype=torch.int32)
    i[:, :2] = torch.tensor([[0, 15], [3, 3], [15, 0], [8, 9]])
    got = p3.p1(i, t)
    np.testing.assert_array_equal(
        got.numpy(), t.numpy()[[0, 3, 15, 8, 15, 3, 0, 9]])


def test_p7_matches_jax(script, monkeypatch, capsys):
    seen, lines = _load(script, monkeypatch, capsys, 1301, "p7")
    assert masked(lines) == P7_LINES
    assert [c["args"][0].shape for c in seen] == list(p3.P7_SHAPES)
    rng = np.random.default_rng(1301)
    for call in seen:
        x, = call["args"]
        got = p3.p7(*common.tensors(CPU, x))
        assert got.dtype == torch.int32 and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), call["r"])
        edge = rng.integers(I32_MIN, I32_MAX, x.shape, endpoint=True)
        flat = edge.reshape(-1)
        flat[:min(len(flat), 16)] = EDGES[:len(flat)]
        edge = edge.astype(np.int32)
        got = p3.p7(*common.tensors(CPU, edge))
        np.testing.assert_array_equal(got.numpy(), _run(call, edge))


def _p8_inputs(rng):
    """(a, b) edge inputs for probe 8: a near both ends, negative, 0 and
    random over int32, b random over int32 with the edges in its rows and
    some of each row equal to its a."""
    a = rng.integers(I32_MIN, I32_MAX, (p3.P8_ROWS, 1), endpoint=True)
    a[:16, 0] = EDGES
    a[16:20, 0] = (0, -1, -99, 1)
    b = rng.integers(I32_MIN, I32_MAX, (p3.P8_ROWS, p3.P8_COLS),
                     endpoint=True)
    b[:, :16] = EDGES
    b[:, 16:20] = a
    return a.astype(np.int32), b.astype(np.int32)


def test_p8_matches_jax(script, monkeypatch, capsys):
    (call,), lines = _load(script, monkeypatch, capsys, 1302, "p8")
    assert masked(lines) == P8_LINES
    a, b = call["args"]
    assert a.shape == (p3.P8_ROWS, 1) and b.shape == (p3.P8_ROWS,
                                                      p3.P8_COLS)
    got = p3.p8(*common.tensors(CPU, a, b))
    assert got.dtype == torch.int32 and got.shape == b.shape
    np.testing.assert_array_equal(got.numpy(), call["r"])
    a, b = _p8_inputs(np.random.default_rng(1302))
    want = _run(call, a, b)
    got = p3.p8(*common.tensors(CPU, a, b))
    np.testing.assert_array_equal(got.numpy(), want)
    # the subtraction wraps somewhere (a near INT32_MIN under a large v)
    v = b.astype(np.int64)
    assert ((v > a) & (v - a > I32_MAX)).any()


def _check_p7_step(host, rng):
    n = 4000
    v = _i32(rng, n, [0, -1, 1] + EDGES)
    i = rng.integers(0, p3.P7_STEPS, n).astype(np.int32)
    i[:19] = p3.P7_STEPS - 1
    got, = _call(host.nabwa_host_probe_p7_step, 1, v, i)
    return got, p3.p7_step(_t(v), _t(i))


def _check_p8_step(host, rng):
    n = 4000
    v = _i32(rng, n, [0, -1, 1] + EDGES)
    a = _i32(rng, n, [-1, 0, 1] + EDGES[::-1])
    a[3000:] = v[3000:]                       # ties: v + i
    i = rng.integers(0, p3.P8_STEPS, n).astype(np.int32)
    got, = _call(host.nabwa_host_probe_p8_step, 1, v, a, i)
    return got, p3.p8_step(_t(v), _t(a), _t(i))


def _check_relayout_src(host, rng):
    """C30's source int4 for out int4 q against out[r, c] = x[8 r + c //
    16, c % 16] (scripts/probe_pallas3.py:142), word 0 of each int4."""
    n = 4000
    quads = rng.integers(4, 1 << 12, n)
    q = rng.integers(0, 1 << 18, n)
    quads[:4], q[:4] = (4, 4, 32, 1 << 12), (0, 127, 255, (1 << 18) - 1)
    got, = _call(host.nabwa_host_probe_relayout_src, 1,
                 q.astype(np.int32), quads.astype(np.int32))
    r, c = q // 32, 4 * (q % 32)
    word = (8 * r + c // 16) * 4 * quads + c % 16
    return got, _t(word // 4)


@pytest.mark.parametrize("name, check", [
    ("p7_step", _check_p7_step), ("p8_step", _check_p8_step),
    ("relayout_src", _check_relayout_src)])
def test_host_steps_match_plain(host, name, check):
    """csrc/probes.cuh `p7_step` (kernel C25), `p8_step` (C26) and
    `relayout_src` (C30), built for the host, equal the plain formulas
    value by value."""
    got, want = check(host, np.random.default_rng(1310 + len(name)))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("which", [["1"], ["1b"], ["2"], ["3"], ["4"],
                                   ["5", "6"], ["7", "8"], []])
def test_entry_point_cpu(which):
    """The port's lines are the script's, numbers aside (the script's own
    are held to the *_LINES above and in
    tests/test_torch_probe_pallas3_reduce.py); with no name the nine
    probes run in the script's order."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "nabwa_tpu_torch.probes.probe_pallas3",
         "--device", "cpu", *which], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[0] == "devices: ['cpu']"
    assert masked(lines[1:]) == sum((LINES[w] for w in which or LINES), [])


@pytest.mark.parametrize("name", ["0", "2b", "10", "9", "p7"])
def test_other_probes_exit_nonzero(name, capsys):
    """A name the script does not have is no probe, and exits non-zero
    before any probe runs."""
    assert p3.main(["--device", "cpu", "7", name]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert f"probe {name}: no such probe" in captured.err


def test_not_ported_names():
    """Every probe of the script is ported: the entry point's names are
    exactly the script's `names`, in its order (:242-243)."""
    tree = ast.parse(pathlib.Path(REPO, "scripts",
                                  "probe_pallas3.py").read_text())
    names = [node.value for node in ast.walk(tree)
             if isinstance(node, ast.Assign)
             and [ast.unparse(t) for t in node.targets] == ["names"]]
    assert len(names) == 1
    script_names = [k.value for k in names[0].keys]
    assert list(p3.PROBES) == script_names == list(LINES)
    assert not hasattr(p3, "NOT_PORTED")


def test_entry_point_needs_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert p3.main(["--device", "cuda"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("call", [
    lambda: p3.p7_cuda(_zeros(8, 256)),
    lambda: p3.p8_cuda(_zeros(256, 1), _zeros(256, 128)),
    lambda: p3.p1_cuda(_zeros(256, 128), _zeros(4096, 128)),
    lambda: p3.p1b_cuda(_zeros(256, 1), _zeros(256, 1), _zeros(4096, 128)),
    lambda: p3.p3_cuda(_zeros(128, 128), _zeros(8, 128)),
    lambda: p3.p4_cuda(_zeros(512, 128))])
def test_kernels_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()


@pytest.mark.parametrize("call, match", [
    (lambda: p3.p7_cuda(_misaligned(8, 256)), "not 16-byte aligned"),
    (lambda: p3.p8_cuda(_on_card(256, 1), _misaligned(256, 128)),
     "not 16-byte aligned"),
    (lambda: p3.p8_cuda(_misaligned(256, 1), _on_card(256, 128)),
     "not 16-byte aligned"),
    (lambda: p3.p8_cuda(_on_card(256, 1), _on_card(256, 126)),
     "multiple of 4"),
    (lambda: p3.p8_cuda(_on_card(255, 1), _on_card(256, 128)),
     r"a must be \[256, 1\]"),
    (lambda: p3.p1_cuda(_misaligned(256, 128), _on_card(4096, 128)),
     "not 16-byte aligned"),
    (lambda: p3.p1_cuda(_on_card(256, 128), _misaligned(4096, 128)),
     "not 16-byte aligned"),
    (lambda: p3.p1_cuda(_on_card(256, 128), _on_card(4096, 126)),
     "multiple of 4 words"),
    (lambda: p3.p1_cuda(_on_card(256, 1), _on_card(4096, 128)),
     r"W >= 2"),
    (lambda: p3.p1_cuda(_on_card(256), _on_card(4096, 128)), "1 dims"),
    (lambda: p3.p1b_cuda(_on_card(256, 1), _misaligned(256, 1),
                         _on_card(4096, 128)), "not 16-byte aligned"),
    (lambda: p3.p1b_cuda(_on_card(256, 1), _on_card(256, 1),
                         _on_card(4096, 6)), "multiple of 4 words"),
    (lambda: p3.p1b_cuda(_on_card(256, 1), _on_card(255, 1),
                         _on_card(4096, 128)), r"must be \[n, 1\]"),
    (lambda: p3.p1b_cuda(_on_card(256, 2), _on_card(256, 2),
                         _on_card(4096, 128)), r"must be \[n, 1\]"),
    (lambda: p3.p3_cuda(_misaligned(128, 128), _on_card(8, 128)),
     "not 16-byte aligned"),
    (lambda: p3.p3_cuda(_on_card(128, 128), _misaligned(8, 128)),
     "not 16-byte aligned"),
    (lambda: p3.p3_cuda(_on_card(128, 128), _on_card(8, 64)),
     r"\[R, C\] and \[M, C\]"),
    (lambda: p3.p4_cuda(_misaligned(512, 128)), "not 16-byte aligned"),
    (lambda: p3.p4_cuda(_on_card(500, 128)), "multiple of 8"),
    (lambda: p3.p4_cuda(_on_card(512, 12)), "at least 16"),
    (lambda: p3.p4_cuda(_on_card(512, 18)), "multiple of 4 words")])
def test_kernels_refuse_inputs(call, match):
    """A wrapper refuses what its kernel does not take, before any
    launch."""
    with pytest.raises(ValueError, match=match):
        call()
