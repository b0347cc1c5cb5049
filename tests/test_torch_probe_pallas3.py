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
the kernels do not take are refused.  The launch path shared by C29, C28,
C27, C20, C7, C15, C8 and C11 (scripts/probe_pallas2.py's lane gather and
launch, scripts/probe_pallas.py's row gathers and scripts/probe_dma.py's
row fetches, whose cases sit here beside the others' for the card-tensor
helpers) is held on fake card tensors and a fake kernel library: one
check pass, each pointer and device index read once, the stream of that
index, exact counts, and every refusal with the message and in the order
of the wrapper's checks one at a time (C8's grid and serial forms, C11
on every shape, 0-d and empty included).  C23's and C34's wrappers, both
forms of each (the lane form and the witness, the grid form and the
witness), are held the same way: refusals in the order of the checks one
at a time (x, then K, then the lane form's group or the witness's shared
memory), nothing launched on an empty x, the pointers read once, and
each form's count exact over 4 threads.  C34's grid form is also played
thread by thread on the host (`p5_words` of csrc/probes.cuh, built by
g++) and held to the plain version and the script at its inputs, and to
the plain version at [512, 128] and at a word count that is not a
multiple of a thread's 4.
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
from nabwa_tpu_torch.probes import probe_dma as pdma
from nabwa_tpu_torch.probes import probe_pallas as pp
from nabwa_tpu_torch.probes import probe_pallas2 as pp2
from nabwa_tpu_torch.probes import probe_pallas3 as p3
from nabwa_tpu_torch.probes import probe_spill as ps

# fixtures and helpers shared with the other probe ports' tests
from nabwa_tpu_torch.ops import _build

from .test_torch_probe_pallas import (_Counted, _launch_from_threads,
                                      _misaligned, _no_build, _on_card,
                                      _OnCard, _OnCard1,
                                      fake_launch)  # noqa: F401
from .test_torch_probe_spill import masked
from .test_torch_probes import (_I, _P, _call, _i32, _t,  # noqa: F401
                                host, one_torch_thread, script)

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
    pytest.param(lambda: p3.p1_cuda(_on_card(256, 1), _on_card(4096, 126)),
                 "multiple of 4 words", id="c27-table-before-width"),
    pytest.param(lambda: pp2.lane_gather_cuda(_on_card(256, 64),
                                              _on_card(256, 64)),
                 r"x and i must be \[R, 128\], got \(256, 64\) and "
                 r"\(256, 64\)", id="c20-narrow"),
    pytest.param(lambda: pp2.lane_gather_cuda(_on_card(256, 128),
                                              _on_card(255, 128)),
                 r"x and i must be \[R, 128\]", id="c20-shapes-differ"),
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
    (lambda: p3.p3_cuda(_on_card(128, 128), _on_card(8, 128).long()),
     "i: dtype torch.int64, expected torch.int32"),
    (lambda: p3.p3_cuda(_on_card(128, 128), _on_card(128, 8).t()),
     "i: not contiguous"),
    (lambda: p3.p3_cuda(_on_card(128, 128).t(), _on_card(8, 128)),
     "x: not contiguous"),
    (lambda: p3.p1b_cuda(_on_card(256, 1), _on_card(256, 1).long(),
                         _on_card(4096, 128)),
     "j: dtype torch.int64, expected torch.int32"),
    (lambda: p3.p1b_cuda(_on_card(256, 1).t(), _on_card(256, 1),
                         _on_card(4096, 128)), r"must be \[n, 1\]"),
    (lambda: p3.p1b_cuda(_on_card(256, 1), _on_card(256, 2)[:, 1:],
                         _on_card(4096, 128)), "j: not contiguous"),
    (lambda: p3.p1b_cuda(_on_card(256, 1), _on_card(256, 1),
                         _on_card(128, 4096).t()), "t: not contiguous"),
    (lambda: p3.p4_cuda(_misaligned(512, 128)), "not 16-byte aligned"),
    (lambda: p3.p4_cuda(_on_card(500, 128)), "multiple of 8"),
    (lambda: p3.p4_cuda(_on_card(512, 12)), "at least 16"),
    (lambda: p3.p4_cuda(_on_card(512, 18)), "multiple of 4 words")])
def test_kernels_refuse_inputs(call, match):
    """A wrapper refuses what its kernel does not take, before any
    launch."""
    with pytest.raises(ValueError, match=match):
        call()


def _reference_cuda_input(t, name, ndim, dev=None, dtype=torch.int32):
    """`common.cuda_input` written with `t.device` for every test: the
    type's name, then `_build.require`'s order (the device read again),
    then the alignment."""
    on = t.device
    if on.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {on}")
    dev = on if dev is None else dev
    _build.require(t, name, dev, ndim, dtype)
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")
    return dev


def _one_at_a_time(check, specs):
    """`check` on each spec in turn, the later ones with the first's
    device, as a wrapper checked its inputs one by one."""
    dev = None
    for t, name, ndim, dtype in specs:
        dev = check(t, name, ndim, dev, dtype)


# the inputs of C28 (i, j, t), C27 (i, t), C20 (x, i) and C29 (x, i) by
# name and shape, and each kernel's wrapper: every caller of the one check
# pass with the four-element spec
_INPUTS = {
    "c28": ((("i", (256, 1)), ("j", (256, 1)), ("t", (4096, 128))),
            p3.p1b_cuda),
    "c27": ((("i", (p3.P1_ROUNDS, 128)), ("t", p3.P1_TABLE)), p3.p1_cuda),
    "c20": ((("x", (pp2.BB, pp2.GATHER_W)), ("i", (pp2.BB, pp2.GATHER_W))),
            pp2.lane_gather_cuda),
    "c29": ((("x", p3.P3_X), ("i", p3.P3_I)), p3.p3_cuda)}
# what may be wrong with an input: its bad form, given its shape
_BAD = {
    "cpu": lambda shape: _zeros(*shape),
    "int64": lambda shape: _on_card(*shape).long(),
    "dims": lambda shape: _on_card(shape[0] * shape[1]),
    "transposed": lambda shape: _on_card(*shape[::-1]).t(),
    "column": lambda shape: _on_card(shape[0], shape[1] + 1)[:, 1:],
    "misaligned": lambda shape: _misaligned(*shape),
    "cuda1": lambda shape: _zeros(*shape).as_subclass(_OnCard1)}
# each kernel, each bad form, each position ([n, 1] has no transposed
# view that is not contiguous; the first input sets the device); C28's
# cases keep their ids
_BAD_CASES = [
    pytest.param(kernel, kind, pos, id=(f"{kind}-{pos}" if kernel == "c28"
                                        else f"{kernel}-{kind}-{pos}"))
    for kernel, (inputs, _) in _INPUTS.items() for kind in _BAD
    for pos in range(len(inputs))
    if not (kind == "cuda1" and pos == 0)
    and not (kind == "transposed" and inputs[pos][1][1] == 1)]


@pytest.mark.parametrize("kernel, kind, pos", _BAD_CASES)
def test_cuda_inputs_refuses_as_one_at_a_time(kernel, kind, pos,
                                              monkeypatch):
    """The one check pass refuses a bad input in any position of C28's,
    C27's, C20's or C29's inputs with the ValueError that checking the inputs
    one at a time raised (the reference's reads of `t.device`, and
    `common.cuda_input`'s), and so does the kernel's wrapper, before
    anything is built or launched."""
    _no_build(monkeypatch)
    inputs, wrapper = _INPUTS[kernel]
    specs = [(_BAD[kind](shape) if k == pos else _on_card(*shape), name, 2,
              torch.int32) for k, (name, shape) in enumerate(inputs)]
    msgs = []
    for check in (lambda: common.cuda_inputs(*specs),
                  lambda: _one_at_a_time(_reference_cuda_input, specs),
                  lambda: _one_at_a_time(common.cuda_input, specs),
                  lambda: wrapper(*[t for t, *_ in specs])):
        with pytest.raises(ValueError) as err:
            check()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == msgs[2] == msgs[3]
    name = inputs[pos][0]
    assert msgs[0] == {
        "cpu": "the kernel needs CUDA tensors, got cpu",
        "int64": f"{name}: dtype torch.int64, expected torch.int32",
        "dims": f"{name}: 1 dims, expected 2",
        "transposed": f"{name}: not contiguous",
        "column": f"{name}: not contiguous",
        "misaligned": f"{name}: not 16-byte aligned",
        "cuda1": f"{name}: on cuda:1, expected cuda:0"}[kind]


def test_cuda_inputs_returns_index_and_pointers(monkeypatch):
    """On good inputs the pass returns the device's index and each
    tensor's data pointer in order (a dtype per tensor: C35's float32 w
    beside an int32 x)."""
    _no_build(monkeypatch)
    ts = [_on_card(256, 1), _on_card(256, 1), _on_card(4096, 128),
          torch.zeros(128, 8).as_subclass(_OnCard)]
    got = common.cuda_inputs(*[(t, f"t{k}", 2, t.dtype)
                               for k, t in enumerate(ts)])
    assert got == (0, [t.data_ptr() for t in ts])
    one = torch.zeros(4, 4, dtype=torch.int32).as_subclass(_OnCard1)
    assert common.cuda_inputs((one, "x", 2, torch.int32)) == (
        1, [one.data_ptr()])


def test_cuda_inputs_long_spec(monkeypatch):
    """The six-element spec: with alignment 16 and no follow-on check it
    is the four-element one; an int32 tensor 4 bytes past a 16-byte
    boundary passes at alignment 4 (C7's and C15's index, read as int32)
    and is refused at 16; `then` runs on its tensor once that tensor has
    passed its own checks, and before the next tensor is checked."""
    _no_build(monkeypatch)
    i32 = torch.int32
    a, b, m = _on_card(8, 1), _on_card(16, 128), _misaligned(8, 1)
    assert common.cuda_inputs((a, "a", 2, i32, 16, None),
                              (b, "b", 2, i32)) == common.cuda_inputs(
        (a, "a", 2, i32), (b, "b", 2, i32))
    assert common.cuda_inputs((m, "m", 2, i32, 4, None)) == (
        0, [m.data_ptr()])
    for spec in ((m, "m", 2, i32), (m, "m", 2, i32, 16, None)):
        with pytest.raises(ValueError, match="^m: not 16-byte aligned$"):
            common.cuda_inputs(spec)
    seen = []

    def then(t):
        seen.append(t)
        raise ValueError("then")
    with pytest.raises(ValueError, match="^a: 1 dims, expected 2$"):
        common.cuda_inputs((_on_card(8), "a", 2, i32, 4, then),
                           (b, "b", 2, i32))
    assert not seen
    with pytest.raises(ValueError, match="^then$"):
        common.cuda_inputs((a, "a", 2, i32, 4, then),
                           (_zeros(16, 128), "b", 2, i32))
    assert len(seen) == 1 and seen[0] is a


@pytest.mark.parametrize("call", [
    lambda: p3.p3_cuda(_on_card(128, 128),
                       _zeros(8, 128).as_subclass(_OnCard1)),
    lambda: p3.p1b_cuda(_on_card(256, 1), _on_card(256, 1),
                        _zeros(4096, 128).as_subclass(_OnCard1)),
    lambda: p3.p1_cuda(_on_card(256, 128),
                       _zeros(4096, 128).as_subclass(_OnCard1)),
    lambda: pp2.lane_gather_cuda(_on_card(256, 128),
                                 _zeros(256, 128).as_subclass(_OnCard1))])
def test_c28_c29_refuse_other_device(call, monkeypatch):
    """C29, C28, C27 and C20 refuse an input on another card than the
    first's, before anything is built or launched; their counts stay."""
    _no_build(monkeypatch)
    counts = (p3.launches_p3, p3.launches_p1b, p3.launches_p1,
              pp2.launches_lane_gather)
    with pytest.raises(ValueError, match="on cuda:1, expected cuda:0"):
        call()
    assert (p3.launches_p3, p3.launches_p1b, p3.launches_p1,
            pp2.launches_lane_gather) == counts


def test_c28_c29_launch_on_pointers_read_once(fake_launch, monkeypatch):
    """C29 and C28 launch on the data pointers and the device index their
    one check pass read: each input's pointer read once, its device index
    once, `device` never (a launch needs no torch.device); the stream is
    the one of that index, the sizes are the shapes', and each count
    rises by one."""
    from collections import Counter
    monkeypatch.setattr(_Counted, "reads", Counter())
    x, i = (_zeros(*s).as_subclass(_Counted) for s in (p3.P3_X, p3.P3_I))
    before = p3.launches_p3
    out = p3.p3_cuda(x, i)
    assert _Counted.reads == Counter(
        {(k, id(a)): 1 for k in ("data_ptr", "get_device") for a in (x, i)}
        | {("data_ptr", id(out)): 1})
    assert fake_launch.calls[-1] == (x.data_ptr(), 128, i.data_ptr(), 1024,
                                     out.data_ptr(), 1000)
    assert tuple(out.shape) == p3.P3_I and out.dtype == torch.int32
    assert p3.launches_p3 == before + 1
    ij = [_zeros(p3.P1_ROUNDS, 1).as_subclass(_Counted) for _ in range(2)]
    t = _zeros(*p3.P1_TABLE).as_subclass(_Counted)
    reads = dict(_Counted.reads)
    before = p3.launches_p1b
    out = p3.p1b_cuda(*ij, t)
    new = _Counted.reads - Counter(reads)
    assert new == Counter({(k, id(a)): 1 for k in ("data_ptr", "get_device")
                           for a in (*ij, t)} | {("data_ptr", id(out)): 1})
    assert fake_launch.calls[-1] == (ij[0].data_ptr(), ij[1].data_ptr(),
                                     256, t.data_ptr(), 128, out.data_ptr(),
                                     1000)
    assert tuple(out.shape) == (512, 128) and out.dtype == torch.int32
    assert p3.launches_p1b == before + 1
    one = [_zeros(*s).as_subclass(_OnCard1) for s in (p3.P3_X, p3.P3_I)]
    p3.p3_cuda(*one)
    assert fake_launch.calls[-1][-1] == 1001


def test_c28_c29_empty_launch_nothing(fake_launch):
    """No rows: an empty output and no launch, no count."""
    counts = (p3.launches_p3, p3.launches_p1b)
    assert p3.p3_cuda(_on_card(128, 128), _on_card(0, 128)).shape == (0, 128)
    assert p3.p1b_cuda(_on_card(0, 1), _on_card(0, 1),
                       _on_card(4096, 128)).shape == (0, 128)
    assert not fake_launch.calls
    assert (p3.launches_p3, p3.launches_p1b) == counts


@pytest.mark.parametrize("kernel", ["c27", "c20"])
def test_c27_c20_launch_on_pointers_read_once(kernel, fake_launch,
                                              monkeypatch):
    """C27 and C20 launch as C29 and C28 do: on the data pointers and the
    device index their one check pass read, each input's pointer and
    device index read once, `device` never, the stream of that index
    (of index 1 for inputs on the second card), the sizes the shapes';
    the count rises by one."""
    from collections import Counter
    monkeypatch.setattr(_Counted, "reads", Counter())
    inputs, wrapper = _INPUTS[kernel]
    mod, count = {"c27": (p3, "launches_p1"),
                  "c20": (pp2, "launches_lane_gather")}[kernel]
    ts = [_zeros(*shape).as_subclass(_Counted) for _, shape in inputs]
    before = getattr(mod, count)
    out = wrapper(*ts)
    assert _Counted.reads == Counter(
        {(k, id(a)): 1 for k in ("data_ptr", "get_device") for a in ts}
        | {("data_ptr", id(out)): 1})
    a, b = (t.data_ptr() for t in ts)
    assert fake_launch.calls[-1] == {
        "c27": (a, 128, p3.P1_ROUNDS, b, 128, out.data_ptr(), 1000),
        "c20": (a, b, pp2.BB, out.data_ptr(), 1000)}[kernel]
    assert tuple(out.shape) == {"c27": (2 * p3.P1_ROUNDS, 128),
                                "c20": (pp2.BB, pp2.GATHER_W)}[kernel]
    assert out.dtype == torch.int32
    assert getattr(mod, count) == before + 1
    wrapper(*[_zeros(*shape).as_subclass(_OnCard1) for _, shape in inputs])
    assert fake_launch.calls[-1][-1] == 1001


def test_c27_c20_empty_launch_nothing(fake_launch):
    """No rows: an empty output and no launch, no count."""
    counts = (p3.launches_p1, pp2.launches_lane_gather)
    assert p3.p1_cuda(_on_card(0, 128), _on_card(4096, 128)).shape == (0, 128)
    assert pp2.lane_gather_cuda(_on_card(0, 128),
                                _on_card(0, 128)).shape == (0, 128)
    assert not fake_launch.calls
    assert (p3.launches_p1, pp2.launches_lane_gather) == counts


# C7's and C15's index shape, wrapper and launch counter
_GATHERS = {"c7": ((pp.ROWLOAD_BB, 1), pp.rowload_cuda, "launches_rowload"),
            "c15": ((pp.ROWLOAD_BB,), pp.smem_idx_cuda, "launches_smem_idx")}


@pytest.mark.parametrize("kernel", list(_GATHERS))
def test_c7_c15_launch_on_pointers_read_once(kernel, fake_launch,
                                             monkeypatch):
    """C7 and C15 launch as C27 and C20 do: on the data pointers and the
    device index their one check pass read, each input's pointer and
    device index read once, `device` never, the stream of that index (of
    index 1 for inputs on the second card), BB rows; an index 4 bytes
    past a 16-byte boundary is launched on its own pointer; the count
    rises by one a launch."""
    from collections import Counter
    monkeypatch.setattr(_Counted, "reads", Counter())
    shape, wrapper, count = _GATHERS[kernel]
    idx = _zeros(*shape).as_subclass(_Counted)
    table = _zeros(pp.ROWLOAD_NROW, 128).as_subclass(_Counted)
    before = getattr(pp, count)
    out = wrapper(idx, table)
    assert _Counted.reads == Counter(
        {(k, id(a)): 1 for k in ("data_ptr", "get_device")
         for a in (idx, table)} | {("data_ptr", id(out)): 1})
    assert fake_launch.calls[-1] == (idx.data_ptr(), table.data_ptr(),
                                     pp.ROWLOAD_BB, out.data_ptr(), 1000)
    assert tuple(out.shape) == (pp.ROWLOAD_BB, 128)
    assert out.dtype == torch.int32
    assert getattr(pp, count) == before + 1
    m = _misaligned(*shape)
    wrapper(m, _on_card(pp.ROWLOAD_NROW, 128))
    assert fake_launch.calls[-1][0] == m.data_ptr()
    wrapper(_zeros(*shape).as_subclass(_OnCard1),
            _zeros(pp.ROWLOAD_NROW, 128).as_subclass(_OnCard1))
    assert fake_launch.calls[-1][-1] == 1001
    assert getattr(pp, count) == before + 3


def test_c7_c15_empty_launch_nothing(fake_launch):
    """No rows: an empty output and no launch, no count."""
    counts = (pp.launches_rowload, pp.launches_smem_idx)
    table = _on_card(pp.ROWLOAD_NROW, 128)
    assert pp.rowload_cuda(_on_card(0, 1), table).shape == (0, 128)
    assert pp.smem_idx_cuda(_on_card(0), table).shape == (0, 128)
    assert not fake_launch.calls
    assert (pp.launches_rowload, pp.launches_smem_idx) == counts


def test_c29_count_exact_under_threads(fake_launch):
    """Eight threads launching C29 together, the interpreter switching
    threads every microsecond: the count rises by exactly the launches
    made."""
    x, i = _on_card(*p3.P3_X), _on_card(*p3.P3_I)
    before = p3.launches_p3
    made = _launch_from_threads(lambda: p3.p3_cuda(x, i))
    assert p3.launches_p3 - before == made == len(fake_launch.calls)


def test_c20_count_exact_under_threads(fake_launch):
    """The same for C20."""
    x, i = (_on_card(pp2.BB, pp2.GATHER_W) for _ in range(2))
    before = pp2.launches_lane_gather
    made = _launch_from_threads(lambda: pp2.lane_gather_cuda(x, i))
    assert pp2.launches_lane_gather - before == made == len(
        fake_launch.calls)


def test_c7_count_exact_under_threads(fake_launch):
    """The same for C7."""
    idx, table = _on_card(pp.ROWLOAD_BB, 1), _on_card(pp.ROWLOAD_NROW, 128)
    before = pp.launches_rowload
    made = _launch_from_threads(lambda: pp.rowload_cuda(idx, table))
    assert pp.launches_rowload - before == made == len(fake_launch.calls)


# C8's wrappers, the grid form and the serial form, with their launch
# counters
_DMA_FORMS = {
    "grid": (pdma.dma_cuda, "launches"),
    "serial": (pdma.dma_serial_cuda, "launches_serial")}
_DMA_NROW = 16
# C8's table by form ([_DMA_NROW, 128] when good)
_DMA_TABLE = {
    "good": lambda: _on_card(_DMA_NROW, 128),
    "more_rows": lambda: _on_card(40, 128),
    "cpu": lambda: _zeros(_DMA_NROW, 128),
    "int64": lambda: _on_card(_DMA_NROW, 128).long(),
    "dims": lambda: _on_card(_DMA_NROW * 128),
    "transposed": lambda: _on_card(128, _DMA_NROW).t(),
    "column": lambda: _on_card(_DMA_NROW, 132)[:, 4:],
    "misaligned": lambda: _misaligned(_DMA_NROW, 128),
    "short": lambda: _on_card(_DMA_NROW - 1, 128),
    "narrow": lambda: _on_card(_DMA_NROW, 124)}
# C8's (N, T, n_rows, src) by form
_DMA_ARGS = {"good": (4, 2, _DMA_NROW, "reg"),
             "src": (4, 2, _DMA_NROW, "hbm"),
             "n0": (0, 2, _DMA_NROW, "cond"),
             "n_big": (pdma.MAX_N + 1, 2, _DMA_NROW, "vmem"),
             "t": (4, -1, _DMA_NROW, "smem"),
             "rows0": (4, 2, 0, "reg")}


def _old_dma_checks(tab, n, t, n_rows, src):
    """C8's checks as its wrapper made them one at a time: CUDA, the
    arguments (`_check`), the table's dtype, dims and contiguity
    (`_build.require`), then its shape [>= n_rows, 128].  The one pass
    adds the table's 16-byte alignment after its contiguity (the kernels
    read it as int4; the old wrapper did not check it)."""
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    pdma._check(n, t, n_rows, src)
    _build.require(tab, "tab", dev, 2)
    if tab.data_ptr() % 16:
        raise ValueError("tab: not 16-byte aligned")
    if tab.shape[1] != 128 or tab.shape[0] < n_rows:
        raise ValueError(f"tab must be [>= {n_rows}, 128], got "
                         f"{tuple(tab.shape)}")


@pytest.mark.parametrize("form, table_form", [
    (form, table_form) for form in _DMA_FORMS for table_form in _DMA_TABLE])
def test_c8_refuses_as_one_at_a_time(form, table_form, monkeypatch):
    """C8's grid and serial wrappers refuse, with every
    argument form beside the table, what its checks one at a time refused,
    with the same message and in the same order (CUDA, then a bad src, an
    N outside [1, MAX_N], a negative T or n_rows 0, then the table's
    dtype, dims, contiguity and alignment, then a table of fewer than
    n_rows rows or not 128 wide); before anything is built or launched,
    their counts unchanged.  What the checks took reaches the library."""
    _no_build(monkeypatch)
    wrapper, count = _DMA_FORMS[form]
    seen = set()
    for args_form, args in _DMA_ARGS.items():
        tab = _DMA_TABLE[table_form]()
        try:
            _old_dma_checks(tab, *args)
            want = None
        except ValueError as err:
            want = str(err)
        seen.add(want)
        before = (pdma.launches, pdma.launches_serial)
        if want is None:
            with pytest.raises(AssertionError, match="library was asked"):
                wrapper(tab, *args, False)
        else:
            with pytest.raises(ValueError) as err:
                wrapper(tab, *args, False)
            assert str(err.value) == want, args_form
        assert (pdma.launches, pdma.launches_serial) == before
    if table_form in ("good", "more_rows"):
        assert None in seen
    else:
        assert None not in seen


def test_c8_refusal_messages():
    """The messages the table forms meet first, with good arguments, and
    the order where a bad table meets a bad src."""
    want = {"cpu": "the kernel needs CUDA tensors, got cpu",
            "int64": "tab: dtype torch.int64, expected torch.int32",
            "dims": "tab: 1 dims, expected 2",
            "transposed": "tab: not contiguous",
            "column": "tab: not contiguous",
            "misaligned": "tab: not 16-byte aligned",
            "short": "tab must be [>= 16, 128], got (15, 128)",
            "narrow": "tab must be [>= 16, 128], got (16, 124)"}
    for form, msg in want.items():
        for wrapper, _ in _DMA_FORMS.values():
            with pytest.raises(ValueError) as err:
                wrapper(_DMA_TABLE[form](), *_DMA_ARGS["good"], True)
            assert str(err.value) == msg, form
    # CUDA before the arguments, the arguments before the table
    with pytest.raises(ValueError, match="needs CUDA tensors, got cpu"):
        pdma.dma_cuda(_zeros(4, 128), 4, 2, 4, "hbm", False)
    with pytest.raises(ValueError, match="src must be one of"):
        pdma.dma_cuda(_on_card(4, 128).long(), 4, 2, 4, "hbm", False)


@pytest.mark.parametrize("form", list(_DMA_FORMS))
@pytest.mark.parametrize("src", pdma.SRCS)
def test_c8_launch_on_pointers_read_once(form, src, fake_launch,
                                         monkeypatch):
    """C8's wrappers launch on the table's pointer and device index read
    once by their one check pass (`device` never), and on one buffer read
    once: the stage at its start, then `smem` mode's scratch ([T, 1024]
    words, none in the other modes), out, rounds, each returned as a view
    at its place; the stream of that index (of index 1 on the second
    card); the count rises by one a launch.  The serial form's rounds are
    zeroed (its warps add to them); the grid form's are not touched."""
    from collections import Counter
    monkeypatch.setattr(_Counted, "reads", Counter())
    wrapper, count = _DMA_FORMS[form]
    n, t = 5, 3
    tab = _zeros(_DMA_NROW, 128).as_subclass(_Counted)
    before = getattr(pdma, count)
    out, stage, rounds = wrapper(tab, n, t, _DMA_NROW, src, True)
    reads = dict(_Counted.reads)
    assert reads.pop(("data_ptr", id(tab))) == 1
    assert reads.pop(("get_device", id(tab))) == 1
    assert [k for k, _ in reads] == ["data_ptr"] and sum(
        reads.values()) == 1                  # the buffer's, once
    call = fake_launch.calls[-1]
    assert call[:6] == (tab.data_ptr(), _DMA_NROW, n, t,
                        pdma.SRCS.index(src), 1)
    words = 2 * n * 128
    scratch = t * pdma.VEC if src == "smem" else 0
    base = stage.data_ptr()
    assert call[6:] == (base + 4 * words, out.data_ptr(), base,
                        rounds.data_ptr(), 1000)
    assert out.data_ptr() == base + 4 * (words + scratch)
    assert rounds.data_ptr() == out.data_ptr() + 4
    assert (tuple(out.shape), tuple(stage.shape), tuple(rounds.shape)) == (
        (1, 1), (2 * n, 128), (t,))
    assert stage.is_contiguous() and stage.dtype == torch.int32
    if form == "serial":
        assert not rounds.any()
    assert getattr(pdma, count) == before + 1
    wrapper(_zeros(_DMA_NROW, 128).as_subclass(_OnCard1), n, t, _DMA_NROW,
            src, False)
    assert fake_launch.calls[-1][-1] == 1001
    out, stage, rounds = wrapper(_on_card(_DMA_NROW, 128), n, 0, _DMA_NROW,
                                 src, False)
    assert fake_launch.calls[-1][3] == 0 and rounds.shape == (0,)
    assert getattr(pdma, count) == before + 3


def test_c8_count_exact_under_threads(fake_launch):
    """Eight threads launching C8's grid form together: the count rises by
    exactly the launches made."""
    tab = _on_card(_DMA_NROW, 128)
    before = pdma.launches
    made = _launch_from_threads(
        lambda: pdma.dma_cuda(tab, 4, 2, _DMA_NROW, "reg", False))
    assert pdma.launches - before == made == len(fake_launch.calls)


# C11's input by form
_EMPTY_X = {"good": lambda: _on_card(8, 128),
            "zero_d": lambda: _on_card(),
            "three_d": lambda: _on_card(2, 3, 8),
            "empty": lambda: _on_card(0, 128),
            "cpu": lambda: _zeros(8, 128),
            "int64": lambda: _on_card(8, 128).long(),
            "transposed": lambda: _on_card(128, 8).t(),
            "column": lambda: _on_card(8, 132)[:, 4:],
            "misaligned": lambda: _misaligned(8, 128)}
_EMPTY_MSG = {"cpu": "the kernel needs CUDA tensors, got cpu",
              "int64": "x: dtype torch.int64, expected torch.int32",
              "transposed": "x: not contiguous",
              "column": "x: not contiguous",
              "misaligned": "x: not 16-byte aligned"}


@pytest.mark.parametrize("x_form", list(_EMPTY_X))
def test_c11_refuses_as_one_at_a_time(x_form, monkeypatch):
    """C11's one check pass refuses what its `cuda_input` refused, with the
    same message, before anything is built or launched (its count
    unchanged); it takes every shape that took, 0-d and empty included,
    and an empty x gives an empty output without asking for the
    library."""
    _no_build(monkeypatch)
    x = _EMPTY_X[x_form]()
    try:
        common.cuda_input(x, "x", x.dim())
        want = None
    except ValueError as err:
        want = str(err)
    assert want == _EMPTY_MSG.get(x_form)
    before = pp2.launches_empty
    if want is not None:
        with pytest.raises(ValueError) as err:
            pp2.empty_cuda(x)
        assert str(err.value) == want
    elif x.numel():
        with pytest.raises(AssertionError, match="library was asked"):
            pp2.empty_cuda(x)
    else:
        out = pp2.empty_cuda(x)
        assert out.shape == x.shape and out.dtype == torch.int32
    assert pp2.launches_empty == before


def test_c11_launch_on_pointers_read_once(fake_launch, monkeypatch):
    """C11 launches on x's pointer and device index read once by its one
    check pass (`device` never), the output's pointer read once, x's
    word count and the stream of that index; an output of x's shape, 0-d
    too; no launch and no count on an empty x."""
    from collections import Counter
    monkeypatch.setattr(_Counted, "reads", Counter())
    x = _zeros(*pp2.EMPTY_SHAPE).as_subclass(_Counted)
    before = pp2.launches_empty
    out = pp2.empty_cuda(x)
    assert _Counted.reads == Counter(
        {(k, id(x)): 1 for k in ("data_ptr", "get_device")}
        | {("data_ptr", id(out)): 1})
    assert fake_launch.calls[-1] == (x.data_ptr(), 1024, out.data_ptr(),
                                     1000)
    assert out.shape == x.shape and out.dtype == torch.int32
    assert out.is_contiguous()
    scalar = pp2.empty_cuda(_zeros().as_subclass(_OnCard1))
    assert scalar.shape == () and fake_launch.calls[-1][1:] == (
        1, scalar.data_ptr(), 1001)
    calls = len(fake_launch.calls)
    assert pp2.empty_cuda(_on_card(0, 128)).shape == (0, 128)
    assert len(fake_launch.calls) == calls
    assert pp2.launches_empty == before + 2


def _p5_input(rng, case):
    """int32 [256, 128] for `case`: "negative", s[0, 0] = -5 and the rest
    within 8 of both int32 ends; "wraps", every value within 8 of
    INT32_MAX and s[0, 0] = INT32_MAX - 2, so that s[0, 0] wraps in its
    first rounds and its trip counts follow the wrapped value."""
    x = I32_MAX - rng.integers(0, 8, p3.P5_X)
    if case == "negative":
        x[1::2] = I32_MIN + rng.integers(0, 8, x[1::2].shape)
        x[0, 0] = -5
    else:
        x[0, 0] = I32_MAX - 2
    return x.astype(np.int32)


# C34's grid form on the host: the script's inputs, and shapes the script
# does not run (only the plain version holds those)
_P5_SHAPES = {"wide": (512, 128), "ragged": (129, 127)}


@pytest.mark.parametrize("case", ["script", "negative", "wraps", "wide",
                                  "ragged"])
def test_host_p5_grid_form_matches_plain(script, monkeypatch, capsys, host,
                                         case):
    """C34's grid form played thread by thread on the host (`p5_words`,
    each thread its 4 words, zeros past the end, and its own copy of
    s[0, 0]) equals the plain version and the script (interpret mode) at
    the script's input, a negative s[0, 0] and an s[0, 0] that wraps;
    and the plain version at [512, 128] (past the witness's shared
    memory) and at [129, 127], 16,383 words (not a multiple of 4)."""
    rng = np.random.default_rng(1321)
    want_jax = None
    if case in _P5_SHAPES:
        x = rng.integers(I32_MIN, I32_MAX, _P5_SHAPES[case], endpoint=True)
        x.reshape(-1)[:len(EDGES)] = EDGES
        x = x.astype(np.int32)
    else:
        (call,), _ = _load(script, monkeypatch, capsys, 1321, "p5")
        x, = call["args"]
        want_jax = call["r"]
        if case != "script":
            x = _p5_input(rng, case)
            want_jax = _run(call, x)
    fn = host.nabwa_host_probe_p5_words
    fn.argtypes = [_P, _I, _I, _P]
    fn.restype = _I
    out = np.full_like(x, 7)
    assert fn(x.ctypes.data_as(_P), x.size, p3.P5_ROUNDS,
              out.ctypes.data_as(_P)) == 0
    want = p3.p5_plain(*common.tensors(CPU, x)).numpy()
    np.testing.assert_array_equal(out, want)
    if want_jax is not None:
        np.testing.assert_array_equal(out, want_jax)
    if case == "ragged":
        assert x.size % 4 == 3


# C23's and C34's wrappers, both forms of each: the call on x, the module
# and name of its launch counter
_SPILL_T = 5
_FORMS = {
    "c23_lane": (lambda x, k=ps.DEFAULT_K, lanes=None:
                 ps.spill_cuda(x, k, _SPILL_T, lanes), ps, "launches"),
    "c23_witness": (lambda x, k=ps.DEFAULT_K, lanes=None:
                    ps.spill_witness_cuda(x, k, _SPILL_T), ps,
                    "launches_witness"),
    "c34_grid": (lambda x, k=None, lanes=None: p3.p5_cuda(x), p3,
                 "launches_p5"),
    "c34_witness": (lambda x, k=None, lanes=None: p3.p5_witness_cuda(x), p3,
                    "launches_p5_witness")}
# x by form ([64, 128] when good)
_FORM_X = {"good": lambda: _on_card(64, 128),
           "cpu": lambda: _zeros(64, 128),
           "int64": lambda: _on_card(64, 128).long(),
           "dims": lambda: _on_card(64 * 128),
           "transposed": lambda: _on_card(128, 64).t(),
           "column": lambda: _on_card(64, 132)[:, 4:],
           "misaligned": lambda: _misaligned(64, 128),
           "wide": lambda: _on_card(512, 128)}
# C23's (K, lanes) by form; C34 takes none
_FORM_ARGS = {"good": (ps.DEFAULT_K, None), "k": (25, None),
              "lanes": (ps.DEFAULT_K, 3), "k_lanes": (25, 3)}


def _form_refusal(form, x, k, lanes):
    """The message of the first check one at a time that refuses x, K or
    the group (None if all pass): `common.cuda_input` on x (C23 any dims,
    C34 two), then C23's K, then the lane form's group, or the witness's
    shared memory for C34's."""
    try:
        common.cuda_input(x, "x", x.dim() if form.startswith("c23") else 2)
    except ValueError as err:
        return str(err)
    if form.startswith("c23") and k not in ps.SPILL_KS:
        return (f"K={k} is not one of the K kernel C23 is built for: "
                + ", ".join(map(str, ps.SPILL_KS)))
    if form == "c23_lane" and lanes == 3:
        return (f"C23's lane form is not built for K={k} over 3 lanes: L "
                f"one of {ps.LANES} dividing K, K / L one of "
                f"{ps.SPILL_MS}")
    if form == "c34_witness" and x.numel() > p3.P5_MAX_WORDS:
        return (f"x must fit one block's shared memory, {p3.P5_MAX_WORDS} "
                f"words, got {x.numel()}")
    return None


@pytest.mark.parametrize("form, x_form, args", [
    (form, x_form, args) for form in _FORMS for x_form in _FORM_X
    for args in (_FORM_ARGS if form.startswith("c23") else ["good"])
    if form == "c23_lane" or "lanes" not in args])
def test_c23_c34_refuse_in_order(form, x_form, args, monkeypatch):
    """Both forms of C23 and C34 refuse what their checks one at a time
    refused, with the same message and in the same order: x (CUDA, dtype,
    dims for C34, contiguity, 16-byte alignment), then C23's K, then the
    lane form's group or C34's witness's shared memory (the grid form
    takes [512, 128]); before anything is built or launched, every count
    unchanged."""
    _no_build(monkeypatch)
    call, mod, count = _FORMS[form]
    x = _FORM_X[x_form]()
    k, lanes = _FORM_ARGS[args]
    want = _form_refusal(form, x, k, lanes)
    before = {name: getattr(m, name) for _, m, name in _FORMS.values()}
    if want is None:
        with pytest.raises(AssertionError, match="library was asked"):
            call(x, k, lanes)
    else:
        with pytest.raises(ValueError) as err:
            call(x, k, lanes)
        assert str(err.value) == want
    assert {name: getattr(m, name) for _, m, name in _FORMS.values()} == \
        before
    takes = (x_form == "good"
             or x_form == "wide" and form != "c34_witness"
             or x_form == "dims" and form.startswith("c23"))
    assert (want is None) == (takes and args == "good")


@pytest.mark.parametrize("form", list(_FORMS))
def test_c23_c34_launch_on_pointers_read_once(form, fake_launch,
                                              monkeypatch):
    """Both forms of C23 and C34 launch on x's pointer and device index
    read once by their one check pass (`device` never), the output's
    pointer read once, the stream of that index (of index 1 on the second
    card); the sizes x's, C23's K, group (`default_lanes`: 2 at [64, 128])
    and T (a negative T as 0); an output of x's shape; the count rises
    by one a launch."""
    from collections import Counter
    monkeypatch.setattr(_Counted, "reads", Counter())
    call, mod, count = _FORMS[form]
    x = _zeros(64, 128).as_subclass(_Counted)
    before = getattr(mod, count)
    out = call(x)
    assert _Counted.reads == Counter(
        {(k, id(x)): 1 for k in ("data_ptr", "get_device")}
        | {("data_ptr", id(out)): 1})
    n = 64 * 128
    args = {"c23_lane": (ps.DEFAULT_K, 2, _SPILL_T),
            "c23_witness": (ps.DEFAULT_K, _SPILL_T)}.get(form, ())
    assert fake_launch.calls[-1] == (x.data_ptr(), n, *args, out.data_ptr(),
                                     1000)
    assert out.shape == x.shape and out.dtype == torch.int32
    assert out.is_contiguous()
    one = _zeros(8, 128).as_subclass(_OnCard1)
    call(one)
    assert fake_launch.calls[-1][1] == 8 * 128
    assert fake_launch.calls[-1][-1] == 1001
    if form == "c23_lane":
        assert fake_launch.calls[-1][2:4] == (ps.DEFAULT_K, 8)
        ps.spill_cuda(_on_card(64, 128), 64, -3, 2)
        assert fake_launch.calls[-1][2:5] == (64, 2, 0)
    if form == "c23_witness":
        ps.spill_witness_cuda(_on_card(64, 128), 320, -3)
        assert fake_launch.calls[-1][2:4] == (320, 0)
    assert getattr(mod, count) == before + 2 + form.startswith("c23")


@pytest.mark.parametrize("form", list(_FORMS))
def test_c23_c34_empty_launch_nothing(form, fake_launch):
    """No words: an empty output of x's shape, no launch, no count."""
    call, mod, count = _FORMS[form]
    before = getattr(mod, count)
    assert call(_on_card(0, 128)).shape == (0, 128)
    assert not fake_launch.calls
    assert getattr(mod, count) == before


@pytest.mark.parametrize("form", list(_FORMS))
def test_c23_c34_count_exact_under_threads(form, fake_launch):
    """Four threads launching one form together, the interpreter switching
    threads every microsecond: its count rises by exactly the launches
    made."""
    call, mod, count = _FORMS[form]
    x = _on_card(64, 128)
    before = getattr(mod, count)
    made = _launch_from_threads(lambda: call(x), threads=4)
    assert getattr(mod, count) - before == made == len(fake_launch.calls)
