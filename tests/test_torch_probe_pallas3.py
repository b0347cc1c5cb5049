"""Probes 7 and 8 of scripts/probe_pallas3.py (`nabwa_tpu_torch.probes.
probe_pallas3`) against the JAX script on the CPU.

The script is loaded in Pallas interpret mode with `np.random` seeded and
its `timeit` replaced by one call that records the jitted `run`, its
inputs and its result.  The plain versions must equal the script's kernel
exactly (int32): probe 7 at its four shapes and probe 8 on [256, 128], at
the script's inputs and, through the captured `run`, at seeded random
int32 with values within 8 of INT32_MAX and INT32_MIN (probe 7's v + i
wraps) and, for probe 8, scalars a near both ends and negative (v - a
wraps) and equal to plane values (the where's tie goes to v + i).
Kernels C25's and C26's steps, `p7_step` and `p8_step` of csrc/probes.cuh
built by g++, equal the plain steps value by value.  The entry point
prints the script's lines; probes 1, 1b and 2-6 exit non-zero as not yet
ported, an unknown name as no such probe; a missing card, CPU tensors,
misaligned inputs and a row width the kernel does not take are refused.
"""

import os
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


@pytest.mark.parametrize("name, check", [("p7_step", _check_p7_step),
                                         ("p8_step", _check_p8_step)])
def test_host_steps_match_plain(host, name, check):
    """csrc/probes.cuh `p7_step` (kernel C25) and `p8_step` (C26), built
    for the host, equal the plain steps value by value."""
    got, want = check(host, np.random.default_rng(1310 + len(name)))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("which", [["7", "8"], []])
def test_entry_point_cpu(which):
    """The port's lines are the script's, numbers aside (the script's own
    are held to P7_LINES and P8_LINES above); with no name the two ported
    probes run."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "nabwa_tpu_torch.probes.probe_pallas3",
         "--device", "cpu", *which], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[0] == "devices: ['cpu']"
    assert masked(lines[1:]) == P7_LINES + P8_LINES


@pytest.mark.parametrize("name", ["1", "1b", "2", "3", "4", "5", "6", "9",
                                  "p7"])
def test_other_probes_exit_nonzero(name, capsys):
    """The script's other probes are not ported yet, and a name it does
    not have is none; either exits non-zero before any probe runs."""
    assert p3.main(["--device", "cpu", "7", name]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    why = ("not yet ported to nabwa_tpu_torch" if name in p3.NOT_PORTED
           else "no such probe")
    assert f"probe {name}: {why}" in captured.err


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
    lambda: p3.p8_cuda(_zeros(256, 1), _zeros(256, 128))])
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
     r"a must be \[256, 1\]")])
def test_kernels_refuse_inputs(call, match):
    """A wrapper refuses what its kernel does not take, before any
    launch."""
    with pytest.raises(ValueError, match=match):
        call()
