"""The port of scripts/probe_pallas2.py (`nabwa_tpu_torch.probes.
probe_pallas2`) against the JAX script on the CPU.

Each plain version must equal the JAX probe's output exactly on the same
numpy inputs.  Probes A (`probe_empty`), B1 and BU (`probe_loads`, all
2 BB rows, where the script checks BB) and E (`probe_lanereduce`) run in
Pallas interpret mode, at the script's inputs and, through the script's
own captured `run`, at edge inputs that pin the int32 wrap-around.
Probe F (`probe_pop`) does not trace in interpret mode on this JAX (the
kernel captures a constant), so its kernel body runs eagerly under
`jax.disable_jit()`, through `Ref`s that hold arrays; the plain version
must equal that route and a numpy model of the pop on the output, the
whole final key state and each round's minimum, at the script's inputs,
at forced ties and where the sum of the tied slots wraps.  The kernels'
new `__host__ __device__` helper (csrc/probes.cuh), built for the host
with g++, must equal the plain formula value by value.  The entry point
runs with `--device cpu` and prints the script's lines; the script's
unported probes and a missing card exit non-zero.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nabwa_tpu_torch.probes import common
from nabwa_tpu_torch.probes import probe_pallas2 as pp2

# fixtures and helpers shared with the other probe ports' tests: the script
# loader (interpret mode), one torch thread, the host harness
from .test_torch_probes import (_call, _i32, _t, host,  # noqa: F401
                                one_torch_thread, script)

REPO = pp2.__file__.rsplit("/nabwa_tpu_torch/", 1)[0]
CPU = torch.device("cpu")
I32_MAX, I32_MIN = 2**31 - 1, -2**31


def _capture(mod, monkeypatch):
    """Replace the script's timeit by one call that records the jitted
    function, its inputs and its result."""
    seen = {}

    def timeit(f, *args, n=20):
        r = f(*args)
        seen.update(run=f, args=[np.asarray(a) for a in args],
                    r=np.asarray(r))
        return 0.0, r
    monkeypatch.setattr(mod, "timeit", timeit)
    return seen


def _load(script, monkeypatch, seed):
    np.random.seed(seed)
    mod = script("probe_pallas2")
    return mod, _capture(mod, monkeypatch)


def _i32_array(v):
    return np.asarray(v, dtype=np.int64).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("case", ["script", "edges"])
def test_empty_matches_jax(script, monkeypatch, case):
    mod, seen = _load(script, monkeypatch, 811)
    mod.probe_empty()
    x, = seen["args"]
    assert x.shape == (8, 128) and x.dtype == np.int32
    want = seen["r"]
    if case == "edges":
        x = _i32_array(np.resize([I32_MAX, I32_MIN, -1, 0, 1, I32_MAX - 1,
                                  I32_MIN + 1, 12345], 1024)
                       ).reshape(8, 128)
        want = np.asarray(seen["run"](jnp.asarray(x)))
        assert (want[x == I32_MAX] == I32_MIN).all()      # wraps
    got = pp2.empty(*common.tensors(CPU, x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("unroll", [1, pp2.LOADS_UNROLL])
def test_loads_matches_jax(script, monkeypatch, unroll):
    mod, seen = _load(script, monkeypatch, 812)
    mod.probe_loads(unroll)
    assert "r" in seen, "the script's probe B failed"
    idx, table = seen["args"]
    assert idx.shape == (pp2.BB, 128) and table.shape == (pp2.NROW, 128)
    got = pp2.loads(*common.tensors(CPU, idx, table), unroll)
    assert got.shape == (2 * pp2.BB, 128) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), seen["r"])
    np.testing.assert_array_equal(got.numpy()[pp2.BB:], table[idx[:, 1]])


@pytest.mark.parametrize("case", ["script", "wrap"])
def test_lanereduce_matches_jax(script, monkeypatch, case):
    mod, seen = _load(script, monkeypatch, 815)
    mod.probe_lanereduce()
    x, = seen["args"]
    assert x.shape == (512, 128)
    want = seen["r"]
    if case == "wrap":
        rng = np.random.default_rng(815)
        x = np.where(rng.random((512, 128)) < 0.5,
                     rng.integers(I32_MAX - 1000, I32_MAX, (512, 128),
                                  endpoint=True),
                     rng.integers(I32_MIN, I32_MIN + 1000, (512, 128),
                                  endpoint=True)).astype(np.int32)
        x[0] = I32_MAX
        x[1] = I32_MIN
        want = np.asarray(seen["run"](jnp.asarray(x)))
        assert (want[:, 0] != x.astype(np.int64).sum(1)).any()
    got = pp2.lanereduce(*common.tensors(CPU, x))
    assert got.shape == (512, 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


class _Ref:
    """A Pallas ref over a JAX array, for running a kernel body eagerly;
    keeps the array after every store."""

    def __init__(self, a):
        self.a = a
        self.history = []

    def __getitem__(self, k):
        return self.a[k]

    def __setitem__(self, k, v):
        self.a = self.a.at[k].set(v)
        self.history.append(self.a)


def _eager_pallas_call(calls):
    """A stand-in for pl.pallas_call that runs the kernel body on `_Ref`s
    and records (inputs, outputs, scratch) of each call in `calls`."""
    def pallas_call(kernel, out_shape, scratch_shapes=(), **_):
        def run(*args):
            refs = ([_Ref(jnp.asarray(a)) for a in args],
                    [_Ref(jnp.zeros(out_shape.shape, out_shape.dtype))],
                    [_Ref(jnp.zeros(s.shape, s.dtype))
                     for s in scratch_shapes])
            kernel(*refs[0], *refs[1], *refs[2])
            calls.append(refs)
            return refs[1][0].a
        return run
    return pallas_call


def _wrap(v):
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


def _numpy_pop(x, iters=pp2.POP_ITERS):
    """scripts/probe_pallas2.py:189-198 in numpy int64: (out, the final
    key, each round's minimum, whether any round's sum wrapped)."""
    key = x.astype(np.int64)
    f = key ^ 21
    mks, wrapped = [], False
    for _ in range(iters):
        mk = key.min(axis=1)
        pm = key == mk[:, None]
        raw = np.where(pm, f, 0).sum(axis=1)
        e1 = _wrap(raw)
        wrapped |= bool((e1 != raw).any())
        key = np.where(pm, 0x7FFFFFFF, key)
        key[:, 0] = np.minimum(key[:, 0], e1)
        mks.append(mk)
    return key[:, :128], key, np.stack(mks), wrapped


def _pop_input(case):
    rng = np.random.default_rng(816)
    shape = (pp2.BB, pp2.POP_S)
    if case == "ties":
        return rng.integers(0, 8, shape).astype(np.int32)
    # a few values near each end: many ties, whose f sum past int32
    return np.where(rng.random(shape) < 0.5,
                    I32_MAX - rng.integers(0, 8, shape),
                    I32_MIN + rng.integers(0, 8, shape)).astype(np.int32)


@pytest.mark.parametrize("case", ["script", "ties", "wrap"])
def test_pop_matches_jax(script, monkeypatch, case):
    mod, seen = _load(script, monkeypatch, 817)
    calls = []
    monkeypatch.setattr(pl, "pallas_call", _eager_pallas_call(calls))
    with jax.disable_jit():
        mod.probe_pop()
        assert "r" in seen, "the script's probe F failed"
        x, = seen["args"]
        want = seen["r"]
        if case != "script":
            x = _pop_input(case)
            want = np.asarray(seen["run"](jnp.asarray(x)))
    assert x.shape == (pp2.BB, pp2.POP_S)
    key_ref = calls[-1][2][0]
    # the stores to key: x, then two a round; a round starts after its
    # predecessor's second
    starts = key_ref.history[0:-1:2]
    assert len(starts) == pp2.POP_ITERS
    jax_mk = np.stack([np.asarray(h).min(axis=1) for h in starts])
    jax_state = np.asarray(key_ref.a)

    out, state, witness = pp2.pop(*common.tensors(CPU, x))
    assert out.shape == (pp2.BB, 128) and out.dtype == torch.int32
    assert state.shape == x.shape and state.dtype == torch.int32
    assert witness.shape == (pp2.POP_ITERS, pp2.BB)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(state.numpy(), jax_state)
    np.testing.assert_array_equal(witness.numpy(), jax_mk)

    m_out, m_state, m_mk, wrapped = _numpy_pop(x)
    np.testing.assert_array_equal(out.numpy(), m_out)
    np.testing.assert_array_equal(state.numpy(), m_state)
    np.testing.assert_array_equal(witness.numpy(), m_mk)
    assert wrapped == (case == "wrap")
    # slots 128-255 and later rounds hold what `out` cannot show
    assert (state.numpy()[:, 128:] != x[:, 128:]).any()


def test_host_pop_take_matches_plain(host):
    """csrc/probes.cuh `pop_take`, which kernel C13 runs on each slot,
    built for the host, equals the plain version's formula value by
    value: the new key, and what the slot adds to the row's sum."""
    rng = np.random.default_rng(818)
    n = 4000
    key = _i32(rng, n)
    f = _i32(rng, n)[::-1].copy()
    mk = np.where(rng.random(n) < 0.5, key, _i32(rng, n)).astype(np.int32)
    mk[:8] = key[:8]                                    # edges taken too
    got_key, got_e1 = _call(host.nabwa_host_probe_pop_take, 2, key, f, mk)
    pm = _t(key) == _t(mk)
    np.testing.assert_array_equal(
        got_key, torch.where(pm, common.FREE_KEY, _t(key)).numpy())
    np.testing.assert_array_equal(got_e1, torch.where(pm, _t(f), 0).numpy())


RESULT_LINES = [
    r"devices: \['cpu'\]",
    r"probeA empty kernel: [\d.]+us",
    r"probeB 2x256 rowloads unroll=1: [\d.]+us \(\d+ns/load\)  ok=True",
    r"probeB 2x256 rowloads unroll=256: [\d.]+us \(\d+ns/load\)  ok=True",
    r"probeE \[512,128\] lane-sum: [\d.]+us ok=True",
    r"probeF pop-shape 50 iters S=256: [\d.]+ms \([\d.]+us/iter\)"]


def test_entry_point_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "nabwa_tpu_torch.probes.probe_pallas2",
         "--device", "cpu", "A", "B1", "BU", "E", "F"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert len(lines) == len(RESULT_LINES), lines
    for line, pattern in zip(lines, RESULT_LINES):
        assert re.fullmatch(pattern, line), (line, pattern)


@pytest.mark.parametrize("probe", pp2.NOT_PORTED)
def test_unported_probe_exits_nonzero(capsys, probe):
    assert pp2.main(["--device", "cpu", "A", probe]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert f"probe {probe}: not yet ported" in captured.err


def test_entry_point_needs_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pp2.main(["--device", "cuda"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("call", [
    lambda: pp2.empty_cuda(_zeros(8, 128)),
    lambda: pp2.loads_cuda(_zeros(256, 128), _zeros(8, 128), 1),
    lambda: pp2.pop_cuda(_zeros(4, 256)),
    lambda: pp2.lanereduce_cuda(_zeros(4, 128))])
def test_kernels_refuse_cpu_tensors(call):
    """A kernel wrapper given CPU tensors raises; only the dispatchers run
    the plain versions, and only for CPU tensors."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
