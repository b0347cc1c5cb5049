"""The probe ports (`nabwa_tpu_torch.probes`) against the JAX probes under
`scripts/`, run in Pallas interpret mode on the CPU.

Each plain version must equal the JAX probe's output exactly on the same
numpy inputs: probe 1 (`probe_rowload`) and probe 5 (`probe_dfs_shape`)
of scripts/probe_pallas.py at their only shapes, scripts/probe_dma.py's
`make` over every `src` x `unroll` at N=8, T=3, ROWS=1000 (and the whole
stage and each round's witness against a numpy model of the copies,
since `out` cannot tell the modes apart), scripts/probe_dfs_shape.py at
two shapes.  The kernels' `__host__ __device__` helpers (csrc/probes.cuh),
built for the host with g++ (csrc/host_harness.cpp), must equal the plain
versions' formulas value by value on random and edge inputs.  The entry
points run with `--device cpu` and print their scripts' lines, and exit
non-zero without a card.

The scripts are loaded as the JAX package's tests would run them here:
`pl.pallas_call` wrapped with interpret=True for the test only, `sys.argv`
and `np.random` set before loading, the inputs and results captured by
replacing probe_pallas.py's `timeit` or read from the module's globals,
and probe_dma.py's import-time change of the JAX compilation cache
directory (to a fixed path outside the checkout) ignored.
"""

import ctypes
import functools
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nabwa_tpu_torch.probes import common
from nabwa_tpu_torch.probes import probe_dfs_shape as pds
from nabwa_tpu_torch.probes import probe_dma as pdma
from nabwa_tpu_torch.probes import probe_pallas as pp

from .test_torch_host_kernels import build as build_host

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
_P = ctypes.c_void_p
_I = ctypes.c_int


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (see tests/test_torch_extend.py):
    the plain versions are loops of small tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def script(monkeypatch):
    """Load scripts/<name>.py in interpret mode with argv; returns the
    module."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    real_update = jax.config.update

    def update(name, value):
        if name != "jax_compilation_cache_dir":
            real_update(name, value)
    monkeypatch.setattr(jax.config, "update", update)

    def load(name, argv=()):
        path = REPO / "scripts" / f"{name}.py"
        monkeypatch.setattr(sys, "argv", [str(path), *argv])
        spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return load


def _captured(mod, monkeypatch):
    """Replace probe_pallas.py's timeit by one call that records the
    inputs and the result."""
    seen = {}

    def timeit(f, *args, n=20):
        r = f(*args)
        seen["args"] = [np.asarray(a) for a in args]
        seen["r"] = np.asarray(r)
        return 0.0, r
    monkeypatch.setattr(mod, "timeit", timeit)
    return seen


def test_rowload_matches_jax(script, monkeypatch):
    np.random.seed(701)
    mod = script("probe_pallas")
    seen = _captured(mod, monkeypatch)
    mod.probe_rowload()
    idx, table = seen["args"]
    assert idx.shape == (256, 1) and table.shape == (4096, 128)
    got = pp.rowload(*common.tensors(CPU, idx, table))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), seen["r"])


def test_dfs_shape_pallas_matches_jax(script, monkeypatch):
    np.random.seed(705)
    mod = script("probe_pallas")
    seen = _captured(mod, monkeypatch)
    mod.probe_dfs_shape()
    k, table = seen["args"]
    assert k.shape == (256, 128) and table.shape == (32768, 128)
    got = pp.dfs_shape(*common.tensors(CPU, k, table))
    assert got.shape == (1, 1) and got.dtype == torch.int32
    assert int(got[0, 0]) == int(seen["r"][0, 0])


def _int32(v):
    v &= 0xFFFFFFFF
    return v - ((v >> 31) << 32)


def _numpy_copies(n, t, n_rows, src):
    """A model of probe_dma.py's copies in Python ints: (out, stage of 2N
    rows, each round's sum of the words it copied) on np.arange's
    table."""
    tab = np.arange(n_rows * 128, dtype=np.int64).reshape(n_rows, 128)
    stage = np.zeros((2 * n, 128), dtype=np.int64)
    rounds = []
    s = 1
    for it in range(t):
        copied = 0
        for i in range(n):
            if src == "reg":
                s = ((s * 1103515245 + 12345) & 0xFFFFFFFF) & 0x7FFFFFFF
                r = s % n_rows
            else:
                v = ((i % 128) * 12345 + it * 1103515245) & 0xFFFFFFFF
                v -= (v >> 31) << 32               # as int32
                r = v % n_rows                     # floor modulo
            stage[i] = tab[r]
            copied += int(tab[r].sum())
            if src == "cond":
                stage[(i + n) % (2 * n)] = tab[r % n_rows]
                copied += int(tab[r % n_rows].sum())
        rounds.append(_int32(copied))
    return _int32(s + int(stage[0, 0])), stage, rounds


@pytest.mark.parametrize("unroll", [True, False])
@pytest.mark.parametrize("src", pdma.SRCS)
def test_dma_matches_jax(script, src, unroll):
    n, t, rows = 8, 3, 1000
    mod = script("probe_dma")
    tab = np.arange(rows * 128, dtype=np.int32).reshape(rows, 128)
    want = np.asarray(jax.jit(mod.make(n, t, rows, unroll, src))(tab))
    out, stage, rounds = pdma.make(n, t, rows, unroll, src)(
        *common.tensors(CPU, tab))
    assert out.shape == (1, 1) and out.dtype == torch.int32
    assert int(out[0, 0]) == int(want[0, 0])
    m_out, m_stage, m_rounds = _numpy_copies(n, t, rows, src)
    assert int(out[0, 0]) == m_out
    np.testing.assert_array_equal(stage.numpy(), m_stage)
    assert rounds.dtype == torch.int32 and rounds.tolist() == m_rounds
    assert len(set(m_rounds)) == t            # every round copied anew
    if src == "cond":
        assert stage[n:].any()
    else:
        assert not stage[n:].any()


@pytest.mark.parametrize("bb,s,iters", [(256, 128, 200), (16, 64, 5)])
def test_dfs_shape_matches_jax(script, bb, s, iters):
    np.random.seed(19 + bb)
    mod = script("probe_dfs_shape", [str(bb), str(s), str(iters)])
    seed, table = np.asarray(mod.seed), np.asarray(mod.table)
    assert seed.shape == (bb, max(s, 128)) and table.shape == (4096, 128)
    got = pds.run(*common.tensors(CPU, seed, table), s, iters)
    assert got.shape == (1, 1) and got.dtype == torch.int32
    assert int(got[0, 0]) == int(np.asarray(mod.r)[0, 0])


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build_host(tmp_path_factory.mktemp("host_probes"))


I32_EDGES = [0, 1, -1, 2, -2, 7, 12345, 2**30, -2**30, 2**31 - 1,
             -2**31, -2**31 + 1, 1103515245, -1103515245]


def _i32(rng, n, edges=I32_EDGES, lo=-2**31, hi=2**31):
    """n int32 values: the edges first, then uniform in [lo, hi)."""
    v = np.array(edges, dtype=np.int64)
    v = np.concatenate([v, rng.integers(lo, hi, n - len(v))])
    return np.ascontiguousarray(v.astype(np.int32))


def _call(fn, outs, *args):
    """fn(*int32 arrays, n, *out arrays) -> the out arrays as int64."""
    n = len(args[0])
    res = [np.empty(n, dtype=np.int32) for _ in range(outs)]
    fn.argtypes = [_P] * len(args) + [_I] + [_P] * outs
    fn.restype = _I
    assert fn(*[a.ctypes.data_as(_P) for a in args], n,
              *[r.ctypes.data_as(_P) for r in res]) == 0
    return [r.astype(np.int64) for r in res]


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def _check_binop(host, rng, op):
    a, b = _i32(rng, 4000), _i32(rng, 4000)[::-1].copy()
    if op == 3:
        b = _i32(rng, 4000, [1, 2, 7, 1000, 100_000, 4_000_000, 2**31 - 1],
                 1, 2**31)
    fn = host.nabwa_host_probe_binop
    fn.argtypes = [_I, _P, _P, _I, _P]
    fn.restype = _I
    out = np.empty(len(a), dtype=np.int32)
    assert fn(op, a.ctypes.data_as(_P), b.ctypes.data_as(_P), len(a),
              out.ctypes.data_as(_P)) == 0
    want = [lambda x, y: common.wrap32(x + y),
            lambda x, y: common.wrap32(x - y),
            lambda x, y: common.wrap32(x * y),
            common.floor_mod][op](_t(a), _t(b))
    return out.astype(np.int64), want


def _check_lcg(host, rng):
    s = _i32(rng, 4000, [0, 1, 2**31 - 1, 12345, 1103515245], 0, 2**31)
    got, = _call(host.nabwa_host_probe_lcg_next, 1, s)
    return got, pdma.lcg_next(_t(s))


def _check_vec_row(host, rng):
    n = 4000
    c = rng.integers(0, 128, n).astype(np.int32)
    t = _i32(rng, n, [0, 1, 2, 3, 63, 64, 2**31 - 1], 0, 2**31)
    rows = rng.choice([1, 7, 1000, 100_000, 4_000_000, 2**31 - 1],
                      n).astype(np.int32)
    got, = _call(host.nabwa_host_probe_dma_vec_row, 1, c, t, rows)
    return got, pdma.vec_value(_t(c), _t(t), _t(rows))


def _check_word_count(host, rng):
    # staged rows whose block offset (word 0's low 3 bits) and word
    # offset (word 1's bits 4-6) take every value
    rows = rng.integers(-2**31, 2**31, (64, 128))
    rows[:, 0] = (rows[:, 0] & ~7) | np.arange(64) % 8
    rows[:, 1] = (rows[:, 1] & ~0x70) | ((np.arange(64) // 8) << 4)
    rows[::5, 4:] = -1
    rows[1::5, 4:] = -2**31
    rows = rows.astype(np.int32).astype(np.int64)
    w = np.broadcast_to(np.arange(128), rows.shape)
    args = [np.ascontiguousarray(a.reshape(-1), dtype=np.int32) for a in
            (rows, w, np.broadcast_to(rows[:, :1], rows.shape),
             np.broadcast_to(rows[:, 1:2], rows.shape))]
    got, = _call(host.nabwa_host_probe_shape_word_count, 1, *args)
    return got, pds.word_counts(_t(rows)).reshape(-1)


def _check_expand(host, rng):
    n = 4000
    e0, e1 = _i32(rng, n), _i32(rng, n)[::-1].copy()
    ck = _i32(rng, n, [0, 1, 128, 2**31 - 1, -2**31], -2**31, 2**31)
    cl = rng.integers(0, 1 << 12, n).astype(np.int32)
    a, b = _call(host.nabwa_host_probe_shape_expand, 2, e0, e1, ck, cl)
    pa, pb = pds.expand(*(_t(x) for x in (e0, e1, ck, cl)))
    return np.stack([a, b]), torch.stack([pa, pb])


def _check_pallas_counts(host, rng):
    x = _i32(rng, 4000, I32_EDGES + [0x55555555, -0x55555556, 0x33333333])
    c1, c3 = _call(host.nabwa_host_probe_pallas_word_counts, 2, x)
    p1, p3 = pp.bank_counts(_t(x))
    return np.stack([c1, c3]), torch.stack([p1, p3])


HOST_CHECKS = {
    "wadd": functools.partial(_check_binop, op=0),
    "wsub": functools.partial(_check_binop, op=1),
    "wmul": functools.partial(_check_binop, op=2),
    "floor_mod": functools.partial(_check_binop, op=3),
    "lcg_next": _check_lcg,
    "dma_vec_row": _check_vec_row,
    "shape_word_count": _check_word_count,
    "shape_expand": _check_expand,
    "pallas_word_counts": _check_pallas_counts,
}


@pytest.mark.parametrize("name", list(HOST_CHECKS))
def test_host_probe_helpers_match_plain(host, name):
    """Each helper of csrc/probes.cuh that kernels C8-C10 call, built for
    the host, equals the plain versions' formula on random and edge
    values."""
    rng = np.random.default_rng(sorted(HOST_CHECKS).index(name) + 720)
    got, want = HOST_CHECKS[name](host, rng)
    np.testing.assert_array_equal(got, want.numpy())


def test_wrap_and_floor_mod_edges():
    vals = [0, 1, -1, 2**31 - 1, -2**31, 2**31, 2**32 - 1, 2**32,
            -2**31 - 1, 3 * 2**32 + 5, 1103515245 * 63]
    want = np.array(vals, dtype=np.int64).astype(np.uint32).view(np.int32)
    for v, w in zip(vals, want):
        assert common.wrap32(v) == int(w), v
    t = torch.tensor(vals, dtype=torch.int64)
    np.testing.assert_array_equal(common.wrap32(t).numpy(), want)
    assert common.wsum(torch.tensor([2**31 - 1, 1])) == -2**31
    assert int(common.wsum(torch.full((3, 2), 2**30), dim=0)[0]) == -2**30
    # jnp's %, not C's: the result takes the divisor's sign
    x = torch.tensor([-7, -1, 0, 6, 7, -2**31, 2**31 - 1])
    np.testing.assert_array_equal(common.floor_mod(x, 7).numpy(),
                                  [0, 6, 0, 6, 0, 5, 1])
    assert common.floor_mod(-2087936806, 1000) == 194
    assert common.floor_mod(-2087936806, 1000) != int(
        torch.fmod(torch.tensor(-2087936806), 1000))


def test_popcount32_edges():
    vals = np.array([0, 1, -1, -2**31, 2**31 - 1, 0x55555555, -65536,
                     0x0F0F0F0F, 12345678, -12345678], dtype=np.int64)
    want = [bin(int(v) & 0xFFFFFFFF).count("1") for v in vals]
    got = common.popcount32(torch.from_numpy(vals))
    assert got.tolist() == want


RESULT_LINES = {
    "probe_pallas": [r"devices: \['cpu'\]",
                     r"probe1 rowload fori BB=256: [\d.]+us  ok=True",
                     r"probe5 dfs-shaped 100 iters BB=256 S=128: "
                     r"[\d.]+ms \([\d.]+us/iter\)"],
    "probe_dma": [rf"N=\s+{n} unroll={u} src={s:4s}  \s*[\d.]+ us/iter  "
                  r"\s*[\d.]+ us/copy"
                  for n in (64, 128) for u in (1, 0)
                  for s in ("reg", "vmem", "cond")],
    "probe_dfs_shape": [r"devices: \['cpu'\] BB=16 S=64 ITERS=5",
                        r"dfs-shaped 5 iters BB=16 S=64: [\d.]+ms total, "
                        r"[\d.]+us/iter, [\d.]+M lane-iters/s"],
}
ENTRY_ARGS = {"probe_pallas": [], "probe_dma": [],
              "probe_dfs_shape": ["16", "64", "5"]}


@pytest.mark.parametrize("name", list(RESULT_LINES))
def test_entry_point_cpu(name):
    env = dict(os.environ, ROWS="1000", T="3", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", f"nabwa_tpu_torch.probes.{name}", "--device",
         "cpu", *ENTRY_ARGS[name]], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert len(lines) == len(RESULT_LINES[name]), lines
    for line, pattern in zip(lines, RESULT_LINES[name]):
        assert re.fullmatch(pattern, line), (line, pattern)


@pytest.mark.parametrize("mod", [pp, pdma, pds])
def test_entry_point_needs_card(mod, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["--device", "cuda"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


def test_unported_probe_exits_nonzero(capsys):
    assert pp.main(["--device", "cpu", "1", "2"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "probe 2: not yet ported" in captured.err


@pytest.mark.parametrize("call", [
    lambda: pp.rowload_cuda(torch.zeros((4, 1), dtype=torch.int32),
                            torch.zeros((8, 128), dtype=torch.int32)),
    lambda: pp.dfs_shape_cuda(torch.zeros((4, 128), dtype=torch.int32),
                              torch.zeros((8, 128), dtype=torch.int32)),
    lambda: pdma.dma_cuda(torch.zeros((8, 128), dtype=torch.int32), 4, 1, 8,
                          "reg", False),
    lambda: pds.run_cuda(torch.zeros((4, 128), dtype=torch.int32),
                         torch.zeros((8, 128), dtype=torch.int32), 128, 1)])
def test_kernels_refuse_cpu_tensors(call):
    """A kernel wrapper given CPU tensors raises; only the dispatchers run
    the plain versions, and only for CPU tensors."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
