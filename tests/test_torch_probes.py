"""The probe ports (`nabwa_tpu_torch.probes`) against the JAX probes under
`scripts/`, run in Pallas interpret mode on the CPU.

Each plain version must equal the JAX probe's output exactly on the same
numpy inputs: probe 1 (`probe_rowload`, also through the script's
captured jitted `run` at indices on both ends of the table and repeated)
and probe 5 (`probe_dfs_shape`) of scripts/probe_pallas.py at their only
shapes, scripts/probe_dma.py's
`make` over every `src` x `unroll` at N=8, T=3, ROWS=1000 and over every
`src` at N=130, T=2 (and the whole stage and each round's witness against
a numpy model of the copies, since `out` cannot tell the modes apart),
scripts/probe_dfs_shape.py at two shapes.  `reg` mode's rows come from the
LCG's jump-ahead, held to the script's loop of steps.  The kernels'
`__host__ __device__` helpers (csrc/probes.cuh), built for the host with
g++ (csrc/host_harness.cpp), must equal the plain versions' formulas value
by value on random and edge inputs (`lcg_jump` also k steps of the LCG,
stepped or in closed form).  The entry points run with `--device cpu` and
print their scripts' lines (probe_dma's also the serial form's), and exit
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
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nabwa_tpu_torch.ops import _build
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
    jitted function, the inputs and the result."""
    seen = {}

    def timeit(f, *args, n=20):
        r = f(*args)
        seen["run"] = f
        seen["args"] = [np.asarray(a) for a in args]
        seen["r"] = np.asarray(r)
        return 0.0, r
    monkeypatch.setattr(mod, "timeit", timeit)
    return seen


@pytest.mark.parametrize("case", ["script", "edges"])
def test_rowload_matches_jax(script, monkeypatch, case):
    """Probe 1 at the script's inputs and, through its captured jitted
    `run`, at indices on both ends of the table and repeated."""
    np.random.seed(701)
    mod = script("probe_pallas")
    seen = _captured(mod, monkeypatch)
    mod.probe_rowload()
    idx, table = seen["args"]
    assert idx.shape == (256, 1) and table.shape == (4096, 128)
    want = seen["r"]
    if case == "edges":
        idx = np.random.default_rng(701).integers(
            0, pp.ROWLOAD_NROW, idx.shape).astype(np.int32)
        idx[:4, 0] = (0, pp.ROWLOAD_NROW - 1, 0, pp.ROWLOAD_NROW - 1)
        idx[100:140, 0] = 7
        want = np.asarray(seen["run"](jnp.asarray(idx), jnp.asarray(table)))
    got = pp.rowload(*common.tensors(CPU, idx, table))
    assert got.shape == (pp.ROWLOAD_BB, 128) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[idx[:, 0]])


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


# (src, unroll, N, T): every mode and unroll at N 8, T 3, and every mode
# at N 130, T 2 (copies 128 and 129 read the vector's second row, i // 128)
DMA_CASES = [pytest.param(src, unroll, 8, 3, id=f"{src}-{unroll}")
             for src in pdma.SRCS for unroll in (True, False)] + [
    pytest.param(src, False, 130, 2, id=f"{src}-False-N130")
    for src in pdma.SRCS]


@pytest.mark.parametrize("src, unroll, n, t", DMA_CASES)
def test_dma_matches_jax(script, src, unroll, n, t):
    """`make` on 1,000 rows: out against the script's jitted `make`, the
    stage and each round's witness against `_numpy_copies`.  In `cond` the
    script's stage has max(N, 8) rows, and interpret mode clamps the
    copies past its end; they never touch row 0, and so not out."""
    rows = 1000
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


def _loop_rows(n, t, n_rows):
    """`reg` mode's rows as the script's loop makes them, one lcg_next a
    copy: (rows [T, N], the state after the last round)."""
    s, rows = 1, []
    for _ in range(t):
        it_rows = []
        for _ in range(n):
            s = pdma.lcg_next(s)
            it_rows.append(s % n_rows)
        rows.append(it_rows)
    return torch.tensor(rows, dtype=torch.int64).view(t, n), s


@pytest.mark.parametrize("n, t, n_rows", [(8, 3, 1000), (130, 2, 1000),
                                          (1, 0, 7), (219, 4, 1),
                                          (128, 64, 100_000)])
def test_copy_rows_by_jump(n, t, n_rows):
    """`copy_rows` builds `reg` mode's rows by the jump-ahead; they and
    the final state equal the script's loop of lcg_next."""
    rows, rows2, final = pdma.copy_rows(n, t, n_rows, "reg")
    want, want_final = _loop_rows(n, t, n_rows)
    assert rows2 is None and final == want_final
    assert rows.dtype == torch.int64 and torch.equal(rows, want)


def _lcg_steps(s, k):
    """k steps of the script's LCG from each seed of s (numpy int64)."""
    s = s.copy()
    for _ in range(k):
        s = ((s * 1103515245 + 12345) & 0xFFFFFFFF) & 0x7FFFFFFF
    return s


def _lcg_closed(s, k):
    """The LCG's state k steps after s in closed form: a^k s + c (a^k -
    1) / (a - 1) mod 2^31, the division exact modulo 2^31 (a - 1)."""
    a, c, m = 1103515245, 12345, 1 << 31
    if k == 0:
        return s
    geo = (pow(a, k, m * (a - 1)) - 1) // (a - 1)
    return (pow(a, k, m) * s + c * geo) % m


@pytest.mark.parametrize("k", [0, 1, 2, 127, 128, 8192, "random"])
def test_lcg_jump_matches_steps(host, k):
    """`lcg_jump` of csrc/probes.cuh (built by g++) and its plain twin
    equal k steps of lcg_next from random int32 seeds, 0, 2^31 - 1 and
    negative ones among them (k = 0 leaves a negative seed unmasked):
    stepped for the fixed k, in closed form for random k up to 2^31 (too
    many to step)."""
    rng = np.random.default_rng(731 if k == "random" else 732 + k)
    s = _i32(rng, 2000, [0, 1, 2**31 - 1, 12345, 1103515245, -1, -2**31])
    if k == "random":
        ks = rng.integers(0, 2**31, len(s))
        ks[:3] = (2**31 - 1, 2**31, 1)
        want = np.array([_lcg_closed(int(a), int(b)) for a, b in
                         zip(s, ks)], dtype=np.int64)
    else:
        ks = np.full(len(s), k, dtype=np.int64)
        want = _lcg_steps(s.astype(np.int64), k)
        assert [_lcg_closed(int(a), k) for a in s[:50]] == want[:50].tolist()
    fn = host.nabwa_host_probe_lcg_jump
    fn.argtypes = [_P, _P, _I, _P]
    fn.restype = _I
    got = np.empty(len(s), dtype=np.int32)
    ks = np.ascontiguousarray(ks, dtype=np.int64)
    assert fn(s.ctypes.data_as(_P), ks.ctypes.data_as(_P), len(s),
              got.ctypes.data_as(_P)) == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pdma.lcg_jump(_t(s), _t(ks)).numpy(),
                                  want)
    assert [pdma.lcg_jump(int(a), int(b)) for a, b in
            zip(s[:20], ks[:20])] == want[:20].tolist()


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


def test_host_block_counts_match_plain(host):
    """C9's lean count from the block's side (`shape_block_lane`,
    `shape_block_count`), built for the host: each of a row's 8 block
    words, read where the warp fetches it, counts what the plain version
    counts for that word, and the 8 sum to the row's count, at every
    block and word offset."""
    rng = np.random.default_rng(730)
    rows = rng.integers(-2**31, 2**31, (128, 128))
    rows[:, 0] = (rows[:, 0] & ~7) | np.arange(128) % 8
    rows[:, 1] = (rows[:, 1] & ~0x70) | ((np.arange(128) // 8 % 8) << 4)
    rows[64::5, 4:] = -1
    rows[65::5, 4:] = -2**31
    rows[66::5, 4:] = 0x55555555
    rows = rows.astype(np.int32).astype(np.int64)
    fn = host.nabwa_host_probe_shape_block_counts
    fn.argtypes = [_P, _I, _P]
    fn.restype = _I
    x = np.ascontiguousarray(rows.reshape(-1), dtype=np.int32)
    got = np.empty((len(rows), 8), dtype=np.int32)
    assert fn(x.ctypes.data_as(_P), len(rows), got.ctypes.data_as(_P)) == 0
    words = pds.word_counts(_t(rows)).numpy()
    blk = (rows[:, 0] & 7) * 16 + 4
    want = words[np.arange(len(rows))[:, None], blk[:, None] + np.arange(8)]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(axis=1), words.sum(axis=1))
    assert (want > 0).sum() > 256


def test_host_push_takes_the_rth_valid_candidate(host):
    """C9's lean push from the slots' side (`push_nth` read at lane
    `push_lane(rank)`), built for the host, for every 9-bit valid mask and
    every rank 1-128: the free slot of inclusive rank r takes candidate j
    where j is valid and the valid candidates before it number r - 1, as
    the plain version's pushes place them; 9 (none) when fewer than r
    are valid."""
    masks = np.arange(512, dtype=np.int32)
    ranks = np.arange(1, 129, dtype=np.int32)
    valid = np.ascontiguousarray(np.repeat(masks, len(ranks)))
    rank = np.ascontiguousarray(np.tile(ranks, len(masks)))
    got, = _call(host.nabwa_host_probe_push_take, 1, valid, rank)
    want = np.full((len(masks), len(ranks)), 9, dtype=np.int64)
    for m in masks.tolist():
        pref = 0
        for j in range(9):
            if (m >> j) & 1:
                want[m, pref] = j         # rank pref + 1
                pref += 1
    np.testing.assert_array_equal(got.reshape(want.shape), want)


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
                     r"probe2 smem-idx rowload BB=256: [\d.]+us  ok=True",
                     r"probe3 popcount: [\d.]+us  ok=True",
                     r"probe4 while\+scratch 50 iters: [\d.]+us  "
                     r"\([\d.]+us/iter\) r=-?\d+",
                     r"probe4b fori vector-only 50 iters: [\d.]+us  "
                     r"\([\d.]+us/iter\)",
                     r"probe4c 60-op body 50 iters: [\d.]+us  "
                     r"\([\d.]+us/iter\)",
                     r"probe5 dfs-shaped 100 iters BB=256 S=128: "
                     r"[\d.]+ms \([\d.]+us/iter\)"],
    "probe_dma": [rf"{f}N=\s+{n} unroll={u} src={s:4s}  \s*[\d.]+ us/iter  "
                  r"\s*[\d.]+ us/copy"
                  for f, n, u, s in [("", n, u, s) for n in (64, 128)
                                     for u in (1, 0)
                                     for s in ("reg", "vmem", "cond")]
                  + [("serial ", 128, 0, "reg")]],
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
    """A probe the script does not have exits non-zero before any runs."""
    assert pp.main(["--device", "cpu", "1", "4d"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "probe 4d: no such probe" in captured.err


@pytest.mark.parametrize("call", [
    lambda: pp.rowload_cuda(torch.zeros((4, 1), dtype=torch.int32),
                            torch.zeros((8, 128), dtype=torch.int32)),
    lambda: pp.dfs_shape_cuda(torch.zeros((4, 128), dtype=torch.int32),
                              torch.zeros((8, 128), dtype=torch.int32)),
    lambda: pdma.dma_cuda(torch.zeros((8, 128), dtype=torch.int32), 4, 1, 8,
                          "reg", False),
    lambda: pds.run_cuda(torch.zeros((4, 128), dtype=torch.int32),
                         torch.zeros((8, 128), dtype=torch.int32), 128, 1),
    lambda: pds.run_witness_cuda(torch.zeros((4, 128), dtype=torch.int32),
                                 torch.zeros((8, 128), dtype=torch.int32),
                                 128, 1),
    lambda: pds.run_stamped_cuda(torch.zeros((4, 128), dtype=torch.int32),
                                 torch.zeros((8, 128), dtype=torch.int32),
                                 128, 1, True),
    lambda: pdma.dma_serial_cuda(torch.zeros((8, 128), dtype=torch.int32), 4,
                                 1, 8, "reg", False)])
def test_kernels_refuse_cpu_tensors(call):
    """A kernel wrapper given CPU tensors raises; only the dispatchers run
    the plain versions, and only for CPU tensors."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()


def _card(*shape, dtype=torch.int32, index=0, skew=False):
    """Zeros that say they lie on card `index` (test_torch_probe_pallas.py's
    `_OnCard`), or, with `skew`, int32 zeros 4 bytes past a 16-byte
    boundary on card 0."""
    from . import test_torch_probe_pallas as tpp
    if skew:
        return tpp._misaligned(*shape)
    t = torch.zeros(shape, dtype=dtype)
    return t.as_subclass(tpp._OnCard1 if index else tpp._OnCard)


# C9's refusals: (seed, table) made on call, S, the message, in the order
# of the one-at-a-time checks (seed, then the table, then `_check`)
C9_REFUSALS = {
    "seed int64": (lambda: (_card(4, 128, dtype=torch.int64),
                            _card(8, 128)), 128, "seed: dtype torch.int64"),
    "seed 1-D": (lambda: (_card(128), _card(8, 128)), 128,
                 "seed: 1 dims, expected 2"),
    "seed transposed": (lambda: (_card(128, 4).t(), _card(8, 128)), 128,
                        "seed: not contiguous"),
    "table on cuda:1": (lambda: (_card(4, 128), _card(8, 128, index=1)), 128,
                        "table: on cuda:1, expected cuda:0"),
    "table int64": (lambda: (_card(4, 128), _card(8, 128,
                                                  dtype=torch.int64)),
                    128, "table: dtype torch.int64"),
    "table 3-D": (lambda: (_card(4, 128), _card(2, 4, 128)), 128,
                  "table: 3 dims, expected 2"),
    "table transposed": (lambda: (_card(4, 128), _card(128, 8).t()), 128,
                         "table: not contiguous"),
    "table misaligned": (lambda: (_card(4, 128), _card(8, 128, skew=True)),
                         128, "table: not 16-byte aligned"),
    "S 48": (lambda: (_card(4, 128), _card(8, 128)), 48,
             "S must be 32, 64, 96 or 128, got 48"),
    "S 64 narrower than its seed": (lambda: (_card(4, 32), _card(8, 128)),
                                    64, r"seed must be \[BB, >= 64\]"),
    "seed narrower than S": (lambda: (_card(4, 64), _card(8, 128)), 128,
                             r"seed must be \[BB, >= 128\]"),
    "table width": (lambda: (_card(4, 128), _card(8, 64)), 128,
                    r"table must be \[NROW, 128\]"),
    "table rows": (lambda: (_card(4, 128), _card(6, 128)), 128,
                   "NROW a power of two"),
    "seed before table": (lambda: (_card(4, 128, dtype=torch.int64),
                                   _card(8, 128, skew=True)), 128,
                          "seed: dtype"),
    "table before S": (lambda: (_card(4, 128), _card(8, 128, skew=True)),
                       48, "table: not 16-byte aligned")}
C9_WRAPPERS = {"run_cuda": pds.run_cuda,
               "run_witness_cuda": pds.run_witness_cuda,
               "run_stamped_cuda": lambda *a: pds.run_stamped_cuda(*a, True)}


def _counts():
    return (pds.launches, pds.launches_witness, pds.launches_stamped,
            pp.launches_dfs_shape)


def _refuse_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_build, "lib", refuse)


@pytest.mark.parametrize("wrapper", list(C9_WRAPPERS))
@pytest.mark.parametrize("case", list(C9_REFUSALS))
def test_c9_refusals(case, wrapper, monkeypatch):
    """Each of C9's wrappers refuses what its kernel does not take with
    the one-at-a-time checks' message and in their order, before asking
    for the library; no count moves."""
    _refuse_library(monkeypatch)
    make, s, msg = C9_REFUSALS[case]
    before = _counts()
    with pytest.raises(ValueError, match=msg):
        C9_WRAPPERS[wrapper](*make(), s, 200)
    assert _counts() == before


def test_c9_stamped_refuses_other_s(monkeypatch):
    """The stamped form runs at S 128 only, refused after the inputs'
    checks."""
    _refuse_library(monkeypatch)
    before = _counts()
    with pytest.raises(ValueError, match="stamped form takes S 128, got 64"):
        pds.run_stamped_cuda(_card(4, 128), _card(8, 128), 64, 200, True)
    assert _counts() == before


# C10's refusals: (k, table) made on call and the message, in the order of
# the one-at-a-time checks (k, the table and its width, k's width, rows)
C10_REFUSALS = {
    "k int64": (lambda: (_card(4, 128, dtype=torch.int64), _card(8, 128)),
                "k: dtype torch.int64"),
    "k 1-D": (lambda: (_card(128), _card(8, 128)), "k: 1 dims, expected 2"),
    "k transposed": (lambda: (_card(128, 4).t(), _card(8, 128)),
                     "k: not contiguous"),
    "table on cuda:1": (lambda: (_card(4, 128), _card(8, 128, index=1)),
                        "table: on cuda:1, expected cuda:0"),
    "table int64": (lambda: (_card(4, 128), _card(8, 128,
                                                  dtype=torch.int64)),
                    "table: dtype torch.int64"),
    "table transposed": (lambda: (_card(4, 128), _card(128, 8).t()),
                         "table: not contiguous"),
    "table misaligned": (lambda: (_card(4, 128), _card(8, 128, skew=True)),
                         "table: not 16-byte aligned"),
    "table width": (lambda: (_card(4, 128), _card(8, 64)),
                    "table rows have 64 words, not 128"),
    "k width": (lambda: (_card(4, 64), _card(8, 128)),
                r"k must be \[BB, 128\]"),
    "table rows": (lambda: (_card(4, 128), _card(6, 128)),
                   "table rows must be a power of two, got 6"),
    "table width before k width": (lambda: (_card(4, 64), _card(8, 64)),
                                   "table rows have 64 words")}


@pytest.mark.parametrize("case", list(C10_REFUSALS))
def test_c10_refusals(case, monkeypatch):
    """C10's wrapper refuses what its kernel does not take with the
    one-at-a-time checks' message and in their order, before asking for
    the library; no count moves."""
    _refuse_library(monkeypatch)
    make, msg = C10_REFUSALS[case]
    before = _counts()
    with pytest.raises(ValueError, match=msg):
        pp.dfs_shape_cuda(*make())
    assert _counts() == before


@pytest.fixture
def fake_dfs_lib(monkeypatch):
    """`_build.lib()` answers with a library that records C9's and C10's
    launch arguments (every launch succeeds), and the current stream's
    handle on device k is 1000 + k."""
    calls = []

    class Lib:
        def nabwa_probe_dfs_shape(self, *args):
            calls.append(("c9",) + args)
            return 0

        def nabwa_probe_dfs_pallas(self, *args):
            calls.append(("c10",) + args)
            return 0
    monkeypatch.setattr(_build, "lib", Lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    return calls


def _counted_pair(shape_a, shape_b, monkeypatch):
    from collections import Counter
    from . import test_torch_probe_pallas3 as tpp3
    monkeypatch.setattr(tpp3._Counted, "reads", Counter())
    a, b = (torch.zeros(s, dtype=torch.int32).as_subclass(tpp3._Counted)
            for s in (shape_a, shape_b))
    return a, b, tpp3._Counted.reads


@pytest.mark.parametrize("form", ["lean", "witness", "stamped"])
def test_c9_launch_on_pointers_read_once(form, fake_dfs_lib, monkeypatch):
    """C9's wrappers launch on the pointers and the device index their one
    pass read (each input's pointer and device index once, `device`
    never), acc in one allocation (the side buffer right after it in the
    stamped form), the stream of that index, the form's flag; each count
    rises by one."""
    from collections import Counter
    seed, table, reads = _counted_pair((6, 128), (4096, 128), monkeypatch)
    counts = _counts()
    if form == "stamped":
        out, stages, cal = pds.run_stamped_cuda(seed, table, 128, 7, True)
        assert stages.shape == (6, 7, len(pds.STAGES))
        assert cal.shape == (6, len(pds.CAL))
        assert stages.data_ptr() == out.data_ptr() + 4
        assert cal.data_ptr() == out.data_ptr() + 4 + 4 * 7 * 5
    else:
        wrapper = pds.run_cuda if form == "lean" else pds.run_witness_cuda
        out = wrapper(seed, table, 128, 7)
    assert {k: v for k, v in reads.items() if k[1] in (id(seed), id(table))
            } == Counter({(k, id(a)): 1 for k in ("data_ptr", "get_device")
                          for a in (seed, table)})
    base = out.data_ptr()
    assert fake_dfs_lib == [("c9", seed.data_ptr(), 128, table.data_ptr(),
                             4096, 6, 128, 7, int(form != "witness"), base,
                             base + 4 if form == "stamped" else None, 1000)]
    assert out.shape == (1, 1) and out.dtype == torch.int32
    bump = {"lean": 0, "witness": 1, "stamped": 2}[form]
    assert _counts() == tuple(c + (i == bump) for i, c in enumerate(counts))
    pds.run_cuda(_card(6, 128, index=1), _card(4096, 128, index=1), 128, 7)
    assert fake_dfs_lib[-1][-1] == 1001


def test_c10_launch_on_pointers_read_once(fake_dfs_lib, monkeypatch):
    """C10's wrapper launches as C9's does: each input's pointer and device
    index read once, acc one allocation, the stream of that index; its
    count rises by one."""
    from collections import Counter
    k, table, reads = _counted_pair((6, 128), (32768, 128), monkeypatch)
    before = pp.launches_dfs_shape
    out = pp.dfs_shape_cuda(k, table, 9)
    assert {key: v for key, v in reads.items()
            if key[1] in (id(k), id(table))} == Counter(
        {(key, id(a)): 1 for key in ("data_ptr", "get_device")
         for a in (k, table)})
    assert fake_dfs_lib == [("c10", k.data_ptr(), table.data_ptr(), 32768,
                             6, 9, out.data_ptr(), 1000)]
    assert out.shape == (1, 1) and out.dtype == torch.int32
    assert pp.launches_dfs_shape == before + 1


def test_c9_c10_empty_launch_nothing(fake_dfs_lib):
    """No reads: acc 0 and no launch, no count."""
    before = _counts()
    for got in (pds.run_cuda(_card(0, 128), _card(4096, 128), 128, 5),
                pds.run_witness_cuda(_card(0, 128), _card(4096, 128), 128,
                                     5),
                pds.run_stamped_cuda(_card(0, 128), _card(4096, 128), 128, 5,
                                     False)[0],
                pp.dfs_shape_cuda(_card(0, 128), _card(32768, 128))):
        assert got.shape == (1, 1) and int(got[0, 0]) == 0
    assert not fake_dfs_lib
    assert _counts() == before
