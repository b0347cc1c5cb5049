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
at forced ties and where the sum of the tied slots wraps.  Probe C holds
at indices all 0, all 127 and a permutation of each row, with x at
+-(2^31 - 1), and refuses indices outside [0, 128).  Probe D reads slots
that no push wrote, which interpret mode fills with INT32_MIN; the plain
version does the same, and its five field buffers and top, which the
output does not show, equal a numpy model of the pushes, at the script's
input, at values near both ends of int32 (the fields wrap) and at rows
that push 3 candidates every round or none.  The kernels' new
`__host__ __device__` helpers (csrc/probes.cuh), built for the host with
g++, must equal the plain formulas value by value.  The entry point runs
with `--device cpu` and prints the script's lines; an unknown probe and a
missing card exit non-zero.
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
from .test_torch_probes import (_I, _P, _call, _i32, _t,  # noqa: F401
                                host, one_torch_thread, script)

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


def _gather_input(case, x):
    """Probe C's indices for `case`, and x with +-(2^31 - 1) in it."""
    rng = np.random.default_rng(819)
    shape = (pp2.BB, pp2.GATHER_W)
    x = x.copy()
    x[:, 0] = I32_MAX
    x[:, pp2.GATHER_W - 1] = -I32_MAX
    x[::2, 5] = I32_MIN
    if case == "zeros":
        return x, np.zeros(shape, dtype=np.int32)
    if case == "last":
        return x, np.full(shape, pp2.GATHER_W - 1, dtype=np.int32)
    return x, np.stack([rng.permutation(pp2.GATHER_W)            # perm
                        for _ in range(pp2.BB)]).astype(np.int32)


@pytest.mark.parametrize("case", ["script", "zeros", "last", "perm"])
def test_lane_gather_matches_jax(script, monkeypatch, case):
    mod, seen = _load(script, monkeypatch, 819)
    mod.probe_lane_gather()
    assert "r" in seen, "the script's probe C failed"
    x, i = seen["args"]
    assert x.shape == i.shape == (pp2.BB, pp2.GATHER_W)
    want = seen["r"]
    if case != "script":
        x, i = _gather_input(case, x)
        want = np.asarray(seen["run"](jnp.asarray(x), jnp.asarray(i)))
    got = pp2.lane_gather(*common.tensors(CPU, x, i))
    assert got.shape == x.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(x, i, axis=1))
    if case == "perm":
        np.testing.assert_array_equal(np.sort(got.numpy(), axis=1),
                                      np.sort(x, axis=1))


@pytest.mark.parametrize("bad", [-1, pp2.GATHER_W, I32_MIN])
def test_lane_gather_refuses_out_of_range(bad):
    x = torch.zeros((4, pp2.GATHER_W), dtype=torch.int32)
    i = torch.zeros_like(x)
    i[2, 7] = bad
    with pytest.raises(ValueError, match="outside"):
        pp2.lane_gather(x, i)


def _numpy_push(c):
    """scripts/probe_pallas2.py:115-142 in Python ints, row by row: (out,
    the five field buffers with INT32_MIN where no push wrote, top)."""
    c = c.astype(np.int64)
    rows = len(c)
    fields = np.full((5, rows, pp2.PUSH_S), I32_MIN, dtype=np.int64)
    top = np.zeros((rows, pp2.PUSH_OUT), dtype=np.int64)
    for i in range(rows):
        t = 0
        for it in range(pp2.PUSH_ROUNDS):
            for j in range(c[i, it & 7] & 3):
                v = int(c[i, j])
                fields[:, i, t] = [v, _wrap(v + 1), v ^ 3, _wrap(v - 7),
                                   _wrap(v * 3)]
                t = (t + 1) & (pp2.PUSH_S - 1)
        top[i, 0] = t
    return _wrap(fields[0, :, :pp2.PUSH_OUT] + top), fields, top


def _push_input(case, c):
    rng = np.random.default_rng(820)
    shape = c.shape
    if case == "near_max":
        c = I32_MAX - rng.integers(0, 1 << 10, shape)
        c[::2, 0] = I32_MAX                             # v + 1 wraps
        return c.astype(np.int32)
    if case == "near_min":
        c = I32_MIN + rng.integers(0, 1 << 10, shape)
        c[::2, 1] = I32_MIN + rng.integers(0, 7, len(c[::2]))  # v - 7 too
        return c.astype(np.int32)
    c = c.copy()
    c[:, :8] = (c[:, :8] | 3) if case == "all_three" else (c[:, :8] & ~3)
    return c


@pytest.mark.parametrize("case", ["script", "near_max", "near_min",
                                  "all_three", "none"])
def test_scalar_push_matches_jax(script, monkeypatch, case):
    mod, seen = _load(script, monkeypatch, 820)
    mod.probe_scalar_push()
    assert "r" in seen, "the script's probe D failed"
    c, = seen["args"]
    assert c.shape == (pp2.BB, pp2.PUSH_OUT) and c.dtype == np.int32
    want = seen["r"]
    if case != "script":
        c = _push_input(case, c)
        want = np.asarray(seen["run"](jnp.asarray(c)))
    out, fields, top = pp2.scalar_push(*common.tensors(CPU, c))
    assert out.shape == (pp2.BB, pp2.PUSH_OUT) and out.dtype == torch.int32
    assert fields.shape == (5, pp2.BB, pp2.PUSH_S)
    assert fields.dtype == top.dtype == torch.int32
    assert top.shape == out.shape
    np.testing.assert_array_equal(out.numpy(), want)
    m_out, m_fields, m_top = _numpy_push(c)
    np.testing.assert_array_equal(out.numpy(), m_out)
    np.testing.assert_array_equal(fields.numpy(), m_fields)
    np.testing.assert_array_equal(top.numpy(), m_top)
    t = m_top[:, 0]
    # slots no push reached read INT32_MIN (plus top in column 0)
    unwritten = np.arange(pp2.PUSH_OUT)[None, :] >= t[:, None]
    assert (want[:, 1:][unwritten[:, 1:]] == I32_MIN).all()
    if case == "all_three":
        assert (t == 150).all()
    elif case == "none":
        assert (t == 0).all() and (want[:, 0] == I32_MIN).all()
    else:
        assert unwritten.any() and 0 < t.max() <= 150
    if case in ("near_max", "near_min"):
        v = c[:, :3].astype(np.int64)
        assert ((v * 3 > I32_MAX) | (v * 3 < I32_MIN)).all()
        step = 1 if case == "near_max" else -7
        wrapped = (fields.numpy()[1 if step == 1 else 3].astype(np.int64)
                   != fields.numpy()[0].astype(np.int64) + step)
        assert (wrapped & (fields.numpy()[0] != I32_MIN)).any()


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


def test_host_push_fields_match_plain(host):
    """csrc/probes.cuh `push_fields`, which kernel C21 runs on each push,
    built for the host, equals the plain version's fields value by value,
    every field of random and edge values."""
    rng = np.random.default_rng(821)
    n = 4000
    v = _i32(rng, n, [2**31 - 1, 2**31 - 2, -2**31, -2**31 + 6, -2**31 + 7,
                      0x2AAAAAAB, -0x2AAAAAAB, 3, -4])
    k = (np.arange(n) % 5).astype(np.int32)
    got, = _call(host.nabwa_host_probe_push_fields, 1, v, k)
    want = pp2.push_values(_t(v))[_t(k), torch.arange(n)]
    np.testing.assert_array_equal(got, want.numpy())


def _cu_constant(name):
    """An int constant of csrc/probe_pallas2.cu (`constexpr int NAME = v;`)."""
    src = open(os.path.join(REPO, "nabwa_tpu_torch", "csrc",
                            "probe_pallas2.cu")).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _loads_blocks(host, bb, warps, max_blocks):
    got, = _call(host.nabwa_host_probe_loads_blocks, 1,
                 *(np.array([v], dtype=np.int32)
                   for v in (bb, warps, max_blocks)))
    return int(got[0])


def _loads_rows(host, warps, blocks, bb, idx_w, steps):
    """Every (block, warp, step) of the grid through the harness: (block,
    warp, step, output row, index word or -1) as int64 arrays."""
    block, warp, step = (a.ravel().astype(np.int32) for a in np.meshgrid(
        np.arange(blocks), np.arange(warps), np.arange(steps),
        indexing="ij"))
    n = len(block)
    row, at = np.empty(n, dtype=np.int64), np.empty(n, dtype=np.int64)
    fn = host.nabwa_host_probe_loads_rows
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
    fn.restype = _I
    assert fn(*[a.ctypes.data_as(_P) for a in (block, warp, step)], n,
              warps, blocks, bb, idx_w, row.ctypes.data_as(_P),
              at.ctypes.data_as(_P)) == 0
    return block, warp, step, row, at


@pytest.mark.parametrize("bb", [0, 1, 7, 256, 1000])
@pytest.mark.parametrize("shape", ["kernel", "8x3"])
def test_host_loads_grid_copies_each_row_once(host, bb, shape):
    """csrc/probes.cuh `loads_blocks` and `loads_out_row`, kernel C12's
    grid and the row each warp copies at each step, built for the host:
    walking every warp of the grid as the kernel does (on to its first row
    past 2 BB), every row in [0, 2 BB) is copied exactly once and no
    other; each reads idx[r, 0] below BB and idx[r - BB, 1] above.  At
    the kernel's block shape, and at 8 warps in at most 3 blocks, where
    the warps take several steps."""
    warps, max_blocks = ((_cu_constant("LOADS_WARPS"),
                          _cu_constant("LOADS_MAX_BLOCKS"))
                         if shape == "kernel" else (8, 3))
    blocks = _loads_blocks(host, bb, warps, max_blocks)
    assert blocks == min(-(-2 * bb // warps), max_blocks)
    idx_w = 3
    steps = -(-2 * bb // max(warps * blocks, 1)) + 1   # one step past all
    block, warp, step, row, at = _loads_rows(host, warps, blocks, bb,
                                             idx_w, steps)
    copied = []
    for b in range(blocks):
        for w in range(warps):
            mine = row[(block == b) & (warp == w)]
            assert (np.diff(mine) > 0).all()     # rising: the stop masks
            assert mine[-1] >= 2 * bb            # every warp stops
            copied.append(mine[mine < 2 * bb])
    copied = np.concatenate(copied) if copied else np.zeros(0, np.int64)
    np.testing.assert_array_equal(np.sort(copied), np.arange(2 * bb))
    r = row[row < 2 * bb]
    np.testing.assert_array_equal(
        at[row < 2 * bb], np.where(r < bb, r * idx_w, (r - bb) * idx_w + 1))
    assert (at[row >= 2 * bb] == -1).all()


RESULT_LINES = [
    r"devices: \['cpu'\]",
    r"probeA empty kernel: [\d.]+us",
    r"probeB 2x256 rowloads unroll=1: [\d.]+us \(\d+ns/load\)  ok=True",
    r"probeB 2x256 rowloads unroll=256: [\d.]+us \(\d+ns/load\)  ok=True",
    r"probeC take_along_axis lanes: [\d.]+us ok=True",
    r"probeD scalar push 50 iters x 256 lanes x <=3 cands: [\d.]+ms "
    r"\([\d.]+us/iter\)",
    r"probeE \[512,128\] lane-sum: [\d.]+us ok=True",
    r"probeF pop-shape 50 iters S=256: [\d.]+ms \([\d.]+us/iter\)"]


def test_entry_point_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "nabwa_tpu_torch.probes.probe_pallas2",
         "--device", "cpu", "A", "B1", "BU", "C", "D", "E", "F"], cwd=REPO,
        env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert len(lines) == len(RESULT_LINES), lines
    for line, pattern in zip(lines, RESULT_LINES):
        assert re.fullmatch(pattern, line), (line, pattern)


@pytest.mark.parametrize("probe", ["G", "c"])
def test_unported_probe_exits_nonzero(capsys, probe):
    """A probe the script does not have exits non-zero before any runs."""
    assert pp2.main(["--device", "cpu", "A", probe]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert f"probe {probe}: no such probe" in captured.err


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
    lambda: pp2.loads_serial_cuda(_zeros(256, 128), _zeros(8, 128), 1),
    lambda: pp2.pop_cuda(_zeros(4, 256)),
    lambda: pp2.lanereduce_cuda(_zeros(4, 128)),
    lambda: pp2.lane_gather_cuda(_zeros(4, 128), _zeros(4, 128)),
    lambda: pp2.scalar_push_cuda(_zeros(4, 128))])
def test_kernels_refuse_cpu_tensors(call):
    """A kernel wrapper given CPU tensors raises; only the dispatchers run
    the plain versions, and only for CPU tensors."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
