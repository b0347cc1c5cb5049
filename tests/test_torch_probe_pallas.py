"""Probes 2, 3, 4, 4b and 4c of scripts/probe_pallas.py (`nabwa_tpu_torch.
probes.probe_pallas`) against the JAX script on the CPU.

Each plain version must equal the script's kernel, run in Pallas interpret
mode, exactly: `probe_smem_idx`, `probe_popcount`, `probe_while_scratch`,
`probe_while_vector_only` and `probe_body_scale` at the script's own
inputs and, through the script's captured jitted `run`, at edge inputs:
indices at both ends of the table and repeated; popcounts of negatives,
INT32_MIN, -1 and INT32_MAX (the script's inputs never set bit 30 or 31);
pools within 8 of INT32_MAX (where `pool + 7` wraps negative) and of
INT32_MIN (where the sums wrap), and pools of values in 0..7 (every slot
equal to the minimum takes + 7, not only the first); probe 4c's body on
values near both ends of int32 and on every residue mod 8 with 0 and -1.
The kernels' new `__host__ __device__` helpers (csrc/probes.cuh), built
for the host with g++, must equal the plain formulas value by value.  The
entry point runs the five probes with `--device cpu` and prints the
script's lines.  C7's and C15's wrappers (probes 1 and 2), given tensors
that say they lie on the card, refuse what their checks one input at a
time refused, with the same messages and in the same order, before
anything is built and with their counts unchanged, and take an index off
a 16-byte boundary; their dispatchers refuse indices outside the table.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabwa_tpu_torch.probes import common
from nabwa_tpu_torch.probes import probe_pallas as pp

# fixtures and helpers shared with the other probe ports' tests: the script
# loader (interpret mode), one torch thread, the host harness
from .test_torch_probes import (_I, _P, _call, _i32, _t,  # noqa: F401
                                host, one_torch_thread, script)

REPO = pp.__file__.rsplit("/nabwa_tpu_torch/", 1)[0]
CPU = torch.device("cpu")
I32_MAX, I32_MIN = 2**31 - 1, -2**31
POOL = (pp.WHILE_BB, pp.WHILE_S)


def _load(script, monkeypatch, seed, probe):
    """Run probe `probe` of the script once with np.random seeded; returns
    what its timeit saw: the jitted `run`, its inputs and its result."""
    np.random.seed(seed)
    mod = script("probe_pallas")
    seen = {}

    def timeit(f, *args, n=20):
        r = f(*args)
        seen.update(run=f, args=[np.asarray(a) for a in args],
                    r=np.asarray(r))
        return 0.0, r
    monkeypatch.setattr(mod, "timeit", timeit)
    getattr(mod, probe)()
    assert "r" in seen, f"the script's {probe} failed"
    return seen


def _run(seen, *args):
    return np.asarray(seen["run"](*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("case", ["script", "edges"])
def test_smem_idx_matches_jax(script, monkeypatch, case):
    seen = _load(script, monkeypatch, 901, "probe_smem_idx")
    idx, table = seen["args"]
    assert idx.shape == (pp.ROWLOAD_BB,) and table.shape == (
        pp.ROWLOAD_NROW, 128)
    want = seen["r"]
    if case == "edges":
        rng = np.random.default_rng(901)
        idx = rng.integers(0, pp.ROWLOAD_NROW, pp.ROWLOAD_BB).astype(np.int32)
        idx[:4] = (0, pp.ROWLOAD_NROW - 1, 0, pp.ROWLOAD_NROW - 1)
        idx[100:140] = 7
        want = _run(seen, idx, table)
    got = pp.smem_idx(*common.tensors(CPU, idx, table))
    assert got.shape == (pp.ROWLOAD_BB, 128) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[idx])


@pytest.mark.parametrize("case", ["script", "edges"])
def test_popcount_matches_jax(script, monkeypatch, case):
    seen = _load(script, monkeypatch, 902, "probe_popcount")
    x, = seen["args"]
    assert x.shape == pp.POPCOUNT_SHAPE and x.dtype == np.int32
    want = seen["r"]
    if case == "edges":
        rng = np.random.default_rng(902)
        x = rng.integers(I32_MIN, I32_MAX, pp.POPCOUNT_SHAPE,
                         endpoint=True).astype(np.int32)
        x[0, :8] = (I32_MIN, -1, I32_MAX, 0, 1, -2, I32_MIN + 1, 1 << 30)
        want = _run(seen, x)
        np.testing.assert_array_equal(want[0, :8], [1, 32, 31, 0, 1, 31, 2,
                                                    1])
    got = pp.popcount(*common.tensors(CPU, x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _pool(case):
    """A [256, 128] int32 pool for probes 4 and 4b."""
    rng = np.random.default_rng(903)
    if case == "all_max_minus_3":
        return np.full(POOL, I32_MAX - 3, dtype=np.int32)
    if case == "near_max":
        return (I32_MAX - rng.integers(0, 8, POOL)).astype(np.int32)
    if case == "near_min":
        return (I32_MIN + rng.integers(0, 8, POOL)).astype(np.int32)
    return rng.integers(0, 8, POOL).astype(np.int32)          # ties


def _sum_of_minima(x):
    """The rounds in numpy int64 with no wrap at all: each row's sum of
    its minima, and whether `pool + 7` ever passed INT32_MAX."""
    pool = x.astype(np.int64)
    total = np.zeros(len(pool), dtype=np.int64)
    passed = False
    for _ in range(pp.WHILE_ITERS):
        m = pool.min(axis=1, keepdims=True)
        pool = np.where(pool == m, pool + 7, pool)
        passed |= bool((pool > I32_MAX).any())
        total += m[:, 0]
    return total, passed


@pytest.mark.parametrize("probe", ["probe_while_scratch",
                                   "probe_while_vector_only"])
@pytest.mark.parametrize("case", ["script", "all_max_minus_3", "near_max",
                                  "near_min", "ties"])
def test_while_matches_jax(script, monkeypatch, probe, case):
    seen = _load(script, monkeypatch, 904, probe)
    x, = seen["args"]
    assert x.shape == POOL and x.dtype == np.int32
    want = seen["r"]
    if case != "script":
        x = _pool(case)
        want = _run(seen, x)
    total, passed = _sum_of_minima(x)
    # the wrap-around is exercised where the case says so: + 7 past
    # INT32_MAX near it, sums past int32 at both ends
    assert passed == (case in ("all_max_minus_3", "near_max"))
    if probe == "probe_while_scratch":
        got = pp.while_scratch(*common.tensors(CPU, x))
        assert got.shape == (1, 1)
        assert (int(want[0, 0]) != int(total.sum())) == (
            case not in ("script", "ties"))
        if case == "all_max_minus_3":
            # by hand: round 1 takes INT32_MAX - 3 and wraps every slot to
            # INT32_MIN + 3, round k > 1 takes INT32_MIN + 3 + 7 (k - 2);
            # 256 rows of that sum, mod 2^32
            assert int(want[0, 0]) == 2144000
    else:
        got = pp.while_vector(*common.tensors(CPU, x))
        assert got.shape == POOL
        assert (want == want[:, :1]).all()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _body_input(case):
    """A [256, 128] int32 input for probe 4c."""
    rng = np.random.default_rng(906)
    shape = pp.BODY_SHAPE
    if case == "near_max":
        return (I32_MAX - rng.integers(0, 64, shape)).astype(np.int32)
    if case == "near_min":
        return (I32_MIN + rng.integers(0, 64, shape)).astype(np.int32)
    x = rng.integers(-8, 8, shape).astype(np.int32)        # small
    x[0, :4] = (0, -1, 0, -1)
    return x


def _numpy_body(x):
    """Probe 4c's rounds in numpy int64, wrapped after each step; and
    whether any `p + j` or `p + (p << 1)` passed int32 before its wrap."""
    p = x.astype(np.int64)
    passed = False
    for _ in range(pp.BODY_ROUNDS):
        for j in range(pp.BODY_STEPS):
            raw = np.where((p & 7) == j % 8, p + j, p)
            passed |= bool((raw > I32_MAX).any())
            p = ((raw + 2**31) & 0xFFFFFFFF) - 2**31
            p = p ^ (p >> 3)
            raw = p + (((p << 1) + 2**31) & 0xFFFFFFFF) - 2**31
            passed |= bool(((raw > I32_MAX) | (raw < I32_MIN)).any())
            p = ((raw + 2**31) & 0xFFFFFFFF) - 2**31
    return p, passed


@pytest.mark.parametrize("case", ["script", "near_max", "near_min",
                                  "small"])
def test_body_scale_matches_jax(script, monkeypatch, case):
    seen = _load(script, monkeypatch, 906, "probe_body_scale")
    x, = seen["args"]
    assert x.shape == pp.BODY_SHAPE and x.dtype == np.int32
    want = seen["r"]
    if case != "script":
        x = _body_input(case)
        want = _run(seen, x)
    if case == "small":
        assert set(np.unique(x % 8)) == set(range(8))
        assert (x == 0).any() and (x == -1).any()
    got = pp.body_scale(*common.tensors(CPU, x))
    assert got.shape == pp.BODY_SHAPE and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    model, passed = _numpy_body(x)
    np.testing.assert_array_equal(got.numpy(), model)
    assert passed                   # the adds wrap at every input


def _check_popcount(host, rng):
    x = _i32(rng, 4000, [0, 1, -1, -2**31, 2**31 - 1, 0x55555555,
                         -0x55555556, 1 << 30, -65536])
    got, = _call(host.nabwa_host_probe_popcount32, 1, x)
    return got, common.popcount32(_t(x))


def _check_while_step(host, rng):
    n = 4000
    key = _i32(rng, n, [2**31 - 1, 2**31 - 7, 2**31 - 8, -2**31, -1, 0])
    m = np.where(rng.random(n) < 0.5, key, _i32(rng, n)).astype(np.int32)
    m[:6] = key[:6]                       # the edges take the step
    got, = _call(host.nabwa_host_probe_while_step, 1, key, m)
    k = _t(key)
    return got, torch.where(k == _t(m), common.wrap32(k + 7), k)


def _check_body_step(host, rng):
    n = 4000
    p = _i32(rng, n, [2**31 - 1, 2**31 - 8, -2**31, -2**31 + 7, -1, 0, 7,
                      8, 0x2AAAAAAA, -0x2AAAAAAB])
    j = rng.integers(0, pp.BODY_STEPS, n).astype(np.int32)
    j[:10] = np.arange(10) % 8
    got, = _call(host.nabwa_host_probe_body_step, 1, p, j)
    return got, pp.body_step(_t(p), _t(j))


HOST_CHECKS = {"popcount32": _check_popcount,
               "while_step": _check_while_step,
               "body_step": _check_body_step}


@pytest.mark.parametrize("name", list(HOST_CHECKS))
def test_host_helpers_match_plain(host, name):
    """csrc/probes.cuh `popcount32` (kernel C16), `while_step` (C17, C18)
    and `body_step` (C19), built for the host, equal the plain versions'
    formulas value by value on random and edge inputs."""
    rng = np.random.default_rng(list(HOST_CHECKS).index(name) + 905)
    got, want = HOST_CHECKS[name](host, rng)
    np.testing.assert_array_equal(got, want.numpy())


RESULT_LINES = [
    r"devices: \['cpu'\]",
    r"probe2 smem-idx rowload BB=256: [\d.]+us  ok=True",
    r"probe3 popcount: [\d.]+us  ok=True",
    r"probe4 while\+scratch 50 iters: [\d.]+us  \([\d.]+us/iter\) "
    r"r=-?\d+",
    r"probe4b fori vector-only 50 iters: [\d.]+us  \([\d.]+us/iter\)",
    r"probe4c 60-op body 50 iters: [\d.]+us  \([\d.]+us/iter\)"]


def test_entry_point_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "nabwa_tpu_torch.probes.probe_pallas",
         "--device", "cpu", "2", "3", "4", "4b", "4c"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert len(lines) == len(RESULT_LINES), lines
    for line, pattern in zip(lines, RESULT_LINES):
        assert re.fullmatch(pattern, line), (line, pattern)


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("call", [
    lambda: pp.smem_idx_cuda(_zeros(4), _zeros(8, 128)),
    lambda: pp.popcount_cuda(_zeros(256, 128)),
    lambda: pp.while_scratch_cuda(_zeros(*POOL)),
    lambda: pp.while_vector_cuda(_zeros(*POOL)),
    lambda: pp.while_scratch_witness_cuda(_zeros(*POOL)),
    lambda: pp.while_vector_witness_cuda(_zeros(*POOL)),
    lambda: pp.body_scale_cuda(_zeros(*pp.BODY_SHAPE))])
def test_kernels_refuse_cpu_tensors(call):
    """A kernel wrapper given CPU tensors raises; only the dispatchers run
    the plain versions, and only for CPU tensors."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a wrapper's
    checks run on it; a launch would fail, so only a refusal passes.  It
    answers `is_cuda` and `get_device()` as a tensor on its device does,
    since the checks read those where they are cheaper than `device`."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return self.device.index


def _misaligned(*shape):
    """A contiguous int32 tensor of `shape` that starts 4 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 4, dtype=torch.int32)
    off = (-base.data_ptr() // 4) % 4 + 1
    t = base[off:off + n].view(shape)
    assert t.data_ptr() % 16 == 4
    return t.as_subclass(_OnCard)


def _on_card(*shape):
    return _zeros(*shape).as_subclass(_OnCard)


@pytest.mark.parametrize("call", [
    lambda: pp.rowload_cuda(_on_card(4, 1), _misaligned(8, 128)),
    lambda: pp.smem_idx_cuda(_on_card(4), _misaligned(8, 128)),
    lambda: pp.dfs_shape_cuda(_on_card(4, 128), _misaligned(8, 128)),
    lambda: pp.popcount_cuda(_misaligned(256, 128)),
    lambda: pp.while_scratch_cuda(_misaligned(*POOL)),
    lambda: pp.while_vector_cuda(_misaligned(*POOL)),
    lambda: pp.while_scratch_witness_cuda(_misaligned(*POOL)),
    lambda: pp.while_vector_witness_cuda(_misaligned(*POOL)),
    lambda: pp.body_scale_cuda(_misaligned(*pp.BODY_SHAPE))])
def test_kernels_refuse_misaligned_tensors(call):
    """A wrapper refuses a tensor its kernel would read as int4 unless it
    starts on a 16-byte boundary (the gather's table too), before any
    launch."""
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        call()


class _OnCard1(_OnCard):
    """A CPU tensor that says it lies on the second card."""

    @property
    def device(self):
        return torch.device("cuda", 1)


def _no_build(monkeypatch):
    """Fail the test if anything asks for the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(pp._build, "lib", refuse)


class _Counted(_OnCard):
    """An `_OnCard` tensor that counts its reads of `data_ptr()`,
    `get_device()` and `device`."""
    reads = None

    def data_ptr(self):
        _Counted.reads["data_ptr", id(self)] += 1
        return super().data_ptr()

    def get_device(self):
        _Counted.reads["get_device", id(self)] += 1
        return 0

    @property
    def device(self):
        _Counted.reads["device", id(self)] += 1
        return torch.device("cuda", 0)


class _FakeLib:
    """Records C29's, C28's, C27's, C20's, C7's, C15's, C8's (both forms),
    C11's, C31's, C33's and C35's, and C17's, C18's, C23's, C32's and
    C34's (both forms each) launch arguments; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def nabwa_probe_p3(self, *args):
        self.calls.append(args)
        return 0

    nabwa_probe_p1b = nabwa_probe_p1 = nabwa_probe_p3
    nabwa_probe_lane_gather = nabwa_probe_p3
    nabwa_probe_rowload = nabwa_probe_smem_idx = nabwa_probe_p3
    nabwa_probe_dma = nabwa_probe_dma_serial = nabwa_probe_p3
    nabwa_probe_empty = nabwa_probe_p3
    nabwa_probe_spill = nabwa_probe_spill_witness = nabwa_probe_p3
    nabwa_probe_p5 = nabwa_probe_p5_witness = nabwa_probe_p3
    nabwa_probe_p2 = nabwa_probe_p2_roll_witness = nabwa_probe_p6 = \
        nabwa_probe_p3
    nabwa_probe_while_scratch = nabwa_probe_p3
    nabwa_probe_while_scratch_witness = nabwa_probe_p3
    nabwa_probe_while_vector = nabwa_probe_p3
    nabwa_probe_while_vector_witness = nabwa_probe_p3


@pytest.fixture
def fake_launch(monkeypatch):
    """`_build.lib()` answers with a `_FakeLib`, and the current stream's
    handle on device k is 1000 + k."""
    fake = _FakeLib()
    monkeypatch.setattr(pp._build, "lib", lambda: fake)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    return fake


def _launch_from_threads(launch, threads=8, calls=300):
    """`launch()` `calls` times in each of `threads` threads started
    together, the interpreter switching threads every microsecond;
    returns the launches made."""
    import threading

    def run():
        for _ in range(calls):
            launch()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=run) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in pool)
    return threads * calls


def _old_gather_checks(idx, table, idx_ndim):
    """C7's (idx_ndim 2) and C15's (1) checks as their wrappers made them
    one input at a time: the index's type, device, dtype, dims and
    contiguity (not its alignment), C7's [BB, 1], then `cuda_input` on
    the table with the index's device, then the table's width."""
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    pp._build.require(idx, "idx", dev, idx_ndim)
    if idx_ndim == 2 and idx.shape[1] != 1:
        raise ValueError(f"idx must be [BB, 1], got {tuple(idx.shape)}")
    common.cuda_input(table, "table", 2, dev)
    if table.shape[1] != 128:
        raise ValueError(f"table rows have {table.shape[1]} words, not 128")


_GATHER_BB, _GATHER_NROW = 8, 16
# C7's and C15's index by form, given its shape: [BB, 1] for C7, [BB] for
# C15 (a 1-D index has no transposed or [BB, 2] form)
_GATHER_IDX = {
    "good": lambda shape: _on_card(*shape),
    "cpu": lambda shape: _zeros(*shape),
    "int64": lambda shape: _on_card(*shape).long(),
    "dims": lambda shape: _on_card(_GATHER_BB, *((1,) if len(shape) == 1
                                                 else ())),
    "transposed": lambda shape: _on_card(*shape).t(),
    "column": lambda shape: _on_card(_GATHER_BB, 2)[:, 1:]
    if len(shape) == 2 else _on_card(_GATHER_BB, 2)[:, 1],
    "wide": lambda shape: _on_card(_GATHER_BB, 2),
    "misaligned": lambda shape: _misaligned(*shape),
    "cuda1": lambda shape: _zeros(*shape).as_subclass(_OnCard1)}
_GATHER_TABLE = {
    "good": lambda: _on_card(_GATHER_NROW, 128),
    "cpu": lambda: _zeros(_GATHER_NROW, 128),
    "int64": lambda: _on_card(_GATHER_NROW, 128).long(),
    "dims": lambda: _on_card(_GATHER_NROW * 128),
    "transposed": lambda: _on_card(128, _GATHER_NROW).t(),
    "column": lambda: _on_card(_GATHER_NROW, 132)[:, 4:],
    "misaligned": lambda: _misaligned(_GATHER_NROW, 128),
    "narrow": lambda: _on_card(_GATHER_NROW, 124),
    "cuda1": lambda: _zeros(_GATHER_NROW, 128).as_subclass(_OnCard1)}
# what each bad table alone is refused with
_TABLE_MSG = {"cpu": "the kernel needs CUDA tensors, got cpu",
              "int64": "table: dtype torch.int64, expected torch.int32",
              "dims": "table: 1 dims, expected 2",
              "transposed": "table: not contiguous",
              "column": "table: not contiguous",
              "misaligned": "table: not 16-byte aligned",
              "narrow": "table rows have 124 words, not 128",
              "cuda1": "table: on cuda:1, expected cuda:0"}
# what each bad index is refused with, whatever the table
_IDX_MSG = {
    "c7": {"cpu": "the kernel needs CUDA tensors, got cpu",
           "int64": "idx: dtype torch.int64, expected torch.int32",
           "dims": "idx: 1 dims, expected 2",
           "transposed": "idx must be [BB, 1], got (1, 8)",
           "column": "idx: not contiguous",
           "wide": "idx must be [BB, 1], got (8, 2)"},
    "c15": {"cpu": "the kernel needs CUDA tensors, got cpu",
            "int64": "idx: dtype torch.int64, expected torch.int32",
            "dims": "idx: 2 dims, expected 1",
            "column": "idx: not contiguous"}}
_GATHERS = {"c7": (2, pp.rowload_cuda), "c15": (1, pp.smem_idx_cuda)}


@pytest.mark.parametrize("kernel, idx_form", [
    (kernel, form) for kernel in _GATHERS for form in _GATHER_IDX
    if kernel == "c7" or form not in ("transposed", "wide")])
def test_gathers_refuse_as_one_at_a_time(kernel, idx_form, monkeypatch):
    """C7's and C15's one check pass refuses, with every table form beside
    the index, what their checks one input at a time refused, with the
    same message: the index's faults first, C7's [BB, 1] before any of
    the table's (its width last); before anything is built or launched,
    and their counts unchanged.  What those checks took, the pass takes:
    an index off a 16-byte boundary (the kernels read it as int32) with a
    good table reaches the kernel library."""
    _no_build(monkeypatch)
    ndim, wrapper = _GATHERS[kernel]
    shape = (_GATHER_BB, 1)[:ndim]
    for table_form, make_table in _GATHER_TABLE.items():
        idx, table = _GATHER_IDX[idx_form](shape), make_table()
        try:
            _old_gather_checks(idx, table, ndim)
            want = None
        except ValueError as err:
            want = str(err)
        if idx_form in _IDX_MSG[kernel]:
            assert want == _IDX_MSG[kernel][idx_form], table_form
        elif idx_form in ("good", "misaligned") and table_form != "good":
            assert want == _TABLE_MSG[table_form], table_form
        counts = (pp.launches_rowload, pp.launches_smem_idx)
        if want is None:
            with pytest.raises(AssertionError, match="library was asked"):
                wrapper(idx, table)
        else:
            with pytest.raises(ValueError) as err:
                wrapper(idx, table)
            assert str(err.value) == want, table_form
        assert (pp.launches_rowload, pp.launches_smem_idx) == counts


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("bad", [pp.ROWLOAD_NROW, -1])
@pytest.mark.parametrize("probe", ["rowload", "smem_idx"])
def test_gathers_refuse_out_of_range(probe, bad, on_card, monkeypatch):
    """An index outside the table's rows is refused by the dispatchers
    before any copy: on the CPU (where 4096 raised IndexError and -1 read
    the last row) and before any launch for tensors on the card (which
    would read out of bounds); the launch counts stay."""
    _no_build(monkeypatch)
    make = _on_card if on_card else _zeros
    table = make(pp.ROWLOAD_NROW, 128)
    idx = _zeros(*((8, 1) if probe == "rowload" else (8,)))
    idx[5] = bad
    if on_card:
        idx = idx.as_subclass(_OnCard)
    counts = (pp.launches_rowload, pp.launches_smem_idx)
    with pytest.raises(ValueError, match=r"indices outside \[0, 4096\)"):
        getattr(pp, probe)(idx, table)
    assert (pp.launches_rowload, pp.launches_smem_idx) == counts


def _while_rows_input(case):
    """A [256, 128] int32 pool for C17's and C18's grid form on the host:
    `_pool`'s cases, "random" over all of int32, and "wraps", values from
    2^30 whose row sums and C17's carry wrap many times."""
    rng = np.random.default_rng(1701)
    if case == "random":
        return rng.integers(I32_MIN, I32_MAX, POOL,
                            endpoint=True).astype(np.int32)
    if case == "wraps":
        return ((1 << 30) + rng.integers(0, 1000, POOL)).astype(np.int32)
    return _pool(case)


@pytest.mark.parametrize("case", ["random", "near_max", "near_min",
                                  "all_max_minus_3", "ties", "wraps"])
def test_host_while_rows_match_plain(host, case):
    """C17's and C18's grid form played lane by lane on the host
    (`while_lane_min` and `while_lane_round` of csrc/probes.cuh, built by
    g++; a row's 32 lanes, their minimum in place of the redux.sync, every
    lane's row sum the same): each row's sum is every column of that row
    of `while_vector_plain`, and the rows' sums added as uint32 (C17's
    carry, summed once after the rounds) are `while_scratch_plain`, on
    random rows over int32, rows within 8 of both ends, all INT32_MAX - 3,
    ties in 0..7, and values from 2^30, whose every row sum and the carry
    wrap many times."""
    x = _while_rows_input(case)
    fn = host.nabwa_host_probe_while_rows
    fn.argtypes = [_P, _I, _I, _P, _P]
    fn.restype = _I
    row_sums = np.full(pp.WHILE_BB, 7, dtype=np.int32)
    acc = np.zeros(1, dtype=np.int32)
    assert fn(x.ctypes.data_as(_P), pp.WHILE_BB, pp.WHILE_ITERS,
              row_sums.ctypes.data_as(_P), acc.ctypes.data_as(_P)) == 0
    x_t, = common.tensors(CPU, x)
    np.testing.assert_array_equal(
        pp.while_vector_plain(x_t).numpy(),
        np.repeat(row_sums[:, None], pp.WHILE_S, axis=1))
    assert int(acc[0]) == int(pp.while_scratch_plain(x_t)[0, 0])
    if case == "wraps":
        total, _ = _sum_of_minima(x)
        assert (total > 12 * 2**32).all() and total.sum() > 3000 * 2**32


# C17's and C18's wrappers, both forms of each: the call, its launch's
# arguments between x and out, out's shape and the launch counter's name
_WHILE_FORMS = {
    "c17_grid": (pp.while_scratch_cuda, (pp.WHILE_SCRATCH_WARPS,), (1, 1),
                 "launches_while_scratch"),
    "c17_witness": (pp.while_scratch_witness_cuda, (), (1, 1),
                    "launches_while_scratch_witness"),
    "c18_grid": (pp.while_vector_cuda, (pp.WHILE_VECTOR_WARPS,), POOL,
                 "launches_while_vector"),
    "c18_witness": (pp.while_vector_witness_cuda, (), POOL,
                    "launches_while_vector_witness")}
# x by form ([256, 128] when good)
_WHILE_X = {"good": lambda: _on_card(*POOL),
            "cpu": lambda: _zeros(*POOL),
            "int64": lambda: _on_card(*POOL).long(),
            "dims": lambda: _on_card(POOL[0] * POOL[1]),
            "transposed": lambda: _on_card(POOL[1], POOL[0]).t(),
            "column": lambda: _on_card(POOL[0], POOL[1] + 4)[:, 4:],
            "misaligned": lambda: _misaligned(*POOL),
            "misaligned_short": lambda: _misaligned(POOL[0] - 1, POOL[1]),
            "short": lambda: _on_card(POOL[0] - 1, POOL[1]),
            "wide": lambda: _on_card(POOL[0], 2 * POOL[1]),
            "cuda1": lambda: _zeros(*POOL).as_subclass(_OnCard1)}


def _while_counts():
    return {name: getattr(pp, name) for *_, name in _WHILE_FORMS.values()}


def _while_refusal(x):
    """The message of the first check one at a time that refuses x (None
    if all pass): `common.cuda_input`'s (device, dtype, dims, contiguity,
    16-byte alignment), then the [256, 128] shape."""
    try:
        common.cuda_input(x, "x", 2)
    except ValueError as err:
        return str(err)
    if tuple(x.shape) != POOL:
        return f"x must be [256, 128], got {tuple(x.shape)}"
    return None


@pytest.mark.parametrize("form, x_form", [
    (form, x_form) for form in _WHILE_FORMS for x_form in _WHILE_X])
def test_c17_c18_refuse_in_order(form, x_form, monkeypatch):
    """Both forms of C17 and C18 refuse what their checks one at a time
    refused, with the same message and in the same order: x's device,
    dtype, dims, contiguity and 16-byte alignment, then its [256, 128]
    shape (a misaligned x of another shape is refused for its alignment);
    before anything is built or launched, every count unchanged."""
    _no_build(monkeypatch)
    call = _WHILE_FORMS[form][0]
    x = _WHILE_X[x_form]()
    want = _while_refusal(x)
    before = _while_counts()
    if want is None:
        with pytest.raises(AssertionError, match="library was asked"):
            call(x)
    else:
        with pytest.raises(ValueError) as err:
            call(x)
        assert str(err.value) == want
    assert _while_counts() == before
    assert (want is None) == (x_form in ("good", "cuda1"))
    if x_form == "misaligned_short":
        assert want == "x: not 16-byte aligned"


@pytest.mark.parametrize("form", list(_WHILE_FORMS))
def test_c17_c18_launch_on_pointers_read_once(form, fake_launch,
                                              monkeypatch):
    """Both forms of C17 and C18 launch on x's pointer and device index
    read once by their one check pass (`device` never), the output's
    pointer read once, the stream of that index (of index 1 on the second
    card); the grid forms with their warps a block; an output of [1, 1]
    (C17) or x's shape (C18); the count rises by one a launch."""
    from collections import Counter
    monkeypatch.setattr(_Counted, "reads", Counter())
    call, args, shape, count = _WHILE_FORMS[form]
    x = _zeros(*POOL).as_subclass(_Counted)
    before = getattr(pp, count)
    out = call(x)
    assert _Counted.reads == Counter(
        {(k, id(x)): 1 for k in ("data_ptr", "get_device")}
        | {("data_ptr", id(out)): 1})
    assert fake_launch.calls[-1] == (x.data_ptr(), *args, out.data_ptr(),
                                     1000)
    assert tuple(out.shape) == shape and out.dtype == torch.int32
    assert out.is_contiguous()
    call(_zeros(*POOL).as_subclass(_OnCard1))
    assert fake_launch.calls[-1][-1] == 1001
    assert getattr(pp, count) == before + 2


@pytest.mark.parametrize("form", list(_WHILE_FORMS))
def test_c17_c18_count_exact_under_threads(form, fake_launch):
    """Four threads launching one form together, the interpreter switching
    threads every microsecond: its count rises by exactly the launches
    made."""
    call, _, _, count = _WHILE_FORMS[form]
    x = _on_card(*POOL)
    before = getattr(pp, count)
    made = _launch_from_threads(lambda: call(x), threads=4)
    assert getattr(pp, count) - before == made == len(fake_launch.calls)
