"""Probes 2, 5 and 6 of scripts/probe_pallas3.py (`nabwa_tpu_torch.probes.
probe_pallas3`) against the JAX script on the CPU.

The script runs in Pallas interpret mode through the captured `timeit` of
tests/test_torch_probe_pallas3.py (`_load`), which records each jitted
`run`, its inputs and its result.  Probe 2 (50 rounds of v += the row
minimum, `native` and `roll`, or the column minimum, `subl`) and probe 5
(50 outer rounds of a loop whose trip count (s[0, 0] & 3) + 1 hangs on
the data) must equal the script exactly: at the script's inputs, which
wrap int32 within probe 2's 50 rounds (asserted on a numpy model), and,
through the captured `run`, at int32 edge inputs: values within 8 of
both ends with each row's or column's minimum repeated (ties), every
value within 8 of INT32_MAX (each first sum wraps), and for probe 5 a
negative s[0, 0] and an s[0, 0] that wraps.  Probe 6 (an int32 [512, 128]
cast to float32 times a float32 [128, 8]) must equal the script exactly
at its inputs (w of ones: every sum an integer below 2^24), and at a
random w agree within 2 K 2^-24 (|x| @ |w|) elementwise, twice the bound
on float32 summation error over K = 128 terms in any order (XLA's dot
need not add in index order as the plain version does).  Kernel C32's
rotation source and C34's trip count, `roll_src` and `p5_trips` of
csrc/probes.cuh built by g++, equal np.roll and the plain formula value by
value.  Kernel C32's lane form, played lane by lane on the host
(`p2_lane_min`, `p2_roll_lane`), equals `p2_min(v, "roll")` in its first
round and the plain version and the script over 50 rounds, at the
script's input, the edge inputs and a row minimum at each of the 128
words; kernel C35's staged form, played block by block on the host
(`p6_stage`, `p6_dot`),
equals the plain version bit for bit at the script's shape and at shapes
that leave tails of K, N and R (and the script at its inputs), with
tiles of 128 and of 8 words.  The wrappers refuse CPU tensors,
misaligned inputs, other dtypes and shapes their kernels do not take
(C34's witness, an s past one block's shared memory; C35's inputs past a
launch's blocks), and an unknown kind.  C31's, C32's (both forms), C33's
and C35's wrappers are held on fake card tensors and a fake kernel
library as C23's and C34's are in tests/test_torch_probe_pallas3.py:
refusals in the order of the checks one at a time, nothing launched on
an empty output, the pointers read once, counts exact over 4 threads.
"""

import numpy as np
import pytest
import torch

from nabwa_tpu_torch.probes import common
from nabwa_tpu_torch.probes import probe_pallas3 as p3

# fixtures and helpers shared with the other probe ports' tests
from .test_torch_probe_pallas import (_Counted, _launch_from_threads,
                                      _misaligned, _no_build, _on_card,
                                      _OnCard, _OnCard1,
                                      fake_launch)  # noqa: F401
from .test_torch_probe_pallas3 import (CPU, EDGES, I32_MAX, I32_MIN, _load,
                                       _p5_input, _run)
from .test_torch_probe_spill import masked
from .test_torch_probes import (_I, _P, _call, _i32, host,  # noqa: F401
                                one_torch_thread)
from .test_torch_probes import script  # noqa: F401

P2_LINES = [f"P2 min-reduce[{k}] 50 iters:#ms (#us/iter)"
            for k in ("native", "roll", "subl")]
P5_LINES = ["P5 dyn-trip inner fori 50 outers:#ms"]
P6_LINES = ["P6 matmul-ones reduce [512,128]:#us ok=True"]


def _wrap(v):
    return (v + 2**31) % 2**32 - 2**31


def _first_wrap(x, kind):
    """The first of probe 2's rounds whose sum v + m leaves int32 (None if
    none does), on a numpy model of the script's kernel (:91-103)."""
    v = x.astype(np.int64)
    for r in range(p3.P2_ROUNDS):
        m = v.min(axis=0 if kind == "subl" else 1, keepdims=True)
        s = v + m
        if ((s > I32_MAX) | (s < I32_MIN)).any():
            return r
        v = _wrap(s)
    return None


def _p2_input(rng, kind, case):
    """int32 [256, 128] for `case`: "edges", values over all of int32, the
    int32 edges in every row, and each row's minimum (each column's, for
    `subl`) repeated at three more places; "high", every value within 8
    of INT32_MAX."""
    if case == "high":
        return (I32_MAX - rng.integers(0, 8, p3.P2_X)).astype(np.int32)
    x = rng.integers(I32_MIN, I32_MAX, p3.P2_X, endpoint=True)
    x[:, :16] = rng.permuted(np.tile(EDGES, (len(x), 1)), axis=1)
    x[:, 16:] = rng.permuted(x[:, 16:], axis=1)
    y = x.T if kind == "subl" else x           # a view: ties along y's rows
    for r in range(len(y)):
        others = np.flatnonzero(y[r] != y[r].min())
        y[r, rng.choice(others, 3, replace=False)] = y[r].min()
    return x.astype(np.int32)


@pytest.mark.parametrize("case", ["script", "edges", "high"])
@pytest.mark.parametrize("kind", p3.P2_KINDS)
def test_p2_matches_jax(script, monkeypatch, capsys, kind, case):
    seen, lines = _load(script, monkeypatch, capsys, 1320, "p2")
    assert masked(lines) == P2_LINES
    assert len(seen) == len(p3.P2_KINDS)
    call = seen[p3.P2_KINDS.index(kind)]
    x, = call["args"]
    assert x.shape == p3.P2_X
    want = call["r"]
    if case == "script":
        assert _first_wrap(x, kind) is not None   # the script's input wraps
    else:
        x = _p2_input(np.random.default_rng(1320), kind, case)
        assert _first_wrap(x, kind) == 0
        want = _run(call, x)
    got = p3.p2(*common.tensors(CPU, x), kind)
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "roll":                 # the same minima as `native`
        np.testing.assert_array_equal(
            got.numpy(), p3.p2_plain(*common.tensors(CPU, x),
                                     "native").numpy())


def test_p2_ties_and_wraps_in_edge_inputs():
    """The edge inputs hold each row's (column's) minimum four times, the
    int32 edges, and wrap in the first round."""
    rng = np.random.default_rng(1320)
    for kind in p3.P2_KINDS:
        x = _p2_input(rng, kind, "edges")
        y = x.T if kind == "subl" else x
        assert ((y == y.min(axis=1, keepdims=True)).sum(axis=1) >= 4).all()
        assert set(EDGES) <= set(x.reshape(-1).tolist())
        assert _first_wrap(x, kind) == 0


@pytest.mark.parametrize("case", ["script", "negative", "wraps"])
def test_p5_matches_jax(script, monkeypatch, capsys, case):
    (call,), lines = _load(script, monkeypatch, capsys, 1321, "p5")
    assert masked(lines) == P5_LINES
    x, = call["args"]
    assert x.shape == p3.P5_X
    want = call["r"]
    if case != "script":
        x = _p5_input(np.random.default_rng(1321), case)
        want = _run(call, x)
    got = p3.p5(*common.tensors(CPU, x))
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # every value got the same additions: sum(j < n) over the rounds' n
    trips = p3.p5_trips(int(x[0, 0]))
    added = sum(n * (n - 1) // 2 for n in trips)
    np.testing.assert_array_equal(want, _wrap(x.astype(np.int64) + added))
    assert len(trips) == p3.P5_ROUNDS and set(trips) <= {1, 2, 3, 4}
    if case == "negative":
        assert trips[0] == 4                    # -5 & 3 == 3
    if case == "wraps":
        assert (x.astype(np.int64) + added > I32_MAX).all()


@pytest.mark.parametrize("case", ["script", "random_w", "int32_x"])
def test_p6_matches_jax(script, monkeypatch, capsys, case):
    (call,), lines = _load(script, monkeypatch, capsys, 1322, "p6")
    assert masked(lines) == P6_LINES
    x, w = call["args"]
    assert x.shape == p3.P6_X and w.shape == p3.P6_W
    assert w.dtype == np.float32 and (w == 1).all()
    want = call["r"]
    rng = np.random.default_rng(1322)
    if case != "script":
        if case == "int32_x":
            x = rng.integers(I32_MIN, I32_MAX, x.shape,
                             endpoint=True).astype(np.int32)
        w = rng.standard_normal(w.shape).astype(np.float32)
        want = _run(call, x, w)
    got = p3.p6(*common.tensors(CPU, x), torch.tensor(w))
    assert got.dtype == torch.float32 and got.shape == (len(x), w.shape[1])
    if case == "script":
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy()[:, 0], x.sum(1))
        return
    xf = x.astype(np.float32).astype(np.float64)
    tol = 2 * x.shape[1] * 2.0**-24 * (np.abs(xf) @ np.abs(w.astype(
        np.float64)))
    assert (np.abs(got.numpy() - want) <= tol).all()
    assert (np.abs(got.numpy() - xf @ w.astype(np.float64)) <= tol).all()


def test_p6_sums_in_index_order():
    """The plain version adds the products in index order, one float32
    rounding each: 2^24 + 1 + 1 stays 2^24 in that order (summed the
    other way it would be 2^24 + 2)."""
    x = torch.tensor([[1 << 24, 1, 1]], dtype=torch.int32)
    w = torch.ones((3, 1), dtype=torch.float32)
    assert float(p3.p6(x, w)[0, 0]) == 2.0**24
    x = torch.tensor([[1, 1, 1 << 24]], dtype=torch.int32)
    assert float(p3.p6(x, w)[0, 0]) == 2.0**24 + 2


def _check_roll_src(host, rng):
    n = 4000
    words = rng.choice([1, 2, 32, 128, 96, 1000, 1 << 20], n)
    c = (rng.integers(0, 1 << 30, n) % words).astype(np.int32)
    sh = (rng.integers(0, 1 << 30, n) % words).astype(np.int32)
    c[:4], sh[:4], words[:4] = (0, 127, 0, 127), (127, 0, 0, 127), 128
    got, = _call(host.nabwa_host_probe_roll_src, 1, c, sh,
                 words.astype(np.int32))
    want = [np.roll(np.arange(w_), s_)[c_] if w_ <= 1000 else (c_ - s_) % w_
            for c_, s_, w_ in zip(c, sh, words)]
    return got, np.array(want)


def _check_p5_trips(host, rng):
    s = _i32(rng, 4000, [0, 1, 2, 3, 4, -1, -2, -3, -4, -5] + EDGES)
    got, = _call(host.nabwa_host_probe_p5_trips, 1, s)
    want = np.array([p3.p5_trips(int(v))[0] for v in s])
    np.testing.assert_array_equal(want, (s & 3) + 1)
    assert set(want[5:9]) == {4, 3, 2, 1}        # -1, -2, -3, -4
    return got, want


@pytest.mark.parametrize("name, check", [
    ("roll_src", _check_roll_src), ("p5_trips", _check_p5_trips)])
def test_host_helpers_match_plain(host, name, check):
    """csrc/probes.cuh `roll_src` (kernel C32's source word, which the
    output cannot check: `native` gives the same result) against np.roll,
    and `p5_trips` (C34) against the plain version's, value by value."""
    got, want = check(host, np.random.default_rng(1323 + len(name)))
    np.testing.assert_array_equal(got, want)


def test_p2_unknown_kind_refused():
    x = torch.zeros(p3.P2_X, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kind 'max'"):
        p3.p2(x, "max")
    with pytest.raises(ValueError, match="no kind 'max'"):
        p3.p2_cuda(_on_card(*p3.P2_X), "max")


def _zeros(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype)


def _floats_on_card(*shape):
    return _zeros(*shape, dtype=torch.float32).as_subclass(_OnCard)


@pytest.mark.parametrize("call", [
    lambda: p3.p2_cuda(_zeros(*p3.P2_X), "native"),
    lambda: p3.p2_cuda(_zeros(*p3.P2_X), "roll"),
    lambda: p3.p2_cuda(_zeros(*p3.P2_X), "subl"),
    lambda: p3.p5_cuda(_zeros(*p3.P5_X)),
    lambda: p3.p6_cuda(_zeros(*p3.P6_X), _zeros(*p3.P6_W,
                                                dtype=torch.float32)),
    lambda: p3.p5_witness_cuda(_zeros(*p3.P5_X))])
def test_kernels_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()


@pytest.mark.parametrize("call, match", [
    (lambda: p3.p2_cuda(_misaligned(*p3.P2_X), "native"),
     "not 16-byte aligned"),
    (lambda: p3.p2_cuda(_misaligned(*p3.P2_X), "subl"),
     "not 16-byte aligned"),
    (lambda: p3.p2_cuda(_on_card(256, 64), "native"), r"\[R, 128\]"),
    (lambda: p3.p2_cuda(_on_card(256, 256), "roll"), r"\[R, 128\]"),
    (lambda: p3.p2_cuda(_on_card(128, 128), "subl"), r"\[256, C\]"),
    (lambda: p3.p2_cuda(_on_card(256, 48), "subl"), "multiple of 32"),
    (lambda: p3.p2_cuda(_on_card(256 * 128), "native"), "1 dims"),
    (lambda: p3.p5_cuda(_misaligned(*p3.P5_X)), "not 16-byte aligned"),
    (lambda: p3.p5_witness_cuda(_on_card(512, 128)), "shared memory"),
    (lambda: p3.p6_cuda(_misaligned(*p3.P6_X), _floats_on_card(*p3.P6_W)),
     "not 16-byte aligned"),
    (lambda: p3.p6_cuda(_on_card(*p3.P6_X), _on_card(*p3.P6_W)),
     "expected torch.float32"),
    (lambda: p3.p6_cuda(_floats_on_card(*p3.P6_X),
                        _floats_on_card(*p3.P6_W)), "expected torch.int32"),
    (lambda: p3.p6_cuda(_on_card(512, 64), _floats_on_card(*p3.P6_W)),
     r"\[R, K\] and \[K, N\]"),
    (lambda: p3.p5_witness_cuda(_misaligned(*p3.P5_X)),
     "not 16-byte aligned"),
    (lambda: p3.p5_cuda(_on_card(256 * 128)), "1 dims, expected 2")])
def test_kernels_refuse_inputs(call, match):
    """A wrapper refuses what its kernel does not take, before any
    launch."""
    with pytest.raises(ValueError, match=match):
        call()


def _roll_input(rng, case):
    """int32 [256, 128] for the lane form's host test: the edge inputs of
    `_p2_input`, or "argmin_words": row r's minimum, unique, at word r mod
    128, so that across the rows it sits once in each lane and register
    of both halves."""
    if case != "argmin_words":
        return _p2_input(rng, "roll", case)
    x = rng.integers(-2**20, I32_MAX, p3.P2_X, endpoint=True)
    rows = np.arange(len(x))
    x[rows, rows % 128] = I32_MIN + rng.integers(0, 8, len(x))
    x[rows, (rows + 1) % 128] = I32_MIN + 8             # the runner-up
    return x.astype(np.int32)


def _host_roll_lanes(host, x, rounds):
    fn = host.nabwa_host_probe_p2_roll_lanes
    fn.argtypes = [_P, _I, _I, _P, _P]
    fn.restype = _I
    m, out = np.full_like(x, 7), np.full_like(x, 7)
    assert fn(x.ctypes.data_as(_P), len(x), rounds, m.ctypes.data_as(_P),
              out.ctypes.data_as(_P)) == 0
    return m, out


@pytest.mark.parametrize("case", ["script", "edges", "high", "argmin_words"])
def test_host_p2_roll_lane_form_matches(script, monkeypatch, capsys, host,
                                        case):
    """Kernel C32's lane form played lane by lane on the host
    (`p2_lane_min` and `p2_roll_lane` of csrc/probes.cuh, built by g++):
    the first round's minimum of every word equals `p2_min(v, "roll")`,
    the script's seven rotations, and the 50 rounds equal the plain
    version and the JAX script's `roll` kind exactly: at the script's
    input, at int32 edges with each row's minimum repeated (ties), at
    every value near INT32_MAX (the sums wrap) and with each row's unique
    minimum in turn at each of the 128 words."""
    seen, _ = _load(script, monkeypatch, capsys, 1320, "p2")
    call = seen[p3.P2_KINDS.index("roll")]
    x, = call["args"]
    want = call["r"]
    if case != "script":
        x = _roll_input(np.random.default_rng(1324), case)
        want = _run(call, x)
    if case == "argmin_words":
        argmin = x.argmin(axis=1)
        assert set(argmin.tolist()) == set(range(128))
        assert ((x == x.min(axis=1, keepdims=True)).sum(axis=1) == 1).all()
    m, out = _host_roll_lanes(host, np.ascontiguousarray(x, np.int32),
                              p3.P2_ROUNDS)
    x_t, = common.tensors(CPU, x)
    np.testing.assert_array_equal(m, p3.p2_min(x_t.long(), "roll").numpy())
    np.testing.assert_array_equal(m, np.broadcast_to(
        x.min(axis=1, keepdims=True), x.shape))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, p3.p2_plain(x_t, "roll").numpy())


def test_host_p2_roll_lanes_agree_by_construction(host):
    """After `p2_lane_min` every word of a lane holds one value, so a
    rotation by sh < 32 takes it from lane (L - sh) mod 32 whatever the
    word: `p2_roll_lane` is the lane of `roll_src` for every word, shift
    and lane, and one round of the lane form on rows of distinct values
    equals the seven literal rotations of `p2_min`."""
    rng = np.random.default_rng(1325)
    c = np.repeat(np.arange(128, dtype=np.int32), 5)
    sh = np.tile(np.array([16, 8, 4, 2, 1], dtype=np.int32), 128)
    src, = _call(host.nabwa_host_probe_roll_src, 1, c, sh,
                 np.full_like(c, 128))
    np.testing.assert_array_equal(src % 32, (c % 32 - sh) % 32)
    x = np.stack([rng.permutation(1 << 20)[:128] - (1 << 19)
                  for _ in range(32)]).astype(np.int32)
    m, out = _host_roll_lanes(host, x, 1)
    np.testing.assert_array_equal(m, p3.p2_min(torch.from_numpy(x).long(),
                                               "roll").numpy())
    np.testing.assert_array_equal(out, x + m)


def _p6_staged(host, x, w, kt):
    fn = host.nabwa_host_probe_p6_staged
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    out = np.full((x.shape[0], w.shape[1]), np.nan, dtype=np.float32)
    rc = fn(x.ctypes.data_as(_P), w.ctypes.data_as(_P), x.shape[0],
            x.shape[1], w.shape[1], kt, out.ctypes.data_as(_P))
    return rc, out


# [R, K, N] of the staged form's host test beside the script's: a tile's
# tail (K 130, 260), K not a multiple of 4 (130, 37, 3), N not a multiple
# of 4 (5, 17, 3) or leaving half a block's columns (12), R leaving a
# block's rows, two whole tiles (256), K 0 and 1
P6_HOST_SHAPES = [(7, 130, 5), (9, 260, 12), (6, 256, 16), (13, 37, 17),
                  (5, 3, 3), (4, 0, 8), (3, 1, 9), (12, 128, 4)]


@pytest.mark.parametrize("shape", [p3.P6_X + p3.P6_W[1:]] + P6_HOST_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kt", [128, 8, 4])
def test_host_p6_staged_form_bit_for_bit(script, monkeypatch, capsys, host,
                                         shape, kt):
    """Kernel C35's staged form played block by block on the host
    (`p6_stage`, then `p6_dot` of csrc/probes.cuh, built by g++), its
    tiles of K 128 words as the kernel's and of 8 to walk many tiles (a
    tail tile staged with zeros past K): bit for bit the
    plain version at x over int32 and a random float32 w, and at the
    script's inputs (w of ones) also the JAX script's result, column 0
    x's row sums."""
    r, k, n = shape
    rng = np.random.default_rng(1326 + r + k + n)
    x = rng.integers(I32_MIN, I32_MAX, (r, k), endpoint=True).astype(
        np.int32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    rc, got = _p6_staged(host, x, w, kt)
    assert rc == 0
    want = p3.p6_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if shape[:2] != p3.P6_X:
        return
    (call,), _ = _load(script, monkeypatch, capsys, 1322, "p6")
    x, w = call["args"]
    rc, got = _p6_staged(host, x, w, kt)
    assert rc == 0
    np.testing.assert_array_equal(got, call["r"])
    np.testing.assert_array_equal(got[:, 0], x.sum(1))


def test_host_p6_staged_refuses_tile(host):
    """The host's staged form is built for tiles of 128 (the kernel's), 8
    and 4 words only, and refuses another."""
    x, w = np.zeros((4, 8), np.int32), np.zeros((8, 8), np.float32)
    for kt in (0, 2, 6, 16, -4):
        assert _p6_staged(host, x, w, kt)[0] == -1
    assert _p6_staged(host, x, w, 4)[0] == 0


# C31's, C32's (the lane form and the witness), C33's and C35's wrappers:
# the call on (x, w), the name of its launch counter, and the arguments
# its launch takes between x's pointer and the output's (w's pointer
# first for C35)
_WRAPPERS = {
    "c31": (lambda x, w=None: p3.p2_cuda(x, "native"), "launches_p2_native"),
    "c32_lane": (lambda x, w=None: p3.p2_cuda(x, "roll"), "launches_p2_roll"),
    "c32_witness": (lambda x, w=None: p3.p2_roll_witness_cuda(x),
                    "launches_p2_roll_witness"),
    "c33": (lambda x, w=None: p3.p2_cuda(x, "subl"), "launches_p2_subl"),
    "c35": (lambda x, w: p3.p6_cuda(x, w), "launches_p6")}
_KIND = {"c31": "native", "c32_lane": "roll", "c32_witness": "roll",
         "c33": "subl"}
_GOOD_X = {"c31": (256, 128), "c32_lane": (256, 128),
           "c32_witness": (256, 128), "c33": (256, 64), "c35": p3.P6_X}
# x by form, then w by form for C35 (x good)
_X_FORMS = {"good": lambda shape: _on_card(*shape),
            "cpu": lambda shape: _zeros(*shape),
            "int64": lambda shape: _on_card(*shape).long(),
            "float": lambda shape: _floats_on_card(*shape),
            "dims": lambda shape: _on_card(shape[0] * shape[1]),
            "transposed": lambda shape: _on_card(*shape[::-1]).t(),
            "column": lambda shape: _on_card(shape[0], shape[1] + 4)[:, 4:],
            "misaligned": lambda shape: _misaligned(*shape),
            "cuda1": lambda shape: _zeros(*shape).as_subclass(_OnCard1),
            "narrow": lambda shape: _on_card(shape[0], 64),
            "short": lambda shape: _on_card(128, shape[1]),
            "odd": lambda shape: _on_card(shape[0], 48)}
_W_FORMS = {"cpu": lambda: _zeros(*p3.P6_W, dtype=torch.float32),
            "int32": lambda: _on_card(*p3.P6_W),
            "dims": lambda: _floats_on_card(p3.P6_W[0] * p3.P6_W[1]),
            "transposed": lambda: _floats_on_card(*p3.P6_W[::-1]).t(),
            "misaligned": lambda: _misaligned(*p3.P6_W).view(torch.float32),
            "cuda1": lambda: _zeros(*p3.P6_W, dtype=torch.float32)
            .as_subclass(_OnCard1),
            "depth": lambda: _floats_on_card(64, 8)}
# x and w past what C35's launch takes: rows of 2^31 and more, columns of
# 2^31 and more, sides below 2^31 but 2^31 blocks (2^28 of rows x 8 of
# columns); empty, so that nothing is allocated
_HUGE = {"rows": ((2**33, 0), (0, 8)), "cols": ((4, 0), (0, 2**31)),
         "blocks": ((2**30, 0), (0, 64))}


def _old_checks(form, x, w):
    """The message of the first check one at a time that refuses the
    inputs (None if all pass): `common.cuda_input` on x, then for C35 on
    w (float32, x's device), then the shape: 128 columns for C31 and
    C32, 256 rows and columns a multiple of 32 for C33, the depths for
    C35, then C35's blocks."""
    try:
        dev = common.cuda_input(x, "x", 2)
        if form == "c35":
            common.cuda_input(w, "w", 2, dev, torch.float32)
    except ValueError as err:
        return str(err)
    rows, cols = x.shape
    kind = _KIND.get(form)
    if kind == "subl" and (rows != 256 or cols % 32):
        return (f"x must be [256, C] with C a multiple of 32 for `subl`, "
                f"got {tuple(x.shape)}")
    if kind in ("native", "roll") and cols != 128:
        return f"x must be [R, 128] for `{kind}`, got {tuple(x.shape)}"
    if form == "c35":
        if w.shape[0] != cols:
            return (f"x and w must be [R, K] and [K, N], got "
                    f"{tuple(x.shape)} and {tuple(w.shape)}")
        width = w.shape[1]
        if max(rows, cols, width) >= 2**31 or \
                -(-rows // 4) * -(-width // 8) >= 2**31:
            return (f"C35 takes at most {2**31 - 1} blocks of 4 x 8 out "
                    f"elements and sides below 2^31, got x "
                    f"{tuple(x.shape)} and w {tuple(w.shape)}")
    return None


_REFUSAL_CASES = (
    [(form, xf, "good") for form in _WRAPPERS for xf in _X_FORMS
     if not (form == "c35" and xf in ("narrow", "short", "odd"))]
    + [("c35", "good", wf) for wf in _W_FORMS]
    + [("c35", "huge", h) for h in _HUGE])


@pytest.mark.parametrize("form, x_form, w_form", _REFUSAL_CASES)
def test_c32_c35_refuse_in_order(form, x_form, w_form, monkeypatch):
    """C31's, C32's (both forms), C33's and C35's wrappers refuse what
    their checks one at a time refused, with the same message and in the
    same order: x (CUDA, dtype, dims, contiguity, 16-byte alignment),
    C35's w (the same, float32, on x's card), then the shape (and C35's
    blocks of a launch); before anything is built or launched, every
    count unchanged.  What passes asks for the library."""
    _no_build(monkeypatch)
    call, _ = _WRAPPERS[form]
    if x_form == "huge":
        xs, ws = _HUGE[w_form]
        x = _on_card(*xs)
        w = _floats_on_card(*ws)
    else:
        x = _X_FORMS[x_form](_GOOD_X[form])
        w = (_W_FORMS[w_form]() if w_form != "good"
             else _floats_on_card(*p3.P6_W))
    want = _old_checks(form, x, w)
    before = {name: getattr(p3, name) for _, name in _WRAPPERS.values()}
    if want is None:
        with pytest.raises(AssertionError, match="library was asked"):
            call(x, w)
    else:
        with pytest.raises(ValueError) as err:
            call(x, w)
        assert str(err.value) == want
    assert {name: getattr(p3, name) for _, name in _WRAPPERS.values()} == \
        before
    takes = (x_form == w_form == "good"
             or x_form == "cuda1" and form != "c35"
             or x_form == "narrow" and form == "c33"
             or x_form == "short" and form not in ("c33", "c35"))
    assert (want is None) == takes, want


@pytest.mark.parametrize("form", list(_WRAPPERS))
def test_c32_c35_launch_on_pointers_read_once(form, fake_launch,
                                              monkeypatch):
    """C31's, C32's (both forms), C33's and C35's wrappers launch on the
    pointers and device index read once by their one check pass (`device`
    never), the output's pointer read once, the stream of that index (of
    index 1 on the second card): C31-C33 on x's rows, columns and kind,
    C32's witness on its rows, C35 on w's pointer and the three sides; an
    output of the right shape and dtype; the count rises by one a
    launch."""
    from collections import Counter
    monkeypatch.setattr(_Counted, "reads", Counter())
    call, count = _WRAPPERS[form]
    rows, cols = _GOOD_X[form]
    x = _zeros(rows, cols).as_subclass(_Counted)
    w = _zeros(*p3.P6_W, dtype=torch.float32).as_subclass(_Counted)
    before = getattr(p3, count)
    out = call(x, w)
    inputs = (x, w) if form == "c35" else (x,)
    assert _Counted.reads == Counter(
        {(k, id(t)): 1 for k in ("data_ptr", "get_device") for t in inputs}
        | {("data_ptr", id(out)): 1})
    args = {"c35": (w.data_ptr(), rows, cols, p3.P6_W[1]),
            "c32_witness": (rows,)}.get(form, (rows, cols, p3.P2_KINDS.index(
                _KIND.get(form, "native"))))
    assert fake_launch.calls[-1] == (x.data_ptr(), *args, out.data_ptr(),
                                     1000)
    shape = (rows, p3.P6_W[1]) if form == "c35" else (rows, cols)
    assert out.shape == shape and out.is_contiguous()
    assert out.dtype == (torch.float32 if form == "c35" else torch.int32)
    one = _zeros(rows, cols).as_subclass(_OnCard1)
    call(one, _zeros(*p3.P6_W, dtype=torch.float32).as_subclass(_OnCard1))
    assert fake_launch.calls[-1][-1] == 1001
    assert getattr(p3, count) == before + 2


@pytest.mark.parametrize("form, shape", [
    ("c31", (0, 128)), ("c32_lane", (0, 128)), ("c32_witness", (0, 128)),
    ("c33", (256, 0)), ("c35", (0, 128)), ("c35", (4, 0))])
def test_c32_c35_empty_launch_nothing(form, shape, fake_launch):
    """No out elements: an empty output of the right shape, no launch, no
    count (C35 with no rows, or with w of no columns)."""
    call, count = _WRAPPERS[form]
    before = getattr(p3, count)
    width = 0 if shape == (4, 0) else p3.P6_W[1]
    x = _on_card(*shape) if shape != (4, 0) else _on_card(4, 128)
    got = call(x, _floats_on_card(128, width))
    assert got.shape == ((x.shape[0], width) if form == "c35" else shape)
    assert not fake_launch.calls
    assert getattr(p3, count) == before


@pytest.mark.parametrize("form", list(_WRAPPERS))
def test_c32_c35_count_exact_under_threads(form, fake_launch):
    """Four threads launching one wrapper together, the interpreter
    switching threads every microsecond: its count rises by exactly the
    launches made."""
    call, count = _WRAPPERS[form]
    x = _on_card(*_GOOD_X[form])
    w = _floats_on_card(*p3.P6_W)
    before = getattr(p3, count)
    made = _launch_from_threads(lambda: call(x, w), threads=4)
    assert getattr(p3, count) - before == made == len(fake_launch.calls)
