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
value.  The wrappers refuse CPU tensors, misaligned inputs, other dtypes
and shapes their kernels do not take (C34's witness, an s past one
block's shared memory), and an unknown kind.
"""

import numpy as np
import pytest
import torch

from nabwa_tpu_torch.probes import common
from nabwa_tpu_torch.probes import probe_pallas3 as p3

# fixtures and helpers shared with the other probe ports' tests
from .test_torch_probe_pallas import _misaligned, _on_card, _OnCard
from .test_torch_probe_pallas3 import (CPU, EDGES, I32_MAX, I32_MIN, _load,
                                       _p5_input, _run)
from .test_torch_probe_spill import masked
from .test_torch_probes import _call, _i32, host, one_torch_thread  # noqa: F401
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
