"""The port of scripts/probe_spill.py (`nabwa_tpu_torch.probes.probe_spill`)
against the JAX script on the CPU.

The script reads K and T from the environment and runs its four shapes
when it is loaded, so each case sets both with `monkeypatch.setenv`, loads
it in Pallas interpret mode and keeps its printed lines.  The plain version
must equal the script's jitted `make(shape, K)` exactly (int32) at every
shape and K 1, 2 and 24 at a small T, and at the script's T = 2000 on
[64, 1]: on the script's zeros, on seeded random int32 and on values
within 8 of INT32_MAX and INT32_MIN (where x + i and the sums wrap).
Kernel C23's loop order (in place, index order, the old v_0 saved for the
last value) is run on the host with its `spill_update` helper built by
g++ and must equal the plain version too; without the saved v_0 it must
not.  C23's lane form (csrc/probes.cuh `spill_lane_init`,
`spill_next_lane`, `spill_lane_round`, `spill_lane_sum`) is played on the
host lane by lane, an array read in place of the shuffle
(`nabwa_host_probe_spill_lanes`), and must equal the plain version at
every K of SPILL_KS over groups of 1, 2, 4 and 8 lanes (those dividing
K), T 0, 1, 3 and 17, on seeded and int32-edge inputs.  The lists of K
and M the kernels are built for match the source, and the lane form's
choice of group is one it is built for.  The entry point prints the
script's lines; a K that C23 is not built for, a missing card, CPU
tensors and a misaligned input are refused.  (The wrappers' launch path
is held on fake card tensors in tests/test_torch_probe_pallas3.py.)
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

from nabwa_tpu_torch.ops import _build
from nabwa_tpu_torch.probes import common
from nabwa_tpu_torch.probes import probe_spill as ps

# fixtures and helpers shared with the other probe ports' tests: the script
# loader (interpret mode), one torch thread, the host harness; tensors that
# say they lie on the card
from .test_torch_probe_pallas import _misaligned, _on_card
from .test_torch_probes import (_I, _P, _call, _i32, _t,  # noqa: F401
                                host, one_torch_thread, script)

REPO = ps.__file__.rsplit("/nabwa_tpu_torch/", 1)[0]
CPU = torch.device("cpu")
I32_MAX, I32_MIN = 2**31 - 1, -2**31
SMALL_T = 7


def masked(lines):
    """Result lines with their measured numbers replaced by '#'."""
    return [re.sub(r"\s*\d+\.\d+", "#", ln) for ln in lines]


def _load(script, monkeypatch, capsys, k, t):
    """Load scripts/probe_spill.py with K=k, T=t; returns (the module, the
    lines it printed)."""
    monkeypatch.setenv("K", str(k))
    monkeypatch.setenv("T", str(t))
    mod = script("probe_spill")
    assert (mod.K, mod.T) == (k, t)
    return mod, capsys.readouterr().out.splitlines()


def _inputs(shape, seed):
    """The script's zeros, and one input of the shape holding int32 edges
    (within 8 of both ends, 0, -1) and seeded random int32."""
    rng = np.random.default_rng(seed)
    mixed = rng.integers(I32_MIN, I32_MAX, shape, endpoint=True)
    edges = ([I32_MAX - d for d in range(8)] + [I32_MIN + d for d in range(8)]
             + [0, -1])
    flat = mixed.reshape(-1)
    n = min(len(flat), len(edges))
    flat[:n] = edges[:n]
    return {"script": np.zeros(shape, np.int32),
            "edges_random": mixed.astype(np.int32)}


def _jax(mod, shape, k, x):
    return np.asarray(jax.jit(mod.make(shape, k))(jnp.asarray(x)))


@pytest.mark.parametrize("k", [1, 2, 24])
def test_spill_matches_jax(script, monkeypatch, capsys, k):
    mod, lines = _load(script, monkeypatch, capsys, k, SMALL_T)
    assert len(lines) == len(ps.SHAPES)
    for shape in ps.SHAPES:
        for name, x in _inputs(shape, 1100 + k).items():
            want = _jax(mod, shape, k, x)
            got = ps.spill(*common.tensors(CPU, x), k, SMALL_T)
            assert got.dtype == torch.int32 and got.shape == shape
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{shape} {name}")


def test_spill_matches_jax_at_script_t(script, monkeypatch, capsys):
    """The script's defaults, K=24 and T=2000, on [64, 1]."""
    mod, _ = _load(script, monkeypatch, capsys, ps.DEFAULT_K, ps.DEFAULT_T)
    shape = (64, 1)
    for name, x in _inputs(shape, 1199).items():
        want = _jax(mod, shape, ps.DEFAULT_K, x)
        got = ps.spill(*common.tensors(CPU, x), ps.DEFAULT_K, ps.DEFAULT_T)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _host_rounds(host, x, k, t, save_v0=True):
    """Kernel C23's loop on the host: `spill_update` (probes.cuh, g++) in
    place in index order, the last value's neighbour the saved old v_0
    (or, with save_v0 False, the new one)."""
    v = [(x.astype(np.int64) + i).astype(np.uint32).view(np.int32)
         for i in range(k)]
    for _ in range(t):
        v0 = v[0]
        for i in range(k - 1):
            v[i], = _call(host.nabwa_host_probe_spill_update, 1, v[i],
                          v[i + 1])
            v[i] = v[i].astype(np.int32)
        nxt = v0 if save_v0 else v[0]
        v[k - 1], = _call(host.nabwa_host_probe_spill_update, 1, v[k - 1],
                          nxt)
        v[k - 1] = v[k - 1].astype(np.int32)
    return np.sum(np.stack(v).astype(np.int64), axis=0).astype(
        np.uint32).view(np.int32)


@pytest.mark.parametrize("k", [1, 2, 5, 24])
def test_kernel_loop_order_on_host(host, k):
    x = _inputs((300,), 1150 + k)["edges_random"]
    want = ps.spill_plain(*common.tensors(CPU, x), k, SMALL_T).numpy()
    np.testing.assert_array_equal(_host_rounds(host, x, k, SMALL_T), want)
    # the trap: without the saved v_0 the last value is wrong at K >= 2
    wrong = _host_rounds(host, x, k, SMALL_T, save_v0=False)
    assert np.array_equal(wrong, want) == (k == 1)


def test_host_spill_update_matches_plain(host):
    """csrc/probes.cuh `spill_update` (kernel C23), built for the host,
    equals the plain update value by value."""
    rng = np.random.default_rng(1130)
    v = _i32(rng, 4000)
    nxt = _i32(rng, 4000)[::-1].copy()
    got, = _call(host.nabwa_host_probe_spill_update, 1, v, nxt)
    want = common.wrap32(_t(v) * 3 + 1) ^ (_t(nxt) >> 2)
    np.testing.assert_array_equal(got, want.numpy())


# (K, L): every K of SPILL_KS over every group of 1, 2, 4 or 8 lanes that
# divides it
_LANE_CASES = [(k, n) for k in ps.SPILL_KS for n in ps.LANES if k % n == 0]


def _host_lanes(host, x, k, lanes, t):
    """(the harness's return code, out) of C23's lane form played on the
    host over x."""
    fn = host.nabwa_host_probe_spill_lanes
    fn.argtypes = [_P, _I, _I, _I, _I, _P]
    fn.restype = _I
    out = np.full_like(x, 7)
    rc = fn(x.ctypes.data_as(_P), len(x), k, lanes, t,
            out.ctypes.data_as(_P))
    return rc, out


@pytest.mark.parametrize("t", [0, 1, 3, 17])
@pytest.mark.parametrize("k, lanes", _LANE_CASES)
def test_host_lane_form_matches_plain(host, k, lanes, t):
    """C23's lane form, each group played lane by lane on the host (the
    kernel's per-lane round and group exchange from probes.cuh, an array
    read in place of the shuffle), equals the plain version exactly on
    int32 edges and seeded int32."""
    x = _inputs((40,), 1160 + k + lanes)["edges_random"]
    assert {I32_MAX, I32_MIN, 0, -1} <= set(x.tolist())
    rc, out = _host_lanes(host, x, k, lanes, t)
    assert rc == 0
    want = ps.spill_plain(*common.tensors(CPU, x), k, t).numpy()
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("k, lanes", [(24, 3), (24, 16 * 3), (2, 4),
                                      (1, 2), (24, 0)])
def test_host_lane_form_refuses_groups(host, k, lanes):
    """A group that is not a power of two or does not divide K is refused,
    nothing written."""
    x = _inputs((8,), 1170)["edges_random"]
    rc, out = _host_lanes(host, x, k, lanes, 3)
    assert rc != 0 and (out == 7).all()


def test_spill_ms_match_the_kernel():
    """SPILL_MS is the list of M csrc/probe_spill.cu instantiates its lane
    form for; `default_lanes` picks, for every K of SPILL_KS and element
    counts from 1 to a million, a group of 1, 2, 4 or 8 lanes that divides
    K with K / L built and at least 3 values a lane (or one lane); at the
    script's K the small shapes take 8 lanes and [64, 128] takes 2 (a
    warp for each of the card's schedulers), and K 1 and 2 one lane."""
    src = (_build.CSRC / "probe_spill.cu").read_text()
    body = src.split("#define SPILL_MS(X)", 1)[1].split("\n\n", 1)[0]
    ms = tuple(int(m) for m in re.findall(r"X\((\d+)\)", body))
    assert ms == ps.SPILL_MS
    for k in ps.SPILL_KS:
        for n in (1, 64, 128, 1024, 2112, 2113, 8192, 10**6):
            lanes = ps.default_lanes(k, n)
            assert lanes in ps.LANES and k % lanes == 0, (k, n)
            assert k // lanes in ps.SPILL_MS, (k, n)
            assert lanes == 1 or k // lanes >= 3, (k, n)
            ps.check_lanes(k, lanes)
    assert [ps.default_lanes(24, r * c) for r, c in ps.SHAPES] == [8, 8, 8,
                                                                   2]
    assert ps.default_lanes(24, 2112) == 8 and ps.default_lanes(24, 2113) == 4
    assert ps.default_lanes(1, 8192) == ps.default_lanes(2, 8192) == 1
    assert ps.default_lanes(128, 8192) == 4


@pytest.mark.parametrize("k, lanes", [(24, 16), (24, 3), (24, 1), (256, 4),
                                      (64, 1), (320, 4)])
def test_lanes_outside_the_built_groups_are_refused(k, lanes):
    """The lane form refuses a group it is not built for (an L not among
    1, 2, 4, 8, or K / L not in SPILL_MS), before anything is built."""
    with pytest.raises(ValueError, match="lane form is not built for"):
        ps.check_lanes(k, lanes)


def test_spill_ks_match_the_kernel():
    """SPILL_KS is the list csrc/probe_spill.cu instantiates: it holds 1,
    2, the script's default 24, and K past ptxas's 255 registers."""
    src = (_build.CSRC / "probe_spill.cu").read_text()
    body = src.split("#define SPILL_KS(X)", 1)[1].split("\n\n", 1)[0]
    ks = tuple(int(k) for k in re.findall(r"X\((\d+)\)", body))
    assert ks == ps.SPILL_KS
    assert {1, 2, ps.DEFAULT_K} <= set(ks) and max(ks) > 255


def test_entry_point_cpu(script, monkeypatch, capsys):
    """The port's lines are the script's, numbers aside."""
    _, want = _load(script, monkeypatch, capsys, 2, 5)
    env = dict(os.environ, K="2", T="5", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "nabwa_tpu_torch.probes.probe_spill",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert masked(lines) == masked(want)
    assert masked(lines)[0] == "(64, 1)    K=2# ms# us/iter"


@pytest.mark.parametrize("k", [0, 3, 25, 1000])
def test_k_outside_the_kernels_set_is_refused(k, monkeypatch, capsys):
    monkeypatch.setenv("K", str(k))
    monkeypatch.setenv("T", "3")
    assert ps.main(["--device", "cpu"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert f"K={k} is not one of the K kernel C23 is built for: 1, 2" in \
        captured.err
    with pytest.raises(ValueError, match="C23 is built for"):
        ps.spill_cuda(_on_card(64, 1), k, 3)


def test_entry_point_needs_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ps.main(["--device", "cuda"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ps.spill_cuda(torch.zeros((64, 1), dtype=torch.int32), 24, 3)


def test_kernel_refuses_misaligned_input():
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        ps.spill_cuda(_misaligned(64, 128), 24, 3)
