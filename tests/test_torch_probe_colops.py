"""The port of scripts/probe_colops.py (`nabwa_tpu_torch.probes.
probe_colops`) against the JAX script on the CPU.

The script reads T and K from the environment and runs its five shapes
when it is loaded, so each case sets both with `monkeypatch.setenv`, loads
it in Pallas interpret mode and keeps its printed lines.  The plain version
must equal the script's jitted `make(shape)` exactly (int32) at every
shape at a small T, and at the script's T = 2000 and K = 64 on [64, 1]:
on the script's zeros, and on one input of seeded random int32 with values
within 8 of INT32_MAX and INT32_MIN (where v * 3 + 1 wraps) and 0 and -1
(at T = 2000 that input alone: the op is elementwise, so its 0 runs the
script's zeros' chain).
Kernel C24's step, `colops_step` of csrc/probes.cuh built by g++, equals
the plain step value by value.  The entry point prints the script's lines;
T or K below 1, a missing card, CPU tensors and a misaligned input are
refused.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabwa_tpu_torch.probes import common
from nabwa_tpu_torch.probes import probe_colops as pc

# fixtures and helpers shared with the other probe ports' tests
from .test_torch_probe_pallas import _misaligned, _on_card
from .test_torch_probe_spill import _inputs, masked
from .test_torch_probes import (_call, _i32, _t, host,  # noqa: F401
                                one_torch_thread, script)

REPO = pc.__file__.rsplit("/nabwa_tpu_torch/", 1)[0]
CPU = torch.device("cpu")


def _load(script, monkeypatch, capsys, t, k):
    """Load scripts/probe_colops.py with T=t, K=k; returns (the module, the
    lines it printed)."""
    monkeypatch.setenv("T", str(t))
    monkeypatch.setenv("K", str(k))
    mod = script("probe_colops")
    assert (mod.T, mod.K) == (t, k)
    return mod, capsys.readouterr().out.splitlines()


def _check(mod, shape, t, k, inputs):
    for name, x in inputs.items():
        want = np.asarray(jax.jit(mod.make(shape))(jnp.asarray(x)))
        got = pc.colops(*common.tensors(CPU, x), t, k)
        assert got.dtype == torch.int32 and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{shape} {name}")


@pytest.mark.parametrize("t, k", [(3, pc.DEFAULT_K), (2, 5)])
def test_colops_matches_jax(script, monkeypatch, capsys, t, k):
    mod, lines = _load(script, monkeypatch, capsys, t, k)
    assert len(lines) == len(pc.SHAPES)
    for shape in pc.SHAPES:
        _check(mod, shape, t, k, _inputs(shape, 1200 + k))


def test_colops_matches_jax_at_script_t(script, monkeypatch, capsys):
    """The script's defaults, T=2000 and K=64, on [64, 1]: one input whose
    elements are the edges (0 among them, each element being the script's
    zeros' own chain) and random values."""
    mod, _ = _load(script, monkeypatch, capsys, pc.DEFAULT_T, pc.DEFAULT_K)
    x = _inputs((64, 1), 1299)["edges_random"]
    assert (x == 0).any()
    _check(mod, (64, 1), pc.DEFAULT_T, pc.DEFAULT_K, {"mixed": x})


def test_host_colops_step_matches_plain(host):
    """csrc/probes.cuh `colops_step` (kernel C24), built for the host,
    equals the plain step value by value."""
    v = _i32(np.random.default_rng(1230), 4000)
    got, = _call(host.nabwa_host_probe_colops_step, 1, v)
    np.testing.assert_array_equal(got, pc.colops_step(_t(v)).numpy())


def test_entry_point_cpu(script, monkeypatch, capsys):
    """The port's lines are the script's, numbers aside."""
    _, want = _load(script, monkeypatch, capsys, 3, 4)
    env = dict(os.environ, T="3", K="4", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "nabwa_tpu_torch.probes.probe_colops",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert masked(lines) == masked(want)
    assert masked(lines)[-1] == "(64, 256)# ms# ns/op"


@pytest.mark.parametrize("t, k", [(0, 64), (2000, 0), (-1, 3)])
def test_t_or_k_below_one_is_refused(t, k, monkeypatch, capsys):
    monkeypatch.setenv("T", str(t))
    monkeypatch.setenv("K", str(k))
    assert pc.main(["--device", "cpu"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "T and K must be at least 1" in captured.err


def test_entry_point_needs_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pc.main(["--device", "cuda"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        pc.colops_cuda(torch.zeros((64, 1), dtype=torch.int32), 3, 4)


def test_kernel_refuses_misaligned_input():
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        pc.colops_cuda(_misaligned(8, 128), 3, 4)
    with pytest.raises(ValueError, match="int32"):
        pc.colops_cuda(_on_card(8, 128).long(), 3, 4)
