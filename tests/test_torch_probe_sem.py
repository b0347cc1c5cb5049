"""The port of scripts/probe_sem.py (`nabwa_tpu_torch.probes.probe_sem`)
against the JAX script on the CPU.

The script reads K from the environment when it is loaded, so each case
sets K with `monkeypatch.setenv` first, then loads the script in Pallas
interpret mode and runs its `main`, recording what its `pallas_call`
returned.  The plain version must equal that output exactly at K = 1, 4
and 16: interpret mode lands every copy as it is issued, so out = [128 K,
..., 128, 0, INT32_MIN], the last word never written.  The stage, which
the output does not show, is held to a numpy model of the copies.  The
entry point with `--device cpu` prints the script's line, byte for byte;
K outside 1..16 (the script's K=17 fails), a missing card, a CPU tensor
given to the kernel's wrapper and a table off a 16-byte boundary are
refused.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nabwa_tpu_torch.probes import common
from nabwa_tpu_torch.probes import probe_sem as psem

# fixtures and helpers shared with the other probe ports' tests: the script
# loader (interpret mode), one torch thread; a tensor that says it lies
# on the card, off a 16-byte boundary
from .test_torch_probe_pallas import _misaligned, _on_card
from .test_torch_probes import one_torch_thread, script  # noqa: F401

REPO = psem.__file__.rsplit("/nabwa_tpu_torch/", 1)[0]
CPU = torch.device("cpu")
I32_MIN = -2**31


def _run_script(script, monkeypatch, k):
    """Load scripts/probe_sem.py with K=k, its pallas_call recording the
    kernel's inputs and output; returns (the module, what was recorded)."""
    monkeypatch.setenv("K", str(k))
    mod = script("probe_sem")
    interpret = pl.pallas_call
    seen = {}

    def recording(*args, **kw):
        call = interpret(*args, **kw)

        def run(*inputs):
            r = call(*inputs)
            seen.update(inputs=[np.asarray(a) for a in inputs],
                        r=np.asarray(r))
            return r
        return run
    monkeypatch.setattr(pl, "pallas_call", recording)
    return mod, seen


def _numpy_stage(table, k):
    stage = np.full((psem.SEM_ROWS, psem.ROW_WORDS), I32_MIN, np.int64)
    stage[:k] = table[:k]
    return stage


@pytest.mark.parametrize("k", [1, 4, 16])
def test_sem_matches_jax(script, monkeypatch, capsys, k):
    mod, seen = _run_script(script, monkeypatch, k)
    assert mod.K == k
    mod.main()
    line = capsys.readouterr().out
    table, = seen["inputs"]
    assert table.shape == (psem.SEM_ROWS, psem.ROW_WORDS)
    want = seen["r"]
    assert want.shape == (k + 2,) and want.dtype == np.int32
    np.testing.assert_array_equal(
        want, [128 * (k - w) for w in range(k + 1)] + [I32_MIN])

    out, stage = psem.sem(*common.tensors(CPU, table), k)
    assert out.dtype == stage.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(stage.numpy(), _numpy_stage(table, k))

    # the port's entry point prints the script's line, byte for byte
    monkeypatch.setenv("K", str(k))
    assert psem.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == line


def test_script_refuses_k17(script, monkeypatch):
    """The script's table has 16 rows: at K=17 its kernel fails, so the
    port refuses K=17 (and 0) before any launch."""
    mod, seen = _run_script(script, monkeypatch, 17)
    with pytest.raises(Exception):
        mod.main()
    assert "r" not in seen


@pytest.mark.parametrize("k", [0, 17])
def test_sem_refuses_k(k, monkeypatch, capsys):
    table, = common.tensors(CPU, np.zeros((psem.SEM_ROWS, psem.ROW_WORDS)))
    with pytest.raises(ValueError, match="1..16"):
        psem.sem(table, k)
    with pytest.raises(ValueError, match="1..16"):
        psem.sem_cuda(_on_card(psem.SEM_ROWS, psem.ROW_WORDS), k)
    monkeypatch.setenv("K", str(k))
    assert psem.main(["--device", "cpu"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert f"K must lie in 1..16, got {k}" in captured.err


def test_entry_point_cpu():
    env = dict(os.environ, K="4", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "nabwa_tpu_torch.probes.probe_sem",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.splitlines() == [
        "sem post-issue then after each wait: [        512         384"
        "         256         128           0 -2147483648]"]


def test_entry_point_needs_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert psem.main(["--device", "cuda"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


def test_kernel_refuses_cpu_tensors():
    """The kernel's wrapper given a CPU tensor raises; only `sem` runs the
    plain version, and only for CPU tensors."""
    table = torch.zeros((psem.SEM_ROWS, psem.ROW_WORDS), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        psem.sem_cuda(table, 4)


def test_kernel_refuses_misaligned_table():
    """The bulk copies need the table on a 16-byte boundary: a table off
    it is refused before any launch."""
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        psem.sem_cuda(_misaligned(psem.SEM_ROWS, psem.ROW_WORDS), 4)
