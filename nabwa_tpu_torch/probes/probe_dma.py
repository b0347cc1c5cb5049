"""The async row-fetch probe of scripts/probe_dma.py on the card.

    ROWS=100000 T=64 python -m nabwa_tpu_torch.probes.probe_dma [--device cuda|cpu]

`make(N, T, n_rows, unroll, src)` (scripts/probe_dma.py:31, pallas_call
at :101) returns a function of the table: T serial iterations, each
issuing N async copies of one [1, 128] int32 row from the [ROWS, 128]
table into a stage and waiting for all of them.  The row index comes from
a register LCG (`reg`), a per-iteration vector (`vmem`), that vector
staged by one more copy (`smem`), or `vmem` plus a second copy of each row
under a predicate (`cond`).  It returns out = final + stage[0, 0], int32
[1, 1], final being the LCG's last state in `reg` mode and the seed 1
otherwise, and, unlike the script, the whole stage, int32 [2N, 128], and
a witness of each round, int32 [T]: the wrap-around sum of every word
that round's copies wrote.  out cannot tell the modes apart, the stage
can, and both see only the last round.  The stage has 2N rows where the
script's has max(N, 8), so each `cond` copy (to row (i + N) % 2N) has a
row of its own; it starts zeroed.

On a CUDA table the function launches kernel C8 (csrc/probe_dma.cu), one
block of cp.async row copies; on a CPU table it runs the plain version,
the same copies in issue order.  `main` times the script's configurations
(N 64 and 128, unroll on and off, `reg`, `vmem` and `cond`) with CUDA
events and prints the script's lines; ROWS and T come from the
environment as there.
"""

import os
import sys

import torch

from ..ops import _build
from . import common
from .common import floor_mod, wrap32

SRCS = ("reg", "vmem", "smem", "cond")
# 2N stage rows of 512 B and two 4 kB index vectors in the block's shared
# memory (232,448 bytes on the H100)
MAX_N = (232448 - 2 * 4096) // 1024

# kernel launches made on CUDA tensors
launches = 0


def _check(n, t, n_rows, src):
    if src not in SRCS:
        raise ValueError(f"src must be one of {SRCS}, got {src!r}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"N must lie in [1, {MAX_N}], got {n}")
    if t < 0 or n_rows < 1:
        raise ValueError(f"bad T {t} or n_rows {n_rows}")


def lcg_next(s):
    """One step of the script's register LCG (:50)."""
    return wrap32(s * 1103515245 + 12345) & 0x7FFFFFFF


def vec_value(col, it, n_rows):
    """Column `col` of the (8, 128) index vector at iteration `it`
    (:40-41); its 8 rows hold the same values."""
    return floor_mod(wrap32(col * 12345 + wrap32(it * 1103515245)), n_rows)


def copy_rows(n, t, n_rows, src):
    """The table row of every copy, in issue order: (rows int64 [T, N],
    rows2 int64 [T, N] of the `cond` copies or None, final), final being
    the LCG's state after the last iteration (the seed 1 but in `reg`
    mode).  scripts/probe_dma.py:38-70."""
    _check(n, t, n_rows, src)
    if src == "reg":
        s, rows = 1, []
        for _ in range(t):
            it_rows = []
            for _ in range(n):
                s = lcg_next(s)
                it_rows.append(s % n_rows)
            rows.append(it_rows)
        return torch.tensor(rows, dtype=torch.int64).view(t, n), None, s
    col = torch.arange(128, dtype=torch.int64)
    it = torch.arange(t, dtype=torch.int64)[:, None]
    vec = vec_value(col, it, n_rows)[:, None, :].expand(t, 8, 128)
    i = torch.arange(n)
    rows = vec[:, i // 128, i % 128]
    rows2 = vec[:, (i // 128 + 1) % 8, i % 128] if src == "cond" else None
    return rows, rows2, 1


def dma_plain(tab, n, t, n_rows, src):
    """`make`'s kernel in plain PyTorch: (out int32 [1, 1], stage int32
    [2N, 128], rounds int32 [T])."""
    rows, rows2, final = copy_rows(n, t, n_rows, src)
    dev = tab.device
    rows = rows.to(dev)
    stage = torch.zeros((2 * n, 128), dtype=torch.int32, device=dev)
    rounds = torch.zeros(t, dtype=torch.int64, device=dev)
    dst2 = (torch.arange(n, device=dev) + n) % (2 * n)
    for it in range(t):
        stage[:n] = tab[rows[it]]
        rounds[it] = stage[:n].long().sum()
        if rows2 is not None:
            r2 = rows2[it].to(dev)
            ok = r2 >= 0
            stage[dst2[ok]] = tab[floor_mod(r2[ok], n_rows)]
            rounds[it] += stage[dst2[ok]].long().sum()
    out = wrap32(final + stage[0, 0].long()).to(torch.int32).view(1, 1)
    return out, stage, wrap32(rounds).to(torch.int32)


def dma_cuda(tab, n, t, n_rows, src, unroll):
    """`dma_plain` by kernel C8."""
    global launches
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    _check(n, t, n_rows, src)
    _build.require(tab, "tab", dev, 2)
    if tab.shape[1] != 128 or tab.shape[0] < n_rows:
        raise ValueError(f"tab must be [>= {n_rows}, 128], got "
                         f"{tuple(tab.shape)}")
    vec = torch.empty(1024, dtype=torch.int32, device=dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stage = torch.empty((2 * n, 128), dtype=torch.int32, device=dev)
    rounds = torch.zeros(t, dtype=torch.int32, device=dev)
    rc = _build.lib().nabwa_probe_dma(
        tab.data_ptr(), n_rows, n, t, SRCS.index(src), int(bool(unroll)),
        vec.data_ptr(), out.data_ptr(), stage.data_ptr(), rounds.data_ptr(),
        _build.stream_of(tab))
    _build.check(rc, "probe_dma kernel launch")
    with _build.count_lock:
        launches += 1
    return out.view(1, 1), stage, rounds


def make(n, t, n_rows, unroll, src="reg"):
    """The probe as a function of the table (scripts/probe_dma.py:31):
    the plain version for a CPU table, kernel C8 for a CUDA table.
    `unroll` unrolls the kernel's issue loop; results do not depend on
    it."""
    _check(n, t, n_rows, src)

    def run(tab):
        if tab.device.type == "cpu":
            return dma_plain(tab, n, t, n_rows, src)
        if tab.device.type == "cuda":
            return dma_cuda(tab, n, t, n_rows, src, unroll)
        raise ValueError(f"probe_dma: no kernel for device {tab.device}")
    return run


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, rest = common.parse_device(argv, "probe_dma")
    if device is None:
        return 1
    if rest:
        print(f"[probe_dma] error: unexpected arguments {rest} (ROWS and T "
              "come from the environment)", file=sys.stderr)
        return 1
    rows = int(os.environ.get("ROWS", "100000"))
    t = int(os.environ.get("T", "64"))
    tab = torch.arange(rows * 128, dtype=torch.int32,
                       device=device).view(rows, 128)
    for n in (64, 128):
        for unroll in (True, False):
            for src in ("reg", "vmem", "cond"):
                f = make(n, t, rows, unroll, src)
                dt, _ = common.timeit(lambda: f(tab), device, n=1)
                per_iter = dt / t
                per_copy = per_iter / n
                print(f"N={n:4d} unroll={int(unroll)} src={src:4s}  "
                      f"{per_iter*1e6:9.1f} us/iter  "
                      f"{per_copy*1e6:7.2f} us/copy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
