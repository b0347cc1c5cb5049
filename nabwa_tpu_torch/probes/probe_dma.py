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

On a CUDA table the function launches kernel C8's grid form
(csrc/probe_dma.cu), the T rounds side by side, one block of cp.async row
copies a round, `reg` mode's rows by the LCG's jump-ahead (`lcg_jump`);
on a CPU table it runs the plain version, the same copies in issue order.
`dma_serial_cuda` launches the serial form, one block running the rounds
in order as the TPU kernel does: the probe's witness of a serial round's
latency.  `main` times the script's configurations (N 64 and 128, unroll
on and off, `reg`, `vmem` and `cond`) on the grid form with CUDA events
and prints the script's lines, then the serial form's line at the
script's default (N 128, unroll off, `reg`); ROWS and T come from the
environment as there.  The grid form's lines divide a call's time, mostly
the host's launch, by T and by T N: the rounds run side by side, so these
are not a round's or a copy's latency.  The `serial` line's us/iter is a
round's latency, the probe's question.
"""

import os
import sys

import torch

from ..ops import _build
from . import common
from .common import floor_mod, wrap32

SRCS = ("reg", "vmem", "smem", "cond")
# 2N stage rows of 512 B and two 4 kB index vectors in the serial form's
# shared memory (232,448 bytes on the H100); the grid form needs less
MAX_N = (232448 - 2 * 4096) // 1024
VEC = 8 * 128                     # the (8, 128) index vector
LCG_A, LCG_C, M31 = 1103515245, 12345, 0x7FFFFFFF
I32 = torch.int32

# kernel launches made on CUDA tensors: the grid form by `dma_cuda`, the
# serial form by `dma_serial_cuda`
launches = 0
launches_serial = 0


def _check(n, t, n_rows, src):
    if src not in SRCS:
        raise ValueError(f"src must be one of {SRCS}, got {src!r}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"N must lie in [1, {MAX_N}], got {n}")
    if t < 0 or n_rows < 1:
        raise ValueError(f"bad T {t} or n_rows {n_rows}")


def lcg_next(s):
    """One step of the script's register LCG (:50)."""
    return wrap32(s * LCG_A + LCG_C) & M31


def lcg_jump(s, k):
    """The LCG's state k >= 0 steps after s (ints, or int64 tensors that
    broadcast): a step is s -> (a s + c) mod 2^31, so k steps are one
    affine map mod 2^31, built by squaring; k = 0 leaves s as it is.
    csrc/probes.cuh `lcg_jump`."""
    a_k, c_k, a, c = 1, 0, LCG_A, LCG_C
    rest = k
    while bool((rest > 0).any()) if torch.is_tensor(rest) else rest > 0:
        bit = rest & 1
        a_k = (a * a_k & M31) * bit + a_k * (1 - bit)
        c_k = ((a * c_k + c) & M31) * bit + c_k * (1 - bit)
        c = (a * c + c) & M31
        a = a * a & M31
        rest = rest >> 1
    moved = (a_k * s + c_k) & M31
    if torch.is_tensor(k) or torch.is_tensor(s):
        return torch.where(torch.as_tensor(k) == 0, torch.as_tensor(s),
                           torch.as_tensor(moved))
    return s if k == 0 else moved


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
        steps = torch.arange(1, t * n + 1, dtype=torch.int64).view(t, n)
        return lcg_jump(1, steps) % n_rows, None, lcg_jump(1, t * n)
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


def _dma_launch(entry, tab, n, t, n_rows, src, unroll):
    """Check the arguments of `dma_cuda` and `dma_serial_cuda`, allocate
    out, the stage, rounds and `smem` mode's scratch ([T, 1024] words) in
    one buffer, and launch library entry `entry` on them; returns (out
    int32 [1, 1], stage int32 [2N, 128], rounds int32 [T]), views of the
    buffer.  The checks and messages are the one-at-a-time checks': CUDA,
    then `_check`, then the table's dtype, dims and contiguity (and its
    16-byte alignment, the kernels' int4 reads) in one pass that reads its
    device index and pointer once, then its shape."""
    if not tab.is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors, got {tab.device}")
    _check(n, t, n_rows, src)
    index, (ptr,) = common.cuda_inputs((tab, "tab", 2, I32))
    if tab.shape[1] != 128 or tab.shape[0] < n_rows:
        raise ValueError(f"tab must be [>= {n_rows}, 128], got "
                         f"{tuple(tab.shape)}")
    words = 2 * n * 128
    at = words + (t * VEC if src == "smem" else 0)
    buf = tab.new_empty(at + 1 + t)
    base = buf.data_ptr()
    # one as_strided a view: a split and views of its parts cost twice it
    out = buf.as_strided((1, 1), (1, 1), at)
    rounds = buf.as_strided((t,), (1,), at + 1)
    if entry == "nabwa_probe_dma_serial":
        rounds.zero_()              # its warps add to it
    _build.check(getattr(_build.lib(), entry)(
        ptr, n_rows, n, t, SRCS.index(src), int(bool(unroll)),
        base + 4 * words, base + 4 * at, base, base + 4 * at + 4,
        torch._C._cuda_getCurrentRawStream(index)), f"{entry} kernel launch")
    return out, buf.as_strided((2 * n, 128), (128, 1)), rounds


def dma_cuda(tab, n, t, n_rows, src, unroll):
    """`dma_plain` by kernel C8's grid form, one block a round; `unroll`
    does not change the result."""
    global launches
    res = _dma_launch("nabwa_probe_dma", tab, n, t, n_rows, src, unroll)
    with _build.count_lock:
        launches += 1
    return res


def dma_serial_cuda(tab, n, t, n_rows, src, unroll):
    """`dma_plain` by C8's serial form, one block running the T rounds in
    order: the probe's witness of a serial round's latency.  Its rounds
    are zeroed first (one fill launch), since its warps add to them."""
    global launches_serial
    res = _dma_launch("nabwa_probe_dma_serial", tab, n, t, n_rows, src,
                      unroll)
    with _build.count_lock:
        launches_serial += 1
    return res


def make(n, t, n_rows, unroll, src="reg"):
    """The probe as a function of the table (scripts/probe_dma.py:31):
    the plain version for a CPU table, kernel C8's grid form for a CUDA
    table.
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
                _print_line("", n, unroll, src, dt, t)
    # the serial form at the script's default, on the card; the plain
    # version on the CPU, which runs the rounds in order too
    n, unroll, src = 128, False, "reg"
    if device.type == "cuda":
        def f(tab):
            return dma_serial_cuda(tab, n, t, rows, src, unroll)
    else:
        f = make(n, t, rows, unroll, src)
    dt, _ = common.timeit(lambda: f(tab), device, n=1)
    _print_line("serial ", n, unroll, src, dt, t)
    return 0


def _print_line(form, n, unroll, src, dt, t):
    """The script's line for one configuration timed at dt seconds a call,
    per round and per copy."""
    per_iter = dt / t
    per_copy = per_iter / n
    print(f"{form}N={n:4d} unroll={int(unroll)} src={src:4s}  "
          f"{per_iter*1e6:9.1f} us/iter  {per_copy*1e6:7.2f} us/copy")


if __name__ == "__main__":
    sys.exit(main())
