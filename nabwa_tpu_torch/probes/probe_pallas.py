"""Probes 1 and 5 of scripts/probe_pallas.py on the card.

    python -m nabwa_tpu_torch.probes.probe_pallas [--device cuda|cpu] [1] [5]

Probe 1, `probe_rowload` (scripts/probe_pallas.py:31, pallas_call at
:43): out[i] = table[idx[i]], 256 rows from a [4096, 128] int32 table; on
a CUDA tensor kernel C7 (csrc/probe_rowload.cu), one warp per row.

Probe 5, `probe_dfs_shape` (:231, pallas_call at :282): 100 iterations of
a DFS-iteration-shaped body over 256 reads of 128 slots with a [32768,
128] table (pop every slot equal to the minimum, a row load into each of
two banks, popcounts over bank 0, 9 pushes into the first free slots);
the result is the int32 sum of the minima.  On a CUDA tensor kernel C10
(csrc/probe_dfs_shape.cu), one warp per read.

The inputs are the script's, unseeded as there (`np.random`); each probe
prints the script's result line with the time of the kernel (CUDA events)
or of the plain version on the CPU.  With no probe named, both run; the
script's probes 2, 3, 4, 4b and 4c are not ported yet.
"""

import sys

import numpy as np
import torch

from ..ops import _build
from . import common
from .common import FREE_KEY, popcount32, wrap32, wsum

ROWLOAD_BB, ROWLOAD_NROW = 256, 4096
DFS_BB, DFS_S, DFS_NROW, DFS_ITERS = 256, 128, 32768, 100

# kernel launches made on CUDA tensors: C7 by `rowload`, C10 by `dfs_shape`
launches_rowload = 0
launches_dfs_shape = 0


def _check_table(table, device):
    _build.require(table, "table", device, 2)
    if table.shape[1] != 128:
        raise ValueError(f"table rows have {table.shape[1]} words, not 128")


def rowload_plain(idx, table):
    """Probe 1's kernel in plain PyTorch: idx int32 [BB, 1] rows of table
    int32 [NROW, 128] -> int32 [BB, 128]."""
    return table[idx[:, 0].long()]


def rowload_cuda(idx, table):
    """`rowload_plain` by kernel C7; every idx must lie in [0, NROW)."""
    global launches_rowload
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    _build.require(idx, "idx", dev, 2)
    _check_table(table, dev)
    if idx.shape[1] != 1:
        raise ValueError(f"idx must be [BB, 1], got {tuple(idx.shape)}")
    bb = idx.shape[0]
    out = torch.empty((bb, 128), dtype=torch.int32, device=dev)
    if bb == 0:
        return out
    rc = _build.lib().nabwa_probe_rowload(
        idx.data_ptr(), table.data_ptr(), bb, out.data_ptr(),
        _build.stream_of(idx))
    _build.check(rc, "probe_rowload kernel launch")
    with _build.count_lock:
        launches_rowload += 1
    return out


def rowload(idx, table):
    """Probe 1's row gather: the plain version for CPU tensors, kernel C7
    for CUDA tensors."""
    if idx.device.type == "cpu":
        return rowload_plain(idx, table)
    if idx.device.type == "cuda":
        return rowload_cuda(idx, table)
    raise ValueError(f"rowload: no kernel for device {idx.device}")


def bank_counts(rows):
    """Popcounts of lo and of lo & hi for each word of bank-0 rows int64
    [R, 128] (scripts/probe_pallas.py:258-263): (c1, c3), int64 [R, 128]."""
    lo = rows & 0x55555555
    hi = (rows >> 1) & 0x55555555
    return popcount32(lo), popcount32(lo & hi)


def dfs_shape_plain(k, table, iters=DFS_ITERS, touched=None):
    """Probe 5's kernel in plain PyTorch, line for line
    (scripts/probe_pallas.py:234-277): k int32 [BB, 128] (the initial
    kidx), table int32 [NROW, 128] (NROW a power of two) -> int32 [1, 1].
    `touched`, a list, receives each iteration's row indices of both
    banks."""
    dev = k.device
    bb, nrow = k.shape[0], table.shape[0]
    lane = torch.arange(DFS_S, dtype=torch.int64, device=dev)[None, :]
    pool = lane * 3 + torch.arange(bb, dtype=torch.int64, device=dev)[:, None]
    kidx = k.long()
    tab = table.long()
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(iters):
        mk = pool.min(dim=1, keepdim=True).values
        pm = pool == mk
        e_k = wsum(torch.where(pm, kidx[:, :DFS_S], 0), dim=1)
        r = kidx[:, 0] & (nrow - 1)
        r2 = kidx[:, 1] & (nrow - 1)
        if touched is not None:
            touched += [r, r2]
        rows = tab[r]
        tab[r2]                     # bank 1: loaded, never read
        c1, c3 = (c.sum(dim=1) for c in bank_counts(rows))
        free = pool >= 0x40000000
        frank = torch.cumsum(free.long(), dim=1)
        for j in range(9):
            pool = torch.where(free & (frank == j + 1), it * 9 + j, pool)
        pool = torch.where(pm, FREE_KEY, pool)
        kidx = (kidx + (c1 + c3 + e_k)[:, None]) & (nrow - 1)
        acc = wrap32(acc + wsum(mk))
    return acc.to(torch.int32).view(1, 1)


def dfs_shape_cuda(k, table, iters=DFS_ITERS):
    """`dfs_shape_plain` by kernel C10."""
    global launches_dfs_shape
    dev = k.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    _build.require(k, "k", dev, 2)
    _check_table(table, dev)
    nrow = table.shape[0]
    if k.shape[1] != 128:
        raise ValueError(f"k must be [BB, 128], got {tuple(k.shape)}")
    if nrow & (nrow - 1):
        raise ValueError(f"table rows must be a power of two, got {nrow}")
    acc = torch.zeros(1, dtype=torch.int32, device=dev)
    if k.shape[0] == 0:
        return acc.view(1, 1)
    rc = _build.lib().nabwa_probe_dfs_pallas(
        k.data_ptr(), table.data_ptr(), nrow, k.shape[0], int(iters),
        acc.data_ptr(), _build.stream_of(k))
    _build.check(rc, "probe_dfs_pallas kernel launch")
    with _build.count_lock:
        launches_dfs_shape += 1
    return acc.view(1, 1)


def dfs_shape(k, table, iters=DFS_ITERS):
    """Probe 5's DFS-iteration mock: the plain version for CPU tensors,
    kernel C10 for CUDA tensors."""
    if k.device.type == "cpu":
        return dfs_shape_plain(k, table, iters)
    if k.device.type == "cuda":
        return dfs_shape_cuda(k, table, iters)
    raise ValueError(f"dfs_shape: no kernel for device {k.device}")


def probe_rowload(device):
    """Probe 1 on the script's inputs; prints its line.  Returns (seconds
    per call, result, ok)."""
    idx = np.random.randint(0, ROWLOAD_NROW, (ROWLOAD_BB, 1))
    table = np.arange(ROWLOAD_NROW * 128).reshape(ROWLOAD_NROW, 128) % 9973
    idx_t, table_t = common.tensors(device, idx, table)
    dt, r = common.timeit(lambda: rowload(idx_t, table_t), device)
    ok = np.array_equal(r.cpu().numpy(), table[idx[:, 0]])
    print(f"probe1 rowload fori BB={ROWLOAD_BB}: {dt*1e6:.1f}us  ok={ok}")
    return dt, r, ok


def probe_dfs_shape(device):
    """Probe 5 on the script's inputs; prints its line.  Returns (seconds
    per call, result)."""
    k = np.random.randint(0, DFS_NROW, (DFS_BB, 128))
    table = np.random.randint(0, 1 << 30, (DFS_NROW, 128))
    k_t, table_t = common.tensors(device, k, table)
    dt, r = common.timeit(lambda: dfs_shape(k_t, table_t), device, n=5)
    print(f"probe5 dfs-shaped {DFS_ITERS} iters BB={DFS_BB} S={DFS_S}: "
          f"{dt*1e3:.2f}ms ({dt/DFS_ITERS*1e6:.2f}us/iter)")
    return dt, r


PROBES = {"1": probe_rowload, "5": probe_dfs_shape}
NOT_PORTED = ("2", "3", "4", "4b", "4c")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, which = common.parse_device(argv, "probe_pallas")
    if device is None:
        return 1
    which = which or list(PROBES)
    for w in which:
        if w not in PROBES:
            why = ("not yet ported to nabwa_tpu_torch" if w in NOT_PORTED
                   else "no such probe")
            print(f"[probe_pallas] probe {w}: {why}", file=sys.stderr)
            return 1
    print("devices:", [common.device_name(device)])
    for w in which:
        PROBES[w](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
