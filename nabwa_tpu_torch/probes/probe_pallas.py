"""Probes 1, 2, 3, 4, 4b, 4c and 5 of scripts/probe_pallas.py on the card.

    python -m nabwa_tpu_torch.probes.probe_pallas [--device cuda|cpu]
                                                  [1] [2] [3] [4] [4b] [4c]
                                                  [5]

Probe 1, `probe_rowload` (scripts/probe_pallas.py:31, pallas_call at
:43): out[i] = table[idx[i]], 256 rows from a [4096, 128] int32 table; on
a CUDA tensor kernel C7 (csrc/probe_rowload.cu), one warp per row.

Probe 2, `probe_smem_idx` (:61, pallas_call at :73): the same gather with
the indices a 1-D [256] array in the TPU kernel's scalar memory; kernel
C15, each block's indices staged in shared memory.

Probe 3, `probe_popcount` (:91, pallas_call at :97): the popcount of each
int32 of [256, 128]; kernel C16.

Probe 4, `probe_while_scratch` (:115, pallas_call at :136): 50 rounds over
a pool int32 [256, 128] of: each row's minimum, every slot equal to it + 7
(wrapping), and a scalar carry of the minima's sum; the result is the
carry, [1, 1].  Probe 4b, `probe_while_vector_only` (:155, pallas_call at
:174): the same rounds with each row's minima summed into a vector
accumulator instead, [256, 128].  Kernels C17 and C18: a warp a row,
the 256 rows over the card (C17's rows in one thread block cluster, its
carry summed in the same launch); the first designs, one block holding
the pool, stay as `while_scratch_witness_cuda` and
`while_vector_witness_cuda`.

Probe 4c, `probe_body_scale` (:193, pallas_call at :213): 50 rounds of 20
elementwise steps over x int32 [256, 128], step j: p + j where p & 7 ==
j % 8, then p ^= p >> 3, p += p << 1 (wrapping); kernel C19, one thread
an element.  C15-C19 are in csrc/probe_pallas.cu.

Probe 5, `probe_dfs_shape` (:231, pallas_call at :282): 100 iterations of
a DFS-iteration-shaped body over 256 reads of 128 slots with a [32768,
128] table (pop every slot equal to the minimum, a row load into each of
two banks, popcounts over bank 0, 9 pushes into the first free slots);
the result is the int32 sum of the minima.  On a CUDA tensor kernel C10
(csrc/probe_dfs_shape.cu), one warp per read.

The inputs are the script's, unseeded as there (`np.random`); each probe
prints the script's result line with the time of the kernel (CUDA events)
or of the plain version on the CPU.  With no probe named, all seven run.
"""

import sys

import numpy as np
import torch

from ..ops import _build
from . import common
from .common import FREE_KEY, popcount32, wrap32, wsum

I32 = torch.int32
ROWLOAD_BB, ROWLOAD_NROW = 256, 4096
POPCOUNT_SHAPE = (256, 128)
WHILE_BB, WHILE_S, WHILE_ITERS = 256, 128, 50
# the grid forms' warps a block: C17's one cluster of 256 / 16 blocks,
# C18's 128 blocks (the fastest of those timed, PERF.md)
WHILE_SCRATCH_WARPS, WHILE_VECTOR_WARPS = 16, 2
BODY_SHAPE, BODY_ROUNDS, BODY_STEPS = (256, 128), 50, 20
DFS_BB, DFS_S, DFS_NROW, DFS_ITERS = 256, 128, 32768, 100

# kernel launches made on CUDA tensors: C7 by `rowload`, C15 by
# `smem_idx`, C16 by `popcount`, C17 by `while_scratch` (its witness by
# `while_scratch_witness_cuda`), C18 by `while_vector` (its witness by
# `while_vector_witness_cuda`), C19 by `body_scale`, C10 by `dfs_shape`
launches_rowload = 0
launches_smem_idx = 0
launches_popcount = 0
launches_while_scratch = 0
launches_while_scratch_witness = 0
launches_while_vector = 0
launches_while_vector_witness = 0
launches_body_scale = 0
launches_dfs_shape = 0


def _table_width(table):
    """Raise ValueError unless table rows have 128 words (C10's table
    check, run inside its one pass)."""
    if table.shape[1] != 128:
        raise ValueError(f"table rows have {table.shape[1]} words, not 128")


def rowload_plain(idx, table):
    """Probe 1's kernel in plain PyTorch: idx int32 [BB, 1] rows of table
    int32 [NROW, 128] -> int32 [BB, 128]."""
    return table[idx[:, 0].long()]


def _one_column(idx):
    """C7's idx must be [BB, 1] (checked before the table)."""
    if idx.shape[1] != 1:
        raise ValueError(f"idx must be [BB, 1], got {tuple(idx.shape)}")


def _gather_cuda(idx_spec, table, name):
    """Launch row-gather kernel `name` (C7 or C15) for the BB rows of the
    index that `idx_spec` (its `common.cuda_inputs` spec) names, unless BB
    is 0.  One check pass over the index and the table reads each one's
    device and data pointer once, and the launch reuses them; the index
    may start off a 16-byte boundary (the kernels read it as int32)."""
    index, (pi, pt) = common.cuda_inputs(idx_spec,
                                         (table, "table", 2, I32))
    width = table.shape[1]
    if width != 128:
        raise ValueError(f"table rows have {width} words, not 128")
    bb = idx_spec[0].shape[0]
    out = table.new_empty(bb, 128)
    if bb:
        rc = getattr(_build.lib(), name)(
            pi, pt, bb, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
        _build.check(rc, f"{name} kernel launch")
    return out


def rowload_cuda(idx, table):
    """`rowload_plain` by kernel C7; the indices are not checked
    (`rowload` does)."""
    global launches_rowload
    out = _gather_cuda((idx, "idx", 2, I32, 4, _one_column), table,
                       "nabwa_probe_rowload")
    if idx.shape[0]:
        with _build.count_lock:
            launches_rowload += 1
    return out


def rowload(idx, table):
    """Probe 1's row gather: the plain version for CPU tensors, kernel C7
    for CUDA tensors; refuses indices outside [0, NROW)."""
    common.check_indices("rowload", table.shape[0], idx)
    return _rowload(idx, table)


def _rowload(idx, table):
    """`rowload` without its index check."""
    return common.dispatch("rowload", idx, rowload_plain, rowload_cuda,
                           table)


def smem_idx_plain(idx, table):
    """Probe 2's kernel in plain PyTorch: idx int32 [BB] rows of table
    int32 [NROW, 128] -> int32 [BB, 128]."""
    return table[idx.long()]


def smem_idx_cuda(idx, table):
    """`smem_idx_plain` by kernel C15; the indices are not checked
    (`smem_idx` does)."""
    global launches_smem_idx
    out = _gather_cuda((idx, "idx", 1, I32, 4, None), table,
                       "nabwa_probe_smem_idx")
    if idx.shape[0]:
        with _build.count_lock:
            launches_smem_idx += 1
    return out


def smem_idx(idx, table):
    """Probe 2's row gather: the plain version for CPU tensors, kernel C15
    for CUDA tensors; refuses indices outside [0, NROW)."""
    common.check_indices("smem_idx", table.shape[0], idx)
    return _smem_idx(idx, table)


def _smem_idx(idx, table):
    """`smem_idx` without its index check."""
    return common.dispatch("smem_idx", idx, smem_idx_plain, smem_idx_cuda,
                           table)


def popcount_plain(x):
    """Probe 3's kernel in plain PyTorch: the set bits of each int32 of x,
    the sign bit included, as int32."""
    return popcount32(x.long()).to(torch.int32)


def popcount_cuda(x):
    """`popcount_plain` by kernel C16."""
    global launches_popcount
    common.cuda_input(x, "x", x.dim())
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = _build.lib().nabwa_probe_popcount(
        x.data_ptr(), x.numel(), out.data_ptr(), _build.stream_of(x))
    _build.check(rc, "probe_popcount kernel launch")
    with _build.count_lock:
        launches_popcount += 1
    return out


def popcount(x):
    """Probe 3: the plain version for CPU tensors, kernel C16 for CUDA
    tensors."""
    return common.dispatch("popcount", x, popcount_plain, popcount_cuda)


def _while_rounds(x):
    """The rounds of probes 4 and 4b (scripts/probe_pallas.py:125-127,
    :164-166) on x int32 [BB, S]: each round's row minima, int64 [BB, 1]
    each."""
    pool = x.long()
    for _ in range(WHILE_ITERS):
        m = pool.min(dim=1, keepdim=True).values
        pool = torch.where(pool == m, wrap32(pool + 7), pool)
        yield m


def while_scratch_plain(x):
    """Probe 4's kernel in plain PyTorch: x int32 [BB, S] -> the carry
    int32 [1, 1], the wrapped sum of every round's row minima."""
    acc = torch.zeros((1, 1), dtype=torch.int64, device=x.device)
    for m in _while_rounds(x):
        acc = wrap32(acc + wsum(m))
    return acc.to(torch.int32)


def while_vector_plain(x):
    """Probe 4b's kernel in plain PyTorch: x int32 [BB, S] -> int32 [BB,
    S], each column of a row the wrapped sum of that row's minima."""
    acc = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for m in _while_rounds(x):
        acc = wrap32(acc + m)
    return acc.to(torch.int32)


def _while_cuda(x, name, rows, cols, *args):
    """Launch kernel `name` (a form of C17 or C18) on x [256, 128] with
    `args` before out [rows, cols].  One check pass reads x's device index
    and pointer once (16-byte aligned: the kernels read int4), then x's
    shape is checked; the launch is on the raw current stream of that
    index."""
    index, (px,) = common.cuda_inputs((x, "x", 2, I32))
    if tuple(x.shape) != (WHILE_BB, WHILE_S):
        raise ValueError(f"x must be [{WHILE_BB}, {WHILE_S}], got "
                         f"{tuple(x.shape)}")
    out = x.new_empty(rows, cols)
    _build.check(getattr(_build.lib(), name)(
        px, *args, out.data_ptr(), torch._C._cuda_getCurrentRawStream(index)),
        f"{name} kernel launch")
    return out


def while_scratch_cuda(x):
    """`while_scratch_plain` by kernel C17's grid form (x [256, 128]): a
    warp a row, the rows in one cluster, the carry summed in the launch."""
    global launches_while_scratch
    out = _while_cuda(x, "nabwa_probe_while_scratch", 1, 1,
                      WHILE_SCRATCH_WARPS)
    with _build.count_lock:
        launches_while_scratch += 1
    return out


def while_scratch_witness_cuda(x):
    """`while_scratch_plain` by C17's witness, one block holding the pool
    and a block-wide sum every round.  The launch path of
    `while_scratch_cuda`."""
    global launches_while_scratch_witness
    out = _while_cuda(x, "nabwa_probe_while_scratch_witness", 1, 1)
    with _build.count_lock:
        launches_while_scratch_witness += 1
    return out


def while_vector_cuda(x):
    """`while_vector_plain` by kernel C18's grid form (x [256, 128]): a
    warp a row over the card."""
    global launches_while_vector
    out = _while_cuda(x, "nabwa_probe_while_vector", WHILE_BB, WHILE_S,
                      WHILE_VECTOR_WARPS)
    with _build.count_lock:
        launches_while_vector += 1
    return out


def while_vector_witness_cuda(x):
    """`while_vector_plain` by C18's witness, one block holding the pool.
    The launch path of `while_vector_cuda`."""
    global launches_while_vector_witness
    out = _while_cuda(x, "nabwa_probe_while_vector_witness", WHILE_BB,
                      WHILE_S)
    with _build.count_lock:
        launches_while_vector_witness += 1
    return out


def while_scratch(x):
    """Probe 4: the plain version for CPU tensors, kernel C17's grid form
    for CUDA tensors."""
    return common.dispatch("while_scratch", x, while_scratch_plain,
                           while_scratch_cuda)


def while_vector(x):
    """Probe 4b: the plain version for CPU tensors, kernel C18's grid form
    for CUDA tensors."""
    return common.dispatch("while_vector", x, while_vector_plain,
                           while_vector_cuda)


def body_step(p, j):
    """Step j of probe 4c's inner loop (scripts/probe_pallas.py:202-204)
    on int64 values holding int32s."""
    p = torch.where((p & 7) == j % 8, wrap32(p + j), p)
    p = p ^ (p >> 3)
    return wrap32(p + (p << 1))


def body_scale_plain(x):
    """Probe 4c's kernel in plain PyTorch: BODY_ROUNDS rounds of the
    BODY_STEPS steps on each int32 of x -> int32, x's shape."""
    p = x.long()
    for _ in range(BODY_ROUNDS):
        for j in range(BODY_STEPS):
            p = body_step(p, j)
    return p.to(torch.int32)


def body_scale_cuda(x):
    """`body_scale_plain` by kernel C19."""
    global launches_body_scale
    common.cuda_input(x, "x", x.dim())
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = _build.lib().nabwa_probe_body_scale(
        x.data_ptr(), x.numel(), out.data_ptr(), _build.stream_of(x))
    _build.check(rc, "probe_body_scale kernel launch")
    with _build.count_lock:
        launches_body_scale += 1
    return out


def body_scale(x):
    """Probe 4c: the plain version for CPU tensors, kernel C19 for CUDA
    tensors."""
    return common.dispatch("body_scale", x, body_scale_plain,
                           body_scale_cuda)


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
    """`dfs_shape_plain` by kernel C10.  One check pass over k and the
    table (the one-at-a-time checks' order and messages: CUDA tensors, k's
    dtype, dims and contiguity, the table's on k's device and its 16-byte
    alignment, its width), each device index and pointer read once; acc
    is one allocation, zeroed by the library on the stream before the
    kernel.  No rows launch nothing."""
    global launches_dfs_shape
    index, (pk, pt) = common.cuda_inputs((k, "k", 2, I32, 4, None),
                                         (table, "table", 2, I32, 16,
                                          _table_width))
    nrow = table.shape[0]
    if k.shape[1] != 128:
        raise ValueError(f"k must be [BB, 128], got {tuple(k.shape)}")
    if nrow & (nrow - 1):
        raise ValueError(f"table rows must be a power of two, got {nrow}")
    bb = k.shape[0]
    if not bb:
        return k.new_zeros(1, 1)
    acc = k.new_empty(1, 1)
    _build.check(_build.lib().nabwa_probe_dfs_pallas(
        pk, pt, nrow, bb, int(iters), acc.data_ptr(),
        torch._C._cuda_getCurrentRawStream(index)),
        "probe_dfs_pallas kernel launch")
    with _build.count_lock:
        launches_dfs_shape += 1
    return acc


def dfs_shape(k, table, iters=DFS_ITERS):
    """Probe 5's DFS-iteration mock: the plain version for CPU tensors,
    kernel C10 for CUDA tensors."""
    return common.dispatch("dfs_shape", k, dfs_shape_plain, dfs_shape_cuda,
                           table, iters)


def probe_rowload(device):
    """Probe 1 on the script's inputs; prints its line.  The indices are
    checked once, and the timed calls skip the check.  Returns (seconds
    per call, result, ok)."""
    idx = np.random.randint(0, ROWLOAD_NROW, (ROWLOAD_BB, 1))
    table = np.arange(ROWLOAD_NROW * 128).reshape(ROWLOAD_NROW, 128) % 9973
    idx_t, table_t = common.tensors(device, idx, table)
    common.check_indices("rowload", table_t.shape[0], idx_t)
    dt, r = common.timeit(lambda: _rowload(idx_t, table_t), device)
    ok = np.array_equal(r.cpu().numpy(), table[idx[:, 0]])
    print(f"probe1 rowload fori BB={ROWLOAD_BB}: {dt*1e6:.1f}us  ok={ok}")
    return dt, r, ok


def probe_smem_idx(device):
    """Probe 2 on the script's inputs, as `probe_rowload`.  Returns
    (seconds per call, result, ok)."""
    idx = np.random.randint(0, ROWLOAD_NROW, (ROWLOAD_BB,))
    table = np.arange(ROWLOAD_NROW * 128).reshape(ROWLOAD_NROW, 128) % 9973
    idx_t, table_t = common.tensors(device, idx, table)
    common.check_indices("smem_idx", table_t.shape[0], idx_t)
    dt, r = common.timeit(lambda: _smem_idx(idx_t, table_t), device)
    ok = np.array_equal(r.cpu().numpy(), table[idx])
    print(f"probe2 smem-idx rowload BB={ROWLOAD_BB}: {dt*1e6:.1f}us  "
          f"ok={ok}")
    return dt, r, ok


def probe_popcount(device):
    """Probe 3 on the script's input; prints its line.  Returns (seconds
    per call, result, ok)."""
    x = np.random.randint(0, 1 << 30, POPCOUNT_SHAPE)
    x_t, = common.tensors(device, x)
    dt, r = common.timeit(lambda: popcount(x_t), device)
    bits = np.unpackbits(x.astype(np.uint32).view(np.uint8))
    ok = np.array_equal(r.cpu().numpy(),
                        bits.reshape(*POPCOUNT_SHAPE, 32).sum(axis=2))
    print(f"probe3 popcount: {dt*1e6:.1f}us  ok={ok}")
    return dt, r, ok


def probe_while_scratch(device):
    """Probe 4 on the script's input; prints its line.  Returns (seconds
    per call, result)."""
    x_t, = common.tensors(device, np.random.randint(0, 1000,
                                                    (WHILE_BB, WHILE_S)))
    dt, r = common.timeit(lambda: while_scratch(x_t), device)
    print(f"probe4 while+scratch {WHILE_ITERS} iters: {dt*1e6:.1f}us  "
          f"({dt/WHILE_ITERS*1e6:.2f}us/iter) r={int(r[0, 0])}")
    return dt, r


def probe_while_vector_only(device):
    """Probe 4b on the script's input; prints its line.  Returns (seconds
    per call, result)."""
    x_t, = common.tensors(device, np.random.randint(0, 1000,
                                                    (WHILE_BB, WHILE_S)))
    dt, r = common.timeit(lambda: while_vector(x_t), device)
    print(f"probe4b fori vector-only {WHILE_ITERS} iters: {dt*1e6:.1f}us  "
          f"({dt/WHILE_ITERS*1e6:.2f}us/iter)")
    return dt, r


def probe_body_scale(device):
    """Probe 4c on the script's input; prints its line.  Returns (seconds
    per call, result)."""
    x_t, = common.tensors(device, np.random.randint(0, 1000, BODY_SHAPE))
    dt, r = common.timeit(lambda: body_scale(x_t), device)
    print(f"probe4c 60-op body {BODY_ROUNDS} iters: {dt*1e6:.1f}us  "
          f"({dt/BODY_ROUNDS*1e6:.2f}us/iter)")
    return dt, r


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


PROBES = {"1": probe_rowload, "2": probe_smem_idx, "3": probe_popcount,
          "4": probe_while_scratch, "4b": probe_while_vector_only,
          "4c": probe_body_scale, "5": probe_dfs_shape}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, which = common.parse_device(argv, "probe_pallas")
    if device is None:
        return 1
    which = which or list(PROBES)
    for w in which:
        if w not in PROBES:
            print(f"[probe_pallas] probe {w}: no such probe", file=sys.stderr)
            return 1
    print("devices:", [common.device_name(device)])
    for w in which:
        PROBES[w](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
