"""Probes A, B1, BU, C, D, E and F of scripts/probe_pallas2.py on the card.

    python -m nabwa_tpu_torch.probes.probe_pallas2 [--device cuda|cpu]
                                                    [A] [B1] [BU] [C] [D]
                                                    [E] [F]

Probe A, `probe_empty` (scripts/probe_pallas2.py:38, pallas_call at :44):
out = x + 1 over [8, 128] int32, the cost of a launch; kernel C11.

Probes B1 and BU, `probe_loads(unroll)` (:55, pallas_call at :67): a
serial loop of BB = 256 bodies, each copying rows idx[i, 0] and idx[i, 1]
of a [32768, 128] int32 table to out[i] and out[i + BB]; unrolled once
(B1) or BB times (BU); kernel C12, its 512 row copies spread over the
card, whatever the unroll.  `loads_serial_cuda` keeps the TPU's loop, one
warp walking the bodies in order, as a witness of one load's latency.

Probe C, `probe_lane_gather` (:86, pallas_call at :92): out[r, c] =
x[r, i[r, c]] over [256, 128] int32, take_along_axis on axis 1; kernel
C20, one warp per row, lanes exchanging values by shuffles.  Indices
outside [0, 128) are refused.

Probe D, `probe_scalar_push` (:111, pallas_call at :146): 50 rounds in
which each of 256 rows pushes c[i, it & 7] & 3 of its candidates c[i, 0],
c[i, 1], c[i, 2], each as five fields (v, v + 1, v ^ 3, v - 7, v * 3) into
slot t of five [256, 256] buffers, t advancing by one a push; the result
is f0[:, :128] plus each row's final t in column 0.  The script never
writes a slot that no push reaches and reads it all the same: undefined
on the TPU, INT32_MIN in Pallas interpret mode, INT32_MIN here.  Kernel
C21, one thread per row.  The plain version and the kernel also return
the five buffers and top whole.

Probe E, `probe_lanereduce` (:164, pallas_call at :170): the int32 sum of
each row of [512, 128], as [512, 1]; kernel C14, one warp per row.

Probe F, `probe_pop` (:182, pallas_call at :202): key = x, f = x ^ 21
over [256, 256] int32, then 50 rounds of: the row's minimum, the sum of f
over the slots equal to it, those slots cleared, slot 0 lowered to that
sum; the result is key[:, :128].  Kernel C13, one warp per row.  The
plain version and the kernel also return the whole final key state and
each round's minimum, which the result alone does not show.

All kernels are in csrc/probe_pallas2.cu.  The inputs are the script's,
unseeded as there (`np.random`); each probe prints the script's result
line with the time of the kernel (CUDA events) or of the plain version
on the CPU.  With no probe named, all seven run, in the script's order.
"""

import sys

import numpy as np
import torch

from ..ops import _build
from . import common
from .common import FREE_KEY, wrap32, wsum

NROW, BB = 32768, 256
EMPTY_SHAPE = (8, 128)
LOADS_UNROLL = BB               # the unrolled kernel's bodies at a time
REDUCE_SHAPE = (512, 128)
POP_S, POP_OUT, POP_ITERS = 256, 128, 50
GATHER_W = 128
PUSH_S, PUSH_OUT, PUSH_ROUNDS, PUSH_FIELDS = 256, 128, 50, 5
UNWRITTEN = -2**31       # what interpret mode reads from an unwritten slot
I32 = torch.int32

# kernel launches made on CUDA tensors: C11 by `empty`, C12 by `loads`
# (its serial forms by `loads_serial_cuda`), C13 by `pop`, C14 by
# `lanereduce`, C20 by `lane_gather`, C21 by `scalar_push`
launches_empty = 0
launches_loads = 0
launches_loads_serial = 0
launches_pop = 0
launches_lanereduce = 0
launches_lane_gather = 0
launches_scalar_push = 0


def _table():
    return np.random.randint(0, 1 << 30, (NROW, 128))


def empty_plain(x):
    """Probe A's kernel in plain PyTorch: x + 1, int32 wrapped."""
    return wrap32(x.long() + 1).to(torch.int32)


def empty_cuda(x):
    """`empty_plain` by kernel C11, for x of any shape (0-d and empty
    too; no launch when x is empty).  One check pass reads x's device
    index and pointer once (16-byte aligned: the kernel reads int4);
    `empty_like` is the cheapest allocation of x's shape (PERF.md)."""
    global launches_empty
    index, (px,) = common.cuda_inputs((x, "x", x.dim(), I32))
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        _build.check(_build.lib().nabwa_probe_empty(
            px, n, out.data_ptr(), torch._C._cuda_getCurrentRawStream(index)),
            "probe_empty kernel launch")
        with _build.count_lock:
            launches_empty += 1
    return out


def empty(x):
    """Probe A: the plain version for CPU tensors, kernel C11 for CUDA
    tensors."""
    return common.dispatch("empty", x, empty_plain, empty_cuda)


def loads_plain(idx, table, unroll=1):
    """Probe B's kernel in plain PyTorch: idx int32 [BB, W >= 2], table
    int32 [NROW, 128] -> int32 [2 BB, 128], rows idx[:, 0] then idx[:,
    1].  The unroll factor does not change the result."""
    return torch.cat([table[idx[:, 0].long()], table[idx[:, 1].long()]])


def _loads_out(idx, table, unroll):
    """Check the arguments of `loads_cuda` and `loads_serial_cuda`;
    returns (BB, idx's width, the output, not yet written)."""
    dev = common.cuda_input(idx, "idx", 2)
    common.cuda_input(table, "table", 2, dev)
    if table.shape[1] != 128:
        raise ValueError(f"table rows have {table.shape[1]} words, not 128")
    bb, width = idx.shape
    if width < 2:
        raise ValueError(f"idx must have 2 columns or more, got {width}")
    if unroll not in (1, LOADS_UNROLL):
        raise ValueError(f"unroll must be 1 or {LOADS_UNROLL}, got {unroll}")
    if unroll != 1 and bb % LOADS_UNROLL:
        raise ValueError(f"unrolled: BB must be a multiple of "
                         f"{LOADS_UNROLL}, got {bb}")
    return bb, width, idx.new_empty(2 * bb, 128)


def loads_cuda(idx, table, unroll=1):
    """`loads_plain` by kernel C12's grid form, the 2 BB row copies spread
    over the card, for either unroll (1, or LOADS_UNROLL with BB a
    multiple of it); every index read must lie in [0, NROW)."""
    global launches_loads
    bb, width, out = _loads_out(idx, table, unroll)
    if bb:
        _build.check(_build.lib().nabwa_probe_loads(
            idx.data_ptr(), width, table.data_ptr(), bb, out.data_ptr(),
            _build.stream_of(idx)), "probe_loads kernel launch")
        with _build.count_lock:
            launches_loads += 1
    return out


def loads_serial_cuda(idx, table, unroll=1):
    """`loads_plain` by C12's serial forms, one warp walking the BB bodies
    in order, rolled (unroll 1) or LOADS_UNROLL bodies at a time: the
    probe's witness of one row load's latency.  Arguments as
    `loads_cuda`."""
    global launches_loads_serial
    bb, width, out = _loads_out(idx, table, unroll)
    if bb:
        _build.check(_build.lib().nabwa_probe_loads_serial(
            idx.data_ptr(), width, table.data_ptr(), bb, int(unroll != 1),
            out.data_ptr(), _build.stream_of(idx)),
            "probe_loads_serial kernel launch")
        with _build.count_lock:
            launches_loads_serial += 1
    return out


def loads(idx, table, unroll=1):
    """Probe B: the plain version for CPU tensors, kernel C12 for CUDA
    tensors."""
    return common.dispatch("loads", idx, loads_plain, loads_cuda, table, unroll)


def lanereduce_plain(x):
    """Probe E's kernel in plain PyTorch: int32 [R, W] -> its int32 sum
    over axis 1, [R, 1] (jnp wraps; torch would sum into int64)."""
    return wsum(x.long(), dim=1, keepdim=True).to(torch.int32)


def lanereduce_cuda(x):
    """`lanereduce_plain` by kernel C14 (W = 128)."""
    global launches_lanereduce
    common.cuda_input(x, "x", 2)
    rows, width = x.shape
    if width != 128:
        raise ValueError(f"x rows have {width} words, not 128")
    out = x.new_empty(rows, 1)
    if rows:
        _build.check(_build.lib().nabwa_probe_lanereduce(
            x.data_ptr(), rows, out.data_ptr(), _build.stream_of(x)),
            "probe_lanereduce kernel launch")
        with _build.count_lock:
            launches_lanereduce += 1
    return out


def lanereduce(x):
    """Probe E: the plain version for CPU tensors, kernel C14 for CUDA
    tensors."""
    return common.dispatch("lanereduce", x, lanereduce_plain, lanereduce_cuda)


def pop_plain(x):
    """Probe F's kernel in plain PyTorch, line for line
    (scripts/probe_pallas2.py:186-198): x int32 [R, S] -> (out int32 [R,
    min(S, 128)], the final key int32 [R, S], each round's minimum int32
    [POP_ITERS, R])."""
    key = x.long()
    f = key ^ 21
    mks = []
    for _ in range(POP_ITERS):
        mk = key.min(dim=1, keepdim=True).values
        pm = key == mk
        e1 = wsum(torch.where(pm, f, 0), dim=1)
        key = torch.where(pm, FREE_KEY, key)
        key[:, 0] = torch.minimum(key[:, 0], e1)
        mks.append(mk[:, 0])
    key = key.to(torch.int32)
    return (key[:, :POP_OUT].contiguous(), key,
            torch.stack(mks).to(torch.int32))


def pop_cuda(x):
    """`pop_plain` by kernel C13 (S = 256)."""
    global launches_pop
    dev = common.cuda_input(x, "x", 2)
    rows = x.shape[0]
    if x.shape[1] != POP_S:
        raise ValueError(f"x rows have {x.shape[1]} slots, not {POP_S}")
    out = torch.empty((rows, POP_OUT), dtype=torch.int32, device=dev)
    state = torch.empty((rows, POP_S), dtype=torch.int32, device=dev)
    witness = torch.empty((POP_ITERS, rows), dtype=torch.int32, device=dev)
    if rows == 0:
        return out, state, witness
    rc = _build.lib().nabwa_probe_pop(
        x.data_ptr(), rows, POP_ITERS, out.data_ptr(), state.data_ptr(),
        witness.data_ptr(), _build.stream_of(x))
    _build.check(rc, "probe_pop kernel launch")
    with _build.count_lock:
        launches_pop += 1
    return out, state, witness


def pop(x):
    """Probe F: the plain version for CPU tensors, kernel C13 for CUDA
    tensors.  Returns (out, final key, each round's minimum)."""
    return common.dispatch("pop", x, pop_plain, pop_cuda)


def lane_gather_plain(x, i):
    """Probe C's kernel in plain PyTorch: x int32 [R, W], i int32 [R, W']
    indices in [0, W) -> out[r, c] = x[r, i[r, c]], int32 [R, W']."""
    return torch.take_along_dim(x, i.long(), dim=1)


def lane_gather_cuda(x, i):
    """`lane_gather_plain` by kernel C20 (x and i [R, 128]); the indices
    are not checked (`lane_gather` does).  One check pass over both
    inputs reads each one's device and data pointer once; the launch
    reuses them."""
    global launches_lane_gather
    dev, (px, pi) = common.cuda_inputs((x, "x", 2, I32), (i, "i", 2, I32))
    shape = x.shape
    if shape[1] != GATHER_W or i.shape != shape:
        raise ValueError(f"x and i must be [R, {GATHER_W}], got "
                         f"{tuple(shape)} and {tuple(i.shape)}")
    rows = shape[0]
    out = x.new_empty(rows, GATHER_W)
    if rows == 0:
        return out
    _build.check(_build.lib().nabwa_probe_lane_gather(
        px, pi, rows, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev)),
        "probe_lane_gather kernel launch")
    with _build.count_lock:
        launches_lane_gather += 1
    return out


def lane_gather(x, i):
    """Probe C: the plain version for CPU tensors, kernel C20 for CUDA
    tensors; refuses indices outside [0, x's columns)."""
    common.check_indices("lane_gather", x.shape[1], i)
    return _lane_gather(x, i)


def _lane_gather(x, i):
    """`lane_gather` without its index check."""
    return common.dispatch("lane_gather", x, lane_gather_plain,
                           lane_gather_cuda, i)


def push_values(v):
    """The five fields of a push of v (scripts/probe_pallas2.py:124-129)
    on int64 values holding int32s: [5, *v.shape]."""
    return torch.stack([v, wrap32(v + 1), v ^ 3, wrap32(v - 7),
                        wrap32(v * 3)])


def scalar_push_plain(c):
    """Probe D's kernel in plain PyTorch, each row's pushes at once
    (scripts/probe_pallas2.py:115-142): c int32 [R, W >= 8] -> (out int32
    [R, 128], the five field buffers int32 [5, R, 256], top int32 [R,
    128]).  A slot no push reaches holds UNWRITTEN."""
    dev = c.device
    rows = c.shape[0]
    cc = c.long()
    fields = torch.full((PUSH_FIELDS, rows, PUSH_S), UNWRITTEN,
                        dtype=torch.int64, device=dev)
    t = torch.zeros(rows, dtype=torch.int64, device=dev)
    row = torch.arange(rows, device=dev)
    vals = [push_values(cc[:, j]) for j in range(3)]
    for it in range(PUSH_ROUNDS):
        n = cc[:, it & 7] & 3
        for j in range(3):
            m = j < n
            fields[:, row[m], t[m]] = vals[j][:, m]
            t = torch.where(m, (t + 1) & (PUSH_S - 1), t)
    top = torch.zeros((rows, PUSH_OUT), dtype=torch.int64, device=dev)
    top[:, 0] = t
    out = wrap32(fields[0, :, :PUSH_OUT] + top)
    return (out.to(torch.int32), fields.to(torch.int32),
            top.to(torch.int32))


def scalar_push_cuda(c):
    """`scalar_push_plain` by kernel C21 (c [R, 128])."""
    global launches_scalar_push
    dev = common.cuda_input(c, "c", 2)
    rows = c.shape[0]
    if c.shape[1] != PUSH_OUT:
        raise ValueError(f"c rows have {c.shape[1]} words, not {PUSH_OUT}")
    out = torch.empty((rows, PUSH_OUT), dtype=torch.int32, device=dev)
    fields = torch.empty((PUSH_FIELDS, rows, PUSH_S), dtype=torch.int32,
                         device=dev)
    top = torch.empty_like(out)
    if rows == 0:
        return out, fields, top
    rc = _build.lib().nabwa_probe_scalar_push(
        c.data_ptr(), rows, fields.data_ptr(), top.data_ptr(),
        out.data_ptr(), _build.stream_of(c))
    _build.check(rc, "probe_scalar_push kernel launch")
    with _build.count_lock:
        launches_scalar_push += 1
    return out, fields, top


def scalar_push(c):
    """Probe D: the plain version for CPU tensors, kernel C21 for CUDA
    tensors.  Returns (out, the five field buffers, top)."""
    return common.dispatch("scalar_push", c, scalar_push_plain,
                           scalar_push_cuda)


def probe_empty(device):
    """Probe A on the script's input; prints its line.  Returns (seconds
    per call, result)."""
    x_t, = common.tensors(device, np.zeros(EMPTY_SHAPE))
    dt, r = common.timeit(lambda: empty(x_t), device, n=50)
    print(f"probeA empty kernel: {dt*1e6:.1f}us")
    return dt, r


def probe_loads(device, unroll):
    """Probe B at `unroll` on the script's inputs; prints its line, `ok`
    over all 2 BB rows (the script's checks the first BB).  Returns
    (seconds per call, result, ok)."""
    idx = np.random.randint(0, NROW, (BB, 128))
    table = _table()
    idx_t, table_t = common.tensors(device, idx, table)
    dt, r = common.timeit(lambda: loads(idx_t, table_t, unroll), device)
    ok = np.array_equal(r.cpu().numpy(),
                        np.concatenate([table[idx[:, 0]], table[idx[:, 1]]]))
    print(f"probeB 2x{BB} rowloads unroll={unroll}: {dt*1e6:.1f}us "
          f"({dt/(2*BB)*1e9:.0f}ns/load)  ok={ok}")
    return dt, r, ok


def probe_lane_gather(device):
    """Probe C on the script's inputs; prints its line.  The indices are
    checked once, and the timed calls skip the check.  Returns (seconds
    per call, result, ok)."""
    x = np.random.randint(0, 99, (BB, GATHER_W))
    i = np.random.randint(0, GATHER_W, (BB, GATHER_W))
    x_t, i_t = common.tensors(device, x, i)
    common.check_indices("lane_gather", x_t.shape[1], i_t)
    dt, r = common.timeit(lambda: _lane_gather(x_t, i_t), device)
    ok = np.array_equal(r.cpu().numpy(), np.take_along_axis(x, i, axis=1))
    print(f"probeC take_along_axis lanes: {dt*1e6:.1f}us ok={ok}")
    return dt, r, ok


def probe_scalar_push(device):
    """Probe D on the script's input; prints its line.  Returns (seconds
    per call, (out, fields, top))."""
    c_t, = common.tensors(device, np.random.randint(0, 1 << 20,
                                                    (BB, PUSH_OUT)))
    dt, r = common.timeit(lambda: scalar_push(c_t), device, n=5)
    print(f"probeD scalar push {PUSH_ROUNDS} iters x {BB} lanes x <=3 "
          f"cands: {dt*1e3:.2f}ms ({dt/PUSH_ROUNDS*1e6:.1f}us/iter)")
    return dt, r


def probe_lanereduce(device):
    """Probe E on the script's input; prints its line.  Returns (seconds
    per call, result, ok)."""
    x = np.random.randint(0, 99, REDUCE_SHAPE)
    x_t, = common.tensors(device, x)
    dt, r = common.timeit(lambda: lanereduce(x_t), device)
    ok = np.array_equal(r.cpu().numpy()[:, 0], x.sum(1))
    print(f"probeE [512,128] lane-sum: {dt*1e6:.1f}us ok={ok}")
    return dt, r, ok


def probe_pop(device):
    """Probe F on the script's input; prints its line.  Returns (seconds
    per call, (out, key, witness))."""
    x = np.random.randint(0, 1 << 20, (BB, POP_S))
    x_t, = common.tensors(device, x)
    dt, r = common.timeit(lambda: pop(x_t), device, n=5)
    print(f"probeF pop-shape {POP_ITERS} iters S={POP_S}: {dt*1e3:.2f}ms "
          f"({dt/POP_ITERS*1e6:.1f}us/iter)")
    return dt, r


PROBES = {"A": probe_empty, "B1": lambda d: probe_loads(d, 1),
          "BU": lambda d: probe_loads(d, LOADS_UNROLL),
          "C": probe_lane_gather, "D": probe_scalar_push,
          "E": probe_lanereduce, "F": probe_pop}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, which = common.parse_device(argv, "probe_pallas2")
    if device is None:
        return 1
    which = which or list(PROBES)
    for w in which:
        if w not in PROBES:
            print(f"[probe_pallas2] probe {w}: no such probe",
                  file=sys.stderr)
            return 1
    print("devices:", [common.device_name(device)])
    for w in which:
        PROBES[w](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
