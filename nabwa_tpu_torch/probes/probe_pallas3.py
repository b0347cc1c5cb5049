"""Probes 1, 1b, 3, 4, 7 and 8 of scripts/probe_pallas3.py on the card.

    python -m nabwa_tpu_torch.probes.probe_pallas3 [--device cuda|cpu]
                                                   [1] [1b] [3] [4] [7] [8]

Probe 1, `p1` (scripts/probe_pallas3.py:35, through `call` at :25-31,
pallas_call at :28): 256 rounds, round k copying row i[k, 0] of a table t
int32 [4096, 128] to out row k and row i[k, 1] (lanes 0 and 1 of row k of
i int32 [256, 128]) to out row k + 256; kernel C27, a warp an out row.

Probe 1b, `p1b` (:60): the same copies with the indices in two columns i
and j int32 [256, 1]; kernel C28, C27's kernel given other index strides.

Probe 3, `p3` (:123): take_along_axis on axis 0, out[r, c] = x[i[r, c],
c] for x int32 [128, 128] and i [8, 128]; kernel C29, a thread an element.

Probe 4, `p4` (:140): the relayout x[:, :16].reshape(64, 128) of x int32
[512, 128]; kernel C30, a thread an out int4.

Probes 1, 1b and 3 refuse indices outside the table's or x's rows before
any launch: the script draws none, and Pallas interpret mode, unlike a
gather, wraps or clamps them (p1 reads row 15 of a 16-row table for both
-1 and 99).

Probe 7, `p7` (:202): 200 chained steps v <- (v + i) ^ (v >> 2), i =
0..199, on x int32 of [1, 256], [256, 1], [8, 256] and [8, 512]
(wrapping); on a CUDA tensor kernel C25, one thread an element.

Probe 8, `p8` (:222): from v = b int32 [256, 128], 30 steps v <- where(v
> a, v - a, v + i), i = 0..29, with a int32 [256, 1] broadcast over each
row's columns (the DFS's expansion shape); kernel C26, a row a warp and
its scalar one broadcast load.  C25-C30 are in csrc/probe_pallas3.cu.

The inputs are the script's, unseeded as there (`np.random`); each probe
prints the script's result line with the time of 20 calls after one
(`timeit`, :15), by CUDA events on the card, and probes 1-4 its `ok`
against the host copy of the inputs.  The script's other probes, 2, 5
and 6 (NOT_PORTED), are not ported yet and exit non-zero; a name the
script does not have exits non-zero too.  With no name, the ported
probes run in the script's order.  Unlike the script, which prints
"FAILED" and goes on (:55-56), a failure here, `ok=False` included,
exits non-zero.
"""

import sys

import numpy as np
import torch

from ..ops import _build
from . import common
from .common import wrap32

P7_SHAPES = ((1, 256), (256, 1), (8, 256), (8, 512))   # :211
P7_STEPS = 200                                          # :206
P8_ROWS, P8_COLS, P8_STEPS = 256, 128, 30               # :227, :232-233
P1_ROUNDS = 256                                         # :43, :68
P1_TABLE = (4096, 128)                                  # :47, :73
P3_X, P3_I = (128, 128), (8, 128)                       # :128-129
P4_X = (512, 128)                                       # :145
P4_WIDTH, P4_FOLD = 16, 8        # :142: 16 words of 8 rows an out row

# kernel launches made on CUDA tensors: C25 by `p7`, C26 by `p8`, C27 by
# `p1`, C28 by `p1b`, C29 by `p3`, C30 by `p4`
launches_p7 = 0
launches_p8 = 0
launches_p1 = 0
launches_p1b = 0
launches_p3 = 0
launches_p4 = 0


def row_copies(a, b, t):
    """The loop of probes 1 and 1b (scripts/probe_pallas3.py:37-43, :62-68)
    in plain PyTorch, round by round: round k copies table row t[a[k]] to
    out row k and t[b[k]] to out row k + n, for a and b int32 [n] in [0,
    t's rows) -> int32 [2 n, t's columns]."""
    n = a.shape[0]
    out = torch.empty((2 * n, t.shape[1]), dtype=torch.int32,
                      device=t.device)
    for k, (r, r2) in enumerate(zip(a.tolist(), b.tolist())):
        out[k] = t[r]
        out[k + n] = t[r2]
    return out


def p1_plain(i, t):
    """Probe 1's kernel in plain PyTorch: i int32 [n, W], W >= 2, whose
    lanes 0 and 1 index t int32 [R, C] -> int32 [2 n, C]."""
    return row_copies(i[:, 0], i[:, 1], t)


def _table_input(t, dev):
    """Check the table of C27 and C28 (its rows are read as int4)."""
    common.cuda_input(t, "t", 2, dev)
    if t.shape[1] % 4:
        raise ValueError(f"t's rows must be a multiple of 4 words, got "
                         f"{t.shape[1]}")


def p1_cuda(i, t):
    """`p1_plain` by kernel C27; t's columns a multiple of 4.  The indices
    are not checked (`p1` does)."""
    global launches_p1
    dev = common.cuda_input(i, "i", 2)
    _table_input(t, dev)
    if i.shape[1] < 2:
        raise ValueError(f"i must be [n, W] with W >= 2, got "
                         f"{tuple(i.shape)}")
    out = torch.empty((2 * i.shape[0], t.shape[1]), dtype=torch.int32,
                      device=dev)
    if out.numel() == 0:
        return out
    rc = _build.lib().nabwa_probe_p1(i.data_ptr(), i.shape[1], i.shape[0],
                                     t.data_ptr(), t.shape[1],
                                     out.data_ptr(), _build.stream_of(i))
    _build.check(rc, "probe_p1 kernel launch")
    with _build.count_lock:
        launches_p1 += 1
    return out


def p1(i, t):
    """Probe 1: the plain version for CPU tensors, kernel C27 for CUDA
    tensors; refuses indices outside [0, t's rows)."""
    common.check_indices("p1", t.shape[0], i[:, :2])
    return _p1(i, t)


def _p1(i, t):
    """`p1` without its index check."""
    return common.dispatch("p1", i, p1_plain, p1_cuda, t)


def p1b_plain(i, j, t):
    """Probe 1b's kernel in plain PyTorch: i and j int32 [n, 1] indexing t
    int32 [R, C] -> int32 [2 n, C]."""
    return row_copies(i[:, 0], j[:, 0], t)


def p1b_cuda(i, j, t):
    """`p1b_plain` by kernel C28; t's columns a multiple of 4.  The
    indices are not checked (`p1b` does)."""
    global launches_p1b
    dev = common.cuda_input(i, "i", 2)
    common.cuda_input(j, "j", 2, dev)
    _table_input(t, dev)
    if i.shape[1] != 1 or j.shape != i.shape:
        raise ValueError(f"i and j must be [n, 1], got {tuple(i.shape)} "
                         f"and {tuple(j.shape)}")
    out = torch.empty((2 * i.shape[0], t.shape[1]), dtype=torch.int32,
                      device=dev)
    if out.numel() == 0:
        return out
    rc = _build.lib().nabwa_probe_p1b(i.data_ptr(), j.data_ptr(),
                                      i.shape[0], t.data_ptr(), t.shape[1],
                                      out.data_ptr(), _build.stream_of(i))
    _build.check(rc, "probe_p1b kernel launch")
    with _build.count_lock:
        launches_p1b += 1
    return out


def p1b(i, j, t):
    """Probe 1b: the plain version for CPU tensors, kernel C28 for CUDA
    tensors; refuses indices outside [0, t's rows)."""
    common.check_indices("p1b", t.shape[0], i, j)
    return _p1b(i, j, t)


def _p1b(i, j, t):
    """`p1b` without its index check."""
    return common.dispatch("p1b", i, p1b_plain, p1b_cuda, j, t)


def p3_plain(x, i):
    """Probe 3's kernel in plain PyTorch: x int32 [R, C], i int32 [M, C]
    in [0, R) -> out[r, c] = x[i[r, c], c], int32 [M, C]."""
    return torch.take_along_dim(x, i.long(), dim=0)


def p3_cuda(x, i):
    """`p3_plain` by kernel C29.  The indices are not checked (`p3`
    does)."""
    global launches_p3
    dev = common.cuda_input(x, "x", 2)
    common.cuda_input(i, "i", 2, dev)
    if i.shape[1] != x.shape[1]:
        raise ValueError(f"x and i must be [R, C] and [M, C], got "
                         f"{tuple(x.shape)} and {tuple(i.shape)}")
    out = torch.empty_like(i)
    if i.numel() == 0:
        return out
    rc = _build.lib().nabwa_probe_p3(x.data_ptr(), x.shape[1], i.data_ptr(),
                                     i.numel(), out.data_ptr(),
                                     _build.stream_of(x))
    _build.check(rc, "probe_p3 kernel launch")
    with _build.count_lock:
        launches_p3 += 1
    return out


def p3(x, i):
    """Probe 3: the plain version for CPU tensors, kernel C29 for CUDA
    tensors; refuses indices outside [0, x's rows)."""
    common.check_indices("p3", x.shape[0], i)
    return _p3(x, i)


def _p3(x, i):
    """`p3` without its index check."""
    return common.dispatch("p3", x, p3_plain, p3_cuda, i)


def p4_plain(x):
    """Probe 4's kernel in plain PyTorch: x int32 [R, W], R a multiple of
    8, W >= 16 -> x[:, :16].reshape(R / 8, 128)."""
    return x[:, :P4_WIDTH].reshape(-1, P4_FOLD * P4_WIDTH)


def p4_cuda(x):
    """`p4_plain` by kernel C30; W a multiple of 4."""
    global launches_p4
    common.cuda_input(x, "x", 2)
    rows, cols = x.shape
    if rows % P4_FOLD:
        raise ValueError(f"x's rows must be a multiple of {P4_FOLD}, got "
                         f"{rows}")
    if cols < P4_WIDTH or cols % 4:
        raise ValueError(f"x's rows must be a multiple of 4 words and at "
                         f"least {P4_WIDTH}, got {cols}")
    out = torch.empty((rows // P4_FOLD, P4_FOLD * P4_WIDTH),
                      dtype=torch.int32, device=x.device)
    if rows == 0:
        return out
    rc = _build.lib().nabwa_probe_p4(x.data_ptr(), rows, cols,
                                     out.data_ptr(), _build.stream_of(x))
    _build.check(rc, "probe_p4 kernel launch")
    with _build.count_lock:
        launches_p4 += 1
    return out


def p4(x):
    """Probe 4: the plain version for CPU tensors, kernel C30 for CUDA
    tensors."""
    return common.dispatch("p4", x, p4_plain, p4_cuda)


def p7_step(v, i):
    """Step i of probe 7 (scripts/probe_pallas3.py:207) on int64 values
    holding int32s."""
    return wrap32(v + i) ^ (v >> 2)


def p7_plain(x):
    """Probe 7's kernel in plain PyTorch: the 200 steps on each int32 of x
    -> int32, x's shape."""
    v = x.long()
    for i in range(P7_STEPS):
        v = p7_step(v, i)
    return v.to(torch.int32)


def p7_cuda(x):
    """`p7_plain` by kernel C25."""
    global launches_p7
    common.cuda_input(x, "x", x.dim())
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = _build.lib().nabwa_probe_p7(x.data_ptr(), x.numel(), out.data_ptr(),
                                     _build.stream_of(x))
    _build.check(rc, "probe_p7 kernel launch")
    with _build.count_lock:
        launches_p7 += 1
    return out


def p7(x):
    """Probe 7: the plain version for CPU tensors, kernel C25 for CUDA
    tensors."""
    return common.dispatch("p7", x, p7_plain, p7_cuda)


def p8_step(v, a, i):
    """Step i of probe 8 (scripts/probe_pallas3.py:228) on int64 values
    holding int32s, a broadcast over v."""
    return torch.where(v > a, wrap32(v - a), wrap32(v + i))


def p8_plain(a, b):
    """Probe 8's kernel in plain PyTorch: a int32 [R, 1], b int32 [R, C]
    -> int32 [R, C]."""
    v, s = b.long(), a.long()
    for i in range(P8_STEPS):
        v = p8_step(v, s, i)
    return v.to(torch.int32)


def p8_cuda(a, b):
    """`p8_plain` by kernel C26; C a multiple of 4."""
    global launches_p8
    dev = common.cuda_input(b, "b", 2)
    common.cuda_input(a, "a", 2, dev)
    rows, cols = b.shape
    if tuple(a.shape) != (rows, 1):
        raise ValueError(f"a must be [{rows}, 1], got {tuple(a.shape)}")
    if cols % 4:
        raise ValueError(f"b's rows must be a multiple of 4 words, got "
                         f"{cols}")
    out = torch.empty_like(b)
    if b.numel() == 0:
        return out
    rc = _build.lib().nabwa_probe_p8(a.data_ptr(), b.data_ptr(), rows, cols,
                                     out.data_ptr(), _build.stream_of(b))
    _build.check(rc, "probe_p8 kernel launch")
    with _build.count_lock:
        launches_p8 += 1
    return out


def p8(a, b):
    """Probe 8: the plain version for CPU tensors, kernel C26 for CUDA
    tensors."""
    return common.dispatch("p8", a, p8_plain, p8_cuda, b)


def probe_p7(device):
    """Probe 7 on the script's inputs, one line a shape.  Returns [(shape,
    seconds per call, result)]."""
    res = []
    for shape in P7_SHAPES:
        x_t, = common.tensors(device, np.random.randint(0, 99, shape))
        dt, r = common.timeit(lambda: p7(x_t), device)
        print(f"P7 {P7_STEPS} ops on {shape}: {dt*1e6:.1f}us")
        res.append((shape, dt, r))
    return res


def probe_p8(device):
    """Probe 8 on the script's inputs; prints its line.  Returns (seconds
    per call, result)."""
    a = np.random.randint(1, 99, (P8_ROWS, 1))
    b = np.random.randint(0, 99, (P8_ROWS, P8_COLS))
    a_t, b_t = common.tensors(device, a, b)
    dt, r = common.timeit(lambda: p8(a_t, b_t), device)
    print(f"P8 {P8_STEPS} col-broadcast ops on [{P8_ROWS},{P8_COLS}]: "
          f"{dt*1e6:.1f}us")
    return dt, r


def _result(line, ok):
    """Print a probe's result line; a wrong result exits non-zero."""
    print(f"{line} ok={ok}")
    if not ok:
        raise SystemExit(f"[probe_pallas3] wrong result: {line}")


def probe_p1(device):
    """Probe 1 on the script's inputs; the indices are checked once, and
    the timed calls skip the check.  Returns (seconds per call, result)."""
    i = np.random.randint(0, P1_TABLE[0], (P1_ROUNDS, P1_TABLE[1]))
    t = np.random.randint(0, 99, P1_TABLE)
    i_t, t_t = common.tensors(device, i, t)
    common.check_indices("p1", t_t.shape[0], i_t[:, :2])
    dt, r = common.timeit(lambda: _p1(i_t, t_t), device)
    got = r.cpu().numpy()
    ok = (np.array_equal(got[:P1_ROUNDS], t[i[:, 0]])
          and np.array_equal(got[P1_ROUNDS:], t[i[:, 1]]))
    _result(f"P1 lane-1 scalar read: {dt*1e6:.1f}us", ok)
    return dt, r


def probe_p1b(device):
    """Probe 1b on the script's inputs, as `probe_p1`."""
    i = np.random.randint(0, P1_TABLE[0], (P1_ROUNDS, 1))
    j = np.random.randint(0, P1_TABLE[0], (P1_ROUNDS, 1))
    t = np.random.randint(0, 99, P1_TABLE)
    i_t, j_t, t_t = common.tensors(device, i, j, t)
    common.check_indices("p1b", t_t.shape[0], i_t, j_t)
    dt, r = common.timeit(lambda: _p1b(i_t, j_t, t_t), device)
    got = r.cpu().numpy()
    ok = (np.array_equal(got[:P1_ROUNDS], t[i[:, 0]])
          and np.array_equal(got[P1_ROUNDS:], t[j[:, 0]]))
    _result(f"P1b two-col scalar reads {2 * P1_ROUNDS} loads: "
            f"{dt*1e6:.1f}us", ok)
    return dt, r


def probe_p3(device):
    """Probe 3 on the script's inputs, as `probe_p1`."""
    x = np.random.randint(0, 99, P3_X)
    i = np.random.randint(0, P3_X[0], P3_I)
    x_t, i_t = common.tensors(device, x, i)
    common.check_indices("p3", x_t.shape[0], i_t)
    dt, r = common.timeit(lambda: _p3(x_t, i_t), device)
    ok = np.array_equal(r.cpu().numpy(), np.take_along_axis(x, i, axis=0))
    _result(f"P3 take_along_axis sublanes: {dt*1e6:.1f}us", ok)
    return dt, r


def probe_p4(device):
    """Probe 4 on the script's inputs.  Returns (seconds per call,
    result)."""
    x = np.random.randint(0, 99, P4_X)
    x_t, = common.tensors(device, x)
    dt, r = common.timeit(lambda: p4(x_t), device)
    out_rows = P4_X[0] // P4_FOLD
    ok = np.array_equal(r.cpu().numpy(),
                        x[:, :P4_WIDTH].reshape(out_rows, -1))
    _result(f"P4 reshape [{P4_X[0]},{P4_WIDTH}]->[{out_rows},"
            f"{P4_FOLD * P4_WIDTH}]: {dt*1e6:.1f}us", ok)
    return dt, r


PROBES = {"1": probe_p1, "1b": probe_p1b, "3": probe_p3, "4": probe_p4,
          "7": probe_p7, "8": probe_p8}
NOT_PORTED = ("2", "5", "6")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, which = common.parse_device(argv, "probe_pallas3")
    if device is None:
        return 1
    which = which or list(PROBES)
    for w in which:
        if w not in PROBES:
            why = ("not yet ported to nabwa_tpu_torch" if w in NOT_PORTED
                   else "no such probe")
            print(f"[probe_pallas3] probe {w}: {why}", file=sys.stderr)
            return 1
    print("devices:", [common.device_name(device)])
    for w in which:
        PROBES[w](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
