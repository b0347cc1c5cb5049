"""Probes 7 and 8 of scripts/probe_pallas3.py on the card.

    python -m nabwa_tpu_torch.probes.probe_pallas3 [--device cuda|cpu]
                                                   [7] [8]

Probe 7, `p7` (scripts/probe_pallas3.py:202, through `call` at :25-31,
pallas_call at :28): 200 chained steps v <- (v + i) ^ (v >> 2), i =
0..199, on x int32 of [1, 256], [256, 1], [8, 256] and [8, 512]
(wrapping); on a CUDA tensor kernel C25, one thread an element.

Probe 8, `p8` (:222): from v = b int32 [256, 128], 30 steps v <- where(v
> a, v - a, v + i), i = 0..29, with a int32 [256, 1] broadcast over each
row's columns (the DFS's expansion shape); kernel C26, a row a warp and
its scalar one broadcast load.  C25 and C26 are in csrc/probe_pallas3.cu.

The inputs are the script's, unseeded as there (`np.random`); each probe
prints the script's result line with the time of 20 calls after one
(`timeit`, :15), by CUDA events on the card.  The script's other probes,
1, 1b and 2-6 (NOT_PORTED), are not ported yet and exit non-zero; a name
the script does not have exits non-zero too.  With no name, the ported
probes run.  Unlike the script, which prints "FAILED" and goes on
(:55-56), a failure here exits non-zero.
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

# kernel launches made on CUDA tensors: C25 by `p7`, C26 by `p8`
launches_p7 = 0
launches_p8 = 0


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


PROBES = {"7": probe_p7, "8": probe_p8}
NOT_PORTED = ("1", "1b", "2", "3", "4", "5", "6")


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
