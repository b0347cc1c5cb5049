"""scripts/probe_colops.py on the card: the cost of a dependent int32 step
by the shape it runs on.

    T=2000 K=64 python -m nabwa_tpu_torch.probes.probe_colops
                                                   [--device cuda|cpu]

The script's kernel (`make`, scripts/probe_colops.py:23, pallas_call at
:39) runs T rounds of K dependent steps v <- (v * 3 + 1) ^ (v >> 2) on
each int32 of its input (wrapping), the input's shape out.  T and K come
from the environment (defaults 2000 and 64); the script runs its five
shapes on zeros and prints each one's time and ns an op (the time over
3 T K).

On a CUDA tensor kernel C24 (csrc/probe_colops.cu) runs each element's
chain in one thread.  The script's shapes give at most one warp per
scheduler, so its time is the chain's latency and nearly the same at
every shape.
"""

import os
import sys

import numpy as np
import torch

from ..ops import _build
from . import common
from .common import wrap32

SHAPES = ((64, 1), (8, 128), (64, 128), (1, 128), (64, 256))  # :51
DEFAULT_T, DEFAULT_K = 2000, 64                              # :19-20

# kernel launches made on CUDA tensors (C24)
launches = 0


def colops_step(v):
    """One step (scripts/probe_colops.py:30) on int64 values holding
    int32s."""
    return wrap32(v * 3 + 1) ^ (v >> 2)


def colops_plain(x, t, k):
    """The script's kernel in plain PyTorch: x int32, any shape; t rounds
    of k steps -> int32, x's shape."""
    v = x.long()
    for _ in range(max(t, 0) * max(k, 0)):
        v = colops_step(v)
    return v.to(torch.int32)


def colops_cuda(x, t, k):
    """`colops_plain` by kernel C24."""
    global launches
    common.cuda_input(x, "x", x.dim())
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = _build.lib().nabwa_probe_colops(x.data_ptr(), x.numel(), int(t),
                                         int(k), out.data_ptr(),
                                         _build.stream_of(x))
    _build.check(rc, "probe_colops kernel launch")
    with _build.count_lock:
        launches += 1
    return out


def colops(x, t, k):
    """The script's kernel: the plain version for CPU tensors, kernel C24
    for CUDA tensors."""
    return common.dispatch("colops", x, colops_plain, colops_cuda, t, k)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, rest = common.parse_device(argv, "probe_colops")
    if device is None:
        return 1
    if rest:
        print(f"[probe_colops] takes no arguments (T and K from the "
              f"environment), got {rest}", file=sys.stderr)
        return 1
    try:
        t = int(os.environ.get("T", str(DEFAULT_T)))
        k = int(os.environ.get("K", str(DEFAULT_K)))
        if t < 1 or k < 1:
            raise ValueError(f"T and K must be at least 1, got T={t} K={k}")
    except ValueError as e:
        print(f"[probe_colops] {e}", file=sys.stderr)
        return 1
    for shape in SHAPES:
        x_t, = common.tensors(device, np.zeros(shape))
        dt, _ = common.timeit(lambda: colops(x_t, t, k), device, n=1)
        per_op = dt / (t * k * 3)
        print(f"{str(shape):10s}  {dt*1e3:7.1f} ms  {per_op*1e9:8.2f} ns/op")
    return 0


if __name__ == "__main__":
    sys.exit(main())
