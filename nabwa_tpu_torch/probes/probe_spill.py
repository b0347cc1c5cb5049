"""scripts/probe_spill.py on the card: K independent int32 values live in
one lane, updated T times.

    K=24 T=2000 python -m nabwa_tpu_torch.probes.probe_spill
                                                  [--device cuda|cpu]

The script's kernel (`make`, scripts/probe_spill.py:23, pallas_call at
:45) takes each int32 x of its input to K values v_i = x + i, runs T
rounds of the simultaneous update v_i <- (v_i * 3 + 1) ^ (v_{(i+1) mod K}
>> 2), and writes the wrapping int32 sum of the K values, the input's
shape.  K and T come from the environment (defaults 24 and 2000); the
script runs its four shapes on zeros and prints one line each.

On a CUDA tensor kernel C23 (csrc/probe_spill.cu) runs in its lane form
(`spill_cuda`): one element's K values spread over a group of L lanes,
M = K / L values a lane, one shuffle a round within the group (L from K
and the element count, `default_lanes`, unless asked).  `spill_witness_cuda`
runs the first design, the witness: one element's K values in one
thread's registers, K a template parameter instantiated for SPILL_KS,
which reaches past ptxas's 255 registers a thread, so the TPU's
vector-register spill question becomes the card's register spill.  A K
outside SPILL_KS is refused, on the CPU too, so that the entry point runs
what the card can.
"""

import os
import sys

import numpy as np
import torch

from ..ops import _build
from . import common
from .common import wrap32, wsum

# csrc/probe_spill.cu's SPILL_KS, the K kernel C23 is built for, and
# SPILL_MS, the values a lane its lane form is built for
SPILL_KS = (1, 2, 24, 64, 128, 240, 248, 256, 320)
SPILL_MS = (1, 2, 3, 6, 12, 8, 16, 32, 30, 31, 40)
LANES = (1, 2, 4, 8)                                 # a group's lanes
# threads past which the lane form stops widening its groups: a warp for
# each of an H100's 132 x 4 schedulers
LANE_FILL = 132 * 4 * 32
SHAPES = ((64, 1), (1, 128), (8, 128), (64, 128))    # probe_spill.py:53
DEFAULT_T, DEFAULT_K = 2000, 24                      # probe_spill.py:19-20
I32 = torch.int32

# kernel launches made on CUDA tensors: C23's lane form by `spill_cuda`,
# its witness by `spill_witness_cuda`
launches = 0
launches_witness = 0


def check_k(k):
    """Raise ValueError unless kernel C23 is built for k."""
    if k not in SPILL_KS:
        raise ValueError(f"K={k} is not one of the K kernel C23 is built "
                         f"for: {', '.join(map(str, SPILL_KS))}")


def default_lanes(k, n):
    """The lane form's group for n elements of K values.  Of the groups it
    is built for (L of 8, 4, 2, 1 dividing K, K / L in SPILL_MS) and that
    hold at least 3 values a lane (or are one lane: a shuffle's latency
    every round would outweigh one or two values' updates), the widest
    whose n L threads stay within LANE_FILL, else the narrowest: wide
    groups shorten a warp's serial round while the card has schedulers to
    spare, and only add shuffles and loop counters a value once every
    scheduler holds a warp, whose M independent values keep it issuing."""
    fits = [n_lanes for n_lanes in LANES[::-1]
            if k % n_lanes == 0 and k // n_lanes in SPILL_MS
            and (n_lanes == 1 or k // n_lanes >= 3)]
    return next((n_lanes for n_lanes in fits if n * n_lanes <= LANE_FILL),
                fits[-1])


def check_lanes(k, lanes):
    """Raise ValueError unless the lane form is built for K over groups of
    `lanes` lanes."""
    if lanes not in LANES or k % lanes or k // lanes not in SPILL_MS:
        raise ValueError(f"C23's lane form is not built for K={k} over "
                         f"{lanes} lanes: L one of {LANES} dividing K, "
                         f"K / L one of {SPILL_MS}")


def spill_plain(x, k, t):
    """The script's kernel in plain PyTorch: x int32, any shape; k >= 1
    values, t rounds -> int32, x's shape.  The K values are one int64
    tensor [k, *x.shape], the neighbour term a roll along its first
    axis."""
    if k < 1:
        raise ValueError(f"K must be at least 1, got {k}")
    i = torch.arange(k, dtype=torch.int64, device=x.device)
    v = wrap32(x.long()[None] + i.view(k, *[1] * x.dim()))
    for _ in range(t):
        v = wrap32(v * 3 + 1) ^ (torch.roll(v, -1, 0) >> 2)
    return wsum(v, dim=0).to(torch.int32)


def spill_cuda(x, k, t, lanes=None):
    """`spill_plain` by kernel C23's lane form over groups of `lanes`
    lanes (`default_lanes` if None); k one of SPILL_KS.  One check pass
    reads x's device index and pointer once; the launch is on the raw
    current stream of that index."""
    global launches
    index, (px,) = common.cuda_inputs((x, "x", x.dim(), I32))
    check_k(k)
    n = x.numel()
    lanes = default_lanes(k, n) if lanes is None else lanes
    check_lanes(k, lanes)
    out = torch.empty_like(x)
    if n:
        _build.check(_build.lib().nabwa_probe_spill(
            px, n, k, lanes, max(int(t), 0), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index)),
            "probe_spill kernel launch")
        with _build.count_lock:
            launches += 1
    return out


def spill_witness_cuda(x, k, t):
    """`spill_plain` by C23's witness, one element a thread: the probe's
    register spill question; k one of SPILL_KS.  The launch path of
    `spill_cuda`."""
    global launches_witness
    index, (px,) = common.cuda_inputs((x, "x", x.dim(), I32))
    check_k(k)
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        _build.check(_build.lib().nabwa_probe_spill_witness(
            px, n, k, max(int(t), 0), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index)),
            "probe_spill witness kernel launch")
        with _build.count_lock:
            launches_witness += 1
    return out


def spill(x, k, t):
    """The script's kernel: the plain version for CPU tensors, kernel C23's
    lane form for CUDA tensors."""
    return common.dispatch("spill", x, spill_plain, spill_cuda, k, t)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, rest = common.parse_device(argv, "probe_spill")
    if device is None:
        return 1
    if rest:
        print(f"[probe_spill] takes no arguments (K and T from the "
              f"environment), got {rest}", file=sys.stderr)
        return 1
    try:
        t = int(os.environ.get("T", str(DEFAULT_T)))
        k = int(os.environ.get("K", str(DEFAULT_K)))
        check_k(k)
        if t < 1:
            raise ValueError(f"T must be at least 1, got {t}")
    except ValueError as e:
        print(f"[probe_spill] {e}", file=sys.stderr)
        return 1
    for shape in SHAPES:
        x_t, = common.tensors(device, np.zeros(shape))
        dt, _ = common.timeit(lambda: spill(x_t, k, t), device, n=1)
        print(f"{str(shape):10s} K={k}  {dt*1e3:7.1f} ms  "
              f"{dt*1e6/t:6.2f} us/iter")
    return 0


if __name__ == "__main__":
    sys.exit(main())
