"""What the probe ports share: int32 wrap-around and floor modulo for the
plain versions, a popcount, the conversion of the scripts' numpy inputs,
the `--device` option and the timer.

The plain versions compute on int64 tensors that hold int32 values:
`wrap32` after each `+`, `-` or `*` gives jnp's int32 wrap-around, `>>`
on such a value is jnp's arithmetic shift, and a sum over an axis is
wrapped once at the end (`wsum`; torch sums int32 into int64, jnp wraps).
"""

import time

import numpy as np
import torch

from .. import cli

M32 = 0xFFFFFFFF
FREE_KEY = 0x7FFFFFFF


def wrap32(x):
    """The int32 value of the low 32 bits of x (an int or an int64
    tensor)."""
    return ((x + 0x80000000) & M32) - 0x80000000


def wsum(x, dim=None, keepdim=False):
    """jnp's int32 sum: the int64 sum wrapped to int32."""
    s = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
    return wrap32(s)


def floor_mod(x, n):
    """jnp's `%` for n > 0 (the sign of the divisor); torch's `%` on
    tensors and Python's on ints are the same, C's `%` and torch.fmod are
    not."""
    return x % n


def popcount32(x):
    """Set bits of the low 32 bits of each value of an int64 tensor
    (SWAR; torch has no popcount)."""
    x = x & M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def tensors(device, *arrays):
    """numpy arrays -> contiguous int32 tensors on `device`."""
    return tuple(torch.from_numpy(np.array(a, dtype=np.int32, order="C"))
                 .to(device) for a in arrays)


def parse_device(argv, cmd):
    """(device, remaining argv) from `--device cuda|cpu`; the device is
    None, after an error message, when it is not usable."""
    device, rest = cli._split_device(argv, cmd)
    return cli._device(device, cmd), rest


def device_name(device):
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def timeit(fn, device, n=20):
    """(seconds per call, last result) of fn() over n calls after one
    warm-up call, as scripts/probe_pallas.py:19 times: CUDA events on a
    CUDA device, the host clock on the CPU."""
    r = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            r = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / n, r
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn()
    return (time.perf_counter() - t0) / n, r
