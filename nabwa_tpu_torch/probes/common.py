"""What the probe ports share: int32 wrap-around and floor modulo for the
plain versions, a popcount, the conversion of the scripts' numpy inputs,
the dispatch between a plain version and its kernel, the kernels' input
checks (one tensor, or all of a launch's in one pass) and the
dispatchers' index check, the `--device` option and the timer.

The plain versions compute on int64 tensors that hold int32 values:
`wrap32` after each `+`, `-` or `*` gives jnp's int32 wrap-around, `>>`
on such a value is jnp's arithmetic shift, and a sum over an axis is
wrapped once at the end (`wsum`; torch sums int32 into int64, jnp wraps).
"""

import time

import numpy as np
import torch

from .. import cli
from ..ops import _build

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


def dispatch(name, t, plain, cuda, *args):
    """plain(t, *args) for a CPU tensor t, cuda(t, *args) for a CUDA one."""
    if t.device.type == "cpu":
        return plain(t, *args)
    if t.device.type == "cuda":
        return cuda(t, *args)
    raise ValueError(f"{name}: no kernel for device {t.device}")


def cuda_input(t, name, ndim, dev=None, dtype=torch.int32):
    """The device of `t`, a contiguous CUDA tensor of `dtype` (int32 unless
    said) with `ndim` dimensions (on `dev` if given) whose start the
    kernels may read as int4; raises ValueError otherwise.  `is_cuda`
    tests the device's type: `t.device.type` formats the type's name on
    every read."""
    if not t.is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors, got {t.device}")
    if dev is None:
        dev = t.device
    _build.require(t, name, dev, ndim, dtype)
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")
    return dev


def cuda_inputs(*specs):
    """One check pass over a kernel's tensor inputs, each given as (t,
    name, ndim, dtype) or (t, name, ndim, dtype, align, then): every t a
    contiguous CUDA tensor of its dtype with ndim dimensions, on the first
    one's device, starting on a multiple of `align` bytes (16 in the short
    form: the kernels read most inputs as int4; an input they read as
    int32 needs 4).  `then(t)`, unless None, runs once t has passed and
    before the next input is checked, and raises ValueError for a shape
    its kernel does not take, so that a wrapper keeps the order of the
    checks it made one input at a time.  The checks and their ValueError
    messages are those of `cuda_input` called on each in turn, the later
    ones with the first's device, in that order.  Returns (the device's
    index, [each tensor's data pointer]), each read once, for the stream's
    handle and the launch."""
    index = None
    ptrs = []
    for spec in specs:
        if len(spec) == 4:
            t, name, ndim, dtype = spec
            align, then = 16, None
        else:
            t, name, ndim, dtype, align, then = spec
        if not t.is_cuda:
            raise ValueError(f"the kernel needs CUDA tensors, got {t.device}")
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: expected a tensor, got {type(t)}")
        on = t.get_device()
        if index is None:
            index = on
        elif on != index:
            raise ValueError(f"{name}: on {t.device}, expected "
                             f"{specs[0][0].device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        ptr = t.data_ptr()
        if ptr % align:
            raise ValueError(f"{name}: not {align}-byte aligned")
        if then is not None:
            then(t)
        ptrs.append(ptr)
    return index, ptrs


def check_indices(name, n, *indices):
    """Raise ValueError unless every index lies in [0, n): the scripts
    draw them so, and neither version defines others (Pallas interpret
    mode wraps or clamps them, a gather would fault)."""
    for i in indices:
        if i.numel() and bool(((i < 0) | (i >= n)).any()):
            raise ValueError(f"{name}: indices outside [0, {n})")


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
