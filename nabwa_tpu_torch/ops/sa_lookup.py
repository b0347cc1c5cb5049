"""Batched suffix-array lookup (bwt_sa, bwt.c:72-81): SA row -> text
position, for the coordinate steps of samse, sampe, bam2bam and bwasw.

`sa_lookup_plain` is nabwa_tpu/ops/sa_lookup.py:34 `_sa_lookup_impl` on
tensors, line for line: every row steps through invPsi (bwt.h:71-75) in
lockstep until it reaches a sampled row, then adds its step count to the
sample (row 0's sample is the reference's -1, so the sum wraps).  The
interval test is the C's modulo, so any sa_intv works; the jnp version's
power-of-two mask gives the same rows for the intervals it accepts.

bwt_sa samples the suffix array by row, so a row's step count is about
geometric with mean sa_intv, not bounded by it: at sa_intv 32, 16k rows
take ~32 steps on average and ~300 at most.  So a batch takes as long as
its slowest row's chain of dependent steps.

Positions are uint32, held as int64 masked to 32 bits as in `ops/occ.py`;
tensors at the public boundary are int32 bit patterns.

`sa_lookup` walks one strand's rows; `sa_lookup_both` walks the rows of
both strands in one call, rows[:n0] on strand 0's bank and sample and
rows[n0:] on strand 1's.  Each dispatches on the device of its rows: a
CPU tensor runs the plain version, a CUDA tensor launches the kernel in
`csrc/sa_lookup.cu` (one launch for both strands), or the call raises.
"""

import torch

from . import _build
from .occ import M32, occ4, select_base, to_i32, u32

_I64 = torch.int64

# kernel launches made by `sa_lookup` on CUDA tensors
launches = 0


def b0_string(bank, pos):
    """Base at string position pos of the $-removed BWT (bwt_B0, bwt.h:66);
    pos: int64 values in [0, seq_len)."""
    w = u32(bank[(pos >> 7) * 12 + 4 + ((pos >> 4) & 7)])
    return (w >> (((~pos) & 15) << 1)) & 3


def inv_psi(bank, l2v, primary, seq_len, k):
    """invPsi for int64 rows k (uint32 values); l2v: int64 [5]."""
    is_primary = k == primary
    strpos = torch.where(k > primary, k - 1, k)
    strpos = torch.where(is_primary, 0, strpos)    # a safe index
    c = b0_string(bank, strpos)
    o = select_base(occ4(bank, primary, seq_len, k), c)
    return torch.where(is_primary, 0, (l2v[c] + o) & M32)


def _walk(bank, l2, primary, seq_len, sa_intv, rows):
    """Every row stepped in lockstep to a sampled row: (sampled rows,
    step counts), int64 tensors of uint32 values."""
    primary = int(primary) & M32
    seq_len = int(seq_len) & M32
    intv = int(sa_intv)
    if intv < 1:
        raise ValueError(f"sa_intv must be positive, got {intv}")
    l2v = torch.tensor([int(v) & M32 for v in l2], dtype=_I64,
                       device=rows.device)
    k = u32(rows)
    s = torch.zeros_like(k)
    while True:
        live = (k % intv) != 0
        if not bool(live.any()):
            return k, s
        nk = inv_psi(bank, l2v, primary, seq_len, k)
        k = torch.where(live, nk, k)
        s = torch.where(live, s + 1, s)


def sa_walk_steps(bank, l2, primary, seq_len, sa_intv, rows):
    """invPsi steps each row takes to a sampled row (int64 [n]), as
    `sa_lookup_plain` walks them."""
    return _walk(bank, l2, primary, seq_len, sa_intv, rows)[1]


def sa_lookup_plain(bank, l2, primary, seq_len, sa, sa_intv, rows):
    """Batched bwt_sa, plain PyTorch.

    bank: one BWT bank's int32 words; l2: the 5 L2 counts (ints); sa: that
    strand's sampled suffix array, int32 (uint32 bits); rows: int32 [n]
    rows (uint32 bits), each <= seq_len.  Returns int32 [n] positions
    (uint32 bit patterns)."""
    k, s = _walk(bank, l2, primary, seq_len, sa_intv, rows)
    kk = k // int(sa_intv)
    base = torch.where(kk == 0, M32, u32(sa)[kk])
    return to_i32(s + base)


def sa_lookup_both_plain(banks, l2, primaries, seq_len, sas, sa_intv,
                        rows, n0):
    """Both strands' rows, plain PyTorch: `sa_lookup_plain` on rows[:n0]
    with strand 0's (banks[0], primaries[0], sas[0]) and on rows[n0:] with
    strand 1's, concatenated."""
    return torch.cat([
        sa_lookup_plain(banks[a], l2, primaries[a], seq_len, sas[a], sa_intv,
                        part)
        for a, part in enumerate((rows[:n0], rows[n0:]))])


def sa_lookup_both_cuda(banks, l2, primaries, seq_len, sas, sa_intv, rows,
                        n0):
    """`sa_lookup_both` on CUDA tensors: one launch of the kernel in
    csrc/sa_lookup.cu for both strands; same contract as
    `sa_lookup_both_plain`."""
    global launches
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    _build.require(rows, "rows", dev, 1)
    for a in (0, 1):
        _build.require(banks[a], f"bank {a}", dev, 1)
        _build.require(sas[a], f"sa {a}", dev, 1)
        if banks[a].data_ptr() % 16:
            raise ValueError("bwt bank must start on a 16-byte boundary")
    intv = int(sa_intv)
    if not 1 <= intv < 1 << 31:
        raise ValueError(f"sa_intv must be in [1, 2**31), got {intv}")
    n = rows.shape[0]
    if not 0 <= n0 <= n:
        raise ValueError(f"n0 {n0} outside [0, {n}]")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    params = _build.u32_params(list(l2[:4]) + list(primaries))
    rc = _build.lib().nabwa_sa_lookup(
        params, banks[0].data_ptr(), banks[1].data_ptr(), sas[0].data_ptr(),
        sas[1].data_ptr(), intv, rows.data_ptr(), n, n0, out.data_ptr(),
        _build.stream_of(rows))
    _build.check(rc, "sa_lookup kernel launch")
    with _build.count_lock:
        launches += 1
    return out


def sa_lookup_cuda(bank, l2, primary, seq_len, sa, sa_intv, rows):
    """`sa_lookup` on CUDA tensors, through the kernel in csrc/sa_lookup.cu
    with every row on one strand; same contract as `sa_lookup_plain`."""
    return sa_lookup_both_cuda((bank, bank), l2, (primary, primary),
                               seq_len, (sa, sa), sa_intv, rows,
                               rows.shape[0])


def sa_lookup(bank, l2, primary, seq_len, sa, sa_intv, rows):
    """Text positions of one strand's SA rows: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if rows.device.type == "cpu":
        return sa_lookup_plain(bank, l2, primary, seq_len, sa, sa_intv, rows)
    if rows.device.type == "cuda":
        return sa_lookup_cuda(bank, l2, primary, seq_len, sa, sa_intv, rows)
    raise ValueError(f"sa_lookup: no kernel for device {rows.device}")


def sa_lookup_both(banks, l2, primaries, seq_len, sas, sa_intv, rows, n0):
    """Text positions of both strands' SA rows (rows[:n0] on strand 0,
    rows[n0:] on strand 1): the plain version for CPU tensors, one kernel
    launch for CUDA tensors."""
    if rows.device.type == "cpu":
        return sa_lookup_both_plain(banks, l2, primaries, seq_len, sas,
                                    sa_intv, rows, n0)
    if rows.device.type == "cuda":
        return sa_lookup_both_cuda(banks, l2, primaries, seq_len, sas,
                                   sa_intv, rows, n0)
    raise ValueError(f"sa_lookup_both: no kernel for device {rows.device}")
