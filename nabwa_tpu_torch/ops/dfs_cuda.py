"""Wrapper of kernel C1 (`csrc/dfs.cu`), the gapped DFS on CUDA tensors.

Same arguments and packed int32 [B, 4H+5] result as
`ops.dfs.dfs_match_gap_plain`; every column but `fin` and `iters` (the
kernel's own per-read telemetry) matches it.  The kernel runs a warp per
read with the read's state in shared memory, or, when one read's state
(`dfs_smem_bytes`) exceeds `SMEM_STATE_BYTES`, in device memory: then the
wrapper allocates that scratch.  The wrapper checks device, dtype, shape
and contiguity, allocates the output with `torch.empty`, and launches on
the current stream.
"""

import ctypes

import torch

from . import _build
from .occ import M32

# kernel launches made on CUDA tensors
launches = 0

# shared memory one read's state may take: a block's 227 KB on the H100
# (the kernel has no static shared memory).  A batch whose reads need more
# keeps their state in device memory.
SMEM_STATE_BYTES = 227 * 1024

# uint32 words handed to the kernel, in the field order of DfsParams
DFS_PARAMS = ("l2_0", "l2_1", "l2_2", "l2_3", "l2_4", "primary_fwd",
              "primary_rev", "seq_len", "rev_word_offset", "s_mm", "s_gapo",
              "s_gape", "max_gape", "max_gapo", "indel_end_skip",
              "max_del_occ", "max_entries", "max_top2", "max_seed_diff",
              "seed_len", "mode", "S", "H", "L", "SL1", "max_iters")

# Limits of the slot layout (info = ldp << 17 | a << 16 | i, counters in
# 8-bit fields, key = score << 16 | 0xFFFF - seq), shared with the plain
# version and the JAX engine.
MAX_READ_LEN = (1 << 14) - 1
MAX_COUNTER = 255
MAX_SCORE = 0x7FFF


def check_limits(L, max_diff_max, max_gapo, max_gape, s_mm, s_gapo, s_gape,
                 stack_cap, hits_cap, max_iters):
    """Raise ValueError for inputs the kernel's slot layout cannot hold."""
    if L > MAX_READ_LEN:
        raise ValueError(f"read width {L} > {MAX_READ_LEN}")
    for name, v in (("max_diff", max_diff_max), ("max_gapo", max_gapo),
                    ("max_gape", max_gape)):
        if v > MAX_COUNTER:
            raise ValueError(f"{name} {v} > {MAX_COUNTER}")
    worst = ((max_diff_max + 1) * s_mm + (max_gapo + 1) * s_gapo
             + (max_gape + 1) * s_gape)
    if worst >= MAX_SCORE:
        raise ValueError(f"alignment scores up to {worst} do not fit the "
                         f"{MAX_SCORE} of the stack key")
    if stack_cap < 2 or hits_cap < 1:
        raise ValueError(f"stack_cap {stack_cap} / hits_cap {hits_cap} "
                         f"too small")
    if not 0 < max_iters < 1 << 31:
        raise ValueError(f"max_iters {max_iters} out of range")


def dfs_smem_bytes(S, H, L, SL1):
    """C1's state of one read in bytes, a multiple of 16: the stack (5 S
    int32), the width and bid planes of both strands (4 (L+1)), the seed
    planes (4 SL1), the codes (2 L) and the hit list (4 H)
    (csrc/dfs_warp.cuh `dfs_state_bytes`)."""
    words = 5 * S + 4 * (L + 1) + 4 * SL1 + 2 * L + 4 * H
    return -(-4 * words // 16) * 16


def launch_shape(params, B, shared):
    """(warps a block, blocks, dynamic shared bytes a block) of a launch of
    B reads with these `param_words`, as `nabwa_dfs` would make it."""
    shape = (ctypes.c_int * 3)()
    _build.check(_build.lib().nabwa_dfs_shape(params, B, int(shared), shape),
                 "dfs launch shape")
    return tuple(shape)


def param_words(rev_word_offset, primary_fwd, primary_rev, l2, seq_len, L,
                SL1, *, s_mm, s_gapo, s_gape, max_gape, max_gapo,
                indel_end_skip, max_del_occ, max_entries, max_top2,
                max_seed_diff, seed_len, mode, stack_cap, hits_cap,
                max_iters):
    """The kernel's DfsParams as uint32 words, in DFS_PARAMS order."""
    words = [int(v) & M32 for v in l2[:5]] + [
        primary_fwd, primary_rev, seq_len, rev_word_offset, s_mm, s_gapo,
        s_gape, max_gape, max_gapo, indel_end_skip, max_del_occ, max_entries,
        max_top2, max_seed_diff, min(seed_len, 0x7FFFFFFF), mode, stack_cap,
        hits_cap, L, SL1, max_iters]
    assert len(words) == len(DFS_PARAMS)
    return _build.u32_params(words)


def dfs_match_gap_cuda(bwt_cat, rev_word_offset, primary_fwd, primary_rev,
                       l2, seq_len, seqs, lengths, widths, bids, seed_widths,
                       seed_bids, has_seed, max_diff, *, s_mm, s_gapo, s_gape,
                       max_gape, max_gapo, indel_end_skip, max_del_occ,
                       max_entries, max_top2, max_seed_diff, seed_len, mode,
                       stack_cap, hits_cap, max_iters):
    """The DFS on CUDA tensors through kernel C1 (all int32)."""
    global launches
    dev = seqs.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    _build.require(seqs, "seqs", dev, 3)
    B, two, L = seqs.shape
    if two != 2:
        raise ValueError(f"seqs: shape {tuple(seqs.shape)}, expected "
                         f"[B, 2, L]")
    SL1 = seed_widths.shape[2] if seed_widths.dim() == 3 else -1
    for name, t, ndim, shape in (
            ("bwt_cat", bwt_cat, 1, None),
            ("lengths", lengths, 1, (B,)),
            ("widths", widths, 3, (B, 2, L + 1)),
            ("bids", bids, 3, (B, 2, L + 1)),
            ("seed_widths", seed_widths, 3, (B, 2, SL1)),
            ("seed_bids", seed_bids, 3, (B, 2, SL1)),
            ("has_seed", has_seed, 1, (B,)),
            ("max_diff", max_diff, 1, (B,))):
        _build.require(t, name, dev, ndim)
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if bwt_cat.data_ptr() % 16 or (rev_word_offset * 4) % 16:
        raise ValueError("bwt banks must start on 16-byte boundaries")
    S, H = stack_cap, hits_cap
    out = torch.empty((B, 4 * H + 5), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    md_max = int(max_diff.max().item())
    check_limits(L, md_max, max_gapo, max_gape, s_mm, s_gapo, s_gape, S, H,
                 max_iters)
    # each read's state in shared memory, or in device memory when one
    # read's does not fit
    per_read = dfs_smem_bytes(S, H, L, SL1)
    scratch = (None if per_read <= SMEM_STATE_BYTES
               else torch.empty(B * per_read // 4, dtype=torch.int32,
                                device=dev))
    params = param_words(
        rev_word_offset, primary_fwd, primary_rev, l2, seq_len, L, SL1,
        s_mm=s_mm, s_gapo=s_gapo, s_gape=s_gape, max_gape=max_gape,
        max_gapo=max_gapo, indel_end_skip=indel_end_skip,
        max_del_occ=max_del_occ, max_entries=max_entries, max_top2=max_top2,
        max_seed_diff=max_seed_diff, seed_len=seed_len, mode=mode,
        stack_cap=S, hits_cap=H, max_iters=max_iters)
    rc = _build.lib().nabwa_dfs(
        params, bwt_cat.data_ptr(), seqs.data_ptr(),
        lengths.data_ptr(), widths.data_ptr(), bids.data_ptr(),
        seed_widths.data_ptr(), seed_bids.data_ptr(), has_seed.data_ptr(),
        max_diff.data_ptr(), None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), B, _build.stream_of(seqs))
    _build.check(rc, "dfs kernel launch")
    with _build.count_lock:
        launches += 1
    return out
