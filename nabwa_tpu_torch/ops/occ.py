"""FM-index rank (Occ) lookups and `bwt_cal_width` in PyTorch.

Plain versions of `nabwa_tpu/ops/occ.py` `occ4` (:47), `select_base` (:87)
and `cal_width` (:141), bit for bit: the `$`-row adjustment (k >= primary
-> k-1, bwt.c:99,167), the k == (uint32)-1 -> 0 edge (bwt.c:98,163) and
the terminal sentinel at each read's length (bwtaln.c:73-74).

Positions are uint32.  The plain versions hold them as int64 values masked
to 32 bits, so every compare is an unsigned compare; tensors at the public
boundary are int32 bit patterns, as in the JAX package.

`cal_width` dispatches on the device of its queries: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel in `csrc/cal_width.cu`
(one thread per row), or the call raises.
"""

import torch

from . import _build

M32 = 0xFFFFFFFF
_M55 = 0x55555555
_I64 = torch.int64

# kernel launches made by `cal_width` on CUDA tensors
launches = 0


def u32(t):
    """int32 bit patterns (or any integer tensor) -> int64 in [0, 2**32)."""
    return t.to(_I64) & M32


def to_i32(v):
    """int64 values in [0, 2**32) or in int32 range -> int32 bit patterns."""
    v = v & M32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _popcount(x):
    """Population count of int64 values below 2**32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def occ4(bwt, primary, seq_len, k, word_offset=0):
    """Counts of each base in BWT[0..k] for a batch of rows (bwt_occ4,
    bwt.c:159-176).

    bwt: int32 flat interleaved words; k: integer tensor of uint32 values
    (int32 bit patterns accepted); primary: int or per-lane int64 tensor;
    word_offset: int or per-lane tensor, the bank's first word.
    Returns int64 [..., 4] counts (uint32 values)."""
    k = u32(k)
    is_neg1 = k == M32
    kk = torch.where(k >= primary, k - 1, k)
    kk = torch.where(is_neg1, 0, kk)
    base = (kk >> 7) * 12 + word_offset
    # a bank's last block may be short; words past its end are masked off
    # below, so indices are clamped into the array as the JAX gather does
    idx = base[..., None] + torch.arange(12, device=k.device)
    blk = u32(bwt[idx.clamp(0, bwt.numel() - 1)])         # [..., 12]
    word_off = ((kk >> 4) & 7)[..., None]
    within = kk & 15
    partial = ((M32 << ((15 - within) * 2)) & M32)[..., None]
    j = torch.arange(8, device=k.device)
    vmask = torch.where(j < word_off, M32,
                        torch.where(j == word_off, partial, 0))
    w = blk[..., 4:]
    lo = w & vmask & _M55
    hi = (w >> 1) & vmask & _M55
    c3 = _popcount(lo & hi).sum(-1)
    c1 = _popcount(lo).sum(-1) - c3
    c2 = _popcount(hi).sum(-1) - c3
    n_valid = word_off[..., 0] * 16 + within + 1
    c0 = n_valid - c1 - c2 - c3
    out = torch.stack([blk[..., 0] + c0, blk[..., 1] + c1,
                       blk[..., 2] + c2, blk[..., 3] + c3], dim=-1) & M32
    return torch.where(is_neg1[..., None], 0, out)


def select_base(cnt4, c):
    """cnt4[..., c] per lane (0 where c is not in 0..3)."""
    out = torch.zeros_like(cnt4[..., 0])
    for j in range(4):
        out = torch.where(c == j, cnt4[..., j], out)
    return out


def cal_width_plain(bwt, l2, primary, seq_len, queries, lengths):
    """Batched bwt_cal_width (bwtaln.c:52-76), plain PyTorch.

    bwt: one bank's int32 words; l2: the 5 L2 counts (ints); queries:
    int32 [B, L] base codes (>3 = N), read left to right on the
    opposite-strand BWT; lengths: int32 [B].  Returns (width, bid), int32
    [B, L+1]; width holds uint32 bit patterns.  Position lengths[b] holds
    the sentinel w=0, bid=final+1; positions past it repeat the final
    interval and the last column is 0 unless lengths[b] == L."""
    dev = queries.device
    B, L = queries.shape
    primary = int(primary) & M32
    seq_len = int(seq_len) & M32
    l2v = torch.tensor([int(v) & M32 for v in l2], dtype=_I64, device=dev)
    q = queries.to(_I64)
    lens = lengths.to(_I64)
    k = torch.zeros(B, dtype=_I64, device=dev)
    l = torch.full((B,), seq_len, dtype=_I64, device=dev)
    bid = torch.zeros(B, dtype=_I64, device=dev)
    w_cols, b_cols = [], []
    for i in range(L):
        c = q[:, i]
        active = i < lens
        is_n = c > 3
        cc = c.clamp(max=3)
        l2c = l2v[cc]
        cnt = occ4(bwt, primary, seq_len, torch.stack([k - 1, l]))
        nk = torch.where(is_n, k, (l2c + select_base(cnt[0], cc) + 1) & M32)
        nl = torch.where(is_n, l, (l2c + select_base(cnt[1], cc)) & M32)
        restart = (nk > nl) | is_n
        nk = torch.where(restart, 0, nk)
        nl = torch.where(restart, seq_len, nl)
        nbid = bid + restart.to(_I64)
        k = torch.where(active, nk, k)
        l = torch.where(active, nl, l)
        bid = torch.where(active, nbid, bid)
        w_cols.append((l - k + 1) & M32)
        b_cols.append(bid)
    width = torch.zeros((B, L + 1), dtype=_I64, device=dev)
    bids = torch.zeros((B, L + 1), dtype=_I64, device=dev)
    if L:
        width[:, :L] = torch.stack(w_cols, dim=1)
        bids[:, :L] = torch.stack(b_cols, dim=1)
    rows = torch.arange(B, device=dev)
    width[rows, lens] = 0
    bids[rows, lens] = bid + 1
    return to_i32(width), bids.to(torch.int32)


def cal_width_cuda(bwt, l2, primary, seq_len, queries, lengths):
    """`cal_width` on CUDA tensors through the kernel in
    csrc/cal_width.cu; same contract as `cal_width_plain`."""
    global launches
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    _build.require(queries, "queries", dev, 2)
    _build.require(lengths, "lengths", dev, 1)
    _build.require(bwt, "bwt", dev, 1)
    B, L = queries.shape
    if lengths.shape[0] != B:
        raise ValueError(f"lengths: {lengths.shape[0]} rows, expected {B}")
    if bwt.data_ptr() % 16:
        raise ValueError("bwt bank must start on a 16-byte boundary")
    width = torch.empty((B, L + 1), dtype=torch.int32, device=dev)
    bid = torch.empty((B, L + 1), dtype=torch.int32, device=dev)
    if B == 0:
        return width, bid
    params = _build.u32_params(list(l2[:5]) + [primary, seq_len])
    rc = _build.lib().nabwa_cal_width(
        params, bwt.data_ptr(), queries.data_ptr(), lengths.data_ptr(),
        B, L, width.data_ptr(), bid.data_ptr(), _build.stream_of(queries))
    _build.check(rc, "cal_width kernel launch")
    with _build.count_lock:
        launches += 1
    return width, bid


def cal_width(bwt, l2, primary, seq_len, queries, lengths):
    """D(i) width and bid planes: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if queries.device.type == "cpu":
        return cal_width_plain(bwt, l2, primary, seq_len, queries, lengths)
    if queries.device.type == "cuda":
        return cal_width_cuda(bwt, l2, primary, seq_len, queries, lengths)
    raise ValueError(f"cal_width: no kernel for device {queries.device}")
