"""The DP lattices of the port's workflow modules on a torch device: the
banded global alignment (aln_global_core, stdaln.c:345-525) of samse's
and sampe's gapped refinement, of the local-SW path recovery and of
bwasw's cigars, the local Smith-Waterman forward lattice (aln_local_core,
stdaln.c:556-637) of sampe's mate rescue, and the seed extension
(aln_extend_core, stdaln.c:862-970) of bwasw.

`banded_global_plain` is nabwa_tpu/ops/dp.py:31 `_banded_global_device` on
tensors: the score lattice and packed traceback bits for a batch of
(reference window, read) pairs, one row at a time, the D chain as a
cummax along the row.  `banded_global` dispatches on the device of its
inputs: a CPU tensor runs the plain version, a CUDA tensor launches the
kernel in `csrc/banded_global.cu` (C4, one thread per pair), or the call
raises.  `local_fwd_plain` is nabwa_tpu/ops/dp.py:404 `_local_fwd_device`
on tensors, and `local_fwd` dispatches the same way to it or to the kernel
in `csrc/local_fwd.cu` (C5, one thread per job).

`extend_plain` is nabwa_tpu/ops/dp.py:264 `_extend_device` on tensors,
with the band per job, and `extend` dispatches to it or to the kernel in
`csrc/extend.cu` (C6, one thread per job, only each row's window).

`banded_global_batch` is the counterpart of nabwa_tpu/ops/dp.py:185
`banded_global_batch`: zero-length pairs are answered on the host, the
rest go to the device in batches of at most `MAX_PAIRS` pairs and
`MAX_LATTICE_BYTES` of lattice, and the host walks each lattice back into
the scalar oracle's path.  `extend_batch` is the counterpart of
nabwa_tpu/ops/dp.py:352 with a band and an initial score per job, in
batches bounded by scratch bytes.  `local_sw_batch`
is the counterpart of nabwa_tpu/ops/dp.py:482: the forward lattice on the
device in batches bounded by scratch bytes, the banded reverse pass on
the host (the native `local_rev`), and the path through
`banded_global_batch` with the reference's bandwidth-doubling retry.  The
JAX package's size threshold for its native route (`_use_native_dp`) is
not carried over: on CUDA every batch launches the kernels.
`banded_global_native` and `local_sw_native` are the host reference
routes: the shared native aln_global_core and local_fwd for each job.
bwasw's host reference route runs the native whole-batch driver instead
(`models/bwasw.py`).
"""

import time

import numpy as np
import torch

from . import _build
from ..index import native
from ..refmodel.stdaln_scalar import FROM_D, FROM_I, FROM_M, MINOR_INF

NEG = MINOR_INF
_I32 = torch.int32

# device pairs per batch, and lattice bytes per batch ((L2+1)(L1+1) a
# pair at the batch's longest lengths): 100 bp pairs are bounded by the
# count, 1 kb pairs (~1 MB each) by the bytes
MAX_PAIRS = 8192
MAX_LATTICE_BYTES = 1 << 28

# local-SW jobs per forward batch: bounds the kernel's h/e scratch,
# 8 (L1+1) bytes a job
MAX_LOCAL_SCRATCH = 1 << 28

# extension jobs per batch: bounds the kernel's hd/ev scratch, 8 (L1+2)
# bytes a job
MAX_EXTEND_SCRATCH = 1 << 28

# kernel launches made on CUDA tensors by `banded_global` (C4), by
# `local_fwd` (C5) and by `extend` (C6)
launches = 0
launches_local = 0
launches_extend = 0


def _shift_right(x, fill):
    """x[:, i-1] at column i, `fill` at column 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], 1)


def banded_global_plain(s1, len1, s2, len2, b1, b2, mat, *, go, ge, gend):
    """Score + traceback lattice for a batch, plain PyTorch.

    s1: int32 [B, L1+1] 1-based reference windows (index 0 unused), codes
    0..4; s2: int32 [B, L2+1] 1-based reads; len1/len2/b1/b2: int32 [B];
    mat: the 5x5 score matrix (host ints).  Returns (score int32 [B],
    ctype int32 [B], tb uint8 [B, L2+1, L1+1]); tb bits 0-1 Mt, 2 It,
    3 Dt, row 0 and rows past len2 zero."""
    dev = s1.device
    B, L1p = s1.shape
    L2p = s2.shape[1]
    i_idx = torch.arange(L1p, dtype=_I32, device=dev)[None, :]
    gend_i = gend if gend >= 0 else ge             # set_end_* fallback
    mat_flat = torch.as_tensor(np.asarray(mat, dtype=np.int32).reshape(-1),
                               device=dev)
    len1, len2 = len1[:, None], len2[:, None]
    b1, b2 = b1[:, None], b2[:, None]
    tmp_end = torch.where(b2 < len2, b2, len2 - 1)
    var_row = b2 == len2                 # the part-1 "last row" variant
    negs = torch.full((B, L1p), NEG, dtype=_I32, device=dev)

    # row 0 (stdaln.c:393-399): M[0,0] = 0, D over i in [1, b1-1]
    in0 = (i_idx >= 1) & (i_idx <= b1 - 1)
    Mp = torch.where(i_idx == 0, 0, negs)
    Dp = torch.where(in0, -go - gend_i * i_idx, negs)
    Ip = negs
    tb_rows = [torch.zeros((B, L1p), dtype=torch.uint8, device=dev)]
    for j in range(1, L2p):
        active = j <= len2
        part1 = j <= tmp_end
        last_row = (j == len2) & ~var_row
        is_var = (j == len2) & var_row
        start = torch.where(part1 | is_var, 0, j - b2 + 1)
        end = torch.minimum(j + b1 - 1, len1)
        in_band = (i_idx >= start) & (i_idx <= end)
        sub = mat_flat[(s2[:, j:j + 1] * 5 + s1).long()]

        # M (set_M, stdaln.c:260-275): from the diagonal, ties M>=I, I>D
        pm, pi, pd = (_shift_right(x, NEG) for x in (Mp, Ip, Dp))
        m_ge_i, m_ge_d, i_gt_d = pm >= pi, pm >= pd, pi > pd
        best = torch.where(m_ge_i, torch.where(m_ge_d, pm, pd),
                           torch.where(i_gt_d, pi, pd))
        Mt = torch.where(m_ge_i, torch.where(m_ge_d, FROM_M, FROM_D),
                         torch.where(i_gt_d, FROM_I, FROM_D))
        Mrow = torch.where(in_band & (i_idx >= 1), best + sub, NEG)

        # I (set_i/set_end_i): from above; gap_end at i == 0 and at the
        # band's right edge when it passes len1 or on the last row
        i_end_gend = ((j + b1 - 1) > len1) | last_row
        i_at_end = i_idx == end
        i_ok = in_band & (~i_at_end | i_end_gend | (i_idx == 0))
        iext = torch.where((i_idx == 0) | i_at_end, gend_i, ge)
        from_m = (Mp - go) > Ip
        Irow = torch.where(i_ok, torch.where(from_m, Mp - go, Ip) - iext,
                           NEG)

        # D (set_d/set_end_d): the within-row chain as a cummax
        dext = torch.where(is_var | last_row, gend_i, ge)
        d_ok = in_band & (i_idx >= torch.clamp(start, min=1))
        a_from_m = _shift_right(Mrow - go, NEG)
        U = torch.where(d_ok, a_from_m + dext * (i_idx - 1), NEG)
        T = torch.cummax(U, dim=1).values
        Drow = torch.where(d_ok, T - dext * i_idx, NEG)
        # traceback: FROM_M iff M[i-1]-go > D[i-1] (stored value)
        Dt = a_from_m > _shift_right(Drow, NEG)

        Mp = torch.where(active, Mrow, Mp).to(_I32)
        Ip = torch.where(active, Irow, Ip).to(_I32)
        Dp = torch.where(active, Drow, Dp).to(_I32)
        tb = Mt | (from_m.to(_I32) << 2) | (Dt.to(_I32) << 3)
        tb_rows.append(torch.where(active, tb, 0).to(torch.uint8))
    tb = torch.stack(tb_rows, 1)

    # final cell (len2, len1) per lane: rows were frozen past len2
    mN, iN, dN = (x.gather(1, len1.long()).squeeze(1) for x in (Mp, Ip, Dp))
    score = mN
    ctype = torch.full((B,), FROM_M, dtype=_I32, device=dev)
    ctype = torch.where(iN > score, FROM_I, ctype)
    score = torch.maximum(score, iN)
    ctype = torch.where(dN > score, FROM_D, ctype)
    score = torch.maximum(score, dN)
    return score, ctype.to(_I32), tb


def banded_global_cuda(s1, len1, s2, len2, b1, b2, mat, *, go, ge, gend):
    """`banded_global` on CUDA tensors through the kernel in
    csrc/banded_global.cu; same contract as `banded_global_plain`."""
    global launches
    dev = s1.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    _build.require(s1, "s1", dev, 2)
    _build.require(s2, "s2", dev, 2)
    B, L1p = s1.shape
    L2p = s2.shape[1]
    if s2.shape[0] != B:
        raise ValueError(f"s2: {s2.shape[0]} rows, expected {B}")
    for name, t in (("len1", len1), ("len2", len2), ("b1", b1), ("b2", b2)):
        _build.require(t, name, dev, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name}: {t.shape[0]} rows, expected {B}")
    mat = np.asarray(mat, dtype=np.int64).reshape(-1)
    if mat.size != 25:
        raise ValueError(f"mat: {mat.size} values, expected 25")
    score = torch.empty(B, dtype=_I32, device=dev)
    ctype = torch.empty(B, dtype=_I32, device=dev)
    tb = torch.empty((B, L2p, L1p), dtype=torch.uint8, device=dev)
    if B == 0:
        return score, ctype, tb
    scratch = torch.empty((3, L1p, B), dtype=_I32, device=dev)
    params = _build.i32_params([go, ge, gend] + mat.tolist())
    rc = _build.lib().nabwa_banded_global(
        params, s1.data_ptr(), s2.data_ptr(), len1.data_ptr(),
        len2.data_ptr(), b1.data_ptr(), b2.data_ptr(), B, L1p - 1, L2p - 1,
        scratch.data_ptr(), tb.data_ptr(), score.data_ptr(),
        ctype.data_ptr(), _build.stream_of(s1))
    _build.check(rc, "banded_global kernel launch")
    with _build.count_lock:
        launches += 1
    return score, ctype, tb


def banded_global(s1, len1, s2, len2, b1, b2, mat, *, go, ge, gend):
    """Score, end type and traceback lattice of a batch: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    kw = dict(go=go, ge=ge, gend=gend)
    if s1.device.type == "cpu":
        return banded_global_plain(s1, len1, s2, len2, b1, b2, mat, **kw)
    if s1.device.type == "cuda":
        return banded_global_cuda(s1, len1, s2, len2, b1, b2, mat, **kw)
    raise ValueError(f"banded_global: no kernel for device {s1.device}")


def pack_pairs(pairs, band_widths, device):
    """The kernel inputs of non-empty pairs [(seq1, seq2), ...] as int32
    tensors on `device`: 1-based padded sequences, lengths, and the band
    limits b1/b2 clamped to the lengths (nabwa_tpu/ops/dp.py:233-244).
    band_widths: one band width per pair."""
    B = len(pairs)
    L1 = max(len(a) for a, _ in pairs)
    L2 = max(len(b) for _, b in pairs)
    s1 = np.zeros((B, L1 + 1), dtype=np.int32)
    s2 = np.zeros((B, L2 + 1), dtype=np.int32)
    len1 = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    len2 = np.array([len(b) for _, b in pairs], dtype=np.int32)
    for bi, (a, b) in enumerate(pairs):
        s1[bi, 1:len(a) + 1] = a
        s2[bi, 1:len(b) + 1] = b
    bw = np.asarray(band_widths, dtype=np.int64)
    b1 = np.where(len1 > len2, len1 - len2 + bw, bw)
    b2 = np.where(len1 > len2, bw, len2 - len1 + bw)
    b1 = np.minimum(b1, len1).astype(np.int32)
    b2 = np.minimum(b2, len2).astype(np.int32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(s1=put(s1), len1=put(len1), s2=put(s2), len2=put(len2),
                b1=put(b1), b2=put(b2))


def _todo(pairs):
    """Indices of the non-empty pairs; the results list with the empty
    ones answered like the C (stdaln.c:351-352)."""
    res = [None] * len(pairs)
    todo = []
    for i, (a, b) in enumerate(pairs):
        if len(a) == 0 or len(b) == 0:
            res[i] = (0, [])
        else:
            todo.append(i)
    return res, todo


def lattice_batches(pairs, todo):
    """`todo` cut, in order, into batches of at most MAX_PAIRS pairs whose
    lattice, (L2+1)(L1+1) bytes a pair at the batch's longest lengths, stays
    within MAX_LATTICE_BYTES (a pair larger than that goes alone)."""
    out, part, l1, l2 = [], [], 0, 0
    for i in todo:
        a, b = pairs[i]
        n1, n2 = max(l1, len(a)), max(l2, len(b))
        if part and (len(part) == MAX_PAIRS
                     or (len(part) + 1) * (n1 + 1) * (n2 + 1)
                     > MAX_LATTICE_BYTES):
            out.append(part)
            part, n1, n2 = [], len(a), len(b)
        part.append(i)
        l1, l2 = n1, n2
    if part:
        out.append(part)
    return out


def banded_global_batch(pairs, ap, device, band_widths=None, seconds=None):
    """Batched aln_global_core on `device`: pairs = [(seq1, seq2), ...]
    (uint8 codes).  Returns [(score, path), ...] exactly like the scalar
    oracle.  band_widths, when given, overrides ap.band_width per pair.
    seconds, when given, gets host seconds added under "dp" (packing, the
    copy to the device and the DP to its end) and "dp_backtrace" (the
    lattice copy back and the backtrace walks)."""
    device = torch.device(device)
    res, todo = _todo(pairs)
    for part in lattice_batches(pairs, todo):
        t0 = time.perf_counter()
        bws = [ap.band_width if band_widths is None else band_widths[i]
               for i in part]
        args = pack_pairs([pairs[i] for i in part], bws, device)
        score, ctype, tb = banded_global(
            **args, mat=ap.matrix, go=int(ap.gap_open), ge=int(ap.gap_ext),
            gend=int(ap.gap_end))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        score = score.cpu().numpy()
        ctype = ctype.cpu().numpy()
        tb = tb.cpu().numpy()
        for bi, idx in enumerate(part):
            a, b = pairs[idx]
            res[idx] = (int(score[bi]),
                        _backtrace(tb[bi], int(ctype[bi]), len(a), len(b)))
        if seconds is not None:
            seconds["dp"] += t1 - t0
            seconds["dp_backtrace"] += time.perf_counter() - t1
    return res


def banded_global_native(pairs, ap, band_widths=None, seconds=None):
    """The host reference route of `banded_global_batch`: the shared
    native aln_global_core (native/stdaln.cpp) for every non-empty pair,
    its ctype sequence rebuilt into the oracle's path.  seconds gets the
    native calls under "dp" and the path rebuilds under "dp_backtrace"."""
    res, todo = _todo(pairs)
    t_dp = t_path = 0.0
    for i in todo:
        a, b = pairs[i]
        bw = ap.band_width if band_widths is None else band_widths[i]
        t0 = time.perf_counter()
        out = native.aln_global_native(
            a, b, ap.matrix, ap.row, ap.gap_open, ap.gap_ext, ap.gap_end, bw)
        t1 = time.perf_counter()
        res[i] = (out[0], _path_from_ctypes(out[1], len(a), len(b)))
        t_dp += t1 - t0
        t_path += time.perf_counter() - t1
    if seconds is not None:
        seconds["dp"] += t_dp
        seconds["dp_backtrace"] += t_path
    return res


def local_fwd_plain(s1, len1, s2, len2, mat, *, go, ge):
    """Best score and end cell of the local-SW forward lattice for a
    batch, plain PyTorch.

    s1: int32 [B, L1+1] 1-based reference windows (index 0 unused), codes
    0..4, padded with 4; s2: int32 [B, L2+1] 1-based reads, padded with 4;
    len1/len2: int32 [B]; mat: the 5x5 score matrix (host ints).  Columns
    past len1 are masked and rows past len2 frozen.  Returns (score,
    end_i, end_j), int32 [B] each; (0, 0, 0) where no cell is positive."""
    dev = s1.device
    B, L1p = s1.shape
    L2p = s2.shape[1]
    qr, r = int(go) + int(ge), int(ge)
    negf = -(1 << 29)
    i_idx = torch.arange(L1p, dtype=_I32, device=dev)[None, :]
    mat_flat = torch.as_tensor(np.asarray(mat, dtype=np.int32).reshape(-1),
                               device=dev)
    inb = (i_idx >= 1) & (i_idx <= len1[:, None])
    h = torch.zeros((B, L1p), dtype=_I32, device=dev)
    e = torch.zeros((B, L1p), dtype=_I32, device=dev)
    score = torch.zeros(B, dtype=_I32, device=dev)
    end_i = torch.zeros(B, dtype=_I32, device=dev)
    end_j = torch.zeros(B, dtype=_I32, device=dev)
    for j in range(1, L2p):
        active = j <= len2
        sub = mat_flat[(s2[:, j:j + 1] * 5 + s1).long()]
        hp0 = torch.clamp(_shift_right(h, 0) + sub, min=0)
        # the E chain, gated per column (NT_LOCAL_SCORE packing)
        e_cur = torch.where(h > qr, torch.maximum(e - r, h - qr), 0)
        hpre = torch.where(inb, torch.maximum(hp0, e_cur), 0)
        # F from the pre-F h, as a cummax along the row
        hcut = torch.clamp(hpre - qr, min=0)
        U = torch.where(inb, hcut + r * i_idx, negf)
        T = torch.cummax(U, dim=1).values
        f = torch.clamp(_shift_right(T, negf) - r * (i_idx - 1), min=0)
        h_new = torch.where(inb, torch.maximum(hpre, f), 0).to(_I32)
        # first cell of the row at its max; strict '>' across rows
        row_best = h_new.max(dim=1).values
        row_arg = torch.argmax(h_new, dim=1)
        better = active & (row_best > score)
        score = torch.where(better, row_best, score)
        end_i = torch.where(better, row_arg.to(_I32), end_i)
        end_j = torch.where(better, j, end_j)
        h = torch.where(active[:, None], h_new, h)
        e = torch.where(active[:, None], e_cur.to(_I32), e)
    return score.to(_I32), end_i.to(_I32), end_j.to(_I32)


def local_fwd_cuda(s1, len1, s2, len2, mat, *, go, ge):
    """`local_fwd` on CUDA tensors through kernel C5 (csrc/local_fwd.cu);
    same contract as `local_fwd_plain`."""
    global launches_local
    dev = s1.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    _build.require(s1, "s1", dev, 2)
    _build.require(s2, "s2", dev, 2)
    B, L1p = s1.shape
    L2p = s2.shape[1]
    if s2.shape[0] != B:
        raise ValueError(f"s2: {s2.shape[0]} rows, expected {B}")
    for name, t in (("len1", len1), ("len2", len2)):
        _build.require(t, name, dev, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name}: {t.shape[0]} rows, expected {B}")
    mat = np.asarray(mat, dtype=np.int64).reshape(-1)
    if mat.size != 25:
        raise ValueError(f"mat: {mat.size} values, expected 25")
    score = torch.empty(B, dtype=_I32, device=dev)
    end_i = torch.empty(B, dtype=_I32, device=dev)
    end_j = torch.empty(B, dtype=_I32, device=dev)
    if B == 0:
        return score, end_i, end_j
    scratch = torch.empty((2, L1p, B), dtype=_I32, device=dev)
    params = _build.i32_params([go, ge] + mat.tolist())
    rc = _build.lib().nabwa_local_fwd(
        params, s1.data_ptr(), s2.data_ptr(), len1.data_ptr(),
        len2.data_ptr(), B, L1p - 1, L2p - 1, scratch.data_ptr(),
        score.data_ptr(), end_i.data_ptr(), end_j.data_ptr(),
        _build.stream_of(s1))
    _build.check(rc, "local_fwd kernel launch")
    with _build.count_lock:
        launches_local += 1
    return score, end_i, end_j


def local_fwd(s1, len1, s2, len2, mat, *, go, ge):
    """Best local-SW score and end cell of a batch: the plain version for
    CPU tensors, kernel C5 for CUDA tensors."""
    if s1.device.type == "cpu":
        return local_fwd_plain(s1, len1, s2, len2, mat, go=go, ge=ge)
    if s1.device.type == "cuda":
        return local_fwd_cuda(s1, len1, s2, len2, mat, go=go, ge=ge)
    raise ValueError(f"local_fwd: no kernel for device {s1.device}")


def pack_local(jobs, device):
    """The kernel inputs of non-empty jobs [(window, read), ...] as int32
    tensors on `device`: 1-based sequences padded with 4, as
    nabwa_tpu/ops/dp.py:522-523 pads them, and their lengths."""
    B = len(jobs)
    L1 = max(len(a) for a, _ in jobs)
    L2 = max(len(b) for _, b in jobs)
    s1 = np.full((B, L1 + 1), 4, dtype=np.int32)
    s2 = np.full((B, L2 + 1), 4, dtype=np.int32)
    for bi, (a, b) in enumerate(jobs):
        s1[bi, 1:len(a) + 1] = a
        s2[bi, 1:len(b) + 1] = b
    len1 = np.array([len(a) for a, _ in jobs], dtype=np.int32)
    len2 = np.array([len(b) for _, b in jobs], dtype=np.int32)

    def put(a):
        return torch.from_numpy(a).to(device)

    return dict(s1=put(s1), len1=put(len1), s2=put(s2), len2=put(len2))


def _local_todo(jobs):
    """Indices of the non-empty jobs; the results list with the empty ones
    answered like the C (aln_local_core's len check)."""
    res = [None] * len(jobs)
    todo = []
    for i, (a, b) in enumerate(jobs):
        if len(a) and len(b):
            todo.append(i)
        else:
            res[i] = (-1, None, 0)
    return res, todo


def _local_finish(jobs, ap, res, fwd, thres, global_batch, seconds):
    """The host side of aln_local_core after the forward pass: the native
    banded reverse pass for every job at or above `thres`, then the path
    through `global_batch(pairs, ap_real, band_widths)` with the
    bandwidth-doubling retry (stdaln.c:723-745).  fwd: {job: (score_f,
    end_i, end_j)}; fills res with (score, path, 0)."""
    t0 = time.perf_counter()
    seg = {}           # job -> (score_f, score_r, si, sj, ei, ej)
    for i, (sf, ei, ej) in fwd.items():
        if sf < thres:
            res[i] = (sf, None, 0)
            continue
        rev = native.local_rev_native(jobs[i][0], jobs[i][1], ap.matrix,
                                      ap.row, ap.gap_open, ap.gap_ext, sf,
                                      ei, ej)
        if rev is None:
            res[i] = (sf, None, 0)
            continue
        sr, si, sj = rev
        seg[i] = (sf, sr, si, sj, ei, ej)
    t1 = time.perf_counter()
    ap_real = type(ap)(ap.gap_open, ap.gap_ext, -1, ap.matrix, ap.row, 0)
    band = {i: ap.band_width for i in seg}
    pending = list(seg)
    while pending:
        pairs = []
        for i in pending:
            sf, sr, si, sj, ei, ej = seg[i]
            pairs.append((np.asarray(jobs[i][0])[si - 1:ei],
                          np.asarray(jobs[i][1])[sj - 1:ej]))
        out = global_batch(pairs, ap_real, [band[i] for i in pending])
        nxt = []
        for i, (score_g, path) in zip(pending, out):
            sf, sr, si, sj, ei, ej = seg[i]
            jmax = max(ei - si, ej - sj) + 1
            if score_g == sr or sf == score_g or band[i] > jmax:
                if sr > score_g and sf > score_g:
                    res[i] = (-1, None, 0)
                else:
                    res[i] = (score_g, [(ct, x + si - 1, y + sj - 1)
                                        for ct, x, y in path], 0)
            else:
                band[i] <<= 1
                nxt.append(i)
        pending = nxt
    if seconds is not None:
        seconds["rescue_rev"] += t1 - t0
        seconds["rescue_path"] += time.perf_counter() - t1
    return res


def local_sw_batch(jobs, ap, device, thres=1, seconds=None):
    """Batched aln_local_core for mate rescue on `device`: jobs =
    [(window, read), ...] (uint8 codes).  Returns [(score, path, 0), ...]
    exactly like the scalar oracle with want_subo=False.  seconds, when
    given, gets host seconds added under "rescue_fwd" (packing, the copy to
    the device and the forward lattice to its end), "rescue_rev" (the
    native reverse passes) and "rescue_path" (the banded global paths,
    kernel C4 on CUDA, with their backtraces)."""
    device = torch.device(device)
    res, todo = _local_todo(jobs)
    fwd = {}
    if todo:
        L1 = max(len(jobs[i][0]) for i in todo)
        step = max(1, MAX_LOCAL_SCRATCH // (8 * (L1 + 1)))
        for start in range(0, len(todo), step):
            part = todo[start:start + step]
            t0 = time.perf_counter()
            score, end_i, end_j = local_fwd(
                **pack_local([jobs[i] for i in part], device),
                mat=ap.matrix, go=int(ap.gap_open), ge=int(ap.gap_ext))
            out = torch.stack([score, end_i, end_j], 1).cpu().numpy()
            for bi, i in enumerate(part):
                fwd[i] = tuple(int(v) for v in out[bi])
            if seconds is not None:
                seconds["rescue_fwd"] += time.perf_counter() - t0

    def global_batch(pairs, ap_real, bws):
        return banded_global_batch(pairs, ap_real, device, band_widths=bws)

    return _local_finish(jobs, ap, res, fwd, thres, global_batch, seconds)


def local_sw_native(jobs, ap, thres=1, seconds=None):
    """The host reference route of `local_sw_batch`: the shared native
    local_fwd for every non-empty job, then the same reverse pass, and the
    paths through `banded_global_native`."""
    res, todo = _local_todo(jobs)
    t0 = time.perf_counter()
    fwd = {i: native.local_fwd_native(jobs[i][0], jobs[i][1], ap.matrix,
                                      ap.row, ap.gap_open, ap.gap_ext)
           for i in todo}
    if seconds is not None:
        seconds["rescue_fwd"] += time.perf_counter() - t0

    def global_batch(pairs, ap_real, bws):
        return banded_global_native(pairs, ap_real, band_widths=bws)

    return _local_finish(jobs, ap, res, fwd, thres, global_batch, seconds)


def extend_plain(s1, len1, s2, len2, g0, bw, mat, *, go, ge):
    """Seed extension of a batch (aln_extend_core's forward pass), plain
    PyTorch: nabwa_tpu/ops/dp.py:264 `_extend_device` row by row, the F
    chain as a cummax along the row, with the band per job.

    s1: int32 [B, L1+2] 1-based target windows (index 0 unused), codes
    0..4; s2: int32 [B, L2+1] 1-based query segments; len1/len2/g0/bw:
    int32 [B]; mat: the 5x5 score matrix (host ints).  Every column of the
    padded row is computed and the window's complement masked, as in the
    jnp function; the loop ends once every job has stopped.  Returns
    (score - 1, end_i, end_j, cells), int32 [B] each: cells counts the
    window cells of each job's live rows, the work C6 does."""
    dev = s1.device
    B, L1p2 = s1.shape
    L2p = s2.shape[1]
    qr, r = int(go) + int(ge), int(ge)
    negf = -(1 << 29)
    i_idx = torch.arange(L1p2, dtype=_I32, device=dev)[None, :]
    mat_t = torch.as_tensor(np.asarray(mat, dtype=np.int32), device=dev)
    # prof[c][b, i] = mat[c][s1[b, i]]: row j's scores are prof[s2[b, j]]
    prof = mat_t[:, s1.long()]
    lanes = torch.arange(B, device=dev)
    # hd[i] = h[j-1][i-1] (the C's rolling eh_h), ev[i] = e[j-1][i]
    hd = torch.zeros((B, L1p2), dtype=_I32, device=dev)
    hd[:, 1] = g0
    ev = torch.zeros((B, L1p2), dtype=_I32, device=dev)
    zeros = torch.zeros(B, dtype=_I32, device=dev)
    start, end = zeros + 1, zeros + 2
    score, end_i, end_j, cells = zeros, zeros, zeros, zeros
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    for j in range(1, L2p):
        start_n = torch.maximum(start, torch.clamp(bw.neg() + j, min=1))
        end_n = torch.minimum(end, torch.minimum(bw + j, len1 + 1))
        dead = start_n == end_n
        active = ~stopped & (j <= len2) & ~dead
        sub = prof[s2[:, j].long(), lanes]
        inwin = (i_idx >= start_n[:, None]) & (i_idx < end_n[:, None])
        hpre = torch.maximum(torch.where(hd > 0, hd + sub, 0), ev)
        # F from the pre-F h, as a cummax along the row
        U = torch.where(inwin, torch.clamp(hpre - qr, min=0) + r * i_idx,
                        negf)
        T = torch.cummax(U, dim=1).values
        f = torch.clamp(_shift_right(T, negf) - r * (i_idx - 1), min=0)
        h = torch.where(inwin, torch.maximum(hpre, f), 0).to(_I32)

        # positive span and best cell (first cell of the row at its max)
        pos = (h > 0) & inwin
        any_pos = pos.any(dim=1)
        pos8 = pos.to(torch.int8)
        ns = torch.argmax(pos8, dim=1).to(_I32)
        ne = (L1p2 - 1 - torch.argmax(pos8.flip(1), dim=1)).to(_I32)
        row_best = h.max(dim=1).values
        row_arg = torch.argmax(h, dim=1).to(_I32)
        better = active & any_pos & (row_best > score)
        score = torch.where(better, row_best, score)
        end_i = torch.where(better, row_arg, end_i)
        end_j = torch.where(better, j, end_j).to(_I32)

        # state: e over the window (0 at end_n), hd over [start_n, end_n]
        e_new = torch.maximum(ev - r, torch.clamp(h - qr, min=0))
        ev_out = torch.where(inwin, e_new, ev)
        ev_out = torch.where(i_idx == end_n[:, None], 0, ev_out)
        wr = (i_idx >= start_n[:, None]) & (i_idx <= end_n[:, None])
        hd_out = torch.where(wr, _shift_right(h, 0), hd)
        upd = active[:, None]
        hd = torch.where(upd, hd_out, hd).to(_I32)
        ev = torch.where(upd, ev_out, ev).to(_I32)
        cells = cells + torch.where(active, inwin.sum(dim=1), 0).to(_I32)
        grow = active & any_pos
        start = torch.where(grow, ns, start_n)
        end = torch.where(grow, ne + 3, end_n)
        stopped = stopped | dead | (active & ~any_pos) | (j >= len2)
        if j % 32 == 0 and bool(stopped.all()):
            break
    return (score - 1).to(_I32), end_i, end_j, cells


def extend_cuda(s1, len1, s2, len2, g0, bw, mat, *, go, ge):
    """`extend` on CUDA tensors through kernel C6 (csrc/extend.cu); same
    contract as `extend_plain`."""
    global launches_extend
    dev = s1.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    _build.require(s1, "s1", dev, 2)
    _build.require(s2, "s2", dev, 2)
    B, L1p2 = s1.shape
    L2p = s2.shape[1]
    if s2.shape[0] != B:
        raise ValueError(f"s2: {s2.shape[0]} rows, expected {B}")
    if L1p2 < 2:
        raise ValueError(f"s1: {L1p2} columns, expected at least 2")
    for name, t in (("len1", len1), ("len2", len2), ("g0", g0), ("bw", bw)):
        _build.require(t, name, dev, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name}: {t.shape[0]} rows, expected {B}")
    mat = np.asarray(mat, dtype=np.int64).reshape(-1)
    if mat.size != 25:
        raise ValueError(f"mat: {mat.size} values, expected 25")
    out = [torch.empty(B, dtype=_I32, device=dev) for _ in range(4)]
    if B == 0:
        return tuple(out)
    scratch = torch.empty((2, L1p2, B), dtype=_I32, device=dev)
    params = _build.i32_params([go, ge] + mat.tolist())
    rc = _build.lib().nabwa_extend(
        params, s1.data_ptr(), s2.data_ptr(), len1.data_ptr(),
        len2.data_ptr(), g0.data_ptr(), bw.data_ptr(), B, L1p2 - 2, L2p - 1,
        scratch.data_ptr(), *[t.data_ptr() for t in out],
        _build.stream_of(s1))
    _build.check(rc, "extend kernel launch")
    with _build.count_lock:
        launches_extend += 1
    return tuple(out)


def extend(s1, len1, s2, len2, g0, bw, mat, *, go, ge):
    """(score - 1, end_i, end_j, cells) of a batch of extensions: the plain
    version for CPU tensors, kernel C6 for CUDA tensors."""
    if s1.device.type == "cpu":
        return extend_plain(s1, len1, s2, len2, g0, bw, mat, go=go, ge=ge)
    if s1.device.type == "cuda":
        return extend_cuda(s1, len1, s2, len2, g0, bw, mat, go=go, ge=ge)
    raise ValueError(f"extend: no kernel for device {s1.device}")


def pack_extend(jobs, g0s, bws, device):
    """The kernel inputs of non-empty jobs [(target, query), ...] as int32
    tensors on `device`: 1-based sequences in rows of L1+2 and L2+1 padded
    with 0, as nabwa_tpu/ops/dp.py:379-390 pads them, their lengths, the
    initial scores and the bands."""
    B = len(jobs)
    L1 = max(len(a) for a, _ in jobs)
    L2 = max(len(b) for _, b in jobs)
    s1 = np.zeros((B, L1 + 2), dtype=np.int32)
    s2 = np.zeros((B, L2 + 1), dtype=np.int32)
    for bi, (a, b) in enumerate(jobs):
        s1[bi, 1:len(a) + 1] = a
        s2[bi, 1:len(b) + 1] = b
    cols = [np.array([len(a) for a, _ in jobs], dtype=np.int32),
            np.array([len(b) for _, b in jobs], dtype=np.int32),
            np.asarray(g0s, dtype=np.int32), np.asarray(bws, dtype=np.int32)]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(s1=put(s1), s2=put(s2), **{
        k: put(v) for k, v in zip(("len1", "len2", "g0", "bw"), cols)})


def _extend_todo(jobs):
    """Indices of the non-empty jobs; the results list with the empty ones
    answered like nabwa_tpu/ops/dp.py:358-362."""
    res = [None] * len(jobs)
    todo = []
    for i, (a, b) in enumerate(jobs):
        if len(a) and len(b):
            todo.append(i)
        else:
            res[i] = (-1, 0, 0)
    return res, todo


def extend_batch(jobs, ap, g0s, device, bws=None, seconds=None):
    """Batched aln_extend_core, score and end only (want_path=False), on
    `device`: jobs = [(target, query), ...] (uint8 codes), g0s the initial
    score of each job, bws its band (ap.band_width when None).  Returns
    [(score, end_i, end_j), ...] matching the scalar oracle.  seconds, when
    given, gets host seconds added under "extend" (packing, the copy to the
    device, the extension and the copy back)."""
    device = torch.device(device)
    res, todo = _extend_todo(jobs)
    if not todo:
        return res
    L1 = max(len(jobs[i][0]) for i in todo)
    step = max(1, MAX_EXTEND_SCRATCH // (8 * (L1 + 2)))
    for lo in range(0, len(todo), step):
        part = todo[lo:lo + step]
        t0 = time.perf_counter()
        args = pack_extend(
            [jobs[i] for i in part], [g0s[i] for i in part],
            [ap.band_width if bws is None else bws[i] for i in part], device)
        out = extend(**args, mat=ap.matrix, go=int(ap.gap_open),
                     ge=int(ap.gap_ext))
        out = torch.stack(out[:3], 1).cpu().numpy()
        for bi, i in enumerate(part):
            res[i] = tuple(int(v) for v in out[bi])
        if seconds is not None:
            seconds["extend"] += time.perf_counter() - t0
    return res


# Host backtrace and path rebuild: copies of nabwa_tpu/ops/dp.py:163-182
# and :596-621, whose module imports jax.

def _path_from_ctypes(cts, len1, len2):
    """Rebuild the scalar oracle's [(ctype, i, j)] last-to-first path from
    the native kernels' ctype byte sequence (each entry's coordinates are
    the previous entry's moved by its ctype, starting at (len1, len2))."""
    path = []
    i, j = len1, len2
    prev = None
    for ct in cts:
        ct = int(ct)
        if prev is not None:
            if prev == FROM_M:
                i -= 1
                j -= 1
            elif prev == FROM_I:
                j -= 1
            else:
                i -= 1
        path.append((ct, i, j))
        prev = ct
    return path


def _backtrace(tb, ctype, len1, len2):
    """Host backtrace matching stdaln.c:487-514 / the scalar oracle."""
    i, j = len1, len2
    typ = _tb_type(tb[j, i], ctype)
    path = [(ctype, i, j)]
    while i or j:
        if ctype == FROM_M:
            i -= 1
            j -= 1
        elif ctype == FROM_I:
            j -= 1
        else:
            i -= 1
        ctype = typ
        if i or j:
            typ = _tb_type(tb[j, i], typ)
            path.append((ctype, i, j))
    return path


def _tb_type(cell, ctype):
    if ctype == FROM_M:
        return cell & 3
    if ctype == FROM_I:
        return FROM_M if (cell >> 2) & 1 else FROM_I
    return FROM_M if (cell >> 3) & 1 else FROM_D
