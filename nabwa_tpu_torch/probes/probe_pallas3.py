"""The nine probes of scripts/probe_pallas3.py on the card.

    python -m nabwa_tpu_torch.probes.probe_pallas3 [--device cuda|cpu]
                         [1] [1b] [2] [3] [4] [5] [6] [7] [8]

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

Probe 2, `p2` (:86): 50 rounds of v <- v + m over x int32 [256, 128]
(wrapping), m the minimum of v's row, taken by `min(axis=1)` (`native`,
kernel C31) or by seven rotate-and-min steps over the row (`roll`, C32's
lane form, whose five rotations within a warp are one shuffle each once a
lane's words agree; its witness, the literal rotation of the whole row,
by `p2_roll_witness_cuda`), or the minimum of v's column (`subl`, C33),
broadcast back.

Probe 5, `p5` (:156): 50 outer rounds over s = x int32 [256, 128], each
running n = (s[0, 0] & 3) + 1 inner rounds s <- s + j, j < n (wrapping);
kernel C34's grid form, each thread an int4 of s and its own copy of
s[0, 0], which alone decides the trip counts (`p5_cuda`); its witness,
one block with s in shared memory as the script kept it in VMEM, by
`p5_witness_cuda`.

Probe 6, `p6` (:183): x int32 [512, 128] cast to float32 times w float32
[128, 8] (ones) -> float32 [512, 8]; kernel C35, a block a 4 x 8 tile of
out with its rows of x and columns of w staged in shared memory, a thread
an out element summing in index order without FMA, so that it equals the
plain version bit for bit.

Probe 7, `p7` (:202): 200 chained steps v <- (v + i) ^ (v >> 2), i =
0..199, on x int32 of [1, 256], [256, 1], [8, 256] and [8, 512]
(wrapping); on a CUDA tensor kernel C25, one thread an element.

Probe 8, `p8` (:222): from v = b int32 [256, 128], 30 steps v <- where(v
> a, v - a, v + i), i = 0..29, with a int32 [256, 1] broadcast over each
row's columns (the DFS's expansion shape); kernel C26, a row a warp and
its scalar one broadcast load.  C25-C35 are in csrc/probe_pallas3.cu.

The inputs are the script's, unseeded as there (`np.random`); each probe
prints the script's result line with the time of 20 calls after one (5
for probes 2 and 5; `timeit`, :15), by CUDA events on the card, and
probes 1-4 and 6 its `ok` against the host copy of the inputs.  A name
the script does not have exits non-zero.  With no name, the nine probes
run in the script's order.  Unlike the script, which prints "FAILED" and
goes on (:55-56), a failure here, `ok=False` included, exits non-zero.
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
P2_KINDS = ("native", "roll", "subl")                   # :111
P2_ROUNDS = 50                                          # :106
P2_SHIFTS = (64, 32, 16, 8, 4, 2, 1)                    # :98
P2_X = (256, 128)                                       # :110
P2_ROW_COLS, P2_COL_ROWS = 128, 256   # C31, C32's rows; C33's columns
P5_ROUNDS = 50                                          # :169
P5_X = (256, 128)                                       # :174
P5_MAX_WORDS = 232448 // 4       # C34's witness: a block's shared memory
P6_X, P6_W = (512, 128), (128, 8)                       # :191-192
# C35's out tile a block (csrc/probes.cuh), and the most blocks a launch
# takes
P6_ROWS, P6_COLS = 4, 8
MAX_BLOCKS = 2**31 - 1
TIMED_CALLS_P2_P5 = 5                                   # :115, :176
I32 = torch.int32

# kernel launches made on CUDA tensors: C25 by `p7`, C26 by `p8`, C27 by
# `p1`, C28 by `p1b`, C29 by `p3`, C30 by `p4`, C31-C33 by `p2` in its
# three kinds (C32's witness by `p2_roll_witness_cuda`), C34 by `p5` (its
# witness by `p5_witness_cuda`), C35 by `p6`
launches_p7 = 0
launches_p8 = 0
launches_p1 = 0
launches_p1b = 0
launches_p3 = 0
launches_p4 = 0
launches_p2_native = 0
launches_p2_roll = 0
launches_p2_roll_witness = 0
launches_p2_subl = 0
launches_p5 = 0
launches_p5_witness = 0
launches_p6 = 0


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


def p1_cuda(i, t):
    """`p1_plain` by kernel C27; t's columns a multiple of 4.  The indices
    are not checked (`p1` does).  One check pass over both inputs reads
    each one's device and data pointer once; the launch reuses them."""
    global launches_p1
    dev, (pi, pt) = common.cuda_inputs((i, "i", 2, I32), (t, "t", 2, I32))
    cols = t.shape[1]
    if cols % 4:
        raise ValueError(f"t's rows must be a multiple of 4 words, got "
                         f"{cols}")
    n, width = i.shape
    if width < 2:
        raise ValueError(f"i must be [n, W] with W >= 2, got "
                         f"{(n, width)}")
    out = t.new_empty(2 * n, cols)
    if n == 0 or cols == 0:
        return out
    _build.check(_build.lib().nabwa_probe_p1(
        pi, width, n, pt, cols, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev)), "probe_p1 kernel launch")
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
    indices are not checked (`p1b` does).  One check pass over the three
    inputs reads each one's device and data pointer once; the launch
    reuses them."""
    global launches_p1b
    dev, (pi, pj, pt) = common.cuda_inputs(
        (i, "i", 2, I32), (j, "j", 2, I32), (t, "t", 2, I32))
    cols = t.shape[1]
    if cols % 4:
        raise ValueError(f"t's rows must be a multiple of 4 words, got "
                         f"{cols}")
    shape = i.shape
    if shape[1] != 1 or j.shape != shape:
        raise ValueError(f"i and j must be [n, 1], got {tuple(shape)} "
                         f"and {tuple(j.shape)}")
    n = shape[0]
    out = t.new_empty(2 * n, cols)
    if n == 0 or cols == 0:
        return out
    _build.check(_build.lib().nabwa_probe_p1b(
        pi, pj, n, pt, cols, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev)), "probe_p1b kernel launch")
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
    does).  One check pass over both inputs reads each one's device and
    data pointer once; the launch reuses them."""
    global launches_p3
    dev, (px, pi) = common.cuda_inputs((x, "x", 2, I32), (i, "i", 2, I32))
    cols, (m, c) = x.shape[1], i.shape
    if c != cols:
        raise ValueError(f"x and i must be [R, C] and [M, C], got "
                         f"{tuple(x.shape)} and {(m, c)}")
    out = i.new_empty(m, c)
    n = m * c
    if n == 0:
        return out
    _build.check(_build.lib().nabwa_probe_p3(
        px, cols, pi, n, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev)), "probe_p3 kernel launch")
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


def p2_min(v, kind):
    """The minimum that round of probe 2 adds to each value of v (int64
    holding int32s, [R, C]): of its row for `native` and `roll` (by seven
    rotations, :97-99, as the script takes it), of its column for `subl`,
    broadcast over v."""
    if kind == "native":
        return v.min(dim=1, keepdim=True).values
    if kind == "roll":
        m = v
        for sh in P2_SHIFTS:
            m = torch.minimum(m, torch.roll(m, sh, 1))
        return m
    if kind == "subl":
        return v.min(dim=0, keepdim=True).values
    raise ValueError(f"p2: no kind {kind!r}, expected one of {P2_KINDS}")


def p2_plain(x, kind):
    """Probe 2's kernel of `kind` in plain PyTorch: 50 rounds of v <- v +
    p2_min(v, kind), wrapping, from x int32 [R, C] -> int32 [R, C]."""
    v = x.long()
    for _ in range(P2_ROUNDS):
        v = wrap32(v + p2_min(v, kind))
    return v.to(torch.int32)


def _p2_rows(x, kind):
    """x's device index and data pointer from one check pass, and x's
    shape (x of `kind`'s shape: 128 columns for `native` and `roll`, 256
    rows and columns a multiple of 32 for `subl`); raises ValueError
    otherwise, in that order."""
    index, (px,) = common.cuda_inputs((x, "x", 2, I32))
    rows, cols = x.shape
    if kind == "subl" and (rows != P2_COL_ROWS or cols % 32):
        raise ValueError(f"x must be [{P2_COL_ROWS}, C] with C a multiple "
                         f"of 32 for `subl`, got {tuple(x.shape)}")
    if kind != "subl" and cols != P2_ROW_COLS:
        raise ValueError(f"x must be [R, {P2_ROW_COLS}] for `{kind}`, got "
                         f"{tuple(x.shape)}")
    return index, px, rows, cols


def p2_cuda(x, kind):
    """`p2_plain` by kernel C31 (`native`), C32's lane form (`roll`), x of
    128 columns, or C33 (`subl`), x of 256 rows and columns a multiple of
    32.  One check pass reads x's device index and pointer once; the
    launch is on the raw current stream of that index."""
    global launches_p2_native, launches_p2_roll, launches_p2_subl
    if kind not in P2_KINDS:
        raise ValueError(f"p2: no kind {kind!r}, expected one of {P2_KINDS}")
    index, px, rows, cols = _p2_rows(x, kind)
    out = torch.empty_like(x)
    if rows * cols:
        _build.check(_build.lib().nabwa_probe_p2(
            px, rows, cols, P2_KINDS.index(kind), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index)),
            f"probe_p2 {kind} kernel launch")
        with _build.count_lock:
            if kind == "native":
                launches_p2_native += 1
            elif kind == "roll":
                launches_p2_roll += 1
            else:
                launches_p2_subl += 1
    return out


def p2_roll_witness_cuda(x):
    """`p2_plain(x, "roll")` by C32's witness, the first design: each of
    the seven steps rotates the whole row, a lane's four words, literally;
    x of 128 columns.  The launch path of `p2_cuda`."""
    global launches_p2_roll_witness
    index, px, rows, cols = _p2_rows(x, "roll")
    out = torch.empty_like(x)
    if rows:
        _build.check(_build.lib().nabwa_probe_p2_roll_witness(
            px, rows, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index)),
            "probe_p2 roll witness kernel launch")
        with _build.count_lock:
            launches_p2_roll_witness += 1
    return out


def p2(x, kind):
    """Probe 2 in `kind`: the plain version for CPU tensors, kernel C31,
    C32 or C33 for CUDA tensors."""
    return common.dispatch("p2", x, p2_plain, p2_cuda, kind)


def p5_trips(s00):
    """The inner trip counts of probe 5's 50 outer rounds from s[0, 0] =
    s00 (an int): every value gets the same additions, so s[0, 0] alone
    decides them; n = (s[0, 0] & 3) + 1 on the int32 bit pattern (:161)."""
    trips = []
    for _ in range(P5_ROUNDS):
        trips.append((s00 & 3) + 1)
        for j in range(trips[-1]):
            s00 = wrap32(s00 + j)
    return trips


def p5_plain(x):
    """Probe 5's kernel in plain PyTorch: from s = x int32 [R, C], 50
    outer rounds, each reading n from the current s[0, 0] and then adding
    j to s for j < n, wrapping -> int32 [R, C]."""
    s = x.long()
    for _ in range(P5_ROUNDS):
        n = (int(s[0, 0]) & 3) + 1
        for j in range(n):
            s = wrap32(s + j)
    return s.to(torch.int32)


def p5_cuda(x):
    """`p5_plain` by kernel C34's grid form, x of any word count.  One
    check pass reads x's device index and pointer once (16-byte aligned:
    the kernel reads int4); the launch is on the raw current stream of
    that index."""
    global launches_p5
    index, (px,) = common.cuda_inputs((x, "x", 2, I32))
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        _build.check(_build.lib().nabwa_probe_p5(
            px, n, out.data_ptr(), torch._C._cuda_getCurrentRawStream(index)),
            "probe_p5 kernel launch")
        with _build.count_lock:
            launches_p5 += 1
    return out


def p5_witness_cuda(x):
    """`p5_plain` by C34's witness, one block with s in shared memory: the
    script's barrier-bound loop on one core; x of at most P5_MAX_WORDS
    words.  The launch path of `p5_cuda`."""
    global launches_p5_witness
    index, (px,) = common.cuda_inputs((x, "x", 2, I32))
    n = x.numel()
    if n > P5_MAX_WORDS:
        raise ValueError(f"x must fit one block's shared memory, "
                         f"{P5_MAX_WORDS} words, got {n}")
    out = torch.empty_like(x)
    if n:
        _build.check(_build.lib().nabwa_probe_p5_witness(
            px, n, out.data_ptr(), torch._C._cuda_getCurrentRawStream(index)),
            "probe_p5 witness kernel launch")
        with _build.count_lock:
            launches_p5_witness += 1
    return out


def p5(x):
    """Probe 5: the plain version for CPU tensors, kernel C34's grid form
    for CUDA tensors."""
    return common.dispatch("p5", x, p5_plain, p5_cuda)


def p6_plain(x, w):
    """Probe 6's kernel in plain PyTorch: x int32 [R, K] cast to float32
    times w float32 [K, N], the products x[:, k] w[k, :] summed over k in
    index order in float32 -> float32 [R, N]."""
    xf = x.float()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(x.shape[1]):
        acc = acc + xf[:, k, None] * w[k]
    return acc


def p6_blocks(rows, width):
    """C35's blocks for an out of [rows, width]: one a P6_ROWS x P6_COLS
    tile."""
    return -(-rows // P6_ROWS) * -(-width // P6_COLS)


def p6_cuda(x, w):
    """`p6_plain` by kernel C35's staged form, x [R, K] and w [K, N] of any
    R, K and N whose ceil(R / 4) ceil(N / 8) blocks fit a launch.  One
    check pass reads both inputs' device index and pointers once; the
    launch is on the raw current stream of that index."""
    global launches_p6
    index, (px, pw) = common.cuda_inputs((x, "x", 2, I32),
                                         (w, "w", 2, torch.float32))
    (rows, depth), (k, width) = x.shape, w.shape
    if k != depth:
        raise ValueError(f"x and w must be [R, K] and [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if max(rows, depth, width) > MAX_BLOCKS or \
            p6_blocks(rows, width) > MAX_BLOCKS:
        raise ValueError(f"C35 takes at most {MAX_BLOCKS} blocks of "
                         f"{P6_ROWS} x {P6_COLS} out elements and sides "
                         f"below 2^31, got x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)}")
    out = x.new_empty((rows, width), dtype=torch.float32)
    if rows * width:
        _build.check(_build.lib().nabwa_probe_p6(
            px, pw, rows, depth, width, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index)),
            "probe_p6 kernel launch")
        with _build.count_lock:
            launches_p6 += 1
    return out


def p6(x, w):
    """Probe 6: the plain version for CPU tensors, kernel C35 for CUDA
    tensors."""
    return common.dispatch("p6", x, p6_plain, p6_cuda, w)


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


def probe_p2(device):
    """Probe 2 on the script's input, one line a kind, each timed over 5
    calls after one.  Returns [(kind, seconds per call, result)]."""
    x_t, = common.tensors(device, np.random.randint(0, 1 << 20, P2_X))
    res = []
    for kind in P2_KINDS:
        dt, r = common.timeit(lambda: p2(x_t, kind), device,
                              n=TIMED_CALLS_P2_P5)
        print(f"P2 min-reduce[{kind}] {P2_ROUNDS} iters: {dt*1e3:.2f}ms "
              f"({dt/P2_ROUNDS*1e6:.1f}us/iter)")
        res.append((kind, dt, r))
    return res


def probe_p5(device):
    """Probe 5 on the script's input, timed over 5 calls after one.
    Returns (seconds per call, result)."""
    x_t, = common.tensors(device, np.random.randint(0, 1 << 20, P5_X))
    dt, r = common.timeit(lambda: p5(x_t), device, n=TIMED_CALLS_P2_P5)
    print(f"P5 dyn-trip inner fori {P5_ROUNDS} outers: {dt*1e3:.2f}ms")
    return dt, r


def probe_p6(device):
    """Probe 6 on the script's inputs; `ok` is the script's: column 0
    close to x's row sums (:195).  Returns (seconds per call, result)."""
    x = np.random.randint(0, 99, P6_X)
    x_t, = common.tensors(device, x)
    w_t = torch.ones(P6_W, dtype=torch.float32, device=device)
    dt, r = common.timeit(lambda: p6(x_t, w_t), device)
    ok = np.allclose(r.cpu().numpy()[:, 0], x.sum(1))
    _result(f"P6 matmul-ones reduce [{P6_X[0]},{P6_X[1]}]: {dt*1e6:.1f}us",
            ok)
    return dt, r


# the script's names in its order (:242-243)
PROBES = {"1": probe_p1, "1b": probe_p1b, "2": probe_p2, "3": probe_p3,
          "4": probe_p4, "5": probe_p5, "6": probe_p6, "7": probe_p7,
          "8": probe_p8}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, which = common.parse_device(argv, "probe_pallas3")
    if device is None:
        return 1
    which = which or list(PROBES)
    for w in which:
        if w not in PROBES:
            print(f"[probe_pallas3] probe {w}: no such probe",
                  file=sys.stderr)
            return 1
    print("devices:", [common.device_name(device)])
    for w in which:
        PROBES[w](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
