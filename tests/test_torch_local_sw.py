"""The port's local Smith-Waterman (`nabwa_tpu_torch.ops.dp`) against the
JAX package on the CPU: `local_fwd_plain` against
`nabwa_tpu.ops.dp._local_fwd_device` (best score and end cell), kernel
C5's per-pair source built for the host against the plain version, C5's
warp kernel run lane by lane by the host harness (1, 4 and 32 lanes of 2
to 16 cells, the register form and the wide form's passes) against the
JAX function and the serial per-pair source, and
`local_sw_batch` and the host reference route `local_sw_native` against the
scalar oracle `refmodel.local_aln_scalar.aln_local_core` (score and path).

Jobs are mate-rescue shaped, drawn with numpy from fixed seeds as in
tests/test_dp_device.py: reference windows of 60-420 bp with a mutated
read placed inside, junk reads, a read with N codes, a window with no
positive cell and a 1-base read; then short windows with random reads and
reads carrying a 1-3 base gap, where low-scoring cells and the gated E
chain decide the best cell.  They are padded with code 4 as the JAX
package's `local_sw_batch` pads them, once at their own widths and once
at its bucketed shapes (L1 to 128, L2 to 32, B to a power of two).
Integer outputs, so the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabwa_tpu.ops import dp as jdp
from nabwa_tpu.refmodel.local_aln_scalar import aln_local_core
from nabwa_tpu.refmodel.stdaln_scalar import (ALN_PARAM_BWA, ALN_SM_BLAST,
                                              AlnParam)
from nabwa_tpu_torch.ops import dp as tdp

from . import test_torch_host_kernels
from .test_torch_dp import _mutate

PARAMS = [(31, ALN_PARAM_BWA), (32, AlnParam(5, 2, 2, ALN_SM_BLAST, 5, 50))]


def _jobs(seed, n=48):
    """Rescue-shaped (window, read) jobs and the edge cases."""
    rng = np.random.default_rng(seed)
    jobs = []
    for t in range(n):
        wlen = int(rng.integers(60, 420))
        ref = rng.integers(0, 4, size=wlen).astype(np.uint8)
        if t % 4 == 3:                                   # junk read
            read = rng.integers(0, 4, size=int(rng.integers(20, 80)))
            read = read.astype(np.uint8)
        else:
            rl = int(rng.integers(20, min(100, wlen)))
            start = int(rng.integers(0, wlen - rl + 1))
            read = _mutate(rng, ref[start:start + rl], 0.06, 0.03, 0.03)
            if len(read) == 0:
                read = ref[:1].copy()
        if t % 5 == 1 and len(read) > 2:
            read = read.copy()
            read[rng.integers(0, len(read))] = 4
        jobs.append((ref, read))
    for t in range(n):                                   # short, gapped
        ref = rng.integers(0, 4, size=int(rng.integers(40, 120)))
        ref = ref.astype(np.uint8)
        s = int(rng.integers(0, len(ref) - 38))
        piece, k = ref[s:s + 38], int(rng.integers(1, 4))
        gap = rng.integers(0, 4, size=k).astype(np.uint8)
        read = (rng.integers(0, 4, size=30).astype(np.uint8) if t % 3 == 0
                else np.concatenate([piece[:15], piece[15 + k:]]) if t % 3 == 1
                else np.concatenate([piece[:15], gap, piece[15:]]))
        jobs.append((ref, read))
    jobs.append((np.zeros(90, np.uint8), np.ones(30, np.uint8)))  # no cell > 0
    jobs.append((jobs[0][0], jobs[0][0][5:6].copy()))             # 1-base read
    return jobs


def _bucketed(args):
    """The kernel inputs padded to the JAX package's bucketed shapes
    (nabwa_tpu/ops/dp.py:517-531): extra columns and rows of code 4,
    extra lanes of length 1."""
    B, L1p = args["s1"].shape
    L2p = args["s2"].shape[1]
    L1 = -(-(L1p - 1) // 128) * 128
    L2 = -(-(L2p - 1) // 32) * 32
    Bb = 8
    while Bb < B:
        Bb <<= 1
    out = {}
    for key, width in (("s1", L1 + 1), ("s2", L2 + 1)):
        t = torch.full((Bb, width), 4, dtype=torch.int32)
        t[:B, :args[key].shape[1]] = args[key]
        out[key] = t
    for key in ("len1", "len2"):
        t = torch.ones(Bb, dtype=torch.int32)
        t[:B] = args[key]
        out[key] = t
    return out


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    return test_torch_host_kernels.build(tmp_path_factory.mktemp("hk"))


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("seed,ap", PARAMS)
def test_plain_matches_jax(seed, ap, bucketed):
    args = tdp.pack_local(_jobs(seed), "cpu")
    if bucketed:
        args = _bucketed(args)
    kw = dict(go=ap.gap_open, ge=ap.gap_ext)
    got = tdp.local_fwd_plain(**args, mat=ap.matrix, **kw)
    j = {k: jnp.asarray(v.numpy()) for k, v in args.items()}
    want = jdp._local_fwd_device(
        j["s1"], j["len1"], j["s2"], j["len2"],
        jnp.asarray(np.asarray(ap.matrix, dtype=np.int32)), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    score = got[0].numpy()
    assert score[-2] == 0 and got[1][-2] == 0 and got[2][-2] == 0
    assert (score > 0).sum() >= 80


@pytest.mark.parametrize("seed,ap", PARAMS)
def test_kernel_source_on_host_matches_plain(host_kernels, seed, ap):
    args = tdp.pack_local(_jobs(seed + 100), "cpu")
    kw = dict(go=ap.gap_open, ge=ap.gap_ext)
    plain = tdp.local_fwd_plain(**args, mat=ap.matrix, **kw)
    got = test_torch_host_kernels.local_fwd(
        host_kernels, **{k: v.numpy() for k, v in args.items()},
        mat=ap.matrix, **kw)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())


def test_local_sw_batch_matches_oracle():
    """local_sw_batch (plain forward pass, split into several batches by a
    small scratch bound) and the host reference route against the scalar
    oracle, a zero-length window included."""
    jobs = _jobs(33)
    jobs.append((np.zeros(0, np.uint8), jobs[0][1]))
    want = [aln_local_core(a, b, ALN_PARAM_BWA, _thres=1)[:2]
            for a, b in jobs]
    old = tdp.MAX_LOCAL_SCRATCH
    tdp.MAX_LOCAL_SCRATCH = 8 * 421 * 7          # 7 jobs a batch
    parts = dict.fromkeys(("rescue_fwd", "rescue_rev", "rescue_path", "dp",
                           "dp_backtrace"), 0.0)
    try:
        got = tdp.local_sw_batch(jobs, ALN_PARAM_BWA, "cpu", seconds=parts)
    finally:
        tdp.MAX_LOCAL_SCRATCH = old
    assert [(s, p) for s, p, _ in got] == want
    assert sum(1 for s, p in want if p) >= 30
    assert all(parts[k] > 0 for k in ("rescue_fwd", "rescue_rev",
                                      "rescue_path"))
    native = tdp.local_sw_native(jobs, ALN_PARAM_BWA)
    assert [(s, p) for s, p, _ in native] == want


def test_local_dispatch_and_kernel_checks():
    args = tdp.pack_local(_jobs(34, n=4), "cpu")
    kw = dict(mat=ALN_PARAM_BWA.matrix, go=26, ge=9)
    with pytest.raises(ValueError):           # the kernel takes CUDA only
        tdp.local_fwd_cuda(**args, **kw)
    meta = {k: v.to("meta") for k, v in args.items()}
    with pytest.raises(ValueError):
        tdp.local_fwd(**meta, **kw)


# C5's lane form: lanes x cells a lane, at 1, 4 and 32 lanes and two K
LANES = [(1, 4), (1, 16), (4, 4), (4, 16), (32, 2), (32, 16)]


def _short_jobs(seed, width, n=24):
    """Jobs whose windows fit `width` columns (1 to width), with reads
    placed in them, junk reads and reads with N codes."""
    rng = np.random.default_rng(seed)
    jobs = []
    for t in range(n):
        wlen = int(rng.integers(1, width + 1)) if t else width
        ref = rng.integers(0, 4, size=wlen).astype(np.uint8)
        if t % 3 == 2:
            read = rng.integers(0, 5, size=int(rng.integers(1, 40)))
            read = read.astype(np.uint8)
        else:
            rl = int(rng.integers(1, wlen + 1))
            start = int(rng.integers(0, wlen - rl + 1))
            read = _mutate(rng, ref[start:start + rl], 0.05, 0.03, 0.03)
            if len(read) == 0:
                read = ref[:1].copy()
        jobs.append((ref, read))
    return jobs


def _jax_local(args, ap):
    j = {k: jnp.asarray(v.numpy()) for k, v in args.items()}
    return [np.asarray(w) for w in jdp._local_fwd_device(
        j["s1"], j["len1"], j["s2"], j["len2"],
        jnp.asarray(np.asarray(ap.matrix, dtype=np.int32)),
        go=ap.gap_open, ge=ap.gap_ext)]


def _check_lanes(lib, args, ap, lanes, k, form, want=None):
    """The lane form on `args` against the JAX function (or `want`) and
    the serial per-pair source."""
    kw = dict(go=ap.gap_open, ge=ap.gap_ext, mat=ap.matrix)
    np_args = {key: v.numpy() for key, v in args.items()}
    got = test_torch_host_kernels.local_fwd(lib, **np_args, lanes=lanes,
                                            k=k, form=form, **kw)
    serial = test_torch_host_kernels.local_fwd(lib, **np_args, **kw)
    want = _jax_local(args, ap) if want is None else want
    for g, s_, w in zip(got, serial, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(s_, w)
    return got


@pytest.mark.parametrize("form", ["registers", "wide"])
@pytest.mark.parametrize("lanes,k", LANES)
@pytest.mark.parametrize("seed,ap", PARAMS)
def test_lane_form_matches_jax_and_serial(host_kernels, seed, ap, lanes, k,
                                          form):
    """C5's warp kernel lane by lane: the register form on windows its
    lanes cover (up to lanes x k columns), the wide form's passes on the
    rescue-shaped jobs (windows of 60-420 columns, many passes at few
    lanes); each also in the JAX package's bucketed shapes."""
    jobs = (_short_jobs(seed + 300 + lanes * k, lanes * k)
            if form == "registers" else _jobs(seed + 200, n=16))
    args = tdp.pack_local(jobs, "cpu")
    got = _check_lanes(host_kernels, args, ap, lanes, k, form)
    assert (got[0] > 0).sum() >= len(jobs) // 2
    padded = _bucketed(args)
    if form == "wide" or lanes * k >= padded["s1"].shape[1] - 1:
        _check_lanes(host_kernels, padded, ap, lanes, k, form)


def _edge_jobs(name, rng):
    """Named edge jobs: (window, read) lists."""
    def rand(n):
        return rng.integers(0, 4, size=n).astype(np.uint8)

    if name == "widths":                     # len1 around a lane's edge
        out = []
        for w in (1, 31, 32, 33, 64, 65):
            ref = rand(w)
            out += [(ref, ref[max(0, w - 20):].copy()),
                    (ref, rand(int(rng.integers(1, 30))))]
        return out
    if name == "wide":                       # past 32 x 16 columns
        ref = rand(32 * 16 + 1)
        read = _mutate(rng, ref[400:500], 0.04, 0.02, 0.02)
        return [(ref, read), (ref, ref[-30:].copy()), (ref[:512], ref[:3])]
    if name == "no_positive":
        return [(np.zeros(90, np.uint8), np.ones(30, np.uint8)),
                (np.full(40, 4, np.uint8), rand(12))]
    if name == "e_gate":                     # h[j-1][i] == q + r, e > r
        return [(np.array(E_GATE[0], np.uint8), np.array(E_GATE[1], np.uint8))]
    x, y = rand(10), rand(10)
    gap = np.full(30, 4, np.uint8)
    if name == "tie_one_row":                # same row, lanes apart
        return [(np.concatenate([x, gap, x]), x.copy()),
                (np.concatenate([x, gap, x, gap, x]), x.copy())]
    assert name == "tie_two_rows"            # the later row's cell is left
    return [(np.concatenate([y, gap, x]),
             np.concatenate([x, np.full(10, 4, np.uint8), y]))]


# a job where the E chain's gate decides the answer: a cell with
# h[j-1][i] == q + r and e[j-1][i] > r (aln_param_blast, q=5, r=2); with
# the gate at >= it would give (18, 27, 29)
E_GATE = ([3, 1, 0, 2, 2, 0, 0, 3, 1, 0, 2, 1, 0, 3, 0, 2, 0, 1, 3, 0, 1, 0,
           2, 3, 2, 1, 1, 1, 0],
          [3, 1, 0, 2, 2, 0, 0, 3, 1, 0, 2, 1, 0, 3, 3, 2, 0, 2, 0, 1, 3, 0,
           1, 0, 2, 3, 2, 1, 1])


@pytest.mark.parametrize("name", ["widths", "wide", "no_positive",
                                  "tie_one_row", "tie_two_rows", "e_gate"])
def test_lane_form_edges(host_kernels, name):
    """Edge jobs through the lane form at 1, 4 and 32 lanes, each width in
    the register form where the lanes cover it and always in the wide
    form: windows of 1, 31, 32, 33 columns and one past 32 x 16; windows
    with no positive cell ((0, 0, 0)); the best score tied in two lanes of
    one row (the leftmost wins) and in two rows (the earlier row wins,
    though its cell lies right of the later one's); a job the E chain's
    gate decides."""
    ap = PARAMS[1][1] if name == "e_gate" else ALN_PARAM_BWA
    jobs = _edge_jobs(name, np.random.default_rng(23))
    args = tdp.pack_local(jobs, "cpu")
    want = _jax_local(args, ap)
    L1 = args["s1"].shape[1] - 1
    for lanes, k in LANES:
        forms = ["wide"] + (["registers"] if lanes * k >= L1 else [])
        for form in forms:
            _check_lanes(host_kernels, args, ap, lanes, k, form, want)
    score, end_i, end_j = want
    if name == "no_positive":
        assert not score.any() and not end_i.any() and not end_j.any()
    elif name == "tie_one_row":
        assert list(end_i) == [10, 10] and list(end_j) == [10, 10]
        assert list(score) == [110, 110]
    elif name == "tie_two_rows":
        # (10, 50) at row 10 before (30, 10) at row 30, both 110
        assert (score[0], end_j[0], end_i[0]) == (110, 10, 50)
        alone = tdp.pack_local([(jobs[0][0], jobs[0][1][20:])], "cpu")
        s2, i2, j2 = _jax_local(alone, ap)
        assert (s2[0], i2[0], j2[0]) == (110, 10, 10)
    elif name == "wide":
        assert L1 == 513 and test_torch_host_kernels.local_form(
            host_kernels, L1) == ("shared", 16)
    elif name == "e_gate":
        assert (score[0], end_i[0], end_j[0]) == (14, 14, 14)
