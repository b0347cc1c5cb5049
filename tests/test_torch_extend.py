"""The port's seed extension (`nabwa_tpu_torch.ops.dp`, kernel C6) against
the JAX package on the CPU: `extend_plain` against
`nabwa_tpu.ops.dp._extend_device` called directly (the JAX package's
`extend_batch` takes its native route off a TPU), kernel C6's per-job
source built for the host against the plain version, and `extend_batch`
against the scalar oracle `refmodel.extend_scalar.aln_extend_core` and
the shared native aln_extend_core.

Jobs are bwasw-shaped, drawn with numpy from fixed seeds: target windows
up to 700 bp with a mutated copy of their start as the query (extensions
that run far), random queries (extensions that stop at once), queries
with N codes, queries with a junk block in the middle (the window shrinks,
then grows back over cells written rows before), short jobs, initial
scores from 1 to 60, and the band of each job 50 or a narrow 7, mixed in
one batch.  Two scorings: bwasw's defaults, and +1/-1 with gap open and
extension 1, under which cells of a row often tie at its maximum.  C6's
warp kernel is also run lane by lane through the host harness (its
per-lane steps of extend.cuh, the carries combined in lane order) at 1, 4
and 32 lanes of 4 cells and at 32 lanes of 1, against the plain version,
the serial extend_job and the JAX function, on these jobs and on edge
jobs: one job at the widest window, bands wider than a pass of 32 x 4
cells, windows narrower than the lanes, len2 0 and 1, periodic sequences
and short jobs over one or two letters whose rows tie at their maximum.
The
JAX function takes the band as a static argument, so it runs once per
band and each job is compared with the run at its own band.  Both at the jobs' own widths and
at the JAX package's bucketed shapes (L1 and L2 to multiples of 32, B to
a power of two).  Integer outputs, so the tolerance is exact equality.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabwa_tpu.ops import dp as jdp
from nabwa_tpu.refmodel.extend_scalar import aln_extend_core
from nabwa_tpu.refmodel.stdaln_scalar import AlnParam
from nabwa_tpu_torch.index import native
from nabwa_tpu_torch.ops import dp as tdp

from . import test_torch_host_kernels
from .test_torch_dp import _mutate

BANDS = (50, 7)


def _ap(a, b, q, r):
    """bwasw's scoring (-a -b -q -r), the matrix built like `_gen_ap`
    (nabwa_tpu/models/bwasw.py:748-753)."""
    m = np.full((5, 5), -b, dtype=np.int64)
    for i in range(4):
        m[i, i] = a
    return AlnParam(q, r, r, m, 5, 50)


def _bwasw_ap():
    return _ap(1, 3, 5, 2)


# (seed, scoring): bwasw's defaults, and a scoring full of ties
PARAMS = [(41, (1, 3, 5, 2)), (42, (1, 1, 1, 1)), (43, (1, 3, 5, 2)),
          (44, (1, 1, 1, 1))]


def _jobs(seed, n=44):
    """(jobs, g0s, bws): bwasw-shaped extension jobs.  The first job fixes
    the widest target (700) and query (400), so every seed has the same
    shapes."""
    rng = np.random.default_rng(seed)
    jobs = [(rng.integers(0, 4, 700).astype(np.uint8),
             rng.integers(0, 4, 400).astype(np.uint8))]
    for t in range(n):
        kind = t % 5
        if kind == 3:                                    # short job
            tgt = rng.integers(0, 4, int(rng.integers(1, 60)))
            q = rng.integers(0, 4, int(rng.integers(1, 60)))
        else:
            tgt = rng.integers(0, 4, int(rng.integers(150, 700)))
            ql = int(rng.integers(40, min(400, len(tgt))))
            q = (rng.integers(0, 4, ql) if kind == 1    # junk query
                 else _mutate(rng, tgt[:ql], 0.04, 0.02, 0.02)[:400])
            if kind == 2 and len(q) > 10:                # N codes
                q = q.copy()
                q[rng.integers(0, len(q), 3)] = 4
            if kind == 4 and len(q) > 60:                # junk block
                q = q.copy()
                at = int(rng.integers(10, len(q) - 40))
                q[at:at + int(rng.integers(6, 20))] = rng.integers(0, 4)
        jobs.append((tgt.astype(np.uint8), np.asarray(q, np.uint8)))
    jobs.append((np.array([2], np.uint8), np.array([2], np.uint8)))
    g0s = [int(g) for g in rng.integers(1, 61, len(jobs))]
    bws = [BANDS[i % 2] for i in range(len(jobs))]
    return jobs, g0s, bws


def _bucketed(args):
    """The kernel inputs padded to the JAX package's bucketed shapes
    (nabwa_tpu/ops/dp.py:374-390): extra columns and rows of code 0, extra
    lanes of length 1, g0 0 and band 1."""
    B, L1p2 = args["s1"].shape
    L2p = args["s2"].shape[1]
    L1 = -(-(L1p2 - 2) // 32) * 32
    L2 = -(-(L2p - 1) // 32) * 32
    Bb = 8
    while Bb < B:
        Bb <<= 1
    out = {}
    for key, width in (("s1", L1 + 2), ("s2", L2 + 1)):
        t = torch.zeros((Bb, width), dtype=torch.int32)
        t[:B, :args[key].shape[1]] = args[key]
        out[key] = t
    for key, fill in (("len1", 1), ("len2", 1), ("g0", 0), ("bw", 1)):
        t = torch.full((Bb,), fill, dtype=torch.int32)
        t[:B] = args[key]
        out[key] = t
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: the plain versions loop over
    rows of mid-sized tensor ops, and when test workers share the cores,
    each op's parallel region waits on threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    return test_torch_host_kernels.build(tmp_path_factory.mktemp("hk"))


def _jax_extend(args, ap):
    """nabwa_tpu.ops.dp._extend_device on the packed args, each job from
    the run at its own band (the JAX function's band is static)."""
    j = {k: jnp.asarray(v.numpy()) for k, v in args.items()}
    bw = args["bw"].numpy()
    out = [np.zeros(len(bw), np.int32) for _ in range(3)]
    for band in np.unique(bw):
        want = jdp._extend_device(
            j["s1"], j["len1"], j["s2"], j["len2"], j["g0"],
            jnp.asarray(np.asarray(ap.matrix, dtype=np.int32)),
            bw=int(band), go=ap.gap_open, ge=ap.gap_ext)
        for o, w in zip(out, want):
            o[bw == band] = np.asarray(w)[bw == band]
    return out



@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("seed,scoring", PARAMS)
def test_plain_matches_jax(seed, scoring, bucketed):
    jobs, g0s, bws = _jobs(seed)
    ap = _ap(*scoring)
    args = tdp.pack_extend(jobs, g0s, bws, "cpu")
    if bucketed:
        args = _bucketed(args)
    kw = dict(go=ap.gap_open, ge=ap.gap_ext)
    got = tdp.extend_plain(**args, mat=ap.matrix, **kw)
    assert all(g.dtype == torch.int32 for g in got)
    bw = args["bw"].numpy()
    assert set(np.unique(bw)) <= set(BANDS) | {1}
    for g, w in zip(got[:3], _jax_extend(args, ap)):
        np.testing.assert_array_equal(g.numpy(), w)
    score, end_j, cells = got[0].numpy(), got[2].numpy(), got[3].numpy()
    n = len(jobs)
    # extensions that ran far and ones that stopped within a few rows
    gain = score[:n] - np.asarray(g0s)
    assert (gain > 40).sum() >= 10 and (end_j[:n] < 10).sum() >= 5
    assert end_j[:n].max() >= 200
    # a job's window cells: at most 2 bw + 1 a row, at least one a row it
    # extended through
    assert (cells[:n] <= (2 * bw[:n] + 1) * args["len2"].numpy()[:n]).all()
    assert (cells[:n] >= end_j[:n]).all()


@pytest.mark.parametrize("seed,scoring", PARAMS)
def test_kernel_source_on_host_matches_plain(host_kernels, seed, scoring):
    jobs, g0s, bws = _jobs(seed + 100)
    ap = _ap(*scoring)
    args = tdp.pack_extend(jobs, g0s, bws, "cpu")
    kw = dict(go=ap.gap_open, ge=ap.gap_ext)
    plain = tdp.extend_plain(**args, mat=ap.matrix, **kw)
    got = test_torch_host_kernels.extend(
        host_kernels, **{k: v.numpy() for k, v in args.items()},
        mat=ap.matrix, **kw)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())


def test_extend_batch_matches_oracle():
    """extend_batch (plain version, split into several batches by a small
    scratch bound) and the native extension against the scalar oracle,
    empty jobs included."""
    jobs, g0s, bws = _jobs(44, n=24)
    jobs.insert(5, (np.zeros(0, np.uint8), jobs[0][1]))
    jobs.append((jobs[1][0], np.zeros(0, np.uint8)))
    g0s[5:5] = [7]
    g0s.append(3)
    bws[5:5] = [50]
    bws.append(7)
    ap = _bwasw_ap()
    want = []
    for (a, b), g0, bw in zip(jobs, g0s, bws):
        ap_b = AlnParam(ap.gap_open, ap.gap_ext, ap.gap_end, ap.matrix,
                        ap.row, bw)
        want.append(tuple(int(v) for v in aln_extend_core(
            a, b, ap_b, g0, want_path=False)[:3]))
    old = tdp.MAX_EXTEND_SCRATCH
    tdp.MAX_EXTEND_SCRATCH = 8 * 702 * 5           # 5 jobs a batch
    parts = {"extend": 0.0}
    try:
        got = tdp.extend_batch(jobs, ap, g0s, "cpu", bws=bws, seconds=parts)
    finally:
        tdp.MAX_EXTEND_SCRATCH = old
    assert got == want
    assert got[5] == (-1, 0, 0) and got[-1] == (-1, 0, 0)
    assert parts["extend"] > 0
    # the shared native aln_extend_core agrees with the oracle on these jobs
    assert [native.aln_extend_native(a, b, ap.matrix, ap.row, ap.gap_open,
                                     ap.gap_ext, bw, g0)
            if len(a) and len(b) else (-1, 0, 0)
            for (a, b), g0, bw in zip(jobs, g0s, bws)] == want
    # one band for all: ap.band_width
    assert tdp.extend_batch(jobs[:8], ap, g0s[:8], "cpu") == [
        native.aln_extend_native(a, b, ap.matrix, ap.row, ap.gap_open,
                                 ap.gap_ext, ap.band_width, g0)
        for (a, b), g0 in zip(jobs[:8], g0s[:8])]


def test_extend_dispatch_and_kernel_checks():
    jobs, g0s, bws = _jobs(45, n=4)
    args = tdp.pack_extend(jobs, g0s, bws, "cpu")
    kw = dict(mat=_bwasw_ap().matrix, go=5, ge=2)
    with pytest.raises(ValueError):           # the kernel takes CUDA only
        tdp.extend_cuda(**args, **kw)
    meta = {k: v.to("meta") for k, v in args.items()}
    with pytest.raises(ValueError):
        tdp.extend(**meta, **kw)


@functools.lru_cache(maxsize=None)
def _seed_case(seed, scoring):
    jobs, g0s, bws = _jobs(seed)
    ap = _ap(*scoring)
    args = tdp.pack_extend(jobs, g0s, bws, "cpu")
    plain = tdp.extend_plain(**args, mat=ap.matrix, go=ap.gap_open,
                             ge=ap.gap_ext)
    return args, ap, [p.numpy() for p in plain], _jax_extend(args, ap)


def _check_lanes(host_kernels, args, ap, plain, want, lanes, k=4):
    """The lane-by-lane warp kernel against the plain version (all four
    outputs), the serial extend_job and the JAX function (score, end)."""
    kw = dict(mat=ap.matrix, go=ap.gap_open, ge=ap.gap_ext)
    na = {key: v.numpy() for key, v in args.items()}
    got = test_torch_host_kernels.extend(host_kernels, **na, **kw,
                                         lanes=lanes, k=k)
    serial = test_torch_host_kernels.extend(host_kernels, **na, **kw)
    for g, p, s in zip(got, plain, serial):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, s)
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lanes,k", [(1, 4), (4, 4), (32, 4), (32, 1)])
@pytest.mark.parametrize("seed,scoring", PARAMS)
def test_lane_emulation_matches_plain_and_jax(host_kernels, seed, scoring,
                                              lanes, k):
    args, ap, plain, want = _seed_case(seed, scoring)
    _check_lanes(host_kernels, args, ap, plain, want, lanes, k)


def _edge_case(name):
    """(args, ap) of one kind of edge job."""
    rng = np.random.default_rng(61)
    if name == "widest_single":       # one job, its window the whole target
        tgt = rng.integers(0, 4, 700).astype(np.uint8)
        jobs = [(tgt, _mutate(rng, tgt[:400], 0.03, 0.02, 0.02))]
        return tdp.pack_extend(jobs, [30], [800], "cpu"), _bwasw_ap()
    if name in ("wide_band", "narrow_window"):
        jobs = []
        for _ in range(9):
            tgt = rng.integers(0, 4, int(rng.integers(60, 500)))
            tgt = tgt.astype(np.uint8)
            jobs.append((tgt, _mutate(rng, tgt[:int(rng.integers(
                20, len(tgt))) or 1], 0.05, 0.03, 0.03)))
        bws = ([130, 200, 333, 129, 128, 127, 300, 150, 257]
               if name == "wide_band" else [0, 1, 2, 3, 5, 8, 13, 15, 1])
        g0s = [int(g) for g in rng.integers(1, 40, len(jobs))]
        return tdp.pack_extend(jobs, g0s, bws, "cpu"), _bwasw_ap()
    if name == "len2_0_1":            # len2 0 and 1 beside longer jobs
        jobs, g0s, bws = _jobs(62, n=8)
        args = tdp.pack_extend(jobs, g0s, bws, "cpu")
        args["len2"][[1, 3]] = 0
        args["len2"][[2, 4, 6]] = 1
        return args, _bwasw_ap()
    if name == "tied_best":
        # short jobs over one or two letters, no mismatch cost beyond a
        # match's: rows that set a new best often tie at their maximum,
        # within one lane's cells and across lanes
        jobs = []
        for _ in range(96):
            alph = int(rng.integers(1, 3))
            jobs.append((rng.integers(0, alph + 1, int(rng.integers(
                2, 40))).astype(np.uint8), rng.integers(
                    0, alph + 1, int(rng.integers(1, 30))).astype(np.uint8)))
        g0s = [int(g) for g in rng.integers(1, 12, len(jobs))]
        bws = [int(b) for b in rng.integers(1, 40, len(jobs))]
        return tdp.pack_extend(jobs, g0s, bws, "cpu"), _ap(2, 1, 2, 1)
    assert name == "ties"             # periodic rows tie at their maximum
    jobs = []
    for period in (1, 2, 3, 4):
        unit = np.arange(period, dtype=np.uint8) % 4
        tgt = np.tile(unit, 300 // period + 1)[:300]
        jobs.append((tgt, tgt[:120].copy()))
        jobs.append((tgt, np.roll(tgt, 1)[:90].copy()))
    g0s = [1, 5, 20, 1, 3, 40, 7, 2]
    return tdp.pack_extend(jobs, g0s, [50, 7] * 4, "cpu"), _ap(1, 1, 1, 1)


@pytest.mark.parametrize("name", ["widest_single", "wide_band",
                                  "narrow_window", "len2_0_1", "ties",
                                  "tied_best"])
def test_lane_emulation_edges(host_kernels, name):
    args, ap = _edge_case(name)
    plain = [p.numpy() for p in tdp.extend_plain(
        **args, mat=ap.matrix, go=ap.gap_open, ge=ap.gap_ext)]
    want = _jax_extend(args, ap)
    if name == "widest_single":       # the window spans the whole target
        assert plain[3][0] > 120 * 400
    if name == "len2_0_1":
        assert (plain[2][[1, 3]] == 0).all() and (plain[3][[1, 3]] == 0).all()
        assert (plain[2][[2, 4, 6]] <= 1).all()
    for lanes, k in ((1, 4), (4, 4), (32, 4), (32, 1), (3, 1)):
        _check_lanes(host_kernels, args, ap, plain, want, lanes, k)
