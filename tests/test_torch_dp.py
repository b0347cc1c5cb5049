"""The port's banded global DP (`nabwa_tpu_torch.ops.dp`) against the JAX
package on the CPU: `banded_global_plain` against
`nabwa_tpu.ops.dp._banded_global_device` (score, end type and the whole
traceback lattice), `banded_global_batch` and the host reference route
against the scalar oracle `refmodel.stdaln_scalar.aln_global_core`, and
kernel C4's per-pair source built for the host against the plain version.

Pairs are drawn with numpy from fixed seeds: random windows and mutated
reads of unequal lengths both ways, N codes in the read, and degenerate
lengths (1 x 1, 0 x n, n x 0).  The parameter sets are those of
tests/test_dp_device.py, gap_end < 0 (the fallback to gap_ext) among them.
C4's warp kernel is also run lane by lane through the host harness (its
per-lane steps of dp_global.cuh, the carries combined in lane order) at
1, 4 and 32 lanes of 4 columns and at 32 lanes of 1, against the plain
version, the serial banded_global_pair and the JAX function, whole
lattice included, on these pairs and on edge pairs: b2 == len2 (the
part-1 last-row variant), sampe's per-pair bands with gap_end -1, rows
wider than a pass of 32 x 4 columns with wide and narrow bands, len2 0 and
1, ties of M, I and D, b1 and b2 drawn freely (bands that empty), and
go < 0 (every column swept).
Integer outputs, so the tolerance is exact equality.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabwa_tpu.ops import dp as jdp
from nabwa_tpu.refmodel.stdaln_scalar import (ALN_PARAM_BWA, ALN_SM_BLAST,
                                              ALN_SM_MAQ, AlnParam,
                                              aln_global_core)
from nabwa_tpu_torch.ops import dp as tdp

from . import test_torch_host_kernels

PARAMS = [
    (11, ALN_PARAM_BWA),
    (12, AlnParam(26, 9, 5, ALN_SM_MAQ, 5, 13)),      # narrow band
    (13, AlnParam(5, 2, 2, ALN_SM_BLAST, 5, 50)),     # blast params
    (14, AlnParam(26, 9, -1, ALN_SM_MAQ, 5, 50)),     # gap_end < 0
]


def _mutate(rng, seq, err, ins, dele):
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.integers(0, 4))
        out.append((c + rng.integers(1, 4)) % 4 if rng.random() < err
                   else c)
    return np.array(out, dtype=np.uint8)


def _pairs(seed, n=24):
    """Random (window, read) pairs, both length orders, N codes, and the
    degenerate 1 x 1 pair."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        ref = rng.integers(0, 4, size=int(rng.integers(5, 90)))
        ref = ref.astype(np.uint8)
        read = _mutate(rng, ref, 0.05, 0.04, 0.04)
        if len(read) == 0:
            read = ref[:1].copy()
        if rng.random() < 0.5 and len(read) > 2:
            read[rng.integers(0, len(read))] = 4
        pairs.append((ref, read))
    pairs.append((pairs[0][1].clip(0, 3), pairs[0][0]))
    pairs.append((pairs[1][0][:3], pairs[1][1]))     # window much shorter
    pairs.append((np.array([1], np.uint8), np.array([1], np.uint8)))
    return pairs


def _packed(pairs, ap):
    return tdp.pack_pairs(pairs, [ap.band_width] * len(pairs), "cpu")


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    return test_torch_host_kernels.build(tmp_path_factory.mktemp("hk"))


def _jax_global(args, ap):
    j = {k: jnp.asarray(v.numpy()) for k, v in args.items()}
    return [np.asarray(w) for w in jdp._banded_global_device(
        j["s1"], j["len1"], j["s2"], j["len2"], j["b1"], j["b2"],
        jnp.asarray(np.asarray(ap.matrix, dtype=np.int32)),
        go=ap.gap_open, ge=ap.gap_ext, gend=ap.gap_end)]


@pytest.mark.parametrize("seed,ap", PARAMS)
def test_plain_matches_jax_lattice(seed, ap):
    args = _packed(_pairs(seed), ap)
    kw = dict(go=ap.gap_open, ge=ap.gap_ext, gend=ap.gap_end)
    score, ctype, tb = tdp.banded_global_plain(**args, mat=ap.matrix, **kw)
    want = _jax_global(args, ap)
    np.testing.assert_array_equal(score.numpy(), want[0])
    np.testing.assert_array_equal(ctype.numpy(), want[1])
    assert tb.dtype == torch.uint8
    np.testing.assert_array_equal(tb.numpy(), want[2])


@pytest.mark.parametrize("seed,ap", PARAMS)
def test_kernel_source_on_host_matches_plain(host_kernels, seed, ap):
    args = _packed(_pairs(seed + 100), ap)
    kw = dict(go=ap.gap_open, ge=ap.gap_ext, gend=ap.gap_end)
    plain = tdp.banded_global_plain(**args, mat=ap.matrix, **kw)
    got = test_torch_host_kernels.banded_global(
        host_kernels, **{k: v.numpy() for k, v in args.items()},
        mat=ap.matrix, **kw)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())


@pytest.mark.parametrize("seed,ap", PARAMS)
def test_batch_paths_match_oracle(seed, ap):
    """banded_global_batch (plain DP, split into several device batches)
    and the host reference route against the scalar oracle, zero-length
    pairs included."""
    pairs = _pairs(seed + 200)
    pairs.append((np.array([], np.uint8), np.array([2], np.uint8)))
    pairs.insert(3, (np.array([1, 2], np.uint8), np.array([], np.uint8)))
    want = []
    for a, b in pairs:
        score, path = aln_global_core(a, b, ap)
        want.append((score, [(int(c), int(x), int(y)) for c, x, y in path]))
    old = tdp.MAX_PAIRS
    tdp.MAX_PAIRS = 7
    try:
        got = tdp.banded_global_batch(pairs, ap, "cpu")
    finally:
        tdp.MAX_PAIRS = old
    assert got == want
    assert tdp.banded_global_native(pairs, ap) == want


def test_batch_split_by_lattice_bytes(monkeypatch):
    """Long pairs (bwasw's cigars) under a small lattice bound go to the
    device in several batches, each within the bound, and give the results
    of one batch."""
    rng = np.random.default_rng(17)
    pairs = []
    for _ in range(9):
        ref = rng.integers(0, 4, int(rng.integers(150, 400)))
        pairs.append((ref.astype(np.uint8), _mutate(rng, ref, 0.03, 0.02,
                                                    0.02)))
    pairs.insert(4, (np.array([], np.uint8), pairs[0][1]))
    ap = AlnParam(5, 2, 2, ALN_SM_BLAST, 5, 30)
    whole = tdp.banded_global_batch(pairs, ap, "cpu")
    bound = 3 * 401 * 420
    monkeypatch.setattr(tdp, "MAX_LATTICE_BYTES", bound)
    sizes = []
    plain = tdp.banded_global_plain

    def recorded(s1, len1, s2, *args, **kw):
        sizes.append(s1.shape[0] * s1.shape[1] * s2.shape[1])
        return plain(s1, len1, s2, *args, **kw)

    monkeypatch.setattr(tdp, "banded_global_plain", recorded)
    assert tdp.banded_global_batch(pairs, ap, "cpu") == whole
    assert len(sizes) >= 3 and max(sizes) <= bound
    assert whole == tdp.banded_global_native(pairs, ap)


def test_batch_band_widths_and_seconds():
    pairs = _pairs(15)
    bws = [5 + (i % 7) for i in range(len(pairs))]
    secs = {"dp": 0.0, "dp_backtrace": 0.0}
    got = tdp.banded_global_batch(pairs, ALN_PARAM_BWA, "cpu",
                                  band_widths=bws, seconds=secs)
    ref = tdp.banded_global_native(pairs, ALN_PARAM_BWA, band_widths=bws)
    assert got == ref
    assert secs["dp"] > 0 and secs["dp_backtrace"] > 0


def test_dispatch_and_kernel_checks():
    args = _packed(_pairs(16, n=4), ALN_PARAM_BWA)
    kw = dict(mat=ALN_PARAM_BWA.matrix, go=26, ge=9, gend=5)
    with pytest.raises(ValueError):           # the kernel takes CUDA only
        tdp.banded_global_cuda(**args, **kw)
    meta = {k: v.to("meta") for k, v in args.items()}
    with pytest.raises(ValueError):
        tdp.banded_global(**meta, **kw)


def _check_lanes(host_kernels, args, ap, lanes, k, plain=None, want=None):
    """The lane-by-lane warp kernel against the plain version, the serial
    banded_global_pair and the JAX function: score, end type and the whole
    lattice."""
    kw = dict(mat=ap.matrix, go=ap.gap_open, ge=ap.gap_ext, gend=ap.gap_end)
    if plain is None:
        plain = [p.numpy() for p in tdp.banded_global_plain(**args, **kw)]
        want = _jax_global(args, ap)
    na = {key: v.numpy() for key, v in args.items()}
    got = test_torch_host_kernels.banded_global(host_kernels, **na, **kw,
                                                lanes=lanes, k=k)
    serial = test_torch_host_kernels.banded_global(host_kernels, **na, **kw)
    for g, p, s, w in zip(got, plain, serial, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(g, w)


@functools.lru_cache(maxsize=None)
def _seed_case(seed, ap):
    args = _packed(_pairs(seed), ap)
    kw = dict(go=ap.gap_open, ge=ap.gap_ext, gend=ap.gap_end)
    plain = [p.numpy() for p in tdp.banded_global_plain(**args, mat=ap.matrix,
                                                         **kw)]
    return args, plain, _jax_global(args, ap)


@pytest.mark.parametrize("lanes,k", [(1, 4), (4, 4), (32, 4), (32, 1)])
@pytest.mark.parametrize("seed,ap", PARAMS)
def test_lane_emulation_matches_plain_and_jax(host_kernels, seed, ap, lanes,
                                              k):
    args, plain, want = _seed_case(seed, ap)
    _check_lanes(host_kernels, args, ap, lanes, k, plain, want)


def _edge_case(name):
    """(args, ap) of one kind of edge pair."""
    rng = np.random.default_rng(71)
    if name == "b2_eq_len2":
        # len1 <= len2 with bw >= len1, and len1 > len2 with bw >= len2:
        # b2 clamps to len2 (the part-1 last-row variant)
        pairs = []
        for _ in range(10):
            ref = rng.integers(0, 4, int(rng.integers(3, 40))).astype(
                np.uint8)
            read = _mutate(rng, ref, 0.05, 0.1, 0.02)
            pairs.append((ref, read if len(read) else ref[:1]))
        ap = AlnParam(26, 9, 5, ALN_SM_MAQ, 5, 40)
        args = tdp.pack_pairs(pairs, [40] * len(pairs), "cpu")
        assert (args["b2"] == args["len2"]).sum() >= 8
        return args, ap
    if name == "sampe_bands":         # per-pair bands, gap_end -1
        pairs = _pairs(72, n=20)
        ap = AlnParam(26, 9, -1, ALN_SM_MAQ, 5, 50)
        return tdp.pack_pairs(pairs, [1 + (i * 7) % 23 for i in
                                      range(len(pairs))], "cpu"), ap
    if name in ("wide_rows", "narrow_band"):
        pairs = []
        for _ in range(6):
            ref = rng.integers(0, 4, int(rng.integers(150, 420))).astype(
                np.uint8)
            pairs.append((ref, _mutate(rng, ref[:int(rng.integers(
                100, len(ref)))], 0.04, 0.03, 0.03)))
        bws = [300, 150, 200, 129, 256, 400] if name == "wide_rows" else [
            1, 2, 3, 5, 8, 13]
        return tdp.pack_pairs(pairs, bws, "cpu"), AlnParam(
            5, 2, 2, ALN_SM_BLAST, 5, 50)
    if name == "len2_0_1":
        args = _packed(_pairs(73, n=10), ALN_PARAM_BWA)
        args["len2"][[0, 4]] = 0
        args["len2"][[2, 5, 7]] = 1
        args["b2"] = torch.minimum(args["b2"], args["len2"])
        return args, ALN_PARAM_BWA
    if name == "ties":                # periodic pairs, M, I and D tie
        mat = np.where(np.eye(5, dtype=bool), 1, -1)
        pairs = []
        for period in (1, 2, 3):
            unit = np.arange(period, dtype=np.uint8) % 4
            ref = np.tile(unit, 60)[:90]
            pairs += [(ref, ref[:60].copy()), (ref[:50], ref[1:81].copy()),
                      (ref, np.roll(ref, 1)[:70].copy())]
        return tdp.pack_pairs(pairs, [10] * len(pairs), "cpu"), AlnParam(
            1, 1, 1, mat, 5, 10)
    if name == "odd_bands":
        # b1 and b2 drawn freely in [0, len + 2], not as pack_pairs clamps
        # them: bands that empty, rows past the band
        args = _packed(_pairs(75, n=30), ALN_PARAM_BWA)
        for key, n in (("b1", args["len1"]), ("b2", args["len2"])):
            args[key] = torch.as_tensor(
                rng.integers(0, n.numpy() + 3), dtype=torch.int32)
        return args, AlnParam(5, 2, 2, ALN_SM_BLAST, 5, 50)
    assert name == "go_negative"      # every column swept
    return (_packed(_pairs(74, n=8), ALN_PARAM_BWA),
            AlnParam(-3, 2, 1, ALN_SM_MAQ, 5, 13))


@pytest.mark.parametrize("name", ["b2_eq_len2", "sampe_bands", "wide_rows",
                                  "narrow_band", "len2_0_1", "ties",
                                  "odd_bands", "go_negative"])
def test_lane_emulation_edges(host_kernels, name):
    args, ap = _edge_case(name)
    kw = dict(go=ap.gap_open, ge=ap.gap_ext, gend=ap.gap_end)
    plain = [p.numpy() for p in tdp.banded_global_plain(**args, mat=ap.matrix,
                                                         **kw)]
    want = _jax_global(args, ap)
    if name == "len2_0_1":            # rows 1.. of a len2-0 pair are zero
        assert not plain[2][[0, 4], 1:].any()
    for lanes, k in ((1, 4), (4, 4), (32, 4), (32, 1), (3, 1)):
        _check_lanes(host_kernels, args, ap, lanes, k, plain, want)
