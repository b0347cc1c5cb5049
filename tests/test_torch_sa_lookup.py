"""The port's plain suffix-array lookup (`nabwa_tpu_torch.ops.sa_lookup`)
against the JAX package's `nabwa_tpu.ops.sa_lookup` (jnp on the CPU) and
the shared native walk (`nabwa_tpu.index.native.bwt_sa_batch`), and kernel
C3's per-row source built for the host against the plain version: one
strand and both strands a call, sa_intv 32, 24 and 1, a synthetic bank
past 2**31, and its division-free interval test.

A ~30 kbp genome with N holes indexed by `nabwa_tpu.index.build`; rows
drawn with numpy from fixed seeds plus the edge rows (0, primary,
seq_len, sampled rows).  Integer outputs, so the tolerance is exact
equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabwa_tpu.index import native
from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.ops import sa_lookup as jsl
from nabwa_tpu.refmodel.fm_scalar import ScalarFm
from nabwa_tpu_torch.index.fmindex import DeviceIndex
from nabwa_tpu_torch.ops import sa_lookup as tsl

from . import genomes, test_torch_host_kernels


def _index(d, sa_intv):
    fa, _ = genomes.random_genome(30000, seed=701, n_frac=0.001)
    (d / "g.fa").write_bytes(fa)
    build_index(str(d / "g.fa"), sa_intv=sa_intv)
    idx = BwaIndex.load(str(d / "g.fa"))
    return idx, DeviceIndex.from_host(idx, "cpu")


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    return _index(tmp_path_factory.mktemp("sa"), 32)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    return test_torch_host_kernels.build(tmp_path_factory.mktemp("hk"))


def _rows(fm, seed):
    n, p, intv = fm.seq_len, fm.primary, fm.sa_intv
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, n + 1, size=600),
        [0, 1, n - 1, n, p, p - 1, p + 1, intv, 2 * intv, intv + 1],
    ]).astype(np.uint32)


def _strand(idx, ix, a):
    fm = idx.fwd if a else idx.rev
    args = (ix.bwt_fwd if a else ix.bwt_rev, ix.l2,
            ix.primary_fwd if a else ix.primary_rev, ix.seq_len,
            ix.sa_fwd if a else ix.sa_rev, ix.sa_intv)
    return fm, args


def _native(idx, fm, rows):
    return native.bwt_sa_batch(fm.bwt, fm.primary, idx.fwd.l2, fm.seq_len,
                               fm.sa, fm.sa_intv, rows)


@pytest.mark.parametrize("a", [1, 0])
def test_sa_lookup_plain_matches_jax_and_native(index, a):
    idx, ix = index
    fm, args = _strand(idx, ix, a)
    rows = _rows(fm, 702 + a)
    got = tsl.sa_lookup(*args, torch.from_numpy(rows.view(np.int32)))
    got = got.numpy().view(np.uint32)
    want = np.asarray(jsl.sa_lookup(
        jnp.asarray(fm.bwt.view(np.int32)), jnp.asarray(
            np.asarray(fm.l2, dtype=np.uint32).view(np.int32)),
        np.uint32(fm.primary).view(np.int32),
        np.uint32(fm.seq_len).view(np.int32),
        jnp.asarray(np.asarray(fm.sa, dtype=np.uint32).view(np.int32)),
        fm.sa_intv, jnp.asarray(rows.view(np.int32)))).view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _native(idx, fm, rows))
    # row 0 is sampled with the reference's -1: sa + (-1) wraps
    assert got[len(rows) - 10] == 0xFFFFFFFF


@pytest.mark.parametrize("a", [1, 0])
def test_sa_lookup_kernel_source_on_host(index, host_kernels, a):
    idx, ix = index
    fm, args = _strand(idx, ix, a)
    rows = _rows(fm, 704 + a)
    plain = tsl.sa_lookup_plain(*args, torch.from_numpy(rows.view(np.int32)))
    got = test_torch_host_kernels.sa_lookup(
        host_kernels, fm.bwt, idx.fwd.l2, fm.primary, fm.seq_len, fm.sa,
        fm.sa_intv, rows)
    np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))


def test_sa_lookup_non_power_of_two_interval(tmp_path, host_kernels):
    """sa_intv 24: the modulo walk of the plain version and of C3's source
    against the scalar reference walk (the native batch walk and the jnp
    version take only powers of two)."""
    idx, ix = _index(tmp_path, 24)
    for a in (1, 0):
        fm, args = _strand(idx, ix, a)
        assert fm.sa_intv == 24
        rows = _rows(fm, 706 + a)[::4]
        sfm = ScalarFm(fm.bwt, fm.primary, fm.l2, fm.seq_len, fm.sa,
                       fm.sa_intv)
        want = np.array([sfm.sa(int(r)) for r in rows], dtype=np.uint32)
        got = tsl.sa_lookup(*args, torch.from_numpy(rows.view(np.int32)))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(test_torch_host_kernels.sa_lookup(
            host_kernels, fm.bwt, idx.fwd.l2, fm.primary, fm.seq_len, fm.sa,
            fm.sa_intv, rows), want)


def test_sa_lookup_dispatch(index):
    idx, ix = index
    _, args = _strand(idx, ix, 1)
    rows = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tsl.sa_lookup(*args, rows)
    with pytest.raises(ValueError):          # the kernel takes CUDA only
        tsl.sa_lookup_cuda(*args, torch.zeros(4, dtype=torch.int32))
    empty = tsl.sa_lookup(*args, torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0,)


def _edge_rows(idx, ix, a, seed):
    """Strand a's edge rows (0, primary and its neighbours, seq_len,
    sampled rows) and the row whose walk is longest among 4,000 drawn
    with numpy seed `seed`, with that walk's step count."""
    fm, args = _strand(idx, ix, a)
    draw = np.random.default_rng(seed).integers(
        0, fm.seq_len + 1, size=4000).astype(np.uint32)
    steps = tsl.sa_walk_steps(*args[:4], args[5],
                              torch.from_numpy(draw.view(np.int32)))
    longest = draw[int(steps.argmax())]
    n, p, intv = fm.seq_len, fm.primary, fm.sa_intv
    rows = np.array([0, 1, n - 1, n, p, p - 1, p + 1, intv, 2 * intv,
                     intv + 1, longest], dtype=np.uint32)
    return rows, int(steps.max())


def _want(idx, fm, rows):
    """bwt_sa of each row by the scalar reference walk."""
    sfm = ScalarFm(fm.bwt, fm.primary, fm.l2, fm.seq_len, fm.sa, fm.sa_intv)
    return np.array([sfm.sa(int(r)) for r in rows], dtype=np.uint32)


@pytest.fixture(scope="module", params=[32, 24, 1])
def index_intv(request, tmp_path_factory):
    return _index(tmp_path_factory.mktemp(f"sa{request.param}"),
                  request.param)


def test_sa_walk_both_strands(index_intv, host_kernels):
    """C3's source with both strands in one call (strand 0 the reverse
    bank, as `AlnEngine.sa_rows_both` orders them), at sa_intv 32, 24 and
    1: the edge rows, the longest walk of a seeded draw and random rows,
    against the plain version, the scalar reference walk, and at powers
    of two the jnp version and the native walk."""
    idx, ix = index_intv
    intv = idx.fwd.sa_intv
    rows, want, plain = [], [], []
    for a in (0, 1):
        fm, args = _strand(idx, ix, a)
        edge, longest = _edge_rows(idx, ix, a, 708 + a)
        r = np.concatenate([edge, _rows(fm, 710 + a)[:200]])
        if intv > 1:
            assert longest > 3 * intv      # not bounded by sa_intv - 1
        rows.append(r)
        want.append(_want(idx, fm, r))
        plain.append(tsl.sa_lookup_plain(
            *args, torch.from_numpy(r.view(np.int32))).numpy()
            .view(np.uint32))
        np.testing.assert_array_equal(plain[-1], want[-1])
        if intv & (intv - 1) == 0:
            np.testing.assert_array_equal(_native(idx, fm, r), want[-1])
            np.testing.assert_array_equal(np.asarray(jsl.sa_lookup(
                jnp.asarray(fm.bwt.view(np.int32)), jnp.asarray(
                    np.asarray(fm.l2, dtype=np.uint32).view(np.int32)),
                np.uint32(fm.primary).view(np.int32),
                np.uint32(fm.seq_len).view(np.int32),
                jnp.asarray(np.asarray(fm.sa, np.uint32).view(np.int32)),
                intv, jnp.asarray(r.view(np.int32)))).view(np.uint32),
                want[-1])
    got = test_torch_host_kernels.sa_lookup_both(
        host_kernels, (idx.rev.bwt, idx.fwd.bwt), idx.fwd.l2,
        (idx.rev.primary, idx.fwd.primary), (idx.rev.sa, idx.fwd.sa), intv,
        np.concatenate(rows), len(rows[0]))
    np.testing.assert_array_equal(got, np.concatenate(want))


@pytest.mark.parametrize("n0", ["both", 0, "all"])
def test_sa_lookup_both_matches_single_strands(index, host_kernels, n0):
    """The both-strand call against two single-strand calls, on the plain
    path and in the host harness, with both strands holding rows and with
    one strand empty."""
    idx, ix = index
    r0 = _rows(idx.rev, 712)
    r1 = _rows(idx.fwd, 713)[:400]
    if n0 == 0:
        r0 = r0[:0]
    if n0 == "all":
        r1 = r1[:0]
    rows = np.concatenate([r0, r1])
    banks, sas = (ix.bwt_rev, ix.bwt_fwd), (ix.sa_rev, ix.sa_fwd)
    prims = (ix.primary_rev, ix.primary_fwd)
    both = tsl.sa_lookup_both(banks, ix.l2, prims, ix.seq_len, sas,
                              ix.sa_intv, torch.from_numpy(rows.view(
                                  np.int32)), len(r0))
    one = [tsl.sa_lookup(banks[a], ix.l2, prims[a], ix.seq_len, sas[a],
                         ix.sa_intv, torch.from_numpy(r.view(np.int32)))
           for a, r in enumerate((r0, r1))]
    want = torch.cat(one).numpy().view(np.uint32)
    np.testing.assert_array_equal(both.numpy().view(np.uint32), want)
    got = test_torch_host_kernels.sa_lookup_both(
        host_kernels, (idx.rev.bwt, idx.fwd.bwt), idx.fwd.l2,
        (idx.rev.primary, idx.fwd.primary), (idx.rev.sa, idx.fwd.sa),
        idx.fwd.sa_intv, rows, len(r0))
    np.testing.assert_array_equal(got, want)
    for a, r in enumerate((r0, r1)):
        fm = idx.fwd if a else idx.rev
        np.testing.assert_array_equal(test_torch_host_kernels.sa_lookup(
            host_kernels, fm.bwt, idx.fwd.l2, fm.primary, fm.seq_len, fm.sa,
            fm.sa_intv, r), one[a].numpy().view(np.uint32))


def _synthetic_bank():
    """The synthetic bank of tests/test_torch_occ.py's
    `test_occ4_unsigned_past_2_31`: 8 blocks of random bwt words whose
    checkpoint counters lie past 2**31; L2 counts of 2**31 wrap each
    invPsi step back into the bank's 1,024 rows."""
    rng = np.random.default_rng(403)
    words = rng.integers(0, 1 << 32, size=12 * 8, dtype=np.uint64)
    words = words.astype(np.uint32)
    for b in range(8):
        words[12 * b:12 * b + 4] = (np.uint32(0x80000000)
                                    + np.uint32(b * 64))
    return words, [0x80000000] * 5, 1023


@pytest.mark.parametrize("intv", [4, 24, 32])
def test_sa_walk_past_2_31(host_kernels, intv):
    """The walk on the synthetic bank with the `$` row past 2**31 (every
    row below it: an unsigned compare keeps k, a signed one would skip a
    row) and inside the bank, both strands in one call, against the plain
    version and, at powers of two, the jnp version.  A
    random bank's invPsi may cycle without a sampled row, so the rows are
    those whose walk ends within 64 steps."""
    words, l2, seq_len = _synthetic_bank()
    rng = np.random.default_rng(714 + intv)
    sa = rng.integers(0, 1 << 32, size=seq_len // intv + 1,
                      dtype=np.uint64).astype(np.uint32)
    bank = torch.from_numpy(words.view(np.int32))
    l2v = torch.tensor(l2, dtype=torch.int64)
    rows, want = [], []
    for primary in (517, 0x80000001):
        k = torch.arange(seq_len + 1, dtype=torch.int64)
        for _ in range(64):
            k = torch.where(k % intv != 0,
                            tsl.inv_psi(bank, l2v, primary, seq_len, k), k)
        r = np.nonzero((k % intv == 0).numpy())[0].astype(np.uint32)
        assert len(r) > 40
        rows.append(r)
        got = tsl.sa_lookup_plain(bank, l2, primary, seq_len,
                                  torch.from_numpy(sa.view(np.int32)), intv,
                                  torch.from_numpy(r.view(np.int32)))
        want.append(got.numpy().view(np.uint32))
        if intv & (intv - 1) == 0:
            np.testing.assert_array_equal(np.asarray(jsl.sa_lookup(
                jnp.asarray(words.view(np.int32)),
                jnp.asarray(np.asarray(l2, np.uint32).view(np.int32)),
                np.uint32(primary).view(np.int32),
                np.uint32(seq_len).view(np.int32),
                jnp.asarray(sa.view(np.int32)), intv,
                jnp.asarray(r.view(np.int32)))).view(np.uint32), want[-1])
    steps = tsl.sa_walk_steps(bank, l2, 517, seq_len, intv,
                              torch.from_numpy(rows[0].view(np.int32)))
    assert int(steps.max()) >= 2
    got = test_torch_host_kernels.sa_lookup_both(
        host_kernels, (words, words), l2, (517, 0x80000001), (sa, sa), intv,
        np.concatenate(rows), len(rows[0]))
    np.testing.assert_array_equal(got, np.concatenate(want))


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 24, 32, 33, 100, 641, 1000,
                               65535, 65537, 1 << 20, (1 << 20) + 3,
                               (1 << 30) + 1, (1 << 31) - 1])
def test_sa_interval_division_exact(host_kernels, d):
    """C3's interval test without a division (a mask and a shift for a
    power of two, a multiply-high reciprocal otherwise) against numpy's
    k // d and k % d == 0 on every uint32 edge: 0, 1, the multiples of d
    and their neighbours up to 2**32 - 1, and random k."""
    rng = np.random.default_rng(720)
    mult = np.unique(np.concatenate([
        np.arange(0, 64, dtype=np.uint64) * d,
        (np.uint64(0xFFFFFFFF) // np.uint64(d)
         - np.arange(0, 64, dtype=np.uint64)) * np.uint64(d),
        rng.integers(0, (1 << 32) // d, size=2000,
                     dtype=np.uint64) * np.uint64(d)]))
    ks = np.concatenate([mult, mult + 1, mult - 1,
                         rng.integers(0, 1 << 32, size=20000,
                                      dtype=np.uint64),
                         [0, 1, 0xFFFFFFFF, 0xFFFFFFFE, 1 << 31,
                          (1 << 31) - 1]])
    ks = ks[(ks <= 0xFFFFFFFF)].astype(np.uint32)
    quot, sampled = test_torch_host_kernels.intv_quot(host_kernels, d, ks)
    np.testing.assert_array_equal(quot, ks // np.uint32(d))
    np.testing.assert_array_equal(sampled, ks % np.uint32(d) == 0)


def test_sa_lookup_both_dispatch(index):
    idx, ix = index
    banks, sas = (ix.bwt_rev, ix.bwt_fwd), (ix.sa_rev, ix.sa_fwd)
    prims = (ix.primary_rev, ix.primary_fwd)
    args = (banks, ix.l2, prims, ix.seq_len, sas, ix.sa_intv)
    with pytest.raises(ValueError):
        tsl.sa_lookup_both(*args, torch.zeros(4, dtype=torch.int32,
                                              device="meta"), 2)
    with pytest.raises(ValueError):          # the kernel takes CUDA only
        tsl.sa_lookup_both_cuda(*args, torch.zeros(4, dtype=torch.int32), 2)
    empty = tsl.sa_lookup_both(*args, torch.zeros(0, dtype=torch.int32), 0)
    assert empty.shape == (0,)
