"""The port's plain suffix-array lookup (`nabwa_tpu_torch.ops.sa_lookup`)
against the JAX package's `nabwa_tpu.ops.sa_lookup` (jnp on the CPU) and
the shared native walk (`nabwa_tpu.index.native.bwt_sa_batch`), and kernel
C3's per-row source built for the host against the plain version.

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
