"""The port's plain occ4 / cal_width (`nabwa_tpu_torch.ops.occ`) against
the JAX package's `nabwa_tpu.ops.occ` on the CPU.

A ~20 kbp genome indexed by `nabwa_tpu.index.build`; queries and rows
drawn with numpy from fixed seeds.  Kernel C2's lane groups (8 lanes a
row) run lane by lane by the host harness, and the four-plane
`cal_width_planes`, are held to the JAX package's `cal_width` too.
Integer outputs, so the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.ops import occ as jocc
from nabwa_tpu_torch.index.fmindex import DeviceIndex
from nabwa_tpu_torch.ops import occ as tocc

from . import genomes, test_torch_host_kernels

M32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    d = tmp_path_factory.mktemp("occ")
    fa, _ = genomes.random_genome(20000, seed=401, n_frac=0.001)
    (d / "g.fa").write_bytes(fa)
    build_index(str(d / "g.fa"))
    idx = BwaIndex.load(str(d / "g.fa"))
    return idx, DeviceIndex.from_host(idx, "cpu")


def _bank(idx, ix, strand):
    fm = idx.fwd if strand == 0 else idx.rev
    tbank = ix.bwt_fwd if strand == 0 else ix.bwt_rev
    return fm, jnp.asarray(fm.bwt.view(np.int32)), tbank


@pytest.mark.parametrize("strand", [0, 1])
def test_occ4_matches_jax(index, strand):
    idx, ix = index
    fm, jbank, tbank = _bank(idx, ix, strand)
    n, p = fm.seq_len, fm.primary
    rng = np.random.default_rng(402 + strand)
    ks = np.concatenate([
        rng.integers(0, n + 1, size=500),
        [0, 1, 127, 128, n - 1, n, p, p - 1, p + 1, M32],
    ]).astype(np.uint32)
    want = np.asarray(jocc.occ4(jbank, np.uint32(p).view(np.int32),
                                np.uint32(n).view(np.int32),
                                jnp.asarray(ks.view(np.int32))))
    got = tocc.occ4(tbank, p, n, torch.from_numpy(ks.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64) & M32)
    np.testing.assert_array_equal(got.numpy()[-1], 0)   # k == -1


def test_occ4_unsigned_past_2_31(tmp_path):
    """primary and checkpoint counters past 2**31: the `$`-row compare and
    the count arithmetic are unsigned, as in the JAX package, in the plain
    version and in the kernels' occ.cuh built for the host."""
    lib = test_torch_host_kernels.build(tmp_path)
    rng = np.random.default_rng(403)
    words = rng.integers(0, 1 << 32, size=12 * 8, dtype=np.uint64)
    words = words.astype(np.uint32)
    for b in range(8):
        words[12 * b:12 * b + 4] = (np.uint32(0x80000000)
                                    + np.uint32(b * 64))
    ks = np.concatenate([rng.integers(0, 8 * 128, size=200),
                         [0, 1023, M32]]).astype(np.uint32)
    for primary in (0x80000001, 517):
        want = np.asarray(jocc.occ4(
            jnp.asarray(words.view(np.int32)),
            np.uint32(primary).view(np.int32), np.int32(0),
            jnp.asarray(ks.view(np.int32))))
        got = tocc.occ4(torch.from_numpy(words.view(np.int32)), primary, 0,
                        torch.from_numpy(ks.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(),
                                      want.astype(np.int64) & M32)
        assert (got.numpy()[:-1, 0] >= 0x80000000).all()
        host = test_torch_host_kernels.occ4(lib, words, primary, ks)
        np.testing.assert_array_equal(host.astype(np.int64), got.numpy())


def _queries(strand, B=64, L=48, seed=404):
    """Reads of the genome with mismatches, Ns, empty and full-width rows,
    and random padding rows."""
    rng = np.random.default_rng(seed + strand)
    seq = np.frombuffer(genomes.random_genome(20000, seed=401,
                                              n_frac=0.001)[1][0],
                        dtype=np.uint8)
    code = np.full(256, 4, dtype=np.int32)
    code[list(b"ACGT")] = np.arange(4)
    q = np.full((B, L), 4, dtype=np.int32)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[:4] = (0, 1, L, L)                 # empty, one base, full width
    for b in range(B):
        start = int(rng.integers(0, len(seq) - L))
        q[b, :lengths[b]] = code[seq[start:start + lengths[b]]]
        if b % 5 == 0 and lengths[b]:           # mismatches and Ns
            q[b, int(rng.integers(0, lengths[b]))] = int(rng.integers(0, 5))
    q[B - 8:] = rng.integers(0, 5, size=(8, L))  # random rows, padding lanes
    return q, lengths


def _jax_cal_width(fm, jbank, q, lengths):
    jw, jb = jocc.cal_width(jbank, jnp.asarray(fm.l2.view(np.int32)),
                            np.uint32(fm.primary).view(np.int32),
                            np.uint32(fm.seq_len).view(np.int32),
                            jnp.asarray(q), jnp.asarray(lengths))
    return np.asarray(jw), np.asarray(jb)


@pytest.mark.parametrize("strand", [0, 1])
def test_cal_width_matches_jax(index, strand):
    idx, ix = index
    fm, jbank, tbank = _bank(idx, ix, strand)
    q, lengths = _queries(strand)
    jw, jb = _jax_cal_width(fm, jbank, q, lengths)
    tw, tb = tocc.cal_width(tbank, ix.l2, fm.primary, fm.seq_len,
                            torch.from_numpy(q), torch.from_numpy(lengths))
    assert tw.dtype == torch.int32 and tb.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("strand", [0, 1])
def test_cal_width_kernel_source_on_host(index, strand, tmp_path):
    """C2's own source (csrc/occ.cuh cal_width_row), built for the host,
    against the JAX package."""
    idx, ix = index
    fm, jbank, tbank = _bank(idx, ix, strand)
    q, lengths = _queries(strand)
    lib = test_torch_host_kernels.build(tmp_path)
    hw, hb = test_torch_host_kernels.cal_width(
        lib, tbank, ix.l2, fm.primary, fm.seq_len, q, lengths)
    jw, jb = _jax_cal_width(fm, jbank, q, lengths)
    np.testing.assert_array_equal(hw, jw)
    np.testing.assert_array_equal(hb, jb)


@pytest.mark.parametrize("seed", [406, 416])
@pytest.mark.parametrize("strand", [0, 1])
def test_occ_group_parts_match_jax(index, strand, seed, tmp_path):
    """A C2 group's half-sum of `occ_lane_part` equals the JAX package's
    occ4 at each base, at random rows (two seeds), rows on both sides of
    the `$` row, both block ends, the last rows and k == (uint32)-1, and
    on the synthetic bank past 2**31."""
    idx, ix = index
    fm, jbank, tbank = _bank(idx, ix, strand)
    lib = test_torch_host_kernels.build(tmp_path)
    n, p = fm.seq_len, fm.primary
    rng = np.random.default_rng(seed + strand)
    ks = np.concatenate([rng.integers(0, n + 1, size=200),
                         [0, 1, 127, 128, 129, n - 1, n, p - 1, p, p + 1,
                          M32]]).astype(np.uint32)
    banks = [(tbank.numpy().view(np.uint32), jbank, p, ks)]
    words = rng.integers(0, 1 << 32, size=12 * 8, dtype=np.uint64)
    words = words.astype(np.uint32)
    words[0::12] |= np.uint32(0x80000000)
    for primary in (0x80000001, 517):
        banks.append((words, jnp.asarray(words.view(np.int32)), primary,
                      np.concatenate([rng.integers(0, 1024, size=100),
                                      [0, 516, 517, 518, 1023, M32]])
                      .astype(np.uint32)))
    for bank, jb, primary, rows in banks:
        want = np.asarray(jocc.occ4(jb, np.uint32(primary).view(np.int32),
                                    np.int32(0),
                                    jnp.asarray(rows.view(np.int32))))
        want = want.view(np.uint32)
        for c in range(4):
            got = test_torch_host_kernels.occ_group(
                lib, bank, primary, rows, np.full(len(rows), c))
            np.testing.assert_array_equal(got, want[:, c])


@pytest.mark.parametrize("shape", [(64, 48), (96, 101)])
@pytest.mark.parametrize("strand", [0, 1])
def test_cal_width_group_form_matches_jax(index, strand, shape, tmp_path):
    """C2's lane groups (csrc/occ.cuh `occ_lane_part`, `cal_width_advance`,
    `cal_width_column`) run lane by lane at 8 lanes a row, against the JAX
    package and the serial `cal_width_row`: rows with N codes (restarts),
    len 0, len 1 and len L, random padding rows, at L 48 and at 101 (not a
    multiple of the group, and past the aln reads' 100)."""
    idx, ix = index
    fm, jbank, tbank = _bank(idx, ix, strand)
    q, lengths = _queries(strand, *shape)
    assert (lengths == 0).any() and (lengths == q.shape[1]).any()
    assert (q[lengths > 0] > 3).any()
    lib = test_torch_host_kernels.build(tmp_path)
    gw, gb = test_torch_host_kernels.cal_width_group(
        lib, tbank, ix.l2, fm.primary, fm.seq_len, q, lengths)
    jw, jb = _jax_cal_width(fm, jbank, q, lengths)
    np.testing.assert_array_equal(gw, jw)
    np.testing.assert_array_equal(gb, jb)
    hw, hb = test_torch_host_kernels.cal_width(
        lib, tbank, ix.l2, fm.primary, fm.seq_len, q, lengths)
    np.testing.assert_array_equal(gw, hw)
    np.testing.assert_array_equal(gb, hb)


@pytest.mark.parametrize("primary", [0x80000001, 517])
def test_cal_width_group_past_2_31(tmp_path, primary):
    """The lane groups on the synthetic bank of
    `test_occ4_unsigned_past_2_31` (checkpoint counters past 2**31, the
    `$` row past 2**31 or inside the bank): L2 counts of 2**31 wrap the
    interval back into the bank's 1,024 rows, so every step's unsigned
    sums and compares wrap, as in the JAX package."""
    lib = test_torch_host_kernels.build(tmp_path)
    rng = np.random.default_rng(403)
    words = rng.integers(0, 1 << 32, size=12 * 8, dtype=np.uint64)
    words = words.astype(np.uint32)
    for b in range(8):
        words[12 * b:12 * b + 4] = (np.uint32(0x80000000)
                                    + np.uint32(b * 64))
    l2 = [0x80000000] * 4 + [0x80000000]
    seq_len = 1023
    B, L = 40, 24
    q = rng.integers(0, 5, size=(B, L)).astype(np.int32)
    q[:20] = rng.integers(0, 4, size=(20, L))
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[:3] = (0, L, 1)
    jw, jb = jocc.cal_width(jnp.asarray(words.view(np.int32)),
                            jnp.asarray(np.asarray(l2, np.uint32)
                                        .view(np.int32)),
                            np.uint32(primary).view(np.int32),
                            np.uint32(seq_len).view(np.int32),
                            jnp.asarray(q), jnp.asarray(lengths))
    pw, pb = tocc.cal_width(torch.from_numpy(words.view(np.int32)), l2,
                            primary, seq_len, torch.from_numpy(q),
                            torch.from_numpy(lengths))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    gw, gb = test_torch_host_kernels.cal_width_group(
        lib, words, l2, primary, seq_len, q, lengths)
    np.testing.assert_array_equal(gw, np.asarray(jw))
    np.testing.assert_array_equal(gb, np.asarray(jb))
    # the walk moves: some step's interval is narrower than the whole bank
    assert (np.asarray(jw)[:, :L] != seq_len + 1).any()


def test_cal_width_planes_matches_jax(index):
    """`cal_width_planes` on CPU tensors against the JAX package's four
    `cal_width` calls as nabwa_tpu/ops/dfs_pallas.py:1446-1453 makes
    them: reads and seed suffixes, strand s on bank s, stacked on axis
    1."""
    idx, ix = index
    seqs = np.stack([_queries(s)[0] for s in (0, 1)], 1)
    lengths = _queries(0)[1]
    seed = np.stack([_queries(s, L=20, seed=405)[0] for s in (0, 1)], 1)
    seed_lengths = _queries(0, L=20, seed=405)[1]
    got = tocc.cal_width_planes(
        ix.bwt_fwd, ix.bwt_rev, ix.l2, ix.primary_fwd, ix.primary_rev,
        ix.seq_len, torch.from_numpy(seqs), torch.from_numpy(lengths),
        torch.from_numpy(seed), torch.from_numpy(seed_lengths))
    banks = [_bank(idx, ix, s)[:2] for s in (0, 1)]
    want = []
    for q, lens in ((seqs, lengths), (seed, seed_lengths)):
        ws, bs = zip(*[_jax_cal_width(*banks[s], q[:, s, :], lens)
                       for s in (0, 1)])
        want += [np.stack(ws, 1), np.stack(bs, 1)]
    assert [tuple(g.shape) for g in got] == [(64, 2, 49)] * 2 + [
        (64, 2, 21)] * 2
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError):
        tocc.cal_width_planes_cuda(
            ix.bwt_fwd, ix.bwt_rev, ix.l2, ix.primary_fwd, ix.primary_rev,
            ix.seq_len, torch.from_numpy(seqs), torch.from_numpy(lengths),
            torch.from_numpy(seed), torch.from_numpy(seed_lengths))


def test_cal_width_kernel_needs_cuda_tensors(index):
    _, ix = index
    q = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tocc.cal_width_cuda(ix.bwt_fwd, ix.l2, ix.primary_fwd,
                            ix.seq_len, q, torch.full((2,), 8,
                                                      dtype=torch.int32))


def test_device_index_layout(index):
    """Both banks padded to whole 48 B blocks, forward then reverse."""
    idx, ix = index
    off = ix.rev_word_offset
    assert off % 12 == 0 and ix.bwt_cat.numel() % 12 == 0
    nf, nr = len(idx.fwd.bwt), len(idx.rev.bwt)
    np.testing.assert_array_equal(ix.bwt_cat[:nf].numpy(),
                                  idx.fwd.bwt.view(np.int32))
    np.testing.assert_array_equal(ix.bwt_cat[off:off + nr].numpy(),
                                  idx.rev.bwt.view(np.int32))
    assert not ix.bwt_cat[nf:off].any() and not ix.bwt_cat[off + nr:].any()
    assert ix.l2 == tuple(int(v) for v in idx.fwd.l2[:5])
    assert ix.sa_fwd.device.type == "cpu" and ix.sa_intv == idx.fwd.sa_intv
