"""The port's plain PyTorch DFS (`nabwa_tpu_torch.ops.dfs`) against the
JAX package's jnp DFS and its Pallas kernel (interpret mode) on the CPU.

Inputs are made once per case from fixed seeds and handed to both sides
as numpy arrays.  Everything is integer, so the tolerance is exact
equality: the plain version is a line-for-line port of the jnp lockstep
engine and must give the identical packed [B, 4H+5] result, telemetry
columns included; against the Pallas kernel the per-read contract of
tests/test_dfs_pallas.py applies (overflow, n_aln, hits, hw).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabwa_tpu.constants import BWA_AVG_ERR
from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.io import fastq
from nabwa_tpu.models.aln import AlnEngine, _maxdiff_table
from nabwa_tpu.ops import dfs_pallas
from nabwa_tpu.ops.dfs import aln_device_step, unpack_result
from nabwa_tpu.options import GapOpt
from nabwa_tpu.refmodel.aln_scalar import cal_maxdiff
from nabwa_tpu_torch.index.fmindex import DeviceIndex
from nabwa_tpu_torch.ops import dfs as tdfs
from nabwa_tpu_torch.ops import occ as tocc

from . import genomes, test_torch_host_kernels


def _inputs(tmp_path, glen, n_reads, read_len, err, indel, seed, opt,
            stack_cap, hits_cap):
    """Index + padded batch arrays exactly as the engines build them."""
    fa, seqs = genomes.random_genome(glen, seed=seed)
    fq = genomes.sample_reads(seqs[0], n_reads, read_len, seed=seed + 1,
                              err_rate=err, indel_rate=indel)
    (tmp_path / "g.fa").write_bytes(fa)
    (tmp_path / "r.fq").write_bytes(fq)
    build_index(str(tmp_path / "g.fa"))
    idx = BwaIndex.load(str(tmp_path / "g.fa"))
    reads = fastq.read_fastq_batch(
        fastq.iter_fastq(str(tmp_path / "r.fq")), 1 << 20)
    max_len = max(r.len for r in reads)
    local = copy.copy(opt)
    if opt.fnr > 0.0:
        local.max_diff = cal_maxdiff(max_len, BWA_AVG_ERR, opt.fnr)
        tab = _maxdiff_table(opt.fnr, max(max_len, 64))
        maxdiff = np.array([tab[r.len] for r in reads], dtype=np.int32)
    else:
        maxdiff = np.full(len(reads), opt.max_diff, dtype=np.int32)
    if local.max_diff < local.max_gapo:
        local.max_gapo = local.max_diff
    B = max(16, -(-len(reads) // 16) * 16)
    L = max(32, -(-max_len // 32) * 32)
    maxdiff = np.concatenate([maxdiff, np.zeros(B - len(reads), np.int32)])
    seqs_a = np.full((B, 2, L), 4, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        seqs_a[i, 0, :r.len] = r.seq
        seqs_a[i, 1, :r.len] = r.rseq
        lengths[i] = r.len
    seeded = local.seed_len < 0x7FFFFFFF
    SL = max(min(local.seed_len, L) if seeded else L, 1)
    has_seed = (lengths > local.seed_len if seeded
                else np.zeros(B, dtype=bool))
    seed_starts = np.maximum(lengths - (local.seed_len if seeded else 0), 0)
    gi = np.minimum(seed_starts[:, None] + np.arange(SL), L - 1)
    sseq = np.stack([np.take_along_axis(seqs_a[:, 0, :], gi, 1),
                     np.take_along_axis(seqs_a[:, 1, :], gi, 1)], axis=1)
    slen = np.where(has_seed, min(local.seed_len, SL), 0).astype(np.int32)
    statics = dict(
        s_mm=local.s_mm, s_gapo=local.s_gapo, s_gape=local.s_gape,
        max_gape=local.max_gape, max_gapo=local.max_gapo,
        indel_end_skip=local.indel_end_skip,
        max_del_occ=local.max_del_occ, max_entries=local.max_entries,
        max_top2=local.max_top2, max_seed_diff=local.max_seed_diff,
        seed_len=local.seed_len, mode=local.mode,
        stack_cap=stack_cap, hits_cap=hits_cap, max_iters=100000)
    batch = (seqs_a, lengths, sseq, slen, has_seed, maxdiff)
    return idx, len(reads), batch, statics


def _jax_ref(idx, opt, batch, statics):
    eng = AlnEngine(idx, opt, use_pallas=False)
    return np.asarray(aln_device_step(
        eng.bwt_cat, eng.bwt_fwd, eng.bwt_rev, eng.rev_off,
        eng.primary_fwd, eng.primary_rev, eng.l2, eng.seq_len,
        *[jnp.asarray(a) for a in batch], **statics)), eng


def _torch_plain(idx, batch, statics):
    ix = DeviceIndex.from_host(idx, "cpu")
    out = tdfs.aln_device_step(
        ix.bwt_cat, ix.bwt_fwd, ix.bwt_rev, ix.rev_word_offset,
        ix.primary_fwd, ix.primary_rev, ix.l2, ix.seq_len,
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in batch],
        **statics)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy()


def _assert_per_read(ref, got, n_reads, hits_cap):
    ru = unpack_result(ref, hits_cap)
    tu = tdfs.unpack_result(got, hits_cap)
    for i in range(n_reads):
        ro, to = bool(ru["overflow"][i]), bool(tu["overflow"][i])
        assert ro == to, f"read {i}: overflow {ro} != {to}"
        if ro:
            continue
        assert ru["n_aln"][i] == tu["n_aln"][i], f"read {i} n_aln"
        n = int(ru["n_aln"][i])
        for f in ("hit_meta", "hit_k", "hit_l", "hit_score"):
            np.testing.assert_array_equal(
                ru[f][i, :n], tu[f][i, :n], err_msg=f"read {i} {f}")
        assert ru["hw"][i] == tu["hw"][i], f"read {i} hw"


CASES = {
    "mismatch": (20000, 16, 40, 0.02, 0.2, 301, GapOpt(), 128),
    "gapped_n4_o2": (30000, 16, 75, 0.02, 0.5, 302,
                     GapOpt(max_diff=4, fnr=-1.0, max_gapo=2), 128),
    "seeded_l25": (30000, 16, 80, 0.03, 0.2, 303, GapOpt(seed_len=25), 128),
    "small_stack_overflow": (30000, 16, 75, 0.03, 0.5, 308,
                             GapOpt(max_diff=4, fnr=-1.0, max_gapo=2), 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_dfs_matches_jax(tmp_path, case):
    glen, n, rl, err, indel, seed, opt, stack_cap = CASES[case]
    idx, n_reads, batch, statics = _inputs(tmp_path, glen, n, rl, err,
                                           indel, seed, opt, stack_cap, 16)
    ref, _ = _jax_ref(idx, opt, batch, statics)
    got = _torch_plain(idx, batch, statics)
    _assert_per_read(ref, got, n_reads, 16)
    np.testing.assert_array_equal(ref, got)
    ovf = unpack_result(ref, 16)["overflow"][:n_reads]
    if case == "small_stack_overflow":
        assert ovf.any(), "the small stack must overflow some reads"
    else:
        assert unpack_result(ref, 16)["n_aln"][:n_reads].any()


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    return test_torch_host_kernels.build(
        tmp_path_factory.mktemp("host_kernels"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_on_host_matches_plain(tmp_path, host_kernels, case):
    """C1's own source (csrc/dfs_read.cuh), built for the host, against the
    plain version: every column but the kernel's telemetry (fin, iters)."""
    glen, n, rl, err, indel, seed, opt, stack_cap = CASES[case]
    idx, _, batch, statics = _inputs(tmp_path, glen, n, rl, err, indel,
                                     seed, opt, stack_cap, 16)
    ix = DeviceIndex.from_host(idx, "cpu")
    seqs, lengths, sseq, slen, has_seed, maxdiff = [
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
        for a in batch]
    planes = []
    for q, ln in ((seqs, lengths), (sseq, slen)):
        wb = [tocc.cal_width_plain(bank, ix.l2, prim, ix.seq_len,
                                   q[:, s, :].contiguous(), ln)
              for s, bank, prim in ((0, ix.bwt_fwd, ix.primary_fwd),
                                    (1, ix.bwt_rev, ix.primary_rev))]
        planes += [torch.stack([w for w, _ in wb], 1),
                   torch.stack([b for _, b in wb], 1)]
    args = (ix.bwt_cat, ix.rev_word_offset, ix.primary_fwd, ix.primary_rev,
            ix.l2, ix.seq_len, seqs, lengths, *planes, has_seed, maxdiff)
    plain = tdfs.dfs_match_gap_plain(*args, **statics).numpy()
    host = test_torch_host_kernels.dfs(host_kernels, *args, **statics)
    np.testing.assert_array_equal(host[:, :4 * 16 + 3],
                                  plain[:, :4 * 16 + 3])


def test_plain_dfs_matches_pallas_interpret(tmp_path):
    opt = GapOpt(max_diff=4, fnr=-1.0, max_gapo=2)
    idx, n_reads, batch, statics = _inputs(tmp_path, 30000, 16, 75, 0.02,
                                           0.5, 302, opt, 128, 16)
    _, eng = _jax_ref(idx, opt, batch, statics)
    table, rev_row0 = dfs_pallas.build_table(np.asarray(eng.bwt_cat),
                                             eng.rev_off)
    params = dfs_pallas.build_params(np.asarray(eng.l2), eng.primary_fwd,
                                     eng.primary_rev, eng.seq_len, rev_row0)
    pal = np.asarray(dfs_pallas.aln_device_step_pallas(
        jnp.asarray(table), jnp.asarray(params), eng.bwt_fwd, eng.bwt_rev,
        eng.rev_off, eng.primary_fwd, eng.primary_rev, eng.l2, eng.seq_len,
        *[jnp.asarray(a) for a in batch], BB=len(batch[1]), interpret=True,
        **statics))
    got = _torch_plain(idx, batch, statics)
    _assert_per_read(pal, got, n_reads, 16)


def test_unpack_result_layout():
    H = 3
    packed = np.arange(2 * (4 * H + 5), dtype=np.int32).reshape(2, -1)
    u = tdfs.unpack_result(packed, H)
    np.testing.assert_array_equal(u["hit_l"], packed[:, 2 * H:3 * H])
    np.testing.assert_array_equal(u["hw"], packed[:, 4 * H + 1])
    assert u["iters"] == packed[0, 4 * H + 4]


def test_dfs_dispatch_rejects_other_devices():
    t = torch.zeros((1, 2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tdfs.dfs_match_gap(None, 0, 0, 0, (0,) * 5, 0, t, t, t, t, t, t, t,
                           t)


def test_kernel_wrapper_checks():
    """The CUDA wrapper refuses CPU tensors and inputs its slot layout
    cannot hold (a ValueError before any build or launch)."""
    from nabwa_tpu_torch.ops import dfs_cuda
    t = torch.zeros((1, 2, 4), dtype=torch.int32)
    statics = dict(s_mm=3, s_gapo=11, s_gape=4, max_gape=6, max_gapo=1,
                   indel_end_skip=5, max_del_occ=10, max_entries=2000000,
                   max_top2=30, max_seed_diff=2, seed_len=32, mode=3,
                   stack_cap=256, hits_cap=32, max_iters=768)
    with pytest.raises(ValueError):
        dfs_cuda.dfs_match_gap_cuda(t, 0, 0, 0, (0,) * 5, 0, t, t, t, t, t,
                                    t, t, t, **statics)
    ok = dict(L=128, max_diff_max=5, max_gapo=1, max_gape=6, s_mm=3,
              s_gapo=11, s_gape=4, stack_cap=256, hits_cap=32,
              max_iters=768)
    dfs_cuda.check_limits(**ok)
    for bad in (dict(L=1 << 14), dict(max_diff_max=256),
                dict(max_gape=300), dict(s_gapo=20000), dict(max_iters=0)):
        with pytest.raises(ValueError):
            dfs_cuda.check_limits(**{**ok, **bad})
