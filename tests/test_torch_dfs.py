"""The port's plain PyTorch DFS (`nabwa_tpu_torch.ops.dfs`) against the
JAX package's jnp DFS and its Pallas kernel (interpret mode) on the CPU,
and kernel C1's own source built for the host: the serial `dfs_read` and
the warp kernel's `dfs_read_warp` run lane by lane (1, 4 and 32 lanes, its
state in a reused buffer as in shared memory or a region a read as in
device memory) on the seeded sets and on `chip_smoke.dfs_edge_data`'s
edge reads.

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

import chip_smoke
from nabwa_tpu_torch.ops import dfs_cuda

from . import genomes, test_torch_host_kernels


def _index(tmp_path, fa):
    (tmp_path / "g.fa").write_bytes(fa)
    build_index(str(tmp_path / "g.fa"))
    return BwaIndex.load(str(tmp_path / "g.fa"))


def _batch(tmp_path, fq, opt, stack_cap, hits_cap, max_iters=100000,
           zero_rows=(), pad=16):
    """Batch arrays of the reads in `fq` (B padded to a multiple of `pad`
    with empty rows), exactly as the engines build them, the rows in
    `zero_rows` given length 0; and the DFS's statics."""
    (tmp_path / "r.fq").write_bytes(fq)
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
    B = max(pad, -(-len(reads) // pad) * pad)
    L = max(32, -(-max_len // 32) * 32)
    maxdiff = np.concatenate([maxdiff, np.zeros(B - len(reads), np.int32)])
    seqs_a = np.full((B, 2, L), 4, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        seqs_a[i, 0, :r.len] = r.seq
        seqs_a[i, 1, :r.len] = r.rseq
        lengths[i] = r.len
    seqs_a[list(zero_rows)] = 4
    lengths[list(zero_rows)] = 0
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
        stack_cap=stack_cap, hits_cap=hits_cap, max_iters=max_iters)
    batch = (seqs_a, lengths, sseq, slen, has_seed, maxdiff)
    return len(reads), batch, statics


def _inputs(tmp_path, glen, n_reads, read_len, err, indel, seed, opt,
            stack_cap, hits_cap):
    """Index + padded batch arrays exactly as the engines build them."""
    fa, seqs = genomes.random_genome(glen, seed=seed)
    fq = genomes.sample_reads(seqs[0], n_reads, read_len, seed=seed + 1,
                              err_rate=err, indel_rate=indel)
    return (_index(tmp_path, fa),
            *_batch(tmp_path, fq, opt, stack_cap, hits_cap))


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


def _dfs_args(idx, batch, lib=None):
    """The DFS's tensor arguments (CPU) for a batch: the index, the reads
    and the width planes of both strands from the plain cal_width, or from
    C2's source built for the host when `lib` is given (the plain one
    walks a column at a time: 18 s at L 7,168)."""
    ix = DeviceIndex.from_host(idx, "cpu")
    seqs, lengths, sseq, slen, has_seed, maxdiff = [
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
        for a in batch]

    def cal_width(bank, prim, q, ln):
        if lib is None:
            return tocc.cal_width_plain(bank, ix.l2, prim, ix.seq_len, q, ln)
        return [torch.from_numpy(a) for a in test_torch_host_kernels.cal_width(
            lib, bank.numpy(), ix.l2, prim, ix.seq_len, q.numpy(),
            ln.numpy())]

    planes = []
    for q, ln in ((seqs, lengths), (sseq, slen)):
        wb = [cal_width(bank, prim, q[:, s, :].contiguous(), ln)
              for s, bank, prim in ((0, ix.bwt_fwd, ix.primary_fwd),
                                    (1, ix.bwt_rev, ix.primary_rev))]
        planes += [torch.stack([w for w, _ in wb], 1),
                   torch.stack([b for _, b in wb], 1)]
    return (ix.bwt_cat, ix.rev_word_offset, ix.primary_fwd, ix.primary_rev,
            ix.l2, ix.seq_len, seqs, lengths, *planes, has_seed, maxdiff)


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
    args = _dfs_args(idx, batch)
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


LANES = (1, 4, 32)
FORMS = ("shared", "device")


@pytest.fixture(scope="module")
def case_refs(tmp_path_factory):
    """Per (case, S): the DFS arguments, the serial dfs_read's result, the
    plain version's and the JAX function's, each computed once."""
    made, refs = {}, {}

    def get(case, S):
        if case not in made:
            glen, n, rl, err, indel, seed, opt, _ = CASES[case]
            idx, _, batch, statics = _inputs(
                tmp_path_factory.mktemp(case), glen, n, rl, err, indel, seed,
                opt, 256, 16)
            made[case] = (idx, opt, batch, statics, _dfs_args(idx, batch))
        if (case, S) not in refs:
            idx, opt, batch, statics, args = made[case]
            st = dict(statics, stack_cap=S)
            lib = host_lib(tmp_path_factory)
            refs[case, S] = (
                args, st, test_torch_host_kernels.dfs(lib, *args, **st),
                tdfs.dfs_match_gap_plain(*args, **st).numpy(),
                _jax_ref(idx, opt, batch, st)[0])
        return refs[case, S]
    return get


_HOST_LIB = {}


def host_lib(tmp_path_factory):
    if "lib" not in _HOST_LIB:
        _HOST_LIB["lib"] = test_torch_host_kernels.build(
            tmp_path_factory.mktemp("host_lanes"))
    return _HOST_LIB["lib"]


def _hold_lanes(lib, args, statics, serial, refs):
    """The warp kernel lane by lane at every lane count and state form:
    all 4H+5 columns equal to the serial dfs_read's, the first 4H+3 to
    each of `refs` (the plain and the JAX results)."""
    n = 4 * statics["hits_cap"] + 3
    for lanes in LANES:
        for form in FORMS:
            got = test_torch_host_kernels.dfs_lanes(
                lib, *args, lanes=lanes, form=form, **statics)
            where = f"{lanes} lanes, {form} form"
            np.testing.assert_array_equal(got, serial, err_msg=where)
            for ref in refs:
                np.testing.assert_array_equal(got[:, :n], ref[:, :n],
                                              err_msg=where)


@pytest.mark.parametrize("S", (2, 33, 256, 1024))
@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_lanes_match_serial_plain_and_jax(tmp_path_factory, case_refs,
                                              case, S):
    """C1's warp kernel (csrc/dfs_warp.cuh) lane by lane against the serial
    dfs_read on every column, and against the plain version and
    aln_device_step on all but the kernel's telemetry, at slot pools that
    overflow (2, 33) and that do not, 33 not a multiple of the lanes."""
    args, statics, serial, plain, ref = case_refs(case, S)
    _hold_lanes(host_lib(tmp_path_factory), args, statics, serial,
                (plain, ref))
    if S <= 33:
        assert serial[:, 4 * statics["hits_cap"] + 2].any()


EDGE_FASTA, EDGE_CASES = chip_smoke.dfs_edge_data()


@pytest.fixture(scope="module")
def edge_index(tmp_path_factory):
    return _index(tmp_path_factory.mktemp("edge"), EDGE_FASTA)


def _edge_holds(label, res, statics, batch):
    """What each edge case is for, asserted on the serial result."""
    H, S = statics["hits_cap"], statics["stack_cap"]
    n_aln, hw, ovf, _, iters = (res[:, 4 * H + j] for j in range(5))
    seqs, lengths = batch[0], batch[1]
    if label == "defaults":
        empty = (lengths == 0) | (seqs[:, 0, :] == 4).all(1)
        assert empty.sum() >= 2 and (iters[empty] == 0).all()
        # gapped hits, and a hit of two places
        assert ((res[:, 0] >> 8) & 0xFF > 0).sum() >= 11
        assert (res[:, 2 * H] - res[:, H] + 1 == 2).any()
    elif label == "pool_S2":
        assert ovf.any() and (hw <= S + 1).all()
    elif label == "hits_H1":
        assert (ovf.astype(bool) & (n_aln == H)).any()
    elif label == "iters_1":
        assert (iters <= 1).all() and ovf.any()
    elif label == "max_entries_3":
        assert ((hw > 3) & (ovf == 0)).any()
    elif label == "counter_end":
        # flagged neither by the pool, the hit list nor the cap: the
        # counter ran out
        assert ovf[0] and hw[0] + 9 <= S and n_aln[0] < H
        assert iters[0] < statics["max_iters"]
    elif label == "wide_device":
        L, SL1 = batch[0].shape[2], batch[2].shape[2] + 1
        assert (dfs_cuda.dfs_smem_bytes(S, H, L, SL1)
                > dfs_cuda.SMEM_STATE_BYTES)


@pytest.mark.parametrize("label", sorted(EDGE_CASES))
def test_warp_lanes_on_edge_reads(tmp_path, tmp_path_factory, edge_index,
                                  label):
    """The edge reads of `chip_smoke.dfs_edge_data` at the retry tier's
    slot pool and hit list with each case's changes (tier 0's pool of 256
    overflows on every gapped read): the warp kernel lane by lane, both
    state forms, against the serial dfs_read (every column),
    aln_device_step and, but for the counter's end, the plain version.
    The counter's end takes the plain version 13,358 lockstep steps over a
    [1, 52192] pool, 2-5 minutes of CPU; chip_smoke.py holds it to the
    plain version on the card."""
    fq, zero, opt_kw, st_kw = EDGE_CASES[label]
    opt = GapOpt(**opt_kw)
    n, batch, statics = _batch(tmp_path, fq, opt, zero_rows=zero,
                               **chip_smoke.DFS_EDGE_STATICS,
                               pad=1 if label == "counter_end" else 16)
    statics.update(st_kw)
    lib = host_lib(tmp_path_factory)
    args = _dfs_args(edge_index, batch, lib)
    serial = test_torch_host_kernels.dfs(lib, *args, **statics)
    refs = [_jax_ref(edge_index, opt, batch, statics)[0]]
    if label != "counter_end":
        refs.append(tdfs.dfs_match_gap_plain(*args, **statics).numpy())
    _hold_lanes(lib, args, statics, serial, refs)
    _edge_holds(label, serial, statics, batch)
