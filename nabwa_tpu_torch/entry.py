"""Entry points of the port's accelerator path: the single-device step and
the data-parallel dry run.  The port's counterpart of __graft_entry__.py.

    python -m nabwa_tpu_torch.entry [--device cuda|cpu] [--devices N]

`entry` builds the single-device step, cal_width on both strands, the DFS
and `unpack_result` on a tiny in-memory problem; `dryrun_multichip` runs
that step sharded over a mesh (`parallel/mesh.py`) with `sa_lookup` on the
best hits and the insert-size histogram summed across the mesh, then
bam2bam on two read groups with the engine on the mesh, whose BAM must
equal the single-device BAM record for record.  All data come from numpy
seeds and the port's own index build.
"""

import argparse
import pathlib
import sys
import tempfile
import time
import types

import numpy as np
import torch

from .index import sa as samod
from .index.build import build_index
from .index.fmindex import BwaIndex, DeviceIndex, FmIndex
from .io import bam as bamio
from .models import bam2bam as b2b
from .models.aln import AlnEngine
from .ops.dfs import dfs_match_gap, unpack_result
from .ops.occ import cal_width
from .ops.sa_lookup import sa_lookup
from .options import GapOpt, PeOpt
from .parallel.mesh import (isize_histogram, make_mesh, on_device,
                            per_device, shard_batch)
from .utils.rand48 import Rand48

# the DFS options of __graft_entry__.py:56-59 (the stack, hit list and
# iteration cap are the step's own)
STATICS = dict(s_mm=3, s_gapo=11, s_gape=4, max_gape=6, max_gapo=1,
               indel_end_skip=5, max_del_occ=10, max_entries=2000000,
               max_top2=30, max_seed_diff=2, seed_len=32, mode=0x03)
SA_INTV = 32
SEED_WIDTH = 33
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _tiny_problem(n_reads=64, read_len=32, glen=2048, seed=3):
    """A tiny index and read batch built in memory from a numpy seed (the
    draws of __graft_entry__.py:11-37): (codes, index with .fwd and .rev
    `FmIndex`es, int32 reads [n, 2, read_len] of (seq, rseq) codes,
    int32 lengths)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=glen).astype(np.uint8)

    def build(c):
        bwt, primary, l2, samp = samod.bwt_and_sample_from_codes(c, SA_INTV)
        inter = samod.interleave_occ(samod.pack_bwt_words(bwt), bwt, len(c))
        return FmIndex(primary=primary, l2=l2, bwt=inter, sa=samp,
                       sa_intv=SA_INTV, seq_len=len(c))

    index = types.SimpleNamespace(fwd=build(codes),
                                  rev=build(codes[::-1].copy()))
    reads = np.zeros((n_reads, 2, read_len), dtype=np.int32)
    lengths = np.full(n_reads, read_len, dtype=np.int32)
    for i in range(n_reads):
        start = int(rng.integers(0, glen - read_len))
        r = codes[start:start + read_len].astype(np.int32)[::-1]
        reads[i, 0] = r                          # seq (reversed)
        reads[i, 1] = np.where(r < 4, 3 - r, r)  # rseq
    return codes, index, reads, lengths


def _step(ix, seqs, lengths, maxdiff, stack_cap, hits_cap, max_iters):
    """cal_width on both strands, the DFS and `unpack_result` for one batch
    on the device of `seqs` (__graft_entry__.py:61-80)."""
    w0, b0 = cal_width(ix.bwt_fwd, ix.l2, ix.primary_fwd, ix.seq_len,
                       seqs[:, 0, :].contiguous(), lengths)
    w1, b1 = cal_width(ix.bwt_rev, ix.l2, ix.primary_rev, ix.seq_len,
                       seqs[:, 1, :].contiguous(), lengths)
    B = seqs.shape[0]
    zeros = torch.zeros((B, 2, SEED_WIDTH), dtype=torch.int32,
                        device=seqs.device)
    packed = dfs_match_gap(
        ix.bwt_cat, ix.rev_word_offset, ix.primary_fwd, ix.primary_rev,
        ix.l2, ix.seq_len, seqs, lengths, torch.stack([w0, w1], dim=1),
        torch.stack([b0, b1], dim=1), zeros, zeros,
        torch.zeros(B, dtype=torch.int32, device=seqs.device), maxdiff,
        stack_cap=stack_cap, hits_cap=hits_cap, max_iters=max_iters,
        **STATICS)
    return unpack_result(packed, hits_cap)


def entry(device="cuda"):
    """The single-device step on the flagship path (__graft_entry__.py
    :40-87): returns (fn, example_args); fn(seqs, lengths, maxdiff) runs
    batched cal_width + the DFS on the args' device and returns (n_aln,
    hit_k, hit_score)."""
    device = torch.device(device)
    _, index, reads, lengths = _tiny_problem()
    ix = DeviceIndex.from_host(index, device)

    def fn(seqs, lengths, maxdiff):
        out = _step(ix, seqs, lengths, maxdiff, stack_cap=512, hits_cap=16,
                    max_iters=20000)
        return out["n_aln"], out["hit_k"], out["hit_score"]

    example_args = tuple(torch.from_numpy(a).to(device) for a in (
        reads, lengths, np.full(len(lengths), 2, dtype=np.int32)))
    return fn, example_args


def _sharded_step(mesh, index, reads, lengths):
    """The dry run's data-parallel step (__graft_entry__.py:144-172): the
    reads sharded over the mesh, the index replicated, each shard's step
    and SA walk on its own device; the insert-size histogram of the first
    half's reads against the second half's, summed across the mesh.
    Returns (n_aln, pos, hist) on mesh[0]."""
    ixs = per_device(mesh, lambda d: DeviceIndex.from_host(index, d))
    maxdiff = np.full(len(lengths), 2, dtype=np.int32)
    n_aln, pos = [], []
    for d, (seqs, lens, md) in zip(mesh, shard_batch(
            mesh, (reads, lengths, maxdiff))):
        if not len(lens):
            continue
        ix = ixs[d]
        with on_device(d):
            out = _step(ix, seqs, lens, md, stack_cap=256, hits_cap=8,
                        max_iters=8000)
            # phase A output: best-hit rows -> positions (the SA walk);
            # a read without a hit walks row 0
            best_k = torch.where(out["n_aln"] > 0, out["hit_k"][:, 0],
                                 torch.zeros_like(out["n_aln"]))
            p = sa_lookup(ix.bwt_fwd, ix.l2, ix.primary_fwd, ix.seq_len,
                          ix.sa_fwd, ix.sa_intv, best_k.contiguous())
        n_aln.append(out["n_aln"].to(mesh[0]))
        pos.append(p.to(mesh[0]))
    n_aln, pos = torch.cat(n_aln), torch.cat(pos)
    # the phase barrier: the per-RG isize histogram, one bincount a shard
    # summed onto mesh[0]
    half = len(lengths) // 2
    lens0 = torch.from_numpy(lengths)
    mapq = torch.full((half,), 37, dtype=torch.int32)
    upos = pos.long() & 0xFFFFFFFF
    hist = isize_histogram(upos[:half], upos[half:2 * half], lens0[:half],
                           lens0[half:2 * half], mapq, mapq, n_bins=1024,
                           mesh=mesh)
    return n_aln, pos, hist


def _genome(n, seed):
    """(FASTA bytes, sequence bytes) of one random contig of n bases."""
    seq = BASES[np.random.default_rng(seed).integers(0, 4, size=n)]
    lines = [b">seq0 dry run\n"] + [seq[i:i + 70].tobytes() + b"\n"
                                    for i in range(0, n, 70)]
    return b"".join(lines), seq.tobytes()


def _pairs(genome, n_pairs, read_len, isize_mean, isize_std, seed,
           err_rate):
    """n_pairs FR pairs drawn from `genome` at the insert size
    N(isize_mean, isize_std), substitutions at err_rate: [(name, seq1,
    qual1, seq2, qual2)] (the draws of tests/test_sampe.py::make_pairs,
    without broken mates)."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome, dtype=np.uint8)
    out = []
    for i in range(n_pairs):
        isize = max(int(rng.normal(isize_mean, isize_std)), read_len + 10)
        start = int(rng.integers(0, len(g) - isize - 1))
        frag = g[start:start + isize]
        r1 = bytearray(frag[:read_len].tobytes())
        r2 = bytearray(frag[-read_len:].tobytes().translate(COMP)[::-1])
        for r in (r1, r2):
            for j in range(read_len):
                if rng.random() < err_rate:
                    r[j] = BASES[int(rng.integers(0, 4))]
        q1, q2 = ("".join(chr(33 + int(q)) for q in
                          rng.integers(25, 40, read_len)) for _ in (1, 2))
        out.append((f"pair{i}", r1.decode(), q1, r2.decode(), q2))
    return out


def _records(path):
    rd = bamio.BamReader(path)
    out = []
    while True:
        r = rd.read1()
        if r is None:
            break
        out.append((r.tid, r.pos, r.bin, r.qual, r.flag, r.l_qname,
                    r.n_cigar, r.l_qseq, r.mtid, r.mpos, r.isize,
                    bytes(r.data)))
    return rd.text, out


def _bam2bam_on_mesh(mesh, n_pairs, glen, chunk_size, n_workers, work):
    """bam2bam on two read groups (pairs alternating rg1 / rg2) with the
    engine on the mesh, against the single-device run on mesh[0]
    (__graft_entry__.py:183-259).  Returns (records, read groups)."""
    fa, seq = _genome(glen, 501)
    (work / "g.fa").write_bytes(fa)
    recs = []
    for k, (name, s1, q1, s2, q2) in enumerate(
            _pairs(seq, n_pairs, 40, 200, 25, 502, err_rate=0.01)):
        tags = b"RGZrg1\x00" if k % 2 == 0 else b"RGZrg2\x00"
        for s, q, fl in ((s1, q1, bamio.BAM_FREAD1),
                         (s2, q2, bamio.BAM_FREAD2)):
            r = bamio.sam_to_bamrec(
                name, bamio.BAM_FPAIRED | fl | bamio.BAM_FUNMAP | 8, -1, -1,
                0, [], -1, -1, 0, s, q, tags)
            r.bin = 0
            recs.append(r)
    bamio.make_bam(str(work / "in.bam"), [], recs,
                   text="@HD\tVN:1.4\n@RG\tID:rg1\tSM:a\n@RG\tID:rg2\tSM:b\n")
    build_index(str(work / "g.fa"))
    idx = BwaIndex.load(str(work / "g.fa"))

    def run(name, engine, **kw):
        out = str(work / name)
        b2b.bam2bam(engine, str(work / "in.bam"), out, GapOpt(), PeOpt(),
                    Rand48(idx.bns.seed), argv=["bam2bam"], version="ref",
                    **kw)
        return _records(out)

    base = run("single.bam", AlnEngine(idx, GapOpt(), mesh[0]), n_workers=1)
    dist = run("mesh.bam", AlnEngine(idx, GapOpt(), mesh=mesh),
               n_workers=n_workers, chunk_size=chunk_size)
    if base != dist:
        raise AssertionError("mesh bam2bam diverged from single-device")
    rgs = set()
    for t in base[1]:
        d = t[-1]
        i = d.find(b"RGZ")
        if i >= 0:
            rgs.add(bytes(d[i + 3:d.index(b"\x00", i)]))
    if len(rgs) != 2:
        raise AssertionError(f"expected 2 read groups in the output, saw "
                             f"{len(rgs)}")
    return len(base[1]), len(rgs)


def dryrun_multichip(n_devices, device="cuda", n_pairs=2048, glen=120_000,
                     chunk_size=128, n_workers=4):
    """The full data-parallel alignment step over an n-device mesh
    (`make_mesh(n_devices, device)`), then the real pipeline over it
    (__graft_entry__.py:90-260): bam2bam (the chunk-lease scheduler,
    per-RG isize, pairing, rescue, refine, the BAM splice) with every
    tier's batch sharded; its output must match the single-device run
    record for record.  The sharded step must equal the same step on
    mesh[0] alone.  Returns a summary dict; raises on a mismatch."""
    t0 = time.perf_counter()
    mesh = make_mesh(n_devices, device)
    _, index, reads, lengths = _tiny_problem(n_reads=8 * len(mesh),
                                             read_len=24, glen=1024)
    n_aln, pos, hist = _sharded_step(mesh, index, reads, lengths)
    one = _sharded_step(mesh[:1], index, reads, lengths)
    if not (torch.equal(n_aln, one[0]) and torch.equal(pos, one[1])
            and torch.equal(hist, one[2])):
        raise AssertionError("the sharded step differs from one device's")
    if int(n_aln.sum()) <= 0:
        raise AssertionError("the sharded step found no alignment")
    names = [str(d) for d in mesh]
    print(f"[dryrun_multichip] {len(mesh)} devices {names} OK: "
          f"{int(n_aln.sum())} alignments, hist_total={int(hist.sum())}",
          file=sys.stderr)
    with tempfile.TemporaryDirectory(prefix="dryrun_b2b_") as tmp:
        n_records, n_rg = _bam2bam_on_mesh(
            mesh, n_pairs, glen, chunk_size, n_workers, pathlib.Path(tmp))
    print(f"[dryrun_multichip] mesh bam2bam == single-device ({n_records} "
          f"records, {n_pairs} pairs, {n_rg} read groups, chunk "
          f"{chunk_size}, {n_workers} workers over {len(mesh)} devices)",
          file=sys.stderr)
    return {"devices": names, "alignments": int(n_aln.sum()),
            "hist_total": int(hist.sum()), "records": n_records,
            "read_groups": n_rg, "pairs": n_pairs,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nabwa_tpu_torch.entry")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh entries (default: every visible card, or 1)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("entry: no CUDA device", file=sys.stderr)
        return 2
    fn, example = entry(args.device)
    n_aln = fn(*example)[0]
    print(f"[entry] single-device step OK: {int(n_aln.sum())} alignments",
          file=sys.stderr)
    n = args.devices
    if n is None and torch.device(args.device).type == "cuda":
        n = torch.cuda.device_count()
    dryrun_multichip(n or 1, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
