#!/usr/bin/env python3
"""On-card smoke run of nabwa_tpu_torch, the `aln`, `samse`, `sampe` and
`bwasw` paths on one NVIDIA GPU.

    python3 chip_smoke.py [--glen BP] [--reads N] [--pairs N] [--batch B]
                          [--retry-stack S] [--long-reads N] [--profile]

Run from the root of a checkout.  It imports the port (`nabwa_tpu_torch`),
`tests/genomes.py` and the standard library, never the JAX package.
Phases, any failure exits non-zero:

1. the card's name and power limit (nvidia-smi) and the nvcc build of the
   kernels from csrc/ (seconds, ptxas register report);
2. kernel C2 (csrc/cal_width.cu) against the plain PyTorch cal_width on
   CUDA tensors: the first 2048 reads of the main path, both strands, the
   reads and their seed suffixes, exact;
3. kernel C1 (csrc/dfs.cu) against the plain PyTorch DFS on CUDA tensors,
   with the engine's own batch inputs and statics: the same 2048 reads at
   the tier-0 settings, then the reads tier 0 flagged at the retry
   settings; exact on every column but the kernel's own telemetry (fin,
   iters);
4. the aln path at the bench's size: a 64 Mbp random genome (seed 99)
   indexed by the port's host build, 32768 x 100 bp reads at 1 % error
   (seed 100).  After a warm-up batch the engine's rate is timed, with
   host seconds per part of `run_chunk`; then, with every launch count at
   0, `python -m nabwa_tpu_torch aln --device cuda` runs in-process.  Both
   `.sai` outputs must be byte-identical to the shared host engine's
   (native/dfsgap.cpp).  Every kernel must have launched, and at most 20 %
   of the reads may fall through to the host.  The host-drained reads are
   solved by that same host engine, so for them the comparison holds the
   host engine against itself;
5. kernel C3 (csrc/sa_lookup.cu) against the plain PyTorch sa_lookup and
   the native host walk on every SA row samse asks for on phase 4's
   `.sai`, both strands, exact;
6. a gapped read set on the same genome (32768 x 100 bp, 1 % error, a
   1-base indel in half the reads, seed 101) aligned by the host engine;
   kernel C4 (csrc/banded_global.cu) against the plain PyTorch DP on the
   first device batch of its samse refine jobs: score, end type and the
   whole traceback lattice, exact;
7. samse on both read sets, on the card (C3, C4) and on the host reference
   route (native SA walk and DP): byte-identical SAM, reads/s and host
   seconds per part of each;
8. the CLI chain on the gapped reads, every launch count at 0 before each
   command: `aln --device cuda` (its `.sai` equal to the host engine's,
   C1 and C2 launched), then `samse --device cuda` (its SAM equal to the
   host reference route's, C3 and C4 launched);
9. a paired read set on the same genome: 32768 pairs x 100 bp, insert
   size 300 +- 30, 1 % substitutions and 10 % broken mates (half with
   every second base of read 2 replaced, half with read 2 moved far; the
   pair model of tests/test_sampe.py, seed 102), of which the last 1/64
   are mates only the rescue places (read 2 with three seed substitutions
   against its true place and an exact copy on a decoy contig of the
   genome, as tests/test_torch_sampe.py builds them); both ends aligned
   by the host engine;
10. sampe on that set, on the host reference route (native SA walk,
   local SW and DP) and on the card (C3, C4, C5), recording the arguments
   of every C5 and C4 launch of the card run: pairs/s and host seconds
   per part of each;
11. kernel C5 (csrc/local_fwd.cu) against the plain PyTorch local-SW
   forward pass, and C4 against its plain DP, on every launch recorded in
   phase 10: the rescue's forward rounds, its path recovery (per-pair
   bands doubled on retry, gap_end -1) and any refine batch; every output
   exact.  Then the two routes' SAM must be byte-identical, and the
   rescue must have placed (XT:A:M) at least half as many mates as were
   built for it;
12. the CLI chain on the pairs, every launch count at 0 before each
   command: `aln --device cuda` on each end (each `.sai` equal to the host
   engine's, C1 and C2 launched), then `sampe --device cuda` (its SAM
   equal to the host reference route's, C3, C4 and C5 launched);
13. a long-read set on the same genome: 512 x 1000 bp reads of the model
   of tests/test_bwasw.py (3 % substitutions, an indel in half the reads,
   chimeric tails, a run of N in a tenth, either strand; seed 103);
14. bwasw on that set, on the host reference route (the native
   whole-batch driver, one thread per core) and on the card (C3, C4, C6),
   recording the arguments of every C6, C4 and C3 launch of the card run:
   reads/s and host seconds per part of each.  Then every recorded launch
   against its plain version: C6's score, end cell and window cells, C4's
   score, end type and whole lattice at 1 kb lengths, C3's positions, all
   exact; and the two routes' SAM byte-identical;
15. the bwasw CLI with every launch count at 0: `bwasw --device cuda` (its
   SAM equal to the host reference route's, C3, C4 and C6 launched).
Phase 12's chain and phase 15 are the main paths: their launch counts,
summed, are the `launches` of the kernels line.
With --profile, torch.profiler runs over one more aln run after phase 4's
timed run and over one more bwasw card run after phase 14: the card's
busy share and the device time of each kernel.

Every kernel's `bound_ms` is the least time the card could take for the
same work on this run's inputs: the larger of the bytes it must move over
HBM_BYTES_PER_S and its integer operations over INT_OPS_PER_S (see
`bound`).  No single PyTorch call computes any of the six functions, so
`library_ms` is null for each.  C4's and C5's `ms` and `plain_ms` are
those of the largest launch of sampe's card run; C4's on samse's refine
batch of phase 6 stand beside them as `samse_refine_*`, and C4's and
C3's on bwasw's largest launch as `bwasw_*`.  C6's are those of the
largest launch of bwasw's card run, its bound counted from the window
cells that launch computed; C4's bound counts the cells inside each
pair's band and the whole lattice's bytes.  `total_ms` (C6) and
`bwasw_total_ms` (C4, C3) sum the device time of every launch of the
bwasw card run, each timed once as it is replayed.

Data and the index are cached under the temp directory.  The last two
lines of standard output are the card line and
{"ok": true, "device": {...}}; the line before them holds the kernels'
launch counts, errors, times and bounds.  Nothing is printed on standard
output before the run has passed, and nothing at all without a CUDA device
or outside a checkout.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
MAX_HOST_SHARE = 0.20
CHECK_B = 2048
# one pair in RESCUE_SHARE of phase 9's set is a mate only the rescue places
RESCUE_SHARE = 64
# NVIDIA H100 SXM datasheet figures: HBM bandwidth,
# and the float32 rate outside the tensor cores, the sheet's only 32-bit
# non-tensor rate, taken for int32 operations too.  Hopper has half as many
# int32 lanes as float32 lanes, so the operations bound is optimistic.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
# integer operations per unit of work: each kernel's inner loop, loads and
# stores not counted, as the comment at the top of its .cu file counts it
OPS_LOCAL_CELL = 23       # csrc/local_sw.cuh, one cell of the sweep
OPS_GLOBAL_CELL = 40      # csrc/dp_global.cuh, one cell of the band
OPS_EXTEND_CELL = 26      # csrc/extend.cuh, one cell of a row's window
OPS_OCC_BLOCK = 40        # one Occ block's count (masks and popcounts)
OCC_BLOCK_BYTES = 48      # bwt.h:61-68, 4 counters + 8 words


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of the bytes' time at the HBM rate
    and the operations' time at the integer rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def as_tuple(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def io_bytes(args, out):
    """Bytes of a launch's tensor inputs and of its outputs."""
    import torch
    return nbytes(*(a for a in args if isinstance(a, torch.Tensor)),
                  *as_tuple(out))


def band_cells(args):
    """Cells inside C4's band, summed over a launch's pairs: the cells the
    DP needs (the kernel sweeps the whole padded row, but a cell outside
    the band only carries traceback bits of NEG comparisons, counted in
    the lattice's bytes).  args: (s1, len1, s2, len2, b1, b2, ...); row j
    of a pair spans [start, min(j + b1 - 1, len1)] as in
    banded_global_plain."""
    import torch
    len1, len2, b1, b2 = (t.long()[:, None]
                          for t in (args[1], args[3], args[4], args[5]))
    j = torch.arange(1, args[2].shape[1], device=args[2].device)[None, :]
    tmp_end = torch.where(b2 < len2, b2, len2 - 1)
    whole = (j <= tmp_end) | ((j == len2) & (b2 == len2))
    start = torch.where(whole, 0, j - b2 + 1)
    n = (torch.minimum(j + b1 - 1, len1) - start + 1).clamp(min=0)
    return int(torch.where(j <= len2, n, 0).sum())


def log(msg):
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line():
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps launches (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_pairs(genome, n_pairs, n_rescue, read_len, isize_mean, isize_std,
               seed, err_rate, frac_broken):
    """FASTQ text of both ends and a decoy contig's FASTA text, drawn in
    bulk with numpy.  The first n_pairs - n_rescue pairs follow the pair
    model of tests/test_sampe.py:18-49 (FR pairs, substitutions in both
    reads, a fraction of broken mates: half with every second base of read
    2 replaced, half with read 2 moved far).  The last n_rescue pairs are
    mates that only the rescue places, built as tests/test_torch_sampe.py
    builds them: read 2 carries three substitutions in its 32-base seed
    against its true place (more than aln's -k 2 allows) and an exact copy
    on the decoy contig, so aln maps it there and the rescue finds it
    beside read 1 (XT:A:M)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.arange(256, dtype=np.uint8)
    comp[bases] = np.frombuffer(b"TGCA", np.uint8)
    code = np.zeros(256, dtype=np.int64)
    code[bases] = np.arange(4)
    n, col = n_pairs, np.arange(read_len)
    isize = np.maximum(rng.normal(isize_mean, isize_std, n).astype(np.int64),
                       read_len + 10)
    start = (rng.random(n) * (len(g) - isize - 1)).astype(np.int64)
    r1 = g[start[:, None] + col]
    r2 = comp[g[(start + isize - read_len)[:, None] + col]][:, ::-1].copy()
    for r in (r1, r2):
        err = rng.random(r.shape) < err_rate
        r[err] = bases[rng.integers(0, 4, int(err.sum()))]
    broken = (rng.random(n) < frac_broken) & (np.arange(n) < n - n_rescue)
    scrambled = broken & (rng.random(n) < 0.5)
    far = broken & ~scrambled
    odd = np.ix_(np.nonzero(scrambled)[0], col[0::2])
    r2[odd] = bases[rng.integers(0, 4, r2[odd].shape)]
    at = rng.integers(0, len(g) - read_len, int(far.sum()))
    r2[far] = g[at[:, None] + col]
    resc = np.arange(n - n_rescue, n)[:, None]
    seed_col = np.argsort(rng.random((n_rescue, 32)), axis=1)[:, :3]
    r2[resc, seed_col] = bases[(code[r2[resc, seed_col]]
                                + rng.integers(1, 4, seed_col.shape)) % 4]
    spacer = bases[rng.integers(0, 4, (n_rescue + 1, 150))]
    decoy = np.concatenate([np.concatenate([spacer[:-1], r2[resc[:, 0]]],
                                           1).reshape(-1), spacer[-1]])
    decoy_fa = b">decoy\n" + b"".join(decoy[i:i + 70].tobytes() + b"\n"
                                      for i in range(0, len(decoy), 70))
    quals = (33 + rng.integers(25, 40, (2, n, read_len))).astype(np.uint8)
    out = []
    for end, r in ((1, r1), (2, r2)):
        rows, q = r.tobytes(), quals[end - 1].tobytes()
        out.append(b"".join(
            b"@pair%d/%d\n%s\n+\n%s\n" % (i, end,
                                           rows[i * read_len:(i + 1)
                                                * read_len],
                                           q[i * read_len:(i + 1) * read_len])
            for i in range(n)))
    return out, decoy_fa


def make_long_reads(genome_seq, n_reads, read_len, seed, err=0.02,
                    indel=0.3, chimera=0.1, with_n=0.1):
    """FASTQ text of long reads, the model of tests/test_bwasw.py:13-45
    (copied): substitutions, one indel of 1-7 bases, a chimeric 150-base
    tail, a run of three N, either strand."""
    import numpy as np
    from tests import genomes
    comp = dict(zip(b"ACGT", b"TGCA"))
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome_seq, dtype=np.uint8)
    out = []
    for i in range(n_reads):
        start = int(rng.integers(0, len(g) - read_len))
        r = bytearray(g[start:start + read_len].tobytes())
        for j in range(len(r)):
            p = rng.random()
            if p < err:
                r[j] = genomes.BASES[int(rng.integers(0, 4))]
        if rng.random() < indel:
            pos = int(rng.integers(20, len(r) - 20))
            ln = int(rng.integers(1, 8))
            if rng.random() < 0.5:
                del r[pos:pos + ln]
            else:
                ins = bytes(genomes.BASES[int(rng.integers(0, 4))]
                            for _ in range(ln))
                r[pos:pos] = ins
        if rng.random() < chimera:
            far = int(rng.integers(0, len(g) - 200))
            r[-150:] = g[far:far + 150].tobytes()
        if rng.random() < with_n:
            pos = int(rng.integers(0, len(r) - 5))
            r[pos:pos + 3] = b"NNN"
        if rng.random() < 0.5:
            r = bytearray(comp.get(b, b) for b in reversed(r))
        qual = bytes([33 + int(q) for q in rng.integers(15, 40, len(r))])
        out.append(b"@lr%d\n%s\n+\n%s\n" % (i, bytes(r), qual))
    return b"".join(out)


def make_data(glen, n_reads, n_pairs, n_long):
    """Genome, index, the bench reads, the gapped reads, the read pairs and
    the long reads (cached by size and seed): a random contig of glen bp
    (seed 99) and the decoy contig of the pairs; 100 bp reads from the
    random contig at 1 % substitutions, seed 100, the same with a 1-base
    indel in half the reads, seed 101, pairs of 100 bp reads, insert size
    300 +- 30, 1 % substitutions, 10 % broken mates and 1/64 of the pairs
    rescued from the decoy, seed 102, and n_long reads of 1000 bp of the
    long-read model at 3 % substitutions and an indel in half, seed 103."""
    from nabwa_tpu_torch.index.build import build_index
    from tests import genomes
    work = pathlib.Path(tempfile.gettempdir()) / \
        f"nabwa_torch_smoke_{glen}_{n_pairs}"
    work.mkdir(parents=True, exist_ok=True)
    fa = work / "g.fa"
    fqs = {work / f"r{n_reads}.fq": dict(seed=100),
           work / f"r{n_reads}_gapped.fq": dict(seed=101, indel_rate=0.5)}
    pe = [work / f"p{n_pairs}_{end}.fq" for end in (1, 2)]
    lr = work / f"lr{n_long}.fq"
    if not (work / "g.fa.rsa").exists() or \
            not all(p.exists() for p in [*fqs, *pe, lr]):
        t0 = time.perf_counter()
        text, seqs = genomes.random_genome(glen, seed=99)
        pairs, decoy = make_pairs(seqs[0], n_pairs, n_pairs // RESCUE_SHARE,
                                  100, 300, 30, 102, 0.01, 0.10)
        for path, fq in zip(pe, pairs):
            path.write_bytes(fq)
        if not (work / "g.fa.rsa").exists():
            fa.write_bytes(text + decoy)
            # SA-IS at every size: the same index as the blockwise
            # incremental construction, built faster when memory is
            # plentiful
            os.environ.setdefault("NABWA_BWT_INC", "0")
            build_index(str(fa))
        for fq, kw in fqs.items():
            fq.write_bytes(genomes.sample_reads(seqs[0], n_reads, 100,
                                                err_rate=0.01, **kw))
        lr.write_bytes(make_long_reads(seqs[0], n_long, 1000, 103, err=0.03,
                                       indel=0.5))
        log(f"genome + index + reads + pairs + long reads: "
            f"{time.perf_counter() - t0:.1f} s")
    return (fa, *fqs, *pe, lr)


def check_cal_width(eng, inputs):
    """C2 against the plain version; returns (max |err|, kernel ms, plain
    ms, bound) with the timed call's bound: its inputs and outputs and two
    Occ blocks a read position (the counts at k-1 and l)."""
    import torch
    from nabwa_tpu_torch.ops import occ
    ix = eng.dev
    worst, n_cmp = 0, 0
    for q, ln in ((inputs["seqs"], inputs["lengths"]),
                  (inputs["seed_seqs"], inputs["seed_lengths"])):
        for s, bank, prim in ((0, ix.bwt_fwd, ix.primary_fwd),
                              (1, ix.bwt_rev, ix.primary_rev)):
            args = (bank, ix.l2, prim, ix.seq_len, q[:, s, :].contiguous(),
                    ln)
            kw, kb = occ.cal_width_cuda(*args)
            pw, pb = occ.cal_width_plain(*args)
            torch.cuda.synchronize()
            for a, b in ((kw, pw), (kb, pb)):
                worst = max(worst, int((a.long() - b.long()).abs().max()))
                n_cmp += a.numel()
    q = inputs["seqs"][:, 0, :].contiguous()
    ln = inputs["lengths"]
    args = (ix.bwt_fwd, ix.l2, ix.primary_fwd, ix.seq_len, q, ln)
    ms = cuda_ms(lambda: occ.cal_width_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: occ.cal_width_plain(*args), 2)
    width, bid = occ.cal_width_cuda(*args)
    steps = int(ln.long().sum())
    bnd = bound(nbytes(q, ln, width, bid) + 2 * OCC_BLOCK_BYTES * steps,
                2 * OPS_OCC_BLOCK * steps)
    log(f"C2 cal_width: {q.shape[0]} reads x 2 strands, reads and seed "
        f"suffixes, max |err| {worst} over {n_cmp} values; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.2f} ms per call at "
        f"{tuple(q.shape)}; bound {bnd[0]:.5f} ms ({bnd[1]})")
    if worst != 0:
        fail("cal_width kernel disagrees with the plain version")
    return worst, ms, plain_ms, bnd


def check_dfs(eng, inputs, statics, tier):
    """C1 against the plain DFS on one batch of the engine's own inputs.
    The width planes come from the plain cal_width, so C1 is checked on
    its own.  Returns (max |err|, kernel ms, plain ms, flagged rows,
    bound); the bound counts the inputs and output and, for every pop the
    reads took, one 2occ4 (two Occ blocks)."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import dfs, dfs_cuda, occ
    ix = eng.dev
    seqs, lens = inputs["seqs"], inputs["lengths"]
    B, _, L = seqs.shape
    planes = []
    for q, ln in ((seqs, lens),
                  (inputs["seed_seqs"], inputs["seed_lengths"])):
        wb = [occ.cal_width_plain(bank, ix.l2, prim, ix.seq_len,
                                  q[:, s, :].contiguous(), ln)
              for s, bank, prim in ((0, ix.bwt_fwd, ix.primary_fwd),
                                    (1, ix.bwt_rev, ix.primary_rev))]
        planes += [torch.stack([w for w, _ in wb], 1).contiguous(),
                   torch.stack([b for _, b in wb], 1).contiguous()]
    args = (ix.bwt_cat, ix.rev_word_offset, ix.primary_fwd, ix.primary_rev,
            ix.l2, ix.seq_len, seqs, lens, *planes, inputs["has_seed"],
            inputs["max_diff"])
    kern = dfs_cuda.dfs_match_gap_cuda(*args, **statics)
    t0 = time.perf_counter()
    plain = dfs.dfs_match_gap_plain(*args, **statics)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    H, S = statics["hits_cap"], statics["stack_cap"]
    cap = statics["max_iters"]
    diff = (kern[:, :4 * H + 3].long() - plain[:, :4 * H + 3].long()).abs()
    worst = int(diff.max())
    ms = cuda_ms(lambda: dfs_cuda.dfs_match_gap_cuda(*args, **statics), 3)
    k = kern.cpu().numpy()
    flagged = np.nonzero(k[:, 4 * H + 2])[0]
    iters = k[:, 4 * H + 4]
    pops = int(iters.astype(np.int64).sum())
    bnd = bound(nbytes(seqs, lens, *planes, inputs["has_seed"],
                       inputs["max_diff"], kern)
                + 2 * OCC_BLOCK_BYTES * pops, 2 * OPS_OCC_BLOCK * pops)
    hits_full = int((k[flagged, 4 * H] >= H).sum())
    at_cap = int((iters[flagged] >= cap).sum())
    log(f"C1 dfs, {tier}: {B} reads (L={L}, S={S}, H={H}, max_iters={cap}), "
        f"max |err| {worst} over hits/n_aln/hw/overflow; {len(flagged)} "
        f"flagged ({hits_full} hit list full, {at_cap} iteration cap, "
        f"{len(flagged) - hits_full - at_cap} slot pool or seq counter); "
        f"most iterations of a read {int(iters.max())}, {pops} in all; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; bound "
        f"{bnd[0]:.5f} ms ({bnd[1]})")
    if worst != 0:
        bad = np.nonzero(diff.any(1).cpu().numpy())[0][:5]
        fail(f"dfs kernel disagrees with the plain version, {tier} "
             f"(rows {bad})")
    return worst, ms, plain_ms, flagged, bnd


def native_reference(idx, reads, opt):
    """The .sai of the shared host engine (native/dfsgap.cpp)."""
    from nabwa_tpu_torch.index import native
    from nabwa_tpu_torch.models.aln import batch_options
    maxdiff, local = batch_options(opt, reads.clip_lens().astype("int32"))
    t0 = time.perf_counter()
    res = native.dfs_match_gap_native(
        idx.fwd.bwt, idx.fwd.primary, idx.rev.bwt, idx.rev.primary,
        idx.fwd.l2, idx.fwd.seq_len, reads, maxdiff, local)
    dt = time.perf_counter() - t0
    return opt.pack() + native_block(res), dt


def native_block(results):
    """The `.sai` records of a chunk's [(alns, hw), ...] results."""
    from nabwa_tpu_torch.io.sai import pack_aln_block
    return pack_aln_block([alns for alns, _ in results])


def sai_columns(sai_bytes):
    """The per-read alignments of a `.sai` as the CLI reads them
    (columnar)."""
    from nabwa_tpu_torch.io.sai import read_sai_columnar
    path = pathlib.Path(tempfile.gettempdir()) / "nabwa_torch_smoke_cols.sai"
    path.write_bytes(sai_bytes)
    return read_sai_columnar(str(path))[1]


def walk_steps(bank, l2, primary, seq_len, sa_intv, rows):
    """invPsi steps each row takes to a sampled row (the loop of the plain
    sa_lookup, counting only)."""
    import torch
    from nabwa_tpu_torch.ops import occ
    from nabwa_tpu_torch.ops import sa_lookup as sl
    l2v = torch.tensor([int(v) & occ.M32 for v in l2], dtype=torch.int64,
                       device=rows.device)
    k = occ.u32(rows)
    steps = torch.zeros_like(k)
    while True:
        live = (k % sa_intv) != 0
        if not bool(live.any()):
            return steps
        nk = sl.inv_psi(bank, l2v, int(primary) & occ.M32,
                        int(seq_len) & occ.M32, k)
        k = torch.where(live, nk, k)
        steps += live.long()


def sa_walk_bound(args):
    """C3's bound on a launch's args (bwt, l2, primary, seq_len, sa,
    sa_intv, rows): its rows and positions, and one Occ block read and
    counted for every invPsi step its rows take."""
    steps = int(walk_steps(*args[:4], args[5], args[6]).sum())
    return bound(12 * args[6].shape[0] + OCC_BLOCK_BYTES * steps,
                 OPS_OCC_BLOCK * steps)


def check_sa_lookup(eng, idx, reads, sai_bytes):
    """C3 against the plain version and the native host walk on every SA
    row samse asks for on this `.sai`, both strands.  The timed call's
    bound counts its rows and positions, the sample it reads and one Occ
    block for every invPsi step its rows take."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.ops import sa_lookup as sl
    from nabwa_tpu_torch.utils.rand48 import Rand48
    ch = msamse.select(reads, sai_columns(sai_bytes), 3,
                       Rand48(idx.bns.seed))
    ix = eng.dev
    worst, n_rows, timed = 0, 0, None
    for a, _, _, rows in msamse.sa_requests(ch):
        args = (ix.bwt_fwd if a else ix.bwt_rev, ix.l2,
                ix.primary_fwd if a else ix.primary_rev, ix.seq_len,
                ix.sa_fwd if a else ix.sa_rev, ix.sa_intv,
                torch.from_numpy(rows.view(np.int32)).to(eng.device))
        kern = sl.sa_lookup_cuda(*args)
        t0 = time.perf_counter()
        plain = sl.sa_lookup_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        nat = msamse.sa_rows_native(idx, a, rows).astype(np.int64)
        got = kern.cpu().numpy().view(np.uint32).astype(np.int64)
        worst = max(worst, int(np.abs(
            got - plain.cpu().numpy().view(np.uint32)).max()),
            int(np.abs(got - nat).max()))
        n_rows += len(rows)
        if timed is None or len(rows) > timed[0]:
            timed = (len(rows), cuda_ms(lambda: sl.sa_lookup_cuda(*args),
                                        20), plain_ms, sa_walk_bound(args))
    log(f"C3 sa_lookup: {n_rows} SA rows of samse on the bench .sai, both "
        f"strands, max |err| {worst} against the plain version and the "
        f"native walk; kernel {timed[1]:.4f} ms, plain {timed[2]:.2f} ms "
        f"per call at {timed[0]} rows; bound {timed[3][0]:.5f} ms "
        f"({timed[3][1]})")
    if worst != 0:
        fail("sa_lookup kernel disagrees with the plain version or the "
             "native walk")
    return worst, timed[1], timed[2], n_rows, timed[3]


def check_banded_global(eng, idx, reads, sai_bytes, opt):
    """C4 against the plain version on the first device batch of the
    refine jobs samse makes on this `.sai`: score, ctype and the whole
    traceback lattice.  The bound counts the inputs, the lattice and every
    cell of the padded rows the kernel computes."""
    import torch
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.ops import dp
    from nabwa_tpu_torch.refmodel.stdaln_scalar import ALN_PARAM_BWA
    from nabwa_tpu_torch.utils.rand48 import Rand48
    ch = msamse.select(reads, sai_columns(sai_bytes), 3,
                       Rand48(idx.bns.seed))
    msamse.sa_coords(eng, ch, host_reference=True)
    msamse.approx_mapq(ch, opt)
    jobs = msamse.gapped_jobs(ch)
    pairs = msamse.refine_pairs(jobs, idx.pac, idx.bns.l_pac)
    pairs = [p for p in pairs if len(p[0]) and len(p[1])][:dp.MAX_PAIRS]
    if not pairs:
        fail("the gapped read set gave no refine jobs")
    ap = ALN_PARAM_BWA
    args = dp.pack_pairs(pairs, [ap.band_width] * len(pairs), eng.device)
    kw = dict(mat=ap.matrix, go=ap.gap_open, ge=ap.gap_ext, gend=ap.gap_end)
    kern = dp.banded_global_cuda(**args, **kw)
    t0 = time.perf_counter()
    plain = dp.banded_global_plain(**args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = max(int((k.long() - p.long()).abs().max())
                for k, p in zip(kern, plain))
    ms = cuda_ms(lambda: dp.banded_global_cuda(**args, **kw), 5)
    tb = kern[2]
    bnd = bound(nbytes(*args.values(), *kern),
                OPS_GLOBAL_CELL * band_cells(tuple(args.values())))
    t0 = time.perf_counter()
    tb.cpu()
    copy_ms = (time.perf_counter() - t0) * 1e3
    log(f"C4 banded_global: {len(jobs)} refine jobs, first batch {len(pairs)}"
        f" pairs at L1={args['s1'].shape[1] - 1}, L2={args['s2'].shape[1] - 1}"
        f"; max |err| {worst} over score, ctype and {tb.numel()} lattice "
        f"bytes; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; lattice copy "
        f"to the host {copy_ms:.2f} ms; bound {bnd[0]:.5f} ms ({bnd[1]})")
    if worst != 0:
        fail("banded_global kernel disagrees with the plain version")
    return worst, ms, plain_ms, len(jobs), tb.numel(), copy_ms, bnd


def samse_routes(eng, idx, reads, sai_bytes, opt, label):
    """samse on the card and on the host reference route: identical SAM
    bytes; reads/s and part seconds of each."""
    import torch
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.utils.rand48 import Rand48
    per_read = sai_columns(sai_bytes)
    out = {}
    for route in ("reference", "cuda"):
        msamse.seconds = dict.fromkeys(msamse.seconds, 0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = msamse.samse_bytes(eng, reads, per_read, opt,
                                  rng=Rand48(idx.bns.seed),
                                  host_reference=route == "reference")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        parts = dict(msamse.seconds)
        parts["rest"] = dt - sum(parts.values())
        out[route] = (blob, len(reads) / dt, parts)
        log(f"samse {label}, {route}: {len(reads) / dt:.1f} reads/s "
            f"({dt:.3f} s); host seconds per part {parts}")
    if out["cuda"][0] != out["reference"][0]:
        fail(f"samse SAM on the card differs from the host reference "
             f"route's ({label})")
    return out


def record(module, name):
    """Replace module.name by a wrapper that appends each call's (args,
    kwargs) to a list and calls through.  Returns (the list, a function
    that puts the original back)."""
    fn, calls = getattr(module, name), []

    def wrapper(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(module, name, wrapper)
    return calls, lambda: setattr(module, name, fn)


def check_launches(label, calls, kernel, plain, size, bound_of):
    """A kernel against its plain version on launches recorded from the
    main path, every output exact on each.  Each launch is timed once
    with CUDA events as it is replayed, and `total_ms` sums those: the
    kernel's device time over the path.  The largest launch by
    `size(args)` is timed again over 5 launches (`ms`) beside its plain
    version (`plain_ms`), and its bound is `bound_of(args, outputs)`.
    Returns a dict of those, max |err| (`err`), and the largest launch's
    `args` and plain outputs (`out`)."""
    import torch
    worst, total_ms, n_rows, timed = 0, 0.0, 0, None
    big = max(calls, key=lambda c: size(c[0]))
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    for call in calls:
        args, kw = call
        ev0.record()
        kern = as_tuple(kernel(*args, **kw))
        ev1.record()
        torch.cuda.synchronize()
        total_ms += ev0.elapsed_time(ev1)
        t0 = time.perf_counter()
        out = as_tuple(plain(*args, **kw))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        worst = max([worst] + [int((k.long() - p.long()).abs().max())
                               for k, p in zip(kern, out)])
        n_rows += out[0].shape[0]
        if call is big:
            timed = (plain_ms, out)
    args, kw = big
    ms = cuda_ms(lambda: kernel(*args, **kw), 5)
    bnd = bound_of(args, timed[1])
    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
    log(f"{label}: max |err| {worst} over every output of {len(calls)} "
        f"launches ({n_rows} rows), {total_ms:.3f} ms of kernel in all; "
        f"largest {timed[1][0].shape[0]} rows, inputs {shapes}, {kw}: "
        f"kernel {ms:.4f} ms, plain {timed[0]:.2f} ms; bound "
        f"{bnd[0]:.5f} ms ({bnd[1]})")
    if worst != 0:
        fail(f"{label}: the kernel disagrees with the plain version")
    return {"err": worst, "ms": ms, "plain_ms": timed[0],
            "total_ms": total_ms, "bound": bnd, "args": args,
            "out": timed[1]}


def sampe_routes(eng, idx, pairs, sais, opt, popt):
    """sampe on the host reference route and on the card: pairs/s, part
    seconds and the card route's launches of C3, C4 and C5, with the
    arguments of each C5 and C4 launch recorded ({"local_fwd": [...],
    "banded_global": [...]})."""
    import torch
    from nabwa_tpu_torch.models import sampe as msampe
    from nabwa_tpu_torch.ops import dp
    from nabwa_tpu_torch.ops import sa_lookup as sl
    from nabwa_tpu_torch.utils.rand48 import Rand48
    out, recorded = {}, {}
    for route in ("reference", "cuda"):
        msampe.seconds = dict.fromkeys(msampe.seconds, 0.0)
        sl.launches = dp.launches = dp.launches_local = 0
        restore = []
        if route == "cuda":
            for name, fn in (("local_fwd", "local_fwd_cuda"),
                             ("banded_global", "banded_global_cuda")):
                recorded[name], undo = record(dp, fn)
                restore.append(undo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            blob, ii = msampe.sampe_bytes(eng, pairs, sais, opt, popt,
                                          Rand48(idx.bns.seed),
                                          host_reference=route == "reference")
        finally:
            for undo in restore:
                undo()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        parts = dict(msampe.seconds)
        parts["rest"] = dt - sum(parts.values())
        rescue = sum(v for k, v in parts.items()
                     if k.startswith("rescue_"))
        counts = {"sa_lookup": sl.launches, "banded_global": dp.launches,
                  "local_fwd": dp.launches_local}
        out[route] = (blob, len(pairs[0]) / dt, parts, rescue / dt, counts)
        log(f"sampe, {route}: {len(pairs[0]) / dt:.1f} pairs/s ({dt:.3f} "
            f"s; insert size {ii.avg:.2f} +- {ii.std:.2f}); rescue "
            f"{100 * rescue / dt:.1f} % of the time; host seconds per part "
            f"{parts}; launches {counts}")
    return out, recorded


def bwasw_routes(eng, idx, reads, opt):
    """bwasw on the host reference route and on the card: reads/s, part
    seconds and the card route's launches of C3, C4 and C6, with the
    arguments of each C6, C4 and C3 launch recorded ({"extend": [...],
    "banded_global": [...], "sa_lookup": [...]})."""
    import torch
    from nabwa_tpu_torch.models import bwasw as mbw
    from nabwa_tpu_torch.ops import dp
    from nabwa_tpu_torch.ops import sa_lookup as sl
    from nabwa_tpu_torch.utils.rand48 import Rand48
    out, recorded = {}, {}
    for route in ("reference", "cuda"):
        mbw.seconds = dict.fromkeys(mbw.seconds, 0.0)
        sl.launches = dp.launches = dp.launches_extend = 0
        restore = []
        if route == "cuda":
            for name, mod, fn in (("extend", dp, "extend_cuda"),
                                  ("banded_global", dp,
                                   "banded_global_cuda"),
                                  ("sa_lookup", sl, "sa_lookup_cuda")):
                recorded[name], undo = record(mod, fn)
                restore.append(undo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            body = mbw.bwasw_bytes(idx, reads, opt, eng, Rand48(11),
                                   host_reference=route == "reference",
                                   threads=os.cpu_count())
        finally:
            for undo in restore:
                undo()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        parts = {k: v for k, v in mbw.seconds.items() if v}
        parts["rest"] = dt - sum(parts.values())
        counts = {"sa_lookup": sl.launches, "banded_global": dp.launches,
                  "extend": dp.launches_extend}
        out[route] = (body, len(reads) / dt, parts, counts)
        log(f"bwasw, {route}: {len(reads) / dt:.2f} reads/s ({dt:.3f} s); "
            f"host seconds per part {parts}; launches {counts}")
    return out, recorded


def profile_run(label, fn):
    """torch.profiler over one call of fn: busy share and per-kernel device
    time, or None where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    top = sorted(on_dev, key=lambda e: -dev_us(e))[:6]
    rows = {e.key[:48]: {"count": e.count, "ms": dev_us(e) / 1e3}
            for e in top}
    if not on_dev:
        log(f"profiler, {label}: no device time seen (not measured)")
        return None
    log(f"profiler, {label}: {wall:.3f} s wall under the profiler, device "
        f"busy {busy_ms:.1f} ms ({100 * busy_ms / 1e3 / wall:.1f} %); {rows}")
    return {"wall_s": wall, "busy_ms": busy_ms,
            "busy_share": busy_ms / 1e3 / wall, "top": rows}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--glen", type=int, default=64_000_000)
    ap.add_argument("--reads", type=int, default=32768)
    ap.add_argument("--pairs", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=2048,
                    help="device batch of the timed engine run")
    ap.add_argument("--retry-stack", type=int, default=1024,
                    help="retry-tier slot pool of the timed engine run; "
                    "its hit list is an eighth of it, as at the default")
    ap.add_argument("--long-reads", type=int, default=512,
                    help="1 kb reads of the bwasw phases")
    ap.add_argument("--profile", action="store_true",
                    help="run torch.profiler over one more engine run and "
                    "one more bwasw card run")
    args = ap.parse_args()
    if not (ROOT / "nabwa_tpu_torch" / "csrc").is_dir() or \
            not (ROOT / "native").is_dir():
        fail("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    torch.cuda.set_device(0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t_start = time.perf_counter()

    import numpy as np
    from nabwa_tpu_torch import cli as port_cli
    from nabwa_tpu_torch.index.fmindex import BwaIndex
    from nabwa_tpu_torch.io import fastq
    from nabwa_tpu_torch.models import aln as maln
    from nabwa_tpu_torch.models.samse import sam_header
    from nabwa_tpu_torch.options import GapOpt, PeOpt
    from nabwa_tpu_torch.ops import _build, dfs_cuda, dp, occ
    from nabwa_tpu_torch.ops import sa_lookup as sl
    from nabwa_tpu_torch.utils.rand48 import Rand48

    # phase 1: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    _build.lib()
    nvcc_s = _build.build_seconds or 0.0
    log(f"kernel library {_build.LIB_PATH.relative_to(ROOT)}: nvcc "
        f"{nvcc_s:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            log("ptxas: " + ln.strip())

    fa, fq, fq_gapped, fq1, fq2, fq_long = make_data(
        args.glen, args.reads, args.pairs, args.long_reads)
    opt = GapOpt()
    idx = BwaIndex.load(str(fa))
    reads = port_cli.open_reads(str(fq), opt.mode)(args.reads, 0)
    if len(reads) != args.reads:
        fail(f"read {len(reads)} reads, expected {args.reads}")
    eng = maln.AlnEngine(idx, opt, "cuda", retry_stack_cap=args.retry_stack,
                         retry_hits_cap=args.retry_stack // 8)

    # phases 2-3: kernels against their plain versions on the card, on the
    # engine's own inputs for the first CHECK_B reads of the chunk
    lens = reads.clip_lens().astype(np.int32)
    maxdiff, local = maln.batch_options(opt, lens)
    max_len = int(lens.max())
    part = reads[:CHECK_B]
    inputs = maln.batch_inputs(part, lens[:CHECK_B], maxdiff[:CHECK_B],
                               local, max_len, eng.device)
    cw_err, cw_ms, cw_plain, cw_bound = check_cal_width(eng, inputs)
    dfs_err, dfs_ms, dfs_plain, flagged, dfs_bound = check_dfs(
        eng, inputs, maln.dfs_statics(local, eng.stack_cap, eng.hits_cap,
                                      eng.tier0_max_iters), "tier 0")
    # the retry tier's settings on the reads tier 0 flagged (all of the
    # batch where it flagged none)
    redo = flagged if len(flagged) else np.arange(len(part))
    again = maln.batch_inputs([part[int(i)] for i in redo], lens[redo],
                              maxdiff[redo], local, max_len, eng.device)
    retry_err, retry_ms, retry_plain, _, _ = check_dfs(
        eng, again, maln.dfs_statics(local, eng.retry_stack_cap,
                                     eng.retry_hits_cap, eng.max_iters),
        "retry tier")

    # phase 4: the aln path at full size
    want, host_s = native_reference(idx, reads, opt)
    log(f"host native engine: {len(reads) / host_s:.1f} reads/s "
        f"({os.cpu_count()} cores)")
    eng.run_chunk(reads[:args.batch], device_batch=args.batch)   # warm-up
    eng.tier0_reads = eng.retry_reads = eng.host_drain_reads = 0
    eng.seconds = dict.fromkeys(eng.seconds, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run_chunk(reads, device_batch=args.batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = opt.pack() + native_block(res)
    host_share = eng.host_drain_reads / len(reads)
    parts = dict(eng.seconds, rest=dt - sum(eng.seconds.values()))
    log(f"aln on the card: {len(reads) / dt:.1f} reads/s ({dt:.3f} s for "
        f"{len(reads)} reads, batch {args.batch}, retry pool "
        f"{eng.retry_stack_cap}); finished on tier 0 {eng.tier0_reads}, "
        f"retry {eng.retry_reads}, host {eng.host_drain_reads} "
        f"({100 * host_share:.2f} %); host seconds per part {parts}")
    if got != want:
        fail("engine .sai differs from the host native engine's")
    if host_share > MAX_HOST_SHARE:
        fail(f"{100 * host_share:.1f} % of reads drained on the host")
    prof = (profile_run("aln", lambda: eng.run_chunk(
        reads, device_batch=args.batch)) if args.profile else None)

    def zero():
        occ.launches = dfs_cuda.launches = sl.launches = 0
        dp.launches = dp.launches_local = dp.launches_extend = 0

    def launched():
        return {"dfs": dfs_cuda.launches, "cal_width": occ.launches,
                "sa_lookup": sl.launches, "banded_global": dp.launches,
                "local_fwd": dp.launches_local,
                "extend": dp.launches_extend}

    tmp = pathlib.Path(tempfile.gettempdir())
    out = tmp / "nabwa_torch_smoke.sai"
    out.unlink(missing_ok=True)
    zero()
    t0 = time.perf_counter()
    rc = port_cli.main(["aln", "--device", "cuda", str(fa), str(fq),
                        "-f", str(out)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = launched()
    log(f"CLI aln --device cuda: rc {rc}, {cli_s:.2f} s end to end "
        f"(index load included); launches {counts}")
    if rc != 0:
        fail(f"the port's aln CLI exited with {rc}")
    if out.read_bytes() != want:
        fail("CLI .sai differs from the host native engine's")
    for name in ("dfs", "cal_width"):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the aln path")

    # phases 5-6: C3 on the SA rows samse asks for on the bench .sai; the
    # gapped read set's .sai from the host engine, and C4 on its jobs
    sa_err, sa_ms, sa_plain, sa_rows, sa_bound = check_sa_lookup(
        eng, idx, reads, want)
    reads_g = port_cli.open_reads(str(fq_gapped), opt.mode)(args.reads, 0)
    want_g, host_g_s = native_reference(idx, reads_g, opt)
    log(f"host native engine, gapped reads: {len(reads_g) / host_g_s:.1f} "
        f"reads/s")
    dp_err, dp_ms, dp_plain, n_jobs, tb_bytes, tb_copy_ms, dp_bound = \
        check_banded_global(eng, idx, reads_g, want_g, opt)

    # phase 7: samse at full size, on the card and on the host reference
    # route, for both read sets
    se_bench = samse_routes(eng, idx, reads, want, opt, "bench reads")
    se_gap = samse_routes(eng, idx, reads_g, want_g, opt, "gapped reads")

    # phase 8: the CLI chain on the gapped reads, every launch count at 0
    # before each command: aln (C1, C2), then samse (C3, C4)
    sai_g = tmp / "nabwa_torch_smoke_g.sai"
    sam_g = tmp / "nabwa_torch_smoke.sam"
    sai_g.unlink(missing_ok=True)
    sam_g.unlink(missing_ok=True)
    zero()
    rc = port_cli.main(["aln", "--device", "cuda", str(fa), str(fq_gapped),
                        "-f", str(sai_g)])
    torch.cuda.synchronize()
    aln_g_counts = launched()
    if rc != 0 or sai_g.read_bytes() != want_g:
        fail(f"CLI aln on the gapped reads: rc {rc}, or its .sai differs "
             f"from the host native engine's")
    zero()
    t0 = time.perf_counter()
    rc = port_cli.main(["samse", "--device", "cuda", str(fa), str(sai_g),
                        str(fq_gapped), "-f", str(sam_g)])
    torch.cuda.synchronize()
    samse_cli_s = time.perf_counter() - t0
    se_counts = launched()
    log(f"CLI chain on the gapped reads: aln launches {aln_g_counts}; "
        f"samse --device cuda rc {rc}, {samse_cli_s:.2f} s end to end "
        f"(index load included), launches {se_counts}")
    if rc != 0:
        fail(f"the port's samse CLI exited with {rc}")
    if sam_g.read_bytes() != (sam_header(idx.bns).encode()
                              + se_gap["reference"][0]):
        fail("CLI SAM differs from the host reference route's")
    for name in ("dfs", "cal_width"):
        if aln_g_counts[name] <= 0:
            fail(f"kernel {name} was not launched by the CLI aln")
    for name in ("sa_lookup", "banded_global"):
        if se_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the samse path")

    # phase 9: the pair set, both ends aligned by the host engine
    popt = PeOpt()
    pairs = tuple(port_cli.open_reads(str(f), opt.mode)(args.pairs, 0)
                  for f in (fq1, fq2))
    if any(len(r) != args.pairs for r in pairs):
        fail(f"read {[len(r) for r in pairs]} pairs, expected {args.pairs}")
    want_pe = [native_reference(idx, r, opt)[0] for r in pairs]
    sais = tuple(sai_columns(w) for w in want_pe)

    # phase 10: sampe on the host reference route and on the card, the
    # card route's C5 and C4 launches recorded
    pe_runs, rec = sampe_routes(eng, idx, pairs, sais, opt, popt)

    # phase 11: C5 and C4 against their plain versions on every launch of
    # that card run (the rescue's forward rounds; its path recovery with
    # per-pair bands and gap_end -1, and any refine batch), then the SAMs
    if not rec["local_fwd"] or not rec["banded_global"]:
        fail(f"the card run of sampe launched C5 {len(rec['local_fwd'])} "
             f"and C4 {len(rec['banded_global'])} times")
    def dp_size(a):
        return a[0].numel() * a[2].shape[1]

    def global_bound(a, out):
        return bound(io_bytes(a, out), OPS_GLOBAL_CELL * band_cells(a))

    lf = check_launches(
        "C5 local_fwd, sampe's rescue rounds", rec["local_fwd"],
        dp.local_fwd_cuda, dp.local_fwd_plain, dp_size,
        lambda a, out: bound(io_bytes(a, out), OPS_LOCAL_CELL * int(
            (a[1].long() * a[3].long()).sum())))
    pdp = check_launches(
        "C4 banded_global, sampe's rescue paths and refine",
        rec["banded_global"], dp.banded_global_cuda, dp.banded_global_plain,
        dp_size, global_bound)
    if pe_runs["cuda"][0] != pe_runs["reference"][0]:
        fail("sampe SAM on the card differs from the host reference route's")
    n_rescue = args.pairs // RESCUE_SHARE
    rescued = pe_runs["cuda"][0].count(b"XT:A:M")
    log(f"sampe: {rescued} mates placed by the rescue ({n_rescue} pairs "
        f"built for it)")
    if rescued < n_rescue // 2:
        fail(f"the rescue placed {rescued} mates, fewer than half of the "
             f"{n_rescue} built for it")

    # phase 12: the slice's main path, the CLI chain on the pairs, every
    # launch count at 0 before each command: aln on each end (C1, C2),
    # then sampe (C3, C4, C5)
    pe_sai = [tmp / f"nabwa_torch_smoke_p{end}.sai" for end in (1, 2)]
    pe_sam = tmp / "nabwa_torch_smoke_pe.sam"
    main_counts = []
    for path, fqp, w in zip(pe_sai, (fq1, fq2), want_pe):
        path.unlink(missing_ok=True)
        zero()
        rc = port_cli.main(["aln", "--device", "cuda", str(fa), str(fqp),
                            "-f", str(path)])
        torch.cuda.synchronize()
        main_counts.append(launched())
        if rc != 0 or path.read_bytes() != w:
            fail(f"CLI aln on {fqp.name}: rc {rc}, or its .sai differs from "
                 f"the host native engine's")
        for name in ("dfs", "cal_width"):
            if main_counts[-1][name] <= 0:
                fail(f"kernel {name} was not launched by the CLI aln")
    pe_sam.unlink(missing_ok=True)
    zero()
    t0 = time.perf_counter()
    rc = port_cli.main(["sampe", "--device", "cuda", str(fa),
                        *map(str, pe_sai), str(fq1), str(fq2), "-f",
                        str(pe_sam)])
    torch.cuda.synchronize()
    sampe_cli_s = time.perf_counter() - t0
    main_counts.append(launched())
    log(f"CLI chain on the pairs: aln launches {main_counts[:2]}; sampe "
        f"--device cuda rc {rc}, {sampe_cli_s:.2f} s end to end (index "
        f"load included), launches {main_counts[2]}")
    if rc != 0:
        fail(f"the port's sampe CLI exited with {rc}")
    if pe_sam.read_bytes() != (sam_header(idx.bns).encode()
                               + pe_runs["reference"][0]):
        fail("CLI sampe SAM differs from the host reference route's")
    for name in ("sa_lookup", "banded_global", "local_fwd"):
        if main_counts[2][name] <= 0:
            fail(f"kernel {name} was not launched on the sampe path")

    # phase 13: the long reads
    from nabwa_tpu_torch.models import bwasw as mbw
    lreads = [(name, seq.decode(), qual.decode() if qual else None)
              for name, _, seq, qual in fastq.iter_fastq(str(fq_long))]
    if len(lreads) != args.long_reads:
        fail(f"read {len(lreads)} long reads, expected {args.long_reads}")
    bopt = mbw.Bsw2Opt()

    # phase 14: bwasw on the host reference route and on the card, the
    # card route's C6, C4 and C3 launches recorded and replayed against
    # their plain versions, then the SAMs
    sw_runs, sw_rec = bwasw_routes(eng, idx, lreads, bopt)
    for name in ("extend", "banded_global", "sa_lookup"):
        if not sw_rec[name]:
            fail(f"the card run of bwasw launched {name} no time")
    ext = check_launches(
        "C6 extend, bwasw's launches", sw_rec["extend"], dp.extend_cuda,
        dp.extend_plain, dp_size,
        lambda a, out: bound(io_bytes(a, out), OPS_EXTEND_CELL * int(
            out[3].long().sum())))
    sw_dp = check_launches(
        "C4 banded_global, bwasw's cigars", sw_rec["banded_global"],
        dp.banded_global_cuda, dp.banded_global_plain, dp_size,
        global_bound)
    sw_sa = check_launches(
        "C3 sa_lookup, bwasw's launches", sw_rec["sa_lookup"],
        sl.sa_lookup_cuda, sl.sa_lookup_plain, lambda a: a[6].shape[0],
        lambda a, _: sa_walk_bound(a))
    if sw_runs["cuda"][0] != sw_runs["reference"][0]:
        fail("bwasw SAM on the card differs from the host reference route's")
    sw_prof = (profile_run("bwasw", lambda: mbw.bwasw_bytes(
        idx, lreads, bopt, eng, Rand48(11))) if args.profile else None)
    sw_jobs = sum(int(c[0][0].shape[0]) for c in sw_rec["extend"])
    n_amb = sum("N" in s for _, s, _ in lreads)
    log(f"bwasw: {len(sw_rec['extend'])} C6 launches ({sw_jobs} jobs), "
        f"{len(sw_rec['banded_global'])} C4, {len(sw_rec['sa_lookup'])} C3; "
        f"{n_amb} reads with N bases")

    # phase 15: the bwasw CLI, every launch count at 0
    sw_sam = tmp / "nabwa_torch_smoke_sw.sam"
    sw_sam.unlink(missing_ok=True)
    zero()
    t0 = time.perf_counter()
    rc = port_cli.main(["bwasw", "--device", "cuda", str(fa), str(fq_long),
                        "-f", str(sw_sam)])
    torch.cuda.synchronize()
    bwasw_cli_s = time.perf_counter() - t0
    sw_counts = launched()
    main_counts.append(sw_counts)
    log(f"CLI bwasw --device cuda: rc {rc}, {bwasw_cli_s:.2f} s end to end "
        f"(index load included), launches {sw_counts}")
    if rc != 0:
        fail(f"the port's bwasw CLI exited with {rc}")
    if sw_sam.read_bytes() != (mbw.sam_sq(idx.bns)
                               + sw_runs["reference"][0]):
        fail("CLI bwasw SAM differs from the host reference route's")
    for name in ("sa_lookup", "banded_global", "extend"):
        if sw_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the bwasw path")
    launches = {k: sum(c[k] for c in main_counts) for k in main_counts[0]}

    def entry(name, source, replaces, err, ms, plain_ms, bnd, **extra):
        return {"name": name, "route": "cuda",
                "source": f"nabwa_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                **extra}

    kernels = [
        entry("dfs", "dfs.cu", "nabwa_tpu/ops/dfs_pallas.py:1253",
              max(dfs_err, retry_err), dfs_ms, dfs_plain, dfs_bound,
              retry_ms=retry_ms, retry_plain_ms=retry_plain,
              retry_reads=len(redo), aln_cli_launches=counts["dfs"]),
        entry("cal_width", "cal_width.cu", "nabwa_tpu/ops/occ.py:141",
              cw_err, cw_ms, cw_plain, cw_bound,
              aln_cli_launches=counts["cal_width"]),
        entry("sa_lookup", "sa_lookup.cu", "nabwa_tpu/ops/sa_lookup.py:34",
              max(sa_err, sw_sa["err"]), sa_ms, sa_plain, sa_bound,
              rows_checked=sa_rows,
              samse_cli_launches=se_counts["sa_lookup"],
              bwasw_launches=sw_counts["sa_lookup"],
              bwasw_launches_checked=len(sw_rec["sa_lookup"]),
              bwasw_rows=int(sw_sa["args"][6].shape[0]),
              bwasw_ms=sw_sa["ms"], bwasw_plain_ms=sw_sa["plain_ms"],
              bwasw_total_ms=sw_sa["total_ms"],
              bwasw_bound_ms=sw_sa["bound"][0],
              bwasw_bound_by=sw_sa["bound"][1]),
        entry("banded_global", "banded_global.cu", "nabwa_tpu/ops/dp.py:31",
              max(pdp["err"], dp_err, sw_dp["err"]), pdp["ms"],
              pdp["plain_ms"], pdp["bound"],
              launches_checked=len(rec["banded_global"]),
              timed_pairs=pdp["args"][0].shape[0],
              samse_refine_jobs=n_jobs, samse_refine_ms=dp_ms,
              samse_refine_plain_ms=dp_plain,
              samse_refine_bound_ms=dp_bound[0],
              lattice_bytes=tb_bytes, lattice_copy_ms=tb_copy_ms,
              samse_cli_launches=se_counts["banded_global"],
              bwasw_launches=sw_counts["banded_global"],
              bwasw_launches_checked=len(sw_rec["banded_global"]),
              bwasw_pairs=int(sw_dp["args"][0].shape[0]),
              bwasw_L1=int(sw_dp["args"][0].shape[1] - 1),
              bwasw_L2=int(sw_dp["args"][2].shape[1] - 1),
              bwasw_band_cells=band_cells(sw_dp["args"]),
              bwasw_ms=sw_dp["ms"], bwasw_plain_ms=sw_dp["plain_ms"],
              bwasw_total_ms=sw_dp["total_ms"],
              bwasw_bound_ms=sw_dp["bound"][0],
              bwasw_bound_by=sw_dp["bound"][1]),
        entry("local_fwd", "local_fwd.cu", "nabwa_tpu/ops/dp.py:404",
              lf["err"], lf["ms"], lf["plain_ms"], lf["bound"],
              launches_checked=len(rec["local_fwd"]),
              rescue_jobs=[int(a[0].shape[0]) for a, _ in rec["local_fwd"]],
              timed_cells=int((lf["args"][1].long()
                               * lf["args"][3].long()).sum())),
        entry("extend", "extend.cu", "nabwa_tpu/ops/dp.py:264",
              ext["err"], ext["ms"], ext["plain_ms"], ext["bound"],
              launches_checked=len(sw_rec["extend"]),
              jobs_checked=sw_jobs, total_ms=ext["total_ms"],
              timed_jobs=int(ext["args"][0].shape[0]),
              timed_L1=int(ext["args"][0].shape[1] - 2),
              timed_L2=int(ext["args"][2].shape[1] - 1),
              timed_cells=int(ext["out"][3].long().sum())),
    ]
    samse = {label: {route: {"reads_per_sec": r[1], "seconds": r[2]}
                     for route, r in runs.items()}
             for label, runs in (("bench", se_bench), ("gapped", se_gap))}
    sampe = {route: {"pairs_per_sec": r[1], "seconds": r[2],
                     "rescue_share": r[3], "launches": r[4]}
             for route, r in pe_runs.items()}
    sampe.update(pairs=args.pairs, pairs_built_for_rescue=n_rescue,
                 cli_seconds=sampe_cli_s, mate_rescued=rescued)
    bwasw = {route: {"reads_per_sec": r[1], "seconds": r[2],
                     "launches": r[3]} for route, r in sw_runs.items()}
    bwasw.update(reads=len(lreads), reads_with_n=n_amb,
                 cli_seconds=bwasw_cli_s, cli_launches=sw_counts,
                 profile=sw_prof)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "aln_reads_per_sec": len(reads) / dt,
                      "host_drain_share": host_share,
                      "tier0_reads": eng.tier0_reads,
                      "retry_reads": eng.retry_reads,
                      "host_drain_reads": eng.host_drain_reads,
                      "run_chunk_seconds": parts,
                      "host_native_reads_per_sec": len(reads) / host_s,
                      "cli_seconds": cli_s, "profile": prof,
                      "samse": samse, "samse_cli_seconds": samse_cli_s,
                      "gapped_aln_launches": aln_g_counts,
                      "sampe": sampe, "bwasw": bwasw}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
