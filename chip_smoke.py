#!/usr/bin/env python3
"""On-card smoke run of nabwa_tpu_torch, the `aln` and `samse` paths on one
NVIDIA GPU.

    python3 chip_smoke.py [--glen BP] [--reads N] [--batch B]
                          [--retry-stack S] [--profile]

Run from the root of a checkout.  It imports the port (`nabwa_tpu_torch`,
whose `host` module holds every host piece it shares with the reference
package), `tests/genomes.py` and the standard library.  Phases, any
failure exits non-zero:

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
With --profile, torch.profiler runs over one more aln run after phase 4's
timed run: the card's busy share and the device time of each kernel.

Data and the index are cached under the temp directory.  The last two
lines of standard output are the card line and
{"ok": true, "device": {...}}; the line before them holds the kernels'
launch counts, errors and times.  Nothing is printed on standard output
before the run has passed, and nothing at all without a CUDA device or
outside a checkout.
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


def make_data(glen, n_reads):
    """Genome, index, the bench reads and the gapped reads (cached by size
    and seed): 100 bp reads at 1 % substitutions, seed 100, and the same
    with a 1-base indel in half the reads, seed 101."""
    from nabwa_tpu_torch import host
    from tests import genomes
    work = pathlib.Path(tempfile.gettempdir()) / f"nabwa_torch_smoke_{glen}"
    work.mkdir(parents=True, exist_ok=True)
    fa = work / "g.fa"
    fqs = {work / f"r{n_reads}.fq": dict(seed=100),
           work / f"r{n_reads}_gapped.fq": dict(seed=101, indel_rate=0.5)}
    if not (work / "g.fa.rsa").exists() or not all(p.exists() for p in fqs):
        t0 = time.perf_counter()
        text, seqs = genomes.random_genome(glen, seed=99)
        if not (work / "g.fa.rsa").exists():
            fa.write_bytes(text)
            # SA-IS at every size: the same index as the blockwise
            # incremental construction, built faster when memory is
            # plentiful
            os.environ.setdefault("NABWA_BWT_INC", "0")
            host.build_index(str(fa))
        for fq, kw in fqs.items():
            fq.write_bytes(genomes.sample_reads(seqs[0], n_reads, 100,
                                                err_rate=0.01, **kw))
        log(f"genome + index + reads: {time.perf_counter() - t0:.1f} s")
    return (fa, *fqs)


def check_cal_width(eng, inputs):
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
    args = (ix.bwt_fwd, ix.l2, ix.primary_fwd, ix.seq_len, q,
            inputs["lengths"])
    ms = cuda_ms(lambda: occ.cal_width_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: occ.cal_width_plain(*args), 2)
    log(f"C2 cal_width: {q.shape[0]} reads x 2 strands, reads and seed "
        f"suffixes, max |err| {worst} over {n_cmp} values; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.2f} ms per call at {tuple(q.shape)}")
    if worst != 0:
        fail("cal_width kernel disagrees with the plain version")
    return worst, ms, plain_ms


def check_dfs(eng, inputs, statics, tier):
    """C1 against the plain DFS on one batch of the engine's own inputs.
    The width planes come from the plain cal_width, so C1 is checked on
    its own.  Returns (max |err|, kernel ms, plain ms, flagged rows)."""
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
    hits_full = int((k[flagged, 4 * H] >= H).sum())
    at_cap = int((iters[flagged] >= cap).sum())
    log(f"C1 dfs, {tier}: {B} reads (L={L}, S={S}, H={H}, max_iters={cap}), "
        f"max |err| {worst} over hits/n_aln/hw/overflow; {len(flagged)} "
        f"flagged ({hits_full} hit list full, {at_cap} iteration cap, "
        f"{len(flagged) - hits_full - at_cap} slot pool or seq counter); "
        f"most iterations of a read {int(iters.max())}; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms")
    if worst != 0:
        bad = np.nonzero(diff.any(1).cpu().numpy())[0][:5]
        fail(f"dfs kernel disagrees with the plain version, {tier} "
             f"(rows {bad})")
    return worst, ms, plain_ms, flagged


def native_reference(idx, reads, opt):
    """The .sai of the shared host engine (native/dfsgap.cpp)."""
    from nabwa_tpu_torch import host
    from nabwa_tpu_torch.models.aln import batch_options
    maxdiff, local = batch_options(opt, reads.clip_lens().astype("int32"))
    t0 = time.perf_counter()
    res = host.native.dfs_match_gap_native(
        idx.fwd.bwt, idx.fwd.primary, idx.rev.bwt, idx.rev.primary,
        idx.fwd.l2, idx.fwd.seq_len, reads, maxdiff, local)
    dt = time.perf_counter() - t0
    if res is None:
        fail("the native host engine is unavailable")
    return opt.pack() + host.sai_block(res), dt


def sai_columns(sai_bytes):
    """The per-read alignments of a `.sai` as the CLI reads them
    (columnar)."""
    from nabwa_tpu_torch import host
    path = pathlib.Path(tempfile.gettempdir()) / "nabwa_torch_smoke_cols.sai"
    path.write_bytes(sai_bytes)
    return host.read_sai_columnar(str(path))[1]


def check_sa_lookup(eng, idx, reads, sai_bytes):
    """C3 against the plain version and the native host walk on every SA
    row samse asks for on this `.sai`, both strands."""
    import numpy as np
    import torch
    from nabwa_tpu_torch import host
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.ops import sa_lookup as sl
    ch = msamse.select(reads, sai_columns(sai_bytes), 3,
                       host.Rand48(idx.bns.seed))
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
                                        20), plain_ms)
    log(f"C3 sa_lookup: {n_rows} SA rows of samse on the bench .sai, both "
        f"strands, max |err| {worst} against the plain version and the "
        f"native walk; kernel {timed[1]:.4f} ms, plain {timed[2]:.2f} ms "
        f"per call at {timed[0]} rows")
    if worst != 0:
        fail("sa_lookup kernel disagrees with the plain version or the "
             "native walk")
    return worst, timed[1], timed[2], n_rows


def check_banded_global(eng, idx, reads, sai_bytes, opt):
    """C4 against the plain version on the first device batch of the
    refine jobs samse makes on this `.sai`: score, ctype and the whole
    traceback lattice."""
    import torch
    from nabwa_tpu_torch import host
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.ops import dp
    ch = msamse.select(reads, sai_columns(sai_bytes), 3,
                       host.Rand48(idx.bns.seed))
    msamse.sa_coords(eng, ch, host_reference=True)
    msamse.approx_mapq(ch, opt)
    jobs = msamse.gapped_jobs(ch)
    pairs = msamse.refine_pairs(jobs, idx.pac, idx.bns.l_pac)
    pairs = [p for p in pairs if len(p[0]) and len(p[1])][:dp.MAX_PAIRS]
    if not pairs:
        fail("the gapped read set gave no refine jobs")
    ap = host.ALN_PARAM_BWA
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
    t0 = time.perf_counter()
    tb.cpu()
    copy_ms = (time.perf_counter() - t0) * 1e3
    log(f"C4 banded_global: {len(jobs)} refine jobs, first batch {len(pairs)}"
        f" pairs at L1={args['s1'].shape[1] - 1}, L2={args['s2'].shape[1] - 1}"
        f"; max |err| {worst} over score, ctype and {tb.numel()} lattice "
        f"bytes; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; lattice copy "
        f"to the host {copy_ms:.2f} ms")
    if worst != 0:
        fail("banded_global kernel disagrees with the plain version")
    return worst, ms, plain_ms, len(jobs), tb.numel(), copy_ms


def samse_routes(eng, idx, reads, sai_bytes, opt, label):
    """samse on the card and on the host reference route: identical SAM
    bytes; reads/s and part seconds of each."""
    import torch
    from nabwa_tpu_torch import host
    from nabwa_tpu_torch.models import samse as msamse
    per_read = sai_columns(sai_bytes)
    out = {}
    for route in ("reference", "cuda"):
        msamse.seconds = dict.fromkeys(msamse.seconds, 0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = msamse.samse_bytes(eng, reads, per_read, opt,
                                  rng=host.Rand48(idx.bns.seed),
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


def profile_run(eng, reads, batch):
    """torch.profiler over one run_chunk: busy share and per-kernel device
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
        eng.run_chunk(reads, device_batch=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    top = sorted(on_dev, key=lambda e: -dev_us(e))[:6]
    rows = {e.key[:48]: {"count": e.count, "ms": dev_us(e) / 1e3}
            for e in top}
    if not on_dev:
        log("profiler: no device time seen (not measured)")
        return None
    log(f"profiler: {wall:.3f} s wall under the profiler, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / 1e3 / wall:.1f} %); {rows}")
    return {"wall_s": wall, "busy_ms": busy_ms,
            "busy_share": busy_ms / 1e3 / wall, "top": rows}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--glen", type=int, default=64_000_000)
    ap.add_argument("--reads", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=2048,
                    help="device batch of the timed engine run")
    ap.add_argument("--retry-stack", type=int, default=1024,
                    help="retry-tier slot pool of the timed engine run; "
                    "its hit list is an eighth of it, as at the default")
    ap.add_argument("--profile", action="store_true",
                    help="run torch.profiler over one more engine run")
    args = ap.parse_args()
    if not (ROOT / "nabwa_tpu_torch" / "csrc").is_dir() or \
            not (ROOT / "nabwa_tpu").is_dir():
        fail("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    torch.cuda.set_device(0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    import numpy as np
    from nabwa_tpu_torch import cli as port_cli
    from nabwa_tpu_torch import host
    from nabwa_tpu_torch.models import aln as maln
    from nabwa_tpu_torch.ops import _build, dfs_cuda, dp, occ
    from nabwa_tpu_torch.ops import sa_lookup as sl

    # phase 1: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    _build.lib()
    nvcc_s = _build.build_seconds or 0.0
    log(f"kernel library {_build.LIB_PATH.relative_to(ROOT)}: nvcc "
        f"{nvcc_s:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            log("ptxas: " + ln.strip())

    fa, fq, fq_gapped = make_data(args.glen, args.reads)
    opt = host.GapOpt()
    idx = host.BwaIndex.load(str(fa))
    reads = host.open_reads(str(fq), opt.mode)(args.reads, 0)
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
    cw_err, cw_ms, cw_plain = check_cal_width(eng, inputs)
    dfs_err, dfs_ms, dfs_plain, flagged = check_dfs(
        eng, inputs, maln.dfs_statics(local, eng.stack_cap, eng.hits_cap,
                                      eng.tier0_max_iters), "tier 0")
    # the retry tier's settings on the reads tier 0 flagged (all of the
    # batch where it flagged none)
    redo = flagged if len(flagged) else np.arange(len(part))
    again = maln.batch_inputs([part[int(i)] for i in redo], lens[redo],
                              maxdiff[redo], local, max_len, eng.device)
    retry_err, retry_ms, retry_plain, _ = check_dfs(
        eng, again, maln.dfs_statics(local, eng.retry_stack_cap,
                                     eng.retry_hits_cap, eng.max_iters),
        "retry tier")

    # phase 4: the main path at full size
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
    got = opt.pack() + host.sai_block(res)
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
    prof = profile_run(eng, reads, args.batch) if args.profile else None

    out = pathlib.Path(tempfile.gettempdir()) / "nabwa_torch_smoke.sai"
    out.unlink(missing_ok=True)
    occ.launches = dfs_cuda.launches = 0
    t0 = time.perf_counter()
    rc = port_cli.main(["aln", "--device", "cuda", str(fa), str(fq),
                        "-f", str(out)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = {"cal_width": occ.launches, "dfs": dfs_cuda.launches}
    log(f"CLI aln --device cuda: rc {rc}, {cli_s:.2f} s end to end "
        f"(index load included); launches {counts}")
    if rc != 0:
        fail(f"the port's aln CLI exited with {rc}")
    if out.read_bytes() != want:
        fail("CLI .sai differs from the host native engine's")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # phases 5-6: C3 on the SA rows samse asks for on the bench .sai; the
    # gapped read set's .sai from the host engine, and C4 on its jobs
    sa_err, sa_ms, sa_plain, sa_rows = check_sa_lookup(eng, idx, reads, want)
    reads_g = host.open_reads(str(fq_gapped), opt.mode)(args.reads, 0)
    want_g, host_g_s = native_reference(idx, reads_g, opt)
    log(f"host native engine, gapped reads: {len(reads_g) / host_g_s:.1f} "
        f"reads/s")
    dp_err, dp_ms, dp_plain, n_jobs, tb_bytes, tb_copy_ms = \
        check_banded_global(eng, idx, reads_g, want_g, opt)

    # phase 7: samse at full size, on the card and on the host reference
    # route, for both read sets
    se_bench = samse_routes(eng, idx, reads, want, opt, "bench reads")
    se_gap = samse_routes(eng, idx, reads_g, want_g, opt, "gapped reads")

    # phase 8: the CLI chain on the gapped reads, every launch count at 0
    # before each command: aln (C1, C2), then samse (C3, C4)
    tmp = pathlib.Path(tempfile.gettempdir())
    sai_g, sam_g = tmp / "nabwa_torch_smoke_g.sai", tmp / "nabwa_torch_smoke.sam"
    sai_g.unlink(missing_ok=True)
    sam_g.unlink(missing_ok=True)

    def zero():
        occ.launches = dfs_cuda.launches = sl.launches = dp.launches = 0

    def launched():
        return {"dfs": dfs_cuda.launches, "cal_width": occ.launches,
                "sa_lookup": sl.launches, "banded_global": dp.launches}

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
    if sam_g.read_bytes() != (host.sam_header(idx.bns).encode()
                              + se_gap["reference"][0]):
        fail("CLI SAM differs from the host reference route's")
    for name in ("dfs", "cal_width"):
        if aln_g_counts[name] <= 0:
            fail(f"kernel {name} was not launched by the CLI aln")
    for name in ("sa_lookup", "banded_global"):
        if se_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the samse path")

    kernels = [
        {"name": "dfs", "route": "cuda",
         "source": "nabwa_tpu_torch/csrc/dfs.cu",
         "replaces": "nabwa_tpu/ops/dfs_pallas.py:1253",
         "launches": counts["dfs"], "max_abs_err": max(dfs_err, retry_err),
         "ms": dfs_ms, "plain_ms": dfs_plain, "retry_ms": retry_ms,
         "retry_plain_ms": retry_plain, "retry_reads": len(redo)},
        {"name": "cal_width", "route": "cuda",
         "source": "nabwa_tpu_torch/csrc/cal_width.cu",
         "replaces": "nabwa_tpu/ops/occ.py:141",
         "launches": counts["cal_width"], "max_abs_err": cw_err,
         "ms": cw_ms, "plain_ms": cw_plain},
        {"name": "sa_lookup", "route": "cuda",
         "source": "nabwa_tpu_torch/csrc/sa_lookup.cu",
         "replaces": "nabwa_tpu/ops/sa_lookup.py:34",
         "launches": se_counts["sa_lookup"], "max_abs_err": sa_err,
         "ms": sa_ms, "plain_ms": sa_plain, "rows_checked": sa_rows},
        {"name": "banded_global", "route": "cuda",
         "source": "nabwa_tpu_torch/csrc/banded_global.cu",
         "replaces": "nabwa_tpu/ops/dp.py:31",
         "launches": se_counts["banded_global"], "max_abs_err": dp_err,
         "ms": dp_ms, "plain_ms": dp_plain, "refine_jobs": n_jobs,
         "lattice_bytes": tb_bytes, "lattice_copy_ms": tb_copy_ms},
    ]
    samse = {label: {route: {"reads_per_sec": r[1], "seconds": r[2]}
                     for route, r in runs.items()}
             for label, runs in (("bench", se_bench), ("gapped", se_gap))}
    print(json.dumps({"kernels": kernels, "aln_reads_per_sec": len(reads) / dt,
                      "host_drain_share": host_share,
                      "tier0_reads": eng.tier0_reads,
                      "retry_reads": eng.retry_reads,
                      "host_drain_reads": eng.host_drain_reads,
                      "run_chunk_seconds": parts,
                      "host_native_reads_per_sec": len(reads) / host_s,
                      "cli_seconds": cli_s, "profile": prof,
                      "samse": samse, "samse_cli_seconds": samse_cli_s,
                      "gapped_aln_launches": aln_g_counts}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
