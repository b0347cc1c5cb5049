#!/usr/bin/env python3
"""On-card smoke run of nabwa_tpu_torch, the `aln` path on one NVIDIA GPU.

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
4. the main path at the bench's size: a 64 Mbp random genome (seed 99)
   indexed by the port's host build, 32768 x 100 bp reads at 1 % error
   (seed 100).  After a warm-up batch the engine's rate is timed, with
   host seconds per part of `run_chunk`; then, with every launch count at
   0, `python -m nabwa_tpu_torch aln --device cuda` runs in-process.  Both
   `.sai` outputs must be byte-identical to the shared host engine's
   (native/dfsgap.cpp).  Every kernel must have launched, and at most 20 %
   of the reads may fall through to the host.  The host-drained reads are
   solved by that same host engine, so for them the comparison holds the
   host engine against itself;
5. with --profile, torch.profiler over one more run: the card's busy
   share and the device time of each kernel.

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
    """Genome, index and reads of the bench (cached by size and seed)."""
    from nabwa_tpu_torch import host
    from tests import genomes
    work = pathlib.Path(tempfile.gettempdir()) / f"nabwa_torch_smoke_{glen}"
    work.mkdir(parents=True, exist_ok=True)
    fa, fq = work / "g.fa", work / f"r{n_reads}.fq"
    if not (work / "g.fa.rsa").exists() or not fq.exists():
        t0 = time.perf_counter()
        text, seqs = genomes.random_genome(glen, seed=99)
        fa.write_bytes(text)
        # SA-IS at every size: the same index as the blockwise
        # incremental construction, built faster when memory is plentiful
        os.environ.setdefault("NABWA_BWT_INC", "0")
        host.build_index(str(fa))
        fq.write_bytes(genomes.sample_reads(seqs[0], n_reads, 100, seed=100,
                                            err_rate=0.01))
        log(f"genome + index + reads: {time.perf_counter() - t0:.1f} s")
    return fa, fq


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
    from nabwa_tpu_torch.ops import _build, dfs_cuda, occ

    # phase 1: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    _build.lib()
    nvcc_s = _build.build_seconds or 0.0
    log(f"kernel library {_build.LIB_PATH.relative_to(ROOT)}: nvcc "
        f"{nvcc_s:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            log("ptxas: " + ln.strip())

    fa, fq = make_data(args.glen, args.reads)
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
    ]
    print(json.dumps({"kernels": kernels, "aln_reads_per_sec": len(reads) / dt,
                      "host_drain_share": host_share,
                      "tier0_reads": eng.tier0_reads,
                      "retry_reads": eng.retry_reads,
                      "host_drain_reads": eng.host_drain_reads,
                      "run_chunk_seconds": parts,
                      "host_native_reads_per_sec": len(reads) / host_s,
                      "cli_seconds": cli_s, "profile": prof}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
