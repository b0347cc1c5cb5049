#!/usr/bin/env python3
"""Time one part of the port with the code of one checkout, on
chip_smoke.py's 64 Mbp cell (the bench reads), on one NVIDIA GPU.

    python3 compare.py c3 CHECKOUT
    python3 compare.py aln CHECKOUT
    python3 compare.py launch CHECKOUT
    python3 compare.py c9 CHECKOUT [SASS_DIR]
    python3 compare.py c23 CHECKOUT [SASS_DIR]
    python3 compare.py c34 CHECKOUT [SASS_DIR]
    python3 compare.py c17 CHECKOUT [SASS_DIR]
    python3 compare.py c32 CHECKOUT [SASS_DIR]

CHECKOUT is the root of a checkout of this repository: this one, or an
older commit unpacked with `git archive` into a directory `.gitignore`
lists.  Its chip_smoke.py, port and kernels are imported and built from
there, so two commits are timed in turn in one run on one card (run them
as A, B, B, A).  The genome, index and reads are chip_smoke.py's default
cell, cached under the temp directory (chip_smoke.py run first makes them;
else this does).  Prints one JSON object.

c3: kernel C3 (the SA walk) on samse's SA rows.  Each strand's rows go to
the checkout's one-strand wrapper, `sa_lookup_cuda`, exact against its
plain version: the launch's time (CUDA events over 20 launches, and queued
behind a sleeping kernel), its longest row's steps and that row alone, its
time a step.  Where the checkout has `sa_lookup_both_cuda`, the two
strands in one launch too.

launch: the host's cost of a launch, on no cell.  The host split of kernel
C14's, C11's, C29's, C28's, C27's, C20's, C7's, C15's and C8's wrappers
(`launch_split` of this checkout's chip_smoke.py, run over the other
checkout's port: its own helpers and wrappers; a step whose helper it
lacks is null), and C11, C12 (unroll 1 and LOADS_UNROLL), C14 and C20 at
scripts/probe_pallas2.py's shapes, C29, C28 and C27 at
scripts/probe_pallas3.py's, C7 and C15 at scripts/probe_pallas.py's and
C8 at scripts/probe_dma.py's default (100,000 rows, N 128, T 64, `reg`,
unroll off: the serial kernel on a checkout before C8's grid form, the
grid form after), exact against their plain versions (C8's out, stage and
rounds), each with `ms` (CUDA events), `queued_ms` and `wall_ms` (the
host's clock) beside `x + 1`, torch.index_select, torch.sum,
torch.gather on axis 0 and on axis 1 (their int64 indices made
beforehand) and C28's, C27's, C7's, C15's and C8's torch.index_select
(their indices made beforehand; C8's the T N rows its copies read).

c9: kernel C9 (the DFS-step mock, scripts/probe_dfs_shape.py at S 128
and 200 iterations) at 256 and 2,048 reads, on no cell: each C9 wrapper
the checkout has (`run_cuda`; `run_witness_cuda`, the first design, where
it is kept beside the lean form) exact against the plain version, with
`ms` (CUDA events) and `queued_ms`; where it has `run_stamped_cuda`,
each form's stage split (this checkout's chip_smoke.py `stage_split`).
With SASS_DIR, the checkout's csrc/probe_dfs_shape.cu is built alone to a
cubin for sm_90a and its SASS written there (`cuobjdump -sass`), and each
kernel's instructions are counted, by opcode, in the JSON.

c23: kernel C23 (scripts/probe_spill.py at K 24, T 2000) at the script's
four shapes, on no cell: the checkout's `spill_cuda` and, where it is
kept, `spill_witness_cuda`, exact against the plain version on seeded
int32, with `ms` and `queued_ms` (queued in turns: witness, lane, lane,
witness); where `spill_cuda` takes `lanes`, its lane form at L 2, 4 and 8,
then at every K of SPILL_KS on [64, 128] (exact, queued), and the
ptxas report of its instantiations.  With SASS_DIR, the checkout's
csrc/probe_spill.cu is built alone and its SASS written and counted as
for c9, with the build's seconds.

c34: kernel C34 (probe 5 of scripts/probe_pallas3.py) at the script's
[256, 128], on no cell: `p5_cuda` and, where it is kept,
`p5_witness_cuda`, exact, with `ms` and `queued_ms` in turns; with
SASS_DIR, the SASS of its csrc/probe_pallas3.cu as for c9.

c17: kernels C17 and C18 (probes 4 and 4b of scripts/probe_pallas.py,
50 rounds over a [256, 128] pool) at the script's input, on no cell:
the checkout's `while_scratch_cuda` and `while_vector_cuda` and, where
they are kept, their witnesses, exact against the plain versions, with
`ms` and `queued_ms` in turns; where the witnesses are kept (the grid
forms take their warps a block), each grid form also at every block size
its entry takes (C17 16 and 32 warps, one cluster of 16 or 8 blocks; C18
1, 2, 4 and 8), a launch the card refuses recorded as its error, and the
four kernels' ptxas report.  With SASS_DIR, the SASS of its
csrc/probe_pallas.cu as for c9.

c32: kernels C32 and C35 (probes 2 `roll` and 6 of
scripts/probe_pallas3.py) at the script's shapes, on no cell: the
checkout's `p2_cuda(x, "roll")` and, where it is kept,
`p2_roll_witness_cuda`, exact against `p2_plain` on the script's input,
with `ms` and `queued_ms` in turns; where the witness is kept, the lane
form also at every block size its launcher takes (1, 2 and 4 warps); then
`p6_cuda` bit for bit against `p6_plain` on the script's x and a random
float32 w, with `ms` and `queued_ms` beside `torch.matmul(x.float(),
w)`'s; the ptxas report of both kernels of C32 and of C35.  With
SASS_DIR, the SASS of its csrc/probe_pallas3.cu as for c9, and the
instructions of C32's kernels and of C35's under "c32_sass".

The SASS's JSON gives, for each kernel, its instructions by opcode and
its loops: each backward branch with the instructions from its target
to it, the body a warp runs each time round.

aln: the `aln` engine's card-only route (`host_frac=0` where the checkout
has the hybrid split): a warm-up chunk of one slice, then 5 timed
`run_chunk`s of the 32768 reads at batch 2048, each `.sai` byte-identical
to the shared host engine's, whose rate is timed in the same process.
"""

import importlib.util
import inspect
import json
import pathlib
import sys
import time

BATCH = 2048
RUNS = 5


def time_c3(cs, idx, opt, reads):
    import numpy as np
    import torch
    from nabwa_tpu_torch.models import aln as maln
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.ops import sa_lookup as sl
    from nabwa_tpu_torch.utils.rand48 import Rand48
    eng = maln.AlnEngine(idx, opt, "cuda")
    sai, _ = cs.native_reference(idx, reads, opt)
    ch = msamse.select(reads, cs.sai_columns(sai), 3, Rand48(idx.bns.seed))
    ix = eng.dev
    out = {}
    rows = {}
    for a, _, _, r in msamse.sa_requests(ch):
        args = (ix.bwt_fwd if a else ix.bwt_rev, ix.l2,
                ix.primary_fwd if a else ix.primary_rev, ix.seq_len,
                ix.sa_fwd if a else ix.sa_rev, ix.sa_intv,
                torch.from_numpy(r.view(np.int32)).to(eng.device))
        rows[a] = args[6]
        cs.exact(f"C3 strand {a}", sl.sa_lookup_cuda(*args),
                 sl.sa_lookup_plain(*args))
        steps = sl.sa_walk_steps(*args[:4], args[5], args[6]) if hasattr(
            sl, "sa_walk_steps") else cs.walk_steps(*args[:4], args[5],
                                                     args[6])
        i = int(steps.argmax())
        lone = args[:6] + (args[6][i:i + 1],)
        lone_ms = cs.queued_ms(lambda: sl.sa_lookup_cuda(*lone), 20)
        out[f"strand{a}"] = {
            "rows": len(r), "max_steps": int(steps[i]),
            "ms": cs.cuda_ms(lambda: sl.sa_lookup_cuda(*args), 20),
            "queued_ms": cs.queued_ms(lambda: sl.sa_lookup_cuda(*args), 20),
            "lone_us_per_step": lone_ms * 1e3 / int(steps[i])}
    if hasattr(sl, "sa_lookup_both_cuda"):
        both = ((ix.bwt_rev, ix.bwt_fwd), ix.l2,
                (ix.primary_rev, ix.primary_fwd), ix.seq_len,
                (ix.sa_rev, ix.sa_fwd), ix.sa_intv,
                torch.cat([rows[0], rows[1]]), len(rows[0]))
        cs.exact("C3 both strands", sl.sa_lookup_both_cuda(*both),
                 sl.sa_lookup_both_plain(*both))
        out["both_ms"] = cs.cuda_ms(lambda: sl.sa_lookup_both_cuda(*both),
                                    20)
    return out


def time_aln(cs, idx, opt, reads):
    import torch
    from nabwa_tpu_torch.models import aln as maln
    want, host_s = cs.native_reference(idx, reads, opt)
    kw = ({"host_frac": 0} if "host_frac" in
          inspect.signature(maln.AlnEngine).parameters else {})
    eng = maln.AlnEngine(idx, opt, "cuda", **kw)
    eng.run_chunk(reads[:BATCH], device_batch=BATCH)
    eng.seconds = dict.fromkeys(eng.seconds, 0.0)
    rates = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run_chunk(reads, device_batch=BATCH)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if opt.pack() + cs.native_block(res) != want:
            cs.fail("the card-only .sai differs from the host native "
                    "engine's")
        rates.append(len(reads) / dt)
    return {"reads_per_sec": rates, "median": sorted(rates)[RUNS // 2],
            "host_native_reads_per_sec": len(reads) / host_s,
            "part_seconds": {k: v / RUNS for k, v in eng.seconds.items()}}


def own_smoke():
    """The chip_smoke.py beside this file: the other checkout's may lack
    `launch_split`."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", pathlib.Path(__file__).resolve().parent
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_launch():
    import numpy as np
    import torch
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_dma as pdma
    from nabwa_tpu_torch.probes import probe_pallas as pp
    from nabwa_tpu_torch.probes import probe_pallas2 as pp2
    from nabwa_tpu_torch.probes import probe_pallas3 as p3
    here = own_smoke()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(here.PROBE_SEED)
    idx_t, tab_t, x_t, x1_t = common.tensors(
        dev, rng.randint(0, pp2.NROW, (pp2.BB, 128)),
        rng.randint(0, 1 << 30, (pp2.NROW, 128)),
        rng.randint(0, 99, pp2.REDUCE_SHAPE),
        rng.randint(-2**31, 2**31, pp2.EMPTY_SHAPE))
    flat = idx_t[:, :2].t().reshape(-1).contiguous()
    nrow = p3.P1_TABLE[0]
    gx_t, gi_t, ri_t, rj_t, rt_t = common.tensors(
        dev, rng.randint(0, 99, p3.P3_X),
        rng.randint(0, p3.P3_X[0], p3.P3_I),
        rng.randint(0, nrow, (p3.P1_ROUNDS, 1)),
        rng.randint(0, nrow, (p3.P1_ROUNDS, 1)),
        rng.randint(0, 99, p3.P1_TABLE))
    pi_t, lx_t, li_t = common.tensors(
        dev, rng.randint(0, nrow, (p3.P1_ROUNDS, p3.P1_TABLE[1])),
        rng.randint(0, 99, (pp2.BB, pp2.GATHER_W)),
        rng.randint(0, pp2.GATHER_W, (pp2.BB, pp2.GATHER_W)))
    wi_t, wt_t = common.tensors(
        dev, rng.randint(0, pp.ROWLOAD_NROW, (pp.ROWLOAD_BB, 1)),
        rng.randint(0, 99, (pp.ROWLOAD_NROW, 128)))
    w_col, si_t = wi_t[:, 0], wi_t[:, 0].contiguous()
    gi_long, li_long = gi_t.long(), li_t.long()
    r_flat = torch.cat((ri_t[:, 0], rj_t[:, 0]))
    p_flat = pi_t[:, :2].t().reshape(-1).contiguous()
    d_rows, d_n, d_t = here.DMA_ROWS[0], 128, here.DMA_T
    d_tab = torch.arange(d_rows * 128, dtype=torch.int32,
                         device=dev).view(d_rows, 128)
    d_flat = pdma.copy_rows(d_n, d_t, d_rows, "reg")[0].reshape(-1).to(dev)
    calls = {
        "probe_empty": (lambda: pp2.empty_cuda(x1_t),
                        lambda: pp2.empty_plain(x1_t)),
        "x + 1": (lambda: x1_t + 1, None),
        "probe_loads": (lambda: pp2.loads_cuda(idx_t, tab_t, 1),
                        lambda: pp2.loads_plain(idx_t, tab_t)),
        "probe_loads_unrolled": (
            lambda: pp2.loads_cuda(idx_t, tab_t, pp2.LOADS_UNROLL),
            lambda: pp2.loads_plain(idx_t, tab_t)),
        "index_select": (lambda: torch.index_select(tab_t, 0, flat), None),
        "probe_lanereduce": (lambda: pp2.lanereduce_cuda(x_t),
                             lambda: pp2.lanereduce_plain(x_t)),
        "torch.sum": (lambda: torch.sum(x_t, dim=1, keepdim=True,
                                        dtype=torch.int32), None),
        "probe_p3": (lambda: p3.p3_cuda(gx_t, gi_t),
                     lambda: p3.p3_plain(gx_t, gi_t)),
        "torch.gather": (lambda: torch.gather(gx_t, 0, gi_long), None),
        "probe_p1b": (lambda: p3.p1b_cuda(ri_t, rj_t, rt_t),
                      lambda: p3.p1b_plain(ri_t, rj_t, rt_t)),
        "index_select_p1b": (lambda: torch.index_select(rt_t, 0, r_flat),
                             None),
        "probe_p1": (lambda: p3.p1_cuda(pi_t, rt_t),
                     lambda: p3.p1_plain(pi_t, rt_t)),
        "index_select_p1": (lambda: torch.index_select(rt_t, 0, p_flat),
                            None),
        "probe_lane_gather": (lambda: pp2.lane_gather_cuda(lx_t, li_t),
                              lambda: pp2.lane_gather_plain(lx_t, li_t)),
        "torch.gather_lanes": (lambda: torch.gather(lx_t, 1, li_long),
                               None),
        "probe_rowload": (lambda: pp.rowload_cuda(wi_t, wt_t),
                          lambda: pp.rowload_plain(wi_t, wt_t)),
        "index_select_rowload": (lambda: torch.index_select(wt_t, 0, w_col),
                                 None),
        "probe_smem_idx": (lambda: pp.smem_idx_cuda(si_t, wt_t),
                           lambda: pp.smem_idx_plain(si_t, wt_t)),
        "index_select_smem_idx": (lambda: torch.index_select(wt_t, 0, si_t),
                                  None),
        "probe_dma": (
            lambda: pdma.dma_cuda(d_tab, d_n, d_t, d_rows, "reg", False),
            lambda: pdma.dma_plain(d_tab, d_n, d_t, d_rows, "reg")),
        "index_select_dma": (lambda: torch.index_select(d_tab, 0, d_flat),
                             None)}
    out = {"split": here.launch_split(dev)}
    for name, (fn, plain) in calls.items():
        if plain is not None:
            for got, want in zip(here.as_tuple(fn()), here.as_tuple(plain())):
                here.exact(name, got, want)
        out[name] = {"ms": here.cuda_ms(fn, here.LAUNCH_REPS),
                     "queued_ms": here.queued_ms(fn, 200),
                     "wall_ms": here.wall_ms(fn, here.LAUNCH_REPS)}
    return out


def dump_sass(out_dir, stem="probe_dfs_shape"):
    """Build the checkout's csrc/<stem>.cu alone to a cubin for sm_90a,
    write its SASS into out_dir and return, for each kernel, its
    instruction count and the count of each opcode, and the build's wall
    seconds under "nvcc_seconds"."""
    import subprocess
    from nabwa_tpu_torch.ops import _build
    nvcc = _build._nvcc()
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tag = pathlib.Path(_build.CSRC).parents[1].name or "checkout"
    cubin = out / f"{tag}_{stem}.cubin"
    t0 = time.perf_counter()
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(_build.CSRC), "-o",
                    str(cubin), str(_build.CSRC / f"{stem}.cu")],
                   check=True, capture_output=True, text=True)
    nvcc_s = time.perf_counter() - t0
    sass = subprocess.run(
        [str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
        check=True, capture_output=True, text=True).stdout
    (out / f"{tag}_{stem}.sass").write_text(sass)
    return {**sass_counts(sass), "nvcc_seconds": nvcc_s}


def sass_counts(sass):
    """For each kernel of `cuobjdump -sass` text: its instruction count,
    the count of each opcode and its loops (`sass_loops`)."""
    import collections
    kernels, code, labels, name = {}, {}, {}, None
    for line in sass.splitlines():
        t = line.strip()
        if t.startswith("Function : "):
            name = t.split(":", 1)[1].strip()
            kernels[name] = collections.Counter()
            code[name], labels[name] = [], {}
            continue
        if name and t.startswith(".L") and t.endswith(":"):
            labels[name][t[:-1]] = len(code[name])
            continue
        # an instruction: /*addr*/ [@predicate] OPCODE.modifiers ...
        end = t.find("*/")
        addr = t[2:end] if t.startswith("/*") and end > 2 else ""
        if not name or not addr or addr.strip("0123456789abcdef"):
            continue
        words = t[end + 2:].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            kernels[name][words[0].split(".")[0].rstrip(";")] += 1
            code[name].append((int(addr, 16), words))
    return {k: {"instructions": sum(c.values()), "by_opcode": dict(c),
                "loops": sass_loops(code[k], labels[k])}
            for k, c in kernels.items()}


def sass_loops(code, labels):
    """The backward branches of one kernel's SASS (not a branch to itself,
    the end's trap), `code` its instructions in order as (address, words)
    and `labels` the index of each label's first instruction: [{"from",
    "to" (hex addresses), "instructions" from the target to the
    branch}]."""
    at = {a: i for i, (a, _) in enumerate(code)}
    loops = []
    for i, (a, words) in enumerate(code):
        if words[0].split(".")[0] != "BRA":
            continue
        # the target, the last operand before the `;` (a comment may follow)
        target = " ".join(words[1:]).split(";")[0].split(",")[-1]
        target = target.strip(" `()")
        j = (labels.get(target) if target.startswith(".L")
             else at.get(int(target, 16)) if target.startswith("0x")
             else None)
        if j is not None and j < i:
            loops.append({"from": hex(code[j][0]), "to": hex(a),
                          "instructions": i - j + 1})
    return loops


def time_c9(sass_dir=None):
    import numpy as np
    import torch
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_dfs_shape as pds
    here = own_smoke()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(here.PROBE_SEED)
    table = rng.randint(0, 1 << 30, (pds.NROW, 128))
    forms = {"run_cuda": pds.run_cuda}
    if hasattr(pds, "run_witness_cuda"):
        forms["run_witness_cuda"] = pds.run_witness_cuda
    s, iters = 128, 200
    out = {}
    for bb in (256, 2048):
        seed_t, tab_t = common.tensors(
            dev, rng.randint(0, 1 << 20, (bb, 128)), table)
        want = pds.run_plain(seed_t, tab_t, s, iters)
        res = {}
        for name, fn in forms.items():
            here.exact(f"C9 {name} BB={bb}", fn(seed_t, tab_t, s, iters),
                       want)
            res[name] = {
                "ms": here.cuda_ms(lambda: fn(seed_t, tab_t, s, iters), 20),
                "queued_ms": here.queued_ms(
                    lambda: fn(seed_t, tab_t, s, iters), 20)}
        if hasattr(pds, "run_stamped_cuda"):
            for lean in (False, True):
                acc, stages, cal = pds.run_stamped_cuda(seed_t, tab_t, s,
                                                        iters, lean)
                here.exact(f"C9 stamped lean={lean} BB={bb}", acc, want)
                res["split_" + ("lean" if lean else "witness")] = \
                    here.stage_split(stages, cal)
        out[str(bb)] = res
    out["nvidia_smi_clocks"] = here.sm_clocks()
    if sass_dir:
        out["sass"] = dump_sass(sass_dir)
    return out


def in_turns(forms, fn_of, reps):
    """{form: its two queued_ms readings} taken in turns: the first form,
    the others, the others again, the first (A, B, B, A for two)."""
    here = own_smoke()
    names = list(forms)
    order = names[:1] + names[1:] + names[1:][::-1] + names[:1]
    got = {name: [] for name in names}
    for name in order:
        got[name].append(here.queued_ms(fn_of(forms[name]), reps))
    return got


def time_c23(sass_dir=None):
    import inspect
    import numpy as np
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_spill as ps
    import torch
    here = own_smoke()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(here.PROBE_SEED + 1)
    forms = {}
    if hasattr(ps, "spill_witness_cuda"):
        forms["spill_witness_cuda"] = ps.spill_witness_cuda
    forms["spill_cuda"] = ps.spill_cuda
    lanes = "lanes" in inspect.signature(ps.spill_cuda).parameters
    k, t = ps.DEFAULT_K, ps.DEFAULT_T
    out = {"shapes": {}}
    for shape in ps.SHAPES:
        x_t, = common.tensors(dev, here.int32_mixed(rng, shape))
        want = ps.spill_plain(x_t, k, t)
        for name, fn in forms.items():
            here.exact(f"C23 {name} {shape}", fn(x_t, k, t), want)
        res = {name: {"ms": here.cuda_ms(lambda: fn(x_t, k, t), 20)}
               for name, fn in forms.items()}
        for name, q in in_turns(forms, lambda fn: lambda: fn(x_t, k, t),
                                20).items():
            res[name].update(queued_ms=sum(q) / 2, queued_ms_turns=q)
        if lanes:
            for n_lanes in (2, 4, 8):
                here.exact(f"C23 spill_cuda L={n_lanes} {shape}",
                           ps.spill_cuda(x_t, k, t, n_lanes), want)
                res[f"L={n_lanes}"] = {"queued_ms": here.queued_ms(
                    lambda: ps.spill_cuda(x_t, k, t, n_lanes), 20)}
        out["shapes"][str(shape)] = res
    if lanes:
        x_t, = common.tensors(dev, here.int32_mixed(rng, (64, 128)))
        out["k_sweep"] = {}
        for kk in ps.SPILL_KS:
            here.exact(f"C23 spill_cuda K={kk}", ps.spill_cuda(x_t, kk, t),
                       ps.spill_plain(x_t, kk, t))
            out["k_sweep"][str(kk)] = here.queued_ms(
                lambda: ps.spill_cuda(x_t, kk, t), 10)
        from nabwa_tpu_torch.ops import _build
        out["ptxas_lane"] = here.ptxas_report(
            _build.build_log, lambda name: int(
                name.split("probe_spill_lane_kernelILi")[1].split("E")[0])
            if "probe_spill_lane_kernelILi" in name else None)
    out["nvidia_smi_clocks"] = here.sm_clocks()
    if sass_dir:
        out["sass"] = dump_sass(sass_dir, "probe_spill")
    return out


def time_c34(sass_dir=None):
    import numpy as np
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_pallas3 as p3
    import torch
    here = own_smoke()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(here.PROBE_SEED + 2)
    forms = {}
    if hasattr(p3, "p5_witness_cuda"):
        forms["p5_witness_cuda"] = p3.p5_witness_cuda
    forms["p5_cuda"] = p3.p5_cuda
    x_t, = common.tensors(dev, rng.randint(0, 1 << 20, p3.P5_X))
    want = p3.p5_plain(x_t)
    res = {}
    for name, fn in forms.items():
        here.exact(f"C34 {name}", fn(x_t), want)
        res[name] = {"ms": here.cuda_ms(lambda: fn(x_t), 100)}
    for name, q in in_turns(forms, lambda fn: lambda: fn(x_t), 100).items():
        res[name].update(queued_ms=sum(q) / 2, queued_ms_turns=q)
    if sass_dir:
        res["sass"] = dump_sass(sass_dir, "probe_pallas3")
    return {"inner_rounds": sum(p3.p5_trips(int(x_t[0, 0]))), **res}


def time_c17(sass_dir=None):
    import numpy as np
    from nabwa_tpu_torch.ops import _build
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_pallas as pp
    import torch
    here = own_smoke()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(here.PROBE_SEED + 3)
    x_t, = common.tensors(dev, rng.randint(0, 1000,
                                           (pp.WHILE_BB, pp.WHILE_S)))
    kept = hasattr(pp, "while_scratch_witness_cuda")

    def at_warps(kern, warps):
        def launch(x):
            out = (x.new_empty(1, 1) if kern == "while_scratch"
                   else torch.empty_like(x))
            _build.check(getattr(_build.lib(), "nabwa_probe_" + kern)(
                x.data_ptr(), warps, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream), kern)
            return out
        return launch
    out = {}
    for kern, sizes in (("while_scratch", (16, 32)),
                        ("while_vector", (1, 2, 4, 8))):
        want = getattr(pp, kern + "_plain")(x_t)
        forms = {}
        if kept:
            forms[kern + "_witness_cuda"] = getattr(pp, kern + "_witness_cuda")
        forms[kern + "_cuda"] = getattr(pp, kern + "_cuda")
        res = {}
        for w in sizes if kept else ():
            fn = at_warps(kern, w)
            try:
                here.exact(f"{kern} at {w} warps a block", fn(x_t), want)
            except RuntimeError as err:
                res[f"warps={w}"] = {"error": str(err)}
                continue
            forms[f"warps={w}"] = fn
        for name, fn in forms.items():
            here.exact(f"{kern} {name}", fn(x_t), want)
            res[name] = {"ms": here.cuda_ms(lambda: fn(x_t), 200)}
        for name, q in in_turns(forms, lambda fn: lambda: fn(x_t),
                                200).items():
            res[name].update(queued_ms=sum(q) / 2, queued_ms_turns=q)
        if kept:
            res["ptxas"] = here.grid_witness_ptxas(_build.build_log,
                                                   "probe_" + kern)
        out[kern] = res
    out["nvidia_smi_clocks"] = here.sm_clocks()
    if sass_dir:
        out["sass"] = dump_sass(sass_dir, "probe_pallas")
    return out


def time_c32(sass_dir=None):
    import numpy as np
    from nabwa_tpu_torch.ops import _build
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_pallas3 as p3
    import torch
    here = own_smoke()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(here.PROBE_SEED + 4)
    x_t, = common.tensors(dev, rng.randint(0, 1 << 20, p3.P2_X))
    want = p3.p2_plain(x_t, "roll")
    forms = {}
    if hasattr(p3, "p2_roll_witness_cuda"):
        forms["p2_roll_witness_cuda"] = p3.p2_roll_witness_cuda
    forms["p2_cuda_roll"] = lambda x: p3.p2_cuda(x, "roll")
    c32 = {}
    for name, fn in forms.items():
        here.exact(f"C32 {name}", fn(x_t), want)
        c32[name] = {"ms": here.cuda_ms(lambda: fn(x_t), 200)}
    for name, q in in_turns(forms, lambda fn: lambda: fn(x_t), 200).items():
        c32[name].update(queued_ms=sum(q) / 2, queued_ms_turns=q)
    xi, = common.tensors(dev, rng.randint(0, 99, p3.P6_X))
    w_t = torch.from_numpy(rng.standard_normal(p3.P6_W).astype(
        np.float32)).to(dev)
    got, ref = p3.p6_cuda(xi, w_t), p3.p6_plain(xi, w_t)
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        here.fail("C35 p6_cuda differs from p6_plain in some bit")
    calls = {"p6_cuda": lambda: p3.p6_cuda(xi, w_t),
             "matmul": lambda: torch.matmul(xi.float(), w_t)}
    c35 = {name: {"ms": here.cuda_ms(fn, 200)} for name, fn in calls.items()}
    for name, q in in_turns(calls, lambda fn: fn, 200).items():
        c35[name].update(queued_ms=sum(q) / 2, queued_ms_turns=q)
    out = {"c32": c32, "c35": c35, "ptxas": here.ptxas_report(
        _build.build_log, lambda name: next(
            (k for k in ("p2_roll_kernel", "p2_row_kernelILi1E",
                         "p6_kernel") if "probe_" + k in name), None)),
        "nvidia_smi_clocks": here.sm_clocks()}
    if sass_dir:
        out["sass"] = dump_sass(sass_dir, "probe_pallas3")
        out["c32_sass"] = {k: v for k, v in out["sass"].items()
                           if "probe_p2_roll" in k or "probe_p6" in k
                           or "probe_p2_row_kernelILi1E" in k}
    return out


MODES = {"c3": time_c3, "aln": time_aln, "launch": time_launch,
         "c9": time_c9, "c23": time_c23, "c34": time_c34, "c17": time_c17,
         "c32": time_c32}


def main(argv):
    probe_modes = ("c9", "c23", "c34", "c17", "c32")
    if (len(argv) not in (2, 3) or argv[0] not in MODES
            or (len(argv) == 3 and argv[0] not in probe_modes)):
        print(f"usage: compare.py {{{','.join(MODES)}}} CHECKOUT "
              "(c9, c23, c34, c17, c32: [SASS_DIR])", file=sys.stderr)
        return 2
    mode, root = argv[:2]
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from nabwa_tpu_torch import cli as port_cli
    from nabwa_tpu_torch.index.fmindex import BwaIndex
    from nabwa_tpu_torch.ops import _build
    from nabwa_tpu_torch.options import GapOpt
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    _build.lib()
    out = {"mode": mode, "checkout": str(cs.ROOT), "card": cs.card_line()}
    if mode == "launch":
        out.update(time_launch())
    elif mode in probe_modes:
        out.update(MODES[mode](*argv[2:]))
    else:
        fa, fq, *_ = cs.make_data(64_000_000, 32768, 32768, 512)
        idx = BwaIndex.load(str(fa))
        opt = GapOpt()
        reads = port_cli.open_reads(str(fq), opt.mode)(32768, 0)
        out.update(MODES[mode](cs, idx, opt, reads))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
