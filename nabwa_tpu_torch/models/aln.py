"""The `aln` engine on PyTorch: the counterpart of `AlnEngine` in
nabwa_tpu/models/aln.py:69-750 (bwa_cal_sa_reg_gap / bwa_aln_core,
bwtaln.c:93-257).

Per reference chunk of reads:
  host:   per-read max_diff, batch max_gapo clamp, padding to [B, 2, L],
          seed-suffix extraction
  device: cal_width (both strands, read and seed suffix) -> DFS, one
          packed [B, 4H+5] result per batch
  tiers:  tier 0 (small stack, iteration cap), then a retry tier with the
          big stack for the reads tier 0 flagged, hardest first; reads
          flagged by both are solved by the shared host engine
          (native/dfsgap.cpp), which is the program's own overflow path,
          bit-exact with the device tiers.  Each tier's slices are
          pipelined: slice i+1 is launched before slice i is collected.
  hybrid: on a CUDA device, a chunk of 256 reads or more is split between
          the card and the host engine (`plan_device_share`, the JAX
          package's split): the card's share runs tier 0 on a helper
          thread while the host engine solves the rest on the other
          cores; the card share's overflow goes to the host engine.
  mesh:   with `mesh=` (`parallel/mesh.py`), every tier's batch is
          sharded over the mesh's devices, the index replicated on each.

The device is explicit: a CPU device runs the plain PyTorch versions, a
CUDA device the kernels.  Nothing moves between them.
"""

import concurrent.futures
import copy
import os
import threading
import time

import numpy as np
import torch

from ..constants import BWA_AVG_ERR
from ..index import native
from ..refmodel.aln_scalar import cal_maxdiff
from ..index.fmindex import DeviceIndex
from ..ops import _build
from ..ops.dfs import aln_device_step, unpack_result
from ..ops.sa_lookup import sa_lookup, sa_lookup_both
from ..parallel.mesh import on_device, per_device, shard_batch

NO_SEED = 0x7FFFFFFF
# The hybrid's knobs as the JAX package reads them
# (nabwa_tpu/models/aln.py:117-120, :320-327, :341-347)
HOST_FRAC_ENV = "NABWA_HOST_FRAC"
DEV_SHARE_ENV = "NABWA_DEV_SHARE"
FORCE_NATIVE_ENV = "NABWA_FORCE_NATIVE"
# the smallest chunk the hybrid splits (nabwa_tpu/models/aln.py:328)
HYBRID_MIN_READS = 256


def _maxdiff_table(fnr, max_len=1024):
    tab = np.zeros(max_len + 1, dtype=np.int32)
    for n in range(1, max_len + 1):
        tab[n] = cal_maxdiff(n, BWA_AVG_ERR, fnr)
    return tab


def _pack_seqs(reads, lens, L):
    """int32 [n, 2, L] of (seq, rseq) codes, padded with N (4).  A
    columnar ReadBatch is gathered by one native ragged copy, as
    `index.native.dfs_match_gap_native` does."""
    n = len(lens)
    seqs = np.full((n, 2, L), 4, dtype=np.uint8)
    if hasattr(reads, "code_bytes"):
        starts = np.repeat(
            np.ascontiguousarray(reads.seq_off[reads.lo:reads.hi]), 2)
        lens2 = np.repeat(np.asarray(lens, dtype=np.int64), 2)
        flags = np.tile(np.array([1, 3 if reads.is_comp else 1],
                                 dtype=np.uint8), n)
        out_off = np.arange(2 * n, dtype=np.int64) * L
        native.lib().gather_rows_u8(
            reads.codes_flat, starts, lens2, flags, 2 * n,
            seqs.reshape(-1), out_off, 0)
    else:
        for i, r in enumerate(reads):
            seqs[i, 0, :r.len] = r.seq
            seqs[i, 1, :r.len] = r.rseq
    return seqs.astype(np.int32)


def batch_options(opt, lens):
    """Per-read max_diff (int32 [n]) and the chunk's options with the batch
    max_gapo clamp (nabwa_tpu/models/aln.py:292-306, bwtaln.c:105)."""
    max_len = int(lens.max())
    local = copy.copy(opt)
    if opt.fnr > 0.0:
        maxdiff = _maxdiff_table(opt.fnr, max(max_len, 64))[lens]
        local.max_diff = cal_maxdiff(max_len, BWA_AVG_ERR, opt.fnr)
    else:
        maxdiff = np.full(len(lens), opt.max_diff, dtype=np.int32)
    if local.max_diff < local.max_gapo:
        local.max_gapo = local.max_diff
    return maxdiff, local


def per_read_groups(opt, lens):
    """bam2bam's per-record options (nabwa_tpu/models/aln.py:470-508,
    bam2bam.c:616,676): each read's max_diff (int32 [n]), and the reads
    grouped by their own clamped max_gapo (bwtaln.c:105 per read), as
    [(options, read indices)] in order of first appearance; a group's
    options carry its clamp and its largest max_diff."""
    if opt.fnr > 0.0:
        maxdiff = _maxdiff_table(opt.fnr, max(int(lens.max()), 64))[lens]
        mg = np.minimum(opt.max_gapo, maxdiff)
    else:
        maxdiff = np.full(len(lens), opt.max_diff, dtype=np.int32)
        mg = np.full(len(lens), min(opt.max_gapo, opt.max_diff))
    groups = []
    for g in dict.fromkeys(mg.tolist()):
        idxs = np.nonzero(mg == g)[0]
        local = copy.copy(opt)
        local.max_gapo = int(g)
        local.max_diff = int(maxdiff[idxs].max())
        groups.append((local, idxs))
    return maxdiff, groups


def batch_inputs(reads, lens, maxdiff, local, max_len, device):
    """One batch's inputs of `aln_device_step` as int32 tensors on `device`
    (nabwa_tpu/models/aln.py:616-648): the codes padded with N to [n, 2, L],
    L the chunk's max_len rounded up to 32, and each read's last seed_len
    bases (bwtaln.c:127-130)."""
    B = len(lens)
    L = max(32, -(-max_len // 32) * 32)
    seqs = _pack_seqs(reads, lens, L)
    lengths = np.asarray(lens, dtype=np.int32)
    seeded = local.seed_len < NO_SEED
    SL = max(min(local.seed_len, L) if seeded else L, 1)
    has_seed = (lengths > local.seed_len if seeded
                else np.zeros(B, dtype=bool))
    seed_starts = np.maximum(lengths - (local.seed_len if seeded else 0), 0)
    gi = np.minimum(seed_starts[:, None] + np.arange(SL), L - 1)
    sseq = np.stack([np.take_along_axis(seqs[:, 0, :], gi, 1),
                     np.take_along_axis(seqs[:, 1, :], gi, 1)], axis=1)
    slen = np.where(has_seed, min(local.seed_len, SL), 0)

    def put(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return dict(seqs=put(seqs), lengths=put(lengths), seed_seqs=put(sseq),
                seed_lengths=put(slen), has_seed=put(has_seed),
                max_diff=put(maxdiff))


def dfs_statics(local, stack_cap, hits_cap, max_iters):
    """The DFS's static arguments for one tier."""
    return dict(
        s_mm=local.s_mm, s_gapo=local.s_gapo, s_gape=local.s_gape,
        max_gape=local.max_gape, max_gapo=local.max_gapo,
        indel_end_skip=local.indel_end_skip, max_del_occ=local.max_del_occ,
        max_entries=local.max_entries, max_top2=local.max_top2,
        max_seed_diff=local.max_seed_diff, seed_len=local.seed_len,
        mode=local.mode, stack_cap=stack_cap, hits_cap=hits_cap,
        max_iters=max_iters)


def plan_device_share(n_reads, device_batch, dev_rate, host_rate,
                      n_cores, dev_lat):
    """The hybrid split policy, a copy of
    nabwa_tpu/models/aln.py:39-65, as a pure function so tests can pin its
    routing decisions (a kernel regression must not silently re-route all
    work to the host and fake a win).

    Returns n_dev, the number of reads handed to the device this chunk.

    - proportional split from the two rate EMAs, rounded to whole
      device_batch slices;
    - opportunity-cost check: driving the device costs ~one host core of
      runtime/transfer work, so the device share must out-produce the
      per-core host rate it displaces;
    - latency guard: a device share also pays a fixed per-chunk cost
      (dispatch + result round trips); shed slices until the predicted
      device window fits inside the host drain window."""
    n_dev = int(n_reads * dev_rate / (dev_rate + host_rate))
    n_dev = (n_dev // device_batch) * device_batch
    n_dev = min(n_dev, n_reads)
    per_core = host_rate / max(n_cores, 1)
    if dev_rate < 1.1 * per_core:
        n_dev = 0
    while n_dev and (dev_lat + n_dev / dev_rate) > \
            1.1 * (n_reads - n_dev) / host_rate:
        n_dev -= device_batch
    return n_dev


def update_rates(dev_rate, host_rate, n_dev=0, dev_seconds=0.0, n_host=0,
                 host_seconds=0.0, dev_warmed=True):
    """The rate EMAs after one chunk, as a pure function: the counterpart
    of the hybrid's EMAs (nabwa_tpu/models/aln.py:373-386) and the
    device-only seed (:415-427).  Returns the new (dev_rate, host_rate).

    dev_rate, host_rate: the measured EMAs so far, None before the first
    measurement.  A chunk's rate is its reads over its window; the first
    measurement is taken as it is, each later one averaged in 0.5 / 0.5.
    n_dev reads took the device route dev_seconds: the route's own
    window, from the first slice's preparation to the last slice's
    collection on the thread that drives the card.  (The JAX package
    times dispatch to the last collect on the thread that also ran the
    host drain, and keeps it only when the collect outlived the drain by
    10 % of that window; here that window would hold the host drain and
    the collect after it, and the card's rate would fall every chunk.)
    n_host reads took the host engine host_seconds, the drain's exact
    window.  dev_warmed False marks the engine's first device window,
    device-only or hybrid, which never enters the EMA (its first launches
    pay the kernels' first load on the card)."""
    if n_dev and dev_warmed:
        r = n_dev / max(dev_seconds, 1e-9)
        dev_rate = r if dev_rate is None else 0.5 * dev_rate + 0.5 * r
    if n_host:
        r = n_host / max(host_seconds, 1e-9)
        host_rate = r if host_rate is None else 0.5 * host_rate + 0.5 * r
    return dev_rate, host_rate


def hybrid_route(n_reads, device_type, mesh, host_frac):
    """Whether a batch chunk takes the hybrid split: the JAX package's
    gate (nabwa_tpu/models/aln.py:328-330) with the accelerator test
    `jax.default_backend() == "tpu"` read as a CUDA device."""
    return (mesh is None and n_reads >= HYBRID_MIN_READS
            and device_type == "cuda" and host_frac > 0.0)


def force_native():
    """NABWA_FORCE_NATIVE: the operator's choice of the host engine for
    every read and SA row (nabwa_tpu/models/aln.py:320-327, :483-489,
    :524-534)."""
    return bool(os.environ.get(FORCE_NATIVE_ENV))


def dev_share_override(n_reads, device_batch):
    """NABWA_DEV_SHARE pins the device share to a fraction of the chunk,
    in whole slices (nabwa_tpu/models/aln.py:341-347); None when unset."""
    env = os.environ.get(DEV_SHARE_ENV)
    if not env:
        return None
    return min(n_reads,
               (int(float(env) * n_reads) // device_batch) * device_batch)


class AlnEngine:
    """The FM-index on one torch device (or replicated over a mesh) plus
    the tiered DFS and the hybrid split.

    Attributes the shared workflow modules (samse, sampe, bam2bam) use:
    `index`, `opt`, `device`, `native_threads`, `run_chunk`, `sa_rows`,
    `sa_rows_both`.  Counters of where reads finished: `tier0_reads`,
    `retry_reads`, `host_drain_reads` (the device tiers' overflow) and
    `hybrid_host_reads` (reads the route choice gave the host engine: the
    hybrid's host share, per-read groups the measured rates send there);
    host seconds per part of `run_chunk` in `seconds` (prepare: padding
    and copies to the device; device: cal_width + DFS and the copy back;
    collect: packed result to hit tuples; drain: the host engine on the
    overflow; hybrid_device and hybrid_host: the hybrid's two routes'
    windows, which overlap).  The rate EMAs of the split are `dev_rate`
    and `host_rate` (reads/s, None until measured).  The counters,
    `seconds` and the EMAs change only under the engine's lock, so worker
    threads may share one engine."""

    # The split's fixed per-chunk device cost (s) and its starting rates
    # (reads/s) before the first measurement, measured on the H100 host by
    # chip_smoke.py phase 4, which prints its new readings beside these
    # (NVIDIA H100 80GB HBM3 at 700.00 W, 8 host cores): DEV_LAT is the
    # device route's seconds on a chunk of one slice of 64 reads; the
    # starting rates are the card-only route's tier-0 rate and the host
    # engine's rate on every core, on the bench reads (64 Mbp genome,
    # 32768 x 100 bp).
    DEV_LAT = 0.0024
    DEV_RATE0 = 81_884.9
    HOST_RATE0 = 40_060.1

    def __init__(self, index, opt, device=None, stack_cap=256, hits_cap=32,
                 retry_stack_cap=1024, retry_hits_cap=128,
                 max_iters=2_000_000, tier0_max_iters=768, mesh=None,
                 host_frac="auto"):
        """tier0_max_iters caps the first tier per read, so one hard read
        is retried with the big stack instead of holding its batch; the
        retry tier runs to max_iters.

        mesh: a `parallel.mesh.make_mesh` tuple of devices.  The index is
        replicated on each distinct device and every tier's batch is
        sharded over the mesh; the engine's own device (SA rows, the DP
        steps of the workflows) is mesh[0].  The hybrid is off under a
        mesh, as in the JAX package.

        host_frac: the hybrid's switch (0 turns it off; "auto" is 0.5, as
        the JAX package's; NABWA_HOST_FRAC overrides the argument)."""
        self.index = index
        self.opt = opt
        self.mesh = None if mesh is None else tuple(
            torch.device(d) for d in mesh)
        if device is None:
            device = self.mesh[0] if self.mesh else "cuda"
        self.device = torch.device(device)
        if self.mesh and self.mesh[0] != self.device:
            raise ValueError(f"device {self.device} is not the mesh's first "
                             f"device {self.mesh[0]}")
        env = os.environ.get(HOST_FRAC_ENV)
        if env is not None:
            host_frac = float(env)
        self.host_frac = 0.5 if host_frac == "auto" else float(host_frac)
        self.stack_cap = stack_cap
        self.hits_cap = hits_cap
        self.retry_stack_cap = retry_stack_cap
        self.retry_hits_cap = retry_hits_cap
        self.max_iters = max_iters
        self.tier0_max_iters = tier0_max_iters
        self.native_threads = 0
        self.tier0_reads = 0
        self.retry_reads = 0
        self.host_drain_reads = 0
        self.hybrid_host_reads = 0
        self.seconds = dict.fromkeys(("prepare", "device", "collect",
                                      "drain", "hybrid_device",
                                      "hybrid_host"), 0.0)
        self.dev_rate = None
        self.host_rate = None
        self._dev_warmed = False
        self._lock = threading.Lock()
        # one DeviceIndex per distinct device of the mesh
        self._ix = per_device(self.mesh or (self.device,),
                              lambda d: DeviceIndex.from_host(index, d))
        self.dev = self._ix[self.device]
        if any(d.type == "cuda" for d in self._ix):
            # build and load both engines' libraries now, so that no
            # route's first window holds an nvcc or g++ run
            _build.lib()
            native.lib()
        # host uint32 views for the native engine
        self._host_fwd = np.ascontiguousarray(index.fwd.bwt, dtype=np.uint32)
        self._host_rev = np.ascontiguousarray(index.rev.bwt, dtype=np.uint32)
        self._host_l2 = np.ascontiguousarray(index.fwd.l2, dtype=np.uint32)

    def run_chunk(self, reads, device_batch=2048, per_read_semantics=False,
                  host_reference=False):
        """Align one reference chunk of reads (list[Read] or ReadBatch);
        returns a list of (alns, max_entries) in read order.
        per_read_semantics: bam2bam's per-record options (see
        `per_read_groups`), each group through the same tiers, or through
        the host engine when the measured card rate is under 1.1x one
        core's host rate (nabwa_tpu/models/aln.py:479-489).
        host_reference: every read on the shared host engine instead of the
        device tiers (the reference the card's output is held against;
        NABWA_FORCE_NATIVE chooses it too, without a mesh).
        A batch chunk on a CUDA device takes the hybrid split
        (`hybrid_route`, `run_hybrid`)."""
        if not len(reads):
            return []
        reads, lens = _with_lens(reads)
        n = len(lens)
        host_reference = host_reference or (self.mesh is None
                                            and force_native())
        if per_read_semantics:
            maxdiff, groups = per_read_groups(self.opt, lens)
            to_host = not host_reference and self._groups_to_host()
        else:
            if not host_reference and hybrid_route(
                    n, self.device.type, self.mesh, self.host_frac):
                return self.run_hybrid(reads, device_batch)
            maxdiff, local = batch_options(self.opt, lens)
            groups = [(local, np.arange(n))]
            to_host = False
        results = [None] * n
        for local, idxs in groups:
            whole = len(idxs) == n
            sub = reads if whole else [reads[int(i)] for i in idxs]
            sub_lens = lens if whole else lens[idxs]
            sub_res = results if whole else [None] * len(idxs)
            if host_reference or to_host:
                t0 = time.perf_counter()
                self._drain_native(sub, maxdiff[idxs], local, sub_res,
                                   range(len(idxs)))
                self._book("drain", time.perf_counter() - t0,
                           hybrid_host_reads=len(idxs) if to_host else 0)
            else:
                tier0_s = self._run_tiers(sub, sub_lens, maxdiff[idxs],
                                          local, sub_res, device_batch)
                if not per_read_semantics and self._measures():
                    # the clean device-only rate seeds the split; the
                    # engine's first device-only chunk stays out of it
                    with self._lock:
                        self.dev_rate, _ = update_rates(
                            self.dev_rate, None, n, tier0_s,
                            dev_warmed=self._dev_warmed)
                        self._dev_warmed = True
            if not whole:
                for i, res in zip(idxs.tolist(), sub_res):
                    results[i] = res
        return results

    def run_hybrid(self, reads, device_batch=2048, n_dev=None):
        """The hybrid split of one batch chunk (nabwa_tpu/models/aln.py
        :305-387): the first n_dev reads (`plan_device_share` from the
        rate EMAs, or NABWA_DEV_SHARE, unless given) run tier 0 on the
        engine's device, slice by slice and pipelined, on a helper thread;
        meanwhile this thread runs the rest through the host engine on
        all cores but one.  The device share's overflow then goes to the
        host engine, with no retry tier.  The windows of both routes
        update the rate EMAs (`update_rates`), but for the engine's first
        device window.  `run_chunk` takes this route on a CUDA device;
        called directly it runs on any device."""
        if not len(reads):
            return []
        if self.mesh is not None:
            raise ValueError("the hybrid split does not run on a mesh")
        reads, lens = _with_lens(reads)
        n = len(lens)
        maxdiff, local = batch_options(self.opt, lens)
        if n_dev is None:
            n_dev = dev_share_override(n, device_batch)
        if n_dev is None:
            n_dev = plan_device_share(
                n, device_batch,
                self.dev_rate if self.dev_rate else self.DEV_RATE0,
                self.host_rate if self.host_rate else self.HOST_RATE0,
                os.cpu_count() or 1, self.DEV_LAT)
        n_dev = max(0, min(int(n_dev), n))
        results = [None] * n
        max_len = int(lens.max())
        tier0 = self._tier(0)
        host_threads = max(1, (self.native_threads or os.cpu_count() or 1)
                           - 1)

        def device_route():
            t0 = time.perf_counter()
            with on_device(self.device):
                flagged = self._device_pass(
                    reads[:n_dev], lens[:n_dev], maxdiff[:n_dev], local,
                    max_len, tier0, results, np.arange(n_dev), device_batch)
            return flagged, time.perf_counter() - t0

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            card = pool.submit(device_route) if n_dev else None
            t0 = time.perf_counter()
            if n_dev < n:
                self._drain_native(reads[n_dev:], maxdiff[n_dev:], local,
                                   results, range(n_dev, n),
                                   n_threads=host_threads)
            host_s = time.perf_counter() - t0
            flagged, dev_s = card.result() if card else ([], 0.0)
        ovf = [i for i, _ in flagged]
        if ovf:
            t0 = time.perf_counter()
            self._drain_native([reads[i] for i in ovf], maxdiff[ovf], local,
                               results, ovf)
            self._book("drain", time.perf_counter() - t0,
                       host_drain_reads=len(ovf))
        self._book("hybrid_device", dev_s, tier0_reads=n_dev - len(ovf),
                   hybrid_host_reads=n - n_dev)
        self._book("hybrid_host", host_s if n_dev < n else 0.0)
        with self._lock:
            self.dev_rate, self.host_rate = update_rates(
                self.dev_rate, self.host_rate, n_dev, dev_s, n - n_dev,
                host_s, dev_warmed=self._dev_warmed)
            self._dev_warmed = self._dev_warmed or n_dev > 0
        return results

    def _measures(self):
        """Device-only chunks seed the split's rate where the hybrid can
        run: on a CUDA device without a mesh."""
        return self.mesh is None and self.device.type == "cuda"

    def _groups_to_host(self):
        """The per-read route choice (nabwa_tpu/models/aln.py:479-489): on
        a CUDA device without a mesh, groups go to the host engine once
        both rates are measured and the card's is under 1.1x one core's
        host rate.  On the CPU device the plain tiers run."""
        return (self._measures() and self.dev_rate is not None
                and self.host_rate is not None
                and self.dev_rate < 1.1 * self.host_rate
                / max(os.cpu_count() or 1, 1))

    def _tier(self, k):
        """(stack_cap, hits_cap, max_iters) of tier 0 or the retry tier."""
        if k == 0:
            retry = self.retry_stack_cap > self.stack_cap
            return (self.stack_cap, self.hits_cap,
                    self.tier0_max_iters if retry else self.max_iters)
        return self.retry_stack_cap, self.retry_hits_cap, self.max_iters

    def _run_tiers(self, reads, lens, maxdiff, local, results, device_batch):
        """Tier 0, the retry tier for the reads tier 0 flagged (hardest
        first), then the host drain, for reads sharing one set of
        options.  Returns tier 0's seconds."""
        n = len(lens)
        max_len = int(lens.max())
        retry = self.retry_stack_cap > self.stack_cap
        t0 = time.perf_counter()
        defer = self._device_pass(reads, lens, maxdiff, local, max_len,
                                  self._tier(0), results, np.arange(n),
                                  device_batch)
        tier0_s = time.perf_counter() - t0
        self._book(tier0_reads=n - len(defer))

        drain = [i for i, _ in defer]
        if defer and retry:
            # hardest first by tier-0 high-water (nabwa_tpu/models/aln.py
            # :436-467)
            defer.sort(key=lambda t: -t[1])
            idxs = np.array([i for i, _ in defer], dtype=np.int64)
            sub = [reads[int(i)] for i in idxs]
            flagged = self._device_pass(sub, lens[idxs], maxdiff[idxs],
                                        local, max_len, self._tier(1),
                                        results, idxs, device_batch)
            drain = [int(idxs[j]) for j, _ in flagged]
            self._book(retry_reads=len(idxs) - len(drain))
        if drain:
            t0 = time.perf_counter()
            self._drain_native([reads[i] for i in drain], maxdiff[drain],
                               local, results, drain)
            self._book("drain", time.perf_counter() - t0,
                       host_drain_reads=len(drain))
        return tier0_s

    def _device_pass(self, reads, lens, maxdiff, local, max_len, tier,
                     results, dst, device_batch):
        """One tier over `reads` in slices of device_batch, pipelined:
        slice i+1 is launched before slice i is collected.  results[dst[j]]
        gets read j's hits.  Returns the reads the tier flagged, as [(j,
        tier high-water)]."""
        stack_cap, hits_cap, max_iters = tier
        flagged = []
        pending = None
        for start in range(0, len(lens), device_batch):
            stop = min(start + device_batch, len(lens))
            launched = self._launch(reads[start:stop], lens[start:stop],
                                    maxdiff[start:stop], local, max_len,
                                    stack_cap, hits_cap, max_iters)
            if pending is not None:
                flagged += self._finish(*pending, hits_cap, results, dst)
            pending = (launched, start, stop)
        if pending is not None:
            flagged += self._finish(*pending, hits_cap, results, dst)
        return flagged

    def _launch(self, reads, lens, maxdiff, local, max_len, stack_cap,
                hits_cap, max_iters):
        """Pad one batch and launch cal_width + DFS on each device of the
        mesh (the engine's one device without a mesh), each shard's packed
        result queued for the copy to the host.  Returns the shards'
        [(host tensor, event or None)]."""
        t0 = time.perf_counter()
        mesh = self.mesh or (self.device,)
        inputs = batch_inputs(reads, lens, maxdiff, local, max_len,
                              "cpu" if self.mesh else self.device)
        t1 = time.perf_counter()
        statics = dfs_statics(local, stack_cap, hits_cap, max_iters)
        out = []
        for d, shard in zip(mesh, shard_batch(mesh, inputs)):
            if not len(shard["lengths"]):
                continue
            ix = self._ix[d]
            with on_device(d):
                packed = aln_device_step(
                    ix.bwt_cat, ix.bwt_fwd, ix.bwt_rev, ix.rev_word_offset,
                    ix.primary_fwd, ix.primary_rev, ix.l2, ix.seq_len,
                    **shard, **statics)
                out.append(_to_host(packed))
        self._book("prepare", t1 - t0)
        self._book("device", time.perf_counter() - t1)
        return out

    def _finish(self, launched, start, stop, hits_cap, results, dst):
        """Wait for a launched batch's copies, join its shards in read
        order and collect them; returns its flagged reads as [(j, hw)]."""
        t0 = time.perf_counter()
        for _, event in launched:
            if event is not None:
                event.synchronize()
        packed = np.concatenate([t.numpy() for t, _ in launched])
        self._book("device", time.perf_counter() - t0)
        fb, hw = self._collect(packed, hits_cap, results, dst[start:stop])
        return [(start + i, int(hw[i])) for i in fb]

    def _book(self, part=None, dt=0.0, **counts):
        """Add host seconds to a part and reads to the tier counters, under
        the engine's lock: bam2bam's worker threads share one engine."""
        with self._lock:
            if part is not None:
                self.seconds[part] += dt
            for name, v in counts.items():
                setattr(self, name, getattr(self, name) + v)

    def sa_rows(self, a, rows):
        """Batched bwt_sa (bwt.c:72-81) on strand-a's index through
        `ops.sa_lookup` on the engine's device (kernel C3 on CUDA; the
        native host walk under NABWA_FORCE_NATIVE): uint32 rows -> raw
        uint32 bwt_sa values (callers apply the reverse-index coordinate
        flip)."""
        rows = np.ascontiguousarray(rows, dtype=np.uint32)
        if len(rows) == 0:
            return np.zeros(0, dtype=np.uint32)
        if force_native():
            from .samse import sa_rows_native
            return sa_rows_native(self.index, a, rows)
        ix = self.dev
        k = torch.from_numpy(rows.view(np.int32)).to(self.device)
        out = sa_lookup(ix.bwt_fwd if a else ix.bwt_rev, ix.l2,
                        ix.primary_fwd if a else ix.primary_rev, ix.seq_len,
                        ix.sa_fwd if a else ix.sa_rev, ix.sa_intv, k)
        return out.cpu().numpy().view(np.uint32)

    def sa_rows_both(self, rows):
        """`sa_rows` for both strands in one call (one C3 launch on CUDA):
        rows[a] are strand a's uint32 rows; returns their raw values, a
        pair indexed the same way."""
        rows = [np.ascontiguousarray(r, dtype=np.uint32) for r in rows]
        if force_native():
            from .samse import sa_rows_both_native
            return sa_rows_both_native(self.index, rows)
        n0 = len(rows[0])
        ix = self.dev
        k = torch.from_numpy(np.concatenate(rows).view(np.int32)).to(
            self.device)
        out = sa_lookup_both((ix.bwt_rev, ix.bwt_fwd), ix.l2,
                             (ix.primary_rev, ix.primary_fwd), ix.seq_len,
                             (ix.sa_rev, ix.sa_fwd), ix.sa_intv, k, n0)
        vals = out.cpu().numpy().view(np.uint32)
        return [vals[:n0], vals[n0:]]

    def _drain_native(self, reads, maxdiff, local, results, idxs,
                      n_threads=None):
        """Solve reads on the host's threaded C++ DFS (native/dfsgap.cpp),
        bit-exact with the device tiers, on n_threads threads
        (`native_threads` unless given; 0 is every core)."""
        lo = copy.copy(local)
        lo.seed_len = self.opt.seed_len
        ix = self.dev
        out = native.dfs_match_gap_native(
            self._host_fwd, ix.primary_fwd, self._host_rev, ix.primary_rev,
            self._host_l2, ix.seq_len, reads,
            np.asarray(maxdiff, dtype=np.int32), lo,
            n_threads=self.native_threads if n_threads is None
            else n_threads)
        for i, res in zip(idxs, out):
            results[i] = res

    def _collect(self, packed, hits_cap, results, idxs):
        """Fill results[idxs[i]] from a packed batch result; returns the
        overflow row list and the hw column.  k/l are uint32 bit patterns
        (nabwa_tpu/models/aln.py:585-613)."""
        t0 = time.perf_counter()
        out = unpack_result(packed, hits_cap)
        meta = out["hit_meta"].view(np.uint32).astype(np.int64)
        nmm_l = (meta & 0xFF).tolist()
        ngo_l = ((meta >> 8) & 0xFF).tolist()
        nge_l = ((meta >> 16) & 0xFF).tolist()
        a_l = ((meta >> 24) & 1).tolist()
        k_l = out["hit_k"].view(np.uint32).astype(np.int64).tolist()
        l_l = out["hit_l"].view(np.uint32).astype(np.int64).tolist()
        sc_l = out["hit_score"].astype(np.int64).tolist()
        na_l = out["n_aln"].tolist()
        hw = out["hw"]
        hw_l = hw.tolist()
        overflow = out["overflow"]
        fallback = []
        for i, dst in enumerate(idxs):
            if overflow[i]:
                fallback.append(i)
                continue
            na = na_l[i]
            results[dst] = (list(zip(nmm_l[i][:na], ngo_l[i][:na],
                                     nge_l[i][:na], a_l[i][:na],
                                     k_l[i][:na], l_l[i][:na],
                                     sc_l[i][:na])), hw_l[i])
        self._book("collect", time.perf_counter() - t0)
        return fallback, hw


def _with_lens(reads):
    """(reads, int32 clip lengths): a ReadBatch as it is, anything else as
    a list of Read objects."""
    if hasattr(reads, "clip_lens"):
        return reads, reads.clip_lens().astype(np.int32)
    reads = list(reads)
    return reads, np.array([r.len for r in reads], dtype=np.int32)


def _to_host(packed):
    """Queue a packed result's copy to the host: (tensor, event).  On the
    card the copy lands in pinned memory behind the launch and the event
    marks its end; a CPU tensor is returned as it is."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event
