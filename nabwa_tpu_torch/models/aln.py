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
          bit-exact with the device tiers.

The device is explicit: a CPU device runs the plain PyTorch versions, a
CUDA device the kernels.  Nothing moves between them.
"""

import copy
import threading
import time

import numpy as np
import torch

from ..constants import BWA_AVG_ERR
from ..index import native
from ..refmodel.aln_scalar import cal_maxdiff
from ..index.fmindex import DeviceIndex
from ..ops.dfs import aln_device_step, unpack_result
from ..ops.sa_lookup import sa_lookup, sa_lookup_both

NO_SEED = 0x7FFFFFFF


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


class AlnEngine:
    """The FM-index on one torch device plus the tiered DFS.

    Attributes the shared workflow modules (samse, sampe, bam2bam) use:
    `index`, `opt`, `native_threads`, `run_chunk`, `sa_rows`,
    `sa_rows_both`.  Counters of where reads finished: `tier0_reads`,
    `retry_reads`, `host_drain_reads`; host seconds per part of
    `run_chunk` in `seconds` (prepare: padding and copies to the device;
    device: cal_width + DFS and the copy back; collect: packed result to
    hit tuples; drain: the host engine).  The counters and `seconds`
    change only under the engine's lock, so worker threads may share one
    engine."""

    def __init__(self, index, opt, device, stack_cap=256, hits_cap=32,
                 retry_stack_cap=1024, retry_hits_cap=128,
                 max_iters=2_000_000, tier0_max_iters=768):
        """tier0_max_iters caps the first tier per read, so one hard read
        is retried with the big stack instead of holding its batch; the
        retry tier runs to max_iters."""
        self.index = index
        self.opt = opt
        self.device = torch.device(device)
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
        self.seconds = dict.fromkeys(("prepare", "device", "collect",
                                      "drain"), 0.0)
        self._lock = threading.Lock()
        self.dev = DeviceIndex.from_host(index, self.device)
        # host uint32 views for the native engine
        self._host_fwd = np.ascontiguousarray(index.fwd.bwt, dtype=np.uint32)
        self._host_rev = np.ascontiguousarray(index.rev.bwt, dtype=np.uint32)
        self._host_l2 = np.ascontiguousarray(index.fwd.l2, dtype=np.uint32)

    def run_chunk(self, reads, device_batch=2048, per_read_semantics=False,
                  host_reference=False):
        """Align one reference chunk of reads (list[Read] or ReadBatch);
        returns a list of (alns, max_entries) in read order.
        per_read_semantics: bam2bam's per-record options (see
        `per_read_groups`), each group through the same tiers.
        host_reference: every read on the shared host engine instead of the
        device tiers (the reference the card's output is held against)."""
        if not len(reads):
            return []
        if hasattr(reads, "clip_lens"):
            lens = reads.clip_lens().astype(np.int32)
        else:
            reads = list(reads)
            lens = np.array([r.len for r in reads], dtype=np.int32)
        n = len(lens)
        if per_read_semantics:
            maxdiff, groups = per_read_groups(self.opt, lens)
        else:
            maxdiff, local = batch_options(self.opt, lens)
            groups = [(local, np.arange(n))]
        results = [None] * n
        for local, idxs in groups:
            whole = len(idxs) == n
            sub = reads if whole else [reads[int(i)] for i in idxs]
            sub_lens = lens if whole else lens[idxs]
            sub_res = results if whole else [None] * len(idxs)
            if host_reference:
                t0 = time.perf_counter()
                self._drain_native(sub, maxdiff[idxs], local, sub_res,
                                   range(len(idxs)))
                self._book("drain", time.perf_counter() - t0)
            else:
                self._run_tiers(sub, sub_lens, maxdiff[idxs], local,
                                sub_res, device_batch)
            if not whole:
                for i, res in zip(idxs.tolist(), sub_res):
                    results[i] = res
        return results

    def _run_tiers(self, reads, lens, maxdiff, local, results, device_batch):
        """Tier 0, the retry tier for the reads tier 0 flagged (hardest
        first), then the host drain, for reads sharing one set of
        options."""
        n = len(lens)
        max_len = int(lens.max())
        retry = self.retry_stack_cap > self.stack_cap
        defer = []
        for start in range(0, n, device_batch):
            stop = min(start + device_batch, n)
            packed = self._run_device(
                reads[start:stop], lens[start:stop], maxdiff[start:stop],
                local, max_len, self.stack_cap, self.hits_cap,
                self.tier0_max_iters if retry else self.max_iters)
            fb, hw = self._collect(packed, self.hits_cap, results,
                                   range(start, stop))
            defer.extend((start + i, int(hw[i])) for i in fb)
        self._book(tier0_reads=n - len(defer))

        drain = [i for i, _ in defer]
        if defer and retry:
            # hardest first by tier-0 high-water (nabwa_tpu/models/aln.py
            # :436-467)
            defer.sort(key=lambda t: -t[1])
            idxs = np.array([i for i, _ in defer], dtype=np.int64)
            sub = [reads[int(i)] for i in idxs]
            drain = []
            for start in range(0, len(idxs), device_batch):
                part = idxs[start:start + device_batch]
                packed = self._run_device(
                    sub[start:start + len(part)], lens[part], maxdiff[part],
                    local, max_len, self.retry_stack_cap,
                    self.retry_hits_cap, self.max_iters)
                fb, _ = self._collect(packed, self.retry_hits_cap, results,
                                      part.tolist())
                drain.extend(int(part[i]) for i in fb)
            self._book(retry_reads=len(idxs) - len(drain))
        if drain:
            t0 = time.perf_counter()
            self._drain_native([reads[i] for i in drain], maxdiff[drain],
                               local, results, drain)
            self._book("drain", time.perf_counter() - t0,
                       host_drain_reads=len(drain))

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
        `ops.sa_lookup` on the engine's device (kernel C3 on CUDA): uint32
        rows -> raw uint32 bwt_sa values (callers apply the reverse-index
        coordinate flip)."""
        rows = np.ascontiguousarray(rows, dtype=np.uint32)
        if len(rows) == 0:
            return np.zeros(0, dtype=np.uint32)
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
        n0 = len(rows[0])
        ix = self.dev
        k = torch.from_numpy(np.concatenate(rows).view(np.int32)).to(
            self.device)
        out = sa_lookup_both((ix.bwt_rev, ix.bwt_fwd), ix.l2,
                             (ix.primary_rev, ix.primary_fwd), ix.seq_len,
                             (ix.sa_rev, ix.sa_fwd), ix.sa_intv, k, n0)
        vals = out.cpu().numpy().view(np.uint32)
        return [vals[:n0], vals[n0:]]

    def _drain_native(self, reads, maxdiff, local, results, idxs):
        """Solve reads on the host's threaded C++ DFS (native/dfsgap.cpp),
        bit-exact with the device tiers."""
        lo = copy.copy(local)
        lo.seed_len = self.opt.seed_len
        ix = self.dev
        out = native.dfs_match_gap_native(
            self._host_fwd, ix.primary_fwd, self._host_rev, ix.primary_rev,
            self._host_l2, ix.seq_len, reads,
            np.asarray(maxdiff, dtype=np.int32), lo,
            n_threads=self.native_threads)
        for i, res in zip(idxs, out):
            results[i] = res

    def _run_device(self, reads, lens, maxdiff, local, max_len, stack_cap,
                    hits_cap, max_iters):
        """Pad one batch, run cal_width + DFS on the device, return the
        packed result as a numpy array."""
        t0 = time.perf_counter()
        inputs = batch_inputs(reads, lens, maxdiff, local, max_len,
                              self.device)
        t1 = time.perf_counter()
        ix = self.dev
        packed = aln_device_step(
            ix.bwt_cat, ix.bwt_fwd, ix.bwt_rev, ix.rev_word_offset,
            ix.primary_fwd, ix.primary_rev, ix.l2, ix.seq_len, **inputs,
            **dfs_statics(local, stack_cap, hits_cap, max_iters)).cpu()
        t2 = time.perf_counter()
        self._book("prepare", t1 - t0)
        self._book("device", t2 - t1)
        return packed.numpy()

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
