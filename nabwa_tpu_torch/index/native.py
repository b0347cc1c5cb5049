"""ctypes bindings for the shared native (C++) host library.

The port's copy of nabwa_tpu/index/native.py, cut to the entry points the
port calls.  The repository's `native/*.cpp` sources the port needs are
compiled with g++ at first use, one process per source, all at once, and
linked into
`nabwa_tpu_torch/build/libnabwa_native.so`.  The library is rebuilt when
the hash of the sources, the flags and the host CPU stored beside it
differs, so a build directory copied to another machine is not reused.
Builds are serialised by a file lock and land by an atomic rename, so
processes never race on one `.so`.

Unlike the JAX package's loader, nothing here degrades: if the library
cannot be built, or an entry point is missing, `lib()` raises.
"""

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parents[1]
_NATIVE = _PKG.parent / "native"
SOURCES = [_NATIVE / f"{n}.cpp" for n in (
    "sais", "bwtwalk", "dfsgap", "stdaln", "bsw2core", "bsw2aln", "post",
    "bwtgen", "fastq")]
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libnabwa_native.so"
_HASH_PATH = BUILD_DIR / "libnabwa_native.srchash"
CXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-std=c++17",
             "-fPIC", "-pthread"]

_lib = None
_lock = threading.Lock()

_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_c = ctypes
_I, _I32, _I64, _U32 = _c.c_int, _c.c_int32, _c.c_int64, _c.c_uint32

# name: (restype, argtypes)
_SIGNATURES = {
    "sais_u8_big": (_I, [_u8, _i64, _I64]),
    "bwt_inc_u8": (_I, [_u8, _I64, _I64, _u8, _u64]),
    "bwt_cal_sa_u32": (_I, [_u32, _U32, _u32, _U32, _I, _u32]),
    "bwt_sa_batch_u32": (_I, [_u32, _U32, _u32, _U32, _u32, _I, _u32, _I64,
                              _u32]),
    "dfs_match_gap_batch": (_I, [
        _u32, _U32, _u32, _U32, _u32, _U32, _u8, _I, _i32, _i32, _I, _I, _I,
        _I, _I, _I, _I, _I, _I64, _I, _I, _I, _I, _I, _I, _i32, _i32,
        _i32]),
    "aln_global_u8": (_I32, [_u8, _I, _u8, _I, _i32, _I, _I32, _I32, _I32,
                             _I, _u8, _I64, _i64]),
    "aln_extend_u8": (_I32, [_u8, _I, _u8, _I, _i32, _I, _I32, _I32, _I,
                             _I32, _I, _i32, _u8, _I64, _i64]),
    "local_fwd_u8": (_I32, [_u8, _I, _u8, _I, _i32, _I, _I32, _I32, _i32]),
    "local_rev_u8": (_I32, [_u8, _I, _u8, _I, _i32, _I, _I32, _I32, _I32,
                            _I, _I, _i32]),
    "bsw2_core_u32": (_I, [_i64, _i64, _i32, _I, _I, _u32, _U32, _u32, _U32,
                           _I, _I, _I, _I, _I, _I, _I, _I, _i64, _i64, _I64,
                           _i64]),
    "bsw2_aln_batch": (_I64, [
        _u32, _U32, _u32, _U32, _u32, _I32, _u32, _U32, _u32, _U32, _u32,
        _I32, _u8, _I64, _u8, _i64, _I64, _i32, _c.c_float, _c.c_double,
        _u64, _I32, _i64, _i64, _I64, _i32, _I64, _i64]),
    "se_select_batch": (_I, [_I64, _u32, _i32, _i64, _u64, _I, _I, _u64,
                             _i32, _i32, _i32, _i32]),
    "se_multi_batch": (_I, [_I64, _u32, _i32, _i64, _i32, _I64, _u64, _i32,
                            _i32, _i32, _i32]),
    "pe_pairing_batch": (_I64, [_I64, _u64, _i64, _u32, _i64, _i64, _I,
                                _I64, _I, _i64, _i64, _f64, _f64]),
    "md_batch": (_I, [_I64, _i64, _u8, _i64, _i32, _i64, _u8, _I64, _I64,
                      _i64, _i32, _u8, _u8, _I64, _i64, _I]),
    "sam_emit_batch": (_I64, [
        _I64, _i64, _i64, _u8, _i64, _u8, _i64, _i32, _i64, _u8, _i64, _u8,
        _i64, _u8, _i64, _u64, _i32, _i32, _i32, _i32, _I64, _I, _i64, _i64,
        _u8, _i64, _I64, _i64, _i32, _u8, _I64, _I, _I, _u8, _I64, _u8,
        _I64, _I]),
    "bam_update_batch": (_I64, [
        _I64, _i64, _i64, _i64, _i64, _i64, _i64, _u8, _i64, _i32, _i64,
        _u8, _i64, _u64, _i32, _i32, _i32, _i32, _I64, _i32, _I, _I, _i64,
        _i64, _u8, _i64, _I64, _i64, _i32, _I64, _I, _I64, _i64, _u8, _I64,
        _i64]),
    "fastq_parse": (_I64,[_u8, _I64, _I64, _I, _I, _u8, _i64, _u8, _i64,
                           _u8, _i32]),
    "sai_scan": (_I64, [_u8, _I64, _I64, _i32, _u8, _I64]),
    "gather_rows_u8": (None, [_u8, _i64, _i64, _u8, _I64, _u8, _i64, _I]),
}


def _cpu_tag():
    """The host CPU's model and flags: -march=native code is only valid
    on the CPU it was built for."""
    try:
        text = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        return os.uname().machine
    keep = [ln for ln in text.splitlines()
            if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep)))


def source_hash():
    h = hashlib.sha256()
    for p in SOURCES:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_tag().encode())
    return h.hexdigest()


def _build(src_hash):
    """g++ each source to an object, all at once, then link; the library
    lands by an atomic rename."""
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in SOURCES:
        obj = BUILD_DIR / f".{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            ["g++"] + CXX_FLAGS + ["-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{tag}"
    try:
        if failed:
            raise RuntimeError("g++ failed on the native host library:\n"
                               + "".join(failed))
        res = subprocess.run(["g++", "-shared", "-pthread", "-o", str(tmp)]
                             + [str(obj) for _, obj, _ in jobs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("linking the native host library failed:\n"
                               + res.stdout + res.stderr)
        os.replace(tmp, LIB_PATH)
        _HASH_PATH.write_text(src_hash)
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)


def lib():
    """The loaded native library, built first if its sources, flags or the
    host CPU changed.  Raises when it cannot be built or lacks an entry
    point."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            h = source_hash()
            with open(BUILD_DIR / ".libnabwa_native.lock", "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                if (not LIB_PATH.exists() or not _HASH_PATH.exists()
                        or _HASH_PATH.read_text() != h):
                    _build(h)
                so = ctypes.CDLL(str(LIB_PATH))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(so, name)      # AttributeError if missing
                fn.argtypes = args
                fn.restype = res
            _lib = so
    return _lib


def suffix_array_native(codes):
    """SA-IS suffix array (the in-place Gbp entry point: the SA buffer of
    n+1 entries doubles as the construction workspace)."""
    t = np.ascontiguousarray(codes, dtype=np.uint8)
    sa = np.empty(len(t) + 1, dtype=np.int64)
    rc = lib().sais_u8_big(t, sa, len(t))
    if rc != 0:
        raise RuntimeError(f"native sais_u8_big failed ({rc})")
    return sa[:len(t)]


def bwt_inc_native(codes, block=0):
    """Blockwise incremental BWT (native/bwtgen.cpp), the low-memory
    large-genome builder.  Returns (bwt_u8, primary)."""
    t = np.ascontiguousarray(codes, dtype=np.uint8)
    out = np.empty(len(t), dtype=np.uint8)
    prim = np.zeros(1, dtype=np.uint64)
    rc = lib().bwt_inc_u8(t, len(t), int(block), out, prim)
    if rc != 0:
        raise RuntimeError(f"native bwt_inc_u8 failed ({rc})")
    return out, int(prim[0])


def cal_sa_native(bwt_words, primary, l2, seq_len, intv):
    """bwt_cal_sa (bwt.c:48-70) via the native invPsi walk."""
    bwt = np.ascontiguousarray(bwt_words, dtype=np.uint32)
    l2a = np.ascontiguousarray(l2, dtype=np.uint32)
    out = np.zeros((int(seq_len) + intv) // intv, dtype=np.uint32)
    rc = lib().bwt_cal_sa_u32(bwt, np.uint32(primary), l2a,
                              np.uint32(seq_len), intv, out)
    if rc != 0:
        raise RuntimeError(f"native bwt_cal_sa_u32 failed ({rc})")
    return out


def bwt_sa_batch(bwt_words, primary, l2, seq_len, sa_sample, intv, rows):
    """Batched bwt_sa via the native invPsi walk."""
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    out = np.empty(len(rows), dtype=np.uint32)
    lib().bwt_sa_batch_u32(
        np.ascontiguousarray(bwt_words, dtype=np.uint32),
        np.uint32(primary), np.ascontiguousarray(l2, dtype=np.uint32),
        np.uint32(seq_len),
        np.ascontiguousarray(sa_sample, dtype=np.uint32), int(intv),
        rows, len(rows), out)
    return out


def aln_global_native(seq1, seq2, mat, row, go, ge, gend, band):
    """Native aln_global_core; returns (score, ctype_bytes), the returned
    path's ctype sequence last-to-first."""
    s1 = np.ascontiguousarray(seq1, dtype=np.uint8)
    s2 = np.ascontiguousarray(seq2, dtype=np.uint8)
    cap = len(s1) + len(s2) + 2
    path = np.empty(cap, dtype=np.uint8)
    pn = np.zeros(1, dtype=np.int64)
    score = lib().aln_global_u8(s1, len(s1), s2, len(s2),
                                np.ascontiguousarray(mat, dtype=np.int32),
                                int(row), int(go), int(ge), int(gend),
                                int(band), path, cap, pn)
    return int(score), path[:int(pn[0])]


def aln_extend_native(seq1, seq2, mat, row, go, ge, band, g0):
    """Native aln_extend_core without its path (nabwa_tpu/index/native.py:332
    with want_path=False); returns (score, end_i, end_j).  Raises on the
    overflow rebase the C would take."""
    s1 = np.ascontiguousarray(seq1, dtype=np.uint8)
    s2 = np.ascontiguousarray(seq2, dtype=np.uint8)
    path = np.empty(1, dtype=np.uint8)
    pn = np.zeros(1, dtype=np.int64)
    out = np.zeros(3, dtype=np.int32)
    rc = lib().aln_extend_u8(s1, len(s1), s2, len(s2),
                             np.ascontiguousarray(mat, dtype=np.int32),
                             int(row), int(go), int(ge), int(band), int(g0),
                             0, out, path, 1, pn)
    if rc != 0:
        raise RuntimeError("extension overflow rebase not modelled")
    return int(out[0]), int(out[1]), int(out[2])


def local_fwd_native(seq1, seq2, mat, row, q, r):
    """Native local_fwd (aln_local_core's forward pass); returns (score_f,
    end_i, end_j).  Raises on the overflow rebase the C would take."""
    out = np.zeros(3, dtype=np.int32)
    rc = lib().local_fwd_u8(np.ascontiguousarray(seq1, dtype=np.uint8),
                            len(seq1),
                            np.ascontiguousarray(seq2, dtype=np.uint8),
                            len(seq2),
                            np.ascontiguousarray(mat, dtype=np.int32),
                            int(row), int(q), int(r), out)
    if rc != 0:
        raise RuntimeError("local SW overflow rebase not modelled")
    return int(out[0]), int(out[1]), int(out[2])


def local_rev_native(seq1, seq2, mat, row, q, r, score_f, end_i, end_j):
    """Native local_rev (the banded reverse pass); returns (score_r,
    start_i, start_j), or None when end_i/end_j is 0 (no local match)."""
    out = np.zeros(3, dtype=np.int32)
    rc = lib().local_rev_u8(np.ascontiguousarray(seq1, dtype=np.uint8),
                            len(seq1),
                            np.ascontiguousarray(seq2, dtype=np.uint8),
                            len(seq2),
                            np.ascontiguousarray(mat, dtype=np.int32),
                            int(row), int(q), int(r), int(score_f),
                            int(end_i), int(end_j), out)
    if rc != 0:
        return None
    return int(out[0]), int(out[1]), int(out[2])


def dfs_match_gap_native(fwd_bwt, primary_fwd, rev_bwt, primary_rev, l2,
                         seq_len, reads, maxdiff, local, hits_cap=512,
                         n_threads=0):
    """Run the native threaded DFS over `reads` (objects with .seq, .rseq,
    .len, or a columnar ReadBatch).  maxdiff: per-read int array; local:
    the batch-clamped GapOpt.  Returns a list of (alns, hw) matching the
    scalar oracle."""
    so = lib()
    n = len(reads)
    if n == 0:
        return []
    if hasattr(reads, "code_bytes"):
        # columnar ReadBatch: pack [n,2,L] via one threaded native ragged
        # gather (seq = reversed clip codes, rseq = reversed complement)
        lengths = reads.clip_lens().astype(np.int32)
        L = int(lengths.max())
        seqs = np.full((n, 2, L), 4, dtype=np.uint8)
        starts = np.repeat(
            np.ascontiguousarray(reads.seq_off[reads.lo:reads.hi]), 2)
        lens2 = np.repeat(lengths.astype(np.int64), 2)
        flags = np.tile(np.array(
            [1, 3 if reads.is_comp else 1], dtype=np.uint8), n)
        out_off = np.arange(2 * n, dtype=np.int64) * L
        so.gather_rows_u8(reads.codes_flat, starts, lens2, flags,
                          2 * n, seqs.reshape(-1), out_off, 0)
    else:
        lengths = np.fromiter((r.len for r in reads), dtype=np.int32,
                              count=n)
        L = int(lengths.max())
        seqs = np.full((n, 2, L), 4, dtype=np.uint8)
        for i, r in enumerate(reads):
            seqs[i, 0, :r.len] = r.seq
            seqs[i, 1, :r.len] = r.rseq
    maxdiff = np.ascontiguousarray(maxdiff, dtype=np.int32)
    fwd = np.ascontiguousarray(fwd_bwt, dtype=np.uint32)
    rev = np.ascontiguousarray(rev_bwt, dtype=np.uint32)
    l2a = np.ascontiguousarray(l2, dtype=np.uint32)
    seed_len = local.seed_len if local.seed_len < 0x7FFFFFFF else 0x7FFFFFF

    cap = hits_cap
    pending = np.arange(n)
    results = [None] * n
    while len(pending):
        m = len(pending)
        hits = np.zeros((m, cap, 7), dtype=np.int32)
        n_aln = np.zeros(m, dtype=np.int32)
        hw = np.zeros(m, dtype=np.int32)
        # positions may come as int32 bit patterns: mask before the uint32
        # narrowing
        so.dfs_match_gap_batch(
            fwd, np.uint32(primary_fwd & 0xFFFFFFFF),
            rev, np.uint32(primary_rev & 0xFFFFFFFF),
            l2a, np.uint32(seq_len & 0xFFFFFFFF),
            np.ascontiguousarray(seqs[pending]), L,
            np.ascontiguousarray(lengths[pending]),
            np.ascontiguousarray(maxdiff[pending]), m,
            local.s_mm, local.s_gapo, local.s_gape, local.max_gape,
            local.max_gapo, local.indel_end_skip, local.max_del_occ,
            local.max_entries, local.max_top2, local.max_seed_diff,
            seed_len, local.mode, cap, n_threads,
            hits.reshape(-1), n_aln, hw)
        retry = []
        hits_u = hits.view(np.uint32)
        n_aln_l = n_aln.tolist()
        hw_l = hw.tolist()
        for j, idx in enumerate(pending):
            na = n_aln_l[j]
            if na < 0:
                retry.append(idx)
                continue
            rows = hits[j, :na].tolist()
            urows = hits_u[j, :na].tolist()
            results[idx] = ([(h[0], h[1], h[2], h[3], u[4], u[5], h[6])
                             for h, u in zip(rows, urows)], hw_l[j])
        pending = np.array(retry, dtype=np.int64)
        cap *= 4
    return results
