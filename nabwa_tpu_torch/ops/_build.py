"""Build and load the port's CUDA kernels.

At first use, every `csrc/*.cu` is compiled by nvcc for sm_90a, one nvcc
process per source, all started together, and the objects are linked into
one shared library with a plain C interface,
`nabwa_tpu_torch/build/libnabwa_torch_kernels.so`, loaded with ctypes.
The library is rebuilt when the hash of the sources stored beside it
differs from the checkout's.  No PyTorch header is compiled, so a build
takes seconds.  The check, the build and the writes of the library, its
hash and its ptxas log run under an `fcntl.flock` on a file in
`BUILD_DIR`, as the host library's loader does (`index/native.py`): of
several processes that start cold together (bam2bam's remote workers on
one card), one builds and the others wait and load its library.

Every C entry point takes device pointers and the CUDA stream as
`c_void_p`, launches on that stream without synchronising, and returns
`cudaGetLastError()`; `check()` raises on a non-zero code.

`lib()`, `stream_of`, `require` and `check` sit on every launch's path:
`lib()` takes its lock only until the library is bound, and `stream_of`
reads the current stream's raw handle without building a
`torch.cuda.Stream`.
"""

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libnabwa_torch_kernels.so"
_HASH_PATH = BUILD_DIR / "libnabwa_torch_kernels.srchash"
_LOG_PATH = BUILD_DIR / "libnabwa_torch_kernels.ptxas.txt"
_LOCK_NAME = ".libnabwa_torch_kernels.lock"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lock = threading.Lock()
# guards the wrappers' launch counters: worker threads launch on one card
count_lock = threading.Lock()
# wall seconds of the nvcc run made by this process (None: library was
# already built for these sources) and the compiler's ptxas report (kept
# beside the library, so a process that reuses it reads the same report)
build_seconds = None
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U32 = ctypes.c_uint32
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    # (fm params[7], bwt, queries, lengths, B, L, width, bid, stream)
    "nabwa_cal_width": [_U32P, _P, _P, _P, _I, _I, _P, _P, _P],
    # (params[8]: l2, primary_fwd, primary_rev, seq_len; bwt_fwd, bwt_rev,
    #  seqs, lengths, seed_seqs, seed_lengths, B, L, SL, widths, bids,
    #  seed_widths, seed_bids, stream)
    "nabwa_cal_width_planes": [_U32P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _P, _P, _P, _P, _P],
    # (dfs params[26], bwt_cat, seqs, lengths, widths, bids, seed_widths,
    #  seed_bids, has_seed, max_diff, scratch, out, B, stream)
    "nabwa_dfs": [_U32P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # (dfs params[26], B, shared, shape[3])
    "nabwa_dfs_shape": [_U32P, _I, _I, _P],
    # (params[6]: l2[0..3], primary0, primary1; bank0, bank1, sa0, sa1,
    #  sa_intv, rows, n, n0, out, stream)
    "nabwa_sa_lookup": [_U32P, _P, _P, _P, _P, _U32, _P, _I, _I, _P, _P],
    # (dp params[28], s1, s2, len1, len2, b1, b2, B, L1, L2, scratch, tb,
    #  score, ctype, stream)
    "nabwa_banded_global": [_I32P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                            _P, _P, _P, _P],
    # (local params[27], s1, s2, len1, len2, B, L1, L2, scratch, score,
    #  end_i, end_j, stream)
    "nabwa_local_fwd": [_I32P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                        _P],
    # (L1, shared bytes a warp may take, form[2])
    "nabwa_local_form": [_I, _I, _P],
    # (extend params[27], s1, s2, len1, len2, g0, bw, B, L1, L2, scratch,
    #  score, end_i, end_j, cells, stream)
    "nabwa_extend": [_I32P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                     _P, _P, _P],
    # (idx, table, bb, out, stream)
    "nabwa_probe_rowload": [_P, _P, _I, _P, _P],
    # (table, n_rows, n, t, src, unroll, scratch, out, stage, rounds,
    # stream): C8's grid form and its serial form
    "nabwa_probe_dma": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "nabwa_probe_dma_serial": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                               _P],
    # (seed, seed_w, table, nrow, bb, s, iters, lean, acc, stamps, stream)
    "nabwa_probe_dfs_shape": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # (k, table, nrow, bb, iters, acc, stream)
    "nabwa_probe_dfs_pallas": [_P, _P, _I, _I, _I, _P, _P],
    # (x, n, out, stream)
    "nabwa_probe_empty": [_P, ctypes.c_longlong, _P, _P],
    # (idx, idx_w, table, bb, out, stream)
    "nabwa_probe_loads": [_P, _I, _P, _I, _P, _P],
    # (idx, idx_w, table, bb, unroll, out, stream)
    "nabwa_probe_loads_serial": [_P, _I, _P, _I, _I, _P, _P],
    # (x, rows, iters, out, state, witness, stream)
    "nabwa_probe_pop": [_P, _I, _I, _P, _P, _P, _P],
    # (x, rows, out, stream)
    "nabwa_probe_lanereduce": [_P, _I, _P, _P],
    # (idx, table, bb, out, stream)
    "nabwa_probe_smem_idx": [_P, _P, _I, _P, _P],
    # (x, n, out, stream)
    "nabwa_probe_popcount": [_P, ctypes.c_longlong, _P, _P],
    # (x, warps, out, stream)
    "nabwa_probe_while_scratch": [_P, _I, _P, _P],
    "nabwa_probe_while_vector": [_P, _I, _P, _P],
    # (x, out, stream)
    "nabwa_probe_while_scratch_witness": [_P, _P, _P],
    "nabwa_probe_while_vector_witness": [_P, _P, _P],
    # (x, n, out, stream)
    "nabwa_probe_body_scale": [_P, _I, _P, _P],
    # (x, idx, rows, out, stream)
    "nabwa_probe_lane_gather": [_P, _P, _I, _P, _P],
    # (c, rows, fields, top, out, stream)
    "nabwa_probe_scalar_push": [_P, _I, _P, _P, _P, _P],
    # (table, k, out, stage, stream)
    "nabwa_probe_sem": [_P, _I, _P, _P, _P],
    # (x, n, k, lanes, t, out, stream)
    "nabwa_probe_spill": [_P, _I, _I, _I, _I, _P, _P],
    # (x, n, k, t, out, stream)
    "nabwa_probe_spill_witness": [_P, _I, _I, _I, _P, _P],
    # (x, n, t, k, out, stream)
    "nabwa_probe_colops": [_P, _I, _I, _I, _P, _P],
    # (x, n, out, stream)
    "nabwa_probe_p7": [_P, _I, _P, _P],
    # (a, b, rows, cols, out, stream)
    "nabwa_probe_p8": [_P, _P, _I, _I, _P, _P],
    # (i, i_w, n, t, cols, out, stream)
    "nabwa_probe_p1": [_P, _I, _I, _P, _I, _P, _P],
    # (i, j, n, t, cols, out, stream)
    "nabwa_probe_p1b": [_P, _P, _I, _P, _I, _P, _P],
    # (x, cols, i, n, out, stream)
    "nabwa_probe_p3": [_P, _I, _P, _I, _P, _P],
    # (x, rows, cols, out, stream)
    "nabwa_probe_p4": [_P, _I, _I, _P, _P],
    # (x, rows, cols, kind, out, stream)
    "nabwa_probe_p2": [_P, _I, _I, _I, _P, _P],
    # (x, rows, out, stream)
    "nabwa_probe_p2_roll_witness": [_P, _I, _P, _P],
    # (x, n, out, stream)
    "nabwa_probe_p5": [_P, _LL, _P, _P],
    "nabwa_probe_p5_witness": [_P, _I, _P, _P],
    # (x, w, rows, depth, width, out, stream)
    "nabwa_probe_p6": [_P, _P, _I, _I, _I, _P, _P],
}


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash():
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(src_hash):
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f".{src.stem}.{tag}.o"
        cmd = ([nvcc] + NVCC_FLAGS + ["-I", str(CSRC), "-c", "-o", str(obj),
                                      str(src)])
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"{src.name}:\n{out}")
        if proc.returncode != 0:
            failed.append(logs[-1])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(failed))
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{tag}"
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp)]
                         + [str(obj) for _, obj, _ in jobs],
                         capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    os.replace(tmp, LIB_PATH)
    _LOG_PATH.write_text(build_log)
    _HASH_PATH.write_text(src_hash)


def lib():
    """The loaded kernel library, built first if the sources changed."""
    global _lib, build_log
    if _lib is not None:        # bound: set only once its functions are
        return _lib
    with _lock:
        if _lib is None:
            h = source_hash()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / _LOCK_NAME, "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                if (not LIB_PATH.exists() or not _HASH_PATH.exists()
                        or _HASH_PATH.read_text() != h):
                    _build(h)
                elif _LOG_PATH.exists():
                    build_log = _LOG_PATH.read_text()
                so = ctypes.CDLL(str(LIB_PATH))
            for name, args in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            so.nabwa_error_string.argtypes = [ctypes.c_int]
            so.nabwa_error_string.restype = ctypes.c_char_p
            _lib = so
    return _lib


def u32_params(values):
    """A ctypes uint32 array of `values` (taken mod 2**32)."""
    return (ctypes.c_uint32 * len(values))(
        *[int(v) & 0xFFFFFFFF for v in values])


def i32_params(values):
    """A ctypes int32 array of `values` (each in int32 range)."""
    return (ctypes.c_int32 * len(values))(*[int(v) for v in values])


def check(rc, what):
    if rc != 0:
        msg = lib().nabwa_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t):
    """The handle of PyTorch's current stream on CUDA tensor t's device
    (what torch.cuda.current_stream(t.device).cuda_stream gives, without
    building a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require(t, name, device, ndim, dtype=torch.int32):
    """Raise ValueError unless `t` is a contiguous tensor of `dtype` (int32
    unless said) with `ndim` dimensions on `device`."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
