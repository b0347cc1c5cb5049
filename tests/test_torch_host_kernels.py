"""The port's CUDA kernel source built for the host, for the CPU tests.

`nabwa_tpu_torch/csrc/host_harness.cpp` runs the kernels' NABWA_HD
per-row code (dfs_read of C1, cal_width_row of C2, sa_walk_row of C3,
banded_global_pair of C4, local_fwd_pair of C5, extend_job of C6) with the
kernels' argument layouts, and C1's, C4's, C5's and C6's warp kernels and
C2's lane groups lane by lane (C1's `dfs_read_warp` of dfs_warp.cuh, the
per-lane steps of dp_global.cuh, local_sw.cuh, extend.cuh and occ.cuh, at
a chosen number of lanes, the values combined in lane order as the warp's
intrinsics combine them).  g++ builds it here, so the tests can hold the
kernel source itself, not only its plain PyTorch version, against the JAX
package on a machine without a GPU.
"""

import ctypes
import pathlib
import subprocess

import numpy as np
import pytest

from nabwa_tpu_torch.ops import _build, dfs_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32P = ctypes.POINTER(ctypes.c_uint32)


def build(out_dir):
    so = pathlib.Path(out_dir) / "libnabwa_host_kernels.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(so),
                    str(_build.CSRC / "host_harness.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.nabwa_host_cal_width.argtypes = [_U32P, _P, _P, _P, _I, _I, _P, _P]
    lib.nabwa_host_dfs.argtypes = [_U32P] + [_P] * 12 + [_I]
    lib.nabwa_host_dfs_lanes.argtypes = [_U32P] + [_P] * 10 + [_I] * 3
    lib.nabwa_host_dfs_state_bytes.argtypes = [_U32P]
    lib.nabwa_host_dfs_state_bytes.restype = ctypes.c_longlong
    lib.nabwa_host_occ4.argtypes = [_P, ctypes.c_uint32, _P, _I, _P]
    lib.nabwa_host_sa_lookup.argtypes = ([_U32P] + [_P] * 4
                                         + [ctypes.c_uint32, _P] + [_I] * 2
                                         + [_P])
    lib.nabwa_host_intv_quot.argtypes = [ctypes.c_uint32, _P, _I, _P, _P]
    lib.nabwa_host_banded_global.argtypes = (
        [ctypes.POINTER(ctypes.c_int32)] + [_P] * 6 + [_I] * 3 + [_P] * 3)
    lib.nabwa_host_local_fwd.argtypes = (
        [ctypes.POINTER(ctypes.c_int32)] + [_P] * 4 + [_I] * 3 + [_P] * 3)
    lib.nabwa_host_extend.argtypes = (
        [ctypes.POINTER(ctypes.c_int32)] + [_P] * 6 + [_I] * 3 + [_P] * 4)
    lib.nabwa_host_banded_global_lanes.argtypes = (
        [ctypes.POINTER(ctypes.c_int32)] + [_P] * 6 + [_I] * 5 + [_P] * 3)
    lib.nabwa_host_extend_lanes.argtypes = (
        [ctypes.POINTER(ctypes.c_int32)] + [_P] * 6 + [_I] * 5 + [_P] * 4)
    lib.nabwa_host_local_fwd_lanes.argtypes = (
        [ctypes.POINTER(ctypes.c_int32)] + [_P] * 4 + [_I] * 6 + [_P] * 3)
    lib.nabwa_host_local_form.argtypes = [_I, _I, _P]
    lib.nabwa_host_cal_width_group.argtypes = ([_U32P] + [_P] * 3
                                               + [_I] * 2 + [_P] * 2)
    lib.nabwa_host_occ_group.argtypes = [_P, ctypes.c_uint32, _P, _P, _I,
                                         _P]
    for fn in (lib.nabwa_host_occ4, lib.nabwa_host_cal_width,
               lib.nabwa_host_dfs, lib.nabwa_host_sa_lookup,
               lib.nabwa_host_banded_global, lib.nabwa_host_local_fwd,
               lib.nabwa_host_extend, lib.nabwa_host_banded_global_lanes,
               lib.nabwa_host_extend_lanes, lib.nabwa_host_dfs_lanes,
               lib.nabwa_host_local_fwd_lanes, lib.nabwa_host_local_form,
               lib.nabwa_host_cal_width_group, lib.nabwa_host_occ_group,
               lib.nabwa_host_intv_quot):
        fn.restype = _I
    return lib


def _arr(a):
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def occ4(lib, bank, primary, ks):
    """occ.cuh's occ4 on numpy arrays: uint32 [n, 4] counts."""
    bank = np.ascontiguousarray(bank, dtype=np.uint32)
    ks = np.ascontiguousarray(ks, dtype=np.uint32)
    out = np.empty((len(ks), 4), dtype=np.uint32)
    lib.nabwa_host_occ4(_ptr(bank), primary, _ptr(ks), len(ks), _ptr(out))
    return out


def cal_width(lib, bwt, l2, primary, seq_len, queries, lengths):
    """C2's per-row code on numpy arrays: (width, bid) int32 [B, L+1]."""
    bwt, q, lens = _arr(bwt), _arr(queries), _arr(lengths)
    B, L = q.shape
    width = np.empty((B, L + 1), dtype=np.int32)
    bid = np.empty((B, L + 1), dtype=np.int32)
    lib.nabwa_host_cal_width(
        _build.u32_params(list(l2[:5]) + [primary, seq_len]), _ptr(bwt),
        _ptr(q), _ptr(lens), B, L, _ptr(width), _ptr(bid))
    return width, bid


def occ_group(lib, bank, primary, ks, cs):
    """occ4(k)[c] as a half of C2's 8-lane group counts it (each lane's
    `occ_lane_part` summed): uint32 [n]."""
    bank = np.ascontiguousarray(bank, dtype=np.uint32)
    ks = np.ascontiguousarray(ks, dtype=np.uint32)
    cs = np.ascontiguousarray(cs, dtype=np.uint32)
    out = np.empty(len(ks), dtype=np.uint32)
    lib.nabwa_host_occ_group(_ptr(bank), primary, _ptr(ks), _ptr(cs),
                             len(ks), _ptr(out))
    return out


def cal_width_group(lib, bwt, l2, primary, seq_len, queries, lengths):
    """C2's lane groups on numpy arrays, 8 lanes a row run lane by lane:
    (width, bid) int32 [B, L+1]."""
    bwt, q, lens = _arr(bwt), _arr(queries), _arr(lengths)
    B, L = q.shape
    width = np.empty((B, L + 1), dtype=np.int32)
    bid = np.empty((B, L + 1), dtype=np.int32)
    lib.nabwa_host_cal_width_group(
        _build.u32_params(list(l2[:5]) + [primary, seq_len]), _ptr(bwt),
        _ptr(q), _ptr(lens), B, L, _ptr(width), _ptr(bid))
    return width, bid


def dfs(lib, bwt_cat, rev_word_offset, primary_fwd, primary_rev, l2,
        seq_len, seqs, lengths, widths, bids, seed_widths, seed_bids,
        has_seed, max_diff, **statics):
    """C1's per-read code on numpy arrays: the packed int32 [B, 4H+5]."""
    arrs = [_arr(a) for a in (bwt_cat, seqs, lengths, widths, bids,
                              seed_widths, seed_bids, has_seed, max_diff)]
    B, _, L = arrs[1].shape
    S, H = statics["stack_cap"], statics["hits_cap"]
    dfs_cuda.check_limits(L, int(arrs[8].max()), statics["max_gapo"],
                          statics["max_gape"], statics["s_mm"],
                          statics["s_gapo"], statics["s_gape"], S, H,
                          statics["max_iters"])
    slots = np.empty((B, 5, S), dtype=np.int32)
    planes = np.empty((2, B, 2, L + 1), dtype=np.int32)
    out = np.empty((B, 4 * H + 5), dtype=np.int32)
    params = dfs_cuda.param_words(rev_word_offset, primary_fwd, primary_rev,
                                  l2, seq_len, L, arrs[5].shape[2],
                                  **statics)
    lib.nabwa_host_dfs(params, *[_ptr(a) for a in arrs], _ptr(slots),
                       _ptr(planes), _ptr(out), B)
    return out


def dfs_lanes(lib, bwt_cat, rev_word_offset, primary_fwd, primary_rev, l2,
              seq_len, seqs, lengths, widths, bids, seed_widths, seed_bids,
              has_seed, max_diff, *, lanes, form, **statics):
    """C1's warp kernel lane by lane on numpy arrays: the packed int32
    [B, 4H+5] of `dfs_read_warp` at `lanes` lanes (1..32), its state in
    one reused buffer (form "shared") or a region a read ("device")."""
    arrs = [_arr(a) for a in (bwt_cat, seqs, lengths, widths, bids,
                              seed_widths, seed_bids, has_seed, max_diff)]
    B, _, L = arrs[1].shape
    H = statics["hits_cap"]
    dfs_cuda.check_limits(L, int(arrs[8].max(initial=0)), statics["max_gapo"],
                          statics["max_gape"], statics["s_mm"],
                          statics["s_gapo"], statics["s_gape"],
                          statics["stack_cap"], H, statics["max_iters"])
    out = np.empty((B, 4 * H + 5), dtype=np.int32)
    params = dfs_cuda.param_words(rev_word_offset, primary_fwd, primary_rev,
                                  l2, seq_len, L, arrs[5].shape[2],
                                  **statics)
    if lib.nabwa_host_dfs_lanes(params, *[_ptr(a) for a in arrs], _ptr(out),
                                B, lanes,
                                {"shared": 0, "device": 1}[form]):
        raise ValueError(f"no lane emulation at {lanes} lanes")
    return out


def dfs_state_bytes(lib, params):
    """dfs_warp.cuh's `dfs_state_bytes` at these `param_words`."""
    return int(lib.nabwa_host_dfs_state_bytes(params))


def sa_lookup(lib, bank, l2, primary, seq_len, sa, sa_intv, rows):
    """C3's per-row code on numpy arrays, every row on one strand: uint32
    [n] positions."""
    return sa_lookup_both(lib, (bank, bank), l2, (primary, primary),
                          (sa, sa), sa_intv, rows, len(rows))


def sa_lookup_both(lib, banks, l2, primaries, sas, sa_intv, rows, n0):
    """C3 on numpy arrays with the kernel's layout: rows[:n0] on strand 0
    (banks[0], primaries[0], sas[0]), rows[n0:] on strand 1.  uint32 [n]
    positions."""
    banks = [np.ascontiguousarray(b, dtype=np.uint32) for b in banks]
    sas = [np.ascontiguousarray(a, dtype=np.uint32) for a in sas]
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    out = np.empty(len(rows), dtype=np.uint32)
    lib.nabwa_host_sa_lookup(
        _build.u32_params(list(l2[:4]) + list(primaries)), _ptr(banks[0]),
        _ptr(banks[1]), _ptr(sas[0]), _ptr(sas[1]), int(sa_intv),
        _ptr(rows), len(rows), n0, _ptr(out))
    return out


def intv_quot(lib, d, ks):
    """C3's interval test at sa_intv d, through the instantiation the
    kernel takes for d: (k // d as uint32 [n], k % d == 0 as bool [n])."""
    ks = np.ascontiguousarray(ks, dtype=np.uint32)
    quot = np.empty(len(ks), dtype=np.uint32)
    sampled = np.empty(len(ks), dtype=np.uint8)
    lib.nabwa_host_intv_quot(d, _ptr(ks), len(ks), _ptr(quot),
                             _ptr(sampled))
    return quot, sampled.astype(bool)


def banded_global(lib, s1, len1, s2, len2, b1, b2, mat, *, go, ge, gend,
                  lanes=None, k=4):
    """C4's per-pair code on numpy arrays: (score, ctype) int32 [B] and
    the uint8 [B, L2+1, L1+1] lattice.  lanes None: the serial
    banded_global_pair; else the warp kernel's steps at `lanes` lanes of
    `k` columns (1 or 4)."""
    s1, s2 = _arr(s1), _arr(s2)
    cols = [_arr(a) for a in (len1, len2, b1, b2)]
    B, L1p = s1.shape
    L2p = s2.shape[1]
    tb = np.empty((B, L2p, L1p), dtype=np.uint8)
    score = np.empty(B, dtype=np.int32)
    ctype = np.empty(B, dtype=np.int32)
    params = _build.i32_params(
        [go, ge, gend] + np.asarray(mat).reshape(-1).tolist())
    head = [params, _ptr(s1), _ptr(s2), *[_ptr(a) for a in cols], B,
            L1p - 1, L2p - 1]
    if lanes is None:
        lib.nabwa_host_banded_global(*head, _ptr(tb), _ptr(score),
                                     _ptr(ctype))
    elif lib.nabwa_host_banded_global_lanes(*head, lanes, k, _ptr(tb),
                                            _ptr(score), _ptr(ctype)):
        raise ValueError(f"no lane emulation at {lanes} lanes of {k}")
    return score, ctype, tb


def local_fwd(lib, s1, len1, s2, len2, mat, *, go, ge, lanes=None, k=2,
              form="registers"):
    """C5's per-pair code on numpy arrays: (score, end_i, end_j) int32
    [B].  lanes None: the serial local_fwd_pair; else the warp kernel's
    steps at `lanes` lanes of `k` cells (2, 4, 8, 16), in the register
    form (one chunk a lane, lanes x k covering L1) or the "wide" form
    (passes over a row buffer)."""
    s1, s2, len1, len2 = (_arr(a) for a in (s1, s2, len1, len2))
    B, L1p = s1.shape
    out = [np.empty(B, dtype=np.int32) for _ in range(3)]
    params = _build.i32_params([go, ge] + np.asarray(mat).reshape(-1).tolist())
    head = [params, _ptr(s1), _ptr(s2), _ptr(len1), _ptr(len2), B, L1p - 1,
            s2.shape[1] - 1]
    if lanes is None:
        lib.nabwa_host_local_fwd(*head, *[_ptr(a) for a in out])
    elif lib.nabwa_host_local_fwd_lanes(
            *head, lanes, k, {"registers": 0, "wide": 1}[form],
            *[_ptr(a) for a in out]):
        raise ValueError(f"no lane emulation at {lanes} lanes of {k} in "
                         f"the {form} form")
    return tuple(out)


def local_form(lib, L1):
    """C5's (form, K) at L1 columns as `ops/dp.py::local_form` asks it,
    from local_sw.cuh's `local_form` built for the host."""
    from nabwa_tpu_torch.ops import dp
    return dp.local_form(L1, lib.nabwa_host_local_form)


def extend(lib, s1, len1, s2, len2, g0, bw, mat, *, go, ge, lanes=None,
           k=4):
    """C6's per-job code on numpy arrays: (score, end_i, end_j, cells)
    int32 [B].  lanes None: the serial extend_job; else the warp kernel's
    steps at `lanes` lanes of `k` cells (1 or 4)."""
    s1, s2, len1, len2, g0, bw = (_arr(a) for a in (s1, s2, len1, len2, g0,
                                                    bw))
    B, L1p2 = s1.shape
    out = [np.empty(B, dtype=np.int32) for _ in range(4)]
    params = _build.i32_params([go, ge] + np.asarray(mat).reshape(-1).tolist())
    head = [params, _ptr(s1), _ptr(s2), _ptr(len1), _ptr(len2), _ptr(g0),
            _ptr(bw), B, L1p2 - 2, s2.shape[1] - 1]
    if lanes is None:
        lib.nabwa_host_extend(*head, *[_ptr(a) for a in out])
    elif lib.nabwa_host_extend_lanes(*head, lanes, k,
                                     *[_ptr(a) for a in out]):
        raise ValueError(f"no lane emulation at {lanes} lanes of {k}")
    return tuple(out)


# ---- tests of the harness's own entry points ----


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build(tmp_path_factory.mktemp("host_kernels"))


_STATICS = dict(s_mm=3, s_gapo=11, s_gape=4, max_gape=6, max_gapo=1,
                indel_end_skip=5, max_del_occ=10, max_entries=2000000,
                max_top2=30, max_seed_diff=2, seed_len=32, mode=3,
                max_iters=768)


@pytest.mark.parametrize("S, H, L, SL1", [(256, 32, 128, 33),
                                          (1024, 128, 128, 33),
                                          (2, 1, 32, 1), (33, 7, 96, 97),
                                          (52192, 128, 32, 33),
                                          (1024, 128, 7168, 7169)])
def test_dfs_state_bytes_match_python(lib, S, H, L, SL1):
    """C1's state size a read (dfs_warp.cuh `dfs_state_bytes`) equals its
    Python mirror, which picks the wrapper's state form."""
    params = dfs_cuda.param_words(0, 0, 0, [0] * 5, 1000, L, SL1,
                                  stack_cap=S, hits_cap=H, **_STATICS)
    got = dfs_state_bytes(lib, params)
    assert got == dfs_cuda.dfs_smem_bytes(S, H, L, SL1)
    assert got % 16 == 0
    words = 5 * S + 4 * (L + 1) + 4 * SL1 + 2 * L + 4 * H
    assert 4 * words <= got < 4 * words + 16


@pytest.mark.parametrize("lanes", [0, 33])
def test_dfs_lanes_refuses_lane_counts(lib, lanes):
    """The lane harness emulates 1 to 32 lanes, a warp at most."""
    z = np.zeros((1, 2, 32), dtype=np.int32)
    one = np.zeros(1, dtype=np.int32)
    planes = np.zeros((1, 2, 33), dtype=np.int32)
    with pytest.raises(ValueError):
        dfs_lanes(lib, np.zeros(48, dtype=np.int32), 0, 0, 0, [0] * 5, 10,
                  z, one, planes, planes, planes, planes, one, one,
                  lanes=lanes, form="shared", stack_cap=256, hits_cap=32,
                  **_STATICS)


def test_local_lane_k_matches_python(lib):
    """C5's choice of form (local_sw.cuh `local_form`, asked through the
    wrapper's `dp.local_form`): the smallest of K 2-16 whose 32 lanes
    cover L1, at every width up to past the register form's last, then
    the wide form, its row state in shared memory until a warp's 9 (L1+1)
    bytes, rounded to 16, pass SMEM_STATE_BYTES."""
    from nabwa_tpu_torch.ops import dp
    for L1 in range(0, 1100):
        want = next((("registers", k) for k in (2, 4, 8, 16)
                     if 32 * k >= L1), ("shared", 16))
        assert local_form(lib, L1) == want, L1
    last = (dp.SMEM_STATE_BYTES // 16 * 16) // 9 - 1
    assert -(-9 * (last + 1) // 16) * 16 <= dp.SMEM_STATE_BYTES
    assert [local_form(lib, n) for n in (last, last + 1, 30000)] == [
        ("shared", 16), ("device", 16), ("device", 16)]


@pytest.mark.parametrize("lanes, k, form", [(0, 2, "registers"),
                                            (33, 2, "registers"),
                                            (4, 3, "wide"),
                                            (1, 32, "registers"),
                                            (4, 2, "registers")])
def test_local_lanes_refuses(lib, lanes, k, form):
    """The lane harness emulates 1 to 32 lanes of 2-16 cells, and the
    register form only where its lanes cover the window."""
    s1 = np.full((1, 10), 1, dtype=np.int32)
    one = np.full(1, 9, dtype=np.int32)
    with pytest.raises(ValueError):
        local_fwd(lib, s1, one, s1, one, np.eye(5, dtype=np.int32),
                  go=5, ge=2, lanes=lanes, k=k, form=form)
