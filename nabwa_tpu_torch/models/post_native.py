"""Host steps of samse and sampe around the native batch kernels
(native/post.cpp): the port's copy of the helpers of
nabwa_tpu/models/post_native.py that its drivers use.

The [n, NF] int64 state table (`F_*` columns) is the native kernels'
record layout.  `build_pair_keys` is the pairing-candidate assembly of
`post_native.build_pair_keys` with the SA walk passed in
(`sa_rows_both`), so the sampe driver can run it on the card's SA kernel
or on the native host walk.  The other names lose their leading
underscore here.
"""

import os

import numpy as np

from ..constants import BWA_AVG_ERR, BWA_TYPE_NO_MATCH
from ..index import native
from ..refmodel.aln_scalar import cal_maxdiff

NF = 17
(F_TYPE, F_STRAND, F_POS, F_MAPQ, F_SEQ_Q, F_C1, F_C2, F_NMM, F_NGO,
 F_NGE, F_NM, F_LEN, F_FULL_LEN, F_CLIP_LEN, F_XFLAG, F_SA,
 F_SCORE) = range(NF)

MIN_HASH_WIDTH = 1000   # bwape.h:31: wider SA intervals go through the memo

_NEG1 = 0xFFFFFFFF


def bns_emit_arrays(bns):
    """Cached flat bns arrays for the native emitter."""
    arr = getattr(bns, "_np_emit", None)
    if arr is None:
        ann_off = np.array([a.offset for a in bns.anns], dtype=np.int64)
        amb_off = np.array([h.offset for h in bns.ambs], dtype=np.int64)
        ann_len = np.array([a.length for a in bns.anns], dtype=np.int64)
        names = [a.name.encode() for a in bns.anns]
        ann_names = b"".join(names)
        ann_name_off = np.zeros(len(names) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in names], out=ann_name_off[1:])
        amb_len = np.array([h.length for h in bns.ambs], dtype=np.int32)
        amb_chr = np.frombuffer(
            b"".join(h.amb.encode() for h in bns.ambs), dtype=np.uint8) \
            if bns.ambs else np.zeros(0, dtype=np.uint8)
        arr = (ann_off, ann_len,
               np.frombuffer(ann_names, dtype=np.uint8)
               if ann_names else np.zeros(0, dtype=np.uint8),
               ann_name_off, amb_off, amb_len, amb_chr)
        bns._np_emit = arr
    return arr


def post_threads():
    """Thread fan-out for the emit/MD native kernels (0 = hardware
    concurrency; NABWA_POST_THREADS overrides)."""
    v = os.environ.get("NABWA_POST_THREADS")
    return int(v) if v else 0


def flat(chunks):
    """list of bytes/arrays -> (flat uint8 array, int64 offsets)."""
    off = np.zeros(len(chunks) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in chunks], out=off[1:])
    total = int(off[-1])
    if not total:
        return np.zeros(0, dtype=np.uint8), off
    # one C-speed join or concatenate where the chunks are all one kind
    if all(isinstance(c, (bytes, bytearray)) for c in chunks):
        return np.frombuffer(b"".join(chunks), dtype=np.uint8), off
    if all(isinstance(c, np.ndarray) for c in chunks):
        return np.ascontiguousarray(
            np.concatenate(chunks).astype(np.uint8, copy=False)), off
    out = np.empty(total, dtype=np.uint8)
    pos = 0
    for c in chunks:
        n = len(c)
        if n:
            out[pos:pos + n] = np.frombuffer(c, dtype=np.uint8) \
                if isinstance(c, (bytes, bytearray)) else c
            pos += n
    return out, off


def interleave_flats(f0, o0, f1, o1):
    """Two (flat, off) columns -> one with rows alternating 0,1,0,1... (the
    sampe emit order) via the threaded native ragged gather."""
    n = len(o0) - 1
    lens = np.empty(2 * n, dtype=np.int64)
    lens[0::2] = o0[1:] - o0[:-1]
    lens[1::2] = o1[1:] - o1[:-1]
    off = np.zeros(2 * n + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    total = int(off[-1])
    if not total:
        return np.zeros(0, dtype=np.uint8), off
    comb = np.concatenate([np.asarray(f0, dtype=np.uint8),
                           np.asarray(f1, dtype=np.uint8)])
    base = np.empty(2 * n, dtype=np.int64)
    base[0::2] = o0[:-1]
    base[1::2] = len(f0) + o1[:-1]
    out = np.empty(total, dtype=np.uint8)
    native.lib().gather_rows_u8(
        comb, base, lens, np.zeros(2 * n, dtype=np.uint8), 2 * n, out, off,
        0)
    return out, off


def pack_recs(per_read_alns):
    """per-read aln tuple lists -> (flat u32 record words, i32 counts)."""
    counts = np.array([len(a) for a in per_read_alns], dtype=np.int32)
    hits = [h for alns in per_read_alns for h in alns]
    recs = np.zeros((len(hits), 4), dtype=np.uint32)
    if hits:
        cols = np.array(hits, dtype=np.int64).T
        recs[:, 0] = ((cols[0] & 0xFF) | ((cols[1] & 0xFF) << 8)
                      | ((cols[2] & 0xFF) << 16)
                      | ((cols[3] & 1) << 24)).astype(np.uint32)
        recs[:, 1] = cols[4].astype(np.uint32)
        recs[:, 2] = cols[5].astype(np.uint32)
        recs[:, 3] = cols[6].astype(np.uint32)
    return np.ascontiguousarray(recs.reshape(-1)), counts


_MAXDIFF_CACHE = {}


def maxdiff_for(lens, fnr, max_mm):
    """Per-read max_diff (bwa_cal_maxdiff at each length, or max_mm)."""
    if fnr <= 0.0:
        return np.full(len(lens), max_mm, dtype=np.int64)
    out = np.empty(len(lens), dtype=np.int64)
    for i, ln in enumerate(lens.tolist()):
        v = _MAXDIFF_CACHE.get((ln, fnr))
        if v is None:
            v = cal_maxdiff(ln, BWA_AVG_ERR, fnr)
            _MAXDIFF_CACHE[(ln, fnr)] = v
        out[i] = v
    return out


def build_pair_keys(sa_rows_both, rev_len, state, recs, counts, hit_off,
                    n_pairs, max_occ, pos_memo):
    """Vectorised pairing-candidate assembly (bwape.c:368-396, with the
    wide-interval memo): gate each pair (both ends matched, n_occ within
    max_occ), expand every hit's SA interval to genome positions through
    one `sa_rows_both([rows0, rows1]) -> [values0, values1]` call (rows[a]
    on strand a, uint32), and pack the per-pair keys (pos<<32 | ki<<1 | j)
    for pe_pairing_batch.

    state: int64 [R, NF] with rows [0, 2*n_pairs) the interleaved ends;
    recs/counts/hit_off: the pack_recs layout over all R rows.  pos_memo
    maps a wide interval (k, l) to its positions and carries over chunks.
    Returns (flat_keys, key_off); an empty segment means the pair failed
    its gates."""
    n = n_pairs
    n2 = 2 * n
    matched = state[:n2, F_TYPE] != BWA_TYPE_NO_MATCH
    lens = state[:, F_LEN]
    nh2 = int(hit_off[n2])          # hits belonging to paired rows
    hk = recs[1:4 * nh2:4].astype(np.int64)
    hl = recs[2:4 * nh2:4].astype(np.int64)
    hw = hl - hk + 1
    hit_row = np.repeat(np.arange(n2, dtype=np.int64), counts[:n2])
    cs_w = np.zeros(nh2 + 1, dtype=np.int64)
    np.cumsum(hw, out=cs_w[1:])
    n_occ_read = cs_w[hit_off[1:n2 + 1]] - cs_w[hit_off[:n2]]
    pair_ok = (matched[0::2] & matched[1::2]
               & (n_occ_read[0::2] <= max_occ)
               & (n_occ_read[1::2] <= max_occ))
    hsel = pair_ok[hit_row >> 1]
    sk = hk[hsel]
    sw = hw[hsel]
    srow = hit_row[hsel]
    sstrand = ((recs[0:4 * nh2:4][hsel].astype(np.int64) >> 24) & 1)
    ski = (np.arange(nh2, dtype=np.int64)
           - hit_off[:n2][hit_row])[hsel]
    stag = (ski << 1) | (srow & 1)
    slen = lens[srow]
    spair = srow >> 1
    wide = sw >= MIN_HASH_WIDTH

    # expansion jobs: direct hits in order + first-seen wide intervals
    d_k, d_w, d_strand, d_len = sk[~wide], sw[~wide], sstrand[~wide], \
        slen[~wide]
    wide_jobs = []          # (key, k, w, strand, len) first-seen wides
    wide_hits = []          # (pair, tag, key) every selected wide hit
    if wide.any():
        for kk, ww, st_, ln_, pr, tg in zip(
                sk[wide].tolist(), sw[wide].tolist(),
                sstrand[wide].tolist(), slen[wide].tolist(),
                spair[wide].tolist(), stag[wide].tolist()):
            key = (kk, kk + ww - 1)
            if key not in pos_memo:
                pos_memo[key] = ("pending", len(wide_jobs))
                wide_jobs.append((key, kk, ww, st_, ln_))
            wide_hits.append((pr, tg, key))
    j_k = np.concatenate([d_k, np.array([t[1] for t in wide_jobs],
                                        dtype=np.int64)])
    j_w = np.concatenate([d_w, np.array([t[2] for t in wide_jobs],
                                        dtype=np.int64)])
    j_strand = np.concatenate([d_strand,
                               np.array([t[3] for t in wide_jobs],
                                        dtype=np.int64)])
    j_len = np.concatenate([d_len, np.array([t[4] for t in wide_jobs],
                                            dtype=np.int64)])
    cw = np.zeros(len(j_w) + 1, dtype=np.int64)
    np.cumsum(j_w, out=cw[1:])
    tot = int(cw[-1])
    expanded = np.zeros(tot, dtype=np.uint64)
    if tot:
        rows_sa = (np.repeat(j_k, j_w)
                   + (np.arange(tot, dtype=np.int64)
                      - np.repeat(cw[:-1], j_w)))
        jstr = np.repeat(j_strand, j_w) != 0
        jlen = np.repeat(j_len, j_w)
        jsels = [~jstr, jstr]
        vals = sa_rows_both([rows_sa[jsel].astype(np.uint32)
                             for jsel in jsels])
        for a in (1, 0):
            v = vals[a].astype(np.int64)
            if a:
                expanded[jsels[a]] = v.astype(np.uint64)
            else:
                expanded[jsels[a]] = ((rev_len - (v + jlen[jsels[a]]))
                                      & _NEG1).astype(np.uint64)
    n_dir = len(d_k)
    dir_base = int(cw[n_dir])      # direct expansions occupy [0, dir_base)
    for wj, (key, kk, ww, _s, _l) in enumerate(wide_jobs):
        o = int(cw[n_dir + wj])
        pos_memo[key] = expanded[o:o + ww].copy()

    # per-pair key assembly: direct block then wide block
    dir_cnt = np.bincount(spair[~wide], weights=sw[~wide],
                          minlength=n).astype(np.int64) if n_dir else \
        np.zeros(n, dtype=np.int64)
    wide_cnt = np.zeros(n, dtype=np.int64)
    for pr, tg, key in wide_hits:
        wide_cnt[pr] += len(pos_memo[key])
    key_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(dir_cnt + wide_cnt, out=key_off[1:])
    flat_keys = np.zeros(int(key_off[-1]), dtype=np.uint64)
    if n_dir:
        elem_pair = np.repeat(spair[~wide], d_w)
        dstart = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(dir_cnt, out=dstart[1:])
        slots = key_off[:-1][elem_pair] + (
            np.arange(dir_base, dtype=np.int64) - dstart[:-1][elem_pair])
        flat_keys[slots] = ((expanded[:dir_base] << np.uint64(32))
                            | np.repeat(stag[~wide], d_w)
                            .astype(np.uint64))
    if wide_hits:
        cursor = (key_off[:-1] + dir_cnt).copy()
        for pr, tg, key in wide_hits:
            posv = pos_memo[key]
            m = len(posv)
            flat_keys[cursor[pr]:cursor[pr] + m] = \
                (posv.astype(np.uint64) << np.uint64(32)) | np.uint64(tg)
            cursor[pr] += m
    return flat_keys, key_off
