"""The DFS-iteration mock of scripts/probe_dfs_shape.py on the card.

    python -m nabwa_tpu_torch.probes.probe_dfs_shape [--device cuda|cpu] [BB] [S] [ITERS]

`run(seed, table, s, iters)` (scripts/probe_dfs_shape.py:23-125,
pallas_call at :118): BB reads with S slots each, ITERS iterations.  Each
iteration pops the lowest-index slot holding the minimum key and gathers
its four fields, loads two rows of the [4096, 128] int32 table, counts
masked popcounts over both, runs ten rounds of column arithmetic and
pushes up to 9 candidates into the lowest free slots.  The result is the
int32 sum of the first row's count over reads and iterations, [1, 1].

On CUDA tensors kernel C9 (csrc/probe_dfs_shape.cu) runs it, one warp per
read; on CPU tensors the plain version below.  S must be a multiple of 32
up to 128.  C9 has two forms: `run_cuda` launches the lean one (its
reductions one redux.sync each, the counts from the rows' blocks, a
one-pass push), `run_witness_cuda` the first design, kept as
the witness that the lean one is timed against; `run_stamped_cuda` runs
either with clock64 stamps and returns each stage's cycles (S 128 only).
`main` makes the script's inputs (unseeded `np.random`, as there), times
10 calls after a warm-up (CUDA events on the card) and prints the
script's line.
"""

import sys

import numpy as np
import torch

from ..ops import _build
from . import common
from .common import FREE_KEY, popcount32, wrap32, wsum

I32 = torch.int32
NROW = 4096           # scripts/probe_dfs_shape.py:18
SHIFTS = (1, 2, 4, 8, 16, 32, 64)
# the stamped form: an iteration's stages, in order, and the calibration
# words a read after them (csrc/probe_dfs_shape.cu STAGES, CAL)
STAGES = ("pop", "loads", "counts", "expand", "push")
CAL = ("imad", "colops", "redux", "shfl", "lds", "cycles", "ns", "sink")
# the steps of each calibration chain (CAL_INT_STEPS, CAL_WARP_STEPS)
CAL_STEPS = {"imad": 64, "colops": 64, "redux": 32, "shfl": 32, "lds": 32}

# kernel launches made on CUDA tensors: C9's lean form by `run_cuda`, its
# witness by `run_witness_cuda`, either stamped by `run_stamped_cuda`
launches = 0
launches_witness = 0
launches_stamped = 0


def _check(seed, table, s):
    if s not in (32, 64, 96, 128):
        raise ValueError(f"S must be 32, 64, 96 or 128, got {s}")
    if seed.dim() != 2 or seed.shape[1] < s:
        raise ValueError(f"seed must be [BB, >= {s}], got "
                         f"{tuple(seed.shape)}")
    nrow = table.shape[0]
    if table.dim() != 2 or table.shape[1] != 128 or nrow & (nrow - 1):
        raise ValueError("table must be [NROW, 128], NROW a power of two; "
                         f"got {tuple(table.shape)}")


def word_counts(rows):
    """The masked popcounts of each word of staged rows int64 [R, 128]
    (:59-72), 0 outside each row's 8-word block: int64 [R, 128]."""
    words = torch.arange(128, dtype=torch.int64, device=rows.device)[None]
    rel = words - (rows[:, :1] & 7) * 16
    wordoff = (rows[:, 1:2] >> 4) & 7
    inblk = (rel >= 4) & (rel < 12)
    vm = torch.where(rel - 4 < wordoff, -1,
                     torch.where(rel - 4 == wordoff, -65536, 0))
    lo = rows & vm & 0x55555555
    hi = (rows >> 1) & vm & 0x55555555
    p1, p2, p3 = popcount32(lo), popcount32(hi), popcount32(lo & hi)
    return torch.where(inblk, p1 - p3 + p2 + p3 * 2, 0)


def expand(e0, e1, cnt_k, cnt_l):
    """The ten rounds of column arithmetic (:78-87): (a, b); candidate j
    is a + j, valid where bit j of b is 0."""
    a = wrap32(e0 + cnt_k)
    b = wrap32(e1 + cnt_l)
    for j in range(10):
        a = torch.where(a > b, wrap32(a - b), wrap32(a + j))
        b = b ^ (a >> 2)
        a = wrap32(a + (b & 15))
        b = torch.minimum(b, wrap32(a + 37))
    return a, b


def run_plain(seed, table, s, iters, touched=None):
    """The script's kernel in plain PyTorch, line for line: seed int32
    [BB, >= S], table int32 [NROW, 128] -> int32 [1, 1].  The free-slot
    prefix is built by the script's seven roll doublings (torch.roll has
    jnp.roll's direction, out[l] = in[l - sh]).  `touched`, a list,
    receives each iteration's row indices of both loads."""
    _check(seed, table, s)
    dev = seed.device
    bb, nrow = seed.shape[0], table.shape[0]
    lane = torch.arange(s, dtype=torch.int64, device=dev)[None, :]
    sd = seed[:, :s].long()
    key, f0, f1, f2, f3 = (sd, sd ^ 12345, wrap32(sd + 7), sd ^ 999,
                           wrap32(sd - 3))
    tab = table.long()
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(iters):
        # pop: min over lanes, index extract, 4 field gathers
        mk = key.min(dim=1, keepdim=True).values
        slot = torch.where(key == mk, lane, s).min(dim=1,
                                                   keepdim=True).values
        e0, e1, e2, e3 = (f.gather(1, slot) for f in (f0, f1, f2, f3))
        key = torch.where(lane == slot, FREE_KEY, key)

        # occ: 2 row loads per read, masked popcounts over both
        r_k = (e0 ^ e1) & (nrow - 1)
        r_l = (e2 ^ e3) & (nrow - 1)
        if touched is not None:
            touched += [r_k, r_l]
        rows = tab[torch.cat([r_k, r_l])[:, 0]]               # [2BB, 128]
        cnt = wsum(word_counts(rows), dim=1, keepdim=True)
        cnt_k, cnt_l = cnt[:bb], cnt[bb:]

        # expansion: ten rounds of column arithmetic, 9 candidates
        a, b = expand(e0, e1, cnt_k, cnt_l)
        cands_k = [wrap32(a + j) for j in range(9)]
        cands_v = [((b >> j) & 1) == 0 for j in range(9)]
        pref = [torch.zeros_like(a)]
        for j in range(8):
            pref.append(pref[-1] + cands_v[j].long())

        # push: candidate j into the (pref[j] + 1)-th free slot
        free = key == FREE_KEY
        frank = free.long()
        for sh in SHIFTS:
            frank = frank + torch.where(lane >= sh,
                                        torch.roll(frank, sh, 1), 0)
        for j in range(9):
            mask = cands_v[j] & free & (frank == pref[j] + 1)
            c = cands_k[j]
            key = torch.where(mask, c, key)
            f0 = torch.where(mask, c ^ 1, f0)
            f1 = torch.where(mask, wrap32(c + it), f1)
            f2 = torch.where(mask, wrap32(c - 2), f2)
            f3 = torch.where(mask, wrap32(c * 3), f3)
        acc = wrap32(acc + wsum(cnt_k))
    return acc.to(torch.int32).view(1, 1)


def _launch(seed, table, s, iters, lean, stamped=False):
    """Check C9's inputs in one pass and launch: the checks and messages
    of the one-at-a-time ones (CUDA tensors; seed's dtype, dims and
    contiguity; the table's on seed's device, and its 16-byte alignment,
    the kernel's int4 reads), then `_check`, then the stamped form's S.
    acc, and the stamped form's side buffer right after it, are one
    allocation; the library zeroes acc on the stream before the kernel.
    Returns (the buffer, whether a kernel ran): no rows launch nothing,
    and their acc is 0."""
    index, (ps, pt) = common.cuda_inputs((seed, "seed", 2, I32, 4, None),
                                         (table, "table", 2, I32))
    _check(seed, table, s)
    if stamped and s != 128:
        raise ValueError(f"the stamped form takes S 128, got {s}")
    bb = seed.shape[0]
    extra = bb * (iters * len(STAGES) + len(CAL)) if stamped else 0
    if not bb:
        return seed.new_zeros(1 + extra), False
    buf = seed.new_empty(1 + extra)
    base = buf.data_ptr()
    _build.check(_build.lib().nabwa_probe_dfs_shape(
        ps, seed.shape[1], pt, table.shape[0], bb, s, int(iters), int(lean),
        base, base + 4 if stamped else None,
        torch._C._cuda_getCurrentRawStream(index)),
        "probe_dfs_shape kernel launch")
    return buf, True


def run_cuda(seed, table, s, iters):
    """`run_plain` by kernel C9's lean form."""
    global launches
    buf, ran = _launch(seed, table, s, iters, True)
    if ran:
        with _build.count_lock:
            launches += 1
    return buf.view(1, 1)


def run_witness_cuda(seed, table, s, iters):
    """`run_plain` by C9's witness, the first design (butterflies, a
    ballot argmin, the push's 9 x K passes)."""
    global launches_witness
    buf, ran = _launch(seed, table, s, iters, False)
    if ran:
        with _build.count_lock:
            launches_witness += 1
    return buf.view(1, 1)


def run_stamped_cuda(seed, table, s, iters, lean):
    """C9's lean form (`lean`) or witness with clock64 stamps, S 128 only:
    (acc int32 [1, 1], each stage's cycles int32 [BB, ITERS, STAGES], the
    calibration words int32 [BB, len(CAL)]).  Not for timing: the stamps
    add a store and a clock read a stage."""
    global launches_stamped
    buf, ran = _launch(seed, table, s, iters, lean, True)
    if ran:
        with _build.count_lock:
            launches_stamped += 1
    bb, n = seed.shape[0], iters * len(STAGES)
    stamps = buf[1:].view(bb, n + len(CAL))
    return (buf[:1].view(1, 1), stamps[:, :n].view(bb, iters, len(STAGES)),
            stamps[:, n:])


def run(seed, table, s, iters):
    """The mock: the plain version for CPU tensors, kernel C9 for CUDA
    tensors."""
    if seed.device.type == "cpu":
        return run_plain(seed, table, s, iters)
    if seed.device.type == "cuda":
        return run_cuda(seed, table, s, iters)
    raise ValueError(f"probe_dfs_shape: no kernel for device {seed.device}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, rest = common.parse_device(argv, "probe_dfs_shape")
    if device is None:
        return 1
    if len(rest) > 3:
        print(f"[probe_dfs_shape] error: expected [BB] [S] [ITERS], got "
              f"{rest}", file=sys.stderr)
        return 1
    bb, s, iters = [int(a) for a in rest] + [256, 128, 200][len(rest):]
    print("devices:", [common.device_name(device)],
          f"BB={bb} S={s} ITERS={iters}")
    seed = np.random.randint(0, 1 << 20, (bb, max(s, 128)))
    table = np.random.randint(0, 1 << 30, (NROW, 128))
    seed_t, table_t = common.tensors(device, seed, table)
    dt, _ = common.timeit(lambda: run(seed_t, table_t, s, iters), device,
                          n=10)
    print(f"dfs-shaped {iters} iters BB={bb} S={s}: {dt*1e3:.2f}ms total, "
          f"{dt/iters*1e6:.2f}us/iter, "
          f"{bb/(dt/iters)/1e6:.1f}M lane-iters/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
