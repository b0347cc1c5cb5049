"""scripts/probe_sem.py on the card: the DMA semaphore's count per [1, 128]
int32 copy.

    K=4 python -m nabwa_tpu_torch.probes.probe_sem [--device cuda|cpu]

The script's kernel (scripts/probe_sem.py:20, pallas_call at :33) issues
K async copies of table rows 0..K-1 into a [16, 128] int32 stage, all on
one DMA semaphore, reads the semaphore right after the issues (out[0]),
then waits K times for one copy's worth (128) and reads it after each wait
(out[1 + k]); out has K + 2 words and out[K + 1] is never written
(undefined on the TPU, INT32_MIN in Pallas interpret mode, INT32_MIN
here).  K comes from the environment (default 4) and lies in 1..16, the
table's rows.

The plain version is interpret mode's semantics, where every copy lands as
it is issued: out = [128 K, 128 (K - 1), ..., 0, INT32_MIN], and the stage
holds table rows 0..K-1 above INT32_MIN.  On a CUDA tensor kernel C22
(csrc/probe_sem.cu) issues bulk async copies that complete on one mbarrier
each, and the "semaphore" is 128 x (copies landed) - 128 x (waits done).
There a read right after the issue sees only the copies that have landed,
so out[0..K-1] depends on timing; the stage, out[K] = 0 and out[K + 1]
do not.  Both versions also return the stage, a witness of the copies.

The entry point prints the script's one line.
"""

import os
import sys

import numpy as np
import torch

from ..ops import _build
from . import common

SEM_ROWS, ROW_WORDS = 16, 128      # scripts/probe_sem.py:32, :38
SEM_UNIT = 128                     # the semaphore's count of one copy
UNWRITTEN = -2**31
DEFAULT_K = 4                      # scripts/probe_sem.py:17

# kernel launches made on CUDA tensors (C22)
launches = 0


def check_k(k):
    """Raise ValueError unless 1 <= k <= 16 (the script's table has 16
    rows; its K=17 fails)."""
    if not 1 <= k <= SEM_ROWS:
        raise ValueError(f"K must lie in 1..{SEM_ROWS}, got {k}")


def sem_plain(table, k):
    """The script's kernel in plain PyTorch, every copy landing at its
    issue: table int32 [16, 128], k in 1..16 -> (out int32 [k + 2], the
    stage int32 [16, 128])."""
    check_k(k)
    out = torch.tensor([SEM_UNIT * (k - w) for w in range(k + 1)]
                       + [UNWRITTEN], dtype=torch.int32, device=table.device)
    stage = torch.full((SEM_ROWS, ROW_WORDS), UNWRITTEN, dtype=torch.int32,
                       device=table.device)
    stage[:k] = table[:k]
    return out, stage


def sem_cuda(table, k):
    """The script's kernel by kernel C22: (out, stage) as `sem_plain`,
    but out[0..k-1] as the card saw them.  table must start on a 16-byte
    boundary."""
    global launches
    dev = common.cuda_input(table, "table", 2)
    if tuple(table.shape) != (SEM_ROWS, ROW_WORDS):
        raise ValueError(f"table must be [{SEM_ROWS}, {ROW_WORDS}], got "
                         f"{tuple(table.shape)}")
    check_k(k)
    out = torch.empty(k + 2, dtype=torch.int32, device=dev)
    stage = torch.empty((SEM_ROWS, ROW_WORDS), dtype=torch.int32, device=dev)
    rc = _build.lib().nabwa_probe_sem(table.data_ptr(), k, out.data_ptr(),
                                      stage.data_ptr(), _build.stream_of(table))
    _build.check(rc, "probe_sem kernel launch")
    with _build.count_lock:
        launches += 1
    return out, stage


def sem(table, k):
    """The script's kernel: the plain version for CPU tensors, kernel C22
    for CUDA tensors.  Returns (out, stage)."""
    return common.dispatch("sem", table, sem_plain, sem_cuda, k)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, rest = common.parse_device(argv, "probe_sem")
    if device is None:
        return 1
    if rest:
        print(f"[probe_sem] takes no arguments (K from the environment), "
              f"got {rest}", file=sys.stderr)
        return 1
    try:
        k = int(os.environ.get("K", str(DEFAULT_K)))
        check_k(k)
    except ValueError as e:
        print(f"[probe_sem] {e}", file=sys.stderr)
        return 1
    table = np.arange(SEM_ROWS * ROW_WORDS).reshape(SEM_ROWS, ROW_WORDS)
    table_t, = common.tensors(device, table)
    out, _ = sem(table_t, k)
    print("sem post-issue then after each wait:", out.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
