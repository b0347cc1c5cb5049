"""Elastic work distribution: chunk leases with at-least-once redelivery.
The port's copy of nabwa_tpu/parallel/scheduler.py, local worker threads
only: the remote workers of `parallel/net.py` (the `worker` command and
`bam2bam -p`) are not ported, so `run_distributed` has no coordinator, and
the knobs no local caller sets (the in-flight window, the attempt cap and
the lease as arguments) are fixed: `LEASE_S`, `MAX_ATTEMPTS`.

The replacement for the reference's ZeroMQ I/O multiplexor
(run_io_multiplexor, bam2bam.c:1462-1715).  The reference keeps a 512k-record
ring with cursors next_output <= next_undone <= next_resend <= next_send <=
next_free, sends fresh work in order, re-sends unacknowledged records
round-robin when idle, drops duplicate/stale results by recno, and restores
input order for the writer.  Here the unit is a CHUNK of records (a device
batch) instead of a single read, and workers are threads sharing one
engine; the semantics carried over 1:1:

- at-least-once: an expired lease re-issues the chunk to the next idle
  worker (a failed chunk job and a straggler are both this one case);
- idempotent dedup: the first completed copy of a chunk wins, later
  duplicates are counted and dropped (bam2bam.c:1620-1647);
- ordered output: results release to the writer strictly in chunk order
  (the recno ring, bam2bam.c:1551-1574);
- determinism: chunk payloads are pure functions of the chunk id, and the
  per-read RNG is derived from absolute record numbers, so redelivered work
  reproduces byte-identical results.
"""

import sys
import threading
import time
import traceback

# a lease long enough that a legitimately slow chunk is never re-issued to
# a second worker: the reference's resend sweep (bam2bam.c:8,1577-1601)
LEASE_S = 90.0
# redeliveries of a chunk that keeps failing before the pass aborts
MAX_ATTEMPTS = 16


class ChunkScheduler:
    """Lease-tracked scheduler over a fixed sequence of chunk ids."""

    def __init__(self, n_chunks):
        """n_chunks=None starts in STREAMING mode: chunks appear via
        append() while workers run (the reference's mux drains records
        as the reader produces them, bam2bam.c:1462-1530) and
        close_input() marks the end of input."""
        self.input_open = n_chunks is None
        self.n_chunks = 0 if n_chunks is None else n_chunks
        self.poisoned = None         # (chunk id, attempts) once a chunk
                                     # exhausts MAX_ATTEMPTS
        self.lock = threading.Lock()
        self.next_fresh = 0          # next never-issued chunk
        self.next_output = 0         # next chunk the writer needs
        self.done = {}               # chunk id -> result (until released)
        self.completed = set()       # chunk ids finished (forever)
        self.leases = {}             # chunk id -> (deadline, count)
        self.total_resends = 0
        self.total_dups = 0

    def acquire(self, now=None):
        """Next chunk to work on, or None.  Fresh chunks go out in order;
        when none is left, the oldest expired lease is re-issued (the mux
        resend sweep, bam2bam.c:1577-1601)."""
        now = time.monotonic() if now is None else now
        with self.lock:
            if self.next_fresh < self.n_chunks:
                cid = self.next_fresh
                self.next_fresh += 1
                self.leases[cid] = (now + LEASE_S, 1)
                return cid
            # re-issue expired leases, lowest chunk id first
            expired = [cid for cid, (dl, _) in self.leases.items()
                       if dl <= now and cid not in self.completed]
            if expired:
                cid = min(expired)
                dl, cnt = self.leases[cid]
                self.leases[cid] = (now + LEASE_S, cnt + 1)
                self.total_resends += 1
                return cid
            return None

    def fail(self, cid, now=None):
        """Report a KNOWN failure: shorten the lease so the chunk re-issues
        soon instead of waiting out the full timeout.  The re-issue delay
        grows exponentially with the attempt count so a deterministically
        failing chunk can't hot-spin the workers, and after MAX_ATTEMPTS
        the pass is poisoned and aborts."""
        now = time.monotonic() if now is None else now
        with self.lock:
            if cid in self.leases and cid not in self.completed:
                _, cnt = self.leases[cid]
                if cnt >= MAX_ATTEMPTS:
                    self.poisoned = (cid, cnt)
                    return
                delay = min(2.0, 0.05 * (2 ** (cnt - 1)))
                self.leases[cid] = (now + delay, cnt)

    def complete(self, cid, result):
        """Submit a result.  Returns False for duplicates (dropped)."""
        with self.lock:
            if cid in self.completed:
                self.total_dups += 1
                return False
            self.completed.add(cid)
            self.done[cid] = result
            self.leases.pop(cid, None)
            return True

    def release_ready(self):
        """Results ready for the writer, strictly in order."""
        out = []
        with self.lock:
            while self.next_output in self.done:
                out.append((self.next_output, self.done.pop(self.next_output)))
                self.next_output += 1
        return out

    def append(self, n=1):
        """Streaming mode: n more chunks are now available."""
        with self.lock:
            self.n_chunks += n

    def close_input(self):
        with self.lock:
            self.input_open = False

    @property
    def finished(self):
        with self.lock:
            return (not self.input_open
                    and self.next_output == self.n_chunks)


def run_distributed(chunks, work_fn, n_workers, writer=None,
                    worker_wrapper=None, producer=None):
    """Drive chunks through worker threads with redelivery; returns
    (ordered results, the scheduler).

    work_fn(chunk_id, payload) -> result.  worker_wrapper lets tests inject
    failures/delays around work_fn per worker.

    producer: optional callable(append) run on its own thread; it
    appends payloads to `chunks` via append(payload) while the workers
    drain them (input overlapped with compute).  chunks then starts as
    an empty list owned by this call.
    """
    if n_workers < 1:
        raise ValueError("run_distributed needs at least one local worker "
                         "(remote workers are not ported)")
    sched = ChunkScheduler(None if producer else len(chunks))
    results = []
    # Writer calls must be serialized AND ordered: release_ready() pops in
    # order under the scheduler lock, but without this lock worker A could
    # pop chunk 0, get preempted, and worker B pop+write chunk 1 first.
    # Each lock holder re-runs release_ready() fresh, so the global writer
    # sequence is strictly chunk-ordered.
    writer_lock = threading.Lock()
    _logged_failures = set()

    def drain_to_writer():
        with writer_lock:
            for oid, r in sched.release_ready():
                assert oid == len(results)   # strict order by design
                results.append(r)
                if writer:
                    writer(oid, r)

    def worker(wid):
        fn = worker_wrapper(wid, work_fn) if worker_wrapper else work_fn
        while not sched.finished:
            if sched.poisoned is not None:
                return
            cid = sched.acquire()
            if cid is None:
                if sched.finished:
                    return
                time.sleep(0.01)
                continue
            try:
                res = fn(cid, chunks[cid])
            except Exception:
                # lease expires; chunk will be re-issued (at-least-once,
                # bam2bam.c:1586-1596) — but a deterministic bug would
                # spin forever silently, so log the first failure per
                # chunk
                if cid not in _logged_failures:
                    _logged_failures.add(cid)
                    print(f"[scheduler] work_fn failed on chunk {cid} "
                          f"(will re-issue):", file=sys.stderr)
                    traceback.print_exc()
                sched.fail(cid)
                continue
            if res is not None:
                sched.complete(cid, res)
            drain_to_writer()

    prod_err = []
    prod_thread = None
    if producer is not None:
        def run_producer():
            try:
                def append(payload):
                    chunks.append(payload)
                    sched.append()
                producer(append)
            except BaseException as e:   # workers must not wait forever
                prod_err.append(e)
            finally:
                sched.close_input()
        prod_thread = threading.Thread(target=run_producer)
        prod_thread.start()
    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if prod_thread is not None:
        prod_thread.join()
    if prod_err:
        raise prod_err[0]
    if sched.poisoned is not None:
        cid, cnt = sched.poisoned
        raise RuntimeError(
            f"chunk {cid} failed {cnt} times; aborting the pass")
    drain_to_writer()
    return results, sched
