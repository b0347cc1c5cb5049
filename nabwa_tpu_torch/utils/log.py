"""Timers, throughput telemetry and counters: the port's copy of
nabwa_tpu/utils/log.py.

Mirrors the reference's observability surface: per-stage wall timers with
"[tag] %.2f sec" stderr lines (bwtaln.c:210-247, bwase.c:698-709), the
output thread's 16-sample records/s EMA printed in kHz every >=10 s
(bam2bam.c:1355-1366), and end-of-run counter totals (bam2bam.c:1709).
"""

import sys
import time
from contextlib import contextmanager


class StageTimers:
    """Accumulating per-stage timers (the reference accumulates clock()
    deltas across chunks, printing running totals per chunk)."""

    def __init__(self, tag):
        self.tag = tag
        self.totals = {}

    @contextmanager
    def __call__(self, stage):
        t0 = time.monotonic()
        yield
        self.totals[stage] = self.totals.get(stage, 0.0) \
            + (time.monotonic() - t0)

    def report(self, stage):
        print(f"[{self.tag}] {self.totals.get(stage, 0.0):.2f} sec, {stage}",
              file=sys.stderr)

    def report_all(self):
        for stage in self.totals:
            self.report(stage)


class RateEMA:
    """records/s telemetry as a 16-sample EMA in kHz, printed every >=10 s
    (run_output_thread, bam2bam.c:1355-1366).  Feed it absolute record
    numbers; it reports on every 0x100-aligned recno once 10 s have
    passed."""

    def __init__(self, tag="run_output_thread", interval=10.0):
        self.tag = tag
        self.interval = interval
        self.t0 = time.monotonic()
        self.lastrn = 0
        self.rate = -1.0

    def update(self, recno):
        if recno % 0x100:
            return
        t1 = time.monotonic()
        sec = t1 - self.t0
        if sec < self.interval:
            return
        inst = (recno - self.lastrn) / (1000.0 * sec)
        self.rate = inst if self.rate < 0 else (inst + 15 * self.rate) * 0.0625
        print(f"[{self.tag}] {recno - self.lastrn} records received in "
              f"{sec:0.2f}s, rate = {self.rate:.1f} kHz.", file=sys.stderr)
        self.lastrn = recno
        self.t0 = t1

    def final(self, recno):
        print(f"[{self.tag}] {recno} records received in total.",
              file=sys.stderr)


class Counters(dict):
    """Named counters surfaced at exit (mux totals, rescue tallies)."""

    def bump(self, name, by=1):
        self[name] = self.get(name, 0) + by

    def report(self, tag):
        if self:
            body = ", ".join(f"{k} {v}" for k, v in sorted(self.items()))
            print(f"[{tag}] {body}.", file=sys.stderr)
