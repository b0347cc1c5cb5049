"""The port's hybrid host/card split on the CPU, against nabwa_tpu.

- `plan_device_share`: the seven cases of tests/test_hybrid_split.py on
  the port's copy, and a hypothesis case holding it equal to
  `nabwa_tpu.models.aln.plan_device_share` over random rates, cores,
  latencies and chunk sizes.
- `update_rates`, the rate EMAs: a card whose collect runs after the host
  drain keeps its share over 10 chunks, where the JAX package's threadless
  formula (nabwa_tpu/models/aln.py:373-386, modelled here) shrinks it
  toward an eighth; the first device-only chunk stays out; a one-sided
  window leaves the other rate alone; an engine's first device window,
  made slow, stays out, so the card keeps its share.
- `AlnEngine.run_hybrid` called directly on the CPU device (the plain
  versions), with the device share pinned at 0, one slice and every read,
  and with overflow forced by a small stack: the `.sai` bytes equal
  `nabwa_tpu aln`'s on tests/test_torch_aln.py's 96-read fixture, and the
  counters add up to the read count.
- NABWA_HOST_FRAC=0, NABWA_DEV_SHARE and NABWA_FORCE_NATIVE route as the
  JAX engine does.
Tolerance: exact (integers, whole files).
"""

import concurrent.futures
import sys
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from nabwa_tpu.index.fmindex import BwaIndex as JaxIndex
from nabwa_tpu.io import fastq as jfastq
from nabwa_tpu.models import aln as jaln
from nabwa_tpu.options import GapOpt as JaxGapOpt
from nabwa_tpu_torch.index.fmindex import BwaIndex
from nabwa_tpu_torch.io import fastq, sai
from nabwa_tpu_torch.models import aln as maln
from nabwa_tpu_torch.models import samse as psamse
from nabwa_tpu_torch.models.aln import (AlnEngine, hybrid_route,
                                        plan_device_share, update_rates)
from nabwa_tpu_torch.options import GapOpt

from .test_torch_aln import data  # noqa: F401  (the 96-read fixture)
from .test_torch_bwasw import jax_native  # noqa: F401

N_READS = 96


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (see tests/test_torch_extend.py): the plain
    versions are loops of small tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_knobs(monkeypatch):
    for name in (maln.HOST_FRAC_ENV, maln.DEV_SHARE_ENV,
                 maln.FORCE_NATIVE_ENV):
        monkeypatch.delenv(name, raising=False)


# --- plan_device_share: the twins of tests/test_hybrid_split.py ---
# (their rates and latencies are that file's synthetic inputs, not
# measurements of any device)

def plan(n=32768, batch=1024, dev=8_000.0, host=25_000.0, cores=4,
         lat=0.12):
    return plan_device_share(n, batch, dev, host, cores, lat)


def test_fast_device_takes_majority():
    n_dev = plan(dev=100_000.0, host=25_000.0)
    assert n_dev >= 16384, n_dev
    assert n_dev % 1024 == 0
    assert n_dev < 32768


def test_slow_tunnel_is_benched():
    assert plan(dev=6_000.0, host=25_000.0) == 0


def test_marginal_device_gets_some_work():
    n_dev = plan(dev=8_000.0, host=25_000.0)
    assert n_dev > 0
    assert n_dev % 1024 == 0


def test_short_chunk_is_host_only():
    assert plan(n=2048, dev=8_000.0, host=25_000.0) == 0


def test_latency_guard_sheds_slices():
    free = plan(dev=50_000.0, host=25_000.0, lat=0.0)
    taxed = plan(dev=50_000.0, host=25_000.0, lat=1.0)
    assert taxed <= free


def test_device_share_never_exceeds_chunk():
    assert plan(n=1024, batch=1024, dev=1e9, host=1.0, lat=0.0) <= 1024


def test_many_cores_raise_the_bar():
    assert plan(dev=7_000.0, host=25_000.0, cores=16) > 0
    assert plan(dev=7_000.0, host=25_000.0, cores=1) == 0


@settings(max_examples=400, deadline=None)
@given(n=st.integers(1, 1 << 20),
       batch=st.sampled_from([64, 256, 1000, 1024, 2048, 4096]),
       dev=st.floats(1.0, 1e7), host=st.floats(1.0, 1e7),
       cores=st.integers(0, 256), lat=st.floats(0.0, 2.0))
def test_plan_matches_jax(n, batch, dev, host, cores, lat):
    assert plan_device_share(n, batch, dev, host, cores, lat) == \
        jaln.plan_device_share(n, batch, dev, host, cores, lat)


# --- update_rates ---

def threadless_update(dev_rate, host_rate, n_dev, n_host, host_s, collect_s):
    """The JAX package's EMAs (nabwa_tpu/models/aln.py:371-386) when the
    device finishes inside the host drain and its collect runs after it:
    the device window is dispatch -> last collect, kept only when the
    collect outlived the drain by 10 % of that window."""
    window = host_s + collect_s
    if n_dev and collect_s > 0.1 * window:
        dev_rate = 0.5 * dev_rate + 0.5 * n_dev / window
    if n_host:
        host_rate = 0.5 * host_rate + 0.5 * n_host / host_s
    return dev_rate, host_rate


def test_card_keeps_its_share_when_collect_follows_the_drain():
    """A card route of 34k reads/s (its own window, collect included)
    beside a host engine of 37.5k on 8 cores (32.8k on the 7 the hybrid
    leaves it), collect ~19 us a read: the port's update holds the card
    at its proportional share for 10 chunks; the threadless formula
    starves it to an eighth of the reads."""
    n, batch, cores, lat = 32768, 2048, 8, 0.01
    card, host, collect = 34_000.0, 37_500.0, 0.630 / 32768
    dev0, host0 = 34_000.0, 37_500.0
    d, h = None, None
    shares = []
    for _ in range(10):
        n_dev = plan_device_share(n, batch, d or dev0, h or host0, cores,
                                  lat)
        d, h = update_rates(d, h, n_dev, lat + n_dev / card, n - n_dev,
                            (n - n_dev) / (host * 7 / 8))
        shares.append(n_dev / n)
    assert min(shares) >= 0.4, shares
    assert abs(d - card) < 0.03 * card
    d, h = dev0, host0
    jax_shares = []
    for _ in range(10):
        n_dev = plan_device_share(n, batch, d, h, cores, lat)
        d, h = threadless_update(d, h, n_dev, n - n_dev, (n - n_dev) / host,
                                 n_dev * collect)
        jax_shares.append(n_dev / n)
    assert jax_shares[-1] <= 0.15 and jax_shares[0] >= 0.4, jax_shares


def test_first_device_only_chunk_stays_out():
    d, h = update_rates(None, None, 2048, 10.0, dev_warmed=False)
    assert (d, h) == (None, None)
    d, h = update_rates(d, h, 2048, 0.1)
    assert d == pytest.approx(20480.0) and h is None
    d, _ = update_rates(d, h, 4096, 0.1, dev_warmed=False)
    assert d == pytest.approx(20480.0)
    d, _ = update_rates(d, h, 4096, 0.1)
    assert d == pytest.approx(0.5 * 20480.0 + 0.5 * 40960.0)


def test_one_sided_window_leaves_the_other_rate():
    d, h = update_rates(30_000.0, 20_000.0, 0, 0.0, 8192, 0.2)
    assert d == 30_000.0 and h == pytest.approx(0.5 * 20_000 + 0.5 * 40960)
    d, h = update_rates(30_000.0, 20_000.0, 8192, 0.2, 0, 0.0)
    assert h == 20_000.0 and d == pytest.approx(0.5 * 30_000 + 0.5 * 40960)
    assert update_rates(None, None) == (None, None)


# --- the hybrid route on the CPU device ---

def _reads(d):
    return fastq.read_fastq_batch(fastq.iter_fastq(str(d / "r.fq")), 1000)


def _sai(opt, res):
    return opt.pack() + sai.pack_aln_block([a for a, _ in res])


def _counted(eng):
    return (eng.tier0_reads + eng.retry_reads + eng.host_drain_reads
            + eng.hybrid_host_reads)


@pytest.mark.parametrize("n_dev,small_stack", [
    (0, False), (32, False), (N_READS, False), (N_READS, True)],
    ids=["host_only", "one_slice", "every_read", "overflow"])
def test_hybrid_route_matches_jax(data, n_dev, small_stack):  # noqa: F811
    d, want = data
    opt = GapOpt()
    kw = (dict(stack_cap=12, retry_stack_cap=40, tier0_max_iters=60)
          if small_stack else {})
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), opt, "cpu", **kw)
    reads = _reads(d)
    res = eng.run_hybrid(reads, device_batch=32, n_dev=n_dev)
    assert _sai(opt, res) == want
    assert _counted(eng) == N_READS
    assert eng.retry_reads == 0
    assert eng.hybrid_host_reads == N_READS - n_dev
    assert eng.tier0_reads + eng.host_drain_reads == n_dev
    if small_stack:
        assert eng.host_drain_reads > 0 and eng.tier0_reads > 0
    # the engine's first device window stays out of the rate EMA
    assert eng.dev_rate is None
    assert (eng.host_rate is not None) == (n_dev < N_READS)
    assert (eng.seconds["hybrid_device"] > 0) == (n_dev > 0)
    assert (eng.seconds["hybrid_host"] > 0) == (n_dev < N_READS)
    # its next device window enters it (with n_dev 0 that is its first)
    eng.run_hybrid(reads[:32], device_batch=32, n_dev=32)
    assert (eng.dev_rate is not None) == (n_dev > 0)


class _ThreadClock:
    """A stand-in for the `time` module of nabwa_tpu_torch.models.aln
    whose `perf_counter` reads a clock of the calling thread's own: each
    call moves it on by STEP seconds, and `add` moves the calling thread's
    on by more.  The hybrid's windows (the card route on its helper thread,
    the host drain on the caller's) then last a fixed step a call they
    make, whatever the machine's speed and the threads' interleaving."""
    STEP = 1e-3

    def __init__(self):
        self._now = threading.local()

    def _get(self):
        return getattr(self._now, "t", 0.0)

    def perf_counter(self):
        self._now.t = self._get() + self.STEP
        return self._now.t

    def add(self, seconds):
        self._now.t = self._get() + seconds


def test_slow_first_device_window_keeps_the_card(data,  # noqa: F811
                                                 monkeypatch):
    """An engine's first device window, made slow here as a kernel build
    inside it would make it (2 s more on the window's clock), stays out of
    the rate EMA: the plan at the bench's size (262,144 reads, batch 2048,
    8 cores) still gives the card a share, where that window taken as it
    is would bench the card for every later chunk.  The next window enters
    the EMA.  The windows' seconds come from `_ThreadClock`, not the wall
    clock."""
    d, want = data
    opt = GapOpt()
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), opt, "cpu")
    reads = _reads(d)
    device_pass = eng._device_pass
    calls = []
    clock = _ThreadClock()
    monkeypatch.setattr(maln, "time", clock)

    def first_slow(*args, **kw):
        if not calls:
            clock.add(2.0)
        calls.append(1)
        return device_pass(*args, **kw)

    monkeypatch.setattr(eng, "_device_pass", first_slow)

    def bench_plan(dev_rate):
        return plan_device_share(262_144, 2048,
                                 dev_rate or AlnEngine.DEV_RATE0,
                                 eng.host_rate, 8, AlnEngine.DEV_LAT)

    assert _sai(opt, eng.run_hybrid(reads, 32, n_dev=64)) == want
    assert eng.dev_rate is None and eng.host_rate > 0
    assert bench_plan(eng.dev_rate) > 0
    slow_rate, _ = update_rates(None, None, 64,
                                eng.seconds["hybrid_device"])
    assert bench_plan(slow_rate) == 0
    assert _sai(opt, eng.run_hybrid(reads, 32, n_dev=64)) == want
    assert len(calls) == 2 and eng.dev_rate > slow_rate


def test_hybrid_columnar_batch_matches_list(data):  # noqa: F811
    """A ReadBatch and a list of Read objects split the same way give the
    same results."""
    d, _ = data
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(), "cpu")
    reads = _reads(d)
    assert eng.run_hybrid(reads, device_batch=32, n_dev=64) == \
        eng.run_hybrid(list(reads), device_batch=32, n_dev=64)


def test_threads_share_a_hybrid_engine(data):  # noqa: F811
    """Six threads (more than the cores the drain leaves) split chunks on
    one engine at a short switch interval: every result equals the JAX
    `.sai`, and the counters and both EMAs' updates add up."""
    d, want = data
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(), "cpu",
                    stack_cap=12, retry_stack_cap=40, tier0_max_iters=60)
    reads = _reads(d)
    n_threads = 6
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(n_threads) as pool:
            futs = [pool.submit(eng.run_hybrid, reads, 32, 32)
                    for _ in range(n_threads)]
            done, pending = concurrent.futures.wait(futs, timeout=600)
        assert not pending
        outs = [f.result() for f in futs]
    finally:
        sys.setswitchinterval(old)
    assert all(_sai(GapOpt(), res) == want for res in outs)
    assert _counted(eng) == n_threads * N_READS
    assert eng.hybrid_host_reads == n_threads * (N_READS - 32)
    assert eng.dev_rate > 0 and eng.host_rate > 0


# --- the knobs ---

def test_gate_is_the_jax_gate():
    """The gate of nabwa_tpu/models/aln.py:328-330 with the accelerator
    read as CUDA: at least 256 reads, no mesh, host_frac > 0."""
    assert hybrid_route(256, "cuda", None, 0.5)
    assert not hybrid_route(255, "cuda", None, 0.5)
    assert not hybrid_route(4096, "cpu", None, 0.5)
    assert not hybrid_route(4096, "cuda", ("cuda:0",), 0.5)
    assert not hybrid_route(4096, "cuda", None, 0.0)


@pytest.mark.parametrize("env", [None, "0", "0.25"])
def test_host_frac_as_jax(data, monkeypatch, env):  # noqa: F811
    """host_frac: "auto" is 0.5, NABWA_HOST_FRAC overrides the argument,
    and 0 turns the hybrid off, as on the JAX engine."""
    d, _ = data
    if env is not None:
        monkeypatch.setenv(maln.HOST_FRAC_ENV, env)
    jeng = jaln.AlnEngine(JaxIndex.load(str(d / "g.fa")), JaxGapOpt())
    jeng_arg = jaln.AlnEngine(JaxIndex.load(str(d / "g.fa")), JaxGapOpt(),
                              host_frac=0.75)
    idx = BwaIndex.load(str(d / "g.fa"))
    eng = AlnEngine(idx, GapOpt(), "cpu")
    eng_arg = AlnEngine(idx, GapOpt(), "cpu", host_frac=0.75)
    assert eng.host_frac == jeng.host_frac
    assert eng_arg.host_frac == jeng_arg.host_frac
    assert hybrid_route(4096, "cuda", None, eng.host_frac) == (env != "0")


@pytest.mark.parametrize("share", ["0.5", "1", "0.1"])
def test_dev_share_as_jax(data, monkeypatch, share):  # noqa: F811
    """NABWA_DEV_SHARE pins the device share in whole slices
    (nabwa_tpu/models/aln.py:341-347)."""
    d, want = data
    monkeypatch.setenv(maln.DEV_SHARE_ENV, share)
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(), "cpu")
    res = eng.run_hybrid(_reads(d), device_batch=32)
    n_dev = min(N_READS, (int(float(share) * N_READS) // 32) * 32)
    assert _sai(GapOpt(), res) == want
    assert eng.hybrid_host_reads == N_READS - n_dev
    assert eng.tier0_reads + eng.host_drain_reads == n_dev


def test_force_native_as_jax(jax_native, data,  # noqa: F811
                             monkeypatch):
    """NABWA_FORCE_NATIVE: every read on the host engine, on the batch and
    the per-read paths, and SA rows on the native walk; the JAX engine
    routes the same reads to its native engine and gets the same hits."""
    d, want = data
    monkeypatch.setenv(maln.FORCE_NATIVE_ENV, "1")
    idx = BwaIndex.load(str(d / "g.fa"))
    eng = AlnEngine(idx, GapOpt(), "cpu")
    reads = _reads(d)
    res = eng.run_chunk(reads, device_batch=32)
    per_read = eng.run_chunk(reads, device_batch=32, per_read_semantics=True)
    assert _sai(GapOpt(), res) == want
    assert per_read == res
    assert _counted(eng) == 0 and eng.seconds["device"] == 0.0
    assert eng.seconds["drain"] > 0
    jreads = jfastq.read_fastq_batch(jfastq.iter_fastq(str(d / "r.fq")),
                                     1000)
    jeng = jaln.AlnEngine(JaxIndex.load(str(d / "g.fa")), JaxGapOpt())
    assert jeng.run_chunk(list(jreads)) == res
    calls = []
    walk = psamse.sa_rows_native
    monkeypatch.setattr(psamse, "sa_rows_native",
                        lambda *a: calls.append(a) or walk(*a))
    rows = np.random.default_rng(503).integers(
        0, idx.fwd.seq_len + 1, size=64).astype(np.uint32)
    native_vals = [eng.sa_rows(a, rows) for a in (0, 1)]
    assert len(calls) == 2
    monkeypatch.delenv(maln.FORCE_NATIVE_ENV)
    assert all(np.array_equal(v, eng.sa_rows(a, rows))
               for a, v in enumerate(native_vals))
    assert all(np.array_equal(v, jeng.sa_rows(a, rows))
               for a, v in enumerate(native_vals))


def test_per_read_groups_stay_on_the_cpu_tiers(data):  # noqa: F811
    """Measured rates that would send per-read groups to the host engine on
    the card leave the CPU device on its plain tiers."""
    d, want = data
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(), "cpu",
                    stack_cap=12, retry_stack_cap=40, tier0_max_iters=60)
    eng.dev_rate, eng.host_rate = 1.0, 1e9
    res = eng.run_chunk(_reads(d), device_batch=64, per_read_semantics=True)
    assert _sai(GapOpt(), res) == want
    assert eng.hybrid_host_reads == 0 and eng.tier0_reads > 0
