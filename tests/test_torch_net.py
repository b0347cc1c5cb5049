"""The port's remote workers on the CPU: `parallel/net.py`, `bam2bam -p`
and `worker`, held to `nabwa_tpu` called directly.

- The wire: the two packages' `send_msg` frames are equal on a plain dict;
  the port's unpickler refuses a class of `nabwa_tpu` (or jax) and takes
  the port's own; a port worker refuses a JAX coordinator's config.
- The payloads: every chunk payload and result of both passes of the
  `dist` set (tests/test_torch_bam2bam.py) pickles without a torch object,
  round-trips through the port's unpickler to the same pickle, and pass 2
  on the round-tripped payload gives the same result.
- The runs: a coordinator (`n_workers=0`, chunks of 6 logical records)
  with an in-thread `worker_main` on the CPU (its engine's tier 0 capped
  at 32 iterations, the rest drained on the host engine, as in
  tests/test_torch_bam2bam.py, so the case stays quick) writes the BAM of
  the port's local-thread `bam2bam` and of `nabwa_tpu`'s; two `python -m
  nabwa_tpu_torch worker --device cpu` processes (`NABWA_FORCE_NATIVE`:
  the host engine, for speed; this case tests the wire) with a 3 s lease,
  one SIGKILLed once the coordinator has accepted a result of its own
  while it holds another lease, write the same BAM with at least one
  chunk resent.  The local-thread baseline runs the host reference route,
  which tests/test_torch_bam2bam.py holds to the default one.
- A worker exits on its idle timeout, and exits non-zero before it
  connects when `--device cuda` has no card.
- Two processes that load the kernel library cold at once build it once:
  `ops/_build.py::lib` holds a file lock over the check and the build
  (the build step and the library load replaced, as there is no nvcc
  here).

Every case that opens a socket or starts a process has its own time limit
(`_run`, `_join`, `subprocess` timeouts), so a hang fails that case.
Tolerance: exact, whole files.
"""

import io
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from nabwa_tpu.options import GapOpt as JaxGapOpt
from nabwa_tpu.parallel import net as jnet
from nabwa_tpu_torch import cli as port_cli
from nabwa_tpu_torch.index.fmindex import BwaIndex
from nabwa_tpu_torch.models import bam2bam as pb2b
from nabwa_tpu_torch.models.aln import AlnEngine
from nabwa_tpu_torch.options import GapOpt, PeOpt
from nabwa_tpu_torch.parallel import net
from nabwa_tpu_torch.utils.rand48 import Rand48

from .test_torch_bam2bam import (_jax_b2b, _port_b2b, made,  # noqa: F401
                                 one_torch_thread)
from .test_torch_smoke import REPO

LIMIT_S = 240


def free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(fn, *args, **kw):
    """fn on a daemon thread: (thread, result dict with "value" or
    "error")."""
    out = {}

    def body():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as e:      # reported by _join
            out["error"] = e
    t = threading.Thread(target=body, daemon=True)
    t.start()
    return t, out


def _join(t, out, limit=LIMIT_S):
    t.join(timeout=limit)
    assert not t.is_alive(), f"no end within {limit} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _cpu_engine(prefix, gopt):
    """A CPU engine whose tier 0 stops at 32 iterations, with no retry
    tier: the reads it flags drain on the bit-exact host engine."""
    return AlnEngine(BwaIndex.load(prefix), gopt, "cpu",
                     retry_stack_cap=256, max_iters=32)


def _net_b2b(d, out, port, **kw):
    """The port's bam2bam serving chunk leases on `port`, all compute
    remote (`n_workers=0`), chunks of 6 logical records."""
    idx = BwaIndex.load(str(d / "g.fa"))
    eng = AlnEngine(idx, GapOpt(), "cpu")
    pb2b.bam2bam(eng, str(d / "in.bam"), str(out), eng.opt, PeOpt(),
                 Rand48(idx.bns.seed), argv=["bam2bam"], n_workers=0,
                 chunk_size=6, port=port, prefix=str(d / "g.fa"), **kw)
    return out.read_bytes()


@pytest.fixture(scope="module")
def local_run(made, tmp_path_factory):
    """The dist set through the port's bam2bam on one local thread, the
    host reference route."""
    d = made("dist")
    return _port_b2b(d, tmp_path_factory.mktemp("local") / "local.bam",
                     host_reference=True)


class _Sock:
    """The sending half of a socket: what `sendall` was given."""

    def __init__(self):
        self.sent = b""

    def sendall(self, data):
        self.sent += data


def test_send_msg_frames_equal_jax():
    msg = {"op": "result", "phase": 2, "cid": 7, "data": [1, "two", b"3",
                                                          (4.5, None)]}
    a, b = _Sock(), _Sock()
    net.send_msg(a, msg)
    jnet.send_msg(b, msg)
    assert a.sent == b.sent and len(a.sent) > 8


def _pair():
    a, b = socket.socketpair()
    a.settimeout(30)
    b.settimeout(30)
    return a, b


def test_unpickler_refuses_nabwa_tpu():
    a, b = _pair()
    try:
        net.send_msg(a, {"op": "config", "opt": JaxGapOpt()})
        with pytest.raises(pickle.UnpicklingError, match="nabwa_tpu"):
            net.recv_msg(b)
        for mod in ("nabwa_tpu.options", "jax.numpy", "jaxlib"):
            with pytest.raises(pickle.UnpicklingError):
                net.PortUnpickler(io.BytesIO(
                    b"\x80\x04c" + mod.encode() + b"\nX\n.")).load()
        opt = GapOpt()
        opt.max_diff = 7
        net.send_msg(a, {"op": "config", "opt": opt})
        got = net.recv_msg(b)
        assert type(got["opt"]) is GapOpt and got["opt"].pack() == opt.pack()
    finally:
        a.close()
        b.close()


def test_worker_refuses_jax_config(made, capsys):
    """A port worker connected to `nabwa_tpu`'s Coordinator refuses its
    config (no port package named) and exits non-zero."""
    d = made("dist")
    port = free_port()
    coord = jnet.Coordinator(port, {"gap_opt": JaxGapOpt().pack(),
                                    "pe_opt": b"", "prefix": str(d / "g.fa")})
    try:
        with pytest.raises(net.ConfigRefused, match="nabwa_tpu_torch"):
            _join(*_run(net.worker_main, "localhost", port,
                        idle_timeout=5, engine_factory=_cpu_engine))
        rc = _join(*_run(port_cli.main, ["worker", "--device", "cpu", "-p",
                                         str(port), "--idle-timeout", "5"]))
        assert rc == 1
        assert "serves only a nabwa_tpu_torch coordinator" in \
            capsys.readouterr().err
    finally:
        coord.close()


def _no_torch_pickle(obj):
    """The pickle of obj, failing on any object of torch."""
    mods = set()

    class P(pickle.Pickler):
        def reducer_override(self, o):
            mods.add(type(o).__module__.split(".")[0])
            if isinstance(o, torch.Tensor):
                raise AssertionError("a tensor on the wire")
            return NotImplemented
    buf = io.BytesIO()
    P(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    assert "torch" not in mods, mods
    return buf.getvalue()


def test_payloads_round_trip(made, tmp_path, monkeypatch):
    """Every payload and result of both passes (chunks of 16 logical
    records) pickles without a torch object and comes back through the
    port's unpickler to the same pickle; pass 2 on a round-tripped payload
    and context returns the same result.  (The payloads are pickled as the
    jobs get them: the ordered writer later updates the pairs.)"""
    d = made("dist")
    calls = {1: [], 2: []}
    p1, p2 = pb2b.pass1_work, pb2b.pass2_work

    def rec1(engine, gopt, payload, host_reference=False):
        blob = _no_torch_pickle(payload)
        res = p1(engine, gopt, payload, host_reference)
        calls[1].append((blob, _no_torch_pickle(res)))
        return res

    def rec2(engine, gopt, popt, iinfos, payload, host_reference=False):
        blobs = (_no_torch_pickle(payload), _no_torch_pickle(iinfos))
        res = p2(engine, gopt, popt, iinfos, payload, host_reference)
        calls[2].append((*blobs, _no_torch_pickle(res)))
        return res
    monkeypatch.setattr(pb2b, "pass1_work", rec1)
    monkeypatch.setattr(pb2b, "pass2_work", rec2)
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(), "cpu")
    _port_b2b(d, tmp_path / "out.bam", engine=eng, chunk_size=16,
              host_reference=True)
    assert len(calls[1]) == len(calls[2]) == 6
    for blobs in calls[1] + calls[2]:
        for blob in blobs:
            assert _no_torch_pickle(net.loads(blob)) == blob
    for payload, ctx, res in calls[2][:2]:
        iinfos = net.loads(ctx)
        assert iinfos and all(
            type(v).__module__.startswith("nabwa_tpu_torch.")
            for v in iinfos.values())
        again = p2(eng, eng.opt, PeOpt(), iinfos, net.loads(payload))
        assert _no_torch_pickle(again) == res


def test_coordinator_with_thread_worker(made, local_run, tmp_path):
    """`n_workers=0`, chunks of 6: every chunk runs in one in-thread
    worker; the BAM equals the port's local-thread run and nabwa_tpu's."""
    d = made("dist")
    port = free_port()
    coord = _run(_net_b2b, d, tmp_path / "net.bam", port)
    worker = _run(net.worker_main, "localhost", port, idle_timeout=30,
                  engine_factory=_cpu_engine)
    assert _join(*worker) == 2 * 15
    got = _join(*coord)
    assert got == local_run
    assert got == _jax_b2b(d, tmp_path / "jax.bam", ["bam2bam"])
    assert pb2b.telemetry["pass1_dups"] == pb2b.telemetry["pass2_dups"] == 0


def _spawn(port, log):
    # a file, not an undrained pipe: a full pipe would freeze the worker
    # mid-chunk
    with open(log, "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "nabwa_tpu_torch", "worker", "--device",
             "cpu", "-p", str(port), "-t", "1", "--idle-timeout", "60"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO),
                               OMP_NUM_THREADS="1", NABWA_FORCE_NATIVE="1"),
            stdout=subprocess.DEVNULL, stderr=err)


def _holds(coord, pid):
    """(results of worker `pid` accepted, chunks it holds)."""
    with coord.lock:
        for (_, wpid), t in coord.workers.items():
            if wpid == pid:
                return t["accepted"], len(t["held"])
    return 0, 0


def _holds_after_result(coord, proc, settle=0.5):
    """Whether `proc` holds a lease after a result of its own was
    accepted; it is stopped (SIGSTOP) while the coordinator takes any
    result it had already sent, and left stopped only if it still holds
    a chunk then, so that a kill loses that chunk."""
    accepted, held = _holds(coord, proc.pid)
    if not (accepted and held):
        return False
    proc.send_signal(signal.SIGSTOP)
    time.sleep(settle)
    accepted, held = _holds(coord, proc.pid)
    if held:
        return True
    proc.send_signal(signal.SIGCONT)
    return False


def test_worker_processes_and_kill(made, local_run, tmp_path, monkeypatch):
    """Two worker processes; the first one that the coordinator has taken
    a result from while it holds another lease is SIGKILLed.  Its lease
    runs out (3 s), the chunk goes to the other worker, and the BAM is
    unchanged."""
    d = made("dist")
    monkeypatch.setenv("NABWA_LEASE_S", "3")
    coords = []

    class Seen(net.Coordinator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            coords.append(self)
    monkeypatch.setattr(net, "Coordinator", Seen)
    port = free_port()
    run = _run(_net_b2b, d, tmp_path / "net.bam", port)
    procs = [_spawn(port, tmp_path / f"w{i}.log") for i in range(2)]
    killed = None
    try:
        t0 = time.monotonic()
        while killed is None and run[0].is_alive():
            assert time.monotonic() - t0 < LIMIT_S
            time.sleep(0.01)
            for p in procs:
                if coords and _holds_after_result(coords[0], p):
                    p.send_signal(signal.SIGKILL)
                    killed = p
                    break
        _join(*run)
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert killed is not None, "no worker held a lease after a result"
    survivor = procs[1 - procs.index(killed)]
    assert killed.returncode == -signal.SIGKILL
    assert survivor.returncode == 0
    assert (tmp_path / "net.bam").read_bytes() == local_run
    tel = pb2b.telemetry
    assert tel["pass1_resends"] + tel["pass2_resends"] >= 1
    log = (tmp_path / f"w{procs.index(survivor)}.log").read_text()
    assert "[worker] finished" in log


def test_worker_idle_exit(made, capsys):
    """A worker that is served no chunk exits after its idle timeout."""
    d = made("dist")
    port = free_port()
    coord = net.Coordinator(port, {"gap_opt": GapOpt().pack(),
                                   "pe_opt": PeOpt().pack(),
                                   "prefix": str(d / "g.fa")})
    try:
        t0 = time.monotonic()
        rc = _join(*_run(port_cli.main, ["worker", "--device", "cpu", "-p",
                                         str(port), "--idle-timeout", "1"]),
                   limit=60)
        assert rc == 0 and 1 <= time.monotonic() - t0 < 60
        err = capsys.readouterr().err
        assert "no work for 1 s, exiting" in err
        assert "finished, 0 chunks processed" in err
        assert [t["sent"] for t in coord.workers.values()] == [0]
    finally:
        coord.close()


def test_worker_without_card(monkeypatch, capsys):
    """`--device cuda` (the default) with no card exits non-zero before it
    connects: the coordinator sees no hello."""
    monkeypatch.setattr(port_cli.torch.cuda, "is_available", lambda: False)
    port = free_port()
    coord = net.Coordinator(port, {"gap_opt": b"", "pe_opt": b"",
                                   "prefix": ""})
    try:
        rc = _join(*_run(port_cli.main, ["worker", "-p", str(port)]),
                   limit=60)
        assert rc == 2
        assert "no CUDA device is available" in capsys.readouterr().err
        time.sleep(0.5)
        assert coord.workers == {}
    finally:
        coord.close()


BUILD_ONCE = """\
import ctypes, pathlib, sys, time, types
from nabwa_tpu_torch.ops import _build
build = pathlib.Path(sys.argv[1])
_build.BUILD_DIR = build
for name in ("LIB_PATH", "_HASH_PATH", "_LOG_PATH"):
    setattr(_build, name, build / getattr(_build, name).name)
def fake_build(src_hash):
    with open(build / "builds.txt", "a") as f:
        f.write("built\\n")
    time.sleep(1.0)
    _build.LIB_PATH.write_bytes(b"")
    _build._HASH_PATH.write_text(src_hash)
class Lib:
    def __getattr__(self, name):
        return types.SimpleNamespace()
_build._build = fake_build
ctypes.CDLL = lambda path: Lib()
while time.time() < float(sys.argv[2]):
    time.sleep(0.001)
_build.lib()
"""


def test_kernel_build_lock(tmp_path):
    """Two processes call `_build.lib()` at the same instant on an empty
    build directory: one builds (1 s), the other waits on the lock, finds
    the library built for its sources and loads it."""
    build = tmp_path / "build"
    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONCE, str(build),
                               repr(start)], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=str(REPO)),
                              stderr=subprocess.PIPE)
             for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]
    assert (build / "builds.txt").read_text() == "built\n"
    assert (build / ".libnabwa_torch_kernels.lock").exists()
