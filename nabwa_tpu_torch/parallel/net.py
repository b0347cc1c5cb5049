"""Multi-process distribution over TCP, the "network" in network-aware: the
port's copy of nabwa_tpu/parallel/net.py.

The replacement for the reference's ZeroMQ topology (bam2bam.c: config
REQ/REP service :1238-1286, DEALER work stream :1808-1812, worker process
:2213-2308).  The coordinator (the bam2bam master, `bam2bam -p PORT`)
serves chunk leases from the same `ChunkScheduler` its local worker
threads drain, so remote workers are more consumers with at-least-once
redelivery: a dropped connection or a dead worker lets the lease expire
and the chunk re-issues (bam2bam.c:1577-1601).  Results are deduped by
(phase, chunk id), the first completed copy winning (bam2bam.c:1620-1647).

Wire format, byte for byte the JAX package's: a `<Q` length and a pickle.
The config handshake ships the binary gap_opt_t/pe_opt_t codecs the
reference memcpys over the wire (options.py `pack`, bam2bam.c:1260-1263)
and the index prefix; each worker loads its own index copy and builds its
own `AlnEngine` on its own device (`cuda` unless asked for the CPU), so
several workers on one host share its card, each in a CUDA context of its
own.  Chunk payloads and results are host objects only (`SeqState`,
`BamRec`, lists and numpy arrays): no tensor crosses the wire.

The import rule over the wire: the port imports neither jax nor
`nabwa_tpu`, so a port process unpickles through `PortUnpickler`, which
refuses any class of those packages, and the coordinator's config names
the port (`"package": PACKAGE`): a worker refuses a config without it,
such as a JAX coordinator's, with `ConfigRefused`.
"""

import io
import os
import pickle
import socket
import struct
import sys
import threading
import time

PACKAGE = "nabwa_tpu_torch"
# packages whose classes a port process never unpickles
REFUSED_PACKAGES = ("nabwa_tpu", "jax", "jaxlib")


class ConfigRefused(RuntimeError):
    """The coordinator's config is not the port's."""


class PortUnpickler(pickle.Unpickler):
    """An unpickler that refuses the classes of `REFUSED_PACKAGES`."""

    def find_class(self, module, name):
        if module.split(".")[0] in REFUSED_PACKAGES:
            raise pickle.UnpicklingError(
                f"refusing to unpickle {module}.{name}: nabwa_tpu_torch "
                "does not import jax or nabwa_tpu")
        return super().find_class(module, name)


def loads(data):
    return PortUnpickler(io.BytesIO(data)).load()


def send_msg(sock, obj):
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(data)) + data)


def recv_msg(sock):
    hdr = _recv_exact(sock, 8)
    if hdr is None:
        return None
    (n,) = struct.unpack("<Q", hdr)
    data = _recv_exact(sock, n)
    if data is None:
        return None
    return loads(data)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return buf


class Coordinator:
    """Chunk-lease server for remote workers.

    begin_pass/end_pass bracket each distributed pass; between passes
    workers poll and get "idle" (the barrier).  `ctx` rides along with
    every chunk of a pass (pass 2 ships the inferred isize infos, the
    PUB-broadcast analog, bam2bam.c:1856-1870).

    `workers` maps each worker's (host, pid) from its hello to its tally:
    the chunks sent to it (`sent`), those of them whose result has not
    come back (`held`, (phase, chunk id) pairs) and its results that the
    scheduler accepted (`accepted`: the first copy of a chunk; duplicates
    and other phases' results are dropped).  Read it under `lock`.
    """

    def __init__(self, port, config):
        self.config = {**config, "package": PACKAGE}
        self.lock = threading.Lock()
        self.phase = 0                 # 0 = no pass active
        self.sched = None
        self.chunks = None
        self.accept_result = None
        self.ctx = None
        self.stopping = False
        self.workers = {}
        self.srv = socket.create_server(("", port))
        self.srv.settimeout(0.2)
        self.threads = []
        self.accept_thread = threading.Thread(target=self._accept_loop,
                                              daemon=True)
        self.accept_thread.start()

    def begin_pass(self, phase, sched, chunks, accept_result, ctx=None):
        with self.lock:
            self.phase = phase
            self.sched = sched
            self.chunks = chunks
            self.accept_result = accept_result
            self.ctx = ctx

    def end_pass(self):
        with self.lock:
            self.phase = 0
            self.sched = None
            self.chunks = None
            self.accept_result = None
            self.ctx = None

    def close(self):
        self.stopping = True
        self.accept_thread.join(timeout=2.0)
        try:
            self.srv.close()
        except OSError:
            pass

    def _accept_loop(self):
        while not self.stopping:
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self.threads.append(t)

    def _serve(self, conn):
        timing = bool(os.environ.get("NABWA_NET_TIMING"))
        tsend = taccept = 0.0
        nget = nres = 0
        tally = {"sent": 0, "held": set(), "accepted": 0}
        try:
            while not self.stopping:
                msg = recv_msg(conn)
                if msg is None:
                    return
                op = msg.get("op")
                t0 = time.monotonic() if timing else 0.0
                if op == "hello":
                    print("[config_service] worker hello from %s"
                          % msg.get("host", "?"), file=sys.stderr)
                    with self.lock:
                        self.workers[(msg.get("host"), msg.get("pid"))] = \
                            tally
                    send_msg(conn, {"op": "config", **self.config})
                elif op == "get":
                    with self.lock:
                        phase, sched, ctx = self.phase, self.sched, self.ctx
                    if self.stopping:
                        send_msg(conn, {"type": "exit"})
                        return
                    if phase == 0 or sched is None:
                        send_msg(conn, {"type": "idle"})
                        continue
                    cid = sched.acquire()
                    if cid is None:
                        send_msg(conn, {"type": "idle"})
                        continue
                    with self.lock:
                        tally["sent"] += 1
                        tally["held"].add((phase, cid))
                    send_msg(conn, {"type": "chunk", "phase": phase,
                                    "cid": cid, "ctx": ctx,
                                    "payload": self.chunks[cid]})
                    if timing:
                        tsend += time.monotonic() - t0
                        nget += 1
                elif op == "result":
                    with self.lock:
                        phase, accept = self.phase, self.accept_result
                        tally["held"].discard((msg["phase"], msg["cid"]))
                    # stale/other-phase results are dropped (dedup by
                    # phase+cid, bam2bam.c:1610-1623)
                    if phase == msg["phase"] and accept is not None:
                        if accept(msg["cid"], msg["data"]):
                            with self.lock:
                                tally["accepted"] += 1
                    send_msg(conn, {"ok": True})
                    if timing:
                        taccept += time.monotonic() - t0
                        nres += 1
                elif op == "bye":
                    return
        except (OSError, EOFError, pickle.UnpicklingError):
            return
        finally:
            if timing and (nget or nres):
                print(f"[net.timing] serve: {nget} chunks sent "
                      f"({tsend:.2f}s), {nres} results accepted "
                      f"({taccept:.2f}s)", file=sys.stderr)
            try:
                conn.close()
            except OSError:
                pass


def worker_main(host, port, n_threads=1, max_run_mins=90.0,
                idle_timeout=90.0, engine_factory=None, device="cuda"):
    """`nabwa_tpu_torch worker` core (bwa_worker, bam2bam.c:2213-2308).

    Connects, fetches the config (binary gap_opt/pe_opt and the index
    prefix), loads the index and builds an `AlnEngine` on `device`, then
    drains chunk leases until `idle_timeout` seconds pass with no work or
    the `max_run_mins` lifetime expires (bam2bam.c:2144-2150, :10,100).
    `engine_factory(prefix, gopt)` replaces the engine (tests).  Raises
    `ConfigRefused` on a config that is not the port's.  Returns the
    number of chunks processed.
    """
    from ..models import bam2bam as b2b
    from ..options import GapOpt, PeOpt

    # the reference's ZeroMQ REQ socket connects lazily, so a worker
    # started before the master binds just waits (bam2bam.c:2246-2258);
    # plain TCP must retry explicitly to match that tolerance
    deadline = time.monotonic() + min(idle_timeout, 60.0)
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.25)
    sock.settimeout(None)
    send_msg(sock, {"op": "hello", "host": socket.gethostname(),
                    "pid": os.getpid()})
    cfg = recv_msg(sock)
    if not cfg or cfg.get("op") != "config":
        sock.close()
        raise ConfigRefused("bad config handshake")
    if cfg.get("package") != PACKAGE:
        sock.close()
        raise ConfigRefused(
            f"the coordinator's config names package "
            f"{cfg.get('package')!r}, not {PACKAGE!r}: a nabwa_tpu_torch "
            "worker serves only a nabwa_tpu_torch coordinator")
    gopt = GapOpt.unpack(cfg["gap_opt"])
    popt = PeOpt.unpack(cfg["pe_opt"])
    if engine_factory is not None:
        engine = engine_factory(cfg["prefix"], gopt)
    else:
        from ..index.fmindex import BwaIndex
        from ..models.aln import AlnEngine
        engine = AlnEngine(BwaIndex.load(cfg["prefix"]), gopt, device)
    # -t caps this worker's native host threads (the reference worker's
    # per-process thread pool, bam2bam.c:2123-2127); without the cap every
    # co-located worker grabs all cores
    engine.native_threads = max(int(n_threads), 1)
    print("[worker] index %r loaded, entering work loop" % cfg["prefix"],
          file=sys.stderr)

    t0 = time.monotonic()
    last_work = time.monotonic()
    done_chunks = 0
    while True:
        now = time.monotonic()
        if now - t0 > max_run_mins * 60:
            print("[worker] lifetime expired", file=sys.stderr)
            break
        if now - last_work > idle_timeout:
            print("[worker] no work for %.0f s, exiting" % idle_timeout,
                  file=sys.stderr)
            break
        send_msg(sock, {"op": "get"})
        msg = recv_msg(sock)
        if msg is None or msg.get("type") == "exit":
            break
        if msg["type"] == "idle":
            time.sleep(0.05)
            continue
        last_work = time.monotonic()
        phase, cid = msg["phase"], msg["cid"]
        if phase == 1:
            data = b2b.pass1_work(engine, gopt, msg["payload"])
        else:
            data = b2b.pass2_work(engine, gopt, popt, msg["ctx"],
                                  msg["payload"])
        send_msg(sock, {"op": "result", "phase": phase, "cid": cid,
                        "data": data})
        ack = recv_msg(sock)
        if ack is None:
            break
        done_chunks += 1
    try:
        send_msg(sock, {"op": "bye"})
        sock.close()
    except OSError:
        pass
    print("[worker] finished, %d chunks processed" % done_chunks,
          file=sys.stderr)
    return done_chunks
