"""Multi-process distribution runtime — the "network" in network-aware.

The replacement for the reference's ZeroMQ topology (bam2bam.c:
config REQ/REP service :1238-1286, DEALER work stream :1808-1812, worker
process :2213-2308).  The coordinator (the bam2bam master) serves chunk
leases from the SAME ChunkScheduler its local worker threads drain, so
remote workers are just additional consumers with at-least-once redelivery:
a dropped connection or dead worker simply lets the lease expire and the
chunk reissues (bam2bam.c:1577-1601 semantics).  Results are deduped by
(phase, chunk id) — first completed copy wins (bam2bam.c:1620-1647).

Wire format: length-prefixed pickle frames over TCP.  The config handshake
ships the SAME binary gap_opt_t/pe_opt_t codecs the reference memcpys over
the wire (options.py pack(), bam2bam.c:1260-1263) plus the index prefix;
workers load their own index copy (NFS/shared-FS model, bwtio design notes
bam2bam.c:818-843).

Device work inside a worker still runs through jax on that host's chips;
cross-host traffic is host-level records only — collectives stay on ICI
inside each host's mesh, DCN carries only chunk payloads and the isize
barrier state (SURVEY §2.7 mapping).
"""

import pickle
import socket
import struct
import sys
import threading
import time


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
    return pickle.loads(data)


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
    """

    def __init__(self, port, config):
        self.config = config           # dict shipped on hello
        self.lock = threading.Lock()
        self.phase = 0                 # 0 = no pass active
        self.sched = None
        self.chunks = None
        self.accept_result = None
        self.ctx = None
        self.stopping = False
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
        import os as _os
        timing = bool(_os.environ.get("NABWA_NET_TIMING"))
        tget = tsend = taccept = 0.0
        nget = nres = 0
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
                    send_msg(conn, {"type": "chunk", "phase": phase,
                                    "cid": cid, "ctx": ctx,
                                    "payload": self.chunks[cid]})
                    if timing:
                        tsend += time.monotonic() - t0
                        nget += 1
                elif op == "result":
                    with self.lock:
                        phase, accept = self.phase, self.accept_result
                    # stale/other-phase results are dropped (dedup by
                    # phase+cid, bam2bam.c:1610-1623)
                    if phase == msg["phase"] and accept is not None:
                        accept(msg["cid"], msg["data"])
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
                idle_timeout=90.0, engine_factory=None):
    """`nabwa_tpu worker` core (bwa_worker, bam2bam.c:2213-2308).

    Connects, fetches config (binary gap_opt/pe_opt + index prefix), loads
    the index, then drains chunk leases until idle_timeout seconds pass
    with no work or the max_run_mins lifetime expires
    (bam2bam.c:2144-2150, :10,100).
    """
    from ..options import GapOpt, PeOpt
    from ..models import bam2bam as b2b

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
    send_msg(sock, {"op": "hello", "host": socket.gethostname()})
    cfg = recv_msg(sock)
    assert cfg and cfg.get("op") == "config", "bad config handshake"
    gopt = GapOpt.unpack(cfg["gap_opt"])
    popt = PeOpt.unpack(cfg["pe_opt"])
    if engine_factory is not None:
        engine = engine_factory(cfg["prefix"], gopt)
    else:
        from ..index.fmindex import BwaIndex
        from ..models.aln import AlnEngine
        engine = AlnEngine(BwaIndex.load(cfg["prefix"]), gopt)
    # -t caps this worker's native DFS threads (the reference worker's
    # per-process thread pool, bam2bam.c:2123-2127); without the cap every
    # co-located worker grabs all cores and scaling measurements lie
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
            iinfos = msg["ctx"]
            data = b2b.pass2_work(engine, gopt, popt, iinfos,
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
