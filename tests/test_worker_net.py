"""Multi-process networked bam2bam: a coordinator plus real `worker`
subprocesses over TCP, including killing a worker mid-run.

Mirrors the reference's distributed test method (SURVEY §4): workers
connect to localhost (`bam2bam -t0 -p PORT` + N `bwa worker` processes,
bam2bam.c:2216), the output must equal the sequential run, and losing a
worker must be absorbed by lease redelivery."""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.models.aln import AlnEngine
from nabwa_tpu.models import bam2bam as b2b
from nabwa_tpu.options import GapOpt, PeOpt
from nabwa_tpu.utils.rand48 import Rand48

from . import refbin, genomes
from .test_sampe import make_pairs
from .test_bam2bam import make_input_bam, dump_records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_worker(port, idle=30.0):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    return subprocess.Popen(
        [sys.executable, "-m", "nabwa_tpu", "worker", "-p", str(port),
         "--idle-timeout", str(idle)],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
        # stderr must NOT be an undrained PIPE: the worker logs per chunk
        # (plus the backend's per-AOT-load warnings) and a full 64 KB pipe
        # freezes it mid-chunk, deadlocking the coordinator
        stderr=subprocess.DEVNULL)


def test_networked_workers_and_kill(tmp_path, monkeypatch):
    # short lease: the killed worker's chunks must re-issue within the
    # test budget (production default is the reference's 90 s)
    monkeypatch.setenv("NABWA_LEASE_S", "5")
    fa, seqs = genomes.random_genome(40000, seed=401)
    fq1, fq2 = make_pairs(seqs[0], 48, 50, 250, 30, 402, err_rate=0.01)
    (tmp_path / "g.fa").write_bytes(fa)
    make_input_bam(str(tmp_path / "in.bam"), fq1, fq2)
    refbin.run_bwa(["index", str(tmp_path / "g.fa")])
    idx = BwaIndex.load(str(tmp_path / "g.fa"))

    def run(name, **kw):
        opt, popt = GapOpt(), PeOpt()
        eng = AlnEngine(idx, opt)
        out = str(tmp_path / name)
        b2b.bam2bam(eng, str(tmp_path / "in.bam"), out, opt, popt,
                    Rand48(idx.bns.seed), argv=["bam2bam"], version="ref",
                    **kw)
        return dump_records(out)

    base = run("seq.bam", n_workers=1)

    port = free_port()
    result = {}

    def coordinator():
        # n_workers=0: all chunk compute happens in the worker processes
        result["recs"] = run("net.bam", n_workers=0, chunk_size=6,
                             port=port, prefix=str(tmp_path / "g.fa"))

    th = threading.Thread(target=coordinator, daemon=True)
    th.start()
    w1 = spawn_worker(port)
    w2 = spawn_worker(port)
    # let w1 do some work, then kill it mid-run: its leased chunks must
    # reissue to w2 (at-least-once redelivery)
    time.sleep(25)
    if th.is_alive():
        w1.send_signal(signal.SIGKILL)
    th.join(timeout=240)
    alive = th.is_alive()
    for w in (w1, w2):
        try:
            w.wait(timeout=60)
        except subprocess.TimeoutExpired:
            w.kill()
    assert not alive, "networked bam2bam did not finish"
    assert result["recs"] == base
