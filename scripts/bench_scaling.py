"""Multi-worker scaling of distributed bam2bam through the TCP
coordinator (BASELINE: >=85 % scaling at 2+ workers).

Shape mirrors the reference's network deployment (`bam2bam -t0 -p PORT`
master + N `bwa worker` processes, bam2bam.c:2213-2308): the master does
BAM I/O + the chunk-lease scheduler only; each worker is pinned to ONE
native DFS thread so N workers model N single-core hosts on this 4-core
box.

Writes chiprun_out/scaling.json and prints one JSON line.

  C_PAIRS=40000 WORKERS=1,2,4 python scripts/bench_scaling.py
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# host-native work only: the scaling claim is about the distribution
# layer, not the chip; the TCP workers inherit the CPU pin
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("NABWA_FORCE_NATIVE", "1")
import jax  # noqa: E402,F401

WORK = pathlib.Path(os.environ.get("WORKDIR", "/tmp/nabwa_scaling"))
N_PAIRS = int(os.environ.get("C_PAIRS", "40000"))
WORKERS = [int(x) for x in os.environ.get("WORKERS", "1,2,4").split(",")]


def setup():
    from tests import genomes
    from nabwa_tpu.index.build import build_index
    from tests.test_bam2bam import make_input_bam

    WORK.mkdir(exist_ok=True)
    fa = WORK / "g.fa"
    if not (WORK / "g.fa.sa").exists():
        fa_b, seqs = genomes.random_genome(4_600_000, seed=11)
        fa.write_bytes(fa_b)
        build_index(str(fa))
    g = b"".join(l for l in fa.read_bytes().split(b"\n")
                 if not l.startswith(b">"))
    # keyed by N_PAIRS: a cached input from a different C_PAIRS run would
    # silently inflate every reported rate
    bam_in = WORK / f"in_{N_PAIRS}.bam"
    if not bam_in.exists():
        f1, f2 = sample_pairs(g, N_PAIRS, seed=301)
        make_input_bam(str(bam_in), f1, f2)
    return fa, bam_in


def sample_pairs(g, n, seed):
    """PE pairs like golden config 5 (100 bp, isize N(300,40), a few
    mismatches, every 23rd mate shredded to force rescue)."""
    import numpy as np
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rng = np.random.default_rng(seed)
    f1, f2 = [], []
    for i in range(n):
        isz = max(210, int(rng.normal(300, 40)))
        start = int(rng.integers(0, len(g) - isz - 110))
        r1 = bytearray(g[start:start + 100])
        r2 = bytearray(g[start + isz - 100:start + isz]
                       .translate(comp)[::-1])
        for r in (r1, r2):
            for _ in range(int(rng.integers(0, 4))):
                p = int(rng.integers(0, len(r)))
                r[p] = b"ACGT"[int(rng.integers(0, 4))]
        if i % 23 == 5:
            for _ in range(30):
                p = int(rng.integers(0, len(r2)))
                r2[p] = b"ACGT"[int(rng.integers(0, 4))]
        q = b"I" * 100
        f1.append(b"@p%d/1\n%s\n+\n%s\n" % (i, bytes(r1), q))
        f2.append(b"@p%d/2\n%s\n+\n%s\n" % (i, bytes(r2), q))
    return b"".join(f1), b"".join(f2)


def run_n(fa, bam_in, n_workers):
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    out = WORK / f"out_{n_workers}.bam"
    out.unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nabwa_tpu", "worker", "-p", str(port),
         "-t", "1", "--idle-timeout", "120"], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for _ in range(n_workers)]
    try:
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "nabwa_tpu", "bam2bam", "-g", str(fa),
             "-f", str(out), str(bam_in), "-t", "0", "-p", str(port)],
            env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        dt = time.time() - t0
        assert r.returncode == 0, r
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=30)
    return dt, out


def records_blob(path):
    """Decompressed record stream AFTER the header: the @PG CL: line
    legitimately embeds argv (port / -f name), which differs per run —
    raw-byte comparison would flag that as a mismatch."""
    import struct
    from nabwa_tpu.io.bam import bgzf_decompress
    raw = bgzf_decompress(pathlib.Path(path).read_bytes())
    assert raw[:4] == b"BAM\x01", raw[:4]
    l_text = struct.unpack("<i", raw[4:8])[0]
    p = 8 + l_text
    n_ref = struct.unpack("<i", raw[p:p + 4])[0]
    p += 4
    for _ in range(n_ref):
        l_name = struct.unpack("<i", raw[p:p + 4])[0]
        p += 8 + l_name
    return raw[p:]


def main():
    fa, bam_in = setup()
    base = None
    ref_bytes = None
    rows = []
    for n in WORKERS:
        dt, out = run_n(fa, bam_in, n)
        rate = 2 * N_PAIRS / dt
        if ref_bytes is None:
            ref_bytes = records_blob(out)
            same = True
        else:
            same = records_blob(out) == ref_bytes
        if base is None:
            base = rate
        eff = rate / (base * n / WORKERS[0])
        rows.append({"workers": n, "seconds": round(dt, 2),
                     "records_per_sec": round(rate, 1),
                     "efficiency_vs_linear": round(eff, 3),
                     "output_identical": bool(same)})
        print(f"workers={n}  {dt:.1f}s  {rate:.0f} rec/s  "
              f"eff={eff:.2f}  identical={same}", file=sys.stderr)
    res = {
        "metric": "bam2bam_multiworker_scaling",
        "n_pairs": N_PAIRS,
        "host_cores": os.cpu_count(),
        "note": ("coordinator -t0 + N single-thread TCP workers on one "
                 "host; workers model single-core hosts; the 4-worker "
                 "row shares the box with the coordinator's I/O"),
        "rows": rows,
    }
    path = pathlib.Path(__file__).resolve().parent.parent / \
        "chiprun_out" / "scaling.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(res, indent=1) + "\n")
    print(json.dumps({"metric": "scaling_efficiency_2workers",
                      "value": rows[1]["efficiency_vs_linear"]
                      if len(rows) > 1 else None,
                      "unit": "x", "rows": rows}))


if __name__ == "__main__":
    main()
