"""Whole-pipeline throughput benchmark: aln / samse / sampe / bam2bam
reads-per-second vs the single-thread reference binary on one dataset.

  python scripts/bench_pipelines.py            # GPU (or whatever backend)
  GLEN=2000000 NREADS=8192 python scripts/bench_pipelines.py

Prints one JSON object per stage.  The driver-facing bench.py stays
aln-only; this script is the full report behind README's numbers.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
if os.environ.get("NABWA_CPU"):
    jax.config.update("jax_platforms", "cpu")
    os.environ.setdefault("NABWA_FORCE_NATIVE", "1")
from nabwa_tpu.device import setup_compile_cache  # noqa: E402
setup_compile_cache()

import numpy as np

GLEN = int(os.environ.get("GLEN", "2000000"))
N_READS = int(os.environ.get("NREADS", "8192"))
READ_LEN = int(os.environ.get("RLEN", "100"))
ISIZE = 250
WORK = pathlib.Path(os.environ.get("WORKDIR", f"/tmp/nabwa_bench_pipe"))


def setup():
    from tests import genomes
    from nabwa_tpu.index.build import build_index
    from tests.refbin import ensure_bwa

    WORK.mkdir(exist_ok=True)
    fa = WORK / "g.fa"
    if not (WORK / "g.fa.bwt").exists():
        fa_b, seqs = genomes.random_genome(GLEN, seed=99)
        fa.write_bytes(fa_b)
        build_index(str(fa))
        subprocess.run([ensure_bwa(), "index", str(fa)],
                       check=True, capture_output=True)
        # bwa index overwrites with identical bytes (tested) — fine.
    g = b"".join(l for l in fa.read_bytes().split(b"\n")
                 if not l.startswith(b">"))
    rng = np.random.default_rng(101)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    f1, f2 = [], []
    for i in range(N_READS // 2):
        isz = int(rng.normal(ISIZE, 25))
        start = int(rng.integers(0, len(g) - isz - 1))
        r1 = bytearray(g[start:start + READ_LEN])
        r2 = bytearray(g[start + isz - READ_LEN:start + isz]
                       .translate(comp)[::-1])
        for r in (r1, r2):
            for _ in range(int(rng.integers(0, 3))):
                p = int(rng.integers(0, len(r)))
                r[p] = b"ACGT"[int(rng.integers(0, 4))]
        q = b"I" * READ_LEN
        f1.append(b"@p%d/1\n%s\n+\n%s\n" % (i, bytes(r1), q))
        f2.append(b"@p%d/2\n%s\n+\n%s\n" % (i, bytes(r2), q))
    (WORK / "r1.fq").write_bytes(b"".join(f1))
    (WORK / "r2.fq").write_bytes(b"".join(f2))
    return fa


def run_ref(args, out=None):
    from tests.refbin import ensure_bwa
    t0 = time.time()
    with open(out or os.devnull, "wb") as o:
        subprocess.run([ensure_bwa()] + args, check=True, stdout=o,
                       stderr=subprocess.DEVNULL)
    return time.time() - t0


def report(stage, n, ours_dt, ref_dt):
    print(json.dumps({
        "stage": stage, "unit": "reads/s",
        "ours": round(n / ours_dt, 1),
        "ref_1thread": round(n / ref_dt, 1),
        "vs_baseline": round(ref_dt / ours_dt, 3)}))


def main():
    fa = setup()
    from nabwa_tpu import cli

    def run_ours(args):
        t0 = time.time()
        rc = cli.main(args)
        assert rc == 0
        return time.time() - t0

    n2 = 2 * (N_READS // 2)

    # aln (per end, timed on end 1)
    for e in (1, 2):
        (WORK / f"ref{e}.sai").unlink(missing_ok=True)
        (WORK / f"got{e}.sai").unlink(missing_ok=True)
    ref_dt = sum(run_ref(["aln", str(fa), str(WORK / f"r{e}.fq"), "-f",
                          str(WORK / f"ref{e}.sai")]) for e in (1, 2))
    ours_dt = sum(run_ours(["aln", str(fa), str(WORK / f"r{e}.fq"), "-f",
                            str(WORK / f"got{e}.sai")]) for e in (1, 2))
    report("aln_pe", n2, ours_dt, ref_dt)

    # samse on end 1
    ref_dt = run_ref(["samse", str(fa), str(WORK / "ref1.sai"),
                      str(WORK / "r1.fq")], out=str(WORK / "ref.se.sam"))
    ours_dt = run_ours(["samse", str(fa), str(WORK / "got1.sai"),
                        str(WORK / "r1.fq"), "-f",
                        str(WORK / "got.se.sam")])
    report("samse", n2 // 2, ours_dt, ref_dt)

    # sampe
    ref_dt = run_ref(["sampe", str(fa), str(WORK / "ref1.sai"),
                      str(WORK / "ref2.sai"), str(WORK / "r1.fq"),
                      str(WORK / "r2.fq")], out=str(WORK / "ref.pe.sam"))
    ours_dt = run_ours(["sampe", str(fa), str(WORK / "got1.sai"),
                        str(WORK / "got2.sai"), str(WORK / "r1.fq"),
                        str(WORK / "r2.fq"), "-f",
                        str(WORK / "got.pe.sam")])
    report("sampe", n2, ours_dt, ref_dt)

    # bam2bam through the chunk-lease scheduler (ours only — the
    # reference's networked mode needs real zmq; sequential mode reads
    # the same BAM, but its runtime is ~= aln+sampe measured above)
    from tests.test_bam2bam import make_input_bam
    bam_in = WORK / "in.bam"
    if not bam_in.exists():
        make_input_bam(str(bam_in), (WORK / "r1.fq").read_bytes(),
                       (WORK / "r2.fq").read_bytes())
    t0 = time.time()
    rc = cli.main(["bam2bam", "-g", str(fa), "-f", str(WORK / "out.bam"),
                   str(bam_in)])
    assert rc == 0
    print(json.dumps({"stage": "bam2bam", "unit": "reads/s",
                      "ours": round(n2 / (time.time() - t0), 1)}))


if __name__ == "__main__":
    main()
