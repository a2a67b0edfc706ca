"""Benchmark: aligned reads/s of the aln engine on one NVIDIA GPU plus the
host's native engine, vs the reference C bwa single-thread on the same
host and data.

Prints the device (platform, kind, count) and the card's name and power
limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": R}
Fails when JAX finds no GPU.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

from nabwa_tpu.device import setup_compile_cache  # noqa: E402

setup_compile_cache()

WORK = ROOT / ".bench_work"
# chromosome scale (chr20-class): the index build exercises the blockwise
# incremental BWT builder, and both strands' occ tables (~48 MB) sit on
# the device
GLEN = 64_000_000
N_READS = 32768
READ_LEN = 100


def setup_data():
    from tests import genomes
    from nabwa_tpu.index.build import build_index

    WORK.mkdir(exist_ok=True)
    fa_path = WORK / "g.fa"
    fq_path = WORK / "r.fq"
    if not (WORK / "g.fa.bwt").exists():
        fa, seqs = genomes.random_genome(GLEN, seed=99)
        fa_path.write_bytes(fa)
        build_index(str(fa_path))
    if (not fq_path.exists()
            or fq_path.read_bytes().count(b"\n") != 4 * N_READS):
        fa_txt = fa_path.read_bytes()
        seq = b"".join(l for l in fa_txt.split(b"\n")
                       if not l.startswith(b">"))
        from tests import genomes as g2
        fq = g2.sample_reads(seq, N_READS, READ_LEN, seed=100, err_rate=0.01)
        fq_path.write_bytes(fq)
    return fa_path, fq_path


def bench_ours(fa_path, fq_path):
    from nabwa_tpu.index.fmindex import BwaIndex
    from nabwa_tpu.models.aln import AlnEngine
    from nabwa_tpu.io import fastq
    from nabwa_tpu.options import GapOpt

    idx = BwaIndex.load(str(fa_path))
    reads = fastq.read_fastq_batch(fastq.iter_fastq(str(fq_path)), 1 << 22)
    eng = AlnEngine(idx, GapOpt())
    # warm-up / compile: a device-only chunk compiles the launch shapes
    # the timed runs reuse (excluded from the rate EMA), a second one
    # measures the clean device rate, then one hybrid chunk measures the
    # native engine
    eng.host_frac = 0.0
    eng.run_chunk(reads)
    eng.run_chunk(reads)
    eng.host_frac = 0.5
    eng.run_chunk(reads)
    rates = []
    for _ in range(3):
        t0 = time.time()
        res = eng.run_chunk(reads)
        dt = time.time() - t0
        rates.append(len(reads) / dt)
    n_hit = sum(1 for a, hw in res if a)
    extra = {
        "device_only_reads_per_sec": round(getattr(eng, "_dev_rate", 0.0), 1),
        "host_native_reads_per_sec": round(getattr(eng, "_host_rate", 0.0),
                                           1),
        "split": eng.last_split,
    }
    return sorted(rates)[1], n_hit, extra


def bench_reference(fa_path, fq_path):
    """Single-thread reference `bwa aln` wall time on the same data.

    The output .sai is always unlinked first: a stale file from a previous
    run would trigger the reference's recovery mode (attempt_recovery,
    bwtaln.c:259-297), which either aborts ("EOF while skipping done work")
    or times a recovery-skip run instead of a real alignment run — this is
    what left round 1 with no recorded benchmark number.
    """
    sys.path.insert(0, str(pathlib.Path(__file__).parent / "tests"))
    from tests.refbin import ensure_bwa

    bwa = ensure_bwa()
    ref_fa = WORK / "ref_g.fa"
    ref_sai = WORK / "ref.sai"
    if not (WORK / "ref_g.fa.bwt").exists():
        ref_fa.write_bytes(fa_path.read_bytes())
        subprocess.run([bwa, "index", str(ref_fa)], check=True,
                       capture_output=True)
    rates = []
    for _ in range(3):
        ref_sai.unlink(missing_ok=True)
        t0 = time.time()
        subprocess.run([bwa, "aln", str(ref_fa), str(fq_path), "-f",
                        str(ref_sai)], check=True, capture_output=True)
        dt = time.time() - t0
        rates.append(N_READS / dt)
    return sorted(rates)[1]


def main():
    d = jax.devices()[0]
    print(f"[device] platform={d.platform} kind={d.device_kind} "
          f"count={len(jax.devices())}", flush=True)
    if d.platform != "gpu":
        sys.exit("bench: JAX found no GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    fa_path, fq_path = setup_data()
    ref_rps = bench_reference(fa_path, fq_path)
    ours_rps, n_hit, extra = bench_ours(fa_path, fq_path)
    # value = the self-tuned hybrid engine (GPU + host cores vs the
    # single-thread reference process); the extra keys report each
    # engine's own rate
    print(json.dumps({
        "metric": "aln_reads_per_sec_per_chip",
        "value": round(ours_rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(ours_rps / ref_rps, 3),
        # the reference binary is timed in the SAME run on the same host
        # and data, so vs_baseline is a paired ratio
        "ref_reads_per_sec": round(ref_rps, 1),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        **extra,
    }))


if __name__ == "__main__":
    main()
