"""Human-scale (3 Gbp) device DFS run.

Runs the default device DFS engine on the 3 Gbp index built by
scripts/bench_index_build.py (default /tmp/nabwa_idxbuild_3000000000),
compares every aln tuple bit-exactly against the native C++ engine on
the same reads, times the reference binary single-thread on the SAME
index files (the formats are bit-compatible), and writes a JSON record.

  NREADS=2048 python scripts/bench_gbp_device.py
"""

import copy
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
from nabwa_tpu.device import setup_compile_cache  # noqa: E402
setup_compile_cache()

import numpy as np

from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.io.fastq import Read
from nabwa_tpu.options import GapOpt
from nabwa_tpu.models.aln import AlnEngine, _maxdiff_table
from nabwa_tpu.constants import BWA_AVG_ERR
from nabwa_tpu.refmodel.aln_scalar import cal_maxdiff

WORK = pathlib.Path(os.environ.get(
    "GBP_DIR", "/tmp/nabwa_idxbuild_3000000000"))
N = int(os.environ.get("NREADS", "2048"))
L = 100

codes = np.memmap(WORK / "g.fa.pac.codes", dtype=np.uint8, mode="r")
glen = len(codes)
print(f"genome: {glen/1e9:.2f} Gbp")

rng = np.random.default_rng(404)
reads = []
for i in range(N):
    start = int(rng.integers(0, glen - L))
    seq = np.array(codes[start:start + L], dtype=np.uint8)
    nerr = int(rng.binomial(L, 0.01))
    for _ in range(nerr):
        p = int(rng.integers(0, L))
        seq[p] = (seq[p] + 1 + int(rng.integers(0, 3))) & 3
    if i % 2:
        seq = (3 - seq)[::-1].copy()
    qual = np.full(L, ord("I"), dtype=np.uint8)
    rseq = np.where(seq < 4, 3 - seq, seq).astype(np.uint8)[::-1].copy()
    reads.append(Read(name=f"g{i}", seq=seq[::-1].copy(), rseq=rseq,
                      qual=qual, full_len=L, clip_len=L,
                      full_codes=seq.copy()))

idx = BwaIndex.load(str(WORK / "g.fa"))
opt = GapOpt()
tab = _maxdiff_table(opt.fnr, 128)
maxdiff = np.array([tab[r.len] for r in reads], dtype=np.int32)
local = copy.copy(opt)
local.max_diff = cal_maxdiff(L, BWA_AVG_ERR, opt.fnr)
if local.max_diff < local.max_gapo:
    local.max_gapo = local.max_diff

out = {"genome_bp": int(glen), "n_reads": N}

# --- native engine (ground truth; bit-exact with the scalar oracle) ---
eng_n = AlnEngine(idx, opt)
res_native = [None] * N
t0 = time.time()
eng_n._drain_native(reads, maxdiff, local, res_native, list(range(N)))
dt_n = time.time() - t0
out["native_reads_per_sec"] = round(N / dt_n, 1)
print(f"native: {dt_n:.2f}s ({N/dt_n:.0f} reads/s)")

# --- device DFS engine, device only ---
eng = AlnEngine(idx, opt, host_frac=0.0)
res_dev = [None] * N
t0 = time.time()
res_dev = eng.run_chunk(reads)
dt_warm = time.time() - t0
res_dev2 = [None] * N
t0 = time.time()
res_dev2 = eng.run_chunk(reads)
dt_d = time.time() - t0
out["device_reads_per_sec"] = round(N / dt_d, 1)
out["device_first_run_s"] = round(dt_warm, 1)
print(f"device: {dt_d:.2f}s ({N/dt_d:.0f} reads/s; first {dt_warm:.1f}s)")

mism = 0
for i, (a, b) in enumerate(zip(res_native, res_dev2)):
    if list(a[0]) != list(b[0]):
        mism += 1
        if mism < 4:
            print(f"MISMATCH read {i}:\n  native {a[0][:3]}\n"
                  f"  device {b[0][:3]}")
out["mismatches"] = mism
out["ok"] = mism == 0
print("aln tuples identical:", mism == 0)

# --- reference binary, single thread, on the SAME index + reads ---
if not os.environ.get("GBP_NO_REF"):
    import subprocess
    sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "tests"))
    from tests.refbin import ensure_bwa
    bwa = ensure_bwa()
    fq = WORK / "gbp_reads.fq"
    FWD = b"ACGTN"
    with open(fq, "wb") as f:
        for r in reads:
            # full_codes are original-orientation nt4
            seq = bytes(FWD[c] for c in r.full_codes)
            f.write(b"@%s\n%s\n+\n%s\n"
                    % (r.name.encode(), seq, b"I" * r.len))
    sai = WORK / "gbp_ref.sai"
    # twice: the first run pays the 2.2 GB cold index read; the warm run
    # is the honest per-read rate (the device number likewise excludes
    # its one-time table upload, reported as device_first_run_s)
    for leg in ("cold", "warm"):
        sai.unlink(missing_ok=True)
        t0 = time.time()
        subprocess.run([str(bwa), "aln", str(WORK / "g.fa"), str(fq),
                        "-f", str(sai)], check=True, capture_output=True)
        dt_r = time.time() - t0
        out[f"reference_reads_per_sec_{leg}"] = round(N / dt_r, 1)
        print(f"reference 1-thread {leg}: {dt_r:.2f}s "
              f"({N/dt_r:.0f} reads/s)")
    out["device_vs_reference"] = round((N / dt_d) / (N / dt_r), 2)

rec = pathlib.Path(__file__).resolve().parents[1] / "chiprun_out"
rec.mkdir(exist_ok=True)
(rec / "gbp_device.json").write_text(json.dumps(out, indent=1))
print(json.dumps(out))
