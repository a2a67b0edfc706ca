"""Profile the hybrid aln engine split on the bench workload: host-only
rate, device-only rate, and the combined chunk, to find overlap losses."""

import os
import sys
import time
import pathlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from nabwa_tpu.device import setup_compile_cache  # noqa: E402
setup_compile_cache()

import numpy as np

import bench

fa_path, fq_path = bench.setup_data()

from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.models.aln import AlnEngine
from nabwa_tpu.io import fastq
from nabwa_tpu.options import GapOpt

idx = BwaIndex.load(str(fa_path))
reads = fastq.read_fastq_batch(fastq.iter_fastq(str(fq_path)), 1 << 22)
print(f"{len(reads)} reads")

eng = AlnEngine(idx, GapOpt(), stack_cap=bench.STACK_CAP)

# ---- host-only rate (native engine, 4 threads) ----
import copy
from nabwa_tpu.refmodel.aln_scalar import cal_maxdiff
from nabwa_tpu.constants import BWA_AVG_ERR

opt = eng.opt
max_len = max(r.len for r in reads)
local = copy.copy(opt)
if opt.fnr > 0.0:
    local.max_diff = cal_maxdiff(max_len, BWA_AVG_ERR, opt.fnr)
if local.max_diff < local.max_gapo:
    local.max_gapo = local.max_diff
md = np.full(len(reads), local.max_diff, dtype=np.int32)

res = [None] * len(reads)
t0 = time.time()
eng._drain_native(reads, md, local, res, list(range(len(reads))))
t_host = time.time() - t0
print(f"host-only: {len(reads)/t_host:.0f} reads/s ({t_host:.3f}s)")

# ---- device-only rate ----
eng2 = AlnEngine(idx, GapOpt(), stack_cap=bench.STACK_CAP, host_frac=0.0)
eng2.run_chunk(reads[:1024], device_batch=1024)  # warm
t0 = time.time()
res2 = eng2.run_chunk(reads, device_batch=1024)
t_dev = time.time() - t0
print(f"device-only(run_chunk incl host drains of ovf): "
      f"{len(reads)/t_dev:.0f} reads/s ({t_dev:.3f}s)")

# ---- hybrid as bench does ----
eng3 = AlnEngine(idx, GapOpt(), stack_cap=bench.STACK_CAP)
eng3.host_frac = 0.0
eng3.run_chunk(reads[:1024], device_batch=1024)
eng3.host_frac = 0.5
eng3.run_chunk(reads[:4096], device_batch=1024)
t0 = time.time()
res3 = eng3.run_chunk(reads, device_batch=1024)
t_hyb = time.time() - t0
print(f"hybrid: {len(reads)/t_hyb:.0f} reads/s ({t_hyb:.3f}s) "
      f"final host_frac={eng3.host_frac:.3f}")

# second hybrid run (converged split)
t0 = time.time()
res4 = eng3.run_chunk(reads, device_batch=1024)
t_hyb2 = time.time() - t0
print(f"hybrid run2: {len(reads)/t_hyb2:.0f} reads/s ({t_hyb2:.3f}s) "
      f"final host_frac={eng3.host_frac:.3f}")
