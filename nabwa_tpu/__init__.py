"""nabwa_tpu — a short-read aligner in JAX with the capabilities of
mpieva/network-aware-bwa (BWA 0.5.x + distributed bam2bam), running its
device paths on an NVIDIA GPU.

Design:

- The FM-index (BWT with interleaved Occ checkpoints, sampled suffix array,
  2-bit packed reference) lives in device memory as flat uint32/int32
  arrays, replicated per device (reference structure: bwt.h:43-59).
- The per-read bounded DFS (bwtgap.c:104-266) runs as a CUDA kernel with
  one GPU thread per read (native/dfs_cuda.cu), sharing its search code
  with the threaded host engine; a jnp lockstep engine serves the mesh
  path.  Banded DP and SA walks are batched XLA programs.
- Distribution is jax.sharding data-parallelism over reads plus a
  host-side chunk scheduler replacing the ZeroMQ bam2bam layer
  (bam2bam.c:1462-1715).

Layout:
  index/     index construction + on-disk format parity (bntseq.c, bwtmisc.c,
             bwtio.c, is.c equivalents)
  ops/       device compute (occ/rank, DFS search, banded DP, SA lookup):
             jnp paths and the CUDA DFS kernel's JAX wrapper
  models/    workflow drivers (aln, samse, sampe, bwasw, bam2bam)
  refmodel/  exact scalar NumPy model of the reference semantics (test oracle
             and host fallback for pathological reads)
  io/        FASTQ/SAM/BAM/.sai readers and writers
  parallel/  mesh/sharding helpers and the distributed chunk scheduler
  device.py  the one routing decision (GPU or host) and the compile cache
  utils/     rand48 LCG, logging, timers
"""

__version__ = "0.1.0"
