"""Profile the sampe post path on the cached 64 Mbp bench index.

  NPAIRS=20000 python scripts/profile_sampe.py [--cprofile]

Generates pairs from /tmp/nabwa_bench64/g.fa, runs `aln` natively for
both ends, then times (and optionally cProfiles) models.sampe.sampe.
"""

import cProfile
import io as _io
import os
import pathlib
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")
os.environ.setdefault("NABWA_FORCE_NATIVE", "1")
from nabwa_tpu.device import setup_compile_cache  # noqa: E402
setup_compile_cache()

import numpy as np

from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.io import fastq
from nabwa_tpu.models import sampe as pe
from nabwa_tpu.models.aln import AlnEngine
from nabwa_tpu.options import GapOpt, PeOpt
from nabwa_tpu.utils.rand48 import Rand48

WORK = pathlib.Path("/tmp/nabwa_bench64")
N = int(os.environ.get("NPAIRS", "20000"))
L = 100
ISIZE = 400

rng = np.random.default_rng(42)
comp = bytes.maketrans(b"ACGT", b"TGCA")
g = b"".join(line.strip() for line in open(WORK / "g.fa", "rb")
             if not line.startswith(b">"))

fq1, fq2 = [], []
for i in range(N):
    isz = max(2 * L + 2, int(rng.normal(ISIZE, 30)))
    start = int(rng.integers(0, len(g) - isz))
    frag = g[start:start + isz]
    r1 = bytearray(frag[:L])
    r2 = bytearray(frag[-L:].translate(comp)[::-1])
    for r in (r1, r2):
        for _ in range(int(rng.binomial(L, 0.01))):
            p = int(rng.integers(0, L))
            r[p] = b"ACGT"[int(rng.integers(0, 4))]
    q = b"I" * L
    fq1.append(b"@p%d\n%s\n+\n%s\n" % (i, bytes(r1), q))
    fq2.append(b"@p%d\n%s\n+\n%s\n" % (i, bytes(r2), q))
(WORK / "pe_1.fq").write_bytes(b"".join(fq1))
(WORK / "pe_2.fq").write_bytes(b"".join(fq2))

idx = BwaIndex.load(str(WORK / "g.fa"))
gopt = GapOpt()
popt = PeOpt()
eng = AlnEngine(idx, gopt)

reads = []
alns = []
t0 = time.time()
for e in (1, 2):
    rd = fastq.read_fastq_batch(fastq.iter_fastq(str(WORK / f"pe_{e}.fq")),
                                1 << 30)
    res = eng.run_chunk(rd)
    reads.append(rd)
    alns.append([r[0] for r in res])
print(f"aln both ends: {time.time()-t0:.2f}s "
      f"({2*N/(time.time()-t0):.0f} reads/s)")

r48 = Rand48(0x32ba6)
t0 = time.time()
if "--cprofile" in sys.argv:
    pr = cProfile.Profile()
    pr.enable()
lines, ii = pe.sampe(eng, reads, alns, gopt, popt, r48)
dt = time.time() - t0
if "--cprofile" in sys.argv:
    pr.disable()
    s = _io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(35)
    print(s.getvalue())
print(f"sampe post: {dt:.2f}s ({2*N/dt:.0f} reads/s)")
