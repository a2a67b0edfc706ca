"""Per-native-kernel timing for the columnar sampe post path.

  NPAIRS=100000 python scripts/profile_sampe_native.py

Wraps every ctypes entry point used by post_native.sampe_bytes with a
wall-clock accumulator, runs the same flow as profile_sampe.py, and
prints seconds per kernel.
"""

import os
import pathlib
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
from nabwa_tpu.index import native as native_mod
from nabwa_tpu.options import GapOpt, PeOpt
from nabwa_tpu.utils.rand48 import Rand48

WORK = pathlib.Path("/tmp/nabwa_bench64")
N = int(os.environ.get("NPAIRS", "100000"))
L = 100
ISIZE = 400

rng = np.random.default_rng(42)
comp = bytes.maketrans(b"ACGT", b"TGCA")
g = b"".join(line.strip() for line in open(WORK / "g.fa", "rb")
             if not line.startswith(b">"))

pe1, pe2 = WORK / "pe_1.fq", WORK / "pe_2.fq"
if not (pe1.exists() and pe1.stat().st_size // (4 * (L + 8)) > N // 2):
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
    pe1.write_bytes(b"".join(fq1))
    pe2.write_bytes(b"".join(fq2))

idx = BwaIndex.load(str(WORK / "g.fa"))
gopt = GapOpt()
popt = PeOpt()
eng = AlnEngine(idx, gopt)

reads, alns = [], []
t0 = time.time()
for e in (1, 2):
    rd = fastq.read_fastq_batch(fastq.iter_fastq(str(WORK / f"pe_{e}.fq")),
                                1 << 30)
    res = eng.run_chunk(rd)
    reads.append(rd)
    alns.append([r[0] for r in res])
print(f"aln both ends: {time.time()-t0:.2f}s")

lib = native_mod._load()
acc = {}


class Wrap:
    def __init__(self, name, fn):
        self.name, self.fn = name, fn

    def __call__(self, *a):
        t0 = time.time()
        r = self.fn(*a)
        acc[self.name] = acc.get(self.name, 0.0) + (time.time() - t0)
        return r


for nm in ("se_select_batch", "pe_pairing_batch", "se_multi_batch",
           "md_batch", "sam_emit_batch", "bwt_sa_batch_u32"):
    setattr(lib, nm, Wrap(nm, getattr(lib, nm)))

r48 = Rand48(0x32ba6)
t0 = time.time()
lines, ii = pe.sampe(eng, reads, alns, gopt, popt, r48)
dt = time.time() - t0
print(f"sampe post: {dt:.2f}s ({2*N/dt:.0f} reads/s)")
for k, v in sorted(acc.items(), key=lambda kv: -kv[1]):
    print(f"  {k:20s} {v:6.3f}s")
print(f"  other (py+numpy)     {dt - sum(acc.values()):6.3f}s")
