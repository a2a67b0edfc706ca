"""Profile single-host bam2bam (golden config-5 shape, smaller input).

  NPAIRS=20000 THREADS=4 python scripts/profile_bam2bam.py [--cprofile]
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

WORK = pathlib.Path("/tmp/nabwa_profile_b2b")
WORK.mkdir(exist_ok=True)
N = int(os.environ.get("NPAIRS", "20000"))
THREADS = os.environ.get("THREADS", "4")

from tests import genomes
from tests.test_bam2bam import make_input_bam
from nabwa_tpu.index.build import build_index
from nabwa_tpu import cli

fa = WORK / "g.fa"
if not (WORK / "g.fa.bwt").exists():
    fab, seqs = genomes.random_genome(4_600_000, seed=11)
    fa.write_bytes(fab)
    build_index(str(fa))
fab, seqs = genomes.random_genome(4_600_000, seed=11)
g = seqs[0]

bam_in = WORK / f"in_{N}.bam"
if not bam_in.exists():
    rng = np.random.default_rng(7)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    L, ISIZE = 100, 400
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
    make_input_bam(str(bam_in), b"".join(fq1), b"".join(fq2))

args = ["bam2bam", "-g", str(fa), "-f", str(WORK / "out.bam"),
        str(bam_in), "-t", THREADS]
(WORK / "out.bam").unlink(missing_ok=True)
t0 = time.time()
if "--cprofile" in sys.argv:
    pr = cProfile.Profile()
    pr.enable()
rc = cli.main(args)
dt = time.time() - t0
if "--cprofile" in sys.argv:
    pr.disable()
    s = _io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(45)
    print(s.getvalue())
assert rc == 0
print(f"bam2bam: {dt:.2f}s ({2*N/dt:.0f} records/s)")
