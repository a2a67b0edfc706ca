"""Profile bwasw on the cached 64 Mbp bench index (config-4 shape).

  NREADS=60 python scripts/profile_bwasw.py [--cprofile]
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

WORK = pathlib.Path("/tmp/nabwa_bench64")
N = int(os.environ.get("NREADS", "60"))

rng = np.random.default_rng(204)
comp = bytes.maketrans(b"ACGT", b"TGCA")
g = b"".join(line.strip() for line in open(WORK / "g.fa", "rb")
             if not line.startswith(b">"))
out = []
for i in range(N):
    L = int(rng.integers(800, 1200))
    start = int(rng.integers(0, len(g) - L))
    r = bytearray(g[start:start + L])
    j = 0
    while j < len(r):
        x = rng.random()
        if x < 0.01:
            r[j] = b"ACGT"[int(rng.integers(0, 4))]
        elif x < 0.015:
            del r[j]
            continue
        elif x < 0.02:
            r.insert(j, b"ACGT"[int(rng.integers(0, 4))])
            j += 1
        j += 1
    rb = bytes(r)
    if i % 2:
        rb = rb.translate(comp)[::-1]
    out.append(b"@L%d\n%s\n+\n%s\n" % (i, rb, b"I" * len(rb)))
(WORK / "sw.fq").write_bytes(b"".join(out))

from nabwa_tpu import cli
args = ["bwasw", str(WORK / "g.fa"), str(WORK / "sw.fq"),
        "-f", str(WORK / "sw.sam")]
t0 = time.time()
if "--cprofile" in sys.argv:
    pr = cProfile.Profile()
    pr.enable()
rc = cli.main(args)
dt = time.time() - t0
if "--cprofile" in sys.argv:
    pr.disable()
    s = _io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(30)
    print(s.getvalue())
assert rc == 0
print(f"bwasw: {dt:.2f}s ({N/dt:.1f} reads/s)")

if os.environ.get("NABWA_BSW_COUNTS"):
    import ctypes
    import numpy as _np
    from nabwa_tpu.index import native as _nm
    _lib = _nm._load()
    _lib.bsw2_counts.argtypes = [
        _np.ctypeslib.ndpointer(_np.int64, flags="C_CONTIGUOUS")]
    _lib.bsw2_counts.restype = None
    c = _np.zeros(5, dtype=_np.int64)
    _lib.bsw2_counts(c)
    print(f"[bsw2.counts] nodes={c[0]} cells={c[1]} occ={c[2]} "
          f"hash={c[3]} expand={c[4]}")
