"""Large-genome index-build proof (>=100 Mbp with peak RSS).

  GLEN=100000000 python scripts/bench_index_build.py

Builds the full 8-file index on a random genome, reports wall time and
peak RSS per stage, and cross-checks the .bwt/.sa headers.  With
DIFF_REF=1 also builds with the reference binary and byte-diffs all
files (slow at >=100 Mbp: the reference switches to its incremental
bwtsw builder).
"""

import os
import resource
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    glen = int(os.environ.get("GLEN", "100000000"))
    seed = int(os.environ.get("SEED", "909"))
    workdir = os.environ.get("WORKDIR", f"/tmp/nabwa_idxbuild_{glen}")
    os.makedirs(workdir, exist_ok=True)
    fa = f"{workdir}/g.fa"

    if not os.path.exists(fa):
        t0 = time.time()
        rng = np.random.default_rng(seed)
        with open(fa, "wb") as f:
            f.write(b">chrBig synthetic\n")
            bases = np.frombuffer(b"ACGT", dtype=np.uint8)
            for off in range(0, glen, 10_000_000):
                n = min(10_000_000, glen - off)
                chunk = bases[rng.integers(0, 4, size=n)]
                rows = chunk[: n - n % 70].reshape(-1, 70)
                f.write(b"\n".join(r.tobytes() for r in rows))
                f.write(b"\n")
                if n % 70:
                    f.write(chunk[n - n % 70:].tobytes() + b"\n")
        print(f"[gen] {glen/1e6:.0f} Mbp in {time.time()-t0:.1f}s")

    from nabwa_tpu.index.build import build_index

    t0 = time.time()
    build_index(fa, fa)
    dt = time.time() - t0
    print(f"[build] {glen/1e6:.0f} Mbp full index (8 files) in {dt:.1f}s, "
          f"peak RSS {rss_gb():.2f} GB")

    from nabwa_tpu.index.formats import read_bwt, read_sa
    primary, l2, bwt, seq_len = read_bwt(fa + ".bwt")
    assert seq_len == glen, (seq_len, glen)
    sa, intv, p2, sl2 = read_sa(fa + ".sa")
    assert p2 == primary and sl2 == glen
    print(f"[check] .bwt/.sa headers consistent (primary={primary})")

    if os.environ.get("DIFF_REF"):
        sys.path.insert(0, "tests")
        from tests.refbin import ensure_bwa
        bwa = ensure_bwa()
        ref_fa = f"{workdir}/ref.fa"
        if not os.path.exists(ref_fa):
            os.link(fa, ref_fa)
        t0 = time.time()
        subprocess.run([bwa, "index", ref_fa], check=True)
        print(f"[ref build] {time.time()-t0:.1f}s")
        for ext in (".pac", ".rpac", ".ann", ".amb", ".bwt", ".rbwt",
                    ".sa", ".rsa"):
            a = open(fa + ext, "rb").read()
            b = open(ref_fa + ext, "rb").read()
            print(f"[diff] {ext}: {'IDENTICAL' if a == b else 'DIFFER'}")
            assert a == b, ext


if __name__ == "__main__":
    main()
