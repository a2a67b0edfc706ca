"""True multi-process distributed proof (SURVEY §4 item 3): N OS
processes on one host under jax.distributed, each owning one CPU device
of a GLOBAL dp mesh, running the phase-A alignment step (cal_width +
DFS + SA lookup) on its read shard with the per-RG isize-histogram psum
at the phase barrier — the JAX replacement for the reference's
ZeroMQ worker fan-out + PUB/SUB isize broadcast (bam2bam.c:1462-1715,
1856-1870).

Coordinator mode (no env): spawns N workers of this file, collects their
shard outputs, and byte-compares the concatenation + the psum'd
histogram against a single-process run of the same step.  Writes
chiprun_out/multiproc.json.

  N_PROCS=2 python scripts/multiproc_dist.py
"""

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N_PROCS = int(os.environ.get("N_PROCS", "2"))
PORT = int(os.environ.get("DIST_PORT", "52431"))
WORK = pathlib.Path(os.environ.get("DIST_WORK", "/tmp/nabwa_multiproc"))


def build_problem():
    import numpy as np
    sys.path.insert(0, str(ROOT / "tests"))
    import __graft_entry__ as ge

    return ge._tiny_problem(n_reads=16 * N_PROCS, read_len=24, glen=4096,
                            seed=11)


def run_step(mesh, fwdpack, revpack, codes, reads, lengths, local_batch):
    """The jitted phase-A step over the (possibly multi-process) mesh.
    `local_batch` = (seqs, lengths, maxdiff) numpy shards owned by this
    process (full arrays in single-process mode)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from nabwa_tpu.ops import occ as occ_ops
    from nabwa_tpu.ops.dfs import dfs_match_gap, unpack_result
    from nabwa_tpu.ops.sa_lookup import sa_lookup
    from nabwa_tpu.parallel.mesh import isize_histogram

    bwt_f, prim_f, l2, sa_f = fwdpack
    bwt_r, prim_r, _, _ = revpack
    seq_len = np.int32(len(codes))
    bwt_cat = np.concatenate([bwt_f, bwt_r])
    rev_off = len(bwt_f)

    statics = dict(s_mm=3, s_gapo=11, s_gape=4, max_gape=6, max_gapo=1,
                   indel_end_skip=5, max_del_occ=10, max_entries=2000000,
                   max_top2=30, max_seed_diff=2, seed_len=32, mode=0x03,
                   stack_cap=256, hits_cap=8, max_iters=8000)

    repl = NamedSharding(mesh, P())
    dp = NamedSharding(mesh, P("dp"))

    def put_repl(x):
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(repl, x, x.shape)

    seqs_l, lengths_l, maxdiff_l = local_batch
    # global batch = per-process shard size * n_processes
    n_global = lengths_l.shape[0] * jax.process_count()
    seqs_d = jax.make_array_from_process_local_data(
        dp, np.asarray(seqs_l), (n_global,) + seqs_l.shape[1:])
    lengths_d = jax.make_array_from_process_local_data(
        dp, np.asarray(lengths_l), (n_global,))
    maxdiff_d = jax.make_array_from_process_local_data(
        dp, np.asarray(maxdiff_l), (n_global,))
    bwt_cat_d = put_repl(bwt_cat)
    bwt_f_d = put_repl(bwt_f)
    bwt_r_d = put_repl(bwt_r)
    l2_d = put_repl(l2)
    sa_f_d = put_repl(sa_f)

    @jax.jit
    def step(bwt_cat, bwt_f_a, bwt_r_a, l2_a, sa_f_a, seqs, lengths,
             maxdiff):
        w0, b0 = occ_ops.cal_width(bwt_f_a, l2_a, np.int32(prim_f),
                                   seq_len, seqs[:, 0, :], lengths)
        w1, b1 = occ_ops.cal_width(bwt_r_a, l2_a, np.int32(prim_r),
                                   seq_len, seqs[:, 1, :], lengths)
        widths = jnp.stack([w0, w1], axis=1)
        bids = jnp.stack([b0, b1], axis=1)
        B = seqs.shape[0]
        packed = dfs_match_gap(
            bwt_cat, rev_off, np.int32(prim_f), np.int32(prim_r), l2_a,
            seq_len, seqs, lengths, widths, bids,
            jnp.zeros((B, 2, 25), jnp.int32),
            jnp.zeros((B, 2, 25), jnp.int32),
            jnp.zeros(B, bool), maxdiff, **statics)
        out = unpack_result(packed, statics["hits_cap"])
        best_k = out["hit_k"][:, 0]
        pos = sa_lookup(bwt_f_a, l2_a, np.int32(prim_f), seq_len, sa_f_a,
                        32, best_k)
        half = B // 2
        hist = isize_histogram(pos[:half], pos[half:2 * half],
                               lengths[:half], lengths[half:2 * half],
                               jnp.full(half, 37), jnp.full(half, 37),
                               n_bins=1024)
        return out["n_aln"], pos, hist

    with mesh:
        n_aln, pos, hist = step(bwt_cat_d, bwt_f_d, bwt_r_d, l2_d, sa_f_d,
                                seqs_d, lengths_d, maxdiff_d)
        jax.block_until_ready((n_aln, pos, hist))
    return n_aln, pos, hist


def worker_main():
    import numpy as np

    pid = int(os.environ["DIST_PROC_ID"])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                               num_processes=N_PROCS, process_id=pid)
    assert jax.process_count() == N_PROCS
    from jax.sharding import Mesh

    # global mesh: one CPU device per process, ordered by process id
    devs = sorted(jax.devices(), key=lambda d: d.process_index)
    mesh = Mesh(np.array(devs), ("dp",))

    codes, fwdpack, revpack, reads, lengths = build_problem()
    n = len(lengths)
    shard = n // N_PROCS
    sl = slice(pid * shard, (pid + 1) * shard)
    maxdiff = np.full(n, 2, dtype=np.int32)
    n_aln, pos, hist = run_step(
        mesh, fwdpack, revpack, codes, reads[sl], lengths[sl],
        (reads[sl], lengths[sl], maxdiff[sl]))

    # each process owns 1/N of the dp-sharded outputs and a fully
    # replicated (psum'd) histogram
    local_naln = np.concatenate(
        [np.asarray(s.data) for s in n_aln.addressable_shards])
    local_pos = np.concatenate(
        [np.asarray(s.data) for s in pos.addressable_shards])
    local_hist = np.asarray(hist.addressable_shards[0].data)
    np.savez(WORK / f"shard_{pid}.npz", n_aln=local_naln, pos=local_pos,
             hist=local_hist)
    jax.distributed.shutdown()


def coordinator_main():
    import numpy as np

    WORK.mkdir(exist_ok=True)
    for f in WORK.glob("shard_*.npz"):
        f.unlink()
    t0 = time.time()
    procs = []
    for pid in range(N_PROCS):
        env = dict(os.environ)
        env["DIST_PROC_ID"] = str(pid)
        env.pop("XLA_FLAGS", None)  # one real CPU device per process
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        out, err = p.communicate(timeout=900)
        if p.returncode != 0:
            sys.stderr.write(err.decode()[-4000:])
            raise SystemExit(f"worker failed rc={p.returncode}")
    dt = time.time() - t0

    # single-process oracle on the same data
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh
    codes, fwdpack, revpack, reads, lengths = build_problem()
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    maxdiff = np.full(len(lengths), 2, dtype=np.int32)
    n_aln, pos, hist = run_step(mesh, fwdpack, revpack, codes, reads,
                                lengths, (reads, lengths, maxdiff))
    ref_naln = np.asarray(n_aln)
    ref_pos = np.asarray(pos)
    ref_hist = np.asarray(hist)

    got_naln, got_pos, hists = [], [], []
    for pid in range(N_PROCS):
        z = np.load(WORK / f"shard_{pid}.npz")
        got_naln.append(z["n_aln"])
        got_pos.append(z["pos"])
        hists.append(z["hist"])
    got_naln = np.concatenate(got_naln)
    got_pos = np.concatenate(got_pos)
    ok = (np.array_equal(got_naln, ref_naln)
          and np.array_equal(got_pos, ref_pos)
          and all(np.array_equal(h, ref_hist) for h in hists))
    res = {
        "n_processes": N_PROCS,
        "global_devices": N_PROCS,
        "reads": int(len(lengths)),
        "alignments": int(ref_naln.sum()),
        "hist_total": int(ref_hist.sum()),
        "outputs_identical_vs_single_process": bool(ok),
        "wall_s": round(dt, 2),
        "ok": bool(ok),
    }
    print(json.dumps(res))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "multiproc.json").write_text(
        json.dumps(res, indent=1))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    if "DIST_PROC_ID" in os.environ:
        worker_main()
    else:
        coordinator_main()
