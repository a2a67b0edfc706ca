"""`aln` workflow driver — bwa_cal_sa_reg_gap / bwa_aln_core
(bwtaln.c:93-257) over a device DFS engine and the host's native one.

Batch pipeline per reference chunk (0x40000 reads, bwtaln.c:208):
  host: read prep → pad to device batch
  device: cal_width (fwd+rev, + seed suffix) → DFS engine → hit arrays
  host: unpack to per-read hit lists (append order), scalar fallback for
        overflow-flagged reads, .sai-compatible output
Batch-level option quirks replicated: local max_diff from the chunk's max
read length sizes nothing here, but its max_gapo clamp (bwtaln.c:105) and
the per-read max_diff/seed_len recomputation (bwtaln.c:125-126) do.
"""

import copy
import os
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp

from .. import device
from ..constants import BWA_AVG_ERR
from ..ops.dfs import unpack_result
from ..refmodel.aln_scalar import cal_maxdiff, aln_batch as scalar_aln_batch
from ..refmodel.fm_scalar import ScalarFm


def _i32(v):
    """uint32 value → int32 bit pattern scalar."""
    return np.array([v], dtype=np.uint32).view(np.int32)[0]


def _maxdiff_table(fnr, max_len=1024):
    tab = np.zeros(max_len + 1, dtype=np.int32)
    for l in range(1, max_len + 1):
        tab[l] = cal_maxdiff(l, BWA_AVG_ERR, fnr)
    return tab


def plan_device_share(n_reads, device_batch, dev_rate, host_rate,
                      n_cores, dev_lat):
    """The hybrid split policy, as a pure function so tests can pin its
    routing decisions (a kernel regression must not silently re-route all
    work to the host and fake a win).

    Returns n_dev, the number of reads handed to the device this chunk.

    - proportional split from the two rate EMAs, rounded to whole
      device_batch slices;
    - opportunity-cost check: driving the device costs ~one host core of
      runtime/transfer work (the device queue stalls when native
      saturates every core), so the device share must out-produce the
      per-core host rate it displaces, or the device stays idle;
    - latency guard: a device share also pays a fixed cost (dispatch +
      result collection); shed slices until the predicted device window
      fits inside the host drain window."""
    n_dev = int(n_reads * dev_rate / (dev_rate + host_rate))
    n_dev = (n_dev // device_batch) * device_batch
    n_dev = min(n_dev, n_reads)
    per_core = host_rate / max(n_cores, 1)
    if dev_rate < 1.1 * per_core:
        n_dev = 0
    while n_dev and (dev_lat + n_dev / dev_rate) > \
            1.1 * (n_reads - n_dev) / host_rate:
        n_dev -= device_batch
    return n_dev


class AlnEngine:
    """Holds device arrays + the compiled DFS for one index."""

    # fixed per-chunk device overhead (s) the hybrid split charges a
    # device share: dispatch -> collect of one 64-read CUDA launch, median
    # 7.53 ms at 64 Mbp (H100 80GB HBM3, 400 W; chip_smoke.py phase 7)
    DEV_LAT = 0.0075

    def __init__(self, index, opt, stack_cap=256, hits_cap=32,
                 max_iters=2_000_000, retry_stack_cap=1024,
                 retry_hits_cap=128, tier0_max_iters=768, mesh=None,
                 dfs_engine="auto", host_frac="auto"):
        """stack_cap/hits_cap size the tier-0 device search (the typical
        read's stack stays well under 256 entries); reads that overflow
        retry once with retry_stack_cap/retry_hits_cap, then drain to the
        host engine.

        dfs_engine: "cuda" (ops/dfs_cuda.py, one GPU thread per read),
        "jnp" (ops/dfs.py, lockstep batch under XLA), or "auto": CUDA on a
        GPU backend without a mesh, jnp otherwise.

        mesh: optional jax.sharding.Mesh with a "dp" axis.  The index is
        replicated per device and read batches are sharded over "dp" (the
        reference replicates the index per process and data-parallelizes
        reads, SURVEY §2.9); jit then partitions the DFS across devices."""
        self.index = index
        self.opt = opt
        self.stack_cap = stack_cap
        self.hits_cap = hits_cap
        self.retry_stack_cap = retry_stack_cap
        self.retry_hits_cap = retry_hits_cap
        self.max_iters = max_iters
        # tier-0 iteration cap: unfinished reads at the cap re-run in the
        # retry tier instead of holding the batch (lockstep) or their
        # warp (CUDA) for the whole tail
        self.tier0_max_iters = tier0_max_iters
        # device/host work split (see run_chunk): fraction of a chunk the
        # host's native engine takes until both engines have a measured
        # rate; then the rates decide.  0 disables the split.
        env = os.environ.get("NABWA_HOST_FRAC")
        if env is not None:
            host_frac = float(env)
        self.host_frac = 0.5 if host_frac == "auto" else float(host_frac)
        # reads solved per place in the last run_chunk: tier0 / retry on
        # the device, host for the native engine
        self.last_split = {}
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            self._repl = NamedSharding(mesh, P())
            self._dp = NamedSharding(mesh, P("dp"))
            self._n_dev = mesh.devices.size
        fwd, rev = index.fwd, index.rev
        assert np.array_equal(fwd.l2, rev.l2), "L2 must match for fwd/rev"
        self.rev_off = len(fwd.bwt)
        self.primary_fwd = _i32(fwd.primary)
        self.primary_rev = _i32(rev.primary)
        self.seq_len = _i32(fwd.seq_len)
        self._scalar_fms = None
        # host-side uint32 views for the native engine: _drain_native must
        # NOT round-trip the device copies (np.asarray on a jax array is a
        # device->host transfer per call)
        self._host_fwd = np.ascontiguousarray(fwd.bwt, dtype=np.uint32)
        self._host_rev = np.ascontiguousarray(rev.bwt, dtype=np.uint32)
        self._host_l2 = np.ascontiguousarray(fwd.l2, dtype=np.uint32)
        # device arrays are built lazily on first device use: native-only
        # runs (and worker processes through NABWA_FORCE_NATIVE) never pay
        # the device copies or backend init, and the index files stay
        # mmap-shared across co-located workers
        self._dfs_choice = dfs_engine
        self._dev = None

    # --- lazy device state -------------------------------------------
    _DEV_ATTRS = ("bwt_fwd", "bwt_rev", "bwt_cat", "l2", "sa_fwd",
                  "sa_rev", "dfs_engine")

    def _device_init(self):
        """Build the device-resident arrays (int32 bit patterns, ops.u32
        rationale) and load the DFS engine on first device use."""
        fwd, rev = self.index.fwd, self.index.rev
        mesh = self.mesh

        def dput(arr):
            a = jnp.asarray(arr)
            return jax.device_put(a, self._repl) if mesh is not None else a

        engine = self._dfs_choice
        if engine == "auto":
            engine = ("cuda" if mesh is None and device.on_gpu()
                      else "jnp")
        if engine == "cuda":
            from ..ops import dfs_cuda
            dfs_cuda.load()          # raises: no silent engine swap
        elif engine != "jnp":
            raise ValueError(f"unknown dfs_engine {engine!r}")
        self._dev = {
            "bwt_fwd": dput(fwd.bwt.view(np.int32)),
            "bwt_rev": dput(rev.bwt.view(np.int32)),
            # bwt_cat (the jnp engine's concatenated view) is built on
            # first use only: the CUDA engine reads the two strands
            # directly, and a copy would double the device-resident BWT
            "bwt_cat": None,
            "l2": dput(fwd.l2.view(np.int32)),
            "sa_fwd": dput(fwd.sa.view(np.int32)),
            "sa_rev": dput(rev.sa.view(np.int32)),
            "dfs_engine": engine,
        }
        return self._dev

    def __getattr__(self, name):
        if name in AlnEngine._DEV_ATTRS:
            d = self.__dict__.get("_dev")
            if d is None:
                d = self._device_init()
            if name == "bwt_cat" and d["bwt_cat"] is None:
                fwd, rev = self.index.fwd, self.index.rev
                cat = jnp.asarray(np.concatenate(
                    [fwd.bwt.view(np.int32), rev.bwt.view(np.int32)]))
                if self.mesh is not None:
                    cat = jax.device_put(cat, self._repl)
                d["bwt_cat"] = cat
            return d[name]
        raise AttributeError(name)

    def _slice(self, device_batch):
        """Reads per device launch: the CUDA kernel takes a whole share
        (one thread per read needs tens of thousands of reads to fill the
        card); the jnp engine keeps the caller's slice."""
        if self.dfs_engine == "cuda":
            from ..ops.dfs_cuda import MAX_BATCH
            return MAX_BATCH
        return device_batch

    def _shard_batch(self, arr):
        """Shard a [B, ...] batch array over the dp axis (replicate-free)."""
        a = jnp.asarray(arr)
        if self.mesh is None:
            return a
        return jax.device_put(a, self._dp)

    def scalar_fms(self):
        if self._scalar_fms is None:
            f, r = self.index.fwd, self.index.rev
            self._scalar_fms = (
                ScalarFm(f.bwt, f.primary, f.l2, f.seq_len, f.sa, f.sa_intv),
                ScalarFm(r.bwt, r.primary, r.l2, r.seq_len, r.sa, r.sa_intv))
        return self._scalar_fms

    def run_chunk(self, reads, device_batch=1024, per_read_semantics=False):
        """Process one reference-chunk of reads; returns list of
        (alns, max_entries) in read order.  device_batch is the jnp
        engine's slice; the CUDA engine launches whole shares.

        per_read_semantics=True mirrors bam2bam's per-record
        bwa_cal_sa_reg_gap calls (bam2bam.c:616,676): the batch-level
        max_gapo clamp (bwtaln.c:105) applies per READ; reads are grouped
        by their clamped max_gapo so each group runs with matching statics.
        """
        opt = self.opt
        if not reads:
            return []
        lens_arr = None
        if not isinstance(reads, list):
            from ..io.fastq import ReadBatch
            if isinstance(reads, ReadBatch):
                # columnar batch: lengths come off the offsets, and the
                # native engine packs seqs straight from the flats
                lens_arr = reads.clip_lens()
            else:
                reads = list(reads)
        max_len = int(lens_arr.max()) if lens_arr is not None \
            else max(r.len for r in reads)
        if opt.fnr > 0.0:
            tab = _maxdiff_table(opt.fnr, max(max_len, 64))
            per_read_maxdiff = tab[lens_arr] if lens_arr is not None \
                else np.array([tab[r.len] for r in reads], dtype=np.int32)
        else:
            per_read_maxdiff = np.full(len(reads), opt.max_diff,
                                       dtype=np.int32)

        results = [None] * len(reads)
        if not per_read_semantics:
            local = copy.copy(opt)
            if opt.fnr > 0.0:
                local.max_diff = cal_maxdiff(max_len, BWA_AVG_ERR, opt.fnr)
            if local.max_diff < local.max_gapo:
                local.max_gapo = local.max_diff

            # Heterogeneous overlap: the host's threaded native engine
            # (native/dfsgap.cpp) runs the same search bit-exactly, so a
            # chunk splits between the two.  jax dispatch is async: dispatch
            # the device share, run the native drain in THIS thread (the C
            # call drops the GIL; the device works through its queue
            # meanwhile), then collect.  The split fraction comes from
            # per-engine rate EMAs.
            use_native = self._native_ok()
            if use_native and self.mesh is None and device.force_native():
                self._drain_native(reads, per_read_maxdiff, local, results,
                                   list(range(len(reads))))
                self.last_split = {"tier0": 0, "retry": 0,
                                   "host": len(reads)}
                return results
            hybrid = (use_native and self.mesh is None and len(reads) >= 256
                      and device.on_gpu() and self.host_frac > 0.0)
            if hybrid:
                self._run_hybrid(reads, per_read_maxdiff, local, results,
                                 max_len, device_batch)
                return results
            self._run_device_only(reads, per_read_maxdiff, local, results,
                                  max_len, device_batch, use_native)
            return results

        # group by per-read clamped max_gapo (identical almost always)
        groups = {}
        for i, r in enumerate(reads):
            mg = min(opt.max_gapo, per_read_maxdiff[i]) \
                if opt.fnr > 0.0 else \
                (opt.max_gapo if opt.max_diff >= opt.max_gapo
                 else opt.max_diff)
            groups.setdefault(mg, []).append(i)
        # engine choice per group (results are bit-identical either way):
        # the jnp lockstep DFS on the CPU backend is the slowest option by
        # ~2 orders, so groups drain natively there; on the GPU the device
        # runs unless measurements say it loses its opportunity cost
        use_native = self._native_ok() and self.mesh is None and (
            not device.use_device()
            or (getattr(self, "_dev_rate", None) is not None
                and getattr(self, "_host_rate", None) is not None
                and self._dev_rate < 1.1 * self._host_rate
                / max(os.cpu_count() or 1, 1)))
        for mg, idxs in groups.items():
            local = copy.copy(opt)
            local.max_gapo = int(mg)
            local.max_diff = int(per_read_maxdiff[idxs].max())
            sub_reads = [reads[i] for i in idxs]
            sub_md = per_read_maxdiff[idxs]
            sub_res = [None] * len(idxs)
            sub_maxlen = max(r.len for r in sub_reads)
            if use_native:
                self._drain_native(sub_reads, sub_md, local, sub_res,
                                   list(range(len(idxs))))
            else:
                step = self._slice(device_batch)
                for start in range(0, len(sub_reads), step):
                    part = sub_reads[start:start + step]
                    self._run_device(part, sub_md[start:start + len(part)],
                                     local, sub_res, start, sub_maxlen)
            for i, res in zip(idxs, sub_res):
                results[i] = res
        return results

    def _run_hybrid(self, reads, per_read_maxdiff, local, results, max_len,
                    device_batch):
        """Split one chunk between the device and the host's native engine:
        dispatch the device share, drain the rest natively meanwhile, then
        collect; device overflow drains natively too."""
        n = len(reads)
        granule = 64 if self.dfs_engine == "cuda" else device_batch
        dev_rate = getattr(self, "_dev_rate", None)
        host_rate = getattr(self, "_host_rate", None)
        if dev_rate is None or host_rate is None:
            # no measured rates yet: the configured host fraction
            n_dev = (int(n * (1.0 - self.host_frac)) // granule) * granule
        else:
            n_dev = plan_device_share(n, granule, dev_rate, host_rate,
                                      os.cpu_count() or 1, self.DEV_LAT)
        env_share = os.environ.get("NABWA_DEV_SHARE")
        if env_share:
            # measurement override: pin the device share to a fixed
            # fraction (policy experiments on hardware)
            n_dev = min(n, (int(float(env_share) * n) // granule) * granule)
        step = self._slice(device_batch)
        handles = []
        t_disp0 = time.time()
        for start in range(0, n_dev, step):
            part = reads[start:min(start + step, n_dev)]
            handles.append((start, part, self._run_device(
                part, per_read_maxdiff[start:start + len(part)], local,
                results, start, max_len, dispatch_only=True)))
        # the device's own finish time, observed off this thread while the
        # native drain holds it: the device rate is then exact whichever
        # engine finishes first
        done = {}

        def watch():
            jax.block_until_ready([ctx["out"] for _, _, ctx in handles])
            done["t"] = time.time()

        watcher = threading.Thread(target=watch)
        watcher.start()
        t_host0 = time.time()
        if n_dev < n:
            self._drain_native(reads[n_dev:], per_read_maxdiff[n_dev:],
                               local, results, list(range(n_dev, n)))
        t_host1 = time.time()
        watcher.join()
        ovf = []
        for start, part, ctx in handles:
            fb = self._collect_device(ctx, part, results, start)
            ovf.extend(start + i for i in fb)
        if ovf:
            self._drain_native([reads[i] for i in ovf],
                               per_read_maxdiff[ovf], local, results, ovf)
        if n_dev:
            r = n_dev / max(done["t"] - t_disp0, 1e-9)
            self._dev_rate = r if dev_rate is None \
                else 0.5 * dev_rate + 0.5 * r
        if n_dev < n:
            r = (n - n_dev) / max(t_host1 - t_host0, 1e-9)
            self._host_rate = r if host_rate is None \
                else 0.5 * host_rate + 0.5 * r
        self.last_split = {"tier0": n_dev - len(ovf), "retry": 0,
                           "host": n - n_dev + len(ovf)}

    def _run_device_only(self, reads, per_read_maxdiff, local, results,
                         max_len, device_batch, use_native):
        """Pipelined device run: dispatch every tier-0 launch up front
        (jax dispatch is async; the device works through the queue), then
        collect in order.  Overflow reads re-run in the device's retry tier
        (bigger stack and hit store) and what overflows that drains to the
        host.  On the CPU backend the native engine out-runs the jnp
        emulation, so tier-0 overflow drains to it directly."""
        timing = bool(os.environ.get("NABWA_TIMING"))
        retry_on_device = device.on_gpu() or not use_native
        step = self._slice(device_batch)
        t_dev0 = time.time()
        handles = []
        for start in range(0, len(reads), step):
            part = reads[start:start + step]
            handles.append((start, part, self._run_device(
                part, per_read_maxdiff[start:start + len(part)],
                local, results, start, max_len, dispatch_only=True)))
        t_disp = time.time()
        defer, ovf = [], []
        for start, part, ctx in handles:
            fb = self._collect_device(ctx, part, results, start)
            if retry_on_device:
                # hw sorts the device retry hardest-first below
                hw = ctx["hw"]
                defer.extend((start + i, int(hw[i])) for i in fb)
            else:
                ovf.extend(start + i for i in fb)
        if timing:
            print(f"[aln.timing] tier0 dispatch {t_disp-t_dev0:.3f}s "
                  f"collect {time.time()-t_disp:.3f}s "
                  f"ovf={len(ovf)} defer={len(defer)}")
        if self.mesh is None and device.on_gpu():
            # clean device-only rate: seeds the hybrid split estimate.
            # The first device-only chunk per engine is compile-laden —
            # never let it into the EMA.
            if getattr(self, "_dev_warmed", False):
                r = len(reads) / max(time.time() - t_dev0, 1e-9)
                self._dev_rate = (0.5 * self._dev_rate + 0.5 * r
                                  if hasattr(self, "_dev_rate") else r)
            self._dev_warmed = True
        if ovf:
            t_n0 = time.time()
            self._drain_native([reads[i] for i in ovf],
                               per_read_maxdiff[ovf], local, results, ovf)
            if timing:
                print(f"[aln.timing] native drain {len(ovf)} reads "
                      f"{time.time()-t_n0:.3f}s")
        n_retry_host = 0
        if defer:
            # retry tier, pipelined like tier-0: dispatch every big-stack
            # launch before collecting any
            t_r0 = time.time()
            defer.sort(key=lambda t: -t[1])
            idxs = [i for i, _ in defer]
            fb_reads = [reads[i] for i in idxs]
            fb_md = per_read_maxdiff[idxs]
            sub_res = [None] * len(idxs)
            rhandles = []
            for start in range(0, len(fb_reads), step):
                part = fb_reads[start:start + step]
                rhandles.append((start, part, self._run_device(
                    part, fb_md[start:start + len(part)], local,
                    sub_res, start, max_len,
                    stack_cap=self.retry_stack_cap,
                    hits_cap=self.retry_hits_cap, tier=1,
                    dispatch_only=True)))
            for start, part, ctx in rhandles:
                fb = self._collect_device(ctx, part, sub_res, start)
                if fb:
                    # retry-tier overflow: native/scalar last resort
                    n_retry_host += len(fb)
                    fb_md2 = np.asarray([fb_md[start + i] for i in fb],
                                        dtype=np.int32)
                    self._drain_native([part[i] for i in fb], fb_md2,
                                       local, sub_res,
                                       [start + i for i in fb])
            for i, res in zip(idxs, sub_res):
                results[i] = res
            if timing:
                print(f"[aln.timing] device retry {len(idxs)} reads "
                      f"{time.time()-t_r0:.3f}s")
        self.last_split = {
            "tier0": len(reads) - len(ovf) - len(defer),
            "retry": len(defer) - n_retry_host,
            "host": len(ovf) + n_retry_host}

    def _native_ok(self):
        from ..index import native as native_mod
        return native_mod._load() is not None

    def sa_rows(self, a, rows):
        """Batched bwt_sa (bwt.c:72-81) for SA rows on strand-a's index:
        uint32 rows -> raw uint32 bwt_sa values (callers apply the
        reverse-index coordinate flip).  Runs on the device where
        device.use_device() says so, else on the native host walk."""
        rows = np.ascontiguousarray(rows, dtype=np.uint32)
        if len(rows) == 0:
            return np.zeros(0, dtype=np.uint32)
        fm = self.index.fwd if a else self.index.rev
        if self._native_ok() and not device.use_device():
            from ..index.native import bwt_sa_batch
            out = bwt_sa_batch(
                self._host_fwd if a else self._host_rev,
                fm.primary, self._host_l2, fm.seq_len, fm.sa, fm.sa_intv,
                rows)
            if out is not None:
                return out
        from ..ops.sa_lookup import sa_lookup
        device.count("sa_rows", len(rows))
        res = sa_lookup(
            self.bwt_fwd if a else self.bwt_rev, self.l2,
            self.primary_fwd if a else self.primary_rev, self.seq_len,
            self.sa_fwd if a else self.sa_rev, fm.sa_intv,
            jnp.asarray(rows.view(np.int32)))
        return np.asarray(res).view(np.uint32)

    def _drain_native(self, fb_reads, fb_maxdiff, local, results, idxs):
        """Solve reads on the host's threaded C++ DFS (bit-exact with the
        device engines); scalar-oracle fallback without the library."""
        from ..index.native import dfs_match_gap_native
        lo = copy.copy(local)
        lo.seed_len = self.opt.seed_len
        fb_maxdiff = np.asarray(fb_maxdiff, dtype=np.int32)
        native = dfs_match_gap_native(
            self._host_fwd, int(self.primary_fwd),
            self._host_rev, int(self.primary_rev),
            self._host_l2, int(self.seq_len),
            fb_reads, fb_maxdiff, lo,
            n_threads=getattr(self, "native_threads", 0))
        if native is not None:
            for i, res in zip(idxs, native):
                results[i] = res
            return
        fms = self.scalar_fms()
        from ..refmodel.dfs_scalar import match_gap
        from ..refmodel.aln_scalar import scalar_cal_width
        for i, r in zip(idxs, fb_reads):
            lo = copy.copy(local)
            if self.opt.fnr > 0.0:
                lo.max_diff = cal_maxdiff(r.len, BWA_AVG_ERR, self.opt.fnr)
            lo.seed_len = self.opt.seed_len \
                if self.opt.seed_len < r.len else 0x7FFFFFFF
            widths_s = (scalar_cal_width(fms[0], r.seq),
                        scalar_cal_width(fms[1], r.rseq))
            seed_w = None
            if r.len > self.opt.seed_len:
                seed_w = (
                    scalar_cal_width(fms[0],
                                     r.seq[r.len - self.opt.seed_len:]),
                    scalar_cal_width(fms[1],
                                     r.rseq[r.len - self.opt.seed_len:]))
            alns, hwv = match_gap(fms, r.len, (r.seq, r.rseq), widths_s,
                                  seed_w, lo, lo.max_diff, local.max_gapo)
            results[i] = (alns, hwv)

    def _collect_device(self, ctx, reads, results, base):
        """Block on one dispatched device call, unpack (ONE host transfer),
        fill `results`; returns the overflow index list (into reads)."""
        H = ctx["hits_cap"]
        out = unpack_result(np.asarray(ctx["out"]), H)
        n = len(reads)
        hw = out["hw"]
        ctx["hw"] = hw
        ok = ~out["overflow"][:n]
        n_aln = np.where(ok, out["n_aln"][:n], 0)
        # only the hits that exist cross into Python objects: a read has
        # one or two, the packed rows hold hits_cap slots
        valid = np.arange(H)[None, :] < n_aln[:, None]
        meta = out["hit_meta"][:n][valid].astype(np.int64)
        hits = list(zip(
            (meta & 0xFF).tolist(), ((meta >> 8) & 0xFF).tolist(),
            ((meta >> 16) & 0xFF).tolist(), ((meta >> 24) & 1).tolist(),
            out["hit_k"][:n][valid].view(np.uint32).tolist(),
            out["hit_l"][:n][valid].view(np.uint32).tolist(),
            out["hit_score"][:n][valid].tolist()))
        ends = np.cumsum(n_aln).tolist()
        hw_l = hw[:n].tolist()
        fallback = []
        start = 0
        for i, (good, end) in enumerate(zip(ok.tolist(), ends)):
            if good:
                results[base + i] = (hits[start:end], hw_l[i])
            else:
                fallback.append(i)
            start = end
        return fallback

    def _run_device(self, reads, maxdiff, local, results, base, max_len,
                    stack_cap=None, hits_cap=None, tier=0,
                    dispatch_only=False):
        stack_cap = stack_cap or self.stack_cap
        hits_cap = hits_cap or self.hits_cap
        max_iters = (self.tier0_max_iters
                     if tier == 0 and self.retry_stack_cap > stack_cap
                     else self.max_iters)
        device.count("dfs_retry_reads" if tier else "dfs_reads", len(reads))
        if self.dfs_engine == "cuda":
            from ..ops import dfs_cuda
            # the slab costs the kernel memory, not time per step, so
            # both tiers take the kernel's own stack, and in tier 0 the
            # iteration cap alone sends the slow reads on
            stack_cap = dfs_cuda.STACK_CAP
            B, L = dfs_cuda.bucket(len(reads), max_len)
            seqs, lengths, md = dfs_cuda.pack_reads(reads, maxdiff, B, L)
            out = dfs_cuda.dfs_call(
                self.bwt_fwd, self.bwt_rev, jnp.asarray(seqs),
                jnp.asarray(lengths), jnp.asarray(md),
                params=dfs_cuda.params(
                    self.primary_fwd, self.primary_rev, self.seq_len,
                    self.index.fwd.l2, local, stack_cap=stack_cap,
                    hits_cap=hits_cap, max_iters=max_iters))
        else:
            out = self._dispatch_jnp(reads, maxdiff, local, max_len,
                                     stack_cap, hits_cap, max_iters)

        ctx = dict(out=out, hits_cap=hits_cap)
        if dispatch_only:
            return ctx

        fallback = self._collect_device(ctx, reads, results, base)
        if fallback and tier == 0 and self.retry_stack_cap > self.stack_cap:
            # second device pass with the big stack for overflow reads only
            fb_reads = [reads[i] for i in fallback]
            fb_maxdiff = np.asarray([maxdiff[i] for i in fallback],
                                    dtype=np.int32)
            sub_results = [None] * len(fb_reads)
            self._run_device(fb_reads, fb_maxdiff, local, sub_results, 0,
                             max_len, stack_cap=self.retry_stack_cap,
                             hits_cap=self.retry_hits_cap, tier=1)
            for i, res in zip(fallback, sub_results):
                results[base + i] = res
            return

        if fallback:
            fb_reads = [reads[i] for i in fallback]
            fb_maxdiff = np.empty(len(fallback), dtype=np.int32)
            for j, r in enumerate(fb_reads):
                fb_maxdiff[j] = (cal_maxdiff(r.len, BWA_AVG_ERR,
                                             self.opt.fnr)
                                 if self.opt.fnr > 0.0 else local.max_diff)
            # pathological reads that overflow even the retry tier drain
            # on the host: threaded native C++ DFS (native/dfsgap.cpp) —
            # an irregular, pointer-chasing search is what scalar cores
            # do best — with the Python scalar oracle as last resort
            self._drain_native(fb_reads, fb_maxdiff, local, results,
                               [base + i for i in fallback])
            return
        return

    def _dispatch_jnp(self, reads, maxdiff, local, max_len, stack_cap,
                      hits_cap, max_iters):
        """Dispatch one slice to the jnp lockstep engine (ops/dfs.py)."""
        # Bucket shapes (B to 64s, L to 32s) so recurring batch geometries
        # reuse compiled kernels; padding lanes are len-0 (done immediately).
        B = max(64, -(-len(reads) // 64) * 64)
        L = max(32, -(-max_len // 32) * 32)
        nreads = len(reads)
        maxdiff = np.concatenate(
            [maxdiff, np.zeros(B - nreads, dtype=np.int32)])
        SL = min(local.seed_len, L) if local.seed_len < 0x7FFFFFFF else L
        SL = max(SL, 1)
        seqs = np.full((B, 2, L), 4, dtype=np.int32)
        lengths = np.zeros(B, dtype=np.int32)
        for i, r in enumerate(reads):
            seqs[i, 0, :r.len] = r.seq
            seqs[i, 1, :r.len] = r.rseq
            lengths[i] = r.len
        # seed-suffix extraction (last seed_len bases, bwtaln.c:127-130) on
        # host; everything device-side runs in ONE fused jit call
        has_seed = lengths > local.seed_len if local.seed_len < 0x7FFFFFFF \
            else np.zeros(B, dtype=bool)
        has_seed = np.asarray(has_seed, dtype=bool)
        seed_starts = np.maximum(lengths - (local.seed_len
                                            if local.seed_len < 0x7FFFFFFF
                                            else 0), 0)
        gather_idx = np.minimum(seed_starts[:, None] + np.arange(SL), L - 1)
        sseq = np.stack([np.take_along_axis(seqs[:, 0, :], gather_idx, 1),
                         np.take_along_axis(seqs[:, 1, :], gather_idx, 1)],
                        axis=1)
        slen = np.where(has_seed, min(local.seed_len, SL), 0).astype(np.int32)

        from ..ops.dfs import aln_device_step
        return aln_device_step(
            self.bwt_cat, self.bwt_fwd, self.bwt_rev, self.rev_off,
            self.primary_fwd, self.primary_rev, self.l2, self.seq_len,
            self._shard_batch(seqs), self._shard_batch(lengths),
            self._shard_batch(sseq), self._shard_batch(slen),
            self._shard_batch(has_seed), self._shard_batch(maxdiff),
            s_mm=local.s_mm, s_gapo=local.s_gapo, s_gape=local.s_gape,
            max_gape=local.max_gape, max_gapo=local.max_gapo,
            indel_end_skip=local.indel_end_skip,
            max_del_occ=local.max_del_occ, max_entries=local.max_entries,
            max_top2=local.max_top2, max_seed_diff=local.max_seed_diff,
            seed_len=local.seed_len, mode=local.mode,
            stack_cap=stack_cap, hits_cap=hits_cap, max_iters=max_iters)
