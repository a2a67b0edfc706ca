#!/usr/bin/env python3
"""Run the aligner's main path once on an NVIDIA GPU and check every output
against the host-native run of the same command.

  python chip_smoke.py           # one card: the phases below
  python chip_smoke.py --four    # four cards: mesh bam2bam vs one card

One process drives the card (a second JAX process would find most of its
memory reserved).  Every command goes through nabwa_tpu.cli.main, once on
the device paths and once with NABWA_FORCE_NATIVE=1, the repo's host
engines, as the plain reference; outputs must be byte-identical (.sai
bytes, SAM text, BAM records).  The device path is int32/uint32 end to end,
so the comparison is exact.

Data is synthetic and seeded: a 64,000,000 bp reference (chromosome-20
class) whose index lives on the device, 32,768 x 100 bp reads at 1 %
error with indels, 16,384 pairs with insert N(300, 40) and broken mates,
200 x 1 kb reads, 4,096 pairs in two read groups.  Phases:
  1 index     build, load, host-to-device copy, first-call compile; the
              CUDA DFS kernel vs its host twin and the jnp engine
  2 aln+samse 3 aln x2 + sampe   4 bwasw (+ its DP jobs replayed on the
  device)     5 bam2bam          6 device-only aln tiers
  7 timings on the card
The script fails on the first phase that fails.  Its last stdout line is
{"ok": true, "device": {...}}; a summary goes to chiprun_out/smoke*.json.
"""

import argparse
import contextlib
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GLEN = 64_000_000
SEED = 20
# the jnp engine's slice in the kernel check and in phase 7 (one compile)
JNP_SLICE = 8192
SUMMARY = {}
# (label, run, output) of each CLI command of phases 2-5, re-run warm in
# phase 7
WARM = []


def log(msg):
    print(msg, flush=True)


def card_line():
    """Card name and power limit, read by a child that stays off JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


@contextlib.contextmanager
def forced_native():
    os.environ["NABWA_FORCE_NATIVE"] = "1"
    try:
        yield
    finally:
        del os.environ["NABWA_FORCE_NATIVE"]


def cli(*argv):
    from nabwa_tpu import cli as cli_mod
    rc = cli_mod.main([str(a) for a in argv])
    if rc:
        raise RuntimeError(f"{argv[0]} exited with {rc}")


def both(label, run, out):
    """Run `run()` (which writes `out`) on the device paths and then
    host-native; returns (device_path, native_path, device_seconds,
    native_seconds, device work counted in nabwa_tpu.device.COUNTS)."""
    from nabwa_tpu import device
    out = pathlib.Path(out)
    WARM.append((label, run, out))
    res = []
    for tag in ("device", "native"):
        before = dict(device.COUNTS)
        t0 = time.perf_counter()
        if tag == "native":
            with forced_native():
                run()
        else:
            run()
        dt = time.perf_counter() - t0
        moved = out.with_name(f"{tag}.{out.name}")
        out.replace(moved)
        work = {k: device.COUNTS[k] - before[k] for k in before}
        res.append((moved, dt, work))
    (dev, t_dev, work), (nat, t_nat, nat_work) = res
    if any(nat_work.values()):
        raise RuntimeError(f"{label}: native run touched the device "
                           f"{nat_work}")
    log(f"  {label}: device run {t_dev:.3f} s, native run {t_nat:.3f} s, "
        f"device work {work}")
    return dev, nat, t_dev, t_nat, work


def same_bytes(label, a, b):
    da, db = pathlib.Path(a).read_bytes(), pathlib.Path(b).read_bytes()
    if da != db:
        n = next((i for i, (x, y) in enumerate(zip(da, db)) if x != y),
                 min(len(da), len(db)))
        raise RuntimeError(f"{label}: device output differs from native at "
                           f"byte {n} ({len(da)} vs {len(db)} bytes)")
    log(f"  {label}: identical ({len(da)} bytes)")


def read_list(fq):
    from nabwa_tpu.io import fastq
    return list(fastq.read_fastq_batch(fastq.iter_fastq(str(fq)), 1 << 22))


def write_pair_bam(path, fq1, fq2):
    """Unaligned paired BAM, pairs alternating between read groups rg1
    and rg2."""
    from nabwa_tpu.io import bam as bamio

    def recs_of(fq):
        lines = fq.strip().split(b"\n")
        for i in range(0, len(lines), 4):
            yield (lines[i][1:].decode().split("/")[0],
                   lines[i + 1].decode(), lines[i + 3].decode())

    recs = []
    for k, ((n1, s1, q1), (n2, s2, q2)) in enumerate(
            zip(recs_of(fq1), recs_of(fq2))):
        tags = b"RGZrg1\x00" if k % 2 == 0 else b"RGZrg2\x00"
        for name, s, q, fl in ((n1, s1, q1, bamio.BAM_FREAD1),
                               (n2, s2, q2, bamio.BAM_FREAD2)):
            r = bamio.sam_to_bamrec(
                name, bamio.BAM_FPAIRED | fl | bamio.BAM_FUNMAP | 8,
                -1, -1, 0, [], -1, -1, 0, s, q, tags)
            r.bin = 0
            recs.append(r)
    bamio.make_bam(str(path), [], recs,
                   text="@HD\tVN:1.4\n@RG\tID:rg1\tSM:a\n"
                        "@RG\tID:rg2\tSM:b\n")


def same_records(label, a, b):
    from tests.test_bam2bam import dump_records
    ta, ra = dump_records(str(a))
    tb, rb = dump_records(str(b))
    if ta != tb:
        raise RuntimeError(f"{label}: BAM headers differ")
    if len(ra) != len(rb):
        raise RuntimeError(f"{label}: {len(ra)} vs {len(rb)} records")
    for i, (x, y) in enumerate(zip(ra, rb)):
        if x != y:
            raise RuntimeError(f"{label}: record {i} differs:\n{x}\n{y}")
    rgs = set()
    for rec in ra:
        d = rec[-1]
        i = d.find(b"RGZ")
        if i >= 0:
            rgs.add(bytes(d[i + 3:d.index(b"\x00", i)]))
    log(f"  {label}: identical ({len(ra)} records, read groups "
        f"{sorted(g.decode() for g in rgs)})")
    return len(ra), len(rgs)


def make_reference(work, glen):
    from tests import genomes
    t0 = time.perf_counter()
    fa, seqs = genomes.random_genome(glen, seed=SEED)
    (work / "ref.fa").write_bytes(fa)
    log(f"  reference: {glen} bp generated in "
        f"{time.perf_counter() - t0:.3f} s")
    return work / "ref.fa", seqs[0]


def phase_index(work, prefix, reads):
    from nabwa_tpu.index.fmindex import BwaIndex
    from nabwa_tpu.models.aln import AlnEngine
    from nabwa_tpu.ops import dfs_cuda
    from nabwa_tpu.options import GapOpt
    from tests.test_dfs_cuda import batch_inputs, kernel_matches_references
    import jax

    log("[phase 1] index")
    t0 = time.perf_counter()
    cli("index", prefix)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = BwaIndex.load(str(prefix))
    t_load = time.perf_counter() - t0
    eng = AlnEngine(idx, GapOpt())
    t0 = time.perf_counter()
    eng._device_init()
    jax.block_until_ready([eng.bwt_fwd, eng.bwt_rev, eng.l2, eng.sa_fwd,
                           eng.sa_rev])
    t_h2d = time.perf_counter() - t0 - dfs_cuda.build_seconds
    occ_mb = (idx.fwd.bwt.nbytes + idx.rev.bwt.nbytes) / 1e6
    sa_mb = (idx.fwd.sa.nbytes + idx.rev.sa.nbytes) / 1e6
    _, _, md, _, local = batch_inputs(eng, reads[:64], GapOpt(), stack_cap=0,
                                      hits_cap=0, max_iters=0)
    t0 = time.perf_counter()
    eng._run_device(reads[:64], md, local, [None] * 64, 0, 100)
    t_first = time.perf_counter() - t0
    mem = jax.devices()[0].memory_stats() or {}
    log(f"  build {t_build:.3f} s | load {t_load:.3f} s | CUDA kernel "
        f"build {dfs_cuda.build_seconds:.3f} s | host-to-device "
        f"{t_h2d:.3f} s ({occ_mb:.1f} MB occ tables, {sa_mb:.1f} MB SA "
        f"samples) | first DFS call incl. compile {t_first:.3f} s | "
        f"bytes_in_use {mem.get('bytes_in_use')}")
    n, n_ovf = kernel_matches_references(idx, reads[:JNP_SLICE], GapOpt())
    log(f"  CUDA DFS kernel == host twin == jnp engine on {n} reads "
        f"({n_ovf} flagged for the host)")
    SUMMARY["index"] = dict(
        build_s=t_build, load_s=t_load, cuda_build_s=dfs_cuda.build_seconds,
        h2d_s=t_h2d, occ_mb=occ_mb, sa_mb=sa_mb, first_call_s=t_first,
        bytes_in_use=mem.get("bytes_in_use"), kernel_check_reads=n,
        kernel_check_flagged=n_ovf)
    return idx


def phase_aln_samse(work, prefix, fq):
    log("[phase 2] aln + samse, 100 bp reads")
    sai = work / "se.sai"
    dev_sai, nat_sai, t_dev, t_nat, w = both(
        "aln", lambda: cli("aln", "-f", sai, prefix, fq), sai)
    if not w["dfs_reads"]:
        raise RuntimeError("aln: no read went to the device DFS")
    same_bytes("aln .sai", dev_sai, nat_sai)
    sam = work / "se.sam"
    dev_sam, nat_sam, _, _, w2 = both(
        "samse", lambda: cli("samse", "-f", sam, prefix, dev_sai, fq), sam)
    if not w2["sa_rows"]:
        raise RuntimeError("samse: no SA walk ran on the device")
    same_bytes("samse SAM", dev_sam, nat_sam)
    SUMMARY["aln_samse"] = dict(aln_device_s=t_dev, aln_native_s=t_nat,
                                aln_work=w, samse_work=w2)
    return dev_sai


def phase_sampe(work, prefix, fq1, fq2):
    log("[phase 3] aln x2 + sampe, pairs of 2 x 100 bp")
    sais = []
    for e, fq in ((1, fq1), (2, fq2)):
        sai = work / f"pe{e}.sai"
        dev_sai, nat_sai, _, _, _ = both(
            f"aln read {e}", lambda fq=fq, sai=sai: cli("aln", "-f", sai,
                                                        prefix, fq), sai)
        same_bytes(f"aln read {e} .sai", dev_sai, nat_sai)
        sais.append(dev_sai)
    sam = work / "pe.sam"
    dev_sam, nat_sam, t_dev, t_nat, w = both(
        "sampe", lambda: cli("sampe", "-f", sam, prefix, sais[0], sais[1],
                             fq1, fq2), sam)
    if not (w["sa_rows"] and w["dp_jobs"]):
        raise RuntimeError(f"sampe: SA walks / DP not on the device: {w}")
    same_bytes("sampe SAM", dev_sam, nat_sam)
    SUMMARY["sampe"] = dict(device_s=t_dev, native_s=t_nat, work=w)


def phase_bwasw(work, prefix, fq):
    """bwasw through the CLI, then the same reads through the per-read
    object path with every extension / CIGAR DP job recorded, replayed
    as one batch on the device and compared with the host kernels."""
    from nabwa_tpu import device
    from nabwa_tpu.index.fmindex import BwaIndex
    from nabwa_tpu.models import bwasw as bw
    from nabwa_tpu.ops import dp

    log("[phase 4] bwasw, 1 kb reads")
    sam = work / "sw.sam"
    dev_sam, nat_sam, _, _, w = both(
        "bwasw", lambda: cli("bwasw", "-f", sam, prefix, fq), sam)
    same_bytes("bwasw SAM", dev_sam, nat_sam)

    lines = pathlib.Path(fq).read_bytes().split(b"\n")
    reads = [(lines[i][1:].decode(), lines[i + 1].decode(),
              lines[i + 3].decode()) for i in range(0, len(lines) - 1, 4)]
    idx = BwaIndex.load(str(prefix))
    rec = {"ext": [], "glob": []}
    ext0, glob0 = dp.extend_batch, dp.banded_global_batch

    def ext(jobs, ap, g0s):
        out = ext0(jobs, ap, g0s)
        rec["ext"].append((jobs, ap, list(g0s), out))
        return out

    def glob(jobs, ap, band_widths=None):
        out = glob0(jobs, ap, band_widths)
        if band_widths is None:
            rec["glob"].append((jobs, ap, out))
        return out

    dp.extend_batch, dp.banded_global_batch = ext, glob
    os.environ["NABWA_BWASW_OBJ"] = "1"
    try:
        text = bw.bwasw(idx, reads)
    finally:
        del os.environ["NABWA_BWASW_OBJ"]
        dp.extend_batch, dp.banded_global_batch = ext0, glob0
    sam_body = dev_sam.read_text()
    if text != sam_body:
        raise RuntimeError("bwasw: per-read object path != CLI output")
    n_calls = len(rec["ext"]) + len(rec["glob"])
    log(f"  bwasw object path == CLI output; {n_calls} DP batches, largest "
        f"{max(len(j) for j, *_ in rec['ext'] + rec['glob'])} jobs "
        f"(under 64 run on the host)")
    before = device.COUNTS["dp_jobs"]
    for kind, calls in rec.items():
        groups = {}
        for call in calls:
            groups.setdefault(repr(vars(call[1])), []).append(call)
        for group in groups.values():
            ap = group[0][1]
            jobs = [j for c in group for j in c[0]]
            want = [r for c in group for r in c[-1]]
            if kind == "ext":
                g0s = [g for c in group for g in c[2]]
                got = ext0(jobs, ap, g0s)
            else:
                got = glob0(jobs, ap)
            if list(got) != list(want):
                raise RuntimeError(f"bwasw {kind} DP: device != host")
    n_dev = device.COUNTS["dp_jobs"] - before
    if not n_dev:
        raise RuntimeError("bwasw DP replay did not reach the device")
    log(f"  {n_dev} bwasw DP jobs replayed on the device == host kernels")
    SUMMARY["bwasw"] = dict(work=w, dp_batches=n_calls,
                            dp_jobs_replayed=n_dev)


def phase_bam2bam(work, prefix, fq1, fq2):
    log("[phase 5] bam2bam, pairs in 2 read groups")
    write_pair_bam(work / "in.bam", fq1, fq2)
    out = work / "out.bam"
    dev, nat, t_dev, t_nat, w = both(
        "bam2bam", lambda: cli("bam2bam", "-g", prefix, "-t", "1",
                               "--temp-dir", work, "-f", out,
                               work / "in.bam"), out)
    if not w["dfs_reads"]:
        raise RuntimeError("bam2bam: no read went to the device DFS")
    n, n_rg = same_records("bam2bam", dev, nat)
    if n_rg != 2:
        raise RuntimeError(f"bam2bam: {n_rg} read groups in the output")
    SUMMARY["bam2bam"] = dict(device_s=t_dev, native_s=t_nat, work=w,
                              records=n)


def phase_device_only(idx, reads):
    from nabwa_tpu.models.aln import AlnEngine
    from nabwa_tpu.options import GapOpt

    log("[phase 6] device-only aln (host_frac = 0)")
    eng = AlnEngine(idx, GapOpt(), host_frac=0)
    got = eng.run_chunk(reads)
    split = dict(eng.last_split)
    with forced_native():
        want = AlnEngine(idx, GapOpt()).run_chunk(reads)
    if [a for a, _ in got] != [a for a, _ in want]:
        raise RuntimeError("device-only aln != native aln")
    n = len(reads)
    on_dev = split["tier0"] + split["retry"]
    log(f"  {n} reads: tier 0 {split['tier0']}, retry tier "
        f"{split['retry']}, drained to host {split['host']} "
        f"({100.0 * on_dev / n:.2f} % on the device); hits == native")
    if on_dev < 0.8 * n:
        raise RuntimeError("the device solved under 80 % of the reads")
    SUMMARY["device_only"] = dict(split, n=n)


def rate(fn, n, repeat=3):
    """Median reads/s of `fn` over `repeat` warm runs (one warm-up)."""
    fn()
    ts = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return n / statistics.median(ts), ts


def phase_timings(work, prefix, idx, reads, fq):
    import jax
    from nabwa_tpu import device
    from nabwa_tpu.models.aln import AlnEngine
    from nabwa_tpu.options import GapOpt

    log("[phase 7] timings on the card (each run ends in "
        "block_until_ready or a host copy of its result)")
    n = len(reads)
    out = {}
    cuda = AlnEngine(idx, GapOpt(), host_frac=0)
    out["cuda_device_only_rps"], ts = rate(lambda: cuda.run_chunk(reads), n)
    log(f"  device-only aln, CUDA kernel: {out['cuda_device_only_rps']:.1f} "
        f"reads/s (runs {[round(t, 4) for t in ts]} s) split "
        f"{cuda.last_split}")
    # the CUDA kernel alone on one tier-0 launch of all reads, inputs
    # packed once; then the same reads under the retry tier's caps, for
    # the per-read iteration distribution
    import numpy as np
    import jax.numpy as jnp
    from nabwa_tpu.ops import dfs_cuda
    from nabwa_tpu.ops.dfs import unpack_result
    from tests.test_dfs_cuda import batch_inputs
    for tier, (S, H, it) in (("tier0", (dfs_cuda.STACK_CAP, 32, 768)),
                             ("retry_caps",
                              (dfs_cuda.STACK_CAP, 128, 2_000_000))):
        t0 = time.perf_counter()
        seqs, lengths, md, p, _ = batch_inputs(
            cuda, reads, GapOpt(), stack_cap=S, hits_cap=H, max_iters=it)
        out["pack_s"] = time.perf_counter() - t0
        args = [jnp.asarray(x) for x in (seqs, lengths, md)]
        res = {}

        def kern():
            res["out"] = jax.block_until_ready(dfs_cuda.dfs_call(
                cuda.bwt_fwd, cuda.bwt_rev, *args, params=p))
        out[f"cuda_{tier}_kernel_rps"], ts = rate(kern, n)
        u = unpack_result(np.asarray(res["out"]), H)
        it_ok = u["fin"][:n][~u["overflow"][:n]]
        pct = {q: int(np.percentile(it_ok, q)) for q in (50, 90, 99, 100)}
        out[f"cuda_{tier}_iters_pct"] = pct
        out[f"cuda_{tier}_flagged"] = int(u["overflow"][:n].sum())
        log(f"  CUDA kernel alone, {tier} caps (stack {S}, hits {H}, "
            f"{it} iterations): {out[f'cuda_{tier}_kernel_rps']:.1f} "
            f"reads/s (runs {[round(t, 4) for t in ts]} s), flagged "
            f"{out[f'cuda_{tier}_flagged']}, iterations of the rest "
            f"p50/p90/p99/max {list(pct.values())}")
    ctx = {"out": res["out"], "hits_cap": 128}
    t0 = time.perf_counter()
    cuda._collect_device(ctx, reads, [None] * n, 0)
    out["collect_s"] = time.perf_counter() - t0
    log(f"  host side of one {n}-read launch: pack {out['pack_s']:.4f} s, "
        f"unpack+collect {out['collect_s']:.4f} s")
    # the lockstep engine's retry tier iterates until its slowest lane
    # ends; a per-read cap of 20000 iterations routes pathological reads
    # to the host instead (same results)
    jeng = AlnEngine(idx, GapOpt(), host_frac=0, dfs_engine="jnp",
                     max_iters=20_000)
    t0 = time.perf_counter()
    jeng.run_chunk(reads[:JNP_SLICE], device_batch=JNP_SLICE)
    t_jc = time.perf_counter() - t0
    out["jnp_first_run_s"] = t_jc
    out["jnp_device_only_rps"], ts = rate(
        lambda: jeng.run_chunk(reads, device_batch=JNP_SLICE), n, repeat=1)
    log(f"  device-only aln, jnp engine ({JNP_SLICE}-read slices): "
        f"{out['jnp_device_only_rps']:.1f} reads/s (run {ts[0]:.4f} s; "
        f"first slice incl. retry-tier compile {t_jc:.3f} s) split "
        f"{jeng.last_split}")
    host = AlnEngine(idx, GapOpt())
    threads = os.cpu_count() or 1
    host.native_threads = threads
    with forced_native():
        out["native_rps"], ts = rate(lambda: host.run_chunk(reads), n)
    out["native_threads"] = threads
    log(f"  host native engine: {out['native_rps']:.1f} reads/s on "
        f"{threads} threads (runs {[round(t, 4) for t in ts]} s)")
    sai = work / "t.sai"

    def cli_aln():
        sai.unlink(missing_ok=True)
        cli("aln", "-f", sai, prefix, fq)

    before = device.COUNTS["dfs_reads"]
    out["cli_hybrid_rps"], ts = rate(cli_aln, n, repeat=1)
    n_dev = (device.COUNTS["dfs_reads"] - before) // 2
    out["cli_hybrid_device_reads"] = n_dev
    log(f"  CLI aln (hybrid, fresh engine per run): "
        f"{out['cli_hybrid_rps']:.1f} reads/s (wall incl. index load "
        f"and I/O, {ts[0]:.4f} s), split device {n_dev} / host {n - n_dev}")
    hyb = AlnEngine(idx, GapOpt())
    for _ in range(3):
        t0 = time.perf_counter()
        hyb.run_chunk(reads)
        dt = time.perf_counter() - t0
    out["engine_hybrid_rps"] = n / dt
    out["engine_hybrid_split"] = dict(hyb.last_split)
    log(f"  hybrid engine, third chunk (rates learned): "
        f"{out['engine_hybrid_rps']:.1f} reads/s, split {hyb.last_split}")
    lat = []
    part = reads[:64]
    _, _, md, _, local = batch_inputs(cuda, part, GapOpt(), stack_cap=0,
                                      hits_cap=0, max_iters=0)
    for _ in range(21):
        res = [None] * 64
        t0 = time.perf_counter()
        ctx = cuda._run_device(part, md, local, res, 0, 100,
                               dispatch_only=True)
        cuda._collect_device(ctx, part, res, 0)
        lat.append(time.perf_counter() - t0)
    out["slice64_latency_s"] = statistics.median(lat[1:])
    log(f"  dispatch -> collect of one 64-read CUDA launch: median "
        f"{out['slice64_latency_s'] * 1e3:.3f} ms over 20")
    out["warm"] = {}
    for label, run, path in list(WARM):
        dev, nat, t_dev, t_nat, w = both(f"{label} (warm)", run, path)
        (same_records if path.suffix == ".bam" else same_bytes)(
            f"{label} (warm)", dev, nat)
        out["warm"][label] = dict(device_s=t_dev, native_s=t_nat, work=w)
    mem = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = mem.get("peak_bytes_in_use")
    log(f"  peak_bytes_in_use {out['peak_bytes_in_use']}")
    SUMMARY["timings"] = out


def one_card(work, glen, n_se=32768, n_pe=16384, n_sw=200, n_b2b=4096):
    from tests import genomes
    from tests.test_sampe import make_pairs

    fa, seq = make_reference(work, glen)
    t0 = time.perf_counter()
    fq = work / "se.fq"
    fq.write_bytes(genomes.sample_reads(seq, n_se, 100, seed=SEED + 1,
                                        err_rate=0.01, indel_rate=0.1))
    p1, p2 = make_pairs(seq, n_pe, 100, 300, 40, SEED + 2, err_rate=0.01,
                        frac_broken=0.1)
    (work / "pe1.fq").write_bytes(p1)
    (work / "pe2.fq").write_bytes(p2)
    (work / "sw.fq").write_bytes(genomes.sample_reads(
        seq, n_sw, 1000, seed=SEED + 3, err_rate=0.01, indel_rate=0.5))
    b1, b2 = make_pairs(seq, n_b2b, 100, 300, 40, SEED + 4, err_rate=0.01,
                        frac_broken=0.1)
    log(f"  {n_se} single reads, {n_pe} pairs, {n_sw} x 1 kb reads, "
        f"{n_b2b} bam2bam pairs generated in "
        f"{time.perf_counter() - t0:.3f} s")
    reads = read_list(fq)
    idx = phase_index(work, fa, reads)
    phase_aln_samse(work, fa, fq)
    phase_sampe(work, fa, work / "pe1.fq", work / "pe2.fq")
    phase_bwasw(work, fa, work / "sw.fq")
    phase_bam2bam(work, fa, b1, b2)
    phase_device_only(idx, reads)
    phase_timings(work, fa, idx, reads, fq)


def device_bytes(devs):
    """bytes_in_use of each device (arrays the program holds there)."""
    return [(d.memory_stats() or {}).get("bytes_in_use") for d in devs]


def four_cards(work, glen, n_pairs=32768):
    import jax
    from nabwa_tpu.index.fmindex import BwaIndex
    from nabwa_tpu.models import bam2bam as b2b
    from nabwa_tpu.models.aln import AlnEngine
    from nabwa_tpu.options import GapOpt, PeOpt
    from nabwa_tpu.parallel.mesh import make_mesh
    from nabwa_tpu.utils.rand48 import Rand48
    from tests.test_sampe import make_pairs

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, have {len(jax.devices())}")
    fa, seq = make_reference(work, glen)
    b1, b2 = make_pairs(seq, n_pairs, 100, 300, 40, SEED + 5,
                        err_rate=0.01, frac_broken=0.1)
    write_pair_bam(work / "in.bam", b1, b2)
    t0 = time.perf_counter()
    cli("index", fa)
    log(f"  index built in {time.perf_counter() - t0:.3f} s")
    idx = BwaIndex.load(str(fa))

    def run(name, engine, **kw):
        t0 = time.perf_counter()
        b2b.bam2bam(engine, str(work / "in.bam"), str(work / name),
                    GapOpt(), PeOpt(), Rand48(idx.bns.seed),
                    argv=["bam2bam"], version="ref", tmp_dir=str(work), **kw)
        return time.perf_counter() - t0

    log(f"[four] bam2bam, {n_pairs} pairs, 2 read groups: one card vs a "
        "4-card dp mesh")
    t_one = run("one.bam", AlnEngine(idx, GapOpt()), n_workers=1)
    log(f"  one card (CUDA DFS): {t_one:.3f} s")
    mesh = make_mesh(4)
    # the lockstep engine's per-read iteration cap (see phase 7)
    eng = AlnEngine(idx, GapOpt(), mesh=mesh, max_iters=20_000)
    # chunks of 1024 records (64 at 32768 pairs): every worker thread
    # takes many leases, and both read groups interleave in every chunk
    with mesh:
        t_mesh = run("mesh.bam", eng, n_workers=4, chunk_size=1024)
    log(f"  4-card mesh (jnp DFS, reads dp-sharded, index replicated): "
        f"{t_mesh:.3f} s")
    used = device_bytes(jax.devices()[:4])
    log(f"  bytes_in_use per device: {used}")
    if min(used) < 0.5 * (idx.fwd.bwt.nbytes + idx.rev.bwt.nbytes):
        raise RuntimeError("the index is not replicated on every device")
    n, n_rg = same_records("mesh bam2bam vs one card", work / "mesh.bam",
                           work / "one.bam")
    if n_rg != 2:
        raise RuntimeError(f"{n_rg} read groups in the output")
    SUMMARY["four"] = dict(one_card_s=t_one, mesh_s=t_mesh,
                           bytes_in_use=used, records=n)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="mesh bam2bam on four cards vs one card, only")
    ap.add_argument("--glen", type=int, default=GLEN,
                    help="reference length (default %(default)s)")
    args = ap.parse_args()

    import jax
    devs = jax.devices()
    d = devs[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    if d.platform != "gpu":
        sys.exit("chip_smoke: JAX found no GPU; nothing was run")
    log(f"[card] {card_line()}")
    sys.path.insert(0, str(ROOT))
    from nabwa_tpu.device import setup_compile_cache
    log(f"[setup] compile cache: {setup_compile_cache()}")
    work = ROOT / ".smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    t0 = time.perf_counter()
    (four_cards if args.four else one_card)(work, args.glen)
    SUMMARY["total_s"] = time.perf_counter() - t0
    SUMMARY["card"] = card_line()
    SUMMARY["device"] = {"platform": d.platform, "kind": d.device_kind,
                         "count": len(devs)}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / ("smoke_four.json" if args.four else "smoke.json")).write_text(
        json.dumps(SUMMARY, indent=1, default=str) + "\n")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[done] {SUMMARY['total_s']:.3f} s")
    print(json.dumps({"ok": True, "device": SUMMARY["device"]}))


if __name__ == "__main__":
    main()
