"""The CUDA DFS kernel's contract, tested without a card.

The kernel (native/dfs_cuda.cu) and its host twin (dfs_fixed_batch in
native/dfsgap.cpp) run the same code from native/dfsgap_core.h.  The twin
must give the packed result of the jnp lockstep engine
(ops.dfs.aln_device_step) — same hits in the same order, same stack
high-water, same finishing iteration, same overflow flags — and the jnp
engine is itself golden-tested against reference `bwa aln` .sai output
(test_dfs_device.py).  The kernel itself runs only on the GPU: its test
carries the `gpu` marker, skips here, and chip_smoke.py runs its body on
the card.
"""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nabwa_tpu.constants import BWA_AVG_ERR
from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.io import fastq
from nabwa_tpu.models.aln import AlnEngine, _maxdiff_table
from nabwa_tpu.options import GapOpt
from nabwa_tpu.ops import dfs_cuda
from nabwa_tpu.ops.dfs import aln_device_step, unpack_result
from nabwa_tpu.refmodel.aln_scalar import cal_maxdiff

from . import genomes


def batch_inputs(eng, reads, opt, *, stack_cap, hits_cap, max_iters):
    """Kernel inputs for one launch over `reads`, as AlnEngine builds
    them: (seqs u8, lengths, maxdiff, params, local opt)."""
    max_len = max(r.len for r in reads)
    local = copy.copy(opt)
    if opt.fnr > 0.0:
        local.max_diff = cal_maxdiff(max_len, BWA_AVG_ERR, opt.fnr)
        tab = _maxdiff_table(opt.fnr, max(max_len, 64))
        maxdiff = np.array([tab[r.len] for r in reads], dtype=np.int32)
    else:
        maxdiff = np.full(len(reads), opt.max_diff, dtype=np.int32)
    if local.max_diff < local.max_gapo:
        local.max_gapo = local.max_diff
    B, L = dfs_cuda.bucket(len(reads), max_len)
    seqs, lengths, md = dfs_cuda.pack_reads(reads, maxdiff, B, L)
    params = dfs_cuda.params(
        eng.primary_fwd, eng.primary_rev, eng.seq_len, eng.index.fwd.l2,
        local, stack_cap=stack_cap, hits_cap=hits_cap, max_iters=max_iters)
    return seqs, lengths, md, params, local


def jnp_reference(eng, seqs, lengths, md, local, *, stack_cap, hits_cap,
                  max_iters):
    """The jnp lockstep engine on the same launch (seed suffixes built as
    AlnEngine._dispatch_jnp builds them)."""
    B, _, L = seqs.shape
    seqs_a = seqs.astype(np.int32)
    SL = max(min(local.seed_len, L), 1)
    has_seed = lengths > local.seed_len
    starts = np.maximum(lengths - local.seed_len, 0)
    gi = np.minimum(starts[:, None] + np.arange(SL), L - 1)
    sseq = np.stack([np.take_along_axis(seqs_a[:, 0, :], gi, 1),
                     np.take_along_axis(seqs_a[:, 1, :], gi, 1)], axis=1)
    slen = np.where(has_seed, min(local.seed_len, SL), 0).astype(np.int32)
    return np.asarray(aln_device_step(
        eng.bwt_cat, eng.bwt_fwd, eng.bwt_rev, eng.rev_off,
        eng.primary_fwd, eng.primary_rev, eng.l2, eng.seq_len,
        jnp.asarray(seqs_a), jnp.asarray(lengths), jnp.asarray(sseq),
        jnp.asarray(slen), jnp.asarray(has_seed), jnp.asarray(md),
        s_mm=local.s_mm, s_gapo=local.s_gapo, s_gape=local.s_gape,
        max_gape=local.max_gape, max_gapo=local.max_gapo,
        indel_end_skip=local.indel_end_skip, max_del_occ=local.max_del_occ,
        max_entries=local.max_entries, max_top2=local.max_top2,
        max_seed_diff=local.max_seed_diff, seed_len=local.seed_len,
        mode=local.mode, stack_cap=stack_cap, hits_cap=hits_cap,
        max_iters=max_iters))


def assert_same_packed(want, got, hits_cap, n_reads):
    """Equal overflow flags; for reads not flagged, equal hits (in order),
    n_aln, stack high-water and finishing iteration.  Returns the number
    of flagged reads."""
    wu, gu = unpack_result(want, hits_cap), unpack_result(got, hits_cap)
    np.testing.assert_array_equal(wu["overflow"], gu["overflow"])
    n_ovf = 0
    for i in range(want.shape[0]):
        if wu["overflow"][i]:
            n_ovf += i < n_reads
            continue
        n = int(wu["n_aln"][i])
        assert int(gu["n_aln"][i]) == n, f"read {i} n_aln"
        for f in ("hit_meta", "hit_k", "hit_l", "hit_score"):
            np.testing.assert_array_equal(wu[f][i, :n], gu[f][i, :n],
                                          err_msg=f"read {i} {f}")
        for f in ("hw", "fin"):
            assert int(wu[f][i]) == int(gu[f][i]), f"read {i} {f}"
    return n_ovf


@dataclasses.dataclass
class Case:
    glen: int
    n_reads: int
    read_len: int
    err: float
    indel: float
    seed: int
    opt: GapOpt
    stack_cap: int = 1024
    hits_cap: int = 64
    max_iters: int = 100000
    n_threads: int = 1
    reverse: bool = False      # feed the reads in reverse order
    repeats: int = 0           # near-copies of the reads' source block
    want_overflow: bool = False


GAPPED = dict(max_diff=4, fnr=-1.0, max_gapo=2)

CASES = {
    "mismatches": Case(20000, 16, 40, 0.02, 0.2, 301, GapOpt()),
    "gapped": Case(30000, 16, 75, 0.02, 0.5, 302, GapOpt(**GAPPED)),
    "seeded": Case(30000, 16, 80, 0.03, 0.2, 303, GapOpt(seed_len=25)),
    # more reads than threads: the work-stealing order must not matter
    "gapped_threads": Case(30000, 48, 75, 0.02, 0.5, 304,
                           GapOpt(**GAPPED), n_threads=4),
    "seeded_reversed": Case(30000, 24, 80, 0.03, 0.2, 305,
                            GapOpt(seed_len=25), reverse=True),
    # 70 reads bucket to a 128-lane launch: 58 padding lanes
    "padded": Case(30000, 70, 60, 0.02, 0.3, 306, GapOpt()),
    "stack_overflow": Case(30000, 16, 75, 0.03, 0.5, 307, GapOpt(**GAPPED),
                           stack_cap=32, want_overflow=True),
    "iteration_cap": Case(30000, 16, 75, 0.03, 0.5, 308, GapOpt(**GAPPED),
                          max_iters=60, want_overflow=True),
    # reads from a 120 bp block with 6 one-substitution copies: up to 7
    # hits per read
    "hits_overflow": Case(30000, 16, 75, 0.0, 0.0, 309, GapOpt(),
                          hits_cap=2, repeats=6, want_overflow=True),
}


def _index_and_reads(tmp_path, c):
    fa, seqs = genomes.random_genome(c.glen, seed=c.seed)
    src = seqs[0]
    if c.repeats:
        rng = np.random.default_rng(c.seed)
        g = bytearray(src)
        src = bytes(g[1000:1120])
        for j in range(c.repeats):
            copy_ = bytearray(src)
            p = int(rng.integers(0, len(copy_)))
            copy_[p] = b"ACGT"[(b"ACGT".index(copy_[p]) + 1) % 4]
            at = 5000 + 3000 * j
            g[at:at + len(copy_)] = copy_
        fa = b">rep\n" + b"".join(bytes(g[i:i + 70]) + b"\n"
                                   for i in range(0, len(g), 70))
    fq = genomes.sample_reads(src, c.n_reads, c.read_len,
                              seed=c.seed + 1, err_rate=c.err,
                              indel_rate=c.indel)
    (tmp_path / "g.fa").write_bytes(fa)
    (tmp_path / "r.fq").write_bytes(fq)
    build_index(str(tmp_path / "g.fa"))
    idx = BwaIndex.load(str(tmp_path / "g.fa"))
    reads = fastq.read_fastq_batch(fastq.iter_fastq(str(tmp_path / "r.fq")),
                                   1 << 20)
    return idx, list(reads)


@pytest.mark.parametrize("name", list(CASES))
def test_host_twin_matches_jnp_engine(tmp_path, name):
    c = CASES[name]
    idx, reads = _index_and_reads(tmp_path, c)
    if c.reverse:
        reads = reads[::-1]
    eng = AlnEngine(idx, c.opt, dfs_engine="jnp")
    caps = dict(stack_cap=c.stack_cap, hits_cap=c.hits_cap,
                max_iters=c.max_iters)
    seqs, lengths, md, params, local = batch_inputs(eng, reads, c.opt,
                                                    **caps)
    want = jnp_reference(eng, seqs, lengths, md, local, **caps)
    got = dfs_cuda.run_host(idx.fwd.bwt.view(np.int32),
                            idx.rev.bwt.view(np.int32), seqs, lengths, md,
                            params, n_threads=c.n_threads)
    n_ovf = assert_same_packed(want, got, c.hits_cap, len(reads))
    assert (n_ovf > 0) == c.want_overflow, n_ovf
    assert n_ovf < len(reads)
    # padding lanes finish at once, empty
    gu = unpack_result(got, c.hits_cap)
    assert not gu["n_aln"][len(reads):].any()
    assert not gu["overflow"][len(reads):].any()


@pytest.mark.parametrize("n_reads,max_len,want", [
    (1, 1, (64, 32)),
    (64, 32, (64, 32)),
    (65, 33, (128, 64)),
    (32768, 100, (32768, 128)),
    (40000, 250, (65536, 256)),
])
def test_bucket_shapes(n_reads, max_len, want):
    assert dfs_cuda.bucket(n_reads, max_len) == want


def test_bucket_rejects_oversized_launch():
    with pytest.raises(ValueError):
        dfs_cuda.bucket(dfs_cuda.MAX_BATCH + 1, 100)


def test_pack_unpack_round_trip():
    """pack_reads pads with code 4 / length 0; a packed result row built
    by hand comes back field for field through unpack_result."""
    class R:
        def __init__(self, seq):
            self.seq = np.asarray(seq, dtype=np.uint8)
            self.rseq = (3 - self.seq)[::-1].copy()
            self.len = len(seq)

    reads = [R([0, 1, 2, 3, 0]), R([3, 3, 1])]
    seqs, lengths, md = dfs_cuda.pack_reads(reads, np.array([2, 3]), 64, 32)
    assert seqs.shape == (64, 2, 32) and seqs.dtype == np.uint8
    assert list(lengths[:3]) == [5, 3, 0] and not lengths[2:].any()
    assert list(md[:3]) == [2, 3, 0]
    np.testing.assert_array_equal(seqs[0, 0, :5], reads[0].seq)
    np.testing.assert_array_equal(seqs[1, 1, :3], reads[1].rseq)
    assert (seqs[0, :, 5:] == 4).all() and (seqs[2:] == 4).all()

    H = 4
    row = np.zeros((2, 4 * H + 5), dtype=np.int32)
    row[0, 0] = 1 | (0 << 8) | (2 << 16) | (1 << 24)
    row[0, H] = np.uint32(0xFFFFFFF0).view(np.int32)
    row[0, 2 * H] = 7
    row[0, 3 * H] = 11
    row[0, 4 * H:] = [1, 5, 0, 9, 9]
    row[1, 4 * H:] = [0, 0, 1, 0, 12]
    u = unpack_result(row, H)
    assert u["hit_meta"][0, 0] & 0xFF == 1 and u["hit_meta"][0, 0] >> 24 == 1
    assert u["hit_k"][0, 0].view(np.uint32) == 0xFFFFFFF0
    assert list(u["n_aln"]) == [1, 0] and list(u["hw"]) == [5, 0]
    assert list(u["overflow"]) == [False, True]
    assert list(u["fin"]) == [9, 0] and u["iters"] == 12


def test_params_layout_and_scratch_size():
    """The parameter vector follows dfsgap::Param, and the Python scratch
    size is the C one."""
    opt = GapOpt(seed_len=0x7FFFFFFF)
    p = dfs_cuda.params(np.int32(-2), 5, np.int32(-16),
                        np.array([0, 1, 2, 3, 4], dtype=np.uint32), opt,
                        stack_cap=256, hits_cap=32, max_iters=768)
    assert len(p) == dfs_cuda.P_COUNT == 23
    assert p[dfs_cuda.P_PRIMARY_FWD] == 0xFFFFFFFE
    assert p[dfs_cuda.P_SEQ_LEN] == 0xFFFFFFF0
    assert p[dfs_cuda.P_L2 + 4] == 4
    assert p[dfs_cuda.P_S_MM] == opt.s_mm
    assert p[dfs_cuda.P_SEED_LEN] == 0x7FFFFFF
    assert (p[dfs_cuda.P_STACK_CAP], p[dfs_cuda.P_HITS_CAP],
            p[dfs_cuda.P_MAX_ITERS]) == (256, 32, 768)
    from nabwa_tpu.index.native import _load
    lib = _load()
    for S, L in ((256, 128), (1024, 256), (32, 32)):
        assert lib.dfs_scratch_words(S, L) == dfs_cuda.scratch_words(S, L)


# ---- the kernel itself (GPU only) ----

def kernel_matches_references(idx, reads, opt, stack_cap=256, hits_cap=32,
                              max_iters=768):
    """Run the CUDA kernel on one launch over `reads` and compare its
    packed result with the host twin's and the jnp engine's.  Returns
    (n_reads, n_flagged).  Needs a GPU backend."""
    eng = AlnEngine(idx, opt, dfs_engine="cuda")
    caps = dict(stack_cap=stack_cap, hits_cap=hits_cap, max_iters=max_iters)
    seqs, lengths, md, params, local = batch_inputs(eng, reads, opt, **caps)
    got = np.asarray(dfs_cuda.dfs_call(
        eng.bwt_fwd, eng.bwt_rev, jnp.asarray(seqs), jnp.asarray(lengths),
        jnp.asarray(md), params=params))
    twin = dfs_cuda.run_host(idx.fwd.bwt.view(np.int32),
                             idx.rev.bwt.view(np.int32), seqs, lengths, md,
                             params)
    np.testing.assert_array_equal(got, twin)
    want = jnp_reference(eng, seqs, lengths, md, local, **caps)
    n_ovf = assert_same_packed(want, got, hits_cap, len(reads))
    return len(reads), n_ovf


@pytest.fixture
def gpu_backend():
    if jax.default_backend() != "gpu":
        pytest.skip("the CUDA kernel runs only on an NVIDIA GPU "
                    "(run by chip_smoke.py on the card)")


@pytest.mark.gpu
def test_cuda_kernel_matches_host_twin_and_jnp(tmp_path, gpu_backend):
    c = CASES["gapped_threads"]
    idx, reads = _index_and_reads(tmp_path, c)
    n, n_ovf = kernel_matches_references(idx, reads, c.opt)
    assert n_ovf < n
