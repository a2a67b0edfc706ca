"""ctypes bindings for the native (C++) components.

Builds native/*.cpp on first use (g++ -O3 -shared) into
native/build/libnabwa_native.so; each entry point degrades gracefully
(NumPy suffix array, Python scalar DFS) when no compiler is available.
The GPU kernel's CUDA sources are built separately (ops/dfs_cuda.py).
"""

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRCS = [_ROOT / "native" / "sais.cpp",
         _ROOT / "native" / "bwtwalk.cpp",
         _ROOT / "native" / "dfsgap.cpp",
         _ROOT / "native" / "stdaln.cpp",
         _ROOT / "native" / "bsw2core.cpp",
         _ROOT / "native" / "bsw2aln.cpp",
         _ROOT / "native" / "post.cpp",
         _ROOT / "native" / "bwtgen.cpp",
         _ROOT / "native" / "fastq.cpp"]
# headers the sources include: a change rebuilds the library
_DEPS = _SRCS + [_ROOT / "native" / "dfsgap_core.h"]
_BUILD = _ROOT / "native" / "build"
_SO = _BUILD / "libnabwa_native.so"

_lib = None
_checked = False
_load_lock = threading.Lock()

_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _load():
    global _lib, _checked
    if _checked:
        return _lib
    with _load_lock:
        return _load_locked()


def _load_locked():
    # _checked is published only AFTER _lib is assigned: the old
    # check-then-act version let a scheduler worker observe
    # _checked=True mid-build and conclude "no native library", silently
    # routing whole bam2bam pass-1 chunks onto the CPU-jit device path
    # (observed: 6 s runs intermittently becoming 50 s)
    global _lib, _checked
    if _checked:
        return _lib
    try:
        newest_src = max(s.stat().st_mtime for s in _DEPS)
        if not _SO.exists() or _SO.stat().st_mtime < newest_src:
            _BUILD.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-funroll-loops",
                 "-std=c++17", "-shared", "-fPIC",
                 "-pthread"] + [str(s) for s in _SRCS]
                + ["-o", str(_SO)],
                check=True, capture_output=True)
        lib = ctypes.CDLL(str(_SO))
        lib.sais_u8.argtypes = [_u8, _i64, ctypes.c_int64]
        lib.sais_u8.restype = ctypes.c_int
        lib.sais_u8_big.argtypes = [_u8, _i64, ctypes.c_int64]
        lib.sais_u8_big.restype = ctypes.c_int
        lib.bwt_cal_sa_u32.argtypes = [
            _u32, ctypes.c_uint32, _u32, ctypes.c_uint32, ctypes.c_int,
            _u32]
        lib.bwt_cal_sa_u32.restype = ctypes.c_int
        lib.dfs_match_gap_batch.argtypes = [
            _u32, ctypes.c_uint32, _u32, ctypes.c_uint32, _u32,
            ctypes.c_uint32,
            _u8, ctypes.c_int, _i32, _i32, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            _i32, _i32, _i32]
        lib.dfs_match_gap_batch.restype = ctypes.c_int
        lib.dfs_fixed_batch.argtypes = [
            _u32, _u32, _u8, ctypes.c_int, ctypes.c_int, _i32, _i32, _i64,
            _i32, _i32, ctypes.c_int]
        lib.dfs_fixed_batch.restype = ctypes.c_int
        lib.dfs_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dfs_scratch_words.restype = ctypes.c_int64
        lib.bwt_sa_batch_u32.argtypes = [
            _u32, ctypes.c_uint32, _u32, ctypes.c_uint32, _u32,
            ctypes.c_int, _u32, ctypes.c_int64, _u32]
        lib.bwt_sa_batch_u32.restype = ctypes.c_int
        lib.aln_global_u8.argtypes = [
            _u8, ctypes.c_int, _u8, ctypes.c_int, _i32, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int,
            _u8, ctypes.c_int64, _i64]
        lib.aln_global_u8.restype = ctypes.c_int32
        lib.aln_extend_u8.argtypes = [
            _u8, ctypes.c_int, _u8, ctypes.c_int, _i32, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int, ctypes.c_int32,
            ctypes.c_int, _i32, _u8, ctypes.c_int64, _i64]
        lib.aln_extend_u8.restype = ctypes.c_int32
        lib.two_occ4_u32.argtypes = [
            _u32, ctypes.c_uint32, _u32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, _u32]
        lib.two_occ4_u32.restype = ctypes.c_int
        lib.local_fwd_u8.argtypes = [
            _u8, ctypes.c_int, _u8, ctypes.c_int, _i32, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int32, _i32]
        lib.local_fwd_u8.restype = ctypes.c_int32
        lib.local_rev_u8.argtypes = [
            _u8, ctypes.c_int, _u8, ctypes.c_int, _i32, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int, ctypes.c_int, _i32]
        lib.local_rev_u8.restype = ctypes.c_int32
        lib.bsw2_core_u32.argtypes = [
            _i64, _i64, _i32, ctypes.c_int, ctypes.c_int,
            _u32, ctypes.c_uint32, _u32, ctypes.c_uint32,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i64, _i64, ctypes.c_int64, _i64]
        lib.bsw2_core_u32.restype = ctypes.c_int
        _u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.bsw2_aln_batch.argtypes = [
            _u32, ctypes.c_uint32, _u32, ctypes.c_uint32, _u32,
            ctypes.c_int32,
            _u32, ctypes.c_uint32, _u32, ctypes.c_uint32, _u32,
            ctypes.c_int32,
            _u8, ctypes.c_int64,
            _u8, _i64, ctypes.c_int64,
            _i32, ctypes.c_float, ctypes.c_double,
            _u64, ctypes.c_int32,
            _i64, _i64, ctypes.c_int64,
            _i32, ctypes.c_int64, _i64]
        lib.bsw2_aln_batch.restype = ctypes.c_int64
        lib.se_select_batch.argtypes = [
            ctypes.c_int64, _u32, _i32, _i64, _u64, ctypes.c_int,
            ctypes.c_int, _u64, _i32, _i32, _i32, _i32]
        lib.se_select_batch.restype = ctypes.c_int
        lib.se_multi_batch.argtypes = [
            ctypes.c_int64, _u32, _i32, _i64, _i32, ctypes.c_int64,
            _u64, _i32, _i32, _i32, _i32]
        lib.se_multi_batch.restype = ctypes.c_int
        _f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.pe_pairing_batch.argtypes = [
            ctypes.c_int64, _u64, _i64, _u32, _i64, _i64,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            _i64, _i64, _f64, _f64]
        lib.pe_pairing_batch.restype = ctypes.c_int64
        lib.bam_update_batch.argtypes = [
            ctypes.c_int64, _i64, _i64,
            _i64, _i64, _i64, _i64,
            _u8, _i64,
            _i32, _i64,
            _u8, _i64,
            _u64, _i32, _i32, _i32, _i32, ctypes.c_int64,
            _i32, ctypes.c_int,
            ctypes.c_int, _i64, _i64, _u8, _i64,
            ctypes.c_int64, _i64, _i32,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            _i64, _u8, ctypes.c_int64, _i64]
        lib.bam_update_batch.restype = ctypes.c_int64
        lib.md_batch.argtypes = [
            ctypes.c_int64, _i64, _u8, _i64, _i32, _i64, _u8,
            ctypes.c_int64, ctypes.c_int64, _i64, _i32, _u8,
            _u8, ctypes.c_int64, _i64, ctypes.c_int]
        lib.md_batch.restype = ctypes.c_int
        lib.sam_emit_batch.argtypes = [
            ctypes.c_int64, _i64, _i64,
            _u8, _i64, _u8, _i64,
            _i32, _i64, _u8, _i64,
            _u8, _i64, _u8, _i64,
            _u64, _i32, _i32, _i32, _i32, ctypes.c_int64,
            ctypes.c_int, _i64, _i64, _u8, _i64,
            ctypes.c_int64, _i64, _i32, _u8, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, _u8, ctypes.c_int64,
            _u8, ctypes.c_int64, ctypes.c_int]
        lib.sam_emit_batch.restype = ctypes.c_int64
        lib.bwt_inc_u8.argtypes = [
            _u8, ctypes.c_int64, ctypes.c_int64, _u8, _u64]
        lib.bwt_inc_u8.restype = ctypes.c_int
        lib.fastq_parse.argtypes = [
            _u8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, _u8, _i64, _u8, _i64, _u8, _i32]
        lib.fastq_parse.restype = ctypes.c_int64
        lib.sai_scan.argtypes = [
            _u8, ctypes.c_int64, ctypes.c_int64, _i32, _u8,
            ctypes.c_int64]
        lib.sai_scan.restype = ctypes.c_int64
        lib.gather_rows_u8.argtypes = [
            _u8, _i64, _i64, _u8, ctypes.c_int64, _u8, _i64,
            ctypes.c_int]
        lib.gather_rows_u8.restype = None
        _lib = lib
    except Exception:
        # never silent: a broken native build otherwise just skips every
        # native-marked test and downgrades the engines to Python paths
        # (observed: a missing <cstdio> turned bwasw 350 -> 0.7 reads/s
        # with no diagnostic)
        import sys as _sys
        import traceback as _tb
        print("[nabwa.native] native library unavailable:",
              file=_sys.stderr)
        exc = _tb.format_exc(limit=2)
        err = getattr(_sys.exc_info()[1], "stderr", None)
        print(err.decode()[:2000] if err else exc, file=_sys.stderr)
        _lib = None
    _checked = True
    return _lib


def have_native():
    return _load() is not None


def suffix_array_native(codes):
    """SA-IS suffix array via the native library; None if unavailable.

    Uses the in-place Gbp entry point (SA buffer of n+1 entries doubles as
    the construction workspace above 2^31 chars — saves an 8n shadow)."""
    lib = _load()
    if lib is None:
        return None
    t = np.ascontiguousarray(codes, dtype=np.uint8)
    sa = np.empty(len(t) + 1, dtype=np.int64)
    rc = lib.sais_u8_big(t, sa, len(t))
    if rc != 0:
        return None
    return sa[:len(t)]


def bwt_inc_native(codes, block=0):
    """Blockwise incremental BWT (native/bwtgen.cpp): the low-memory
    large-genome builder (bwt_gen capability parity, bwt_gen/bwt_gen.c:
    1247-1556).  Returns (bwt_u8, primary) or None.

    Peak native memory ~0.65 B/char (two packed BWT buffers + occ
    checkpoints + per-block rank/sort arrays) vs SA-IS's 8+ B/char."""
    lib = _load()
    if lib is None:
        return None
    t = np.ascontiguousarray(codes, dtype=np.uint8)
    out = np.empty(len(t), dtype=np.uint8)
    prim = np.zeros(1, dtype=np.uint64)
    rc = lib.bwt_inc_u8(t, len(t), int(block), out, prim)
    if rc != 0:
        return None
    return out, int(prim[0])


def cal_sa_native(bwt_words, primary, l2, seq_len, intv):
    """bwt_cal_sa (bwt.c:48-70) via the native invPsi walk; None if
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    bwt = np.ascontiguousarray(bwt_words, dtype=np.uint32)
    l2a = np.ascontiguousarray(l2, dtype=np.uint32)
    out = np.zeros((int(seq_len) + intv) // intv, dtype=np.uint32)
    rc = lib.bwt_cal_sa_u32(bwt, np.uint32(primary), l2a,
                            np.uint32(seq_len), intv, out)
    if rc != 0:
        return None
    return out


def bwt_sa_batch(bwt_words, primary, l2, seq_len, sa_sample, intv, rows):
    """Batched bwt_sa via the native invPsi walk; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    out = np.empty(len(rows), dtype=np.uint32)
    lib.bwt_sa_batch_u32(
        np.ascontiguousarray(bwt_words, dtype=np.uint32),
        np.uint32(primary), np.ascontiguousarray(l2, dtype=np.uint32),
        np.uint32(seq_len),
        np.ascontiguousarray(sa_sample, dtype=np.uint32), int(intv),
        rows, len(rows), out)
    return out


class OccNative:
    """Reusable native bwt_2occ4 handle for host FM walks (bit-exact with
    ScalarFm.two_occ4/occ4; the scalar stays the independent oracle)."""

    def __init__(self, bwt_words, primary, l2, seq_len):
        lib = _load()
        self._bwt = np.ascontiguousarray(bwt_words, dtype=np.uint32)
        self._l2 = np.ascontiguousarray(l2, dtype=np.uint32)
        self._primary = int(primary)
        self._seq_len = int(seq_len)
        self._out = np.empty(8, dtype=np.uint32)
        # raw CFUNCTYPE call with prebound pointers: the ndpointer
        # argtype validation costs ~30 us per call, dwarfing the kernel
        proto = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_void_p)
        self._fn = proto(ctypes.cast(lib.two_occ4_u32,
                                     ctypes.c_void_p).value)
        self._bwt_p = self._bwt.ctypes.data_as(ctypes.c_void_p)
        self._l2_p = self._l2.ctypes.data_as(ctypes.c_void_p)
        self._out_p = self._out.ctypes.data_as(ctypes.c_void_p)

    def two_occ4(self, k, l):
        self._fn(self._bwt_p, self._primary, self._l2_p, self._seq_len,
                 k & 0xFFFFFFFF, l & 0xFFFFFFFF, self._out_p)
        o = self._out.astype(np.int64)
        return o[:4], o[4:]

    def occ4(self, k):
        return self.two_occ4(k, k)[0]


def aln_global_native(seq1, seq2, mat, row, go, ge, gend, band):
    """Native aln_global_core; returns (score, ctype_bytes) where
    ctype_bytes is the returned path's ctype sequence (last-to-first), or
    None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    s1 = np.ascontiguousarray(seq1, dtype=np.uint8)
    s2 = np.ascontiguousarray(seq2, dtype=np.uint8)
    cap = len(s1) + len(s2) + 2
    path = np.empty(cap, dtype=np.uint8)
    pn = np.zeros(1, dtype=np.int64)
    score = lib.aln_global_u8(s1, len(s1), s2, len(s2),
                              np.ascontiguousarray(mat, dtype=np.int32),
                              int(row), int(go), int(ge), int(gend),
                              int(band), path, cap, pn)
    return int(score), path[:int(pn[0])]


def aln_extend_native(seq1, seq2, mat, row, go, ge, band, g0,
                      want_path=False):
    """Native aln_extend_core; returns (score, end_i, end_j, ctype_bytes
    or None).  None if the library is unavailable; raises on the
    unmodelled overflow-rebase guard (same contract as the scalar)."""
    lib = _load()
    if lib is None:
        return None
    s1 = np.ascontiguousarray(seq1, dtype=np.uint8)
    s2 = np.ascontiguousarray(seq2, dtype=np.uint8)
    cap = len(s1) + len(s2) + 2
    path = np.empty(cap, dtype=np.uint8)
    pn = np.zeros(1, dtype=np.int64)
    out = np.zeros(3, dtype=np.int32)
    rc = lib.aln_extend_u8(s1, len(s1), s2, len(s2),
                           np.ascontiguousarray(mat, dtype=np.int32),
                           int(row), int(go), int(ge), int(band),
                           int(g0), int(bool(want_path)), out, path, cap,
                           pn)
    if rc != 0:
        raise AssertionError("extension overflow rebase not modelled")
    # pn > 0 iff the kernel entered its path branch (pre-global score > 0
    # with want_path) — the FINAL score can legitimately be <= 0 there
    p = path[:int(pn[0])] if (want_path and int(pn[0]) > 0) else None
    return int(out[0]), int(out[1]), int(out[2]), p


def local_fwd_native(seq1, seq2, mat, row, q, r):
    """Native local_fwd; returns (score_f, end_i, end_j) or None."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(3, dtype=np.int32)
    rc = lib.local_fwd_u8(np.ascontiguousarray(seq1, dtype=np.uint8),
                          len(seq1),
                          np.ascontiguousarray(seq2, dtype=np.uint8),
                          len(seq2),
                          np.ascontiguousarray(mat, dtype=np.int32),
                          int(row), int(q), int(r), out)
    if rc != 0:
        raise AssertionError("local SW overflow rebase not modelled")
    return int(out[0]), int(out[1]), int(out[2])


def local_rev_native(seq1, seq2, mat, row, q, r, score_f, end_i, end_j):
    """Native local_rev; returns (score_r, start_i, start_j), None when
    end_i/end_j is 0 (no local match), or False without the library."""
    lib = _load()
    if lib is None:
        return False
    out = np.zeros(3, dtype=np.int32)
    rc = lib.local_rev_u8(np.ascontiguousarray(seq1, dtype=np.uint8),
                          len(seq1),
                          np.ascontiguousarray(seq2, dtype=np.uint8),
                          len(seq2),
                          np.ascontiguousarray(mat, dtype=np.int32),
                          int(row), int(q), int(r), int(score_f),
                          int(end_i), int(end_j), out)
    if rc != 0:
        return None
    return int(out[0]), int(out[1]), int(out[2])


def pack_read_codes(reads, B=None, L=None):
    """Search inputs for `reads` (a columnar ReadBatch, or objects with
    .seq/.rseq/.len): uint8 [B, 2, L] (seq, rseq; padding code 4) and
    int32 lengths [B] (0 on padding rows).  B and L default to the read
    count and the longest read."""
    n = len(reads)
    columnar = hasattr(reads, "code_bytes")
    if columnar:
        lengths = reads.clip_lens().astype(np.int32)
    else:
        lengths = np.fromiter((r.len for r in reads), dtype=np.int32,
                              count=n)
    B = n if B is None else B
    L = int(lengths.max(initial=0)) if L is None else L
    lens = np.zeros(B, dtype=np.int32)
    lens[:n] = lengths
    lib = _load()
    if columnar and lib is not None:
        # one threaded native ragged gather (seq = reversed clip codes,
        # rseq = reversed complement): no per-read objects on the hot path
        seqs = np.full((B, 2, L), 4, dtype=np.uint8)
        starts = np.repeat(
            np.ascontiguousarray(reads.seq_off[reads.lo:reads.hi]), 2)
        lens2 = np.repeat(lengths.astype(np.int64), 2)
        flags = np.tile(np.array(
            [1, 3 if reads.is_comp else 1], dtype=np.uint8), n)
        out_off = np.arange(2 * n, dtype=np.int64) * L
        lib.gather_rows_u8(reads.codes_flat, starts, lens2, flags,
                           2 * n, seqs.reshape(-1), out_off, 0)
    elif n and int(lengths.min()) == int(lengths.max()):
        # uniform lengths (the common chunk): one stack, no slices
        packed = np.stack([np.stack([r.seq for r in reads]),
                           np.stack([r.rseq for r in reads])],
                          axis=1).astype(np.uint8, copy=False)
        if packed.shape == (B, 2, L):
            seqs = np.ascontiguousarray(packed)
        else:
            seqs = np.full((B, 2, L), 4, dtype=np.uint8)
            seqs[:n, :, :packed.shape[2]] = packed
    else:
        seqs = np.full((B, 2, L), 4, dtype=np.uint8)
        for i, r in enumerate(reads):
            seqs[i, 0, :r.len] = r.seq
            seqs[i, 1, :r.len] = r.rseq
    return seqs, lens


def dfs_match_gap_native(fwd_bwt, primary_fwd, rev_bwt, primary_rev, l2,
                         seq_len, reads, maxdiff, local, hits_cap=512,
                         n_threads=0):
    """Run the native threaded DFS over `reads` (objects with .seq, .rseq,
    .len).  maxdiff: per-read int array; local: the batch-clamped GapOpt.
    Returns list of (alns, hw) dicts matching the scalar oracle, or None
    if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(reads)
    if n == 0:
        return []
    seqs, lengths = pack_read_codes(reads)
    L = seqs.shape[2]
    maxdiff = np.ascontiguousarray(maxdiff, dtype=np.int32)
    fwd = np.ascontiguousarray(fwd_bwt, dtype=np.uint32)
    rev = np.ascontiguousarray(rev_bwt, dtype=np.uint32)
    l2a = np.ascontiguousarray(l2, dtype=np.uint32)
    seed_len = local.seed_len if local.seed_len < 0x7FFFFFFF else 0x7FFFFFF

    cap = hits_cap
    pending = np.arange(n)
    results = [None] * n
    while len(pending):
        m = len(pending)
        hits = np.zeros((m, cap, 7), dtype=np.int32)
        n_aln = np.zeros(m, dtype=np.int32)
        hw = np.zeros(m, dtype=np.int32)
        sub_seqs = np.ascontiguousarray(seqs[pending])
        sub_len = np.ascontiguousarray(lengths[pending])
        sub_md = np.ascontiguousarray(maxdiff[pending])
        # callers may hand int32 bit patterns (AlnEngine stores u32
        # positions that way); mask before the uint32 narrowing — numpy
        # raises on out-of-bounds conversions past 2 Gbp
        lib.dfs_match_gap_batch(
            fwd, np.uint32(primary_fwd & 0xFFFFFFFF),
            rev, np.uint32(primary_rev & 0xFFFFFFFF),
            l2a, np.uint32(seq_len & 0xFFFFFFFF),
            sub_seqs, L, sub_len, sub_md, m,
            local.s_mm, local.s_gapo, local.s_gape, local.max_gape,
            local.max_gapo, local.indel_end_skip, local.max_del_occ,
            local.max_entries, local.max_top2, local.max_seed_diff,
            seed_len, local.mode, cap, n_threads,
            hits.reshape(-1), n_aln, hw)
        retry = []
        hits_u = hits.view(np.uint32)
        n_aln_l = n_aln.tolist()
        hw_l = hw.tolist()
        for j, idx in enumerate(pending):
            na = n_aln_l[j]
            if na < 0:
                retry.append(idx)
                continue
            # one tolist per read: plain-int rows beat per-field numpy
            # scalar extraction ~5x at bench scale
            rows = hits[j, :na].tolist()
            urows = hits_u[j, :na].tolist()
            alns = [(h[0], h[1], h[2], h[3], u[4], u[5], h[6])
                    for h, u in zip(rows, urows)]
            results[idx] = (alns, hw_l[j])
        pending = np.array(retry, dtype=np.int64)
        cap *= 4
    return results
