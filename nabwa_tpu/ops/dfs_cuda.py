"""The DFS as a CUDA kernel, called through JAX's foreign function
interface (native/dfs_cuda.cu, search code shared with the host engine in
native/dfsgap_core.h).

The search is a data-dependent pointer chase: every step reads two
48-byte occ blocks at positions the previous step computed, and reads
diverge (own stack, own hit list, own step count).  One GPU thread runs
one read's whole search with per-thread control flow and its own stack in
a scratch slab, so nothing waits for the slowest read of a lockstep batch.
The result is the jnp engine's packed [B, 4H+5] int32 layout
(ops/dfs.unpack_result); reads that outgrow the slab, the hit store or
the iteration cap are flagged and drained on the host.

The library is built from the committed sources with nvcc at first use,
into native/build/.  A build or load failure raises: the GPU path never
drops silently to another engine.
"""

import ctypes
import functools
import pathlib
import shutil
import subprocess
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "dfs_cuda.cu"
_DEPS = [_SRC, _ROOT / "native" / "dfsgap_core.h"]
_SO = _ROOT / "native" / "build" / "libnabwa_cuda.so"
TARGET = "nabwa_dfs"

# reads per kernel launch: one thread each, about one full wave of the
# card's resident threads; larger chunks are split into launches
MAX_BATCH = 65536
# score bins of the slab stack (dfsgap_core.h kMaxBins)
MAX_BINS = 256
# per-read stack slab of both tiers (24 B an entry, 98 KB a read): at
# 64 Mbp, 100 bp reads at 1 % error, 15 % of reads outgrew a 1024-entry
# stack (H100 80GB HBM3, 400 W, chip_smoke.py phase 7); at 8 Mbp the
# deepest of 2048 reads needed 1244 entries (host twin)
STACK_CAP = 4096

# dfsgap::Param layout
(P_PRIMARY_FWD, P_PRIMARY_REV, P_SEQ_LEN, P_L2) = range(4)
(P_S_MM, P_S_GAPO, P_S_GAPE, P_MAX_GAPE, P_MAX_GAPO, P_INDEL_END_SKIP,
 P_MAX_DEL_OCC, P_MAX_ENTRIES, P_MAX_TOP2, P_MAX_SEED_DIFF, P_SEED_LEN,
 P_MODE, P_STACK_CAP, P_HITS_CAP, P_MAX_ITERS, P_COUNT) = range(8, 24)

_lock = threading.Lock()
_loaded = False
# seconds the last nvcc build took in this process (0.0: library was current)
build_seconds = 0.0


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA DFS kernel cannot be built")


def _build():
    global build_seconds
    newest = max(p.stat().st_mtime for p in _DEPS)
    if _SO.exists() and _SO.stat().st_mtime >= newest:
        return
    t0 = time.time()
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(".so.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-I", str(_SRC.parent),
           "-o", str(tmp), str(_SRC)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run nvcc: {e}") from e
    if r.returncode != 0:
        raise RuntimeError("nvcc failed building the CUDA DFS kernel:\n"
                           + r.stderr[-4000:])
    tmp.replace(_SO)
    build_seconds = time.time() - t0


def load():
    """Build the kernel library if stale and register its FFI target.
    Raises on any failure."""
    global _loaded
    with _lock:
        if _loaded:
            return
        _build()
        lib = ctypes.CDLL(str(_SO))
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.NabwaDfs),
                                    platform="CUDA")
        _loaded = True


def bucket(n_reads, max_len):
    """Launch shape for n_reads reads of up to max_len bases: B a power of
    two (>= 64, <= MAX_BATCH) so recurring shares reuse one compile, L a
    multiple of 32."""
    if n_reads > MAX_BATCH:
        raise ValueError(f"{n_reads} reads exceed one launch ({MAX_BATCH})")
    B = max(64, 1 << max(n_reads - 1, 0).bit_length())
    L = max(32, -(-max_len // 32) * 32)
    return B, L


def pack_reads(reads, maxdiff, B, L):
    """Kernel inputs for `reads` (a columnar ReadBatch or objects with
    .seq/.rseq/.len): seqs uint8 [B, 2, L] padded with code 4, lengths
    and maxdiff int32 [B]; padding lanes have length 0 and finish without
    searching."""
    from ..index.native import pack_read_codes
    seqs, lengths = pack_read_codes(reads, B, L)
    md = np.zeros(B, dtype=np.int32)
    md[:len(reads)] = maxdiff
    return seqs, lengths, md


def params(primary_fwd, primary_rev, seq_len, l2, opt, *, stack_cap,
           hits_cap, max_iters):
    """The kernel's int64 parameter vector (dfsgap::Param layout) for the
    batch-clamped GapOpt `opt`; index values may be int32 bit patterns."""
    p = [0] * P_COUNT
    p[P_PRIMARY_FWD] = int(primary_fwd) & 0xFFFFFFFF
    p[P_PRIMARY_REV] = int(primary_rev) & 0xFFFFFFFF
    p[P_SEQ_LEN] = int(seq_len) & 0xFFFFFFFF
    for c in range(5):
        p[P_L2 + c] = int(l2[c]) & 0xFFFFFFFF
    seed_len = opt.seed_len if opt.seed_len < 0x7FFFFFFF else 0x7FFFFFF
    for idx, v in ((P_S_MM, opt.s_mm), (P_S_GAPO, opt.s_gapo),
                   (P_S_GAPE, opt.s_gape), (P_MAX_GAPE, opt.max_gape),
                   (P_MAX_GAPO, opt.max_gapo),
                   (P_INDEL_END_SKIP, opt.indel_end_skip),
                   (P_MAX_DEL_OCC, opt.max_del_occ),
                   (P_MAX_ENTRIES, opt.max_entries),
                   (P_MAX_TOP2, opt.max_top2),
                   (P_MAX_SEED_DIFF, opt.max_seed_diff),
                   (P_SEED_LEN, seed_len), (P_MODE, opt.mode),
                   (P_STACK_CAP, stack_cap), (P_HITS_CAP, hits_cap),
                   (P_MAX_ITERS, max_iters)):
        p[idx] = int(v)
    return tuple(p)


def scratch_words(stack_cap, L):
    """int32 words of per-read scratch (dfsgap::scratch_words)."""
    return stack_cap * 6 + MAX_BINS + 8 * (L + 1)


@functools.partial(jax.jit, static_argnames=("params",))
def dfs_call(bwt_fwd, bwt_rev, seqs, lengths, maxdiff, *, params):
    """Run the kernel on one launch: bwt_* int32 device arrays, seqs uint8
    [B, 2, L], lengths/maxdiff int32 [B]; returns packed int32 [B, 4H+5]."""
    B, _, L = seqs.shape
    H = params[P_HITS_CAP]
    out, _ = jax.ffi.ffi_call(TARGET, (
        jax.ShapeDtypeStruct((B, 4 * H + 5), jnp.int32),
        jax.ShapeDtypeStruct((B, scratch_words(params[P_STACK_CAP], L)),
                             jnp.int32)))(
        bwt_fwd, bwt_rev, seqs, lengths, maxdiff,
        params=np.asarray(params, dtype=np.int64))
    return out


def run_host(bwt_fwd, bwt_rev, seqs, lengths, maxdiff, params, n_threads=0):
    """The kernel's contract on the host (native/dfsgap.cpp
    dfs_fixed_batch, same code as the kernel): same inputs as dfs_call,
    numpy result.  Keeps the kernel's arithmetic testable without a card."""
    from ..index.native import _load
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    B, _, L = seqs.shape
    H = params[P_HITS_CAP]
    S = params[P_STACK_CAP]
    assert lib.dfs_scratch_words(S, L) == scratch_words(S, L)
    out = np.zeros((B, 4 * H + 5), dtype=np.int32)
    scratch = np.zeros((B, scratch_words(S, L)), dtype=np.int32)
    lib.dfs_fixed_batch(
        np.ascontiguousarray(bwt_fwd).view(np.uint32),
        np.ascontiguousarray(bwt_rev).view(np.uint32),
        np.ascontiguousarray(seqs, dtype=np.uint8), B, L,
        np.ascontiguousarray(lengths, dtype=np.int32),
        np.ascontiguousarray(maxdiff, dtype=np.int32),
        np.asarray(params, dtype=np.int64), scratch.reshape(B, -1), out,
        n_threads)
    return out
