"""The one routing decision (nabwa_tpu.device) at each call site, with the
backend monkeypatched to "cpu" and "gpu".

On the GPU every device path runs on the device (DFS, SA walks, DP
batches of 64 jobs or more, the hybrid split), NABWA_FORCE_NATIVE pins
all of it to the host engines, and a GPU backend whose CUDA kernel cannot
be built raises instead of running another engine.  The compile-cache
helper is tested here too.
"""

import os

import numpy as np
import jax
import pytest

from nabwa_tpu import device
from nabwa_tpu.index.build import build_index
from nabwa_tpu.index.fmindex import BwaIndex
from nabwa_tpu.index.native import bwt_sa_batch
from nabwa_tpu.io import fastq
from nabwa_tpu.models.aln import AlnEngine
from nabwa_tpu.ops import dfs_cuda
from nabwa_tpu.ops.dp import _use_native_dp
from nabwa_tpu.options import GapOpt

from . import genomes


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("routing")
    fa, seqs = genomes.random_genome(30000, seed=601)
    fq = genomes.sample_reads(seqs[0], 300, 50, seed=602, err_rate=0.02)
    (tmp / "g.fa").write_bytes(fa)
    (tmp / "r.fq").write_bytes(fq)
    build_index(str(tmp / "g.fa"))
    idx = BwaIndex.load(str(tmp / "g.fa"))
    reads = list(fastq.read_fastq_batch(fastq.iter_fastq(str(tmp / "r.fq")),
                                        1 << 20))
    return idx, reads


@pytest.fixture
def backend(monkeypatch, request):
    """Pretend the default backend is request.param ("cpu" or "gpu")."""
    monkeypatch.setattr(device, "on_gpu", lambda: request.param == "gpu")
    monkeypatch.delenv("NABWA_FORCE_NATIVE", raising=False)
    return request.param


@pytest.fixture
def no_kernel(monkeypatch, tmp_path):
    """A CUDA kernel library that is absent and cannot be built."""
    monkeypatch.setattr(dfs_cuda, "_loaded", False)
    monkeypatch.setattr(dfs_cuda, "_SO", tmp_path / "libnabwa_cuda.so")
    monkeypatch.setattr(dfs_cuda, "_nvcc", lambda: str(tmp_path / "nvcc"))


@pytest.mark.parametrize("name,want", [("cpu", False), ("gpu", True),
                                       ("metal", False)])
def test_on_gpu_reads_the_backend(monkeypatch, name, want):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert device.on_gpu() is want


@pytest.mark.parametrize("backend,force,want", [
    ("gpu", False, True), ("gpu", True, False), ("cpu", False, False),
], indirect=["backend"])
def test_use_device(monkeypatch, backend, force, want):
    if force:
        monkeypatch.setenv("NABWA_FORCE_NATIVE", "1")
    assert device.use_device() is want


@pytest.mark.parametrize("backend,force,n_jobs,native", [
    ("cpu", False, 4096, True),
    ("gpu", False, 63, True),
    ("gpu", False, 64, False),
    ("gpu", True, 4096, True),
], indirect=["backend"])
def test_dp_routing(monkeypatch, backend, force, n_jobs, native):
    if force:
        monkeypatch.setenv("NABWA_FORCE_NATIVE", "1")
    before = device.COUNTS["dp_jobs"]
    assert _use_native_dp(n_jobs) is native
    assert device.COUNTS["dp_jobs"] - before == (0 if native else n_jobs)


@pytest.mark.parametrize("backend", ["cpu", "gpu"], indirect=True)
def test_sa_rows_routing(small, backend):
    """SA walks run on the device on the GPU (here: the jnp walk on the
    CPU backend) and on the native host walk otherwise; same answers."""
    idx, _ = small
    eng = AlnEngine(idx, GapOpt(), dfs_engine="jnp")
    rows = np.arange(1, 30000, 97, dtype=np.uint32)
    before = device.COUNTS["sa_rows"]
    got = eng.sa_rows(1, rows)
    want = bwt_sa_batch(idx.fwd.bwt, idx.fwd.primary, idx.fwd.l2,
                        idx.fwd.seq_len, idx.fwd.sa, idx.fwd.sa_intv, rows)
    np.testing.assert_array_equal(got, want)
    ran_on_device = device.COUNTS["sa_rows"] - before == len(rows)
    assert ran_on_device == (backend == "gpu")


@pytest.mark.parametrize("backend,mesh,want", [
    ("cpu", False, "jnp"), ("gpu", True, "jnp"),
], indirect=["backend"])
def test_auto_engine_without_cuda(small, backend, mesh, want):
    idx, _ = small
    m = None
    if mesh:
        from nabwa_tpu.parallel.mesh import make_mesh
        m = make_mesh(2)
    assert AlnEngine(idx, GapOpt(), mesh=m).dfs_engine == want


@pytest.mark.parametrize("backend", ["gpu"], indirect=True)
@pytest.mark.parametrize("per_read", [False, True])
def test_gpu_without_kernel_raises(small, backend, no_kernel, per_read):
    """GPU backend, no built kernel: the hybrid split (300 reads) and the
    per-read path both raise; neither falls back to jnp or native."""
    idx, reads = small
    eng = AlnEngine(idx, GapOpt())
    with pytest.raises(RuntimeError, match="nvcc"):
        eng.run_chunk(reads, per_read_semantics=per_read)


@pytest.mark.parametrize("backend", ["gpu"], indirect=True)
def test_gpu_force_native_needs_no_kernel(monkeypatch, small, backend,
                                          no_kernel):
    """NABWA_FORCE_NATIVE on the GPU: the whole chunk runs on the host
    engine, and the (unbuildable) kernel is never touched."""
    idx, reads = small
    monkeypatch.setenv("NABWA_FORCE_NATIVE", "1")
    eng = AlnEngine(idx, GapOpt())
    res = eng.run_chunk(reads)
    assert eng.last_split == {"tier0": 0, "retry": 0, "host": len(reads)}
    assert sum(1 for alns, _ in res if alns) > 0.9 * len(reads)


@pytest.mark.parametrize("backend", ["cpu"], indirect=True)
def test_cpu_per_read_path_is_native(small, backend):
    idx, reads = small
    eng = AlnEngine(idx, GapOpt())
    res = eng.run_chunk(reads[:40], per_read_semantics=True)
    assert "_dev" not in eng.__dict__ or eng.__dict__["_dev"] is None
    want = AlnEngine(idx, GapOpt()).run_chunk(reads[:40])
    assert [a for a, _ in res] == [a for a, _ in want]


def test_compile_cache_from_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.setup_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.setup_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
