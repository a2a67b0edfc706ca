"""Where work runs, and how JAX is set up for it.

One routing decision serves the whole program: `on_gpu()`.  Every path
that can run on the device (the DFS, SA walks, banded DP, the hybrid
split) asks it, and `use_device()` adds the operator's NABWA_FORCE_NATIVE
switch, which pins all work to the host engines (the plain reference the
device paths are checked against).  On any other backend the host engines
run; the jnp engines still run there under the CPU tests.
"""

import os
import pathlib
import threading

import jax

_ROOT = pathlib.Path(__file__).resolve().parents[1]

# per-process tallies of work routed to the device, by path; read by
# chip_smoke.py to show which paths ran on the card
COUNTS = {"dfs_reads": 0, "dfs_retry_reads": 0, "sa_rows": 0,
          "dp_jobs": 0}
_counts_lock = threading.Lock()


def count(path, n):
    """Add n units of device work to COUNTS[path] (thread-safe: bam2bam
    workers route concurrently)."""
    with _counts_lock:
        COUNTS[path] += n


def on_gpu():
    """True when JAX's default backend is an NVIDIA GPU."""
    return jax.default_backend() == "gpu"


def force_native():
    """True when NABWA_FORCE_NATIVE pins all work to the host engines."""
    return bool(os.environ.get("NABWA_FORCE_NATIVE"))


def use_device():
    """True when the device paths run: a GPU backend, not forced native."""
    return on_gpu() and not force_native()


def setup_compile_cache():
    """Point JAX's persistent compile cache at one place and return it.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache is <checkout>/.jax_cache
    (listed in .gitignore): a fixed path, so reruns from one checkout hit.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
