"""ops.u32 unsigned-on-int32 semantics vs numpy uint32 ground truth.

The jnp engines run all position arithmetic as uint32 bit patterns on
int32 lanes (the reference's bwtint_t range, bwt.h:41, cap 4 Gbp at
bwtindex.c:103-105); these tests pin the helper semantics and the occ
block geometry across the 2^31 boundary.
"""

import numpy as np
import jax.numpy as jnp

from nabwa_tpu.ops.u32 import ult, ule, ugt, uge, umin, umax, ushr


def _pairs(rng, n=4096):
    """uint32 pairs concentrated around the interesting boundaries."""
    edges = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001,
                      0xB2D05E00,          # ~3 Gbp
                      0xFFFFFFF0, 0xFFFFFFFE, 0xFFFFFFFF],
                     dtype=np.uint32)
    a = np.concatenate([rng.integers(0, 2**32, n).astype(np.uint32),
                        np.repeat(edges, len(edges)),
                        np.tile(edges, len(edges))])
    b = np.concatenate([rng.integers(0, 2**32, n).astype(np.uint32),
                        np.tile(edges, len(edges)),
                        np.repeat(edges, len(edges))])
    return a, b


def test_u32_compares_match_numpy_uint32():
    rng = np.random.default_rng(7)
    a_u, b_u = _pairs(rng)
    a = jnp.asarray(a_u.view(np.int32))
    b = jnp.asarray(b_u.view(np.int32))
    assert np.array_equal(np.asarray(ult(a, b)), a_u < b_u)
    assert np.array_equal(np.asarray(ule(a, b)), a_u <= b_u)
    assert np.array_equal(np.asarray(ugt(a, b)), a_u > b_u)
    assert np.array_equal(np.asarray(uge(a, b)), a_u >= b_u)
    assert np.array_equal(np.asarray(umin(a, b)).view(np.uint32),
                          np.minimum(a_u, b_u))
    assert np.array_equal(np.asarray(umax(a, b)).view(np.uint32),
                          np.maximum(a_u, b_u))


def test_u32_shr_matches_numpy_uint32():
    rng = np.random.default_rng(8)
    a_u, _ = _pairs(rng)
    a = jnp.asarray(a_u.view(np.int32))
    for k in (1, 4, 7, 16, 31):
        assert np.array_equal(np.asarray(ushr(a, k)).view(np.uint32),
                              a_u >> np.uint32(k)), k


def test_occ_prep_geometry_past_2gbp():
    """Occ block geometry in u32-on-int32 arithmetic (block, word, base
    within word, as ops.occ computes them) vs plain uint64 arithmetic for
    positions spanning 0 .. 4 Gbp-16."""
    rng = np.random.default_rng(9)
    k_u = np.concatenate([
        rng.integers(0, 2**32 - 16, 8192).astype(np.uint32),
        np.arange(2**31 - 4, 2**31 + 4, dtype=np.uint32),
        np.array([0, 1, 0xFFFFFFEF], dtype=np.uint32)])
    primary_u = np.uint32(3_000_000_011)
    k = jnp.asarray(k_u.view(np.int32))
    primary = jnp.asarray(np.uint32(primary_u).view(np.int32))

    is_neg1 = k == -1
    kk = jnp.where(uge(k, primary), k - 1, k)
    kk = jnp.where(is_neg1, 0, kk)
    blk = ushr(kk, 7)
    row, sub = blk >> 3, blk & 7
    woff, win = ushr(kk, 4) & 7, kk & 15

    kk64 = np.where(k_u >= primary_u, k_u.astype(np.uint64) - 1,
                    k_u.astype(np.uint64))
    assert np.array_equal(np.asarray(row).view(np.uint32),
                          (kk64 >> 7 >> 3).astype(np.uint32))
    assert np.array_equal(np.asarray(sub), (kk64 >> 7) & 7)
    assert np.array_equal(np.asarray(woff), (kk64 >> 4) & 7)
    assert np.array_equal(np.asarray(win), kk64 & 15)
