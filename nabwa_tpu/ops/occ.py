"""Batched FM-index rank (Occ) lookups on device.

Batched re-design of the reference's occ primitives (bwt.c:83-216): one
query gathers a single 12-word (48 B) interleaved block — 4 checkpoint
counters + 8 BWT words covering 128 bases (layout bwt.h:61-68) — then counts
base occurrences in all 8 words with bit tricks + population count as
vector ops, using per-word validity masks instead of the reference's scalar word
loop.  Only 3 popcounts per word are needed: c1/c2/c3 derive from pc(lo),
pc(hi), pc(lo&hi) and c0 from the arithmetic valid count.

Semantics match bwt_occ / bwt_occ4 exactly, including the `$`-row adjustment
(k >= primary → k-1, bwt.c:99,167) and the k == (bwtint_t)(-1) → 0 edge
(bwt.c:98,163).

All position arithmetic runs on **int32 bit patterns with explicit unsigned
semantics** (ops.u32): int32 add/sub/mask ops are bit-identical to the
C's uint32 wraparound, and compares and right shifts use the explicit
unsigned forms.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .u32 import I32, NEG1, uge, ugt, ule, ushr

_M55 = np.int32(0x55555555)

# kept for callers that still pass uint32 host data
U32 = jnp.uint32
_FULL = np.uint32(0xFFFFFFFF)


def gather_blocks(bwt, kk, word_offset=None):
    """Gather the 12-word interleaved block for each (adjusted) position.

    bwt: int32 [n_words]; kk: int32 [...] (non-negative as unsigned);
    word_offset: optional int32 bank offset.  Returns int32 [..., 12].
    """
    base = ushr(kk, 7) * I32(12)
    if word_offset is not None:
        base = base + word_offset
    idx = base[..., None] + jnp.arange(12, dtype=I32)
    return bwt[idx]


def occ4(bwt, primary, seq_len, k, word_offset=None):
    """Counts of each base in BWT[0..k] for a batch of rows.

    k: int32 [...] (uint32 bit patterns); primary scalar or per-lane vector;
    returns int32 [..., 4].  Mirrors bwt_occ4 (bwt.c:159-176) with the -1
    edge from bwt_2occ4's delegation.
    """
    k = k.astype(I32)
    is_neg1 = k == NEG1
    kk = jnp.where(uge(k, primary), k - I32(1), k)
    kk = jnp.where(is_neg1, I32(0), kk)

    blk = gather_blocks(bwt, kk, word_offset)  # [..., 12]

    word_off = ushr(kk, 4) & I32(7)
    within = kk & I32(15)
    shift = (I32(15) - within) * I32(2)
    partial = (I32(-1) << shift)   # == ~((1<<s)-1)

    c1 = jnp.zeros_like(kk)
    c2 = jnp.zeros_like(kk)
    c3 = jnp.zeros_like(kk)
    for j in range(8):
        w = blk[..., 4 + j]
        vmask = jnp.where(I32(j) < word_off, I32(-1),
                          jnp.where(I32(j) == word_off, partial, I32(0)))
        lo = w & vmask & _M55
        hi = ushr(w, 1) & vmask & _M55
        c1 = c1 + jax.lax.population_count(lo)
        c2 = c2 + jax.lax.population_count(hi)
        c3 = c3 + jax.lax.population_count(lo & hi)
    n_valid = word_off * I32(16) + within + I32(1)
    c1 = c1 - c3
    c2 = c2 - c3
    c0 = n_valid - c1 - c2 - c3
    out = jnp.stack([blk[..., 0] + c0, blk[..., 1] + c1,
                     blk[..., 2] + c2, blk[..., 3] + c3], axis=-1)
    return jnp.where(is_neg1[..., None], I32(0), out)


def select_base(cnt4, c):
    """cnt4[..., c] per lane without a gather (4-way select chain)."""
    out = jnp.zeros_like(cnt4[..., 0])
    for j in range(4):
        out = jnp.where(c == j, cnt4[..., j], out)
    return out


def occ(bwt, l2, primary, seq_len, k, c, word_offset=None):
    """Single-base occ (bwt_occ, bwt.c:92-115).  c: int32 [...] in 0..3."""
    return select_base(occ4(bwt, primary, seq_len, k, word_offset), c)


def two_occ4(bwt, primary, seq_len, k, l):
    """bwt_2occ4 semantics (bwt.c:179-216): occ4 at k and l (k<=l).  The C
    shares the checkpoint block when possible — an optimization only."""
    return occ4(bwt, primary, seq_len, k), occ4(bwt, primary, seq_len, l)


def match_exact(bwt, l2, primary, seq_len, queries, lengths):
    """Batched bwt_match_exact (bwt.c:218-235).

    queries: int32 [B, L] base codes (>3 = N), processed right-to-left;
    lengths: int32 [B].  Returns (n_occ, k, l) as int32 uint32-bit-patterns;
    n_occ=0 means no match.  Fixed L-iteration masked scan.
    """
    B, L = queries.shape
    k0 = jnp.zeros(B, dtype=I32)
    l0 = jnp.full(B, seq_len, dtype=I32)
    ok_mask = jnp.ones(B, dtype=bool)

    def body(carry, i):
        k, l, ok_m = carry
        pos = lengths - 1 - i          # right-to-left
        active = (pos >= 0) & ok_m
        c = queries[jnp.arange(B), jnp.maximum(pos, 0)]
        is_n = c > 3
        cc = jnp.minimum(c, 3)
        occ_k = occ(bwt, l2, primary, seq_len, k - I32(1), cc)
        occ_l = occ(bwt, l2, primary, seq_len, l, cc)
        nk = l2[cc] + occ_k + I32(1)
        nl = l2[cc] + occ_l
        fail = is_n | ugt(nk, nl)
        nk = jnp.where(active & ~fail, nk, k)
        nl = jnp.where(active & ~fail, nl, l)
        ok_m = ok_m & ~(active & fail)
        return (nk, nl, ok_m), None

    (k, l, ok_m), _ = jax.lax.scan(body, (k0, l0, ok_mask),
                                   jnp.arange(L, dtype=I32))
    n = jnp.where(ok_m, l - k + I32(1), I32(0))
    return n, k, l


def cal_width(bwt, l2, primary, seq_len, queries, lengths):
    """Batched bwt_cal_width (bwtaln.c:52-76): D(i) lower-bound intervals.

    queries processed left-to-right on the *opposite-strand* BWT.  Returns
    (width int32 [B, L+1] as uint32 bits, bid int32 [B, L+1]); the terminal
    sentinel (w=0, bid=final+1) lands at position len.
    """
    B, L = queries.shape
    k0 = jnp.zeros(B, dtype=I32)
    l0 = jnp.full(B, seq_len, dtype=I32)
    bid0 = jnp.zeros(B, dtype=I32)

    def body(carry, i):
        k, l, bid = carry
        c = queries[:, i]
        active = i < lengths
        is_n = c > 3
        cc = jnp.minimum(c, 3)
        occ_k = occ(bwt, l2, primary, seq_len, k - I32(1), cc)
        occ_l = occ(bwt, l2, primary, seq_len, l, cc)
        nk = jnp.where(is_n, k, l2[cc] + occ_k + I32(1))
        nl = jnp.where(is_n, l, l2[cc] + occ_l)
        restart = ugt(nk, nl) | is_n
        nk = jnp.where(restart, I32(0), nk)
        nl = jnp.where(restart, seq_len, nl)
        nbid = bid + restart.astype(I32)
        nk = jnp.where(active, nk, k)
        nl = jnp.where(active, nl, l)
        nbid = jnp.where(active, nbid, bid)
        w_i = nl - nk + I32(1)
        return (nk, nl, nbid), (w_i, nbid)

    (_, _, bid_fin), (w_t, bid_t) = jax.lax.scan(
        body, (k0, l0, bid0), jnp.arange(L, dtype=I32))
    width = jnp.zeros((B, L + 1), dtype=I32)
    bid = jnp.zeros((B, L + 1), dtype=I32)
    width = width.at[:, :L].set(w_t.T)
    bid = bid.at[:, :L].set(bid_t.T)
    # terminal sentinel at position len: w=0, bid=final_bid+1 (bwtaln.c:73-74)
    width = width.at[jnp.arange(B), lengths].set(I32(0))
    bid = bid.at[jnp.arange(B), lengths].set(bid_fin + 1)
    return width, bid
