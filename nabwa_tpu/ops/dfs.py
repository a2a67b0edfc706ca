"""Batched bounded-DFS gapped search — bwt_match_gap (bwtgap.c:104-266)
as one lockstep jnp program under XLA.  It is the mesh path's engine and
the plain version the CUDA kernel (ops/dfs_cuda.py) is timed against.

The reference runs a divergent best-first search per read with a score-binned
LIFO priority stack.  Here a whole batch of reads runs in lockstep: one outer
iteration pops (or advances the zero-budget exact-match fast path of) exactly
one entry per live read, entirely as masked vector ops.

Priority-stack design (round 2): the reference's pop order is "lowest
nonempty score bin, LIFO within the bin" (gap_stack_t, bwtgap.c:13-79).
That order is exactly "minimum score, then maximum push sequence number", so
each per-read stack is a flat [S]-slot pool where every occupied slot
carries (score, seq); pop is a pair of masked reductions over the slot axis
plus a one-hot extract, and push writes up to 9 candidates through disjoint
one-hot masks into the lowest free slots.  Nothing in the loop body indexes
an array with a per-lane data-dependent address: every per-read access is
a reduction, cumsum or one-hot select over the slot axis, so each
iteration is a fixed set of full-width vector ops.

Other structure notes:
- both strands search within one stack (two seeds pushed, bwtgap.c:127-128);
  strand selects the fwd/rev BWT bank in one concatenated device array;
- the zero-budget bwt_match_exact_alt call (bwtgap.c:162) becomes a per-read
  "pending exact" lane state advancing one base per outer iteration;
- gap_shadow's width rewrite (bwtgap.c:81-91) is a masked prefix-sum update
  on per-strand [B, L+1] planes;
- all stop rules are per-lane `done` conditions.

SA positions are int32 bit patterns with unsigned semantics (ops.u32).

Reads that overflow the device stack or hit caps are flagged and re-run on
the scalar host model (refmodel.dfs_scalar) — same semantics, no limits.
"""

import functools

import jax
import jax.numpy as jnp

from .u32 import I32, ult, ule, ugt, uge, ushr
from .occ import occ4, select_base
from ..constants import (STATE_M, STATE_I, STATE_D, BWA_MODE_GAPE,
                         BWA_MODE_LOGGAP, BWA_MODE_NONSTOP)

_STATICS = ("s_mm", "s_gapo", "s_gape", "max_gape", "max_gapo",
            "indel_end_skip", "max_del_occ", "max_entries", "max_top2",
            "max_seed_diff", "seed_len", "mode", "stack_cap", "hits_cap",
            "max_iters", "rev_word_offset")


def _int_log2(v):
    """int_log2 (bwtgap.c:93-102) for small non-negative int32 vectors."""
    bits = (v[..., None] >= (1 << jnp.arange(1, 16, dtype=I32))).astype(I32)
    return bits.sum(axis=-1)


def _row_gather(row, pos, width):
    """row[b, pos[b]] without a per-lane gather: one-hot select + sum.
    Out-of-range pos returns 0 (callers mask those lanes)."""
    m = pos[:, None] == jnp.arange(width, dtype=I32)
    return jnp.where(m, row, 0).sum(axis=1)


def _sel4(vals, c):
    """vals[c] per lane for a length-(>=4) vector `vals`, c in 0..3."""
    out = jnp.broadcast_to(vals[0], c.shape)
    for j in range(1, 4):
        out = jnp.where(c == j, vals[j], out)
    return out


@functools.partial(jax.jit, static_argnames=_STATICS)
def aln_device_step(bwt_cat, bwt_fwd, bwt_rev, rev_word_offset, primary_fwd,
                    primary_rev, l2, seq_len, seqs, lengths, seed_seqs,
                    seed_lengths, has_seed, max_diff, **statics):
    """One fused device step: cal_width (both strands + seed suffixes) then
    the DFS — everything under a single jit so no eager dispatch or
    throwaway scan compiles happen per batch (bwa_cal_sa_reg_gap's per-read
    width+search loop, bwtaln.c:111-138, as one compiled program)."""
    from .occ import cal_width

    w0, b0 = cal_width(bwt_fwd, l2, primary_fwd, seq_len,
                       seqs[:, 0, :], lengths)
    w1, b1 = cal_width(bwt_rev, l2, primary_rev, seq_len,
                       seqs[:, 1, :], lengths)
    widths = jnp.stack([w0, w1], axis=1)
    bids = jnp.stack([b0, b1], axis=1)
    sw0, sb0 = cal_width(bwt_fwd, l2, primary_fwd, seq_len,
                         seed_seqs[:, 0, :], seed_lengths)
    sw1, sb1 = cal_width(bwt_rev, l2, primary_rev, seq_len,
                         seed_seqs[:, 1, :], seed_lengths)
    seed_widths = jnp.stack([sw0, sw1], axis=1)
    seed_bids = jnp.stack([sb0, sb1], axis=1)
    return dfs_match_gap(bwt_cat, rev_word_offset, primary_fwd, primary_rev,
                         l2, seq_len, seqs, lengths, widths, bids,
                         seed_widths, seed_bids, has_seed, max_diff,
                         **statics)


@functools.partial(jax.jit, static_argnames=_STATICS)
def dfs_match_gap(bwt_cat, rev_word_offset, primary_fwd, primary_rev, l2,
                  seq_len, seqs, lengths, widths, bids, seed_widths,
                  seed_bids, has_seed, max_diff, *, s_mm, s_gapo, s_gape,
                  max_gape, max_gapo, indel_end_skip, max_del_occ,
                  max_entries, max_top2, max_seed_diff, seed_len, mode,
                  stack_cap=2048, hits_cap=64, max_iters=200000):
    """Run the DFS for a batch.

    bwt_cat: int32 [Wf+Wr], forward then reverse interleaved BWT.
    seqs: int32 [B, 2, L] (seq / rseq codes, reversed-read orientation).
    lengths: int32 [B]; widths/bids: int32 [B, 2, L+1]; seed_*: [B, 2, SL+1].
    max_diff: int32 [B] per-read budget; max_gapo is the batch-clamped
    scalar (bwtaln.c:105).  primary_*/seq_len are int32 uint32-bit-patterns.

    Returns dict with hit arrays [B, H] (k/l as uint32 bit patterns),
    n_aln, hw (max_entries high-water), and overflow flags.
    """
    B, _, L = seqs.shape
    S = stack_cap
    H = hits_cap
    LP1 = L + 1
    gape_mode = bool(mode & BWA_MODE_GAPE)
    nonstop = bool(mode & BWA_MODE_NONSTOP)
    loggap = bool(mode & BWA_MODE_LOGGAP)
    BIG = I32(0x7FFFFFF)
    seq_len_i = I32(seq_len) if isinstance(seq_len, int) else \
        seq_len.astype(I32)
    s_iota = jnp.arange(S, dtype=I32)

    def aln_score(m, o, e):
        return m * s_mm + o * s_gapo + e * s_gape

    # --- initial state ---
    # slot pool: s_key = (score << 16) | (0xFFFF - seq) for occupied slots,
    # INT32_MAX for free ones.  seq is the per-read push counter, so
    # min(s_key) == the C's binned-LIFO pop order (lowest score bin, LIFO
    # within bin) in ONE reduction, free slots excluded automatically.
    FREE = I32(0x7FFFFFFF)
    st = dict(
        s_key=jnp.full((B, S), FREE, dtype=I32),
        s_info=jnp.zeros((B, S), dtype=I32),   # ldp<<17 | a<<16 | i
        s_cnt=jnp.zeros((B, S), dtype=I32),    # n_mm|go<<8|ge<<16|state<<24
        s_k=jnp.zeros((B, S), dtype=I32),
        s_l=jnp.zeros((B, S), dtype=I32),
        seq_ctr=jnp.zeros(B, dtype=I32),
        n_entries=jnp.zeros(B, dtype=I32),
        best_score=aln_score(max_diff + 1, max_gapo + 1, max_gape + 1),
        best_diff=max_diff + 1,
        best_cnt=jnp.zeros(B, dtype=I32),
        max_diff=max_diff.astype(I32),
        n_aln=jnp.zeros(B, dtype=I32),
        done=jnp.zeros(B, dtype=bool),
        overflow=jnp.zeros(B, dtype=bool),
        hw=jnp.zeros(B, dtype=I32),
        pend=jnp.zeros(B, dtype=bool),
        pend_i=jnp.zeros(B, dtype=I32),
        pend_k=jnp.zeros(B, dtype=I32),
        pend_l=jnp.zeros(B, dtype=I32),
        pend_cnt=jnp.zeros(B, dtype=I32),   # n_mm|gapo<<8|gape<<16
        pend_a=jnp.zeros(B, dtype=I32),
        pend_ldp=jnp.zeros(B, dtype=I32),
        fin=jnp.zeros(B, dtype=I32),   # iteration at which the lane finished
        # per-strand D(i) planes, mutated by gap_shadow
        w0=widths[:, 0, :].astype(I32),
        w1=widths[:, 1, :].astype(I32),
        bid0=bids[:, 0, :].astype(I32),
        bid1=bids[:, 1, :].astype(I32),
        hit_meta=jnp.zeros((B, H), dtype=I32),
        hit_k=jnp.zeros((B, H), dtype=I32),
        hit_l=jnp.zeros((B, H), dtype=I32),
        hit_score=jnp.zeros((B, H), dtype=I32),
        iters=jnp.zeros((), dtype=I32),
    )

    # too many Ns in seq[0] → no search at all (bwtgap.c:118-123)
    n_count = ((seqs[:, 0, :] > 3)
               & (jnp.arange(L) < lengths[:, None])).sum(axis=1)
    st["done"] = n_count > max_diff

    # push the two strand seeds (bwtgap.c:127-128): slots 0 (a=0, seq 0)
    # and 1 (a=1, seq 1); both score 0, a=1 pops first like the C (its key
    # 0xFFFE is the smaller).
    empty_read = lengths <= 0
    st["done"] = st["done"] | empty_read
    seedable = ~st["done"]
    seed_key = jnp.where(seedable[:, None],
                         jnp.array([0xFFFF, 0xFFFE], dtype=I32)[None, :],
                         FREE)
    st["s_key"] = st["s_key"].at[:, 0:2].set(seed_key)
    st["s_info"] = st["s_info"].at[:, 0].set(jnp.where(seedable, lengths, 0))
    st["s_info"] = st["s_info"].at[:, 1].set(
        jnp.where(seedable, I32(1 << 16) | lengths, 0))
    st["s_l"] = st["s_l"].at[:, 0:2].set(
        jnp.where(seedable, seq_len_i, 0)[:, None])
    st["seq_ctr"] = jnp.where(seedable, 2, 0)
    st["n_entries"] = jnp.where(seedable, 2, 0)

    seq_fwd = seqs[:, 0, :]
    seq_rev = seqs[:, 1, :]
    SL1 = seed_widths.shape[2]
    sw0_p, sw1_p = seed_widths[:, 0, :], seed_widths[:, 1, :]
    sb0_p, sb1_p = seed_bids[:, 0, :], seed_bids[:, 1, :]

    def occ4_lane(k_vec, a_vec):
        """occ4 against bwts[1-a] per lane (bwtgap.c:149): a=0 → reverse
        bank, a=1 → forward bank."""
        offs = jnp.where(a_vec == 0, rev_word_offset, 0).astype(I32)
        prim = jnp.where(a_vec == 0, primary_rev, primary_fwd).astype(I32)
        return occ4(bwt_cat, prim, seq_len_i, k_vec, word_offset=offs)

    def get_seq(a_vec, pos):
        row = jnp.where((a_vec == 0)[:, None], seq_fwd, seq_rev)
        return _row_gather(row, pos, L)

    def body(st):
        st = dict(st)
        active = ~st["done"]
        in_pend = st["pend"] & active
        do_stack = active & ~st["pend"]

        # ---- stack checks (bwtgap.c:139-141) ----
        st["hw"] = jnp.where(do_stack,
                             jnp.maximum(st["hw"], st["n_entries"]), st["hw"])
        empty = st["n_entries"] == 0
        over_cap = st["n_entries"] > max_entries
        st["done"] = st["done"] | (do_stack & (empty | over_cap))
        do_pop = do_stack & ~empty & ~over_cap

        # ---- pop: min key == min score then max seq (gap_pop,
        # bwtgap.c:66-79); the key is unique per live entry, so pop_m has
        # exactly one bit per popping lane ----
        min_key = st["s_key"].min(axis=1)
        pop_m = st["s_key"] == min_key[:, None]
        e_score = ushr(min_key, 16)    # garbage (0x7FFF) on empty lanes,
        #                                masked by do_pop below

        def extract(a):
            return jnp.where(pop_m, a, 0).sum(axis=1)

        e_info = extract(st["s_info"])
        e_cnt = extract(st["s_cnt"])
        e_k = extract(st["s_k"])
        e_l = extract(st["s_l"])
        # commit removal for popping lanes
        st["s_key"] = jnp.where(pop_m & do_pop[:, None], FREE, st["s_key"])
        st["n_entries"] = st["n_entries"] - do_pop.astype(I32)

        e_a = ushr(e_info, 16) & I32(1)
        e_ldp = ushr(e_info, 17)
        e_i = e_info & I32(0xFFFF)
        e_nmm = e_cnt & I32(0xFF)
        e_go = ushr(e_cnt, 8) & I32(0xFF)
        e_ge = ushr(e_cnt, 16) & I32(0xFF)
        e_state = ushr(e_cnt, 24) & I32(3)

        # strand-selected D(i) planes for this iteration's pops/hits
        a0 = (e_a == 0)[:, None]
        w_row = jnp.where(a0, st["w0"], st["w1"])
        bid_row = jnp.where(a0, st["bid0"], st["bid1"])

        # ---- best-score stop (bwtgap.c:144) ----
        if not nonstop:
            brk = do_pop & (e_score > st["best_score"] + s_mm)
            st["done"] = st["done"] | brk
            do_pop = do_pop & ~brk

        # ---- budget (bwtgap.c:146-148) ----
        m = st["max_diff"] - (e_nmm + e_go)
        if gape_mode:
            m = m - e_ge
        proc = do_pop & (m >= 0)

        # ---- width lower bound (bwtgap.c:156) ----
        bid_im1 = _row_gather(bid_row, e_i - 1, LP1)
        proc = proc & ~((e_i > 0) & (m < bid_im1))

        # ---- hit / exact-path / expand split (bwtgap.c:158-164) ----
        direct_hit = proc & (e_i == 0)
        exact_ok = (e_state == STATE_M) | (e_ge == max_gape) if not gape_mode \
            else jnp.ones(B, dtype=bool)
        need_exact = proc & ~direct_hit & (m == 0) & exact_ok
        expand = proc & ~direct_hit & ~need_exact

        # enter pending-exact state
        st["pend"] = st["pend"] | need_exact
        for nm, val in (("pend_i", e_i), ("pend_k", e_k), ("pend_l", e_l),
                        ("pend_a", e_a), ("pend_ldp", e_ldp),
                        ("pend_cnt", e_cnt)):
            st[nm] = jnp.where(need_exact, val, st[nm])

        # ---- shared occ lookups: a lane is either pending or popping,
        # never both, so ONE (k-1, l) occ4 pair serves the pending
        # exact-match step AND the expansion (the bwt_2occ4 analog —
        # halves the hottest memory op, cf. bwt.c:179-216) ----
        occ_a = jnp.where(in_pend, st["pend_a"], e_a)
        occ_k_in = jnp.where(in_pend, st["pend_k"], e_k) - I32(1)
        occ_l_in = jnp.where(in_pend, st["pend_l"], e_l)
        cnt_k4 = occ4_lane(occ_k_in, occ_a)
        cnt_l4 = occ4_lane(occ_l_in, occ_a)

        # ---- pending exact-match step (bwt_match_exact_alt, one base) ----
        pc = get_seq(st["pend_a"], st["pend_i"] - 1)
        cc = jnp.minimum(pc, 3)
        okk = select_base(cnt_k4, cc)
        oll = select_base(cnt_l4, cc)
        l2c = _sel4(l2, cc)
        nk = l2c + okk + I32(1)
        nl = l2c + oll
        pfail = in_pend & ((pc > 3) | ugt(nk, nl))
        pstep = in_pend & ~pfail
        st["pend_k"] = jnp.where(pstep, nk, st["pend_k"])
        st["pend_l"] = jnp.where(pstep, nl, st["pend_l"])
        st["pend_i"] = jnp.where(pstep, st["pend_i"] - 1, st["pend_i"])
        pend_hit = pstep & (st["pend_i"] == 0)
        st["pend"] = st["pend"] & ~(pend_hit | pfail)

        # ---- hit processing (bwtgap.c:166-199) ----
        hit_now = direct_hit | pend_hit
        h_cnt = jnp.where(direct_hit, e_cnt, st["pend_cnt"])
        h_nmm = h_cnt & I32(0xFF)
        h_go = ushr(h_cnt, 8) & I32(0xFF)
        h_ge = ushr(h_cnt, 16) & I32(0xFF)
        h_a = jnp.where(direct_hit, e_a, st["pend_a"])
        h_ldp = jnp.where(direct_hit, e_ldp, st["pend_ldp"])
        h_k = jnp.where(direct_hit, e_k, st["pend_k"])
        h_l = jnp.where(direct_hit, e_l, st["pend_l"])
        h_score = aln_score(h_nmm, h_go, h_ge)

        first_hit = hit_now & (st["n_aln"] == 0)
        new_best_diff = h_nmm + h_go + (h_ge if gape_mode else 0)
        st["best_score"] = jnp.where(first_hit, h_score, st["best_score"])
        st["best_diff"] = jnp.where(first_hit, new_best_diff,
                                    st["best_diff"])
        if not nonstop:
            st["max_diff"] = jnp.where(
                first_hit, jnp.minimum(new_best_diff + 1, st["max_diff"]),
                st["max_diff"])
        eq_best = h_score == st["best_score"]
        width_cnt = h_l - h_k + I32(1)
        brk2 = hit_now & ~eq_best & (st["best_cnt"] > max_top2)
        st["best_cnt"] = st["best_cnt"] + jnp.where(hit_now & eq_best,
                                                    width_cnt, 0)
        st["done"] = st["done"] | brk2
        add_lane = hit_now & ~brk2
        # tandem-repeat dedup (bwtgap.c:179-183)
        in_hits = ((st["hit_k"] == h_k[:, None])
                   & (st["hit_l"] == h_l[:, None])
                   & (jnp.arange(H) < st["n_aln"][:, None])).any(axis=1)
        do_add = add_lane & ~((h_go > 0) & in_hits)

        # gap_shadow (bwtgap.c:81-91) on the h_a-strand planes
        ha0 = (h_a == 0)[:, None]
        wa = jnp.where(ha0, st["w0"], st["w1"])
        bida = jnp.where(ha0, st["bid0"], st["bid1"])
        x = h_l - h_k + I32(1)
        shadow_mask = do_add[:, None] & (jnp.arange(LP1) < h_ldp[:, None])
        eq = shadow_mask & (wa == x[:, None])
        gt = shadow_mask & ugt(wa, x[:, None])
        jc = jnp.cumsum(eq.astype(I32), axis=1)
        wa_new = jnp.where(gt, wa - x[:, None],
                           jnp.where(eq, seq_len_i - jc, wa))
        bida_new = jnp.where(eq, I32(1), bida)
        upd0 = do_add[:, None] & ha0
        upd1 = do_add[:, None] & ~ha0
        st["w0"] = jnp.where(upd0, wa_new, st["w0"])
        st["w1"] = jnp.where(upd1, wa_new, st["w1"])
        st["bid0"] = jnp.where(upd0, bida_new, st["bid0"])
        st["bid1"] = jnp.where(upd1, bida_new, st["bid1"])

        # append hit via one-hot write at n_aln
        hof = do_add & (st["n_aln"] >= H)
        st["overflow"] = st["overflow"] | hof
        write_hit = do_add & ~hof
        hmask = write_hit[:, None] & (jnp.arange(H) == st["n_aln"][:, None])
        meta = (h_cnt & I32(0xFFFFFF)) | (h_a << 24)
        for nm, val in (("hit_meta", meta), ("hit_k", h_k), ("hit_l", h_l),
                        ("hit_score", h_score)):
            st[nm] = jnp.where(hmask, val[:, None], st[nm])
        st["n_aln"] = st["n_aln"] + write_hit.astype(I32)

        # ---- expansion (bwtgap.c:201-259); cnt_k4/cnt_l4 carry e_k/e_l
        # occs for every non-pending lane (see shared lookup above) ----
        i2 = e_i - 1
        occ_width = e_l - e_k + I32(1)

        bid_i2m1 = _row_gather(bid_row, i2 - 1, LP1)
        bid_i2 = _row_gather(bid_row, i2, LP1)
        w_i2m1 = _row_gather(w_row, i2 - 1, LP1)
        w_i2 = _row_gather(w_row, i2, LP1)
        allow_diff = jnp.where(i2 > 0, ~(bid_i2m1 > m - 1),
                               jnp.ones(B, dtype=bool))
        allow_m = jnp.where(
            i2 > 0,
            ~((bid_i2m1 == m - 1) & (bid_i2 == m - 1) & (w_i2m1 == w_i2)),
            jnp.ones(B, dtype=bool))
        # seed bounds (bwtgap.c:210-214)
        ii = jnp.where(has_seed, i2 - (lengths - seed_len), I32(-1))
        sbid_row = jnp.where(a0, sb0_p, sb1_p)
        sw_row = jnp.where(a0, sw0_p, sw1_p)
        m_seed = max_seed_diff - (e_nmm + e_go) - (e_ge if gape_mode else 0)
        sbid_iim1 = _row_gather(sbid_row, ii - 1, SL1)
        sbid_ii = _row_gather(sbid_row, ii, SL1)
        sw_iim1 = _row_gather(sw_row, ii - 1, SL1)
        sw_ii = _row_gather(sw_row, ii, SL1)
        seed_gate = (i2 > 0) & (ii > 0)
        allow_diff = allow_diff & ~(seed_gate & (sbid_iim1 > m_seed - 1))
        allow_m = allow_m & ~(seed_gate & (sbid_iim1 == m_seed - 1)
                              & (sbid_ii == m_seed - 1)
                              & (sw_iim1 == sw_ii))

        # indel gating (bwtgap.c:217-218)
        vsum = e_go + e_ge
        if loggap:
            tmp = _int_log2(vsum) // 2 + 1
        else:
            tmp = vsum
        ind_ok = (allow_diff & (i2 >= indel_end_skip + tmp)
                  & (lengths - i2 >= indel_end_skip + tmp))

        # candidate pushes, exact C order: ins, del c=0..3, mm j=1..4
        is_m = e_state == STATE_M
        is_i = e_state == STATE_I
        is_d = e_state == STATE_D
        can_open = is_m & (e_go < max_gapo)
        can_ext_i = is_i & (e_ge < max_gape)
        can_ext_d = (is_d & (e_ge < max_gape)
                     & ((e_go + e_ge < st["max_diff"])
                        | ult(occ_width, I32(max_del_occ))))

        sc = get_seq(e_a, i2)

        cand_valid = []
        cand_i = []
        cand_k = []
        cand_l = []
        cand_nmm = []
        cand_go = []
        cand_ge = []
        cand_state = []
        cand_diff = []
        # slot 0: insertion open (state M) or extension (state I)
        cand_valid.append(expand & ind_ok & (can_open | can_ext_i))
        cand_i.append(i2)
        cand_k.append(e_k)
        cand_l.append(e_l)
        cand_nmm.append(e_nmm)
        cand_go.append(e_go + is_m.astype(I32))
        cand_ge.append(e_ge + is_i.astype(I32))
        cand_state.append(jnp.full(B, STATE_I, dtype=I32))
        cand_diff.append(jnp.ones(B, dtype=bool))
        # slots 1-4: deletion (open from M / extend from D) for bases 0..3
        for j in range(4):
            dk = l2[j] + cnt_k4[:, j] + I32(1)
            dl = l2[j] + cnt_l4[:, j]
            cand_valid.append(expand & ind_ok & (can_open | can_ext_d)
                              & ule(dk, dl))
            cand_i.append(i2 + 1)
            cand_k.append(dk)
            cand_l.append(dl)
            cand_nmm.append(e_nmm)
            cand_go.append(e_go + is_m.astype(I32))
            cand_ge.append(e_ge + is_d.astype(I32))
            cand_state.append(jnp.full(B, STATE_D, dtype=I32))
            cand_diff.append(jnp.ones(B, dtype=bool))
        # slots 5-8: mismatch/match c=(sc+j)&3 for j=1..4
        mm_all = allow_diff & allow_m
        exact_only = ~mm_all & (sc < 4)
        for j in range(1, 5):
            c = (sc + j) & 3
            is_mm = (jnp.full(B, j != 4, dtype=bool)) | (sc > 3)
            l2c_j = _sel4(l2, c)
            mk = l2c_j + select_base(cnt_k4, c) + I32(1)
            ml = l2c_j + select_base(cnt_l4, c)
            ok_int = ule(mk, ml)
            v = expand & ok_int & (mm_all | (exact_only & (j == 4)))
            cand_valid.append(v)
            cand_i.append(i2)
            cand_k.append(mk)
            cand_l.append(ml)
            cand_nmm.append(e_nmm + is_mm.astype(I32))
            cand_go.append(e_go)
            cand_ge.append(e_ge)
            cand_state.append(jnp.full(B, STATE_M, dtype=I32))
            cand_diff.append(is_mm)

        valid = jnp.stack(cand_valid, axis=1)              # [B, 9]
        ci = jnp.stack([jnp.broadcast_to(x, (B,)) for x in cand_i], axis=1)
        ck = jnp.stack(cand_k, axis=1)
        cl = jnp.stack(cand_l, axis=1)
        cnmm = jnp.stack(cand_nmm, axis=1)
        cgo = jnp.stack(cand_go, axis=1)
        cge = jnp.stack(cand_ge, axis=1)
        cstate = jnp.stack(cand_state, axis=1)
        cdiff = jnp.stack(cand_diff, axis=1)

        # Push-time pruning (an optimization the C lacks; provably inert):
        # max_diff and best_score only tighten over the search, so a
        # candidate that ALREADY busts the pop-time budget check
        # (bwtgap.c:146-148, continue) or the best-score break
        # (bwtgap.c:144) can never contribute anything when popped — the
        # pop would discard it (or end a lane that ends anyway once the
        # minimum remaining score passes the bound).  Dropping it at push
        # keeps the hit set, hit order and all width/shadow state
        # bit-identical while shrinking both stack pressure and wasted pop
        # iterations.  (Only the max_entries high-water can differ, which
        # surfaces solely through the YQ debug tag.)
        cdiffsum = cnmm + cgo + (cge if gape_mode else 0)
        keep = cdiffsum <= st["max_diff"][:, None]
        csc = aln_score(cnmm, cgo, cge)
        if not nonstop:
            keep = keep & (csc <= (st["best_score"] + s_mm)[:, None])
        valid = valid & keep

        n_push = valid.sum(axis=1).astype(I32)
        free_n = S - st["n_entries"]
        # slot-pool exhaustion, and the (rare) 16-bit seq-counter ceiling —
        # both flag the read for the retry tier / scalar fallback
        sovf = expand & ((n_push > free_n)
                         | (st["seq_ctr"] + n_push > I32(0xFFFF)))
        st["overflow"] = st["overflow"] | sovf
        st["done"] = st["done"] | sovf
        valid = valid & ~sovf[:, None]

        cldp = jnp.where(cdiff, ci, 0)
        cinfo = (cldp << 17) | (e_a[:, None] << 16) | ci
        ccnt = cnmm | (cgo << 8) | (cge << 16) | (cstate << 24)
        prefix = jnp.cumsum(valid.astype(I32), axis=1) - valid.astype(I32)
        ckey = (csc << 16) | (I32(0xFFFF) - st["seq_ctr"][:, None] - prefix)

        # one-hot scatter of up to 9 candidates into the lowest free slots
        free = st["s_key"] == FREE                           # [B, S]
        frank = jnp.cumsum(free.astype(I32), axis=1)         # 1-based
        for j in range(9):
            mask_j = (valid[:, j][:, None] & free
                      & (frank == (prefix[:, j] + 1)[:, None]))
            st["s_key"] = jnp.where(mask_j, ckey[:, j][:, None],
                                    st["s_key"])
            st["s_info"] = jnp.where(mask_j, cinfo[:, j][:, None],
                                     st["s_info"])
            st["s_cnt"] = jnp.where(mask_j, ccnt[:, j][:, None],
                                    st["s_cnt"])
            st["s_k"] = jnp.where(mask_j, ck[:, j][:, None], st["s_k"])
            st["s_l"] = jnp.where(mask_j, cl[:, j][:, None], st["s_l"])

        n_pushed = valid.sum(axis=1).astype(I32)
        st["n_entries"] = st["n_entries"] + n_pushed
        st["seq_ctr"] = st["seq_ctr"] + n_pushed

        st["iters"] = st["iters"] + 1
        st["fin"] = jnp.where(active & st["done"], st["iters"], st["fin"])
        # iteration cap: flag leftover reads for host fallback
        cap_hit = st["iters"] >= max_iters
        st["overflow"] = st["overflow"] | jnp.where(cap_hit, ~st["done"],
                                                    False)
        st["done"] = st["done"] | cap_hit
        return st

    def cond(st):
        return jnp.any(~st["done"])

    final = jax.lax.while_loop(cond, body, st)
    # Single packed result array: the 8 logical outputs ship as ONE
    # [B, 4H+5] int32 device-to-host transfer (unpacked by unpack_result;
    # the CUDA kernel writes the same layout).
    packed = jnp.concatenate([
        final["hit_meta"], final["hit_k"], final["hit_l"],
        final["hit_score"],
        final["n_aln"][:, None], final["hw"][:, None],
        final["overflow"].astype(I32)[:, None], final["fin"][:, None],
        jnp.broadcast_to(final["iters"], (B,))[:, None],
    ], axis=1)
    return packed


def unpack_result(packed, hits_cap):
    """Split the packed dfs_match_gap result into the logical outputs."""
    H = hits_cap
    return {
        "hit_meta": packed[:, 0:H],
        "hit_k": packed[:, H:2 * H],
        "hit_l": packed[:, 2 * H:3 * H],
        "hit_score": packed[:, 3 * H:4 * H],
        "n_aln": packed[:, 4 * H],
        "hw": packed[:, 4 * H + 1],
        "overflow": packed[:, 4 * H + 2] != 0,
        # iterations run: the lockstep engine writes its global count in
        # every row, the CUDA kernel each read's own
        "iters": packed[:, 4 * H + 4].max() if packed.shape[0] else 0,
        "fin": packed[:, 4 * H + 3],
    }
