"""Batched banded DP kernels on device — stdaln.c's alignment cores as
batched XLA programs (SURVEY §2.4).

Device part computes the score lattice + packed traceback directions for a
whole BATCH of (ref-window, read) pairs as one jit program; the short
per-record backtrace walk runs on host.  The banded structure of
aln_global_core (stdaln.c:345-525) — five loop parts, separate `gap_end`
penalties on terminal rows/columns, M>=I>I>D tie-breaking — is translated
into per-(row, cell) predicates, validated cell-for-cell against the scalar
oracle (refmodel.stdaln_scalar) by randomized property tests.

Key vectorization: within a row, D[i] = max(M[i-1]-go, D[i-1]) - ext is a
sequential chain; with T[i] = D[i] + ext*i it becomes a running max of
U[i] = (M[i-1]-go) + ext*(i-1), i.e. one cummax along the row — no scalar
loop.  Rows then advance under one lax.scan of int32 vector ops.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..refmodel.stdaln_scalar import FROM_M, FROM_I, FROM_D, MINOR_INF

I32 = jnp.int32
NEG = np.int32(MINOR_INF)


@functools.partial(jax.jit, static_argnames=("go", "ge", "gend"))
def _banded_global_device(s1, len1, s2, len2, b1, b2, mat, *, go, ge, gend):
    """Score + traceback lattice for a batch.

    s1: int32 [B, L1+1] 1-based ref windows (index 0 unused), codes 0..4.
    s2: int32 [B, L2+1] 1-based reads.  len1/len2/b1/b2: int32 [B].
    mat: int32 [5, 5] score matrix.  Returns (score [B], last_type [B],
    tb uint8 [B, L2+1, L1+1]) with tb bits: 0-1 Mt, 2 It, 3 Dt.
    """
    B, L1p = s1.shape
    L2p = s2.shape[1]
    L1 = L1p - 1
    i_idx = jnp.arange(L1p, dtype=I32)           # [L1+1]
    ge_i = I32(ge)
    gend_i = I32(gend if gend >= 0 else ge)      # set_end_* fallback

    # substitution score rows: sub[b, j, i] built per row inside the scan
    # via mat[s2[:, j], s1] — a [B, L1+1] gather from the 5x5 matrix
    mat_flat = mat.reshape(-1)

    tmp_end = jnp.where(b2 < len2, b2, len2 - 1)
    var_row = b2 == len2                 # the part-1 "last row" variant

    # ---- row 0 (stdaln.c:393-399): M[0,0]=0, D over i in [1, b1-1] ----
    in0 = (i_idx[None, :] >= 1) & (i_idx[None, :] <= (b1 - 1)[:, None])
    M0 = jnp.where(i_idx[None, :] == 0, I32(0), NEG) * jnp.ones((B, 1), I32)
    # D[0,i] = max(M[0,i-1]-go, D[0,i-1]) - gend == -go - gend*i  (from M00)
    D0 = jnp.where(in0, -I32(go) - gend_i * i_idx[None, :], NEG)
    I0 = jnp.full((B, L1p), NEG, dtype=I32)

    def row_step(carry, j):
        Mp, Ip, Dp = carry
        j = j.astype(I32)
        active = (j >= 1) & (j <= len2)

        part1 = j <= tmp_end
        last_row = (j == len2) & ~var_row
        is_var = (j == len2) & var_row
        start = jnp.where(part1 | is_var, I32(0), j - b2 + 1)
        end = jnp.minimum(j + b1 - 1, len1)
        in_band = (i_idx[None, :] >= start[:, None]) \
            & (i_idx[None, :] <= end[:, None])

        # substitution scores for this row
        c2 = s2[:, :]  # [B, L2+1]
        c2j = jnp.take_along_axis(c2, jnp.broadcast_to(
            jnp.clip(j, 0, L2p - 1)[None, None], (B, 1)), axis=1)[:, 0]
        sub = mat_flat[c2j[:, None] * 5 + s1]     # [B, L1+1]

        # ---- M (set_M, stdaln.c:260-275): from diag, tie order M>=I, I>D
        pm = jnp.concatenate([jnp.full((B, 1), NEG, I32), Mp[:, :-1]], 1)
        pi = jnp.concatenate([jnp.full((B, 1), NEG, I32), Ip[:, :-1]], 1)
        pd = jnp.concatenate([jnp.full((B, 1), NEG, I32), Dp[:, :-1]], 1)
        m_ge_i = pm >= pi
        m_ge_d = pm >= pd
        i_gt_d = pi > pd
        best = jnp.where(m_ge_i, jnp.where(m_ge_d, pm, pd),
                         jnp.where(i_gt_d, pi, pd))
        Mt = jnp.where(m_ge_i, jnp.where(m_ge_d, FROM_M, FROM_D),
                       jnp.where(i_gt_d, FROM_I, FROM_D)).astype(jnp.uint8)
        m_ok = in_band & (i_idx[None, :] >= 1)
        Mrow = jnp.where(m_ok, best + sub, NEG)

        # ---- I (set_i/set_end_i): from above, same column ----
        # gend at i==0 and at the band's right edge when it passes len1 or
        # on the last row (stdaln.c part1 :402-420/:422-440, part3 :459-471,
        # last row :473-485); plain ge strictly inside
        i_end_gend = ((j + b1 - 1) > len1) | last_row
        i_at_end = i_idx[None, :] == end[:, None]
        i_ok = in_band & (~i_at_end | i_end_gend[:, None]
                          | (i_idx[None, :] == 0))
        # the i==0 cell exists only on part1/variant rows (start==0)
        iext = jnp.where((i_idx[None, :] == 0) | i_at_end,
                         gend_i, ge_i)
        from_m = (Mp - I32(go)) > Ip
        Irow = jnp.where(i_ok,
                         jnp.where(from_m, Mp - I32(go), Ip) - iext, NEG)
        It = from_m.astype(jnp.uint8)   # FROM_M=0? no: FROM_M iff cond

        # ---- D (set_d/set_end_d): within-row chain via cummax ----
        dext = jnp.where(is_var | last_row, gend_i, ge_i)[:, None]
        d_ok = in_band & (i_idx[None, :] >= jnp.maximum(start, 1)[:, None])
        a_from_m = jnp.concatenate(
            [jnp.full((B, 1), NEG, I32), Mrow[:, :-1] - I32(go)], 1)
        U = jnp.where(d_ok, a_from_m + dext * (i_idx[None, :] - 1), NEG)
        T = jax.lax.cummax(U, axis=1)
        Drow = jnp.where(d_ok, T - dext * i_idx[None, :], NEG)
        # traceback: FROM_M iff M[i-1]-go > D[i-1] (stored value)
        d_prev = jnp.concatenate(
            [jnp.full((B, 1), NEG, I32), Drow[:, :-1]], 1)
        Dt = (a_from_m > d_prev).astype(jnp.uint8)

        Mrow = jnp.where(active[:, None], Mrow, Mp)
        Irow = jnp.where(active[:, None], Irow, Ip)
        Drow = jnp.where(active[:, None], Drow, Dp)
        tb = (Mt | (It << 2) | (Dt << 3)) \
            & jnp.where(active[:, None], jnp.uint8(0xFF), jnp.uint8(0))
        return (Mrow, Irow, Drow), tb

    (Mf, If, Df), tb_rows = jax.lax.scan(
        row_step, (M0, I0, D0), jnp.arange(1, L2p, dtype=I32))
    # assemble [B, L2+1, L1+1]; row 0 has no traceback
    tb = jnp.concatenate([jnp.zeros((B, 1, L1p), jnp.uint8),
                          jnp.transpose(tb_rows, (1, 0, 2))], axis=1)

    # final cell (len2, len1) per lane — rows were frozen past len2
    mN = jnp.take_along_axis(Mf, len1[:, None], axis=1)[:, 0]
    iN = jnp.take_along_axis(If, len1[:, None], axis=1)[:, 0]
    dN = jnp.take_along_axis(Df, len1[:, None], axis=1)[:, 0]
    score = mN
    ctype = jnp.full(B, FROM_M, dtype=I32)
    ctype = jnp.where(iN > score, FROM_I, ctype)
    score = jnp.maximum(score, iN)
    ctype = jnp.where(dN > score, FROM_D, ctype)
    score = jnp.maximum(score, dN)
    return score, ctype, tb


def _use_native_dp(n_jobs):
    """Route a DP batch to the native kernels (bit-exact with the device
    ones): always where device.use_device() says no; on the GPU when the
    batch is under 64 jobs, too small to pay for a launch and its
    transfers.  Device batches are tallied in device.COUNTS."""
    from .. import device
    from ..index import native as native_mod
    if native_mod._load() is None:
        return False
    if not device.use_device() or n_jobs < 64:
        return True
    device.count("dp_jobs", n_jobs)
    return False


def _path_from_ctypes(cts, len1, len2):
    """Rebuild the scalar oracle's [(ctype, i, j)] last-to-first path from
    the native kernels' ctype byte sequence (each entry's coordinates are
    the previous entry's moved by its ctype, starting at (len1, len2))."""
    path = []
    i, j = len1, len2
    prev = None
    for ct in cts:
        ct = int(ct)
        if prev is not None:
            if prev == FROM_M:
                i -= 1
                j -= 1
            elif prev == FROM_I:
                j -= 1
            else:
                i -= 1
        path.append((ct, i, j))
        prev = ct
    return path


def banded_global_batch(pairs, ap, band_widths=None):
    """Batched aln_global_core: pairs = [(seq1, seq2), ...] (uint8 codes).
    Returns [(score, path), ...] exactly like the scalar oracle.

    Device computes scores + traceback lattices for the whole batch in one
    jit call; the short backtrace walks run on host.  Zero-length pairs are
    answered host-side like the C (stdaln.c:351-352).  band_widths, when
    given, overrides ap.band_width per pair (the local-SW path-recovery
    retry widens bands per job, stdaln.c:723-745).
    """
    res = [None] * len(pairs)
    todo = [i for i, (a, b) in enumerate(pairs)
            if len(a) > 0 and len(b) > 0]
    for i, (a, b) in enumerate(pairs):
        if len(a) == 0 or len(b) == 0:
            res[i] = (0, [])
    if not todo:
        return res

    if _use_native_dp(len(todo)):
        from ..index.native import aln_global_native
        for i in todo:
            a, b = pairs[i]
            bw = (band_widths[i] if band_widths is not None
                  else ap.band_width)
            score, cts = aln_global_native(
                a, b, ap.matrix, ap.row, ap.gap_open, ap.gap_ext,
                ap.gap_end, bw)
            res[i] = (score, _path_from_ctypes(cts, len(a), len(b)))
        return res

    B = len(todo)
    L1 = max(len(pairs[i][0]) for i in todo)
    L2 = max(len(pairs[i][1]) for i in todo)
    # bucket for compile reuse (B in powers of two)
    L1 = -(-L1 // 32) * 32
    L2 = -(-L2 // 32) * 32
    Bb = 8
    while Bb < B:
        Bb <<= 1
    s1 = np.zeros((Bb, L1 + 1), dtype=np.int32)
    s2 = np.zeros((Bb, L2 + 1), dtype=np.int32)
    len1 = np.ones(Bb, dtype=np.int32)
    len2 = np.ones(Bb, dtype=np.int32)
    for bi, i in enumerate(todo):
        a, b = pairs[i]
        s1[bi, 1:len(a) + 1] = a
        s2[bi, 1:len(b) + 1] = b
        len1[bi] = len(a)
        len2[bi] = len(b)
    if band_widths is None:
        bw = np.full(Bb, ap.band_width, dtype=np.int64)
    else:
        bw = np.full(Bb, 1, dtype=np.int64)
        for bi, i in enumerate(todo):
            bw[bi] = band_widths[i]    # indexed by pair position
    b1 = np.where(len1 > len2, len1 - len2 + bw, bw)
    b2 = np.where(len1 > len2, bw, len2 - len1 + bw)
    b1 = np.minimum(b1, len1).astype(np.int32)
    b2 = np.minimum(b2, len2).astype(np.int32)

    score, ctype, tb = _banded_global_device(
        jnp.asarray(s1), jnp.asarray(len1), jnp.asarray(s2),
        jnp.asarray(len2), jnp.asarray(b1), jnp.asarray(b2),
        jnp.asarray(np.asarray(ap.matrix, dtype=np.int32)),
        go=int(ap.gap_open), ge=int(ap.gap_ext), gend=int(ap.gap_end))
    # one packed host transfer
    score = np.asarray(score)
    ctype = np.asarray(ctype)
    tb = np.asarray(tb)

    for bi, idx in enumerate(todo):
        res[idx] = (int(score[bi]),
                    _backtrace(tb[bi], int(ctype[bi]),
                               int(len1[bi]), int(len2[bi])))
    return res


@functools.partial(jax.jit, static_argnames=("go", "ge", "bw"))
def _extend_device(s1, len1, s2, len2, g0, mat, *, go, ge, bw):
    """Batched aln_extend_core forward lattice (stdaln.c:862-970).

    The C walks rows with an adaptive band (narrowing to the positive
    cells); within a row the F chain vectorizes exactly via one cummax:
    h is first corrected by the (column-wise) E and the diagonal term, and
    F[i] = max(F[i-1]-r, max(h[i-1]-q-r, 0)) never improves through an
    F-derived h because q+r > r — the classic lazy-F argument.

    Returns (score, end_i, end_j) per lane (the C's `path_len == 0` mode,
    which is all bwasw's extend_left/rght consume)."""
    B, L1p2 = s1.shape          # s1 padded to [B, L1max+2], 1-based
    qr = I32(go + ge)
    r = I32(ge)
    i_idx = jnp.arange(L1p2, dtype=I32)
    mat_flat = mat.reshape(-1)
    NEGF = I32(-(1 << 29))

    # state: hd[i] = h[j-1][i-1] (shifted diagonal, the C's rolling eh_h),
    # ev[i] = e[j-1][i], window [start, end), best score + cell
    hd0 = jnp.zeros((B, L1p2), I32).at[:, 1].set(g0)
    ev0 = jnp.zeros((B, L1p2), I32)
    init = (hd0, ev0, jnp.ones(B, I32), jnp.full(B, 2, I32),
            jnp.zeros(B, I32), jnp.zeros(B, I32), jnp.zeros(B, I32),
            jnp.zeros(B, jnp.bool_))

    def row_step(carry, j):
        hd, ev, start, end, score, end_i, end_j, stopped = carry
        j = j.astype(I32)
        active = ~stopped & (j <= len2)
        start_n = jnp.maximum(start, jnp.maximum(j - bw, 1))
        end_n = jnp.minimum(end, jnp.minimum(j + bw, len1 + 1))
        dead = start_n == end_n
        active = active & ~dead

        c2j = jnp.take_along_axis(
            s2, jnp.clip(j, 0, s2.shape[1] - 1)[None, None].astype(I32)
            * jnp.ones((B, 1), I32), axis=1)[:, 0]
        sub = mat_flat[c2j[:, None] * 5 + s1]

        inwin = (i_idx[None, :] >= start_n[:, None]) \
            & (i_idx[None, :] < end_n[:, None])
        h0a = jnp.where(hd > 0, hd + sub, 0)
        hpre = jnp.maximum(h0a, ev)                 # pre-F h
        hcut_pre = jnp.maximum(hpre - qr, 0)
        U = jnp.where(inwin, hcut_pre + r * i_idx[None, :], NEGF)
        T = jax.lax.cummax(U, axis=1)
        Tm1 = jnp.concatenate([jnp.full((B, 1), NEGF, I32), T[:, :-1]], 1)
        f = jnp.maximum(Tm1 - r * (i_idx[None, :] - 1), 0)
        f = jnp.where(inwin, f, 0)
        h = jnp.where(inwin, jnp.maximum(hpre, f), 0)

        # positive span and best-cell tracking (first cell wins ties)
        pos = (h > 0) & inwin
        any_pos = pos.any(axis=1)
        ns = jnp.argmax(pos, axis=1).astype(I32)
        ne = (L1p2 - 1 - jnp.argmax(pos[:, ::-1], axis=1)).astype(I32)
        row_best = jnp.max(jnp.where(pos, h, 0), axis=1)
        row_arg = jnp.argmax(jnp.where(pos, h, 0), axis=1).astype(I32)
        better = active & any_pos & (row_best > score)
        score = jnp.where(better, row_best, score)
        end_i = jnp.where(better, row_arg, end_i)
        end_j = jnp.where(better, j, end_j)

        # state updates (C writes only [start, end] cells; end gets e=0)
        hcut = jnp.maximum(h - qr, 0)
        e_new = jnp.maximum(ev - r, hcut)
        ev_out = jnp.where(inwin, e_new, ev)
        ev_out = jnp.where(i_idx[None, :] == end_n[:, None], 0, ev_out)
        h_shift = jnp.concatenate([jnp.zeros((B, 1), I32), h[:, :-1]], 1)
        wr = (i_idx[None, :] >= start_n[:, None]) \
            & (i_idx[None, :] <= end_n[:, None])
        hd_out = jnp.where(wr, h_shift, hd)

        stop_now = stopped | dead | (active & ~any_pos) | (j >= len2)
        upd = active[:, None]
        hd = jnp.where(upd, hd_out, hd)
        ev = jnp.where(upd, ev_out, ev)
        start = jnp.where(active & any_pos, ns, start_n)
        end = jnp.where(active & any_pos, ne + 3, end_n)
        return (hd, ev, start, end, score, end_i, end_j, stop_now), None

    L2max = s2.shape[1] - 1
    (hd, ev, start, end, score, end_i, end_j, stopped), _ = jax.lax.scan(
        row_step, init, jnp.arange(1, L2max + 1, dtype=I32))
    return score - 1, end_i, end_j


def extend_batch(jobs, ap, g0s):
    """Batched aln_extend_core, score/end only (want_path=False).

    jobs: [(seq1, seq2), ...]; g0s: per-job initial score G0.
    Returns [(score, end_i, end_j), ...] matching the scalar oracle."""
    res = [None] * len(jobs)
    todo = [i for i, (a, b) in enumerate(jobs) if len(a) and len(b)]
    for i, (a, b) in enumerate(jobs):
        if not (len(a) and len(b)):
            res[i] = (-1, 0, 0)
    if not todo:
        return res
    if _use_native_dp(len(todo)):
        from ..index.native import aln_extend_native
        for i in todo:
            a, b = jobs[i]
            score, ei, ej, _ = aln_extend_native(
                a, b, ap.matrix, ap.row, ap.gap_open, ap.gap_ext,
                ap.band_width, g0s[i], want_path=False)
            res[i] = (score, ei, ej)
        return res
    B = len(todo)
    L1 = -(-max(len(jobs[i][0]) for i in todo) // 32) * 32
    L2 = -(-max(len(jobs[i][1]) for i in todo) // 32) * 32
    Bb = 8
    while Bb < B:
        Bb <<= 1
    s1 = np.zeros((Bb, L1 + 2), dtype=np.int32)
    s2 = np.zeros((Bb, L2 + 1), dtype=np.int32)
    len1 = np.ones(Bb, dtype=np.int32)
    len2 = np.ones(Bb, dtype=np.int32)
    g0 = np.zeros(Bb, dtype=np.int32)
    for bi, i in enumerate(todo):
        a, b = jobs[i]
        s1[bi, 1:len(a) + 1] = a
        s2[bi, 1:len(b) + 1] = b
        len1[bi] = len(a)
        len2[bi] = len(b)
        g0[bi] = g0s[i]
    score, ei, ej = _extend_device(
        jnp.asarray(s1), jnp.asarray(len1), jnp.asarray(s2),
        jnp.asarray(len2), jnp.asarray(g0),
        jnp.asarray(np.asarray(ap.matrix, dtype=np.int32)),
        go=int(ap.gap_open), ge=int(ap.gap_ext), bw=int(ap.band_width))
    packed = np.asarray(jnp.stack([score, ei, ej], axis=1))
    for bi, i in enumerate(todo):
        res[i] = (int(packed[bi, 0]), int(packed[bi, 1]),
                  int(packed[bi, 2]))
    return res


@functools.partial(jax.jit, static_argnames=("go", "ge"))
def _local_fwd_device(s1, len1, s2, len2, mat, *, go, ge):
    """Batched forward pass of aln_local_core (stdaln.c:556-637):
    full-width SW scan returning (score_f, end_i, end_j) per lane.

    Row recurrence vectorizes with the same lazy-F cummax as
    _extend_device.  The C's `f` freeze over zero cells (f neither decays
    nor applies while h[i-1]==0) is provably unobservable: a positive f
    always keeps its own gate open (h[i] >= f > 0), and a frozen f is
    never positive again except through a fresh h-q-r > 0 — so plain
    lazy-F yields identical h lattices.

    The E chain is gated per column: e[j][i] = h[j-1][i] > q+r ?
    max(e[j-1][i]-r, h[j-1][i]-q-r) : 0 (the NT_LOCAL_SCORE packing drops
    e when h doesn't fit, stdaln.c:563-571).

    Best cell: C scans i then j ascending updating on strict '<', so the
    winner is the first row-major cell attaining the max — argmax's
    first-occurrence tie rule within a row, strict '>' across rows."""
    B, L1p = s1.shape
    qr = I32(go + ge)
    r = I32(ge)
    i_idx = jnp.arange(L1p, dtype=I32)
    mat_flat = mat.reshape(-1)
    NEGF = I32(-(1 << 29))
    inb = (i_idx[None, :] >= 1) & (i_idx[None, :] <= len1[:, None])

    h0 = jnp.zeros((B, L1p), I32)
    e0 = jnp.zeros((B, L1p), I32)
    init = (h0, e0, jnp.zeros(B, I32), jnp.zeros(B, I32),
            jnp.zeros(B, I32))

    def row_step(carry, j):
        hprev, eprev, score, end_i, end_j = carry
        j = j.astype(I32)
        active = j <= len2

        c2j = jnp.take_along_axis(
            s2, jnp.clip(j, 0, s2.shape[1] - 1)[None, None].astype(I32)
            * jnp.ones((B, 1), I32), axis=1)[:, 0]
        sub = mat_flat[c2j[:, None] * 5 + s1]

        hdiag = jnp.concatenate([jnp.zeros((B, 1), I32), hprev[:, :-1]], 1)
        hp0 = jnp.maximum(hdiag + sub, 0)
        e_cur = jnp.where(hprev > qr,
                          jnp.maximum(eprev - r, hprev - qr), 0)
        hpre = jnp.maximum(hp0, e_cur)
        hpre = jnp.where(inb, hpre, 0)
        hcut = jnp.maximum(hpre - qr, 0)
        U = jnp.where(inb, hcut + r * i_idx[None, :], NEGF)
        T = jax.lax.cummax(U, axis=1)
        Tm1 = jnp.concatenate([jnp.full((B, 1), NEGF, I32), T[:, :-1]], 1)
        f = jnp.maximum(Tm1 - r * (i_idx[None, :] - 1), 0)
        h = jnp.where(inb, jnp.maximum(hpre, f), 0)

        row_best = jnp.max(h, axis=1)
        row_arg = jnp.argmax(h, axis=1).astype(I32)
        better = active & (row_best > score)
        score = jnp.where(better, row_best, score)
        end_i = jnp.where(better, row_arg, end_i)
        end_j = jnp.where(better, j, end_j)

        upd = active[:, None]
        hprev = jnp.where(upd, h, hprev)
        eprev = jnp.where(upd, e_cur, eprev)
        return (hprev, eprev, score, end_i, end_j), None

    L2max = s2.shape[1] - 1
    (h, e, score, end_i, end_j), _ = jax.lax.scan(
        row_step, init, jnp.arange(1, L2max + 1, dtype=I32))
    return score, end_i, end_j


def local_sw_batch(jobs, ap, thres=1):
    """Batched aln_local_core for mate rescue: returns
    [(score, path, subo), ...] bit-identical to the scalar oracle with
    want_subo=False.

    Split: the O(len1*len2) forward lattice runs on device for the whole
    batch (one jit call); the short banded reverse walk (stdaln.c:639-696,
    O(band*aln_len)) runs on host; path recovery batches through the
    banded-global device kernel with the reference's bandwidth-doubling
    retry (stdaln.c:723-745)."""
    from ..refmodel.local_aln_scalar import local_rev

    res = [None] * len(jobs)
    todo = [i for i, (a, b) in enumerate(jobs) if len(a) and len(b)]
    for i, (a, b) in enumerate(jobs):
        if not (len(a) and len(b)):
            res[i] = (-1, None, 0)
    if not todo:
        return res
    if _use_native_dp(len(todo)):
        from ..index.native import local_fwd_native
        packed = np.zeros((len(todo), 3), dtype=np.int64)
        for bi, i in enumerate(todo):
            a, b = jobs[i]
            packed[bi] = local_fwd_native(a, b, ap.matrix, ap.row,
                                          ap.gap_open, ap.gap_ext)
    else:
        B = len(todo)
        # coarse buckets: rescue windows are isize-dependent (~6*std+2L),
        # so fine-grained shapes would compile a kernel per batch
        L1 = -(-max(len(jobs[i][0]) for i in todo) // 128) * 128
        L2 = -(-max(len(jobs[i][1]) for i in todo) // 32) * 32
        Bb = 8
        while Bb < B:
            Bb <<= 1
        s1 = np.full((Bb, L1 + 1), 4, dtype=np.int32)
        s2 = np.full((Bb, L2 + 1), 4, dtype=np.int32)
        len1 = np.ones(Bb, dtype=np.int32)
        len2 = np.ones(Bb, dtype=np.int32)
        for bi, i in enumerate(todo):
            a, b = jobs[i]
            s1[bi, 1:len(a) + 1] = a
            s2[bi, 1:len(b) + 1] = b
            len1[bi] = len(a)
            len2[bi] = len(b)
        score_f, end_i, end_j = _local_fwd_device(
            jnp.asarray(s1), jnp.asarray(len1), jnp.asarray(s2),
            jnp.asarray(len2),
            jnp.asarray(np.asarray(ap.matrix, dtype=np.int32)),
            go=int(ap.gap_open), ge=int(ap.gap_ext))
        packed = np.asarray(jnp.stack([score_f, end_i, end_j], axis=1))

    # host reverse pass (native O(band*len) walk, scalar model as
    # fallback); collect path-recovery segments
    from ..index.native import local_rev_native
    seg = {}           # job idx -> (score_f, score_r, si, sj, ei, ej)
    for bi, i in enumerate(todo):
        sf, ei, ej = (int(packed[bi, 0]), int(packed[bi, 1]),
                      int(packed[bi, 2]))
        if sf < thres:
            res[i] = (sf, None, 0)
            continue
        rev = local_rev_native(jobs[i][0], jobs[i][1], ap.matrix, ap.row,
                               ap.gap_open, ap.gap_ext, sf, ei, ej)
        if rev is False:
            rev = local_rev(jobs[i][0], jobs[i][1], ap, sf, ei, ej)
        if rev is None:
            res[i] = (sf, None, 0)
            continue
        sr, si, sj = rev
        seg[i] = (sf, sr, si, sj, ei, ej)

    # batched bandwidth-doubling global DP (stdaln.c:723-745)
    band = {i: ap.band_width for i in seg}
    done_path = {}
    pending = list(seg)
    while pending:
        pairs = []
        for i in pending:
            sf, sr, si, sj, ei, ej = seg[i]
            pairs.append((np.asarray(jobs[i][0])[si - 1:ei],
                          np.asarray(jobs[i][1])[sj - 1:ej]))
        ap_real = type(ap)(ap.gap_open, ap.gap_ext, -1, ap.matrix,
                           ap.row, 0)
        out = banded_global_batch(
            pairs, ap_real,
            band_widths=[band[i] for i in pending])
        nxt = []
        for i, (score_g, path) in zip(pending, out):
            sf, sr, si, sj, ei, ej = seg[i]
            jmax = max(ei - si, ej - sj) + 1
            if score_g == sr or sf == score_g or band[i] > jmax:
                done_path[i] = (score_g, path)
            else:
                band[i] <<= 1
                nxt.append(i)
        pending = nxt

    for i, (score_g, path) in done_path.items():
        sf, sr, si, sj, ei, ej = seg[i]
        if sr > score_g and sf > score_g:
            res[i] = (-1, None, 0)
        else:
            res[i] = (score_g,
                      [(ct, x + si - 1, y + sj - 1) for ct, x, y in path],
                      0)
    return res


def _backtrace(tb, ctype, len1, len2):
    """Host backtrace matching stdaln.c:487-514 / the scalar oracle."""
    i, j = len1, len2
    typ = _tb_type(tb[j, i], ctype)
    path = [(ctype, i, j)]
    while i or j:
        if ctype == FROM_M:
            i -= 1
            j -= 1
        elif ctype == FROM_I:
            j -= 1
        else:
            i -= 1
        ctype = typ
        if i or j:
            typ = _tb_type(tb[j, i], typ)
            path.append((ctype, i, j))
    return path


def _tb_type(cell, ctype):
    if ctype == FROM_M:
        return cell & 3
    if ctype == FROM_I:
        return FROM_M if (cell >> 2) & 1 else FROM_I
    return FROM_M if (cell >> 3) & 1 else FROM_D
