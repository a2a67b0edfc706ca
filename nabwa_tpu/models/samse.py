"""samse workflow — bwa_sai2sam_se_core semantics (bwase.c:654-721).

Pipeline per chunk (0x40000 reads): hit selection + drand48 sampling (host,
call-order faithful), SA→coordinate via the batched device sa_lookup,
gapped refinement (banded global DP, host scalar for now — Pallas kernel
later), MD/NM, SAM emission.  Output is byte-identical with the reference's
`bwa samse`.
"""

import numpy as np

from ..constants import (BWA_TYPE_NO_MATCH, BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT,
                         BWA_TYPE_MATESW, BWA_AVG_ERR, BWA_MODE_COMPREAD,
                         SAM_FSU, SAM_FMU, SAM_FSR, SAM_FMR, SAM_FPP)
from ..refmodel.aln_scalar import cal_maxdiff
from ..refmodel.stdaln_scalar import (aln_global_core, path2cigar32,
                                      ALN_PARAM_BWA, FROM_M, FROM_I, FROM_D,
                                      FROM_S)

_NEG1 = 0xFFFFFFFF


def make_g_log_n():
    """g_log_n table (bwase_initialize, bwase.c:613-617)."""
    import math
    t = np.zeros(256, dtype=np.int32)
    for i in range(1, 256):
        t[i] = int(4.343 * math.log(i) + 0.5)
    return t


G_LOG_N = make_g_log_n()


class SeqState:
    """Mutable per-read alignment state (the bwa_seq_t fields samse uses)."""

    __slots__ = ("read", "type", "c1", "c2", "n_mm", "n_gapo", "n_gape",
                 "strand", "score", "sa", "pos", "mapQ", "seQ", "cigar",
                 "md", "nm", "multi", "n_multi", "extra_flag", "len",
                 "max_entries")

    def __init__(self, read):
        self.read = read
        self.len = read.len
        self.type = BWA_TYPE_NO_MATCH
        self.c1 = self.c2 = 0
        self.n_mm = self.n_gapo = self.n_gape = 0
        self.strand = 0
        self.score = 0
        self.sa = 0
        self.pos = 0
        self.mapQ = self.seQ = 0
        self.cigar = None          # list of (op, len) or None
        self.md = None
        self.nm = 0
        self.multi = []
        self.n_multi = 0
        self.extra_flag = 0
        self.max_entries = 0

    # tuple state: slot-dict pickling dominated distributed bam2bam's
    # pass-2 chunk serialization at the coordinator
    def __getstate__(self):
        return tuple(getattr(self, f) for f in SeqState.__slots__)

    def __setstate__(self, st):
        for f, v in zip(SeqState.__slots__, st):
            setattr(self, f, v)


def aln2seq_core(alns, s, rng, set_main=True, n_multi=0):
    """bwa_aln2seq_core (bwase.c:19-95): reservoir-sample the primary hit
    among score ties (weighted by interval size), count c1/c2, optionally
    enumerate multi-hits.  rng is the shared Rand48 stream — call order is
    part of the output contract."""
    if not alns:
        s.type = BWA_TYPE_NO_MATCH
        s.c1 = s.c2 = 0
        return
    if set_main:
        # alns are (n_mm, n_gapo, n_gape, a, k, l, score) tuples (io.sai A_*)
        best = alns[0][6]
        cnt = 0
        i = 0
        drand48 = rng.drand48
        while i < len(alns):
            n_mm, n_gapo, n_gape, a, k, l, score = alns[i]
            if score > best:
                break
            w = l - k + 1
            if drand48() * (w + cnt) > float(cnt):
                s.n_mm = n_mm
                s.n_gapo = n_gapo
                s.n_gape = n_gape
                s.strand = a
                s.score = score
                s.sa = k + int(w * drand48())
            cnt += w
            i += 1
        s.c1 = cnt
        while i < len(alns):
            cnt += alns[i][5] - alns[i][4] + 1
            i += 1
        s.c2 = cnt - s.c1
        s.type = BWA_TYPE_REPEAT if s.c1 > 1 else BWA_TYPE_UNIQUE

    if n_multi:
        n_occ = sum(q[5] - q[4] + 1 for q in alns)
        s.multi = []
        s.n_multi = 0
        if n_occ > n_multi + 1:  # too many -> none (bwase.c:54-57)
            return
        rest = n_occ
        multi = []
        for q in alns:
            sz = q[5] - q[4] + 1
            if sz <= rest:
                for l in range(q[4], q[5] + 1):
                    multi.append(dict(pos=l, gap=q[1] + q[2],
                                      mm=q[0], strand=q[3],
                                      cigar=None, n_cigar=0))
                rest -= sz
            else:
                # unreachable given the cap above (bwase.c:75 comment)
                break
        multi = [m for m in multi if m["pos"] != s.sa]
        s.multi = multi[:n_multi] if len(multi) >= n_multi else multi
        s.n_multi = len(s.multi)


def approx_mapQ(s, mm):
    """bwa_approx_mapQ (bwase.c:113-122)."""
    if s.c1 == 0:
        return 23
    if s.c1 > 1:
        return 0
    if s.n_mm == mm:
        return 25
    if s.c2 == 0:
        return 37
    n = 255 if s.c2 >= 255 else s.c2
    return 0 if 23 < G_LOG_N[n] else 23 - G_LOG_N[n]


def cal_pac_pos(engine, states, max_mm, fnr):
    """bwa_cal_pac_pos (bwase.c:156-183) with batched sa_lookup (native
    host walk or device kernel via engine.sa_rows).

    Reverse-strand primary hits and multis resolve on the forward BWT;
    forward-strand ones on the reverse BWT with the seq_len-(sa+len) flip."""
    rev = engine.index.rev
    _md_cache = {}
    jobs_f, jobs_r = [], []  # (state_idx, 'p'|('m',j), sa_row)
    for si, s in enumerate(states):
        matched = s.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT)
        if matched and s.strand:
            jobs_f.append((si, -1, s.sa))
        if matched and not s.strand:
            jobs_r.append((si, -1, s.sa))
        for j, m in enumerate(s.multi):
            (jobs_f if m["strand"] else jobs_r).append((si, j, m["pos"]))

    def run(jobs, a):
        if not jobs:
            return np.zeros(0, dtype=np.uint32)
        return engine.sa_rows(a, np.array([t[2] for t in jobs],
                                          dtype=np.uint32))

    res_f = run(jobs_f, 1)
    res_r = run(jobs_r, 0)

    for (si, j, _), v in zip(jobs_f, res_f):
        s = states[si]
        if j < 0:
            s.pos = int(v)
        else:
            s.multi[j]["pos"] = int(v)
    for (si, j, _), v in zip(jobs_r, res_r):
        s = states[si]
        if j < 0:
            s.pos = (rev.seq_len - (int(v) + s.len)) & _NEG1
        else:
            s.multi[j]["pos"] = (rev.seq_len - (int(v) + s.len)) & _NEG1

    for s in states:
        if s.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
            if fnr > 0.0:
                # cal_maxdiff is an iterative series per length — cache
                # per distinct read length (one or two values per chunk;
                # the per-state call was ~0.6 s per 200k records)
                max_diff = _md_cache.get(s.len)
                if max_diff is None:
                    max_diff = cal_maxdiff(s.len, BWA_AVG_ERR, fnr)
                    _md_cache[s.len] = max_diff
            else:
                max_diff = max_mm
            s.seQ = s.mapQ = approx_mapQ(s, max_diff)


def refine_window(l_pac, pac, seq_codes, pos, ext, is_end_correct=True):
    """The reference-window slice of refine_gapped_core (bwase.c:193-207).
    Returns (ref_seq, __pos)."""
    length = len(seq_codes)
    # uint32 pos past l_pac is a wrapped negative (bwase.c:197)
    pos_u = pos & _NEG1
    __pos = pos_u if pos_u <= l_pac else int(np.int32(np.uint32(pos_u)))
    ref_len = length + abs(ext)
    if ext > 0:
        lo = __pos
        hi = min(__pos + ref_len, l_pac)
    else:
        x = __pos + (length if is_end_correct else ref_len)
        lo = max(x - ref_len, 0)
        hi = min(x, l_pac)
    ref_seq = pac[lo:hi] if hi > lo else np.zeros(0, dtype=np.uint8)
    return ref_seq, __pos


def refine_gapped_core(l_pac, pac, seq_codes, pos, ext, is_end_correct=True,
                       path=None):
    """refine_gapped_core (bwase.c:189-237).  seq_codes: forward-oriented
    read codes vs the reference strand.  Returns (cigar list, new_pos).
    `path` short-circuits the DP with a batch-precomputed device result."""
    ref_seq, __pos = refine_window(l_pac, pac, seq_codes, pos, ext,
                                   is_end_correct)
    if path is None:
        _, path = aln_global_core(ref_seq, np.asarray(seq_codes),
                                  ALN_PARAM_BWA)
    cigar = path2cigar32(path)
    n_cigar = len(cigar)
    if n_cigar == 0:
        return [], __pos

    if ext < 0 and is_end_correct:  # fix forward-strand coordinate
        ll = 0
        for op, ln in cigar:
            if op == FROM_D:
                ll -= ln
            elif op == FROM_I:
                ll += ln
        __pos += ll

    if cigar[0][0] == FROM_D:  # 5' deletion
        __pos += cigar[0][1]
        cigar = cigar[1:]
    if cigar and cigar[-1][0] == FROM_D:  # 3' deletion
        cigar = cigar[:-1]
    # I at either end becomes S (bwase.c:230-232)
    if cigar and cigar[-1][0] == FROM_I:
        cigar[-1] = (FROM_S, cigar[-1][1])
    if cigar and cigar[0][0] == FROM_I:
        cigar[0] = (FROM_S, cigar[0][1])
    return cigar, __pos


def _bns_arrays(bns):
    """Cached ann/amb offset arrays for vectorized coordinate work."""
    arr = getattr(bns, "_np_arrays", None)
    if arr is None:
        arr = (np.array([a.offset for a in bns.anns], dtype=np.int64),
               np.array([h.offset for h in bns.ambs], dtype=np.int64),
               np.array([h.offset + h.length for h in bns.ambs],
                        dtype=np.int64))
        try:
            bns._np_arrays = arr
        except AttributeError:
            pass
    return arr


def cal_md_batch(states, bns, pac):
    """Vectorized MD/NM for the common case — matched reads with no CIGAR
    whose reference window stays inside pac and touches no ambiguity hole
    (bwa_cal_md1 fast path over the whole chunk at once).  Returns the
    list of states that still need the scalar cal_md1."""
    _, amb_off, amb_end = _bns_arrays(bns)
    l_pac = bns.l_pac
    todo = []
    by_len = {}
    for s in states:
        if s.type == BWA_TYPE_NO_MATCH:
            continue
        if s.cigar is not None:
            todo.append(s)
            continue
        by_len.setdefault(s.len, []).append(s)
    for L, group in by_len.items():
        pos = np.array([s.pos for s in group], dtype=np.int64)
        inb = pos + L <= l_pac
        if len(amb_off):
            idx = np.searchsorted(amb_end, pos, side="right")
            idxc = np.minimum(idx, len(amb_off) - 1)
            clean = inb & ~((idx < len(amb_off))
                            & (amb_off[idxc] < pos + L))
        else:
            clean = inb
        clean_states = [s for s, c in zip(group, clean.tolist()) if c]
        todo.extend(s for s, c in zip(group, clean.tolist()) if not c)
        if not clean_states:
            continue
        cpos = pos[clean]
        ref = pac[cpos[:, None] + np.arange(L)]
        seq = np.stack([(s.read.rseq if s.strand else s.read.seq[::-1])[:L]
                        for s in clean_states])
        mism = (ref != seq) | (seq > 3)
        nm = mism.sum(axis=1)
        nm_l = nm.tolist()
        clean_md = str(L)
        rows, cols = np.nonzero(mism)
        rows = rows.tolist()
        cols = cols.tolist()
        ri = 0
        for i, s in enumerate(clean_states):
            n = nm_l[i]
            s.nm = n
            if n == 0:
                s.md = clean_md
                continue
            out = []
            last = -1
            rseq = ref[i]
            for _ in range(n):
                mi = cols[ri]
                ri += 1
                out.append(str(mi - last - 1))
                out.append("ACGT"[rseq[mi]])
                last = mi
            out.append(str(L - 1 - last))
            s.md = "".join(out)
    return todo


def cal_md1(cigar, seq_codes, pos, bns, pac):
    """bwa_cal_md1 (bwase.c:253-315): MD string and NM, walking pac with
    ambiguity holes overriding the packed (randomized) bases."""
    holes = bns.ambs
    n_holes = len(holes)
    # find first hole ending after pos (binary search, bwase.c:263-268)
    left, right = 0, n_holes
    while left < right:
        mid = left + ((right - left) >> 1)
        h = holes[mid]
        if pos >= h.offset + h.length:
            left = mid + 1
        elif pos < h.offset:
            right = mid
        else:
            left = right = mid
    ridx = right  # index of current/next hole

    out = []
    nm = 0
    u = 0
    p = pos
    l_pac = bns.l_pac

    # fast path: no ambiguity hole overlaps the reference window and the
    # window stays inside pac — per-M-segment numpy compares instead of
    # the per-base Python walk (the dominant cost of refine_gapped)
    ref_span = (len(seq_codes) if not cigar else
                sum(ln for op, ln in cigar if op in (FROM_M, FROM_D)))
    if (p + ref_span <= l_pac
            and (ridx >= n_holes or holes[ridx].offset >= p + ref_span)):
        seq = np.asarray(seq_codes)
        y = 0
        for op, ln in (cigar or ((FROM_M, len(seq)),)):
            if op == FROM_M:
                ref = pac[p:p + ln]
                sseg = seq[y:y + ln]
                mism = np.flatnonzero((ref != sseg) | (sseg > 3)).tolist()
                last = -1
                for mi in mism:
                    out.append(str(u + (mi - last - 1)))
                    out.append("ACGT"[int(ref[mi])])
                    u = 0
                    last = mi
                u += ln - 1 - last
                nm += len(mism)
                p += ln
                y += ln
            elif op in (FROM_I, FROM_S):
                y += ln
                if op == FROM_I:
                    nm += ln
            elif op == FROM_D:
                out.append(str(u))
                out.append("^")
                out.append("".join("ACGT"[int(c)] for c in pac[p:p + ln]))
                u = 0
                nm += ln
                p += ln
        out.append(str(u))
        return "".join(out), nm

    def get_ref():
        if ridx < n_holes and p >= holes[ridx].offset:
            return ord(holes[ridx].amb)  # the raw ambiguity character
        return int(pac[p])

    def advance():
        nonlocal p, ridx
        p += 1
        if ridx < n_holes and p >= holes[ridx].offset + holes[ridx].length:
            ridx += 1

    if cigar:
        y = 0
        for op, ln in cigar:
            if op == FROM_M:
                for _ in range(ln):
                    if p >= l_pac:
                        break
                    c = get_ref()
                    if c > 3 or seq_codes[y] > 3 or c != seq_codes[y]:
                        out.append(str(u))
                        out.append(chr(c) if c > 3 else "ACGT"[c])
                        nm += 1
                        u = 0
                    else:
                        u += 1
                    advance()
                    y += 1
            elif op in (FROM_I, FROM_S):
                y += ln
                if op == FROM_I:
                    nm += ln
            elif op == FROM_D:
                out.append(str(u))
                out.append("^")
                for _ in range(ln):
                    if p >= l_pac:
                        break
                    c = get_ref()
                    out.append(chr(c) if c > 3 else "ACGT"[c])
                    advance()
                u = 0
                nm += ln
    else:
        for z in range(len(seq_codes)):
            c = get_ref()
            if c > 3 or seq_codes[z] > 3 or c != seq_codes[z]:
                out.append(str(u))
                out.append(chr(c) if c > 3 else "ACGT"[c])
                nm += 1
                u = 0
            else:
                u += 1
            advance()
    out.append(str(u))
    return "".join(out), nm


def correct_trimmed(s):
    """bwa_correct_trimmed (bwase.c:320-354)."""
    r = s.read
    if s.len == r.full_len:
        return
    extra = r.full_len - s.len
    if s.strand == 0:
        if s.cigar and s.cigar[-1][0] == FROM_S:
            s.cigar[-1] = (FROM_S, s.cigar[-1][1] + extra)
        else:
            if s.cigar is None:
                s.cigar = [(FROM_M, s.len)]
            s.cigar = list(s.cigar) + [(FROM_S, extra)]
    else:
        if s.cigar and s.cigar[0][0] == FROM_S:
            s.cigar[0] = (FROM_S, s.cigar[0][1] + extra)
        else:
            if s.cigar is None:
                s.cigar = [(FROM_M, s.len)]
            s.cigar = [(FROM_S, extra)] + list(s.cigar)
    s.len = r.full_len


def _refine_jobs(jobs, pac, l_pac, use_device, is_end_correct=True):
    """Solve a list of (apply, seq_codes, pos, ext) refinement jobs —
    device-batched banded-global DPs, scalar fallback."""
    paths = [None] * len(jobs)
    if use_device and jobs:
        from ..ops.dp import banded_global_batch
        pairs = [refine_window(l_pac, pac, seqc, pos, ext,
                               is_end_correct)[0:1] + (np.asarray(seqc),)
                 for _, seqc, pos, ext in jobs]
        paths = [p for _, p in banded_global_batch(pairs, ALN_PARAM_BWA)]
    for (apply, seqc, pos, ext), path in zip(jobs, paths):
        cig, newpos = refine_gapped_core(l_pac, pac, seqc, pos, ext,
                                         is_end_correct, path=path)
        apply(cig, newpos)


def refine_gapped(bns, pac, states, use_device=True, ntpac=None):
    """bwa_refine_gapped (bwase.c:356-423).

    All gapped-refinement DPs of the batch run as ONE device
    banded-global call (ops.dp.banded_global_batch); use_device=False
    keeps the scalar host oracle path.  ntpac (unpacked nucleotide pac)
    switches on the color-space path (bwase.c:383-401): decode each read
    via cs2nt, re-refine every cigar against the nucleotide reference
    with is_end_correct=0, and compute MD/NM from ntpac; quality-trim
    correction is Illumina-only (bwase.c:418)."""
    jobs = []   # (apply, seq_codes, pos, ext)
    for s in states:
        r = s.read
        # s.seq was stored reversed; forward orientation for DP/MD
        fwd_codes = r.seq[::-1]
        for m in s.multi:
            if m["gap"] == 0:
                continue
            seqc = r.rseq if m["strand"] else fwd_codes

            def apply_m(cig, newpos, m=m):
                m["cigar"] = cig
                m["n_cigar"] = len(cig)
                m["pos"] = newpos

            jobs.append((apply_m, seqc, m["pos"],
                         (1 if m["strand"] else -1) * m["gap"]))
        if s.type in (BWA_TYPE_NO_MATCH, BWA_TYPE_MATESW) or s.n_gapo == 0:
            continue
        seqc = r.rseq if s.strand else fwd_codes

        def apply_s(cig, newpos, s=s):
            s.cigar = cig if cig else None
            s.pos = newpos

        jobs.append((apply_s, seqc, s.pos,
                     (1 if s.strand else -1) * (s.n_gapo + s.n_gape)))

    _refine_jobs(jobs, pac, bns.l_pac, use_device)

    if ntpac is not None:       # color space (bwase.c:383-401)
        from ..refmodel.cs2nt import cs2nt_core
        jobs2 = []
        for s in states:
            cs2nt_core(s, bns.l_pac, ntpac)
            r = s.read
            fwd_codes = r.seq[::-1]
            for m in s.multi:
                if m["gap"] == 0:
                    continue
                seqc = r.rseq if m["strand"] else fwd_codes

                def apply_m(cig, newpos, m=m):
                    m["cigar"] = cig
                    m["n_cigar"] = len(cig)
                    m["pos"] = newpos

                jobs2.append((apply_m, seqc, m["pos"],
                              (1 if m["strand"] else -1) * m["gap"]))
            if s.type != BWA_TYPE_NO_MATCH and s.cigar:

                def apply_s(cig, newpos, s=s):
                    s.cigar = cig if cig else None
                    s.pos = newpos

                jobs2.append((apply_s,
                              r.rseq if s.strand else fwd_codes, s.pos,
                              (1 if s.strand else -1)
                              * (s.n_gapo + s.n_gape)))
        _refine_jobs(jobs2, ntpac, bns.l_pac, use_device,
                     is_end_correct=False)

    md_pac = ntpac if ntpac is not None else pac
    from . import post_native
    if not post_native.md_states(states, bns, md_pac):
        for s in cal_md_batch(states, bns, md_pac):
            r = s.read
            seqc = r.rseq if s.strand else r.seq[::-1]
            s.md, s.nm = cal_md1(s.cigar, seqc, s.pos, bns, md_pac)

    if ntpac is None:   # trimming correction is Illumina-only
        for s in states:
            correct_trimmed(s)


def pos_end(s):
    """bwase.c:425-436."""
    if s.cigar:
        x = s.pos
        for op, ln in s.cigar:
            if op in (FROM_M, FROM_D):
                x += ln
        return x
    return s.pos + s.len


def pos_end_multi(m, length):
    if m["cigar"]:
        x = m["pos"]
        for op, ln in m["cigar"]:
            if op in (FROM_M, FROM_D):
                x += ln
        return x
    return m["pos"] + length


def pos_5(s):
    if s.type != BWA_TYPE_NO_MATCH:
        return pos_end(s) if s.strand else s.pos
    return -1


def coor_pac2real(bns, pac_coor, length):
    """bns_coor_pac2real (bntseq.c:272-306): (seqid, nn)."""
    anns = bns.anns
    left, mid, right = 0, 0, bns.n_seqs
    while left < right:
        mid = (left + right) >> 1
        if pac_coor >= anns[mid].offset:
            if mid == bns.n_seqs - 1:
                break
            if pac_coor < anns[mid + 1].offset:
                break
            left = mid + 1
        else:
            right = mid
    seqid = mid
    # hole overlap count (single overlapping hole, as in the reference)
    left, right = 0, bns.n_holes
    nn = 0
    holes = bns.ambs
    while left < right:
        hmid = (left + right) >> 1
        h = holes[hmid]
        if pac_coor >= h.offset + h.length:
            left = hmid + 1
        elif pac_coor + length <= h.offset:
            right = hmid
        else:
            if pac_coor >= h.offset:
                nn += (h.offset + h.length - pac_coor
                       if h.offset + h.length < pac_coor + length else length)
            else:
                nn += (h.length if h.offset + h.length < pac_coor + length
                       else length - (h.offset - pac_coor))
            break
    return seqid, nn


def coor_pac2real_batch(bns, pos_arr, len_arr):
    """Vectorized bns_coor_pac2real over a chunk: one searchsorted for the
    seqid, nn=0 fast path when no ambiguity hole touches the window, exact
    scalar bisect replay for the (rare) rows that touch one."""
    ann_off, amb_off, amb_end = _bns_arrays(bns)
    pos = np.asarray(pos_arr, dtype=np.int64)
    ln = np.asarray(len_arr, dtype=np.int64)
    seqid = np.searchsorted(ann_off, pos, side="right") - 1
    seqid = np.clip(seqid, 0, bns.n_seqs - 1)
    nn = np.zeros(len(pos), dtype=np.int64)
    if len(amb_off):
        idx = np.searchsorted(amb_end, pos, side="right")
        idxc = np.minimum(idx, len(amb_off) - 1)
        touch = (idx < len(amb_off)) & (amb_off[idxc] < pos + ln)
        for i in np.flatnonzero(touch).tolist():
            _, nn_i = coor_pac2real(bns, int(pos[i]), int(ln[i]))
            nn[i] = nn_i
    return seqid.tolist(), nn.tolist()


CIGAR_CHR = "MIDS"
_FWD_BASES = "ACGTN"
_REV_BASES = "TGCAN"
_FWD_TAB = bytes.maketrans(bytes(range(5)), b"ACGTN")
_REV_TAB = bytes.maketrans(bytes(range(5)), b"TGCAN")


def print_sam1(bns, s, mate, mode, max_top2, rg_id=None, pre=None):
    """bwa_print_sam1 (bwase.c:458-592) — returns one SAM line (no \\n).
    pre: optional precomputed (seqid, nn) for s (coor_pac2real_batch)."""
    r = s.read
    out = []
    if s.type != BWA_TYPE_NO_MATCH or (mate and mate.type != BWA_TYPE_NO_MATCH):
        flag = s.extra_flag
        if s.type == BWA_TYPE_NO_MATCH:
            s.pos = mate.pos
            s.strand = mate.strand
            flag |= SAM_FSU
            flag &= ~SAM_FPP
            j = 1
        else:
            j = pos_end(s) - s.pos
        seqid, nn = pre if pre is not None \
            else coor_pac2real(bns, s.pos, j)
        if (s.type != BWA_TYPE_NO_MATCH
                and s.pos + j - bns.anns[seqid].offset > bns.anns[seqid].length):
            flag |= SAM_FSU  # bridges two reference sequences
            flag &= ~SAM_FPP
            s.mapQ = 0
        if s.strand:
            flag |= SAM_FSR
        m_seqid = -1
        am = 0
        if mate:
            if mate.type != BWA_TYPE_NO_MATCH:
                m_seqid, m_nn = coor_pac2real(bns, mate.pos, mate.len)
                nn += m_nn
                m_j = pos_end(mate) - mate.pos
                if (mate.pos + m_j - bns.anns[m_seqid].offset
                        > bns.anns[m_seqid].length):
                    flag |= SAM_FMU
                    flag &= ~SAM_FPP
                if mate.strand:
                    flag |= SAM_FMR
            else:
                flag |= SAM_FMU
                flag &= ~SAM_FPP
        out.append("%s\t%d\t%s\t" % (r.name, flag, bns.anns[seqid].name))
        out.append("%d\t%d\t" % (s.pos - bns.anns[seqid].offset + 1, s.mapQ))
        if s.cigar:
            out.append("".join("%d%c" % (ln, CIGAR_CHR[op])
                               for op, ln in s.cigar))
        elif s.type == BWA_TYPE_NO_MATCH:
            out.append("*")
        else:
            out.append("%dM" % s.len)
        if mate and mate.type != BWA_TYPE_NO_MATCH:
            am = min(mate.seQ, s.seQ)
            out.append("\t%s\t" % ("=" if seqid == m_seqid
                                   else bns.anns[m_seqid].name))
            isize = pos_5(mate) - pos_5(s) if seqid == m_seqid else 0
            if s.type == BWA_TYPE_NO_MATCH:
                isize = 0
            out.append("%d\t%d\t" % (mate.pos - bns.anns[m_seqid].offset + 1,
                                     isize))
        elif mate:
            out.append("\t=\t%d\t0\t" % (s.pos - bns.anns[seqid].offset + 1))
        else:
            out.append("\t*\t0\t0\t")
        # sequence & quality: seq codes were restored to original orientation
        full = np.asarray(r.full_codes, dtype=np.uint8)
        if s.strand == 0:
            out.append(full.tobytes().translate(_FWD_TAB).decode())
        else:
            out.append(full[::-1].tobytes().translate(_REV_TAB).decode())
        out.append("\t")
        out.append(_qual_str(s))
        if rg_id:
            out.append("\tRG:Z:%s" % rg_id)
        if r.bc:
            out.append("\tBC:Z:%s" % r.bc)
        if r.clip_len < r.full_len:
            out.append("\tXC:i:%d" % r.clip_len)
        if s.type != BWA_TYPE_NO_MATCH:
            xt = "NURM"[s.type]
            if nn > 10:
                xt = "N"
            out.append("\tXT:A:%c\t%s:i:%d"
                       % (xt, "NM" if mode & BWA_MODE_COMPREAD else "CM",
                          s.nm))
            if nn:
                out.append("\tXN:i:%d" % nn)
            if mate:
                out.append("\tSM:i:%d\tAM:i:%d" % (s.seQ, am))
            if s.type != BWA_TYPE_MATESW:
                out.append("\tX0:i:%d" % s.c1)
                if s.c1 <= max_top2:
                    out.append("\tX1:i:%d" % s.c2)
            out.append("\tXM:i:%d\tXO:i:%d\tXG:i:%d"
                       % (s.n_mm, s.n_gapo, s.n_gapo + s.n_gape))
            if s.md:
                out.append("\tMD:Z:%s" % s.md)
            if s.n_multi:
                out.append("\tXA:Z:")
                for m in s.multi:
                    jj = pos_end_multi(m, s.len) - m["pos"]
                    sid, _ = coor_pac2real(bns, m["pos"], jj)
                    out.append("%s,%c%d," % (bns.anns[sid].name,
                                             "-" if m["strand"] else "+",
                                             m["pos"] - bns.anns[sid].offset + 1))
                    if m["cigar"]:
                        out.append("".join("%d%c" % (ln, CIGAR_CHR[op])
                                           for op, ln in m["cigar"]))
                    else:
                        out.append("%dM" % s.len)
                    out.append(",%d;" % (m["gap"] + m["mm"]))
    else:  # no match at all
        flag = s.extra_flag | SAM_FSU
        if mate and mate.type == BWA_TYPE_NO_MATCH:
            flag |= SAM_FMU
        out.append("%s\t%d\t*\t0\t0\t*\t*\t0\t0\t" % (r.name, flag))
        # p->seq was reversed back to original orientation by refine_gapped
        # and len restored to full_len by correct_trimmed (bwase.c:570-575)
        seqc = (np.where(r.full_codes < 4, 3 - r.full_codes, r.full_codes)[::-1]
                if s.strand else r.full_codes)
        out.append("".join(_FWD_BASES[c] for c in seqc[:s.len]))
        out.append("\t")
        out.append(_qual_str(s))
        if rg_id:
            out.append("\tRG:Z:%s" % rg_id)
        if r.bc:
            out.append("\tBC:Z:%s" % r.bc)
        if r.clip_len < r.full_len:
            out.append("\tXC:i:%d" % r.clip_len)
        if mate and mate.type != BWA_TYPE_NO_MATCH:
            _, nn = coor_pac2real(bns, mate.pos, mate.len)
            if nn:
                out.append("\tXN:i:%d" % nn)
    return "".join(out)


def _qual_str(s):
    """Quality emission incl. the reference's reverse-first-len-only
    behaviour for trimmed reverse-strand reads (bwase.c:528-531)."""
    r = s.read
    if r.qual is None:
        return "*"
    q = bytearray(r.qual)
    if s.strand:
        # seq_reverse(p->len, p->qual, 0): reverse only the first len chars
        # (len may have been restored to full_len by correct_trimmed)
        n = min(s.len, len(q))
        q[:n] = q[:n][::-1]
    return q.decode("latin1")


def sam_header(bns, rg_line=None, version="0.5.10-evan.6.3-nabwa"):
    lines = []
    for a in bns.anns:
        lines.append("@SQ\tSN:%s\tLN:%d" % (a.name, a.length))
    if rg_line:
        lines.append(rg_line)
    lines.append("@PG\tID:bwa\tPN:bwa\tVN:%s" % version)
    return "\n".join(lines) + "\n"


def samse(engine, reads, per_read_alns, opt, n_occ=3, rng=None,
          rg_id=None, ntpac=None):
    """Core of samse for one chunk: returns list of SAM lines.  ntpac
    (the .nt nucleotide pac, bwa_open_nt bwase.c:594-602) switches on
    color-space decoding."""
    from ..utils.rand48 import Rand48

    bns = engine.index.bns
    pac = engine.index.pac
    if rng is None:
        rng = Rand48(bns.seed)
    states = []
    for r, alns in zip(reads, per_read_alns):
        s = SeqState(r)
        aln2seq_core(alns, s, rng, set_main=True, n_multi=n_occ)
        states.append(s)
    cal_pac_pos(engine, states, opt.max_diff, opt.fnr)
    refine_gapped(bns, pac, states, ntpac=ntpac)
    # one vectorized coor_pac2real pass for every matched state
    matched = [s for s in states if s.type != BWA_TYPE_NO_MATCH]
    pres = {}
    if matched:
        sid, nn = coor_pac2real_batch(
            bns, [s.pos for s in matched],
            [pos_end(s) - s.pos for s in matched])
        pres = {id(s): (i1, n1) for s, i1, n1 in zip(matched, sid, nn)}
    return [print_sam1(bns, s, None, opt.mode, opt.max_top2, rg_id=rg_id,
                       pre=pres.get(id(s)))
            for s in states]
