"""bam2bam workflow — the fork's flagship BAM→BAM pipeline (bam2bam.c),
single-host path.

Two-pass structure exactly like the sequential loop (bam2bam.c:1143-1219,
1761-1779): pass 1 aligns + positions every logical record (singleton or
pair) and accumulates per-read-group insert-size histograms
(insert_size.c:141-165); after the barrier (infer_all_isizes) pass 2 runs
pairing + mate rescue + gapped refinement and splices the new alignment back
into the ORIGINAL BAM records (bwa_update_bam1, bam2bam.c:430-593).

The device batch engine replaces the per-record bwa_cal_sa_reg_gap calls;
drand48 consumption stays in record order because sampling happens on host
after the batched search.  The ZeroMQ distribution of this pipeline maps to
chunk sharding over hosts + an isize-histogram reduction at the barrier
(SURVEY §2.7); this module is the single-host core those shards run.
"""

import math
import struct

import numpy as np

from ..constants import (BWA_TYPE_NO_MATCH, BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT,
                         BWA_TYPE_MATESW, BWA_AVG_ERR, SAM_FPD, SAM_FR1,
                         SAM_FR2, SAM_FPP, SAM_FSU, SAM_FMU, SAM_FSR,
                         SAM_FSC, SAM_FMR, SAM_FQC, SAM_FDP,
                         BWA_MODE_COMPREAD)
from ..io import bam as bamio
from ..io.bam import (BamRec, BAM_FPAIRED, BAM_FREAD1, BAM_FREAD2,
                      BAM_FUNMAP, REVCOM1, reg2bin)
from ..io.fastq import Read, trim_read
from ..refmodel.aln_scalar import cal_maxdiff
from ..refmodel.stdaln_scalar import FROM_M, FROM_I, FROM_D, FROM_S
from . import samse as se
from . import sampe as pe

MAX_ISIZE = 100000  # insert_size.c:47

EOF_KIND, SINGLETON, PROPER_PAIR = 0, 1, 2
PRISTINE, ALIGNED, POSITIONED, FINISHED = 0, 1, 2, 3


class Pair:
    """bam_pair_t (bwtaln.h:124-130)."""

    __slots__ = ("recno", "kind", "phase", "recs", "states", "alns", "hw",
                 "side")

    def __init__(self, kind, recs):
        self.kind = kind
        self.recs = recs
        self.phase = PRISTINE
        self.states = [None, None]
        self.alns = [None, None]
        self.hw = [0, 0]
        self.side = None      # pre-computed .sai alignments (sideload)

    def __getstate__(self):
        # recno is assigned after construction; tolerate unset slots
        return tuple(getattr(self, f, None) for f in Pair.__slots__)

    def __setstate__(self, st):
        for f, v in zip(Pair.__slots__, st):
            setattr(self, f, v)


def bam1_to_read(rec: BamRec, is_comp=True, trim_qual=0):
    """bam1_to_seq (bwaseqio.c:272-307) → io.fastq.Read."""
    codes = rec.seq_nt4().copy()
    quals = np.minimum(rec.quals().astype(np.int32) + 33, 126).astype(
        np.uint8)
    if rec.flag & SAM_FSR:  # stored reverse-complemented; recover the read
        codes = codes[::-1]
        codes = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
        quals = quals[::-1].copy()
    full_len = len(codes)
    ln = trim_read(trim_qual, codes, quals, full_len) if trim_qual >= 1 \
        else full_len
    fwd = codes[:ln]
    rseq = fwd[::-1].copy()
    if is_comp:
        rseq = np.where(rseq < 4, 3 - rseq, rseq).astype(np.uint8)
    return Read(name=rec.qname, seq=fwd[::-1].copy(), rseq=rseq, qual=quals,
                full_len=full_len, clip_len=ln, full_codes=codes, bc="")


def bam1_to_reads_batch(recs, is_comp=True, trim_qual=0):
    """bam1_to_read over a whole chunk: ONE nybble decode + qual clamp
    over the concatenated record bytes, per-read zero-copy views
    (bam1_to_seq per record was ~30% of pass-1, bwaseqio.c:272-307)."""
    n = len(recs)
    if n == 0:
        return []
    lq = np.empty(n, dtype=np.int64)
    seq_parts = []
    qual_parts = []
    for i, r in enumerate(recs):
        L = r.l_qseq
        lq[i] = L
        so = r.seq_off()
        nb = (L + 1) // 2
        mv = memoryview(r.data)
        seq_parts.append(mv[so:so + nb])
        qual_parts.append(mv[so + nb:so + nb + L])
    nb_arr = (lq + 1) // 2
    seq_cat = np.frombuffer(b"".join(seq_parts), dtype=np.uint8)
    q_cat = np.minimum(np.frombuffer(b"".join(qual_parts), dtype=np.uint8)
                       .astype(np.int16) + 33, 126).astype(np.uint8)
    dec = np.empty(seq_cat.size * 2, dtype=np.uint8)
    dec[0::2] = seq_cat >> 4
    dec[1::2] = seq_cat & 0xF
    dec = bamio.NT16_NT4[dec]
    dco = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(2 * nb_arr, out=dco[1:])
    qo = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lq, out=qo[1:])
    # restore original orientation for reverse-mapped inputs, in place
    for i, r in enumerate(recs):
        if r.flag & SAM_FSR:
            a, L = int(dco[i]), int(lq[i])
            codes = dec[a:a + L]
            tmp = codes[::-1].copy()
            codes[:] = np.where(tmp < 4, 3 - tmp, tmp)
            quals = q_cat[int(qo[i]):int(qo[i + 1])]
            quals[:] = quals[::-1].copy()
    comp = np.where(dec < 4, 3 - dec, dec).astype(np.uint8) if is_comp \
        else dec
    out = []
    for i, r in enumerate(recs):
        a, L = int(dco[i]), int(lq[i])
        codes = dec[a:a + L]
        quals = q_cat[int(qo[i]):int(qo[i + 1])]
        ln = trim_read(trim_qual, codes, quals, L) if trim_qual >= 1 \
            else L
        out.append(Read(name=r.qname, seq=codes[:ln][::-1],
                        rseq=comp[a:a + ln][::-1], qual=quals,
                        full_len=L, clip_len=ln, full_codes=codes, bc=""))
    return out


def try_get_sai(sai_streams, c):
    """try_get_sai (bwaseqio.c:323-338): pull the next record from sideload
    stream c; returns list-of-aln-dicts or None (stream absent/ended)."""
    import sys

    f = sai_streams.get(c) if sai_streams else None
    if f is None:
        return None
    hdr = f.read(4)
    if len(hdr) == 4:
        (naln,) = struct.unpack("<i", hdr)
        body = f.read(16 * naln) if naln >= 0 else b""
        if naln >= 0 and len(body) == 16 * naln:
            from ..io import sai as saiio
            recs = np.frombuffer(body, dtype=saiio.ALN_DTYPE)
            return saiio.aln_records_to_tuples(recs)
    print(f"[read_bam_pair] note: sai file {c} has ended.", file=sys.stderr)
    f.close()
    sai_streams[c] = None
    return None


def read_bam_pairs(reader, allow_broken=False, drop_aligned=False,
                   sai_streams=None):
    """read_bam_pair loop (bwaseqio.c:345-494).  Yields Pair objects.

    sai_streams: optional {0: f, 1: f, 2: f} of open .sai record streams
    (positioned past the header) — matching records enter the pipeline
    already in phase ALIGNED (bwaseqio.c:466-483)."""
    pending = None
    while True:
        rec = pending if pending is not None else reader.read1()
        pending = None
        if rec is None:
            return
        if not (rec.flag & BAM_FPAIRED):
            p = Pair(SINGLETON, [rec, None])
        else:
            mate = reader.read1()
            if mate is None:
                if allow_broken:
                    return
                raise IOError("got a paired read and hit EOF")
            f1 = rec.flag & (BAM_FPAIRED | BAM_FREAD1 | BAM_FREAD2)
            f2 = mate.flag & (BAM_FPAIRED | BAM_FREAD1 | BAM_FREAD2)
            if rec.qname == mate.qname:
                if f1 == (BAM_FPAIRED | BAM_FREAD1) and \
                        f2 == (BAM_FPAIRED | BAM_FREAD2):
                    p = Pair(PROPER_PAIR, [rec, mate])
                elif f2 == (BAM_FPAIRED | BAM_FREAD1) and \
                        f1 == (BAM_FPAIRED | BAM_FREAD2):
                    p = Pair(PROPER_PAIR, [mate, rec])
                elif allow_broken:
                    rec.flag = (rec.flag & ~BAM_FREAD2) | BAM_FPAIRED \
                        | BAM_FREAD1
                    mate.flag = (mate.flag & ~BAM_FREAD1) | BAM_FPAIRED \
                        | BAM_FREAD2
                    p = Pair(PROPER_PAIR, [rec, mate])
                else:
                    raise IOError("pair flags wrong for %s" % rec.qname)
            else:
                # lone mate: discard first, retry with second
                if not allow_broken:
                    raise IOError("lone mate %s" % rec.qname)
                pending = mate
                continue
        if drop_aligned:
            # skip while either end is already aligned (bwaseqio.c:469-473)
            aligned0 = not (p.recs[0].flag & BAM_FUNMAP)
            aligned1 = p.kind == PROPER_PAIR and \
                not (p.recs[1].flag & BAM_FUNMAP)
            if aligned0 or aligned1:
                continue
        # .sai sideload (bwaseqio.c:475-483)
        if sai_streams:
            if p.kind == SINGLETON:
                a0 = try_get_sai(sai_streams, 0)
                if a0 is not None:
                    p.side = [a0, None]
                    p.phase = ALIGNED
            else:
                a1 = try_get_sai(sai_streams, 1)
                a2 = try_get_sai(sai_streams, 2)
                if a1 is not None and a2 is not None:
                    p.side = [a1, a2]
                    p.phase = ALIGNED
        # QC-fail propagation (bwaseqio.c:486-489)
        if p.kind == PROPER_PAIR:
            p.recs[0].flag |= p.recs[1].flag & SAM_FQC
            p.recs[1].flag |= p.recs[0].flag & SAM_FQC
        for i in range(p.kind):
            erase_unwanted_tags(p.recs[i])
        yield p


def _tag_unwanted(a, b):
    return ((a in b"ASCN" and b == 77)            # ?M
            or (a == 77 and b == 68)              # MD
            or (a == 88 and chr(b) in "01ACGMNOT")  # X?
            or (a == 89 and b == 81))             # YQ


def erase_unwanted_tags(rec: BamRec):
    """erase_unwanted_tags (bwaseqio.c:413-464): drop AM NM CM SM MD X0 X1
    XA XC XG XM XN XO XT YQ.  Scan-first: typical unaligned input (RG/BC
    only) strips nothing, so the common case does no copies at all."""
    d = rec.data
    p = rec.aux_off()
    n = len(d)
    while p < n:
        if _tag_unwanted(d[p], d[p + 1]):
            break
        p = bamio._skip_tag(d, p)
    else:
        pass
    if p >= n:
        return
    out = bytearray(d[:p])
    while p < n:
        q = bamio._skip_tag(d, p)
        if not _tag_unwanted(d[p], d[p + 1]):
            out += d[p:q]
        p = q
    rec.data = out


def unique(p, skip_duplicates):
    """bam2bam.c:595-606."""
    if not skip_duplicates:
        return True
    if p.kind == SINGLETON:
        return not (p.recs[0].flag & SAM_FDP)
    return not (p.recs[0].flag & SAM_FDP) and \
        not (p.recs[1].flag & SAM_FDP)


def revcom_bam1(rec: BamRec):
    """revcom_bam1 (bam2bam.c:335-362)."""
    rec.flag ^= SAM_FSR
    off = rec.seq_off()
    nb = (rec.l_qseq + 1) // 2
    seg = bytes(rec.data[off:off + nb])
    rc = bytes(REVCOM1[b] for b in reversed(seg))
    rc = bytearray(rc)
    if rec.l_qseq & 1:  # shift by one nybble
        out = bytearray(nb)
        for i in range(nb - 1):
            out[i] = ((rc[i] & 0x0F) << 4) | ((rc[i + 1] & 0xF0) >> 4)
        out[nb - 1] = (rc[nb - 1] & 0x0F) << 4
        rc = out
    rec.data[off:off + nb] = rc
    qoff = rec.qual_off()
    rec.data[qoff:qoff + rec.l_qseq] = \
        rec.data[qoff:qoff + rec.l_qseq][::-1]


def resize_cigar(rec: BamRec, n_cigar):
    """bam_resize_cigar (bam2bam.c:407-414)."""
    off = rec.cigar_off()
    old_end = off + 4 * rec.n_cigar
    tail = rec.data[old_end:]
    rec.data = rec.data[:off] + bytearray(4 * n_cigar) + tail
    rec.n_cigar = n_cigar


_TAG_PREFIX = {}


def _tag_prefix(u, v, t):
    key = u + v + t
    pre = _TAG_PREFIX.get(key)
    if pre is None:
        pre = _TAG_PREFIX[key] = key.encode()
    return pre


def push_int(rec, u, v, x):
    rec.data += _tag_prefix(u, v, "i") + struct.pack("<I", x & 0xFFFFFFFF)


def push_char(rec, u, v, c):
    rec.data += _tag_prefix(u, v, "A") + c.encode()


def push_string(rec, u, v, s):
    rec.data += _tag_prefix(u, v, "Z") + s.encode() + b"\x00"


_CIG_BAM_OP = [0, 1, 2, 4]  # "\000\001\002\004" (bam2bam.c:469)


def update_bam1(out: BamRec, bns, s, mate, mode, max_top2, debug_bam=False):
    """bwa_update_bam1 (bam2bam.c:430-593)."""
    r = s.read
    if r.clip_len < r.full_len:
        push_int(out, "X", "C", r.clip_len)
    if getattr(s, "max_entries", 0) and debug_bam:
        push_int(out, "Y", "Q", s.max_entries)

    if s.type != BWA_TYPE_NO_MATCH or (mate and
                                       mate.type != BWA_TYPE_NO_MATCH):
        am = 0
        if s.type == BWA_TYPE_NO_MATCH:
            s.pos = mate.pos
            s.strand = mate.strand
            s.extra_flag |= SAM_FSU
            j = 1
        else:
            j = se.pos_end(s) - s.pos

        if s.strand != ((out.flag & SAM_FSR) != 0):
            revcom_bam1(out)
        out.flag &= ~(SAM_FPP | SAM_FSU | SAM_FMU | SAM_FSC | SAM_FMR)
        out.flag |= s.extra_flag

        seqid, nn = se.coor_pac2real(bns, s.pos, j)
        if s.type != BWA_TYPE_NO_MATCH and \
                s.pos + j - bns.anns[seqid].offset > bns.anns[seqid].length:
            out.flag |= SAM_FSU
            out.flag &= ~SAM_FPP
            s.mapQ = 0

        out.tid = seqid
        out.pos = s.pos - bns.anns[seqid].offset
        out.bin = reg2bin(s.pos - bns.anns[seqid].offset,
                          se.pos_end(s) - bns.anns[seqid].offset)
        out.qual = s.mapQ

        if s.cigar:
            resize_cigar(out, len(s.cigar))
            off = out.cigar_off()
            for i, (op, ln) in enumerate(s.cigar):
                struct.pack_into("<I", out.data, off + 4 * i,
                                 (ln << 4) | _CIG_BAM_OP[op])
        elif s.type == BWA_TYPE_NO_MATCH:
            resize_cigar(out, 0)
        else:
            resize_cigar(out, 1)
            struct.pack_into("<I", out.data, out.cigar_off(), s.len << 4)

        if mate and mate.type != BWA_TYPE_NO_MATCH:
            am = min(mate.seQ, s.seQ)
            m_seqid, m_nn = se.coor_pac2real(bns, mate.pos, mate.len)
            nn += m_nn
            m_j = se.pos_end(mate) - mate.pos
            if mate.pos + m_j - bns.anns[m_seqid].offset \
                    > bns.anns[m_seqid].length:
                out.flag |= SAM_FMU
                out.flag &= ~SAM_FPP
            if mate.strand:
                out.flag |= SAM_FMR
            out.mtid = m_seqid
            out.mpos = mate.pos - bns.anns[m_seqid].offset
            if s.type == BWA_TYPE_NO_MATCH:
                out.isize = 0
            else:
                out.isize = (se.pos_5(mate) - se.pos_5(s)) \
                    if seqid == m_seqid else 0
        elif mate:
            out.flag |= SAM_FMU
            out.flag &= ~SAM_FPP
            out.mtid = seqid
            out.mpos = s.pos - bns.anns[seqid].offset
            out.isize = 0
        else:
            out.mtid = -1
            out.mpos = -1
            out.isize = 0

        if s.type != BWA_TYPE_NO_MATCH:
            xt = "NURM"[s.type]
            if nn > 10:
                xt = "N"
            push_char(out, "X", "T", xt)
            if mode & BWA_MODE_COMPREAD:
                push_int(out, "N", "M", s.nm)
            else:
                push_int(out, "C", "M", s.nm)
            if nn:
                push_int(out, "X", "N", nn)
            if mate:
                push_int(out, "S", "M", s.seQ)
                push_int(out, "A", "M", am)
            if s.type != BWA_TYPE_MATESW:
                push_int(out, "X", "0", s.c1)
                if s.c1 <= max_top2:
                    push_int(out, "X", "1", s.c2)
            push_int(out, "X", "M", s.n_mm)
            push_int(out, "X", "O", s.n_gapo)
            push_int(out, "X", "G", s.n_gapo + s.n_gape)
            if s.md:
                push_string(out, "M", "D", s.md)
            if s.n_multi:
                parts = []
                for m in s.multi:
                    jj = se.pos_end_multi(m, s.len) - m["pos"]
                    sid, _ = se.coor_pac2real(bns, m["pos"], jj)
                    parts.append("%s,%c%d," % (
                        bns.anns[sid].name, "-" if m["strand"] else "+",
                        m["pos"] - bns.anns[sid].offset + 1))
                    if m["cigar"]:
                        parts.append("".join(
                            "%d%c" % (ln, se.CIGAR_CHR[op])
                            for op, ln in m["cigar"]))
                    else:
                        parts.append("%dM" % s.len)
                    parts.append(",%d;" % (m["gap"] + m["mm"]))
                push_string(out, "X", "A", "".join(parts))
    else:  # no match at all
        out.tid = -1
        out.pos = -1
        out.bin = 0
        out.qual = 0
        out.mtid = -1
        out.mpos = -1
        out.isize = 0
        out.flag &= ~(SAM_FPP | SAM_FMU | SAM_FSC)
        out.flag |= SAM_FSU
        if mate and mate.type == BWA_TYPE_NO_MATCH:
            out.flag |= SAM_FMU
        resize_cigar(out, 0)
        if mate and mate.type != BWA_TYPE_NO_MATCH:
            _, nn = se.coor_pac2real(bns, mate.pos, mate.len)
            if nn:
                push_int(out, "X", "N", nn)


def infer_isize_hist(hist, ap_prior, L, rg=None, report=True):
    """infer_isize_hist (insert_size.c:50-139).  hist: int array MAX_ISIZE.
    Returns IsizeInfo or None (unusable).  Prints the reference's
    [infer_isize] report lines (insert_size.c:65-67,129-137) when
    report=True."""
    import sys

    rg_s = rg if rg else "(null)"
    ii = pe.IsizeInfo()
    tot = int(hist.sum())
    if tot < 20:
        if report:
            print(f"[infer_isize] {rg_s}: too few good pairs",
                  file=sys.stderr)
        return None
    cum = 0
    p25 = p50 = p75 = 0
    for i in range(MAX_ISIZE):
        cum2 = cum + int(hist[i])
        if cum <= tot * 0.25 + 0.5 < cum2:
            p25 = i
        if cum <= tot * 0.50 + 0.5 < cum2:
            p50 = i
        if cum <= tot * 0.75 + 0.5 < cum2:
            p75 = i
        cum = cum2
    tmp = int(p25 - pe.OUTLIER_BOUND * (p75 - p25) + .499)
    ii.low = tmp if tmp > 1 else 1
    ii.high = int(p75 + pe.OUTLIER_BOUND * (p75 - p25) + .499)
    n = 0
    x = 0
    for i in range(MAX_ISIZE):
        if ii.low <= i <= ii.high:
            n += int(hist[i])
            x += int(hist[i]) * i
    ii.avg = x / n
    std_acc = -1.0  # ii->std initialised to -1.0 (insert_size.c:60,100)
    skew = kurt = 0.0
    for i in range(MAX_ISIZE):
        if ii.low <= i <= ii.high and hist[i]:
            t = (i - ii.avg) * (i - ii.avg)
            std_acc += t * int(hist[i])
            skew += t * (i - ii.avg) * int(hist[i])
            kurt += t * t * int(hist[i])
    kurt = kurt / n / (std_acc / n * std_acc / n) - 3
    ii.std = math.sqrt(std_acc / n)
    skew = skew / n / (ii.std * ii.std * ii.std)
    y = 1.0
    while y < 10.0:
        if .5 * math.erfc(y / math.sqrt(2)) < ap_prior / L * (
                y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + .499)
    n_ap = int(hist[ii.high_bayesian + 1:].sum()) \
        if ii.high_bayesian + 1 < MAX_ISIZE else 0
    ii.ap_prior = .01 * (n_ap + .01) / tot
    if ii.ap_prior < ap_prior:
        ii.ap_prior = ap_prior
    if report:
        print(f"[infer_isize] {rg_s}: qu({p25}, {p50}, {p75})",
              file=sys.stderr, end="")
    if math.isnan(ii.std) or p75 > MAX_ISIZE:
        if report:
            print(" -- not useable", file=sys.stderr)
        return None
    if report:
        print(" bound(%d,%d), num/avg/std/kur/skw %d/%.3f/%.3f/%.3f/%.3f,"
              " ap %.2e, max %d, %.2f sigma"
              % (ii.low, ii.high, n, ii.avg, ii.std, skew, kurt,
                 ii.ap_prior, ii.high_bayesian, y), file=sys.stderr)
    return ii


class NullIsize(pe.IsizeInfo):
    """static null_ii — zero-initialised (bam2bam.c globals)."""

    def __init__(self):
        super().__init__()
        self.avg = 0.0
        self.std = 0.0
        self.ap_prior = 0.0


def improve_isize_est(hists, p, ap_prior, L):
    """improve_isize_est (insert_size.c:141-165)."""
    s = p.states
    if p.kind < 1 or s[0].mapQ < 20:
        return
    if p.kind > 1 and s[1].mapQ < 20:
        return
    if p.kind == 1:
        ln = s[0].len
    elif s[0].pos < s[1].pos:
        ln = s[1].pos + s[1].len - s[0].pos
    else:
        ln = s[0].pos + s[0].len - s[1].pos
    if ln < 0 or ln >= MAX_ISIZE:
        return
    rg = p.recs[0].get_rg()
    h = hists.get(rg)
    if h is None:
        h = np.zeros(MAX_ISIZE, dtype=np.int64)
        hists[rg] = h
    h[ln] += 1


def pass1_work(engine, gopt, payload):
    """Phase-1 chunk job (align): build per-record read states and run the
    device DFS.  Pure: returns data for the coordinator's ordered writer.
    Runs identically on local worker threads and remote `worker`
    processes (pair_aln, bam2bam.c:882-909)."""
    out = []
    jobs = []
    all_recs = [recs[j] for pi, kind, recs, uniq, side in payload["items"]
                for j in range(kind)]
    all_reads = bam1_to_reads_batch(all_recs, True, gopt.trim_qual)
    ri = 0
    for pi, kind, recs, uniq, side in payload["items"]:
        states = [se.SeqState(all_reads[ri + j]) for j in range(kind)]
        ri += kind
        out.append((pi, kind, states, side))
        if uniq and side is None:
            for j in range(kind):
                jobs.append((len(out) - 1, j))
    reads = [out[oi][2][j].read for oi, j in jobs]
    results = engine.run_chunk(reads, per_read_semantics=True)
    alns = [[[] for _ in range(kind)] for pi, kind, _, _ in out]
    hws = [[0, 0] for _ in out]
    for i, (pi, kind, states, side) in enumerate(out):
        if side is not None:       # pre-computed .sai (phase aligned)
            for j in range(kind):
                alns[i][j] = side[j]
    for (oi, j), (a, hw) in zip(jobs, results):
        alns[oi][j] = a
        hws[oi][j] = hw
    return [(pi, states, alns[i], hws[i])
            for i, (pi, kind, states, _) in enumerate(out)]


def pass2_work(engine, gopt, popt, iinfos, payload):
    """Phase-2 chunk job (finish): pairing + mate rescue + refinement +
    BAM splice.  Columnar native pipeline when the C++ kernels are
    available (states -> one [R,NF] matrix, batch pairing/multi/refine/
    MD, native BAM splice into FRESH records — idempotent without deep
    clones); the per-object path below is the oracle/fallback.
    Runs identically on local threads and remote workers (pair_finish,
    bam2bam.c:882-909)."""
    import os as _os
    from ..index import native as _native_mod
    if (_native_mod._load() is not None
            and not _os.environ.get("NABWA_B2B_OBJ")):
        return _pass2_work_columnar(engine, gopt, popt, iinfos, payload)
    return _pass2_work_obj(engine, gopt, popt, iinfos, payload)


def _pass2_work_obj(engine, gopt, popt, iinfos, payload):
    """Per-object pass-2 (the original pipeline; byte-identical oracle
    for _pass2_work_columnar, and the no-native fallback)."""
    import copy as _copy

    bns = engine.index.bns
    pac = engine.index.pac
    skip_duplicates = payload["skip_duplicates"]
    debug_bam = payload["debug_bam"]
    null_ii = NullIsize()
    # Three sweeps over the chunk so the heavy DPs batch on device:
    # (1) pairing + multi-hit expansion per record, collecting the mate-
    # rescue jobs; (2) ONE batched rescue (paired_sw_batch) and ONE
    # batched gapped refinement across all states; (3) BAM splicing.
    # Per-record results are unchanged — pairing/refine/update are pure
    # per pair, and phase B consumes no drand48 (sampling ran in order at
    # the posn phase, mirroring the reference's worker split).
    out = []
    pos_memo = {}
    counters = {"n_tot": [0, 0], "n_mapped": [0, 0]}
    rescue_pairs = []
    rescue_iis = []
    refine_states = []
    done = []
    pairs_todo = []
    for pi, pair in payload["items"]:
        p = _clone_pair(pair)
        if unique(p, skip_duplicates):
            if p.kind == SINGLETON:
                refine_states.append(p.states[0])
            else:
                pairs_todo.append(p)
            done.append(p)
        out.append((pi, p))
    # pairing-expansion SA lookups batch once per chunk (a per-hit device
    # call costs a link round trip per RECORD and a fresh while_loop
    # lowering per interval width — measured minutes/chunk)
    positions = _expand_positions_batch(engine, pairs_todo, popt, pos_memo)
    multi_jobs = []
    multi_refs = []
    for idx, p in enumerate(pairs_todo):
        ii = _finish_pair_pre(engine, bns, pac, p, gopt, popt, iinfos,
                              null_ii, positions.get(idx), multi_jobs,
                              multi_refs)
        rescue_pairs.append((p.states[0], p.states[1]))
        rescue_iis.append(ii)
        refine_states.extend((p.states[0], p.states[1]))
    if multi_jobs:
        vals = _batch_positions(engine, multi_jobs)
        for m, v in zip(multi_refs, vals):
            m["pos"] = int(v)
    if rescue_pairs:
        pe.paired_sw_batch(bns, pac, rescue_pairs, popt, rescue_iis,
                           counters)
    se.refine_gapped(bns, pac, refine_states)
    for p in done:
        if p.kind == SINGLETON:
            update_bam1(p.recs[0], bns, p.states[0], None, engine.opt.mode,
                        engine.opt.max_top2, debug_bam=debug_bam)
        else:
            s = p.states
            update_bam1(p.recs[0], bns, s[0], s[1], gopt.mode,
                        gopt.max_top2, debug_bam=debug_bam)
            update_bam1(p.recs[1], bns, s[1], s[0], gopt.mode,
                        gopt.max_top2, debug_bam=debug_bam)
    return [(pi, p.recs[:p.kind]) for pi, p in out], counters


def _pass2_work_columnar(engine, gopt, popt, iinfos, payload):
    """Columnar pass-2: one [R, NF] int64 state matrix over the chunk
    (paired rows first, interleaved ends; singletons after), the native
    pairing/multi kernels, proxy-based mate rescue, columnar refine/MD/
    trim, and the native BAM splice (bam_update_batch) into FRESH
    records.  Byte-identical with _pass2_work_obj — pinned by
    tests/test_bam2bam*.py and the NABWA_B2B_OBJ A/B escape."""
    from ..constants import BWA_PET_STD, BWA_PET_SOLID
    from ..index import native as native_mod
    from . import post_native as pn
    from .post_native import (NF, F_TYPE, F_STRAND, F_POS, F_MAPQ,
                              F_SEQ_Q, F_C1, F_C2, F_NMM, F_NGO, F_NGE,
                              F_NM, F_LEN, F_FULL_LEN, F_CLIP_LEN,
                              F_XFLAG, F_SA, F_SCORE)
    lib = native_mod._load()
    if popt.type not in (BWA_PET_STD, BWA_PET_SOLID):
        return _pass2_work_obj(engine, gopt, popt, iinfos, payload)
    bns = engine.index.bns
    pac = engine.index.pac
    skip_duplicates = payload["skip_duplicates"]
    debug_bam = payload["debug_bam"]
    null_ii = NullIsize()
    counters = {"n_tot": [0, 0], "n_mapped": [0, 0]}

    out = []
    paired = []
    singles = []
    done = set()
    for pi, p in payload["items"]:
        out.append((pi, p))
        if unique(p, skip_duplicates):
            done.add(id(p))
            (singles if p.kind == SINGLETON else paired).append(p)
    n_p = len(paired)

    rows_states = []
    rows_reads = []
    row_alns = []
    for p in paired:
        for j in (0, 1):
            s = p.states[j]
            rows_states.append(s)
            rows_reads.append(s.read)
            row_alns.append(p.alns[j] or [])
    for p in singles:
        s = p.states[0]
        rows_states.append(s)
        rows_reads.append(s.read)
        row_alns.append(p.alns[0] or [])
    R = len(rows_states)
    if R == 0:
        return [(pi, p.recs[:p.kind]) for pi, p in out], counters

    state = np.zeros((R, NF), dtype=np.int64)
    for fi, attr in ((F_TYPE, "type"), (F_STRAND, "strand"),
                     (F_POS, "pos"), (F_MAPQ, "mapQ"), (F_SEQ_Q, "seQ"),
                     (F_C1, "c1"), (F_C2, "c2"), (F_NMM, "n_mm"),
                     (F_NGO, "n_gapo"), (F_NGE, "n_gape"),
                     (F_XFLAG, "extra_flag"), (F_SA, "sa"),
                     (F_SCORE, "score"), (F_LEN, "len")):
        state[:, fi] = [getattr(s, attr) for s in rows_states]
    state[:, F_FULL_LEN] = [r.full_len for r in rows_reads]
    state[:, F_CLIP_LEN] = [r.clip_len for r in rows_reads]
    lens = state[:, F_LEN]
    recs_flat, hit_counts = pn._pack_recs(row_alns)
    hit_off = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(hit_counts, out=hit_off[1:])

    # --- pairing over the interleaved paired region ---
    if n_p:
        ii_list = [iinfos.get(p.recs[0].get_rg(), null_ii)
                   for p in paired]
        flat_keys, key_off = pn.build_pair_keys(
            engine, state, recs_flat, hit_counts, hit_off, n_p,
            popt.max_occ, {})
        pet = 0 if popt.type == BWA_PET_STD else 1
        lib.pe_pairing_batch(
            n_p, flat_keys, key_off, recs_flat, 4 * hit_off,
            state.reshape(-1), pet, popt.max_isize, gopt.s_mm,
            np.array([ii.high for ii in ii_list], dtype=np.int64),
            np.array([ii.high_bayesian for ii in ii_list],
                     dtype=np.int64),
            np.array([ii.avg for ii in ii_list], dtype=np.float64),
            np.array([ii.std for ii in ii_list], dtype=np.float64))

    # --- multi hits (paired rows only, bam2bam.c:705-811) ---
    stride = 1
    multi_pos = np.zeros(R, dtype=np.uint64)
    multi_gap = np.zeros(R, dtype=np.int32)
    multi_mm = np.zeros(R, dtype=np.int32)
    multi_strand = np.zeros(R, dtype=np.int32)
    multi_n = np.zeros(R, dtype=np.int32)
    if (popt.N_multi or popt.n_multi) and n_p:
        n2 = 2 * n_p
        typ2 = state[:n2, F_TYPE]
        mate_typ = typ2.reshape(n_p, 2)[:, ::-1].reshape(-1)
        fpp = (state[:n2, F_XFLAG] & SAM_FPP) != 0
        cond = (~fpp) & (mate_typ != BWA_TYPE_NO_MATCH)
        nm = np.where(cond,
                      np.where(state[:n2, F_C1] + state[:n2, F_C2] - 1
                               > popt.N_multi, popt.n_multi,
                               popt.N_multi),
                      popt.n_multi)
        nm = np.where(typ2 != BWA_TYPE_NO_MATCH, nm, 0).astype(np.int32)
        nm_full = np.zeros(R, dtype=np.int32)
        nm_full[:n2] = nm
        stride = int(max(popt.n_multi, popt.N_multi)) + 1
        multi_pos = np.zeros(R * stride, dtype=np.uint64)
        multi_gap = np.zeros(R * stride, dtype=np.int32)
        multi_mm = np.zeros(R * stride, dtype=np.int32)
        multi_strand = np.zeros(R * stride, dtype=np.int32)
        lib.se_multi_batch(R, recs_flat, hit_counts, state.reshape(-1),
                           nm_full, stride, multi_pos, multi_gap,
                           multi_mm, multi_strand, multi_n)

    mrows = np.nonzero(multi_n)[0]
    mslot, mlen = [], []
    for i in mrows.tolist():
        for m in range(multi_n[i]):
            mslot.append(i * stride + m)
            mlen.append(lens[i])
    mslot = np.array(mslot, dtype=np.int64)
    mlen = np.array(mlen, dtype=np.int64)
    rev_len = engine.index.rev.seq_len
    if len(mslot):
        m_strand = multi_strand[mslot] != 0
        for a in (1, 0):
            msel = m_strand if a else ~m_strand
            if not msel.any():
                continue
            vals = engine.sa_rows(
                a, multi_pos[mslot[msel]].astype(np.uint32)) \
                .astype(np.int64)
            if a:
                multi_pos[mslot[msel]] = vals.astype(np.uint64)
            else:
                multi_pos[mslot[msel]] = \
                    ((rev_len - (vals + mlen[msel])) & 0xFFFFFFFF) \
                    .astype(np.uint64)

    # --- mate rescue via per-candidate proxies (bwa_paired_sw) ---
    cigars = {}
    if n_p:
        p0v = state[0:2 * n_p:2]
        p1v = state[1:2 * n_p:2]
        mq_pair = np.maximum(p0v[:, F_MAPQ], p1v[:, F_MAPQ])
        cand = np.nonzero((mq_pair >= pe.SW_MIN_MAPQ)
                          & ((p0v[:, F_XFLAG] & SAM_FPP) == 0))[0]
        if len(cand):
            prox = []
            for i in cand.tolist():
                pp = []
                for row in (2 * i, 2 * i + 1):
                    s = se.SeqState(rows_reads[row])
                    st = state[row]
                    s.type = int(st[F_TYPE])
                    s.strand = int(st[F_STRAND])
                    s.pos = int(st[F_POS])
                    s.mapQ = int(st[F_MAPQ])
                    s.seQ = int(st[F_SEQ_Q])
                    s.n_mm = int(st[F_NMM])
                    s.n_gapo = int(st[F_NGO])
                    s.n_gape = int(st[F_NGE])
                    s.extra_flag = int(st[F_XFLAG])
                    s.len = int(st[F_LEN])
                    pp.append(s)
                prox.append((i, pp))
            pe.paired_sw_batch(bns, pac, [pp for _, pp in prox], popt,
                               [ii_list[i] for i, _ in prox], counters)
            for i, pp in prox:
                for j, s in enumerate(pp):
                    row = 2 * i + j
                    st = state[row]
                    st[F_TYPE] = s.type
                    st[F_STRAND] = s.strand
                    st[F_POS] = s.pos
                    st[F_MAPQ] = s.mapQ
                    st[F_SEQ_Q] = s.seQ
                    st[F_NMM] = s.n_mm
                    st[F_NGO] = s.n_gapo
                    st[F_NGE] = s.n_gape
                    st[F_XFLAG] = s.extra_flag
                    if s.cigar:
                        cigars[row] = s.cigar

    # --- gapped refinement (bwa_refine_gapped) ---
    mcigars = {}
    jobs = []
    fwd_cache = {}
    strand = state[:, F_STRAND] != 0

    def fwd_codes(i):
        c = fwd_cache.get(i)
        if c is None:
            c = rows_reads[i].seq[::-1]
            fwd_cache[i] = c
        return c

    for o in mslot.tolist():
        if multi_gap[o] == 0:
            continue
        i = o // stride
        seqc = rows_reads[i].rseq if multi_strand[o] else fwd_codes(i)

        def apply_m(cig, newpos, o=o):
            mcigars[o] = cig
            multi_pos[o] = newpos

        jobs.append((apply_m, seqc, int(multi_pos[o]),
                     (1 if multi_strand[o] else -1) * int(multi_gap[o])))
    typ = state[:, F_TYPE]
    gap_rows = np.nonzero((typ != BWA_TYPE_NO_MATCH)
                          & (typ != BWA_TYPE_MATESW)
                          & (state[:, F_NGO] > 0))[0]
    for i in gap_rows.tolist():
        seqc = rows_reads[i].rseq if strand[i] else fwd_codes(i)

        def apply_s(cig, newpos, i=i):
            cigars[i] = cig if cig else None
            state[i, F_POS] = newpos

        jobs.append((apply_s, seqc, int(state[i, F_POS]),
                     (1 if strand[i] else -1)
                     * int(state[i, F_NGO] + state[i, F_NGE])))
    se._refine_jobs(jobs, pac, bns.l_pac, use_device=True)

    # --- MD/NM ---
    seq_chunks = [(rows_reads[i].rseq if strand[i] else fwd_codes(i))
                  for i in range(R)]
    seq_flat, seq_off = pn._flat(seq_chunks)
    cig_counts = np.zeros(R, dtype=np.int64)
    for i, cg in cigars.items():
        if cg:
            cig_counts[i] = 2 * len(cg)
    cig_off = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(cig_counts, out=cig_off[1:])
    cig = np.zeros(int(cig_off[-1]), dtype=np.int32)
    for i, cg in cigars.items():
        if cg:
            cig[cig_off[i]:cig_off[i + 1]] = \
                np.array(cg, dtype=np.int32).reshape(-1)
    ann_off, ann_len, ann_names, ann_name_off, amb_off, amb_len, \
        amb_chr = pn._bns_emit_arrays(bns)
    md_cap = int(seq_off[-1]) * 2 + 24 * R + 16
    md_buf = np.empty(md_cap, dtype=np.uint8)
    md_off = np.zeros(R + 1, dtype=np.int64)
    rc = lib.md_batch(R, state.reshape(-1), seq_flat, seq_off, cig,
                      cig_off, np.ascontiguousarray(pac, dtype=np.uint8),
                      bns.l_pac, len(bns.ambs), amb_off, amb_len,
                      amb_chr, md_buf, md_cap, md_off,
                      pn._post_threads())
    if rc != 0:
        raise RuntimeError("pass2 columnar: md_batch failed")

    # --- quality-trim cigar correction (every read, bwase.c:418) ---
    trimmed = np.nonzero(lens < state[:, F_FULL_LEN])[0]
    for i in trimmed.tolist():
        s = se.SeqState(rows_reads[i])
        s.strand = int(state[i, F_STRAND])
        s.cigar = list(cigars[i]) if cigars.get(i) else None
        s.len = int(state[i, F_LEN])
        se.correct_trimmed(s)
        cigars[i] = s.cigar
        state[i, F_LEN] = s.len

    # --- native BAM splice into fresh records ---
    mate_idx = np.full(R, -1, dtype=np.int64)
    if n_p:
        mate_idx[:2 * n_p] = np.arange(2 * n_p, dtype=np.int64) ^ 1
    rec_objs = [p.recs[j] for p in paired for j in (0, 1)] \
        + [p.recs[0] for p in singles]
    in_flag = np.array([r.flag for r in rec_objs], dtype=np.int64)
    in_l_qname = np.array([r.l_qname for r in rec_objs], dtype=np.int64)
    in_n_cigar = np.array([r.n_cigar for r in rec_objs], dtype=np.int64)
    in_l_qseq = np.array([r.l_qseq for r in rec_objs], dtype=np.int64)
    in_data, in_off = pn._flat([r.data for r in rec_objs])

    # rebuild flat cigars post-trim, multi cigars appended (emit layout)
    cig_counts[:] = 0
    for i, cg in cigars.items():
        if cg:
            cig_counts[i] = 2 * len(cg)
    mcig_counts = np.zeros(R * stride, dtype=np.int64)
    for o, cg in mcigars.items():
        if cg:
            mcig_counts[o] = 2 * len(cg)
    roff = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(cig_counts, out=roff[1:])
    moff = np.zeros(R * stride + 1, dtype=np.int64)
    np.cumsum(mcig_counts, out=moff[1:])
    moff += roff[-1]
    cig = np.zeros(int(moff[-1]), dtype=np.int32)
    for i, cg in cigars.items():
        if cg:
            cig[roff[i]:roff[i + 1]] = \
                np.array(cg, dtype=np.int32).reshape(-1)
    for o, cg in mcigars.items():
        if cg:
            cig[moff[o]:moff[o + 1]] = \
                np.array(cg, dtype=np.int32).reshape(-1)
    cig_off_full = np.concatenate([roff, moff])

    max_ent = np.array([getattr(s, "max_entries", 0) or 0
                        for s in rows_states], dtype=np.int32)
    out_fields = np.zeros((R, 9), dtype=np.int64)
    out_off = np.zeros(R + 1, dtype=np.int64)
    cap = (int(in_off[-1]) + int(md_off[-1]) + 200 * R
           + 64 * int(multi_n.sum()) + 1024)
    blob = np.empty(cap, dtype=np.uint8)
    args = (R, state.reshape(-1), mate_idx,
            in_flag, in_l_qname, in_n_cigar, in_l_qseq, in_data, in_off,
            cig, cig_off_full, md_buf, md_off,
            multi_pos, multi_gap, multi_mm, multi_strand, multi_n,
            stride, max_ent, 1 if debug_bam else 0,
            bns.n_seqs, ann_off, ann_len, ann_names, ann_name_off,
            len(bns.ambs), amb_off, amb_len, bns.l_pac,
            gopt.mode, gopt.max_top2)
    total = lib.bam_update_batch(*args, out_fields.reshape(-1), blob,
                                 cap, out_off)
    if total > cap:
        blob = np.empty(int(total), dtype=np.uint8)
        total = lib.bam_update_batch(*args, out_fields.reshape(-1),
                                     blob, int(total), out_off)

    def mk_rec(row, old):
        nr = BamRec()
        nr.l_qname = old.l_qname
        nr.l_qseq = old.l_qseq
        f = out_fields[row]
        nr.flag = int(f[0])
        nr.tid = int(f[1])
        nr.pos = int(f[2])
        nr.bin = int(f[3])
        nr.qual = int(f[4])
        nr.mtid = int(f[5])
        nr.mpos = int(f[6])
        nr.isize = int(f[7])
        nr.n_cigar = int(f[8])
        nr.data = bytearray(
            blob[int(out_off[row]):int(out_off[row + 1])].tobytes())
        return nr

    row_of = {}
    for i, p in enumerate(paired):
        row_of[id(p)] = 2 * i
    for k, p in enumerate(singles):
        row_of[id(p)] = 2 * n_p + k
    result = []
    for pi, p in out:
        if id(p) not in done:
            result.append((pi, p.recs[:p.kind]))
        elif p.kind == SINGLETON:
            r0 = row_of[id(p)]
            result.append((pi, [mk_rec(r0, p.recs[0])]))
        else:
            r0 = row_of[id(p)]
            result.append((pi, [mk_rec(r0, p.recs[0]),
                                mk_rec(r0 + 1, p.recs[1])]))
    return result, counters


def bam2bam(engine, in_bam, out_bam, gopt, popt, rng, argv=None,
            version="ref", only_aligned=False, broken_input=False,
            skip_duplicates=False, drop_aligned=False, debug_bam=False,
            n_workers=1, chunk_size=4096, worker_wrapper=None,
            rng_mode="drand48", port=None, prefix=None,
            sai_streams=None, tmp_dir=None):
    """Two-pass bam2bam (bwa_bam2bam_core, bam2bam.c:1728-1940), driven
    through the chunk-lease scheduler.

    The input is split into fixed-size chunks of logical records; pass 1
    (device DFS align) and pass 2 (pairing + rescue + refine + BAM splice)
    run as pure chunk jobs over `n_workers` workers with at-least-once
    redelivery and strictly ordered release — the in-process analog of the
    reference's I/O multiplexor (run_io_multiplexor, bam2bam.c:1462-1715).
    Chunk jobs never mutate shared state: results are applied by the ordered
    writer, so a redelivered chunk is idempotent by construction.

    The drand48 hit-sampling pass runs at the coordinator in strict record
    order between the two passes (rng_mode="drand48", bit-reproducible, the
    sequential reference's call-order contract) — unlike the reference's
    networked mode, whose output depends on worker scheduling (SURVEY §2.7
    determinism caveat).  rng_mode="counter" instead derives an independent
    rand48 stream per logical record from hash_64(seed ^ recno): output is
    then invariant under any processing order, including redelivery.

    worker_wrapper(wid, fn) lets tests inject failures/stragglers around
    the chunk jobs (the kill-injection path).

    port: serve chunk leases to remote `worker` processes on this TCP port
    (the ZeroMQ work-stream analog, bam2bam.c:1808-1812); prefix is the
    index path shipped to workers in the config handshake.  Local worker
    threads and remote workers drain the same scheduler; n_workers=0 with
    a port makes the coordinator I/O-only like `bam2bam -t0 -p PORT`.
    """
    import copy as _copy
    import os as _os

    from ..parallel.scheduler import run_distributed
    from ..utils.log import StageTimers, RateEMA, Counters
    from .sampe import hash_64
    from ..utils.rand48 import Rand48

    # chunk workers run concurrently: cap each one's native engine so
    # n_workers x hardware_concurrency does not oversubscribe the box
    if n_workers > 1:
        engine.native_threads = max(1, (_os.cpu_count() or 1) // n_workers)

    bns = engine.index.bns
    pac = engine.index.pac
    reader = bamio.BamReader(in_bam)
    timers = StageTimers("bam2bam")
    telemetry = Counters()

    pairs = []

    coordinator = None
    if port is not None:
        from ..parallel.net import Coordinator
        coordinator = Coordinator(port, {
            "gap_opt": gopt.pack(), "pe_opt": popt.pack(),
            "prefix": prefix or "",
        })

    # ---- PASS 1: align (device DFS), chunk-distributed; the input BAM
    # is parsed by a producer thread and chunks stream into the
    # scheduler as they fill, so the (GIL-bound) record reader overlaps
    # the workers' native compute — the reference's mux likewise never
    # waits for the whole input (bam2bam.c:1462-1530) ----
    chunks1 = []

    def produce_chunks(append):
        buf = []

        def flush():
            append({"items": [(pi, pairs[pi].kind,
                               pairs[pi].recs[:pairs[pi].kind],
                               unique(pairs[pi], skip_duplicates),
                               pairs[pi].side)
                              for pi in buf]})
            buf.clear()
        for p in read_bam_pairs(reader, allow_broken=broken_input,
                                drop_aligned=drop_aligned,
                                sai_streams=sai_streams):
            p.recno = len(pairs)
            pairs.append(p)
            buf.append(p.recno)
            if len(buf) >= chunk_size:
                flush()
        if buf:
            flush()

    def work_align(cid, payload):
        return pass1_work(engine, gopt, payload)

    # The drand48 sampling + SA->position walk + isize histograms fold
    # into the ordered pass-1 writer: chunks release strictly in record
    # order, so the rng stream and histogram sums are identical to the
    # former standalone stage — but the (GIL-bound) sampling now overlaps
    # the other workers' native DFS instead of running as a serial stage
    # after the pass.
    hists = {}

    def apply_align(cid, res):
        chunk_pairs = []
        for pi, states, alns, hws in res:
            p = pairs[pi]
            for j in range(p.kind):
                p.states[j] = states[j]
                p.alns[j] = alns[j]
                p.hw[j] = hws[j]
                states[j].max_entries = hws[j]
            chunk_pairs.append(p)
        pos_states = []
        for p in chunk_pairs:
            if not unique(p, skip_duplicates):
                continue
            if rng_mode == "counter":
                r = Rand48()
                r.x = hash_64((bns.seed ^ p.recno)
                              & 0xFFFFFFFFFFFFFFFF) & ((1 << 48) - 1)
            else:
                r = rng
            if p.kind == SINGLETON:
                se.aln2seq_core(p.alns[0], p.states[0], r, set_main=True,
                                n_multi=popt.max_occ_se)
            else:
                for j in range(2):
                    st = p.states[j]
                    st.n_multi = 0
                    st.multi = []
                    se.aln2seq_core(p.alns[j], st, r, set_main=True,
                                    n_multi=0)
            pos_states.extend(p.states[j] for j in range(p.kind))
        se.cal_pac_pos(engine, pos_states, gopt.max_diff, gopt.fnr)
        for p in chunk_pairs:
            if unique(p, skip_duplicates):
                improve_isize_est(hists, p, popt.ap_prior,
                                  engine.index.fwd.seq_len)
            p.phase = POSITIONED

    # lease long enough that a legitimately slow chunk is never re-issued
    # to a second worker (duplicate compute); the reference's resend sweep
    # uses a 90 s lease (bam2bam.c:8,1577-1601).  Env-tunable so the
    # worker-kill tests keep a fast redelivery turnaround.
    import os as _os
    lease_s = float(_os.environ.get("NABWA_LEASE_S", "90"))
    with timers("read + pass 1 align"):
        _, sched1 = run_distributed(chunks1, work_align,
                                    n_workers=n_workers,
                                    lease_timeout=lease_s,
                                    writer=apply_align,
                                    worker_wrapper=worker_wrapper,
                                    coordinator=coordinator, phase=1,
                                    producer=produce_chunks)
    idx_chunks = [list(range(i, min(i + chunk_size, len(pairs))))
                  for i in range(0, len(pairs), chunk_size)]
    telemetry.bump("pass1_resends", sched1.total_resends)
    telemetry.bump("pass1_dups", sched1.total_dups)

    # ---- barrier: infer_all_isizes (bam2bam.c:1856-1870); the per-RG
    # histograms were accumulated in record order by the pass-1 writer --
    iinfos = {}
    for rg, h in hists.items():
        ii = infer_isize_hist(h, popt.ap_prior, engine.index.fwd.seq_len,
                              rg=rg)
        if ii is not None:
            iinfos[rg] = ii
    # ---- PASS 2: finish (pairing + rescue + refine), chunk-distributed --
    chunks2 = [{"items": [(pi, pairs[pi]) for pi in idxs],
                "skip_duplicates": skip_duplicates,
                "debug_bam": debug_bam}
               for idxs in idx_chunks]

    def work_finish(cid, payload):
        return pass2_work(engine, gopt, popt, iinfos, payload)

    counters = {"n_tot": [0, 0], "n_mapped": [0, 0]}
    ema = RateEMA("bam2bam")

    # Output streams from the ordered pass-2 writer: records release in
    # input order, so BGZF compression/IO overlaps the remaining chunks'
    # compute instead of running as a serial stage after the pass.
    header_text = print_header_text(bns, reader.text, argv or [], version)
    refs = [(a.name, a.length) for a in bns.anns]
    out_f = open(out_bam, "wb")
    bam_w = bamio.BgzfWriter(out_f, level=2)
    payload = bytearray(b"BAM\x01")
    t = header_text.encode("latin1")
    import struct as _struct
    payload += _struct.pack("<i", len(t)) + t
    payload += _struct.pack("<i", len(refs))
    for name, ln in refs:
        nb = name.encode() + b"\x00"
        payload += _struct.pack("<i", len(nb)) + nb \
            + _struct.pack("<i", ln)
    bam_w.write(bytes(payload))

    def apply_finish(cid, res):
        recs_list, cnt = res
        for k in range(2):
            counters["n_tot"][k] += cnt["n_tot"][k]
            counters["n_mapped"][k] += cnt["n_mapped"][k]
        for pi, recs in recs_list:
            p = pairs[pi]
            p.recs[:p.kind] = recs
            p.phase = FINISHED
            ema.update(pi)
            if only_aligned and any(recs[i].flag & SAM_FSU
                                    for i in range(p.kind)):
                continue
            for rec in recs:
                bam_w.write(rec.encode())

    with timers("pass 2 finish"):
        _, sched2 = run_distributed(chunks2, work_finish,
                                    n_workers=n_workers,
                                    lease_timeout=lease_s,
                                    writer=apply_finish,
                                    worker_wrapper=worker_wrapper,
                                    coordinator=coordinator, phase=2,
                                    ctx=iinfos)
    telemetry.bump("pass2_resends", sched2.total_resends)
    telemetry.bump("pass2_dups", sched2.total_dups)

    # mate-rescue tallies in the reference's format (bam2bam.c:1208-1214)
    import sys as _sys
    print("[bwa_paired_sw] %d out of %d Q%d singletons are mated."
          % (counters["n_mapped"][1], counters["n_tot"][1], 17),
          file=_sys.stderr)
    print("[bwa_paired_sw] %d out of %d Q%d discordant pairs are fixed."
          % (counters["n_mapped"][0], counters["n_tot"][0], 17),
          file=_sys.stderr)

    # ---- output BAM: flush the streaming writer ----
    with timers("write output"):
        bam_w.close()
        out_f.close()
    if coordinator is not None:
        coordinator.close()
    ema.final(len(pairs))
    telemetry.report("bam2bam")
    timers.report_all()
    return counters


def _clone_rec(r):
    if r is None:
        return None
    c = BamRec()
    c.tid, c.pos, c.bin, c.qual = r.tid, r.pos, r.bin, r.qual
    c.l_qname, c.flag, c.n_cigar = r.l_qname, r.flag, r.n_cigar
    c.l_qseq, c.mtid, c.mpos = r.l_qseq, r.mtid, r.mpos
    c.isize = r.isize
    c.data = bytearray(r.data)
    return c


def _clone_state(s):
    if s is None:
        return None
    c = se.SeqState.__new__(se.SeqState)
    for f in se.SeqState.__slots__:
        setattr(c, f, getattr(s, f))
    c.cigar = list(s.cigar) if s.cigar is not None else None
    c.multi = [dict(m) for m in s.multi]
    return c


def _clone_pair(p):
    """Targeted copy of everything pass-2 mutates (recs/states/alns) —
    redelivery idempotence without deepcopy's per-record millisecond (the
    read arrays and the sideload are never written in phase B and stay
    shared)."""
    c = Pair(p.kind, [_clone_rec(r) for r in p.recs])
    c.phase = p.phase
    c.states = [_clone_state(s) for s in p.states]
    # aln records are immutable tuples now: a shallow list copy suffices
    c.alns = [list(a) if a is not None else None for a in p.alns]
    c.hw = list(p.hw)
    c.side = p.side
    try:
        c.recno = p.recno
    except AttributeError:
        pass
    return c


def _expand_positions_batch(engine, pairs, popt, pos_memo):
    """SA-interval → positions expansion for pairing, batched across the
    whole chunk (bwape.c:368-396 semantics incl. the wide-interval memo):
    one device call per strand instead of one per hit.  Returns
    {pair_idx: {(j, ki): uint32 positions}} for pairs that pass the
    both-mapped / max_occ gates (bam2bam.c:705-811)."""
    slots = []       # (a, k, l, readlen) — first requester wins the memo
    slot_of = {}     # wide-interval (k, l) -> slot
    consumers = []   # ((pair_idx, j, ki), slot)
    result = {}
    for idx, p in enumerate(pairs):
        s = p.states
        if not all(x.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT)
                   for x in s):
            continue
        n_occ = [sum(h[5] - h[4] + 1 for h in p.alns[j])
                 for j in range(2)]
        if n_occ[0] > popt.max_occ or n_occ[1] > popt.max_occ:
            continue
        result[idx] = {}
        for j in range(2):
            for ki, h in enumerate(p.alns[j]):
                key = (h[4], h[5])
                wide = h[5] - h[4] + 1 >= pe.MIN_HASH_WIDTH
                if wide and key in pos_memo:
                    result[idx][(j, ki)] = pos_memo[key]
                    continue
                if wide and key in slot_of:
                    sl = slot_of[key]
                else:
                    sl = len(slots)
                    slots.append((h[3], h[4], h[5], s[j].len))
                    if wide:
                        slot_of[key] = sl
                consumers.append(((idx, j, ki), sl))

    slot_pos = [None] * len(slots)
    for a_val in (1, 0):
        sel = [i for i, t in enumerate(slots) if t[0] == a_val]
        if not sel:
            continue
        rows = np.concatenate(
            [np.arange(slots[i][1], slots[i][2] + 1, dtype=np.uint32)
             for i in sel])
        res = engine.sa_rows(a_val, rows)
        off = 0
        for i in sel:
            w = slots[i][2] - slots[i][1] + 1
            seg = res[off:off + w]
            off += w
            if a_val:
                slot_pos[i] = seg
            else:
                slot_pos[i] = (np.uint32(engine.index.rev.seq_len)
                               - (seg + np.uint32(slots[i][3])))
    for (idx, j, ki), sl in consumers:
        result[idx][(j, ki)] = slot_pos[sl]
    for key, sl in slot_of.items():
        pos_memo[key] = slot_pos[sl]
    return result


def _finish_pair_pre(engine, bns, pac, p, gopt, popt, iinfos, null_ii,
                     positions, multi_jobs, multi_refs):
    """Pairing + multi-hit expansion for one pair (the part of
    pair_finish before mate rescue, bam2bam.c:705-811).  positions: the
    pair's pre-expanded {(j, ki): uint32 array} from
    _expand_positions_batch, or None when the pair failed its gates.
    Multi-hit position jobs are appended to multi_jobs/multi_refs for the
    caller's chunk-batched lookup.  Returns the pair's per-RG isize info
    for the batched rescue."""
    s = p.states
    rg = p.recs[0].get_rg()
    ii = iinfos.get(rg, null_ii)

    if positions is not None:
        d_arr = []
        for j in range(2):
            for ki, h in enumerate(p.alns[j]):
                seg = positions[(j, ki)]
                d_arr.append((np.asarray(seg, dtype=np.uint64) << 32)
                             | np.uint64((ki << 1) | j))
        d_arr = np.sort(np.concatenate(d_arr)) if d_arr else \
            np.empty(0, dtype=np.uint64)
        pe.pairing((s[0], s[1]), d_arr, (p.alns[0], p.alns[1]), popt,
                   gopt.s_mm, ii)

    if popt.N_multi or popt.n_multi:
        for j in range(2):
            if s[j].type != BWA_TYPE_NO_MATCH:
                if (not (s[j].extra_flag & SAM_FPP)
                        and s[1 - j].type != BWA_TYPE_NO_MATCH):
                    nm = popt.n_multi \
                        if s[j].c1 + s[j].c2 - 1 > popt.N_multi \
                        else popt.N_multi
                else:
                    nm = popt.n_multi
                se.aln2seq_core(p.alns[j], s[j], None, set_main=False,
                                n_multi=nm)
        # multi positions: deferred to the caller's chunk-wide batch
        for j in range(2):
            for m in s[j].multi:
                multi_jobs.append((m["strand"], m["pos"], s[j].len))
                multi_refs.append(m)

    return ii


def _batch_positions(engine, jobs):
    rev = engine.index.rev
    out = np.zeros(len(jobs), dtype=np.uint32)
    for strand_val in (1, 0):
        sel = [(i, t) for i, t in enumerate(jobs) if t[0] == strand_val]
        if not sel:
            continue
        res = engine.sa_rows(strand_val,
                             np.array([t[1] for _, t in sel],
                                      dtype=np.uint32))
        for (i, t), v in zip(sel, res):
            if strand_val:
                out[i] = v
            else:
                out[i] = (np.uint32(rev.seq_len) - (v + np.uint32(t[2])))
    return out


def find_pp_tag(header_text):
    """find_pp_tag (bam2bam.c:212-271): (pp, id)."""
    present = []
    linked = []
    for line in header_text.split("\n"):
        if line.startswith("@PG"):
            for field in line.split("\t"):
                if field.startswith("ID:"):
                    present.append(field[3:])
                elif field.startswith("PP:"):
                    linked.append(field[3:])
    pp = None
    for k in present:
        if k not in linked:
            pp = k
            break
    myid = "bwa"
    n = 1
    while myid in present:
        myid = "bwa-%d" % n
        n += 1
    return pp, myid


def print_header_text(bns, oldhdr, argv, version):
    """bwa_print_header_text (bam2bam.c:164-200)."""
    pp, myid = find_pp_tag(oldhdr)
    out = ["@HD\tVN:1.4\n@PG\tID:%s%s\tPN:bwa\tVN:%s%s" % (
        myid, ("\tPP:" + pp) if pp else "", version,
        "\tCL:" if argv else "")]
    for i, a in enumerate(argv):
        out.append("%s%c" % (a, "\n" if i == len(argv) - 1 else " "))
    for a in bns.anns:
        out.append("@SQ\tSN:%s\tLN:%d\n" % (a.name, a.length))
    for line in oldhdr.split("\n"):
        if not line:
            continue
        if line.startswith("@SQ") or line.startswith("@HD"):
            continue
        out.append(line + "\n")
    return "".join(out)
