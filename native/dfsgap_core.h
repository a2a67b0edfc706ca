// BWA's bounded-DFS gapped search (bwt_match_gap, bwtgap.c:104-266) and
// its FM-index helpers, written once for two compilers: g++ builds it into
// the host library (native/dfsgap.cpp) and nvcc into the GPU kernel
// (native/dfs_cuda.cu).
//
// The search is a template over its stack and hit store:
//   - host: a growable binned stack and a caller-sized hit array — the
//     reference's own semantics, bit-exact including the stack high-water;
//   - fixed (GPU, and its host twin for tests): a slab of stack_cap entries
//     and hits_cap hit slots, an iteration cap, and push-time pruning, the
//     same contract as the jnp lockstep engine (nabwa_tpu/ops/dfs.py).
//     A read that outgrows any of them is flagged and drained on the host.
//
// Pop order is "lowest score, then LIFO" (gap_stack_t, bwtgap.c:13-79):
// the drand48 stream downstream depends on the hit order it produces.
//
// BWT layout: interleaved checkpoints, words[] = repeating
// [cnt[4] | 8 bwt words] per 128 bases (bwt_bwtupdate_core,
// bwtmisc.c:125-152).  All rank math matches bwt.c:83-216.

#pragma once

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define NABWA_HD __host__ __device__ inline
#else
#define NABWA_HD inline
#endif

namespace dfsgap {

constexpr uint32_t NEG1 = 0xFFFFFFFFu;
constexpr int STATE_M = 0, STATE_I = 1, STATE_D = 2;
constexpr int MODE_GAPE = 0x01, MODE_LOGGAP = 0x04, MODE_NONSTOP = 0x10;  // bwtaln.h:132-136
constexpr int kMaxBins = 256;            // score bins of the slab stack
constexpr int kMaskWords = kMaxBins / 32;

NABWA_HD int popc32(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

NABWA_HD int popc64(uint64_t x) {
#ifdef __CUDA_ARCH__
    return __popcll(x);
#else
    return __builtin_popcountll(x);
#endif
}

NABWA_HD int ctz32(uint32_t x) {   // x != 0
#ifdef __CUDA_ARCH__
    return __ffs(x) - 1;
#else
    return __builtin_ctz(x);
#endif
}

struct Fm {
    const uint32_t* bwt;
    uint32_t primary;
    uint32_t L2[5];
    uint32_t seq_len;
};

// count of 2-bit code c among the top `n` bases of one 16-base word
NABWA_HD uint32_t word_cnt(uint32_t w, int c, int n) {
    uint32_t lo = w & 0x55555555u;
    uint32_t hi = (w >> 1) & 0x55555555u;
    uint32_t x0 = (c & 1) ? lo : (lo ^ 0x55555555u);
    uint32_t x1 = (c & 2) ? hi : (hi ^ 0x55555555u);
    uint32_t m = n >= 16 ? 0xFFFFFFFFu : ~((1u << ((16 - n) << 1)) - 1u);
    return (uint32_t)popc32(x0 & x1 & m);
}

// bit mask of lanes holding code c in a 64-bit word pair (one bit set per
// matching 2-bit base, at the base's low bit position)
NABWA_HD uint64_t code_bits64(uint64_t v, int c) {
    uint64_t lo = v & 0x5555555555555555ull;
    uint64_t hi = (v >> 1) & 0x5555555555555555ull;
    return ((c & 1) ? lo : lo ^ 0x5555555555555555ull)
        & ((c & 2) ? hi : hi ^ 0x5555555555555555ull);
}

// count of code c among bases [0, kk] of a block's data words (pairs of
// full words fold into one 64-bit popcount; word_cnt handles the leftover
// and the masked partial word, including c == 0)
NABWA_HD uint32_t scan_cnt(const uint32_t* w, int kk, int c) {
    int wi = kk / 16;
    uint32_t n = 0;
    int j = 0;
    for (; j + 2 <= wi; j += 2)
        n += (uint32_t)popc64(
            code_bits64(((uint64_t)w[j] << 32) | w[j + 1], c));
    if (j < wi)
        n += word_cnt(w[j], c, 16);
    return n + word_cnt(w[wi], c, (kk & 15) + 1);
}

// bwt_occ (bwt.c:92-115)
NABWA_HD uint32_t occ1(const Fm& fm, uint32_t k, int c) {
    if (k == fm.seq_len) return fm.L2[c + 1] - fm.L2[c];
    if (k == NEG1) return 0;
    if (k >= fm.primary) --k;
    const uint32_t* p = fm.bwt + (size_t)(k / 128) * 12;
    return p[c] + scan_cnt(p + 4, (int)(k % 128), c);
}

// all-4-codes counting: tally codes 1..3 with three popcounts (code 0 is
// derived from the base count), fusing word pairs into one 64-bit
// popcount each — ~4x fewer ops than a per-code word_cnt sweep
NABWA_HD void word_cnt123(uint32_t v, uint32_t* c1, uint32_t* c2,
                          uint32_t* c3) {
    uint32_t lo = v & 0x55555555u, hi = (v >> 1) & 0x55555555u;
    *c1 += (uint32_t)popc32(lo & ~hi);
    *c2 += (uint32_t)popc32(hi & ~lo);
    *c3 += (uint32_t)popc32(hi & lo);
}

NABWA_HD void pair_cnt123(uint64_t v, uint32_t* c1, uint32_t* c2,
                          uint32_t* c3) {
    uint64_t lo = v & 0x5555555555555555ull;
    uint64_t hi = (v >> 1) & 0x5555555555555555ull;
    *c1 += (uint32_t)popc64(lo & ~hi);
    *c2 += (uint32_t)popc64(hi & ~lo);
    *c3 += (uint32_t)popc64(hi & lo);
}

// mask keeping the top ((kk & 15) + 1) bases of a 16-base word (bases are
// MSB-first); masked-off bases become code 0, never counted in c1..c3
NABWA_HD uint32_t part_mask(int kk) {
    return ~((1u << ((15 - (kk & 15)) << 1)) - 1u);
}

// bwt_occ4 core (bwt.c:159-176) for k not in {-1, seq_len}
NABWA_HD void occ4_raw(const Fm& fm, uint32_t k, uint32_t cnt[4]) {
    if (k >= fm.primary) --k;
    const uint32_t* p = fm.bwt + (size_t)(k / 128) * 12;
    const uint32_t* w = p + 4;
    int kk = (int)(k % 128);
    int wi = kk / 16;
    uint32_t c1 = 0, c2 = 0, c3 = 0;
    int j = 0;
    for (; j + 2 <= wi; j += 2)
        pair_cnt123(((uint64_t)w[j] << 32) | w[j + 1], &c1, &c2, &c3);
    uint32_t last = w[wi] & part_mask(kk);
    if (j < wi)
        pair_cnt123(((uint64_t)w[j] << 32) | last, &c1, &c2, &c3);
    else
        word_cnt123(last, &c1, &c2, &c3);
    cnt[0] = p[0] + (uint32_t)(kk + 1) - c1 - c2 - c3;
    cnt[1] = p[1] + c1;
    cnt[2] = p[2] + c2;
    cnt[3] = p[3] + c3;
}

// bwt_2occ4 semantics (scalar model two_occ4): edge cases per operand
NABWA_HD void occ4_edge(const Fm& fm, uint32_t k, uint32_t cnt[4]) {
    if (k == NEG1) { for (int c = 0; c < 4; ++c) cnt[c] = 0; return; }
    if (k == fm.seq_len) {
        for (int c = 0; c < 4; ++c) cnt[c] = fm.L2[c + 1] - fm.L2[c];
        return;
    }
    occ4_raw(fm, k, cnt);
}

// bwt_2occ (bwt.c:118-153) semantics for cal_width: occ of c at k and l
// sharing one checkpoint scan when both land in the same 128-base block
NABWA_HD void occ2(const Fm& fm, uint32_t k, uint32_t l, int c,
                   uint32_t* ok, uint32_t* ol) {
    uint32_t _k = (k >= fm.primary) ? k - 1 : k;
    uint32_t _l = (l >= fm.primary) ? l - 1 : l;
    if (_l >> 7 != _k >> 7 || k == NEG1 || l == NEG1
        || k == fm.seq_len || l == fm.seq_len) {
        *ok = occ1(fm, k, c);
        *ol = occ1(fm, l, c);
        return;
    }
    const uint32_t* p = fm.bwt + (size_t)(_k / 128) * 12;
    const uint32_t* w = p + 4;
    int kk = (int)(_k % 128), ll = (int)(_l % 128);
    int wk = kk / 16, wl = ll / 16;
    uint32_t n = 0;      // count over full words [0, wk)
    int j = 0;
    for (; j + 2 <= wk; j += 2)
        n += (uint32_t)popc64(
            code_bits64(((uint64_t)w[j] << 32) | w[j + 1], c));
    if (j < wk)
        n += word_cnt(w[j], c, 16);
    *ok = p[c] + n + word_cnt(w[wk], c, (kk & 15) + 1);
    for (j = wk; j + 2 <= wl; j += 2)
        n += (uint32_t)popc64(
            code_bits64(((uint64_t)w[j] << 32) | w[j + 1], c));
    if (j < wl)
        n += word_cnt(w[j], c, 16);
    *ol = p[c] + n + word_cnt(w[wl], c, (ll & 15) + 1);
}

// bwt_2occ4 (bwt.c:179-216): occ4 at k and l with one shared scan when
// both fall in the same checkpoint block
NABWA_HD void two_occ4(const Fm& fm, uint32_t k, uint32_t l,
                       uint32_t cnt_k[4], uint32_t cnt_l[4]) {
    uint32_t _k = (k >= fm.primary) ? k - 1 : k;
    uint32_t _l = (l >= fm.primary) ? l - 1 : l;
    if (_l >> 7 != _k >> 7 || k == NEG1 || l == NEG1
        || k == fm.seq_len || l == fm.seq_len) {
        occ4_edge(fm, k, cnt_k);
        occ4_edge(fm, l, cnt_l);
        return;
    }
    const uint32_t* p = fm.bwt + (size_t)(_k / 128) * 12;
    const uint32_t* w = p + 4;
    int kk = (int)(_k % 128), ll = (int)(_l % 128);
    int wk = kk / 16, wl = ll / 16;
    uint32_t f1 = 0, f2 = 0, f3 = 0;    // shared full-word tallies
    int j = 0;
    for (; j + 2 <= wk; j += 2)
        pair_cnt123(((uint64_t)w[j] << 32) | w[j + 1], &f1, &f2, &f3);
    if (j < wk)
        word_cnt123(w[j], &f1, &f2, &f3);
    uint32_t k1 = f1, k2 = f2, k3 = f3;
    word_cnt123(w[wk] & part_mask(kk), &k1, &k2, &k3);
    cnt_k[0] = p[0] + (uint32_t)(kk + 1) - k1 - k2 - k3;
    cnt_k[1] = p[1] + k1;
    cnt_k[2] = p[2] + k2;
    cnt_k[3] = p[3] + k3;
    for (j = wk; j + 2 <= wl; j += 2)
        pair_cnt123(((uint64_t)w[j] << 32) | w[j + 1], &f1, &f2, &f3);
    if (j < wl)
        word_cnt123(w[j], &f1, &f2, &f3);
    word_cnt123(w[wl] & part_mask(ll), &f1, &f2, &f3);
    cnt_l[0] = p[0] + (uint32_t)(ll + 1) - f1 - f2 - f3;
    cnt_l[1] = p[1] + f1;
    cnt_l[2] = p[2] + f2;
    cnt_l[3] = p[3] + f3;
}

// bwt_cal_width (bwtaln.c:52-76)
NABWA_HD void cal_width(const Fm& fm, const uint8_t* str, int len,
                        uint32_t* w, int32_t* bid) {
    uint32_t k = 0, l = fm.seq_len;
    int32_t cur = 0;
    for (int i = 0; i < len; ++i) {
        int c = str[i];
        if (c < 4) {
            uint32_t ok, ol;
            occ2(fm, k - 1, l, c, &ok, &ol);
            k = fm.L2[c] + ok + 1;
            l = fm.L2[c] + ol;
        }
        if (k > l || c > 3) { k = 0; l = fm.seq_len; ++cur; }
        w[i] = l - k + 1;
        bid[i] = cur;
    }
    w[len] = 0;
    bid[len] = cur + 1;
}

struct Entry {
    uint32_t k, l;
    int16_t i, last_diff_pos;
    uint8_t a, n_mm, n_gapo, n_gape, state;
};

struct Opts {
    int s_mm, s_gapo, s_gape;
    int max_gape, max_gapo_batch;
    int indel_end_skip, max_del_occ;
    int64_t max_entries;
    int max_top2, max_seed_diff, seed_len, mode;
    int hits_cap;
};

struct Hit { int32_t n_mm, n_gapo, n_gape, a, k, l, score; };

NABWA_HD int int_log2(uint32_t v) {
    int c = 0;
    if (v & 0xFFFF0000u) { v >>= 16; c |= 16; }
    if (v & 0xFF00u) { v >>= 8; c |= 8; }
    if (v & 0xF0u) { v >>= 4; c |= 4; }
    if (v & 0xCu) { v >>= 2; c |= 2; }
    if (v & 0x2u) c |= 1;
    return c;
}

// gap_shadow (bwtgap.c:81-91)
NABWA_HD void gap_shadow(uint32_t x, uint32_t max_seq_len,
                         int last_diff_pos, uint32_t* w, int32_t* bid) {
    int j = 0;
    for (int i = 0; i < last_diff_pos; ++i) {
        if (w[i] > x) w[i] -= x;
        else if (w[i] == x) {
            bid[i] = 1;
            ++j;
            w[i] = max_seq_len - (uint32_t)j;
        }
    }
}

NABWA_HD int score_of(const Opts& opt, int m, int o, int e) {
    return m * opt.s_mm + o * opt.s_gapo + e * opt.s_gape;
}

// Fixed-capacity priority stack: per score bin a LIFO list threaded
// through a slab of `cap` entries, a bit mask of non-empty bins, and a
// free list.  Storage belongs to the caller (device scratch, or host
// vectors in the test twin).  `pushes` is the jnp engine's 16-bit
// push-sequence ceiling, kept so both engines flag the same reads.
struct SlabStack {
    Entry* slots;
    int32_t* next;
    int32_t* head;
    int cap;
    int n_bins;
    int best;
    int32_t free_head;
    int32_t n_used;
    int32_t pushes;
    int64_t n_entries;
    uint32_t mask[kMaskWords];

    NABWA_HD bool reset(int nb) {
        if (nb > kMaxBins) return false;
        n_bins = nb;
        best = nb;
        free_head = -1;
        n_used = 0;
        pushes = 0;
        n_entries = 0;
        for (int w = 0; w < kMaskWords; ++w) mask[w] = 0;
        return true;
    }
    NABWA_HD bool room(int n, int max_score) const {
        return n_entries + n <= cap && pushes + n <= 0xFFFF
            && max_score < n_bins;
    }
    NABWA_HD void push(const Entry& e, int score) {
        int32_t s;
        if (free_head >= 0) { s = free_head; free_head = next[s]; }
        else s = n_used++;
        slots[s] = e;
        uint32_t bit = 1u << (score & 31);
        next[s] = (mask[score >> 5] & bit) ? head[score] : -1;
        head[score] = s;
        mask[score >> 5] |= bit;
        ++n_entries;
        ++pushes;
        if (best > score) best = score;
    }
    NABWA_HD Entry pop() {
        int32_t s = head[best];
        Entry e = slots[s];
        head[best] = next[s];
        next[s] = free_head;
        free_head = s;
        --n_entries;
        if (head[best] < 0) {
            mask[best >> 5] &= ~(1u << (best & 31));
            best = n_bins;
            if (n_entries) {
                for (int w = 0; w < kMaskWords; ++w)
                    if (mask[w]) { best = (w << 5) + ctz32(mask[w]); break; }
            }
        }
        return e;
    }
};

struct Result {
    int n_aln;
    int32_t hw;
    int32_t fin;       // iteration at which the search ended (0 if never ran)
    int32_t iters;     // iterations run (the cap when capped)
    bool overflow;     // stack, hit store or iteration cap exceeded
};

// bwt_match_gap (bwtgap.c:104-266) for one read.
//
// kFixed selects the fixed-capacity contract (see the file comment): an
// empty read is skipped, candidates that can no longer contribute are
// dropped at push (they would be discarded at pop; only the high-water
// mark differs from the reference), and a push that exceeds the slab, or
// an iteration past max_iters, flags the read.  Iterations are counted as
// the lockstep engine counts them: one per pop, plus one per base of a
// zero-budget exact match.  W/BID (and SW/SBID when the read is longer
// than seed_len) need length + 1 (seed_len + 1) slots per strand.
template <bool kFixed, class Stack, class Hits>
NABWA_HD void match_gap(const Fm* fms, int length, const uint8_t* seq,
                        const uint8_t* rseq, int max_diff, int max_gapo,
                        const Opts& opt, int64_t max_iters,
                        uint32_t* const* W, int32_t* const* BID,
                        uint32_t* const* SW, int32_t* const* SBID,
                        Stack& stack, Hits& hits, Result& res) {
    const bool mode_gape = opt.mode & MODE_GAPE;
    const bool mode_nonstop = opt.mode & MODE_NONSTOP;
    const bool mode_loggap = opt.mode & MODE_LOGGAP;

    res.n_aln = 0;
    res.hw = 0;
    res.fin = 0;
    res.iters = 0;
    res.overflow = false;
    if (kFixed && length <= 0) return;

    int best_score = score_of(opt, max_diff + 1, max_gapo + 1,
                              opt.max_gape + 1);
    int best_diff = max_diff + 1;
    int64_t best_cnt = 0;
    int n_bins = best_score;
    int64_t hw = 0;
    int n_aln = 0;

    int n_n = 0;
    for (int i = 0; i < length; ++i) n_n += seq[i] > 3;
    if (n_n > max_diff) return;

    // widths on the strand's own search index: w0 from the forward bwt
    // with seq, w1 from the reverse bwt with rseq; strand a searches
    // fms[1-a] (bwtgap.c:149)
    cal_width(fms[0], seq, length, W[0], BID[0]);
    cal_width(fms[1], rseq, length, W[1], BID[1]);
    const bool has_seed = opt.seed_len < length;
    if (has_seed) {
        int sl = opt.seed_len;
        cal_width(fms[0], seq + (length - sl), sl, SW[0], SBID[0]);
        cal_width(fms[1], rseq + (length - sl), sl, SW[1], SBID[1]);
    }

    if (!stack.reset(n_bins + 1)) { res.overflow = true; return; }
    Entry seed = {0, fms[0].seq_len, (int16_t)length, 0, 0, 0, 0, 0,
                  (uint8_t)STATE_M};
    stack.push(seed, 0);
    seed.a = 1;
    stack.push(seed, 0);

    int64_t t = 0;     // iterations so far
    for (;;) {
        if (t >= max_iters) { res.overflow = true; break; }
        ++t;
        if (hw < stack.n_entries) hw = stack.n_entries;
        if (stack.n_entries == 0 || stack.n_entries > opt.max_entries)
            break;
        Entry e = stack.pop();
        uint32_t k = e.k, l = e.l;
        int a = e.a, i = e.i;
        int e_score = score_of(opt, e.n_mm, e.n_gapo, e.n_gape);
        if (!mode_nonstop && e_score > best_score + opt.s_mm) break;

        int m = max_diff - (e.n_mm + e.n_gapo);
        if (mode_gape) m -= e.n_gape;
        if (m < 0) continue;
        const Fm& fm = fms[1 - a];
        const uint8_t* strn = a == 0 ? seq : rseq;
        uint32_t* w = W[a];
        int32_t* bid = BID[a];
        int m_seed = 0;
        if (has_seed) {
            m_seed = opt.max_seed_diff - (e.n_mm + e.n_gapo);
            if (mode_gape) m_seed -= e.n_gape;
        }
        if (i > 0 && m < bid[i - 1]) continue;

        bool hit_found = false;
        if (i == 0) {
            hit_found = true;
        } else if (m == 0 && (e.state == STATE_M || mode_gape
                              || e.n_gape == opt.max_gape)) {
            // bwt_match_exact_alt (bwt.c:237-252), one base per iteration
            bool ok = true, capped = false;
            for (int j = i - 1; j >= 0; --j) {
                if (t >= max_iters) { capped = true; break; }
                ++t;
                int c = strn[j];
                if (c > 3) { ok = false; break; }
                k = fm.L2[c] + occ1(fm, k - 1, c) + 1;
                l = fm.L2[c] + occ1(fm, l, c);
                if (k > l) { ok = false; break; }
            }
            if (capped) { res.overflow = true; break; }
            if (!ok) continue;
            hit_found = true;
        }

        if (hit_found) {
            int score = e_score;
            bool do_add = true;
            if (n_aln == 0) {
                best_score = score;
                best_diff = e.n_mm + e.n_gapo + (mode_gape ? e.n_gape : 0);
                if (!mode_nonstop && best_diff + 1 < max_diff)
                    max_diff = best_diff + 1;
            }
            if (score == best_score) best_cnt += (int64_t)(l - k) + 1;
            else if (best_cnt > opt.max_top2) break;
            if (e.n_gapo) {
                for (int h = 0; h < n_aln; ++h)
                    if (hits.k(h) == k && hits.l(h) == l)
                        { do_add = false; break; }
            }
            if (do_add) {
                gap_shadow(l - k + 1, fm.seq_len, e.last_diff_pos, w, bid);
                if (!hits.add(n_aln, e.n_mm, e.n_gapo, e.n_gape, a, k, l,
                              score)) {
                    res.overflow = true;
                    break;
                }
                ++n_aln;
            }
            continue;
        }

        --i;
        uint32_t cnt_k[4], cnt_l[4];
        two_occ4(fm, k - 1, l, cnt_k, cnt_l);
        uint32_t occw = l - k + 1;

        bool allow_diff = true, allow_M = true;
        if (i > 0) {
            int ii = i - (length - opt.seed_len);
            if (bid[i - 1] > m - 1) allow_diff = false;
            else if (bid[i - 1] == m - 1 && bid[i] == m - 1
                     && w[i - 1] == w[i]) allow_M = false;
            if (has_seed && ii > 0) {
                const uint32_t* sw = SW[a];
                const int32_t* sbid = SBID[a];
                if (sbid[ii - 1] > m_seed - 1) allow_diff = false;
                else if (sbid[ii - 1] == m_seed - 1
                         && sbid[ii] == m_seed - 1
                         && sw[ii - 1] == sw[ii]) allow_M = false;
            }
        }

        // candidates in the reference's push order: insertion, deletions
        // for bases 0..3, then mismatches/match
        Entry cand[9];
        int cscore[9];
        int nc = 0;
        auto add = [&](int ci, uint32_t ck, uint32_t cl, int n_mm,
                       int n_gapo, int n_gape, int state, bool is_diff) {
            Entry& c = cand[nc];
            c.k = ck; c.l = cl; c.i = (int16_t)ci;
            c.last_diff_pos = (int16_t)(is_diff ? ci : 0);
            c.a = (uint8_t)a; c.n_mm = (uint8_t)n_mm;
            c.n_gapo = (uint8_t)n_gapo; c.n_gape = (uint8_t)n_gape;
            c.state = (uint8_t)state;
            cscore[nc++] = score_of(opt, n_mm, n_gapo, n_gape);
        };

        int tmp = mode_loggap
            ? int_log2((uint32_t)(e.n_gape + e.n_gapo)) / 2 + 1
            : e.n_gapo + e.n_gape;
        if (allow_diff && i >= opt.indel_end_skip + tmp
            && length - i >= opt.indel_end_skip + tmp) {
            if (e.state == STATE_M) {
                if (e.n_gapo < max_gapo) {
                    add(i, k, l, e.n_mm, e.n_gapo + 1, e.n_gape, STATE_I,
                        true);
                    for (int j = 0; j < 4; ++j) {
                        uint32_t dk = fm.L2[j] + cnt_k[j] + 1;
                        uint32_t dl = fm.L2[j] + cnt_l[j];
                        if (dk <= dl)
                            add(i + 1, dk, dl, e.n_mm, e.n_gapo + 1,
                                e.n_gape, STATE_D, true);
                    }
                }
            } else if (e.state == STATE_I) {
                if (e.n_gape < opt.max_gape)
                    add(i, k, l, e.n_mm, e.n_gapo, e.n_gape + 1, STATE_I,
                        true);
            } else if (e.state == STATE_D) {
                if (e.n_gape < opt.max_gape
                    && (e.n_gape + e.n_gapo < max_diff
                        || occw < (uint32_t)opt.max_del_occ)) {
                    for (int j = 0; j < 4; ++j) {
                        uint32_t dk = fm.L2[j] + cnt_k[j] + 1;
                        uint32_t dl = fm.L2[j] + cnt_l[j];
                        if (dk <= dl)
                            add(i + 1, dk, dl, e.n_mm, e.n_gapo,
                                e.n_gape + 1, STATE_D, true);
                    }
                }
            }
        }

        if (allow_diff && allow_M) {
            for (int j = 1; j <= 4; ++j) {
                int c = (strn[i] + j) & 3;
                bool is_mm = (j != 4 || strn[i] > 3);
                uint32_t mk = fm.L2[c] + cnt_k[c] + 1;
                uint32_t ml = fm.L2[c] + cnt_l[c];
                if (mk <= ml)
                    add(i, mk, ml, e.n_mm + (is_mm ? 1 : 0), e.n_gapo,
                        e.n_gape, STATE_M, is_mm);
            }
        } else if (strn[i] < 4) {
            int c = strn[i] & 3;
            uint32_t mk = fm.L2[c] + cnt_k[c] + 1;
            uint32_t ml = fm.L2[c] + cnt_l[c];
            if (mk <= ml)
                add(i, mk, ml, e.n_mm, e.n_gapo, e.n_gape, STATE_M, false);
        }

        int max_score = 0;
        if (kFixed) {
            // push-time pruning: max_diff and best_score only tighten, so
            // a candidate already past the pop-time budget check or the
            // best-score break can never contribute when popped
            int kept = 0;
            for (int j = 0; j < nc; ++j) {
                int diff = cand[j].n_mm + cand[j].n_gapo
                    + (mode_gape ? cand[j].n_gape : 0);
                if (diff > max_diff) continue;
                if (!mode_nonstop && cscore[j] > best_score + opt.s_mm)
                    continue;
                cand[kept] = cand[j];
                cscore[kept] = cscore[j];
                if (cscore[j] > max_score) max_score = cscore[j];
                ++kept;
            }
            nc = kept;
        }
        if (nc && !stack.room(nc, max_score)) {
            res.overflow = true;
            break;
        }
        for (int j = 0; j < nc; ++j) stack.push(cand[j], cscore[j]);
    }
    res.n_aln = n_aln;
    res.hw = (int32_t)(hw > 0x7FFFFFFF ? 0x7FFFFFFF : hw);
    res.fin = res.overflow ? 0 : (int32_t)t;
    res.iters = (int32_t)t;
}

// ---- the fixed-capacity batch contract shared by the GPU kernel and its
// host twin: inputs and the packed [B, 4H+5] int32 result of
// nabwa_tpu/ops/dfs.py (hit_meta | hit_k | hit_l | hit_score | n_aln |
// hw | overflow | fin | iters) ----

// params[] layout, written by nabwa_tpu/ops/dfs_cuda.py:_params
enum Param {
    P_PRIMARY_FWD, P_PRIMARY_REV, P_SEQ_LEN, P_L2,
    P_S_MM = P_L2 + 5, P_S_GAPO, P_S_GAPE, P_MAX_GAPE, P_MAX_GAPO,
    P_INDEL_END_SKIP, P_MAX_DEL_OCC, P_MAX_ENTRIES, P_MAX_TOP2,
    P_MAX_SEED_DIFF, P_SEED_LEN, P_MODE, P_STACK_CAP, P_HITS_CAP,
    P_MAX_ITERS, P_COUNT
};

struct Batch {
    Fm fms[2];
    Opts opt;
    int stack_cap;
    int64_t max_iters;
};

NABWA_HD void batch_from_params(const int64_t* p, const uint32_t* bwt_fwd,
                                const uint32_t* bwt_rev, Batch& b) {
    b.fms[0].bwt = bwt_fwd;
    b.fms[1].bwt = bwt_rev;
    b.fms[0].primary = (uint32_t)p[P_PRIMARY_FWD];
    b.fms[1].primary = (uint32_t)p[P_PRIMARY_REV];
    for (int f = 0; f < 2; ++f) {
        b.fms[f].seq_len = (uint32_t)p[P_SEQ_LEN];
        for (int c = 0; c < 5; ++c) b.fms[f].L2[c] = (uint32_t)p[P_L2 + c];
    }
    Opts& o = b.opt;
    o.s_mm = (int)p[P_S_MM];
    o.s_gapo = (int)p[P_S_GAPO];
    o.s_gape = (int)p[P_S_GAPE];
    o.max_gape = (int)p[P_MAX_GAPE];
    o.max_gapo_batch = (int)p[P_MAX_GAPO];
    o.indel_end_skip = (int)p[P_INDEL_END_SKIP];
    o.max_del_occ = (int)p[P_MAX_DEL_OCC];
    o.max_entries = p[P_MAX_ENTRIES];
    o.max_top2 = (int)p[P_MAX_TOP2];
    o.max_seed_diff = (int)p[P_MAX_SEED_DIFF];
    o.seed_len = (int)p[P_SEED_LEN];
    o.mode = (int)p[P_MODE];
    o.hits_cap = (int)p[P_HITS_CAP];
    b.stack_cap = (int)p[P_STACK_CAP];
    b.max_iters = p[P_MAX_ITERS];
}

// int32 words of per-read scratch: slab (Entry + next), bin heads, and
// the width/bid planes of both strands for the read and its seed
NABWA_HD int64_t scratch_words(int stack_cap, int L) {
    return (int64_t)stack_cap * (sizeof(Entry) / 4 + 1) + kMaxBins
        + 8 * (int64_t)(L + 1);
}

// hit store writing straight into one packed result row
struct RowHits {
    int32_t* row;
    int cap;
    NABWA_HD uint32_t k(int h) const { return (uint32_t)row[cap + h]; }
    NABWA_HD uint32_t l(int h) const { return (uint32_t)row[2 * cap + h]; }
    NABWA_HD bool add(int n, int n_mm, int n_gapo, int n_gape, int a,
                      uint32_t k_, uint32_t l_, int score) {
        if (n >= cap) return false;
        row[n] = n_mm | (n_gapo << 8) | (n_gape << 16) | (a << 24);
        row[cap + n] = (int32_t)k_;
        row[2 * cap + n] = (int32_t)l_;
        row[3 * cap + n] = score;
        return true;
    }
};

// one read of a batch: seqs uint8 [B][2][L] (seq, rseq; reversed-read
// orientation, padding 4), scratch int32 [B][scratch_words], out int32
// [B][4H+5]
NABWA_HD void fixed_read(const Batch& b, int r, int L, const uint8_t* seqs,
                         const int32_t* lengths, const int32_t* maxdiff,
                         int32_t* scratch, int32_t* out) {
    const int S = b.stack_cap, H = b.opt.hits_cap;
    int32_t* row = out + (int64_t)r * (4 * H + 5);
    for (int j = 0; j < 4 * H + 5; ++j) row[j] = 0;
    int32_t* s = scratch + (int64_t)r * scratch_words(S, L);
    SlabStack st;
    st.slots = reinterpret_cast<Entry*>(s);
    s += (int64_t)S * (sizeof(Entry) / 4);
    st.next = s;
    s += S;
    st.head = s;
    s += kMaxBins;
    st.cap = S;
    uint32_t* W[2];
    int32_t* BID[2];
    uint32_t* SW[2];
    int32_t* SBID[2];
    for (int a = 0; a < 2; ++a) {
        W[a] = reinterpret_cast<uint32_t*>(s); s += L + 1;
        BID[a] = s; s += L + 1;
        SW[a] = reinterpret_cast<uint32_t*>(s); s += L + 1;
        SBID[a] = s; s += L + 1;
    }
    RowHits hits{row, H};
    Result res;
    const uint8_t* seq = seqs + (int64_t)r * 2 * L;
    match_gap<true>(b.fms, lengths[r], seq, seq + L, maxdiff[r],
                    b.opt.max_gapo_batch, b.opt, b.max_iters, W, BID, SW,
                    SBID, st, hits, res);
    row[4 * H] = res.n_aln;
    row[4 * H + 1] = res.hw;
    row[4 * H + 2] = res.overflow ? 1 : 0;
    row[4 * H + 3] = res.fin;
    row[4 * H + 4] = res.iters;
}

}  // namespace dfsgap
