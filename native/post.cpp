// Native batch post-processing for samse/sampe: hit selection with the
// exact drand48 stream, MD/NM reference walk, and full SAM line emission.
//
// These are C++ ports of the byte-identical Python implementations in
// nabwa_tpu/models/samse.py (themselves ports of bwase.c:19-111, 253-315,
// 458-592).  Per-record Python was the measured throughput cap of the
// samse/sampe post stage; the reference runs the same
// per-record logic in C at ~128k reads/s on one core.
//
// Layout contracts (see nabwa_tpu/models/post_native.py):
//   state matrix: int64 [n, NF] with the column enum below;
//   aln records:  the raw .sai bwt_aln1_t stream (u32 meta/k/l, i32 score);
//   cigars:       flat (op,len) int32 pairs + int64 offsets, count<0 = None;
//   strings:      concatenated bytes + int64 offsets [n+1].

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <memory>
#include <thread>
#include <vector>

namespace {

// state columns (keep in sync with post_native.py)
enum {
  F_TYPE = 0, F_STRAND, F_POS, F_MAPQ, F_SEQ_Q, F_C1, F_C2, F_NMM,
  F_NGO, F_NGE, F_NM, F_LEN, F_FULL_LEN, F_CLIP_LEN, F_XFLAG, F_SA,
  F_SCORE, NF
};

enum { TYPE_NO_MATCH = 0, TYPE_UNIQUE = 1, TYPE_REPEAT = 2,
       TYPE_MATESW = 3 };

constexpr int SAM_FPP = 2, SAM_FSU = 4, SAM_FMU = 8, SAM_FSR = 16,
              SAM_FMR = 32;
constexpr int MODE_COMPREAD = 0x02;

// POSIX rand48 (utils/rand48.py): X' = (a*X + c) mod 2^48
constexpr uint64_t R48_A = 0x5DEECE66DULL, R48_C = 0xB,
                   R48_MASK = (1ULL << 48) - 1;

inline double drand48_step(uint64_t &x) {
  x = (R48_A * x + R48_C) & R48_MASK;
  return std::ldexp(static_cast<double>(x), -48);
}

struct Writer {
  uint8_t *buf;
  int64_t cap, len;
  bool overflow;
  inline void put(char c) {
    if (len < cap) buf[len] = static_cast<uint8_t>(c);
    else overflow = true;
    ++len;
  }
  inline void bytes(const uint8_t *s, int64_t n) {
    if (len + n <= cap) { std::memcpy(buf + len, s, n); }
    else overflow = true;
    len += n;
  }
  inline void str(const char *s) {
    bytes(reinterpret_cast<const uint8_t *>(s),
          static_cast<int64_t>(std::strlen(s)));
  }
  inline void num(int64_t v) {
    char tmp[24];
    int n = std::snprintf(tmp, sizeof tmp, "%lld",
                          static_cast<long long>(v));
    bytes(reinterpret_cast<const uint8_t *>(tmp), n);
  }
};

struct Bns {
  int n_seqs;
  const int64_t *ann_off;
  const int64_t *ann_len;
  const uint8_t *ann_names;
  const int64_t *ann_name_off;
  int64_t n_holes;
  const int64_t *amb_off;
  const int32_t *amb_len;
  const uint8_t *amb_chr;
  int64_t l_pac;
};

// bns_coor_pac2real (samse.py coor_pac2real, bntseq.c:272-306)
static void coor_pac2real(const Bns &b, int64_t pac_coor, int64_t length,
                          int64_t *seqid_out, int64_t *nn_out) {
  int64_t left = 0, mid = 0, right = b.n_seqs;
  while (left < right) {
    mid = (left + right) >> 1;
    if (pac_coor >= b.ann_off[mid]) {
      if (mid == b.n_seqs - 1) break;
      if (pac_coor < b.ann_off[mid + 1]) break;
      left = mid + 1;
    } else {
      right = mid;
    }
  }
  int64_t seqid = mid;
  int64_t nn = 0;
  left = 0;
  right = b.n_holes;
  while (left < right) {
    int64_t hmid = (left + right) >> 1;
    int64_t off = b.amb_off[hmid];
    int64_t end = off + b.amb_len[hmid];
    if (pac_coor >= end) {
      left = hmid + 1;
    } else if (pac_coor + length <= off) {
      right = hmid;
    } else {
      if (pac_coor >= off)
        nn += (end < pac_coor + length) ? end - pac_coor : length;
      else
        nn += (end < pac_coor + length) ? b.amb_len[hmid]
                                        : length - (off - pac_coor);
      break;
    }
  }
  *seqid_out = seqid;
  *nn_out = nn;
}

// pos_end (samse.py / bwase.c:425-436) on flat cigars
static int64_t pos_end(const int64_t *st, const int32_t *cig,
                       const int64_t *cig_off, int64_t i) {
  int64_t c0 = cig_off[i], c1 = cig_off[i + 1];
  if (c1 > c0) {
    int64_t x = st[i * NF + F_POS];
    for (int64_t c = c0; c < c1; c += 2) {
      int op = cig[c];
      if (op == 0 || op == 2) x += cig[c + 1];   // M or D
    }
    return x;
  }
  return st[i * NF + F_POS] + st[i * NF + F_LEN];
}

static int64_t pos_5(const int64_t *st, const int32_t *cig,
                     const int64_t *cig_off, int64_t i) {
  if (st[i * NF + F_TYPE] != TYPE_NO_MATCH)
    return st[i * NF + F_STRAND] ? pos_end(st, cig, cig_off, i)
                                 : st[i * NF + F_POS];
  return -1;
}

static const char CIGAR_CHR[] = "MIDS";
static const char FWD_BASES[] = "ACGTN";
static const char REV_BASES[] = "TGCAN";

// hash_64 (sampe.py hash_64, bwape.c:43-54)
inline uint64_t hash_64(uint64_t key) {
  key += ~(key << 32);
  key ^= key >> 22;
  key += ~(key << 13);
  key ^= key >> 8;
  key += key << 3;
  key ^= key >> 15;
  key += ~(key << 27);
  key ^= key >> 31;
  return key;
}

// g_log_n (samse.py make_g_log_n, bwase.c:613-617)
struct GLogN {
  int t[256];
  GLogN() {
    t[0] = 0;
    for (int i = 1; i < 256; ++i)
      t[i] = static_cast<int>(4.343 * std::log(i) + 0.5);
  }
};
static const GLogN g_log_n;

}  // namespace

extern "C" {

// bwa_aln2seq_core (samse.py aln2seq_core, bwase.c:19-95) for a batch of
// reads, consuming the shared drand48 stream sequentially in read order.
// recs: raw .sai record words (meta,k,l,score) x n_recs; counts[i] records
// per read.  Fills state cols TYPE/STRAND/NMM/NGO/NGE/SCORE/SA/C1/C2 and
// the multi-hit arrays (pos/gap/mm/strand per hit, multi_n per read,
// stride n_multi+1).  set_main=0 keeps the existing main fields (bam2bam
// XA-only pass).  Returns 0.
int se_select_batch(int64_t n, const uint32_t *recs, const int32_t *counts,
                    int64_t *state, uint64_t *rng_state, int set_main,
                    int n_multi, uint64_t *multi_pos, int32_t *multi_gap,
                    int32_t *multi_mm, int32_t *multi_strand,
                    int32_t *multi_n) {
  uint64_t x = *rng_state;
  const uint32_t *r = recs;
  int64_t stride = n_multi + 1;
  for (int64_t i = 0; i < n; ++i) {
    int32_t na = counts[i];
    int64_t *st = state + i * NF;
    if (multi_n) multi_n[i] = 0;
    if (na == 0) {
      if (set_main) {
        st[F_TYPE] = TYPE_NO_MATCH;
        st[F_C1] = 0;
        st[F_C2] = 0;
      }
      continue;
    }
    if (set_main) {
      int32_t best = static_cast<int32_t>(r[3]);
      int64_t cnt = 0;
      int32_t j = 0;
      for (; j < na; ++j) {
        const uint32_t *p = r + 4 * j;
        int32_t score = static_cast<int32_t>(p[3]);
        if (score > best) break;
        uint32_t meta = p[0];
        int64_t w = static_cast<int64_t>(p[2]) - p[1] + 1;
        if (drand48_step(x) * static_cast<double>(w + cnt) >
            static_cast<double>(cnt)) {
          st[F_NMM] = meta & 0xFF;
          st[F_NGO] = (meta >> 8) & 0xFF;
          st[F_NGE] = (meta >> 16) & 0xFF;
          st[F_STRAND] = (meta >> 24) & 1;
          st[F_SCORE] = score;
          st[F_SA] = static_cast<int64_t>(
              p[1] + static_cast<uint32_t>(static_cast<double>(w) *
                                           drand48_step(x)));
        }
        cnt += w;
      }
      st[F_C1] = cnt;
      for (; j < na; ++j) {
        const uint32_t *p = r + 4 * j;
        cnt += static_cast<int64_t>(p[2]) - p[1] + 1;
      }
      st[F_C2] = cnt - st[F_C1];
      st[F_TYPE] = st[F_C1] > 1 ? TYPE_REPEAT : TYPE_UNIQUE;
    }
    if (n_multi > 0 && multi_n) {
      int64_t n_occ = 0;
      for (int32_t j = 0; j < na; ++j) {
        const uint32_t *p = r + 4 * j;
        n_occ += static_cast<int64_t>(p[2]) - p[1] + 1;
      }
      if (n_occ <= n_multi + 1) {
        int64_t rest = n_occ;
        int32_t m = 0;
        uint64_t main_sa = static_cast<uint64_t>(st[F_SA]);
        for (int32_t j = 0; j < na; ++j) {
          const uint32_t *p = r + 4 * j;
          int64_t sz = static_cast<int64_t>(p[2]) - p[1] + 1;
          if (sz > rest) break;  // unreachable given the cap (bwase.c:75)
          uint32_t meta = p[0];
          for (uint32_t l = p[1]; l <= p[2]; ++l) {
            if (l == main_sa) continue;  // skip the primary (s.sa)
            if (m < stride) {
              int64_t o = i * stride + m;
              multi_pos[o] = l;
              multi_gap[o] = ((meta >> 8) & 0xFF) + ((meta >> 16) & 0xFF);
              multi_mm[o] = meta & 0xFF;
              multi_strand[o] = (meta >> 24) & 1;
            }
            ++m;
          }
          rest -= sz;
        }
        // cap exactly as the Python: keep first n_multi when m > n_multi
        multi_n[i] = m > n_multi ? n_multi : m;
      }
    }
    r += 4 * static_cast<int64_t>(na);
  }
  *rng_state = x;
  return 0;
}

// Multi-hit enumeration with a PER-READ cap (the sampe multi phase,
// sampe.py:625-640 / bwape.c:400-413): same hit walk as se_select_batch's
// n_multi block, no drand48 use, keeps main fields untouched.  n_cap[i]
// <= 0 skips read i.  stride rows per read in the multi arrays.
int se_multi_batch(int64_t n, const uint32_t *recs, const int32_t *counts,
                   const int64_t *state, const int32_t *n_cap,
                   int64_t stride, uint64_t *multi_pos, int32_t *multi_gap,
                   int32_t *multi_mm, int32_t *multi_strand,
                   int32_t *multi_n) {
  const uint32_t *r = recs;
  for (int64_t i = 0; i < n; ++i) {
    int32_t na = counts[i];
    int32_t cap = n_cap[i];
    multi_n[i] = 0;
    if (na == 0 || cap <= 0) {
      r += 4 * static_cast<int64_t>(na);
      continue;
    }
    const int64_t *st = state + i * NF;
    int64_t n_occ = 0;
    for (int32_t j = 0; j < na; ++j) {
      const uint32_t *p = r + 4 * j;
      n_occ += static_cast<int64_t>(p[2]) - p[1] + 1;
    }
    if (n_occ <= cap + 1) {
      int64_t rest = n_occ;
      int64_t m = 0;
      uint64_t main_sa = static_cast<uint64_t>(st[F_SA]);
      for (int32_t j = 0; j < na; ++j) {
        const uint32_t *p = r + 4 * j;
        int64_t sz = static_cast<int64_t>(p[2]) - p[1] + 1;
        if (sz > rest) break;  // unreachable given the cap (bwase.c:75)
        uint32_t meta = p[0];
        for (uint32_t l = p[1]; l <= p[2]; ++l) {
          if (l == main_sa) continue;  // skip the primary (s.sa)
          if (m < stride) {
            int64_t o = i * stride + m;
            multi_pos[o] = l;
            multi_gap[o] = ((meta >> 8) & 0xFF) + ((meta >> 16) & 0xFF);
            multi_mm[o] = meta & 0xFF;
            multi_strand[o] = (meta >> 24) & 1;
          }
          ++m;
        }
        rest -= sz;
      }
      multi_n[i] = static_cast<int32_t>(m > cap ? cap : m);
    }
    r += 4 * static_cast<int64_t>(na);
  }
  return 0;
}

// pairing (sampe.py pairing, bwape.c:180-293) for a batch of pairs.
//
// keys: per-pair candidate arrays, flat uint64 (pos<<32 | ki<<1 | j),
// UNSORTED within a pair — sorted here (the reference introsorts the
// same keys, total order on the value).  key_off: [n_pairs+1]; an empty
// segment skips the pair (not both ends matched / over max_occ).
// recs/rec_off: per READ (2*n_pairs rows, interleaved ends) .sai record
// words — the sweep reads hit strand/score/counts by (j, ki).
// state: int64 [2*n_pairs, NF], interleaved ends; updated in place
// exactly like the Python (mapQ/seQ merges, SAM_FPP, position moves).
// pet_type: 0 = BWA_PET_STD sweep, 1 = BWA_PET_SOLID.
// ii_*: per-PAIR isize-info columns (bam2bam pairs carry per-read-group
// infos, bam2bam.c:705-811; sampe broadcasts its chunk estimate).
// Returns total cnt_chg.
int64_t pe_pairing_batch(int64_t n_pairs, uint64_t *keys,
                         const int64_t *key_off, const uint32_t *recs,
                         const int64_t *rec_off, int64_t *state,
                         int pet_type, int64_t max_isize, int s_mm,
                         const int64_t *ii_high_arr,
                         const int64_t *ii_high_bayesian_arr,
                         const double *ii_avg_arr,
                         const double *ii_std_arr) {
  constexpr uint64_t U64MAX = ~0ULL;
  int64_t cnt_chg = 0;
  for (int64_t pi = 0; pi < n_pairs; ++pi) {
    int64_t k0 = key_off[pi], k1 = key_off[pi + 1];
    if (k0 >= k1) continue;
    int64_t ii_high = ii_high_arr[pi];
    int64_t ii_high_bayesian = ii_high_bayesian_arr[pi];
    double ii_avg = ii_avg_arr[pi], ii_std = ii_std_arr[pi];
    std::sort(keys + k0, keys + k1);
    int64_t *st[2] = {state + (2 * pi) * NF, state + (2 * pi + 1) * NF};
    const uint32_t *aln[2] = {recs + rec_off[2 * pi],
                              recs + rec_off[2 * pi + 1]};
    uint32_t max_len = static_cast<uint32_t>(
        std::max(st[0][F_FULL_LEN], st[1][F_FULL_LEN]));
    uint64_t o_score = U64MAX, subo_score = U64MAX;
    int o_n = 0, subo_n = 0;
    uint64_t o_pos[2] = {U64MAX, U64MAX};
    uint64_t last_pos[2][2] = {{U64MAX, U64MAX}, {U64MAX, U64MAX}};

    auto aux = [&](uint64_t u, uint64_t v) {
      if (u == U64MAX) return;
      // bwtint_t (uint32) insert-length arithmetic, bwape.c:190
      uint32_t l = static_cast<uint32_t>(v >> 32)
          + static_cast<uint32_t>(st[v & 1][F_LEN])
          - static_cast<uint32_t>(u >> 32);
      if (!((v >> 32) > (u >> 32) && l >= max_len)) return;
      if (!((ii_high && l <= static_cast<uint64_t>(ii_high_bayesian))
            || (ii_high == 0 && l <= static_cast<uint64_t>(max_isize))))
        return;
      const uint32_t *rv = aln[v & 1] + 4 * (static_cast<uint32_t>(v) >> 1);
      const uint32_t *ru = aln[u & 1] + 4 * (static_cast<uint32_t>(u) >> 1);
      uint64_t s = static_cast<uint64_t>(static_cast<int32_t>(rv[3]))
          + static_cast<int32_t>(ru[3]);
      s *= 10;
      if (ii_high)
        s += static_cast<int>(
            -4.343 * std::log(.5 * std::erfc(std::fabs(l - ii_avg)
                                             / ii_std / M_SQRT2))
            + .499);
      s = (s << 32) | (static_cast<uint32_t>(
          hash_64(((u >> 32) << 32) | (v >> 32))));
      if ((s >> 32) == (o_score >> 32)) ++o_n;
      else if ((s >> 32) < (o_score >> 32)) { subo_n += o_n; o_n = 1; }
      else ++subo_n;
      if (s < o_score) {
        subo_score = o_score;
        o_score = s;
        o_pos[u & 1] = u;
        o_pos[v & 1] = v;
      } else if (s < subo_score) {
        subo_score = s;
      }
    };

    for (int64_t t = k0; t < k1; ++t) {
      uint64_t x = keys[t];
      int strand = (aln[x & 1][4 * (static_cast<uint32_t>(x) >> 1)]
                    >> 24) & 1;
      bool do_aux = pet_type == 0 ? strand == 1
                                  : ((strand ^ static_cast<int>(x)) & 1)
                                        != 0;
      if (do_aux) {
        int y = 1 - static_cast<int>(x & 1);
        aux(last_pos[y][1], x);
        aux(last_pos[y][0], x);
      } else {
        last_pos[x & 1][0] = last_pos[x & 1][1];
        last_pos[x & 1][1] = x;
      }
    }

    if (o_score == U64MAX) continue;
    int mapQ_p = 0;
    if (o_n == 1) {
      if (subo_score == U64MAX) {
        mapQ_p = 29;
      } else if ((subo_score >> 32) - (o_score >> 32)
                 > static_cast<uint64_t>(s_mm) * 10) {
        mapQ_p = 23;
      } else {
        int nn = subo_n > 255 ? 255 : subo_n;
        mapQ_p = static_cast<int>(((subo_score >> 32) - (o_score >> 32))
                                  / 2) - g_log_n.t[nn];
        if (mapQ_p < 0) mapQ_p = 0;
      }
    }
    int rr[2];
    for (int j = 0; j < 2; ++j)
      rr[j] = (aln[o_pos[j] & 1][4 * (static_cast<uint32_t>(o_pos[j])
                                      >> 1)] >> 24) & 1;
    bool ok0 = st[0][F_POS] == static_cast<int64_t>(o_pos[0] >> 32)
        && st[0][F_STRAND] == rr[0];
    bool ok1 = st[1][F_POS] == static_cast<int64_t>(o_pos[1] >> 32)
        && st[1][F_STRAND] == rr[1];
    if (ok0 && ok1) {
      if (st[0][F_MAPQ] > 0 && st[1][F_MAPQ] > 0) {
        int64_t mq = st[0][F_MAPQ] + st[1][F_MAPQ];
        if (mq > 60) mq = 60;
        st[0][F_MAPQ] = st[1][F_MAPQ] = mq;
      } else {
        if (st[0][F_MAPQ] == 0)
          st[0][F_MAPQ] = std::min<int64_t>(mapQ_p + 7, st[1][F_MAPQ]);
        if (st[1][F_MAPQ] == 0)
          st[1][F_MAPQ] = std::min<int64_t>(mapQ_p + 7, st[0][F_MAPQ]);
      }
    } else if (ok0) {  // end 1 moved
      st[1][F_SEQ_Q] = 0;
      st[1][F_MAPQ] = std::min<int64_t>(st[0][F_MAPQ], mapQ_p);
    } else if (ok1) {  // end 0 moved
      st[0][F_SEQ_Q] = 0;
      st[0][F_MAPQ] = std::min<int64_t>(st[1][F_MAPQ], mapQ_p);
    } else {  // both moved
      st[0][F_SEQ_Q] = st[1][F_SEQ_Q] = 0;
      mapQ_p = std::max(mapQ_p - 20, 0);
      st[0][F_MAPQ] = st[1][F_MAPQ] = mapQ_p;
    }
    for (int j = 0; j < 2; ++j) {
      uint64_t w = o_pos[j];
      const uint32_t *r = aln[w & 1] + 4 * (static_cast<uint32_t>(w) >> 1);
      int64_t *q = st[j];
      q[F_XFLAG] |= SAM_FPP;
      if (q[F_POS] != static_cast<int64_t>(w >> 32)
          || q[F_STRAND] != static_cast<int64_t>((r[0] >> 24) & 1)) {
        q[F_NMM] = r[0] & 0xFF;
        q[F_NGO] = (r[0] >> 8) & 0xFF;
        q[F_NGE] = (r[0] >> 16) & 0xFF;
        q[F_STRAND] = (r[0] >> 24) & 1;
        q[F_SCORE] = static_cast<int32_t>(r[3]);
        q[F_POS] = static_cast<int64_t>(w >> 32);
        if (q[F_MAPQ] > 0) ++cnt_chg;
      }
    }
  }
  return cnt_chg;
}

// bwa_update_bam1 (bam2bam.py update_bam1, bam2bam.c:430-593) for a
// batch: splice the finished alignment state into fresh BAM record
// blobs.  Inputs mirror the sam_emit_batch conventions (state matrix,
// flat refined cigars with the [n+1]+[n*stride+1] offset layout, flat
// MDs, multi arrays, bns columns).  Old records arrive as core-field
// columns + flat data blobs; outputs are 9 new core fields per row
// (flag,tid,pos,bin,qual,mtid,mpos,isize,n_cigar) and a fresh data blob
// per row (qname | new cigar | seq | qual | old aux | appended tags).
// Returns the total blob length (re-run with a bigger buffer if > cap).
// Mutates state F_POS/F_STRAND/F_XFLAG/F_MAPQ exactly like the Python
// (the NO_MATCH-with-mate coordinate adoption).
int64_t bam_update_batch(
    int64_t n, int64_t *state, const int64_t *mate_idx,
    const int64_t *in_flag, const int64_t *in_l_qname,
    const int64_t *in_n_cigar, const int64_t *in_l_qseq,
    const uint8_t *in_data, const int64_t *in_off,
    const int32_t *cig, const int64_t *cig_off,
    const uint8_t *md, const int64_t *md_off,
    const uint64_t *multi_pos, const int32_t *multi_gap,
    const int32_t *multi_mm, const int32_t *multi_strand,
    const int32_t *multi_n, int64_t stride,
    const int32_t *max_entries, int debug_bam,
    int n_seqs, const int64_t *ann_off, const int64_t *ann_len,
    const uint8_t *ann_names, const int64_t *ann_name_off,
    int64_t n_holes, const int64_t *amb_off, const int32_t *amb_len_a,
    int64_t l_pac, int mode, int64_t max_top2,
    int64_t *out_fields, uint8_t *out_data, int64_t out_cap,
    int64_t *out_off) {
  Bns bns{n_seqs, ann_off, ann_len, ann_names, ann_name_off,
          n_holes, amb_off, amb_len_a, nullptr, l_pac};
  // revcom1 (bam2bam.c:109-126): bit-reversal of the byte swaps and
  // complements both nt16 nybbles at once
  static uint8_t revcom1[256];
  static bool rc_init = false;
  if (!rc_init) {
    for (int i = 0; i < 256; ++i) {
      uint8_t v = 0;
      for (int b = 0; b < 8; ++b)
        if (i & (1 << b)) v |= 1 << (7 - b);
      revcom1[i] = v;
    }
    rc_init = true;
  }
  static const int CIG_BAM_OP[4] = {0, 1, 2, 4};
  constexpr int FSR = 16, FSC = 256;
  Writer w{out_data, out_cap, 0, false};

  auto reg2bin = [](int64_t beg, int64_t end) -> int64_t {
    --end;
    if (beg >> 14 == end >> 14) return 4681 + (beg >> 14);
    if (beg >> 17 == end >> 17) return 585 + (beg >> 17);
    if (beg >> 20 == end >> 20) return 73 + (beg >> 20);
    if (beg >> 23 == end >> 23) return 9 + (beg >> 23);
    if (beg >> 26 == end >> 26) return 1 + (beg >> 26);
    return 0;
  };
  auto push_int = [&](char u, char v, int64_t x) {
    char t[3] = {u, v, 'i'};
    w.bytes(reinterpret_cast<const uint8_t *>(t), 3);
    uint32_t val = static_cast<uint32_t>(x);
    w.bytes(reinterpret_cast<const uint8_t *>(&val), 4);
  };
  auto push_char = [&](char u, char v, char c) {
    char t[4] = {u, v, 'A', c};
    w.bytes(reinterpret_cast<const uint8_t *>(t), 4);
  };

  for (int64_t i = 0; i < n; ++i) {
    out_off[i] = w.len;
    int64_t *st = state + i * NF;
    int64_t mi = mate_idx[i];
    int64_t *mt = mi >= 0 ? state + mi * NF : nullptr;
    int64_t flag = in_flag[i];
    int64_t l_qname = in_l_qname[i], l_qseq = in_l_qseq[i];
    const uint8_t *ind = in_data + in_off[i];
    int64_t in_len = in_off[i + 1] - in_off[i];
    int64_t old_cig_off = l_qname;
    int64_t seq_src = l_qname + 4 * in_n_cigar[i];
    int64_t nbytes = (l_qseq + 1) / 2;
    int64_t qual_src = seq_src + nbytes;
    int64_t aux_src = qual_src + l_qseq;
    (void)old_cig_off;

    int64_t c0 = cig_off[i], c1 = cig_off[i + 1];
    bool has_cigar = c1 > c0;
    int64_t tid, pos_out, bin, qual, mtid, mpos, isize, n_cig_new;
    bool revcom = false;

    bool s_matched = st[F_TYPE] != TYPE_NO_MATCH;
    bool m_matched = mt && mt[F_TYPE] != TYPE_NO_MATCH;
    if (s_matched || m_matched) {
      int64_t am = 0, j;
      if (!s_matched) {
        st[F_POS] = mt[F_POS];
        st[F_STRAND] = mt[F_STRAND];
        st[F_XFLAG] |= SAM_FSU;
        j = 1;
      } else {
        j = pos_end(state, cig, cig_off, i) - st[F_POS];
      }
      revcom = (st[F_STRAND] != 0) != ((flag & FSR) != 0);
      if (revcom) flag ^= FSR;
      flag &= ~(SAM_FPP | SAM_FSU | SAM_FMU | FSC | SAM_FMR);
      flag |= st[F_XFLAG];

      int64_t seqid, nn;
      coor_pac2real(bns, st[F_POS], j, &seqid, &nn);
      if (s_matched
          && st[F_POS] + j - ann_off[seqid] > ann_len[seqid]) {
        flag |= SAM_FSU;
        flag &= ~SAM_FPP;
        st[F_MAPQ] = 0;
      }
      tid = seqid;
      pos_out = st[F_POS] - ann_off[seqid];
      bin = reg2bin(pos_out,
                    pos_end(state, cig, cig_off, i) - ann_off[seqid]);
      qual = st[F_MAPQ];
      n_cig_new = has_cigar ? (c1 - c0) / 2 : (s_matched ? 1 : 0);

      if (m_matched) {
        am = std::min(mt[F_SEQ_Q], st[F_SEQ_Q]);
        int64_t m_seqid, m_nn;
        coor_pac2real(bns, mt[F_POS], mt[F_LEN], &m_seqid, &m_nn);
        nn += m_nn;
        int64_t m_j = pos_end(state, cig, cig_off, mi) - mt[F_POS];
        if (mt[F_POS] + m_j - ann_off[m_seqid] > ann_len[m_seqid]) {
          flag |= SAM_FMU;
          flag &= ~SAM_FPP;
        }
        if (mt[F_STRAND]) flag |= SAM_FMR;
        mtid = m_seqid;
        mpos = mt[F_POS] - ann_off[m_seqid];
        if (!s_matched) {
          isize = 0;
        } else {
          isize = seqid == m_seqid
              ? pos_5(state, cig, cig_off, mi)
                    - pos_5(state, cig, cig_off, i)
              : 0;
        }
      } else if (mt) {
        flag |= SAM_FMU;
        flag &= ~SAM_FPP;
        mtid = seqid;
        mpos = st[F_POS] - ann_off[seqid];
        isize = 0;
      } else {
        mtid = -1;
        mpos = -1;
        isize = 0;
      }

      // ---- data blob: qname | new cigar | seq' | qual' | aux ----
      w.bytes(ind, l_qname);
      if (has_cigar) {
        for (int64_t c = c0; c < c1; c += 2) {
          uint32_t word = (static_cast<uint32_t>(cig[c + 1]) << 4)
              | CIG_BAM_OP[cig[c] & 3];
          w.bytes(reinterpret_cast<const uint8_t *>(&word), 4);
        }
      } else if (s_matched) {
        uint32_t word = static_cast<uint32_t>(st[F_LEN]) << 4;
        w.bytes(reinterpret_cast<const uint8_t *>(&word), 4);
      }
      if (revcom) {
        // revcom_bam1 (bam2bam.c:335-362)
        if (w.len + nbytes <= w.cap) {
          uint8_t *dst = w.buf + w.len;
          for (int64_t b = 0; b < nbytes; ++b)
            dst[b] = revcom1[ind[seq_src + nbytes - 1 - b]];
          if (l_qseq & 1) {
            for (int64_t b = 0; b < nbytes - 1; ++b)
              dst[b] = static_cast<uint8_t>(((dst[b] & 0x0F) << 4)
                                            | ((dst[b + 1] & 0xF0) >> 4));
            dst[nbytes - 1] = static_cast<uint8_t>((dst[nbytes - 1]
                                                    & 0x0F) << 4);
          }
        } else {
          w.overflow = true;
        }
        w.len += nbytes;
        if (w.len + l_qseq <= w.cap) {
          uint8_t *dst = w.buf + w.len;
          for (int64_t b = 0; b < l_qseq; ++b)
            dst[b] = ind[qual_src + l_qseq - 1 - b];
        } else {
          w.overflow = true;
        }
        w.len += l_qseq;
      } else {
        w.bytes(ind + seq_src, nbytes + l_qseq);
      }
      w.bytes(ind + aux_src, in_len - aux_src);

      // ---- tag pushes (same append order as the Python) ----
      if (st[F_CLIP_LEN] < st[F_FULL_LEN])
        push_int('X', 'C', st[F_CLIP_LEN]);
      if (max_entries && max_entries[i] && debug_bam)
        push_int('Y', 'Q', max_entries[i]);
      if (s_matched) {
        char xt = "NURM"[st[F_TYPE] & 3];
        if (nn > 10) xt = 'N';
        push_char('X', 'T', xt);
        if (mode & MODE_COMPREAD) push_int('N', 'M', st[F_NM]);
        else push_int('C', 'M', st[F_NM]);
        if (nn) push_int('X', 'N', nn);
        if (mt) {
          push_int('S', 'M', st[F_SEQ_Q]);
          push_int('A', 'M', am);
        }
        if (st[F_TYPE] != TYPE_MATESW) {
          push_int('X', '0', st[F_C1]);
          if (st[F_C1] <= max_top2) push_int('X', '1', st[F_C2]);
        }
        push_int('X', 'M', st[F_NMM]);
        push_int('X', 'O', st[F_NGO]);
        push_int('X', 'G', st[F_NGO] + st[F_NGE]);
        if (md_off[i + 1] > md_off[i]) {
          char t[3] = {'M', 'D', 'Z'};
          w.bytes(reinterpret_cast<const uint8_t *>(t), 3);
          w.bytes(md + md_off[i], md_off[i + 1] - md_off[i]);
          w.put('\0');
        }
        if (multi_n && multi_n[i]) {
          char t[3] = {'X', 'A', 'Z'};
          w.bytes(reinterpret_cast<const uint8_t *>(t), 3);
          char tmp[32];
          for (int32_t m = 0; m < multi_n[i]; ++m) {
            int64_t o = i * stride + m;
            int64_t mc0 = cig_off[n + 1 + o], mc1 = cig_off[n + 2 + o];
            int64_t mpos_p = static_cast<int64_t>(multi_pos[o]);
            int64_t jj;
            if (mc1 > mc0) {
              jj = 0;
              for (int64_t c = mc0; c < mc1; c += 2)
                if (cig[c] == 0 || cig[c] == 2) jj += cig[c + 1];
            } else {
              jj = st[F_LEN];
            }
            int64_t sid, dummy_nn;
            coor_pac2real(bns, mpos_p, jj, &sid, &dummy_nn);
            w.bytes(ann_names + ann_name_off[sid],
                    ann_name_off[sid + 1] - ann_name_off[sid]);
            w.put(',');
            w.put(multi_strand[o] ? '-' : '+');
            w.num(mpos_p - ann_off[sid] + 1);
            w.put(',');
            if (mc1 > mc0) {
              for (int64_t c = mc0; c < mc1; c += 2) {
                w.num(cig[c + 1]);
                w.put(CIGAR_CHR[cig[c] & 3]);
              }
            } else {
              int nw = std::snprintf(tmp, sizeof tmp, "%lldM",
                                     static_cast<long long>(st[F_LEN]));
              w.bytes(reinterpret_cast<const uint8_t *>(tmp), nw);
            }
            w.put(',');
            w.num(multi_gap[o] + multi_mm[o]);
            w.put(';');
          }
          w.put('\0');
        }
      }
    } else {  // neither end matched (bam2bam.c:576-592)
      tid = -1;
      pos_out = -1;
      bin = 0;
      qual = 0;
      mtid = -1;
      mpos = -1;
      isize = 0;
      flag &= ~(SAM_FPP | SAM_FMU | FSC);
      flag |= SAM_FSU;
      if (mt) flag |= SAM_FMU;   // mate exists and is NO_MATCH here
      n_cig_new = 0;
      w.bytes(ind, l_qname);
      w.bytes(ind + seq_src, nbytes + l_qseq);
      w.bytes(ind + aux_src, in_len - aux_src);
      if (st[F_CLIP_LEN] < st[F_FULL_LEN])
        push_int('X', 'C', st[F_CLIP_LEN]);
      if (max_entries && max_entries[i] && debug_bam)
        push_int('Y', 'Q', max_entries[i]);
    }

    int64_t *of = out_fields + i * 9;
    of[0] = flag;
    of[1] = tid;
    of[2] = pos_out;
    of[3] = bin;
    of[4] = qual;
    of[5] = mtid;
    of[6] = mpos;
    of[7] = isize;
    of[8] = n_cig_new;
  }
  out_off[n] = w.len;
  return w.len;
}

// bwa_cal_md1 (samse.py cal_md1, bwase.c:253-315) for a batch.
// seqs: strand-resolved read codes (forward reference orientation),
// flat + offsets.  cig counts of <=0 pairs = no cigar.  md_out must hold
// >= 2*total_seq_len + 16*n bytes; per-read [md_off[i], md_off[i+1]).
// Fills state F_NM.  Skips reads with TYPE_NO_MATCH.
int md_batch(int64_t n, int64_t *state, const uint8_t *seqs,
             const int64_t *seq_off, const int32_t *cig,
             const int64_t *cig_off, const uint8_t *pac, int64_t l_pac,
             int64_t n_holes, const int64_t *amb_off,
             const int32_t *amb_len, const uint8_t *amb_chr,
             uint8_t *md_out, int64_t md_cap, int64_t *md_off,
             int n_threads) {
  // Rows are independent (own state row + read-only pac walk), so ranges
  // emit into disjoint scratch slices and compact in order.
  auto md_rows = [&](int64_t lo, int64_t hi, uint8_t *obuf,
                     int64_t ocap) -> int64_t {
  int64_t w = 0;
  for (int64_t i = lo; i < hi; ++i) {
    md_off[i] = w;
    int64_t *st = state + i * NF;
    if (st[F_TYPE] == TYPE_NO_MATCH) continue;
    const uint8_t *seq = seqs + seq_off[i];
    int64_t seq_len = seq_off[i + 1] - seq_off[i];
    int64_t pos = st[F_POS];

    // first hole ending after pos (bwase.c:263-268)
    int64_t left = 0, right = n_holes;
    while (left < right) {
      int64_t mid = left + ((right - left) >> 1);
      if (pos >= amb_off[mid] + amb_len[mid]) left = mid + 1;
      else if (pos < amb_off[mid]) right = mid;
      else { left = right = mid; }
    }
    int64_t ridx = right;

    int64_t nm = 0, u = 0, p = pos;
    auto get_ref = [&]() -> int {
      if (ridx < n_holes && p >= amb_off[ridx]) return amb_chr[ridx];
      return pac[p];
    };
    auto advance = [&]() {
      ++p;
      if (ridx < n_holes && p >= amb_off[ridx] + amb_len[ridx]) ++ridx;
    };
    auto put = [&](char c) {
      if (w < ocap) obuf[w] = static_cast<uint8_t>(c);
      ++w;
    };
    auto put_num = [&](int64_t v) {
      char tmp[24];
      int k = std::snprintf(tmp, sizeof tmp, "%lld",
                            static_cast<long long>(v));
      for (int t = 0; t < k; ++t) put(tmp[t]);
    };

    int64_t c0 = cig_off[i], c1 = cig_off[i + 1];
    if (c1 > c0) {
      int64_t y = 0;
      for (int64_t c = c0; c < c1; c += 2) {
        int op = cig[c];
        int32_t ln = cig[c + 1];
        if (op == 0) {            // M
          for (int32_t z = 0; z < ln; ++z) {
            if (p >= l_pac) break;
            int cc = get_ref();
            if (cc > 3 || seq[y] > 3 || cc != seq[y]) {
              put_num(u);
              put(cc > 3 ? static_cast<char>(cc) : FWD_BASES[cc]);
              ++nm;
              u = 0;
            } else {
              ++u;
            }
            advance();
            ++y;
          }
        } else if (op == 1 || op == 3) {   // I or S
          y += ln;
          if (op == 1) nm += ln;
        } else if (op == 2) {     // D
          put_num(u);
          put('^');
          for (int32_t z = 0; z < ln; ++z) {
            if (p >= l_pac) break;
            int cc = get_ref();
            put(cc > 3 ? static_cast<char>(cc) : FWD_BASES[cc]);
            advance();
          }
          u = 0;
          nm += ln;
        }
      }
    } else {
      for (int64_t z = 0; z < seq_len; ++z) {
        int cc = get_ref();
        if (cc > 3 || seq[z] > 3 || cc != seq[z]) {
          put_num(u);
          put(cc > 3 ? static_cast<char>(cc) : FWD_BASES[cc]);
          ++nm;
          u = 0;
        } else {
          ++u;
        }
        advance();
      }
    }
    put_num(u);
    st[F_NM] = nm;
  }
  return w;
  };  // md_rows

  int nth = n_threads > 0 ? n_threads
      : static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0 && nth > static_cast<int>(n / 4096))
    nth = static_cast<int>(n / 4096);
  if (nth > n) nth = static_cast<int>(n);
  if (nth <= 1) {
    int64_t w = md_rows(0, n, md_out, md_cap);
    md_off[n] = w;
    return w <= md_cap ? 0 : -1;
  }

  std::vector<int64_t> bnd(nth + 1, 0), cut(nth + 1, n), lens(nth, 0);
  cut[0] = 0;
  for (int t = 1; t < nth; ++t) cut[t] = n * t / nth;
  for (int t = 0; t < nth; ++t) {
    int64_t b = 0;
    for (int64_t i = cut[t]; i < cut[t + 1]; ++i)
      b += 4 * (seq_off[i + 1] - seq_off[i]) + 32;
    bnd[t + 1] = bnd[t] + b;
  }
  std::unique_ptr<uint8_t[]> scratch(new uint8_t[bnd[nth]]);
  std::vector<std::thread> ts;
  for (int t = 0; t < nth; ++t)
    ts.emplace_back([&, t]() {
      lens[t] = md_rows(cut[t], cut[t + 1], scratch.get() + bnd[t],
                        bnd[t + 1] - bnd[t]);
    });
  for (auto &th : ts) th.join();
  for (int t = 0; t < nth; ++t)
    if (lens[t] > bnd[t + 1] - bnd[t]) {
      // bound breach (should be impossible): redo sequentially — safe,
      // rows only assign their own state/offsets
      int64_t w = md_rows(0, n, md_out, md_cap);
      md_off[n] = w;
      return w <= md_cap ? 0 : -1;
    }
  int64_t total = 0;
  for (int t = 0; t < nth; ++t) {
    // rebase this range's offsets from slice-local to global
    for (int64_t i = cut[t]; i < cut[t + 1]; ++i) md_off[i] += total;
    if (total + lens[t] <= md_cap)
      std::memcpy(md_out + total, scratch.get() + bnd[t],
                  static_cast<size_t>(lens[t]));
    total += lens[t];
  }
  md_off[n] = total;
  return total <= md_cap ? 0 : -1;
}

// bwa_print_sam1 (samse.py print_sam1, bwase.c:458-592) for a batch, with
// optional mates via mate_idx (row index into the same batch, -1 = none).
// Rows MUST be in print order: state mutations (bridging fix-ups,
// unmapped-mate position adoption) are applied in sequence exactly like
// the per-record Python.  Returns total bytes (> out_cap on overflow:
// re-call with a bigger buffer).
int64_t sam_emit_batch(
    int64_t n, int64_t *state, const int64_t *mate_idx,
    const uint8_t *names, const int64_t *name_off,
    const uint8_t *bcs, const int64_t *bc_off,
    const int32_t *cig, const int64_t *cig_off,
    const uint8_t *md, const int64_t *md_off,
    const uint8_t *seqs, const int64_t *seq_off,
    const uint8_t *quals, const int64_t *qual_off,
    const uint64_t *multi_pos, const int32_t *multi_gap,
    const int32_t *multi_mm, const int32_t *multi_strand,
    const int32_t *multi_n, int64_t multi_stride,
    int n_seqs, const int64_t *ann_off, const int64_t *ann_len,
    const uint8_t *ann_names, const int64_t *ann_name_off,
    int64_t n_holes, const int64_t *amb_off, const int32_t *amb_len,
    const uint8_t *amb_chr, int64_t l_pac,
    int mode, int max_top2, const uint8_t *rg, int64_t rg_len,
    uint8_t *out, int64_t out_cap, int n_threads) {
  Bns bns{n_seqs, ann_off, ann_len, ann_names, ann_name_off,
          n_holes, amb_off, amb_len, amb_chr, l_pac};
  // Rows are emitted by ranges.  Cross-row traffic is mate-local only
  // (mate_idx pairs), and a row's state mutations are idempotent
  // assignments from fields its mate never writes, so any split at a
  // pair boundary reproduces the sequential byte stream exactly.
  auto emit_rows = [&](int64_t lo, int64_t hi, Writer &wtr) {
  for (int64_t i = lo; i < hi; ++i) {
    int64_t *st = state + i * NF;
    int64_t mi = mate_idx ? mate_idx[i] : -1;
    int64_t *mt = mi >= 0 ? state + mi * NF : nullptr;
    const uint8_t *name = names + name_off[i];
    int64_t name_len = name_off[i + 1] - name_off[i];
    const uint8_t *seq_full = seqs + seq_off[i];
    int64_t full = seq_off[i + 1] - seq_off[i];
    const uint8_t *qual = quals + qual_off[i];
    int64_t qlen = qual_off[i + 1] - qual_off[i];

    auto emit_qual = [&]() {
      if (qlen == 0) { wtr.put('*'); return; }
      if (st[F_STRAND]) {
        // reverse only the first len chars (bwase.c:528-531)
        int64_t m = st[F_LEN] < qlen ? st[F_LEN] : qlen;
        for (int64_t z = m - 1; z >= 0; --z)
          wtr.put(static_cast<char>(qual[z]));
        for (int64_t z = m; z < qlen; ++z)
          wtr.put(static_cast<char>(qual[z]));
      } else {
        wtr.bytes(qual, qlen);
      }
    };
    auto emit_common_tags = [&]() {
      if (rg_len) {
        wtr.str("\tRG:Z:");
        wtr.bytes(rg, rg_len);
      }
      if (bc_off[i + 1] > bc_off[i]) {
        wtr.str("\tBC:Z:");
        wtr.bytes(bcs + bc_off[i], bc_off[i + 1] - bc_off[i]);
      }
      if (st[F_CLIP_LEN] < st[F_FULL_LEN]) {
        wtr.str("\tXC:i:");
        wtr.num(st[F_CLIP_LEN]);
      }
    };
    auto emit_cigar = [&](int64_t row, const int32_t *cg,
                          const int64_t *cgo, int64_t deflen) {
      int64_t c0 = cgo[row], c1 = cgo[row + 1];
      if (c1 > c0) {
        for (int64_t c = c0; c < c1; c += 2) {
          wtr.num(cg[c + 1]);
          wtr.put(CIGAR_CHR[cg[c]]);
        }
      } else {
        wtr.num(deflen);
        wtr.put('M');
      }
    };

    bool s_match = st[F_TYPE] != TYPE_NO_MATCH;
    bool m_match = mt && mt[F_TYPE] != TYPE_NO_MATCH;
    if (s_match || m_match) {
      int64_t flag = st[F_XFLAG];
      int64_t j;
      if (!s_match) {
        st[F_POS] = mt[F_POS];
        st[F_STRAND] = mt[F_STRAND];
        flag |= SAM_FSU;
        flag &= ~SAM_FPP;
        j = 1;
      } else {
        j = pos_end(state, cig, cig_off, i) - st[F_POS];
      }
      int64_t seqid, nn;
      coor_pac2real(bns, st[F_POS], j, &seqid, &nn);
      if (s_match &&
          st[F_POS] + j - ann_off[seqid] > ann_len[seqid]) {
        flag |= SAM_FSU;   // bridges two reference sequences
        flag &= ~SAM_FPP;
        st[F_MAPQ] = 0;
      }
      if (st[F_STRAND]) flag |= SAM_FSR;
      int64_t m_seqid = -1, am = 0;
      if (mt) {
        if (m_match) {
          int64_t m_nn;
          coor_pac2real(bns, mt[F_POS], mt[F_LEN], &m_seqid, &m_nn);
          nn += m_nn;
          int64_t m_j = pos_end(state, cig, cig_off, mi) - mt[F_POS];
          if (mt[F_POS] + m_j - ann_off[m_seqid] > ann_len[m_seqid]) {
            flag |= SAM_FMU;
            flag &= ~SAM_FPP;
          }
          if (mt[F_STRAND]) flag |= SAM_FMR;
        } else {
          flag |= SAM_FMU;
          flag &= ~SAM_FPP;
        }
      }
      wtr.bytes(name, name_len);
      wtr.put('\t');
      wtr.num(flag);
      wtr.put('\t');
      wtr.bytes(ann_names + ann_name_off[seqid],
                ann_name_off[seqid + 1] - ann_name_off[seqid]);
      wtr.put('\t');
      wtr.num(st[F_POS] - ann_off[seqid] + 1);
      wtr.put('\t');
      wtr.num(st[F_MAPQ]);
      wtr.put('\t');
      if (cig_off[i + 1] > cig_off[i]) {
        emit_cigar(i, cig, cig_off, 0);
      } else if (!s_match) {
        wtr.put('*');
      } else {
        wtr.num(st[F_LEN]);
        wtr.put('M');
      }
      if (mt && m_match) {
        am = mt[F_SEQ_Q] < st[F_SEQ_Q] ? mt[F_SEQ_Q] : st[F_SEQ_Q];
        wtr.put('\t');
        if (seqid == m_seqid) wtr.put('=');
        else
          wtr.bytes(ann_names + ann_name_off[m_seqid],
                    ann_name_off[m_seqid + 1] - ann_name_off[m_seqid]);
        wtr.put('\t');
        int64_t isize = 0;
        if (seqid == m_seqid)
          isize = pos_5(state, cig, cig_off, mi) -
                  pos_5(state, cig, cig_off, i);
        if (!s_match) isize = 0;
        wtr.num(mt[F_POS] - ann_off[m_seqid] + 1);
        wtr.put('\t');
        wtr.num(isize);
        wtr.put('\t');
      } else if (mt) {
        wtr.str("\t=\t");
        wtr.num(st[F_POS] - ann_off[seqid] + 1);
        wtr.str("\t0\t");
      } else {
        wtr.str("\t*\t0\t0\t");
      }
      // seq (original orientation codes; reverse-complement if strand)
      if (st[F_STRAND] == 0)
        for (int64_t z = 0; z < full; ++z) wtr.put(FWD_BASES[seq_full[z]]);
      else
        for (int64_t z = full - 1; z >= 0; --z)
          wtr.put(REV_BASES[seq_full[z]]);
      wtr.put('\t');
      emit_qual();
      emit_common_tags();
      if (s_match) {
        char xt = "NURM"[st[F_TYPE]];
        if (nn > 10) xt = 'N';
        wtr.str("\tXT:A:");
        wtr.put(xt);
        wtr.put('\t');
        wtr.str((mode & MODE_COMPREAD) ? "NM" : "CM");
        wtr.str(":i:");
        wtr.num(st[F_NM]);
        if (nn) {
          wtr.str("\tXN:i:");
          wtr.num(nn);
        }
        if (mt) {
          wtr.str("\tSM:i:");
          wtr.num(st[F_SEQ_Q]);
          wtr.str("\tAM:i:");
          wtr.num(am);
        }
        if (st[F_TYPE] != TYPE_MATESW) {
          wtr.str("\tX0:i:");
          wtr.num(st[F_C1]);
          if (st[F_C1] <= max_top2) {
            wtr.str("\tX1:i:");
            wtr.num(st[F_C2]);
          }
        }
        wtr.str("\tXM:i:");
        wtr.num(st[F_NMM]);
        wtr.str("\tXO:i:");
        wtr.num(st[F_NGO]);
        wtr.str("\tXG:i:");
        wtr.num(st[F_NGO] + st[F_NGE]);
        if (md_off[i + 1] > md_off[i]) {
          wtr.str("\tMD:Z:");
          wtr.bytes(md + md_off[i], md_off[i + 1] - md_off[i]);
        }
        int32_t nmu = multi_n ? multi_n[i] : 0;
        if (nmu > 0) {
          wtr.str("\tXA:Z:");
          for (int32_t m = 0; m < nmu; ++m) {
            int64_t o = i * multi_stride + m;
            int64_t mp = static_cast<int64_t>(multi_pos[o]);
            // pos_end for the multi: cigar M/D span, else s.len.
            // Multi cigars ride the same flat `cig` array; their offsets
            // are appended to cig_off after the n+1 read offsets
            // (layout: cig_off[0..n] reads, cig_off[n+1 ..] multis).
            int64_t span = st[F_LEN];
            const int64_t *mc_off = cig_off + (n + 1);
            int64_t c0 = mc_off[o], c1 = mc_off[o + 1];
            if (c1 > c0) {
              span = 0;
              for (int64_t c = c0; c < c1; c += 2)
                if (cig[c] == 0 || cig[c] == 2) span += cig[c + 1];
            }
            int64_t sid, dummy;
            coor_pac2real(bns, mp, span, &sid, &dummy);
            wtr.bytes(ann_names + ann_name_off[sid],
                      ann_name_off[sid + 1] - ann_name_off[sid]);
            wtr.put(',');
            wtr.put(multi_strand[o] ? '-' : '+');
            wtr.num(mp - ann_off[sid] + 1);
            wtr.put(',');
            if (c1 > c0) {
              for (int64_t c = c0; c < c1; c += 2) {
                wtr.num(cig[c + 1]);
                wtr.put(CIGAR_CHR[cig[c]]);
              }
            } else {
              wtr.num(st[F_LEN]);
              wtr.put('M');
            }
            wtr.put(',');
            wtr.num(multi_gap[o] + multi_mm[o]);
            wtr.put(';');
          }
        }
      }
    } else {
      // no match at all (bwase.c:570-592)
      int64_t flag = st[F_XFLAG] | SAM_FSU;
      if (mt && !m_match) flag |= SAM_FMU;
      wtr.bytes(name, name_len);
      wtr.put('\t');
      wtr.num(flag);
      wtr.str("\t*\t0\t0\t*\t*\t0\t0\t");
      if (st[F_STRAND]) {
        for (int64_t z = 0; z < st[F_LEN]; ++z) {
          uint8_t c = seq_full[full - 1 - z];
          wtr.put(FWD_BASES[c < 4 ? 3 - c : c]);
        }
      } else {
        for (int64_t z = 0; z < st[F_LEN]; ++z)
          wtr.put(FWD_BASES[seq_full[z]]);
      }
      wtr.put('\t');
      emit_qual();
      emit_common_tags();
      if (mt && m_match) {
        int64_t sid, nn;
        coor_pac2real(bns, mt[F_POS], mt[F_LEN], &sid, &nn);
        if (nn) {
          wtr.str("\tXN:i:");
          wtr.num(nn);
        }
      }
    }
    wtr.put('\n');
  }
  };  // emit_rows

  // auto mode self-caps on small batches (thread spawn ~50 us each);
  // an explicit n_threads bypasses the cap so tests can drive the
  // threaded path on tiny inputs
  int nth = n_threads > 0 ? n_threads
      : static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0 && nth > static_cast<int>(n / 2048))
    nth = static_cast<int>(n / 2048);
  if (nth > n) nth = static_cast<int>(n);
  if (nth <= 1) {
    Writer wtr{out, out_cap, 0, false};
    emit_rows(0, n, wtr);
    return wtr.len;
  }

  // per-row output upper bound (digits, tags and both reference names
  // included), so each thread's scratch slice can never overflow
  int64_t maxann = 1;
  for (int s = 0; s < n_seqs; ++s) {
    int64_t ln = ann_name_off[s + 1] - ann_name_off[s];
    if (ln > maxann) maxann = ln;
  }
  const int64_t *mc_off = cig_off + (n + 1);
  std::vector<int64_t> bnd(n + 1);
  bnd[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t b = 256 + 2 * maxann + rg_len + 24
        + (name_off[i + 1] - name_off[i])
        + (seq_off[i + 1] - seq_off[i])
        + (qual_off[i + 1] - qual_off[i])
        + 6 * (cig_off[i + 1] - cig_off[i])
        + (md_off[i + 1] - md_off[i])
        + (bc_off[i + 1] - bc_off[i]);
    int32_t nmu = multi_n ? multi_n[i] : 0;
    for (int32_t m = 0; m < nmu; ++m) {
      int64_t o = i * multi_stride + m;
      b += maxann + 64 + 6 * (mc_off[o + 1] - mc_off[o]);
    }
    bnd[i + 1] = bnd[i] + b;
  }

  // range boundaries at pair edges (mate_idx is intra-pair by contract)
  std::vector<int64_t> cut(nth + 1, n);
  cut[0] = 0;
  for (int t = 1; t < nth; ++t) {
    int64_t c = n * t / nth;
    if (mate_idx && (c & 1)) ++c;
    cut[t] = c > n ? n : c;
  }

  // uninitialized scratch: a zeroing vector costs ~100 ms of page
  // faults at 200k rows (the bound sum is ~3x the real output)
  std::unique_ptr<uint8_t[]> scratch(new uint8_t[bnd[n]]);
  std::vector<Writer> wts(nth);
  std::vector<std::thread> ts;
  for (int t = 0; t < nth; ++t) {
    wts[t] = Writer{scratch.get() + bnd[cut[t]],
                    bnd[cut[t + 1]] - bnd[cut[t]], 0, false};
    ts.emplace_back([&, t]() { emit_rows(cut[t], cut[t + 1], wts[t]); });
  }
  for (auto &th : ts) th.join();
  int64_t total = 0;
  bool over = false;
  for (int t = 0; t < nth; ++t) {
    total += wts[t].len;
    over |= wts[t].overflow;
  }
  if (over) {
    // bound breach (should be impossible): redo sequentially — safe,
    // the per-row state mutations are idempotent (see emit_rows note)
    Writer wtr{out, out_cap, 0, false};
    emit_rows(0, n, wtr);
    return wtr.len;
  }
  if (total <= out_cap) {
    int64_t pos = 0;
    for (int t = 0; t < nth; ++t) {
      std::memcpy(out + pos, scratch.get() + bnd[cut[t]],
                  static_cast<size_t>(wts[t].len));
      pos += wts[t].len;
    }
  }
  return total;
}

}  // extern "C"
