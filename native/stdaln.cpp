// Native banded-global and extension DP kernels — bit-exact ports of the
// scalar models (refmodel/stdaln_scalar.py aln_global_core,
// refmodel/extend_scalar.py aln_extend_core), which themselves replicate
// the reference stdaln.c:345-525 and :862-1007 including tie-break order
// (M >= I, I > D) and the banded five-part loop structure.
//
// These are the host half of DP kernels #3/#5: the batched XLA versions
// (nabwa_tpu/ops/dp.py) carry large batches on the GPU; small batches,
// and every batch where no device runs, are solved here instead.
// Exposed via plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t MINOR_INF = -1073741823;
constexpr uint8_t FROM_M = 0, FROM_I = 1, FROM_D = 2;

struct Lattice {
    int len1, len2;
    std::vector<int32_t> M, I, D;
    std::vector<uint8_t> Mt, It, Dt;
    const int32_t* mat;
    int row;
    int32_t go, ge, gend;

    Lattice(int l1, int l2, const int32_t* m, int r, int32_t go_,
            int32_t ge_, int32_t gend_)
        : len1(l1), len2(l2),
          M((size_t)(l2 + 1) * (l1 + 1), MINOR_INF),
          I((size_t)(l2 + 1) * (l1 + 1), MINOR_INF),
          D((size_t)(l2 + 1) * (l1 + 1), MINOR_INF),
          Mt((size_t)(l2 + 1) * (l1 + 1), 0),
          It((size_t)(l2 + 1) * (l1 + 1), 0),
          Dt((size_t)(l2 + 1) * (l1 + 1), 0),
          mat(m), row(r), go(go_), ge(ge_), gend(gend_) {}

    inline size_t at(int j, int i) const {
        return (size_t)j * (len1 + 1) + i;
    }

    inline void set_m(int j, int i, int32_t sc) {
        size_t p = at(j - 1, i - 1), c = at(j, i);
        int32_t pm = M[p], pi = I[p], pd = D[p];
        if (pm >= pi) {
            if (pm >= pd) { M[c] = pm + sc; Mt[c] = FROM_M; }
            else          { M[c] = pd + sc; Mt[c] = FROM_D; }
        } else {
            if (pi > pd)  { M[c] = pi + sc; Mt[c] = FROM_I; }
            else          { M[c] = pd + sc; Mt[c] = FROM_D; }
        }
    }

    inline void set_i(int j, int i, int32_t ext) {
        size_t p = at(j - 1, i), c = at(j, i);
        int32_t pm = M[p], pi = I[p];
        if (pm - go > pi) { It[c] = FROM_M; I[c] = pm - go - ext; }
        else              { It[c] = FROM_I; I[c] = pi - ext; }
    }
    inline void set_end_i(int j, int i) {
        set_i(j, i, gend >= 0 ? gend : ge);
    }

    inline void set_d(int j, int i, int32_t ext) {
        size_t p = at(j, i - 1), c = at(j, i);
        int32_t pm = M[p], pd = D[p];
        if (pm - go > pd) { Dt[c] = FROM_M; D[c] = pm - go - ext; }
        else              { Dt[c] = FROM_D; D[c] = pd - ext; }
    }
    inline void set_end_d(int j, int i) {
        set_d(j, i, gend >= 0 ? gend : ge);
    }
};

// aln_global_core (stdaln.c:345-525 via the scalar model).  seq1/seq2:
// base codes (1-based use; pass raw arrays).  path_out receives the
// ctype sequence of the returned path (last-to-first, already truncated
// like the scalar's path[:-1]); *path_n its length.  Returns the score.
static int32_t global_core(const uint8_t* seq1, int len1,
                           const uint8_t* seq2, int len2,
                           const int32_t* mat, int row,
                           int32_t go, int32_t ge, int32_t gend, int band,
                           uint8_t* path_out, int64_t path_cap,
                           int64_t* path_n) {
    *path_n = 0;
    if (len1 == 0 || len2 == 0) return 0;
    int b1, b2;
    if (len1 > len2) { b1 = len1 - len2 + band; b2 = band; }
    else             { b1 = band; b2 = len2 - len1 + band; }
    if (b1 > len1) b1 = len1;
    if (b2 > len2) b2 = len2;

    // 1-based code access: s(x, arr) with arr[0] == 0 sentinel
    auto s1 = [&](int i) { return i == 0 ? 0 : (int)seq1[i - 1]; };
    auto s2 = [&](int j) { return j == 0 ? 0 : (int)seq2[j - 1]; };
    auto sc = [&](int j, int i) { return mat[s2(j) * row + s1(i)]; };

    Lattice L(len1, len2, mat, row, go, ge, gend);
    L.M[L.at(0, 0)] = 0;
    for (int i = 1; i < b1; ++i) L.set_end_d(0, i);

    int tmp_end = b2 < len2 ? b2 : len2 - 1;
    int j = 1;
    for (; j <= tmp_end; ++j) {
        L.set_end_i(j, 0);
        int end = (j + b1 <= len1 + 1) ? j + b1 - 1 : len1;
        for (int i = 1; i < end; ++i) {
            L.set_m(j, i, sc(j, i));
            L.set_i(j, i, ge);
            L.set_d(j, i, ge);
        }
        L.set_m(j, end, sc(j, end));
        L.set_d(j, end, ge);
        if (j + b1 - 1 > len1) L.set_end_i(j, end);
    }
    if (j == len2 && b2 != len2 - 1) {
        L.set_end_i(j, 0);
        int end = (j + b1 <= len1 + 1) ? j + b1 - 1 : len1;
        for (int i = 1; i < end; ++i) {
            L.set_m(j, i, sc(j, i));
            L.set_i(j, i, ge);
            L.set_end_d(j, i);
        }
        L.set_m(j, end, sc(j, end));
        L.set_end_d(j, end);
        if (j + b1 - 1 > len1) L.set_end_i(j, end);
        ++j;
    }
    for (; j <= len2 - b2 + 1; ++j) {
        int end = j + b1 - 1;
        for (int i = j - b2 + 1; i < end; ++i) {
            L.set_m(j, i, sc(j, i));
            L.set_i(j, i, ge);
            L.set_d(j, i, ge);
        }
        L.set_m(j, end, sc(j, end));
        L.set_d(j, end, ge);
    }
    for (; j < len2; ++j) {
        for (int i = j - b2 + 1; i < len1; ++i) {
            L.set_m(j, i, sc(j, i));
            L.set_i(j, i, ge);
            L.set_d(j, i, ge);
        }
        L.set_m(j, len1, sc(j, len1));
        L.set_end_i(j, len1);
        L.set_d(j, len1, ge);
    }
    if (j == len2) {
        for (int i = j - b2 + 1; i < len1; ++i) {
            L.set_m(j, i, sc(j, i));
            L.set_i(j, i, ge);
            L.set_end_d(j, i);
        }
        L.set_m(j, len1, sc(j, len1));
        L.set_end_i(j, len1);
        L.set_end_d(j, len1);
    }

    // backtrace — mirrors the scalar loop exactly, incl. the final
    // path[:-1] truncation
    int i = len1, jj = len2;
    int32_t mx = L.M[L.at(jj, i)];
    uint8_t typ = L.Mt[L.at(jj, i)], ctype = FROM_M;
    if (L.I[L.at(jj, i)] > mx) {
        mx = L.I[L.at(jj, i)]; typ = L.It[L.at(jj, i)]; ctype = FROM_I;
    }
    if (L.D[L.at(jj, i)] > mx) {
        mx = L.D[L.at(jj, i)]; typ = L.Dt[L.at(jj, i)]; ctype = FROM_D;
    }
    int64_t n = 0;
    if (n < path_cap) path_out[n] = ctype;
    ++n;
    while (i || jj) {
        if (ctype == FROM_M) { --i; --jj; }
        else if (ctype == FROM_I) { --jj; }
        else { --i; }
        ctype = typ;
        if (typ == FROM_M) typ = L.Mt[L.at(jj, i)];
        else if (typ == FROM_I) typ = L.It[L.at(jj, i)];
        else typ = L.Dt[L.at(jj, i)];
        if (n < path_cap) path_out[n] = ctype;
        ++n;
        if (!(i || jj)) break;
    }
    *path_n = n - 1;   // path[:-1]
    return mx;
}

}  // namespace

extern "C" {

// Returns the score; path_out gets the returned path's ctype bytes
// (last-to-first), *path_n the count.  path_cap must be
// >= len1 + len2 + 1.
int32_t aln_global_u8(const uint8_t* seq1, int len1, const uint8_t* seq2,
                      int len2, const int32_t* mat, int row, int32_t go,
                      int32_t ge, int32_t gend, int band,
                      uint8_t* path_out, int64_t path_cap,
                      int64_t* path_n) {
    return global_core(seq1, len1, seq2, len2, mat, row, go, ge, gend,
                       band, path_out, path_cap, path_n);
}

// local_fwd (stdaln.c:556-637 via the scalar model): forward full-width
// SW scan.  out[0..2] = score_f, end_i, end_j.  Returns 0, or -1 on the
// unmodelled overflow guard.
int32_t local_fwd_u8(const uint8_t* seq1, int len1, const uint8_t* seq2,
                     int len2, const int32_t* mat, int row, int32_t q,
                     int32_t r, int32_t* out) {
    out[0] = 0; out[1] = 0; out[2] = 0;
    if ((int64_t)11 * (len2 > 1 ? len2 : 1) >= 32000) return -1;
    int32_t qr = q + r;
    int tmp_len = len1 + 1;
    std::vector<int32_t> eh_h(tmp_len, 0), eh_e(tmp_len, 0);
    int32_t score_f = 0;
    int end_i = 0, end_j = 0;
    for (int j = 1; j <= len2; ++j) {
        int32_t last_h = 0, f = 0;
        const int32_t* sa_row = mat + (int)seq2[j - 1] * row;
        for (int i = 1; i < tmp_len; ++i) {
            int32_t curr_h = eh_h[i - 1] + sa_row[(int)seq1[i - 1]];
            if (curr_h < 0) curr_h = 0;
            if (last_h > 0) {
                f = (f > last_h - q) ? f - r : last_h - qr;
                if (curr_h < f) curr_h = f;
            }
            if (eh_h[i] > qr) {
                int32_t curr_last_h = eh_h[i];
                int32_t e = (eh_e[i - 1] > curr_last_h - q)
                    ? eh_e[i - 1] - r : curr_last_h - qr;
                if (curr_h < e) curr_h = e;
                eh_h[i - 1] = last_h;
                eh_e[i - 1] = e;
            } else {
                eh_h[i - 1] = last_h;
                eh_e[i - 1] = 0;
            }
            last_h = curr_h;
            if (score_f < curr_h) {
                score_f = curr_h;
                end_i = i;
                end_j = j;
            }
        }
        eh_h[tmp_len - 1] = last_h;
        eh_e[tmp_len - 1] = 0;
    }
    out[0] = score_f; out[1] = end_i; out[2] = end_j;
    return 0;
}

// local_rev (stdaln.c:639-696 via the scalar model): reverse banded pass
// locating the start cell after a forward hit.  out[0..2] = score_r - qr,
// start_i, start_j.  Returns 0, or -1 when end_i/end_j is 0.
int32_t local_rev_u8(const uint8_t* seq1, int len1, const uint8_t* seq2,
                     int len2, const int32_t* mat, int row, int32_t q,
                     int32_t r, int32_t score_f, int end_i, int end_j,
                     int32_t* out) {
    (void)len2;
    if (end_i == 0 || end_j == 0) return -1;
    int32_t qr = q + r;
    int32_t max_score = 0;
    for (int c = 0; c < row * row; ++c)
        if (mat[c] > max_score) max_score = mat[c];
    std::vector<int32_t> eh_h(len1 + 1, 0), eh_e(len1 + 1, 0);
    // score_r seeds with mat[s1[end_i]][s2[end_j]] (stdaln.c:652)
    int32_t score_r = mat[(int)seq1[end_i - 1] * row
                          + (int)seq2[end_j - 1]];
    int start_i = end_i, start_j = end_j;
    eh_h[end_i] = qr + score_r;
    eh_e[end_i] = 0;
    int start = end_i - 1;
    int end = end_i - 3 > 0 ? end_i - 3 : 0;
    for (int j = end_j - 1; j != 0; --j) {
        int32_t last_h = 0, f = 0;
        const int32_t* sa_row = mat + (int)seq2[j - 1] * row;
        int i = start;
        bool broke = false;
        for (; i != end; --i) {
            // sa_row[i] = mat[s2[j]][s1[i]]; i >= end+1 >= 1 always
            int32_t curr_h = eh_h[i + 1] + sa_row[(int)seq1[i - 1]];
            if (curr_h < 0) curr_h = 0;
            if (last_h > 0) {
                f = (f > last_h - q) ? f - r : last_h - qr;
                if (curr_h < f) curr_h = f;
            }
            int32_t curr_last_h = eh_h[i];
            int32_t e = (eh_e[i + 1] > curr_last_h - q)
                ? eh_e[i + 1] - r : curr_last_h - qr;
            if (e < 0) e = 0;
            if (curr_h < e) curr_h = e;
            eh_h[i + 1] = last_h;
            eh_e[i + 1] = e;
            last_h = curr_h;
            if (score_r < curr_h) {
                score_r = curr_h;
                start_i = i;
                start_j = j;
                if (score_r - qr == score_f) { broke = true; break; }
            }
        }
        // stdaln.c:690 runs in both exit paths at the current s position
        eh_h[i + 1] = last_h;
        eh_e[i + 1] = 0;
        if (broke) break;
        // band boundaries (stdaln.c:692-695)
        if (eh_h[start] <= qr) --start;
        if (start <= 0) start = 0;
        end = start_i - (start_j - j)
            - (score_r + (start_j - j) * max_score) / r - 1;
        if (end <= 0) end = 0;
    }
    out[0] = score_r - qr;
    out[1] = start_i;
    out[2] = start_j;
    return 0;
}

// aln_extend_core (stdaln.c:862-1007 via the scalar model).  Fills
// out[0..2] = score, end_i, end_j; when want_path and score > 0 also the
// band-doubling global path of the [end_i]x[end_j] prefix.  Returns 0,
// or -1 on the (unmodelled) overflow-rebase guard.
int32_t aln_extend_u8(const uint8_t* seq1, int len1, const uint8_t* seq2,
                      int len2, const int32_t* mat, int row, int32_t go,
                      int32_t ge, int band, int32_t G0, int want_path,
                      int32_t* out, uint8_t* path_out, int64_t path_cap,
                      int64_t* path_n) {
    *path_n = 0;
    out[0] = -1; out[1] = 0; out[2] = 0;
    if (len1 == 0 || len2 == 0) return 0;
    int32_t mat_max = 0;
    for (int c = 0; c < row * row; ++c)
        if (mat[c] > mat_max) mat_max = mat[c];
    if (G0 + (int64_t)len2 * mat_max >= 32000) return -1;

    int32_t qr = go + ge;
    std::vector<int32_t> eh_h(len1 + 2, 0), eh_e(len1 + 2, 0);
    int start = 1, end = 2;
    int end_i = 0, end_j = 0;
    int32_t score = 0;
    eh_h[1] = G0;

    for (int j = 1; j <= len2; ++j) {
        int32_t h1 = 0, f = 0;
        const int32_t* sa_row = mat + (int)seq2[j - 1] * row;
        int _start = j - band > 1 ? j - band : 1;
        if (_start > start) start = _start;
        int _end = j + band < len1 + 1 ? j + band : len1 + 1;
        if (_end < end) end = _end;
        if (start == end) break;
        int ns = 0, ne = 0;
        for (int i = start; i < end; ++i) {
            int32_t h = eh_h[i];
            int32_t e = eh_e[i];
            eh_h[i] = h1;
            if (h) h += sa_row[(int)seq1[i - 1]];
            if (e > h) h = e;
            if (f > h) h = f;
            h1 = h;
            if (h > 0) {
                if (ns == 0) ns = i;
                ne = i;
                if (score < h) { score = h; end_i = i; end_j = j; }
            }
            h -= qr;
            if (h < 0) h = 0;
            e -= ge;
            if (e < h) e = h;
            f -= ge;
            if (f < h) f = h;
            eh_e[i] = e;
        }
        eh_h[end] = h1;
        eh_e[end] = 0;
        if (ne <= 0) break;
        start = ns;
        end = ne + 3;
    }

    score -= 1;
    out[0] = score; out[1] = end_i; out[2] = end_j;
    if (score <= 0 || !want_path) return 0;

    int jmax = (end_i - 1 > end_j - 1 ? end_i - 1 : end_j - 1) + 1;
    int i_band = band;
    for (;;) {
        int64_t pn = 0;
        int32_t sg = global_core(seq1, end_i, seq2, end_j, mat, row, go,
                                 ge, -1, i_band, path_out, path_cap, &pn);
        *path_n = pn;
        if (score == sg || i_band > jmax) {
            out[0] = sg;
            return 0;
        }
        i_band <<= 1;
    }
}

}  // extern "C"
