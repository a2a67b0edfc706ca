// Native (host C++) engine for BWA's bounded-DFS gapped search
// (bwt_match_gap, bwtgap.c:104-266), bit-exact with the Python scalar
// oracle (nabwa_tpu/refmodel/dfs_scalar.py) and the device engines.
//
// The search itself lives in dfsgap_core.h, shared with the GPU kernel.
// Here it runs with a growable stack: the host engine solves the reads
// the device flags (deep stacks, long hit lists) and is the whole aligner
// where no device runs.  Threaded over reads with a work-stealing atomic
// cursor.  dfs_fixed_batch is the GPU kernel's contract run on the host,
// so the kernel's arithmetic is testable without a card.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "dfsgap_core.h"

namespace {

using namespace dfsgap;

// growable binned priority stack (gap_stack_t, bwtgap.c:13-79)
struct Stack {
    std::vector<std::vector<Entry>> bins;
    int best = 0;
    int64_t n_entries = 0;
    bool reset(int n_bins) {
        if ((int)bins.size() < n_bins) bins.resize(n_bins);
        for (auto& b : bins) b.clear();
        best = n_bins;
        n_entries = 0;
        return true;
    }
    bool room(int, int) const { return true; }
    void push(const Entry& e, int score) {
        bins[score].push_back(e);
        ++n_entries;
        if (best > score) best = score;
    }
    Entry pop() {
        Entry e = bins[best].back();
        bins[best].pop_back();
        --n_entries;
        if (bins[best].empty() && n_entries) {
            int i = best + 1;
            while (i < (int)bins.size() && bins[i].empty()) ++i;
            best = i;
        } else if (n_entries == 0) {
            best = (int)bins.size();
        }
        return e;
    }
};

// caller-sized hit array; a full store makes the caller re-run the read
// with a larger one
struct HostHits {
    Hit* hits;
    int cap;
    uint32_t k(int h) const { return (uint32_t)hits[h].k; }
    uint32_t l(int h) const { return (uint32_t)hits[h].l; }
    bool add(int n, int n_mm, int n_gapo, int n_gape, int a, uint32_t k_,
             uint32_t l_, int score) {
        if (n >= cap) return false;
        hits[n] = { n_mm, n_gapo, n_gape, a, (int32_t)k_, (int32_t)l_,
                    score };
        return true;
    }
};

// per-thread reusable buffers: the per-read allocations (width arrays +
// ~100 score-bin vectors) cost more than the search itself on short reads
struct Arena {
    std::vector<uint32_t> w0, w1, sw0, sw1;
    std::vector<int32_t> b0, b1, sb0, sb1;
    Stack stack;
};

// one read on the host engine.  Returns n_aln (-1 = hits_cap exceeded);
// hw_out gets the stack high-water mark.
int match_gap_host(const Fm fms[2], int length, const uint8_t* seq,
                   const uint8_t* rseq, int max_diff, int max_gapo,
                   const Opts& opt, Hit* hits, int32_t* hw_out, Arena& ar) {
    ar.w0.resize(length + 1); ar.w1.resize(length + 1);
    ar.b0.resize(length + 1); ar.b1.resize(length + 1);
    int sl = opt.seed_len < length ? opt.seed_len : 0;
    ar.sw0.resize(sl + 1); ar.sw1.resize(sl + 1);
    ar.sb0.resize(sl + 1); ar.sb1.resize(sl + 1);
    uint32_t* W[2] = { ar.w0.data(), ar.w1.data() };
    int32_t* BID[2] = { ar.b0.data(), ar.b1.data() };
    uint32_t* SW[2] = { ar.sw0.data(), ar.sw1.data() };
    int32_t* SBID[2] = { ar.sb0.data(), ar.sb1.data() };
    HostHits store{hits, opt.hits_cap};
    Result res;
    match_gap<false>(fms, length, seq, rseq, max_diff, max_gapo, opt,
                     INT64_MAX, W, BID, SW, SBID, ar.stack, store, res);
    *hw_out = res.overflow ? 0 : res.hw;
    return res.overflow ? -1 : res.n_aln;
}

template <class F>
void parallel_for(int n, int n_threads, F&& body) {
    if (n_threads <= 0) {
        n_threads = (int)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 1;
    }
    if (n_threads > n) n_threads = n > 0 ? n : 1;
    std::atomic<int> cursor{0};
    auto work = [&]() {
        Arena ar;
        for (;;) {
            int i = cursor.fetch_add(1);
            if (i >= n) break;
            body(i, ar);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < n_threads; ++t) threads.emplace_back(work);
    work();
    for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// exported single-shot bwt_2occ4 for host FM walks (bsw2_core's trie
// descent does one per node; the Python per-word popcount loop was the
// bwasw profile's top entry)
int two_occ4_u32(const uint32_t* bwt_arr, uint32_t primary,
                 const uint32_t* L2, uint32_t seq_len,
                 uint32_t k, uint32_t l, uint32_t* out8) {
    Fm fm;
    fm.bwt = bwt_arr;
    fm.primary = primary;
    for (int c = 0; c < 5; ++c) fm.L2[c] = L2[c];
    fm.seq_len = seq_len;
    two_occ4(fm, k, l, out8, out8 + 4);
    return 0;
}

// Batch DFS over n reads, threaded.  seqs: uint8 [n][2][L] (seq, rseq,
// reversed-read orientation, padding = 4).  Outputs:
//   hits_out   int32 [n][hits_cap][7]  (n_mm,n_gapo,n_gape,a,k,l,score)
//   n_aln_out  int32 [n]  (-1 = hits_cap exceeded -> caller re-runs)
//   hw_out     int32 [n]  stack high-water
int dfs_match_gap_batch(
    const uint32_t* bwt_fwd, uint32_t primary_fwd,
    const uint32_t* bwt_rev, uint32_t primary_rev,
    const uint32_t* L2, uint32_t seq_len,
    const uint8_t* seqs, int L, const int32_t* lengths,
    const int32_t* maxdiff, int n,
    int s_mm, int s_gapo, int s_gape, int max_gape, int max_gapo,
    int indel_end_skip, int max_del_occ, int64_t max_entries,
    int max_top2, int max_seed_diff, int seed_len, int mode,
    int hits_cap, int n_threads,
    int32_t* hits_out, int32_t* n_aln_out, int32_t* hw_out) {
    Fm fms[2];
    fms[0].bwt = bwt_fwd; fms[0].primary = primary_fwd;
    fms[1].bwt = bwt_rev; fms[1].primary = primary_rev;
    for (int f = 0; f < 2; ++f) {
        std::memcpy(fms[f].L2, L2, 5 * sizeof(uint32_t));
        fms[f].seq_len = seq_len;
    }
    Opts opt{ s_mm, s_gapo, s_gape, max_gape, max_gapo, indel_end_skip,
              max_del_occ, max_entries, max_top2, max_seed_diff, seed_len,
              mode, hits_cap };
    parallel_for(n, n_threads, [&](int i, Arena& ar) {
        const uint8_t* seq = seqs + (size_t)i * 2 * L;
        n_aln_out[i] = match_gap_host(
            fms, lengths[i], seq, seq + L, maxdiff[i], max_gapo, opt,
            reinterpret_cast<Hit*>(hits_out + (size_t)i * hits_cap * 7),
            &hw_out[i], ar);
    });
    return 0;
}

// The GPU kernel's fixed-capacity contract on the host (same inputs as
// the nabwa_dfs FFI target, same packed [B][4H+5] result); scratch is
// int32 [B][scratch_words(stack_cap, L)].
int dfs_fixed_batch(const uint32_t* bwt_fwd, const uint32_t* bwt_rev,
                    const uint8_t* seqs, int B, int L,
                    const int32_t* lengths, const int32_t* maxdiff,
                    const int64_t* params, int32_t* scratch, int32_t* out,
                    int n_threads) {
    Batch b;
    batch_from_params(params, bwt_fwd, bwt_rev, b);
    parallel_for(B, n_threads, [&](int r, Arena&) {
        fixed_read(b, r, L, seqs, lengths, maxdiff, scratch, out);
    });
    return 0;
}

int64_t dfs_scratch_words(int stack_cap, int L) {
    return scratch_words(stack_cap, L);
}

}  // extern "C"
