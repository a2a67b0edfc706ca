// GPU kernel for BWA's bounded-DFS gapped search: one thread runs one
// read's whole search (dfsgap_core.h, the same code the host engine
// runs), with its stack, hit store and width planes in a per-read slab
// of scratch memory.  Reads diverge freely; nothing is lockstepped.
//
// Called from JAX through the XLA FFI as the "nabwa_dfs" target
// (nabwa_tpu/ops/dfs_cuda.py builds and registers it):
//   args    bwt_fwd, bwt_rev  int32 [words]  interleaved BWT (uint32 bits)
//           seqs              uint8 [B][2][L] seq, rseq (padding 4)
//           lengths, maxdiff  int32 [B]       (length 0 = padding lane)
//   results out               int32 [B][4H+5] packed as ops/dfs.py
//           scratch           int32 [B][scratch_words(S, L)]
//   attr    params            int64 [P_COUNT] (dfsgap::Param layout)

#include <cuda_runtime.h>

#include <string>

#include "xla/ffi/api/ffi.h"

#include "dfsgap_core.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 128;

__global__ void dfs_kernel(dfsgap::Batch b, int B, int L,
                           const uint8_t* __restrict__ seqs,
                           const int32_t* __restrict__ lengths,
                           const int32_t* __restrict__ maxdiff,
                           int32_t* __restrict__ scratch,
                           int32_t* __restrict__ out) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    dfsgap::fixed_read(b, r, L, seqs, lengths, maxdiff, scratch, out);
}

ffi::Error DfsImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> bwt_fwd,
                   ffi::Buffer<ffi::S32> bwt_rev, ffi::Buffer<ffi::U8> seqs,
                   ffi::Buffer<ffi::S32> lengths,
                   ffi::Buffer<ffi::S32> maxdiff,
                   ffi::ResultBuffer<ffi::S32> out,
                   ffi::ResultBuffer<ffi::S32> scratch,
                   ffi::Span<const int64_t> params) {
    if (params.size() != dfsgap::P_COUNT)
        return ffi::Error::InvalidArgument("nabwa_dfs: params length");
    auto dims = seqs.dimensions();
    if (dims.size() != 3 || dims[1] != 2)
        return ffi::Error::InvalidArgument("nabwa_dfs: seqs must be [B,2,L]");
    const int B = (int)dims[0], L = (int)dims[2];
    dfsgap::Batch b;
    batch_from_params(params.begin(),
                      reinterpret_cast<const uint32_t*>(bwt_fwd.typed_data()),
                      reinterpret_cast<const uint32_t*>(bwt_rev.typed_data()),
                      b);
    auto odims = out->dimensions();
    if (odims.size() != 2 || odims[0] != B
        || odims[1] != 4 * b.opt.hits_cap + 5)
        return ffi::Error::InvalidArgument("nabwa_dfs: out shape");
    auto sdims = scratch->dimensions();
    if (sdims.size() != 2 || sdims[0] != B
        || sdims[1] != dfsgap::scratch_words(b.stack_cap, L))
        return ffi::Error::InvalidArgument("nabwa_dfs: scratch shape");
    if (B == 0) return ffi::Error::Success();
    int grid = (B + kThreads - 1) / kThreads;
    dfs_kernel<<<grid, kThreads, 0, stream>>>(
        b, B, L, seqs.typed_data(), lengths.typed_data(),
        maxdiff.typed_data(), scratch->typed_data(), out->typed_data());
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess)
        return ffi::Error::Internal(std::string("nabwa_dfs launch: ")
                                    + cudaGetErrorString(err));
    return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    NabwaDfs, DfsImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Attr<ffi::Span<const int64_t>>("params"));
