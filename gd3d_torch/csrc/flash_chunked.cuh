// K2 at head dims above 256 and K1 past the cluster kernels' reach (768
// bf16, 2048 fp32; flash_chunked.cu): the launchers that gd3d_flash_bwd
// (flash_bwd.cu) and gd3d_flash_fwd (flash_fwd.cu) send those head dims to.
#pragma once

#include "common.cuh"

namespace gd3d {
namespace chunked {

// Head-dim columns that one program writes; a wider head dim is cut into
// chunks of this many columns (the last one may be narrower).
constexpr int kChunk = 256;

cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int N, int M, int H, int D, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, bool bf16, cudaStream_t st);

cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* di, void* dq, void* dk, void* dv, int B,
                       int N, int M, int H, int D, Strides qs, Strides ks, Strides vs,
                       Strides dos, float scale, bool bf16, cudaStream_t st);

}  // namespace chunked
}  // namespace gd3d
