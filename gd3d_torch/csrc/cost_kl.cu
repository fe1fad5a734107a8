// K3: per-row KL(teacher || masked-softmax(student cost)).
//
// Replaces gd3d/kernels/cost_kl.py::_fwd_impl (body _kl_kernel), reached
// through masked_softmax_kl_rows. For each row of a (B, N, M) student cost
// volume: zero the row when its patch is not in the mask (a zeroed row
// softmaxes to the uniform 1/M), softmax it, clamp at eps, and sum
// pc * log(pc / qc) against the row-normalized teacher map, clamped at eps
// too. Output (B, N) fp32. The backward is the analytic formula of gd3d's
// _vjp_bwd, in plain torch, as in gd3d.
//
// What bounds it on an H100: memory. Each row is read from device memory
// once (two fp32 maps of M floats, 5.4 KB at M = 672) and its later passes
// hit L1; the work per element is a few flops and two transcendentals. The
// design keeps the softmax and KL intermediates out of device memory
// entirely: one block per row makes three passes (max, sum of exp, KL sum)
// over the row with block-wide shuffle reductions, and writes one float.
// Grid: (B * N), 256 threads.
#include "common.cuh"

namespace gd3d {

constexpr int kKlThreads = 256;

// Block-wide reduction; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < kKlThreads / 32 ? red[lane] : (kMax ? -INFINITY : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

__global__ void __launch_bounds__(kKlThreads)
cost_kl_kernel(const float* __restrict__ teacher_p, const float* __restrict__ cost,
               const bool* __restrict__ row_mask, float* __restrict__ out, int M,
               float eps) {
  __shared__ float red[kKlThreads / 32];
  const long long r = blockIdx.x;
  const float* p_row = teacher_p + r * M;
  const float* c_row = cost + r * M;
  const bool keep = row_mask[r];

  float mx = -INFINITY;
  for (int j = threadIdx.x; j < M; j += kKlThreads) mx = fmaxf(mx, keep ? c_row[j] : 0.f);
  mx = block_reduce<true>(mx, red);

  float se = 0.f;
  for (int j = threadIdx.x; j < M; j += kKlThreads)
    se += expf((keep ? c_row[j] : 0.f) - mx);
  se = block_reduce<false>(se, red);

  float kl = 0.f;
  for (int j = threadIdx.x; j < M; j += kKlThreads) {
    const float q = expf((keep ? c_row[j] : 0.f) - mx) / se;
    const float pc = fmaxf(p_row[j], eps);
    const float qc = fmaxf(q, eps);
    kl += pc * logf(pc / qc);
  }
  kl = block_reduce<false>(kl, red);
  if (threadIdx.x == 0) out[r] = kl;
}

}  // namespace gd3d

extern "C" int gd3d_cost_kl(const void* teacher_p, const void* cost, const void* row_mask,
                            void* out, int B, int N, int M, float eps, void* stream) {
  using namespace gd3d;
  if (B <= 0 || N <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cost_kl_kernel<<<B * N, kKlThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(teacher_p), static_cast<const float*>(cost),
      static_cast<const bool*>(row_mask), static_cast<float*>(out), M, eps);
  return static_cast<int>(cudaGetLastError());
}
