// K3: per-row KL(teacher || masked-softmax(student cost)).
//
// Replaces gd3d/kernels/cost_kl.py::_fwd_impl (body _kl_kernel), reached
// through masked_softmax_kl_rows. For each row of a (B, N, M) student cost
// volume: zero the row when its patch is not in the mask (a zeroed row
// softmaxes to the uniform 1/M), softmax it, clamp at eps, and sum
// pc * log(pc / qc) against the row-normalized teacher map, clamped at eps
// too. Output (B, N) fp32. Any M >= 1, no padding. The backward is the
// analytic formula of gd3d's _vjp_bwd, in plain torch, as in gd3d.
//
// What bounds it on an H100: memory (two fp32 maps, 3.6 MB at (1, 672, 672),
// 1.1 us at 3.35 TB/s), and at these sizes the latency of one launch. The
// design reads each row from device memory once and does the rest in
// registers and shuffles:
// - One warp per row, kKlRows rows a block, no shared memory and no
//   __syncthreads: every reduction is a __shfl_xor_sync butterfly.
// - The row's aligned body is loaded as float4s of both maps (up to
//   kChunks * 32 of them, all issued before any arithmetic) and stays in
//   registers. The head before the first 16-byte boundary, the tail, and
//   whatever exceeds the registers (M > 1536) are read as scalars, once per
//   pass (the second read of a few elements hits L1). A row of M = 1369 is
//   not 16-byte aligned, so its head moves from row to row. The two maps
//   must share their address modulo 16 (the entry point refuses others), so
//   one head serves both.
// - Online softmax statistics: each lane keeps a running max and a sum
//   rescaled to it; lanes merge (max, sum) pairs across the warp.
// - The KL from registers: sum pc * (log pc - log qc) with
//   log qc = max(c - m - log s, log eps), which is the twin's clamp
//   (q > eps <=> log q > log eps). One expf and one logf per element, no
//   division.
#include "common.cuh"

namespace gd3d {

#ifndef GD3D_KL_ROWS
#define GD3D_KL_ROWS 4  // rows (warps) a block; kernels/sweep.py times 1 to 8
#endif
constexpr int kKlRows = GD3D_KL_ROWS;
constexpr int kKlThreads = 32 * kKlRows;

__device__ __forceinline__ void merge_max_sum(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  s = mm == -INFINITY ? 0.f : s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

__device__ __forceinline__ float max4(const float4& v) {
  return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

__device__ __forceinline__ float kl_term(float p, float c, float lse, float eps,
                                         float log_eps) {
  const float pc = fmaxf(p, eps);
  return pc * (logf(pc) - fmaxf(c - lse, log_eps));
}

template <int kChunks>
__global__ void __launch_bounds__(kKlThreads)
cost_kl_kernel(const float* __restrict__ teacher_p, const float* __restrict__ cost,
               const bool* __restrict__ row_mask, float* __restrict__ out, int rows, int M,
               float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kKlRows + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp leaves together
  const float* pr = teacher_p + static_cast<long long>(r) * M;
  const float* cr = cost + static_cast<long long>(r) * M;
  const bool keep = row_mask[r];

  // [0, head) scalar, [head, body_end) float4s in registers, [body_end, M) scalar
  const int head =
      min(static_cast<int>((16 - (reinterpret_cast<uintptr_t>(pr) & 15)) & 15) >> 2, M);
  const int nb = min((M - head) >> 2, 32 * kChunks);
  const int body_end = head + 4 * nb;
  const int n_rest = M - 4 * nb;
  const float4* pb = reinterpret_cast<const float4*>(pr + head);
  const float4* cb = reinterpret_cast<const float4*>(cr + head);

  float4 pv[kChunks], cv[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int q = lane + 32 * i;
    if (q < nb) {
      pv[i] = pb[q];
      cv[i] = keep ? cb[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  float m = -INFINITY, s = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
    if (lane + 32 * i < nb) m = fmaxf(m, max4(cv[i]));
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
    if (lane + 32 * i < nb)
      s += expf(cv[i].x - m) + expf(cv[i].y - m) + expf(cv[i].z - m) + expf(cv[i].w - m);
  for (int t = lane; t < n_rest; t += 32) {
    const int j = t < head ? t : body_end + (t - head);
    merge_max_sum(m, s, keep ? cr[j] : 0.f, 1.f);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge_max_sum(m, s, m2, s2);
  }
  const float lse = m + logf(s);
  const float log_eps = logf(eps);

  float kl = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (lane + 32 * i < nb) {
      kl += kl_term(pv[i].x, cv[i].x, lse, eps, log_eps);
      kl += kl_term(pv[i].y, cv[i].y, lse, eps, log_eps);
      kl += kl_term(pv[i].z, cv[i].z, lse, eps, log_eps);
      kl += kl_term(pv[i].w, cv[i].w, lse, eps, log_eps);
    }
  }
  for (int t = lane; t < n_rest; t += 32) {
    const int j = t < head ? t : body_end + (t - head);
    kl += kl_term(pr[j], keep ? cr[j] : 0.f, lse, eps, log_eps);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) kl += __shfl_xor_sync(0xffffffffu, kl, o);
  if (lane == 0) out[r] = kl;
}

template <int kChunks>
cudaError_t launch(const float* p, const float* c, const bool* mask, float* out, int rows, int M,
                   float eps, cudaStream_t st) {
  const int blocks = (rows + kKlRows - 1) / kKlRows;
  cost_kl_kernel<kChunks><<<blocks, kKlThreads, 0, st>>>(p, c, mask, out, rows, M, eps);
  return cudaGetLastError();
}

}  // namespace gd3d

extern "C" int gd3d_cost_kl(const void* teacher_p, const void* cost, const void* row_mask,
                            void* out, int B, int N, int M, float eps, void* stream) {
  using namespace gd3d;
  const long long rows = static_cast<long long>(B) * N;
  if (B <= 0 || N <= 0 || M <= 0 || rows >= (1LL << 31) - kKlRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(teacher_p);
  const float* c = static_cast<const float*>(cost);
  const bool* mask = static_cast<const bool*>(row_mask);
  float* o = static_cast<float*>(out);
  // float4s of both maps at one index need the same address modulo 16
  if ((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(c)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = static_cast<int>(rows);
  const int chunks = (M + 127) / 128;  // float4s per lane that hold a row
  cudaError_t err;
  if (chunks <= 1) err = launch<1>(p, c, mask, o, R, M, eps, st);
  else if (chunks <= 2) err = launch<2>(p, c, mask, o, R, M, eps, st);
  else if (chunks <= 4) err = launch<4>(p, c, mask, o, R, M, eps, st);
  else if (chunks <= 6) err = launch<6>(p, c, mask, o, R, M, eps, st);
  else if (chunks <= 8) err = launch<8>(p, c, mask, o, R, M, eps, st);
  else err = launch<12>(p, c, mask, o, R, M, eps, st);
  return static_cast<int>(err);
}
