// K1: non-causal flash-attention forward that also saves the row
// log-sum-exp for the backward.
//
// Replaces the stock TPU Pallas kernel that gd3d calls through
// gd3d/ops/attention.py::_flash_call (jax.experimental.pallas.ops.tpu.
// flash_attention._flash_attention_impl with save_residuals=True). That
// kernel saves the row max m and row sum l; this one saves
// lse = m + log(l), one fp32 per row, which is all the backward needs.
//
// What bounds it on an H100: at the student's main pass (B=2, N=4161, H=12,
// D=64) the score and PV products are ~53 GFLOP per layer against ~25 MB of
// q/k/v/o traffic, so the kernel is bound by arithmetic. This first version
// runs that arithmetic on the fp32 CUDA cores (no tensor cores), which keeps
// fp32 inputs exact (the frozen teachers run fp32 with TF32 off) and bf16
// inputs accumulated in fp32. Its design against the bound: a few threads
// own one query row in registers (one 32-wide part of the head dim each),
// K/V tiles are staged once per block in shared memory and read back as
// 16-byte broadcast vectors, so every shared load feeds four FMAs. wgmma and
// TMA come in a later revision.
//
// Head dims: 64 (two threads per row, 64 queries and 64 keys per tile;
// every attention layer but one) and 128 (four threads per row, 32 queries
// and 32 keys per tile, so the K/V tiles stay within 48 KB of static shared
// memory and the registers per thread stay those of D=64; the VGGT camera
// head's trunk, width 2048 over 16 heads).
//
// Layout: q, k, v are (B, N, H, D) views read through their strides; o is a
// contiguous (B, N, H, D) tensor and lse a contiguous (B, H, N) fp32 tensor.
// Ragged sequence lengths (2, 672, 673, 1374, 4161, ...) are masked inside
// the kernel: keys past M score -inf, queries past N are computed but not
// stored. Grid: (ceil(N / rows per block), H, B), 128 threads.
#include "common.cuh"

namespace gd3d {

template <typename T, int kParts, int kKeys>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int N, int M, int H,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale_log2) {
  constexpr int kRowF = kParts * kPad;  // floats per tile row in shared memory
  constexpr int kRows = kThreads / kParts;
  __shared__ __align__(16) float Ks[kKeys * kRowF];
  __shared__ __align__(16) float Vs[kKeys * kRowF];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const int n = blockIdx.x * kRows + row;
  const bool row_ok = n < N;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  // scores are kept in log2 units: s2 = scale * log2(e) * q.k
  float qr[kHalf];
  float acc[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    qr[d] = row_ok ? to_float(qb[n * qs.n + part * kHalf + d]) * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < M; k0 += kKeys) {
    __syncthreads();
    load_tile_parts<T, kParts, kKeys>(Ks, kb, ks.n, k0, M);
    load_tile_parts<T, kParts, kKeys>(Vs, vb, vs.n, k0, M);
    __syncthreads();

    float s[kKeys];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float dot = parts_dot<kParts>(qr, Ks + j * kRowF + part * kPad);
      s[j] = (k0 + j < M) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // every tile holds at least one real key, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float corr = exp2f(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
      axpy_row(acc, p, Vs + j * kRowF + part * kPad);
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / l;
    T* ob = o + b * os.b + h * os.h + n * os.n + part * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) ob[d] = from_float<T>(acc[d] * inv);
    if (part == 0) lse[((long long)b * H + h) * N + n] = (m + log2f(l)) * kLn2;
  }
}

template <typename T, int kParts, int kKeys>
void launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                int N, int M, int H, Strides qs, Strides ks, Strides vs, Strides os,
                float scale, cudaStream_t stream) {
  constexpr int kRows = kThreads / kParts;
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<T, kParts, kKeys><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), N, M, H, qs, ks, vs, os,
      scale * kLog2e);
}

template <typename T>
void launch_fwd_dim(int D, const void* q, const void* k, const void* v, void* o, void* lse,
                    int B, int N, int M, int H, Strides qs, Strides ks, Strides vs,
                    Strides os, float scale, cudaStream_t stream) {
  if (D == 64)
    launch_fwd<T, 2, 64>(q, k, v, o, lse, B, N, M, H, qs, ks, vs, os, scale, stream);
  else
    launch_fwd<T, 4, 32>(q, k, v, o, lse, B, N, M, H, qs, ks, vs, os, scale, stream);
}

}  // namespace gd3d

extern "C" int gd3d_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int N, int M, int H, int D,
                              long long qsb, long long qsn, long long qsh,
                              long long ksb, long long ksn, long long ksh,
                              long long vsb, long long vsn, long long vsh,
                              long long osb, long long osn, long long osh, float scale,
                              int is_bf16, void* stream) {
  using namespace gd3d;
  if ((D != 64 && D != 128) || N <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsn, qsh}, ks{ksb, ksn, ksh}, vs{vsb, vsn, vsh}, os{osb, osn, osh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_fwd_dim<__nv_bfloat16>(D, q, k, v, o, lse, B, N, M, H, qs, ks, vs, os, scale, st);
  else
    launch_fwd_dim<float>(D, q, k, v, o, lse, B, N, M, H, qs, ks, vs, os, scale, st);
  return static_cast<int>(cudaGetLastError());
}
