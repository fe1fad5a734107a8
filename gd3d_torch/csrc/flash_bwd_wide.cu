// K2 at head dims 128 and 256 in fp32: flash-attention backward (dQ, dK,
// dV) from the forward's log-sum-exp.
//
// Replaces gd3d/kernels/flash_bwd_fused.py::flash_attention_bwd_fused for
// fp32 operands at the head dims that flash_bwd.cu (head dim 64) does not
// hold; the wrapper zero-pads head dims 65..128 to 128 and 129..256 to 256
// (kernels/flash_bwd_fused.py::bwd_padded). bf16 at every width runs
// flash_bwd_sm90.cu. No path of the repo trains attention this wide: these
// kernels are the simple, exact route, on the fp32 CUDA cores, not a tuned
// one.
//
// The math and the scheme are flash_bwd.cu's: P = exp(scale Q K^T - lse),
// dV = P^T dO, dS = P * (dO V^T - di) * scale, dK = dS^T Q, dQ = dS K, in
// two passes with no atomics, so two runs give the same bits:
//   - dK/dV (flash_bwd_dkv_wide_kernel): a block owns kRows keys and holds
//     their K and V rows in registers; tiles of kRows queries (Q, dO, their
//     lse and di) stream through shared memory.
//   - dQ (flash_bwd_dq_wide_kernel): a block owns kRows queries and holds Q
//     and dO; tiles of kRows keys (K, V) stream through shared memory.
// Shared memory sets the tile: the 64-row fp32 tiles of flash_bwd.cu take
// 101 KB at D = 64, and would take 404 KB at D = 256. Here kParts = D / 32
// consecutive threads own one row, a 32-wide part each (K1's head-dim-128
// layout, common.cuh), so a block of 128 threads owns 32 rows at D = 128 and
// 16 at D = 256, and two tiles of that many rows, each row kParts parts
// kPad floats apart, take 36 KB at either width. A dot product over the head
// dim is 32 FMAs a thread and a butterfly over its kParts lanes; a row's
// update (dV += p dO, dK += dS Q, dQ += dS K) 32 FMAs a thread. Every sum
// over queries (keys) runs in order, one tile row after the other.
//
// Layout: q, k, v, dout are (B, N, H, D) views read through their strides
// (any alignment: the tiles load one element at a time); dq, dk, dv are
// contiguous (B, N|M, H, D); lse and di are contiguous (B, H, N) fp32. Rows
// past N or M are loaded as zeros and stored nowhere; a query past N adds
// nothing to dK and dV, a key past M nothing to dQ (their P is set to 0).
#include "common.cuh"

namespace gd3d {
namespace wide {

// dK and dV of kThreads / kParts keys of one (b, h). Grid (ceil(M / rows), H, B).
template <int kParts>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          float* __restrict__ dk, float* __restrict__ dv, int N, int M, int H,
                          Strides qs, Strides ks, Strides vs, Strides dos, float scale) {
  constexpr int kRowF = kParts * kPad;
  constexpr int kRows = kThreads / kParts;
  constexpr int kDim = 32 * kParts;
  __shared__ __align__(16) float Qs[kRows * kRowF];
  __shared__ __align__(16) float Dos[kRows * kRowF];
  __shared__ float Lse2[kRows];
  __shared__ float Di[kRows];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const int m = blockIdx.x * kRows + row;
  const bool row_ok = m < M;
  const float scale_log2 = scale * kLog2e;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* di_bh = di + ((long long)b * H + h) * N;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;

  float kr[kHalf], vr[kHalf], dk_acc[kHalf], dv_acc[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    kr[d] = row_ok ? k[b * ks.b + h * ks.h + m * ks.n + part * kHalf + d] : 0.f;
    vr[d] = row_ok ? v[b * vs.b + h * vs.h + m * vs.n + part * kHalf + d] : 0.f;
    dk_acc[d] = dv_acc[d] = 0.f;
  }

  for (int n0 = 0; n0 < N; n0 += kRows) {
    __syncthreads();
    load_tile_parts<float, kParts, kRows>(Qs, qb, qs.n, n0, N);
    load_tile_parts<float, kParts, kRows>(Dos, dob, dos.n, n0, N);
    if (threadIdx.x < kRows) {
      const bool ok = n0 + threadIdx.x < N;
      Lse2[threadIdx.x] = ok ? lse_bh[n0 + threadIdx.x] * kLog2e : 0.f;
      Di[threadIdx.x] = ok ? di_bh[n0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    const int rows = min(kRows, N - n0);
    for (int j = 0; j < rows; ++j) {
      const float* qj = Qs + j * kRowF + part * kPad;
      const float* doj = Dos + j * kRowF + part * kPad;
      const float p = exp2f(fmaf(parts_dot<kParts>(kr, qj), scale_log2, -Lse2[j]));
      axpy_row(dv_acc, p, doj);
      const float ds = p * (parts_dot<kParts>(vr, doj) - Di[j]) * scale;
      axpy_row(dk_acc, ds, qj);
    }
  }

  if (row_ok) {
    const long long o = (((long long)b * M + m) * H + h) * kDim + part * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      dk[o + d] = dk_acc[d];
      dv[o + d] = dv_acc[d];
    }
  }
}

// dQ of kThreads / kParts queries of one (b, h). Grid (ceil(N / rows), H, B).
template <int kParts>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dq, int N, int M, int H, Strides qs, Strides ks,
                         Strides vs, Strides dos, float scale) {
  constexpr int kRowF = kParts * kPad;
  constexpr int kRows = kThreads / kParts;
  constexpr int kDim = 32 * kParts;
  __shared__ __align__(16) float Ks[kRows * kRowF];
  __shared__ __align__(16) float Vs[kRows * kRowF];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const int n = blockIdx.x * kRows + row;
  const bool row_ok = n < N;
  const float scale_log2 = scale * kLog2e;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const long long bhn = ((long long)b * H + h) * N + n;
  const float lse2 = row_ok ? lse[bhn] * kLog2e : 0.f;
  const float dii = row_ok ? di[bhn] : 0.f;

  float qr[kHalf], dor[kHalf], dq_acc[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    qr[d] = row_ok ? q[b * qs.b + h * qs.h + n * qs.n + part * kHalf + d] : 0.f;
    dor[d] = row_ok ? dout[b * dos.b + h * dos.h + n * dos.n + part * kHalf + d] : 0.f;
    dq_acc[d] = 0.f;
  }

  for (int m0 = 0; m0 < M; m0 += kRows) {
    __syncthreads();
    load_tile_parts<float, kParts, kRows>(Ks, kb, ks.n, m0, M);
    load_tile_parts<float, kParts, kRows>(Vs, vb, vs.n, m0, M);
    __syncthreads();
    const int rows = min(kRows, M - m0);
    for (int j = 0; j < rows; ++j) {
      const float* kj = Ks + j * kRowF + part * kPad;
      const float p = exp2f(fmaf(parts_dot<kParts>(qr, kj), scale_log2, -lse2));
      const float ds = p * (parts_dot<kParts>(dor, Vs + j * kRowF + part * kPad) - dii) * scale;
      axpy_row(dq_acc, ds, kj);
    }
  }

  if (row_ok) {
    const long long o = (((long long)b * N + n) * H + h) * kDim + part * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) dq[o + d] = dq_acc[d];
  }
}

template <int kParts>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* di, void* dq, void* dk, void* dv, int B, int N,
                   int M, int H, Strides qs, Strides ks, Strides vs, Strides dos, float scale,
                   cudaStream_t stream) {
  constexpr int kRows = kThreads / kParts;
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* di_ = static_cast<const float*>(di);
  flash_bwd_dkv_wide_kernel<kParts><<<dim3((M + kRows - 1) / kRows, H, B), kThreads, 0,
                                      stream>>>(q_, k_, v_, do_, lse_, di_,
                                                static_cast<float*>(dk), static_cast<float*>(dv),
                                                N, M, H, qs, ks, vs, dos, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_kernel<kParts><<<dim3((N + kRows - 1) / kRows, H, B), kThreads, 0,
                                     stream>>>(q_, k_, v_, do_, lse_, di_,
                                               static_cast<float*>(dq), N, M, H, qs, ks, vs, dos,
                                               scale);
  return cudaGetLastError();
}

}  // namespace wide

cudaError_t launch_bwd_wide(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, void* dq, void* dk, void* dv,
                            int B, int N, int M, int H, int D, Strides qs, Strides ks,
                            Strides vs, Strides dos, float scale, cudaStream_t stream) {
  if (D == 128)
    return wide::launch<4>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, qs, ks, vs,
                                  dos, scale, stream);
  if (D == 256)
    return wide::launch<8>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, qs, ks, vs,
                                  dos, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace gd3d
