// K2: flash-attention backward (dQ, dK, dV) from the forward's
// log-sum-exp.
//
// Replaces gd3d/kernels/flash_bwd_fused.py::flash_attention_bwd_fused (body
// _fused_bwd_kernel), the one-pass TPU backward that gd3d wires in as the
// custom_vjp of gd3d/ops/attention.py::_fused_bwd_flash. The math is the
// same: rebuild P = exp(scale * Q K^T - lse), dV = P^T dO,
// dS = P * (dO V^T - di) * scale, dK = dS^T Q, dQ = dS K, with
// di = rowsum(O * dO) computed by the caller.
//
// The reduction of dQ across KV blocks is where the TPU design does not
// carry over: its grid runs in order on one core and sums per-KV-block dQ
// partials afterwards. Here blocks run in parallel, so this port takes the
// SECOND-PASS route: one kernel per 64-key tile accumulates dK and dV over
// all queries, and a second kernel per 64-query tile accumulates dQ over all
// keys, recomputing P and dP. That costs two extra tile products (7 in all
// against the one-pass 5) but needs no atomics and no scratch buffer, and
// it makes the result deterministic: every sum runs in a fixed order, so
// two runs give identical bits and the tolerance against the plain version
// is that of fp32 accumulation order alone.
//
// What bounds it on an H100: arithmetic, as in K1 (~3.5x the forward's
// products at the same shapes). Both kernels keep one row per thread pair
// in registers and stream the other operand's tiles through shared memory
// as 16-byte broadcast reads, on the fp32 CUDA cores; tensor cores come in
// a later revision.
//
// Layout: q, k, v, dout are (B, N, H, D) views read through their strides;
// dq, dk, dv are contiguous (B, N|M, H, D); lse and di are contiguous
// (B, H, N) fp32. Ragged lengths are masked in the kernels.
#include "common.cuh"

namespace gd3d {

// dK, dV for one 64-key tile of one (b, h); loops over every query tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     T* __restrict__ dk, T* __restrict__ dv, int N, int M, int H,
                     Strides qs, Strides ks, Strides vs, Strides dos, float scale) {
  __shared__ __align__(16) float Qs[kTile * kRow];
  __shared__ __align__(16) float dOs[kTile * kRow];
  __shared__ float Ls[kTile];
  __shared__ float Ds[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int j = blockIdx.x * kTile + row;
  const bool key_ok = j < M;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + h * ks.h + (long long)j * ks.n + half * kHalf;
  const T* vb = v + b * vs.b + h * vs.h + (long long)j * vs.n + half * kHalf;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* di_bh = di + ((long long)b * H + h) * N;

  float kr[kHalf], vr[kHalf], dk_acc[kHalf], dv_acc[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    kr[d] = key_ok ? to_float(kb[d]) : 0.f;
    vr[d] = key_ok ? to_float(vb[d]) : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();
    load_tile(Qs, qb, qs.n, q0, N);
    load_tile(dOs, dob, dos.n, q0, N);
    if (threadIdx.x < kTile) {
      const int i = q0 + threadIdx.x;
      Ls[threadIdx.x] = i < N ? lse_bh[i] : 0.f;
      Ds[threadIdx.x] = i < N ? di_bh[i] : 0.f;
    }
    __syncthreads();

    const int rows = min(kTile, N - q0);
    for (int i = 0; i < rows; ++i) {
      const float* q_row = Qs + i * kRow + half * kPad;
      const float* do_row = dOs + i * kRow + half * kPad;
      const float s = pair_dot(kr, q_row);
      const float dp = pair_dot(vr, do_row);
      const float p = key_ok ? __expf(s * scale - Ls[i]) : 0.f;
      const float ds = p * (dp - Ds[i]) * scale;
      axpy_row(dv_acc, p, do_row);
      axpy_row(dk_acc, ds, q_row);
    }
  }

  if (key_ok) {
    const long long off = (((long long)b * M + j) * H + h) * kD + half * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      dk[off + d] = from_float<T>(dk_acc[d]);
      dv[off + d] = from_float<T>(dv_acc[d]);
    }
  }
}

// dQ for one 64-query tile of one (b, h); loops over every key tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    T* __restrict__ dq, int N, int M, int H, Strides qs, Strides ks,
                    Strides vs, Strides dos, float scale) {
  __shared__ __align__(16) float Ks[kTile * kRow];
  __shared__ __align__(16) float Vs[kTile * kRow];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int i = blockIdx.x * kTile + row;
  const bool q_ok = i < N;

  const T* qb = q + b * qs.b + h * qs.h + (long long)i * qs.n + half * kHalf;
  const T* dob = dout + b * dos.b + h * dos.h + (long long)i * dos.n + half * kHalf;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const long long stat = ((long long)b * H + h) * N + i;
  const float lse_i = q_ok ? lse[stat] : 0.f;
  const float di_i = q_ok ? di[stat] : 0.f;

  float qr[kHalf], dor[kHalf], dq_acc[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    qr[d] = q_ok ? to_float(qb[d]) : 0.f;
    dor[d] = q_ok ? to_float(dob[d]) : 0.f;
    dq_acc[d] = 0.f;
  }

  for (int k0 = 0; k0 < M; k0 += kTile) {
    __syncthreads();
    load_tile(Ks, kb, ks.n, k0, M);
    load_tile(Vs, vb, vs.n, k0, M);
    __syncthreads();

    const int cols = min(kTile, M - k0);
    for (int j = 0; j < cols; ++j) {
      const float* k_row = Ks + j * kRow + half * kPad;
      const float s = pair_dot(qr, k_row);
      const float dp = pair_dot(dor, Vs + j * kRow + half * kPad);
      const float p = q_ok ? __expf(s * scale - lse_i) : 0.f;
      axpy_row(dq_acc, p * (dp - di_i) * scale, k_row);
    }
  }

  if (q_ok) {
    const long long off = (((long long)b * N + i) * H + h) * kD + half * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) dq[off + d] = from_float<T>(dq_acc[d]);
  }
}

template <typename T>
void launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* di, void* dq, void* dk, void* dv, int B, int N,
                int M, int H, Strides qs, Strides ks, Strides vs, Strides dos, float scale,
                cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* di_ = static_cast<const float*>(di);
  const dim3 grid_kv((M + kTile - 1) / kTile, H, B);
  flash_bwd_dkv_kernel<T><<<grid_kv, kThreads, 0, stream>>>(
      q_, k_, v_, do_, lse_, di_, static_cast<T*>(dk), static_cast<T*>(dv), N, M, H, qs,
      ks, vs, dos, scale);
  const dim3 grid_q((N + kTile - 1) / kTile, H, B);
  flash_bwd_dq_kernel<T><<<grid_q, kThreads, 0, stream>>>(
      q_, k_, v_, do_, lse_, di_, static_cast<T*>(dq), N, M, H, qs, ks, vs, dos, scale);
}

}  // namespace gd3d

extern "C" int gd3d_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* di, void* dq,
                              void* dk, void* dv, int B, int N, int M, int H, int D,
                              long long qsb, long long qsn, long long qsh,
                              long long ksb, long long ksn, long long ksh,
                              long long vsb, long long vsn, long long vsh,
                              long long dosb, long long dosn, long long dosh, float scale,
                              int is_bf16, void* stream) {
  using namespace gd3d;
  if (D != kD || N <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsn, qsh}, ks{ksb, ksn, ksh}, vs{vsb, vsn, vsh},
      dos{dosb, dosn, dosh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_bwd<__nv_bfloat16>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, qs, ks, vs,
                              dos, scale, st);
  else
    launch_bwd<float>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, qs, ks, vs, dos,
                      scale, st);
  return static_cast<int>(cudaGetLastError());
}
