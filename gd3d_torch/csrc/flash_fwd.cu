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
// D=64) the score and PV products are ~106 GFLOP per layer against ~25 MB of
// q/k/v/o traffic, so the kernel is bound by arithmetic. Two designs:
//
// * bf16, head dim 64 (the student, DINOv2 and the VGGT aggregator):
//   flash_fwd_tc_kernel, on the tensor cores. One block of 4 warps per 64
//   queries of one (b, h); each warp owns 16 query rows. The Q tile comes
//   in once by cp.async and stays in registers as mma A fragments. 64-key
//   tiles of K and V stream through a two-stage cp.async ring (the copy of
//   tile j+1 is in flight while tile j is computed), rows padded by 16 bytes
//   against bank conflicts. S = Q K^T runs on mma.sync m16n8k16; the online
//   softmax works on the fp32 accumulator fragments (row max and sum over
//   the 4-lane quad, exp2 with scale * log2(e) folded in); P is rounded to
//   bf16 in registers and is directly the A operand of P V (V through
//   ldmatrix.trans). O is normalised, staged through shared memory and
//   stored with 16-byte writes.
// * fp32 (the frozen teachers, which run with TF32 off) and head dim 128
//   (the VGGT camera trunk, fp32): flash_fwd_kernel, on the fp32 CUDA cores,
//   which keeps fp32 inputs exact. A few threads own one query row in
//   registers (one 32-wide part of the head dim each); K/V tiles are staged
//   in shared memory and read back as 16-byte broadcast vectors, so every
//   shared load feeds four FMAs. Head dim 64: two threads per row, 64
//   queries and 64 keys per tile. Head dim 128: four threads per row, 32
//   queries and 32 keys per tile, so the K/V tiles stay within 48 KB of
//   static shared memory.
//
// Layout: q, k, v are (B, N, H, D) views read through their strides; o is a
// contiguous (B, N, H, D) tensor and lse a contiguous (B, H, N) fp32 tensor.
// Ragged sequence lengths (2, 672, 673, 1374, 4161, ...) are masked inside
// the kernels: keys past M score -inf (the tensor-core kernel copies zeros
// for their rows), queries past N are computed but not stored. Nothing is
// padded in device memory. Grid: (ceil(N / rows per block), H, B), 128
// threads.
#include "common.cuh"
#include "mma.cuh"

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

// bf16, head dim 64, on the tensor cores (see the note at the top).
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
                    const tc::bf16* __restrict__ v, tc::bf16* __restrict__ o,
                    float* __restrict__ lse, int N, int M, int H, Strides qs, Strides ks,
                    Strides vs, Strides os, float scale_log2) {
  using namespace tc;
  // Q, then K stages 0 and 1, then V stages 0 and 1
  __shared__ __align__(128) bf16 smem[5 * kTile * kRowE];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + kTileBytes;
  const uint32_t sV = sQ + 3 * kTileBytes;

  load_tile_async(sQ, qb, qs.n, q0, N);
  load_tile_async(sK, kb, ks.n, 0, M);
  load_tile_async(sV, vb, vs.n, 0, M);
  cp_async_commit();

  uint32_t qf[4][4];     // the warp's 16 query rows as A fragments, 4 x 16 dims
  float acc[8][4] = {};  // O, 16 rows x 64 dims
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  const int n_tiles = (M + kTile - 1) / kTile;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile_async(sK + (st ^ 1) * kTileBytes, kb, ks.n, (j + 1) * kTile, M);
      load_tile_async(sV + (st ^ 1) * kTileBytes, vb, vs.n, (j + 1) * kTile, M);
    }
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldsm_a(qf[kk], sQ, warp * 16, kk * 16, lane);
    }
    const uint32_t kt = sK + st * kTileBytes;
    const uint32_t vt = sV + st * kTileBytes;

    float s[8][4] = {};  // S, 16 rows x 64 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_b(bk, kt, np * 16, kk * 16, lane);
        mma(s[2 * np], qf[kk], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
    const int k0 = j * kTile;
    const bool ragged = k0 + kTile > M;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        s[nt][e] = (ragged && key >= M) ? -INFINITY : s[nt][e] * scale_log2;
      }
    }
    // online softmax; every tile holds a real key, so the new max is finite
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[nt][e] *= corr[e >> 1];
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    }
    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[4];
        ldsm_b_trans(bv, vt, kk * 16, np * 16, lane);
        mma(acc[2 * np], pa, bv[0], bv[1]);
        mma(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // the warp's rows of the Q tile are free: its Q is in registers
  store_rows(acc, 1.f / l[0], 1.f / l[1], smem, warp * 16, o + b * os.b + h * os.h, os.n,
             q0 + warp * 16, N, lane);
  if ((lane & 3) == 0) {
    float* lse_bh = lse + ((long long)b * H + h) * N;
    const int n = q0 + warp * 16 + (lane >> 2);
    if (n < N) lse_bh[n] = (m[0] + log2f(l[0])) * kLn2;
    if (n + 8 < N) lse_bh[n + 8] = (m[1] + log2f(l[1])) * kLn2;
  }
}

void launch_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int N, int M, int H, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  flash_fwd_tc_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), static_cast<float*>(lse),
      N, M, H, qs, ks, vs, os, scale * kLog2e);
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
  if (is_bf16 && D == kD)
    launch_fwd_tc(q, k, v, o, lse, B, N, M, H, qs, ks, vs, os, scale, st);
  else if (is_bf16)  // head dim 128
    launch_fwd<__nv_bfloat16, 4, 32>(q, k, v, o, lse, B, N, M, H, qs, ks, vs, os, scale, st);
  else
    launch_fwd_dim<float>(D, q, k, v, o, lse, B, N, M, H, qs, ks, vs, os, scale, st);
  return static_cast<int>(cudaGetLastError());
}
