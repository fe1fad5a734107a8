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
// two runs give identical bits.
//
// What bounds it on an H100: arithmetic, as in K1 (3.5x the forward's
// products at the same shapes). Two designs:
//
// * bf16 (the student): flash_bwd_dkv_tc_kernel and flash_bwd_dq_tc_kernel,
//   all seven products on the tensor cores (mma.sync m16n8k16, bf16
//   operands, fp32 accumulators), 4 warps a block, 16 rows a warp.
//   - dK/dV: one block per 64 keys holds its K and V rows as A fragments
//     in registers. Query tiles of Q and dO, with their lse and di, stream
//     through a two-stage cp.async ring. The block works on the transposed
//     problem, keys by queries: S^T = K Q^T and dP^T = V dO^T leave P^T and
//     dS^T = P^T * (dP^T - di) * scale in accumulator fragments whose rows
//     are this warp's keys, which, rounded to bf16, are directly the A
//     operands of dV += P^T dO and dK += dS^T Q (dO and Q through
//     ldmatrix.trans). So neither P nor dS goes through shared memory.
//   - dQ: one block per 64 queries holds Q and dO as A fragments; 64-key
//     tiles of K and V stream through the ring; S = Q K^T and dP = dO V^T
//     give dS, rounded to bf16, the A operand of dQ += dS K (K through
//     ldmatrix.trans).
//   Queries are taken 32 at a time inside a tile (keys, in the dQ kernel),
//   which keeps the S and dP fragments at 16 registers each. Both kernels
//   use more than 48 KB of shared memory (six 9 KB tiles), so they launch
//   with dynamic shared memory. dK, dV and dQ accumulate in fp32 registers
//   and are stored once, through shared memory, with 16-byte writes.
// * fp32: flash_bwd_dkv_kernel and flash_bwd_dq_kernel on the fp32 CUDA
//   cores. One row per thread pair in registers; the other operand's tiles
//   stream through shared memory as 16-byte broadcast reads.
//
// Layout: q, k, v, dout are (B, N, H, D) views read through their strides;
// dq, dk, dv are contiguous (B, N|M, H, D); lse and di are contiguous
// (B, H, N) fp32. Ragged lengths are masked in the kernels: the tensor-core
// kernels copy zeros for rows past N or M, which makes a padded query's
// terms exactly 0 (its Q and dO rows are 0, and so are its lse and di), and
// the dQ kernel gives keys past M a P of 0.
#include "common.cuh"
#include "mma.cuh"

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

// bf16 on the tensor cores (see the note at the top). dK, dV for one 64-key
// tile of one (b, h), looping over every query tile.
constexpr int kDkvSmem = 6 * tc::kTileBytes + 2 * 2 * kTile * 4;  // + lse, di per stage
constexpr int kDqSmem = 6 * tc::kTileBytes;

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
                        const tc::bf16* __restrict__ v, const tc::bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        tc::bf16* __restrict__ dk, tc::bf16* __restrict__ dv, int N, int M,
                        int H, Strides qs, Strides ks, Strides vs, Strides dos, float scale) {
  using namespace tc;
  // K, V, Q stages 0 and 1, dO stages 0 and 1, then per stage 64 lse and 64 di
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const float* stats = reinterpret_cast<const float*>(smem_raw + 6 * kTileBytes);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + kTileBytes;
  const uint32_t sQ = sK + 2 * kTileBytes;
  const uint32_t sO = sK + 4 * kTileBytes;
  const uint32_t sStats = sK + 6 * kTileBytes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * kTile;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* di_bh = di + ((long long)b * H + h) * N;

  auto load_query_tile = [&](int st, int i0) {
    load_tile_async(sQ + st * kTileBytes, qb, qs.n, i0, N);
    load_tile_async(sO + st * kTileBytes, dob, dos.n, i0, N);
    if (tid < kTile)
      load_vec_async(sStats + st * 2 * kTile * 4, lse_bh, i0, N, tid);
    else
      load_vec_async(sStats + (st * 2 + 1) * kTile * 4, di_bh, i0, N, tid - kTile);
  };
  load_tile_async(sK, k + b * ks.b + h * ks.h, ks.n, key0, M);
  load_tile_async(sV, v + b * vs.b + h * vs.h, vs.n, key0, M);
  load_query_tile(0, 0);
  cp_async_commit();

  uint32_t kf[4][4], vf[4][4];  // the warp's 16 keys of K and V as A fragments
  float dk_acc[8][4] = {};
  float dv_acc[8][4] = {};
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (N + kTile - 1) / kTile;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    if (i + 1 < n_tiles) load_query_tile(st ^ 1, (i + 1) * kTile);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldsm_a(kf[kk], sK, warp * 16, kk * 16, lane);
        ldsm_a(vf[kk], sV, warp * 16, kk * 16, lane);
      }
    }
    const uint32_t qt = sQ + st * kTileBytes;
    const uint32_t ot = sO + st * kTileBytes;
    const float* lse_t = stats + st * 2 * kTile;
    const float* di_t = lse_t + kTile;
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += 32) {  // 32 queries at a time
      float s[4][4] = {};   // S^T: 16 keys x 32 queries
      float dp[4][4] = {};  // dP^T
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bq[4], bo[4];
          ldsm_b(bq, qt, c0 + np * 16, kk * 16, lane);
          mma(s[2 * np], kf[kk], bq[0], bq[1]);
          mma(s[2 * np + 1], kf[kk], bq[2], bq[3]);
          ldsm_b(bo, ot, c0 + np * 16, kk * 16, lane);
          mma(dp[2 * np], vf[kk], bo[0], bo[1]);
          mma(dp[2 * np + 1], vf[kk], bo[2], bo[3]);
        }
      }
      // P^T and dS^T; the column (query) picks lse and di
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = c0 + nt * 8 + 2 * (lane & 3);
        const float2 L = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 Dv = *reinterpret_cast<const float2*>(di_t + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nt][e] * scale_log2 - ((e & 1) ? L.y : L.x) * kLog2e);
          dp[nt][e] = p * (dp[nt][e] - ((e & 1) ? Dv.y : Dv.x)) * scale;
          s[nt][e] = p;
        }
      }
      // dV += P^T dO, dK += dS^T Q: P^T and dS^T rounded to bf16 as A fragments
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4], da[4];
        a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
        a_from_c(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bo[4], bq[4];
          ldsm_b_trans(bo, ot, c0 + kk * 16, np * 16, lane);
          mma(dv_acc[2 * np], pa, bo[0], bo[1]);
          mma(dv_acc[2 * np + 1], pa, bo[2], bo[3]);
          ldsm_b_trans(bq, qt, c0 + kk * 16, np * 16, lane);
          mma(dk_acc[2 * np], da, bq[0], bq[1]);
          mma(dk_acc[2 * np + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // the warp's rows of the K and V tiles are free: K and V are in registers
  const long long off = (long long)b * M * H * kD + h * kD;
  store_rows(dk_acc, 1.f, 1.f, smem, warp * 16, dk + off, (long long)H * kD,
             key0 + warp * 16, M, lane);
  store_rows(dv_acc, 1.f, 1.f, smem + kTile * kRowE, warp * 16, dv + off,
             (long long)H * kD, key0 + warp * 16, M, lane);
}

// dQ for one 64-query tile of one (b, h), looping over every key tile.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
                       const tc::bf16* __restrict__ v, const tc::bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       tc::bf16* __restrict__ dq, int N, int M, int H, Strides qs,
                       Strides ks, Strides vs, Strides dos, float scale) {
  using namespace tc;
  // Q, dO, then K stages 0 and 1, V stages 0 and 1
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sO = sQ + kTileBytes;
  const uint32_t sK = sQ + 2 * kTileBytes;
  const uint32_t sV = sQ + 4 * kTileBytes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  load_tile_async(sQ, q + b * qs.b + h * qs.h, qs.n, q0, N);
  load_tile_async(sO, dout + b * dos.b + h * dos.h, dos.n, q0, N);
  load_tile_async(sK, kb, ks.n, 0, M);
  load_tile_async(sV, vb, vs.n, 0, M);
  cp_async_commit();

  // this lane's rows g and g + 8: lse in log2 units and di
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* di_bh = di + ((long long)b * H + h) * N;
  float lse2[2], dii[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = n < N ? lse_bh[n] * kLog2e : 0.f;
    dii[r] = n < N ? di_bh[n] : 0.f;
  }
  uint32_t qf[4][4], of[4][4];  // the warp's 16 queries of Q and dO as A fragments
  float dq_acc[8][4] = {};
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (M + kTile - 1) / kTile;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile_async(sK + (st ^ 1) * kTileBytes, kb, ks.n, (j + 1) * kTile, M);
      load_tile_async(sV + (st ^ 1) * kTileBytes, vb, vs.n, (j + 1) * kTile, M);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldsm_a(qf[kk], sQ, warp * 16, kk * 16, lane);
        ldsm_a(of[kk], sO, warp * 16, kk * 16, lane);
      }
    }
    const uint32_t kt = sK + st * kTileBytes;
    const uint32_t vt = sV + st * kTileBytes;
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += 32) {  // 32 keys at a time
      float s[4][4] = {};   // S: 16 queries x 32 keys
      float dp[4][4] = {};  // dP
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4], bv[4];
          ldsm_b(bk, kt, c0 + np * 16, kk * 16, lane);
          mma(s[2 * np], qf[kk], bk[0], bk[1]);
          mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          ldsm_b(bv, vt, c0 + np * 16, kk * 16, lane);
          mma(dp[2 * np], of[kk], bv[0], bv[1]);
          mma(dp[2 * np + 1], of[kk], bv[2], bv[3]);
        }
      }
      const int k0 = j * kTile + c0;
      const bool ragged = k0 + 32 > M;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          const float p = (ragged && key >= M)
                              ? 0.f
                              : exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]);
          s[nt][e] = p * (dp[nt][e] - dii[e >> 1]) * scale;  // dS
        }
      }
      // dQ += dS K, dS rounded to bf16 as A fragments
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t da[4];
        a_from_c(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          ldsm_b_trans(bk, kt, c0 + kk * 16, np * 16, lane);
          mma(dq_acc[2 * np], da, bk[0], bk[1]);
          mma(dq_acc[2 * np + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // the warp's rows of the Q tile are free: Q is in registers
  store_rows(dq_acc, 1.f, 1.f, smem, warp * 16,
             dq + (long long)b * N * H * kD + h * kD, (long long)H * kD, q0 + warp * 16,
             N, lane);
}

cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* di, void* dq, void* dk, void* dv,
                          int B, int N, int M, int H, Strides qs, Strides ks, Strides vs,
                          Strides dos, float scale, cudaStream_t stream) {
  using tc::bf16;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* di_ = static_cast<const float*>(di);
  const dim3 grid_kv((M + kTile - 1) / kTile, H, B);
  flash_bwd_dkv_tc_kernel<<<grid_kv, kThreads, kDkvSmem, stream>>>(
      q_, k_, v_, do_, lse_, di_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, M, H,
      qs, ks, vs, dos, scale);
  const dim3 grid_q((N + kTile - 1) / kTile, H, B);
  flash_bwd_dq_tc_kernel<<<grid_q, kThreads, kDqSmem, stream>>>(
      q_, k_, v_, do_, lse_, di_, static_cast<bf16*>(dq), N, M, H, qs, ks, vs, dos, scale);
  return cudaSuccess;
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
  if (is_bf16) {
    const cudaError_t err = launch_bwd_tc(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H,
                                          qs, ks, vs, dos, scale, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    launch_bwd<float>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, qs, ks, vs, dos,
                      scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}
