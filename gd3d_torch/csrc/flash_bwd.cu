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
// products at the same shapes). Both dtypes run all seven products on the
// tensor cores and share one plan:
//   - dK/dV: one block per key tile holds its K and V rows. Query tiles of
//     Q and dO, with their lse and di, stream through shared memory. The
//     block works on the transposed problem, keys by queries: S^T = K Q^T
//     and dP^T = V dO^T leave P^T and dS^T = P^T * (dP^T - di) * scale in
//     accumulator fragments whose rows are the block's keys, which are
//     directly the A operands of dV += P^T dO and dK += dS^T Q. So neither
//     P nor dS goes through shared memory.
//   - dQ: one block per query tile holds Q and dO; key tiles of K and V
//     stream through shared memory; S = Q K^T and dP = dO V^T give dS, the
//     A operand of dQ += dS K.
//   dK, dV and dQ accumulate in fp32 registers and are stored once.
//
// The routes, by dtype and kernel width, the least of 64, 128 and 256 that
// holds the head dim D (no path of the repo trains attention wider than
// 64; the --tiny CroCo-Stereo model trains at 16 and 8). A D below its
// width whose rows are 16-byte multiples (fp32 D a multiple of 4, bf16 a
// multiple of 8) runs on the caller's own rows: the copies fill the columns
// past D with zeros, which add nothing to S or dP and leave dQ's, dK's and
// dV's columns past D unstored; the wrapper (kernels/flash_bwd_fused.py)
// zero-pads any other D to the width.
// * bf16 at 64 (the student under autocast), 128 and 256:
//   flash_bwd_sm90.cu, on TMA, wgmma and warp specialisation;
//   gd3d_flash_bwd below sends every bf16 case there.
// * fp32 at 128 and 256: flash_bwd_tf32_wide.cu, the same two passes (in
//   one launch) and the same split TF32 as at 64, with teams of warps that
//   split the head dim and the block's own rows in shared memory;
//   gd3d_flash_bwd below sends those widths there.
// * fp32 at 64 (the student at its configured compute_dtype): flash_bwd_dkv_tf32_
//   kernel and flash_bwd_dq_tf32_kernel, mma.sync m16n8k8 on TF32 operands
//   at fp32 accuracy: every operand is split into two TF32 parts and every
//   product is three mma.sync (mma.cuh), whatever
//   torch.backends.cuda.matmul.allow_tf32 says. The 67 TFLOP/s of the fp32
//   CUDA cores bound any fp32 kernel at 2.5x the time that three TF32
//   products at 495 TFLOP/s take.
//   - A streamed tile lands raw (cp.async, 16 bytes a copy), then the block
//     splits it once into a hi and a lo tile with rows of 68 floats, which
//     both of a tile's roles read without bank conflicts (tf32::kLd); the
//     next tile's copy runs during the products. 4 x 17 KB of split tiles
//     and 2 x 16 KB of raw ones: 101 KB, 2 blocks an SM. 4 warps a block,
//     16 rows a warp, 64 rows a tile; queries (keys, in the dQ kernel) are
//     taken 32 at a time inside a tile.
//   - The register-resident operands (K and V, or Q and dO: 64 floats a
//     thread) stay fp32 and are split at use, once per k-step and 32-row
//     chunk, reused over 4 n-tiles: their split parts would take 128
//     registers. For the same reason the chunk loop is not unrolled
//     (#pragma unroll 1): with two chunks in flight the compiler overlaps
//     the next chunk's S with this one's dV and dK, reaches 255 registers
//     and spills.
//     243 (dK/dV) and 222 (dQ) registers, no spills.
//   - The A fragment of m16n8k8 holds columns t and t + 4 where the
//     accumulator holds 2t and 2t + 1. P^T, dS^T and dS pass from the
//     accumulator as A fragments with no shuffle by reading C column 2t as
//     A column t and 2t + 1 as t + 4 (mma.cuh, a_from_c_tf32); the B operand
//     of dV, dK and dQ then loads queries (keys) 2t and 2t + 1 of each 8
//     into its rows t and t + 4.
//
// Layout: q, k, v, dout are (B, N, H, D) views read through their strides,
// whose addresses and (B, N, H) steps fall on 16 bytes (the wrapper copies
// a view that does not); dq, dk, dv are contiguous (B, N|M, H, D), D
// columns a row at any width; lse and di are
// contiguous (B, H, N) fp32. Ragged lengths are masked in the kernels: rows
// past N or M are copied as zeros, which makes a padded query's terms
// exactly 0 (its Q and dO rows are 0, and so are its lse and di), and the
// dQ kernels give keys past M a P of 0.
#include "common.cuh"
#include "flash_chunked.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace gd3d {

// fp32 on the tensor cores (see the note at the top). Shared memory, in
// floats: the raw tiles that cp.async fills (two of 64 x 64; in the dK/dV
// kernel also the tile's 64 lse and 64 di), then the split tiles the
// products read (hi and lo of each), then (dK/dV) the split tile's lse, di.
#ifndef GD3D_TF32_CHUNK
#define GD3D_TF32_CHUNK 32  // queries (keys) a warp takes at a time in the fp32 kernels
#endif

namespace tf32 {
constexpr int kChunk = GD3D_TF32_CHUNK;
constexpr int kNt = kChunk / 8;  // n-tiles of S (k-steps of the second products) a chunk
static_assert(kChunk == 16 || kChunk == 32, "chunks of 16 or 32 rows");
constexpr int kTileF = kTile * kD;  // floats per raw tile: 64 rows of 64, unpadded
constexpr int kLd = kD + 4;  // floats a split tile's row (mma.cuh: no bank conflicts)
constexpr int kSplitF = kTile * kLd;
constexpr int kDkvSmem = (2 * kTileF + 2 * kTile + 4 * kSplitF + 2 * kTile) * 4;  // 103424 bytes
constexpr int kDqSmem = (2 * kTileF + 4 * kSplitF) * 4;                          // 102400 bytes
}  // namespace tf32

// dK, dV for one 64-key tile of one (b, h), looping over every query tile.
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          float* __restrict__ dk, float* __restrict__ dv, int N, int M, int H,
                          int D, Strides qs, Strides ks, Strides vs, Strides dos, float scale) {
  using namespace tf32;
  extern __shared__ __align__(16) float smem_f[];
  float* rawQ = smem_f;
  float* rawO = rawQ + kTileF;
  float* rawStats = rawO + kTileF;  // lse, then di
  float* Qhi = rawStats + 2 * kTile;
  float* Qlo = Qhi + kSplitF;
  float* Ohi = Qlo + kSplitF;
  float* Olo = Ohi + kSplitF;
  float* stats = Olo + kSplitF;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * kTile;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* di_bh = di + ((long long)b * H + h) * N;

  auto load_query_tile = [&](int i0) {
    tc::copy_rows_async<kTile, kD, kD>(smem_u32(rawQ), qb, qs.n, i0, N, D);
    tc::copy_rows_async<kTile, kD, kD>(smem_u32(rawO), dob, dos.n, i0, N, D);
    if (tid < kTile)
      tc::load_vec_async(smem_u32(rawStats), lse_bh, i0, N, tid);
    else
      tc::load_vec_async(smem_u32(rawStats + kTile), di_bh, i0, N, tid - kTile);
  };
  load_query_tile(0);
  cp_async_commit();

  float kf[8][4], vf[8][4];  // the warp's 16 keys of K and V, A fragments in fp32
  tc::load_a_rows(kf, k + b * ks.b + h * ks.h, ks.n, key0 + warp * 16, M, D, lane);
  tc::load_a_rows(vf, v + b * vs.b + h * vs.h, vs.n, key0 + warp * 16, M, D, lane);
  float dk_acc[8][4] = {};
  float dv_acc[8][4] = {};
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (N + kTile - 1) / kTile;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    tc::split_rows<kTile, kD, kLd>(rawQ, Qhi, Qlo);
    tc::split_rows<kTile, kD, kLd>(rawO, Ohi, Olo);
    stats[tid] = rawStats[tid];
    __syncthreads();
    if (i + 1 < n_tiles) {  // the raw tiles are free: copy the next during the products
      load_query_tile((i + 1) * kTile);
      cp_async_commit();
    }
#pragma unroll 1  // two chunks in flight spill (see the note at the top)
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {  // kChunk queries at a time
      float s[kNt][4] = {};   // S^T: 16 keys x kChunk queries
      float dp[kNt][4] = {};  // dP^T
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const tc::SplitA ka = tc::split_a(kf[kk][0], kf[kk][1], kf[kk][2], kf[kk][3]);
        const tc::SplitA va = tc::split_a(vf[kk][0], vf[kk][1], vf[kk][2], vf[kk][3]);
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int o0 = (c0 + nt * 8 + g) * kLd + 8 * kk + t, o1 = o0 + 4;
          uint32_t bq[4], bo[4];
          tc::load_b(bq, Qhi, Qlo, o0, o1);
          tc::mma_split(s[nt], ka, bq);
          tc::load_b(bo, Ohi, Olo, o0, o1);
          tc::mma_split(dp[nt], va, bo);
        }
      }
      // P^T and dS^T; the column (query) picks lse and di
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int c = c0 + nt * 8 + 2 * t;
        const float2 L = *reinterpret_cast<const float2*>(stats + c);
        const float2 Dv = *reinterpret_cast<const float2*>(stats + kTile + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[nt][e], scale_log2, -((e & 1) ? L.y : L.x) * kLog2e));
          dp[nt][e] = p * (dp[nt][e] - ((e & 1) ? Dv.y : Dv.x)) * scale;
          s[nt][e] = p;
        }
      }
      // dV += P^T dO, dK += dS^T Q over the chunk's queries, 8 at a time: C
      // columns 2t and 2t + 1 are A columns t and t + 4, so B holds queries
      // 2t and 2t + 1 in its rows t and t + 4, head dims g of each 8
#pragma unroll
      for (int kq = 0; kq < kNt; ++kq) {
        const tc::SplitA pa = tc::a_from_c_tf32(s[kq]);
        const tc::SplitA da = tc::a_from_c_tf32(dp[kq]);
#pragma unroll
        for (int nd = 0; nd < 8; ++nd) {
          const int o0 = (c0 + kq * 8 + 2 * t) * kLd + 8 * nd + g, o1 = o0 + kLd;
          uint32_t bo[4], bq[4];
          tc::load_b(bo, Ohi, Olo, o0, o1);
          tc::mma_split(dv_acc[nd], pa, bo);
          tc::load_b(bq, Qhi, Qlo, o0, o1);
          tc::mma_split(dk_acc[nd], da, bq);
        }
      }
    }
  }

  const long long off = ((long long)b * M * H + h) * D;
  tc::store_c_rows(dk_acc, dk + off, (long long)H * D, key0 + warp * 16, M, D, lane);
  tc::store_c_rows(dv_acc, dv + off, (long long)H * D, key0 + warp * 16, M, D, lane);
}

// dQ for one 64-query tile of one (b, h), looping over every key tile.
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dq, int N, int M, int H, int D, Strides qs,
                         Strides ks, Strides vs, Strides dos, float scale) {
  using namespace tf32;
  extern __shared__ __align__(16) float smem_f[];
  float* rawK = smem_f;
  float* rawV = rawK + kTileF;
  float* Khi = rawV + kTileF;
  float* Klo = Khi + kSplitF;
  float* Vhi = Klo + kSplitF;
  float* Vlo = Vhi + kSplitF;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  tc::copy_rows_async<kTile, kD, kD>(smem_u32(rawK), kb, ks.n, 0, M, D);
  tc::copy_rows_async<kTile, kD, kD>(smem_u32(rawV), vb, vs.n, 0, M, D);
  cp_async_commit();

  float qf[8][4], of[8][4];  // the warp's 16 queries of Q and dO, A fragments in fp32
  tc::load_a_rows(qf, q + b * qs.b + h * qs.h, qs.n, q0 + warp * 16, N, D, lane);
  tc::load_a_rows(of, dout + b * dos.b + h * dos.h, dos.n, q0 + warp * 16, N, D, lane);
  // this lane's rows g and g + 8: lse in log2 units and di
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* di_bh = di + ((long long)b * H + h) * N;
  float lse2[2], dii[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + warp * 16 + g + 8 * r;
    lse2[r] = n < N ? lse_bh[n] * kLog2e : 0.f;
    dii[r] = n < N ? di_bh[n] : 0.f;
  }
  float dq_acc[8][4] = {};
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (M + kTile - 1) / kTile;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    tc::split_rows<kTile, kD, kLd>(rawK, Khi, Klo);
    tc::split_rows<kTile, kD, kLd>(rawV, Vhi, Vlo);
    __syncthreads();
    if (j + 1 < n_tiles) {
      tc::copy_rows_async<kTile, kD, kD>(smem_u32(rawK), kb, ks.n, (j + 1) * kTile, M, D);
      tc::copy_rows_async<kTile, kD, kD>(smem_u32(rawV), vb, vs.n, (j + 1) * kTile, M, D);
      cp_async_commit();
    }
#pragma unroll 1  // two chunks in flight spill (see the note at the top)
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {  // kChunk keys at a time
      float s[kNt][4] = {};   // S: 16 queries x kChunk keys
      float dp[kNt][4] = {};  // dP
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const tc::SplitA qa = tc::split_a(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
        const tc::SplitA oa = tc::split_a(of[kk][0], of[kk][1], of[kk][2], of[kk][3]);
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int o0 = (c0 + nt * 8 + g) * kLd + 8 * kk + t, o1 = o0 + 4;
          uint32_t bk[4], bv[4];
          tc::load_b(bk, Khi, Klo, o0, o1);
          tc::mma_split(s[nt], qa, bk);
          tc::load_b(bv, Vhi, Vlo, o0, o1);
          tc::mma_split(dp[nt], oa, bv);
        }
      }
      // dS; keys past M get P = 0
      const int k0 = j * kTile + c0;
      const bool ragged = k0 + kChunk > M;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          const float p = (ragged && key >= M)
                              ? 0.f
                              : exp2f(fmaf(s[nt][e], scale_log2, -lse2[e >> 1]));
          s[nt][e] = p * (dp[nt][e] - dii[e >> 1]) * scale;
        }
      }
      // dQ += dS K over the chunk's keys, 8 at a time (keys 2t, 2t + 1 in B's rows t, t + 4)
#pragma unroll
      for (int kq = 0; kq < kNt; ++kq) {
        const tc::SplitA da = tc::a_from_c_tf32(s[kq]);
#pragma unroll
        for (int nd = 0; nd < 8; ++nd) {
          const int o0 = (c0 + kq * 8 + 2 * t) * kLd + 8 * nd + g;
          uint32_t bk[4];
          tc::load_b(bk, Khi, Klo, o0, o0 + kLd);
          tc::mma_split(dq_acc[nd], da, bk);
        }
      }
    }
  }

  tc::store_c_rows(dq_acc, dq + ((long long)b * N * H + h) * D, (long long)H * D,
                   q0 + warp * 16, N, D, lane);
}

cudaError_t launch_bwd_tf32(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, void* dq, void* dk, void* dv,
                            int B, int N, int M, int H, int D, Strides qs, Strides ks,
                            Strides vs, Strides dos, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tf32::kDkvSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, tf32::kDqSmem);
  if (err != cudaSuccess) return err;
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* di_ = static_cast<const float*>(di);
  const dim3 grid_kv((M + kTile - 1) / kTile, H, B);
  flash_bwd_dkv_tf32_kernel<<<grid_kv, kThreads, tf32::kDkvSmem, stream>>>(
      q_, k_, v_, do_, lse_, di_, static_cast<float*>(dk), static_cast<float*>(dv), N, M, H,
      D, qs, ks, vs, dos, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((N + kTile - 1) / kTile, H, B);
  flash_bwd_dq_tf32_kernel<<<grid_q, kThreads, tf32::kDqSmem, stream>>>(
      q_, k_, v_, do_, lse_, di_, static_cast<float*>(dq), N, M, H, D, qs, ks, vs, dos, scale);
  return cudaGetLastError();
}

// flash_bwd_tf32_wide.cu: fp32 at widths 128 and 256 (head dims 68..256).
cudaError_t launch_bwd_tf32_wide(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* di, void* dq, void* dk, void* dv,
                                 int B, int N, int M, int H, int D, Strides qs, Strides ks,
                                 Strides vs, Strides dos, float scale, cudaStream_t stream);

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
  // any head dim whose rows are 16-byte multiples: up to 256 at the least
  // kernel width that holds it, wider in column chunks (flash_chunked.cu)
  if (D <= 0 || D % (is_bf16 ? 8 : 4) != 0 || N <= 0 || M <= 0 || B <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsn, qsh}, ks{ksb, ksn, ksh}, vs{vsb, vsn, vsh},
      dos{dosb, dosn, dosh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > chunked::kChunk)
    return static_cast<int>(chunked::launch_bwd(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H,
                                                D, qs, ks, vs, dos, scale, is_bf16, st));
  // each launcher returns the first launch error of its two kernels
  if (is_bf16)  // head dims 64, 128 and 256
    return static_cast<int>(sm90::launch_bwd_bf16(q, k, v, dout, lse, di, dq, dk, dv, B, N, M,
                                                  H, D, qs, ks, vs, dos, scale, st));
  if (D > kD)  // fp32 at widths 128 and 256: split TF32 on mma.sync
    return static_cast<int>(launch_bwd_tf32_wide(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H,
                                                 D, qs, ks, vs, dos, scale, st));
  return static_cast<int>(launch_bwd_tf32(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, D, qs,
                                          ks, vs, dos, scale, st));
}
