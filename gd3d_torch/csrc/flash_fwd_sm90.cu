// K1 in bf16 at head dim 64 (the student, DINOv2 and the VGGT aggregator,
// the bf16 CroCo teacher): the flash-attention forward with the row
// log-sum-exp, on Hopper's own machinery. gd3d_flash_fwd (flash_fwd.cu)
// sends that case here; fp32 and head dim 128 stay there.
//
// Replaces, as the rest of K1 does, the stock TPU Pallas flash forward that
// gd3d calls through gd3d/ops/attention.py::_flash_call.
//
// What bounds it on an H100: arithmetic. At the student's main pass
// (2, 4161, 12, 64) the two products are 106 GFLOP against 25 MB of q, k,
// v and o, 0.108 ms at the tensor cores' 989 TFLOP/s and 0.008 ms at
// 3.35 TB/s. The design (sm90.cuh has the building blocks):
//
// * Warp specialisation. A block is one producer warpgroup and one
//   consumer warpgroup, which owns 64 query rows of one (b, h). The
//   producer (one thread; its warpgroup's registers lowered to 24 by
//   setmaxnreg, the consumer's raised to 232) copies the Q tile once and
//   then 128-key tiles of K and V by TMA into a three-stage ring, each tile
//   completing on its own mbarrier ("full") and freed by the consumer on
//   another ("empty"). K and V have barriers of their own, so S starts
//   before V has landed.
// * S = Q K^T is four m64n128k16 wgmma with both operands K-major in
//   shared memory. The online softmax runs on the fp32 accumulator in
//   registers (row max and sum over the 4 lanes of a row, on raw scores;
//   one ffma and one exp2 a score with scale * log2(e) folded in; keys past
//   M score -inf). P, rounded to bf16, is the A-register operand of
//   O += P V: eight m64n64k16 wgmma with V read MN-major through the
//   descriptor's transpose bit. Neither S nor P touches shared memory.
// * Overlap. S of tile j + 1 and P V of tile j are issued together, and the
//   softmax of tile j + 1 runs while P V does (it waits only before O is
//   rescaled and P rewritten). At head dim 64 the exponentials (one a
//   score, 16 a clock an SM) take as long as the two products, so the
//   kernel is as fast as that overlap. Two blocks share an SM (104 KB of
//   shared memory and 256 threads each), so one block's softmax also runs
//   under the other's products. Two or three consumer warpgroups a block
//   (128 or 192 rows, K and V tiles shared), with or without named
//   barriers making them take turns at issuing, measured slower at
//   (2, 4161, 12, 64) than this plan on NVIDIA H100 80GB HBM3.
// * The grid: 64-row tiles, ceil(N / 64) x H x B blocks; the cost pass
//   (2, 673, 12) makes 264 blocks, one full wave at two an SM.
// * Epilogue: O scaled by 1 / l and stored as bf16 pairs straight from the
//   accumulator, rows past N skipped; the LSE as fp32 (B, H, N).
//
// Layout: q, k, v are (B, N|M, H, 64) bf16 views read by TMA through their
// strides (their addresses and (B, N, H) steps on 16 bytes: the wrapper
// copies a view that is not); rows past N or M arrive as zeros.
#include "sm90.cuh"

namespace gd3d {
namespace sm90 {

constexpr int kFwdKeys = 128;  // keys a tile
constexpr int kFwdStages = 3;
constexpr int kFwdRows = 64;  // queries a block: one consumer warpgroup
constexpr int kFwdTileBytes = kFwdKeys * kRowBytes;
constexpr int kFwdK = kFwdRows * kRowBytes;  // shared memory: Q, then K stages, V stages
constexpr int kFwdV = kFwdK + kFwdStages * kFwdTileBytes;
constexpr int kFwdSmem = kFwdV + kFwdStages * kFwdTileBytes + 1024;  // + alignment slack

__global__ void __launch_bounds__(256, 2)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, int N, int M, int H, Strides os,
                      float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // q_full, then per stage k_full, v_full, k_empty, v_empty
  __shared__ __align__(8) uint64_t bars[1 + 4 * kFwdStages];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kFwdK;
  const uint32_t sV = sQ + kFwdV;
  const uint32_t q_full = smem_u32(bars);
  auto bar = [&](int kind, int s) { return q_full + 8 * (1 + kind * kFwdStages + s); };
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kFwdRows;
  const int n_tiles = (M + kFwdKeys - 1) / kFwdKeys;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 1);
      mbar_init(bar(2, s), 128);
      mbar_init(bar(3, s), 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    regs_down<24>();
    if (threadIdx.x == 0) {
      prefetch_map(tq);
      prefetch_map(tk);
      prefetch_map(tv);
      mbar_arrive_tx(q_full, kFwdRows * kRowBytes);
      tma_load(sQ, tq, q_full, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kFwdStages;
        const uint32_t ph = (j / kFwdStages) & 1;
        const uint32_t off = s * kFwdTileBytes;
        mbar_wait(bar(2, s), ph ^ 1);
        mbar_arrive_tx(bar(0, s), kFwdTileBytes);
        for (int i = 0; i < kFwdKeys / kBox; ++i)
          tma_load(sK + off + i * kBoxBytes, tk, bar(0, s), j * kFwdKeys + i * kBox, h, b);
        mbar_wait(bar(3, s), ph ^ 1);
        mbar_arrive_tx(bar(1, s), kFwdTileBytes);
        for (int i = 0; i < kFwdKeys / kBox; ++i)
          tma_load(sV + off + i * kBoxBytes, tv, bar(1, s), j * kFwdKeys + i * kBox, h, b);
      }
    }
  } else {  // the consumer warpgroup: 64 query rows
    regs_up<232>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;
    float acc[32];  // O, 64 rows x 64 dims
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, raw scores
    float l[2] = {0.f, 0.f};              // this lane's part of the row sums
    float sc[64];                         // S, 64 rows x 128 keys; then P
    uint32_t pa[8][4];                    // P in bf16: the A fragments of 8 k-steps

    // Softmax of tile j in place: keys past M score -inf, the running max
    // and sum advance; sets corr to the factor that rescales what O holds.
    // Every tile holds a real key, so the new max is finite.
    auto softmax = [&](int j, float (&corr)[2]) {
      const int k0 = j * kFwdKeys;
      if (k0 + kFwdKeys > M) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= M) sc[i] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        ms[r] = mx[r] * scale_log2;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float p = fast_exp2(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
        l[(i >> 1) & 1] += p;
        sc[i] = p;
      }
    };
    auto issue_s = [&](int j) {
      const uint32_t kt = sK + (j % kFwdStages) * kFwdTileBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(sc, desc_k(sQ, kk), desc_k(kt, kk), kk);
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {
      const uint32_t vt = sV + (j % kFwdStages) * kFwdTileBytes;
      mbar_wait(bar(1, j % kFwdStages), (j / kFwdStages) & 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs_n64_mn(acc, pa[kk], desc_mn(vt, kk), 1);
      wgmma_commit();
    };

    // S of tile j + 1 and P V of tile j run while the softmax of tile j + 1
    // does: P V waits only before O is rescaled and P overwritten
    mbar_wait(q_full, 0);
    float corr[2];
    mbar_wait(bar(0, 0), 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(bar(2, 0));
    softmax(0, corr);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) a_from_acc(pa[kk], sc, kk);
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kFwdStages;
      mbar_wait(bar(0, s), (j / kFwdStages) & 1);
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      mbar_arrive(bar(2, s));
      softmax(j, corr);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar(3, (j - 1) % kFwdStages));
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) a_from_acc(pa[kk], sc, kk);
    }
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar(3, (n_tiles - 1) % kFwdStages));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row0 = q0 + warp * 16;
    store_acc(acc, 1.f / l[0], 1.f / l[1], o + b * os.b + h * os.h, os.n, row0, N, lane);
    if (t == 0) {
      float* lse_bh = lse + ((long long)b * H + h) * N;
      const int n = row0 + (lane >> 2);
      if (n < N) lse_bh[n] = (m[0] * scale_log2 + log2f(l[0])) * kLn2;
      if (n + 8 < N) lse_bh[n + 8] = (m[1] * scale_log2 + log2f(l[1])) * kLn2;
    }
  }
}

cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int N, int M, int H, Strides qs, Strides ks, Strides vs,
                            Strides os, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, B, N, H, qs) || !encode_map(&tk, k, B, M, H, ks) ||
      !encode_map(&tv, v, B, M, H, vs))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kFwdRows - 1) / kFwdRows, H, B);
  flash_fwd_sm90_kernel<<<grid, 256, kFwdSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), N, M, H, os,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace gd3d
