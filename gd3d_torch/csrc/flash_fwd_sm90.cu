// K1 in bf16 at the kernel widths 64, 128 and 256: the flash-attention
// forward with the row log-sum-exp, on Hopper's own machinery.
// gd3d_flash_fwd (flash_fwd.cu) sends every bf16 case here; fp32 stays
// there. A head dim D below its width (a multiple of 8, so that its rows
// are 16-byte multiples) runs at that width on the caller's own rows: TMA
// fills each box's columns past D with zeros, which add nothing to Q K^T,
// and only D columns of O are stored (the wrapper zero-pads any other D up
// to 256). Head dim 64 is the student, DINOv2 and the VGGT aggregator and
// the bf16 CroCo teacher, 16 and 8 the --tiny CroCo-Stereo model; no model
// of the repo runs bf16 attention above 64, which serves the head dims
// 72..256 (72, 80 and 104 among them) that wider backbones have.
//
// Replaces, as the rest of K1 does, the stock TPU Pallas flash forward that
// gd3d calls through gd3d/ops/attention.py::_flash_call.
//
// What bounds it on an H100: arithmetic. At the student's main pass
// (2, 4161, 12, 64) the two products are 106 GFLOP against 25 MB of q, k,
// v and o, 0.108 ms at the tensor cores' 989 TFLOP/s and 0.008 ms at
// 3.35 TB/s; the same width re-headed, (2, 4161, 6, 128) or (2, 4161, 3,
// 256), does the same products. The design (sm90.cuh has the building
// blocks), one template over the head dim kD, the consumer warpgroups kWG,
// the keys a tile kKeys and the ring's stages:
//
// * Warp specialisation. A block is one producer warpgroup and kWG
//   consumer warpgroups, each of which owns 64 query rows of one (b, h).
//   The producer (one thread; where the plan hands registers over, its
//   warpgroup's are lowered to 24 by setmaxnreg and the consumers' raised
//   to 232, or 240 at kWG = 2) copies the Q tile once and then kKeys-key
//   tiles of K and V by TMA into a ring of stages, each tile completing on
//   its own mbarrier ("full") and freed by
//   the consumers on another ("empty"). K and V have barriers of their
//   own, so S starts before V has landed. A tile is kD / 64 panels of 64
//   columns (sm90.cuh).
// * S = Q K^T is kD / 16 m64nKk16 wgmma (K = kKeys) with both operands
//   K-major in shared memory. The online softmax runs on the fp32
//   accumulator in registers (row max and sum over the 4 lanes of a row, on
//   raw scores; one ffma and one exp2 a score with scale * log2(e) folded
//   in; keys past M score -inf). P, rounded to bf16, is the A-register
//   operand of O += P V: kKeys / 16 m64nDk16 wgmma (D = kD, one product
//   across the panels) with V read MN-major through the descriptor's
//   transpose bit. Neither S nor P touches shared memory.
// * Overlap. S of tile j + 1 and P V of tile j are issued together, and the
//   softmax of tile j + 1 runs while P V does (it waits only before O is
//   rescaled and P rewritten). With two consumer warpgroups, named barriers
//   make them take turns at issuing (sm90.cuh, Turns), so that one's softmax
//   runs under the other's products; they wait for V before their turn, as
//   a wait loop between their products made ptxas serialize them (C7520).
//   One consumer warpgroup waits for V after it has issued S (waiting
//   first measured 3% slower at (2, 4161, 12, 64)).
// * The plans, by head dim (registers a consumer thread: O kD / 2, S
//   kKeys / 2, P kKeys / 4; sm90.cuh, Regs, on the register budgets).
//   Times: `python3 -m gd3d_torch.kernels.sweep wide` on NVIDIA H100 80GB
//   HBM3, 700 W, each the faster of two runs in one call (the other plans
//   named here were build flags, since removed):
//   - 64: one consumer warpgroup, 128-key tiles, three stages: 104 KB of
//     shared memory and 256 threads, two blocks an SM, so one block's
//     softmax also runs under the other's products. At head dim 64 the
//     exponentials (one a score, 16 a clock an SM) take as long as the two
//     products. Two or three consumer warpgroups a block (128 or 192 rows,
//     K and V tiles shared), with or without turns, measured slower at
//     (2, 4161, 12, 64) than this plan on NVIDIA H100 80GB HBM3.
//   - 128: where 128-row blocks fill two waves (sm90.cuh, wide_tiles), two
//     consumer warpgroups sharing 128-key tiles, two stages: 160 KB, one
//     block an SM, O 64 + S 64 + P 32 registers of the 240 handed over;
//     else one consumer warpgroup with 64-key tiles, two stages: 80 KB, 150
//     registers, one block an SM (but (2, 673, 4, 128) makes 88 blocks
//     rather than 48). At (2, 4161, 6, 128) 0.1762 ms against the 64-row
//     plan's 0.2792; at (2, 673, 4, 128) 0.0180 against its 0.0148.
//   - 256: O alone is 128 registers. One consumer warpgroup, 64-key tiles,
//     two stages: 32 KB of Q and 128 KB of K and V, one block an SM, 202
//     registers; (2, 4161, 3, 256) makes 396 blocks, three full waves
//     (0.2070 ms).
// * Epilogue: O scaled by 1 / l and stored as bf16 pairs straight from the
//   accumulator, rows past N and columns past D skipped, through O's own
//   strides; the LSE as fp32 (B, H, N).
//
// Layout: q, k, v are (B, N|M, H, D) bf16 views, D <= kD, read by TMA
// through their strides (their addresses and (B, N, H) steps on 16 bytes:
// the wrapper copies a view that is not); rows past N or M and columns past
// D arrive as zeros.
#include "sm90.cuh"

namespace gd3d {
namespace sm90 {

template <int kD, int kWG, int kKeys, int kStages>
struct FwdPlan {
  static constexpr int kRows = 64 * kWG;               // queries a block
  static constexpr int kQPanel = kRows * kRowBytes;    // a panel of the Q tile
  static constexpr int kPanel = kKeys * kRowBytes;     // a panel of a K or V tile
  static constexpr int kTileBytes = kD / 64 * kPanel;
  static constexpr int kK = kD / 64 * kQPanel;         // shared memory: Q, K stages, V stages
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kSmem = kV + kStages * kTileBytes + 1024;  // + alignment slack
};

template <int kD, int kWG, int kKeys, int kStages>
__global__ void __launch_bounds__(128 * (kWG + 1), (Regs<kD, kWG>::kMinBlocks))
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, int N, int M, int H, int D, Strides os,
                      float scale_log2) {
  using L = FwdPlan<kD, kWG, kKeys, kStages>;
  constexpr int kS = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // q_full, then per stage k_full, v_full, k_empty, v_empty
  __shared__ __align__(8) uint64_t bars[1 + 4 * kS];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + L::kK;
  const uint32_t sV = sQ + L::kV;
  const uint32_t q_full = smem_u32(bars);
  auto bar = [&](int kind, int s) { return q_full + 8 * (1 + kind * kS + s); };
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * L::kRows;
  const int n_tiles = (M + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 1);
      mbar_init(bar(2, s), 128 * kWG);
      mbar_init(bar(3, s), 128 * kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    Regs<kD, kWG>::producer();
    if (threadIdx.x == 0) {
      prefetch_map(tq);
      prefetch_map(tk);
      prefetch_map(tv);
      mbar_arrive_tx(q_full, L::kK);
      tma_tile<kD, L::kRows, L::kQPanel>(sQ, tq, q_full, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kS;
        const uint32_t ph = (j / kS) & 1;
        const uint32_t off = s * L::kTileBytes;
        mbar_wait(bar(2, s), ph ^ 1);
        mbar_arrive_tx(bar(0, s), L::kTileBytes);
        tma_tile<kD, kKeys, L::kPanel>(sK + off, tk, bar(0, s), j * kKeys, h, b);
        mbar_wait(bar(3, s), ph ^ 1);
        mbar_arrive_tx(bar(1, s), L::kTileBytes);
        tma_tile<kD, kKeys, L::kPanel>(sV + off, tv, bar(1, s), j * kKeys, h, b);
      }
    }
  } else {  // a consumer warpgroup: 64 query rows
    Regs<kD, kWG>::consumer();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;
    const uint32_t sQc = sQ + c * kBoxBytes;  // this warpgroup's rows of each Q panel
    float acc[kD / 2];  // O, 64 rows x kD dims
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, raw scores
    float l[2] = {0.f, 0.f};              // this lane's part of the row sums
    float sc[kKeys / 2];                  // S, 64 rows x kKeys keys; then P
    uint32_t pa[kKeys / 16][4];           // P in bf16: the A fragments of kKeys / 16 k-steps
    Turns<kWG> turns(c, n_tiles);

    // Softmax of tile j in place: keys past M score -inf, the running max
    // and sum advance; sets corr to the factor that rescales what O holds.
    // Every tile holds a real key, so the new max is finite.
    auto softmax = [&](int j, float (&corr)[2]) {
      const int k0 = j * kKeys;
      if (k0 + kKeys > M) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i)
          if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= M) sc[i] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
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
      for (int i = 0; i < kKeys / 2; ++i) {
        const float p = fast_exp2(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
        l[(i >> 1) & 1] += p;
        sc[i] = p;
      }
    };
    auto issue_s = [&](int j) {
      const uint32_t kt = sK + (j % kS) * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss<kKeys>(sc, desc_k<L::kQPanel>(sQc, kk), desc_k<L::kPanel>(kt, kk), kk);
      wgmma_commit();
    };
    // V of tile j: one consumer warpgroup waits for it between its products,
    // two before their turn (wait_v)
    auto wait_v = [&](int j) { mbar_wait(bar(1, j % kS), (j / kS) & 1); };
    auto issue_pv = [&](int j) {
      const uint32_t vt = sV + (j % kS) * L::kTileBytes;
      if constexpr (kWG == 1) wait_v(j);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs<kD, 1>(acc, pa[kk], desc_mn<L::kPanel>(vt, kk), 1);
      wgmma_commit();
    };
    auto to_fragments = [&] {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) a_from_acc(pa[kk], sc, kk);
    };

    // S of tile j + 1 and P V of tile j run while the softmax of tile j + 1
    // does: P V waits only before O is rescaled and P overwritten
    mbar_wait(q_full, 0);
    float corr[2];
    mbar_wait(bar(0, 0), 0);
    turns.mine();
    wgmma_fence();
    issue_s(0);
    turns.theirs(0);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(bar(2, 0));
    softmax(0, corr);
    to_fragments();
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kS;
      mbar_wait(bar(0, s), (j / kS) & 1);
      if constexpr (kWG == 2) wait_v(j - 1);
      turns.mine();
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      turns.theirs(j);
      wgmma_wait<1>();
      fence_regs(sc);
      mbar_arrive(bar(2, s));
      softmax(j, corr);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar(3, (j - 1) % kS));
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      to_fragments();
    }
    if constexpr (kWG == 2) wait_v(n_tiles - 1);
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar(3, (n_tiles - 1) % kS));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row0 = q0 + c * 64 + warp * 16;
    store_acc<kD>(acc, 1.f / l[0], 1.f / l[1], o + b * os.b + h * os.h, os.n, row0, N, D,
                  lane);
    if (t == 0) {
      float* lse_bh = lse + ((long long)b * H + h) * N;
      const int n = row0 + (lane >> 2);
      if (n < N) lse_bh[n] = (m[0] * scale_log2 + log2f(l[0])) * kLn2;
      if (n + 8 < N) lse_bh[n + 8] = (m[1] * scale_log2 + log2f(l[1])) * kLn2;
    }
  }
}

template <int kD, int kWG, int kKeys, int kStages>
cudaError_t launch_fwd_plan(const CUtensorMap* maps, void* o, void* lse, int B, int N, int M,
                            int H, int D, Strides os, float scale, cudaStream_t stream) {
  constexpr int kSmem = FwdPlan<kD, kWG, kKeys, kStages>::kSmem;
  const auto kernel = flash_fwd_sm90_kernel<kD, kWG, kKeys, kStages>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + 64 * kWG - 1) / (64 * kWG), H, B);
  kernel<<<grid, 128 * (kWG + 1), kSmem, stream>>>(maps[0], maps[1], maps[2],
                                                   static_cast<bf16*>(o),
                                                   static_cast<float*>(lse), N, M, H, D,
                                                   os, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int N, int M, int H, int D, Strides qs, Strides ks,
                            Strides vs, Strides os, float scale, cudaStream_t stream) {
  if (D <= 0 || D > 256 || D % 8 != 0) return cudaErrorInvalidValue;
  CUtensorMap maps[3];  // q, k, v, each at its true head dim
  if (!encode_map(&maps[0], q, B, N, H, D, qs) || !encode_map(&maps[1], k, B, M, H, D, ks) ||
      !encode_map(&maps[2], v, B, M, H, D, vs))
    return cudaErrorInvalidValue;
  if (D <= 64)
    return launch_fwd_plan<64, 1, 128, 3>(maps, o, lse, B, N, M, H, D, os, scale, stream);
  if (D > 128)
    return launch_fwd_plan<256, 1, 64, 2>(maps, o, lse, B, N, M, H, D, os, scale, stream);
  if (wide_tiles(N, B, H))
    return launch_fwd_plan<128, 2, 128, 2>(maps, o, lse, B, N, M, H, D, os, scale, stream);
  return launch_fwd_plan<128, 1, 64, 2>(maps, o, lse, B, N, M, H, D, os, scale, stream);
}

}  // namespace sm90
}  // namespace gd3d
