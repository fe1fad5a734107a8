// K2 in bf16 at the kernel widths 64, 128 and 256: the flash-attention
// backward (dQ, dK, dV from the forward's log-sum-exp, with di = rowsum(O *
// dO) from the caller) on Hopper's own machinery. gd3d_flash_bwd
// (flash_bwd.cu) sends every bf16 case here; fp32 stays in flash_bwd.cu
// (width 64) and flash_bwd_tf32_wide.cu (128 and 256). A head dim D below
// its width (a multiple of 8) runs at that width on the caller's own rows,
// as K1 does (flash_fwd_sm90.cu): the columns past D arrive as zeros, add
// nothing to S or dP, and come out of dQ, dK and dV as columns that are
// not stored (the wrapper zero-pads any other D up to 256). Head dim 64 is
// the student under autocast, 16 and 8 the --tiny CroCo-Stereo model; no
// model of the repo trains bf16 attention above 64.
//
// Replaces, as the rest of K2 does, gd3d/kernels/flash_bwd_fused.py::
// flash_attention_bwd_fused. Like flash_bwd.cu it takes the second-pass
// route: a dK/dV kernel per key tile and a dQ kernel per query tile, seven
// tile products against the one-pass five, at best 71% of the bound. It
// needs no atomics and no scratch, and every sum runs in a fixed order, so
// two runs give the same bits, which the resume checks rely on. (Summing dQ
// across key tiles in one pass would need either unordered float atomics,
// which break that, or key tiles taking a per-query-tile lock in turn.)
//
// What bounds it on an H100: arithmetic, 2.5 times the forward's products
// (five counted, 0.269 ms at (2, 4161, 12, 64) on 989 TFLOP/s, and the same
// at (2, 4161, 6, 128) and (2, 4161, 3, 256)). Both kernels share K1's plan
// (flash_fwd_sm90.cu, sm90.cuh): a producer warpgroup (registers lowered to
// 24 by setmaxnreg) copies tiles of kD / 64 column panels by TMA into an
// mbarrier ring; consumer warpgroups of 64 rows run every product as a
// wgmma, round the intermediate P and dS to bf16 in registers as the next
// product's A operand, overlap one tile's elementwise work with the
// previous tile's last products, and store their fp32 accumulators once as
// bf16.
//
// * dK/dV: a block holds 64 keys for each group of kSplit consumer
//   warpgroups (kWG / kSplit groups). K and V arrive once by TMA. 64-query
//   tiles of Q and dO stream through a ring of stages with their lse (times
//   log2 e) and di, which the producer warp reads with plain loads (a
//   (B, H, N) row starts anywhere, so TMA cannot take it) one tile ahead,
//   so that their latency passes while it waits for a free stage, and
//   publishes on the tile's barrier. Each consumer works on the transposed
//   problem, its 64 keys by the 64 queries: S^T = K Q^T and dP^T = V dO^T
//   (m64n64k16, B K-major), then P^T = exp2(S^T scale log2 e - lse log2 e)
//   and dS^T = P^T (dP^T - di) scale in registers, then dV += P^T dO and
//   dK += dS^T Q with dO and Q read MN-major, over its kD / kSplit columns
//   of dK and dV. Registers a consumer thread: dK and dV kD / kSplit, S^T
//   and dP^T 64, P^T and dS^T in bf16 32. The plans, by head dim (times:
//   `python3 -m gd3d_torch.kernels.sweep wide` on NVIDIA H100 80GB HBM3,
//   700 W, each kernel's device time in a K2 call through torch.profiler;
//   the other plans named here were build flags, since removed):
//   - 64: K and V are also read into registers as A fragments, so the four
//     products of a tile read only the streamed operand from shared memory;
//     a four-stage ring; 64 or 128 keys a block (kWG = 1 or 2), two or one
//     block an SM. S^T and dP^T of tile i + 1 are issued with dV and dK of
//     tile i, and tile i + 1's elementwise part runs under them.
//   - 128: K and V stay in shared memory (their fragments would be another
//     64 registers): S^T and dP^T read both operands there. 128 keys a block
//     over four stages (192 KB; 0.3612 ms at (2, 4161, 6, 128)), or, where
//     those do not fill two waves, 64 over two (98 KB, 229 registers, one
//     block an SM; 0.4206 ms there). K held as A fragments as well (S^T
//     from registers) spilled and took 0.4041 ms against 0.3579, and the
//     dQ kernel with Q and dO as fragments 0.2155 against 0.2179: the
//     shared-memory reads of these products are not what bounds them.
//   - 256: dK and dV alone would be 256 registers. Two consumer warpgroups
//     share 64 keys (kSplit = 2): each computes the whole S^T and dP^T and
//     holds columns 0..127 or 128..255 of dK and dV (FlashAttention-3's
//     split), so S^T and dP^T are computed twice: nine tile products in
//     the two kernels for the bound's five. Two stages, 194 KB; 0.4800 ms
//     at (2, 4161, 3, 256).
//   Above head dim 64 a consumer waits for a tile's dV and dK before it
//   issues the next tile's S^T and dP^T: with the overlap, the
//   accumulators, S^T, dP^T and their bf16 fragments (224 registers) spill
//   at 240, and the kernel took 0.6253 and 1.1728 ms at those shapes.
// * dQ: a block holds 64 kWG queries of Q and dO; kKeys-key tiles of K and
//   V stream through a ring. S = Q K^T and dP = dO V^T (m64nKk16, both
//   operands K-major), dS in registers (keys past M give P = 0),
//   dQ += dS K with K read MN-major (one m64nDk16 across the panels). With
//   two consumer warpgroups (128-row blocks, taken where they fill two
//   waves) named barriers make them take turns at issuing their products
//   (sm90.cuh, Turns), which measured faster there than letting them issue
//   freely; shorter rows take 64-row blocks. The dK/dV kernel makes the
//   same choice on M. Head dim 64: 128-key tiles, three stages (two at
//   kWG = 1, two blocks an SM). 128: 64-key tiles (dQ 64 + S and dP 64 +
//   dS 16 registers), three stages (two, 170 registers, one block an SM):
//   0.2171 ms at (2, 4161, 6, 128), the 64-row plan 0.5164. 256: 64-key
//   tiles, one consumer warpgroup (dQ alone is 128 registers; 234 in all),
//   two stages, 193 KB: 0.3968 ms at (2, 4161, 3, 256).
//
// Ragged lengths: rows past N or M arrive as zeros. A padded query then has
// Q and dO rows of 0, and the producer gives it lse = di = 0, so its P is 1
// and its dP is 0: every term it adds to dV and dK is 0. dQ, dK and dV are
// contiguous (B, N|M, H, D): the stores write D columns a row, H * D apart.
#include "sm90.cuh"

namespace gd3d {
namespace sm90 {

// dK/dV: kWG consumer warpgroups, kSplit of them on each 64 keys.
template <int kD, int kWG, int kSplit, int kStages>
struct DkvPlan {
  static constexpr int kKeys = 64 * kWG / kSplit;       // keys a block
  static constexpr int kCols = kD / kSplit;             // columns of dK, dV a warpgroup holds
  static constexpr int kKVPanel = kKeys * kRowBytes;    // a panel of the K or V tile
  static constexpr int kKV = kD / 64 * kKVPanel;
  static constexpr int kQTile = kD / 64 * kBoxBytes;    // a Q or dO tile: 64 queries
  static constexpr int kV = kKV;                        // shared memory: K, V,
  static constexpr int kQ = 2 * kKV;                    // Q stages,
  static constexpr int kO = kQ + kStages * kQTile;      // dO stages,
  static constexpr int kStats = kO + kStages * kQTile;  // lse, di per stage
  static constexpr int kBytes = kStats + kStages * 2 * kBox * 4 + 1024;
};

template <int kD, int kWG, int kSplit, int kStages>
__global__ void __launch_bounds__(128 * (kWG + 1), (Regs<kD, kWG>::kMinBlocks))
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int M, int H,
                          int D, float scale) {
  using L = DkvPlan<kD, kWG, kSplit, kStages>;
  constexpr int kS = kStages;
  constexpr bool kRegKV = kD == 64;  // K and V as register fragments
  constexpr bool kOverlap = kD == 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // kv_full, then per stage q_full, q_empty
  __shared__ __align__(8) uint64_t bars[1 + 2 * kS];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + L::kV;
  const uint32_t sQ = sK + L::kQ;
  const uint32_t sO = sK + L::kO;
  const unsigned char* gK = smem_raw + (sK - smem_u32(smem_raw));  // generic address of K
  float* stats = reinterpret_cast<float*>(const_cast<unsigned char*>(gK) + L::kStats);
  const uint32_t kv_full = smem_u32(bars);
  auto q_full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto q_empty = [&](int s) { return kv_full + 8 * (1 + kS + s); };
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * L::kKeys;
  const int n_tiles = (N + kBox - 1) / kBox;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(q_full(s), 32);  // the producer warp's lanes
      mbar_init(q_empty(s), 128 * kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup; its first warp works
    Regs<kD, kWG>::producer();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse_bh = lse + ((long long)b * H + h) * N;
      const float* di_bh = di + ((long long)b * H + h) * N;
      if (lane == 0) {
        prefetch_map(tq);
        prefetch_map(tk);
        prefetch_map(tv);
        prefetch_map(tdo);
        mbar_arrive_tx(kv_full, 2 * L::kKV);
        tma_tile<kD, L::kKeys, L::kKVPanel>(sK, tk, kv_full, key0, h, b);
        tma_tile<kD, L::kKeys, L::kKVPanel>(sV, tv, kv_full, key0, h, b);
      }
      // this lane's two entries of lse (times log2 e) and di for query tile
      // i, read one tile ahead so that the loads' latency passes while the
      // producer waits for a free stage
      float lv[2], dv[2];
      auto read = [&](int i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = i * kBox + lane + 32 * j;
          lv[j] = n < N ? lse_bh[n] * kLog2e : 0.f;
          dv[j] = n < N ? di_bh[n] : 0.f;
        }
      };
      read(0);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kS;
        mbar_wait(q_empty(s), ((i / kS) & 1) ^ 1);
        float* st = stats + s * 2 * kBox;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          st[lane + 32 * j] = lv[j];
          st[kBox + lane + 32 * j] = dv[j];
        }
        if (lane == 0) {
          mbar_arrive_tx(q_full(s), 2 * L::kQTile);
          tma_tile<kD, kBox, kBoxBytes>(sQ + s * L::kQTile, tq, q_full(s), i * kBox, h, b);
          tma_tile<kD, kBox, kBoxBytes>(sO + s * L::kQTile, tdo, q_full(s), i * kBox, h, b);
        } else {
          mbar_arrive(q_full(s));
        }
        read(i + 1);
      }
    }
  } else {  // a consumer warpgroup: 64 keys, kD / kSplit columns of dK and dV
    Regs<kD, kWG>::consumer();
    const int c = threadIdx.x / 128 - 1;
    const int grp = c / kSplit;                     // its keys: grp * 64 ..
    const uint32_t cols = c % kSplit * L::kCols / 64 * kBoxBytes;  // its first panel
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;
    const float scale_log2 = scale * kLog2e;
    float dk_acc[L::kCols / 2], dv_acc[L::kCols / 2];
#pragma unroll
    for (int i = 0; i < L::kCols / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float st_[32], dp[32];        // S^T and dP^T, 64 keys x 64 queries; then P^T, dS^T
    uint32_t pa[4][4], da[4][4];  // P^T and dS^T in bf16: the A fragments of 4 k-steps
    uint32_t kf[kRegKV ? 4 : 1][4], vf[kRegKV ? 4 : 1][4];  // head dim 64: K, V rows
    Turns<kWG> turns(c, n_tiles);
    mbar_wait(kv_full, 0);
    if constexpr (kRegKV) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a_from_tile(kf[kk], gK + grp * kBoxBytes, warp * 16, kk, lane);
        a_from_tile(vf[kk], gK + L::kV + grp * kBoxBytes, warp * 16, kk, lane);
      }
    }
    auto issue_s = [&](int i) {
      const uint32_t qt = sQ + (i % kS) * L::kQTile;
      const uint32_t ot = sO + (i % kS) * L::kQTile;
      if constexpr (kRegKV) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<64, 0>(st_, kf[kk], desc_k<kBoxBytes>(qt, kk), kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<64, 0>(dp, vf[kk], desc_k<kBoxBytes>(ot, kk), kk);
      } else {
        const uint32_t kt = sK + grp * kBoxBytes, vt = sV + grp * kBoxBytes;
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          wgmma_ss<64>(st_, desc_k<L::kKVPanel>(kt, kk), desc_k<kBoxBytes>(qt, kk), kk);
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          wgmma_ss<64>(dp, desc_k<L::kKVPanel>(vt, kk), desc_k<kBoxBytes>(ot, kk), kk);
      }
      wgmma_commit();
    };
    auto issue_dkv = [&](int i) {
      const uint32_t qt = sQ + (i % kS) * L::kQTile + cols;
      const uint32_t ot = sO + (i % kS) * L::kQTile + cols;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<L::kCols, 1>(dv_acc, pa[kk], desc_mn<kBoxBytes>(ot, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<L::kCols, 1>(dk_acc, da[kk], desc_mn<kBoxBytes>(qt, kk), 1);
      wgmma_commit();
    };
    // P^T and dS^T of query tile i in place; the column (query) picks lse and di
    auto elementwise = [&](int i) {
      const float* lse_t = stats + (i % kS) * 2 * kBox;
      const float* di_t = lse_t + kBox;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int col = 8 * cc + 2 * t;
        const float2 lv = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 dv2 = *reinterpret_cast<const float2*>(di_t + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(st_[4 * cc + e], scale_log2, -((e & 1) ? lv.y : lv.x)));
          dp[4 * cc + e] = p * (dp[4 * cc + e] - ((e & 1) ? dv2.y : dv2.x)) * scale;
          st_[4 * cc + e] = p;
        }
      }
    };
    auto to_fragments = [&] {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a_from_acc(pa[kk], st_, kk);
        a_from_acc(da[kk], dp, kk);
      }
    };

    if constexpr (kOverlap) {
      // S^T and dP^T of tile i + 1 and dV, dK of tile i run while tile
      // i + 1's elementwise part does
      mbar_wait(q_full(0), 0);
      turns.mine();
      wgmma_fence();
      issue_s(0);
      turns.theirs(0);
      wgmma_wait<0>();
      fence_regs(st_);
      fence_regs(dp);
      elementwise(0);
      to_fragments();
      for (int i = 1; i < n_tiles; ++i) {
        mbar_wait(q_full(i % kS), (i / kS) & 1);
        turns.mine();
        wgmma_fence();
        issue_s(i);
        issue_dkv(i - 1);
        turns.theirs(i);
        wgmma_wait<1>();
        fence_regs(st_);
        fence_regs(dp);
        elementwise(i);
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        mbar_arrive(q_empty((i - 1) % kS));
        to_fragments();
      }
      wgmma_fence();
      issue_dkv(n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(q_empty((n_tiles - 1) % kS));
    } else {
      // a tile's dV and dK done before the next tile's S^T and dP^T
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(q_full(i % kS), (i / kS) & 1);
        turns.mine();
        wgmma_fence();
        issue_s(i);
        turns.theirs(i);
        wgmma_wait<0>();
        fence_regs(st_);
        fence_regs(dp);
        elementwise(i);
        to_fragments();
        wgmma_fence();
        issue_dkv(i);
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        mbar_arrive(q_empty(i % kS));
      }
    }
    const int col0 = c % kSplit * L::kCols;  // this warpgroup's first column
    const long long off = ((long long)b * M * H + h) * D + col0;
    const int row0 = key0 + grp * 64 + warp * 16;
    store_acc<L::kCols>(dk_acc, 1.f, 1.f, dk + off, (long long)H * D, row0, M, D - col0, lane);
    store_acc<L::kCols>(dv_acc, 1.f, 1.f, dv + off, (long long)H * D, row0, M, D - col0, lane);
  }
}

// dQ: kWG consumer warpgroups of 64 queries, kKeys-key tiles.
template <int kD, int kWG, int kKeys, int kStages>
struct DqPlan {
  static constexpr int kRows = 64 * kWG;              // queries a block
  static constexpr int kQPanel = kRows * kRowBytes;   // a panel of the Q or dO tile
  static constexpr int kPanel = kKeys * kRowBytes;    // a panel of a K or V tile
  static constexpr int kTileBytes = kD / 64 * kPanel;
  static constexpr int kO = kD / 64 * kQPanel;        // shared memory: Q, dO,
  static constexpr int kK = 2 * kO;                   // K stages,
  static constexpr int kV = kK + kStages * kTileBytes;  // V stages
  static constexpr int kBytes = kV + kStages * kTileBytes + 1024;
};

template <int kD, int kWG, int kKeys, int kStages>
__global__ void __launch_bounds__(128 * (kWG + 1), (Regs<kD, kWG>::kMinBlocks))
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         bf16* __restrict__ dq, int N, int M, int H, int D, float scale) {
  using L = DqPlan<kD, kWG, kKeys, kStages>;
  constexpr int kS = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // qo_full, then per stage kv_full, kv_empty
  __shared__ __align__(8) uint64_t bars[1 + 2 * kS];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sO = sQ + L::kO;
  const uint32_t sK = sQ + L::kK;
  const uint32_t sV = sQ + L::kV;
  const uint32_t qo_full = smem_u32(bars);
  auto kv_full = [&](int s) { return qo_full + 8 * (1 + s); };
  auto kv_empty = [&](int s) { return qo_full + 8 * (1 + kS + s); };
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * L::kRows;
  const int n_tiles = (M + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), 128 * kWG);
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
      prefetch_map(tdo);
      mbar_arrive_tx(qo_full, 2 * L::kO);
      tma_tile<kD, L::kRows, L::kQPanel>(sQ, tq, qo_full, q0, h, b);
      tma_tile<kD, L::kRows, L::kQPanel>(sO, tdo, qo_full, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kS;
        const uint32_t ph = (j / kS) & 1;
        const uint32_t off = s * L::kTileBytes;
        mbar_wait(kv_empty(s), ph ^ 1);
        mbar_arrive_tx(kv_full(s), 2 * L::kTileBytes);
        tma_tile<kD, kKeys, L::kPanel>(sK + off, tk, kv_full(s), j * kKeys, h, b);
        tma_tile<kD, kKeys, L::kPanel>(sV + off, tv, kv_full(s), j * kKeys, h, b);
      }
    }
  } else {  // a consumer warpgroup: 64 queries
    Regs<kD, kWG>::consumer();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;
    const uint32_t sQc = sQ + c * kBoxBytes;  // this warpgroup's rows of each panel
    const uint32_t sOc = sO + c * kBoxBytes;
    const float scale_log2 = scale * kLog2e;
    const int row0 = q0 + c * 64 + warp * 16;
    // this lane's rows g and g + 8: lse in log2 units and di
    const float* lse_bh = lse + ((long long)b * H + h) * N;
    const float* di_bh = di + ((long long)b * H + h) * N;
    float lse2[2], dii[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = row0 + (lane >> 2) + 8 * r;
      lse2[r] = n < N ? lse_bh[n] * kLog2e : 0.f;
      dii[r] = n < N ? di_bh[n] : 0.f;
    }
    Turns<kWG> turns(c, n_tiles);
    float dq_acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dq_acc[i] = 0.f;
    float sc[kKeys / 2], dp[kKeys / 2];  // S and dP, 64 queries x kKeys keys; then dS in sc
    uint32_t da[kKeys / 16][4];          // dS in bf16: the A fragments of kKeys / 16 k-steps
    auto issue_s = [&](int j) {
      const uint32_t kt = sK + (j % kS) * L::kTileBytes;
      const uint32_t vt = sV + (j % kS) * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss<kKeys>(sc, desc_k<L::kQPanel>(sQc, kk), desc_k<L::kPanel>(kt, kk), kk);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss<kKeys>(dp, desc_k<L::kQPanel>(sOc, kk), desc_k<L::kPanel>(vt, kk), kk);
      wgmma_commit();
    };
    auto issue_dq = [&](int j) {
      const uint32_t kt = sK + (j % kS) * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs<kD, 1>(dq_acc, da[kk], desc_mn<L::kPanel>(kt, kk), 1);
      wgmma_commit();
    };
    auto elementwise = [&](int j) {  // dS of key tile j in sc; keys past M give P = 0
      const int k0 = j * kKeys;
      if (k0 + kKeys > M) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i)
          if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= M) sc[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = fast_exp2(fmaf(sc[i], scale_log2, -lse2[r]));
        sc[i] = p * (dp[i] - dii[r]) * scale;
      }
    };
    auto to_fragments = [&] {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) a_from_acc(da[kk], sc, kk);
    };

    // S and dP of key tile j + 1 and dQ of tile j run while tile j + 1's
    // elementwise part does
    mbar_wait(qo_full, 0);
    mbar_wait(kv_full(0), 0);
    turns.mine();
    wgmma_fence();
    issue_s(0);
    turns.theirs(0);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    elementwise(0);
    to_fragments();
    for (int j = 1; j < n_tiles; ++j) {
      mbar_wait(kv_full(j % kS), (j / kS) & 1);
      turns.mine();
      wgmma_fence();
      issue_s(j);
      issue_dq(j - 1);
      turns.theirs(j);
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      elementwise(j);
      wgmma_wait<0>();
      fence_regs(dq_acc);
      mbar_arrive(kv_empty((j - 1) % kS));
      to_fragments();
    }
    wgmma_fence();
    issue_dq(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(dq_acc);
    mbar_arrive(kv_empty((n_tiles - 1) % kS));
    store_acc<kD>(dq_acc, 1.f, 1.f, dq + ((long long)b * N * H + h) * D, (long long)H * D,
                  row0, N, D, lane);
  }
}

template <int kD, int kWG, int kSplit, int kStages>
cudaError_t launch_dkv(const CUtensorMap* maps, const float* lse, const float* di, void* dk,
                       void* dv, int B, int N, int M, int H, int D, float scale,
                       cudaStream_t stream) {
  using L = DkvPlan<kD, kWG, kSplit, kStages>;
  const auto kernel = flash_bwd_dkv_sm90_kernel<kD, kWG, kSplit, kStages>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + L::kKeys - 1) / L::kKeys, H, B);
  kernel<<<grid, 128 * (kWG + 1), L::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), N, M, H, D, scale);
  return cudaGetLastError();
}

template <int kD, int kWG, int kKeys, int kStages>
cudaError_t launch_dq(const CUtensorMap* maps, const float* lse, const float* di, void* dq,
                      int B, int N, int M, int H, int D, float scale, cudaStream_t stream) {
  using L = DqPlan<kD, kWG, kKeys, kStages>;
  const auto kernel = flash_bwd_dq_sm90_kernel<kD, kWG, kKeys, kStages>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + L::kRows - 1) / L::kRows, H, B);
  kernel<<<grid, 128 * (kWG + 1), L::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, static_cast<bf16*>(dq), N, M, H, D, scale);
  return cudaGetLastError();
}

// The two kernels at one kernel width kD (head dim D <= kD): 128-row
// (128-key) blocks where they fill two waves, else 64-row ones; width 256
// has one plan of each.
template <int kD>
cudaError_t launch_bwd_plans(const CUtensorMap* maps, const float* lse, const float* di,
                             void* dq, void* dk, void* dv, int B, int N, int M, int H, int D,
                             float scale, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (kD == 256)
    err = launch_dkv<256, 2, 2, 2>(maps, lse, di, dk, dv, B, N, M, H, D, scale, stream);
  else if (wide_tiles(M, B, H))
    err = launch_dkv<kD, 2, 1, 4>(maps, lse, di, dk, dv, B, N, M, H, D, scale, stream);
  else
    err = launch_dkv<kD, 1, 1, kD == 64 ? 4 : 2>(maps, lse, di, dk, dv, B, N, M, H, D, scale,
                                                 stream);
  if (err != cudaSuccess) return err;
  constexpr int kKeys = kD == 64 ? 128 : 64;
  if constexpr (kD == 256)
    return launch_dq<256, 1, 64, 2>(maps, lse, di, dq, B, N, M, H, D, scale, stream);
  else if (wide_tiles(N, B, H))
    return launch_dq<kD, 2, kKeys, 3>(maps, lse, di, dq, B, N, M, H, D, scale, stream);
  else
    return launch_dq<kD, 1, kKeys, 2>(maps, lse, di, dq, B, N, M, H, D, scale, stream);
}

cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, void* dq, void* dk, void* dv,
                            int B, int N, int M, int H, int D, Strides qs, Strides ks,
                            Strides vs, Strides dos, float scale, cudaStream_t stream) {
  if (D <= 0 || D > 256 || D % 8 != 0) return cudaErrorInvalidValue;
  CUtensorMap maps[4];  // q, k, v, dO, each at its true head dim
  if (!encode_map(&maps[0], q, B, N, H, D, qs) || !encode_map(&maps[1], k, B, M, H, D, ks) ||
      !encode_map(&maps[2], v, B, M, H, D, vs) || !encode_map(&maps[3], dout, B, N, H, D, dos))
    return cudaErrorInvalidValue;
  const float* lse_ = static_cast<const float*>(lse);
  const float* di_ = static_cast<const float*>(di);
  if (D <= 64)
    return launch_bwd_plans<64>(maps, lse_, di_, dq, dk, dv, B, N, M, H, D, scale, stream);
  if (D <= 128)
    return launch_bwd_plans<128>(maps, lse_, di_, dq, dk, dv, B, N, M, H, D, scale, stream);
  return launch_bwd_plans<256>(maps, lse_, di_, dq, dk, dv, B, N, M, H, D, scale, stream);
}

}  // namespace sm90
}  // namespace gd3d
