// K2 in bf16 at head dim 64 (the student under autocast): the flash-attention
// backward (dQ, dK, dV from the forward's log-sum-exp, with di = rowsum(O *
// dO) from the caller) on Hopper's own machinery. gd3d_flash_bwd
// (flash_bwd.cu) sends that case here; fp32 stays there.
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
// (five counted, 0.269 ms at (2, 4161, 12, 64) on 989 TFLOP/s). Both kernels
// share K1's plan (flash_fwd_sm90.cu, sm90.cuh): a producer warpgroup
// (registers lowered to 24 by setmaxnreg) copies tiles by TMA into an
// mbarrier ring; consumer warpgroups of 64 rows run every product as a
// wgmma, round the intermediate P and dS to bf16 in registers as the next
// product's A operand, overlap one tile's elementwise work with the
// previous tile's last products, and store their fp32 accumulators once as
// bf16.
//
// * dK/dV: a block holds 64 kWG keys, 64 for each consumer warpgroup. K and
//   V arrive once by TMA and are read into registers as A fragments, so the
//   four products of a tile read only the streamed operand from shared
//   memory. 64-query tiles of Q and dO stream through a four-stage ring
//   with their lse (times log2 e) and di, which the producer warp reads
//   with plain loads (a (B, H, N) row starts anywhere, so TMA cannot take
//   it) one tile ahead, so that their latency passes while it waits for a
//   free stage, and publishes on the tile's barrier. Each consumer works on
//   the transposed problem, its 64 keys by the 64 queries: S^T = K Q^T and dP^T = V dO^T (m64n64k16, B K-major), then
//   P^T = exp2(S^T scale log2 e - lse log2 e) and
//   dS^T = P^T (dP^T - di) scale in registers, then dV += P^T dO and
//   dK += dS^T Q with dO and Q read MN-major.
// * dQ: a block holds 64 kWG queries of Q and dO; 128-key tiles of K and V
//   stream through a ring of three stages (two at kWG = 1). S = Q K^T and
//   dP = dO V^T (m64n128k16, both operands K-major), dS in registers
//   (keys past M give P = 0), dQ += dS K with K read MN-major. With two
//   consumer warpgroups (128-row blocks, taken where they fill two waves)
//   named barriers make them take turns at issuing their products
//   (sm90.cuh, Turns), which measured faster there than letting them issue
//   freely; shorter rows take 64-row blocks, two an SM. The dK/dV kernel
//   makes the same choice on M.
//
// Ragged lengths: rows past N or M arrive as zeros. A padded query then has
// Q and dO rows of 0, and the producer gives it lse = di = 0, so its P is 1
// and its dP is 0: every term it adds to dV and dK is 0.
#include "sm90.cuh"

namespace gd3d {
namespace sm90 {

constexpr int kDkvStages = 4;
constexpr int kDqKeys = 128;  // keys a tile of the dQ kernel

// dK/dV: kWG consumer warpgroups of 64 keys a block.
template <int kWG>
struct DkvSmem {
  static constexpr int kKeys = 64 * kWG;
  static constexpr int kV = kWG * kBoxBytes;                    // K, then V
  static constexpr int kQ = 2 * kV;                             // Q stages
  static constexpr int kO = kQ + kDkvStages * kBoxBytes;        // dO stages
  static constexpr int kStats = kO + kDkvStages * kBoxBytes;    // lse, di per stage
  static constexpr int kBytes = kStats + kDkvStages * 2 * kBox * 4 + 1024;
};

template <int kWG>
__global__ void __launch_bounds__(128 * (kWG + 1), kWG == 1 ? 2 : 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int M, int H,
                          float scale) {
  using L = DkvSmem<kWG>;
  constexpr int kS = kDkvStages;
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
    regs_down<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse_bh = lse + ((long long)b * H + h) * N;
      const float* di_bh = di + ((long long)b * H + h) * N;
      if (lane == 0) {
        prefetch_map(tq);
        prefetch_map(tk);
        prefetch_map(tv);
        prefetch_map(tdo);
        mbar_arrive_tx(kv_full, 2 * L::kV);
        for (int i = 0; i < kWG; ++i) {
          tma_load(sK + i * kBoxBytes, tk, kv_full, key0 + i * kBox, h, b);
          tma_load(sV + i * kBoxBytes, tv, kv_full, key0 + i * kBox, h, b);
        }
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
          mbar_arrive_tx(q_full(s), 2 * kBoxBytes);
          tma_load(sQ + s * kBoxBytes, tq, q_full(s), i * kBox, h, b);
          tma_load(sO + s * kBoxBytes, tdo, q_full(s), i * kBox, h, b);
        } else {
          mbar_arrive(q_full(s));
        }
        read(i + 1);
      }
    }
  } else {  // a consumer warpgroup: 64 keys
    regs_up<kWG == 1 ? 232 : 240>();  // all the producer gave up
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;
    const float scale_log2 = scale * kLog2e;
    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float st_[32], dp[32];        // S^T and dP^T, 64 keys x 64 queries; then P^T, dS^T
    uint32_t pa[4][4], da[4][4];  // P^T and dS^T in bf16: the A fragments of 4 k-steps
    uint32_t kf[4][4], vf[4][4];  // the block's K and V rows, read once
    Turns<kWG> turns(c, n_tiles);
    mbar_wait(kv_full, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_from_tile(kf[kk], gK + c * kBoxBytes, warp * 16, kk, lane);
      a_from_tile(vf[kk], gK + L::kV + c * kBoxBytes, warp * 16, kk, lane);
    }
    auto issue_s = [&](int i) {
      const uint32_t qt = sQ + (i % kS) * kBoxBytes;
      const uint32_t ot = sO + (i % kS) * kBoxBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_k(st_, kf[kk], desc_k(qt, kk), kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_k(dp, vf[kk], desc_k(ot, kk), kk);
      wgmma_commit();
    };
    auto issue_dkv = [&](int i) {
      const uint32_t qt = sQ + (i % kS) * kBoxBytes;
      const uint32_t ot = sO + (i % kS) * kBoxBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_mn(dv_acc, pa[kk], desc_mn(ot, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_mn(dk_acc, da[kk], desc_mn(qt, kk), 1);
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

    // S^T and dP^T of tile i + 1 and dV, dK of tile i run while tile i + 1's
    // elementwise part does
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
    const long long off = (long long)b * M * H * 64 + h * 64;
    const int row0 = key0 + c * 64 + warp * 16;
    store_acc(dk_acc, 1.f, 1.f, dk + off, (long long)H * 64, row0, M, lane);
    store_acc(dv_acc, 1.f, 1.f, dv + off, (long long)H * 64, row0, M, lane);
  }
}

template <int kWG>
struct DqSmem {
  static constexpr int kStages = kWG == 1 ? 2 : 3;
  static constexpr int kRows = 64 * kWG;  // queries a block
  static constexpr int kTileBytes = kDqKeys * kRowBytes;
  static constexpr int kO = kRows * kRowBytes;
  static constexpr int kK = 2 * kO;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBytes = kV + kStages * kTileBytes + 1024;
};

template <int kWG>
__global__ void __launch_bounds__(128 * (kWG + 1), kWG == 1 ? 2 : 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         bf16* __restrict__ dq, int N, int M, int H, float scale) {
  using L = DqSmem<kWG>;
  constexpr int kS = L::kStages;
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
  const int n_tiles = (M + kDqKeys - 1) / kDqKeys;
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
    regs_down<24>();
    if (threadIdx.x == 0) {
      prefetch_map(tq);
      prefetch_map(tk);
      prefetch_map(tv);
      prefetch_map(tdo);
      mbar_arrive_tx(qo_full, 2 * L::kRows * kRowBytes);
      for (int i = 0; i < kWG; ++i) {
        tma_load(sQ + i * kBoxBytes, tq, qo_full, q0 + i * kBox, h, b);
        tma_load(sO + i * kBoxBytes, tdo, qo_full, q0 + i * kBox, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kS;
        const uint32_t ph = (j / kS) & 1;
        const uint32_t off = s * L::kTileBytes;
        mbar_wait(kv_empty(s), ph ^ 1);
        mbar_arrive_tx(kv_full(s), 2 * L::kTileBytes);
        for (int i = 0; i < kDqKeys / kBox; ++i) {
          tma_load(sK + off + i * kBoxBytes, tk, kv_full(s), j * kDqKeys + i * kBox, h, b);
          tma_load(sV + off + i * kBoxBytes, tv, kv_full(s), j * kDqKeys + i * kBox, h, b);
        }
      }
    }
  } else {  // a consumer warpgroup: 64 queries
    regs_up<kWG == 1 ? 232 : 240>();  // all the producer gave up
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;
    const uint32_t sQc = sQ + c * kBoxBytes;
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
    float dq_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
    float sc[64], dp[64];  // S and dP, 64 queries x 128 keys; then dS in sc
    uint32_t da[8][4];     // dS in bf16: the A fragments of 8 k-steps
    auto issue_s = [&](int j) {
      const uint32_t kt = sK + (j % kS) * L::kTileBytes;
      const uint32_t vt = sV + (j % kS) * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(sc, desc_k(sQc, kk), desc_k(kt, kk), kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(dp, desc_k(sOc, kk), desc_k(vt, kk), kk);
      wgmma_commit();
    };
    auto issue_dq = [&](int j) {
      const uint32_t kt = sK + (j % kS) * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs_n64_mn(dq_acc, da[kk], desc_mn(kt, kk), 1);
      wgmma_commit();
    };
    auto elementwise = [&](int j) {  // dS of key tile j in sc; keys past M give P = 0
      const int k0 = j * kDqKeys;
      if (k0 + kDqKeys > M) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= M) sc[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        const float p = fast_exp2(fmaf(sc[i], scale_log2, -lse2[r]));
        sc[i] = p * (dp[i] - dii[r]) * scale;
      }
    };
    auto to_fragments = [&] {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) a_from_acc(da[kk], sc, kk);
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
    store_acc(dq_acc, 1.f, 1.f, dq + (long long)b * N * H * 64 + h * 64, (long long)H * 64,
              row0, N, lane);
  }
}

template <int kWG>
cudaError_t launch_dkv(const CUtensorMap* maps, const float* lse, const float* di, void* dk,
                       void* dv, int B, int N, int M, int H, float scale, cudaStream_t stream) {
  constexpr int kBytes = DkvSmem<kWG>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<kWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + 64 * kWG - 1) / (64 * kWG), H, B);
  flash_bwd_dkv_sm90_kernel<kWG><<<grid, 128 * (kWG + 1), kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), N, M, H, scale);
  return cudaGetLastError();
}

template <int kWG>
cudaError_t launch_dq(const CUtensorMap* maps, const float* lse, const float* di, void* dq,
                      int B, int N, int M, int H, float scale, cudaStream_t stream) {
  constexpr int kBytes = DqSmem<kWG>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<kWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + 64 * kWG - 1) / (64 * kWG), H, B);
  flash_bwd_dq_sm90_kernel<kWG><<<grid, 128 * (kWG + 1), kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, static_cast<bf16*>(dq), N, M, H, scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, void* dq, void* dk, void* dv,
                            int B, int N, int M, int H, Strides qs, Strides ks, Strides vs,
                            Strides dos, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];  // q, k, v, dO
  if (!encode_map(&maps[0], q, B, N, H, qs) || !encode_map(&maps[1], k, B, M, H, ks) ||
      !encode_map(&maps[2], v, B, M, H, vs) || !encode_map(&maps[3], dout, B, N, H, dos))
    return cudaErrorInvalidValue;
  const float* lse_ = static_cast<const float*>(lse);
  const float* di_ = static_cast<const float*>(di);
  const cudaError_t err =
      wide_tiles(M, B, H)
          ? launch_dkv<2>(maps, lse_, di_, dk, dv, B, N, M, H, scale, stream)
          : launch_dkv<1>(maps, lse_, di_, dk, dv, B, N, M, H, scale, stream);
  if (err != cudaSuccess) return err;
  return wide_tiles(N, B, H) ? launch_dq<2>(maps, lse_, di_, dq, B, N, M, H, scale, stream)
                             : launch_dq<1>(maps, lse_, di_, dq, B, N, M, H, scale, stream);
}

}  // namespace sm90
}  // namespace gd3d
