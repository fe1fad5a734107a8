// K2 at head dims 128 and 256 in fp32: flash-attention backward (dQ, dK,
// dV) from the forward's log-sum-exp, on the tensor cores.
//
// Replaces gd3d/kernels/flash_bwd_fused.py::flash_attention_bwd_fused for
// fp32 operands at the kernel widths 128 and 256 (head dims 65..128 and
// 129..256; bf16 at every width runs flash_bwd_sm90.cu, fp32 at 64
// flash_bwd.cu). A head dim Dh below the width D that is a multiple of 4
// runs on the caller's own rows: the copies fill the columns past Dh with
// zeros, which add nothing to S^T or dP^T, and the stores write Dh
// columns; the wrapper zero-pads any other head dim to the width
// (kernels/flash_bwd_fused.py::bwd_padded). No path of the repo trains
// attention this wide; gd3d takes any head dim.
//
// What bounds it on an H100: arithmetic, seven tile products a (query, key)
// pair, each three TF32 mma.sync (mma.cuh: every fp32 operand split into a
// hi and a lo part, which keeps fp32 accuracy), against 495 / 3 TFLOP/s.
// The math and the scheme are flash_bwd.cu's fp32 route at 64: two passes
// with no atomics, every sum in a fixed order, so two runs give the same
// bits:
//   - dK/dV (dkv_block): a block owns kOwn keys, 16 a group of warps, with
//     query tiles of Q and dO streaming through. It works on the transposed
//     problem, S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T = P^T *
//     (dP^T - di) * scale are already the A operands of dV += P^T dO and
//     dK += dS^T Q (C column 2t read as A column t and 2t + 1 as t + 4,
//     a_from_c_tf32; the B operand then holds queries 2t and 2t + 1 in its
//     rows t and t + 4).
//   - dQ (dq_block): a block owns kOwn queries, key tiles of K and V
//     streaming through; S = Q K^T and dP = dO V^T give dS, the A operand of
//     dQ += dS K.
//   One launch runs both passes (flash_bwd_tf32_wide_kernel): the grid's z
//   holds the role, dK/dV blocks first.
//
// The budget, and the plan it leaves (Plan<D>). At 64 a warp owns 16 rows
// with their K and V (Q and dO) in registers beside its accumulators; a
// warp's accumulators alone, 16 rows D wide, take D / 2 floats a thread, so
// dK and dV take 256 at D = 256. Here a team of kTeam warps owns 16 rows and
// splits the head dim: each runs the k-steps of S^T and dP^T (S and dP)
// over its D / kTeam columns, a partial C tile; the team sums the parts
// through shared memory (mma.cuh, team_sum: same order, same bits in every
// warp), and each warp then runs dV and dK (dQ) into its D / kTeam output
// columns. No product is done twice; the exponentials and the splits of
// P^T and dS^T are, once a warp of the team. The kernels are bound less by
// the tensor cores than by the latency of each warp's chains of dependent
// mma.sync, so what counts most is how many warps an SM holds; teams buy
// warps, as an accumulator a quarter as wide lets four warps fit where one
// did.
//   - The own rows lie raw in shared memory (rows of D + 4 floats, no bank
//     conflicts), their A fragments loaded by ldmatrix and split at use,
//     once a k-step and tile. A streamed tile lands raw (cp.async, 16 bytes a
//     copy, during the products on the tile before) and is split once a
//     block into hi and lo tiles, whose S-type B fragments come by ldmatrix
//     too (4 registers in one instruction). The lse and di of a query tile
//     are read from device memory into registers.
//   - D = 128: 4 groups of 2 warps (64 own rows, 256 threads), 32-row
//     streamed tiles: 204800 bytes of shared memory, 1 block of 8 warps an
//     SM, 233 registers, no spills.
//   - D = 256: 3 groups of 4 warps (48 own rows, 384 threads), 16-row
//     streamed tiles: 229888 bytes, 1 block of 12 warps an SM, 168
//     registers, no spills. A 16-row tile gives S^T and dP^T two n-tiles
//     each, four chains of 3 x 8 dependent mma.sync a warp: even and odd
//     k-steps sum apart (kKs) and add, so eight chains are in flight.
//   - Grid: at (2,673,4,D) 11 x 8 (D = 128) or 15 x 8 (256) blocks a pass,
//     which alone would leave 44 or 12 of the 132 SMs idle; with both passes
//     in one launch, dK/dV first, 176 or 240 blocks run in 1.3 or 1.8
//     waves. At (2,4161,6,128) 66 x 12 x 2 = 1584 blocks, at (2,4161,3,256)
//     87 x 6 x 2 = 1044.
//
// Layout: q, k, v, dout are (B, N, H, D) views read through their strides,
// whose addresses and (B, N, H) steps fall on 16 bytes (the wrapper copies
// a view that does not), Dh columns a row; dq, dk, dv are contiguous
// (B, N|M, H, Dh); lse and di are contiguous (B, H, N) fp32. Rows past N or
// M are copied as zeros: a padded query's Q and dO rows are 0 and its lse
// and di read as 0, so it adds exactly 0 to dK and dV; the dQ pass gives
// keys past M a P of 0.
#include "common.cuh"
#include "mma.cuh"

namespace gd3d {
namespace tf32_wide {

template <int D>
struct Plan {
  static_assert(D == 128 || D == 256, "kernel widths 128 and 256");
  static constexpr int kLd = D + 4;                 // floats a row the products read
  static constexpr int kGroups = D == 128 ? 4 : 3;  // 16-row groups a block
  static constexpr int kTeam = D == 128 ? 2 : 4;    // warps a group, splitting D
  static constexpr int kWarps = kTeam * kGroups;
  static constexpr int kN = 32 * kWarps;            // threads a block
  static constexpr int kOwn = 16 * kGroups;         // own rows a block
  static constexpr int kRows = D == 128 ? 32 : 16;  // rows a streamed tile
  static constexpr int kNt = kRows / 8;             // n-tiles of an S-type product
  static constexpr int kKs = kNt < 4 ? 2 : 1;       // its partial sums over k-steps
  static constexpr int kSteps = D / 8 / kTeam;      // k-steps (output n-tiles) a warp
  static constexpr int kXF = tc::team_part_floats<2 * kNt * 4>();  // a warp's S, dP parts
  static constexpr int kOwnF = kOwn * kLd;          // floats of the own K (Q) or V (dO)
  static constexpr int kRawF = kRows * D;           // floats of a raw streamed tile
  static constexpr int kSplitF = kRows * kLd;       // floats of a split part
  static constexpr int kSmem = (2 * kOwnF + 2 * kRawF + 4 * kSplitF + kWarps * kXF) * 4;
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// dK, dV for the kOwn keys of tile `tile` of one (b, h), looping over every
// query tile. Shared memory: the own K and V rows, the raw tiles of Q and
// dO, the split tiles Q hi, Q lo, dO hi, dO lo, and each warp's parts of
// S^T and dP^T.
template <int D>
__device__ __forceinline__ void dkv_block(int tile, int b, const float* __restrict__ q,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const float* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ di, float* __restrict__ dk,
                                          float* __restrict__ dv, int N, int M, int H, int Dh,
                                          Strides qs, Strides ks, Strides vs, Strides dos,
                                          float scale) {
  using P = Plan<D>;
  constexpr int kLd = P::kLd, kRows = P::kRows, kNt = P::kNt, kKs = P::kKs, kN = P::kN;
  constexpr int kSteps = P::kSteps, kTeam = P::kTeam;
  extern __shared__ __align__(16) float smem_f[];
  float* Ks = smem_f;
  float* Vs = Ks + P::kOwnF;
  float* rawQ = Vs + P::kOwnF;
  float* rawO = rawQ + P::kRawF;
  float* Qhi = rawO + P::kRawF;
  float* Qlo = Qhi + P::kSplitF;
  float* Ohi = Qlo + P::kSplitF;
  float* Olo = Ohi + P::kSplitF;
  float* xch = Olo + P::kSplitF;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp % P::kGroups;  // the 16 keys
  const int part = warp / P::kGroups;   // the part of the head dim
  const int h = blockIdx.y;
  const int key0 = tile * P::kOwn;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* di_bh = di + ((long long)b * H + h) * N;
  auto copy_tile = [&](int i0) {
    tc::copy_rows_async<kRows, D, D, kN>(smem_u32(rawQ), qb, qs.n, i0, N, Dh);
    tc::copy_rows_async<kRows, D, D, kN>(smem_u32(rawO), dob, dos.n, i0, N, Dh);
    cp_async_commit();
  };
  tc::copy_rows_async<P::kOwn, D, kLd, kN>(smem_u32(Ks), k + b * ks.b + h * ks.h, ks.n, key0, M,
                                           Dh);
  tc::copy_rows_async<P::kOwn, D, kLd, kN>(smem_u32(Vs), v + b * vs.b + h * vs.h, vs.n, key0, M,
                                           Dh);
  copy_tile(0);
  const uint32_t ka_lane = tc::a_lane_addr<kLd>(Ks + group * 16 * kLd, lane);  // its 16 keys
  const uint32_t va_lane = tc::a_lane_addr<kLd>(Vs + group * 16 * kLd, lane);
  const uint32_t qb_lane = tc::b_lane_addr<kLd>(Qhi, Qlo, lane);
  const uint32_t ob_lane = tc::b_lane_addr<kLd>(Ohi, Olo, lane);
  float* team_xch = xch + group * kTeam * P::kXF;
  float dk_acc[kSteps][4] = {};  // this warp's part of the head dim
  float dv_acc[kSteps][4] = {};
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (N + kRows - 1) / kRows;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    tc::split_rows<kRows, D, kLd, kN>(rawQ, Qhi, Qlo);
    tc::split_rows<kRows, D, kLd, kN>(rawO, Ohi, Olo);
    __syncthreads();
    if (i + 1 < n_tiles) copy_tile((i + 1) * kRows);  // during the products
    // lse and di of this lane's queries (the columns 2t, 2t + 1 of each
    // n-tile of S^T); 0 past N, which makes a padded query add 0
    const int i0 = i * kRows;
    float L[kNt][2], Dv[kNt][2];
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = i0 + nt * 8 + 2 * t + c;
        L[nt][c] = qi < N ? lse_bh[qi] : 0.f;
        Dv[nt][c] = qi < N ? di_bh[qi] : 0.f;
      }
    // S^T (x[.][0]: 16 keys x kRows queries) and dP^T (x[.][1]) over this
    // warp's part of the head dim
    float x[kKs][2][kNt][4] = {};
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int kk = part * kSteps + j;
      const tc::SplitA ka = tc::split_a_ldm(ka_lane + 32 * kk);
      const tc::SplitA va = tc::split_a_ldm(va_lane + 32 * kk);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const uint32_t o = (nt * 8 * kLd + 8 * kk) * 4;
        uint32_t bq[4], bo[4];
        tc::ldmatrix_x4(bq, qb_lane + o);
        tc::mma_split(x[j % kKs][0][nt], ka, bq);
        tc::ldmatrix_x4(bo, ob_lane + o);
        tc::mma_split(x[j % kKs][1][nt], va, bo);
      }
    }
    if constexpr (kKs == 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[0][u][nt][e] += x[1][u][nt][e];
    }
    tc::team_sum<kTeam>(x[0], team_xch, part, group, lane);  // the whole S^T and dP^T
    // P^T and dS^T; the column (query) picks lse and di
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(x[0][0][nt][e], scale_log2, -L[nt][e & 1] * kLog2e));
        x[0][1][nt][e] = p * (x[0][1][nt][e] - Dv[nt][e & 1]) * scale;
        x[0][0][nt][e] = p;
      }
    // dV += P^T dO, dK += dS^T Q into this warp's columns, over the tile's
    // queries 8 at a time (queries 2t, 2t + 1 in B's rows t, t + 4)
#pragma unroll
    for (int kq = 0; kq < kNt; ++kq) {
      const tc::SplitA pa = tc::a_from_c_tf32(x[0][0][kq]);
      const tc::SplitA da = tc::a_from_c_tf32(x[0][1][kq]);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int o0 = (kq * 8 + 2 * t) * kLd + 8 * (part * kSteps + j) + g;
        uint32_t bo[4], bq[4];
        tc::load_b(bo, Ohi, Olo, o0, o0 + kLd);
        tc::mma_split(dv_acc[j], pa, bo);
        tc::load_b(bq, Qhi, Qlo, o0, o0 + kLd);
        tc::mma_split(dk_acc[j], da, bq);
      }
    }
  }
  const int col0 = part * kSteps * 8;  // this warp's first column
  const long long off = ((long long)b * M * H + h) * Dh + col0;
  const long long stride = (long long)H * Dh;
  tc::store_c_rows(dk_acc, dk + off, stride, key0 + group * 16, M, Dh - col0, lane);
  tc::store_c_rows(dv_acc, dv + off, stride, key0 + group * 16, M, Dh - col0, lane);
}

// dQ for the kOwn queries of tile `tile` of one (b, h), looping over every
// key tile. Shared memory: the own Q and dO rows, the raw tiles of K and V,
// the split tiles K hi, K lo, V hi, V lo, and each warp's parts of S and
// dP.
template <int D>
__device__ __forceinline__ void dq_block(int tile, int b, const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ di, float* __restrict__ dq,
                                         int N, int M, int H, int Dh, Strides qs, Strides ks,
                                         Strides vs, Strides dos, float scale) {
  using P = Plan<D>;
  constexpr int kLd = P::kLd, kRows = P::kRows, kNt = P::kNt, kKs = P::kKs, kN = P::kN;
  constexpr int kSteps = P::kSteps, kTeam = P::kTeam;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;
  float* Os = Qs + P::kOwnF;
  float* rawK = Os + P::kOwnF;
  float* rawV = rawK + P::kRawF;
  float* Khi = rawV + P::kRawF;
  float* Klo = Khi + P::kSplitF;
  float* Vhi = Klo + P::kSplitF;
  float* Vlo = Vhi + P::kSplitF;
  float* xch = Vlo + P::kSplitF;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp % P::kGroups;  // the 16 queries
  const int part = warp / P::kGroups;   // the part of the head dim
  const int h = blockIdx.y;
  const int q0 = tile * P::kOwn;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  auto copy_tile = [&](int j0) {
    tc::copy_rows_async<kRows, D, D, kN>(smem_u32(rawK), kb, ks.n, j0, M, Dh);
    tc::copy_rows_async<kRows, D, D, kN>(smem_u32(rawV), vb, vs.n, j0, M, Dh);
    cp_async_commit();
  };
  tc::copy_rows_async<P::kOwn, D, kLd, kN>(smem_u32(Qs), q + b * qs.b + h * qs.h, qs.n, q0, N,
                                           Dh);
  tc::copy_rows_async<P::kOwn, D, kLd, kN>(smem_u32(Os), dout + b * dos.b + h * dos.h, dos.n,
                                           q0, N, Dh);
  copy_tile(0);
  // this lane's rows g and g + 8: lse in log2 units and di
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* di_bh = di + ((long long)b * H + h) * N;
  float lse2[2], dii[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + group * 16 + g + 8 * r;
    lse2[r] = n < N ? lse_bh[n] * kLog2e : 0.f;
    dii[r] = n < N ? di_bh[n] : 0.f;
  }
  const uint32_t qa_lane = tc::a_lane_addr<kLd>(Qs + group * 16 * kLd, lane);  // its queries
  const uint32_t oa_lane = tc::a_lane_addr<kLd>(Os + group * 16 * kLd, lane);
  const uint32_t kb_lane = tc::b_lane_addr<kLd>(Khi, Klo, lane);
  const uint32_t vb_lane = tc::b_lane_addr<kLd>(Vhi, Vlo, lane);
  float* team_xch = xch + group * kTeam * P::kXF;
  float dq_acc[kSteps][4] = {};  // this warp's part of the head dim
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (M + kRows - 1) / kRows;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    tc::split_rows<kRows, D, kLd, kN>(rawK, Khi, Klo);
    tc::split_rows<kRows, D, kLd, kN>(rawV, Vhi, Vlo);
    __syncthreads();
    if (j + 1 < n_tiles) copy_tile((j + 1) * kRows);  // during the products
    // S (x[.][0]: 16 queries x kRows keys) and dP (x[.][1]) over this warp's
    // part of the head dim
    float x[kKs][2][kNt][4] = {};
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int kk = part * kSteps + u;
      const tc::SplitA qa = tc::split_a_ldm(qa_lane + 32 * kk);
      const tc::SplitA oa = tc::split_a_ldm(oa_lane + 32 * kk);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const uint32_t o = (nt * 8 * kLd + 8 * kk) * 4;
        uint32_t bk[4], bv[4];
        tc::ldmatrix_x4(bk, kb_lane + o);
        tc::mma_split(x[u % kKs][0][nt], qa, bk);
        tc::ldmatrix_x4(bv, vb_lane + o);
        tc::mma_split(x[u % kKs][1][nt], oa, bv);
      }
    }
    if constexpr (kKs == 2) {
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[0][w][nt][e] += x[1][w][nt][e];
    }
    tc::team_sum<kTeam>(x[0], team_xch, part, group, lane);  // the whole S and dP
    // dS; keys past M get P = 0
    const int k0 = j * kRows;
    const bool ragged = k0 + kRows > M;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const float p = (ragged && key >= M)
                            ? 0.f
                            : exp2f(fmaf(x[0][0][nt][e], scale_log2, -lse2[e >> 1]));
        x[0][0][nt][e] = p * (x[0][1][nt][e] - dii[e >> 1]) * scale;
      }
    // dQ += dS K into this warp's columns, over the tile's keys 8 at a time
    // (keys 2t, 2t + 1 in B's rows t, t + 4)
#pragma unroll
    for (int kq = 0; kq < kNt; ++kq) {
      const tc::SplitA da = tc::a_from_c_tf32(x[0][0][kq]);
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int o0 = (kq * 8 + 2 * t) * kLd + 8 * (part * kSteps + u) + g;
        uint32_t bk[4];
        tc::load_b(bk, Khi, Klo, o0, o0 + kLd);
        tc::mma_split(dq_acc[u], da, bk);
      }
    }
  }
  const int col0 = part * kSteps * 8;  // this warp's first column
  tc::store_c_rows(dq_acc, dq + ((long long)b * N * H + h) * Dh + col0, (long long)H * Dh,
                   q0 + group * 16, N, Dh - col0, lane);
}

// Both passes in one launch, the role in the grid's slowest dimension: z in
// [0, B) runs dK/dV for the keys of tile x, z in [B, 2B) dQ for the queries
// of tile x (tiles past the role's count exit). The passes share nothing but
// the inputs; blocks start in the order of their index, so every dK/dV
// block (the heavier, four products to three) starts before any dQ block,
// and at short lengths (fewer blocks than SMs, as at (2,673,4,D)) the dQ
// blocks fill the SMs that the dK/dV blocks leave idle.
template <int D>
__global__ void __launch_bounds__(Plan<D>::kN, 1)
flash_bwd_tf32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           float* __restrict__ dq, float* __restrict__ dk,
                           float* __restrict__ dv, int B, int N, int M, int H, int Dh,
                           Strides qs, Strides ks, Strides vs, Strides dos, float scale) {
  const int tile = blockIdx.x;
  const int role = blockIdx.z / B;  // 0: dK/dV, 1: dQ
  const int b = blockIdx.z % B;
  if (role == 0) {
    if (tile * Plan<D>::kOwn < M)
      dkv_block<D>(tile, b, q, k, v, dout, lse, di, dk, dv, N, M, H, Dh, qs, ks, vs, dos, scale);
  } else if (tile * Plan<D>::kOwn < N) {
    dq_block<D>(tile, b, q, k, v, dout, lse, di, dq, N, M, H, Dh, qs, ks, vs, dos, scale);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* di, float* dq, float* dk, float* dv, int B,
                   int N, int M, int H, int Dh, Strides qs, Strides ks, Strides vs, Strides dos,
                   float scale, cudaStream_t stream) {
  using P = Plan<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_tf32_wide_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((M > N ? M : N) + P::kOwn - 1) / P::kOwn, H, 2 * B);
  flash_bwd_tf32_wide_kernel<D><<<grid, P::kN, P::kSmem, stream>>>(
      q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, Dh, qs, ks, vs, dos, scale);
  return cudaGetLastError();
}

}  // namespace tf32_wide

// fp32 K2 at the widths 128 and 256, head dim D in 65..256 (gd3d_flash_bwd,
// flash_bwd.cu, sends them here); returns the launch error.
cudaError_t launch_bwd_tf32_wide(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* di, void* dq, void* dk, void* dv,
                                 int B, int N, int M, int H, int D, Strides qs, Strides ks,
                                 Strides vs, Strides dos, float scale, cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* di_ = static_cast<const float*>(di);
  float* dq_ = static_cast<float*>(dq);
  float* dk_ = static_cast<float*>(dk);
  float* dv_ = static_cast<float*>(dv);
  if (D <= 128)
    return tf32_wide::launch<128>(q_, k_, v_, do_, lse_, di_, dq_, dk_, dv_, B, N, M, H, D, qs,
                                  ks, vs, dos, scale, stream);
  return tf32_wide::launch<256>(q_, k_, v_, do_, lse_, di_, dq_, dk_, dv_, B, N, M, H, D, qs, ks,
                                vs, dos, scale, stream);
}

}  // namespace gd3d
