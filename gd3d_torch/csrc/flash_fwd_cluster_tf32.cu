// K1 in fp32 above head dim 256 (256 < D <= 2048): the flash-attention
// forward with the row log-sum-exp at fp32 accuracy on the tensor cores
// (every product three TF32 mma.sync on split operands, mma.cuh, whatever
// torch.backends.cuda.matmul.allow_tf32 says), on thread-block clusters
// that split the head dim (flash_fwd_cluster.cuh). gd3d_flash_fwd
// (flash_fwd.cu) sends fp32 at these head dims here; past 2048 they run on
// flash_chunked.cu.
//
// Replaces, as the rest of K1 does, the stock TPU Pallas flash forward that
// gd3d calls through gd3d/ops/attention.py::_flash_call, which takes any
// head dim. No model of the repo goes past 128, so no path launches it.
//
// What bounds it on an H100: arithmetic, three TF32 products for each fp32
// one (495 / 3 TFLOP/s): at (2, 673, 2, 512) 3.7 GFLOP, 0.0225 ms. Like
// flash_fwd.cu's flash_fwd_tf32_kernel, whose width-256 plan each CTA
// follows, it is bound more by the latency of each warp's chains of
// mma.sync than by the tensor cores, so what counts is the warps an SM
// holds: 12.
//
// The design. A cluster of G = ceil(D / 256) CTAs (split: 192 or 256
// columns a CTA) takes 48 query rows of one (b, h): three groups of 16 rows,
// each a team of 4 warps that split the CTA's columns (48 or 64 each). K
// and V tiles of 32 keys come by 16-byte cp.async into raw tiles during the
// products on the tile before and are split once a CTA into TF32 hi and lo
// tiles (rows of cols + 4 floats); Q stays in registers. A warp forms S over
// its columns; the team sums its 4 parts in shared memory (mma.cuh,
// team_sum: ((p0 + p1) + (p2 + p3)), the same bits in each warp), which is
// the CTA's part. Then the team spans the cluster: warp 0 of each team
// leaves the CTA's part in its own part slot of team_sum's area (no new
// buffer: the width-256 plan fills 229376 bytes of shared memory) and
// arrives on the team's full barrier in every CTA (G arrivals a phase); the
// team's warps wait on theirs, read the G parts in rank order (ld.shared::
// cluster, their own CTA's locally) and sum them, and arrive on the team's
// empty barrier in every peer (4 (G - 1) arrivals, without a cluster-scope
// release: the values are already in registers), which warp 0 waits on
// before team_sum writes that slot again on the next tile. Every warp of
// the team in every CTA then holds the same bits of S and runs the same
// online softmax; each runs O += P V into its own columns; rank 0 writes
// the LSE. At (2, 673, 2, 512) the grid is 15 x 2 clusters x 2 x 2 = 120
// CTAs, one wave; 168 registers, no spills.
//
// Measured (python3 -m gd3d_torch.kernels.sweep k1wide on NVIDIA H100 80GB
// HBM3, 700.00 W; ms at (2, 673, 2, 512) / (1, 4161, 3, 512)): 0.2045 /
// 4.755 (SDPA 0.2058 / 2.515; the same kernel with no exchange, wrong sums,
// timing only: 0.1289 / 2.81). A team's exchange is exposed on every
// 32-key tile: the width-256 plan syncs its 12 warps each tile (the split
// tiles), so nothing runs under it, and its publishing arrival needs a
// cluster-scope release (plain stores, pulled); the bf16 kernel's push by
// st.async needs an inbox, for which these 229376 bytes leave no room.
//
// Layout: q, k, v are (B, N|M, H, D) fp32 views, D a multiple of 4 (the
// wrapper zero-pads any other D), read through their strides (addresses
// and (B, N, H) steps on 16 bytes: the wrapper copies a view that is not);
// the copies fill rows past M and columns past D with zeros, keys past M
// score -inf, rows past N are not stored. No atomics: two runs give the
// same bits.
#include "flash_fwd_cluster.cuh"
#include "mma.cuh"

namespace gd3d {
namespace cluster {

template <int kDc>
struct Tf32Plan {
  static_assert(kDc == 192 || kDc == 256, "192 or 256 columns a CTA");
  static constexpr int kLd = kDc + 4;        // floats a row the products read
  static constexpr int kGroups = 3;          // 16-query groups a CTA
  static constexpr int kTeam = 4;            // warps a group, splitting the columns
  static constexpr int kN = 32 * kTeam * kGroups;  // threads a CTA
  static constexpr int kRows = 16 * kGroups;       // queries a CTA
  static constexpr int kKeys = 32;                 // keys a tile
  static constexpr int kNt = kKeys / 8;            // n-tiles of S
  static constexpr int kSteps = kDc / 8 / kTeam;   // k-steps (n-tiles of O) a warp
  static constexpr int kXF = tc::team_part_floats<kNt * 4>();  // a warp's part of S
  static constexpr int kRawF = kKeys * kDc;
  static constexpr int kSplitF = kKeys * kLd;
  static constexpr int kSmem = (2 * kRawF + 4 * kSplitF + kTeam * kGroups * kXF) * 4;
  static_assert(kSmem + 1024 <= 233472, "shared memory an SM");
};

template <int kDc>
__global__ void __launch_bounds__(Tf32Plan<kDc>::kN, 1)
flash_fwd_cluster_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ o,
                              float* __restrict__ lse, int N, int M, int H, int Dh, Strides qs,
                              Strides ks, Strides vs, Strides os, float scale_log2) {
  using P = Tf32Plan<kDc>;
  constexpr int kLd = P::kLd, kKeys = P::kKeys, kNt = P::kNt, kN = P::kN;
  constexpr int kSteps = P::kSteps, kTeam = P::kTeam;
  extern __shared__ __align__(16) float smem_f[];
  // each team's exchange: full, then empty
  __shared__ __align__(8) uint64_t xbars[2 * P::kGroups];
  float* rawK = smem_f;
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
  const int part = warp / P::kGroups;   // the part of the CTA's columns
  const int ctas = size();
  const int me = rank();
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x / ctas * P::kRows;
  const int cta0 = me * kDc;                    // this CTA's first column
  const int col0 = cta0 + part * kSteps * 8;    // this warp's first column
  const uint32_t full = smem_u32(xbars) + 8 * group;
  const uint32_t empty = full + 8 * P::kGroups;
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::kGroups; ++i) {
      bar_init(smem_u32(xbars) + 8 * i, ctas);
      bar_init(smem_u32(xbars) + 8 * (P::kGroups + i), kTeam * (ctas - 1));
    }
    fence_bar_init();
  }
  cluster::sync();  // every CTA's barriers are set before a peer arrives on them

  const float* kb = k + b * ks.b + h * ks.h + cta0;
  const float* vb = v + b * vs.b + h * vs.h + cta0;
  auto copy_tile = [&](int j0) {
    tc::copy_rows_async<kKeys, kDc, kDc, kN>(smem_u32(rawK), kb, ks.n, j0, M, Dh - cta0);
    tc::copy_rows_async<kKeys, kDc, kDc, kN>(smem_u32(rawV), vb, vs.n, j0, M, Dh - cta0);
    cp_async_commit();
  };
  copy_tile(0);
  // the group's 16 queries over this warp's columns: A fragments in fp32,
  // split at use
  float qf[kSteps][4];
  tc::load_a_rows(qf, q + b * qs.b + h * qs.h + col0, qs.n, q0 + group * 16, N, Dh - col0,
                  lane);
  float* team_xch = xch + group * kTeam * P::kXF;
  // this lane's float4s of the CTA's part of S: warp 0's slot of team_sum
  const uint32_t part_addr = smem_u32(team_xch) + lane * (kNt * 4 + 4) * 4;
  const uint32_t kb_lane = tc::b_lane_addr<kLd>(Khi, Klo, lane);

  float acc[kSteps][4] = {};  // O, rows g and g + 8, this warp's columns
  float m[2] = {-INFINITY, -INFINITY};  // row maxima in log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  const int n_tiles = (M + kKeys - 1) / kKeys;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    tc::split_rows<kKeys, kDc, kLd, kN>(rawK, Khi, Klo);
    tc::split_rows<kKeys, kDc, kLd, kN>(rawV, Vhi, Vlo);
    __syncthreads();
    if (j + 1 < n_tiles) copy_tile((j + 1) * kKeys);  // during the products

    float s[1][kNt][4] = {};  // S: 16 queries x kKeys keys, this warp's part
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const tc::SplitA qa = tc::split_a(qf[u][0], qf[u][1], qf[u][2], qf[u][3]);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, kb_lane + (nt * 8 * kLd + 8 * (part * kSteps + u)) * 4);
        tc::mma_split(s[0][nt], qa, bk);
      }
    }
    // warp 0's slot holds the CTA's part of tile j - 1 until every peer
    // has read it
    if (part == 0) wait_cta(empty, (j & 1) ^ 1);
    tc::team_sum<kTeam>(s, team_xch, part, group, lane);  // the CTA's part, in every warp
    tc::team_sync<kTeam>(group);  // every warp of the team has read the parts
    if (part == 0) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
        st4(part_addr + 16 * nt, s[0][nt][0], s[0][nt][1], s[0][nt][2], s[0][nt][3]);
      __syncwarp();
      if (lane == 0)
        for (int c = 0; c < ctas; ++c) arrive(full, c);
    }
    cluster::wait(full, j & 1);
    float sc[kNt * 4];  // S over the whole head dim, the same bits in every CTA
    sum_ranks<kNt>(sc, part_addr, 16, ctas, me);
    __syncwarp();
    if (lane == 0)
      for (int c = 0; c < ctas; ++c)
        if (c != me) arrive_read(empty, c);
    // online softmax over the tile in log2 units, the same in every warp;
    // keys past M score -inf (every tile holds a real key, so the new
    // maxima are finite). Score e of n-tile nt is sc[4 nt + e].
    const int k0 = j * kKeys;
    const bool ragged = k0 + kKeys > M;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool past = ragged && k0 + nt * 8 + 2 * t + (e & 1) >= M;
        float& x = sc[4 * nt + e];
        x = past ? -INFINITY : x * scale_log2;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // over the row's 4 lanes
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        acc[u][2 * r] *= corr;
        acc[u][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int i = 0; i < kNt * 4; ++i) {  // one exponential a score
      const float p = fast_exp2(sc[i] - m[(i & 3) >> 1]);
      l[(i & 3) >> 1] += p;
      sc[i] = p;
    }
    // O += P V into this warp's columns, over the tile's keys 8 at a time
    // (keys 2t, 2t + 1 in B's rows t, t + 4, head dims g of each 8)
#pragma unroll
    for (int kq = 0; kq < kNt; ++kq) {
      const tc::SplitA pa =
          tc::split_a(sc[4 * kq], sc[4 * kq + 2], sc[4 * kq + 1], sc[4 * kq + 3]);
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int o0 = (kq * 8 + 2 * t) * kLd + 8 * (part * kSteps + u) + g;
        uint32_t bv[4];
        tc::load_b(bv, Vhi, Vlo, o0, o0 + kLd);
        tc::mma_split(acc[u], pa, bv);
      }
    }
  }

  float* ob = o + b * os.b + h * os.h + col0;
  float* lse_bh = lse + ((long long)b * H + h) * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int n = q0 + group * 16 + g + 8 * r;
    if (n >= N) continue;
    const float inv = 1.f / l[r];
    float* row = ob + n * os.n + 2 * t;
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
      if (8 * u + 2 * t < Dh - col0)
        *reinterpret_cast<float2*>(row + 8 * u) =
            make_float2(acc[u][2 * r] * inv, acc[u][2 * r + 1] * inv);
    if (t == 0 && part == 0 && me == 0) lse_bh[n] = (m[r] + log2f(l[r])) * kLn2;
  }
  cluster::sync();  // no CTA leaves while a peer may still read its parts of S
}

template <int kDc>
static cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int N, int M, int H, int D, Strides qs, Strides ks,
                               Strides vs, Strides os, float scale, int ctas,
                               cudaStream_t stream) {
  using P = Tf32Plan<kDc>;
  const dim3 grid((N + P::kRows - 1) / P::kRows * ctas, H, B);
  Launch launch(grid, P::kN, P::kSmem, ctas, stream);
  return launch(flash_fwd_cluster_tf32_kernel<kDc>, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(o), static_cast<float*>(lse), N, M, H, D, qs, ks, vs, os,
                scale * kLog2e);
}

cudaError_t launch_fwd_cluster_tf32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int N, int M, int H, int D, Strides qs,
                                    Strides ks, Strides vs, Strides os, float scale,
                                    cudaStream_t stream) {
  if (D <= 256 || D > kMaxD || D % 4 != 0) return cudaErrorInvalidValue;
  const Split sp = split(D);
  if (sp.cols == 192)
    return launch_tf32<192>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, os, scale, sp.ctas,
                            stream);
  return launch_tf32<256>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, os, scale, sp.ctas,
                          stream);
}

}  // namespace cluster
}  // namespace gd3d
