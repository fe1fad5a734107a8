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
// q/k/v/o traffic, so the kernel is bound by arithmetic. The routes, by
// dtype and kernel width:
//
// * bf16 at 64 (the student, DINOv2 and the VGGT aggregator, the bf16
//   teacher, and the --tiny CroCo-Stereo model's 16 and 8), 128 and 256 (no
//   model of the repo): flash_fwd_sm90.cu, on TMA, wgmma and warp
//   specialisation; gd3d_flash_fwd below sends every bf16 case there.
// * fp32, head dim 64 (the frozen CroCo teacher, which runs with TF32 off):
//   flash_fwd_f32_kernel, on the fp32 CUDA cores, which keeps fp32 exact.
//   Both products are register-tiled. One block of 128 threads takes 64
//   queries of one (b, h) and walks the keys in tiles of 32. The threads
//   form a 16 x 8 grid: a thread owns 4 query rows (16 apart) and, of S, the
//   4 keys tx, tx + 8, ... of the tile; of O, the 8 head dims of two
//   float4 columns. Q, K and V tiles lie row-major in shared memory with
//   rows of 68 floats, so the 8 key rows (or the 4 query rows) that a warp
//   reads at once start 4 banks apart: one 16-byte shared load feeds 16
//   FMAs of S (4 keys x 4 dims against a query row, or the reverse) and
//   10.7 on average (8 loads per 64 FMAs of S, 12 per 128 of O). The row
//   max is reduced over the 8 lanes that share a row with three shuffles,
//   in a fixed order; the row sum stays a per-thread partial until the end.
//   P goes to the second product through a per-warp region of shared memory
//   (the 8 lanes of a row are in one warp, so __syncwarp is enough). K and V
//   tiles stream through a two-stage ring of 16-byte cp.async copies, read
//   straight from the operands' strides and zero-filled past M; Q comes in
//   the same way once. Scores are kept in log2 units (scale * log2(e)
//   applied to S) and every exponential is one ex2.
//   The grid, reckoned for the CroCo encoder (B, N, H) = (2, 672, 16):
//   61 KB of dynamic shared memory and <= 168 registers give 3 blocks an SM,
//   396 slots on 132 SMs. 672 = 10.5 tiles of 64 queries, so 11 x 16 x 2 =
//   352 blocks are all resident at once (no second wave); an SM holds 2 or
//   3 of them, 2.67 on average, so the busiest SM carries 3 / 2.67 = 1.125
//   of the mean. Tiles of 32 queries would give 672 blocks, 5.09 an SM, the
//   busiest 6 / 5.09 = 1.18. The decoder (H = 12) gives 264 blocks, 2 an SM.
//   Tiles of 64 keys (8 x 4 of S and of O per thread, 102 KB, 2 blocks an
//   SM) were tried: no faster at the decoder, and slower at the encoder,
//   whose 352 blocks then need a second wave.
// * fp32 at 128 (the VGGT camera trunk, N = 2 frames) and 256 (no path of
//   the repo): flash_fwd_tf32_kernel, on the tensor cores at fp32
//   accuracy, as the fp32 K2 (mma.cuh): every operand split into TF32 hi
//   and lo parts, every product three mma.sync m16n8k8, whatever
//   torch.backends.cuda.matmul.allow_tf32 says. A block takes 16 queries a
//   group of warps and walks the keys in tiles of 32. S = Q K^T leaves P
//   in accumulator fragments, which pass to O += P V as A fragments (C
//   column 2t as A column t, 2t + 1 as t + 4, a_from_c_tf32;
//   V's B rows t and t + 4 then hold keys 2t and 2t + 1). A lane owns its
//   scores, so every exponential is computed once in a warp (one ex2 in
//   log2 units); the row max takes two shuffles over the row's 4 lanes, and
//   the row sum stays a per-lane partial until the end. K and V tiles come
//   in by 16-byte cp.async, zero-filled past M, into raw tiles during the
//   products on the tile before, and are split once a block into hi and lo
//   tiles with rows of D + 4 floats (no bank conflicts), whose S-type B
//   fragments come by ldmatrix. Q stays in registers (fp32, split at use).
//   The budget: a warp's O takes D / 2 floats a thread (16 rows of D) and
//   its Q as many, 256 at D = 256. So at 256 a team of 4 warps owns the 16
//   queries and splits the head dim (FwdPlan, mma.cuh's warp teams): each
//   runs S over its 64 columns, the team sums the parts (same bits in every
//   warp), all four run the same softmax, and each runs O += P V into its
//   64 columns. The kernel is bound by the latency of each warp's chains of
//   mma.sync more than by the tensor cores, so what counts is the warps an
//   SM holds.
//   - D = 128: 4 warps, one a group (64 queries), 100352 bytes of shared
//     memory, 2 blocks an SM, 234 registers, no spills.
//   - D = 256: 3 groups of 4 warps (48 queries, 384 threads), 229376
//     bytes, 1 block of 12 warps an SM, 161 registers, no spills.
//   The grid, reckoned at the widths' cases: 11 x 8 = 88 blocks at
//   (2,673,4,128), 15 x 8 = 120 at (2,673,4,256), one wave; 66 x 12 = 792
//   at (2,4161,6,128), three waves of 264; 87 x 6 = 522 at (2,4161,3,256),
//   four waves of 132 (the last nearly full); 16 at the camera trunk's
//   (1,2,16,128), a 2-key tile each.
//
// * above 256: flash_fwd_cluster_sm90.cu (bf16 up to 768, TMA and wgmma)
//   and flash_fwd_cluster_tf32.cu (fp32 up to 2048, split TF32 on
//   mma.sync), each CTA close to the width-256 plan above, a thread-block
//   cluster of ceil(D / 256) CTAs splitting the head dim and summing its
//   parts of S in distributed shared memory (flash_fwd_cluster.cuh); past
//   those, flash_chunked.cu (CUDA cores, column chunks).
//
// Layout: q, k, v are (B, N, H, D) views read through their strides; o is a
// (B, N, H, D) tensor written through its strides and lse a contiguous
// (B, H, N) fp32 tensor. Up to 256 each kernel runs at a width of 64, 128 or
// 256, the least that holds D (above, the cluster kernels take 192 or 256
// columns a CTA). A head dim below its width whose rows are 16-byte
// multiples (fp32 D a multiple of 4, bf16 a multiple of 8) runs on the
// caller's own rows: the copies fill the columns past D with zeros (cp.async
// with no source bytes, TMA past the map's D), which add nothing to Q K^T
// and leave P V's columns past D at 0, and the stores write D columns. The
// wrapper zero-pads any other head dim to the width (kernels/flash_fwd.py:
// runs_direct, fwd_padded). Every kernel copies 16 bytes at a time
// (TMA, cp.async): the views' addresses and (B, N, H) steps must fall on
// 16 bytes (the wrapper copies a view that does not). Ragged sequence
// lengths (2, 672, 673, 1374, 4161, ...) are masked inside the kernels:
// keys past M score -inf (their rows are copied as zeros), queries past N
// are computed but not stored. The fp32 kernels' grid: (ceil(N / queries a
// block), H, B).
#include "common.cuh"
#include "flash_chunked.cuh"
#include "flash_fwd_cluster.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace gd3d {

// fp32, head dim 64, register-tiled on the CUDA cores (see the note at the
// top). Shared memory, in floats: Q (kBQ x kLd), K stages 0 and 1, V stages 0
// and 1 (kBK x kLd each), P (kBQ x kLdP).
namespace f32 {
constexpr int kBQ = 64;               // queries per block
constexpr int kBK = 32;               // keys per tile
constexpr int kLd = kD + 4;           // floats per Q, K, V row in shared memory
constexpr int kLdP = kBK + 8;         // floats per P row
constexpr int kTX = kBK / 4;          // threads across a tile's keys
constexpr int kTY = kThreads / kTX;   // thread rows
constexpr int kRQ = kBQ / kTY;        // query rows per thread
constexpr int kDC = kD / (4 * kTX);   // float4 columns of O per thread
constexpr int kSmemBytes = (kBQ * kLd + 4 * kBK * kLd + kBQ * kLdP) * 4;

// Rows [row0, row0 + kRows) of a (rows, D) fp32 slice with row stride
// `stride` (elements), D <= 64 a multiple of 4, into a tile of kLd-float
// rows; rows at or past n_rows and columns at or past D are zeros.
template <int kRows>
__device__ __forceinline__ void load_rows_async(uint32_t dst, const float* __restrict__ src,
                                                long long stride, int row0, int n_rows, int D) {
#pragma unroll
  for (int i = 0; i < kRows * (kD / 4) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 4;
    const int col = (c & 15) * 4;
    const bool ok = row0 + r < n_rows && col < D;
    const float* g = ok ? src + (long long)(row0 + r) * stride + col : src;
    cp_async16(dst + (r * kLd + col) * 4, g, ok);
  }
}
}  // namespace f32

__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int N, int M, int H, int D, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale_log2) {
  using namespace f32;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;
  float* Ks = Qs + kBQ * kLd;
  float* Vs = Ks + 2 * kBK * kLd;
  float* Ps = Vs + 2 * kBK * kLd;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const uint32_t sK = smem_u32(Ks);
  const uint32_t sV = smem_u32(Vs);

  load_rows_async<kBQ>(smem_u32(Qs), q + b * qs.b + h * qs.h, qs.n, q0, N, D);
  load_rows_async<kBK>(sK, kb, ks.n, 0, M, D);
  load_rows_async<kBK>(sV, vb, vs.n, 0, M, D);
  cp_async_commit();

  // thread rows: ty + kTY * i; S keys: tx + kTX * j; O dims: 4 * (tx + kTX * c)
  float acc[kRQ][4 * kDC] = {};
  float m[kRQ], l[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    m[i] = -INFINITY;  // in log2 units
    l[i] = 0.f;        // this thread's part of the row sum
  }
  const float4* Q4 = reinterpret_cast<const float4*>(Qs) + ty * (kLd / 4);
  float* Pw = Ps + ty * kLdP + tx;
  const float4* P4 = reinterpret_cast<const float4*>(Ps) + ty * (kLdP / 4);

  const int n_tiles = (M + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_rows_async<kBK>(sK + (st ^ 1) * kBK * kLd * 4, kb, ks.n, (t + 1) * kBK, M, D);
      load_rows_async<kBK>(sV + (st ^ 1) * kBK * kLd * 4, vb, vs.n, (t + 1) * kBK, M, D);
    }
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const float4* K4 = reinterpret_cast<const float4*>(Ks + st * kBK * kLd) + tx * (kLd / 4);
    const float4* V4 = reinterpret_cast<const float4*>(Vs + st * kBK * kLd) + tx;

    float s[kRQ][4] = {};
#pragma unroll
    for (int d4 = 0; d4 < kD / 4; ++d4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = K4[j * kTX * (kLd / 4) + d4];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        const float4 qv = Q4[i * kTY * (kLd / 4) + d4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    const int k0 = t * kBK;
    const bool ragged = k0 + kBK > M;
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      // every tile holds a real key, so the new max is finite
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool past = ragged && k0 + tx + kTX * j >= M;
        s[i][j] = past ? -INFINITY : s[i][j] * scale_log2;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < kTX; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float corr = fast_exp2(m[i] - mx);
      m[i] = mx;
      l[i] *= corr;
#pragma unroll
      for (int d = 0; d < 4 * kDC; ++d) acc[i][d] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = fast_exp2(s[i][j] - mx);
        l[i] += p;
        Pw[i * kTY * kLdP + j * kTX] = p;
      }
    }
    __syncwarp();  // a row's 8 lanes are in one warp

#pragma unroll
    for (int k4 = 0; k4 < kBK / 4; ++k4) {
      float4 pv[kRQ];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) pv[i] = P4[i * kTY * (kLdP / 4) + k4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          const float4 vv = V4[(k4 * 4 + kk) * (kLd / 4) + c * kTX];
#pragma unroll
          for (int i = 0; i < kRQ; ++i) {
            const float p = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y : kk == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * c + 0] = fmaf(p, vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(p, vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage, and P
  }

  float* ob = o + b * os.b + h * os.h;
  float* lse_bh = lse + ((long long)b * H + h) * N;
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
#pragma unroll
    for (int w = 1; w < kTX; w <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
    const int n = q0 + ty + kTY * i;
    if (n >= N) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = 4 * (tx + kTX * c);
      if (col < D)
        *reinterpret_cast<float4*>(ob + n * os.n + col) =
            make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv, acc[i][4 * c + 2] * inv,
                        acc[i][4 * c + 3] * inv);
    }
    if (tx == 0) lse_bh[n] = (m[i] + log2f(l[i])) * kLn2;
  }
}

cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                           int B, int N, int M, int H, int D, Strides qs, Strides ks,
                           Strides vs, Strides os, float scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f32::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + f32::kBQ - 1) / f32::kBQ, H, B);
  flash_fwd_f32_kernel<<<grid, kThreads, f32::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), N, M, H, D, qs, ks, vs, os,
      scale * kLog2e);
  return cudaGetLastError();
}

// fp32 at head dims 128 and 256 on split TF32 (see the note at the top).
// Shared memory, in floats: the raw K and V tiles that cp.async fills, the
// split tiles the products read (K hi, K lo, V hi, V lo), and (teams of
// more than one warp) each warp's part of S.
namespace tf32_wide {
template <int D>
struct FwdPlan {
  static_assert(D == 128 || D == 256, "kernel widths 128 and 256");
  static constexpr int kLd = D + 4;                 // floats a row the products read
  static constexpr int kGroups = D == 128 ? 4 : 3;  // 16-query groups a block
  static constexpr int kTeam = D == 128 ? 1 : 4;    // warps a group, splitting D
  static constexpr int kN = 32 * kTeam * kGroups;   // threads a block
  static constexpr int kRows = 16 * kGroups;        // queries a block
  static constexpr int kKeys = 32;  // keys a tile
  static constexpr int kNt = kKeys / 8;             // n-tiles of S
  static constexpr int kKs = kNt < 4 ? 2 : 1;       // partial sums of S over k-steps
  static constexpr int kSteps = D / 8 / kTeam;      // k-steps (n-tiles of O) a warp
  static constexpr int kXF = kTeam > 1 ? tc::team_part_floats<kNt * 4>() : 0;  // a warp's S
  static constexpr int kRawF = kKeys * D;
  static constexpr int kSplitF = kKeys * kLd;
  static constexpr int kSmem = (2 * kRawF + 4 * kSplitF + kTeam * kGroups * kXF) * 4;
  static constexpr int kBlocks = D == 128 ? 2 : 1;  // blocks an SM
  static_assert(kBlocks * (kSmem + 1024) <= 233472, "shared memory an SM");
};
}  // namespace tf32_wide

template <int D>
__global__ void __launch_bounds__(tf32_wide::FwdPlan<D>::kN, tf32_wide::FwdPlan<D>::kBlocks)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int N, int M, int H, int Dh, Strides qs,
                      Strides ks, Strides vs, Strides os, float scale_log2) {
  using P = tf32_wide::FwdPlan<D>;
  constexpr int kLd = P::kLd, kKeys = P::kKeys, kNt = P::kNt, kKs = P::kKs, kN = P::kN;
  constexpr int kSteps = P::kSteps, kTeam = P::kTeam;
  extern __shared__ __align__(16) float smem_f[];
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
  const int part = warp / P::kGroups;   // the part of the head dim
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * P::kRows;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  auto copy_tile = [&](int j0) {
    tc::copy_rows_async<kKeys, D, D, kN>(smem_u32(rawK), kb, ks.n, j0, M, Dh);
    tc::copy_rows_async<kKeys, D, D, kN>(smem_u32(rawV), vb, vs.n, j0, M, Dh);
    cp_async_commit();
  };
  copy_tile(0);
  // the group's 16 queries over this warp's part of the head dim: A
  // fragments in fp32, split at use
  const int col0 = part * kSteps * 8;  // this warp's first column
  float qf[kSteps][4];
  tc::load_a_rows(qf, q + b * qs.b + h * qs.h + col0, qs.n, q0 + group * 16, N, Dh - col0,
                  lane);
  float* team_xch = xch + group * kTeam * P::kXF;
  const uint32_t kb_lane = tc::b_lane_addr<kLd>(Khi, Klo, lane);

  float acc[kSteps][4] = {};  // O, rows g and g + 8, this warp's columns
  float m[2] = {-INFINITY, -INFINITY};  // row maxima in log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  const int n_tiles = (M + kKeys - 1) / kKeys;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    tc::split_rows<kKeys, D, kLd, kN>(rawK, Khi, Klo);
    tc::split_rows<kKeys, D, kLd, kN>(rawV, Vhi, Vlo);
    __syncthreads();
    if (j + 1 < n_tiles) copy_tile((j + 1) * kKeys);  // during the products

    float s[kKs][1][kNt][4] = {};  // S: 16 queries x kKeys keys, this warp's part
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const tc::SplitA qa = tc::split_a(qf[u][0], qf[u][1], qf[u][2], qf[u][3]);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, kb_lane + (nt * 8 * kLd + 8 * (part * kSteps + u)) * 4);
        tc::mma_split(s[u % kKs][0][nt], qa, bk);
      }
    }
    if constexpr (kKs == 2) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][0][nt][e] += s[1][0][nt][e];
    }
    tc::team_sum<kTeam>(s[0], team_xch, part, group, lane);  // the whole S, in every warp
    float (&sc)[kNt][4] = s[0][0];
    // online softmax over the tile in log2 units, the same in every warp;
    // keys past M score -inf (every tile holds a real key, so the new
    // maxima are finite)
    const int k0 = j * kKeys;
    const bool ragged = k0 + kKeys > M;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool past = ragged && k0 + nt * 8 + 2 * t + (e & 1) >= M;
        sc[nt][e] = past ? -INFINITY : sc[nt][e] * scale_log2;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
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
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // one exponential a score
        const float p = fast_exp2(sc[nt][e] - m[e >> 1]);
        l[e >> 1] += p;
        sc[nt][e] = p;
      }
    // O += P V into this warp's columns, over the tile's keys 8 at a time
    // (keys 2t, 2t + 1 in B's rows t, t + 4, head dims g of each 8)
#pragma unroll
    for (int kq = 0; kq < kNt; ++kq) {
      const tc::SplitA pa = tc::a_from_c_tf32(sc[kq]);
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
    if (t == 0 && part == 0) lse_bh[n] = (m[r] + log2f(l[r])) * kLn2;
  }
}

template <int D>
cudaError_t launch_fwd_tf32(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int N, int M, int H, int Dh, Strides qs, Strides ks,
                            Strides vs, Strides os, float scale, cudaStream_t stream) {
  using P = tf32_wide::FwdPlan<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + P::kRows - 1) / P::kRows, H, B);
  flash_fwd_tf32_kernel<D><<<grid, P::kN, P::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), N, M, H, Dh, qs, ks, vs, os,
      scale * kLog2e);
  return cudaGetLastError();
}

// The K1 kernels, as gd3d_flash_fwd_route names them (flash_fwd.py's
// FWD_ROUTES, in this order)
enum FwdRoute : int { kFwdF32, kFwdTf32, kFwdSm90, kFwdCluster, kFwdChunked };

}  // namespace gd3d

// The K1 kernel that gd3d_flash_fwd launches for head dim D. Above 256
// gd3d_flash_fwd dispatches on it (and flash_fwd.py counts those launches
// by it): up to cluster::kMaxDBf16 (768, bf16) or cluster::kMaxD (2048,
// fp32) clusters that split D (flash_fwd_cluster_{sm90,tf32}.cu), wider
// column chunks (flash_chunked.cu). Up to 256 it names what the dispatch's
// tests pick: bf16 flash_fwd_sm90.cu, fp32 at width 64 the CUDA cores
// (flash_fwd_f32_kernel), at 128 and 256 split TF32
// (flash_fwd_tf32_kernel). -1 for a head dim the kernels refuse.
extern "C" int gd3d_flash_fwd_route(int D, int is_bf16) {
  using namespace gd3d;
  if (D <= 0 || D % (is_bf16 ? 8 : 4) != 0) return -1;
  if (D > chunked::kChunk)
    return D <= (is_bf16 ? cluster::kMaxDBf16 : cluster::kMaxD) ? kFwdCluster : kFwdChunked;
  if (is_bf16) return kFwdSm90;
  return D <= kD ? kFwdF32 : kFwdTf32;
}

extern "C" int gd3d_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int N, int M, int H, int D,
                              long long qsb, long long qsn, long long qsh,
                              long long ksb, long long ksn, long long ksh,
                              long long vsb, long long vsn, long long vsh,
                              long long osb, long long osn, long long osh, float scale,
                              int is_bf16, void* stream) {
  using namespace gd3d;
  // any head dim whose rows are 16-byte multiples, on the kernel that
  // gd3d_flash_fwd_route names: up to 256 at the least kernel width that
  // holds it, above on the clusters or, past their reach, in column chunks
  if (D <= 0 || D % (is_bf16 ? 8 : 4) != 0 || N <= 0 || M <= 0 || B <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsn, qsh}, ks{ksb, ksn, ksh}, vs{vsb, vsn, vsh}, os{osb, osn, osh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int route = gd3d_flash_fwd_route(D, is_bf16);
  if (route == kFwdCluster) {
    // S once a key tile, its parts summed across the cluster
    if (is_bf16)  // above 256: wgmma on TMA tiles
      return static_cast<int>(cluster::launch_fwd_cluster_bf16(q, k, v, o, lse, B, N, M, H, D,
                                                               qs, ks, vs, os, scale, st));
    // fp32 above 256: split TF32 on mma.sync
    return static_cast<int>(cluster::launch_fwd_cluster_tf32(q, k, v, o, lse, B, N, M, H, D,
                                                             qs, ks, vs, os, scale, st));
  }
  if (route == kFwdChunked)  // past the clusters' reach: column chunks on the CUDA cores
    return static_cast<int>(
        chunked::launch_fwd(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, os, scale, is_bf16, st));
  if (is_bf16)  // head dims 64, 128 and 256
    return static_cast<int>(
        sm90::launch_fwd_bf16(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, os, scale, st));
  cudaError_t err;
  if (D <= kD)  // fp32 at width 64: the CUDA cores
    err = launch_fwd_f32(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, os, scale, st);
  else if (D <= 128)  // fp32 at widths 128 and 256: split TF32 on mma.sync
    err = launch_fwd_tf32<128>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, os, scale, st);
  else
    err = launch_fwd_tf32<256>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, os, scale, st);
  return static_cast<int>(err);
}
