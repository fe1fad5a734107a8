// Tensor-core building blocks of the fp32 flash kernels on split TF32, as
// inline PTX for sm_90a: mma.sync m16n8k8 on TF32 operands split into two
// parts, and the copies, splits and fragment loads of fp32 tiles of D
// columns that the kernels share: K2 at head dim 64 (flash_bwd.cu), K1 at
// 128 and 256 (flash_fwd.cu) and K2 at 128 and 256 (flash_bwd_tf32_wide.cu).
// (The bf16 flash kernels run on wgmma: sm90.cuh.)
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace gd3d {
namespace tc {

// Entries [i0, i0 + 64) of a fp32 vector (the log-sum-exp or di row of one
// (b, h)); entries at or past n become zeros. Threads 0..63 copy one each.
__device__ __forceinline__ void load_vec_async(uint32_t dst, const float* __restrict__ src,
                                               int i0, int n, int tid) {
  const bool ok = i0 + tid < n;
  cp_async4(dst + tid * 4, ok ? src + i0 + tid : src, ok);
}

// ---------------------------------------------------------------- TF32
// An fp32 product at fp32 accuracy on the tensor cores: x = hi + lo with
// hi = x rounded to TF32 (10 mantissa bits) and lo = (x - hi) rounded to
// TF32, so x - hi - lo is below 2^-22 |x|. Then a b = a_lo b_hi + a_hi b_lo
// + a_hi b_hi + a_lo b_lo, and the last term (below 2^-22 |a b|) is dropped:
// three mma.sync per product, the small terms first, summed in the fp32
// accumulator. GD3D_TF32_PASSES=1 keeps a_hi b_hi alone (single-pass TF32,
// about three decimal digits): a switch for measuring what the split buys,
// never the shipped build.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), lane = 4 g + t:
//   A (16x8, row-major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                         a3 = A[g+8][t+4]
//   B (8x8, "col"):       b0 = B[t][g], b1 = B[t+4][g]
//   C (16x8, fp32):       c0, c1 = C[g][2t, 2t+1],
//                         c2, c3 = C[g+8][2t, 2t+1]
// A C tile holds columns 2t and 2t+1 where an A fragment wants t and t+4.
// a_from_c_tf32 reads C column 2t as A column t and 2t+1 as t+4, which
// permutes the reduction index of the next product; its B operand must
// then hold, in its rows t and t+4, the rows 2t and 2t+1 of its source.
// The splits of A fragments (split_a) are volatile so that they stay where
// they are used: hoisted out of the loops, the two parts of a
// register-resident operand would take twice its registers.
#ifndef GD3D_TF32_PASSES
#define GD3D_TF32_PASSES 3
#endif
static_assert(GD3D_TF32_PASSES == 1 || GD3D_TF32_PASSES == 3, "1 or 3 TF32 passes");

// x rounded to TF32 (to nearest, ties away), in an fp32 bit pattern.
__device__ __forceinline__ float round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// A fragment (4 values) split into its TF32 parts.
struct SplitA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2, float a3) {
  SplitA s;
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s.hi[i]) : "f"(a[i]));
    asm volatile("cvt.rna.tf32.f32 %0, %1;\n"
                 : "=r"(s.lo[i])
                 : "f"(a[i] - __uint_as_float(s.hi[i])));
  }
  return s;
}

// The A fragment over the 8 columns of a C n-tile (C column 2t as A column
// t, 2t+1 as t+4; see above), split.
__device__ __forceinline__ SplitA a_from_c_tf32(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// c += a * b on the tensor cores (16x8x8, TF32 in, fp32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b at fp32 accuracy from split operands (b: hi0, hi1, lo0, lo1).
__device__ __forceinline__ void mma_split(float (&c)[4], const SplitA& a, const uint32_t (&b)[4]) {
#if GD3D_TF32_PASSES == 3
  mma_tf32(c, a.lo, b[0], b[1]);
  mma_tf32(c, a.hi, b[2], b[3]);
#endif
  mma_tf32(c, a.hi, b[0], b[1]);
}

// ------------------------------------------------------- fp32 tiles
// A tile of fp32 rows in shared memory has kLd floats a row: D for a raw
// tile that cp.async fills and that is only split, D + 4 for a tile that
// the products read (split tiles, and raw rows whose A fragments are split
// at use). D + 4 = 4 (mod 32) makes both ways the products read a tile hit
// 32 banks: 8 rows g at 4 columns t (an A fragment, or an S-type product's
// B operand: bank 4 g + t + const) and the 4 rows 2t (or 2t + 1) at 8
// columns g (a P- or dS-type product's B operand: bank 8 t + g + const);
// and ldmatrix's 8 rows of 16 bytes fall 16 bytes apart mod 128.

// Rows [row0, row0 + kRows) of a (rows, D) fp32 slice with row stride
// `stride` (elements) into shared memory rows of kLd floats, 16 bytes a
// copy, the kN threads of the block taking a share each; rows at or past
// n_rows and columns at or past n_cols (a head dim below the kernel width
// D, a multiple of 4) become zeros, and are not read. src and stride * 4
// bytes must fall on 16 bytes.
template <int kRows, int D, int kLd, int kN = kThreads>
__device__ __forceinline__ void copy_rows_async(uint32_t dst, const float* __restrict__ src,
                                                long long stride, int row0, int n_rows,
                                                int n_cols) {
  constexpr int kChunks = D / 4;  // 16-byte copies a row
  constexpr int kAll = kRows * kChunks;
#pragma unroll
  for (int i = 0; i < (kAll + kN - 1) / kN; ++i) {
    const unsigned c = threadIdx.x + i * kN;
    if (kAll % kN != 0 && c >= kAll) break;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    const bool ok = row0 + r < n_rows && col < n_cols;
    cp_async16(dst + (r * kLd + col) * 4, ok ? src + (long long)(row0 + r) * stride + col : src,
               ok);
  }
}

// A raw tile of kRows rows of D floats into its TF32 parts, hi and lo, in
// rows of kLd floats, by the kN threads of the block.
template <int kRows, int D, int kLd, int kN = kThreads>
__device__ __forceinline__ void split_rows(const float* __restrict__ raw, float* __restrict__ hi,
                                           float* __restrict__ lo) {
  constexpr int kChunks = D / 4;
  constexpr int kAll = kRows * kChunks;
#pragma unroll
  for (int i = 0; i < (kAll + kN - 1) / kN; ++i) {
    const unsigned c = threadIdx.x + i * kN;
    if (kAll % kN != 0 && c >= kAll) break;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * D + col);
    const float4 h = make_float4(round_tf32(x.x), round_tf32(x.y), round_tf32(x.z),
                                 round_tf32(x.w));
    const float4 l = make_float4(round_tf32(x.x - h.x), round_tf32(x.y - h.y),
                                 round_tf32(x.z - h.z), round_tf32(x.w - h.w));
    const int o = r * kLd + col;
    *reinterpret_cast<float4*>(hi + o) = h;
    *reinterpret_cast<float4*>(lo + o) = l;
  }
}

// A B fragment of a split tile at offsets o0 (b0) and o1 (b1): hi0, hi1,
// lo0, lo1, as mma_split takes it.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const float* hi, const float* lo, int o0,
                                       int o1) {
  b[0] = __float_as_uint(hi[o0]);
  b[1] = __float_as_uint(hi[o1]);
  b[2] = __float_as_uint(lo[o0]);
  b[3] = __float_as_uint(lo[o1]);
}

// ldmatrix.x4: four 8 x 8 matrices of 16-bit elements, for fp32 each 8 rows
// of 4 floats (16 bytes); lane 8 m + r gives the address of row r of
// matrix m, and every lane 4 g + t receives float t of row g of each. That
// is an A or B fragment of m16n8k8 .tf32 in one instruction where four
// 4-byte loads would take four.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// This lane's ldmatrix address for the B fragments of an S-type product
// (b0 = X[8 nt + g][8 kk + t], b1 = its column t + 4) from a split tile in
// rows of kLd floats: matrices hi (columns 0..3, 4..7), lo (the same), so
// the fragment comes as mma_split takes it. Add (8 nt kLd + 8 kk) * 4
// bytes for n-tile nt and k-step kk.
template <int kLd>
__device__ __forceinline__ uint32_t b_lane_addr(const float* hi, const float* lo, int lane) {
  const int m = lane >> 3, r = lane & 7;
  return smem_u32(m < 2 ? hi : lo) + (r * kLd + 4 * (m & 1)) * 4;
}

// This lane's ldmatrix address for the A fragments of 16 raw fp32 rows in
// rows of kLd floats (a0..a3 = rows g, g + 8 at column t, then at t + 4).
// Add 32 kk bytes for k-step kk.
template <int kLd>
__device__ __forceinline__ uint32_t a_lane_addr(const float* rows, int lane) {
  const int m = lane >> 3, r = lane & 7;
  return smem_u32(rows) + (((m & 1) * 8 + r) * kLd + 4 * (m >> 1)) * 4;
}

// The A fragment at `addr` (a_lane_addr), split.
__device__ __forceinline__ SplitA split_a_ldm(uint32_t addr) {
  uint32_t a[4];
  ldmatrix_x4(a, addr);
  return split_a(__uint_as_float(a[0]), __uint_as_float(a[1]), __uint_as_float(a[2]),
                 __uint_as_float(a[3]));
}

// The warp's 16 rows (first + g, first + g + 8) of a (rows, 8 kSteps) fp32
// slice as A fragments of its kSteps k-steps, in fp32 (split at use); rows
// at or past n_rows and columns at or past n_cols are zeros. Read once a
// block, from device memory.
template <int kSteps>
__device__ __forceinline__ void load_a_rows(float (&a)[kSteps][4], const float* __restrict__ src,
                                            long long stride, int first, int n_rows, int n_cols,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool ok0 = first + g < n_rows, ok1 = first + g + 8 < n_rows;
  const float* r0 = src + (long long)(first + g) * stride;
  const float* r1 = src + (long long)(first + g + 8) * stride;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const bool lo = 8 * kk + t < n_cols, hi = 8 * kk + t + 4 < n_cols;
    a[kk][0] = ok0 && lo ? r0[8 * kk + t] : 0.f;
    a[kk][1] = ok1 && lo ? r1[8 * kk + t] : 0.f;
    a[kk][2] = ok0 && hi ? r0[8 * kk + t + 4] : 0.f;
    a[kk][3] = ok1 && hi ? r1[8 * kk + t + 4] : 0.f;
  }
}

// Writes a warp's 16 x (8 kTiles) fp32 C tile to rows first + g, first + g
// + 8 of a slice with row stride `stride`; rows at or past n_rows and
// columns at or past n_cols (a head dim below the kernel width, a multiple
// of 4, past the slice's first column) are skipped.
template <int kTiles>
__device__ __forceinline__ void store_c_rows(const float (&c)[kTiles][4], float* __restrict__ dst,
                                             long long stride, int first, int n_rows, int n_cols,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = first + g + 8 * half;
    if (r >= n_rows) continue;
    float* row = dst + (long long)r * stride + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
      if (nt * 8 + 2 * t < n_cols)
        *reinterpret_cast<float2*>(row + nt * 8) =
            make_float2(c[nt][2 * half], c[nt][2 * half + 1]);
  }
}


// ------------------------------------------------------ warp teams
// The fp32 kernels at 128 and 256 may give each 16 rows to a team of kTeam
// warps (1, 2 or 4), which split the head dim: each runs the k-steps of an
// S-type product over its part of D (a partial C tile) and the P-type
// product into its part of the output columns. The team sums its partial C
// tiles through shared memory (`team_sum`), after which every warp of the
// team holds the whole tile, bit for bit.

// The kTeam warps of team `team` (0..3) wait for each other, at named
// barrier 1 + team (__syncthreads takes barrier 0); immediate barrier ids
// let ptxas count the barriers a block uses.
template <int kTeam>
__device__ __forceinline__ void team_sync(int team) {
  switch (team) {
    case 0: asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kTeam) : "memory"); break;
    case 1: asm volatile("bar.sync 2, %0;\n" ::"n"(32 * kTeam) : "memory"); break;
    case 2: asm volatile("bar.sync 3, %0;\n" ::"n"(32 * kTeam) : "memory"); break;
    default: asm volatile("bar.sync 4, %0;\n" ::"n"(32 * kTeam) : "memory"); break;
  }
}

// Floats of a warp's part in team_sum's shared memory: kF floats a lane,
// lane rows padded by 4 floats to an odd number of 16-byte units, so the
// lanes' 16-byte stores and loads hit distinct banks.
template <int kF>
__host__ __device__ constexpr int team_part_floats() {
  static_assert(kF % 8 == 0, "whole pairs of 16-byte units a lane");
  return 32 * (kF + 4);
}

// Each of the kT C tiles c[t] (kN n-tiles each, a partial sum in each warp
// of the team) becomes the team's sum, in the same order in every warp
// (p0 + p1, or (p0 + p1) + (p2 + p3)), so all hold the same bits. `xch`
// holds the team's parts, team_part_floats<kT * kN * 4>() floats each, warp
// `part`'s at part times that. The caller keeps a __syncthreads between two
// calls on the same memory.
template <int kTeam, int kT, int kN>
__device__ __forceinline__ void team_sum(float (&c)[kT][kN][4], float* xch, int part, int team,
                                         int lane) {
  static_assert(kTeam == 1 || kTeam == 2 || kTeam == 4, "teams of 1, 2 or 4 warps");
  if constexpr (kTeam > 1) {
    constexpr int kF = kT * kN * 4;
    constexpr int kPart = team_part_floats<kF>();
    float4* mine = reinterpret_cast<float4*>(xch + part * kPart + lane * (kF + 4));
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int i = 0; i < kN; ++i)
        mine[t * kN + i] = make_float4(c[t][i][0], c[t][i][1], c[t][i][2], c[t][i][3]);
    team_sync<kTeam>(team);
    const float* x = xch + lane * (kF + 4);
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        float4 p[kTeam];
#pragma unroll
        for (int m = 0; m < kTeam; ++m)
          p[m] = *reinterpret_cast<const float4*>(x + m * kPart + 4 * (t * kN + i));
        const float4 s01 = make_float4(p[0].x + p[1].x, p[0].y + p[1].y, p[0].z + p[1].z,
                                       p[0].w + p[1].w);
        if constexpr (kTeam == 2) {
          c[t][i][0] = s01.x, c[t][i][1] = s01.y, c[t][i][2] = s01.z, c[t][i][3] = s01.w;
        } else {
          c[t][i][0] = s01.x + (p[2].x + p[3].x);
          c[t][i][1] = s01.y + (p[2].y + p[3].y);
          c[t][i][2] = s01.z + (p[2].z + p[3].z);
          c[t][i][3] = s01.w + (p[2].w + p[3].w);
        }
      }
  }
}
}  // namespace tc
}  // namespace gd3d
