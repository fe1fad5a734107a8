// Tensor-core building blocks of the bf16 flash kernels (K1 forward, K2
// backward), as inline PTX for sm_90a: mma.sync m16n8k16 (bf16 operands,
// fp32 accumulators), ldmatrix (plain and .trans) and tile loads built on
// the cp.async copies of common.cuh.
//
// Tiles: 64 rows of head dim 64 in bf16 (128 bytes a row). In shared memory
// each row is padded by 16 bytes (kRowE = 72 elements, 144 bytes), so the 8
// row addresses of one ldmatrix phase start 4 banks apart and hit all 32
// banks once: no bank conflicts, at 9 KB a tile.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), lane = 4 g + t:
//   A (16x16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//                          a2 = A[g][2t+8..],  a3 = A[g+8][2t+8..]
//   B (16x8, "col"):       b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8, fp32):        c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// A C tile of 16 rows and 16 columns (two n-tiles) is, once rounded to bf16,
// the A fragment of a product over those 16 columns (a_from_c below): the
// flash kernels feed P and dS to the next product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace gd3d {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRowE = kD + 8;                            // elements per smem row
constexpr int kTileBytes = kTile * kRowE * 2;            // 9216
constexpr int kChunks = kTile * kD * 2 / 16 / kThreads;  // 16-byte copies per thread

// Rows [row0, row0 + 64) of a (rows, 64) bf16 slice with row stride `stride`
// (elements) into a padded smem tile; rows at or past n_rows become zeros.
// src points at row 0 and must be 16-byte aligned, as must stride * 2 bytes.
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ src,
                                                long long stride, int row0, int n_rows) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    const bool ok = row0 + r < n_rows;
    const bf16* g = ok ? src + (long long)(row0 + r) * stride + col : src;
    cp_async16(dst + (r * kRowE + col) * 2, g, ok);
  }
}

// Entries [i0, i0 + 64) of a fp32 vector (the log-sum-exp or di row of one
// (b, h)); entries at or past n become zeros. Threads 0..63 copy one each.
__device__ __forceinline__ void load_vec_async(uint32_t dst, const float* __restrict__ src,
                                               int i0, int n, int tid) {
  const bool ok = i0 + tid < n;
  cp_async4(dst + tid * 4, ok ? src + i0 + tid : src, ok);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment of the 16x16 block at (row0, col0) of a row-major smem tile.
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], uint32_t tile, int row0, int col0,
                                       int lane) {
  ldsm_x4(r, tile + ((row0 + (lane & 15)) * kRowE + col0 + (lane >> 4) * 8) * 2);
}

// B fragments of two n-tiles (n0..n0+15) at depth k0..k0+15 from a smem tile
// stored [n][k] (B = tileᵀ: the keys of S = Q Kᵀ): r[0], r[1] feed n-tile 0,
// r[2], r[3] n-tile 1.
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], uint32_t tile, int n0, int k0,
                                       int lane) {
  ldsm_x4(r, tile + ((n0 + (lane & 7) + (lane >> 4) * 8) * kRowE + k0 +
                     ((lane >> 3) & 1) * 8) * 2);
}

// The same from a smem tile stored [k][n] (B = tile: V in P V), through
// ldmatrix.trans.
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&r)[4], uint32_t tile, int k0, int n0,
                                             int lane) {
  ldsm_x4_trans(r, tile + ((k0 + (lane & 15)) * kRowE + n0 + (lane >> 4) * 8) * 2);
}

// c += a * b on the tensor cores (16x8x16, bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of columns 16 kk .. 16 kk + 15 of a 16-row C tile held as
// n-tiles c[2 kk] and c[2 kk + 1].
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Writes a warp's 16 x 64 fp32 C tile (8 n-tiles), times `mul` per row half,
// as bf16 into rows row0.. of a padded smem tile, then copies those rows to
// global memory with 16-byte stores: row r goes to dst + (first + r) * stride,
// and rows at or past n_rows are skipped.
__device__ __forceinline__ void store_rows(const float (&c)[8][4], float mul_lo, float mul_hi,
                                           bf16* tile, int row0, bf16* __restrict__ dst,
                                           long long stride, int first, int n_rows,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + (row0 + g) * kRowE + col) =
        pack_bf16(c[nt][0] * mul_lo, c[nt][1] * mul_lo);
    *reinterpret_cast<uint32_t*>(tile + (row0 + g + 8) * kRowE + col) =
        pack_bf16(c[nt][2] * mul_hi, c[nt][3] * mul_hi);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c16 = lane + 32 * i;  // 16 rows of 8 chunks
    const int r = c16 >> 3;
    const int col = (c16 & 7) * 8;
    if (first + r < n_rows)
      *reinterpret_cast<uint4*>(dst + (long long)(first + r) * stride + col) =
          *reinterpret_cast<const uint4*>(tile + (row0 + r) * kRowE + col);
  }
}

}  // namespace tc
}  // namespace gd3d
