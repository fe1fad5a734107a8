// Tensor-core building blocks of the fp32 flash backward (K2, flash_bwd.cu),
// as inline PTX for sm_90a: mma.sync m16n8k8 on TF32 operands split into
// two parts, and the lse / di vector loads built on the cp.async copies of
// common.cuh. (The bf16 flash kernels run on wgmma: sm90.cuh.)
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

}  // namespace tc
}  // namespace gd3d
