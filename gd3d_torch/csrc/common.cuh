// Shared helpers for the gd3d_torch CUDA kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace gd3d {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides of a (B, N, H, D) attention operand whose last dim is
// contiguous. q = qkv[:, :, 0] of a (B, N, 3, H, D) projection is such a view,
// so the kernels read the models' layout without a transpose copy.
struct Strides {
  long long b, n, h;
};

// Flash tiles: head_dim 64, 64 rows (queries or keys) per tile, two threads
// per row, each owning one 32-wide half of the head dim. A tile row lives in
// shared memory as two halves 36 floats apart, so the two threads of a pair
// read 16-byte vectors from disjoint banks.
constexpr int kD = 64;
constexpr int kHalf = 32;
constexpr int kTile = 64;
constexpr int kThreads = 128;
constexpr int kPad = 36;
constexpr int kRow = 2 * kPad;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Loads rows [row0, row0 + kTile) of one (b, h) slice into a padded fp32 tile;
// rows at or beyond n_rows are zero. src points at element (b, 0, h, 0).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int n_rows) {
  for (int idx = threadIdx.x; idx < kTile * kD; idx += kThreads) {
    const int r = idx / kD;
    const int d = idx % kD;
    const int gr = row0 + r;
    const float val = gr < n_rows ? to_float(src[gr * row_stride + d]) : 0.f;
    dst[r * kRow + (d / kHalf) * kPad + (d % kHalf)] = val;
  }
}

// Dot product of a thread's 32-wide register half with a tile row's half,
// completed across the thread pair.
__device__ __forceinline__ float pair_dot(const float* reg, const float* tile_row_half) {
  const float4* t = reinterpret_cast<const float4*>(tile_row_half);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kHalf / 4; ++c) {
    const float4 x = t[c];
    acc = fmaf(reg[4 * c + 0], x.x, acc);
    acc = fmaf(reg[4 * c + 1], x.y, acc);
    acc = fmaf(reg[4 * c + 2], x.z, acc);
    acc = fmaf(reg[4 * c + 3], x.w, acc);
  }
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

// reg += w * tile_row_half.
__device__ __forceinline__ void axpy_row(float* reg, float w, const float* tile_row_half) {
  const float4* t = reinterpret_cast<const float4*>(tile_row_half);
#pragma unroll
  for (int c = 0; c < kHalf / 4; ++c) {
    const float4 x = t[c];
    reg[4 * c + 0] = fmaf(w, x.x, reg[4 * c + 0]);
    reg[4 * c + 1] = fmaf(w, x.y, reg[4 * c + 1]);
    reg[4 * c + 2] = fmaf(w, x.z, reg[4 * c + 2]);
    reg[4 * c + 3] = fmaf(w, x.w, reg[4 * c + 3]);
  }
}

}  // namespace gd3d
