// Shared helpers for the gd3d_torch CUDA kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// cp.async: asynchronous copies from global to shared memory, zero-filled
// where !ok (the source is then not read). Source and destination must be
// aligned to the copy's size.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

// 4-byte copy.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One-instruction forms of 2^x and 1/x on the special-function unit (about
// 2 ulp; 2^-inf is 0), without the slow paths that exp2f and a division
// carry for denormals.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// Head-dim-generic forms of the two helpers above, for K1 at head dim
// 32 * kParts: kParts consecutive threads own one row, each a 32-wide part,
// and a tile row lives in shared memory as kParts parts kPad floats apart.
template <typename T, int kParts, int kRows>
__device__ __forceinline__ void load_tile_parts(float* dst, const T* __restrict__ src,
                                                long long row_stride, int row0, int n_rows) {
  constexpr int kDim = 32 * kParts;
  for (int idx = threadIdx.x; idx < kRows * kDim; idx += kThreads) {
    const int r = idx / kDim;
    const int d = idx % kDim;
    const int gr = row0 + r;
    const float val = gr < n_rows ? to_float(src[gr * row_stride + d]) : 0.f;
    dst[r * (kParts * kPad) + (d / kHalf) * kPad + (d % kHalf)] = val;
  }
}

// Dot product of a thread's 32-wide register part with a tile row's part,
// completed across the row's kParts threads (a butterfly over lane bits).
template <int kParts>
__device__ __forceinline__ float parts_dot(const float* reg, const float* tile_row_part) {
  const float4* t = reinterpret_cast<const float4*>(tile_row_part);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kHalf / 4; ++c) {
    const float4 x = t[c];
    acc = fmaf(reg[4 * c + 0], x.x, acc);
    acc = fmaf(reg[4 * c + 1], x.y, acc);
    acc = fmaf(reg[4 * c + 2], x.z, acc);
    acc = fmaf(reg[4 * c + 3], x.w, acc);
  }
#pragma unroll
  for (int o = 1; o < kParts; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
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
