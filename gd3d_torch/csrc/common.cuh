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

// Flash tiles: head_dim 64, 64 rows (queries or keys) per tile, 128
// threads a block.
constexpr int kD = 64;
constexpr int kTile = 64;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

}  // namespace gd3d
