// K1 above head dim 256 on thread-block clusters: the split of the head
// dim across a cluster's CTAs and the cluster building blocks (ranks,
// distributed shared memory, mbarriers that peers arrive on, st.async)
// that the bf16 kernel (flash_fwd_cluster_sm90.cu, wgmma on TMA tiles) and
// the fp32 kernel (flash_fwd_cluster_tf32.cu, split TF32 on mma.sync)
// share. gd3d_flash_fwd (flash_fwd.cu, by gd3d_flash_fwd_route) sends
// 256 < D <= kMaxDBf16 (bf16) or kMaxD (fp32) here and D past them to
// flash_chunked.cu.
//
// The design, in both dtypes: a cluster of G CTAs takes one tile of query
// rows of one (b, h); CTA g copies only its own columns of Q, K and V (the
// copies fill zeros past D) and forms its part of S = Q K^T over them on
// the tensor cores. The parts meet in distributed shared memory and are
// summed in rank order, so every CTA holds the same bits of S, runs the
// same online softmax, and accumulates O = P V over its own columns; rank
// 0 writes the LSE. A key tile costs one exchange, signalled on per-warp (or
// per-team) mbarriers, not on a cluster barrier; the cluster barrier runs
// twice a launch, after the mbarriers are initialised and before any CTA
// leaves (a peer may still use its shared memory). The bf16 kernel pushes
// its part into each peer's inbox by st.async, whose bytes complete the
// peer's barrier; the fp32 kernel leaves its part in its own shared memory
// and the peers pull it (its shared memory has no room for an inbox). What
// an exchange costs, measured on the card (PERF.md, "K1 above 256
// (Hopper)"): not the waiting, nor the bytes, but the cluster-scope release
// and acquire that make plain stores visible to a peer; st.async needs
// neither.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace gd3d {
namespace cluster {

constexpr int kMaxCtas = 8;                   // the portable cluster size
constexpr int kPanelCols = 64;                // the head-dim columns a panel
constexpr int kMaxD = 4 * kPanelCols * kMaxCtas;  // 2048: four panels a CTA at most
// The bf16 kernel's inbox holds a part of S from each peer, two tiles deep,
// beside 160 KB of Q, K and V: room for two peers
constexpr int kMaxCtasBf16 = 3;
constexpr int kMaxDBf16 = 4 * kPanelCols * kMaxCtasBf16;  // 768

// How head dim D (256 < D <= kMaxD) splits across a cluster: its
// P = ceil(D / 64) panels go to G = ceil(P / 4) CTAs, ceil(P / G) panels
// each (cols = 192 or 256 columns), CTA g taking columns g * cols on; the
// panels of the last CTA past D are zeros. So a CTA costs the products of
// at most 256 columns, and D = 320 those of 2 x 192, not of 512.
struct Split {
  int ctas, cols;
};

__host__ __device__ constexpr Split split(int D) {
  const int panels = (D + kPanelCols - 1) / kPanelCols;
  const int ctas = (panels + 3) / 4;
  return {ctas, kPanelCols * ((panels + ctas - 1) / ctas)};
}

cudaError_t launch_fwd_cluster_bf16(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int N, int M, int H, int D, Strides qs,
                                    Strides ks, Strides vs, Strides os, float scale,
                                    cudaStream_t stream);
cudaError_t launch_fwd_cluster_tf32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int N, int M, int H, int D, Strides qs,
                                    Strides ks, Strides vs, Strides os, float scale,
                                    cudaStream_t stream);

// ------------------------------------------------------------------ host
// A launch of `ctas`-CTA clusters along x (grid.x a multiple of ctas):
// launch(kernel, args...) sets the kernel's dynamic shared memory and
// returns the launch's error, then cudaGetLastError().
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Launch(dim3 grid, int threads, int smem, int ctas, cudaStream_t stream) : cfg(), attr() {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = ctas;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  Launch(const Launch&) = delete;
  template <typename... Params, typename... Args>
  cudaError_t operator()(void (*kernel)(Params...), Args&&... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(cfg.dynamicSmemBytes));
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

// ---------------------------------------------------------------- device
__device__ __forceinline__ int rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

// Every thread of every CTA of the cluster (release, then acquire).
__device__ __forceinline__ void sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// The address of the same shared-memory location in CTA `cta` of the cluster.
__device__ __forceinline__ uint32_t at(uint32_t addr, int cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(cta));
  return r;
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// Makes initialised barriers visible to the cluster and to the async proxy.
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on the barrier at `bar` of CTA `cta` (release at cluster
// scope: this thread's earlier writes, and those its warp made before a
// __syncwarp, are seen by whoever the phase releases).
__device__ __forceinline__ void arrive(uint32_t bar, int cta) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   at(bar, cta))
               : "memory");
}

// One arrival on the barrier at `bar` of CTA `cta` that says this thread
// has read what that CTA left for it (the values are in registers, used
// before the arrival is issued), so it may be written again: no data is
// published, so no cluster-scope release (as CUTLASS's consumer release of
// a peer's buffer).
__device__ __forceinline__ void arrive_read(uint32_t bar, int cta) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(at(bar, cta)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` of this CTA's barrier at `bar`
// has completed: with acquire at cluster scope (kCluster: a peer's plain
// stores are read next) or at the default CTA scope (st.async's bytes, as
// TMA's, and read-done arrivals). A wait of more than ten seconds traps: a
// peer that never arrives is a fault, and a launch that fails is better
// than a card that hangs.
template <bool kCluster>
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    if constexpr (kCluster)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    if (done) break;
    const uint64_t now = global_ns();
    if (t0 == 0) t0 = now;
    else if (now - t0 > 10000000000ull) asm volatile("trap;\n");
  }
}

__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  wait_phase<true>(bar, parity);
}

__device__ __forceinline__ void wait_cta(uint32_t bar, uint32_t parity) {
  wait_phase<false>(bar, parity);
}

// Four floats into CTA `cta`'s shared memory at its address `addr` (this
// CTA's address of the same location), counted as 16 bytes on its barrier
// at `bar` (st.async: no fence, the bytes complete the peer's phase).
__device__ __forceinline__ void st_async4(uint32_t addr, uint32_t bar, int cta, float a, float b,
                                          float c, float d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(at(addr, cta)),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(at(bar, cta))
      : "memory");
}

__device__ __forceinline__ void st4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// Four floats at a shared::cluster address (from `at`; this CTA's own too).
__device__ __forceinline__ void ld4(float* x, uint32_t addr) {
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
               : "r"(addr)
               : "memory");
}

// Four floats at a shared::cta address (this CTA's own).
__device__ __forceinline__ void ld4_own(float* x, uint32_t addr) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
               : "r"(addr)
               : "memory");
}

// The kV float4s at `mine` + i * step (i < kV) in CTA `cta`: this CTA's own
// through its shared::cta window, a peer's through the cluster's.
template <int kV>
__device__ __forceinline__ void ld_part(float (&y)[4 * kV], uint32_t mine, uint32_t step,
                                        int cta, int me) {
  if (cta == me) {
#pragma unroll
    for (int i = 0; i < kV; ++i) ld4_own(y + 4 * i, mine + i * step);
  } else {
    const uint32_t a = at(mine, cta);
#pragma unroll
    for (int i = 0; i < kV; ++i) ld4(y + 4 * i, a + i * step);
  }
}

// x = the sum over the cluster's CTAs of the kV float4s each holds at
// `mine` + i * step (i < kV) in its shared memory, in rank order:
// ((p0 + p1) + p2) + ..., so every CTA gets the same bits. Each part's
// float4s are all asked for before any is added.
template <int kV>
__device__ __forceinline__ void sum_ranks(float (&x)[4 * kV], uint32_t mine, uint32_t step,
                                          int ctas, int me) {
  ld_part<kV>(x, mine, step, 0, me);
  for (int c = 1; c < ctas; ++c) {
    float y[4 * kV];
    ld_part<kV>(y, mine, step, c, me);
#pragma unroll
    for (int e = 0; e < 4 * kV; ++e) x[e] += y[e];
  }
}

}  // namespace cluster
}  // namespace gd3d
