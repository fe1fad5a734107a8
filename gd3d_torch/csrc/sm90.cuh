// Hopper building blocks of the bf16 flash kernels at head dim 64 (K1
// forward, K2 backward), as inline PTX for sm_90a: tensor maps and TMA
// copies, mbarriers, warpgroup matrix products (wgmma) with their
// shared-memory descriptors, and register handover between warpgroups
// (setmaxnreg).
//
// Tiles: rows of head dim 64 in bf16, 128 bytes a row, copied by TMA with
// the 128-byte swizzle (16-byte chunk c of row r lands at chunk c ^ (r % 8)),
// so 8 rows make a 1024-byte atom and a tile must start on 1024 bytes. That
// is the layout wgmma's descriptors call SWIZZLE_128B, read two ways:
//   K-major (the reduction runs along a row: Q and K in S = Q K^T, dO and V
//   in dP = dO V^T, Q and dO as the B operand of S^T = K Q^T and
//   dP^T = V dO^T): the start address steps 32 bytes a k-step of 16, 8-row
//   groups are 1024 bytes apart (SBO);
//   MN-major (the reduction runs down the rows: V in O = P V, dO in
//   dV = P^T dO, Q in dK = dS^T Q, K in dQ = dS K), the descriptor's
//   transpose bit set: a k-step of 16 rows is two atoms, 2048 bytes; 8-row
//   groups are 1024 bytes apart (SBO); the 64 columns fill one atom's width.
//
// Register layouts (per warp of a warpgroup, lane = 4 g + t; the warp holds
// rows 16 w .. 16 w + 15 of the 64):
//   accumulator of m64nN: d[4 c + e], c < N / 8: row g + 8 (e / 2), column
//   8 c + 2 t + e % 2;
//   A fragment of m64k16 (bf16 pairs): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
//   a2 = (g, 2t+8..), a3 = (g+8, 2t+8..).
// So accumulator columns 16 k .. 16 k + 15 (chunks 2k, 2k + 1), rounded to
// bf16, are directly the A fragment of k-step k of the next product
// (a_from_acc): P and dS never leave registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace gd3d {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kRowBytes = 128;  // a tile row: 64 bf16
constexpr int kBox = 64;        // rows a TMA copy brings (one box)
constexpr int kBoxBytes = kBox * kRowBytes;

// ------------------------------------------------------------------ host
// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (cudaGetDriverEntryPointByVersion), so that the library links without
// libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a (B, L, H, 64) bf16 view with element strides s (its
// last dim contiguous): dims (64, L, H, B), boxes of 64 x kBox x 1 x 1, the
// 128-byte swizzle, rows past L read as zeros. A step along a dim of length
// 1 is never taken, so it is replaced by one that TMA takes. Returns false
// where CUDA refuses the map (an address or step off 16 bytes).
inline bool encode_map(CUtensorMap* map, const void* ptr, int B, int L, int H, Strides s) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const long long sn = L == 1 ? 64LL * H : s.n;
  const long long sh = H == 1 ? 64 : s.h;
  const long long sb = B == 1 ? sn * L : s.b;
  const cuuint64_t dims[4] = {64, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sn * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, kBox, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Streaming multiprocessors of the current device (asked once).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// Whether 128-row blocks (two consumer warpgroups, one block an SM) over
// rows of length L fill at least two waves; if not, a launcher takes
// 64-row blocks (one consumer warpgroup, two blocks an SM).
inline bool wide_tiles(int L, int B, int H) {
  return (long long)((L + 127) / 128) * B * H >= 2LL * sm_count();
}

// The bf16, head-dim-64 launchers (flash_fwd_sm90.cu, flash_bwd_sm90.cu).
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int N, int M, int H, Strides qs, Strides ks, Strides vs,
                            Strides os, float scale, cudaStream_t stream);
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, void* dq, void* dk, void* dv,
                            int B, int N, int M, int H, Strides qs, Strides ks, Strides vs,
                            Strides dos, float scale, cudaStream_t stream);

// ---------------------------------------------------------------- device
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map))
               : "memory");
}

// One box (64 columns x kBox rows of head h, batch b, from row `row`) into
// shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(0), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// Register handover between warpgroups (setmaxnreg): a block of 128 (kWG +
// 1) threads launches at 65536 / (128 (kWG + 1)) registers a thread (two
// blocks an SM at kWG = 1); the producer warpgroup drops to 24 and the
// consumers take what it gave up, 232 at kWG = 1 and 240 at kWG = 2.
template <int kRegs>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Named barriers (ids 1.., 0 being __syncthreads'): sync waits until n
// threads have arrived, itself included; arrive does not wait.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Two consumer warpgroups (kWG = 2) taking turns at issuing the products
// of their n steps, so that one's elementwise work runs under the other's
// products: warpgroup c waits on named barrier 1 + c, then hands the turn
// to the other at 2 - c. Warpgroup 0 goes first; warpgroup 1 hands no turn
// on after its last step, so every arrival is waited for. One warpgroup
// (kWG = 1) takes no turns.
template <int kWG>
struct Turns {
  int c, n;
  __device__ __forceinline__ Turns(int c_, int n_) : c(c_), n(n_) {
    if (kWG == 2 && c == 1) named_arrive(1, 256);
  }
  __device__ __forceinline__ void mine() const {
    if (kWG == 2) named_sync(1 + c, 256);
  }
  __device__ __forceinline__ void theirs(int step) const {
    if (kWG == 2 && !(c == 1 && step == n - 1)) named_arrive(2 - c, 256);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Tells the compiler that the registers change here: the products write
// their accumulators asynchronously, so no read may move above the wait
// and no write below the issue.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of a SWIZZLE_128B tile at `addr` (1024-byte
// aligned atoms; addr may step inside an atom's first row, as the K-major
// k-steps do): SBO 1024 bytes, LBO 16 bytes (not read for these layouts).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// K-major: k-step kk of a tile starts 32 bytes further along the rows.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 32);
}

// MN-major: k-step kk starts 16 rows further down.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * kRowBytes);
}

// Two fp32 values rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k-step k (accumulator columns 16 k .. 16 k + 15).
template <int kN>
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&d)[kN], int k) {
  a[0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
}

// The A fragment of k-step kk of a SWIZZLE_128B tile (64 columns a row,
// at generic address `tile`) whose 16 rows from `row0` this warp holds:
// what a K-major descriptor of the tile would feed a wgmma, loaded once so
// that a tile the block keeps is read from registers.
__device__ __forceinline__ void a_from_tile(uint32_t (&a)[4], const unsigned char* tile,
                                            int row0, int kk, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + g + 8 * (i & 1);  // rows g, g + 8, g, g + 8
    const int chunk = (2 * kk + (i >> 1)) ^ (r & 7);
    a[i] = *reinterpret_cast<const uint32_t*>(tile + r * kRowBytes + chunk * 16 + 4 * t);
  }
}

// Stores a warpgroup's 64 x 64 accumulator as bf16 rows of a contiguous
// (rows, stride) output: this thread's rows row0 + g (times mul0) and
// row0 + g + 8 (times mul1), skipping rows at or past n_rows. row0 is the
// warp's first row.
__device__ __forceinline__ void store_acc(const float (&d)[32], float mul0, float mul1,
                                          bf16* __restrict__ out, long long stride, int row0,
                                          int n_rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(out + r0 * stride + col) =
          pack_bf16(d[4 * c] * mul0, d[4 * c + 1] * mul0);
    if (r1 < n_rows)
      *reinterpret_cast<uint32_t*>(out + r1 * stride + col) =
          pack_bf16(d[4 * c + 2] * mul1, d[4 * c + 3] * mul1);
  }
}

// d = A B (acc = 0) or d += A B, A and B K-major in shared memory, m64n128k16.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d = A B (acc = 0) or d += A B, A a bf16 fragment in registers, B
// MN-major in shared memory (the transpose bit set), m64n64k16.
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}


// d = A B (acc = 0) or d += A B, A a bf16 fragment in registers, B
// K-major in shared memory, m64n64k16.
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

}  // namespace sm90
}  // namespace gd3d
