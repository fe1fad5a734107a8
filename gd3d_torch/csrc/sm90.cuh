// Hopper building blocks of the bf16 flash kernels (K1 forward, K2
// backward) at the kernel widths 64, 128 and 256, as inline PTX for sm_90a: tensor
// maps and TMA copies, mbarriers, warpgroup matrix products (wgmma) with
// their shared-memory descriptors, and register handover between
// warpgroups (setmaxnreg).
//
// Tiles: a tile of R rows of head dim D in bf16 lies in shared memory as
// D / 64 column panels, one after another, each R rows of 64 columns (128
// bytes a row; the panel of columns 64 p .. 64 p + 63 starts 128 R p bytes
// into the tile). TMA copies a panel in boxes of 64 rows with the 128-byte
// swizzle (16-byte chunk c of row r lands at chunk c ^ (r % 8)), so 8 rows
// make a 1024-byte atom and a tile must start on 1024 bytes. At D = 64 a
// tile is one panel. That is the layout wgmma's descriptors call
// SWIZZLE_128B, read two ways:
//   K-major (the reduction runs along a row: Q and K in S = Q K^T, dO and V
//   in dP = dO V^T, K and V as the A operand of S^T = K Q^T and
//   dP^T = V dO^T, Q and dO as their B operand): k-step kk of 16 columns
//   reads panel kk / 4, its start address 32 (kk % 4) bytes along the
//   rows; 8-row groups are 1024 bytes apart (SBO);
//   MN-major (the reduction runs down the rows: V in O = P V, dO in
//   dV = P^T dO, Q in dK = dS^T Q, K in dQ = dS K), the descriptor's
//   transpose bit set: a k-step of 16 rows is two atoms, 2048 bytes; 8-row
//   groups are 1024 bytes apart (SBO); a product n columns wide spans n / 64
//   panels, 128 R bytes apart (LBO, the step from one 64-column atom to the
//   next along n).
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

constexpr int kRowBytes = 128;  // a panel row: 64 bf16
constexpr int kBox = 64;        // rows a TMA copy brings (one box of one panel)
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

// The tensor map of a (B, L, H, D) bf16 view with element strides s (its
// last dim contiguous): dims (D, L, H, B), boxes of 64 x kBox x 1 x 1 (one
// box of one panel), the 128-byte swizzle. TMA fills what a box holds past
// the view with zeros: rows past L, and columns past D where D is below
// the kernel width (D a multiple of 8: 16-byte rows), up to whole panels
// past D (the fourth at D = 192, width 256). A box counts its full
// kBoxBytes towards its barrier's transaction count however much of it lies
// out of bounds, so every stage expects the same bytes at any D. A step
// along a dim of length 1 is never taken, so it is replaced by one that TMA
// takes. Returns false where CUDA refuses the map (an address or step off
// 16 bytes).
inline bool encode_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D,
                       Strides s) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const long long sn = L == 1 ? (long long)D * H : s.n;
  const long long sh = H == 1 ? D : s.h;
  const long long sb = B == 1 ? sn * L : s.b;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
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

// The bf16 launchers at any head dim D up to 256 that is a multiple of 8
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu), at the kernel width 64, 128 or 256
// that holds it; cudaErrorInvalidValue for another D.
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int N, int M, int H, int D, Strides qs, Strides ks,
                            Strides vs, Strides os, float scale, cudaStream_t stream);
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, void* dq, void* dk, void* dv,
                            int B, int N, int M, int H, int D, Strides qs, Strides ks,
                            Strides vs, Strides dos, float scale, cudaStream_t stream);

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

// Waits until the phase of parity `parity` has completed. (A bounded wait
// that traps after a timeout was tried: its exit path out of the consumer
// warpgroups' code made ptxas fit that code within the launch bound instead
// of the setmaxnreg budget, and every kernel that hands registers over
// spilled.)
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

// One box (columns col .. col + 63 and kBox rows from `row`, of head h and
// batch b) into shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int col, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(col), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// Rows row0 .. row0 + kRows - 1 (kRows a multiple of kBox) of the kD / 64
// panels into a tile at dst whose panels are kPanel bytes apart, completing
// on `bar`.
template <int kD, int kRows, int kPanel>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int row0, int h, int b) {
#pragma unroll
  for (int p = 0; p < kD / 64; ++p)
#pragma unroll
    for (int i = 0; i < kRows / kBox; ++i)
      tma_load(dst + p * kPanel + i * kBoxBytes, map, bar, 64 * p, row0 + i * kBox, h, b);
}

// Register handover between warpgroups (setmaxnreg), in the plans that
// hand over (Regs: head dim 64, and two consumer warpgroups at any head
// dim): a block of 128 (kWG + 1) threads launches at 65536 / (128 (kWG +
// 1)) registers a thread (two blocks an SM at kWG = 1); the producer
// warpgroup drops to 24 and the consumers take what it gave up, 232 at
// kWG = 1 and 240 at kWG = 2. One-consumer plans above head dim 64 hand
// nothing over (Regs).
template <int kRegs>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// The register plan of a kernel at head dim kD with kWG consumer
// warpgroups. A block of one consumer warpgroup above head dim 64 takes
// most of an SM's shared memory, so it runs alone on its SM anyway: it is
// bounded to one block an SM (up to 255 registers a thread, 150-234 used)
// and hands nothing over. The others hand over as above. (Bounded to two
// blocks an SM, ptxas refused head dim 256's m64n256k16 product, whose 128
// accumulators and operands need 158 registers, within 128; that build
// also had the trap that mbar_wait's note tells of.)
template <int kD, int kWG>
struct Regs {
  static constexpr bool kHandover = kD == 64 || kWG == 2;
  static constexpr int kMinBlocks = kD == 64 && kWG == 1 ? 2 : 1;  // for __launch_bounds__
  __device__ __forceinline__ static void producer() {
    if constexpr (kHandover) regs_down<24>();
  }
  __device__ __forceinline__ static void consumer() {  // all the producer gave up
    if constexpr (kHandover) regs_up<kWG == 1 ? 232 : 240>();
  }
};

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
// k-steps do): SBO 1024 bytes, LBO `lbo` bytes (read only by an MN-major
// product wider than one 64-column atom).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// K-major: k-step kk of a tile whose panels are kPanel bytes apart reads
// panel kk / 4, 32 (kk % 4) bytes along its rows.
template <int kPanel>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * kPanel + (kk & 3) * 32, 16);
}

// MN-major: k-step kk starts 16 rows further down; a product n columns wide
// reads n / 64 panels, kPanel bytes apart.
template <int kPanel>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * kRowBytes, kPanel);
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

// Stores a warpgroup's 64 x kN accumulator as bf16 rows of a (rows,
// stride) output: this thread's rows row0 + g (times mul0) and row0 + g + 8
// (times mul1), skipping rows at or past n_rows and the 8-column chunks at
// or past n_cols (the output's head dim past the accumulator's first
// column, a multiple of 8; the columns past it hold the zero columns of a
// head dim below the kernel width). row0 is the warp's first row.
template <int kN>
__device__ __forceinline__ void store_acc(const float (&d)[kN / 2], float mul0, float mul1,
                                          bf16* __restrict__ out, long long stride, int row0,
                                          int n_rows, int n_cols, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int c = 0; c < kN / 8; ++c) {
    if (8 * c >= n_cols) break;
    const int col = 8 * c + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(out + r0 * stride + col) =
          pack_bf16(d[4 * c] * mul0, d[4 * c + 1] * mul0);
    if (r1 < n_rows)
      *reinterpret_cast<uint32_t*>(out + r1 * stride + col) =
          pack_bf16(d[4 * c + 2] * mul1, d[4 * c + 3] * mul1);
  }
}

// The accumulator registers of a wgmma, as asm operands and as the
// operand list {%0, ..., %n-1} of its PTX (n = 32, 64, 96 or 128 floats).
#define GD3D_ACC8(i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define GD3D_ACC32(i) GD3D_ACC8(i), GD3D_ACC8(i + 8), GD3D_ACC8(i + 16), GD3D_ACC8(i + 24)
#define GD3D_ACC64(i) GD3D_ACC32(i), GD3D_ACC32(i + 32)
#define GD3D_ACC128 GD3D_ACC64(0), GD3D_ACC64(64)

#define GD3D_D32 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" "}"
#define GD3D_D64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63" "}"
#define GD3D_D96 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, " \
  "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, " \
  "%90, %91, %92, %93, %94, %95" "}"
#define GD3D_D128 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, " \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, " \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127" "}"

// d = A B (acc = 0) or d += A B, m64nNk16 with N = kN (64 or 128), A and B
// K-major in shared memory.
template <int kN>
__device__ __forceinline__ void wgmma_ss(float (&d)[kN / 2], uint64_t da, uint64_t db, int acc) {
  static_assert(kN == 64 || kN == 128, "wgmma_ss: n is 64 or 128");
  if constexpr (kN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GD3D_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : GD3D_ACC32(0)
        : "l"(da), "l"(db), "r"(acc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GD3D_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : GD3D_ACC64(0)
        : "l"(da), "l"(db), "r"(acc));
  }
}

// d = A B (acc = 0) or d += A B, m64nNk16 with N = kN (64, 128, 192 or 256), A a
// bf16 fragment in registers, B in shared memory: K-major (kTransB = 0) or
// MN-major (kTransB = 1, the descriptor's transpose bit).
template <int kN, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[kN / 2], const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  static_assert(kN == 64 || kN == 128 || kN == 192 || kN == 256,
                "wgmma_rs: n is 64, 128, 192 or 256");
  if constexpr (kN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GD3D_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : GD3D_ACC32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(kTransB));
  } else if constexpr (kN == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GD3D_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : GD3D_ACC64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(kTransB));
  } else if constexpr (kN == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " GD3D_D96
        ", {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : GD3D_ACC64(0), GD3D_ACC32(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " GD3D_D128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : GD3D_ACC128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(kTransB));
  }
}

#undef GD3D_ACC8
#undef GD3D_ACC32
#undef GD3D_ACC64
#undef GD3D_ACC128
#undef GD3D_D32
#undef GD3D_D64
#undef GD3D_D96
#undef GD3D_D128

}  // namespace sm90
}  // namespace gd3d
