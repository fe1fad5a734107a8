// K2 at head dims above 256, and K1 above 768 (bf16) or 2048 (fp32):
// non-causal flash attention, forward (O and the row log-sum-exp) and
// backward (dQ, dK, dV), in column chunks. K1 at 256 < D up to those runs
// on thread-block clusters instead (flash_fwd_cluster_sm90.cu,
// flash_fwd_cluster_tf32.cu: S once a key tile on the tensor cores);
// gd3d_flash_fwd sends only D past their reach (cluster::kMaxDBf16,
// cluster::kMaxD) to launch_fwd here, and gd3d_flash_bwd every D above 256
// to launch_bwd.
//
// Replaces, for those head dims (past the widest of the other flash
// kernels: flash_fwd_sm90.cu, flash_fwd.cu, flash_bwd_sm90.cu, flash_bwd.cu,
// flash_bwd_tf32_wide.cu at 64, 128 and 256; past the cluster kernels'
// reach for K1), the same TPU kernels as they do:
// the stock Pallas flash forward that gd3d reaches through
// gd3d/ops/attention.py::_flash_call, and
// gd3d/kernels/flash_bwd_fused.py::flash_attention_bwd_fused. gd3d's
// attention takes any head dim; no model of the repo goes past 128, so no
// path launches these kernels.
//
// Design. Past 256 columns the other kernels' output tiles (64 rows x D
// fp32 accumulators) no longer fit a block's registers, so a program owns
// 64 rows and one chunk of at most kChunk = 256 head-dim columns of its
// output. The score-like products (S = Q K^T, and for K2 dP = dO V^T) need
// every column, so each program forms them over the whole head dim, in
// 64-column panels through shared memory, and then applies its weights (P,
// or dS) to its own chunk of the other operand: a head dim of D costs
// ceil(D / 256) times the score products, which the bound counts once.
// One template serves both dtypes: every operand is read by 16-byte loads
// (the caller's rows are 16-byte multiples: 4 fp32 or 8 bf16; the wrappers
// zero-pad any other D), widened to fp32 in shared memory, and every sum
// runs in fp32 on the CUDA cores in a fixed order (no atomics), so the
// results repeat bit for bit. 256 threads form a 16 x 16 grid: a thread
// owns the rows ty + 16a and, of a 64 x 64 score tile, the columns
// tx + 16b (a, b < 4), and of its output chunk the columns tx + 16b of each
// of its (up to 4) panels: 64 fp32 accumulators. A row's 16 lanes are one
// half-warp, so row reductions take four shuffles. Shared memory rows are
// 65 floats, so the 16 lanes of a row read 16 banks.
//
// * Forward: own rows are queries, the loop walks keys in
//   tiles of 64 with the online softmax in log2 units; the chunk-0 program
//   writes the LSE.
// * Backward, one launch, three programs per (row tile, chunk): kDq (own
//   queries: dQ += dS K), kDk (own keys: dK += dS^T Q) and kDv (own keys:
//   dV += P^T dO), each recomputing P from the saved LSE and, for dQ and
//   dK, dP from dO and V, with Delta = rowsum(dO * O) from the caller.
//
// What bounds it: at (B, N, H, D) = (2, 673, 2, 512) the forward's score and
// PV products are 3.7 GFLOP once against 11 MB of traffic, so the work is
// arithmetic; these kernels are simple CUDA-core kernels (no tensor cores)
// and run far below that bound (PERF.md, "K1 / K2 above 256"; the forward
// was timed there before the cluster kernels took 257..2048 from it).
#include <algorithm>

#include "flash_chunked.cuh"

namespace gd3d {
namespace chunked {

constexpr int kRows = 64;                // own rows a program
constexpr int kOther = 64;               // rows of the other side a tile
constexpr int kPanel = 64;               // head-dim columns a panel
constexpr int kPanels = kChunk / kPanel;  // panels a chunk
constexpr int kThreadsC = 256;
constexpr int kLd = kPanel + 1;          // shared-memory row, floats
constexpr int kBuf = kRows * kLd;        // one 64 x 64 tile
constexpr int kSmemBytes = 3 * kBuf * static_cast<int>(sizeof(float));

enum Mode { kDq, kDk, kDv };  // the backward's programs

struct Operand {
  const void* p;
  Strides s;
};

// Four fp32 (or eight bf16, two to a word, the lower first) of one 16-byte
// load, widened to fp32.
template <typename T>
__device__ __forceinline__ void widen(const uint4& u, float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      out[i] = __uint_as_float(w[i]);
    } else {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Rows row0 .. row0 + 63 (of L) and head-dim columns col0 .. col0 + 63 (of D)
// of one (b, h) slice of `x`, as fp32 into `dst` (rows of kLd floats), zero
// past L and past D. D is a multiple of the 16-byte vector.
template <typename T>
__device__ __forceinline__ void load_panel(float* dst, Operand x, int b, int h, int row0, int L,
                                           int col0, int D) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kPanel / kVec;
  const T* base = static_cast<const T*>(x.p) + b * x.s.b + h * x.s.h;
  for (int idx = threadIdx.x; idx < kRows * kPerRow; idx += kThreadsC) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    float vals[kVec];
    if (row0 + r < L && col0 + c < D) {
      const uint4 u = *reinterpret_cast<const uint4*>(base + (row0 + r) * x.s.n + col0 + c);
      widen<T>(u, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * kLd + c + i] = vals[i];
  }
}

// acc[a][b] += sum over the whole head dim of A[own row][.] * B[other row][.]
// for the thread's rows ty + 16a and columns tx + 16b.
template <typename T>
__device__ __forceinline__ void score_tile(float (&acc)[4][4], float* sa, float* sb, Operand A,
                                           Operand Bo, int b, int h, int own0, int own_len,
                                           int oth0, int oth_len, int D) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int p0 = 0; p0 < D; p0 += kPanel) {
    load_panel<T>(sa, A, b, h, own0, own_len, p0, D);
    load_panel<T>(sb, Bo, b, h, oth0, oth_len, p0, D);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kPanel; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sa[(ty + 16 * i) * kLd + kk];
        bv[i] = sb[(tx + 16 * i) * kLd + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// out[p][a][b] += sum over the tile's 64 other rows j of W[row][j] *
// X[j][chunk column], panel by panel of the chunk (npanels of them).
template <typename T>
__device__ __forceinline__ void apply_tile(float (&out)[kPanels][4][4], const float* sw, float* sx,
                                           Operand X, int b, int h, int oth0, int oth_len,
                                           int col0, int npanels, int D) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int p = 0; p < kPanels; ++p) {
    if (p < npanels) {  // uniform over the block
      load_panel<T>(sx, X, b, h, oth0, oth_len, col0 + p * kPanel, D);
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < kOther; ++j) {
        float wv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wv[i] = sw[(ty + 16 * i) * kLd + j];
          xv[i] = sx[j * kLd + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) out[p][i][c] = fmaf(wv[i], xv[c], out[p][i][c]);
      }
      __syncthreads();
    }
  }
}

// The max (or sum) of v over the 16 lanes of this thread's half-warp.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void store_chunk(const float (&acc)[kPanels][4][4], float mul_row[4],
                                            T* out, Strides s, int b, int h, int row0, int L,
                                            int col0, int npanels, int D) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  T* base = out + b * s.b + h * s.h;
#pragma unroll
  for (int p = 0; p < kPanels; ++p) {
    if (p >= npanels) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r >= L) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + p * kPanel + tx + 16 * c;
        if (col < D) base[r * s.n + col] = from_float<T>(acc[p][i][c] * mul_row[i]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsC)
    flash_fwd_chunked_kernel(Operand q, Operand k, Operand v, T* o, Strides os, float* lse,
                             int N, int M, int H, int D, float scale_log2) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = smem + kBuf;
  float* sw = smem + 2 * kBuf;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * kRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int col0 = blockIdx.z * kChunk;
  const int npanels = min(kPanels, (D - col0 + kPanel - 1) / kPanel);

  float acc[kPanels][4][4] = {};
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int j0 = 0; j0 < M; j0 += kOther) {
    float s[4][4] = {};
    score_tile<T>(s, sa, sb, q, k, b, h, row0, N, j0, M, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = (j0 + tx + 16 * c < M) ? s[i][c] * scale_log2 : -INFINITY;
        tmax = fmaxf(tmax, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(tmax));  // a tile holds >= 1 key
      const float corr = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[i][c] - m_new);
        psum += p;
        sw[(ty + 16 * i) * kLd + tx + 16 * c] = p;
      }
      l[i] = l[i] * corr + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][i][c] *= corr;
    }
    __syncthreads();
    apply_tile<T>(acc, sw, sa, v, b, h, j0, M, col0, npanels, D);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / l[i];
  store_chunk<T>(acc, inv, o, os, b, h, row0, N, col0, npanels, D);
  if (blockIdx.z == 0 && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r < N) lse[(static_cast<long long>(blockIdx.y)) * N + r] = (m[i] + log2f(l[i])) * kLn2;
    }
  }
}

// One program of the backward: dQ (own queries), dK or dV (own keys), one
// chunk of columns.
template <typename T, int kMode>
__device__ __forceinline__ void bwd_program(Operand q, Operand k, Operand v, Operand dout,
                                            const float* lse, const float* di, T* out,
                                            Strides os, int N, int M, int H, int D, float scale,
                                            float* smem) {
  float* sa = smem;
  float* sb = smem + kBuf;
  float* sw = smem + 2 * kBuf;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool own_q = kMode == kDq;
  const int own_len = own_q ? N : M, oth_len = own_q ? M : N;
  const int row0 = blockIdx.x * kRows;
  if (row0 >= own_len) return;  // uniform over the block
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int chunks = (D + kChunk - 1) / kChunk;
  const int col0 = (blockIdx.z % chunks) * kChunk;
  const int npanels = min(kPanels, (D - col0 + kPanel - 1) / kPanel);
  const float* lse_bh = lse + static_cast<long long>(bh) * N;
  const float* di_bh = di + static_cast<long long>(bh) * N;
  const float scale_log2 = scale * kLog2e;

  // the query-side statistics of the own rows (dQ), in log2 units
  float row_lse[4] = {}, row_di[4] = {};
  if (own_q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      row_lse[i] = r < N ? lse_bh[r] * kLog2e : 0.f;
      row_di[i] = r < N ? di_bh[r] : 0.f;
    }
  }
  float acc[kPanels][4][4] = {};
  for (int j0 = 0; j0 < oth_len; j0 += kOther) {
    // s[i][c]: own row ty + 16i against other row j0 + tx + 16c
    float s[4][4] = {};
    if (own_q)
      score_tile<T>(s, sa, sb, q, k, b, h, row0, N, j0, M, D);
    else
      score_tile<T>(s, sa, sb, k, q, b, h, row0, M, j0, N, D);
    float dp[4][4] = {};
    if (kMode == kDq)
      score_tile<T>(dp, sa, sb, dout, v, b, h, row0, N, j0, M, D);
    else if (kMode == kDk)
      score_tile<T>(dp, sa, sb, v, dout, b, h, row0, M, j0, N, D);
    float col_lse[4] = {}, col_di[4] = {};
    if (!own_q) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = j0 + tx + 16 * c;
        col_lse[c] = r < N ? lse_bh[r] * kLog2e : 0.f;
        col_di[c] = r < N ? di_bh[r] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool live = row0 + ty + 16 * i < own_len && j0 + tx + 16 * c < oth_len;
        const float l2 = own_q ? row_lse[i] : col_lse[c];
        const float p = live ? exp2f(s[i][c] * scale_log2 - l2) : 0.f;
        float w = p;
        if (kMode != kDv) w = p * (dp[i][c] - (own_q ? row_di[i] : col_di[c]));
        sw[(ty + 16 * i) * kLd + tx + 16 * c] = w;
      }
    }
    __syncthreads();
    const Operand X = kMode == kDq ? k : (kMode == kDk ? q : dout);
    apply_tile<T>(acc, sw, sa, X, b, h, j0, oth_len, col0, npanels, D);
  }
  const float mul = kMode == kDv ? 1.f : scale;
  float muls[4] = {mul, mul, mul, mul};
  store_chunk<T>(acc, muls, out, os, b, h, row0, own_len, col0, npanels, D);
}

// grid.z = 3 * chunks: z / chunks picks dQ, dK or dV, z % chunks the chunk.
template <typename T>
__global__ void __launch_bounds__(kThreadsC)
    flash_bwd_chunked_kernel(Operand q, Operand k, Operand v, Operand dout, const float* lse,
                             const float* di, T* dq, T* dk, T* dv, Strides qos, Strides kos,
                             int N, int M, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int chunks = (D + kChunk - 1) / kChunk;
  const int part = blockIdx.z / chunks;
  if (part == 0)
    bwd_program<T, kDq>(q, k, v, dout, lse, di, dq, qos, N, M, H, D, scale, smem);
  else if (part == 1)
    bwd_program<T, kDk>(q, k, v, dout, lse, di, dk, kos, N, M, H, D, scale, smem);
  else
    bwd_program<T, kDv>(q, k, v, dout, lse, di, dv, kos, N, M, H, D, scale, smem);
}

template <typename T>
static cudaError_t fwd_typed(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int N, int M, int H, int D, Strides qs, Strides ks,
                             Strides vs, Strides os, float scale, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRows - 1) / kRows, B * H, (D + kChunk - 1) / kChunk);
  flash_fwd_chunked_kernel<T><<<grid, kThreadsC, kSmemBytes, st>>>(
      Operand{q, qs}, Operand{k, ks}, Operand{v, vs}, static_cast<T*>(o), os,
      static_cast<float*>(lse), N, M, H, D, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t bwd_typed(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* di, void* dq, void* dk, void* dv,
                             int B, int N, int M, int H, int D, Strides qs, Strides ks,
                             Strides vs, Strides dos, float scale, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // dQ is (B, N, H, D), dK and dV (B, M, H, D), all contiguous
  const long long hd = static_cast<long long>(H) * D;
  const Strides qos{N * hd, hd, D}, kos{M * hd, hd, D};
  const dim3 grid((std::max(N, M) + kRows - 1) / kRows, B * H, 3 * ((D + kChunk - 1) / kChunk));
  flash_bwd_chunked_kernel<T><<<grid, kThreadsC, kSmemBytes, st>>>(
      Operand{q, qs}, Operand{k, ks}, Operand{v, vs}, Operand{dout, dos},
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), qos, kos, N, M, H, D, scale);
  return cudaGetLastError();
}

cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int N, int M, int H, int D, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, bool bf16, cudaStream_t st) {
  if (bf16)
    return fwd_typed<__nv_bfloat16>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, os, scale, st);
  return fwd_typed<float>(q, k, v, o, lse, B, N, M, H, D, qs, ks, vs, os, scale, st);
}

cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* di, void* dq, void* dk, void* dv, int B,
                       int N, int M, int H, int D, Strides qs, Strides ks, Strides vs,
                       Strides dos, float scale, bool bf16, cudaStream_t st) {
  if (bf16)
    return bwd_typed<__nv_bfloat16>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, D, qs, ks,
                                    vs, dos, scale, st);
  return bwd_typed<float>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, D, qs, ks, vs, dos,
                          scale, st);
}

}  // namespace chunked
}  // namespace gd3d
