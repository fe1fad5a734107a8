// K4: fused pairwise depth-ranking loss, forward and both backward passes.
//
// Replaces gd3d/kernels/pairwise_rank.py: the forward _fwd_kernel
// (pallas_call at :235), the row pass _bwd_row_kernel (:309) and the column
// pass _bwd_col_kernel (:339). For every keypoint pair (i, j) of a view,
//
//   diff  = u[j] - u[i] + bias                       (hidden width h)
//   score = tanh(w_out . gelu(LN(diff)) + b_out)
//   loss  = log1p(exp(-sign(d_j - d_i) * score))
//
// summed over the valid pairs (|d_j - d_i| > thr, both keypoints valid).
// The forward writes per-row (per i) loss sums and valid-pair counts; the
// caller sums them per view. The row pass writes du over the i role
// (-ddiff summed over j) and per-block partial sums of the five parameter
// gradients (dbias, dln_s, dln_b, dw_out, db_out); the column pass adds du
// over the j role (+ddiff summed over i); a last pass sums the partials.
//
// What carries over from the TPU and what does not: gd3d accumulates the
// parameter gradients across its sequential grid (pairwise_rank.py:133-150).
// Blocks on Hopper run in no order, so each block writes its own partial and
// a second pass sums the partials in a fixed order, as K2 does: the result is
// deterministic, bit for bit from run to run. N is not a multiple of any
// tile (672, 300): streamed rows past N are masked inside the kernel, no
// padded copy is made. GELU is exact, with CUDA's erff (fp32, a few ulp),
// where the TPU kernel uses the Abramowitz-Stegun polynomial (abs err
// 1.5e-7, pairwise_rank.py:34-44); both agree with the plain twin's erf to
// within the fp32 tolerance.
//
// What bounds it on an H100: arithmetic on the CUDA cores. A pair costs
// about 30 flops per hidden unit forward (LayerNorm, erff, tanh) and about
// twice that backward, against reading u once (N * h floats per view): at
// N = 672, h = 128 the forward is ~3.5 GFLOP over 0.7 MB. The (N, N, h)
// intermediates that the plain twin materializes (0.46 GB each at N = 672)
// never leave registers. One warp owns one row (the lanes split the hidden
// width, h / 32 units each); the block's eight warps stream the other rows
// through shared memory in tiles of 32; invalid pairs are skipped whole
// (the condition is uniform across the warp), so the work is that of the
// valid pairs.
//
// Layout: u (B, N, h), depths (B, N), valid (B, N) as fp32 (> 0 is valid),
// grad_rows (B, N): all contiguous fp32. h is 32, 64, 96 or 128.
#include "common.cuh"

namespace gd3d {

constexpr int kPrWarps = 8;
constexpr int kPrThreads = kPrWarps * 32;
constexpr int kPrTile = 32;
constexpr int kPrMaxH = 128;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

enum PrMode { kPrFwd = 0, kPrRow = 1, kPrCol = 2 };

struct PrHead {
  const float* bias;
  const float* ln_s;
  const float* ln_b;
  const float* w_out;
  const float* b_out;
  float thr;
  float eps;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Grid (ceil(N / kPrWarps), B); warp w of block x owns row p = 8x + w of
// view b and streams every other row q. In the forward and the row pass the
// owned row plays i and the streamed one j; in the column pass the reverse.
template <int kPer, int kMode>
__global__ void __launch_bounds__(kPrThreads)
pairwise_rank_kernel(const float* __restrict__ u, const float* __restrict__ depths,
                     const float* __restrict__ valid, const float* __restrict__ grad_rows,
                     PrHead hd, int N, float* __restrict__ row_sum,
                     float* __restrict__ row_cnt, float* __restrict__ du,
                     float* __restrict__ partials) {
  constexpr int kH = 32 * kPer;
  __shared__ __align__(16) float Us[kPrTile * kH];
  __shared__ float Ds[kPrTile];
  __shared__ float Vs[kPrTile];
  __shared__ float Gs[kPrTile];
  __shared__ float red[kMode == kPrRow ? kPrWarps * (4 * kPrMaxH + 1) : 1];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kPrWarps + warp;
  const float* ub = u + (long long)b * N * kH;
  const float* db = depths + (long long)b * N;
  const float* vb = valid + (long long)b * N;
  const float* gb = grad_rows + (long long)b * N;
  const bool own_ok = p < N && vb[p] > 0.f;
  const float d_own = p < N ? db[p] : 0.f;
  const float g_own = (kMode == kPrRow && p < N) ? gb[p] : 0.f;
  const float inv_h = 1.f / kH;
  const float b_out = *hd.b_out;

  // a = bias - u[i] (owned row is i) or bias + u[j] (owned row is j)
  float a[kPer], lns[kPer], lnb[kPer], w[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int d = lane + 32 * e;
    const float uo = p < N ? ub[(long long)p * kH + d] : 0.f;
    a[e] = kMode == kPrCol ? hd.bias[d] + uo : hd.bias[d] - uo;
    lns[e] = hd.ln_s[d];
    lnb[e] = hd.ln_b[d];
    w[e] = hd.w_out[d];
  }
  float loss_acc = 0.f, cnt_acc = 0.f, db_acc = 0.f;
  float du_acc[kPer], dbias_acc[kPer], dlns_acc[kPer], dlnb_acc[kPer], dw_acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    du_acc[e] = dbias_acc[e] = dlns_acc[e] = dlnb_acc[e] = dw_acc[e] = 0.f;
  }

  for (int q0 = 0; q0 < N; q0 += kPrTile) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kPrTile * kH; idx += kPrThreads) {
      const int r = q0 + idx / kH;
      Us[idx] = r < N ? ub[(long long)q0 * kH + idx] : 0.f;
    }
    if (threadIdx.x < kPrTile) {
      const int r = q0 + threadIdx.x;
      Ds[threadIdx.x] = r < N ? db[r] : 0.f;
      Vs[threadIdx.x] = r < N ? vb[r] : 0.f;
      Gs[threadIdx.x] = (kMode == kPrCol && r < N) ? gb[r] : 0.f;
    }
    __syncthreads();
    if (!own_ok) continue;
    const int rows = min(kPrTile, N - q0);
    for (int t = 0; t < rows; ++t) {
      // dj - di: the owned row is i except in the column pass
      const float dd = kMode == kPrCol ? d_own - Ds[t] : Ds[t] - d_own;
      if (!(Vs[t] > 0.f) || !(fabsf(dd) > hd.thr)) continue;  // warp-uniform
      const float* uq = Us + t * kH;
      float x[kPer];
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        x[e] = kMode == kPrCol ? a[e] - uq[lane + 32 * e] : a[e] + uq[lane + 32 * e];
        s += x[e];
      }
      const float mu = warp_sum(s) * inv_h;
      float s2 = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        x[e] -= mu;
        s2 += x[e] * x[e];
      }
      const float inv = rsqrtf(warp_sum(s2) * inv_h + hd.eps);
      float y[kPer], g[kPer];
      float sp = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        x[e] *= inv;  // xhat
        y[e] = x[e] * lns[e] + lnb[e];
        g[e] = 0.5f * y[e] * (1.f + erff(y[e] * kInvSqrt2));
        sp += g[e] * w[e];
      }
      const float score = tanhf(warp_sum(sp) + b_out);
      const float alpha = dd > 0.f ? 1.f : -1.f;
      const float z = -alpha * score;
      if (kMode == kPrFwd) {
        loss_acc += log1pf(expf(z));
        cnt_acc += 1.f;
        continue;
      }
      const float gscale = kMode == kPrRow ? g_own : Gs[t];
      const float sig = 1.f / (1.f + expf(-z));
      const float dpre = gscale * (-alpha * sig) * (1.f - score * score);
      float dy[kPer], dxh[kPer];
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const float gelu_grad = 0.5f * (1.f + erff(y[e] * kInvSqrt2)) +
                                y[e] * kInvSqrt2Pi * expf(-0.5f * y[e] * y[e]);
        dy[e] = dpre * w[e] * gelu_grad;
        dxh[e] = dy[e] * lns[e];
        m1 += dxh[e];
        m2 += dxh[e] * x[e];
      }
      m1 = warp_sum(m1) * inv_h;
      m2 = warp_sum(m2) * inv_h;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const float ddiff = inv * (dxh[e] - m1 - x[e] * m2);
        if (kMode == kPrCol) {
          du_acc[e] += ddiff;
        } else {
          du_acc[e] -= ddiff;
          dbias_acc[e] += ddiff;
          dlns_acc[e] += dy[e] * x[e];
          dlnb_acc[e] += dy[e];
          dw_acc[e] += dpre * g[e];
        }
      }
      if (kMode == kPrRow) db_acc += dpre;
    }
  }

  if (kMode == kPrFwd) {
    if (p < N && lane == 0) {
      row_sum[(long long)b * N + p] = loss_acc;
      row_cnt[(long long)b * N + p] = cnt_acc;
    }
    return;
  }
  if (p < N) {
    float* dur = du + ((long long)b * N + p) * kH;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (kMode == kPrCol)
        dur[lane + 32 * e] += du_acc[e];  // after the row pass, same stream
      else
        dur[lane + 32 * e] = du_acc[e];
    }
  }
  if (kMode == kPrRow) {
    // this block's parameter-gradient partial: its warps summed in order
    constexpr int kP = 4 * kH + 1;
    float* rw = red + warp * kP;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int d = lane + 32 * e;
      rw[d] = dbias_acc[e];
      rw[kH + d] = dlns_acc[e];
      rw[2 * kH + d] = dlnb_acc[e];
      rw[3 * kH + d] = dw_acc[e];
    }
    if (lane == 0) rw[4 * kH] = db_acc;
    __syncthreads();
    float* part = partials + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kP;
    for (int c = threadIdx.x; c < kP; c += kPrThreads) {
      float acc = 0.f;
#pragma unroll
      for (int wi = 0; wi < kPrWarps; ++wi) acc += red[wi * kP + c];
      part[c] = acc;
    }
  }
}

// Sums the per-block partials (n_blocks, P) column by column in block order.
__global__ void pairwise_rank_reduce(const float* __restrict__ partials, int n_blocks, int P,
                                     float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P) return;
  float acc = 0.f;
  for (int i = 0; i < n_blocks; ++i) acc += partials[(long long)i * P + c];
  out[c] = acc;
}

template <int kMode>
void launch_pr(int h, dim3 grid, const float* u, const float* depths, const float* valid,
               const float* grad_rows, PrHead hd, int N, float* row_sum, float* row_cnt,
               float* du, float* partials, cudaStream_t st) {
#define GD3D_PR_LAUNCH(PER)                                                          \
  pairwise_rank_kernel<PER, kMode><<<grid, kPrThreads, 0, st>>>(                     \
      u, depths, valid, grad_rows, hd, N, row_sum, row_cnt, du, partials)
  switch (h) {
    case 32: GD3D_PR_LAUNCH(1); break;
    case 64: GD3D_PR_LAUNCH(2); break;
    case 96: GD3D_PR_LAUNCH(3); break;
    default: GD3D_PR_LAUNCH(4); break;
  }
#undef GD3D_PR_LAUNCH
}

}  // namespace gd3d

namespace {
bool pr_shape_ok(int B, int N, int h) {
  return B > 0 && N > 0 && (h == 32 || h == 64 || h == 96 || h == 128);
}
}  // namespace

extern "C" int gd3d_pairwise_rank_fwd(const void* u, const void* depths, const void* valid,
                                      const void* bias, const void* ln_s, const void* ln_b,
                                      const void* w_out, const void* b_out, void* row_sum,
                                      void* row_cnt, int B, int N, int h, float thr,
                                      float eps, void* stream) {
  using namespace gd3d;
  if (!pr_shape_ok(B, N, h)) return static_cast<int>(cudaErrorInvalidValue);
  const PrHead hd{static_cast<const float*>(bias), static_cast<const float*>(ln_s),
                  static_cast<const float*>(ln_b), static_cast<const float*>(w_out),
                  static_cast<const float*>(b_out), thr, eps};
  const dim3 grid((N + kPrWarps - 1) / kPrWarps, B);
  launch_pr<kPrFwd>(h, grid, static_cast<const float*>(u), static_cast<const float*>(depths),
                    static_cast<const float*>(valid), nullptr, hd, N,
                    static_cast<float*>(row_sum), static_cast<float*>(row_cnt), nullptr,
                    nullptr, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// partials: (B * ceil(N / 8), 4h + 1) scratch; param_grads: (4h + 1) =
// [dbias | dln_s | dln_b | dw_out | db_out].
extern "C" int gd3d_pairwise_rank_bwd(const void* u, const void* depths, const void* valid,
                                      const void* bias, const void* ln_s, const void* ln_b,
                                      const void* w_out, const void* b_out,
                                      const void* grad_rows, void* du, void* partials,
                                      void* param_grads, int B, int N, int h, float thr,
                                      float eps, void* stream) {
  using namespace gd3d;
  if (!pr_shape_ok(B, N, h)) return static_cast<int>(cudaErrorInvalidValue);
  const PrHead hd{static_cast<const float*>(bias), static_cast<const float*>(ln_s),
                  static_cast<const float*>(ln_b), static_cast<const float*>(w_out),
                  static_cast<const float*>(b_out), thr, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kPrWarps - 1) / kPrWarps, B);
  const float* u_ = static_cast<const float*>(u);
  const float* d_ = static_cast<const float*>(depths);
  const float* v_ = static_cast<const float*>(valid);
  const float* g_ = static_cast<const float*>(grad_rows);
  float* du_ = static_cast<float*>(du);
  float* part_ = static_cast<float*>(partials);
  launch_pr<kPrRow>(h, grid, u_, d_, v_, g_, hd, N, nullptr, nullptr, du_, part_, st);
  launch_pr<kPrCol>(h, grid, u_, d_, v_, g_, hd, N, nullptr, nullptr, du_, nullptr, st);
  const int P = 4 * h + 1;
  pairwise_rank_reduce<<<(P + 127) / 128, 128, 0, st>>>(part_, grid.x * grid.y, P,
                                                         static_cast<float*>(param_grads));
  return static_cast<int>(cudaGetLastError());
}
