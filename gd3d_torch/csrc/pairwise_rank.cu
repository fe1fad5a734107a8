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
// caller sums them per view. The backward writes du (the i role, -ddiff
// summed over j, plus the j role, +ddiff summed over i) and the five
// parameter gradients (dbias, dln_s, dln_b, dw_out, db_out).
//
// What bounds it on an H100: the rate at which the CUDA cores and the
// special-function unit take work. A pair costs about 22 operations per
// hidden unit forward (LayerNorm, an erf, the output dot) and about 60
// backward, against reading u once: at N = 672, h = 128 the (N, N, h)
// intermediates that the plain twin materializes (0.46 GB each) never leave
// registers. The design:
//
// * Only valid keypoints are visited. A first kernel compacts each view: the
//   rows of its valid keypoints, their depths and upstream gradients go to
//   scratch in keypoint order, and the outputs of invalid keypoints are
//   zeroed. A pair of the compacted view fails only
//   the depth threshold, so almost no lane idles (at the MASt3R shape 44% of
//   all pairs are invalid, 3% of the compacted ones). Such a pair is still
//   skipped whole: it adds nothing to any sum or count.
// * LayerNorm stays two-pass, in the plain twin's order: u[j] - u[i] first
//   (exact in fp32 when the two rows are close, as the rows of a barely
//   trained head are), then the bias, the mean over the hidden width, and
//   the centred squares. Centring each row by its own mean beforehand would
//   save a reduction, but rounds at the size of u instead of the size of
//   the difference, which nearly equal rows would show.
// * Eight lanes own one pair (h / 8 hidden units each, as 16-byte vectors),
//   so a warp has four independent pairs in flight; a sum over the hidden
//   width is three shuffles, and the three later sums of the backward (output
//   dot, mean of dxhat, mean of dxhat * xhat) are reduced side by side.
//   The per-pair scalars use single-instruction exp, log and reciprocal.
// * GELU is exact up to the Abramowitz-Stegun 7.1.26 erf (abs. error
//   1.5e-7, the form gd3d's kernel uses, pairwise_rank.py:34-44): one
//   reciprocal and one exponential per unit, and exp(-y^2 / 2) is shared by
//   the erf and by the Gaussian of GELU's derivative, so each pass evaluates
//   them once per unit.
// * The grid splits the owned rows (one per warp) and the streamed range (a
//   third dimension of chunks), so that every scheduler has several warps
//   at N = 300 as well as at 672. Streamed rows arrive in tiles of 32
//   through a two-stage ring of 16-byte cp.async copies.
// * No atomics. Each (owned row, chunk) writes its own partial sums, counts
//   and du to scratch, each block its parameter-gradient partial, and
//   kernels of this file sum them in a fixed order: K4 and K4b give the
//   same bits from run to run. The row pass accumulates du, dln_s and
//   db_out (dbias is minus the sum of its du), the column pass du, dln_b
//   and dw_out, which balances their registers.
//
// Layout: u (B, N, h), depths (B, N), valid (B, N) as fp32 (> 0 is valid),
// grad_rows (B, N): all contiguous fp32. h is 32, 64, 96 or 128. The scratch
// is one fp32 buffer of gd3d_pairwise_rank_scratch(...) floats, laid out by
// PrScratch below.
#include "common.cuh"

namespace gd3d {

constexpr int kPrLanes = 8;              // lanes per pair
constexpr int kPrPairs = 32 / kPrLanes;  // pairs per warp step
constexpr int kPrTile = 32;              // streamed rows per stage
constexpr int kPrFwdWarps = 8;  // owned rows per block, forward
constexpr int kPrBwdWarps = 4;  // and in the two backward passes
constexpr int kPrPrepRows = 8;
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

// The scratch buffer, in floats. uc, dc, gc and idx hold the compacted
// views (the first nvalid[b] entries of each); the rest are partials.
struct PrScratch {
  float* uc;       // (B, N, h)   rows of the valid keypoints
  float* dc;       // (B, N)      their depths
  float* gc;       // (B, N)      their upstream gradients (backward)
  int* idx;        // (B, N)      their keypoint indices
  int* nvalid;     // (B)
  float* psum;     // (B, C, N)   forward: per-chunk row sums
  float* pcnt;     // (B, C, N)   forward: per-chunk row counts
  float* du_row;   // (B, C, N, h) backward: du over the i role, per chunk
  float* du_col;   // (B, C, N, h) backward: du over the j role, per chunk
  float* pparam;   // (B * ceil(N / kPrBwdWarps) * C, 4h + 1) block partials
  long long total;
};

__host__ __device__ inline long long pr_align4(long long x) { return (x + 3) & ~3LL; }

inline PrScratch pr_scratch(float* base, int B, int N, int h, int C, bool backward) {
  PrScratch s{};
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base + off;
    off += pr_align4(n);
    return p;
  };
  const long long BN = (long long)B * N;
  s.uc = take(BN * h);
  s.dc = take(BN);
  s.gc = take(BN);
  s.idx = reinterpret_cast<int*>(take(BN));
  s.nvalid = reinterpret_cast<int*>(take(B));
  if (backward) {
    s.du_row = take(BN * C * h);
    s.du_col = take(BN * C * h);
    s.pparam = take((long long)B * ((N + kPrBwdWarps - 1) / kPrBwdWarps) * C * (4 * h + 1));
  } else {
    s.psum = take(BN * C);
    s.pcnt = take(BN * C);
  }
  s.total = off;
  return s;
}

// Streamed rows per chunk when nv valid keypoints are split into C chunks: a
// multiple of the pairs a warp takes per step.
__device__ __forceinline__ int pr_chunk_len(int nv, int C) {
  return ((nv + C - 1) / C + kPrPairs - 1) / kPrPairs * kPrPairs;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the kPrLanes lanes that share a pair.
__device__ __forceinline__ float pair_sum(float x) {
#pragma unroll
  for (int o = 1; o < kPrLanes; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Compaction. Grid (ceil(N / 8), B), 256 threads: warp w takes keypoint
// n = 8 x + w. A valid one goes to slot (number of valid keypoints before
// it); an invalid one has its outputs zeroed.
template <bool kBackward>
__global__ void __launch_bounds__(32 * kPrPrepRows)
pairwise_rank_prep(const float* __restrict__ u, const float* __restrict__ depths,
                   const float* __restrict__ valid, const float* __restrict__ grad_rows,
                   int N, int h, PrScratch sc, float* __restrict__ row_sum,
                   float* __restrict__ row_cnt, float* __restrict__ du) {
  __shared__ int counts[2][kPrPrepRows];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kPrPrepRows;
  const float* vb = valid + (long long)b * N;
  int before = 0, all = 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int ok = vb[n] > 0.f;
    all += ok;
    before += ok && n < row0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_xor_sync(0xffffffffu, before, o);
    all += __shfl_xor_sync(0xffffffffu, all, o);
  }
  if (lane == 0) {
    counts[0][warp] = before;
    counts[1][warp] = all;
  }
  __syncthreads();
  before = all = 0;
#pragma unroll
  for (int w = 0; w < kPrPrepRows; ++w) {
    before += counts[0][w];
    all += counts[1][w];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) sc.nvalid[b] = all;

  const int n = row0 + warp;
  if (n >= N) return;
  int slot = before;
  for (int w = 0; w < warp; ++w) slot += vb[row0 + w] > 0.f;
  const long long bn = (long long)b * N + n;
  const bool ok = vb[n] > 0.f;
  const int h4 = h / 4;  // <= 32 vectors a row, one per lane
  if (!ok) {
    if (kBackward) {
      if (lane < h4) reinterpret_cast<float4*>(du + bn * h)[lane] = make_float4(0, 0, 0, 0);
    } else if (lane == 0) {
      row_sum[bn] = 0.f;
      row_cnt[bn] = 0.f;
    }
    return;
  }
  const long long bs = (long long)b * N + slot;
  if (lane < h4)
    reinterpret_cast<float4*>(sc.uc + bs * h)[lane] =
        reinterpret_cast<const float4*>(u + bn * h)[lane];
  if (lane == 0) {
    sc.dc[bs] = depths[bn];
    sc.idx[bs] = n;
    if (kBackward) sc.gc[bs] = grad_rows[bn];
  }
}

// Grid (ceil(N / kW), C, B), 32 kW threads. Warp w of block x owns the
// compacted keypoint p = kW x + w of view b and streams the keypoints of
// chunk blockIdx.y. In the forward and the row pass the owned keypoint
// plays i and the streamed one j; in the column pass the reverse. kPer is
// h / 32: a lane holds kPer 16-byte vectors of a row, vector 8 c + (lane % 8).
template <int kPer, int kMode, int kW>
__global__ void __launch_bounds__(32 * kW, kMode == kPrFwd ? 2 : 3)
pairwise_rank_kernel(PrHead hd, int N, PrScratch sc) {
  constexpr int kH = 32 * kPer;
  constexpr int kE = 4 * kPer;  // hidden units per lane
  constexpr int kThreadsB = 32 * kW;
  constexpr int kP = 4 * kH + 1;
  __shared__ __align__(16) float Us[2][kPrTile * kH];
  __shared__ float Ds[2][kPrTile];
  __shared__ float Gs[2][kPrTile];
  __shared__ __align__(16) float Bias[kH];
  __shared__ __align__(16) float Lns[kH];
  __shared__ __align__(16) float Lnb[kH];
  __shared__ __align__(16) float Wo[kH];

  const int b = blockIdx.z;
  const int C = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kPrLanes;  // which vectors of a row
  const int grp = lane / kPrLanes;  // which pair of the step
  const int nv = sc.nvalid[b];
  const int len = pr_chunk_len(nv, C);
  const int q_begin = blockIdx.y * len;
  const int q_end = min(nv, q_begin + len);
  const int p = blockIdx.x * kW + warp;
  float* part = kMode == kPrFwd ? nullptr
                                : sc.pparam + (((long long)b * gridDim.x + blockIdx.x) * C +
                                               blockIdx.y) * kP;
  if (blockIdx.x * kW >= nv || q_begin >= nv) {
    // nothing to do here; the parameter-gradient sum reads every partial
    if (kMode == kPrRow)
      for (int c = threadIdx.x; c < kP; c += kThreadsB)
        if (c < 2 * kH || c == 4 * kH) part[c] = 0.f;
    if (kMode == kPrCol)
      for (int c = threadIdx.x; c < 2 * kH; c += kThreadsB) part[2 * kH + c] = 0.f;
    return;
  }

  const float* ub = sc.uc + (long long)b * N * kH;
  const float* db = sc.dc + (long long)b * N;
  const float* gb = sc.gc + (long long)b * N;
  auto load_tile = [&](int st, int q0) {
    const uint32_t dst = smem_u32(Us[st]);
#pragma unroll
    for (int i = 0; i < kPrTile * kH / 4 / kThreadsB; ++i) {
      const int c = threadIdx.x + i * kThreadsB;
      const bool ok = q0 + c / (kH / 4) < q_end;
      cp_async16(dst + c * 16, ok ? ub + (long long)q0 * kH + c * 4 : ub, ok);
    }
    if (threadIdx.x < kPrTile) {
      const bool ok = q0 + threadIdx.x < q_end;
      cp_async4(smem_u32(&Ds[st][threadIdx.x]), ok ? db + q0 + threadIdx.x : db, ok);
      if (kMode == kPrCol)
        cp_async4(smem_u32(&Gs[st][threadIdx.x]), ok ? gb + q0 + threadIdx.x : gb, ok);
    }
  };
  load_tile(0, q_begin);
  cp_async_commit();

  for (int c = threadIdx.x; c < kH; c += kThreadsB) {
    Bias[c] = hd.bias[c];
    Lns[c] = hd.ln_s[c];
    Lnb[c] = hd.ln_b[c];
    Wo[c] = hd.w_out[c];
  }
  const bool own_ok = p < nv;
  const float d_own = own_ok ? db[p] : 0.f;
  const float g_own = (kMode == kPrRow && own_ok) ? gb[p] : 0.f;
  const float inv_h = 1.f / kH;
  const float b_out = *hd.b_out;

  float a[kE];  // the owned row
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    float4 t = make_float4(0, 0, 0, 0);
    if (own_ok) t = reinterpret_cast<const float4*>(ub + (long long)p * kH)[c * kPrLanes + sub];
    a[4 * c] = t.x, a[4 * c + 1] = t.y, a[4 * c + 2] = t.z, a[4 * c + 3] = t.w;
  }
  float loss_acc = 0.f, cnt_acc = 0.f, db_acc = 0.f;
  // acc0: du; acc1: dln_s (row pass) or dln_b (column pass); acc2: dw_out
  float acc0[kMode == kPrFwd ? 1 : kE], acc1[kMode == kPrFwd ? 1 : kE];
  float acc2[kMode == kPrCol ? kE : 1];
  if constexpr (kMode != kPrFwd) {
#pragma unroll
    for (int e = 0; e < kE; ++e) acc0[e] = acc1[e] = 0.f;
  }
  if constexpr (kMode == kPrCol) {
#pragma unroll
    for (int e = 0; e < kE; ++e) acc2[e] = 0.f;
  }

  const int n_tiles = (q_end - q_begin + kPrTile - 1) / kPrTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int q0 = q_begin + t * kPrTile;
    if (t + 1 < n_tiles) load_tile(st ^ 1, q0 + kPrTile);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const int steps = own_ok ? (min(kPrTile, q_end - q0) + kPrPairs - 1) / kPrPairs : 0;
    for (int step = 0; step < steps; ++step) {
      const int r = step * kPrPairs + grp;
      // dj - di: the owned row is i except in the column pass
      const float dd = kMode == kPrCol ? d_own - Ds[st][r] : Ds[st][r] - d_own;
      const bool ok = q0 + r < q_end && fabsf(dd) > hd.thr;
      if (!__any_sync(0xffffffffu, ok)) continue;
      const float4* uq = reinterpret_cast<const float4*>(Us[st] + r * kH) + sub;
      // diff = (u[j] - u[i]) + bias, its mean, then the centred squares
      float x[kE];
      float sm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const float4 v = uq[c * kPrLanes];
        const float4 b4 = reinterpret_cast<const float4*>(Bias)[c * kPrLanes + sub];
        const float uv[4] = {v.x, v.y, v.z, v.w};
        const float bias[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float d = kMode == kPrCol ? a[4 * c + k] - uv[k] : uv[k] - a[4 * c + k];
          x[4 * c + k] = d + bias[k];
          sm[k] += x[4 * c + k];
        }
      }
      const float mu = pair_sum((sm[0] + sm[1]) + (sm[2] + sm[3])) * inv_h;
      float sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        x[e] -= mu;
        sq[e & 3] = fmaf(x[e], x[e], sq[e & 3]);
      }
      const float var = pair_sum((sq[0] + sq[1]) + (sq[2] + sq[3])) * inv_h;
      const float inv = rsqrtf(var + hd.eps);
      // per unit: xhat (kept in x), y, the erf and Gaussian of GELU; sp sums
      // 2 gelu(y) w_out; qv = w_out gelu'(y), m1 and m2 sum dxhat / dpre and
      // dxhat xhat / dpre
      float qv[kMode == kPrFwd ? 1 : kE], gv[kMode == kPrCol ? kE : 1];
      float sp = 0.f, m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const float4 s4 = reinterpret_cast<const float4*>(Lns)[c * kPrLanes + sub];
        const float4 b4 = reinterpret_cast<const float4*>(Lnb)[c * kPrLanes + sub];
        const float4 w4 = reinterpret_cast<const float4*>(Wo)[c * kPrLanes + sub];
        const float lns[4] = {s4.x, s4.y, s4.z, s4.w};
        const float lnb[4] = {b4.x, b4.y, b4.z, b4.w};
        const float wo[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = 4 * c + k;
          x[e] *= inv;
          const float y = fmaf(x[e], lns[k], lnb[k]);
          // erf(|y| / sqrt 2), Abramowitz-Stegun 7.1.26
          const float tt = fast_rcp(fmaf(0.3275911f * 0.70710678f, fabsf(y), 1.f));
          float poly = fmaf(tt, 1.061405429f, -1.453152027f);
          poly = fmaf(tt, poly, 1.421413741f);
          poly = fmaf(tt, poly, -0.284496736f);
          poly = fmaf(tt, poly, 0.254829592f);
          const float gauss = fast_exp2(y * y * (-0.5f * kLog2e));  // exp(-y^2 / 2)
          const float erf_abs = fmaf(-poly * tt, gauss, 1.f);
          const float g2 = fmaf(fabsf(y), erf_abs, y);  // 2 gelu(y)
          sp = fmaf(g2, wo[k], sp);
          if constexpr (kMode != kPrFwd) {
            const float cdf = fmaf(0.5f, copysignf(erf_abs, y), 0.5f);
            qv[e] = wo[k] * fmaf(y * kInvSqrt2Pi, gauss, cdf);
            const float rr = qv[e] * lns[k];
            m1 += rr;
            m2 = fmaf(rr, x[e], m2);
          }
          if constexpr (kMode == kPrCol) gv[e] = g2;
        }
      }
      sp = pair_sum(sp);
      if (kMode != kPrFwd) {
        m1 = pair_sum(m1);
        m2 = pair_sum(m2);
      }
      // tanh(pre) = 1 - 2 / (exp(2 pre) + 1)
      const float pre = fmaf(0.5f, sp, b_out);
      const float score = 1.f - 2.f * fast_rcp(fast_exp2(pre * (2.f * kLog2e)) + 1.f);
      const float alpha = dd > 0.f ? 1.f : -1.f;
      const float ez = fast_exp2(-alpha * score * kLog2e);  // exp(z), z = -alpha score
      if constexpr (kMode == kPrFwd) {
        if (ok) {
          loss_acc += __logf(1.f + ez);  // |z| <= 1: 1 + exp(z) is in [1.36, 3.72]
          cnt_acc += 1.f;
        }
      } else if (ok) {  // an invalid pair adds nothing
        const float gscale = kMode == kPrRow ? g_own : Gs[st][r];
        const float sig = ez * fast_rcp(1.f + ez);
        const float dpre = gscale * (-alpha * sig) * (1.f - score * score);
        const float c1 = inv * dpre;
        m1 *= inv_h;
        m2 *= inv_h;
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          const float4 s4 = reinterpret_cast<const float4*>(Lns)[c * kPrLanes + sub];
          const float lns[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int e = 4 * c + k;
            // ddiff = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
            const float dd_e = c1 * fmaf(-x[e], m2, fmaf(qv[e], lns[k], -m1));
            if constexpr (kMode == kPrRow) {
              acc0[e] -= dd_e;
              acc1[e] = fmaf(dpre, qv[e] * x[e], acc1[e]);  // dln_s += dy xhat
            } else {
              acc0[e] += dd_e;
              acc1[e] = fmaf(dpre, qv[e], acc1[e]);         // dln_b += dy
              acc2[e] = fmaf(0.5f * dpre, gv[e], acc2[e]);  // dw_out += dpre gelu(y)
            }
          }
        }
        if (kMode == kPrRow) db_acc += dpre;
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // this warp's sums: the four pairs of a step, in a fixed order
  const long long out = ((long long)b * C + blockIdx.y) * N + p;
  if constexpr (kMode == kPrFwd) {
    loss_acc += __shfl_xor_sync(0xffffffffu, loss_acc, 8);
    loss_acc += __shfl_xor_sync(0xffffffffu, loss_acc, 16);
    cnt_acc += __shfl_xor_sync(0xffffffffu, cnt_acc, 8);
    cnt_acc += __shfl_xor_sync(0xffffffffu, cnt_acc, 16);
    if (own_ok && lane == 0) {
      sc.psum[out] = loss_acc;
      sc.pcnt[out] = cnt_acc;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      acc0[e] += __shfl_xor_sync(0xffffffffu, acc0[e], 8);
      acc0[e] += __shfl_xor_sync(0xffffffffu, acc0[e], 16);
      acc1[e] += __shfl_xor_sync(0xffffffffu, acc1[e], 8);
      acc1[e] += __shfl_xor_sync(0xffffffffu, acc1[e], 16);
      if constexpr (kMode == kPrCol) {
        acc2[e] += __shfl_xor_sync(0xffffffffu, acc2[e], 8);
        acc2[e] += __shfl_xor_sync(0xffffffffu, acc2[e], 16);
      }
    }
    if (kMode == kPrRow) {
      db_acc += __shfl_xor_sync(0xffffffffu, db_acc, 8);
      db_acc += __shfl_xor_sync(0xffffffffu, db_acc, 16);
    }
    if (own_ok && grp == 0) {
      float* dur = (kMode == kPrRow ? sc.du_row : sc.du_col) + out * kH;
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        reinterpret_cast<float4*>(dur)[c * kPrLanes + sub] =
            make_float4(acc0[4 * c], acc0[4 * c + 1], acc0[4 * c + 2], acc0[4 * c + 3]);
    }
    // this block's parameter-gradient partial: its warps summed in order. The
    // tiles are free now (the loop ended on a barrier).
    constexpr int kR = 2 * kH + 1;
    float* red = Us[0];
    static_assert(kW * kR <= 2 * kPrTile * kH, "the partials fit in the tile ring");
    if (grp == 0) {
      float* rw = red + warp * kR;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int d = (c * kPrLanes + sub) * 4 + k;
          const int e = 4 * c + k;
          // the row pass: dbias = -du, dln_s; the column pass: dln_b, dw_out
          if constexpr (kMode == kPrRow) {
            rw[d] = -acc0[e];
            rw[kH + d] = acc1[e];
          } else {
            rw[d] = acc1[e];
            rw[kH + d] = acc2[e];
          }
        }
      }
      if (lane == 0) rw[2 * kH] = db_acc;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kR; c += kThreadsB) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kW; ++wi) s += red[wi * kR + c];
      if (kMode == kPrRow)
        part[c < 2 * kH ? c : 4 * kH] = s;  // [dbias | dln_s | . | . | db_out]
      else if (c < 2 * kH)
        part[2 * kH + c] = s;  // [. | . | dln_b | dw_out | .]
    }
  }
}

// Forward: row n = idx[slot] gets the sum of its chunks' partials, in chunk
// order. One thread per (view, slot).
__global__ void pairwise_rank_finish_fwd(PrScratch sc, int N, int C,
                                         float* __restrict__ row_sum,
                                         float* __restrict__ row_cnt) {
  const int b = blockIdx.y;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const int nv = sc.nvalid[b];
  if (slot >= nv) return;
  const int used = (nv + pr_chunk_len(nv, C) - 1) / pr_chunk_len(nv, C);
  float s = 0.f, n = 0.f;
  for (int c = 0; c < used; ++c) {
    s += sc.psum[((long long)b * C + c) * N + slot];
    n += sc.pcnt[((long long)b * C + c) * N + slot];
  }
  const long long o = (long long)b * N + sc.idx[(long long)b * N + slot];
  row_sum[o] = s;
  row_cnt[o] = n;
}

// Backward: du[idx[slot]] is the sum over the chunks of the row-pass and
// column-pass partials, in chunk order. One thread per 16-byte vector.
__global__ void pairwise_rank_finish_du(PrScratch sc, int N, int h, int C,
                                        float* __restrict__ du) {
  const int b = blockIdx.y;
  const int h4 = h / 4;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int slot = i / h4;
  const int nv = sc.nvalid[b];
  if (slot >= nv) return;
  const int used = (nv + pr_chunk_len(nv, C) - 1) / pr_chunk_len(nv, C);
  float4 s = make_float4(0, 0, 0, 0);
  for (int c = 0; c < used; ++c) {
    const long long off = (((long long)b * C + c) * N + slot) * h4 + i % h4;
    const float4 r = reinterpret_cast<const float4*>(sc.du_row)[off];
    const float4 q = reinterpret_cast<const float4*>(sc.du_col)[off];
    s.x += r.x + q.x, s.y += r.y + q.y, s.z += r.z + q.z, s.w += r.w + q.w;
  }
  const long long o = (long long)b * N + sc.idx[(long long)b * N + slot];
  reinterpret_cast<float4*>(du)[o * h4 + i % h4] = s;
}

// Sums the per-block partials (n_blocks, P) column by column: one warp per
// column, lane l takes blocks l, l + 32, ... in order, then a fixed
// butterfly over the lanes.
__global__ void pairwise_rank_reduce(const float* __restrict__ partials, int n_blocks, int P,
                                     float* __restrict__ out) {
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= P) return;
  float acc = 0.f;
  for (int i = threadIdx.x & 31; i < n_blocks; i += 32) acc += partials[(long long)i * P + c];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) out[c] = acc;
}

template <int kMode, int kW>
void launch_pr(int h, int B, int N, int C, PrHead hd, PrScratch sc, cudaStream_t st) {
  const dim3 grid((N + kW - 1) / kW, C, B);
#define GD3D_PR_LAUNCH(PER) \
  pairwise_rank_kernel<PER, kMode, kW><<<grid, 32 * kW, 0, st>>>(hd, N, sc)
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
bool pr_shape_ok(int B, int N, int h, int C) {
  return B > 0 && N > 0 && C > 0 && (h == 32 || h == 64 || h == 96 || h == 128);
}
}  // namespace

// Floats of scratch that a forward (backward = 0) or a backward call needs
// when the streamed range is split into n_chunks.
extern "C" long long gd3d_pairwise_rank_scratch(int B, int N, int h, int n_chunks,
                                                int backward) {
  return gd3d::pr_scratch(nullptr, B, N, h, n_chunks, backward != 0).total;
}

extern "C" int gd3d_pairwise_rank_fwd(const void* u, const void* depths, const void* valid,
                                      const void* bias, const void* ln_s, const void* ln_b,
                                      const void* w_out, const void* b_out, void* row_sum,
                                      void* row_cnt, void* scratch, int B, int N, int h,
                                      int n_chunks, float thr, float eps, void* stream) {
  using namespace gd3d;
  if (!pr_shape_ok(B, N, h, n_chunks)) return static_cast<int>(cudaErrorInvalidValue);
  const PrHead hd{static_cast<const float*>(bias), static_cast<const float*>(ln_s),
                  static_cast<const float*>(ln_b), static_cast<const float*>(w_out),
                  static_cast<const float*>(b_out), thr, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PrScratch sc = pr_scratch(static_cast<float*>(scratch), B, N, h, n_chunks, false);
  float* sums = static_cast<float*>(row_sum);
  float* cnts = static_cast<float*>(row_cnt);
  pairwise_rank_prep<false>
      <<<dim3((N + kPrPrepRows - 1) / kPrPrepRows, B), 32 * kPrPrepRows, 0, st>>>(
          static_cast<const float*>(u), static_cast<const float*>(depths),
          static_cast<const float*>(valid), nullptr, N, h, sc, sums, cnts, nullptr);
  launch_pr<kPrFwd, kPrFwdWarps>(h, B, N, n_chunks, hd, sc, st);
  pairwise_rank_finish_fwd<<<dim3((N + 127) / 128, B), 128, 0, st>>>(sc, N, n_chunks, sums,
                                                                    cnts);
  return static_cast<int>(cudaGetLastError());
}

// param_grads: (4h + 1) = [dbias | dln_s | dln_b | dw_out | db_out].
extern "C" int gd3d_pairwise_rank_bwd(const void* u, const void* depths, const void* valid,
                                      const void* bias, const void* ln_s, const void* ln_b,
                                      const void* w_out, const void* b_out,
                                      const void* grad_rows, void* du, void* scratch,
                                      void* param_grads, int B, int N, int h, int n_chunks,
                                      float thr, float eps, void* stream) {
  using namespace gd3d;
  if (!pr_shape_ok(B, N, h, n_chunks)) return static_cast<int>(cudaErrorInvalidValue);
  const PrHead hd{static_cast<const float*>(bias), static_cast<const float*>(ln_s),
                  static_cast<const float*>(ln_b), static_cast<const float*>(w_out),
                  static_cast<const float*>(b_out), thr, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PrScratch sc = pr_scratch(static_cast<float*>(scratch), B, N, h, n_chunks, true);
  float* du_ = static_cast<float*>(du);
  pairwise_rank_prep<true>
      <<<dim3((N + kPrPrepRows - 1) / kPrPrepRows, B), 32 * kPrPrepRows, 0, st>>>(
          static_cast<const float*>(u), static_cast<const float*>(depths),
          static_cast<const float*>(valid), static_cast<const float*>(grad_rows), N, h, sc,
          nullptr, nullptr, du_);
  launch_pr<kPrRow, kPrBwdWarps>(h, B, N, n_chunks, hd, sc, st);
  launch_pr<kPrCol, kPrBwdWarps>(h, B, N, n_chunks, hd, sc, st);
  pairwise_rank_finish_du<<<dim3((N * (h / 4) + 127) / 128, B), 128, 0, st>>>(sc, N, h,
                                                                             n_chunks, du_);
  const int P = 4 * h + 1;
  const int n_blocks = B * ((N + kPrBwdWarps - 1) / kPrBwdWarps) * n_chunks;
  pairwise_rank_reduce<<<(P + 3) / 4, 128, 0, st>>>(sc.pparam, n_blocks, P,
                                                    static_cast<float*>(param_grads));
  return static_cast<int>(cudaGetLastError());
}
