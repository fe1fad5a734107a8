// K1 in bf16 above head dim 256 (256 < D <= 768): the flash-attention
// forward with the row log-sum-exp, on thread-block clusters that split the
// head dim (flash_fwd_cluster.cuh), each CTA on TMA and wgmma as
// flash_fwd_sm90.cu runs the widths up to 256. gd3d_flash_fwd
// (flash_fwd.cu) sends bf16 at these head dims here; past 768 (the inbox
// below holds two peers' parts) they run on flash_chunked.cu.
//
// Replaces, as the rest of K1 does, the stock TPU Pallas flash forward that
// gd3d calls through gd3d/ops/attention.py::_flash_call, which takes any
// head dim. No model of the repo goes past 128, so no path launches it.
//
// What bounds it on an H100: arithmetic. At (1, 4161, 3, 512) the two
// products are 106 GFLOP (the same as (2, 4161, 3, 256)) against 26 MB of
// q, k, v and o: 0.108 ms at 989 TFLOP/s, 0.008 ms at 3.35 TB/s.
//
// The design. A cluster of G = ceil(D / 256) CTAs (flash_fwd_cluster.cuh,
// split: 192 or 256 columns a CTA) takes 64 query rows of one (b, h). A CTA
// is flash_fwd_sm90.cu's one-consumer plan at its width (a producer
// warpgroup whose one thread copies Q once and then 64-key tiles of K and V
// by TMA into a two-stage ring of mbarriers; a consumer warpgroup that
// issues S over its columns and P V of the tile before together), with one
// change: between S and the softmax, the consumer warps exchange their
// parts of S through distributed shared memory, while P V runs. Warp w
// (16 rows x 64 keys, 32 floats a thread) pushes its part by st.async into
// its slot of every peer's inbox (two inboxes, alternating by tile, of a
// 16 KB slot for each peer); the bytes complete the peer warp w's full
// barrier, which that warp arms with the bytes it expects. It waits for its
// own, sums the G parts in rank order (its own from registers), and tells
// each peer it has read its slot (an arrival without a cluster-scope
// release: the values are already in registers), which the peer waits for
// before it pushes into that inbox again two tiles later. So a warp waits
// only for its own rows' parts. Every CTA then holds the same bits of S,
// runs the same softmax, and accumulates O over its own columns (m64n192k16
// or m64n256k16 with P from registers); rank 0 writes the LSE. Shared
// memory at 256 columns: 32 KB of Q, 128 KB of K and V, 64 KB of inbox, 1
// block an SM, 242 registers (199 at 192). At (2, 673, 2, 512) the grid is
// 11 x 2 clusters x 2 x 2 = 88 CTAs, at (1, 4161, 3, 512) 396 (three
// waves of 132).
//
// Measured (python3 -m gd3d_torch.kernels.sweep k1wide on NVIDIA H100 80GB
// HBM3, 700.00 W; ms at (2, 673, 2, 512) / (1, 4161, 3, 512)): this design
// 0.0391 / 0.506 (SDPA 0.0662 / 0.818). The exchange is most of the time:
// the same kernel with none (wrong sums, timing only) 0.0244 / 0.282. Pulling
// the peers' parts (plain stores, an arrival with a cluster-scope release,
// a wait with a cluster-scope acquire, ld.shared::cluster) took 0.0517 /
// 0.754, 0.0456 / 0.647 with the read-done arrival weakened as here; without
// the waits, or with local loads in place of the remote ones, it was no
// faster, but without the cluster-scope release and acquire (not a correct
// kernel) 0.0445 / 0.630: the fences cost, not the bytes or the waiting.
// Issuing S of the next tile before the exchange (to hide it) was slower,
// 0.0564 / 0.805 (more registers live, and little latency to hide).
//
// Layout: q, k, v are (B, N|M, H, D) bf16 views, D a multiple of 8 (the
// wrapper zero-pads any other D), read by TMA through their strides (their
// addresses and (B, N, H) steps on 16 bytes: the wrapper copies a view that
// is not); rows past N or M and columns past D arrive as zeros, keys past M
// score -inf, rows past N are not stored. No atomics: two runs give the
// same bits.
#include "flash_fwd_cluster.cuh"
#include "sm90.cuh"

namespace gd3d {
namespace cluster {

template <int kDc>
struct Bf16Plan {
  static_assert(kDc == 192 || kDc == 256, "192 or 256 columns a CTA");
  static constexpr int kKeys = 64;    // keys a tile
  static constexpr int kStages = 2;   // K and V tiles in flight
  static constexpr int kPanels = kDc / 64;
  static constexpr int kQPanel = 64 * sm90::kRowBytes;     // a panel of the Q tile
  static constexpr int kPanel = kKeys * sm90::kRowBytes;   // a panel of a K or V tile
  static constexpr int kTileBytes = kPanels * kPanel;
  static constexpr int kXBytes = 128 * (kKeys / 2) * 4;    // the warpgroup's S: 16 KB
  static constexpr int kInbox = (kMaxCtasBf16 - 1) * kXBytes;  // a tile's parts from the peers
  static constexpr int kK = kPanels * kQPanel;             // shared memory: Q, K, V, inbox
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kX = kV + kStages * kTileBytes;
  static constexpr int kSmem = kX + 2 * kInbox + 1024;     // + alignment slack
};

// Rows row0 .. row0 + 63 of the kPanels panels of columns col0 on into a
// tile whose panels are kPanel bytes apart, completing on `bar`.
template <int kPanels, int kPanel>
__device__ __forceinline__ void tma_cols(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int col0, int row0, int h, int b) {
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
    sm90::tma_load(dst + p * kPanel, map, bar, col0 + 64 * p, row0, h, b);
}

template <int kDc>
__global__ void __launch_bounds__(256, 1)
flash_fwd_cluster_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, sm90::bf16* __restrict__ o,
                              float* __restrict__ lse, int N, int M, int H, int D, Strides os,
                              float scale_log2) {
  using L = Bf16Plan<kDc>;
  using namespace sm90;
  constexpr int kKeys = L::kKeys, kS = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // q_full, then per stage k_full, v_full, k_empty, v_empty
  __shared__ __align__(8) uint64_t bars[1 + 4 * kS];
  // the exchange: full, then empty, per buffer and consumer warp
  __shared__ __align__(8) uint64_t xbars[2 * 2 * 4];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + L::kK;
  const uint32_t sV = sQ + L::kV;
  const uint32_t sX = sQ + L::kX;
  const uint32_t q_full = smem_u32(bars);
  auto bar = [&](int kind, int s) { return q_full + 8 * (1 + kind * kS + s); };
  auto xbar = [&](int kind, int buf, int w) { return smem_u32(xbars) + 8 * (kind * 8 + buf * 4 + w); };
  const int ctas = size();
  const int me = rank();
  const int col0 = me * kDc;  // this CTA's first column
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x / ctas * 64;
  const int n_tiles = (M + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 1);
      mbar_init(bar(2, s), 128);
      mbar_init(bar(3, s), 128);
    }
    for (int i = 0; i < 8; ++i) {
      bar_init(smem_u32(xbars) + 8 * i, 1);             // full: this warp's expect_tx
      bar_init(smem_u32(xbars) + 8 * (8 + i), ctas - 1);  // empty: each peer's warp read it
    }
    fence_bar_init();
  }
  cluster::sync();  // every CTA's barriers are set before a peer arrives on them

  if (threadIdx.x < 128) {  // the producer warpgroup
    if (threadIdx.x == 0) {
      prefetch_map(tq);
      prefetch_map(tk);
      prefetch_map(tv);
      mbar_arrive_tx(q_full, L::kK);
      tma_cols<L::kPanels, L::kQPanel>(sQ, tq, q_full, col0, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kS;
        const uint32_t ph = (j / kS) & 1;
        const uint32_t off = s * L::kTileBytes;
        mbar_wait(bar(2, s), ph ^ 1);
        mbar_arrive_tx(bar(0, s), L::kTileBytes);
        tma_cols<L::kPanels, L::kPanel>(sK + off, tk, bar(0, s), col0, j * kKeys, h, b);
        mbar_wait(bar(3, s), ph ^ 1);
        mbar_arrive_tx(bar(1, s), L::kTileBytes);
        tma_cols<L::kPanels, L::kPanel>(sV + off, tv, bar(1, s), col0, j * kKeys, h, b);
      }
    }
  } else {  // the consumer warpgroup: 64 query rows, this CTA's columns of O
    const int ct = threadIdx.x - 128;
    const int warp = ct / 32;
    const int lane = ct % 32;
    const int t = lane & 3;
    float acc[kDc / 2];  // O, 64 rows x kDc columns
#pragma unroll
    for (int i = 0; i < kDc / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, raw scores
    float l[2] = {0.f, 0.f};              // this lane's part of the row sums
    float sc[kKeys / 2];                  // S, 64 rows x kKeys keys; then P
    uint32_t pa[kKeys / 16][4];           // P in bf16: the A fragments of P V

    // S of tile j over the cluster. This thread's 32 floats of this CTA's
    // part go by st.async into every peer's inbox j % 2, in the slot that
    // holds this CTA's parts (float4 i at i * 2048 bytes, so a warp's
    // stores and loads are 512 contiguous bytes), once every peer has read
    // tile j - 2 from it; the bytes complete the phase of the peer warp's
    // full barrier, which that warp armed with the bytes it expects. The G
    // parts are summed in rank order, this CTA's from registers.
    auto exchange = [&](int j) {
      const int buf = j & 1;
      const uint32_t ph = (j >> 1) & 1;
      const uint32_t box = sX + buf * L::kInbox + ct * 16;  // + slot * kXBytes + i * 2048
      const uint32_t full = xbar(0, buf, warp);
      wait_cta(xbar(1, buf, warp), ph ^ 1);
      for (int c = 0; c < ctas; ++c) {
        if (c == me) continue;
        const uint32_t slot = box + (me < c ? me : me - 1) * L::kXBytes;
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i)
          st_async4(slot + i * 2048, full, c, sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                    sc[4 * i + 3]);
      }
      if (lane == 0) mbar_arrive_tx(full, (ctas - 1) * 32 * (kKeys / 2) * 4);
      wait_cta(full, ph);
      auto part = [&](float (&y)[4], int c, int i) {  // float4 i of CTA c's part
        if (c == me) {
#pragma unroll
          for (int e = 0; e < 4; ++e) y[e] = sc[4 * i + e];
        } else {
          ld4_own(y, box + (c < me ? c : c - 1) * L::kXBytes + i * 2048);
        }
      };
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
        float x[4];
        part(x, 0, i);
        for (int c = 1; c < ctas; ++c) {
          float y[4];
          part(y, c, i);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] += y[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * i + e] = x[e];
      }
      __syncwarp();
      if (lane == 0)
        for (int c = 0; c < ctas; ++c)
          if (c != me) arrive_read(xbar(1, buf, warp), c);
    };
    // Softmax of tile j in place: keys past M score -inf, the running max
    // and sum advance; sets corr to the factor that rescales what O holds.
    // Every tile holds a real key, so the new max is finite.
    auto softmax = [&](int j, float (&corr)[2]) {
      const int k0 = j * kKeys;
      if (k0 + kKeys > M) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i)
          if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= M) sc[i] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        ms[r] = mx[r] * scale_log2;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const float p = fast_exp2(fmaf(sc[i], scale_log2, -ms[(i >> 1) & 1]));
        l[(i >> 1) & 1] += p;
        sc[i] = p;
      }
    };
    auto issue_s = [&](int j) {
      const uint32_t kt = sK + (j % kS) * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kDc / 16; ++kk)
        wgmma_ss<kKeys>(sc, desc_k<L::kQPanel>(sQ, kk), desc_k<L::kPanel>(kt, kk), kk);
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {
      const uint32_t vt = sV + (j % kS) * L::kTileBytes;
      mbar_wait(bar(1, j % kS), (j / kS) & 1);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs<kDc, 1>(acc, pa[kk], desc_mn<L::kPanel>(vt, kk), 1);
      wgmma_commit();
    };
    auto to_fragments = [&] {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) a_from_acc(pa[kk], sc, kk);
    };

    // S of tile j + 1 and P V of tile j are issued together; the exchange
    // and the softmax of tile j + 1 run while P V does
    mbar_wait(q_full, 0);
    float corr[2];
    mbar_wait(bar(0, 0), 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(bar(2, 0));
    exchange(0);
    softmax(0, corr);
    to_fragments();
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kS;
      mbar_wait(bar(0, s), (j / kS) & 1);
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      mbar_arrive(bar(2, s));
      exchange(j);
      softmax(j, corr);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar(3, (j - 1) % kS));
#pragma unroll
      for (int i = 0; i < kDc / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      to_fragments();
    }
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar(3, (n_tiles - 1) % kS));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row0 = q0 + warp * 16;
    store_acc<kDc>(acc, 1.f / l[0], 1.f / l[1], o + b * os.b + h * os.h + col0, os.n, row0, N,
                   D - col0, lane);
    if (me == 0 && t == 0) {
      float* lse_bh = lse + ((long long)b * H + h) * N;
      const int n = row0 + (lane >> 2);
      if (n < N) lse_bh[n] = (m[0] * scale_log2 + log2f(l[0])) * kLn2;
      if (n + 8 < N) lse_bh[n + 8] = (m[1] * scale_log2 + log2f(l[1])) * kLn2;
    }
  }
  __syncwarp();
  cluster::sync();  // no CTA leaves while a peer may still read its exchange buffers
}

template <int kDc>
static cudaError_t launch_bf16(const CUtensorMap* maps, void* o, void* lse, int B, int N, int M,
                               int H, int D, Strides os, float scale, int ctas,
                               cudaStream_t stream) {
  const dim3 grid((N + 63) / 64 * ctas, H, B);
  Launch launch(grid, 256, Bf16Plan<kDc>::kSmem, ctas, stream);
  return launch(flash_fwd_cluster_sm90_kernel<kDc>, maps[0], maps[1], maps[2],
                static_cast<sm90::bf16*>(o), static_cast<float*>(lse), N, M, H, D, os,
                scale * kLog2e);
}

cudaError_t launch_fwd_cluster_bf16(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int N, int M, int H, int D, Strides qs,
                                    Strides ks, Strides vs, Strides os, float scale,
                                    cudaStream_t stream) {
  if (D <= 256 || D > kMaxDBf16 || D % 8 != 0) return cudaErrorInvalidValue;
  CUtensorMap maps[3];  // q, k, v, each at its true head dim
  if (!sm90::encode_map(&maps[0], q, B, N, H, D, qs) ||
      !sm90::encode_map(&maps[1], k, B, M, H, D, ks) ||
      !sm90::encode_map(&maps[2], v, B, M, H, D, vs))
    return cudaErrorInvalidValue;
  const Split sp = split(D);
  if (sp.cols == 192)
    return launch_bf16<192>(maps, o, lse, B, N, M, H, D, os, scale, sp.ctas, stream);
  return launch_bf16<256>(maps, o, lse, B, N, M, H, D, os, scale, sp.ctas, stream);
}

}  // namespace cluster
}  // namespace gd3d
