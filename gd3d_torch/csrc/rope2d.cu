// K5: 2D rotary position embedding (CroCo/DUSt3R flavour), forward and
// backward, on one or two token tensors per launch.
//
// Replaces gd3d/kernels/rope2d.py::_rope2d_call (body _rope2d_kernel),
// reached through rope2d_pallas. The head dim D splits into quarters of
// Q = D / 4: the first half rotates by the y position, the second by the x
// position, each as Q (u, v) pairs (u at quarter offset k, v at k + Q) by
// the angle pos * f0 / base^(k / Q). The backward is the same kernel with
// -f0 (a rotation by -theta is the transpose of the forward map), as in
// gd3d's custom_vjp (rope2d.py:98-99) and the reference's cuRoPE2D.
//
// What bounds it on an H100: memory. Every element is read once and written
// once (11.3 MB per tensor at the VGGT frame shape (2, 1374, 16, 64) in
// bf16, 3.4 us at 3.35 TB/s) and costs a few flops. So the design keeps the
// instructions per byte low and the bytes in flight high:
// - The angle depends on (token, half, k) and not on the head. A thread owns
//   kVec consecutive pairs of one half of one token, computes their
//   full-precision sincosf once, and rotates those pairs in up to kMaxHeads
//   heads from the registers (a token's H heads split into
//   ceil(H / kMaxHeads) equal groups, one thread per group). The fast
//   __sincosf is not used: VGGT's angles reach ~50 rad, where its error grows.
//   With 4 heads a thread, rather than 8 or all 16, twice or four times as
//   many threads share the latency of each launch's one round trip to
//   memory; on the H100 that was faster at every main-path shape, although
//   each angle is computed H / 4 times (kernels/sweep.py times 4, 8, 16).
// - inv_freq = f0 / base^(k / Q) depends on k alone: each block computes its
//   Q values once (powf, as the twin) into shared memory.
// - Wide accesses: the kVec u's of a head are one load of kVec * sizeof(T)
//   bytes (16 where D and the view allow), the kVec v's another. A thread
//   issues the loads of all its heads before it computes an angle, so each
//   thread has up to 2 * kMaxHeads * 16 bytes in flight.
// - Two tensors in one launch (q and k of an attention layer, which may have
//   different lengths and positions): the first task's blocks come first in
//   the grid, the second's after them.
// - 32-bit index arithmetic; the entry point refuses extents beyond 2^31.
//
// Layout: tokens are read through (b, n, h) element strides with a
// contiguous last dim, so the (B, N, H, D) views the models hand over
// (q = qkv[:, :, 0], or a (B, H, N, D) transpose of one) are read in place.
// The view's address and its strides must be multiples of the vector; the
// wrapper checks that (kernels/rope2d.py::vec_width) and so does the entry
// point. The output is a fresh (B, N, H, D)-contiguous tensor. Positions are
// (B, N, 2) integers read through strides (stride 0 over a broadcast batch).
// fp32 and bf16 tokens; the rotation runs in fp32 and rounds once.
#include "common.cuh"

namespace gd3d {

constexpr int kRopeThreads = 128;
#ifndef GD3D_ROPE_HEADS
#define GD3D_ROPE_HEADS 4
#endif
constexpr int kMaxHeads = GD3D_ROPE_HEADS;

struct RopeTask {
  const void* x;
  void* out;
  const long long* pos;
  int N, H;
  int xsb, xsn, xsh;  // element strides of the tokens
  int psb, psn, psc;  // element strides of the positions
  int heads;          // heads per group (<= kMaxHeads)
  int groups;         // ceil(H / heads)
  int threads;        // B * N * groups * D / (2 * kVec)
  int blocks;
};

template <int kBytes> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

template <typename T, int kVec>
using Raw = typename RawOf<kVec * static_cast<int>(sizeof(T))>::type;

template <typename T, int kVec>
__device__ __forceinline__ void unpack(const Raw<T, kVec>& r, float (&f)[kVec]) {
  T e[kVec];
  memcpy(e, &r, sizeof(r));
#pragma unroll
  for (int j = 0; j < kVec; ++j) f[j] = to_float(e[j]);
}

template <typename T, int kVec>
__device__ __forceinline__ Raw<T, kVec> pack(const float (&f)[kVec]) {
  T e[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) e[j] = from_float<T>(f[j]);
  Raw<T, kVec> r;
  memcpy(&r, e, sizeof(r));
  return r;
}

// One thread's work: kVec pairs (u at k0 + j, v at k0 + Q + j) of one half
// of one token, in the heads of one group. inv_freq (shared memory, Q
// floats) is written by the block's first threads before the barrier, which
// comes after this thread's loads are issued.
template <typename T, int kVec>
__device__ __forceinline__ void rope_block(const RopeTask& t, int block, int D,
                                           const float* inv_freq) {
  using R = Raw<T, kVec>;
  const int tid = block * kRopeThreads + threadIdx.x;
  const bool live = tid < t.threads;
  const int Q = D >> 2;
  const int chunks = D / (2 * kVec);  // threads per (token, group)
  const int chunk = tid % chunks;
  const int rest = tid / chunks;
  const int g = rest % t.groups;
  const int token = rest / t.groups;
  const int b = token / t.N;
  const int n = token - b * t.N;
  const int half_chunks = Q / kVec;
  const int half = chunk >= half_chunks;
  const int k0 = (chunk - half * half_chunks) * kVec;
  const int iu = half * 2 * Q + k0;
  const int h0 = g * t.heads;
  const int nh = live ? min(t.heads, t.H - h0) : 0;

  const T* x = static_cast<const T*>(t.x) + b * t.xsb + n * t.xsn + h0 * t.xsh;
  const float p = live ? static_cast<float>(t.pos[b * t.psb + n * t.psn + half * t.psc]) : 0.f;
  R u[kMaxHeads], v[kMaxHeads];
#pragma unroll
  for (int i = 0; i < kMaxHeads; ++i) {
    if (i < nh) {
      u[i] = *reinterpret_cast<const R*>(x + i * t.xsh + iu);
      v[i] = *reinterpret_cast<const R*>(x + i * t.xsh + iu + Q);
    }
  }
  __syncthreads();  // inv_freq is written

  float c[kVec], s[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) sincosf(p * inv_freq[k0 + j], &s[j], &c[j]);

  T* out = static_cast<T*>(t.out) + (token * t.H + h0) * D + iu;
#pragma unroll
  for (int i = 0; i < kMaxHeads; ++i) {
    if (i < nh) {
      float fu[kVec], fv[kVec], ou[kVec], ov[kVec];
      unpack<T, kVec>(u[i], fu);
      unpack<T, kVec>(v[i], fv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ou[j] = fu[j] * c[j] - fv[j] * s[j];
        ov[j] = fv[j] * c[j] + fu[j] * s[j];
      }
      *reinterpret_cast<R*>(out + i * D) = pack<T, kVec>(ou);
      *reinterpret_cast<R*>(out + i * D + Q) = pack<T, kVec>(ov);
    }
  }
}

// Dynamic shared memory: the Q values of inv_freq = f0 / base^(k / Q).
template <typename T, int kVec>
__global__ void __launch_bounds__(kRopeThreads)
rope2d_kernel(RopeTask t0, RopeTask t1, int D, float base, float f0) {
  extern __shared__ float inv_freq[];
  const int Q = D >> 2;
  for (int k = threadIdx.x; k < Q; k += kRopeThreads)
    inv_freq[k] = f0 / powf(base, static_cast<float>(k) / static_cast<float>(Q));
  // Branch on the block, not on a runtime-indexed parameter, so each task's
  // fields stay in the constant bank.
  if (static_cast<int>(blockIdx.x) < t0.blocks)
    rope_block<T, kVec>(t0, blockIdx.x, D, inv_freq);
  else
    rope_block<T, kVec>(t1, blockIdx.x - t0.blocks, D, inv_freq);
}

constexpr long long kMaxIndex = (1LL << 31) - 1;

// Fills task from the arguments; false if they are out of the kernel's range.
bool make_task(RopeTask& t, const void* x, void* out, const void* pos, int B, int N, int H,
               int D, int vec, int elt, long long xsb, long long xsn, long long xsh,
               long long psb, long long psn, long long psc) {
  if (B <= 0 || N <= 0 || H <= 0 || xsb < 0 || xsn < 0 || xsh < 0 || psb < 0 || psn < 0 ||
      psc < 0)
    return false;
  const long long x_extent = (B - 1) * xsb + (N - 1) * xsn + (H - 1) * xsh + D;
  const long long p_extent = (B - 1) * psb + (N - 1) * psn + psc + 1;
  const long long groups = (H + kMaxHeads - 1) / kMaxHeads;
  const long long threads = static_cast<long long>(B) * N * groups * (D / (2 * vec));
  if (x_extent > kMaxIndex || p_extent > kMaxIndex ||
      static_cast<long long>(B) * N * H * D > kMaxIndex || threads > kMaxIndex)
    return false;
  // the vector loads and stores need the address and every step on vec elements
  const long long vb = static_cast<long long>(vec) * elt;
  if (reinterpret_cast<uintptr_t>(x) % vb || reinterpret_cast<uintptr_t>(out) % vb ||
      (B > 1 && (xsb * elt) % vb) || (N > 1 && (xsn * elt) % vb) || (H > 1 && (xsh * elt) % vb))
    return false;
  t.x = x;
  t.out = out;
  t.pos = static_cast<const long long*>(pos);
  t.N = N;
  t.H = H;
  t.xsb = static_cast<int>(xsb);
  t.xsn = static_cast<int>(xsn);
  t.xsh = static_cast<int>(xsh);
  t.psb = static_cast<int>(psb);
  t.psn = static_cast<int>(psn);
  t.psc = static_cast<int>(psc);
  t.groups = static_cast<int>(groups);
  t.heads = (H + t.groups - 1) / t.groups;  // equal groups: 6 heads go 3 + 3
  t.threads = static_cast<int>(threads);
  t.blocks = static_cast<int>((threads + kRopeThreads - 1) / kRopeThreads);
  return true;
}

template <typename T, int kVec>
cudaError_t launch(const RopeTask& t0, const RopeTask& t1, int D, float base, float f0,
                   cudaStream_t st) {
  rope2d_kernel<T, kVec><<<t0.blocks + t1.blocks, kRopeThreads, (D / 4) * sizeof(float), st>>>(
      t0, t1, D, base, f0);
  return cudaGetLastError();
}

}  // namespace gd3d

// n_tasks = 1 rotates (x0, pos0) into out0; n_tasks = 2 also (x1, pos1) into
// out1, in the same launch. Both tensors share D, the dtype and the vector
// width vec (elements per access: 8, 4, 2 or 1 for bf16, 4, 2 or 1 for fp32,
// dividing D / 4).
extern "C" int gd3d_rope2d(int n_tasks, const void* x0, void* out0, const void* pos0, int B0,
                           int N0, int H0, long long xsb0, long long xsn0, long long xsh0,
                           long long psb0, long long psn0, long long psc0, const void* x1,
                           void* out1, const void* pos1, int B1, int N1, int H1,
                           long long xsb1, long long xsn1, long long xsh1, long long psb1,
                           long long psn1, long long psc1, int D, int vec, float base,
                           float f0, int is_bf16, void* stream) {
  using namespace gd3d;
  const int elt = is_bf16 ? 2 : 4;
  // D / 4 floats of inv_freq in shared memory: at most 16 KB
  if (D <= 0 || D % 4 != 0 || D > 4 * 4096 || vec <= 0 || (D / 4) % vec != 0 ||
      vec * elt > 16 || (vec & (vec - 1)) != 0 || n_tasks < 1 || n_tasks > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  RopeTask t0{}, t1{};
  if (!make_task(t0, x0, out0, pos0, B0, N0, H0, D, vec, elt, xsb0, xsn0, xsh0, psb0, psn0,
                 psc0) ||
      (n_tasks == 2 && !make_task(t1, x1, out1, pos1, B1, N1, H1, D, vec, elt, xsb1, xsn1,
                                  xsh1, psb1, psn1, psc1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(t0.blocks) + t1.blocks > kMaxIndex)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (vec) {
      case 8: return static_cast<int>(launch<__nv_bfloat16, 8>(t0, t1, D, base, f0, st));
      case 4: return static_cast<int>(launch<__nv_bfloat16, 4>(t0, t1, D, base, f0, st));
      case 2: return static_cast<int>(launch<__nv_bfloat16, 2>(t0, t1, D, base, f0, st));
      default: return static_cast<int>(launch<__nv_bfloat16, 1>(t0, t1, D, base, f0, st));
    }
  }
  switch (vec) {
    case 4: return static_cast<int>(launch<float, 4>(t0, t1, D, base, f0, st));
    case 2: return static_cast<int>(launch<float, 2>(t0, t1, D, base, f0, st));
    default: return static_cast<int>(launch<float, 1>(t0, t1, D, base, f0, st));
  }
}
