// K5: 2D rotary position embedding (CroCo/DUSt3R flavour), forward and
// backward.
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
// once (about 11 MB per call at the VGGT frame shape (2, 1374, 16, 64) in
// bf16, 3.4 us at 3.35 TB/s) and costs a few flops, so the angles are
// computed in registers (one sincosf per rotated pair) and no cos/sin table
// goes to device memory. One thread owns one (u, v) pair; neighbouring
// threads own neighbouring k, so loads and stores of a quarter coalesce.
//
// Layout: tokens are (B, N, H, D) element strides (b, n, h) with a
// contiguous last dim, so the (B, N, H, D) views the models hand over
// (q = qkv[:, :, 0], or a (B, H, N, D) transpose of one) are read in place
// without a transpose copy. The output is written through its own strides.
// Positions are (B, N, 2) integers read through strides (stride 0 over a
// broadcast batch). fp32 and bf16 tokens; the rotation runs in fp32 and
// rounds once. Grid: ceil(B * N * H * D / 2 / 256) blocks of 256 threads.
#include "common.cuh"

namespace gd3d {

constexpr int kRopeThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRopeThreads)
rope2d_kernel(const T* __restrict__ x, T* __restrict__ out,
              const long long* __restrict__ pos, int N, int H, int Q, Strides xs,
              Strides os, long long psb, long long psn, long long psc, float base,
              float f0, int total) {
  const int t = blockIdx.x * kRopeThreads + threadIdx.x;
  if (t >= total) return;
  const int two_q = 2 * Q;
  const int kk = t % two_q;  // pair index within the row: [0, Q) y, [Q, 2Q) x
  int r = t / two_q;
  const int h = r % H;
  r /= H;
  const int n = r % N;
  const int b = r / N;
  const int half = kk / Q;
  const int k = kk - half * Q;

  const float p = static_cast<float>(pos[b * psb + n * psn + half * psc]);
  const float inv_freq = f0 / powf(base, static_cast<float>(k) / static_cast<float>(Q));
  float s, c;
  sincosf(p * inv_freq, &s, &c);

  const int iu = half * two_q + k;
  const int iv = iu + Q;
  const T* xr = x + b * xs.b + n * xs.n + h * xs.h;
  T* orow = out + b * os.b + n * os.n + h * os.h;
  const float u = to_float(xr[iu]);
  const float v = to_float(xr[iv]);
  orow[iu] = from_float<T>(u * c - v * s);
  orow[iv] = from_float<T>(v * c + u * s);
}

}  // namespace gd3d

extern "C" int gd3d_rope2d(const void* x, void* out, const void* pos, int B, int N, int H,
                           int D, long long xsb, long long xsn, long long xsh,
                           long long osb, long long osn, long long osh, long long psb,
                           long long psn, long long psc, float base, float f0, int is_bf16,
                           void* stream) {
  using namespace gd3d;
  const long long total = static_cast<long long>(B) * N * H * (D / 2);
  if (D % 4 != 0 || B <= 0 || N <= 0 || H <= 0 || total >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{xsb, xsn, xsh}, os{osb, osn, osh};
  const int blocks = static_cast<int>((total + kRopeThreads - 1) / kRopeThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* p = static_cast<const long long*>(pos);
  if (is_bf16)
    rope2d_kernel<__nv_bfloat16><<<blocks, kRopeThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), p, N, H,
        D / 4, xs, os, psb, psn, psc, base, f0, static_cast<int>(total));
  else
    rope2d_kernel<float><<<blocks, kRopeThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), p, N, H, D / 4, xs, os, psb,
        psn, psc, base, f0, static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}
