// LiteFlowNet Regularization: confidence-weighted k x k flow filter.
//
// Replaces the Pallas TPU kernel _regfilter_pallas
// (dfvo_tpu/ops/regfilter.py).
//
//   out_x = (bx + sum_j dist_j * wx_j * flow_x(p + off_j)) / sum_j dist_j
//   out_y = (by + sum_j dist_j * wy_j * flow_y(p + off_j)) / sum_j dist_j
//
// dist is [N,H,W,k*k] with ky-major taps, flow [N,H,W,2], both f32 or both
// bf16; flow reads outside the image are zero; sums in f32, one division at
// the end; output in the flow's dtype. k in {3, 5, 7}. Unlike the TPU kernel
// there are no padded rows (that kernel padded dist with 1.0 only to keep its
// pad rows finite), so the result equals the unpadded op everywhere.
//
// What bounds it on the H100: about 5 flops per dist element read once, so
// device-memory bandwidth on dist (k*k values per pixel) dominates.
// Design: one thread per output pixel, 128 consecutive pixels per block. The
// block first copies its 128*k*k dist values into shared memory with
// coalesced loads (the per-pixel taps are contiguous, so thread-per-pixel
// reads straight from global memory would stride by k*k elements); the odd
// k*k stride then makes the per-thread shared-memory reads bank-conflict
// free. The 2*k*k + 2 filter weights sit in shared memory too. The flow
// reads of neighbouring pixels overlap and are served by L1.

#include "common.cuh"

namespace dfvo {

constexpr int kRegBlock = 128;

template <typename T, int K>
__global__ void __launch_bounds__(kRegBlock)
    regfilter_kernel(const T* __restrict__ dist, const T* __restrict__ flow,
                     const float* __restrict__ wts, T* __restrict__ out, int n,
                     int h, int w) {
  constexpr int KK = K * K;
  constexpr int P = (K - 1) / 2;
  __shared__ float sw[2 * KK + 2];
  __shared__ float sd[kRegBlock * KK];

  const long long total = static_cast<long long>(n) * h * w;
  const long long p0 = static_cast<long long>(blockIdx.x) * kRegBlock;
  const int npix = static_cast<int>(min(static_cast<long long>(kRegBlock), total - p0));

  for (int i = threadIdx.x; i < 2 * KK + 2; i += kRegBlock) sw[i] = wts[i];
  const T* dsrc = dist + p0 * KK;
  for (int i = threadIdx.x; i < npix * KK; i += kRegBlock) sd[i] = to_f32(dsrc[i]);
  __syncthreads();
  if (threadIdx.x >= npix) return;

  const long long pix = p0 + threadIdx.x;
  const int x = static_cast<int>(pix % w);
  const int y = static_cast<int>((pix / w) % h);
  const long long b = pix / (static_cast<long long>(w) * h);
  const float* d = sd + threadIdx.x * KK;

  float ax = 0.f, ay = 0.f, den = 0.f;
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    const float dj = d[j];
    den += dj;
    const int yy = y + j / K - P;
    const int xx = x + j % K - P;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
      const T* f = flow + ((b * h + yy) * w + xx) * 2;
      ax += dj * sw[j] * to_f32(f[0]);
      ay += dj * sw[KK + j] * to_f32(f[1]);
    }
  }
  const float inv = 1.f / den;
  out[pix * 2] = from_f32<T>((ax + sw[2 * KK]) * inv);
  out[pix * 2 + 1] = from_f32<T>((ay + sw[2 * KK + 1]) * inv);
}

template <typename T>
static void launch_regfilter(const void* dist, const void* flow,
                             const void* wts, void* out, int n, int h, int w,
                             int k, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * h * w;
  const dim3 grid(ceil_div(total, kRegBlock));
  const T* d = static_cast<const T*>(dist);
  const T* f = static_cast<const T*>(flow);
  const float* wv = static_cast<const float*>(wts);
  T* o = static_cast<T*>(out);
  if (k == 3)
    regfilter_kernel<T, 3><<<grid, kRegBlock, 0, stream>>>(d, f, wv, o, n, h, w);
  else if (k == 5)
    regfilter_kernel<T, 5><<<grid, kRegBlock, 0, stream>>>(d, f, wv, o, n, h, w);
  else
    regfilter_kernel<T, 7><<<grid, kRegBlock, 0, stream>>>(d, f, wv, o, n, h, w);
}

}  // namespace dfvo

// wts: f32 device array [wx (k*k), wy (k*k), bx, by].
extern "C" int dfvo_regfilter(const void* dist, const void* flow,
                              const void* wts, void* out, int n, int h, int w,
                              int k, int dtype, void* stream) {
  using namespace dfvo;
  if (n <= 0 || h <= 0 || w <= 0 || (k != 3 && k != 5 && k != 7))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_regfilter<float>(dist, flow, wts, out, n, h, w, k, s);
  else if (dtype == kBFloat16)
    launch_regfilter<__nv_bfloat16>(dist, flow, wts, out, n, h, w, k, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
