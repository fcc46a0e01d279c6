// Local cost volume (LiteFlowNet / HD3 correlation), stride 1.
//
// Replaces the Pallas TPU kernels _pallas_corr_stride1 and
// _pallas_corr_rowchunk (dfvo_tpu/ops/pallas_corr.py). The TPU needed the
// row-banded variant only to fit VMEM; on Hopper one kernel covers every size.
//
//   out[n,y,x,(dy+D)*(2D+1)+(dx+D)] = (1/C) * sum_c f1[n,y,x,c] * f2[n,y+dy,x+dx,c]
//
// with f2 zero outside the image, D in {3, 4}, NHWC inputs in f32 or bf16,
// f32 accumulation, and output in the input dtype. Stride 2 is handled by the
// wrapper (dfvo_torch/ops/pallas_corr.py), which subsamples both maps.
//
// What bounds it on the H100: about 2 flops per element read, so memory, not
// arithmetic. Device memory traffic is f1 + f2 + out once each, because the
// (2D+1)^2 re-reads of f2 by neighbouring pixels hit L1/L2; the limit of this
// design is L1 load bandwidth for those re-reads.
// Design: one warp per output pixel. The warp stages its f1 row once in
// shared memory as f32. Lane l then owns displacements l, l+32, ...: it walks
// the channels of its displaced f2 row with 16-byte vector loads (8 bf16 or 4
// f32 channels) while every lane reads the same f1 words from shared memory
// (a broadcast), so no cross-lane reduction is needed. The (2D+1)^2 outputs
// of a pixel are written by consecutive lanes (coalesced). Out-of-image
// displacements are skipped by a bounds check, so no padded copy of f2
// exists. Channel counts that do not fill 16-byte vectors take a scalar loop.
// Tiling f2 through shared memory (or TMA) is the next step for speed.

#include "common.cuh"

namespace dfvo {

constexpr int kCorrWarps = 8;  // pixels (warps) per block
constexpr int kCorrMaxChannels = 1536;  // 8 warps x 1536 x 4 B = 48 KB smem

template <typename T, bool VEC>
__device__ __forceinline__ float dot_row(const float* __restrict__ row,
                                         const T* __restrict__ bp, int c) {
  float s = 0.f;
  if constexpr (VEC) {
    constexpr int E = kVec<T>;
    for (int ci = 0; ci < c; ci += E) {
      float v[E];
      load16(bp + ci, v);
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(row + ci + e);
        s += a.x * v[e] + a.y * v[e + 1] + a.z * v[e + 2] + a.w * v[e + 3];
      }
    }
  } else {
    for (int ci = 0; ci < c; ++ci) s += row[ci] * to_f32(bp[ci]);
  }
  return s;
}

template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(kCorrWarps * 32)
    correlation_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                       T* __restrict__ out, int n, int h, int w, int c,
                       float inv_c) {
  constexpr int K = 2 * D + 1;
  constexpr int KK = K * K;
  constexpr int ROUNDS = (KK + 31) / 32;
  extern __shared__ float4 corr_smem[];  // float4: 16-byte aligned rows

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pix = static_cast<long long>(blockIdx.x) * kCorrWarps + warp;
  const long long total = static_cast<long long>(n) * h * w;
  if (pix >= total) return;  // whole warp leaves together

  float* row = reinterpret_cast<float*>(corr_smem) + warp * c;
  const T* a = f1 + pix * c;
  for (int ci = lane; ci < c; ci += 32) row[ci] = to_f32(a[ci]);
  __syncwarp();

  const int x = static_cast<int>(pix % w);
  const int y = static_cast<int>((pix / w) % h);
  const long long b = pix / (static_cast<long long>(w) * h);
  T* o = out + pix * KK;

#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int k = r * 32 + lane;
    if (k < KK) {
      const int yy = y + k / K - D;
      const int xx = x + k % K - D;
      float s = 0.f;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        s = dot_row<T, VEC>(row, f2 + ((b * h + yy) * w + xx) * c, c);
      o[k] = from_f32<T>(s * inv_c);
    }
  }
}

template <typename T, int D>
static void launch_correlation_d(const void* f1, const void* f2, void* out,
                                 int n, int h, int w, int c,
                                 cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * h * w;
  const dim3 grid(ceil_div(total, kCorrWarps));
  const dim3 block(kCorrWarps * 32);
  const size_t smem = sizeof(float) * kCorrWarps * c;
  const float inv_c = 1.f / static_cast<float>(c);
  const T* a = static_cast<const T*>(f1);
  const T* b = static_cast<const T*>(f2);
  T* o = static_cast<T*>(out);
  // vector path: 16-byte f2 rows, and f1 rows in shared memory that stay
  // 16-byte aligned (c a multiple of 4 floats)
  if (vec_ok<T>(f2, c) && c % 4 == 0)
    correlation_kernel<T, D, true><<<grid, block, smem, stream>>>(a, b, o, n, h, w, c, inv_c);
  else
    correlation_kernel<T, D, false><<<grid, block, smem, stream>>>(a, b, o, n, h, w, c, inv_c);
}

template <typename T>
static void launch_correlation(const void* f1, const void* f2, void* out,
                               int n, int h, int w, int c, int max_disp,
                               cudaStream_t stream) {
  if (max_disp == 3)
    launch_correlation_d<T, 3>(f1, f2, out, n, h, w, c, stream);
  else
    launch_correlation_d<T, 4>(f1, f2, out, n, h, w, c, stream);
}

}  // namespace dfvo

extern "C" int dfvo_correlation(const void* f1, const void* f2, void* out,
                                int n, int h, int w, int c, int max_disp,
                                int dtype, void* stream) {
  using namespace dfvo;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > kCorrMaxChannels ||
      (max_disp != 3 && max_disp != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_correlation<float>(f1, f2, out, n, h, w, c, max_disp, s);
  else if (dtype == kBFloat16)
    launch_correlation<__nv_bfloat16>(f1, f2, out, n, h, w, c, max_disp, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
