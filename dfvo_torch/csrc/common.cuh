// Shared helpers for the dfvo_torch CUDA kernels.
//
// Every kernel is exported through a plain C function that takes raw device
// pointers, sizes, a dtype code and the CUDA stream, launches on that stream
// and returns cudaGetLastError() (0 on success). The Python wrappers
// (dfvo_torch/ops/) validate shapes, dtypes and contiguity before calling.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dfvo {

// dtype codes shared with dfvo_torch/ops/cuda_lib.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// elements of T in one 16-byte vector load
template <typename T>
inline constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// 16-byte load of consecutive channels, widened to f32. The caller
// guarantees 16-byte alignment (see vec_ok).
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// True when every pixel row of `channels` T values starting at `base` is
// 16-byte aligned, so the vector loads above may be used.
template <typename T>
inline bool vec_ok(const void* base, int channels) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
         (static_cast<long long>(channels) * sizeof(T)) % 16 == 0;
}

inline unsigned int ceil_div(long long a, long long b) {
  return static_cast<unsigned int>((a + b - 1) / b);
}

}  // namespace dfvo
