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

// ---- tensor-core building blocks (inline PTX, sm_80+ forms) ----

// 16-byte asynchronous copy global -> shared. With valid == false nothing is
// read and the 16 bytes are zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// Four (x4) or two (x2) 8x8 b16 matrices from shared memory. Lane l gives
// the address of row l % 8 of matrix l / 8; each row is 16 bytes, 16-byte
// aligned.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s)
               : "memory");
}

// d += a * b for one m16n8k16 tile, bf16 inputs, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4):
//   a[0..3]: A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]
//   b0, b1:  B[2t..2t+1][g], B[2t+8..2t+9][g]  (lower k in the low half)
//   d[0..3]: D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  const __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Allow a kernel more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace dfvo
