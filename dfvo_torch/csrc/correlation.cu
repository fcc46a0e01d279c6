// Local cost volume (LiteFlowNet / HD3 correlation), stride 1.
//
// Replaces the Pallas TPU kernels _pallas_corr_stride1 and
// _pallas_corr_rowchunk (dfvo_tpu/ops/pallas_corr.py). The TPU needed the
// row-banded variant only to fit VMEM; on Hopper one kernel covers every size.
//
//   out[n,y,x,(dy+D)*(2D+1)+(dx+D)] = (1/C) * sum_c f1[n,y,x,c] * f2[n,y+dy,x+dx,c]
//
// with f2 zero outside the image, D in {3, 4}, NHWC inputs read through
// their N/H/W element strides (channel stride 1), f32 accumulation, and a
// dense output in the input dtype. Stride 2 is handled by the wrapper
// (dfvo_torch/ops/pallas_corr.py), which passes the [::2, ::2] views as they
// are, without a copy. Two variants:
//
// tensor_core (dfvo_correlation_tc): the bf16 main path; C a multiple of 16
// up to 256, 16-byte aligned pixels. What bounds it on the H100: device
// memory, f1 + f2 + out once each (at level 2 with N = 64, 174 MB: 52 us at
// 3.35 TB/s); the 2 * 49 * C flops per pixel are 3 GFLOP there. Design: a
// block owns TH x 32 output pixels of one item. It stages the f1 tile
// (TH x 32 x C) and the f2 tile with its halo ((TH+2D) x 40 x C, zero-filled
// outside the image) in shared memory by cp.async, once. For each output row,
// 16-pixel m-tile and dy, a warp runs the banded GEMM
//   P[x, x'] = sum_c f1[y, x, c] * f2[y+dy, x', c],  x' in x0-D .. x0-D+23
// as three m16n8k16 n-tiles (bf16 in, f32 accumulate, A and B fragments by
// ldmatrix straight from the staged pixels) and keeps the 2D+1 diagonals
// x' - x = dx: 7 of every 24 products, about 11 us of tensor time at level 2,
// N = 64. The channel loop is outermost, so an f1 fragment is loaded once
// for all 2D+1 rows of f2 (shared-memory reads bound this design, see
// PERF.md). The 49 (or 81) outputs of each pixel are staged in shared memory
// so that the store to `out` is one contiguous run of 16-byte vectors per
// tile row.
// The staged pixel pitch is C + 8 elements, which keeps the eight 16-byte
// rows of every ldmatrix on distinct banks.
//
// cuda_core (dfvo_correlation): float32, C not a multiple of 16 and
// unaligned bases. One warp per output pixel: the warp stages its f1 row
// once in shared memory as f32; lane l owns displacements l, l+32, ... and
// walks the channels of its displaced f2 row with 16-byte vector loads where
// aligned (else a scalar loop) while every lane reads the same f1 words (a
// broadcast); the (2D+1)^2 outputs of a pixel are written by consecutive
// lanes. The f2 re-reads are served by L1.

#include <algorithm>

#include "common.cuh"

namespace dfvo {

// ---- cuda_core variant ----

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
    correlation_kernel(const T* __restrict__ f1, PixStrides s1,
                       const T* __restrict__ f2, PixStrides s2,
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
  const int x = static_cast<int>(pix % w);
  const int y = static_cast<int>((pix / w) % h);
  const long long b = pix / (static_cast<long long>(w) * h);

  float* row = reinterpret_cast<float*>(corr_smem) + warp * c;
  const T* a = f1 + b * s1.n + y * s1.h + x * s1.w;
  for (int ci = lane; ci < c; ci += 32) row[ci] = to_f32(a[ci]);
  __syncwarp();

  T* o = out + pix * KK;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int k = r * 32 + lane;
    if (k < KK) {
      const int yy = y + k / K - D;
      const int xx = x + k % K - D;
      float s = 0.f;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        s = dot_row<T, VEC>(row, f2 + b * s2.n + yy * s2.h + xx * s2.w, c);
      o[k] = from_f32<T>(s * inv_c);
    }
  }
}

template <typename T, int D>
static void launch_correlation_d(const void* f1, PixStrides s1, const void* f2,
                                 PixStrides s2, void* out, int n, int h, int w,
                                 int c, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * h * w;
  const dim3 grid(ceil_div(total, kCorrWarps));
  const dim3 block(kCorrWarps * 32);
  const size_t smem = sizeof(float) * kCorrWarps * c;
  const float inv_c = 1.f / static_cast<float>(c);
  const T* a = static_cast<const T*>(f1);
  const T* b = static_cast<const T*>(f2);
  T* o = static_cast<T*>(out);
  // vector path: every f2 pixel 16-byte aligned, and f1 rows in shared
  // memory that stay 16-byte aligned (c a multiple of 4 floats)
  constexpr int E = kVec<T>;
  const bool vec = vec_ok<T>(f2, c) && c % 4 == 0 && s2.n % E == 0 &&
                   s2.h % E == 0 && s2.w % E == 0;
  if (vec)
    correlation_kernel<T, D, true><<<grid, block, smem, stream>>>(a, s1, b, s2, o, n, h, w, c, inv_c);
  else
    correlation_kernel<T, D, false><<<grid, block, smem, stream>>>(a, s1, b, s2, o, n, h, w, c, inv_c);
}

template <typename T>
static void launch_correlation(const void* f1, PixStrides s1, const void* f2,
                               PixStrides s2, void* out, int n, int h, int w,
                               int c, int max_disp, cudaStream_t stream) {
  if (max_disp == 3)
    launch_correlation_d<T, 3>(f1, s1, f2, s2, out, n, h, w, c, stream);
  else
    launch_correlation_d<T, 4>(f1, s1, f2, s2, out, n, h, w, c, stream);
}

// ---- tensor_core variant ----

constexpr int kCorrTcCols = 32;  // output columns per block: two m-tiles
constexpr int kCorrTcF2Cols = kCorrTcCols + 8;  // three 8-wide n-tiles each
constexpr int kCorrTcMaxChannels = 256;
constexpr size_t kCorrTcSmemTarget = 100 * 1024;  // two blocks per SM

__host__ __device__ inline size_t corr_tc_smem(int th, int c, int d) {
  const int kk = (2 * d + 1) * (2 * d + 1);
  return sizeof(__nv_bfloat16) *
         ((static_cast<size_t>(th) * kCorrTcCols +
           static_cast<size_t>(th + 2 * d) * kCorrTcF2Cols) * (c + 8) +
          static_cast<size_t>(th) * kCorrTcCols * kk);
}

template <int D>
__global__ void __launch_bounds__(256)
    correlation_tc_kernel(const __nv_bfloat16* __restrict__ f1, PixStrides s1,
                          const __nv_bfloat16* __restrict__ f2, PixStrides s2,
                          __nv_bfloat16* __restrict__ out, int h, int w, int c,
                          float inv_c, int th) {
  constexpr int K = 2 * D + 1;
  constexpr int KK = K * K;
  constexpr int TW = kCorrTcCols;
  constexpr int F2W = kCorrTcF2Cols;
  extern __shared__ __align__(16) unsigned char corr_tc_smem_raw[];
  const int pitch = c + 8;
  __nv_bfloat16* t1 = reinterpret_cast<__nv_bfloat16*>(corr_tc_smem_raw);
  __nv_bfloat16* t2 = t1 + th * TW * pitch;
  __nv_bfloat16* to = t2 + (th + 2 * D) * F2W * pitch;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * th;
  const int chunks = c / 8;  // 16-byte chunks per pixel
  const __nv_bfloat16* f1b = f1 + b * s1.n;
  const __nv_bfloat16* f2b = f2 + b * s2.n;
  // Staging: the lanes of a warp copy 32 / chunks whole pixels at a time,
  // lane = (pixel in the group, chunk); one division per thread, none per
  // pixel.
  const int ppw = 32 / chunks;  // pixels per warp and pass
  const int lp = (tid & 31) / chunks;
  const int ch = ((tid & 31) - lp * chunks) * 8;
  const int pstep = (nthreads >> 5) * ppw;
  if (lp < ppw) {
    for (int p = (tid >> 5) * ppw + lp; p < th * TW; p += pstep) {
      const int y = ty0 + p / TW;
      const int x = tx0 + p % TW;
      const bool ok = y < h && x < w;
      cp_async16(t1 + p * pitch + ch, ok ? f1b + y * s1.h + x * s1.w + ch : f1b, ok);
    }
    for (int p = (tid >> 5) * ppw + lp; p < (th + 2 * D) * F2W; p += pstep) {
      const int y = ty0 - D + p / F2W;
      const int x = tx0 - D + p % F2W;
      const bool ok = y >= 0 && y < h && x >= 0 && x < w;
      cp_async16(t2 + p * pitch + ch, ok ? f2b + y * s2.h + x * s2.w + ch : f2b, ok);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int csteps = c / 16;
  // work items: (tile row, 16-pixel m-tile), one warp each at a time. The
  // channel loop is outermost, so each A fragment is loaded once for all
  // 2D+1 rows of f2; the K x 3 accumulator tiles stay in registers.
  for (int it = tid >> 5; it < th * 2; it += nthreads >> 5) {
    const int row = it >> 1;
    const int m = it & 1;
    const __nv_bfloat16* arow =
        t1 + (row * TW + m * 16 + (lane & 15)) * pitch + (lane >> 4) * 8;
    // staged f2 column j = 16m + n holds x' = tx0 - D + j
    const __nv_bfloat16* b4 = t2 + (row * F2W + m * 16 + (lane & 7) + (lane >> 4) * 8) * pitch +
                              ((lane >> 3) & 1) * 8;
    const __nv_bfloat16* b2 = t2 + (row * F2W + m * 16 + 16 + (lane & 7)) * pitch +
                              ((lane >> 3) & 1) * 8;
    float acc[K][3][4] = {};
    for (int cs = 0; cs < csteps; ++cs) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + cs * 16);
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        uint32_t bq[4], bp[2];
        ldmatrix_x4(bq, b4 + dy * F2W * pitch + cs * 16);
        ldmatrix_x2(bp, b2 + dy * F2W * pitch + cs * 16);
        mma_bf16_16816(acc[dy][0], a, bq[0], bq[1]);
        mma_bf16_16816(acc[dy][1], a, bq[2], bq[3]);
        mma_bf16_16816(acc[dy][2], a, bp[0], bp[1]);
      }
    }
    // keep the diagonals: pixel x = x0 + prow, x' = x0 - D + n, so
    // dx + D = n - prow
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int prow = g + 8 * (q >> 1);
        const int dxi = nt * 8 + 2 * t + (q & 1) - prow;
        if (dxi >= 0 && dxi < K) {
          __nv_bfloat16* o = to + (row * TW + m * 16 + prow) * KK + dxi;
#pragma unroll
          for (int dy = 0; dy < K; ++dy)
            o[dy * K] = __float2bfloat16(acc[dy][nt][q] * inv_c);
        }
      }
  }
  __syncthreads();

  // one contiguous run of nx * KK outputs per tile row: 16-byte vectors
  // where both ends are aligned (rows of even width), else 2-byte stores
  const int nx = min(TW, w - tx0);
  for (int row = 0; row < th && ty0 + row < h; ++row) {
    __nv_bfloat16* dst =
        out + ((static_cast<long long>(b) * h + ty0 + row) * w + tx0) * KK;
    const __nv_bfloat16* src = to + row * TW * KK;
    int done = 0;
    if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      done = nx * KK / 8 * 8;
      for (int i = tid; i < done / 8; i += nthreads)
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    }
    for (int i = done + tid; i < nx * KK; i += nthreads) dst[i] = src[i];
  }
}

template <int D>
static int launch_correlation_tc(const void* f1, PixStrides s1, const void* f2,
                                 PixStrides s2, void* out, int n, int h, int w,
                                 int c, cudaStream_t stream) {
  // the tallest tile of 8, 4, 2 or 1 rows that keeps two blocks on an SM
  int th = 8;
  while (th > 1 && (th / 2 >= h || corr_tc_smem(th, c, D) > kCorrTcSmemTarget))
    th /= 2;
  const size_t smem = corr_tc_smem(th, c, D);
  auto kernel = correlation_tc_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(w, kCorrTcCols), ceil_div(h, th), n);
  const int threads = 64 * std::min(th, 4);  // one warp per (row, m-tile)
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(f1), s1,
      static_cast<const __nv_bfloat16*>(f2), s2,
      static_cast<__nv_bfloat16*>(out), h, w, c, 1.f / static_cast<float>(c), th);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dfvo

// cuda_core variant. f1, f2: [n, h, w, c] with element strides (s?n, s?h,
// s?w) and unit channel stride; out: dense [n, h, w, (2D+1)^2].
extern "C" int dfvo_correlation(const void* f1, long long s1n, long long s1h,
                                long long s1w, const void* f2, long long s2n,
                                long long s2h, long long s2w, void* out, int n,
                                int h, int w, int c, int max_disp, int dtype,
                                void* stream) {
  using namespace dfvo;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > kCorrMaxChannels ||
      (max_disp != 3 && max_disp != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const PixStrides s1{s1n, s1h, s1w}, s2{s2n, s2h, s2w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_correlation<float>(f1, s1, f2, s2, out, n, h, w, c, max_disp, s);
  else if (dtype == kBFloat16)
    launch_correlation<__nv_bfloat16>(f1, s1, f2, s2, out, n, h, w, c, max_disp, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// tensor_core variant: bf16 only, c a multiple of 16 up to 256, every pixel
// 16-byte aligned (base and the three strides). Arguments as above.
extern "C" int dfvo_correlation_tc(const void* f1, long long s1n, long long s1h,
                                   long long s1w, const void* f2, long long s2n,
                                   long long s2h, long long s2w, void* out,
                                   int n, int h, int w, int c, int max_disp,
                                   void* stream) {
  using namespace dfvo;
  const bool aligned = reinterpret_cast<uintptr_t>(f1) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(f2) % 16 == 0 &&
                       s1n % 8 == 0 && s1h % 8 == 0 && s1w % 8 == 0 &&
                       s2n % 8 == 0 && s2h % 8 == 0 && s2w % 8 == 0;
  if (n <= 0 || n > 65535 || h <= 0 || w <= 0 || c <= 0 || c % 16 != 0 ||
      c > kCorrTcMaxChannels || (max_disp != 3 && max_disp != 4) || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const PixStrides s1{s1n, s1h, s1w}, s2{s2n, s2h, s2w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_disp == 3)
    return launch_correlation_tc<3>(f1, s1, f2, s2, out, n, h, w, c, s);
  return launch_correlation_tc<4>(f1, s1, f2, s2, out, n, h, w, c, s);
}
