// Backward of the local cost volume (csrc/correlation.cu), stride 1.
//
// Replaces _corr_bwd (dfvo_tpu/ops/pallas_corr.py:215), the backward pass of
// the cost volume's custom_vjp: jax.vjp of the plain XLA form, not a Pallas
// kernel. With K = (2D+1)^2 taps d = (dy, dx), dy-major, and the forward's
// mean over the C channels:
//
//   df1[n,y,x,c] = (1/C) sum_d g[n,y,x,d] * f2[n,y+dy,x+dx,c]
//   df2[n,y,x,c] = (1/C) sum_d g[n,y-dy,x-dx,d] * f1[n,y-dy,x-dx,c]
//
// with f1, f2 and g zero outside the image: both in gather form, so every
// output element is written by one thread, without atomics. f1, f2 and the
// gradients are NHWC maps read and written through their N/H/W element
// strides (channel stride 1); stride 2 is handled by the wrapper
// (dfvo_torch/ops/pallas_corr.py), which passes the [::2, ::2] views of the
// inputs and of zero-filled full-size gradients. g is dense [n, h, w, K].
// float32 or bf16 in, f32 multiply-adds on the CUDA cores (not TF32),
// gradients in the input dtype. D in {3, 4}, C <= 1536.
//
// What bounds it on the H100: device memory in principle. At level 2 of a
// finetuning update at 192x640 (a pair, 48 x 160 x 64, float32) f1, f2 and
// g are read once and df1, df2 written once: 18.8 MB, 5.6 us at 3.35 TB/s,
// against 2 * 49 * C multiply-adds per pixel (96 M there, 2.9 us of the
// float32 rate). The plain VJP it replaces runs about 780 small ops per
// call (a product, a mean and a zero-filled slice add per tap).
//
// Design: one launch. A block of 256 threads owns a 4 x 16 pixel tile and
// walks chunks of 32 channels (the chunks are split over blocks up to about
// 1,056 blocks, so that the small levels fill the card). Once per block
// it stages, as f32 in shared memory, the tile's cotangent g[y, x, :] (for
// df1) and the cotangent at the shifted pixels g[y-dy, x-dx, d] (for df2),
// zero outside the image. Per chunk it stages f2 and f1 with a +-D halo by
// cp.async (zero-filled outside the image, which is the padding), double
// buffered where a block has more than one chunk: the next chunk's copies
// are in flight while this one computes.
// Lane l of a warp is channel l of the chunk, and the warp owns 8
// consecutive pixels of one tile row: for each dy it loads the 8 + 2D
// pixels of the halo row it needs into registers once and walks the 2D + 1
// dx taps over them, the cotangent read as a shared-memory broadcast, so
// each staged value is read once per dy and the 8 pixels' df1 and df2 stay
// in registers. Each input crosses device memory about once (the halos
// and the neighbouring blocks' reads are served by L2); the stores of a
// warp are 32 consecutive channels. What limits this design is the
// broadcast reads of g, one per multiply-add (see PERF.md).

#include <algorithm>

#include "common.cuh"

namespace dfvo {

constexpr int kCbRows = 4;     // tile rows
constexpr int kCbCols = 16;    // tile columns
constexpr int kCbSeg = 8;      // consecutive pixels per warp
constexpr int kCbChan = 32;    // channels per chunk, one per lane
constexpr int kCbThreads = 256;
constexpr int kCbTile = kCbRows * kCbCols;
constexpr int kCbMaxChannels = 1536;
constexpr int kCbTargetBlocks = 1056;  // eight per SM of an H100
static_assert(kCbRows * (kCbCols / kCbSeg) * 32 == kCbThreads,
              "one warp per 8-pixel row segment of the tile");

// Dynamic shared memory: the staged f2 / f1 halos (nbuf buffers x maps x
// halo pixels x 32 channels of T), then the cotangents (f32, 64 pixels x K
// per map).
__host__ __device__ inline size_t corr_bwd_smem(int d, int tsize, int maps, int nbuf) {
  const int kk = (2 * d + 1) * (2 * d + 1);
  const int hp = (kCbRows + 2 * d) * (kCbCols + 2 * d);
  return static_cast<size_t>(nbuf) * maps * hp * kCbChan * tsize +
         sizeof(float) * kCbTile * kk * maps;
}

template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(kCbThreads)
    correlation_bwd_kernel(const T* __restrict__ f1, PixStrides s1,
                           const T* __restrict__ f2, PixStrides s2,
                           const T* __restrict__ g, T* __restrict__ df1,
                           PixStrides d1, T* __restrict__ df2, PixStrides d2,
                           int h, int w, int c, int nsplit, int nbuf, float inv_c) {
  constexpr int K = 2 * D + 1;
  constexpr int KK = K * K;
  constexpr int HW = kCbCols + 2 * D;  // halo columns
  constexpr int HP = (kCbRows + 2 * D) * HW;
  constexpr int V = kCbSeg + 2 * D;  // halo pixels one warp reads per row
  extern __shared__ __align__(16) unsigned char cb_smem_raw[];
  const bool need1 = df1 != nullptr;
  const bool need2 = df2 != nullptr;
  const int maps = need1 + need2;
  T* bufs = reinterpret_cast<T*>(cb_smem_raw);  // [stage][map][HP][kCbChan]
  float* ga = reinterpret_cast<float*>(
      cb_smem_raw + static_cast<size_t>(nbuf) * maps * HP * kCbChan * sizeof(T));
  float* gb = ga + (need1 ? kCbTile * KK : 0);

  const int tid = threadIdx.x;
  const int b = blockIdx.z / nsplit;
  const int split = blockIdx.z - b * nsplit;
  const int y0 = blockIdx.y * kCbRows;
  const int x0 = blockIdx.x * kCbCols;
  const T* gbase = g + static_cast<long long>(b) * h * w * KK;

  // halos of f2 (map 0, for df1) and f1 (for df2) for the chunk's channels:
  // staged pixel i <-> image pixel (y0 - D + i / HW, x0 - D + i % HW)
  const int nchunks = (c + kCbChan - 1) / kCbChan;
  auto stage = [&](int chunk, int st) {
    const int c0 = chunk * kCbChan;
    const int cw = min(kCbChan, c - c0);
    for (int m = 0; m < maps; ++m) {
      const bool is_f2 = need1 && m == 0;
      const PixStrides ss = is_f2 ? s2 : s1;
      const T* base = (is_f2 ? f2 : f1) + b * ss.n;
      T* dst = bufs + (static_cast<size_t>(st) * maps + m) * HP * kCbChan;
      if constexpr (VEC) {
        constexpr int E = kVec<T>;
        const int pieces = cw / E;
        for (int i = tid; i < HP * pieces; i += kCbThreads) {
          const int pix = i / pieces;
          const int pc = i - pix * pieces;
          const int yy = y0 - D + pix / HW;
          const int xx = x0 - D + pix % HW;
          const bool ok = yy >= 0 && yy < h && xx >= 0 && xx < w;
          cp_async16(dst + pix * kCbChan + pc * E,
                     ok ? base + yy * ss.h + xx * ss.w + c0 + pc * E : base, ok);
        }
      } else {
        for (int i = tid; i < HP * cw; i += kCbThreads) {
          const int pix = i / cw;
          const int cc = i - pix * cw;
          const int yy = y0 - D + pix / HW;
          const int xx = x0 - D + pix % HW;
          const bool ok = yy >= 0 && yy < h && xx >= 0 && xx < w;
          dst[pix * kCbChan + cc] = ok ? base[yy * ss.h + xx * ss.w + c0 + cc] : from_f32<T>(0.f);
        }
      }
    }
    cp_async_commit();
  };

  int chunk = split;
  if (chunk < nchunks) stage(chunk, 0);

  // the cotangent of the tile, ga[p][d] = g[y, x, d], and at the shifted
  // pixels, gb[p][d] = g[y - dy, x - dx, d]; zero outside the image. All of
  // a thread's loads are issued before its stores, so their latencies
  // overlap (a loop of load-store pairs waits for each load in turn).
  constexpr int GN = (kCbTile * KK + kCbThreads - 1) / kCbThreads;
  float va[GN], vb[GN];
#pragma unroll
  for (int u = 0; u < GN; ++u) {
    const int i = tid + u * kCbThreads;
    const int p = i / KK;
    const int d = i - p * KK;
    const int y = y0 + p / kCbCols;
    const int x = x0 + p % kCbCols;
    const int yy = y - (d / K - D);
    const int xx = x - (d % K - D);
    const bool in_tile = i < kCbTile * KK;
    va[u] = need1 && in_tile && y < h && x < w
                ? to_f32(gbase[(static_cast<long long>(y) * w + x) * KK + d])
                : 0.f;
    vb[u] = need2 && in_tile && yy >= 0 && yy < h && xx >= 0 && xx < w
                ? to_f32(gbase[(static_cast<long long>(yy) * w + xx) * KK + d])
                : 0.f;
  }
#pragma unroll
  for (int u = 0; u < GN; ++u) {
    const int i = tid + u * kCbThreads;
    if (i < kCbTile * KK) {
      if (need1) ga[i] = va[u];
      if (need2) gb[i] = vb[u];
    }
  }

  const int lane = tid & 31;
  const int seg = tid >> 5;
  const int py = seg / (kCbCols / kCbSeg);
  const int px0 = (seg % (kCbCols / kCbSeg)) * kCbSeg;
  const int y = y0 + py;
  const float* gar = ga + (py * kCbCols + px0) * KK;
  const float* gbr = gb + (py * kCbCols + px0) * KK;
  for (int it = 0; chunk < nchunks; ++it, chunk += nsplit) {
    if (chunk + nsplit < nchunks) {
      // into the buffer the previous chunk used, free since its last
      // barrier (a block with more than one chunk has two buffers)
      stage(chunk + nsplit, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int ch = chunk * kCbChan + lane;
    const T* buf = bufs + static_cast<size_t>(it & 1) * maps * HP * kCbChan;
    if (ch < c && y < h) {
      if (need1) {
        // df1[y, x0 + px0 + r] = sum_{dy, dx} g[y, x, d] * f2[y + dy, x + dx]:
        // f2 at staged row py + dy + D, column px0 + r + dx + D
        float acc[kCbSeg] = {};
#pragma unroll
        for (int dyi = 0; dyi < K; ++dyi) {
          float v[V];
          const T* row = buf + ((py + dyi) * HW + px0) * kCbChan + lane;
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = to_f32(row[j * kCbChan]);
#pragma unroll
          for (int dxi = 0; dxi < K; ++dxi)
#pragma unroll
            for (int r = 0; r < kCbSeg; ++r) acc[r] += gar[r * KK + dyi * K + dxi] * v[r + dxi];
        }
        T* o = df1 + b * d1.n + y * d1.h + ch;
#pragma unroll
        for (int r = 0; r < kCbSeg; ++r) {
          const int x = x0 + px0 + r;
          if (x < w) o[x * d1.w] = from_f32<T>(acc[r] * inv_c);
        }
      }
      if (need2) {
        // df2[y, x] = sum_{dy, dx} g[y - dy, x - dx, d] * f1[y - dy, x - dx]:
        // f1 at staged row py - dy + D, column px0 + r - dx + D
        const T* m1 = buf + (need1 ? HP * kCbChan : 0);
        float acc[kCbSeg] = {};
#pragma unroll
        for (int dyi = 0; dyi < K; ++dyi) {
          float v[V];
          const T* row = m1 + ((py + 2 * D - dyi) * HW + px0) * kCbChan + lane;
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = to_f32(row[j * kCbChan]);
#pragma unroll
          for (int dxi = 0; dxi < K; ++dxi)
#pragma unroll
            for (int r = 0; r < kCbSeg; ++r)
              acc[r] += gbr[r * KK + dyi * K + dxi] * v[r + 2 * D - dxi];
        }
        T* o = df2 + b * d2.n + y * d2.h + ch;
#pragma unroll
        for (int r = 0; r < kCbSeg; ++r) {
          const int x = x0 + px0 + r;
          if (x < w) o[x * d2.w] = from_f32<T>(acc[r] * inv_c);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int D>
static int launch_correlation_bwd(const void* f1, PixStrides s1, const void* f2,
                                  PixStrides s2, const void* g, void* df1,
                                  PixStrides d1, void* df2, PixStrides d2, int n,
                                  int h, int w, int c, cudaStream_t stream) {
  // split the channel chunks over blocks where the tiles alone leave the
  // card short of blocks; a block with one chunk needs one buffer, which
  // at D = 3 in float32 lets two blocks share an SM
  const long long tiles = static_cast<long long>(ceil_div(w, kCbCols)) * ceil_div(h, kCbRows) * n;
  const int chunks = static_cast<int>(ceil_div(c, kCbChan));
  int nsplit = static_cast<int>(std::min<long long>(chunks, ceil_div(kCbTargetBlocks, tiles)));
  nsplit = std::max(1, std::min(nsplit, 65535 / n));
  const int nbuf = ceil_div(chunks, nsplit) > 1 ? 2 : 1;
  const int maps = (df1 != nullptr) + (df2 != nullptr);
  const size_t smem = corr_bwd_smem(D, sizeof(T), maps, nbuf);
  // cp.async staging: 16-byte aligned pixels of both maps, whole vectors
  // in every chunk
  constexpr int E = kVec<T>;
  const bool vec = vec_ok<T>(f1, c) && vec_ok<T>(f2, c) && s1.n % E == 0 && s1.h % E == 0 &&
                   s1.w % E == 0 && s2.n % E == 0 && s2.h % E == 0 && s2.w % E == 0;
  auto kernel = vec ? correlation_bwd_kernel<T, D, true> : correlation_bwd_kernel<T, D, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(w, kCbCols), ceil_div(h, kCbRows), n * nsplit);
  kernel<<<grid, kCbThreads, smem, stream>>>(
      static_cast<const T*>(f1), s1, static_cast<const T*>(f2), s2, static_cast<const T*>(g),
      static_cast<T*>(df1), d1, static_cast<T*>(df2), d2, h, w, c, nsplit, nbuf,
      1.f / static_cast<float>(c));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_correlation_bwd_t(const void* f1, PixStrides s1, const void* f2,
                                    PixStrides s2, const void* g, void* df1,
                                    PixStrides d1, void* df2, PixStrides d2, int n,
                                    int h, int w, int c, int max_disp, cudaStream_t s) {
  if (max_disp == 3)
    return launch_correlation_bwd<T, 3>(f1, s1, f2, s2, g, df1, d1, df2, d2, n, h, w, c, s);
  return launch_correlation_bwd<T, 4>(f1, s1, f2, s2, g, df1, d1, df2, d2, n, h, w, c, s);
}

}  // namespace dfvo

// f1, f2: [n, h, w, c] with element strides (s?n, s?h, s?w) and unit channel
// stride; g: dense [n, h, w, (2D+1)^2]; df1, df2: [n, h, w, c] with element
// strides (d?n, d?h, d?w) and unit channel stride, or null where that
// gradient is not wanted (not both). All of one dtype.
extern "C" int dfvo_correlation_bwd(const void* f1, long long s1n, long long s1h,
                                    long long s1w, const void* f2, long long s2n,
                                    long long s2h, long long s2w, const void* g,
                                    void* df1, long long d1n, long long d1h,
                                    long long d1w, void* df2, long long d2n,
                                    long long d2h, long long d2w, int n, int h, int w,
                                    int c, int max_disp, int dtype, void* stream) {
  using namespace dfvo;
  if (n <= 0 || n > 65535 || h <= 0 || w <= 0 || c <= 0 || c > kCbMaxChannels ||
      (max_disp != 3 && max_disp != 4) || (df1 == nullptr && df2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const PixStrides s1{s1n, s1h, s1w}, s2{s2n, s2h, s2w}, d1{d1n, d1h, d1w}, d2{d2n, d2h, d2w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_correlation_bwd_t<float>(f1, s1, f2, s2, g, df1, d1, df2, d2, n, h, w, c,
                                           max_disp, s);
  if (dtype == kBFloat16)
    return launch_correlation_bwd_t<__nv_bfloat16>(f1, s1, f2, s2, g, df1, d1, df2, d2, n, h,
                                                   w, c, max_disp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
