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
// output element is written by one thread, without atomics. Mirroring the
// taps (k -> K-1-k turns d into -d) gives df2 the form of df1:
//
//   df2[n,y,x,c] = (1/C) sum_k G2[n,y,x,k] * f1[n,y+dy(k),x+dx(k),c],
//   G2[n,y,x,k] = g[n,y+dy(k),x+dx(k),K-1-k],
//
// so one loop computes either gradient from a staged cotangent and a staged
// map. f1, f2 and the gradients are NHWC maps read and written through
// their N/H/W element strides (channel stride 1); stride 2 is handled by the
// wrapper (dfvo_torch/ops/pallas_corr.py), which passes the [::2, ::2] views
// of the inputs and of zero-filled full-size gradients. g is dense
// [n, h, w, K]. float32 or bf16 in, f32 multiply-adds on the CUDA cores (not
// TF32), gradients in the input dtype. D in {3, 4}, C <= 1536.
//
// What bounds it on the H100: device memory in principle. At level 2 of a
// finetuning update at 192x640 (a pair, 48 x 160 x 64, float32) f1, f2 and
// g are read once and df1, df2 written once: 18.8 MB, 5.6 us at 3.35 TB/s,
// against 2 * 49 * C multiply-adds per pixel (96 M there, 2.9 us of the
// float32 rate). In practice three costs set its time (PERF.md):
// the shared-memory pipe (128 bytes a clock an SM) that feeds the
// multiply-adds, the traffic from L2 into shared memory (the halos and the
// cotangent, about 25 MB at that level), and at the small levels one
// serial chain per block of launch, staging and arithmetic (about 5.8 us
// a level, of which the cotangent's staging takes as much as the
// arithmetic).
//
// Design: one launch. A block of 128 threads owns an 8 x 16 pixel tile
// (halo 2.4x its outputs at D = 3), one of the two gradients (df1 and df2
// are separate blocks, so each stages one map) and a share of the channel
// chunks of 32. The chunks go one to a block where those blocks fit one
// wave (the small levels spread over the SMs); else a block walks an equal
// share of them, double-buffered (the large levels stage the cotangent
// once per tile).
//   * Once per block it stages the tile's cotangent as f32, tap-major in
//     quads: gm[q / 4][k][q % 4] for tile pixel q, so that one 16-byte
//     shared load gives four consecutive pixels' weight for one tap. Each
//     thread copies one pixel of every quad at fixed taps (a warp: 4 pixels
//     x 8 taps, a few sectors of g), by 4-byte cp.async straight into its
//     slot for float32 (zero-filled outside the image), through registers
//     for bf16; the loops over rows and quads are unrolled, so a copy costs
//     a few instructions: this staging is on every block's critical path.
//   * Per chunk it stages the map (f2 for df1, f1 for df2) with its +-D
//     halo, (8 + 2D) x (16 + 2D) pixels x 32 channels, by 16-byte cp.async
//     (zero-filled outside the image: the padding). The cotangent and the
//     first chunk are one group of copies with one wait.
//   * A quarter-warp (8 lanes, 4 channels each) owns a strip of 8 pixels of
//     a tile row for the chunk's 32 channels. Per dy it loads the strip's
//     window of 8 + 2D staged pixels (16-byte loads of 4 channels) into
//     registers once, and per dx two 16-byte loads give the 8 pixels'
//     weights: 32 multiply-adds per two weight loads, and a staged value
//     feeds 2D + 1 taps (70 shared wavefronts per 224 multiply-add
//     instructions a warp and dy). The four quarter-warps' weight loads fall
//     on distinct banks (their quads lie 2K 16-byte units apart). The dy
//     loop stays rolled: unrolled, the registers spill (3x slower).
// Each thread sums its outputs over the taps in order; two launches, and a
// launch with one gradient asked for, give equal outputs bit for bit.

#include <algorithm>

#include "common.cuh"

namespace dfvo {

constexpr int kCbRows = 8;     // tile rows
constexpr int kCbCols = 16;    // tile columns
constexpr int kCbSeg = 8;      // pixels of a strip: one quarter-warp's
constexpr int kCbQuad = 4;     // channels per lane
constexpr int kCbChan = 32;    // channels per chunk: 8 lanes of 4
constexpr int kCbTile = kCbRows * kCbCols;
constexpr int kCbThreads = kCbTile / kCbSeg * (kCbChan / kCbQuad);
constexpr int kCbMaxChannels = 1536;
constexpr int kCbSms = 132;                 // SMs of an H100
constexpr size_t kCbSmemPerSm = 233472;     // shared memory of an SM, bytes
static_assert(kCbThreads == 128, "a quarter-warp per strip of 8 pixels");
static_assert(kCbCols % kCbSeg == 0 && kCbCols % 4 == 0, "strips and quads within a row");

template <int D>
struct CbTile {
  static constexpr int K = 2 * D + 1;
  static constexpr int KK = K * K;
  static constexpr int HW = kCbCols + 2 * D;  // halo columns
  static constexpr int HP = (kCbRows + 2 * D) * HW;  // halo pixels
  static constexpr int GM = kCbTile * KK;  // staged cotangent, f32
};

// Dynamic shared memory: the staged cotangent (f32), then nbuf buffers of
// the haloed map (32 channels of T a pixel).
template <typename T, int D>
inline size_t corr_bwd_smem(int nbuf) {
  using L = CbTile<D>;
  return sizeof(float) * L::GM + static_cast<size_t>(nbuf) * L::HP * kCbChan * sizeof(T);
}

struct CbArgs {
  const void* f1;
  PixStrides s1;
  const void* f2;
  PixStrides s2;
  const void* g;  // dense [n, h, w, K]
  void* df1;
  PixStrides d1;
  void* df2;
  PixStrides d2;
  int h, w, c;
  int maps, first_map;  // gradients per tile (1 or 2), the first one's map
  int nsplit, tiles_x, tiles_y;
  bool vout;  // 4-channel vector stores
  float inv_c;
};

// Four consecutive staged channels, widened to f32.
__device__ __forceinline__ void cb_lds4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void cb_lds4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&q);
  const float2 a = __bfloat1622float2(hv[0]);
  const float2 b = __bfloat1622float2(hv[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// Four channels to the gradient: one 16-byte (float32) or 8-byte (bf16)
// store where ``vec``, else element by element below c.
__device__ __forceinline__ void cb_store4(float* o, const float (&v)[4], int left, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < left) o[e] = v[e];
  }
}
__device__ __forceinline__ void cb_store4(__nv_bfloat16* o, const float (&v)[4], int left,
                                          bool vec) {
  if (vec) {
    uint2 q;
    q.x = pack_bf16x2(__float2bfloat16(v[0]), __float2bfloat16(v[1]));
    q.y = pack_bf16x2(__float2bfloat16(v[2]), __float2bfloat16(v[3]));
    *reinterpret_cast<uint2*>(o) = q;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < left) o[e] = __float2bfloat16(v[e]);
  }
}

template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(kCbThreads) correlation_bwd_kernel(CbArgs a) {
  using L = CbTile<D>;
  constexpr int K = L::K, KK = L::KK, HW = L::HW, HP = L::HP;
  constexpr int WIN = kCbSeg + 2 * D;  // a strip's window of staged pixels
  extern __shared__ __align__(16) unsigned char cb_smem[];
  float* gm = reinterpret_cast<float*>(cb_smem);  // [tile pixel / 4][KK][4]
  T* bufs = reinterpret_cast<T*>(cb_smem + sizeof(float) * L::GM);  // [stage][HP][32]

  const int tid = threadIdx.x;
  const int blk = static_cast<int>(blockIdx.x);
  const int map = a.first_map + blk % a.maps;  // 0: df1 from g and f2; 1: df2
  const int rest = blk / a.maps;
  const int split = rest % a.nsplit;
  const int tile = rest / a.nsplit;
  const int x0 = (tile % a.tiles_x) * kCbCols;
  const int y0 = ((tile / a.tiles_x) % a.tiles_y) * kCbRows;
  const long long b = tile / (a.tiles_x * a.tiles_y);
  const int h = a.h, w = a.w, c = a.c;
  const PixStrides sf = map == 0 ? a.s2 : a.s1;
  const T* fb = static_cast<const T*>(map == 0 ? a.f2 : a.f1) + b * sf.n;
  const T* gb = static_cast<const T*>(a.g) + b * h * w * KK;

  // chunk j (channels 32 j ..) of the map's halo into buffer st: staged
  // pixel i <-> image pixel (y0 - D + i / HW, x0 - D + i % HW), zero
  // outside the image and past c. By vectors: thread tid copies piece
  // tid % PIECES of the pixels tid / PIECES + STEP u, walked by row and
  // column
  auto stage = [&](int j, int st) {
    const int c0 = j * kCbChan;
    T* dst = bufs + static_cast<size_t>(st) * HP * kCbChan;
    if constexpr (VEC) {
      constexpr int E = kVec<T>;
      constexpr int PIECES = kCbChan / E;
      constexpr int STEP = kCbThreads / PIECES;
      const int pc = tid % PIECES, ch = c0 + pc * E;
      int pix = tid / PIECES, hr = pix / HW, hc = pix % HW;
#pragma unroll 4
      for (; pix < HP; pix += STEP) {
        const int yy = y0 - D + hr, xx = x0 - D + hc;
        const bool ok = yy >= 0 && yy < h && xx >= 0 && xx < w && ch < c;
        cp_async16(dst + pix * kCbChan + pc * E, ok ? fb + yy * sf.h + xx * sf.w + ch : fb, ok);
        hr += STEP / HW;
        hc += STEP % HW;
        if (hc >= HW) {
          hc -= HW;
          ++hr;
        }
      }
    } else {
      for (int i = tid; i < HP * kCbChan; i += kCbThreads) {
        const int pix = i / kCbChan, cc = i - pix * kCbChan;
        const int yy = y0 - D + pix / HW, xx = x0 - D + pix % HW, ch = c0 + cc;
        const bool ok = yy >= 0 && yy < h && xx >= 0 && xx < w && ch < c;
        dst[pix * kCbChan + cc] = ok ? fb[yy * sf.h + xx * sf.w + ch] : from_f32<T>(0.f);
      }
    }
  };

  // the tile's cotangent: gm[(q / 4 * KK + k) * 4 + q % 4] holds g[q, k]
  // (map 0) or g[q + d(k), KK-1-k] (map 1), zero outside the image. Thread
  // tid copies pixel q % 4 = tid % 4 of each of the 32 quads (8 rows x 4)
  // at the taps k = tid / 4 + 32 j, so that a warp's copies are 4 pixels x
  // 8 taps: a few sectors of g, consecutive words of gm
  static_assert(kCbThreads == 4 * 32 && kCbCols == 16, "4 pixels x 32 taps a pass");
  const int i4 = tid & 3;
  auto g_tap = [&](int j, auto&& copy) {
    const int k = (tid >> 2) + 32 * j;
    if (k >= KK) return;
    int dy = 0, dx = 0, t = k;
    if (map == 1) {
      dy = k / K - D;
      dx = k % K - D;
      t = KK - 1 - k;
    }
    const int yb = y0 + dy, xb = x0 + i4 + dx;  // the source of row 0, quad 0
    const long long row = static_cast<long long>(w) * KK;
    const T* src = gb + (yb * row + static_cast<long long>(xb) * KK) + t;
    bool col_ok[4];
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) col_ok[c4] = xb + 4 * c4 >= 0 && xb + 4 * c4 < w;
#pragma unroll
    for (int r = 0; r < kCbRows; ++r) {
      const bool row_ok = yb + r >= 0 && yb + r < h;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4)
        copy(4 * r + c4, ((4 * r + c4) * KK + k) * 4 + i4, src + r * row + 4 * c4 * KK,
             row_ok && col_ok[c4]);
    }
  };
  constexpr int GPASSES = (KK + 31) / 32;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < GPASSES; ++j)
      g_tap(j, [&](int, int e, const T* src, bool ok) {
        cp_async_small<4>(gm + e, ok ? src : gb, ok);
      });
  }

  const int nchunks = (c + kCbChan - 1) / kCbChan;
  const int mine = split < nchunks ? (nchunks - 1 - split) / a.nsplit + 1 : 0;
  if (mine == 0) {
    cp_async_wait<0>();
    return;
  }
  stage(split, 0);
  cp_async_commit();  // the cotangent and the first chunk: one wait
  if constexpr (sizeof(T) != 4) {
    // bf16: a tap's 32 loads before their stores, so that their latencies
    // overlap
#pragma unroll 1
    for (int j = 0; j < GPASSES; ++j) {
      float v[kCbRows * 4];
      g_tap(j, [&](int slot, int, const T* src, bool ok) { v[slot] = ok ? to_f32(*src) : 0.f; });
      g_tap(j, [&](int slot, int e, const T*, bool) { gm[e] = v[slot]; });
    }
  }

  // quarter-warp s (tid / 8) owns the strip of tile row s / 2, columns
  // 8 (s % 2) .. +7: quads 2s and 2s + 1 of gm; lane % 8 owns channels
  // 4 (lane % 8) .. +3 of the chunk
  const int s = tid >> 3;
  const int cq = tid & 7;
  const int r = s >> 1;
  const int col0 = (s & 1) * kCbSeg;
  const float* gq = gm + 2 * s * KK * 4;
  const int y = y0 + r;
  const PixStrides so = map == 0 ? a.d1 : a.d2;
  T* ob = static_cast<T*>(map == 0 ? a.df1 : a.df2) + b * so.n + static_cast<long long>(y) * so.h;

  for (int t = 0; t < mine; ++t) {
    const int j = split + t * a.nsplit;
    if (t + 1 < mine) {
      // into the buffer the previous chunk used, free since its last
      // barrier (a block with more than one chunk has two buffers)
      stage(j + a.nsplit, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* buf = bufs + static_cast<size_t>(t & 1) * HP * kCbChan + cq * kCbQuad;
    float acc[kCbSeg][kCbQuad];
#pragma unroll
    for (int p = 0; p < kCbSeg; ++p)
#pragma unroll
      for (int e = 0; e < kCbQuad; ++e) acc[p][e] = 0.f;
#pragma unroll 1
    for (int dyi = 0; dyi < K; ++dyi) {
      // the window: staged row r + dyi, columns col0 .. col0 + 8 + 2D - 1
      float win[WIN][kCbQuad];
      const T* row = buf + ((r + dyi) * HW + col0) * kCbChan;
#pragma unroll
      for (int i = 0; i < WIN; ++i) cb_lds4(row + i * kCbChan, win[i]);
#pragma unroll
      for (int dxi = 0; dxi < K; ++dxi) {
        const int k = dyi * K + dxi;
        float gv[2][4];  // the strip's two quads of pixels
        cb_lds4(gq + k * 4, gv[0]);
        cb_lds4(gq + (KK + k) * 4, gv[1]);
#pragma unroll
        for (int p = 0; p < kCbSeg; ++p)
#pragma unroll
          for (int e = 0; e < kCbQuad; ++e)
            acc[p][e] = fmaf(gv[p >> 2][p & 3], win[p + dxi][e], acc[p][e]);
      }
    }
    const int ch = j * kCbChan + cq * kCbQuad;
    if (y < h && ch < c) {
#pragma unroll
      for (int p = 0; p < kCbSeg; ++p) {
        const int x = x0 + col0 + p;
        if (x < w) {
          float v[kCbQuad];
#pragma unroll
          for (int e = 0; e < kCbQuad; ++e) v[e] = acc[p][e] * a.inv_c;
          cb_store4(ob + x * so.w + ch, v, c - ch, a.vout);
        }
      }
    }
    if (t + 1 < mine) __syncthreads();  // this chunk's buffer is free
  }
}

template <typename T, int D, bool VEC>
static int launch_correlation_bwd_v(const CbArgs& a, int nbuf, unsigned blocks,
                                    cudaStream_t stream) {
  auto kernel = correlation_bwd_kernel<T, D, VEC>;
  const size_t smem = corr_bwd_smem<T, D>(nbuf);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kCbThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
static int launch_correlation_bwd(const void* f1, PixStrides s1, const void* f2,
                                  PixStrides s2, const void* g, void* df1,
                                  PixStrides d1, void* df2, PixStrides d2, int n,
                                  int h, int w, int c, cudaStream_t stream) {
  // the chunks' split: one chunk a block where that is one wave of blocks
  // with one buffer each; else as few splits as give every SM a block, each
  // walking an equal number of chunks (a block with one more chunk than its
  // neighbours sets the launch's time)
  const int tiles_x = static_cast<int>(ceil_div(w, kCbCols));
  const int tiles_y = static_cast<int>(ceil_div(h, kCbRows));
  const int maps = (df1 != nullptr) + (df2 != nullptr);
  const long long tile_maps = static_cast<long long>(tiles_x) * tiles_y * n * maps;
  const int chunks = static_cast<int>(ceil_div(c, kCbChan));
  const long long per_sm = std::max<long long>(
      1, std::min<long long>(4, kCbSmemPerSm / (corr_bwd_smem<T, D>(1) + 1024)));
  int nsplit = chunks;
  if (tile_maps * chunks > per_sm * kCbSms) {
    const long long want = std::min<long long>(chunks, ceil_div(kCbSms, tile_maps));
    nsplit = static_cast<int>(ceil_div(chunks, ceil_div(chunks, want)));
  }
  const int nbuf = ceil_div(chunks, nsplit) > 1 ? 2 : 1;
  if (tile_maps * nsplit > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte cp.async staging: aligned pixels of both maps, whole vectors in
  // every chunk; vector stores: 4-channel groups aligned in both gradients
  constexpr int E = kVec<T>;
  const bool vec = vec_ok<T>(f1, c) && vec_ok<T>(f2, c) && s1.n % E == 0 && s1.h % E == 0 &&
                   s1.w % E == 0 && s2.n % E == 0 && s2.h % E == 0 && s2.w % E == 0;
  auto out_ok = [&](const void* p, PixStrides d) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0 &&
                            d.n % 4 == 0 && d.h % 4 == 0 && d.w % 4 == 0);
  };
  const bool vout = c % 4 == 0 && out_ok(df1, d1) && out_ok(df2, d2);
  const CbArgs a{f1, s1, f2, s2, g, df1, d1, df2, d2, h, w, c, maps, df1 != nullptr ? 0 : 1,
                 nsplit, tiles_x, tiles_y, vout, 1.f / static_cast<float>(c)};
  const unsigned blocks = static_cast<unsigned>(tile_maps * nsplit);
  if (vec) return launch_correlation_bwd_v<T, D, true>(a, nbuf, blocks, stream);
  return launch_correlation_bwd_v<T, D, false>(a, nbuf, blocks, stream);
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
