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
// reg_tile (dfvo_correlation): float32 (every cost volume of the
// finetuning update: LiteFlowNet's levels 6 -> 2, HD3's five levels at
// D = 4) and bf16 outside the tensor_core set (HD3's two 512-channel levels
// on every network call, C not a multiple of 16, unaligned pixels). f32
// multiply-adds on the CUDA cores, never TF32 (the float32 update is held to
// the CPU within 1e-3). What bounds it on the H100: device memory at the
// large levels (level 2 of an update, [2, 48, 160, 64] with f1 a stride-2
// view: 10.9 MB, 3.3 us at 3.35 TB/s, against 0.10 GFLOP, 1.5 us at the
// 67 TFLOP/s float32 rate) and latency at the small ones (level 6 is 240
// pixels). So the design keeps the FMA pipe fed from registers and spreads
// a small map over many SMs:
//   * a block owns an 8 x 16 output tile of one item and stages the f1 tile
//     and the f2 tile with its D halo in shared memory, a chunk of channels
//     at a time (64 bytes a pixel: 16 float32 or 32 bf16 channels), by
//     16-byte cp.async with zero fill outside the image (that is the
//     padding) and past C, double-buffered: the next chunk's copy is in
//     flight while this chunk computes. Pixels that are not 16-byte aligned
//     (or C not a multiple of a 16-byte vector) are staged element by element
//     through the same buffers;
//   * warp w takes displacement row dy = w - D (2D + 1 warps), and lane l a
//     strip of 4 output pixels of tile row l % 8, columns 4 (l / 8) ..: per
//     channel quad the thread reads its strip's 4 f1 pixels and the window of
//     4 + 2D f2 pixels of row y + dy once into registers (16-byte loads of
//     4 float32 channels, 8 bytes of bf16; the 8 rows of a quarter-warp sit
//     on distinct banks, the staged row spanning an odd number of 16-byte
//     units) and runs 4 x (2D + 1) x 4 FMAs from them;
//   * a small map is split over the channels: a thread block cluster of CS
//     blocks (1, 2, 4 or 8, chosen from the shape so that the grid covers the
//     SMs) owns one tile, block r the chunks r, r + CS, ...; each block puts
//     its partial tile in its shared memory, and after a cluster barrier block
//     r sums the CS partials of tile rows r, r + CS, ... in rank order over
//     distributed shared memory, scales by 1/C and stores each tile row's
//     (2D+1)^2 outputs per pixel as one contiguous run.
// Every sum runs in a fixed order (channels in order within a block, the
// blocks in rank order), with no atomics: two launches give equal outputs
// bit for bit.

#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace dfvo {

// ---- reg_tile variant ----

constexpr int kCrRows = 8;     // tile rows: the 8 lanes of a quarter-warp
constexpr int kCrSeg = 4;      // output pixels of a row per thread
constexpr int kCrStrips = 4;   // strips per tile row: the 4 quarter-warps
constexpr int kCrCols = kCrSeg * kCrStrips;
constexpr int kCrPixBytes = 64;  // staged bytes of a pixel per chunk
constexpr int kCrMaxChannels = 1536;
constexpr int kCrMaxCluster = 8;     // the portable cluster size
constexpr int kCrTargetBlocks = 132;  // one block for each SM of an H100

template <int D>
struct CrTile {
  static constexpr int K = 2 * D + 1;
  static constexpr int KK = K * K;
  static constexpr int F2R = kCrRows + 2 * D;  // staged f2 rows
  static constexpr int F2C = kCrCols + 2 * D;  // staged f2 columns
  static constexpr int THREADS = 32 * K;       // one warp per dy
  // bytes of a staged row: an odd number of 16-byte units
  static constexpr int RP1 = kCrCols * kCrPixBytes + 16;
  static constexpr int RP2 = F2C * kCrPixBytes + 16;
  static constexpr int BUF = kCrRows * RP1 + F2R * RP2;  // one staging buffer
  static constexpr int RED = static_cast<int>(sizeof(float)) * kCrRows * kCrCols * KK;
  static constexpr int SMEM = 2 * BUF > RED ? 2 * BUF : RED;
};

struct CrArgs {
  const void* f1;
  PixStrides s1;
  const void* f2;
  PixStrides s2;
  void* out;  // dense [n, h, w, (2D+1)^2]
  int n, h, w, c, cs;
  float inv_c;
};

// Four consecutive staged channels, widened to f32.
__device__ __forceinline__ void cr_lds4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void cr_lds4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// The cluster size for a map: the smallest of 1, 2, 4, 8 whose grid covers
// kCrTargetBlocks, with at least one chunk of channels per block.
inline int cr_cluster(long long tiles, int nchunks) {
  int cs = 1;
  while (cs < kCrMaxCluster && 2 * cs <= nchunks && tiles * cs < kCrTargetBlocks) cs *= 2;
  return cs;
}

template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(CrTile<D>::THREADS, 2)  // two blocks an SM
    correlation_rt_kernel(CrArgs a) {
  using L = CrTile<D>;
  constexpr int K = L::K, KK = L::KK, F2C = L::F2C, NT = L::THREADS;
  constexpr int CH = kCrPixBytes / static_cast<int>(sizeof(T));  // channels per chunk
  constexpr int E = kVec<T>;  // channels per 16-byte piece
  constexpr int PIECES = CH / E;
  constexpr int WIN = kCrSeg + 2 * D;  // a strip's window of f2 pixels
  extern __shared__ __align__(16) unsigned char cr_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.cs;
  const int rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x;
  const int dyi = tid >> 5;  // the warp's displacement row, dy + D
  const int row = tid & 7;
  const int strip = (tid >> 3) & 3;
  const int tiles_x = (a.w + kCrCols - 1) / kCrCols;
  const int tiles_y = (a.h + kCrRows - 1) / kCrRows;
  const long long tile = blockIdx.x / cs;
  const int x0 = static_cast<int>(tile % tiles_x) * kCrCols;
  const int y0 = static_cast<int>((tile / tiles_x) % tiles_y) * kCrRows;
  const long long b = tile / (static_cast<long long>(tiles_x) * tiles_y);
  const T* f1b = static_cast<const T*>(a.f1) + b * a.s1.n;
  const T* f2b = static_cast<const T*>(a.f2) + b * a.s2.n;
  const int c = a.c;
  const int nchunks = (c + CH - 1) / CH;

  // chunk j (channels CH j ..) of the f1 tile, staged pixel (r, col) <->
  // (y0 + r, x0 + col), and of the f2 tile, (r, col) <-> (y0 - D + r,
  // x0 - D + col); zero outside the image and past c
  auto stage = [&](int j, unsigned char* buf) {
    const int c0 = j * CH;
    unsigned char* t2 = buf + kCrRows * L::RP1;
    if constexpr (VEC) {
      for (int i = tid; i < kCrRows * kCrCols * PIECES; i += NT) {
        const int pix = i / PIECES, pc = i - pix * PIECES;
        const int r = pix / kCrCols, col = pix - r * kCrCols;
        const int y = y0 + r, x = x0 + col, ch = c0 + pc * E;
        const bool ok = y < a.h && x < a.w && ch < c;
        cp_async16(buf + r * L::RP1 + col * kCrPixBytes + pc * 16,
                   ok ? f1b + y * a.s1.h + x * a.s1.w + ch : f1b, ok);
      }
      for (int i = tid; i < L::F2R * F2C * PIECES; i += NT) {
        const int pix = i / PIECES, pc = i - pix * PIECES;
        const int r = pix / F2C, col = pix - r * F2C;
        const int y = y0 - D + r, x = x0 - D + col, ch = c0 + pc * E;
        const bool ok = y >= 0 && y < a.h && x >= 0 && x < a.w && ch < c;
        cp_async16(t2 + r * L::RP2 + col * kCrPixBytes + pc * 16,
                   ok ? f2b + y * a.s2.h + x * a.s2.w + ch : f2b, ok);
      }
    } else {
      for (int i = tid; i < kCrRows * kCrCols * CH; i += NT) {
        const int pix = i / CH, cc = i - pix * CH;
        const int r = pix / kCrCols, col = pix - r * kCrCols;
        const int y = y0 + r, x = x0 + col, ch = c0 + cc;
        const bool ok = y < a.h && x < a.w && ch < c;
        *reinterpret_cast<T*>(buf + r * L::RP1 + col * kCrPixBytes + cc * sizeof(T)) =
            ok ? f1b[y * a.s1.h + x * a.s1.w + ch] : from_f32<T>(0.f);
      }
      for (int i = tid; i < L::F2R * F2C * CH; i += NT) {
        const int pix = i / CH, cc = i - pix * CH;
        const int r = pix / F2C, col = pix - r * F2C;
        const int y = y0 - D + r, x = x0 - D + col, ch = c0 + cc;
        const bool ok = y >= 0 && y < a.h && x >= 0 && x < a.w && ch < c;
        *reinterpret_cast<T*>(t2 + r * L::RP2 + col * kCrPixBytes + cc * sizeof(T)) =
            ok ? f2b[y * a.s2.h + x * a.s2.w + ch] : from_f32<T>(0.f);
      }
    }
  };

  unsigned char* bufs[2] = {cr_smem, cr_smem + L::BUF};
  float acc[kCrSeg][K];
#pragma unroll
  for (int p = 0; p < kCrSeg; ++p)
#pragma unroll
    for (int dx = 0; dx < K; ++dx) acc[p][dx] = 0.f;

  // this block's chunks: rank, rank + cs, ...
  const int mine = rank < nchunks ? (nchunks - 1 - rank) / cs + 1 : 0;
  if (mine > 0) stage(rank, bufs[0]);
  cp_async_commit();
  for (int t = 0; t < mine; ++t) {
    const int j = rank + t * cs;
    if (t + 1 < mine) {
      stage(j + cs, bufs[(t + 1) & 1]);  // its buffer's last reads ended at t - 1's barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* buf = bufs[t & 1];
    const int nq = min(CH, c - j * CH + 3) / 4;  // channel quads holding a channel below c
    const unsigned char* pa = buf + row * L::RP1 + strip * kCrSeg * kCrPixBytes;
    const unsigned char* pb =
        buf + kCrRows * L::RP1 + (row + dyi) * L::RP2 + strip * kCrSeg * kCrPixBytes;
#pragma unroll 1
    for (int q = 0; q < nq; ++q) {
      const int off = q * 4 * static_cast<int>(sizeof(T));
      float fa[kCrSeg][4];
#pragma unroll
      for (int p = 0; p < kCrSeg; ++p)
        cr_lds4(reinterpret_cast<const T*>(pa + p * kCrPixBytes + off), fa[p]);
#pragma unroll
      for (int i = 0; i < WIN; ++i) {
        float fb[4];
        cr_lds4(reinterpret_cast<const T*>(pb + i * kCrPixBytes + off), fb);
#pragma unroll
        for (int p = 0; p < kCrSeg; ++p) {
          const int dx = i - p;
          if (dx >= 0 && dx < K) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[p][dx] = fmaf(fa[p][e], fb[e], acc[p][dx]);
          }
        }
      }
    }
    __syncthreads();  // this chunk's buffer is free
  }

  // the block's partial tile, red[pixel][(dy + D) K + dx + D], over the
  // staging buffers; then block r sums tile rows r, r + cs, ... over the
  // cluster's partials in rank order
  float* red = reinterpret_cast<float*>(cr_smem);
#pragma unroll
  for (int p = 0; p < kCrSeg; ++p)
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
      red[(row * kCrCols + strip * kCrSeg + p) * KK + dyi * K + dx] = acc[p][dx];
  cluster.sync();
  const float* parts[kCrMaxCluster];  // the cluster's partial tiles, by rank
#pragma unroll
  for (int q = 0; q < kCrMaxCluster; ++q) parts[q] = cluster.map_shared_rank(red, q < cs ? q : 0);
  T* out = static_cast<T*>(a.out);
  const int nx = min(kCrCols, a.w - x0);
  for (int r = rank; r < kCrRows && y0 + r < a.h; r += cs) {
    T* dst = out + ((b * a.h + y0 + r) * a.w + x0) * KK;
    const int o = r * kCrCols * KK;
#pragma unroll 2
    for (int i = tid; i < nx * KK; i += NT) {
      float v[kCrMaxCluster];  // every rank's load in flight at once
#pragma unroll
      for (int q = 0; q < kCrMaxCluster; ++q) v[q] = q < cs ? parts[q][o + i] : 0.f;
      float sum = v[0];
#pragma unroll
      for (int q = 1; q < kCrMaxCluster; ++q) sum = q < cs ? sum + v[q] : sum;
      dst[i] = from_f32<T>(sum * a.inv_c);
    }
  }
  cluster.sync();  // no block leaves while its partial tile is read
}

template <typename T, int D, bool VEC>
static int launch_correlation_rt_v(const CrArgs& a, unsigned blocks, cudaStream_t stream) {
  auto kernel = correlation_rt_kernel<T, D, VEC>;
  cudaError_t err = allow_smem(kernel, CrTile<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(CrTile<D>::THREADS);
  cfg.dynamicSmemBytes = CrTile<D>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
static int launch_correlation_rt(const void* f1, PixStrides s1, const void* f2, PixStrides s2,
                                 void* out, int n, int h, int w, int c, cudaStream_t stream) {
  constexpr int CH = kCrPixBytes / static_cast<int>(sizeof(T));
  const long long tiles = static_cast<long long>(n) * ceil_div(h, kCrRows) * ceil_div(w, kCrCols);
  const int cs = cr_cluster(tiles, (c + CH - 1) / CH);
  if (tiles * cs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const CrArgs a{f1, s1, f2, s2, out, n, h, w, c, cs, 1.f / static_cast<float>(c)};
  // vector staging: every pixel 16-byte aligned, c a multiple of a vector
  constexpr int E = kVec<T>;
  const bool vec = vec_ok<T>(f1, c) && vec_ok<T>(f2, c) && s1.n % E == 0 && s1.h % E == 0 &&
                   s1.w % E == 0 && s2.n % E == 0 && s2.h % E == 0 && s2.w % E == 0;
  const unsigned blocks = static_cast<unsigned>(tiles * cs);
  if (vec) return launch_correlation_rt_v<T, D, true>(a, blocks, stream);
  return launch_correlation_rt_v<T, D, false>(a, blocks, stream);
}

template <typename T>
static int launch_correlation(const void* f1, PixStrides s1, const void* f2, PixStrides s2,
                              void* out, int n, int h, int w, int c, int max_disp,
                              cudaStream_t stream) {
  if (max_disp == 3) return launch_correlation_rt<T, 3>(f1, s1, f2, s2, out, n, h, w, c, stream);
  return launch_correlation_rt<T, 4>(f1, s1, f2, s2, out, n, h, w, c, stream);
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

// reg_tile variant. f1, f2: [n, h, w, c] with element strides (s?n, s?h,
// s?w) and unit channel stride; out: dense [n, h, w, (2D+1)^2].
extern "C" int dfvo_correlation(const void* f1, long long s1n, long long s1h,
                                long long s1w, const void* f2, long long s2n,
                                long long s2h, long long s2w, void* out, int n,
                                int h, int w, int c, int max_disp, int dtype,
                                void* stream) {
  using namespace dfvo;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > kCrMaxChannels ||
      (max_disp != 3 && max_disp != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const PixStrides s1{s1n, s1h, s1w}, s2{s2n, s2h, s2w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_correlation<float>(f1, s1, f2, s2, out, n, h, w, c, max_disp, s);
  if (dtype == kBFloat16)
    return launch_correlation<__nv_bfloat16>(f1, s1, f2, s2, out, n, h, w, c, max_disp, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
