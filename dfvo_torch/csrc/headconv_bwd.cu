// Backward of the tiny-output-channel head convolution (csrc/headconv.cu).
//
// Replaces _hc_bwd (dfvo_tpu/ops/headconv.py:254), the backward pass of the
// head conv's custom_vjp: jax.vjp of the plain XLA convolution, not a Pallas
// kernel. With pad p = (k-1)/2 ('same') or 0 (an input padded by the caller):
//
//   dx[n,y,x,ci]    = sum_{ky,kx,co} g[n, y+p-ky, x+p-kx, co] * w[ky,kx,ci,co]
//   dw[ky,kx,ci,co] = sum_{n,oy,ox} x[n, oy-p+ky, ox-p+kx, ci] * g[n,oy,ox,co]
//   db[co]          = sum_{n,oy,ox} g[n,oy,ox,co]
//
// with g zero outside the output and x zero outside the input. x is NHWC
// read through its N/H/W element strides (channel stride 1), w through its
// four strides (on the path, the permuted OIHW parameter as it is), g dense
// [n, out_h, out_w, cout]; dw is written through w's strides. Odd k <= 7,
// Cout <= 4, at most 48 KB of float32 weights; float32 or bf16 in, f32
// multiply-adds on the CUDA cores (not TF32: float32 gradients are held to
// 1e-4), each gradient in its input's dtype.
//
// What bounds it on the H100: the operations. dx and dw each take as many
// multiply-adds as the forward: at LiteFlowNet's level 2 on a pair (96 x
// 320, k = 7, Cin = 32, Cout = 2, float32) 0.19 G each, 11.5 us of the
// float32 rate, against 16 MB of inputs and outputs (4.9 us at 3.35 TB/s).
// The plain VJP it replaces recomputes the forward with its casts and
// permutes and calls cuDNN's convolution_backward on NCHW copies.
//
// Design: two launches, no atomic adds of values. A block of 256 threads
// takes 8 x 32 input-pixel tiles in turn (at most 264 blocks, two per SM,
// striding over the tiles; 4 or 2 rows where a map has fewer tiles than
// that). Per tile it stages the cotangent with its k-1 halo in shared
// memory (as f32, zero outside the output: that is the padding), and per
// chunk of 16 input channels (32 for k <= 3) the input with its halo by
// cp.async (zero-filled outside the image) into one of two buffers: the
// next chunk's copy, of this tile or the next, overlaps this chunk's
// compute. The weights are staged once per block as f32. The first chunk,
// the first cotangent tile and the weights arrive in one latency round
// (by cp.async in float32 where the cotangent has Cout 1, 2 or 4 and the
// weights are the permuted OIHW parameter). The tap count k is a template
// parameter, so the register windows below unroll:
//   * dx for the tile's pixels and the chunk's channels: a thread holds 8
//     pixels of a row for one channel. Per ky it reads the 8 + k - 1
//     cotangent vectors of its row once into registers and that ky's
//     k x Cout weights of its channel, and runs all 8 x k x Cout FMAs
//     from registers (k-fold fewer shared loads than a load per tap);
//   * dw and db: a thread owns (ky, channel) with k x Cout sums, one per
//     kx, and walks each staged input row once, the cotangent's last k
//     columns in a register window: each staged x value is read once per
//     ky, not once per tap. Where k x 16 threads leave most of the block
//     idle (k = 1, 3) the tile's rows are split into groups, which add
//     their sums into the block's running dw in group order;
//   * each block writes its f32 dw and db partial to a workspace, and
//     headconv_bwd_reduce sums the partials in a fixed order (each warp a
//     fixed stride of partials, then the warps in order), so the gradients
//     are equal bit for bit from run to run.
// Summing the partials in the main launch instead (the last block to
// finish, found by a ticket counter) measured 3 to 13 us longer than the
// second launch at every head of the finetuning update (PERF.md).

#include <algorithm>

#include "common.cuh"

namespace dfvo {

constexpr int kHbRows = 8;      // tile rows, halved down to 2 for small maps
constexpr int kHbMinRows = 2;
constexpr int kHbCols = 32;     // tile columns
constexpr int kHbSeg = 8;       // pixels of a row per dx thread
// input channels per chunk: 32 for k <= 3 (the deep disparity heads take
// half the steps), 16 for k = 5, 7 (two buffers of a 7 x 7 halo fit twice
// in an SM)
__host__ __device__ constexpr int hb_chan(int k) { return k <= 3 ? 32 : 16; }
constexpr int kHbThreads = 256;
constexpr int kHbMaxBlocks = 264;  // two per SM of an H100
constexpr int kHbMaxWeightBytes = 48 * 1024;
constexpr int kHbReduceWarps = 8;
constexpr int kHbBatch = 8;  // loads a thread issues before their stores

// cotangent floats per staged pixel: Cout, padded to 4 for Cout = 3 so that
// one vector load reads them
template <int COUT>
inline constexpr int kHbGPitch = COUT == 3 ? 4 : COUT;

__host__ __device__ inline int hb_round4(int v) { return (v + 3) & ~3; }

// Elements of a staged input row: the halo columns of a chunk's channels,
// plus one pixel so that the rows that the two half-warps of a dw warp read
// (16-channel chunks) sit on other banks.
__host__ __device__ inline int hb_xpitch(int k) { return (kHbCols + k) * hb_chan(k); }

// Byte offsets of the dynamic shared memory: the two staged input buffers,
// the weights, the staged cotangent and the running dw and db (f32).
struct HbSmem {
  size_t xbuf, ws, gh, acc, total;
};

__host__ __device__ inline HbSmem hb_smem(int rows, int k, int cin, int cout, int tsize,
                                          bool need_dx, bool need_dw, bool need_part) {
  const int halo = (rows + k - 1) * (kHbCols + k - 1);
  const int gp = cout == 3 ? 4 : cout;
  const int nw = k * k * cin * cout;
  HbSmem s;
  s.xbuf = need_dw ? static_cast<size_t>(rows + k - 1) * hb_xpitch(k) * tsize : 0;
  s.ws = 2 * s.xbuf;  // 16-byte multiples
  s.gh = s.ws + sizeof(float) * (need_dx ? hb_round4(nw) : 0);
  s.acc = s.gh + sizeof(float) * hb_round4(halo * gp);
  s.total = s.acc + sizeof(float) * (need_part ? hb_round4(nw + cout) : 0);
  return s;
}

__host__ __device__ inline long long hb_tiles(int n, int in_h, int in_w, int rows) {
  return static_cast<long long>(n) * ((in_h + rows - 1) / rows) *
         ((in_w + kHbCols - 1) / kHbCols);
}

// Tile rows: 8, or fewer where the map has too few 8-row tiles to give
// every block of the grid one (each block's work is a serial chain, so a
// small map is faster cut finer).
inline int hb_rows(int n, int in_h, int in_w) {
  int rows = kHbRows;
  while (rows > kHbMinRows && hb_tiles(n, in_h, in_w, rows) < kHbMaxBlocks) rows /= 2;
  return rows;
}

inline int hb_blocks(int n, int in_h, int in_w) {
  return static_cast<int>(
      std::min<long long>(hb_tiles(n, in_h, in_w, hb_rows(n, in_h, in_w)), kHbMaxBlocks));
}

template <int GP>
__device__ __forceinline__ void load_gp(const float* p, float (&v)[GP]) {
  if constexpr (GP == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (GP == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

__device__ __forceinline__ void store_as(void* base, long long i, float v, int dtype) {
  if (dtype == kFloat32)
    static_cast<float*>(base)[i] = v;
  else
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(v);
}

struct HbArgs {
  const void* x;
  long long sxn, sxh, sxw;
  const void* w;  // in x's dtype
  long long sw0, sw1, sw2, sw3;
  const void* g;  // dense [n, out_h, out_w, cout], x's dtype
  void* dx;       // dense [n, in_h, in_w, cin], or null
  float* part;    // [gridDim.x][k*k*cin*cout + cout], or null
  int n, in_h, in_w, cin, out_h, out_w, pad;
  int need_dw, need_db;
  int rows;  // tile rows (hb_rows)
  int vec;    // 16-byte input pieces: cp.async staging
  int wcopy;  // w the permuted contiguous OIHW tensor in f32: staged by cp.async
  int gcopy;  // g f32 with Cout 1, 2 or 4, aligned: its halo staged by cp.async
};

template <typename T, int K, int COUT>
__global__ void __launch_bounds__(kHbThreads) headconv_bwd_kernel(HbArgs a) {
  constexpr int GP = kHbGPitch<COUT>;
  constexpr int NSEG = kHbCols / kHbSeg;
  constexpr int HW = kHbCols + K - 1;  // halo columns, of x and of g
  constexpr int WIN = kHbSeg + K - 1;  // a dx thread's cotangent window
  constexpr int CH = hb_chan(K);
  constexpr int KK = K * K;
  extern __shared__ __align__(16) unsigned char hb_smem_raw[];
  const int cin = a.cin;
  const int pad = a.pad;
  const int rows = a.rows;
  const int HH = rows + K - 1;
  const int XP = hb_xpitch(K);
  const int nw = K * K * cin * COUT;
  const bool need_dx = a.dx != nullptr;
  const bool need_part = a.part != nullptr;
  const HbSmem lay = hb_smem(rows, K, cin, COUT, sizeof(T), need_dx, a.need_dw, need_part);
  T* xbuf[2] = {reinterpret_cast<T*>(hb_smem_raw),
                reinterpret_cast<T*>(hb_smem_raw + lay.xbuf)};
  float* ws = reinterpret_cast<float*>(hb_smem_raw + lay.ws);
  float* gh = reinterpret_cast<float*>(hb_smem_raw + lay.gh);
  float* acc = reinterpret_cast<float*>(hb_smem_raw + lay.acc);
  const T* x = static_cast<const T*>(a.x);
  const T* wt = static_cast<const T*>(a.w);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  const int tid = threadIdx.x;

  const int tiles_x = (a.in_w + kHbCols - 1) / kHbCols;
  const int tiles_y = (a.in_h + rows - 1) / rows;
  const long long ntiles = hb_tiles(a.n, a.in_h, a.in_w, rows);
  const int nchunks = (cin + CH - 1) / CH;
  // the block's steps s = t * nchunks + j: chunk j of its tile t, the tile
  // blockIdx.x + t * gridDim.x
  const long long nsteps =
      (ntiles > blockIdx.x ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0) * nchunks;
  auto tile_of = [&](long long s, int& b, int& y0, int& x0) {
    const long long tile = blockIdx.x + (s / nchunks) * gridDim.x;
    x0 = static_cast<int>(tile % tiles_x) * kHbCols;
    y0 = static_cast<int>((tile / tiles_x) % tiles_y) * rows;
    b = static_cast<int>(tile / (static_cast<long long>(tiles_x) * tiles_y));
  };
  // step s's input chunk with its halo into buffer s % 2: staged pixel
  // (j, i) <-> input pixel (y0 - pad + j, x0 - pad + i), zero outside the
  // image and past cin
  auto stage_x = [&](long long s) {
    int b, y0, x0;
    tile_of(s, b, y0, x0);
    const int c0 = static_cast<int>(s % nchunks) * CH;
    const T* xb = x + b * a.sxn;
    T* xs = xbuf[s & 1];
    if (a.vec) {
      constexpr int E = kVec<T>;
      constexpr int PIECES = CH / E;
      for (int i = tid; i < HH * HW * PIECES; i += kHbThreads) {
        const int pix = i / PIECES;
        const int pc = i - pix * PIECES;
        const int r = pix / HW;
        const int col = pix - r * HW;
        const int yy = y0 - pad + r;
        const int xx = x0 - pad + col;
        const int c = c0 + pc * E;
        const bool ok = yy >= 0 && yy < a.in_h && xx >= 0 && xx < a.in_w && c < cin;
        cp_async16(xs + r * XP + col * CH + pc * E,
                   ok ? xb + yy * a.sxh + xx * a.sxw + c : xb, ok);
      }
    } else {
      for (int i0 = tid; i0 < HH * HW * CH; i0 += kHbBatch * kHbThreads) {
        T v[kHbBatch];
#pragma unroll
        for (int u = 0; u < kHbBatch; ++u) {
          const int i = i0 + u * kHbThreads;
          const int pix = i / CH;
          const int r = pix / HW;
          const int yy = y0 - pad + r;
          const int xx = x0 - pad + pix - r * HW;
          const int c = c0 + i - pix * CH;
          const bool ok = i < HH * HW * CH && yy >= 0 && yy < a.in_h && xx >= 0 &&
                          xx < a.in_w && c < cin;
          v[u] = ok ? xb[yy * a.sxh + xx * a.sxw + c] : from_f32<T>(0.f);
        }
#pragma unroll
        for (int u = 0; u < kHbBatch; ++u) {
          const int i = i0 + u * kHbThreads;
          const int pix = i / CH;
          const int r = pix / HW;
          if (i < HH * HW * CH) xs[r * XP + (pix - r * HW) * CH + i - pix * CH] = v[u];
        }
      }
    }
  };
  // the cotangent of step s's tile with its halo: gh pixel (j, i) <->
  // output pixel (y0 + pad - (k-1) + j, x0 + pad - (k-1) + i), zero outside
  // the output; by cp.async where a.gcopy, else loads batched before their
  // stores
  auto stage_g = [&](long long s) {
    int b, y0, x0;
    tile_of(s, b, y0, x0);
    const int gy0 = y0 + pad - (K - 1);
    const int gx0 = x0 + pad - (K - 1);
    if constexpr (sizeof(T) == 4 && GP == COUT) {
      if (a.gcopy) {
        for (int i = tid; i < HH * HW; i += kHbThreads) {
          const int yy = gy0 + i / HW;
          const int xx = gx0 + i % HW;
          const bool ok = yy >= 0 && yy < a.out_h && xx >= 0 && xx < a.out_w;
          const T* src = ok ? g + ((static_cast<long long>(b) * a.out_h + yy) * a.out_w + xx) * COUT
                            : g;
          if constexpr (COUT == 4)
            cp_async16(gh + i * GP, src, ok);
          else
            cp_async_small<4 * COUT>(gh + i * GP, src, ok);
        }
        return;
      }
    }
    for (int i0 = tid; i0 < HH * HW; i0 += 4 * kHbThreads) {
      float v[4][GP];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kHbThreads;
        const int yy = gy0 + i / HW;
        const int xx = gx0 + i % HW;
        const bool ok = i < HH * HW && yy >= 0 && yy < a.out_h && xx >= 0 && xx < a.out_w;
        const T* gp = g + ((static_cast<long long>(b) * a.out_h + yy) * a.out_w + xx) * COUT;
#pragma unroll
        for (int co = 0; co < GP; ++co) v[u][co] = ok && co < COUT ? to_f32(gp[co]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kHbThreads < HH * HW)
#pragma unroll
          for (int co = 0; co < GP; ++co) gh[(i0 + u * kHbThreads) * GP + co] = v[u][co];
    }
  };

  // one latency round before the first step: the first input chunk, the
  // first cotangent tile and the weights, as ws[(co * cin + ci) * k*k +
  // tap] (the OIHW order: lanes, channels k*k words apart, an odd number,
  // read on distinct banks). A permuted contiguous OIHW parameter in f32 is
  // copied as it is; else the loads of a batch are issued before its stores.
  if (nsteps > 0) {
    if (a.need_dw) stage_x(0);
    stage_g(0);
  }
  if (need_dx) {
    if constexpr (sizeof(T) == 4) {
      if (a.wcopy)
        for (int i = tid; i < nw; i += kHbThreads) cp_async_small<4>(ws + i, wt + i, true);
    }
    if (sizeof(T) != 4 || !a.wcopy)
      for (int i0 = tid; i0 < nw; i0 += kHbBatch * kHbThreads) {
        float v[kHbBatch];
#pragma unroll
        for (int u = 0; u < kHbBatch; ++u) {
          const int i = i0 + u * kHbThreads;
          const int tap = i % KK;
          const int ci = (i / KK) % cin;
          const int co = i / (KK * cin);
          v[u] = i < nw ? to_f32(wt[(tap / K) * a.sw0 + (tap % K) * a.sw1 + ci * a.sw2 +
                                    co * a.sw3])
                        : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kHbBatch; ++u)
          if (i0 + u * kHbThreads < nw) ws[i0 + u * kHbThreads] = v[u];
      }
  }
  cp_async_commit();
  // running dw as acc[(tap * cin + ci) * COUT + co], then db
  if (need_part)
    for (int i = tid; i < nw + COUT; i += kHbThreads) acc[i] = 0.f;

  // the tile's output pixels sit at gh offset (k-1-pad, k-1-pad)
  const float* gtile = gh + ((K - 1 - pad) * HW + K - 1 - pad) * GP;
  for (long long s = 0; s < nsteps; ++s) {
    int b, y0, x0;
    tile_of(s, b, y0, x0);
    const int c0 = static_cast<int>(s % nchunks) * CH;
    const int cw = min(CH, cin - c0);
    if (c0 == 0 && s > 0) {
      stage_g(s);  // the previous step's barrier ended the reads of the last tile's
      cp_async_commit();
    }
    if (a.need_dw && s + 1 < nsteps) {
      stage_x(s + 1);  // its buffer's last reads ended at step s - 1's barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (c0 == 0 && a.need_db && tid < 32 * COUT) {
      // warp co sums the tile's cotangent of output channel co: lane l the
      // pixels l, l + 32, ..., then the lanes by shuffles (a fixed order)
      const int co = tid >> 5;
      const int lane = tid & 31;
      float t = 0.f;
      for (int p = lane; p < rows * kHbCols; p += 32)
        t += gtile[((p / kHbCols) * HW + p % kHbCols) * GP + co];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
      if (lane == 0) acc[nw + co] += t;
    }

    if (need_dx) {
      // dx[y0 + py, x0 + px0 + r] = sum_{ky, kx, co} g[.., co] * w[ky, kx, c, co],
      // the cotangent at gh row py + k-1-ky, column px0 + r + k-1-kx: per
      // ky the window of columns px0 .. px0 + 8 + k - 2
      for (int i = tid; i < rows * NSEG * cw; i += kHbThreads) {
        const int c = i % cw;
        const int sg = i / cw;
        const int py = sg / NSEG;
        const int px0 = (sg % NSEG) * kHbSeg;
        const int iy = y0 + py;
        const int ix0 = x0 + px0;
        if (iy >= a.in_h || ix0 >= a.in_w) continue;
        float sum[kHbSeg] = {};
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const float* grow = gh + ((py + K - 1 - ky) * HW + px0) * GP;
          float gw[WIN][GP];
#pragma unroll
          for (int q = 0; q < WIN; ++q) load_gp<GP>(grow + q * GP, gw[q]);
          float wv[K][COUT];
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
#pragma unroll
            for (int co = 0; co < COUT; ++co)
              wv[kx][co] = ws[(co * cin + c0 + c) * KK + ky * K + kx];
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
#pragma unroll
            for (int r = 0; r < kHbSeg; ++r)
#pragma unroll
              for (int co = 0; co < COUT; ++co)
                sum[r] = fmaf(gw[r + K - 1 - kx][co], wv[kx][co], sum[r]);
        }
        T* o = dx + ((static_cast<long long>(b) * a.in_h + iy) * a.in_w + ix0) * cin + c0 + c;
#pragma unroll
        for (int r = 0; r < kHbSeg; ++r)
          if (ix0 + r < a.in_w) o[r * cin] = from_f32<T>(sum[r]);
      }
    }

    if (a.need_dw) {
      // dw[ky, kx, c0 + c, co] += sum over the tile's output pixels (py, px)
      // of x at staged (py + ky, px + kx) times g at gtile (py, px): thread
      // (group, ky, c) walks staged row py + ky once, column i feeding tap
      // kx with the cotangent at column i - kx (zero outside 0 .. 31)
      const int per = K * cw;
      int groups = 1;
      while (2 * groups <= rows && 2 * groups * per <= kHbThreads) groups *= 2;
      const int grp = tid / per;
      const int c = tid % cw;
      const int ky = (tid / cw) % K;
      float sw[K][COUT];
#pragma unroll
      for (int kx = 0; kx < K; ++kx)
#pragma unroll
        for (int co = 0; co < COUT; ++co) sw[kx][co] = 0.f;
      if (grp < groups) {
        const T* xs = xbuf[s & 1];
        for (int py = grp; py < rows; py += groups) {
          const T* xrow = xs + (py + ky) * XP + c;
          const float* grow = gtile + py * HW * GP;
          float gw[K][COUT];  // gw[d]: the cotangent at column i - d
#pragma unroll
          for (int d = 0; d < K; ++d)
#pragma unroll
            for (int co = 0; co < COUT; ++co) gw[d][co] = 0.f;
#pragma unroll
          for (int i = 0; i < HW; ++i) {
#pragma unroll
            for (int d = K - 1; d > 0; --d)
#pragma unroll
              for (int co = 0; co < COUT; ++co) gw[d][co] = gw[d - 1][co];
            if (i < kHbCols) {
              float gv[GP];
              load_gp<GP>(grow + i * GP, gv);
#pragma unroll
              for (int co = 0; co < COUT; ++co) gw[0][co] = gv[co];
            } else {
#pragma unroll
              for (int co = 0; co < COUT; ++co) gw[0][co] = 0.f;
            }
            const float xv = to_f32(xrow[i * CH]);
#pragma unroll
            for (int kx = 0; kx < K; ++kx)
#pragma unroll
              for (int co = 0; co < COUT; ++co) sw[kx][co] = fmaf(xv, gw[kx][co], sw[kx][co]);
          }
        }
      }
      // the groups add in order; each entry has one owner in a group
      for (int q = 0; q < groups; ++q) {
        if (grp == q) {
          float* dst = acc + ((ky * K) * cin + c0 + c) * COUT;
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
#pragma unroll
            for (int co = 0; co < COUT; ++co) dst[kx * cin * COUT + co] += sw[kx][co];
        }
        if (q + 1 < groups) __syncthreads();
      }
    }
    __syncthreads();  // this step's reads of gh and of its input buffer are done
  }
  if (!need_part) return;
  const int np = nw + COUT;
  float* mine = a.part + static_cast<long long>(blockIdx.x) * np;
  for (int i = tid; i < np; i += kHbThreads) mine[i] = acc[i];
}

// Sum of the nparts partials of each of the k*k*cin*cout + cout entries, in
// a fixed order: lane = entry, warp w the partials w, w + 8, ..., then the 8
// warps in order. dw is written through its strides, db densely, each in
// its dtype code; either may be null.
__global__ void __launch_bounds__(kHbReduceWarps * 32)
    headconv_bwd_reduce_kernel(const float* __restrict__ part, int nparts, int k, int cin,
                               int cout, void* dw, long long sw0, long long sw1,
                               long long sw2, long long sw3, int wdtype, void* db,
                               int bdtype) {
  __shared__ float red[kHbReduceWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = k * k * cin * cout;
  const int total = nw + cout;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < total)
#pragma unroll 8
    for (int p = warp; p < nparts; p += kHbReduceWarps)
      s += part[static_cast<long long>(p) * total + e];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || e >= total) return;
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kHbReduceWarps; ++i) t += red[i][lane];
  if (e < nw) {
    if (dw == nullptr) return;
    const int co = e % cout;
    const int ci = (e / cout) % cin;
    const int tap = e / (cout * cin);
    store_as(dw, (tap / k) * sw0 + (tap % k) * sw1 + ci * sw2 + co * sw3, t, wdtype);
  } else if (db != nullptr) {
    store_as(db, e - nw, t, bdtype);
  }
}

template <typename T, int K, int COUT>
static int launch_headconv_bwd_kc(const HbArgs& a, cudaStream_t stream) {
  const HbSmem lay = hb_smem(a.rows, K, a.cin, COUT, sizeof(T), a.dx != nullptr, a.need_dw,
                             a.part != nullptr);
  auto kernel = headconv_bwd_kernel<T, K, COUT>;
  cudaError_t err = allow_smem(kernel, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<hb_blocks(a.n, a.in_h, a.in_w), kHbThreads, lay.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
static int launch_headconv_bwd_k(const HbArgs& a, int cout, cudaStream_t s) {
  switch (cout) {
    case 1:
      return launch_headconv_bwd_kc<T, K, 1>(a, s);
    case 2:
      return launch_headconv_bwd_kc<T, K, 2>(a, s);
    case 3:
      return launch_headconv_bwd_kc<T, K, 3>(a, s);
    default:
      return launch_headconv_bwd_kc<T, K, 4>(a, s);
  }
}

template <typename T>
static int launch_headconv_bwd(const HbArgs& a, int k, int cout, cudaStream_t s) {
  switch (k) {
    case 1:
      return launch_headconv_bwd_k<T, 1>(a, cout, s);
    case 3:
      return launch_headconv_bwd_k<T, 3>(a, cout, s);
    case 5:
      return launch_headconv_bwd_k<T, 5>(a, cout, s);
    default:
      return launch_headconv_bwd_k<T, 7>(a, cout, s);
  }
}

}  // namespace dfvo

// Number of dw / db partials (blocks) that dfvo_headconv_bwd writes for an
// input of n x in_h x in_w pixels: the rows of its workspace.
extern "C" int dfvo_headconv_bwd_parts(int n, int in_h, int in_w) {
  return dfvo::hb_blocks(n, in_h, in_w);
}

// x: [n, in_h, in_w, cin] with element strides sxn, sxh, sxw and unit
// channel stride; wts: element (ky, kx, ci, co) at ky*sw0 + kx*sw1 + ci*sw2 +
// co*sw3, in x's dtype; g: dense [n, out_h, out_w, cout] in x's dtype; dx:
// dense [n, in_h, in_w, cin] in x's dtype, or null; part: f32 workspace of
// dfvo_headconv_bwd_parts rows of k*k*cin*cout + cout, set exactly when
// need_dw or need_db (dfvo_headconv_bwd_reduce sums it). pad as
// dfvo_headconv.
extern "C" int dfvo_headconv_bwd(const void* x, long long sxn, long long sxh, long long sxw,
                                 const void* wts, long long sw0, long long sw1, long long sw2,
                                 long long sw3, const void* g, void* dx, float* part, int n,
                                 int in_h, int in_w, int cin, int out_h, int out_w, int k,
                                 int cout, int pad, int need_dw, int need_db, int dtype,
                                 void* stream) {
  using namespace dfvo;
  const bool want_part = need_dw || need_db;
  if (n <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || cin <= 0 || k < 1 ||
      k > 7 || k % 2 == 0 || cout < 1 || cout > 4 ||
      sizeof(float) * k * k * cin * cout > kHbMaxWeightBytes || (pad != 0 && 2 * pad != k - 1) ||
      out_h != in_h + 2 * pad - (k - 1) || out_w != in_w + 2 * pad - (k - 1) ||
      (dx == nullptr && !want_part) || (want_part != (part != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  HbArgs a{x, sxn, sxh, sxw, wts, sw0, sw1, sw2, sw3, g, dx, want_part ? part : nullptr,
           n, in_h, in_w, cin, out_h, out_w, pad, need_dw != 0, need_db != 0,
           hb_rows(n, in_h, in_w), 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    a.vec = vec_ok<float>(x, cin) && sxn % 4 == 0 && sxh % 4 == 0 && sxw % 4 == 0;
    a.wcopy = sw0 == k && sw1 == 1 && sw2 == k * k && sw3 == static_cast<long long>(cin) * k * k;
    a.gcopy = cout != 3 && reinterpret_cast<uintptr_t>(g) % (4 * cout) == 0;
    return launch_headconv_bwd<float>(a, k, cout, s);
  }
  if (dtype == kBFloat16) {
    a.vec = vec_ok<__nv_bfloat16>(x, cin) && sxn % 8 == 0 && sxh % 8 == 0 && sxw % 8 == 0;
    return launch_headconv_bwd<__nv_bfloat16>(a, k, cout, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The nparts partials of a dfvo_headconv_bwd launch summed into dw (through
// its strides sw0..sw3, dtype wdtype) and db (dense, dtype bdtype), either
// of which may be null: the second launch.
extern "C" int dfvo_headconv_bwd_reduce(const float* part, int nparts, void* dw, long long sw0,
                                        long long sw1, long long sw2, long long sw3, int wdtype,
                                        void* db, int bdtype, int k, int cin, int cout,
                                        void* stream) {
  using namespace dfvo;
  if (part == nullptr || nparts <= 0 || (dw == nullptr && db == nullptr) || k < 1 ||
      cin <= 0 || cout < 1 || cout > 4 || (wdtype != kFloat32 && wdtype != kBFloat16) ||
      (bdtype != kFloat32 && bdtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = k * k * cin * cout + cout;
  headconv_bwd_reduce_kernel<<<ceil_div(total, 32), kHbReduceWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(part, nparts, k, cin, cout,
                                                                    dw, sw0, sw1, sw2, sw3,
                                                                    wdtype, db, bdtype);
  return static_cast<int>(cudaGetLastError());
}
