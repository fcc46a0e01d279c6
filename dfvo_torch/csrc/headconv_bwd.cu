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
// Design: two launches, no atomics. headconv_bwd_kernel: a block of 256
// threads takes 8 x 32 pixel tiles in turn (at most 264 blocks, striding
// over the tiles; 4 or 2 rows where a map has fewer tiles than that). Per tile it stages the cotangent with its k-1 halo in
// shared memory once (as f32, zero outside the output: that is the
// padding), then per chunk of 32 input channels the input with its halo
// (cp.async, zero-filled outside the image); the weights are staged once
// per block as f32. From that staging the block computes
//   * dx for the tile's pixels and the chunk's channels: a thread holds 8
//     pixels of a row for one channel in registers and walks the k x k
//     taps, each weight read once for the 8 pixels and the cotangent as a
//     shared-memory broadcast of Cout values. Lanes are channels, so the
//     stores of a warp are 32 consecutive channels of a pixel;
//   * dw and db: a thread owns a (tap, channel) pair with its Cout sums in
//     registers and walks the tile's pixels, x from the staged tile and the
//     cotangent as a broadcast vector, then adds them into the block's
//     running dw and db in shared memory (each entry has one owner).
// Each block writes its f32 dw and db partial to a workspace that the
// wrapper allocates; headconv_bwd_reduce sums the partials in a fixed order
// (each warp a fixed stride of partials, then the warps in order), so the
// gradients do not change from run to run.

#include <algorithm>

#include "common.cuh"

namespace dfvo {

constexpr int kHbRows = 8;      // tile rows, halved down to 2 for small maps
constexpr int kHbMinRows = 2;
constexpr int kHbCols = 32;     // tile columns
constexpr int kHbSeg = 8;       // pixels of a row per dx thread
constexpr int kHbChan = 32;     // input channels per chunk
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

// Byte offsets of the dynamic shared memory: the staged input chunk (T),
// the weights, the staged cotangent and the running dw and db (f32).
struct HbSmem {
  size_t ws, gh, acc, total;
};

__host__ __device__ inline HbSmem hb_smem(int rows, int k, int cin, int cout, int tsize,
                                          bool need_dx, bool need_dw, bool need_part) {
  const int halo = (rows + k - 1) * (kHbCols + k - 1);
  const int gp = cout == 3 ? 4 : cout;
  const int nw = k * k * cin * cout;
  HbSmem s;
  s.ws = need_dw ? static_cast<size_t>(halo) * kHbChan * tsize : 0;  // xs first, 16-byte rows
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

struct HbArgs {
  const void* x;
  long long sxn, sxh, sxw;
  const void* w;  // in x's dtype
  long long sw0, sw1, sw2, sw3;
  const void* g;  // dense [n, out_h, out_w, cout], x's dtype
  void* dx;       // dense [n, in_h, in_w, cin], or null
  float* part;    // [gridDim.x][k*k*cin*cout + cout], or null
  int n, in_h, in_w, cin, out_h, out_w, k, pad;
  int need_dw, need_db;
  int rows;  // tile rows (hb_rows)
};

template <typename T, int COUT, bool VEC>
__global__ void __launch_bounds__(kHbThreads) headconv_bwd_kernel(HbArgs a) {
  constexpr int GP = kHbGPitch<COUT>;
  constexpr int NSEG = kHbCols / kHbSeg;
  extern __shared__ __align__(16) unsigned char hb_smem_raw[];
  const int k = a.k;
  const int cin = a.cin;
  const int pad = a.pad;
  const int HW = kHbCols + k - 1;  // halo columns, of x and of g
  const int rows = a.rows;
  const int HH = rows + k - 1;
  const int nw = k * k * cin * COUT;
  const bool need_dx = a.dx != nullptr;
  const bool need_part = a.part != nullptr;
  const HbSmem lay = hb_smem(rows, k, cin, COUT, sizeof(T), need_dx, a.need_dw, need_part);
  T* xs = reinterpret_cast<T*>(hb_smem_raw);
  float* ws = reinterpret_cast<float*>(hb_smem_raw + lay.ws);
  float* gh = reinterpret_cast<float*>(hb_smem_raw + lay.gh);
  float* acc = reinterpret_cast<float*>(hb_smem_raw + lay.acc);
  const T* x = static_cast<const T*>(a.x);
  const T* wt = static_cast<const T*>(a.w);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  const int tid = threadIdx.x;

  // weights as ws[(tap * COUT + co) * cin + ci]: lanes (channels) read
  // consecutive words. The loads of a batch are issued before its stores,
  // so their latencies overlap.
  if (need_dx)
    for (int i0 = tid; i0 < nw; i0 += kHbBatch * kHbThreads) {
      float v[kHbBatch];
#pragma unroll
      for (int u = 0; u < kHbBatch; ++u) {
        const int i = i0 + u * kHbThreads;
        const int ci = i % cin;
        const int co = (i / cin) % COUT;
        const int tap = i / (cin * COUT);
        v[u] = i < nw ? to_f32(wt[(tap / k) * a.sw0 + (tap % k) * a.sw1 + ci * a.sw2 +
                                  co * a.sw3])
                      : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kHbBatch; ++u)
        if (i0 + u * kHbThreads < nw) ws[i0 + u * kHbThreads] = v[u];
    }
  // running dw as acc[(tap * cin + ci) * COUT + co], then db
  if (need_part)
    for (int i = tid; i < nw + COUT; i += kHbThreads) acc[i] = 0.f;

  const int tiles_x = (a.in_w + kHbCols - 1) / kHbCols;
  const int tiles_y = (a.in_h + rows - 1) / rows;
  const long long ntiles = hb_tiles(a.n, a.in_h, a.in_w, rows);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tx = static_cast<int>(tile % tiles_x);
    const int ty = static_cast<int>((tile / tiles_x) % tiles_y);
    const int b = static_cast<int>(tile / (static_cast<long long>(tiles_x) * tiles_y));
    const int y0 = ty * rows;
    const int x0 = tx * kHbCols;
    __syncthreads();  // the previous tile's reads of gh and xs are done

    // the cotangent with its halo: gh pixel (j, i) <-> output pixel
    // (y0 + pad - (k-1) + j, x0 + pad - (k-1) + i)
    const int gy0 = y0 + pad - (k - 1);
    const int gx0 = x0 + pad - (k - 1);
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
    __syncthreads();
    // the tile's output pixels sit at gh offset (k-1-pad, k-1-pad)
    const float* gtile = gh + ((k - 1 - pad) * HW + k - 1 - pad) * GP;
    if (a.need_db && tid < 32 * COUT) {
      // warp co sums the tile's cotangent of output channel co: lane l the
      // pixels l, l + 32, ..., then the lanes by shuffles (a fixed order)
      const int co = tid >> 5;
      const int lane = tid & 31;
      float s = 0.f;
#pragma unroll
      for (int p = lane; p < rows * kHbCols; p += 32)
        s += gtile[((p / kHbCols) * HW + p % kHbCols) * GP + co];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) acc[nw + co] += s;
    }

    for (int c0 = 0; c0 < cin; c0 += kHbChan) {
      const int cw = min(kHbChan, cin - c0);
      if (a.need_dw) {
        // the input chunk with its halo: xs pixel (j, i) <-> input pixel
        // (y0 - pad + j, x0 - pad + i)
        const T* xb = x + b * a.sxn;
        if constexpr (VEC) {
          constexpr int E = kVec<T>;
          const int pieces = cw / E;
          for (int i = tid; i < HH * HW * pieces; i += kHbThreads) {
            const int pix = i / pieces;
            const int pc = i - pix * pieces;
            const int yy = y0 - pad + pix / HW;
            const int xx = x0 - pad + pix % HW;
            const bool ok = yy >= 0 && yy < a.in_h && xx >= 0 && xx < a.in_w;
            cp_async16(xs + pix * kHbChan + pc * E,
                       ok ? xb + yy * a.sxh + xx * a.sxw + c0 + pc * E : xb, ok);
          }
          cp_async_commit();
          cp_async_wait_all();
        } else {
          for (int i = tid; i < HH * HW * cw; i += kHbThreads) {
            const int pix = i / cw;
            const int cc = i - pix * cw;
            const int yy = y0 - pad + pix / HW;
            const int xx = x0 - pad + pix % HW;
            const bool ok = yy >= 0 && yy < a.in_h && xx >= 0 && xx < a.in_w;
            xs[pix * kHbChan + cc] = ok ? xb[yy * a.sxh + xx * a.sxw + c0 + cc] : from_f32<T>(0.f);
          }
        }
        __syncthreads();
      }

      if (need_dx) {
        // dx[y0 + py, x0 + px0 + r] = sum_{ky, kx, co} g[.., co] * w[ky, kx, c, co],
        // the cotangent at gh row py + k-1-ky, column px0 + r + k-1-kx
        for (int i = tid; i < rows * NSEG * cw; i += kHbThreads) {
          const int c = i % cw;
          const int s = i / cw;
          const int py = s / NSEG;
          const int px0 = (s % NSEG) * kHbSeg;
          const int iy = y0 + py;
          const int ix0 = x0 + px0;
          if (iy >= a.in_h || ix0 >= a.in_w) continue;
          float sum[kHbSeg] = {};
          for (int ky = 0; ky < k; ++ky) {
            const float* grow = gh + ((py + k - 1 - ky) * HW + px0 + k - 1) * GP;
            for (int kx = 0; kx < k; ++kx) {
              float wv[COUT];
#pragma unroll
              for (int co = 0; co < COUT; ++co)
                wv[co] = ws[((ky * k + kx) * COUT + co) * cin + c0 + c];
              const float* gp = grow - kx * GP;
#pragma unroll
              for (int r = 0; r < kHbSeg; ++r) {
                float gv[GP];
                load_gp<GP>(gp + r * GP, gv);
#pragma unroll
                for (int co = 0; co < COUT; ++co) sum[r] += gv[co] * wv[co];
              }
            }
          }
          T* o = dx + ((static_cast<long long>(b) * a.in_h + iy) * a.in_w + ix0) * cin + c0 + c;
#pragma unroll
          for (int r = 0; r < kHbSeg; ++r)
            if (ix0 + r < a.in_w) o[r * cin] = from_f32<T>(sum[r]);
        }
      }

      if (a.need_dw) {
        // dw[ky, kx, c0 + c, co] += sum over the tile's output pixels of
        // x at xs (py + ky, px + kx) times g at gtile (py, px)
        for (int i = tid; i < k * k * cw; i += kHbThreads) {
          const int c = i % cw;
          const int tap = i / cw;
          const int ky = tap / k;
          const int kx = tap - ky * k;
          // two chains of sums (even and odd columns) halve the dependent
          // adds
          float s[2][COUT] = {};
          for (int py = 0; py < rows; ++py) {
            const T* xrow = xs + ((py + ky) * HW + kx) * kHbChan + c;
            const float* grow = gtile + py * HW * GP;
#pragma unroll 8
            for (int px = 0; px < kHbCols; ++px) {
              const float xv = to_f32(xrow[px * kHbChan]);
              float gv[GP];
              load_gp<GP>(grow + px * GP, gv);
#pragma unroll
              for (int co = 0; co < COUT; ++co) s[px & 1][co] += xv * gv[co];
            }
          }
          float* dst = acc + (tap * cin + c0 + c) * COUT;
#pragma unroll
          for (int co = 0; co < COUT; ++co) dst[co] += s[0][co] + s[1][co];
        }
        __syncthreads();  // before the next chunk's staging overwrites xs
      }
    }
  }
  if (need_part) {
    __syncthreads();
    float* part = a.part + static_cast<long long>(blockIdx.x) * (nw + COUT);
    for (int i = tid; i < nw + COUT; i += kHbThreads) part[i] = acc[i];
  }
}

template <typename T>
__device__ __forceinline__ void store_as(void* base, long long i, float v) {
  static_cast<T*>(base)[i] = from_f32<T>(v);
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
    const long long off = (tap / k) * sw0 + (tap % k) * sw1 + ci * sw2 + co * sw3;
    if (wdtype == kFloat32)
      store_as<float>(dw, off, t);
    else
      store_as<__nv_bfloat16>(dw, off, t);
  } else if (db != nullptr) {
    if (bdtype == kFloat32)
      store_as<float>(db, e - nw, t);
    else
      store_as<__nv_bfloat16>(db, e - nw, t);
  }
}

template <typename T, int COUT>
static int launch_headconv_bwd_cout(const HbArgs& a, cudaStream_t stream) {
  const HbSmem lay = hb_smem(a.rows, a.k, a.cin, COUT, sizeof(T), a.dx != nullptr, a.need_dw,
                             a.part != nullptr);
  constexpr int E = kVec<T>;
  const bool vec = vec_ok<T>(a.x, a.cin) && a.sxn % E == 0 && a.sxh % E == 0 && a.sxw % E == 0;
  auto kernel = vec ? headconv_bwd_kernel<T, COUT, true> : headconv_bwd_kernel<T, COUT, false>;
  cudaError_t err = allow_smem(kernel, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<hb_blocks(a.n, a.in_h, a.in_w), kHbThreads, lay.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_headconv_bwd(const HbArgs& a, int cout, cudaStream_t s) {
  switch (cout) {
    case 1:
      return launch_headconv_bwd_cout<T, 1>(a, s);
    case 2:
      return launch_headconv_bwd_cout<T, 2>(a, s);
    case 3:
      return launch_headconv_bwd_cout<T, 3>(a, s);
    default:
      return launch_headconv_bwd_cout<T, 4>(a, s);
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
// dfvo_headconv_bwd_parts rows of k*k*cin*cout + cout, or null when neither
// need_dw nor need_db. pad as dfvo_headconv.
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
  const HbArgs a{x, sxn, sxh, sxw, wts, sw0, sw1, sw2, sw3, g, dx, want_part ? part : nullptr,
                 n, in_h, in_w, cin, out_h, out_w, k, pad, need_dw, need_db,
                 hb_rows(n, in_h, in_w)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_headconv_bwd<float>(a, cout, s);
  if (dtype == kBFloat16) return launch_headconv_bwd<__nv_bfloat16>(a, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dw (through its strides, dtype code wdtype) and db (dense, bdtype) from
// the nparts partials of dfvo_headconv_bwd; either may be null.
extern "C" int dfvo_headconv_bwd_reduce(const float* part, int nparts, void* dw, long long sw0,
                                        long long sw1, long long sw2, long long sw3, int wdtype,
                                        void* db, int bdtype, int k, int cin, int cout,
                                        void* stream) {
  using namespace dfvo;
  if (nparts <= 0 || k < 1 || cin <= 0 || cout < 1 || cout > 4 ||
      (dw == nullptr && db == nullptr) || (wdtype != kFloat32 && wdtype != kBFloat16) ||
      (bdtype != kFloat32 && bdtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = k * k * cin * cout + cout;
  headconv_bwd_reduce_kernel<<<ceil_div(total, 32), kHbReduceWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      part, nparts, k, cin, cout, dw, sw0, sw1, sw2, sw3, wdtype, db, bdtype);
  return static_cast<int>(cudaGetLastError());
}
