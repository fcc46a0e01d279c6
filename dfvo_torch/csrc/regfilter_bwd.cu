// Backward of the regularization filter with its confidence normalisation
// (csrc/regfilter.cu).
//
// Replaces _rf_bwd (dfvo_tpu/ops/regfilter.py:242), the backward pass of
// the filter's custom_vjp (jax.vjp of the plain XLA filter, not a Pallas
// kernel), together with autodiff of the normalisation before it
// (dfvo_tpu/models/liteflownet.py:403-404). Per pixel p, with s_j = raw_j^2,
// m = min_j s_j, e_j = exp(m - s_j), D = sum_j e_j, f_j = flow(p + off_j)
// (zero outside the image), out = (b + sum_j e_j w_j f_j) / D and c = g / D,
// each for x and y:
//
//   draw_j   = -2 raw_j (e_j sum_xy c (w_j f_j - out) + [s_j = m] sum_xy c b / T)
//   dflow(q) = sum_j w_j (c e_j)(q - off_j)    over the q - off_j in the image
//   dw_j     = sum_p c e_j f_j,   db = sum_p c
//
// T is the number of taps with s_j = m: the max in the normalisation passes
// its cotangent, sum_xy c b, to the tied taps in equal parts, as autodiff of
// amax (and of jnp.max) does. s_j and m are rounded as the forward rounds
// them (raw^2 and the difference separately, no fused multiply-add), so the
// tied set is the forward's. A tap whose e_j underflows to 0 gets a
// gradient of exactly 0. raw [N,H,W,k*k] and flow [N,H,W,2] are NHWC
// contiguous, both f32 or both bf16; the cotangent g [N,H,W,2] is read
// through its four element strides (autograd may hand a view); the weights
// and biases in their own dtype (f32 or bf16). Sums in f32 (f32 FMA, no
// TF32), each gradient written in its input's dtype.
//
// What bounds it on the H100: device memory. Per pixel it must read k*k
// raw values, the flow and the cotangent and write k*k + 2 gradient values:
// at LiteFlowNet's level 2 on a pair (96 x 320, k = 7, float32) 25.6 MB,
// 7.6 us at 3.35 TB/s, against about 0.15 G operations (2.2 us of the f32
// rate). The plain VJP it replaces recomputes the forward with autograd
// and launches a small kernel for each of its ops.
//
// Design: two launches, no atomics, no output with two writers.
// * rf_bwd_pixels: a block of 256 threads walks 8 x 32 pixel tiles (at
//   most 264 blocks, striding over the tiles), one thread per pixel. It
//   stages the tile's flow with a (k-1)/2 halo and the tile's raw taps in
//   shared memory as f32 (the flow zero outside the image: the padding).
//   The taps of a tile row are one contiguous span, copied element by
//   element with consecutive threads on consecutive elements (in float32
//   one 4-byte cp.async each, all in flight at once), so rows need no
//   alignment (level 6's 360-byte rows) and the reads are coalesced. A
//   thread computes its pixel's m, each e_j (kept in shared memory), D, out
//   and c, and draw in place of its raw taps, which the block then writes
//   out as it read them; and, for the gather, (c_x, c_y, m) of its pixel to
//   a workspace. Then each of the 2k*k + 2 parameter-gradient entries has
//   owners, one per segment of the tile's pixels, which sum its terms from
//   shared memory; the first owner adds the segments in order into a
//   running sum in its register, and the block writes its partial at the
//   end. At k = 7 the staging takes 105 KB: two blocks an SM. (Holding a
//   pixel's taps in registers instead takes 255 registers at k = 7, one
//   block an SM, and reading them lane-strided touches 32 cache lines per
//   warp access.)
// * rf_bwd_gather: one thread per pixel q gathers dflow(q) over its k*k
//   neighbours p = q - off_j: c and m of p from the workspace and the one
//   raw tap raw_j(p), whose e_j it recomputes as the first pass did, so each
//   raw value is read once more in all. Every load goes out, at a clamped
//   address where p lies outside the image, so that none waits on a branch.
//   One block more, the last, sums the parameter partials of the first pass
//   in a fixed order (partial 0, 1, ... for each entry) and writes dwx, dbx,
//   dwy, dby; the gradients do not change from run to run.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace dfvo {

constexpr int kRbRows = 8;     // tile rows
constexpr int kRbCols = 32;    // tile columns, one lane each
constexpr int kRbThreads = kRbRows * kRbCols;
constexpr int kRbMaxBlocks = 264;  // two per SM of an H100
constexpr int kRgThreads = 256;

template <int K>
struct RbTile {
  static constexpr int KK = K * K;
  static constexpr int P = (K - 1) / 2;
  static constexpr int HH = kRbRows + 2 * P;  // flow halo rows
  static constexpr int HW = kRbCols + 2 * P;  // flow halo columns
  // parameter-gradient entries: dwx[KK], dwy[KK], dbx, dby
  static constexpr int NV = 2 * KK + 2;
  // owners per entry (each a strided segment of the tile's pixels)
  static constexpr int SEGS = kRbThreads / NV > 0 ? kRbThreads / NV : 1;
  // shared floats: flow halo (x, y), raw (then draw) and e per pixel and
  // tap, c_x and c_y per pixel, the weights and biases (as the entries),
  // the segments' sums; at k = 7 105 KB, two blocks an SM
  static constexpr int FLOW = HH * HW * 2;
  static constexpr int E = kRbThreads * KK;
  static constexpr int SMEM_FLOATS = FLOW + 2 * E + 2 * kRbThreads + NV + SEGS * NV;
};

__device__ __forceinline__ float rb_param(const void* p, int i, int dtype) {
  return dtype == kFloat32 ? static_cast<const float*>(p)[i]
                           : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void rb_store(void* p, int i, float v, int dtype) {
  if (dtype == kFloat32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

// e_j of a tap, rounded as the forward rounds it
__device__ __forceinline__ float rb_exp(float m, float r) {
  return expf(__fsub_rn(m, __fmul_rn(r, r)));
}

struct RbArgs {
  const void *raw, *flow, *wx, *bx, *wy, *by;
  int wdtype;
  const void* g;
  long long sgn, sgh, sgw, sgc;  // the cotangent's element strides
  void* draw;    // [N,H,W,k*k], or null
  float4* coef;  // (c_x, c_y, m, 0) per pixel, or null when dflow is not needed
  float* part;   // [gridDim.x of rf_bwd_pixels][NV], or null
  void *dflow, *dwx, *dbx, *dwy, *dby;  // or null
  int n, h, w;
};

__host__ __device__ inline long long rb_tiles(int n, int h, int w) {
  return static_cast<long long>(n) * ((h + kRbRows - 1) / kRbRows) *
         ((w + kRbCols - 1) / kRbCols);
}

inline int rb_blocks(int n, int h, int w) {
  return static_cast<int>(std::min<long long>(rb_tiles(n, h, w), kRbMaxBlocks));
}

template <typename T, int K>
__global__ void __launch_bounds__(kRbThreads) rf_bwd_pixels(RbArgs a) {
  using L = RbTile<K>;
  constexpr int KK = L::KK, HW = L::HW, NV = L::NV, SEGS = L::SEGS;
  extern __shared__ __align__(16) float rb_smem[];
  float* fh = rb_smem;         // flow halo, (x, y) per halo pixel
  float* rs = fh + L::FLOW;    // rs[pixel * KK + j]: raw, then draw
  float* es = rs + L::E;       // es[pixel * KK + j]
  float* cx = es + L::E;       // c_x, c_y per tile pixel (0 outside the image)
  float* cy = cx + kRbThreads;
  float* ws = cy + kRbThreads;  // wx[KK], wy[KK], bx, by
  float* seg = ws + NV;         // seg[segment * NV + entry]
  const T* raw = static_cast<const T*>(a.raw);
  const T* flow = static_cast<const T*>(a.flow);
  const T* g = static_cast<const T*>(a.g);
  T* draw = static_cast<T*>(a.draw);
  const int tid = threadIdx.x;
  const int py = tid / kRbCols, px = tid % kRbCols;

  for (int i = tid; i < NV; i += kRbThreads)
    ws[i] = i < KK       ? rb_param(a.wx, i, a.wdtype)
            : i < 2 * KK ? rb_param(a.wy, i - KK, a.wdtype)
            : i == 2 * KK ? rb_param(a.bx, 0, a.wdtype)
                          : rb_param(a.by, 0, a.wdtype);
  float total = 0.f;  // thread tid < NV: the block's running sum of entry tid

  const int tiles_x = (a.w + kRbCols - 1) / kRbCols;
  const int tiles_y = (a.h + kRbRows - 1) / kRbRows;
  const long long ntiles = rb_tiles(a.n, a.h, a.w);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int x0 = static_cast<int>(tile % tiles_x) * kRbCols;
    const int y0 = static_cast<int>((tile / tiles_x) % tiles_y) * kRbRows;
    const int b = static_cast<int>(tile / (static_cast<long long>(tiles_x) * tiles_y));
    const int y = y0 + py, x = x0 + px;
    const bool mine = y < a.h && x < a.w;
    __syncthreads();  // the previous tile's reads of the shared arrays are done
    // The tile's flow with its halo (fh pixel (j, i) <-> pixel (y0 - P + j,
    // x0 - P + i)) and raw taps (each tile row's taps are one contiguous span
    // in memory, read with consecutive threads on consecutive elements). In
    // float32 every element is one 4-byte cp.async, all in flight at once and
    // holding no registers; bf16 elements are loaded a batch at a time.
    for (int i = tid; i < L::HH * HW; i += kRbThreads) {
      const int yy = y0 - L::P + i / HW, xx = x0 - L::P + i % HW;
      const bool in = yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
      const T* f = in ? flow + ((static_cast<long long>(b) * a.h + yy) * a.w + xx) * 2 : flow;
      if constexpr (std::is_same<T, float>::value) {
        cp_async_small<4>(fh + 2 * i, f, in);
        cp_async_small<4>(fh + 2 * i + 1, f + 1, in);
      } else {
        fh[2 * i] = in ? to_f32(f[0]) : 0.f;
        fh[2 * i + 1] = in ? to_f32(f[1]) : 0.f;
      }
    }
#pragma unroll (K)
    for (int i = tid; i < L::E; i += kRbThreads) {
      const int row = i / (kRbCols * KK), col = (i / KK) % kRbCols;
      const bool in = y0 + row < a.h && x0 + col < a.w;
      const T* r = in ? raw + ((static_cast<long long>(b) * a.h + y0 + row) * a.w + x0) * KK +
                            (i - row * kRbCols * KK)
                      : raw;
      if constexpr (std::is_same<T, float>::value)
        cp_async_small<4>(rs + i, r, in);
      else
        rs[i] = in ? to_f32(*r) : 0.f;
    }
    cp_async_commit();
    // the thread's cotangent, while the copies fly
    const T* gp = g + b * a.sgn + (mine ? y : 0) * a.sgh + (mine ? x : 0) * a.sgw;
    const float gx = to_f32(gp[0]), gy = to_f32(gp[a.sgc]);
    cp_async_wait_all();
    __syncthreads();

    float* rp = rs + tid * KK;  // lanes KK (odd) floats apart: no bank conflicts
    float* ep = es + tid * KK;
    float c_x = 0.f, c_y = 0.f;
    if (mine) {
      float mn = fabsf(rp[0]);
      for (int j = 1; j < KK; ++j) mn = fminf(mn, fabsf(rp[j]));
      const float m = __fmul_rn(mn, mn);  // min_j of the rounded raw_j^2
      const float* f0 = fh + 2 * (py * HW + px);  // the halo pixel of tap (0, 0)
      float den = 0.f, ax = 0.f, ay = 0.f;
      int ties = 0;
#pragma unroll (K)
      for (int j = 0; j < KK; ++j) {
        const float r = rp[j];
        const float e = rb_exp(m, r);
        const float* f = f0 + 2 * ((j / K) * HW + j % K);
        ep[j] = e;
        den += e;
        ties += __fmul_rn(r, r) == m;
        ax = fmaf(e, ws[j] * f[0], ax);
        ay = fmaf(e, ws[KK + j] * f[1], ay);
      }
      const float inv = 1.f / den;  // den >= 1: the minimal tap gives exp(0)
      c_x = gx * inv;
      c_y = gy * inv;
      if (draw != nullptr) {
        // draw in place of the pixel's raw taps
        const float ox = (ws[2 * KK] + ax) * inv, oy = (ws[2 * KK + 1] + ay) * inv;
        const float tb = (c_x * ws[2 * KK] + c_y * ws[2 * KK + 1]) / static_cast<float>(ties);
#pragma unroll (K)
        for (int j = 0; j < KK; ++j) {
          const float r = rp[j];
          const float* f = f0 + 2 * ((j / K) * HW + j % K);
          const float ge = c_x * (ws[j] * f[0] - ox) + c_y * (ws[KK + j] * f[1] - oy);
          const float dt = ep[j] * ge + (__fmul_rn(r, r) == m ? tb : 0.f);
          rp[j] = -2.f * r * dt;
        }
      }
      if (a.coef != nullptr)
        a.coef[(static_cast<long long>(b) * a.h + y) * a.w + x] = make_float4(c_x, c_y, m, 0.f);
    } else {
      for (int j = 0; j < KK; ++j) ep[j] = 0.f;
    }
    cx[tid] = c_x;
    cy[tid] = c_y;
    if (draw != nullptr) {
      __syncthreads();
#pragma unroll (K)
      for (int i = tid; i < L::E; i += kRbThreads) {
        const int row = i / (kRbCols * KK), col = (i / KK) % kRbCols;
        if (y0 + row < a.h && x0 + col < a.w)
          draw[((static_cast<long long>(b) * a.h + y0 + row) * a.w + x0) * KK +
               (i - row * kRbCols * KK)] = from_f32<T>(rs[i]);
      }
    }

    if (a.part != nullptr) {
      __syncthreads();
      if (tid < SEGS * NV) {
        // entry i over the pixels s, s + SEGS, ... of the tile
        const int i = tid % NV, s0 = tid / NV;
        float s = 0.f;
        if (i < 2 * KK) {
          const int comp = i >= KK, j = i - comp * KK;
          const float* c = comp ? cy : cx;
          const int off = 2 * ((j / K) * HW + j % K) + comp;
#pragma unroll 8
          for (int q = s0; q < kRbThreads; q += SEGS)
            s = fmaf(c[q] * es[q * KK + j], fh[2 * ((q / kRbCols) * HW + q % kRbCols) + off], s);
        } else {
          const float* c = i == 2 * KK ? cx : cy;
          for (int q = s0; q < kRbThreads; q += SEGS) s += c[q];
        }
        seg[s0 * NV + i] = s;
      }
      __syncthreads();
      if (tid < NV)
#pragma unroll
        for (int s0 = 0; s0 < SEGS; ++s0) total += seg[s0 * NV + tid];
    }
  }
  if (a.part != nullptr && tid < NV) a.part[static_cast<long long>(blockIdx.x) * NV + tid] = total;
}

// Blocks 0 .. gridDim.x - 2 (all of them when no partials are summed): the
// flow gradient, one thread per pixel. The last block, when a.part is set:
// the parameter gradients from the nparts partials.
template <typename T, int K>
__global__ void __launch_bounds__(kRgThreads) rf_bwd_gather(RbArgs a, int nparts) {
  using L = RbTile<K>;
  constexpr int KK = L::KK, NV = L::NV;
  if (a.part != nullptr && blockIdx.x == gridDim.x - 1) {
    for (int i = threadIdx.x; i < NV; i += kRgThreads) {
      float s = 0.f;
      for (int p = 0; p < nparts; ++p) s += a.part[static_cast<long long>(p) * NV + i];
      void* o = i < KK ? a.dwx : i < 2 * KK ? a.dwy : i == 2 * KK ? a.dbx : a.dby;
      if (o != nullptr) rb_store(o, i < 2 * KK ? i % KK : 0, s, a.wdtype);
    }
    return;
  }
  __shared__ float ws[2 * KK];
  for (int i = threadIdx.x; i < 2 * KK; i += kRgThreads)
    ws[i] = i < KK ? rb_param(a.wx, i, a.wdtype) : rb_param(a.wy, i - KK, a.wdtype);
  __syncthreads();
  const long long q = static_cast<long long>(blockIdx.x) * kRgThreads + threadIdx.x;
  if (q >= static_cast<long long>(a.n) * a.h * a.w) return;
  const int x = static_cast<int>(q % a.w);
  const int y = static_cast<int>((q / a.w) % a.h);
  const long long img = q - (static_cast<long long>(y) * a.w + x);  // pixel (b, 0, 0)
  const T* raw = static_cast<const T*>(a.raw);
  float dx = 0.f, dy = 0.f;
  // p = q - off_j reads q through its tap j. Every load goes out (at a
  // clamped address where p lies outside the image, its term then dropped),
  // so that none waits on a branch.
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    const int yy = y - (j / K - L::P), xx = x - (j % K - L::P);
    const bool in = yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
    const long long p = img + static_cast<long long>(min(max(yy, 0), a.h - 1)) * a.w +
                        min(max(xx, 0), a.w - 1);
    const float4 c = a.coef[p];
    const float r = to_f32(raw[p * KK + j]);
    const float e = in ? rb_exp(c.z, r) : 0.f;
    dx = fmaf(ws[j], c.x * e, dx);
    dy = fmaf(ws[KK + j], c.y * e, dy);
  }
  T* o = static_cast<T*>(a.dflow) + q * 2;
  o[0] = from_f32<T>(dx);
  o[1] = from_f32<T>(dy);
}

template <typename T, int K>
static int launch_rf_bwd(const RbArgs& a, cudaStream_t stream) {
  using L = RbTile<K>;
  const size_t smem = sizeof(float) * L::SMEM_FLOATS;
  auto pixels = rf_bwd_pixels<T, K>;
  cudaError_t err = allow_smem(pixels, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = rb_blocks(a.n, a.h, a.w);
  pixels<<<blocks, kRbThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long npix = static_cast<long long>(a.n) * a.h * a.w;
  const long long gather =
      (a.dflow != nullptr ? (npix + kRgThreads - 1) / kRgThreads : 0) + (a.part != nullptr);
  if (gather == 0) return 0;
  if (gather > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rf_bwd_gather<T, K><<<static_cast<unsigned>(gather), kRgThreads, 0, stream>>>(a, blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_rf_bwd_k(const RbArgs& a, int k, cudaStream_t s) {
  if (k == 3) return launch_rf_bwd<T, 3>(a, s);
  if (k == 5) return launch_rf_bwd<T, 5>(a, s);
  return launch_rf_bwd<T, 7>(a, s);
}

}  // namespace dfvo

// Number of parameter-gradient partials (blocks of the first pass) for an
// n x h x w map: the rows of the workspace `part` of dfvo_reg_dist_filter_bwd.
extern "C" int dfvo_reg_dist_filter_bwd_parts(int n, int h, int w) {
  return dfvo::rb_blocks(n, h, w);
}

// raw [N,H,W,k*k] and flow [N,H,W,2] contiguous, of dtype `dtype`; wx, wy
// (k*k values), bx, by (one each) contiguous, of dtype `wdtype`; g [N,H,W,2]
// of dtype `dtype` at element strides sgn, sgh, sgw, sgc. Outputs, each null
// when not needed, dense in their input's dtype: draw [N,H,W,k*k], dflow
// [N,H,W,2], dwx, dwy (k*k values), dbx, dby (one). coef: f32 workspace of
// N*H*W float4 (16-byte aligned), set exactly when dflow is; part: f32
// workspace of dfvo_reg_dist_filter_bwd_parts rows of 2k*k + 2, set exactly
// when a parameter gradient is needed.
extern "C" int dfvo_reg_dist_filter_bwd(const void* raw, const void* flow, const void* wx,
                                        const void* bx, const void* wy, const void* by,
                                        int wdtype, const void* g, long long sgn, long long sgh,
                                        long long sgw, long long sgc, void* draw, void* dflow,
                                        void* coef, float* part, void* dwx, void* dbx,
                                        void* dwy, void* dby, int n, int h, int w, int k,
                                        int dtype, void* stream) {
  using namespace dfvo;
  const bool need_part = dwx != nullptr || dbx != nullptr || dwy != nullptr || dby != nullptr;
  if (n <= 0 || h <= 0 || w <= 0 || (k != 3 && k != 5 && k != 7) ||
      (wdtype != kFloat32 && wdtype != kBFloat16) || (dflow != nullptr) != (coef != nullptr) ||
      need_part != (part != nullptr) || reinterpret_cast<uintptr_t>(coef) % 16 != 0 ||
      (draw == nullptr && dflow == nullptr && !need_part))
    return static_cast<int>(cudaErrorInvalidValue);
  const RbArgs a{raw, flow, wx, bx, wy, by, wdtype, g, sgn, sgh, sgw, sgc, draw,
                 static_cast<float4*>(coef), part, dflow, dwx, dbx, dwy, dby, n, h, w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_rf_bwd_k<float>(a, k, s);
  if (dtype == kBFloat16) return launch_rf_bwd_k<__nv_bfloat16>(a, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
