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
// Design: one pass over the raw map, then a small fixed-order sum; no
// atomics, no output with two writers, no workspace but the per-tile
// parameter partials.
// * rf_bwd_tile: a block owns a tile of pixels, 16 x 16 at k = 7 and 8 x 16
//   at k = 3 and 5, one thread each. It stages the raw taps of the tile and
//   of its (k-1)/2 halo, and the flow of that region with its own (k-1)/2
//   halo, in shared memory as f32 (zero outside the image: the padding).
//   Each staged raw row is one contiguous span in memory, copied by a warp
//   with 16-byte cp.async between 4-byte head and tail copies; the staged
//   rows are placed so that shared and device addresses agree modulo 16
//   bytes, so no row needs alignment. bf16 data is staged by converting
//   loads. The weights and the cotangent of the thread's staged pixels are
//   fetched while the copies fly. Every loop over the k*k taps is unrolled,
//   so a tap's shared-memory reads take constant offsets. Then, in phases
//   separated by barriers:
//   - every staged pixel p (tile and halo) computes m, D and c = g / D (a
//     tile pixel also out and the tie share of the bias term), kept in
//     shared memory; the halo's are recomputed here instead of being read
//     from another block;
//   - each tile pixel q gathers dflow(q) over its k*k neighbours p = q - off_j
//     from the staged c, m and raw_j(p) (e_j recomputed), and writes it;
//   - each parameter-gradient entry (tap j for both components, and the
//     biases) has (threads) / (k*k + 1) owners, owner s summing tile rows s,
//     s + SEGS, ...; the segments are added in order and the tile's partial
//     is written to its row of `part`;
//   - each tile pixel computes draw in place of its raw taps (e_j recomputed
//     again: no e_j is stored, which keeps the staging at 113 KB at k = 7,
//     two blocks an SM), and the block writes the tile's rows out as
//     contiguous spans, by 16-byte stores where the map's and the gradient's
//     alignment agree.
// * rf_bwd_reduce (only when a parameter gradient is needed): a warp per
//   entry sums it over the tiles' partials, lane l the tiles l, l + 32, ...
//   in order, then the lanes by a fixed butterfly; dwx, dbx, dwy and dby do
//   not change from run to run.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace dfvo {

template <int K>
struct RbTile {
  static constexpr int KK = K * K;
  static constexpr int P = (K - 1) / 2;
  static constexpr int TH = K == 7 ? 16 : 8;  // tile rows
  static constexpr int TW = 16;               // tile columns
  static constexpr int NT = TH * TW;          // threads: one per tile pixel
  static constexpr int NW = NT / 32;          // warps
  static constexpr int SR = TH + 2 * P;  // staged raw rows: the tile and its halo
  static constexpr int SC = TW + 2 * P;  // staged raw columns
  static constexpr int NS = SR * SC;     // staged pixels
  static constexpr int ROUNDS = (NS + NT - 1) / NT;  // staged pixels per thread
  static constexpr int FR = TH + 4 * P;  // staged flow: every staged pixel's taps
  static constexpr int FC = TW + 4 * P;
  // parameter-gradient entries: dwx[KK], dwy[KK], dbx, dby
  static constexpr int NV = 2 * KK + 2;
  // owners: tap j (both components) and the biases, each a segment of pixels
  static constexpr int OWN = KK + 1;
  static constexpr int SEGS = NT / OWN;  // owner s: tile rows s, s + SEGS, ...
  // floats of a staged raw row (a multiple of 4), plus up to 3 to make the
  // row pitch agree with the map's modulo 16 bytes
  static constexpr int RPF = (SC * KK + 3) / 4 * 4;
  // float offsets in shared memory: raw (with the alignment shift), flow
  // (x, y per pixel), c_x, c_y and m per staged pixel, out_x, out_y and the
  // tie share per tile pixel, the weights as (wx_j, wy_j) pairs and the
  // biases, the segments' sums; at k = 7 113 KB, two blocks an SM
  static constexpr int FLOW = (SR * (RPF + 3) + 5) / 2 * 2;  // 8-byte aligned pairs
  static constexpr int CX = FLOW + FR * FC * 2;
  static constexpr int CY = CX + NS;
  static constexpr int MM = CY + NS;
  static constexpr int OX = MM + NS;
  static constexpr int OY = OX + NT;
  static constexpr int TB = OY + NT;
  static constexpr int WS = (TB + NT + 1) / 2 * 2;  // 8-byte aligned pairs
  static constexpr int SEG = WS + NV;
  static constexpr int SMEM_FLOATS = SEG + SEGS * NV;
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

// e_j of a tap: s_j and m - s_j rounded as the forward rounds them
__device__ __forceinline__ float rb_exp(float m, float r) {
  return __expf(__fsub_rn(m, __fmul_rn(r, r)));
}

struct RbArgs {
  const void *raw, *flow, *wx, *bx, *wy, *by;
  int wdtype;
  const void* g;
  long long sgn, sgh, sgw, sgc;  // the cotangent's element strides
  void* draw;    // [N,H,W,k*k], or null
  void* dflow;   // [N,H,W,2], or null
  float* part;   // [tiles][NV], or null
  void *dwx, *dbx, *dwy, *dby;  // or null
  int n, h, w;
};

template <int K>
__host__ __device__ inline long long rb_tiles(int n, int h, int w) {
  using L = RbTile<K>;
  return static_cast<long long>(n) * ((h + L::TH - 1) / L::TH) * ((w + L::TW - 1) / L::TW);
}

__device__ __forceinline__ int mod4(long long v) { return static_cast<int>(((v % 4) + 4) % 4); }

template <typename T, int K>
__global__ void __launch_bounds__(RbTile<K>::NT) rf_bwd_tile(RbArgs a) {
  using L = RbTile<K>;
  constexpr int KK = L::KK, P = L::P, TH = L::TH, TW = L::TW, NT = L::NT, SR = L::SR,
                SC = L::SC, FC = L::FC, NV = L::NV, OWN = L::OWN, SEGS = L::SEGS,
                ROUNDS = L::ROUNDS;
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float rb_smem[];
  float* fs = rb_smem + L::FLOW;
  float* cxs = rb_smem + L::CX;
  float* cys = rb_smem + L::CY;
  float* ms = rb_smem + L::MM;
  float* oxs = rb_smem + L::OX;
  float* oys = rb_smem + L::OY;
  float* tbs = rb_smem + L::TB;
  float* ws = rb_smem + L::WS;  // (wx_j, wy_j) at 2j, then bx, by
  float* seg = rb_smem + L::SEG;
  const T* raw = static_cast<const T*>(a.raw);
  const T* flow = static_cast<const T*>(a.flow);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int h = a.h, w = a.w;
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  const long long tile = blockIdx.x;
  const int x0 = static_cast<int>(tile % tiles_x) * TW;
  const int y0 = static_cast<int>((tile / tiles_x) % tiles_y) * TH;
  const long long b = tile / (static_cast<long long>(tiles_x) * tiles_y);
  const long long bh = b * h;  // pixel (b, yy, xx) is (bh + yy) * w + xx

  // Staged raw pixel (r, col) <-> pixel (y0 - P + r, x0 - P + col), tap j at
  // rs[r * rpf + col * KK + j]. In float32 the shift and the row pitch make
  // every staged float agree with its device address modulo 16 bytes.
  const long long base = ((bh + y0 - P) * w + x0 - P) * KK;
  const int shift =
      F32 ? mod4(static_cast<long long>(reinterpret_cast<uintptr_t>(raw) / 4) + base) : 0;
  const int rpf = F32 ? L::RPF + mod4(static_cast<long long>(w) * KK - L::RPF) : L::RPF;
  float* rs = rb_smem + shift;

  // the raw rows, warp v taking rows v, v + NW, ...: columns [lo, hi) lie in
  // the image (zero elsewhere)
  const int lo = max(0, P - x0), hi = min(SC, w - x0 + P);
  for (int r = tid >> 5; r < SR; r += L::NW) {
    const int yy = y0 - P + r;
    const bool row_in = yy >= 0 && yy < h;
    const int l = row_in ? lo : SC, u = row_in ? hi : SC;
    float* srow = rs + r * rpf;
    const int zl = l * KK, zr = (SC - u) * KK;
    for (int i = lane; i < zl + zr; i += 32) srow[i < zl ? i : u * KK + (i - zl)] = 0.f;
    if (u <= l) continue;
    const T* src = raw + ((bh + yy) * w + x0 - P + l) * KK;
    float* dst = srow + l * KK;
    const int cnt = (u - l) * KK;
    if constexpr (F32) {
      const int h0 =
          min(cnt, (4 - static_cast<int>((reinterpret_cast<uintptr_t>(src) / 4) % 4)) % 4);
      const int nb = (cnt - h0) / 4;
      for (int i = lane; i < cnt - 3 * nb; i += 32) {  // head, body vectors, tail
        if (i >= h0 && i < h0 + nb) {
          const int o = h0 + 4 * (i - h0);
          cp_async16(dst + o, src + o, true);
        } else {
          const int o = i < h0 ? i : i + 3 * nb;
          cp_async_small<4>(dst + o, src + o, true);
        }
      }
    } else {
      for (int i = lane; i < cnt; i += 32) dst[i] = to_f32(src[i]);
    }
  }
  // the flow, staged pixel (r, col) <-> pixel (y0 - 2P + r, x0 - 2P + col)
  for (int i = tid; i < L::FR * FC; i += NT) {
    const int yy = y0 - 2 * P + i / FC, xx = x0 - 2 * P + i % FC;
    const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const T* f = in ? flow + ((bh + yy) * w + xx) * 2 : flow;
    if constexpr (F32) {
      cp_async_small<4>(fs + 2 * i, f, in);
      cp_async_small<4>(fs + 2 * i + 1, f + 1, in);
    } else {
      fs[2 * i] = in ? to_f32(f[0]) : 0.f;
      fs[2 * i + 1] = in ? to_f32(f[1]) : 0.f;
    }
  }
  cp_async_commit();
  // while the copies fly: the weights, and the cotangent of this thread's
  // staged pixels (0 outside the image)
  for (int i = tid; i < NV; i += NT)
    ws[i] = i < 2 * KK ? rb_param(i % 2 ? a.wy : a.wx, i / 2, a.wdtype)
                       : rb_param(i == 2 * KK ? a.bx : a.by, 0, a.wdtype);
  const T* g = static_cast<const T*>(a.g);
  float gx[ROUNDS], gy[ROUNDS];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int i = tid + k * NT;
    const int yy = y0 - P + i / SC, xx = x0 - P + i % SC;
    const bool in = i < L::NS && yy >= 0 && yy < h && xx >= 0 && xx < w;
    const T* gp = g + (in ? b * a.sgn + yy * a.sgh + xx * a.sgw : 0);
    gx[k] = in ? to_f32(gp[0]) : 0.f;
    gy[k] = in ? to_f32(gp[a.sgc]) : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  // every staged pixel: m, D, c; a tile pixel also out and the tie share
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const int i = tid + k * NT;
    if (i >= L::NS) break;
    const int r = i / SC, col = i - r * SC;
    const int yy = y0 - P + r, xx = x0 - P + col;
    float c_x = 0.f, c_y = 0.f, m = 0.f;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
      const float* rp = rs + r * rpf + col * KK;  // lanes KK (odd) floats apart
      float mn = fabsf(rp[0]);
#pragma unroll
      for (int j = 1; j < KK; ++j) mn = fminf(mn, fabsf(rp[j]));
      m = __fmul_rn(mn, mn);  // min_j of the rounded raw_j^2
      const int ty = r - P, tx = col - P;
      float den = 0.f;
      if (ty >= 0 && ty < TH && tx >= 0 && tx < TW) {
        const float* f0 = fs + 2 * (r * FC + col);  // the flow of tap (0, 0)
        float ax = 0.f, ay = 0.f;
        int ties = 0;
#pragma unroll
        for (int j = 0; j < KK; ++j) {
          const float rj = rp[j];
          const float e = rb_exp(m, rj);
          const float2 f = *reinterpret_cast<const float2*>(f0 + 2 * ((j / K) * FC + j % K));
          const float2 wj = *reinterpret_cast<const float2*>(ws + 2 * j);
          den += e;
          ties += __fmul_rn(rj, rj) == m;
          ax = fmaf(e, wj.x * f.x, ax);
          ay = fmaf(e, wj.y * f.y, ay);
        }
        const float inv = 1.f / den;  // den >= 1: the minimal tap gives exp(0)
        c_x = gx[k] * inv;
        c_y = gy[k] * inv;
        const int t = ty * TW + tx;
        oxs[t] = (ws[2 * KK] + ax) * inv;
        oys[t] = (ws[2 * KK + 1] + ay) * inv;
        tbs[t] = (c_x * ws[2 * KK] + c_y * ws[2 * KK + 1]) / static_cast<float>(ties);
      } else {
#pragma unroll
        for (int j = 0; j < KK; ++j) den += rb_exp(m, rp[j]);
        c_x = gx[k] / den;
        c_y = gy[k] / den;
      }
    }
    cxs[i] = c_x;  // 0 outside the image: such a p adds nothing below
    cys[i] = c_y;
    ms[i] = m;
  }
  __syncthreads();

  const int qy = tid / TW, qx = tid % TW;
  const int y = y0 + qy, x = x0 + qx;
  const bool mine = y < h && x < w;
  if (a.dflow != nullptr) {
    // dflow(q) = sum_j w_j (c e_j)(q - off_j): staged p = (qy + 2P - j / K,
    // qx + 2P - j % K); outside the image c = 0 and the raw taps are 0
    const float* rq = rs + (qy + 2 * P) * rpf + (qx + 2 * P) * KK;
    const int iq = (qy + 2 * P) * SC + qx + 2 * P;
    float dfx = 0.f, dfy = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const float* rrow = rq - dy * rpf;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const int j = dy * K + dx;
        const int pi = iq - dy * SC - dx;
        const float e = rb_exp(ms[pi], rrow[j - dx * KK]);
        const float2 wj = *reinterpret_cast<const float2*>(ws + 2 * j);
        dfx = fmaf(wj.x, cxs[pi] * e, dfx);
        dfy = fmaf(wj.y, cys[pi] * e, dfy);
      }
    }
    if (mine) {
      T* o = static_cast<T*>(a.dflow) + ((bh + y) * w + x) * 2;
      o[0] = from_f32<T>(dfx);
      o[1] = from_f32<T>(dfy);
    }
  }
  if (a.part != nullptr && tid < SEGS * OWN) {
    // entry o over the tile rows s, s + SEGS, ...: dw_j = sum c e_j f_j,
    // db = sum c (pixels outside the image have c = 0)
    const int o = tid % OWN, s0 = tid / OWN;
    float sx = 0.f, sy = 0.f;
    if (o < KK) {
      const int fo = 2 * ((o / K) * FC + o % K);
      for (int ty = s0; ty < TH; ty += SEGS) {
        const float* rrow = rs + (ty + P) * rpf + P * KK + o;
        const int irow = (ty + P) * SC + P;
        const float* frow = fs + 2 * ((ty + P) * FC + P) + fo;
#pragma unroll
        for (int tx = 0; tx < TW; ++tx) {
          const float e = rb_exp(ms[irow + tx], rrow[tx * KK]);
          const float2 f = *reinterpret_cast<const float2*>(frow + 2 * tx);
          sx = fmaf(cxs[irow + tx] * e, f.x, sx);
          sy = fmaf(cys[irow + tx] * e, f.y, sy);
        }
      }
    } else {
      for (int ty = s0; ty < TH; ty += SEGS) {
        const int irow = (ty + P) * SC + P;
#pragma unroll
        for (int tx = 0; tx < TW; ++tx) {
          sx += cxs[irow + tx];
          sy += cys[irow + tx];
        }
      }
    }
    seg[s0 * NV + (o < KK ? o : 2 * KK)] = sx;
    seg[s0 * NV + (o < KK ? KK + o : 2 * KK + 1)] = sy;
  }
  __syncthreads();  // the gathers' and the owners' reads of raw are done
  if (a.part != nullptr) {
    for (int i = tid; i < NV; i += NT) {
      float total = 0.f;
#pragma unroll
      for (int s0 = 0; s0 < SEGS; ++s0) total += seg[s0 * NV + i];
      a.part[tile * NV + i] = total;
    }
  }
  if (a.draw == nullptr) return;
  if (mine) {
    // draw in place of the pixel's raw taps
    const int pr = qy + P, pc = qx + P;
    const int pi = pr * SC + pc;
    float* rp = rs + pr * rpf + pc * KK;
    const float m = ms[pi], c_x = cxs[pi], c_y = cys[pi];
    const float ox = oxs[tid], oy = oys[tid], tb = tbs[tid];
    const float* f0 = fs + 2 * (pr * FC + pc);
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      const float r = rp[j];
      const float sj = __fmul_rn(r, r);
      const float e = __expf(__fsub_rn(m, sj));
      const float2 f = *reinterpret_cast<const float2*>(f0 + 2 * ((j / K) * FC + j % K));
      const float2 wj = *reinterpret_cast<const float2*>(ws + 2 * j);
      const float ge = c_x * (wj.x * f.x - ox) + c_y * (wj.y * f.y - oy);
      const float dt = e * ge + (sj == m ? tb : 0.f);
      rp[j] = -2.f * r * dt;
    }
  }
  __syncthreads();
  // the tile's rows of draw, each one contiguous span
  T* draw = static_cast<T*>(a.draw);
  const int nx = min(TW, w - x0);
  const bool vec = F32 && (reinterpret_cast<uintptr_t>(a.draw) & 15) ==
                              (reinterpret_cast<uintptr_t>(a.raw) & 15);
  for (int ty = 0; ty < TH && y0 + ty < h; ++ty) {
    const float* src = rs + (ty + P) * rpf + P * KK;
    T* dst = draw + ((bh + y0 + ty) * w + x0) * KK;
    const int cnt = nx * KK;
    if (vec) {
      // src and dst agree modulo 16 bytes (the staging shift)
      const int h0 =
          min(cnt, (4 - static_cast<int>((reinterpret_cast<uintptr_t>(dst) / 4) % 4)) % 4);
      const int nb = (cnt - h0) / 4;
      for (int i = tid; i < cnt - 3 * nb; i += NT) {
        if (i >= h0 && i < h0 + nb) {
          const int o = h0 + 4 * (i - h0);
          *reinterpret_cast<float4*>(reinterpret_cast<float*>(dst) + o) =
              *reinterpret_cast<const float4*>(src + o);
        } else {
          const int o = i < h0 ? i : i + 3 * nb;
          dst[o] = from_f32<T>(src[o]);
        }
      }
    } else {
      for (int i = tid; i < cnt; i += NT) dst[i] = from_f32<T>(src[i]);
    }
  }
}

// The parameter gradients from the tiles' partials: block i (one warp)
// sums entry i, lane l over the tiles l, l + 32, ... in order, then the
// lanes by a fixed butterfly.
template <int K>
__global__ void __launch_bounds__(32) rf_bwd_reduce(RbArgs a, int nparts) {
  constexpr int KK = K * K, NV = RbTile<K>::NV;
  const int i = blockIdx.x, lane = threadIdx.x;
  float s = 0.f;
#pragma unroll 8
  for (int p = lane; p < nparts; p += 32) s += a.part[static_cast<long long>(p) * NV + i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    void* out = i < KK ? a.dwx : i < 2 * KK ? a.dwy : i == 2 * KK ? a.dbx : a.dby;
    if (out != nullptr) rb_store(out, i < 2 * KK ? i % KK : 0, s, a.wdtype);
  }
}

template <typename T, int K>
static int launch_rf_bwd(const RbArgs& a, cudaStream_t stream) {
  using L = RbTile<K>;
  const size_t smem = sizeof(float) * L::SMEM_FLOATS;
  auto kernel = rf_bwd_tile<T, K>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = rb_tiles<K>(a.n, a.h, a.w);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(tiles), L::NT, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (a.part == nullptr) return 0;
  rf_bwd_reduce<K><<<L::NV, 32, 0, stream>>>(a, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_rf_bwd_k(const RbArgs& a, int k, cudaStream_t s) {
  if (k == 3) return launch_rf_bwd<T, 3>(a, s);
  if (k == 5) return launch_rf_bwd<T, 5>(a, s);
  return launch_rf_bwd<T, 7>(a, s);
}

}  // namespace dfvo

// Number of parameter-gradient partials (tiles of the pass) for an n x h x w
// map and a k x k filter: the rows of the workspace `part` of
// dfvo_reg_dist_filter_bwd.
extern "C" int dfvo_reg_dist_filter_bwd_parts(int n, int h, int w, int k) {
  using namespace dfvo;
  const long long tiles = k == 3 ? rb_tiles<3>(n, h, w) : k == 5 ? rb_tiles<5>(n, h, w)
                                                                  : rb_tiles<7>(n, h, w);
  return static_cast<int>(tiles);
}

// raw [N,H,W,k*k] and flow [N,H,W,2] contiguous, of dtype `dtype`; wx, wy
// (k*k values), bx, by (one each) contiguous, of dtype `wdtype`; g [N,H,W,2]
// of dtype `dtype` at element strides sgn, sgh, sgw, sgc. Outputs, each null
// when not needed, dense in their input's dtype: draw [N,H,W,k*k], dflow
// [N,H,W,2], dwx, dwy (k*k values), dbx, dby (one). part: f32 workspace of
// dfvo_reg_dist_filter_bwd_parts rows of 2k*k + 2, set exactly when a
// parameter gradient is needed.
extern "C" int dfvo_reg_dist_filter_bwd(const void* raw, const void* flow, const void* wx,
                                        const void* bx, const void* wy, const void* by,
                                        int wdtype, const void* g, long long sgn, long long sgh,
                                        long long sgw, long long sgc, void* draw, void* dflow,
                                        float* part, void* dwx, void* dbx, void* dwy, void* dby,
                                        int n, int h, int w, int k, int dtype, void* stream) {
  using namespace dfvo;
  const bool need_part = dwx != nullptr || dbx != nullptr || dwy != nullptr || dby != nullptr;
  if (n <= 0 || h <= 0 || w <= 0 || (k != 3 && k != 5 && k != 7) ||
      (wdtype != kFloat32 && wdtype != kBFloat16) || need_part != (part != nullptr) ||
      (draw == nullptr && dflow == nullptr && !need_part))
    return static_cast<int>(cudaErrorInvalidValue);
  const RbArgs a{raw, flow, wx, bx, wy, by, wdtype, g, sgn, sgh, sgw, sgc, draw, dflow,
                 part, dwx, dbx, dwy, dby, n, h, w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_rf_bwd_k<float>(a, k, s);
  if (dtype == kBFloat16) return launch_rf_bwd_k<__nv_bfloat16>(a, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
