// LiteFlowNet Regularization: the confidence normalisation and the
// confidence-weighted k x k flow filter, fused into one kernel.
//
// Replaces the Pallas TPU kernel _regfilter_pallas
// (dfvo_tpu/ops/regfilter.py) together with the normalisation that XLA
// fused into that kernel's dist input (dfvo_tpu/models/liteflownet.py,
// Regularization):
//
//   e_j   = exp(min_i raw_i^2 - raw_j^2)  ( = exp(-(raw^2) - max(-(raw^2))) )
//   out_x = (bx + sum_j e_j * wx_j * flow_x(p + off_j)) / sum_j e_j
//   out_y = (by + sum_j e_j * wy_j * flow_y(p + off_j)) / sum_j e_j
//
// raw is the moduleDist output [N,H,W,k*k] in NHWC memory (ky-major taps),
// flow [N,H,W,2], both f32 or both bf16; the weights wx, wy (k*k values)
// and biases bx, by are read from the parameter tensors in their own dtype
// (f32 or bf16). Flow reads outside the image are zero; sums in f32, one
// division at the end; output in the flow's dtype. k in {3, 5, 7}. The
// minimal tap gives exp(0) = 1, so the divisor is >= 1 and finite even
// where every other tap underflows. r^2 and the difference are rounded
// separately (no fused multiply-add), as the plain version computes them,
// so the minimal tap's exponent is exactly 0.
//
// What bounds it on the H100: per pixel it reads k*k raw values and 2 flow
// values and writes 2, each once, so device memory (k*k values per pixel)
// is the bound; about 13 instructions per tap and pixel (a min pass, the
// exp, the divisor, 2 multiplies and 2 fused multiply-adds) and 2 shared
// reads per tap make the instruction rate and latency the next limits.
// Design:
// * A persistent grid (as many blocks as fit on the card) walks 2-D tiles
//   of 8 rows x 32 columns with blocks of 4 warps, four to an SM (on the
//   H100 7 % faster than 16-row tiles in blocks of 8 warps, two to an SM).
//   Warp w takes tile rows 2w and 2w+1, lane c
//   column c: each thread filters a vertical pixel pair, which shares each
//   weight read and each flow halo row. Row and column come from the tile
//   index, with no per-pixel division.
// * raw: the taps of one tile row are one contiguous span in memory. Each
//   warp copies its rows' spans with 16-byte cp.async into a two-stage ring
//   in shared memory, in the input dtype (bf16 on the main path). The span
//   need not be 16-byte aligned (level 6 rows are 360 B): the aligned body
//   goes by cp.async, the few elements of an unaligned head and tail by
//   plain loads into registers, stored after the current tile's compute.
//   The copy of tile i+1 overlaps the compute of tile i.
// * flow: each tile's (8+2p) x (32+2p) halo is staged once, zero-filled
//   outside the image, one 4-byte (bf16 x 2) or 8-byte (f32 x 2) cp.async
//   per pixel; each tap is then one shared read with no bounds test.
// * The normalisation in registers: a bf16 thread loads its k*k taps as
//   (k*k+1)/2 32-bit words (its span starts on either half of a word) and
//   aligns them with funnel shifts; a first pass finds min |raw|, a second
//   computes exp(m^2 - raw_j^2) per tap and accumulates the divisor and
//   both sums. Lane c's taps start c*k*k halfwords into its row, an odd
//   stride: the tap words of a warp meet at most 2-way bank conflicts
//   (for every k and row offset). The min pass compares two bf16 taps per
//   instruction.
// * The 2*k*k + 2 weights are loaded by each block from the parameter
//   tensors into shared memory as (wx_j, wy_j, wx_j+1, wy_j+1): one
//   broadcast 16-byte read per two taps, for both pixels of the pair.

#include "common.cuh"

namespace dfvo {

constexpr int kRfWarps = 4;
constexpr int kRfRowsPerWarp = 2;                     // vertical pixel pairs
constexpr int kRfRows = kRfWarps * kRfRowsPerWarp;    // tile rows
constexpr int kRfCols = 32;                           // tile columns, one lane each
constexpr int kRfThreads = kRfWarps * 32;

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

template <typename T, int K>
struct RfTile {
  static constexpr int KK = K * K;
  static constexpr int P = (K - 1) / 2;
  // bytes of raw taps in one full tile row
  static constexpr int SPAN = kRfCols * KK * static_cast<int>(sizeof(T));
  // its shared region: the span starts up to 15 bytes into its first
  // 16-byte block, and a bf16 thread's last tap word may reach 2 bytes past
  static constexpr int ROW = round16(SPAN + 16);
  static constexpr int HALO_H = kRfRows + 2 * P;
  static constexpr int HALO_W = kRfCols + 2 * P;
  static constexpr int FLOW = round16(HALO_H * HALO_W * 2 * static_cast<int>(sizeof(T)));
  static constexpr int STAGE = kRfRows * ROW + FLOW;
  // (wx_j, wy_j, wx_j+1, wy_j+1) per pair of taps, then bx, by
  static constexpr int WPAIRS = (KK + 1) / 2;
  static constexpr int WEIGHTS = round16(WPAIRS * 16 + 8);
  static constexpr int SMEM = 2 * STAGE + WEIGHTS;
};

__device__ __forceinline__ float load_param(const void* p, int i, int dtype) {
  return dtype == kFloat32 ? static_cast<const float*>(p)[i]
                           : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// One thread's k*k raw taps, read from shared memory at byte offset `off`.
template <typename T, int KK>
struct Taps;

template <int KK>
struct Taps<float, KK> {
  const float* p;
  __device__ __forceinline__ Taps(const unsigned char* smem, int off)
      : p(reinterpret_cast<const float*>(smem + off)) {}
  __device__ __forceinline__ float get(int j) const { return p[j]; }
  __device__ __forceinline__ float min_abs() const {
    float m = fabsf(p[0]);
#pragma unroll
    for (int j = 1; j < KK; ++j) m = fminf(m, fabsf(p[j]));
    return m;
  }
};

template <int KK>
struct Taps<__nv_bfloat16, KK> {
  static constexpr int NW = (KK + 1) / 2;
  uint32_t v[NW];  // tap 2i in the low half of v[i], tap 2i+1 in the high
  __device__ __forceinline__ Taps(const unsigned char* smem, int off) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(smem + (off & ~3));
    const unsigned shift = (off & 2) ? 16u : 0u;
    uint32_t raw[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) raw[i] = q[i];
#pragma unroll
    for (int i = 0; i < NW; ++i)
      v[i] = __funnelshift_r(raw[i], i + 1 < NW ? raw[i + 1] : 0u, shift);
  }
  __device__ __forceinline__ float get(int j) const {
    const uint32_t u = v[j / 2];
    return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  // min_j |tap_j|, two taps per bf16x2 min (the last word's high half is
  // the next pixel's: its low half stands in for it)
  __device__ __forceinline__ float min_abs() const {
    const uint32_t last = v[NW - 1] & 0x7fffu;
    __nv_bfloat162 m = as_bf162(last | (last << 16));
#pragma unroll
    for (int i = 0; i < NW - 1; ++i) m = __hmin2(m, as_bf162(v[i] & 0x7fff7fffu));
    return fminf(__low2float(m), __high2float(m));
  }
  static __device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
    return *reinterpret_cast<const __nv_bfloat162*>(&u);
  }
};

// exp(x) as one MUFU.EX2 (x * log2 e); results below 2^-126 flush to 0,
// which moves no sum whose divisor is >= 1
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float2 flow_pair(const unsigned char* smem, int idx, float) {
  return reinterpret_cast<const float2*>(smem)[idx];
}
__device__ __forceinline__ float2 flow_pair(const unsigned char* smem, int idx, __nv_bfloat16) {
  const uint32_t u = reinterpret_cast<const uint32_t*>(smem)[idx];
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// A head or tail element of a raw span: loaded when the copy starts,
// stored to shared memory (byte offset `off`) after the current compute.
template <typename T>
struct Pending {
  T val;
  int off = -1;
  __device__ __forceinline__ void flush(unsigned char* smem) {
    if (off >= 0) *reinterpret_cast<T*>(smem + off) = val;
    off = -1;
  }
};

struct RfGeom {
  int n, h, w, ntx, nty;
  __device__ __forceinline__ void tile(int t, int& b, int& y0, int& x0) const {
    const int tx = t % ntx;
    const int rest = t / ntx;
    y0 = (rest % nty) * kRfRows;
    b = rest / nty;
    x0 = tx * kRfCols;
  }
};

// Byte address of the first raw tap of pixel (b, y, x0).
template <typename T, int KK>
__device__ __forceinline__ uintptr_t raw_row(const T* raw, const RfGeom& g, int b, int y, int x0) {
  return reinterpret_cast<uintptr_t>(raw + ((static_cast<long long>(b) * g.h + y) * g.w + x0) * KK);
}

// Start the copies of tile (b, y0, x0) into the stage at byte offset `st`.
template <typename T, int K>
__device__ __forceinline__ void rf_stage(unsigned char* smem, int st, const T* raw,
                                         const T* flow, const RfGeom& g, int b, int y0,
                                         int x0, bool flow_vec,
                                         Pending<T> (&pend)[kRfRowsPerWarp]) {
  using Tl = RfTile<T, K>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int rr = 0; rr < kRfRowsPerWarp; ++rr) {
    const int row = warp * kRfRowsPerWarp + rr;
    const int y = y0 + row;
    if (y >= g.h) break;
    const int ncols = g.w - x0 < kRfCols ? g.w - x0 : kRfCols;
    const uintptr_t gs = raw_row<T, Tl::KK>(raw, g, b, y, x0);
    const uintptr_t ge = gs + static_cast<uintptr_t>(ncols) * Tl::KK * sizeof(T);
    const uintptr_t base = gs & ~uintptr_t(15);  // shared offset 0 of the row
    const uintptr_t a0 = (gs + 15) & ~uintptr_t(15), a1 = ge & ~uintptr_t(15);
    const uintptr_t head_end = a0 < ge ? a0 : ge;
    const uintptr_t tail_beg = a1 > head_end ? a1 : head_end;
    unsigned char* srow = smem + st + row * Tl::ROW;
    for (uintptr_t a = head_end + 16 * lane; a < tail_beg; a += 16 * 32)
      cp_async16(srow + (a - base), reinterpret_cast<const void*>(a), true);
    const int nhead = static_cast<int>((head_end - gs) / sizeof(T));
    const int ntail = static_cast<int>((ge - tail_beg) / sizeof(T));
    if (lane < nhead + ntail) {
      const uintptr_t a = lane < nhead ? gs + lane * sizeof(T)
                                       : tail_beg + (lane - nhead) * sizeof(T);
      pend[rr].val = *reinterpret_cast<const T*>(a);
      pend[rr].off = st + row * Tl::ROW + static_cast<int>(a - base);
    }
  }
  unsigned char* sf = smem + st + kRfRows * Tl::ROW;
  for (int i = threadIdx.x; i < Tl::HALO_H * Tl::HALO_W; i += kRfThreads) {
    const int hr = i / Tl::HALO_W, hc = i - hr * Tl::HALO_W;
    const int yy = y0 - Tl::P + hr, xx = x0 - Tl::P + hc;
    const bool in = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
    const T* src = in ? flow + ((static_cast<long long>(b) * g.h + yy) * g.w + xx) * 2 : flow;
    T* dst = reinterpret_cast<T*>(sf) + 2 * i;
    if (flow_vec) {
      cp_async_small<2 * sizeof(T)>(dst, src, in);
    } else {  // flow not aligned to a pixel pair: element loads (off the main path)
      dst[0] = in ? src[0] : from_f32<T>(0.f);
      dst[1] = in ? src[1] : from_f32<T>(0.f);
    }
  }
}

// One thread: the vertical pixel pair (r0, c), (r0 + 1, c) of the tile. The
// pair shares each weight read and each halo row: halo row r0 + dy + 1 is
// tap row dy + 1 of the upper pixel and tap row dy of the lower one.
template <typename T, int K>
__device__ __forceinline__ void rf_compute(const unsigned char* smem, int st, const T* raw,
                                           T* out, const RfGeom& g, int b, int y0, int x0) {
  using Tl = RfTile<T, K>;
  constexpr int KK = Tl::KK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRfRowsPerWarp;
  const int y = y0 + r0, x = x0 + lane;
  if (y >= g.h || x >= g.w) return;
  const bool lower = y + 1 < g.h;  // else the lower pixel's taps are not staged
  const float4* sw = reinterpret_cast<const float4*>(smem + 2 * Tl::STAGE);
  const float* sb = reinterpret_cast<const float*>(sw + Tl::WPAIRS);
  constexpr int tap_bytes = KK * static_cast<int>(sizeof(T));
  const int shift0 = static_cast<int>(raw_row<T, KK>(raw, g, b, y, x0) & 15);
  const int shift1 = lower ? static_cast<int>(raw_row<T, KK>(raw, g, b, y + 1, x0) & 15) : 0;
  const Taps<T, KK> t0(smem, st + r0 * Tl::ROW + shift0 + lane * tap_bytes);
  const Taps<T, KK> t1(smem, st + (r0 + 1) * Tl::ROW + shift1 + lane * tap_bytes);
  const float m0 = t0.min_abs(), m1 = t1.min_abs();
  const float mm0 = __fmul_rn(m0, m0), mm1 = __fmul_rn(m1, m1);  // min_j rounded raw_j^2

  const unsigned char* sf = smem + st + kRfRows * Tl::ROW;
  const int h0 = r0 * Tl::HALO_W + lane;
  float ax0 = 0.f, ay0 = 0.f, den0 = 0.f, ax1 = 0.f, ay1 = 0.f, den1 = 0.f;
  float2 fu[K], fl[K];  // halo rows r0 + dy (upper pixel) and r0 + dy + 1 (lower)
#pragma unroll
  for (int dx = 0; dx < K; ++dx) fu[dx] = flow_pair(sf, h0 + dx, T());
  float4 wq = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) fl[dx] = flow_pair(sf, h0 + (dy + 1) * Tl::HALO_W + dx, T());
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const int j = dy * K + dx;
      if ((j & 1) == 0) wq = sw[j / 2];
      const float wx = (j & 1) ? wq.z : wq.x, wy = (j & 1) ? wq.w : wq.y;
      const float r = t0.get(j), q = t1.get(j);
      const float e0 = exp_ftz(__fsub_rn(mm0, __fmul_rn(r, r)));
      const float e1 = exp_ftz(__fsub_rn(mm1, __fmul_rn(q, q)));
      den0 += e0;
      den1 += e1;
      ax0 = fmaf(e0, wx * fu[dx].x, ax0);
      ay0 = fmaf(e0, wy * fu[dx].y, ay0);
      ax1 = fmaf(e1, wx * fl[dx].x, ax1);
      ay1 = fmaf(e1, wy * fl[dx].y, ay1);
    }
#pragma unroll
    for (int dx = 0; dx < K; ++dx) fu[dx] = fl[dx];
  }
  T* o = out + ((static_cast<long long>(b) * g.h + y) * g.w + x) * 2;
  const float inv0 = 1.f / den0;
  store_pair(o, (ax0 + sb[0]) * inv0, (ay0 + sb[1]) * inv0);
  if (lower) {
    const float inv1 = 1.f / den1;
    store_pair(o + static_cast<long long>(g.w) * 2, (ax1 + sb[0]) * inv1, (ay1 + sb[1]) * inv1);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kRfThreads)
    reg_dist_filter_kernel(const T* __restrict__ raw, const T* __restrict__ flow,
                           const void* wx, const void* bx, const void* wy,
                           const void* by, int wdtype, T* __restrict__ out,
                           RfGeom g, bool flow_vec) {
  using Tl = RfTile<T, K>;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* sw = reinterpret_cast<float2*>(smem + 2 * Tl::STAGE);
  float* sb = reinterpret_cast<float*>(sw + 2 * Tl::WPAIRS);
  for (int j = threadIdx.x; j < 2 * Tl::WPAIRS; j += kRfThreads)  // tap KK pads the last pair
    sw[j] = j < Tl::KK ? make_float2(load_param(wx, j, wdtype), load_param(wy, j, wdtype))
                       : make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
    sb[0] = load_param(bx, 0, wdtype);
    sb[1] = load_param(by, 0, wdtype);
  }

  const int ntiles = g.n * g.nty * g.ntx;
  Pending<T> pend[kRfRowsPerWarp];
  int t = blockIdx.x;
  int b, y0, x0;
  if (t < ntiles) {
    g.tile(t, b, y0, x0);
    rf_stage<T, K>(smem, 0, raw, flow, g, b, y0, x0, flow_vec, pend);
    for (auto& p : pend) p.flush(smem);
  }
  cp_async_commit();
  for (int i = 0; t < ntiles; ++i, t += gridDim.x) {
    const int cur = (i & 1) * Tl::STAGE, nxt = ((i + 1) & 1) * Tl::STAGE;
    const int tn = t + gridDim.x;
    if (tn < ntiles) {
      int bn, yn, xn;
      g.tile(tn, bn, yn, xn);
      rf_stage<T, K>(smem, nxt, raw, flow, g, bn, yn, xn, flow_vec, pend);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // ... and every thread's
    g.tile(t, b, y0, x0);
    rf_compute<T, K>(smem, cur, raw, out, g, b, y0, x0);
    for (auto& p : pend) p.flush(smem);  // head and tail of tile tn, into the other stage
    __syncthreads();     // stage `cur` is free for the copies of the next step
  }
  cp_async_wait_all();
}

template <typename T, int K>
static int launch_rdf(const void* raw, const void* flow, const void* wx, const void* bx,
                      const void* wy, const void* by, int wdtype, void* out, int n,
                      int h, int w, cudaStream_t stream) {
  using Tl = RfTile<T, K>;
  auto kernel = reg_dist_filter_kernel<T, K>;
  // blocks that fit on the card at once, per device (the persistent grid)
  static int capacity[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (capacity[dev] == 0) {
    if ((err = allow_smem(kernel, Tl::SMEM)) != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRfThreads,
                                                             Tl::SMEM)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    capacity[dev] = sms * per_sm;
  }
  RfGeom g{n, h, w, (w + kRfCols - 1) / kRfCols, (h + kRfRows - 1) / kRfRows};
  const long long ntiles = static_cast<long long>(n) * g.ntx * g.nty;
  if (ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(ntiles < capacity[dev] ? ntiles : capacity[dev]);
  const bool flow_vec = reinterpret_cast<uintptr_t>(flow) % (2 * sizeof(T)) == 0;
  kernel<<<grid, kRfThreads, Tl::SMEM, stream>>>(
      static_cast<const T*>(raw), static_cast<const T*>(flow), wx, bx, wy, by, wdtype,
      static_cast<T*>(out), g, flow_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_rdf_k(const void* raw, const void* flow, const void* wx, const void* bx,
                        const void* wy, const void* by, int wdtype, void* out, int n,
                        int h, int w, int k, cudaStream_t s) {
  if (k == 3) return launch_rdf<T, 3>(raw, flow, wx, bx, wy, by, wdtype, out, n, h, w, s);
  if (k == 5) return launch_rdf<T, 5>(raw, flow, wx, bx, wy, by, wdtype, out, n, h, w, s);
  return launch_rdf<T, 7>(raw, flow, wx, bx, wy, by, wdtype, out, n, h, w, s);
}

}  // namespace dfvo

// raw [N,H,W,k*k] and flow [N,H,W,2] contiguous, of dtype `dtype`; wx, wy
// (k*k values), bx, by (one each) contiguous, of dtype `wdtype`; out
// [N,H,W,2] contiguous, of dtype `dtype`.
extern "C" int dfvo_reg_dist_filter(const void* raw, const void* flow, const void* wx,
                                    const void* bx, const void* wy, const void* by,
                                    int wdtype, void* out, int n, int h, int w, int k,
                                    int dtype, void* stream) {
  using namespace dfvo;
  if (n <= 0 || h <= 0 || w <= 0 || (k != 3 && k != 5 && k != 7) ||
      (wdtype != kFloat32 && wdtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_rdf_k<float>(raw, flow, wx, bx, wy, by, wdtype, out, n, h, w, k, s);
  if (dtype == kBFloat16)
    return launch_rdf_k<__nv_bfloat16>(raw, flow, wx, bx, wy, by, wdtype, out, n, h, w, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
