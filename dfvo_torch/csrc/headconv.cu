// Tiny-output-channel "head" convolution (Cout <= 4), stride 1, plus bias.
//
// Replaces the Pallas TPU kernel _headconv_pallas (dfvo_tpu/ops/headconv.py)
// with its helpers _pick_pack and _toeplitz_weights. That kernel packed output
// pixels into the TPU matrix unit's lanes through block-Toeplitz weights; the
// packing is a TPU workaround and is not carried over.
//
//   out[n,y,x,co] = bias[co] + sum_{dy,dx,ci} in[n,y+dy-pad,x+dx-pad,ci] * w[dy,dx,ci,co]
//
// NHWC input, 'same' zero padding (pad = (k-1)/2, out-of-image reads are
// zero) or an input already padded by the caller (pad = 0), f32
// accumulation, output in the input dtype. Two variants:
//
// tensor_core (dfvo_headconv_tc): the bf16 main path. Cin in {16, 32, 64,
// 128}, Cout <= 2, k in {3, 5, 7}, 16-byte aligned pixels. What bounds it on
// the H100: device memory. At LiteFlowNet level 2 with N = 64 the input is
// 126 MB (38 us at 3.35 TB/s) against 12.3 GFLOP; on the CUDA cores in f32
// the FLOPs alone would take 184 us, so only the tensor cores can reach the
// memory bound. Design: a block of 8 warps owns a strip of 64 staged input
// columns (64 - (k-1) output columns) and walks down a range of output
// rows, 4 rows per step. A ring of input rows lives in shared memory, filled
// by cp.async with zero-fill for out-of-image pixels (that is the 'same'
// padding), one step ahead of the compute, so each input pixel crosses
// device memory about once. Per output row the block runs one GEMM with
// (dx, co) in the N dimension:
//   P[x_in, (dx,co)] = sum_{dy,ci} X[y+dy-pad, x_in, ci] * W[dy,dx,ci,co]
// M = 64 input columns (one 16-row m-tile per warp), K = k*Cin, N = k*Cout
// padded to 8 or 16, by mma.sync.m16n8k16 (bf16 in, f32 accumulate). A warp
// computes two output rows at once, so each A fragment (ldmatrix from a
// staged row) feeds both; the B fragments (the weights) sit in registers
// where they fit in 64 of them, which holds for every head of the main path.
// The block's shared-memory reads are what limits this design (see PERF.md),
// and both choices halve them. The epilogue writes P to shared memory and
// sums the shifted diagonals, out[y, x, co] = sum_dx P[x+dx, dx, co], with
// coalesced stores. The weights are read once per block through the strides
// the caller passes (the nn.Conv2d OIHW parameter as it is) and laid out in
// B-fragment order, so the wrapper launches no cast or copy. The staged
// pixel pitch is Cin + 8 elements, which keeps the eight 16-byte rows of
// every ldmatrix on distinct banks.
//
// reg_tile (dfvo_headconv): float32 (the finetuning path: LiteFlowNet's
// main_3 heads, Cin 32, Cout 2, k 7/5/5/3/3 'same'; Monodepth2's disparity
// heads, Cin 16..128, Cout 1, k 3, pre-padded), and bf16 outside the
// tensor_core set (Cin = 3 and other channel counts, unaligned bases, Cout
// 3-4, k = 1). f32 multiply-adds on the CUDA cores (not TF32: float32 is held
// to 1e-4). What bounds it on the H100: the operations. Level 2 of an update
// (96 x 320, N = 2, k = 7, Cin 32, Cout 2) is 0.385 GFLOP a call, 5.7 us at
// the 67 TFLOP/s float32 rate, against 5 MB of input. So the design keeps
// the FMA pipe fed from registers:
//   * a block of 4 warps owns an 8 x 32 output tile and stages its input
//     with the k-1 halo in shared memory, 16 channels at a time (32 for
//     k <= 3), by cp.async with zero-fill outside the image (that is the
//     'same' padding), double-buffered: the next chunk's copy overlaps this
//     chunk's FMAs;
//   * warp s takes channel quads s (and s + 4) of every chunk (the Cin
//     reduction split over the 4 warps, so that a small map still fills the
//     card), and lane l a strip of 8 output pixels of tile row l % 8,
//     columns 8 (l / 8) ..;
//   * per (dy, channel quad) a thread reads the 8 + k - 1 staged pixels of
//     its strip's row once into registers (16-byte loads of 4 channels: the
//     8 rows of a quarter-warp sit on distinct banks, the staged row spanning
//     an odd number of 16-byte units) and runs 8 x k x 4 x Cout FMAs from
//     them, the weights read as broadcasts of 4 x Cout values per (dy, dx);
//   * the 4 warps' partial outputs are summed in shared memory in warp order
//     (a fixed order), the bias added and the tile stored densely.
// The f32 weights [k, k, Cin, Cout] (contiguous, as the wrapper passes
// them) are staged once per block by cp.async beside the first chunk, with
// Cin padded to a multiple of 4 by zeros where it is not one. Inputs whose
// pixels are not 16-byte aligned are staged element by element through the
// same buffers.

#include <algorithm>

#include "common.cuh"

namespace dfvo {

constexpr int kHeadMaxWeightBytes = 48 * 1024;

// ---- reg_tile variant ----

constexpr int kRtRows = 8;    // tile rows: the 8 lanes of a quarter-warp
constexpr int kRtSeg = 8;     // output pixels of a row per thread
constexpr int kRtStrips = 4;  // strips per tile row: the 4 quarter-warps
constexpr int kRtCols = kRtSeg * kRtStrips;
constexpr int kRtSplit = 4;  // warps of a block, each 4 channels of every chunk
constexpr int kRtThreads = 32 * kRtSplit;
// channel quads a warp takes per chunk: 2 for k <= 3 (the deep disparity
// heads take half the steps), else 1; staged channels per chunk
__host__ __device__ constexpr int rt_qpw(int k) { return k <= 3 ? 2 : 1; }
__host__ __device__ constexpr int rt_chan(int k) { return 4 * kRtSplit * rt_qpw(k); }

constexpr int kRtBatch = 8;  // loads a thread issues before their stores

// Weight rows per tap: Cin padded to a multiple of 4 (a channel quad).
__host__ __device__ inline int rt_cin4(int cin) { return (cin + 3) & ~3; }

// Byte layout of the dynamic shared memory: two staging buffers (reused for
// the warps' partial outputs at the end), then the f32 weights.
struct RtSmem {
  int row_pitch;  // bytes of a staged row: an odd number of 16-byte units
  int buf;        // bytes of one staging buffer
  int weights;    // offset of the weights
  int total;
};

__host__ __device__ inline RtSmem rt_smem(int k, int cin, int cout, int tsize) {
  RtSmem s;
  s.row_pitch = (kRtCols + k - 1) * rt_chan(k) * tsize + 16;
  s.buf = (kRtRows + k - 1) * s.row_pitch;
  const int red = static_cast<int>(sizeof(float)) * kRtSplit * kRtRows * kRtCols * cout;
  s.weights = 2 * s.buf > red ? 2 * s.buf : red;
  s.total = s.weights + static_cast<int>(sizeof(float)) * k * k * rt_cin4(cin) * cout;
  return s;
}

// Four consecutive staged channels, widened to f32.
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

struct RtArgs {
  const void* x;  // dense [n, in_h, in_w, cin]
  const float* w;  // dense f32 [k, k, cin, cout]
  const float* bias;  // f32 [cout] or null
  void* out;  // dense [n, out_h, out_w, cout]
  int n, in_h, in_w, cin, out_h, out_w, cout, pad;
  int vec;   // pixels 16-byte aligned: cp.async staging
  int wvec;  // Cin a multiple of 4 and w 16-byte aligned: cp.async of the weights
};

template <typename T, int K, int COUT>
__global__ void __launch_bounds__(kRtThreads) headconv_rt_kernel(RtArgs a) {
  constexpr int SR = kRtRows + K - 1;  // staged rows
  constexpr int SC = kRtCols + K - 1;  // staged columns
  constexpr int WIN = kRtSeg + K - 1;  // a strip's window of staged pixels
  constexpr int QPW = rt_qpw(K);
  constexpr int CH = rt_chan(K);
  extern __shared__ __align__(16) unsigned char rt_smem_raw[];
  const int cin = a.cin;
  const RtSmem lay = rt_smem(K, cin, COUT, sizeof(T));
  const int cin4 = rt_cin4(cin);
  float* ws = reinterpret_cast<float*>(rt_smem_raw + lay.weights);
  unsigned char* bufs[2] = {rt_smem_raw, rt_smem_raw + lay.buf};

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int row = tid & 7;         // the strip's tile row
  const int strip = (tid >> 3) & 3;
  const int tiles_x = (a.out_w + kRtCols - 1) / kRtCols;
  const int tiles_y = (a.out_h + kRtRows - 1) / kRtRows;
  const long long tile = blockIdx.x;
  const int x0 = static_cast<int>(tile % tiles_x) * kRtCols;
  const int y0 = static_cast<int>((tile / tiles_x) % tiles_y) * kRtRows;
  const int b = static_cast<int>(tile / (static_cast<long long>(tiles_x) * tiles_y));
  const T* xb = static_cast<const T*>(a.x) + static_cast<long long>(b) * a.in_h * a.in_w * cin;
  const int iy0 = y0 - a.pad;
  const int ix0 = x0 - a.pad;

  // chunk j (channels CH j ..) of the tile's input with its halo: staged
  // pixel (r, col) <-> input pixel (iy0 + r, ix0 + col), zero outside the
  // image and past cin
  auto stage = [&](int j, unsigned char* buf) {
    const int c0 = j * CH;
    if (a.vec) {
      constexpr int E = kVec<T>;
      constexpr int PIECES = CH / E;
      for (int i = tid; i < SR * SC * PIECES; i += kRtThreads) {
        const int pix = i / PIECES;
        const int pc = i - pix * PIECES;
        const int r = pix / SC;
        const int col = pix - r * SC;
        const int yy = iy0 + r;
        const int xx = ix0 + col;
        const int c = c0 + pc * E;
        const bool ok = yy >= 0 && yy < a.in_h && xx >= 0 && xx < a.in_w && c < cin;
        cp_async16(buf + r * lay.row_pitch + (col * CH + pc * E) * sizeof(T),
                   ok ? xb + (static_cast<long long>(yy) * a.in_w + xx) * cin + c : xb, ok);
      }
    } else {
      for (int i = tid; i < SR * SC * CH; i += kRtThreads) {
        const int pix = i / CH;
        const int cc = i - pix * CH;
        const int r = pix / SC;
        const int col = pix - r * SC;
        const int yy = iy0 + r;
        const int xx = ix0 + col;
        const int c = c0 + cc;
        const bool ok = yy >= 0 && yy < a.in_h && xx >= 0 && xx < a.in_w && c < cin;
        *reinterpret_cast<T*>(buf + r * lay.row_pitch + (col * CH + cc) * sizeof(T)) =
            ok ? xb[(static_cast<long long>(yy) * a.in_w + xx) * cin + c] : from_f32<T>(0.f);
      }
    }
  };

  const int nchunks = (cin + CH - 1) / CH;
  // weights as ws[(tap * cin4 + c) * COUT + co], zero for c >= cin: the
  // 4 x COUT values of a (tap, quad) are COUT float4s
  const int nws = K * K * cin4 * COUT;
  if (a.wvec) {
    for (int i = tid; i < nws / 4; i += kRtThreads) cp_async16(ws + 4 * i, a.w + 4 * i, true);
  } else {
    for (int i0 = tid; i0 < nws; i0 += kRtBatch * kRtThreads) {
      float v[kRtBatch];
#pragma unroll
      for (int u = 0; u < kRtBatch; ++u) {
        const int i = i0 + u * kRtThreads;
        const int co = i % COUT;
        const int c = (i / COUT) % cin4;
        const int tap = i / (COUT * cin4);
        v[u] = i < nws && c < cin ? a.w[(tap * cin + c) * COUT + co] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRtBatch; ++u)
        if (i0 + u * kRtThreads < nws) ws[i0 + u * kRtThreads] = v[u];
    }
  }
  stage(0, bufs[0]);
  cp_async_commit();  // with the weights

  float acc[kRtSeg][COUT];
#pragma unroll
  for (int p = 0; p < kRtSeg; ++p)
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[p][co] = 0.f;
  for (int j = 0; j < nchunks; ++j) {
    if (j + 1 < nchunks) {
      stage(j + 1, bufs[(j + 1) & 1]);  // its buffer's last reads ended at j - 1's barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int qq = 0; qq < QPW; ++qq) {
      const int ql = qq * kRtSplit + warp;  // the quad within the chunk
      const int quad = j * kRtSplit * QPW + ql;
      if (quad * 4 >= cin) break;
      const unsigned char* base =
          bufs[j & 1] + row * lay.row_pitch + (strip * kRtSeg * CH + ql * 4) * sizeof(T);
      const float* wq = ws + quad * 4 * COUT;
#pragma unroll 1
      for (int dy = 0; dy < K; ++dy) {
        const T* src = reinterpret_cast<const T*>(base + dy * lay.row_pitch);
        float win[WIN][4];
#pragma unroll
        for (int i = 0; i < WIN; ++i) lds4(src + i * CH, win[i]);
        const float* wd = wq + dy * K * cin4 * COUT;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          float wv[4 * COUT];  // wv[ch * COUT + co]
#pragma unroll
          for (int e = 0; e < COUT; ++e) {
            float q[4];
            lds4(wd + dx * cin4 * COUT + 4 * e, q);
#pragma unroll
            for (int m = 0; m < 4; ++m) wv[4 * e + m] = q[m];
          }
#pragma unroll
          for (int p = 0; p < kRtSeg; ++p)
#pragma unroll
            for (int ch = 0; ch < 4; ++ch)
#pragma unroll
              for (int co = 0; co < COUT; ++co)
                acc[p][co] = fmaf(win[p + dx][ch], wv[ch * COUT + co], acc[p][co]);
        }
      }
    }
    __syncthreads();  // this chunk's buffer is free
  }

  // the warps' partial outputs, red[warp][pixel][co], over the staging
  // buffers; then each output is the sum over the warps in order, plus bias
  float* red = reinterpret_cast<float*>(rt_smem_raw);
  const int px0 = row * kRtCols + strip * kRtSeg;
#pragma unroll
  for (int p = 0; p < kRtSeg; ++p)
#pragma unroll
    for (int co = 0; co < COUT; ++co)
      red[(warp * kRtRows * kRtCols + px0 + p) * COUT + co] = acc[p][co];
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < kRtRows * kRtCols; i += kRtThreads) {
    const int y = y0 + i / kRtCols;
    const int xo = x0 + i % kRtCols;
    if (y >= a.out_h || xo >= a.out_w) continue;
    T* o = out + ((static_cast<long long>(b) * a.out_h + y) * a.out_w + xo) * COUT;
#pragma unroll
    for (int co = 0; co < COUT; ++co) {
      float v = 0.f;
#pragma unroll
      for (int s = 0; s < kRtSplit; ++s) v += red[(s * kRtRows * kRtCols + i) * COUT + co];
      o[co] = from_f32<T>(a.bias != nullptr ? v + a.bias[co] : v);
    }
  }
}

template <typename T, int K, int COUT>
static int launch_headconv_rt_kc(const RtArgs& a, cudaStream_t stream) {
  const RtSmem lay = rt_smem(K, a.cin, COUT, sizeof(T));
  auto kernel = headconv_rt_kernel<T, K, COUT>;
  cudaError_t err = allow_smem(kernel, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(ceil_div(a.out_w, kRtCols)) *
                           ceil_div(a.out_h, kRtRows) * a.n;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kRtThreads, lay.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
static int launch_headconv_rt_k(const RtArgs& a, cudaStream_t s) {
  switch (a.cout) {
    case 1:
      return launch_headconv_rt_kc<T, K, 1>(a, s);
    case 2:
      return launch_headconv_rt_kc<T, K, 2>(a, s);
    case 3:
      return launch_headconv_rt_kc<T, K, 3>(a, s);
    default:
      return launch_headconv_rt_kc<T, K, 4>(a, s);
  }
}

template <typename T>
static int launch_headconv_rt(const RtArgs& a, int k, cudaStream_t s) {
  switch (k) {
    case 1:
      return launch_headconv_rt_k<T, 1>(a, s);
    case 3:
      return launch_headconv_rt_k<T, 3>(a, s);
    case 5:
      return launch_headconv_rt_k<T, 5>(a, s);
    default:
      return launch_headconv_rt_k<T, 7>(a, s);
  }
}

// ---- tensor_core variant ----

constexpr int kHcTcCols = 64;       // staged input columns per block
constexpr int kHcTcRowsPerWarp = 2;  // output rows one warp computes at once
constexpr int kHcTcWarpRows = 2;     // warp groups (4 warps each) per block
constexpr int kHcTcRowsPerStep = kHcTcRowsPerWarp * kHcTcWarpRows;
constexpr int kHcTcThreads = 128 * kHcTcWarpRows;
constexpr int kHcTcPrefetch = 1;     // steps of input rows fetched ahead

// Layout of the dynamic shared memory of headconv_tc_kernel.
struct HcTcSmem {
  int ring_elems;  // ring rows x 64 columns x pitch bf16
  int wfrag;       // uint2 B fragments: (k*cin/16) k-steps x nt x 32 lanes
  int pbuf;        // floats: rows per step x 64 x (nt*8 + 1)
  __host__ __device__ constexpr size_t bytes() const {
    return sizeof(__nv_bfloat16) * ring_elems + sizeof(uint2) * wfrag +
           sizeof(float) * pbuf;
  }
};

// Ring rows: the k - 1 + R rows one step reads, plus R per step in flight.
__host__ __device__ constexpr int hc_tc_slots(int k) {
  return k - 1 + kHcTcRowsPerStep * (kHcTcPrefetch + 1);
}

__host__ __device__ constexpr HcTcSmem hc_tc_smem(int k, int cin, int cout) {
  const int nt = (k * cout + 7) / 8;
  return {hc_tc_slots(k) * kHcTcCols * (cin + 8), (k * cin / 16) * nt * 32,
          kHcTcRowsPerStep * kHcTcCols * (nt * 8 + 1)};
}

template <int K, int COUT, int CIN>
__global__ void __launch_bounds__(kHcTcThreads)
    headconv_tc_kernel(const __nv_bfloat16* __restrict__ x, long long sxn,
                       long long sxh, long long sxw,
                       const __nv_bfloat16* __restrict__ wts, long long sw0,
                       long long sw1, long long sw2, long long sw3,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int in_h, int in_w,
                       int out_h, int out_w, int pad, int rows_per_block) {
  constexpr int NT = (K * COUT + 7) / 8;  // n-tiles of 8 over (dx, co)
  constexpr int NP = NT * 8 + 1;          // odd pitch: conflict-free epilogue
  constexpr int CS = CIN / 16;            // k-steps per input row
  constexpr int RW = kHcTcRowsPerWarp;
  constexpr int R = kHcTcRowsPerStep;
  constexpr int PF = kHcTcPrefetch;
  constexpr int SLOTS = hc_tc_slots(K);
  constexpr int TW = kHcTcCols - (K - 1);  // output columns per block
  constexpr int PITCH = CIN + 8;           // staged pixel pitch, elements
  constexpr int CHUNKS = CIN / 8;          // 16-byte chunks per pixel
  constexpr int CPT = (kHcTcCols * CHUNKS + kHcTcThreads - 1) / kHcTcThreads;
  // B fragments live in registers where they fit in 64 of them (every head
  // of the main path), else they are read from shared memory
  constexpr bool BREG = 2 * K * CS * NT <= 64;
  extern __shared__ __align__(16) unsigned char hc_tc_smem_raw[];
  constexpr HcTcSmem lay = hc_tc_smem(K, CIN, COUT);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(hc_tc_smem_raw);
  uint2* wfrag = reinterpret_cast<uint2*>(ring + lay.ring_elems);
  float* pbuf = reinterpret_cast<float*>(wfrag + lay.wfrag);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int mt = warp & 3;  // the warp's 16-column m-tile
  const int q = warp >> 2;  // the warp's pair of rows within a step
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, out_h - y0);
  const __nv_bfloat16* xb = x + b * sxn;

  // Each thread stages the same 16-byte chunks (column, channel offset) of
  // every input row, fixed for the block.
  int soff[CPT];        // offset in a ring row, elements
  long long goff[CPT];  // offset from the image row, elements
  bool cok[CPT];        // column inside the image
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int idx = tid + u * kHcTcThreads;
    const int col = idx / CHUNKS;
    const int ch = (idx % CHUNKS) * 8;
    const int ix = x0 - pad + col;
    cok[u] = ix >= 0 && ix < in_w;
    soff[u] = col * PITCH + ch;
    goff[u] = ix * sxw + ch;
  }
  // input rows y0 - pad + j for j in [j0, j1) -> ring slot j % SLOTS, zero
  // outside the image
  auto stage_rows = [&](int j0, int j1) {
    for (int j = j0; j < j1; ++j) {
      const int iy = y0 - pad + j;
      const bool rok = iy >= 0 && iy < in_h;
      const __nv_bfloat16* src = xb + (rok ? iy * sxh : 0);
      __nv_bfloat16* dst = ring + (j % SLOTS) * kHcTcCols * PITCH;
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const bool ok = rok && cok[u];
        if (tid + u * kHcTcThreads < kHcTcCols * CHUNKS)
          cp_async16(dst + soff[u], ok ? src + goff[u] : xb, ok);
      }
    }
  };
  // Input rows needed through step s: j < s*R + R + K - 1. Groups: the first
  // K - 1 rows, then R rows per step.
  const int need = rows + K - 1;
  stage_rows(0, K - 1);
  cp_async_commit();
  for (int p = 0; p < PF; ++p) {
    stage_rows(min(K - 1 + p * R, need), min(K - 1 + (p + 1) * R, need));
    cp_async_commit();
  }

  // weights as B[dy*CIN + ci][dx*COUT + co] in m16n8k16 B-fragment order,
  // through shared memory into registers
  for (int i = tid; i < lay.wfrag; i += kHcTcThreads) {
    const int l = i & 31;
    const int nt = (i >> 5) % NT;
    const int s = (i >> 5) / NT;
    const int n = nt * 8 + (l >> 2);
    const int dy = s / CS;
    const int ci0 = (s % CS) * 16 + 2 * (l & 3);
    __nv_bfloat16 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = ci0 + (e & 1) + (e >> 1) * 8;
      v[e] = n < K * COUT ? wts[dy * sw0 + (n / COUT) * sw1 + ci * sw2 +
                                (n % COUT) * sw3]
                          : __float2bfloat16(0.f);
    }
    wfrag[i] = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  }
  __syncthreads();
  uint2 bw[BREG ? K : 1][BREG ? CS : 1][BREG ? NT : 1];
  if constexpr (BREG) {
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int cs = 0; cs < CS; ++cs)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          bw[dy][cs][nt] = wfrag[((dy * CS + cs) * NT + nt) * 32 + lane];
  }
  float bv = 0.f;
  const int etid = tid & 127;  // epilogue: thread etid of a row
  if (bias != nullptr && etid < TW * COUT) bv = __bfloat162float(bias[etid % COUT]);

  const int g = lane >> 2;
  const int t = lane & 3;
  const int tw = min(TW, out_w - x0);
  for (int r0 = 0; r0 < rows; r0 += R) {
    // into the slots of the rows the previous step began with, free since
    // its last barrier
    const int j0 = min(K - 1 + r0 + PF * R, need);
    stage_rows(j0, min(j0 + R, need));
    cp_async_commit();
    cp_async_wait<PF>();  // rows up to r0 + R + K - 2 have landed
    __syncthreads();

    // output rows r and r + 1 of this warp: input row r + j feeds row r with
    // dy = j and row r + 1 with dy = j - 1, so each A fragment is loaded once
    // for both
    const int r = r0 + q * RW;
    if (r < rows) {
      float acc[RW][NT][4];
#pragma unroll
      for (int w = 0; w < RW; ++w)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[w][nt][e] = 0.f;
#pragma unroll
      for (int j = 0; j < K + RW - 1; ++j) {
        const __nv_bfloat16* arow = ring + ((r + j) % SLOTS) * kHcTcCols * PITCH +
                                    (mt * 16 + (lane & 15)) * PITCH + (lane >> 4) * 8;
#pragma unroll
        for (int cs = 0; cs < CS; ++cs) {
          uint32_t a[4];
          ldmatrix_x4(a, arow + cs * 16);
#pragma unroll
          for (int w = 0; w < RW; ++w) {
            const int dy = j - w;
            if (dy >= 0 && dy < K) {
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const uint2 bb = BREG ? bw[BREG ? dy : 0][BREG ? cs : 0][BREG ? nt : 0]
                                      : wfrag[((dy * CS + cs) * NT + nt) * 32 + lane];
                mma_bf16_16816(acc[w][nt], a, bb.x, bb.y);
              }
            }
          }
        }
      }
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        float* prow = pbuf + (q * RW + w) * kHcTcCols * NP;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            prow[(mt * 16 + g + 8 * (e >> 1)) * NP + nt * 8 + 2 * t + (e & 1)] =
                acc[w][nt][e];
      }
    }
    __syncthreads();

    // out[y, x, co] = bias + sum_dx P[x + dx, dx*COUT + co], one row per 128
    // threads at a time
    for (int rr = tid >> 7; rr < R; rr += kHcTcWarpRows) {
      if (r0 + rr < rows && etid < tw * COUT) {
        const float* prow = pbuf + rr * kHcTcCols * NP;
        const int xo = etid / COUT;
        const int co = etid - xo * COUT;
        float v = bv;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) v += prow[(xo + dx) * NP + dx * COUT + co];
        out[((static_cast<long long>(b) * out_h + y0 + r0 + rr) * out_w + x0) * COUT + etid] =
            __float2bfloat16(v);
      }
    }
  }
}

template <int K, int COUT, int CIN>
static int launch_headconv_tc_kc(const void* x, const long long* sx,
                                 const void* wts, const long long* sw,
                                 const void* bias, void* out, int n, int in_h,
                                 int in_w, int out_h, int out_w, int pad,
                                 cudaStream_t stream) {
  constexpr int TW = kHcTcCols - (K - 1);
  constexpr size_t smem = hc_tc_smem(K, CIN, COUT).bytes();
  auto kernel = headconv_tc_kernel<K, COUT, CIN>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about 1024 blocks: enough to fill 132 SMs several times over, with row
  // ranges long enough that the k-1 halo rows are a small extra
  const int strips = static_cast<int>(ceil_div(out_w, TW));
  const long long want = ceil_div(1024, static_cast<long long>(strips) * n);
  const int chunks = static_cast<int>(std::min<long long>(out_h, std::max<long long>(1, want)));
  const int rows = static_cast<int>(ceil_div(out_h, chunks));
  const dim3 grid(strips, ceil_div(out_h, rows), n);
  kernel<<<grid, kHcTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), sx[0], sx[1], sx[2],
      static_cast<const __nv_bfloat16*>(wts), sw[0], sw[1], sw[2], sw[3],
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      in_h, in_w, out_h, out_w, pad, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int COUT>
static int launch_headconv_tc_k(const void* x, const long long* sx,
                                const void* wts, const long long* sw,
                                const void* bias, void* out, int n, int in_h,
                                int in_w, int cin, int out_h, int out_w,
                                int pad, cudaStream_t s) {
  switch (cin) {
    case 16:
      return launch_headconv_tc_kc<K, COUT, 16>(x, sx, wts, sw, bias, out, n, in_h, in_w, out_h, out_w, pad, s);
    case 32:
      return launch_headconv_tc_kc<K, COUT, 32>(x, sx, wts, sw, bias, out, n, in_h, in_w, out_h, out_w, pad, s);
    case 64:
      return launch_headconv_tc_kc<K, COUT, 64>(x, sx, wts, sw, bias, out, n, in_h, in_w, out_h, out_w, pad, s);
    case 128:
      return launch_headconv_tc_kc<K, COUT, 128>(x, sx, wts, sw, bias, out, n, in_h, in_w, out_h, out_w, pad, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int K>
static int launch_headconv_tc(const void* x, const long long* sx,
                              const void* wts, const long long* sw,
                              const void* bias, void* out, int n, int in_h,
                              int in_w, int cin, int out_h, int out_w,
                              int cout, int pad, cudaStream_t s) {
  if (cout == 1)
    return launch_headconv_tc_k<K, 1>(x, sx, wts, sw, bias, out, n, in_h, in_w,
                                      cin, out_h, out_w, pad, s);
  return launch_headconv_tc_k<K, 2>(x, sx, wts, sw, bias, out, n, in_h, in_w,
                                    cin, out_h, out_w, pad, s);
}

}  // namespace dfvo

// reg_tile variant. x: dense [n, in_h, in_w, cin]; wts: dense f32 [k, k,
// cin, cout]; bias: f32 [cout] or null; out: dense [n, out_h, out_w, cout].
// pad = (k-1)/2 for 'same' zero padding (out = in size), 0 for a pre-padded
// input (out = in - (k-1)).
extern "C" int dfvo_headconv(const void* x, const void* wts, const void* bias,
                             void* out, int n, int in_h, int in_w, int cin,
                             int out_h, int out_w, int k, int cout, int pad,
                             int dtype, void* stream) {
  using namespace dfvo;
  if (n <= 0 || out_h <= 0 || out_w <= 0 || cin <= 0 || k < 1 || k > 7 ||
      k % 2 == 0 || cout < 1 || cout > 4 ||
      sizeof(float) * k * k * cin * cout > kHeadMaxWeightBytes ||
      (pad != 0 && 2 * pad != k - 1) || out_h != in_h + 2 * pad - (k - 1) ||
      out_w != in_w + 2 * pad - (k - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RtArgs a{x, static_cast<const float*>(wts), static_cast<const float*>(bias), out,
           n, in_h, in_w, cin, out_h, out_w, cout, pad, 0,
           cin % 4 == 0 && reinterpret_cast<uintptr_t>(wts) % 16 == 0};
  if (dtype == kFloat32) {
    a.vec = vec_ok<float>(x, cin);
    return launch_headconv_rt<float>(a, k, s);
  }
  if (dtype == kBFloat16) {
    a.vec = vec_ok<__nv_bfloat16>(x, cin);
    return launch_headconv_rt<__nv_bfloat16>(a, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// tensor_core variant. x: bf16 [n, in_h, in_w, cin] with element strides
// sxn, sxh, sxw and unit channel stride, 16-byte aligned pixels; wts: bf16,
// element (dy, dx, ci, co) at wts[dy*sw0 + dx*sw1 + ci*sw2 + co*sw3]; bias:
// bf16 [cout] or null; out: dense bf16 [n, out_h, out_w, cout]. pad as
// dfvo_headconv.
extern "C" int dfvo_headconv_tc(const void* x, long long sxn, long long sxh,
                                long long sxw, const void* wts, long long sw0,
                                long long sw1, long long sw2, long long sw3,
                                const void* bias, void* out, int n, int in_h,
                                int in_w, int cin, int out_h, int out_w, int k,
                                int cout, int pad, void* stream) {
  using namespace dfvo;
  if (n <= 0 || n > 65535 || out_h <= 0 || out_w <= 0 ||
      (cin != 16 && cin != 32 && cin != 64 && cin != 128) ||
      (k != 3 && k != 5 && k != 7) ||
      cout < 1 || cout > 2 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      sxn % 8 != 0 || sxh % 8 != 0 || sxw % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long sx[3] = {sxn, sxh, sxw};
  const long long sw[4] = {sw0, sw1, sw2, sw3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 3)
    return launch_headconv_tc<3>(x, sx, wts, sw, bias, out, n, in_h, in_w, cin, out_h, out_w, cout, pad, s);
  if (k == 5)
    return launch_headconv_tc<5>(x, sx, wts, sw, bias, out, n, in_h, in_w, cin, out_h, out_w, cout, pad, s);
  return launch_headconv_tc<7>(x, sx, wts, sw, bias, out, n, in_h, in_w, cin, out_h, out_w, cout, pad, s);
}
