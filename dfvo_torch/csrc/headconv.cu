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
// cuda_core (dfvo_headconv): float32, Cin = 3 and other odd shapes, and
// unaligned bases. One thread per output pixel computing all Cout outputs
// in registers on the CUDA cores in f32; f32 weights staged once per block
// in shared memory (broadcast reads); each tap's Cin channels read with
// 16-byte vector loads where aligned, else a scalar loop. Float32 stays in
// true f32 (TF32 tensor cores would not hold 1e-4).

#include <algorithm>

#include "common.cuh"

namespace dfvo {

constexpr int kHeadBlock = 128;
constexpr int kHeadMaxWeightBytes = 48 * 1024;

template <typename T, int COUT, bool VEC>
__global__ void __launch_bounds__(kHeadBlock)
    headconv_kernel(const T* __restrict__ x, const float* __restrict__ wts,
                    const float* __restrict__ bias, T* __restrict__ out, int n,
                    int in_h, int in_w, int cin, int out_h, int out_w, int k,
                    int pad) {
  extern __shared__ float head_smem[];
  const int nw = k * k * cin * COUT;
  for (int i = threadIdx.x; i < nw; i += kHeadBlock) head_smem[i] = wts[i];
  __syncthreads();

  const long long pix = static_cast<long long>(blockIdx.x) * kHeadBlock + threadIdx.x;
  const long long total = static_cast<long long>(n) * out_h * out_w;
  if (pix >= total) return;
  const int ox = static_cast<int>(pix % out_w);
  const int oy = static_cast<int>((pix / out_w) % out_h);
  const long long b = pix / (static_cast<long long>(out_w) * out_h);

  float acc[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) acc[co] = 0.f;

  for (int dy = 0; dy < k; ++dy) {
    const int iy = oy + dy - pad;
    if (iy < 0 || iy >= in_h) continue;
    for (int dx = 0; dx < k; ++dx) {
      const int ix = ox + dx - pad;
      if (ix < 0 || ix >= in_w) continue;
      const T* xp = x + ((b * in_h + iy) * in_w + ix) * cin;
      const float* wp = head_smem + (dy * k + dx) * cin * COUT;
      if constexpr (VEC) {
        constexpr int E = kVec<T>;
        for (int ci = 0; ci < cin; ci += E) {
          float v[E];
          load16(xp + ci, v);
#pragma unroll
          for (int e = 0; e < E; ++e) {
#pragma unroll
            for (int co = 0; co < COUT; ++co)
              acc[co] += v[e] * wp[(ci + e) * COUT + co];
          }
        }
      } else {
        for (int ci = 0; ci < cin; ++ci) {
          const float v = to_f32(xp[ci]);
#pragma unroll
          for (int co = 0; co < COUT; ++co) acc[co] += v * wp[ci * COUT + co];
        }
      }
    }
  }

  T* o = out + pix * COUT;
#pragma unroll
  for (int co = 0; co < COUT; ++co)
    o[co] = from_f32<T>(bias != nullptr ? acc[co] + bias[co] : acc[co]);
}

template <typename T, int COUT>
static void launch_headconv_cout(const void* x, const void* wts,
                                 const void* bias, void* out, int n, int in_h,
                                 int in_w, int cin, int out_h, int out_w,
                                 int k, int pad, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * out_h * out_w;
  const size_t smem = sizeof(float) * k * k * cin * COUT;
  const unsigned int grid = ceil_div(total, kHeadBlock);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(wts);
  const float* bp = static_cast<const float*>(bias);
  T* o = static_cast<T*>(out);
  if (vec_ok<T>(x, cin))
    headconv_kernel<T, COUT, true><<<grid, kHeadBlock, smem, stream>>>(
        xp, wp, bp, o, n, in_h, in_w, cin, out_h, out_w, k, pad);
  else
    headconv_kernel<T, COUT, false><<<grid, kHeadBlock, smem, stream>>>(
        xp, wp, bp, o, n, in_h, in_w, cin, out_h, out_w, k, pad);
}

template <typename T>
static void launch_headconv(const void* x, const void* wts, const void* bias,
                            void* out, int n, int in_h, int in_w, int cin,
                            int out_h, int out_w, int k, int cout, int pad,
                            cudaStream_t s) {
  switch (cout) {
    case 1:
      launch_headconv_cout<T, 1>(x, wts, bias, out, n, in_h, in_w, cin, out_h, out_w, k, pad, s);
      break;
    case 2:
      launch_headconv_cout<T, 2>(x, wts, bias, out, n, in_h, in_w, cin, out_h, out_w, k, pad, s);
      break;
    case 3:
      launch_headconv_cout<T, 3>(x, wts, bias, out, n, in_h, in_w, cin, out_h, out_w, k, pad, s);
      break;
    default:
      launch_headconv_cout<T, 4>(x, wts, bias, out, n, in_h, in_w, cin, out_h, out_w, k, pad, s);
      break;
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

// cuda_core variant. x: [n, in_h, in_w, cin]; wts: f32 [k, k, cin, cout];
// bias: f32 [cout] or null; out: [n, out_h, out_w, cout]. pad = (k-1)/2 for 'same' zero padding
// (out = in size), 0 for a pre-padded input (out = in - (k-1)).
extern "C" int dfvo_headconv(const void* x, const void* wts, const void* bias,
                             void* out, int n, int in_h, int in_w, int cin,
                             int out_h, int out_w, int k, int cout, int pad,
                             int dtype, void* stream) {
  using namespace dfvo;
  if (n <= 0 || out_h <= 0 || out_w <= 0 || cin <= 0 || k < 1 || k > 7 ||
      k % 2 == 0 || cout < 1 || cout > 4 ||
      sizeof(float) * k * k * cin * cout > kHeadMaxWeightBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_headconv<float>(x, wts, bias, out, n, in_h, in_w, cin, out_h, out_w, k, cout, pad, s);
  else if (dtype == kBFloat16)
    launch_headconv<__nv_bfloat16>(x, wts, bias, out, n, in_h, in_w, cin, out_h, out_w, k, cout, pad, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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
