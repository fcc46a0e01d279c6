// Tiny-output-channel "head" convolution (Cout <= 4), stride 1, plus bias.
//
// Replaces the Pallas TPU kernel _headconv_pallas (dfvo_tpu/ops/headconv.py)
// with its helpers _pick_pack and _toeplitz_weights. That kernel packed output
// pixels into the TPU matrix unit's lanes through block-Toeplitz weights; the
// packing is a TPU workaround and is not carried over: this kernel computes
// the same op directly.
//
//   out[n,y,x,co] = bias[co] + sum_{dy,dx,ci} in[n,y+dy-pad,x+dx-pad,ci] * w[dy,dx,ci,co]
//
// NHWC input in f32 or bf16, weights [k,k,Cin,Cout] in f32, odd k in 1..7,
// 'same' zero padding (pad = (k-1)/2, out-of-image reads are zero) or an
// input already padded by the caller (pad = 0), f32 accumulation, output in
// the input dtype.
//
// What bounds it on the H100: with Cout <= 4 there are at most 8 flops per
// input element per tap and no reuse across output channels, so it is
// memory-bound; each input element is needed by k*k output pixels.
// Design: one thread per output pixel computing all Cout outputs in
// registers. The whole weight tensor (at most 7*7*32*2 floats = 12.5 KB on
// the main path) is staged once per block in shared memory, where every
// thread of a warp reads the same word (a broadcast). Each tap's Cin input
// channels are read with 16-byte vector loads (8 bf16 or 4 f32 channels per
// load; a scalar loop serves channel counts that do not fill a vector). The
// k*k re-reads of an input pixel by its neighbours are served by L1; only the
// input and the Cout-wide output cross device memory once. Shared-memory
// tiling of the input halo is the next step for speed.

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

}  // namespace dfvo

// x: [n, in_h, in_w, cin]; wts: f32 [k, k, cin, cout]; bias: f32 [cout] or
// null; out: [n, out_h, out_w, cout]. pad = (k-1)/2 for 'same' zero padding
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
