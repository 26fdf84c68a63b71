// Bilinear warp sampler, forward: hand-written for Hopper (sm_90a).
//
// Replaces the TPU band-warp forward tools/bench_pallas_warp.py::_pallas_fwd
// (a one-hot MXU contraction over a banded source window, with the source
// depth split into bf16 hi/lo channels) and its XLA production sibling
// ops/warp_band.py _rung_taps/_rung_branch_fwd. Hopper gathers directly, so
// there is no band, no one-hot and no hi/lo split: the source stays fp32.
//
// Semantics: torch.nn.functional.grid_sample(mode="bilinear",
// align_corners=False) on NHWC tensors, zeros or border padding, as
// ops/grid_sample.py writes it: unnormalize, clip (border), floor, mask the
// out-of-range taps (zeros), clamp the indices, weighted sum of four taps.
//
// Bound: bytes. Per output pixel it reads 8 B of coords and the four taps
// of a C-channel fp32 source, and writes 4*C B; with C = 4 each tap is one
// 16-byte load and neighbouring threads read neighbouring source pixels
// for a smooth warp, so most taps hit L1/L2 and DRAM traffic is close to
// coords + one source pass + output (~40 B/pixel). One thread per output
// pixel; the design keeps every access a single aligned vector load.
//
// Backward (warp_sample_bwd): the counterpart of XLA's autodiff of the JAX
// gather sampler (sc_sfmlearner_release_tpu/ops/grid_sample.py) and of the
// band sampler's custom VJP (ops/warp_band.py::_band_sample_bwd), written as
// the derivative of the plain version as PyTorch's autograd takes it.
// - d(coords), summed over all C channels: one thread per output pixel, no
//   atomics. It re-gathers the four taps as the forward does (one 16-byte
//   load each at C = 4), forms each tap's dot product with dout, and applies
//   d wx/dx = 1 (floor carries no gradient), dx/dg = W/2, dy/dg = H/2.
//   A tap masked to weight 0 (zeros padding) contributes nothing; with
//   border padding the clip passes the gradient only inside [0, W-1] and
//   [0, H-1], bounds included, as torch.clamp does.
// - d(source) for the leading G channels only (on the main path G = 1: the
//   source depth; the RGB behind it is camera data and gets no gradient, so
//   no zero-filled gradient is written for it). The C entry zero-fills the
//   [F, H, W, G] gradient, then each thread scatters w * dout into the four
//   taps with atomicAdd through the clamped indices, exactly where the
//   forward gathered. A tap of weight 0 (masked, or a clamped border tap
//   with no share) is skipped: it would add 0. The atomics make the sum's
//   order, and so its last bits, vary from run to run.
// - Bound: bytes. Per output pixel it reads 8 B of coords, 4*C B of dout
//   and the four taps (one source pass from DRAM for a smooth warp), writes
//   8 B of d(coords), and zero-fills and scatters 4*G B per source pixel:
//   ~190 MB at [16,256,832,4], G = 1.
// - Resources (nvcc 12.9, -Xptxas -v, sm_90a): 48 registers at C = 4
//   (56-57 for any C), no spills, no shared memory; the forward 30-31 at
//   C = 4 (45-47 for any C).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  int i00, i01, i10, i11;  // clamped flat pixel indices in the source plane
  float w00, w01, w10, w11;
  float wx, wy;            // the x1 and y1 taps' fractions (before masking)
  bool m00, m01, m10, m11; // the tap lies in the source (always, for border)
  bool pass_x, pass_y;     // the clip passes the gradient (always, for zeros)
};

template <bool BORDER>
__device__ __forceinline__ Taps make_taps(float2 g, int H, int W) {
  float x = ((g.x + 1.0f) * (float)W - 1.0f) / 2.0f;
  float y = ((g.y + 1.0f) * (float)H - 1.0f) / 2.0f;
  Taps t;
  t.pass_x = t.pass_y = true;
  if (BORDER) {
    t.pass_x = x >= 0.0f && x <= (float)W - 1.0f;
    t.pass_y = y >= 0.0f && y <= (float)H - 1.0f;
    x = fminf(fmaxf(x, 0.0f), (float)W - 1.0f);
    y = fminf(fmaxf(y, 0.0f), (float)H - 1.0f);
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = x0 + 1, y1 = y0 + 1;

  t.wx = wx;
  t.wy = wy;
  t.w00 = (1.0f - wy) * (1.0f - wx);
  t.w01 = (1.0f - wy) * wx;
  t.w10 = wy * (1.0f - wx);
  t.w11 = wy * wx;
  t.m00 = t.m01 = t.m10 = t.m11 = true;
  if (!BORDER) {
    const bool vx0 = x0 >= 0 && x0 <= W - 1, vx1 = x1 >= 0 && x1 <= W - 1;
    const bool vy0 = y0 >= 0 && y0 <= H - 1, vy1 = y1 >= 0 && y1 <= H - 1;
    t.m00 = vy0 && vx0;
    t.m01 = vy0 && vx1;
    t.m10 = vy1 && vx0;
    t.m11 = vy1 && vx1;
    if (!t.m00) t.w00 = 0.0f;
    if (!t.m01) t.w01 = 0.0f;
    if (!t.m10) t.w10 = 0.0f;
    if (!t.m11) t.w11 = 0.0f;
  }
  const int x0c = min(max(x0, 0), W - 1), x1c = min(max(x1, 0), W - 1);
  const int y0c = min(max(y0, 0), H - 1), y1c = min(max(y1, 0), H - 1);
  t.i00 = y0c * W + x0c;
  t.i01 = y0c * W + x1c;
  t.i10 = y1c * W + x0c;
  t.i11 = y1c * W + x1c;
  return t;
}

// Same association as the plain version: ((w00*v00 + w01*v01) + w10*v10) + w11*v11.
__device__ __forceinline__ float blend(const Taps& t, float a, float b, float c, float d) {
  return t.w00 * a + t.w01 * b + t.w10 * c + t.w11 * d;
}

template <bool BORDER>
__global__ void __launch_bounds__(256) warp_sample_c4_kernel(
    const float4* __restrict__ src, const float2* __restrict__ coords,
    float4* __restrict__ out, int64_t total, int64_t plane_out, int H, int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float4* s = src + (i / plane_out) * (int64_t)H * W;
  const Taps t = make_taps<BORDER>(__ldg(coords + i), H, W);
  const float4 a = __ldg(s + t.i00), b = __ldg(s + t.i01);
  const float4 c = __ldg(s + t.i10), d = __ldg(s + t.i11);
  out[i] = make_float4(blend(t, a.x, b.x, c.x, d.x), blend(t, a.y, b.y, c.y, d.y),
                       blend(t, a.z, b.z, c.z, d.z), blend(t, a.w, b.w, c.w, d.w));
}

template <bool BORDER>
__global__ void __launch_bounds__(256) warp_sample_kernel(
    const float* __restrict__ src, const float2* __restrict__ coords,
    float* __restrict__ out, int64_t total, int64_t plane_out, int H, int W, int C) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* s = src + (i / plane_out) * (int64_t)H * W * C;
  const Taps t = make_taps<BORDER>(__ldg(coords + i), H, W);
  for (int k = 0; k < C; ++k) {
    out[i * C + k] = blend(t, __ldg(s + (int64_t)t.i00 * C + k), __ldg(s + (int64_t)t.i01 * C + k),
                           __ldg(s + (int64_t)t.i10 * C + k), __ldg(s + (int64_t)t.i11 * C + k));
  }
}

// d(coords) of one pixel from the four taps' dot products with dout (0 for a
// masked tap): d wx/dx = 1, dx/dg = W/2, and the border clip's pass flags.
__device__ __forceinline__ float2 coords_grad(const Taps& t, float d00, float d01, float d10,
                                              float d11, int H, int W) {
  if (!t.m00) d00 = 0.0f;
  if (!t.m01) d01 = 0.0f;
  if (!t.m10) d10 = 0.0f;
  if (!t.m11) d11 = 0.0f;
  const float dwx = (1.0f - t.wy) * (d01 - d00) + t.wy * (d11 - d10);
  const float dwy = (1.0f - t.wx) * (d10 - d00) + t.wx * (d11 - d01);
  return make_float2(t.pass_x ? dwx * (0.5f * (float)W) : 0.0f,
                     t.pass_y ? dwy * (0.5f * (float)H) : 0.0f);
}

// Scatter w * go into the source gradient at a tap; a tap of weight 0 adds 0.
__device__ __forceinline__ void scatter(float* ds, int idx, int G, int k, float w, float go) {
  if (w != 0.0f) atomicAdd(ds + (int64_t)idx * G + k, w * go);
}

__device__ __forceinline__ float component(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return ((a.x * b.x + a.y * b.y) + a.z * b.z) + a.w * b.w;
}

template <bool BORDER>
__global__ void __launch_bounds__(256) warp_sample_bwd_c4_kernel(
    const float4* __restrict__ src, const float2* __restrict__ coords,
    const float4* __restrict__ dout, float2* __restrict__ dcoords, float* __restrict__ dsrc,
    int64_t total, int64_t plane_out, int H, int W, int G) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t f = i / plane_out;
  const Taps t = make_taps<BORDER>(__ldg(coords + i), H, W);
  const float4 go = __ldg(dout + i);
  if (dcoords != nullptr) {
    const float4* s = src + f * (int64_t)H * W;
    const float4 a = __ldg(s + t.i00), b = __ldg(s + t.i01);
    const float4 c = __ldg(s + t.i10), d = __ldg(s + t.i11);
    dcoords[i] = coords_grad(t, dot4(go, a), dot4(go, b), dot4(go, c), dot4(go, d), H, W);
  }
  if (G > 0) {
    float* ds = dsrc + f * (int64_t)H * W * G;
    for (int k = 0; k < G; ++k) {
      const float gk = component(go, k);
      scatter(ds, t.i00, G, k, t.w00, gk);
      scatter(ds, t.i01, G, k, t.w01, gk);
      scatter(ds, t.i10, G, k, t.w10, gk);
      scatter(ds, t.i11, G, k, t.w11, gk);
    }
  }
}

template <bool BORDER>
__global__ void __launch_bounds__(256) warp_sample_bwd_kernel(
    const float* __restrict__ src, const float2* __restrict__ coords,
    const float* __restrict__ dout, float2* __restrict__ dcoords, float* __restrict__ dsrc,
    int64_t total, int64_t plane_out, int H, int W, int C, int G) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t f = i / plane_out;
  const Taps t = make_taps<BORDER>(__ldg(coords + i), H, W);
  const float* go = dout + i * C;
  if (dcoords != nullptr) {
    const float* s = src + f * (int64_t)H * W * C;
    float d00 = 0.0f, d01 = 0.0f, d10 = 0.0f, d11 = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float gk = __ldg(go + k);
      d00 += gk * __ldg(s + (int64_t)t.i00 * C + k);
      d01 += gk * __ldg(s + (int64_t)t.i01 * C + k);
      d10 += gk * __ldg(s + (int64_t)t.i10 * C + k);
      d11 += gk * __ldg(s + (int64_t)t.i11 * C + k);
    }
    dcoords[i] = coords_grad(t, d00, d01, d10, d11, H, W);
  }
  if (G > 0) {
    float* ds = dsrc + f * (int64_t)H * W * G;
    for (int k = 0; k < G; ++k) {
      const float gk = __ldg(go + k);
      scatter(ds, t.i00, G, k, t.w00, gk);
      scatter(ds, t.i01, G, k, t.w01, gk);
      scatter(ds, t.i10, G, k, t.w10, gk);
      scatter(ds, t.i11, G, k, t.w11, gk);
    }
  }
}

}  // namespace

extern "C" {

// src [F, H, W, C] f32, coords [F, Ho, Wo, 2] f32 -> out [F, Ho, Wo, C] f32,
// all contiguous. border: 0 = zeros padding, 1 = border padding.
// Launches on `stream` and returns cudaGetLastError() after the launch.
int warp_sample_fwd(const void* src, const void* coords, void* out, int F, int H,
                    int W, int C, int Ho, int Wo, int border, void* stream) {
  const int64_t plane_out = (int64_t)Ho * Wo;
  const int64_t total = (int64_t)F * plane_out;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const float2* g = (const float2*)coords;
  if (C == 4) {
    const float4* in4 = (const float4*)src;
    float4* out4 = (float4*)out;
    if (border)
      warp_sample_c4_kernel<true><<<blocks, threads, 0, s>>>(in4, g, out4, total, plane_out, H, W);
    else
      warp_sample_c4_kernel<false><<<blocks, threads, 0, s>>>(in4, g, out4, total, plane_out, H, W);
  } else {
    const float* in = (const float*)src;
    float* o = (float*)out;
    if (border)
      warp_sample_kernel<true><<<blocks, threads, 0, s>>>(in, g, o, total, plane_out, H, W, C);
    else
      warp_sample_kernel<false><<<blocks, threads, 0, s>>>(in, g, o, total, plane_out, H, W, C);
  }
  return (int)cudaGetLastError();
}

// Backward of warp_sample_fwd. src [F, H, W, C], coords [F, Ho, Wo, 2] and
// dout [F, Ho, Wo, C] f32 contiguous. Writes dcoords [F, Ho, Wo, 2] unless it
// is null, and, when G > 0, zero-fills dsrc [F, H, W, G] (the gradient of the
// leading G <= C channels of src) and scatter-adds into it. Launches on
// `stream` and returns the first CUDA error of the fill and the launch.
int warp_sample_bwd(const void* src, const void* coords, const void* dout, void* dcoords,
                    void* dsrc, int F, int H, int W, int C, int G, int Ho, int Wo, int border,
                    void* stream) {
  const int64_t plane_out = (int64_t)Ho * Wo;
  const int64_t total = (int64_t)F * plane_out;
  cudaStream_t s = (cudaStream_t)stream;
  if (G > 0) {
    const cudaError_t err =
        cudaMemsetAsync(dsrc, 0, (size_t)F * H * W * G * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (total == 0 || (G == 0 && dcoords == nullptr)) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const float2* g = (const float2*)coords;
  float2* dg = (float2*)dcoords;
  float* ds = (float*)dsrc;
  if (C == 4) {
    const float4* in4 = (const float4*)src;
    const float4* d4 = (const float4*)dout;
    if (border)
      warp_sample_bwd_c4_kernel<true><<<blocks, threads, 0, s>>>(in4, g, d4, dg, ds, total,
                                                                 plane_out, H, W, G);
    else
      warp_sample_bwd_c4_kernel<false><<<blocks, threads, 0, s>>>(in4, g, d4, dg, ds, total,
                                                                  plane_out, H, W, G);
  } else {
    const float* in = (const float*)src;
    const float* d = (const float*)dout;
    if (border)
      warp_sample_bwd_kernel<true><<<blocks, threads, 0, s>>>(in, g, d, dg, ds, total, plane_out,
                                                              H, W, C, G);
    else
      warp_sample_bwd_kernel<false><<<blocks, threads, 0, s>>>(in, g, d, dg, ds, total, plane_out,
                                                               H, W, C, G);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
