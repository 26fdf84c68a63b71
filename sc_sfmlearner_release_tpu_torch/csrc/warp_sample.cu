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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  int i00, i01, i10, i11;  // clamped flat pixel indices in the source plane
  float w00, w01, w10, w11;
};

template <bool BORDER>
__device__ __forceinline__ Taps make_taps(float2 g, int H, int W) {
  float x = ((g.x + 1.0f) * (float)W - 1.0f) / 2.0f;
  float y = ((g.y + 1.0f) * (float)H - 1.0f) / 2.0f;
  if (BORDER) {
    x = fminf(fmaxf(x, 0.0f), (float)W - 1.0f);
    y = fminf(fmaxf(y, 0.0f), (float)H - 1.0f);
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = x0 + 1, y1 = y0 + 1;

  Taps t;
  t.w00 = (1.0f - wy) * (1.0f - wx);
  t.w01 = (1.0f - wy) * wx;
  t.w10 = wy * (1.0f - wx);
  t.w11 = wy * wx;
  if (!BORDER) {
    const bool vx0 = x0 >= 0 && x0 <= W - 1, vx1 = x1 >= 0 && x1 <= W - 1;
    const bool vy0 = y0 >= 0 && y0 <= H - 1, vy1 = y1 >= 0 && y1 <= H - 1;
    if (!(vy0 && vx0)) t.w00 = 0.0f;
    if (!(vy0 && vx1)) t.w01 = 0.0f;
    if (!(vy1 && vx0)) t.w10 = 0.0f;
    if (!(vy1 && vx1)) t.w11 = 0.0f;
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

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
