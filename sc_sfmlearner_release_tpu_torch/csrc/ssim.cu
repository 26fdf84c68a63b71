// SSIM dissimilarity map, forward: hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sc_sfmlearner_release_tpu/ops/pallas_ssim.py::
// _ssim_kernel: reflect-pad by 1, the five 3x3 means (mu_x, mu_y, sigma_x^2,
// sigma_y^2, sigma_xy) with C1 = 0.01^2 and C2 = 0.03^2, and output
// clip((1 - SSIM) / 2, 0, 1). As on the TPU, no windowed intermediate
// reaches device memory: only the map is written.
//
// Bound: bytes. It must read x and y once and write the map once
// (12 B per output element). Each 32x8 block stages a (8+2)x(32+2) tile of
// x and y, halo included, in shared memory, reflecting the halo at the
// image edge (-1 -> 1, n -> n-2); the nine taps of every window then come
// from shared memory, so DRAM sees each input element about 1.3 times.
// The window sums run in the order of the plain version (rows, then
// columns, from the top-left tap) and scale by 1/9 as it does, so the two
// round alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;
constexpr int TH = 8;
constexpr float C1 = 0.0001f;  // 0.01^2
constexpr float C2 = 0.0009f;  // 0.03^2

__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  // Halo cells past a ragged edge feed no output; keep their load in bounds.
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(TW * TH) ssim_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ out, int H, int W) {
  __shared__ float sx[TH + 2][TW + 2];
  __shared__ float sy[TH + 2][TW + 2];

  const int64_t plane = (int64_t)blockIdx.z * H * W;
  const int ox = blockIdx.x * TW, oy = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  for (int k = tid; k < (TH + 2) * (TW + 2); k += TW * TH) {
    const int ly = k / (TW + 2), lx = k % (TW + 2);
    const int64_t src = plane + (int64_t)reflect(oy + ly - 1, H) * W + reflect(ox + lx - 1, W);
    sx[ly][lx] = __ldg(x + src);
    sy[ly][lx] = __ldg(y + src);
  }
  __syncthreads();

  const int gx = ox + threadIdx.x, gy = oy + threadIdx.y;
  if (gx >= W || gy >= H) return;

  float s_x = 0.0f, s_y = 0.0f, s_xx = 0.0f, s_yy = 0.0f, s_xy = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float a = sx[threadIdx.y + dy][threadIdx.x + dx];
      const float b = sy[threadIdx.y + dy][threadIdx.x + dx];
      s_x += a;
      s_y += b;
      s_xx += a * a;
      s_yy += b * b;
      s_xy += a * b;
    }
  }
  const float inv9 = 1.0f / 9.0f;
  const float mu_x = s_x * inv9, mu_y = s_y * inv9;
  const float sigma_x = s_xx * inv9 - mu_x * mu_x;
  const float sigma_y = s_yy * inv9 - mu_y * mu_y;
  const float sigma_xy = s_xy * inv9 - mu_x * mu_y;
  const float n = (2.0f * mu_x * mu_y + C1) * (2.0f * sigma_xy + C2);
  const float d = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2);
  out[plane + (int64_t)gy * W + gx] = fminf(fmaxf((1.0f - n / d) / 2.0f, 0.0f), 1.0f);
}

}  // namespace

extern "C" {

// x, y [P, H, W] f32 contiguous (P = F*C planes) -> out [P, H, W] f32.
// Needs H >= 2 and W >= 2 (reflect padding). Launches on `stream` and
// returns cudaGetLastError() after the launch.
int ssim_fwd(const void* x, const void* y, void* out, int P, int H, int W, void* stream) {
  if (P == 0) return (int)cudaSuccess;
  const dim3 threads(TW, TH);
  const dim3 blocks((W + TW - 1) / TW, (H + TH - 1) / TH, P);
  ssim_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)out, H, W);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
