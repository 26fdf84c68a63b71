// Plane-sweep cost volume (ManyDepth's matching encoder), forward only:
// hand-written for Hopper (sm_90a).
//
// For each pixel of the current frame's feature map (1/4 resolution) and
// each of D depth bins, backproject the pixel at that depth (inv_K), project
// it into the lookup frame (P = K * T, 3 x 4), sample the lookup features
// bilinearly (F.grid_sample, align_corners=True, zeros padding) and take the
// channel mean of |warped - current|, times the edge mask (projected x in
// [2, w - 2] and y in [2, h - 2], the current pixel at least 2 from the
// border). The same launch then does the rest of the public code's per-pixel
// work: the division by (count + 1e-7) (one lookup frame, count 0 or 1), the
// missing bins (cost 0) set to the pixel's maximum over bins, the confidence
// mask (every bin observed), the volume times that mask, and the per-pixel
// argmin over bins (zeros ignored), returned as 1 / depth of that bin.
//
// Arithmetic: the public code's formulas in its order (pix / (z + 1e-7),
// normalized by (size - 1), unnormalized by grid_sample's ((g + 1) / 2) *
// (size - 1), PyTorch's four bilinear weights and their order nw, ne, sw,
// se), with -fmad=false. The channel sum runs over channels in order, so its
// last bits differ from PyTorch's reduction: a near tie between two bins can
// pick the other bin.
//
// Design: one thread per current pixel, which keeps its C = 64 current
// features in registers and loops over the bins. The lookup features stay
// NCHW: for a tap, neighbouring threads (neighbouring x) read neighbouring
// floats of one channel plane, so each warp-wide load touches one or two
// cache lines and the taps are served from L1/L2 (the lookup map is 2 MB a
// sample). Masked bins skip their taps. The first pass writes each bin's
// cost to the output and keeps the maximum; the second reads the thread's
// own costs back, fills, masks and takes the argmin. Bound: L1/L2 load
// throughput of the taps (4 C loads per pixel and bin), far above the
// roofline's one pass over inputs and outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int C>
__global__ void __launch_bounds__(128) cost_volume_kernel(
    const float* __restrict__ cur, const float* __restrict__ lookup,
    const float* __restrict__ proj, const float* __restrict__ inv_k,
    const float* __restrict__ bins, float* __restrict__ volume, float* __restrict__ lowest,
    float* __restrict__ confidence, int B, int D, int H, int W) {
  const int64_t plane = (int64_t)H * W;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * plane) return;
  const int b = (int)(i / plane);
  const int64_t p = i - (int64_t)b * plane;
  const int y = (int)(p / W), x = (int)(p - (int64_t)y * W);

  const float* cb = cur + (int64_t)b * C * plane + p;
  float c[C];
#pragma unroll
  for (int k = 0; k < C; ++k) c[k] = __ldg(cb + k * plane);
  const float* lb = lookup + (int64_t)b * C * plane;

  const float* ik = inv_k + b * 9;
  const float* P = proj + b * 12;
  const float fx = (float)x, fy = (float)y;
  // inv_K[:3, :3] @ [x, y, 1]
  const float r0 = __ldg(ik + 0) * fx + __ldg(ik + 1) * fy + __ldg(ik + 2);
  const float r1 = __ldg(ik + 3) * fx + __ldg(ik + 4) * fy + __ldg(ik + 5);
  const float r2 = __ldg(ik + 6) * fx + __ldg(ik + 7) * fy + __ldg(ik + 8);
  const bool inner = x >= 2 && x <= W - 3 && y >= 2 && y <= H - 3;
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);

  float* vb = volume + (int64_t)b * D * plane + p;
  float vmax = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float depth = __ldg(bins + d);
    const float X = depth * r0, Y = depth * r1, Z = depth * r2;
    const float px = __ldg(P + 0) * X + __ldg(P + 1) * Y + __ldg(P + 2) * Z + __ldg(P + 3);
    const float py = __ldg(P + 4) * X + __ldg(P + 5) * Y + __ldg(P + 6) * Z + __ldg(P + 7);
    const float pz = __ldg(P + 8) * X + __ldg(P + 9) * Y + __ldg(P + 10) * Z + __ldg(P + 11);
    const float zd = pz + 1e-7f;
    const float gx = (px / zd / wm1 - 0.5f) * 2.0f;
    const float gy = (py / zd / hm1 - 0.5f) * 2.0f;
    const float xv = (gx / 2.0f + 0.5f) * wm1;
    const float yv = (gy / 2.0f + 0.5f) * hm1;
    float v = 0.0f;
    if (inner && xv >= 2.0f && xv <= (float)(W - 2) && yv >= 2.0f && yv <= (float)(H - 2)) {
      const float ix = ((gx + 1.0f) / 2.0f) * wm1;
      const float iy = ((gy + 1.0f) / 2.0f) * hm1;
      const float x0f = floorf(ix), y0f = floorf(iy);
      const int x0 = (int)x0f, y0 = (int)y0f;
      const float x1f = x0f + 1.0f, y1f = y0f + 1.0f;
      const float nw = (x1f - ix) * (y1f - iy);
      const float ne = (ix - x0f) * (y1f - iy);
      const float sw = (x1f - ix) * (iy - y0f);
      const float se = (ix - x0f) * (iy - y0f);
      const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
      const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
      const bool mnw = vx0 && vy0, mne = vx1 && vy0, msw = vx0 && vy1, mse = vx1 && vy1;
      const float* t = lb + (int64_t)y0 * W + x0;
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < C; ++k) {  // unrolled whole: c[] stays in registers
        const float* tk = t + k * plane;
        float s = 0.0f;
        if (mnw) s = s + __ldg(tk) * nw;
        if (mne) s = s + __ldg(tk + 1) * ne;
        if (msw) s = s + __ldg(tk + W) * sw;
        if (mse) s = s + __ldg(tk + W + 1) * se;
        sum += fabsf(s - c[k]);
      }
      const float mean = sum / (float)C;
      // count is 1 where the cost is positive: cost / (1 + 1e-7).
      v = mean > 0.0f ? mean / (1.0f + 1e-7f) : 0.0f;
    }
    vb[(int64_t)d * plane] = v;
    vmax = fmaxf(vmax, v);
  }

  bool all = true;
  for (int d = 0; d < D; ++d) all = all && vb[(int64_t)d * plane] != 0.0f;
  const float conf = all ? 1.0f : 0.0f;
  float best = 0.0f;
  int arg = 0;
  for (int d = 0; d < D; ++d) {
    const float v = vb[(int64_t)d * plane];
    const float filled = v == 0.0f ? vmax : v;
    const float viz = filled == 0.0f ? 100.0f : filled;
    if (d == 0 || viz < best) {
      best = viz;
      arg = d;
    }
    vb[(int64_t)d * plane] = filled * conf;
  }
  lowest[i] = 1.0f / __ldg(bins + arg);
  confidence[i] = conf;
}

}  // namespace

extern "C" {

// cur, lookup [B, C, H, W]; proj [B, 3, 4]; inv_k [B, 3, 3]; bins [D]: all
// f32 contiguous on one device. Writes volume [B, D, H, W], lowest [B, H, W]
// and confidence [B, H, W]. C must be 64. Launches on `stream` and returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for C != 64).
int cost_volume_fwd(const void* cur, const void* lookup, const void* proj, const void* inv_k,
                    const void* bins, void* volume, void* lowest, void* confidence, int B,
                    int C, int D, int H, int W, void* stream) {
  if (C != 64) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * H * W;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cost_volume_kernel<64><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)lookup, (const float*)proj, (const float*)inv_k,
      (const float*)bins, (float*)volume, (float*)lowest, (float*)confidence, B, D, H, W);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
