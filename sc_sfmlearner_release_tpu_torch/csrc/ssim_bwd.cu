// SSIM dissimilarity map, backward: hand-written for Hopper (sm_90a).
//
// The counterpart of the JAX package's SSIM backward, which recomputes
// through XLA (sc_sfmlearner_release_tpu/ops/pallas_ssim.py:150-158,
// ssim_fused's custom_vjp around the Pallas _ssim_kernel): given the map's
// cotangent g it returns d/dy and, when asked, d/dx, as PyTorch's autograd
// takes the derivative of the plain version (ops/ssim.py::ssim_nchw_plain).
//
// Math, per output pixel p (window sums S over the reflect-padded 3x3):
//   val = (1 - n/d)/2 with n = (2 mx my + C1)(2 sxy + C2) and
//   d = (mx^2 + my^2 + C1)(sx + sy + C2); out = clip(val, 0, 1), whose
//   gradient passes where 0 <= val <= 1 (bounds included, as torch.clamp).
//   Five per-pixel coefficients follow (x 1/9, the mean's scale):
//   a_x, a_y (for mx, my), a_xx = a_yy (for E[x^2], E[y^2]) and a_xy.
//   The adjoint of the 3x3 mean is the transposed 3x3 sum of those maps,
//   and the adjoint of the reflect pad folds padded row/column -1 onto 1 and
//   H (W) onto H-2 (W-2): input row 1 collects window row 0 twice, input
//   row H-2 collects window row H-1 twice (weights 2 below), so rows and
//   columns 1 and n-2 collect from two window positions. Then
//     dy = T(a_y) + 2 y T(a_yy) + x T(a_xy),
//     dx = T(a_x) + 2 x T(a_yy) + y T(a_xy).
//
// Bound: bytes. It must read x, y and g once and write dy (and dx if asked):
// 16 B per element, 164 MB at [16,3,256,832] for dy alone.
//
// Design (one pass, no coefficient map reaches device memory): a block of
// 256 threads owns a 32x32 output tile of one plane.
// - It stages x and y over the tile plus a 2-pixel halo (36x36, reflected
//   in the index arithmetic; rows and columns outside the reflect range are
//   clamped and never used) in shared memory.
// - It recomputes the statistics of the 34x34 windows around the tile in
//   the forward's order (nine taps top-left first, row by row; the build
//   keeps -fmad=false), so val and with it the clip's mask are bit-equal to
//   the forward's and the plain version's; the coefficient maps go to shared
//   memory, 0 for a window outside the image. g is read once per window.
// - Each output pixel sums the 3x3 neighbourhood of each map with the
//   reflect weights and writes its gradient.
// The halo costs 27% more loads of x and y and 13% more windows than the
// tile holds; the loads hit L2. What bounds it in practice is issue slots:
// ~300 instructions per output (PERF.md has its time against the bound).
// Resources (nvcc 12.9, -Xptxas -v, sm_90a): 32 registers, no spills;
// 24,240 B of static shared memory (28,864 B with d/dx): 8 blocks of 256
// threads fit an SM, full occupancy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;           // output tile, TILE x TILE
constexpr int THREADS = 256;
constexpr int IN = TILE + 4;       // staged inputs: tile plus a 2-pixel halo
constexpr int WIN = TILE + 2;      // windows: tile plus a 1-pixel halo
constexpr float C1 = 0.0001f;      // 0.01^2
constexpr float C2 = 0.0009f;      // 0.03^2

// Reflect by one (-1 -> 1, n -> n-2), then clamp indices that only the
// windows outside the image would read.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

// How often input index i is read by the window centred at p in [i-1, i+1]:
// twice where the reflect pad folds the window's edge tap onto i.
__device__ __forceinline__ float fold(int i, int p, int n) {
  return ((i == 1 && p == 0) || (i == n - 2 && p == n - 1)) ? 2.0f : 1.0f;
}

template <bool DX>
__global__ void __launch_bounds__(THREADS) ssim_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ dy, int H, int W) {
  __shared__ float sx[IN][IN], sy[IN][IN];
  __shared__ float ay[WIN][WIN], ayy[WIN][WIN], axy[WIN][WIN];
  __shared__ float ax[DX ? WIN : 1][DX ? WIN : 1];

  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const int64_t base = (int64_t)blockIdx.z * H * W;
  const float* px = x + base;
  const float* py = y + base;
  const float* pg = g + base;

  for (int k = threadIdx.x; k < IN * IN; k += THREADS) {
    const int rr = k / IN, cc = k % IN;
    const int64_t off = (int64_t)reflect(r0 - 2 + rr, H) * W + reflect(c0 - 2 + cc, W);
    sx[rr][cc] = __ldg(px + off);
    sy[rr][cc] = __ldg(py + off);
  }
  __syncthreads();

  // Window (r0-1+ar, c0-1+ac) reads staged rows ar..ar+2, columns ac..ac+2.
  for (int k = threadIdx.x; k < WIN * WIN; k += THREADS) {
    const int ar = k / WIN, ac = k % WIN;
    const int pr = r0 - 1 + ar, pc = c0 - 1 + ac;
    float ky = 0.0f, kyy = 0.0f, kxy = 0.0f, kx = 0.0f;
    if (pr >= 0 && pr < H && pc >= 0 && pc < W) {
      float s[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float a = sx[ar + i][ac + j], b = sy[ar + i][ac + j];
          if (i == 0 && j == 0) {
            s[0] = a, s[1] = b, s[2] = a * a, s[3] = b * b, s[4] = a * b;
          } else {
            s[0] = s[0] + a, s[1] = s[1] + b, s[2] = s[2] + a * a;
            s[3] = s[3] + b * b, s[4] = s[4] + a * b;
          }
        }
      const float inv9 = 1.0f / 9.0f;
      const float mu_x = s[0] * inv9, mu_y = s[1] * inv9;
      const float sigma_x = s[2] * inv9 - mu_x * mu_x;
      const float sigma_y = s[3] * inv9 - mu_y * mu_y;
      const float sigma_xy = s[4] * inv9 - mu_x * mu_y;
      const float A = 2.0f * mu_x * mu_y + C1, B = 2.0f * sigma_xy + C2;
      const float D1 = mu_x * mu_x + mu_y * mu_y + C1, D2 = sigma_x + sigma_y + C2;
      const float n = A * B, d = D1 * D2;
      const float r = n / d;
      const float val = (1.0f - r) / 2.0f;
      const float gv = (val >= 0.0f && val <= 1.0f) ? __ldg(pg + (int64_t)pr * W + pc) : 0.0f;
      const float t = (-0.5f * gv) / d;  // d loss / d n; d loss / d d = -t * r
      const float dA = t * B, dB = t * A;
      const float dD1 = -t * r * D2, dD2 = -t * r * D1;
      const float dsxy = 2.0f * dB;
      const float dmu_y = 2.0f * mu_x * dA + 2.0f * mu_y * dD1 - 2.0f * mu_y * dD2 - mu_x * dsxy;
      ky = dmu_y * inv9;
      kyy = dD2 * inv9;
      kxy = dsxy * inv9;
      if (DX) {
        const float dmu_x = 2.0f * mu_y * dA + 2.0f * mu_x * dD1 - 2.0f * mu_x * dD2 - mu_y * dsxy;
        kx = dmu_x * inv9;
      }
    }
    ay[ar][ac] = ky;
    ayy[ar][ac] = kyy;
    axy[ar][ac] = kxy;
    if (DX) ax[ar][ac] = kx;
  }
  __syncthreads();

  // Output (i, j) = (r0+tr, c0+tc): windows i-1..i+1 are rows tr..tr+2 of
  // the maps; the input itself is staged at (tr+2, tc+2).
  for (int k = threadIdx.x; k < TILE * TILE; k += THREADS) {
    const int tr = k / TILE, tc = k % TILE;
    const int i = r0 + tr, j = c0 + tc;
    if (i >= H || j >= W) continue;
    float rw[3], cw[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      rw[q] = fold(i, i - 1 + q, H);
      cw[q] = fold(j, j - 1 + q, W);
    }
    float ty = 0.0f, tyy = 0.0f, txy = 0.0f, tx = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float ry = 0.0f, ryy = 0.0f, rxy = 0.0f, rx = 0.0f;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        ry += cw[b] * ay[tr + a][tc + b];
        ryy += cw[b] * ayy[tr + a][tc + b];
        rxy += cw[b] * axy[tr + a][tc + b];
        if (DX) rx += cw[b] * ax[tr + a][tc + b];
      }
      ty += rw[a] * ry;
      tyy += rw[a] * ryy;
      txy += rw[a] * rxy;
      if (DX) tx += rw[a] * rx;
    }
    const float xv = sx[tr + 2][tc + 2], yv = sy[tr + 2][tc + 2];
    const int64_t off = base + (int64_t)i * W + j;
    dy[off] = ty + 2.0f * yv * tyy + xv * txy;
    if (DX) dx[off] = tx + 2.0f * xv * tyy + yv * txy;
  }
}

}  // namespace

extern "C" {

// x, y, g [P, H, W] f32 contiguous (P = F*C planes, P <= 65535) -> dy, and dx
// unless it is null, [P, H, W] f32. Needs H >= 2 and W >= 2 (reflect
// padding). Launches on `stream` and returns cudaGetLastError() after it.
int ssim_bwd(const void* x, const void* y, const void* g, void* dx, void* dy, int P, int H,
             int W, void* stream) {
  if (P == 0) return (int)cudaSuccess;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, P);
  const auto s = (cudaStream_t)stream;
  const auto xf = (const float*)x, yf = (const float*)y, gf = (const float*)g;
  if (dx != nullptr)
    ssim_bwd_kernel<true><<<grid, THREADS, 0, s>>>(xf, yf, gf, (float*)dx, (float*)dy, H, W);
  else
    ssim_bwd_kernel<false><<<grid, THREADS, 0, s>>>(xf, yf, gf, nullptr, (float*)dy, H, W);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
