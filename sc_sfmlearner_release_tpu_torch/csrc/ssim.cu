// SSIM dissimilarity map, forward: hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sc_sfmlearner_release_tpu/ops/pallas_ssim.py::
// _ssim_kernel: reflect-pad by 1, the five 3x3 means (mu_x, mu_y, sigma_x^2,
// sigma_y^2, sigma_xy) with C1 = 0.01^2 and C2 = 0.03^2, and output
// clip((1 - SSIM) / 2, 0, 1). As on the TPU, no windowed intermediate
// reaches device memory: only the map is written.
//
// Bound: bytes. It must read x and y once and write the map once
// (12 B per output element; 123 MB at [16,3,256,832]).
//
// Design: each warp streams rows down a column strip of one plane.
// - Tile. A lane holds V adjacent columns of a row (V = 4, one float4, when
//   W % 4 == 0 and every pointer is 16-byte aligned; else V = 1), so a
//   warp's strip is 32*V columns wide; lanes past the image idle. The warp
//   walks the output rows [r0, r0 + rows) of its strip, reading the input
//   rows r0-1 .. r0+rows once each. Rows reflect in the index arithmetic
//   (-1 -> 1, H -> H-2).
// - Halo columns. A lane takes its neighbours' edge columns with
//   __shfl_up/down_sync. Lane 0 and lane 31 also copy the V columns beyond
//   the strip, where the image goes on there; at the image edge the
//   reflected column (-1 -> 1, W -> W-2) is the lane's own or its
//   neighbour's, so no padded copy exists.
// - Staging: a per-warp ring of STAGES rows in shared memory, filled by
//   cp.async (16-byte cp.async.cg at V = 4, 4-byte cp.async.ca at V = 1),
//   one commit group per row, so STAGES-1 rows of x and y are in flight
//   while a row is computed (2 KB per warp at V = 4). Each lane reads back
//   only the bytes it copied itself, so cp.async.wait_group orders the ring
//   and no barrier is needed. Chosen over register prefetch because the
//   rows in flight then cost no registers, which the 3x3 sums already need,
//   and over TMA because a strip's row is 512 B: one 16-byte copy per lane
//   moves it without a barrier object per stage.
// - Sums. The nine taps of every window are added in the plain version's
//   order, top-left first, row by row, so kernel and plain version round
//   alike (the build keeps -fmad=false). Streaming keeps that order: for
//   each column a lane carries the window sums of the output row above
//   (six taps done) and of the current one (three taps done) in registers;
//   each new input row completes the first, extends the second and starts
//   the next. Products x*x, y*y, x*y are taken once per tap.
// - Geometry. Blocks of WARPS independent warps; the launch picks the rows
//   per warp that leave the busiest SM the fewest warp-rows (see plan()).
//   At [16,3,256,832]: 7 strips of 128 columns, 43 rows per warp, 2016 warps
//   in 252 blocks, at most 2 blocks (16 warps) per SM.
// - Resources (nvcc 12.9, -Xptxas -v, sm_90a): V = 4: 103 registers, no
//   spills, 26,112 B static shared memory per 256-thread block, so
//   registers allow 2 blocks (16 warps, 25% occupancy) per SM, the minimum
//   that __launch_bounds__ asks for. V = 1: 53 registers, 6,528 B.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;      // warps per block; each walks its own strip chunk
constexpr int STAGES = 3;     // ring depth: STAGES-1 input rows in flight per warp
constexpr int SM_WARPS = 16;  // warps an SM needs to hide a row's latency
constexpr unsigned FULL = 0xffffffffu;
constexpr float C1 = 0.0001f;  // 0.01^2
constexpr float C2 = 0.0009f;  // 0.03^2

template <int V>
struct __align__(16) Stage {
  float x[32 * V];
  float y[32 * V];
  float hx[2][V];  // the V columns beside the strip: left (lane 0), right (lane 31)
  float hy[2][V];
};

// Copies BYTES from global `src` to shared address `dst` if `pred`; a
// predicated instruction rather than a branch.
template <int BYTES>
__device__ __forceinline__ void cp_async(bool pred, unsigned dst, const float* src) {
  if constexpr (BYTES == 16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n"
        " @p cp.async.cg.shared.global [%1], [%2], 16;\n}\n" ::"r"((int)pred),
        "r"(dst), "l"(src)
        : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n"
        " @p cp.async.ca.shared.global [%1], [%2], %3;\n}\n" ::"r"((int)pred),
        "r"(dst), "l"(src), "n"(BYTES)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load_cols(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_cols(const float* p, float (&v)[1]) { v[0] = *p; }

__device__ __forceinline__ void store_cols(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_cols(float* p, const float (&v)[1]) { __stcs(p, v[0]); }

// The row's taps for a lane's columns c0 .. c0+V-1: e[0] is column c0-1 and
// e[V+1] column c0+V, reflected at the image edge. `h` is the column beyond
// the strip that lane 0 (c0-1) or lane 31 (c0+V) loaded. Every lane calls this.
template <int V>
__device__ __forceinline__ void taps(const float (&a)[V], float h, int lane, int c0, int W,
                                     float (&e)[V + 2]) {
  const float up = __shfl_up_sync(FULL, a[V - 1], 1);  // column c0-1, from lane-1
  const float dn = __shfl_down_sync(FULL, a[0], 1);    // column c0+V, from lane+1
  float own_l, own_r;  // the partners of -1 -> 1 and W -> W-2 when the edge is here
  if constexpr (V > 1) {
    own_l = a[1];
    own_r = a[V - 2];
  } else {
    own_l = dn;
    own_r = lane == 0 ? h : up;
  }
  e[0] = c0 == 0 ? own_l : (lane == 0 ? h : up);
  e[V + 1] = c0 + V >= W ? own_r : (lane == 31 ? h : dn);
#pragma unroll
  for (int j = 0; j < V; ++j) e[j + 1] = a[j];
}

template <int V>
__global__ void __launch_bounds__(WARPS * 32, 2) ssim_kernel(
    const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
    int H, int W, int strips, int chunks, int rows, int units) {
  __shared__ Stage<V> ring[WARPS][STAGES];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int unit = blockIdx.x * WARPS + warp;
  if (unit >= units) return;  // whole warps only: the shuffles need all 32 lanes
  const int chunk = unit % chunks, strip_plane = unit / chunks;
  const int strip = strip_plane % strips, plane = strip_plane / strips;
  const int r0 = chunk * rows;
  const int n_in = min(rows, H - r0) + 2;
  const int c0 = (strip * 32 + lane) * V;
  const bool active = c0 < W;
  // Lane 0 and lane 31 also copy the V columns beside the strip, where the
  // image goes on there: one more 16-byte copy at V = 4.
  const bool halo = (lane == 0 && c0 > 0) || (lane == 31 && c0 + V < W);
  const int hoff = halo ? (lane == 0 ? -V : V) : 0;
  const int hcol = lane == 0 ? V - 1 : 0;  // the column needed, within those V
  const int64_t base = (int64_t)plane * H * W + c0;
  const float* gx = x + base;
  const float* gy = y + base;
  float* go = out + base;

  // This lane's slots; stage i lies i*STAGE bytes on. A lane past the image
  // reads zeros, not whatever an earlier kernel left in shared memory, so its
  // discarded arithmetic never takes the division's slow path.
  constexpr unsigned STAGE = sizeof(Stage<V>);
  Stage<V>* st = ring[warp];
  if (!active) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) st[i].x[lane * V + j] = st[i].y[lane * V + j] = 0.0f;
  }
  const unsigned s_x = (unsigned)__cvta_generic_to_shared(st->x + lane * V);
  const unsigned s_y = s_x + 32 * V * sizeof(float);
  const unsigned s_hx = (unsigned)__cvta_generic_to_shared(st->hx[lane != 0]);
  const unsigned s_hy = s_hx + 2 * V * sizeof(float);

  // Input row k of the chunk (image row r0-1+k; only the first and the last
  // can fall outside the image) into the stage at byte offset `at`.
  auto fetch = [&](int k, unsigned at) {
    if (k < n_in) {
      const int row = r0 - 1 + k;
      const int off = (row < 0 ? 1 : (row >= H ? H - 2 : row)) * W;
      cp_async<4 * V>(active, s_x + at, gx + off);
      cp_async<4 * V>(active, s_y + at, gy + off);
      cp_async<4 * V>(halo, s_hx + at, gx + off + hoff);
      cp_async<4 * V>(halo, s_hy + at, gy + off + hoff);
    }
    cp_async_commit();  // one group per row, empty past the end
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) fetch(k, k * STAGE);

  // acc6: the window sums of output row (input row - 1), six taps done;
  // acc3: those of output row (input row), three taps done.
  // Statistics in order: x, y, x*x, y*y, x*y.
  float acc6[5][V], acc3[5][V];
#pragma unroll
  for (int q = 0; q < 5; ++q)
#pragma unroll
    for (int j = 0; j < V; ++j) acc6[q][j] = acc3[q][j] = 0.0f;

  unsigned at = 0, prev = (STAGES - 1) * STAGE;  // the stage read now, and before
  for (int k = 0; k < n_in; ++k) {
    cp_async_wait<STAGES - 2>();
    const Stage<V>& s = *reinterpret_cast<const Stage<V>*>(
        reinterpret_cast<const char*>(st) + at);
    float a[V], b[V];
    load_cols(s.x + lane * V, a);
    load_cols(s.y + lane * V, b);
    const float ha = halo ? s.hx[lane != 0][hcol] : 0.0f;
    const float hb = halo ? s.hy[lane != 0][hcol] : 0.0f;
    fetch(k + STAGES - 1, prev);  // refills the stage read in the previous iteration
    prev = at;
    at = at + STAGE == STAGES * STAGE ? 0 : at + STAGE;

    float u[5][V + 2];
    taps<V>(a, ha, lane, c0, W, u[0]);
    taps<V>(b, hb, lane, c0, W, u[1]);
#pragma unroll
    for (int j = 0; j < V + 2; ++j) {
      u[2][j] = u[0][j] * u[0][j];
      u[3][j] = u[1][j] * u[1][j];
      u[4][j] = u[0][j] * u[1][j];
    }

    if (k >= 2) {  // input row k completes output row r0 + k - 2
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float sum[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) sum[q] = ((acc6[q][j] + u[q][j]) + u[q][j + 1]) + u[q][j + 2];
        const float inv9 = 1.0f / 9.0f;
        const float mu_x = sum[0] * inv9, mu_y = sum[1] * inv9;
        const float sigma_x = sum[2] * inv9 - mu_x * mu_x;
        const float sigma_y = sum[3] * inv9 - mu_y * mu_y;
        const float sigma_xy = sum[4] * inv9 - mu_x * mu_y;
        const float n = (2.0f * mu_x * mu_y + C1) * (2.0f * sigma_xy + C2);
        const float d = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2);
        o[j] = fminf(fmaxf((1.0f - n / d) / 2.0f, 0.0f), 1.0f);
      }
      if (active) store_cols(go + (r0 + k - 2) * W, o);
    }
#pragma unroll
    for (int q = 0; q < 5; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc6[q][j] = ((acc3[q][j] + u[q][j]) + u[q][j + 1]) + u[q][j + 2];
        acc3[q][j] = (u[q][j] + u[q][j + 1]) + u[q][j + 2];
      }
  }
}

struct Plan {
  int strips, chunks, rows, units, blocks;
};

// Rows per warp: the split that leaves the busiest SM the fewest warp-rows.
// Blocks spread over the SMs, so the busiest runs ceil(blocks / sms) of them,
// and a row costs an SM about the same whichever of its warps runs it (issue
// slots and memory alike), down to SM_WARPS warps per SM, below which a
// row's latency shows. Cached for the last shape (a training step repeats
// one shape).
template <int V>
cudaError_t plan(int P, int H, int W, Plan* p) {
  thread_local int dev_c = -1, P_c, H_c, W_c;
  thread_local Plan plan_c;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev == dev_c && P == P_c && H == H_c && W == W_c) {
    *p = plan_c;
    return cudaSuccess;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int strips = (W + 32 * V - 1) / (32 * V);
  int64_t best = INT64_MAX;
  for (int c = 1; c <= H; ++c) {
    const int rows = (H + c - 1) / c;
    if ((H + rows - 1) / rows != c) continue;  // the same split as a smaller c
    const int64_t units = (int64_t)P * strips * c;
    const int64_t blocks = (units + WARPS - 1) / WARPS;
    const int64_t warps_per_sm = (blocks + sms - 1) / sms * WARPS;
    const int64_t cost = (warps_per_sm > SM_WARPS ? warps_per_sm : SM_WARPS) * (rows + 2);
    if (cost < best) {
      best = cost;
      *p = Plan{strips, c, rows, (int)units, (int)blocks};
    }
  }
  dev_c = dev, P_c = P, H_c = H, W_c = W, plan_c = *p;
  return cudaSuccess;
}

bool use_float4(const void* x, const void* y, const void* out, int W) {
  return W % 4 == 0 && ((uintptr_t)x | (uintptr_t)y | (uintptr_t)out) % 16 == 0;
}

template <int V>
int launch(const float* x, const float* y, float* out, int P, int H, int W, cudaStream_t s) {
  Plan p;
  const cudaError_t err = plan<V>(P, H, W, &p);
  if (err != cudaSuccess) return (int)err;
  ssim_kernel<V><<<p.blocks, WARPS * 32, 0, s>>>(x, y, out, H, W, p.strips, p.chunks, p.rows,
                                                  p.units);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y [P, H, W] f32 contiguous (P = F*C planes) -> out [P, H, W] f32.
// Needs H >= 2 and W >= 2 (reflect padding) and P*H*W < 2^31. Launches on
// `stream` and returns cudaGetLastError() after the launch.
int ssim_fwd(const void* x, const void* y, void* out, int P, int H, int W, void* stream) {
  if (P == 0) return (int)cudaSuccess;
  const auto s = (cudaStream_t)stream;
  const auto xf = (const float*)x, yf = (const float*)y;
  return use_float4(x, y, out, W) ? launch<4>(xf, yf, (float*)out, P, H, W, s)
                                  : launch<1>(xf, yf, (float*)out, P, H, W, s);
}

// The launch ssim_fwd would make for these arguments, for reports: plan =
// {columns per lane, warps per block, strips per row, rows per warp, blocks}.
int ssim_plan(const void* x, const void* y, const void* out, int P, int H, int W, int* plan_out) {
  const int v = use_float4(x, y, out, W) ? 4 : 1;
  Plan p{};
  const cudaError_t err = v == 4 ? plan<4>(P, H, W, &p) : plan<1>(P, H, W, &p);
  plan_out[0] = v, plan_out[1] = WARPS, plan_out[2] = p.strips, plan_out[3] = p.rows;
  plan_out[4] = p.blocks;
  return (int)err;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
