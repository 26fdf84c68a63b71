// SSIM dissimilarity map, backward: hand-written for Hopper (sm_90a).
//
// The counterpart of the JAX package's SSIM backward, which recomputes
// through XLA (sc_sfmlearner_release_tpu/ops/pallas_ssim.py:150-158,
// ssim_fused's custom_vjp around the Pallas _ssim_kernel): given the map's
// cotangent g it returns d/dy and, when asked, d/dx, as PyTorch's autograd
// takes the derivative of the plain version (ops/ssim.py::ssim_nchw_plain).
// ops/ssim.py::ssim_nchw_bwd_plain writes the same algorithm in tensor ops.
//
// Math, per window (pixel) p, with window sums S over the reflect-padded 3x3:
//   val = (1 - n/d)/2 with n = A B, d = D1 D2, A = 2 mx my + C1,
//   B = 2 sxy + C2, D1 = mx^2 + my^2 + C1, D2 = sx + sy + C2;
//   out = clip(val, 0, 1), whose gradient passes where 0 <= val <= 1 (bounds
//   included, as torch.clamp). With t = -g/(9 d) (2/9 of d loss / d n) the
//   coefficients, each d loss / d S of one window sum, are
//     a_xy = t A, 2 a_yy = -t r D1 (r = n/d),
//     a_y = mx (t B - t A) + my (-t r D2 + t r D1),
//     a_x = my (t B - t A) + mx (-t r D2 + t r D1).
//   The adjoint of the 3x3 window is the transposed 3x3 sum T of each map;
//   the adjoint of the reflect pad adds window row/column 0 once more at
//   index 1 and n-1 once more at n-2 (for n = 2, index 1 is n-1 and index 0
//   is n-2: each then takes the other's window twice). Then
//     dy = T(a_y) + y T(2 a_yy) + x T(a_xy),
//     dx = T(a_x) + x T(2 a_yy) + y T(a_xy).
//
// Bound: bytes. It must read x, y and g once and write dy (and dx if asked):
// 16 B per element (20 B with d/dx), 164 MB at [16,3,256,832] for dy alone.
//
// Design: each warp streams rows down a column strip of one plane, as the
// forward (ssim.cu) does, and keeps everything between the loads and the
// stores in registers: no coefficient map reaches shared or device memory
// and no block barrier is needed. What the design does about the instruction
// rate, which bound the kernel's first, tiled version (32x32 tiles staged
// with a halo in shared memory, ~300 instructions per output): every window
// is computed once per strip, its coefficients once, and each output takes
// its nine window contributions as two adds across (shuffled neighbours)
// and two adds down (carried partial sums), ~130 instructions per output
// as counted from the source.
// - Tile. A lane holds V adjacent columns of a row (V = 4, one float4, when
//   W % 4 == 0 and all five pointers are 16-byte aligned; else V = 1). Each
//   warp walks the output rows [r0, r0 + rows) of its strip and reads the
//   input rows r0-2 .. r0+rows+1 once each (reflected in the index
//   arithmetic; rows that only a window outside the image reads are
//   clamped): output row i needs windows i-1 .. i+1, which need input rows
//   i-2 .. i+2.
// - Strips overlap. An output needs the coefficients of the windows beside
//   it, and those windows the inputs beside them: two columns either side.
//   A warp computes the windows of all its 32*V columns but writes only the
//   columns of its inner lanes (lanes 1..30 at V = 4, 2..29 at V = 1), whose
//   neighbours it holds; the first strip also writes its first lanes, since
//   left of column 0 lies no window. Strip s holds columns [120s, 120s+128)
//   (28s at V = 1) and writes [120s+4, 120s+124): 7 strips per 832-column
//   row, as the forward has, with 6.7% more windows and loads than outputs.
//   Each strip's loads start on a 32-byte sector: the card's time follows
//   the sectors a layout requests, re-read or not (tools/ssim_variants.py's
//   memory-only twins; strips 16 B off the sectors cost ~10%, PERF.md).
//   Chosen over a 2-column halo because that costs every lane a fifth
//   window column at V = 4 (lanes wait on lanes 0 and 31 in SIMT) and
//   requests the neighbours' sectors all the same.
// - Staging: a per-warp ring of STAGES rows of x, y and g in shared memory,
//   filled by cp.async (16-byte cp.async.cg at V = 4, 4-byte cp.async.ca at
//   V = 1), one commit group per row. Row k is read for its taps, row k-1
//   for g at the window centres, row k-2 for x and y at the output: the
//   ring holds those three and STAGES-3 rows in flight. Each lane reads back
//   only the bytes it copied, so cp.async.wait_group orders the ring.
// - Window statistics in the forward's order: acc6/acc3 carry the nine taps
//   of each window top-left first, row by row (the build keeps -fmad=false),
//   so val, and with it the clip's mask, are bit-equal to the forward's and
//   the plain version's. n/d is an IEEE division for that reason; t takes
//   the fast reciprocal (__fdividef, 2 ulp): only gradients see it.
// - Transposed sum. When window row rho completes, each lane forms its
//   coefficients, takes the neighbours' across the lane boundary with
//   __shfl_up/down_sync and sums the three columns (h); down the column it
//   carries two partial sums per map: output row rho (windows rho-1, rho
//   done) and row rho+1 (window rho done); output row rho-1 completes. The
//   reflect pad's extra terms are warp-uniform branches: rows 0 and H-1 for
//   every lane, columns 1 and W-2 only in the warps that hold them.
// - Geometry. Blocks of WARPS independent warps; the launch picks the rows
//   per warp that leave the busiest SM the fewest warp-rows, counting the 4
//   extra input rows of each warp (plan()). At [16,3,256,832]: 7 strips, 43
//   rows per warp, 2016 warps in 504 blocks, at most 4 blocks (16 warps) per
//   SM.
// - Resources (nvcc -Xptxas -v, sm_90a, with CUDA 12.8's PyTorch on the
//   card's machine): V = 4: 121 registers for d/dy, 128 with d/dx, no
//   spills, 30,720 B static shared memory per 128-thread block, so 4 blocks
//   (16 warps) fit an SM, as __launch_bounds__ asks. V = 1: 54 and 56
//   registers, 7,680 B. The arithmetic costs ~10 us over the memory-only
//   twin at [16,3,256,832]; the twin ~8 us over torch.addcmul of the same
//   bytes, most of it the 4 halo rows and the strip overlap (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;          // warps per block; each walks its own strip chunk
constexpr int MIN_BLOCKS = 4;     // blocks per SM asked of __launch_bounds__: 16 warps
constexpr int STAGES = 5;         // ring depth: rows k-2, k-1, k and those in flight
constexpr int AHEAD = STAGES - 3;  // input rows in flight per warp
constexpr int SM_WARPS = 16;      // warps an SM needs to hide a row's latency
constexpr unsigned FULL = 0xffffffffu;
constexpr float C1 = 0.0001f;  // 0.01^2
constexpr float C2 = 0.0009f;  // 0.03^2

template <int V>
struct __align__(16) Stage {
  float x[32 * V];
  float y[32 * V];
  float g[32 * V];
};

// Lanes at each side of a strip that write no output: a written column
// needs two columns of the strip on either side.
template <int V>
constexpr int IDLE_LANES = V > 1 ? 1 : 2;

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

// Reflect by one (-1 -> 1, n -> n-2), then clamp the rows that only the
// windows outside the image read.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

// The row's taps for a lane's columns c0 .. c0+V-1: e[0] is column c0-1 and
// e[V+1] column c0+V, reflected at the image edge, where the partner is the
// lane's own column or its neighbour's. Lane 0 and lane 31 take their own
// value beyond the strip: only windows whose outputs they do not write see
// it. Every lane calls this.
template <int V>
__device__ __forceinline__ void taps(const float (&a)[V], int c0, int W, float (&e)[V + 2]) {
  const float up = __shfl_up_sync(FULL, a[V - 1], 1);  // column c0-1, from lane-1
  const float dn = __shfl_down_sync(FULL, a[0], 1);    // column c0+V, from lane+1
  float own_l, own_r;  // the partners of -1 -> 1 and W -> W-2 when the edge is here
  if constexpr (V > 1) {
    own_l = a[1];
    own_r = a[V - 2];
  } else {
    own_l = dn;
    own_r = up;
  }
  e[0] = c0 == 0 ? own_l : up;
  e[V + 1] = c0 + V >= W ? own_r : dn;
#pragma unroll
  for (int j = 0; j < V; ++j) e[j + 1] = a[j];
}

template <int V, bool DX>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) ssim_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ g,
    float* __restrict__ dx, float* __restrict__ dy, int H, int W, int strips, int chunks,
    int rows, int units) {
  __shared__ Stage<V> ring[WARPS][STAGES];
  constexpr int L = IDLE_LANES<V>;
  constexpr int M = DX ? 4 : 3;  // coefficient maps: a_y, 2 a_yy, a_xy (, a_x)
  constexpr unsigned STAGE = sizeof(Stage<V>);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int unit = blockIdx.x * WARPS + warp;
  if (unit >= units) return;  // whole warps only: the shuffles need all 32 lanes
  const int chunk = unit % chunks, strip_plane = unit / chunks;
  const int strip = strip_plane % strips, plane = strip_plane / strips;
  const int r0 = chunk * rows;
  const int n_in = min(rows, H - r0) + 4;
  const int c0 = ((32 - 2 * L) * strip + lane) * V;
  const bool active = c0 >= 0 && c0 < W;
  // The first strip also writes its first lanes: left of column 0 lies no window.
  const bool writer = active && (lane >= L || strip == 0) && lane < 32 - L;
  // Whether this warp holds column 1 or W-2, which the reflect pad's fold reaches.
  const bool fold_cols = __any_sync(
      FULL, active && ((c0 <= 1 && 1 < c0 + V) || (c0 <= W - 2 && W - 2 < c0 + V)));
  const int64_t base = (int64_t)plane * H * W + (active ? c0 : 0);
  const float* gx = x + base;
  const float* gy = y + base;
  const float* gg = g + base;
  float* gdy = dy + base;
  float* gdx = DX ? dx + base : nullptr;

  // This lane's slots; stage i lies i*STAGE bytes on. A lane outside the
  // image reads zeros, not whatever an earlier kernel left in shared memory,
  // so its discarded arithmetic stays finite; its g of 0 zeroes its
  // coefficients.
  Stage<V>* st = ring[warp];
  if (!active) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j)
        st[i].x[lane * V + j] = st[i].y[lane * V + j] = st[i].g[lane * V + j] = 0.0f;
  }
  const unsigned s_x = (unsigned)__cvta_generic_to_shared(st->x + lane * V);
  const unsigned s_y = s_x + 32 * V * sizeof(float);
  const unsigned s_g = s_y + 32 * V * sizeof(float);
  auto stage = [&](unsigned at) {
    return reinterpret_cast<const Stage<V>*>(reinterpret_cast<const char*>(st) + at);
  };

  // Input row k of the chunk (image row r0-2+k) into the stage at byte offset `at`.
  auto fetch = [&](int k, unsigned at) {
    if (k < n_in) {
      const int off = reflect(r0 - 2 + k, H) * W;
      cp_async<4 * V>(active, s_x + at, gx + off);
      cp_async<4 * V>(active, s_y + at, gy + off);
      cp_async<4 * V>(active, s_g + at, gg + off);
    }
    cp_async_commit();  // one group per row, empty past the end
  };

#pragma unroll
  for (int k = 0; k < AHEAD; ++k) fetch(k, k * STAGE);

  // acc6: the window sums of window row (input row - 1), six taps done;
  // acc3: those of window row (input row), three taps done.
  // Statistics in order: x, y, x*x, y*y, x*y.
  float acc6[5][V], acc3[5][V];
  // part[0]: the transposed sums of output row rho (windows rho-1 and rho
  // done), part[1]: of output row rho+1 (window rho done), where rho is the
  // last window row completed.
  float part[2][M][V];
#pragma unroll
  for (int q = 0; q < 5; ++q)
#pragma unroll
    for (int j = 0; j < V; ++j) acc6[q][j] = acc3[q][j] = 0.0f;
#pragma unroll
  for (int q = 0; q < M; ++q)
#pragma unroll
    for (int j = 0; j < V; ++j) part[0][q][j] = part[1][q][j] = 0.0f;

  int slot0 = 0;  // the ring slot of input row k
  for (int k = 0; k < n_in; ++k) {
    auto slot = [&](int d) {  // the slot of input row k + d (mod STAGES)
      const int s = slot0 + d;
      return (unsigned)(s >= STAGES ? s - STAGES : s) * STAGE;
    };
    // Refills the slot of row k-3, last read in the previous iteration.
    fetch(k + AHEAD, slot(AHEAD));
    const unsigned cur = slot(0), prev = slot(STAGES - 1), prev2 = slot(STAGES - 2);
    slot0 = slot0 + 1 == STAGES ? 0 : slot0 + 1;
    cp_async_wait<AHEAD>();

    float a[V], b[V];
    load_cols(stage(cur)->x + lane * V, a);
    load_cols(stage(cur)->y + lane * V, b);
    float u[5][V + 2];
    taps<V>(a, c0, W, u[0]);
    taps<V>(b, c0, W, u[1]);
#pragma unroll
    for (int j = 0; j < V + 2; ++j) {
      u[2][j] = u[0][j] * u[0][j];
      u[3][j] = u[1][j] * u[1][j];
      u[4][j] = u[0][j] * u[1][j];
    }
    float sum[5][V];  // input row k completes window row rho = r0 + k - 3
#pragma unroll
    for (int q = 0; q < 5; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sum[q][j] = ((acc6[q][j] + u[q][j]) + u[q][j + 1]) + u[q][j + 2];
        acc6[q][j] = ((acc3[q][j] + u[q][j]) + u[q][j + 1]) + u[q][j + 2];
        acc3[q][j] = (u[q][j] + u[q][j + 1]) + u[q][j + 2];
      }
    if (k < 2) continue;

    const int rho = r0 + k - 3;
    const bool live = active && rho >= 0 && rho < H;  // windows outside the image are 0
    float gw[V];
    load_cols(stage(prev)->g + lane * V, gw);
    float km[M][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float inv9 = 1.0f / 9.0f;
      const float mu_x = sum[0][j] * inv9, mu_y = sum[1][j] * inv9;
      const float sigma_x = sum[2][j] * inv9 - mu_x * mu_x;
      const float sigma_y = sum[3][j] * inv9 - mu_y * mu_y;
      const float sigma_xy = sum[4][j] * inv9 - mu_x * mu_y;
      const float A = 2.0f * mu_x * mu_y + C1, B = 2.0f * sigma_xy + C2;
      const float D1 = mu_x * mu_x + mu_y * mu_y + C1, D2 = sigma_x + sigma_y + C2;
      const float d = D1 * D2;
      const float r = (A * B) / d;
      const float val = (1.0f - r) / 2.0f;
      const float gv = (live && val >= 0.0f && val <= 1.0f) ? gw[j] : 0.0f;
      const float t = __fdividef(gv * (-1.0f / 9.0f), d);
      const float tA = t * A, tB = t * B, tr = t * r;
      const float dm = tB - tA, dv = tr * D1 - tr * D2;
      km[0][j] = mu_x * dm + mu_y * dv;
      km[1][j] = -tr * D1;
      km[2][j] = tA;
      if constexpr (DX) km[3][j] = mu_y * dm + mu_x * dv;
    }

    // h: each map summed over the three window columns around each column.
    float h[M][V];
#pragma unroll
    for (int q = 0; q < M; ++q) {
      float left = __shfl_up_sync(FULL, km[q][V - 1], 1);
      if (c0 == 0) left = 0.0f;  // window -1
      const float right = __shfl_down_sync(FULL, km[q][0], 1);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float kl = j > 0 ? km[q][j - 1] : left;
        const float kr = j < V - 1 ? km[q][j + 1] : right;
        h[q][j] = (kl + km[q][j]) + kr;
        if (fold_cols) {
          if (c0 + j == 1) h[q][j] += kl;      // column 1 reads window 0 twice
          if (c0 + j == W - 2) h[q][j] += kr;  // column W-2 reads window W-1 twice
        }
      }
    }

    if (k >= 4) {  // output row rho - 1 has its three window rows
      float xo[V], yo[V], o[V], ox[V];
      load_cols(stage(prev2)->x + lane * V, xo);
      load_cols(stage(prev2)->y + lane * V, yo);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float f[M];
#pragma unroll
        for (int q = 0; q < M; ++q) {
          f[q] = part[0][q][j] + h[q][j];
          if (rho == H - 1) f[q] += h[q][j];  // row H-2 reads window row H-1 twice
        }
        o[j] = (f[0] + yo[j] * f[1]) + xo[j] * f[2];
        if constexpr (DX) ox[j] = (f[3] + xo[j] * f[1]) + yo[j] * f[2];
      }
      if (writer) {
        const int off = (rho - 1) * W;
        store_cols(gdy + off, o);
        if constexpr (DX) store_cols(gdx + off, ox);
      }
    }
#pragma unroll
    for (int q = 0; q < M; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        part[0][q][j] = part[1][q][j] + h[q][j];
        part[1][q][j] = rho == 0 ? h[q][j] + h[q][j] : h[q][j];  // row 1 reads window row 0 twice
      }
  }
}

struct Plan {
  int strips, chunks, rows, units, blocks;
};

// Rows per warp: the split that leaves the busiest SM the fewest warp-rows,
// each warp reading 4 input rows more than it writes. Blocks spread over
// the SMs, so the busiest runs ceil(blocks / sms) of them, and a row costs
// an SM about the same whichever of its warps runs it, down to SM_WARPS
// warps per SM, below which a row's latency shows. Cached for the last
// shape (a training step repeats one shape).
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
  const int stride = (32 - 2 * IDLE_LANES<V>) * V;  // columns written per strip
  // Strip 0 writes columns [0, stride + L*V), strip s > 0 [s*stride + L*V, (s+1)*stride + L*V).
  const int strips = W > stride + IDLE_LANES<V> * V ? (W - IDLE_LANES<V> * V + stride - 1) / stride : 1;
  int64_t best = INT64_MAX;
  for (int c = 1; c <= H; ++c) {
    const int rows = (H + c - 1) / c;
    if ((H + rows - 1) / rows != c) continue;  // the same split as a smaller c
    const int64_t units = (int64_t)P * strips * c;
    const int64_t blocks = (units + WARPS - 1) / WARPS;
    const int64_t warps_per_sm = (blocks + sms - 1) / sms * WARPS;
    const int64_t cost = (warps_per_sm > SM_WARPS ? warps_per_sm : SM_WARPS) * (rows + 4);
    if (cost < best) {
      best = cost;
      *p = Plan{strips, c, rows, (int)units, (int)blocks};
    }
  }
  dev_c = dev, P_c = P, H_c = H, W_c = W, plan_c = *p;
  return cudaSuccess;
}

bool use_float4(const void* x, const void* y, const void* g, const void* dx, const void* dy,
                int W) {
  return W % 4 == 0 &&
         ((uintptr_t)x | (uintptr_t)y | (uintptr_t)g | (uintptr_t)dx | (uintptr_t)dy) % 16 == 0;
}

template <int V>
int launch(const float* x, const float* y, const float* g, float* dx, float* dy, int P, int H,
           int W, cudaStream_t s) {
  Plan p;
  const cudaError_t err = plan<V>(P, H, W, &p);
  if (err != cudaSuccess) return (int)err;
  if (dx != nullptr)
    ssim_bwd_kernel<V, true><<<p.blocks, WARPS * 32, 0, s>>>(x, y, g, dx, dy, H, W, p.strips,
                                                              p.chunks, p.rows, p.units);
  else
    ssim_bwd_kernel<V, false><<<p.blocks, WARPS * 32, 0, s>>>(x, y, g, nullptr, dy, H, W,
                                                               p.strips, p.chunks, p.rows,
                                                               p.units);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y, g [P, H, W] f32 contiguous (P = F*C planes) -> dy, and dx unless it
// is null, [P, H, W] f32. Needs H >= 2 and W >= 2 (reflect padding) and
// P*H*W < 2^31. Launches on `stream` and returns cudaGetLastError() after it.
int ssim_bwd(const void* x, const void* y, const void* g, void* dx, void* dy, int P, int H,
             int W, void* stream) {
  if (P == 0) return (int)cudaSuccess;
  const auto s = (cudaStream_t)stream;
  const auto xf = (const float*)x, yf = (const float*)y, gf = (const float*)g;
  return use_float4(x, y, g, dx, dy, W)
             ? launch<4>(xf, yf, gf, (float*)dx, (float*)dy, P, H, W, s)
             : launch<1>(xf, yf, gf, (float*)dx, (float*)dy, P, H, W, s);
}

// The launch ssim_bwd would make for these arguments, for reports: plan =
// {columns per lane, warps per block, strips per row, rows per warp, blocks}.
int ssim_bwd_plan(const void* x, const void* y, const void* g, const void* dx, const void* dy,
                  int P, int H, int W, int* plan_out) {
  const int v = use_float4(x, y, g, dx, dy, W) ? 4 : 1;
  Plan p{};
  const cudaError_t err = v == 4 ? plan<4>(P, H, W, &p) : plan<1>(P, H, W, &p);
  plan_out[0] = v, plan_out[1] = WARPS, plan_out[2] = p.strips, plan_out[3] = p.rows;
  plan_out[4] = p.blocks;
  return (int)err;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
