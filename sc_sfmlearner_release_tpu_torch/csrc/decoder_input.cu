// The input of one DepthDecoder convolution, forward and backward:
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's decoder pads with the custom-VJP
// reflect pads of ops/reflect_pad.py, a TPU workaround the port leaves out;
// until this kernel the port composed PyTorch's nearest upsample, torch.cat,
// F.pad(mode="reflect") and autocast's cast, each a pass over the tensor in
// device memory (the concatenation in fp32, since the encoder's skips are
// BatchNorm's fp32 output), and cuDNN transposed the result to NHWC.
//
// Forward: from a source `src` [N, h, w, Cs] (NHWC, the previous block's
// output, upsampled by `scale` = 1 or 2, nearest) and a skip `skip`
// [N, Ck, H, W] (NCHW fp32, an encoder feature: BatchNorm's output), either
// of which may be absent,
// write out [N, H+2, W+2, Cs+Ck] (NHWC: the layout in which cuDNN runs the
// convolution without a transpose) in the convolution's dtype:
//   out[n, y', x', c] = c < Cs ? src[n, r(y'-1, H) / scale, r(x'-1, W) / scale, c]
//                              : skip[n, c - Cs, r(y'-1, H), r(x'-1, W)]
// with r the reflection by 1 (-1 -> 1, H -> H-2; a size-1 axis replicates),
// the channels in torch.cat([upsample(src), skip], 1)'s order. Each value is
// rounded once to the output's dtype (round to nearest even), as the cast
// after the concatenation rounds it, so the forward equals the composition
// bit for bit.
//
// Width shards (--spatial-shards): `left` and `right` (0 or 1) say whether
// the source and the skip carry one halo column from the neighbouring shard
// on that side (src [N, h, l + w + r, Cs], skip [N, Ck, H, l + W + r]; one
// source column covers the upsampled halo under x2). The columns reflect
// over the shard's columns and its halo, at the image's edges alone, as
// parallel/spatial.py's reflect_pad1 pads them; a halo column's gradient
// is written to its place, for the halo's own backward to send back.
//
// Backward: from the input's gradient gout (NHWC, the output's dtype) write
// the source's gradient (NHWC, its dtype) and the skip's (NCHW fp32).
// Each element gathers the 1 to 3 padded rows and columns that reflect onto
// it and, for the source under x2, its 2x2 block: no zero fill and no
// atomics, so the result is deterministic. The sums are in fp32, in a fixed
// order (block row, block column, then rows and columns of the pad), rounded
// once to the destination's dtype. The composition rounds the source's
// gradient twice under bf16 (the pad's sum cast to bf16, then the upsample's
// sum), and sums in the atomics' order.
//
// Bound: bytes. Each input is read once and the output written once; the
// backward reads gout once and writes both gradients once.
//
// Design: one launch of each kernel, whose blocks split into two ranges.
// - Source blocks: one thread per 8 channels (one 16-byte access of bf16,
//   two of fp32: Cs and Cs+Ck are multiples of 8, the NHWC pointers 16-byte
//   aligned) of one output pixel (forward) or one source pixel (backward),
//   consecutive threads along the channels and then the pixels, so a warp
//   reads and writes whole lines of NHWC.
//   The source's pixels repeat under x2 and reflection: the repeats are
//   served by L1/L2.
// - Skip blocks: a tile of 32 pixels of one row by 64 channels moves through
//   shared memory ([64][33] floats, the 33rd column keeping both passes free
//   of bank conflicts): along the row in NCHW (a warp reads 32 consecutive
//   pixels of a channel), along the channels in NHWC (a warp writes 32
//   consecutive channels of a pixel). The forward's tile is an output row of
//   W+2 columns, the backward's a skip row of W.
// - 256 threads a block: 8 warps; the skip tile's 64 channels are 8 rows of
//   8 per warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_X = 32;  // pixels of a skip tile
constexpr int TILE_C = 64;  // channels of a skip tile
constexpr int V = 8;        // channels of a source thread

struct Shape {
  int N, Cs, h, w, shift;  // source [N, h, l + w + r, Cs]; scale = 1 << shift
  int Ck, H, W;            // skip [N, Ck, H, l + W + r]; out [N, H+2, W+2, Cs+Ck]
  int l, r;                // halo columns on the left and the right (0 or 1)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements as floats, and back: one 16-byte access of bf16,
// two of fp32.
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[V]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    const float2 f = __bfloat1622float2(q[k]);
    v[2 * k] = f.x, v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[V]) {
  uint4 u;
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < V / 2; ++k) q[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The index that padded index i + 1 reads, i in [-1, n]: reflection by 1, a
// size-1 axis replicated.
__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// The stored index that padded index i of n + 2 reads, of an axis that
// stores l + n + r (l, r halo elements): reflection by 1 where there is no
// halo.
__device__ __forceinline__ int stored(int i, int n, int l, int r) {
  return reflect(i - 1 + l, l + n + r);
}

// The padded indices (of n + 2) that read stored index e of l + n + r, the
// unreflected one first; returns their count (1 to 3).
__device__ __forceinline__ int padded(int e, int n, int l, int r, int (&p)[3]) {
  const int m = l + n + r;
  int k = 0;
  p[k++] = e + 1 - l;
  if (!l && e == (m > 1 ? 1 : 0)) p[k++] = 0;
  if (!r && e == (m > 1 ? m - 2 : 0)) p[k++] = n + 1;
  return k;
}

template <typename TS, typename TO>
__global__ void __launch_bounds__(THREADS) upsample_cat_reflection_pad_fwd(
    const TS* __restrict__ src, const float* __restrict__ skip, TO* __restrict__ out, Shape s,
    int src_blocks) {
  const int Hp = s.H + 2, Wp = s.W + 2, Ct = s.Cs + s.Ck;
  __shared__ float tile[TILE_C][TILE_X + 1];
  if ((int)blockIdx.x < src_blocks) {
    const int per = s.Cs / V;
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= (int64_t)s.N * Hp * Wp * per) return;
    const int64_t pix = i / per;
    const int c = (int)(i - pix * per) * V;
    const int xp = (int)(pix % Wp);
    const int64_t t = pix / Wp;
    const int yp = (int)(t % Hp), n = (int)(t / Hp);
    // The stored column e is image column e - l of the upsampled shard:
    // source column floor((e - l) / scale), stored at that plus l.
    const int y = reflect(yp - 1, s.H) >> s.shift;
    const int x = (stored(xp, s.W, s.l, s.r) + (s.l << s.shift) - s.l) >> s.shift;
    float v[V];
    load(src + (((int64_t)n * s.h + y) * (s.l + s.w + s.r) + x) * s.Cs + c, v);
    store(out + pix * Ct + c, v);
    return;
  }
  int b = (int)blockIdx.x - src_blocks;
  const int ctiles = (s.Ck + TILE_C - 1) / TILE_C, xtiles = (Wp + TILE_X - 1) / TILE_X;
  const int c0 = (b % ctiles) * TILE_C;
  b /= ctiles;
  const int x0 = (b % xtiles) * TILE_X;
  b /= xtiles;
  const int yp = b % Hp, n = b / Hp;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int y = reflect(yp - 1, s.H), Ws = s.l + s.W + s.r;
  if (x0 + lane < Wp) {
    const float* row =
        skip + ((int64_t)n * s.Ck * s.H + y) * Ws + stored(x0 + lane, s.W, s.l, s.r);
    for (int cc = warp; cc < TILE_C && c0 + cc < s.Ck; cc += THREADS / 32)
      tile[cc][lane] = row[(int64_t)(c0 + cc) * s.H * Ws];
  }
  __syncthreads();
  TO* base = out + ((int64_t)n * Hp + yp) * Wp * Ct + s.Cs + c0;
  for (int xx = warp; xx < TILE_X && x0 + xx < Wp; xx += THREADS / 32) {
    TO* o = base + (int64_t)(x0 + xx) * Ct;
    if (c0 + lane < s.Ck) o[lane] = from_f<TO>(tile[lane][xx]);
    if (c0 + 32 + lane < s.Ck) o[32 + lane] = from_f<TO>(tile[32 + lane][xx]);
  }
}

template <typename TS, typename TO>
__global__ void __launch_bounds__(THREADS) upsample_cat_reflection_pad_bwd(
    const TO* __restrict__ gout, TS* __restrict__ gsrc, float* __restrict__ gskip, Shape s,
    int src_blocks) {
  const int Wp = s.W + 2, Ct = s.Cs + s.Ck, ws = s.l + s.w + s.r, Ws = s.l + s.W + s.r;
  const int64_t row_stride = (int64_t)Wp * Ct;
  __shared__ float tile[TILE_C][TILE_X + 1];
  if ((int)blockIdx.x < src_blocks) {
    const int per = s.Cs / V;
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= (int64_t)s.N * s.h * ws * per) return;
    const int64_t pix = i / per;
    const int c = (int)(i - pix * per) * V;
    const int sx = (int)(pix % ws) - s.l;  // image column of the shard's source
    const int64_t t = pix / ws;
    const int sy = (int)(t % s.h), n = (int)(t / s.h);
    const TO* g = gout + (int64_t)n * (s.H + 2) * row_stride + c;
    const int scale = 1 << s.shift;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int dy = 0; dy < scale; ++dy) {
      int rows[3];
      const int nr = padded(sy * scale + dy, s.H, 0, 0, rows);
      for (int dx = 0; dx < scale; ++dx) {
        // A halo column's upsampled block lies half outside the stored ones.
        const int e = sx * scale + dx + s.l;
        if (e < 0 || e >= Ws) continue;
        int cols[3];
        const int nc = padded(e, s.W, s.l, s.r, cols);
        for (int r = 0; r < nr; ++r)
          for (int q = 0; q < nc; ++q) {
            float v[V];
            load(g + rows[r] * row_stride + (int64_t)cols[q] * Ct, v);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] += v[k];
          }
      }
    }
    store(gsrc + pix * s.Cs + c, acc);
    return;
  }
  int b = (int)blockIdx.x - src_blocks;
  const int ctiles = (s.Ck + TILE_C - 1) / TILE_C, xtiles = (Ws + TILE_X - 1) / TILE_X;
  const int c0 = (b % ctiles) * TILE_C;
  b /= ctiles;
  const int x0 = (b % xtiles) * TILE_X;
  b /= xtiles;
  const int y = b % s.H, n = b / s.H;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int rows[3];
  const int nr = padded(y, s.H, 0, 0, rows);
  const TO* g = gout + (int64_t)n * (s.H + 2) * row_stride + s.Cs + c0;
  for (int xx = warp; xx < TILE_X && x0 + xx < Ws; xx += THREADS / 32) {
    int cols[3];
    const int nc = padded(x0 + xx, s.W, s.l, s.r, cols);
    float a0 = 0.0f, a1 = 0.0f;
    for (int r = 0; r < nr; ++r)
      for (int q = 0; q < nc; ++q) {
        const TO* p = g + rows[r] * row_stride + (int64_t)cols[q] * Ct;
        if (c0 + lane < s.Ck) a0 += to_f(p[lane]);
        if (c0 + 32 + lane < s.Ck) a1 += to_f(p[32 + lane]);
      }
    tile[lane][xx] = a0;
    tile[32 + lane][xx] = a1;
  }
  __syncthreads();
  if (x0 + lane < Ws) {
    float* o = gskip + ((int64_t)n * s.Ck * s.H + y) * Ws + x0 + lane;
    for (int cc = warp; cc < TILE_C && c0 + cc < s.Ck; cc += THREADS / 32)
      o[(int64_t)(c0 + cc) * s.H * Ws] = tile[cc][lane];
  }
}

int64_t blocks(int64_t items) { return (items + THREADS - 1) / THREADS; }

int64_t skip_blocks(const Shape& s, int rows, int cols) {
  if (s.Ck == 0) return 0;
  return (int64_t)s.N * rows * ((cols + TILE_X - 1) / TILE_X) * ((s.Ck + TILE_C - 1) / TILE_C);
}

template <typename TS, typename TO>
struct Fwd {
  static int run(const void* src, const void* skip, void* out, Shape s, cudaStream_t stream) {
    const int64_t sb = s.Cs ? blocks((int64_t)s.N * (s.H + 2) * (s.W + 2) * (s.Cs / V)) : 0;
    const int64_t total = sb + skip_blocks(s, s.H + 2, s.W + 2);
    if (total == 0) return (int)cudaSuccess;
    if (total > INT32_MAX) return (int)cudaErrorInvalidValue;
    upsample_cat_reflection_pad_fwd<TS, TO><<<(unsigned)total, THREADS, 0, stream>>>(
        (const TS*)src, (const float*)skip, (TO*)out, s, (int)sb);
    return (int)cudaGetLastError();
  }
};

template <typename TS, typename TO>
struct Bwd {
  static int run(const void* gout, void* gsrc, void* gskip, Shape s, cudaStream_t stream) {
    const int64_t sb = gsrc ? blocks((int64_t)s.N * s.h * (s.l + s.w + s.r) * (s.Cs / V)) : 0;
    const int64_t total = sb + (gskip ? skip_blocks(s, s.H, s.l + s.W + s.r) : 0);
    if (total == 0) return (int)cudaSuccess;
    if (total > INT32_MAX) return (int)cudaErrorInvalidValue;
    upsample_cat_reflection_pad_bwd<TS, TO><<<(unsigned)total, THREADS, 0, stream>>>(
        (const TO*)gout, (TS*)gsrc, (float*)gskip, s, (int)sb);
    return (int)cudaGetLastError();
  }
};

// The launcher for the dtypes' codes (0: fp32, 1: bf16) of the source and
// the output: fp32 into fp32 (no autocast), fp32 into bf16 (the skip-only
// input under autocast, whose source code is 0), bf16 into bf16 (autocast).
template <template <typename, typename> class L, typename... A>
int dispatch(int ts, int to, A... args) {
  using F = float;
  using B = __nv_bfloat16;
  switch (ts * 2 + to) {
    case 0: return L<F, F>::run(args...);
    case 1: return L<F, B>::run(args...);
    case 3: return L<B, B>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

bool check(int Cs, int Ck, int dt_s, int dt_o, int scale, int left, int right) {
  return Cs % V == 0 && (Cs + Ck) % V == 0 && (scale == 1 || scale == 2) && dt_s >= 0 &&
         dt_s <= dt_o && dt_o <= 1 && (left == 0 || left == 1) && (right == 0 || right == 1);
}

}  // namespace

extern "C" {

// src [N, h, left + w + right, Cs] (NHWC; null with Cs = 0), skip
// [N, Ck, H, left + W + right] (NCHW fp32; null with Ck = 0), out
// [N, H+2, W+2, Cs+Ck] (NHWC), with H = scale * h and W = scale * w where
// there is a source; left and right the halo columns (0 or 1); Cs and
// Cs+Ck multiples of 8; every tensor dense, on one device, fewer than 2^31
// elements, the NHWC ones 16-byte aligned. Dtype codes of src and out: 0
// fp32, 1 bf16, a bf16 source only into bf16. Launches on `stream`; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments outside these.
int decoder_input_fwd(const void* src, const void* skip, void* out, int N, int Cs, int h, int w,
                      int scale, int Ck, int H, int W, int left, int right, int dt_src,
                      int dt_out, void* stream) {
  if (!check(Cs, Ck, dt_src, dt_out, scale, left, right)) return (int)cudaErrorInvalidValue;
  const Shape s{N, Cs, h, w, scale == 2 ? 1 : 0, Ck, H, W, left, right};
  return dispatch<Fwd>(dt_src, dt_out, src, skip, out, s, (cudaStream_t)stream);
}

// gout [N, H+2, W+2, Cs+Ck] (NHWC, dtype dt_out) -> gsrc
// [N, h, left + w + right, Cs] (NHWC; null: not written) and gskip
// [N, Ck, H, left + W + right] (NCHW fp32; null: not written), the halo
// columns included. The same shapes, conditions and codes as
// decoder_input_fwd.
int decoder_input_bwd(const void* gout, void* gsrc, void* gskip, int N, int Cs, int h, int w,
                      int scale, int Ck, int H, int W, int left, int right, int dt_src,
                      int dt_out, void* stream) {
  if (!check(Cs, Ck, dt_src, dt_out, scale, left, right)) return (int)cudaErrorInvalidValue;
  const Shape s{N, Cs, h, w, scale == 2 ? 1 : 0, Ck, H, W, left, right};
  return dispatch<Bwd>(dt_src, dt_out, gout, gsrc, gskip, s, (cudaStream_t)stream);
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
