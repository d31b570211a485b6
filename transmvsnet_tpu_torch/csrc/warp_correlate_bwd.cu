// Plane-sweep warp-correlation backward: gradients of the source and
// reference features (and of the view weights), float32, from float32 or
// bf16 features.
//
// Replaces two TPU kernels, which the JAX package computes with one Pallas
// kernel body (_bwd_kernel):
//   transmvsnet_tpu/ops/pallas/warp_bwd.py::warp_correlate_bwd (the S = 1,
//     unit-view-weight case; bf16 there): K4, the kernels named
//     warp_correlate_bwd_*. Its float32 instantiation serves the float32
//     path, where the JAX package differentiates warp_rowsweep.py by
//     autodiff of the XLA warp (ops/pallas/vjp.py, pallas_bwd=None): the
//     same gradient.
//   transmvsnet_tpu/ops/pallas/warp_bwd.py::warp_correlate_wsum_bwd (bf16):
//     K8, the kernels named warp_correlate_wsum_bwd_*, on the same body.
// For the forward of warp_correlate.cu,
//   sim[n, d, p] = mean_c bilinear(src[n, c], px, py) * ref[b, c, p]
// with (px, py) the projection of ref pixel p at depth[b, d, p] into source
// view n = b*S + s (invalid, contributing nothing, where its z < 1e-6),
// K4 takes the per-view cotangent g[n, d, p] and K8 the cotangent g[b, d, p]
// of the weighted sum out[b, d, p] = sum_s vw[n, p] * sim[n, d, p]. With
// gd = g * vw / C (vw = 1 for K4) they return
//   dref[b, c, p] = sum_s sum_d samp_c(n, d, p) * gd
//   dsrc[n, c]    = scatter of ref[b, c, p] * gd * w_corner
//                   into the four corners of every (d, p)
// and K8, when asked (want_dvw), also
//   dvw[n, p]     = sum_d g[b, d, p] * sim[n, d, p].
// Projections and depth hypotheses get no gradient: the sample grid is
// built without one in the reference.
//
// What bounds it on an H100: per (view, hypothesis, pixel) it gathers the
// C channels of four corners and adds C float32 values into each of them;
// its unique traffic is one depth and one cotangent read, so by the
// roofline it is bound by bytes. In practice it is bound by the reductions
// into dsrc, which L2 serves one address at a time, and by the
// instructions around each sample.
//
// Design, three launches per call on the caller's stream:
// 1. Prologue (*_to_channels_last): src [N, C, H, W] is copied
//    channels-last, [N, H, W, C] in its own dtype, into the caller's
//    scratch, and the float32 accumulator [N, H, W, C] is zeroed. A
//    corner's C channels are then one run of 16-128 bytes, where the
//    planar layout put them in C lines H*W apart.
// 2. Main (*_main): a group of C/4 lanes serves one (view, pixel); each
//    lane owns 4 channels, gathers them with one 8- or 16-byte load per
//    corner and adds into the accumulator with one 4-wide reduction
//    (atomicAdd on float4, sm_90): a quarter of the atomic instructions
//    of one per channel, each on one 16-byte run. The group walks the D
//    hypotheses C/4 at a time: lane l sets up hypothesis d0 + l (the
//    projection, the tests, the corner weights) and the group's lanes take
//    the C/4 samples in turn by shuffles, so a sample is set up once, not
//    once per lane. A warp's 32/(C/4) groups are neighbouring pixels of a
//    row, and at one hypothesis their samples usually lie about a cell
//    apart, so a group's right column of cells is often the next group's
//    left column: there two reductions would hit one address at once. The
//    groups combine before the reduction: when the anchors say so, a group
//    adds the next group's left column (by shuffles) into its right column
//    and the next group leaves it out. Each lane adds its 4 dref sums
//    once, with 4 scalar atomics (the S views of a batch meet there). K8
//    forms the per-hypothesis cotangent in one place (gd), where it
//    multiplies in the view weight. Without dvw, a sample with vw*g = 0
//    does no work; with dvw, K8 still samples where vw = 0 (dvw needs sim
//    there) but scatters nothing, and the lanes' partial sums of dvw meet
//    by shuffles, written once per (view, pixel) without an atomic.
// 3. Epilogue (*_to_planar): the accumulator is written to dsrc
//    [N, C, H, W] through shared-memory tiles.
// The sample arithmetic (the projection, the Z >= 1e-6 test, the clamps,
// the corner weights and the validity masks) is that of the forward
// kernel and of the plain version, at every pixel, frame edges included.
// Tolerance: the reductions into dsrc and dref add in no fixed order (and
// dsrc's partly across neighbouring groups first), and the projection may
// fuse multiply-adds (~1e-5 px of sample position), so
// the result matches the plain version within 1e-3*|p| + 1e-3*max|p|, the
// gate of the forward kernels, and is not bitwise repeatable.
//
// The caller zeroes dsrc and dref (the contract of the earlier kernel of
// this file, kept so that either build runs under one wrapper; the
// epilogue writes dsrc in full) and passes the scratch: src_cl [N, H, W, C]
// in the features' dtype and acc [N, H, W, C] float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // pixels per prologue / epilogue block

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Four consecutive channels at p (8- or 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// acc[0..3] += v[0..3] with one 4-wide reduction (atomicAdd on float4, sm_90 only).
__device__ __forceinline__ void red_add4(float* acc, const float v[4]) {
  atomicAdd(reinterpret_cast<float4*>(acc), make_float4(v[0], v[1], v[2], v[3]));
}

// src [N, C, HW] -> src_cl [N, HW, C]; acc [N, HW, C] = 0. Block (tile, n).
// E is an unsigned integer of the features' size: the copy moves bits. A
// pixel's C channels are 16-128 bytes, so both outputs are written in
// 16-byte stores.
template <typename E, int C>
__device__ __forceinline__ void to_channels_last(const E* __restrict__ src, E* __restrict__ src_cl,
                                                 float* __restrict__ acc, long long HW) {
  constexpr int kPer = 16 / sizeof(E);  // elements per 16-byte store
  static_assert(C % kPer == 0, "a pixel's channels fill whole 16-byte stores");
  __shared__ E tile[C][kTile + 1];
  const long long n = blockIdx.y, p0 = (long long)blockIdx.x * kTile;
  const int np = (int)min((long long)kTile, HW - p0);
  for (int e = threadIdx.x; e < C * kTile; e += kThreads) {
    const int c = e / kTile, i = e % kTile;
    if (i < np) tile[c][i] = src[(n * C + c) * HW + p0 + i];
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(src_cl + (n * HW + p0) * C);
  for (int k = threadIdx.x; k < np * C / kPer; k += kThreads) {
    union {
      uint4 u;
      E e[kPer];
    } pack;
#pragma unroll
    for (int j = 0; j < kPer; ++j) pack.e[j] = tile[(k * kPer + j) % C][(k * kPer + j) / C];
    out[k] = pack.u;
  }
  float4* a = reinterpret_cast<float4*>(acc + (n * HW + p0) * C);
  for (int k = threadIdx.x; k < np * C / 4; k += kThreads) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// acc [N, HW, C] -> dsrc [N, C, HW]. Block (tile, n).
template <int C>
__device__ __forceinline__ void to_planar(const float* __restrict__ acc, float* __restrict__ dsrc,
                                          long long HW) {
  __shared__ float tile[C][kTile + 1];
  const long long n = blockIdx.y, p0 = (long long)blockIdx.x * kTile;
  const int np = (int)min((long long)kTile, HW - p0);
  const float4* a = reinterpret_cast<const float4*>(acc + (n * HW + p0) * C);
  for (int k = threadIdx.x; k < np * C / 4; k += kThreads) {
    const float4 v = a[k];
    const int c = (4 * k) % C, i = (4 * k) / C;  // 4 channels of one pixel
    tile[c][i] = v.x, tile[c + 1][i] = v.y, tile[c + 2][i] = v.z, tile[c + 3][i] = v.w;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < C * kTile; e += kThreads) {
    const int c = e / kTile, i = e % kTile;
    if (i < np) dsrc[(n * C + c) * HW + p0 + i] = tile[c][i];
  }
}

// kWsum = false (K4): g is [B*S, D, H, W], vw and dvw are unused.
// kWsum = true (K8): g is [B, D, H, W], shared by the S views; kDvw says
// whether dvw is computed.
template <typename T, int C, bool kWsum, bool kDvw>
__device__ __forceinline__ void bwd_main(
    const T* __restrict__ src_cl,           // [B*S, H, W, C]
    const T* __restrict__ ref,              // [B, C, H, W]
    const float* __restrict__ rel,          // [B*S, 3, 4]
    const float* __restrict__ depth,        // [B, D, H, W]
    const float* __restrict__ vw,           // [B*S, H, W] (K8)
    const float* __restrict__ g,            // [B*S or B, D, H, W]
    float* __restrict__ acc,                // [B*S, H, W, C], zeroed
    float* __restrict__ dref,               // [B, C, H, W], zeroed
    float* __restrict__ dvw,                // [B*S, H, W] (K8 with dvw)
    int N, int S, int D, int H, int W) {
  constexpr int L = C / 4;   // lanes per (view, pixel), 4 channels each
  constexpr int G = 32 / L;  // groups per warp: G neighbouring pixels
  static_assert(kThreads % 32 == 0 && 32 % L == 0, "groups tile the warps");
  const int lane = threadIdx.x % L;
  const int group = (threadIdx.x % 32) / L;
  const long long HW = (long long)H * W;
  const long long q = (long long)blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const bool active = q < (long long)N * HW;
  // Every lane of a warp walks all D hypotheses (the groups exchange
  // corner sums by shuffles); an inactive group's samples are all invalid.
  const long long qa = active ? q : 0;
  const int n = (int)(qa / HW);
  const int b = n / S;
  const long long pix = qa - (long long)n * HW;
  const int y = (int)(pix / W);
  const int x = (int)(pix - (long long)y * W);
  const float wv = kWsum && active ? vw[qa] : 1.f;
  const bool run = active && (kDvw || wv != 0.f);

  float r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = __ldg(rel + n * 12 + i);
  const float fx = (float)x, fy = (float)y;
  const float bx = r[0] * fx + r[1] * fy + r[2];
  const float by = r[4] * fx + r[5] * fy + r[6];
  const float bz = r[8] * fx + r[9] * fy + r[10];

  float refv[4], dr[4];
  const T* rb = ref + ((long long)b * C + 4 * lane) * HW + pix;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    refv[k] = run ? load(rb + k * HW) : 0.f;
    dr[k] = 0.f;
  }
  const T* sb = src_cl + (long long)n * HW * C + 4 * lane;
  float* ab = acc + (long long)n * HW * C + 4 * lane;
  const float* zb = depth + (long long)b * D * HW + pix;
  const float* gb = g + (long long)(kWsum ? b : n) * D * HW + pix;
  const float inv_c = 1.f / (float)C;
  float dv = 0.f;
  constexpr int kNone = INT_MIN / 2;  // the x0 of a sample that adds nothing
  for (int d0 = 0; d0 < D; d0 += L) {
    // Lane l sets up hypothesis d0 + l of its group's pixel: the
    // projection, the tests and the corner weights, which the group's
    // lanes then take in turn by shuffles.
    const int dl = d0 + lane;
    float gv = 0.f, gd = 0.f;
    int sx0 = kNone, sy0 = 0;
    float sw[4] = {0.f, 0.f, 0.f, 0.f};
    if (run && dl < D) {
      gv = gb[dl * HW];
      gd = kWsum ? gv * wv * inv_c : gv * inv_c;
      const float z = zb[dl * HW];
      const float X = bx * z + r[3];
      const float Y = by * z + r[7];
      const float Z = bz * z + r[11];
      if (Z >= 1e-6f && (kDvw ? gv : gd) != 0.f) {
        const float px = X / Z, py = Y / Z;
        // Clamp before the int cast; beyond [-2, size+1] every corner is zero.
        const float x0f = fminf(fmaxf(floorf(px), -2.f), (float)W + 1.f);
        const float y0f = fminf(fmaxf(floorf(py), -2.f), (float)H + 1.f);
        const float wx = px - floorf(px), wy = py - floorf(py);
        const int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
        const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
        const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
        if ((vy0 || vy1) && (vx0 || vx1)) {
          sx0 = x0, sy0 = y0;
          sw[0] = (vy0 && vx0) ? (1.f - wx) * (1.f - wy) : 0.f;
          sw[1] = (vy0 && vx1) ? wx * (1.f - wy) : 0.f;
          sw[2] = (vy1 && vx0) ? (1.f - wx) * wy : 0.f;
          sw[3] = (vy1 && vx1) ? wx * wy : 0.f;
        }
      }
    }
    const int steps = min(L, D - d0);
    for (int j = 0; j < steps; ++j) {
      const int x0 = __shfl_sync(0xffffffffu, sx0, j, L);
      const int y0 = __shfl_sync(0xffffffffu, sy0, j, L);
      const float g_d = __shfl_sync(0xffffffffu, gd, j, L);
      const float g_v = kDvw ? __shfl_sync(0xffffffffu, gv, j, L) : 0.f;
      float w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = __shfl_sync(0xffffffffu, sw[c], j, L);
      const bool ok = x0 != kNone;
      // Corner c = 2i + j is cell (y0 + i, x0 + j), on the frame if on[c];
      // a corner of zero weight adds nothing and is not read.
      const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
      const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
      const bool on[4] = {ok && vy0 && vx0, ok && vy0 && vx1, ok && vy1 && vx0, ok && vy1 && vx1};
      float a[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a[c][0] = a[c][1] = a[c][2] = a[c][3] = 0.f;
        if (w[c] != 0.f) load4(sb + ((long long)(y0 + (c >> 1)) * W + x0 + (c & 1)) * C, a[c]);
      }
      float sim = 0.f, s[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = w[0] * a[0][k] + w[1] * a[1][k] + w[2] * a[2][k] + w[3] * a[3][k];
        if (kDvw) sim = fmaf(v, refv[k], sim);
        dr[k] = fmaf(v, g_d, dr[k]);
        s[k] = refv[k] * g_d;
      }
      if (kDvw) dv = fmaf(g_v, sim * inv_c, dv);
      // K8 where vw = 0 scatters nothing (dvw only).
      const bool scatter = ok && (!kWsum || g_d != 0.f);
      float add[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) add[c][k] = s[k] * w[c];
      // Combine before the reduction: the next group's pixel is the next
      // one in the row, and its sample usually lies about a cell to the
      // right, so its left column of cells is this sample's right column.
      // When the anchors say so, this group adds the next group's left
      // column into its own right column and the next group leaves it out.
      const int ax = scatter ? x0 : kNone, ay = scatter ? y0 : kNone;
      const int next_x = __shfl_down_sync(0xffffffffu, ax, L);
      const int next_y = __shfl_down_sync(0xffffffffu, ay, L);
      float next[2][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        next[0][k] = __shfl_down_sync(0xffffffffu, add[0][k], L);
        next[1][k] = __shfl_down_sync(0xffffffffu, add[2][k], L);
      }
      const bool take = scatter && group < G - 1 && next_y == ay && next_x == ax + 1;
      const bool taken = __shfl_up_sync(0xffffffffu, take, L) && group > 0;
      if (take) {
#pragma unroll
        for (int k = 0; k < 4; ++k) add[1][k] += next[0][k], add[3][k] += next[1][k];
      }
      if (scatter) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool right = c & 1;
          if (on[c] && (right ? w[c] != 0.f || take : w[c] != 0.f && !taken))
            red_add4(ab + ((long long)(y0 + (c >> 1)) * W + x0 + (c & 1)) * C, add[c]);
        }
      }
    }
  }
  if (run) {
    float* drb = dref + ((long long)b * C + 4 * lane) * HW + pix;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (dr[k] != 0.f) atomicAdd(drb + k * HW, dr[k]);
  }
  if constexpr (kDvw) {
    // The group's lanes hold partial sums over their channels.
#pragma unroll
    for (int off = L / 2; off > 0; off /= 2) dv += __shfl_xor_sync(0xffffffffu, dv, off);
    if (active && lane == 0) dvw[q] = dv;
  }
}

// K4's three kernels.
template <typename E, int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_bwd_to_channels_last(
    const E* __restrict__ src, E* __restrict__ src_cl, float* __restrict__ acc, long long HW) {
  to_channels_last<E, C>(src, src_cl, acc, HW);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_bwd_main(
    const T* __restrict__ src_cl, const T* __restrict__ ref, const float* __restrict__ rel,
    const float* __restrict__ depth, const float* __restrict__ g, float* __restrict__ acc,
    float* __restrict__ dref, int N, int S, int D, int H, int W) {
  bwd_main<T, C, false, false>(src_cl, ref, rel, depth, nullptr, g, acc, dref, nullptr, N, S, D, H, W);
}

template <int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_bwd_to_planar(
    const float* __restrict__ acc, float* __restrict__ dsrc, long long HW) {
  to_planar<C>(acc, dsrc, HW);
}

// K8's three kernels (bf16 features).
template <int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_wsum_bwd_to_channels_last(
    const unsigned short* __restrict__ src, unsigned short* __restrict__ src_cl,
    float* __restrict__ acc, long long HW) {
  to_channels_last<unsigned short, C>(src, src_cl, acc, HW);
}

template <int C, bool kDvw>
__global__ void __launch_bounds__(kThreads) warp_correlate_wsum_bwd_main(
    const __nv_bfloat16* __restrict__ src_cl, const __nv_bfloat16* __restrict__ ref,
    const float* __restrict__ rel, const float* __restrict__ depth, const float* __restrict__ vw,
    const float* __restrict__ g, float* __restrict__ acc, float* __restrict__ dref,
    float* __restrict__ dvw, int N, int S, int D, int H, int W) {
  bwd_main<__nv_bfloat16, C, true, kDvw>(src_cl, ref, rel, depth, vw, g, acc, dref, dvw, N, S, D,
                                         H, W);
}

template <int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_wsum_bwd_to_planar(
    const float* __restrict__ acc, float* __restrict__ dsrc, long long HW) {
  to_planar<C>(acc, dsrc, HW);
}

struct Args {
  const void *src, *ref, *rel, *depth, *vw, *g;
  void *dsrc, *dref, *dvw, *src_cl, *acc;
  int N, S, D, H, W;
  cudaStream_t stream;
};

unsigned main_blocks(const Args& a, int C) {
  const long long groups = (long long)a.N * a.H * a.W;
  const long long per_block = kThreads / (C / 4);
  return (unsigned)((groups + per_block - 1) / per_block);
}

dim3 tile_grid(const Args& a) {
  const long long HW = (long long)a.H * a.W;
  return dim3((unsigned)((HW + kTile - 1) / kTile), (unsigned)a.N);
}

template <typename T, int C>
cudaError_t launch_k4(const Args& a) {
  const long long HW = (long long)a.H * a.W;
  using E = std::conditional_t<sizeof(T) == 2, unsigned short, unsigned>;
  T* src_cl = static_cast<T*>(a.src_cl);
  float* acc = static_cast<float*>(a.acc);
  warp_correlate_bwd_to_channels_last<E, C><<<tile_grid(a), kThreads, 0, a.stream>>>(
      static_cast<const E*>(a.src), static_cast<E*>(a.src_cl), acc, HW);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  warp_correlate_bwd_main<T, C><<<main_blocks(a, C), kThreads, 0, a.stream>>>(
      src_cl, static_cast<const T*>(a.ref), static_cast<const float*>(a.rel),
      static_cast<const float*>(a.depth), static_cast<const float*>(a.g), acc,
      static_cast<float*>(a.dref), a.N, a.S, a.D, a.H, a.W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  warp_correlate_bwd_to_planar<C><<<tile_grid(a), kThreads, 0, a.stream>>>(
      acc, static_cast<float*>(a.dsrc), HW);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_k8(const Args& a, bool want_dvw) {
  using T = __nv_bfloat16;
  const long long HW = (long long)a.H * a.W;
  T* src_cl = static_cast<T*>(a.src_cl);
  float* acc = static_cast<float*>(a.acc);
  warp_correlate_wsum_bwd_to_channels_last<C><<<tile_grid(a), kThreads, 0, a.stream>>>(
      static_cast<const unsigned short*>(a.src), static_cast<unsigned short*>(a.src_cl), acc, HW);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kernel = want_dvw ? warp_correlate_wsum_bwd_main<C, true> : warp_correlate_wsum_bwd_main<C, false>;
  kernel<<<main_blocks(a, C), kThreads, 0, a.stream>>>(
      src_cl, static_cast<const T*>(a.ref), static_cast<const float*>(a.rel),
      static_cast<const float*>(a.depth), static_cast<const float*>(a.vw),
      static_cast<const float*>(a.g), acc, static_cast<float*>(a.dref),
      static_cast<float*>(a.dvw), a.N, a.S, a.D, a.H, a.W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  warp_correlate_wsum_bwd_to_planar<C><<<tile_grid(a), kThreads, 0, a.stream>>>(
      acc, static_cast<float*>(a.dsrc), HW);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k4(int C, const Args& a) {
  switch (C) {
    case 8: return launch_k4<T, 8>(a);
    case 16: return launch_k4<T, 16>(a);
    case 32: return launch_k4<T, 32>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_k8(int C, const Args& a, bool want_dvw) {
  switch (C) {
    case 8: return launch_k8<8>(a, want_dvw);
    case 16: return launch_k8<16>(a, want_dvw);
    case 32: return launch_k8<32>(a, want_dvw);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K4. src and ref are bf16 when bf16 != 0, else float32; dsrc and dref
// zeroed by the caller; scratch src_cl [N, H, W, C] in the features' dtype
// and acc [N, H, W, C] float32, after the stream (an earlier build of this
// entry point took no scratch and ignores them). Returns a cudaError_t
// code: 0 on success, else the first launch's error.
extern "C" int warp_correlate_bwd(const void* src, const void* ref, const void* rel,
                                  const void* depth, const void* g, void* dsrc, void* dref,
                                  int N, int S, int C, int D, int H, int W, int bf16,
                                  void* stream, void* src_cl, void* acc) {
  const Args a{src, ref, rel, depth, nullptr, g, dsrc, dref, nullptr, src_cl, acc,
               N, S, D, H, W, static_cast<cudaStream_t>(stream)};
  return (int)(bf16 ? dispatch_k4<__nv_bfloat16>(C, a) : dispatch_k4<float>(C, a));
}

// K8: bf16 src and ref; float32 rel, depth, vw [B*S, H, W] and g [B, D, H, W];
// dsrc and dref zeroed by the caller; scratch as K4's. dvw [B*S, H, W] is
// written in full when want_dvw != 0 and left untouched otherwise (an
// earlier build of this entry point took neither scratch nor flag, ignores
// them and always writes dvw). Returns a cudaError_t code: 0 on success,
// else the first launch's error.
extern "C" int warp_correlate_wsum_bwd(const void* src, const void* ref, const void* rel,
                                       const void* depth, const void* vw, const void* g,
                                       void* dsrc, void* dref, void* dvw, int N, int S, int C,
                                       int D, int H, int W, void* stream, void* src_cl, void* acc,
                                       int want_dvw) {
  const Args a{src, ref, rel, depth, vw, g, dsrc, dref, dvw, src_cl, acc,
               N, S, D, H, W, static_cast<cudaStream_t>(stream)};
  return (int)dispatch_k8(C, a, want_dvw != 0);
}

extern "C" const char* warp_correlate_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
