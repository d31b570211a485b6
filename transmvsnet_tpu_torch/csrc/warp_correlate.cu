// Plane-sweep warp-correlation forward: float32 or bf16 features in,
// float32 similarity out; and its view-weighted sum over the source views.
//
// Replaces three TPU kernels:
//   transmvsnet_tpu/ops/pallas/warp_onehot.py::warp_correlate_onehot (bf16
//     features; the bf16 instantiation of the kernels named
//     warp_correlate_fwd_*, K2),
//   transmvsnet_tpu/ops/pallas/warp_rowsweep.py::warp_correlate_rowsweep
//     (float32 features; their float instantiation, K6), and
//   transmvsnet_tpu/ops/pallas/warp_onehot.py::warp_correlate_wsum_onehot
//     (bf16 features; the kernels named warp_correlate_wsum_fwd_*, K7).
// K2/K6: for source view n = b*S + s, hypothesis d and reference pixel
// (y, x),
//   [X Y Z] = rel[n] @ [x*z, y*z, z, 1],  z = depth[b, d, y, x]
//   invalid if Z < 1e-6 (sampled as zero), else (px, py) = (X/Z, Y/Z)
//   out[n, d, y, x] = mean_c bilinear(src[n, c], px, py) * ref[b, c, y, x]
// with per-corner zeros padding; rel = (P_src @ P_ref^-1)[:3] is computed by
// the wrapper in float32. K7 weights each view by vw[b, s, y, x] and sums:
//   out[b, d, y, x] = sum_s vw[b, s, y, x] * sim(b*S + s, d, y, x)
// so the [B, S, D, H, W] per-view volume is never written.
//
// What bounds it on an H100: per (view, hypothesis, pixel) it does ~10*C
// flops and moves 8 bytes of unique traffic (a depth read shared by the S
// views, one float32 write; K7 writes 1/S of that and reads vw), so by the
// roofline it is bound by bytes. In practice it is bound by instructions:
// per sample on the plane, 4*C multiply-adds and, for bf16, 4*C conversions
// to float32 (integer operations, at half the float32 rate), beside the
// setup of the sample (the projection, a reciprocal, floors, clamps, the
// corner weights). The gathers are served by L1/L2 (a source plane of a
// stage fits in the 50 MB L2): an earlier form of this body, timed with
// every gather made L1-resident, was no faster, and each cut in its
// instructions per sample made it faster.
//
// Two launches per call on the caller's stream, under each kernel's own
// names:
// 1. Prologue (warp_correlate_fwd_to_channels_last, K7's
//    warp_correlate_wsum_fwd_to_channels_last; one device function,
//    to_channels_last): src [N, C, H, W] is copied channels-last in its own
//    dtype into the caller's scratch, with 16-byte loads and stores through
//    a shared-memory tile: each view's H*W records
//    of C channels, between pads of W + 1 records of zeros. A corner's C
//    channels are then one run of 16-128 bytes, where the planar layout put
//    them in C lines H*W apart, and every corner of a sample with a corner
//    on the plane lies in bounds without a clamp.
// 2. Body (warp_correlate_fwd_main, K7's warp_correlate_wsum_fwd_main; the
//    two share the layout and a group's round, round_total): a group of G
//    lanes serves one (view, pixel), each lane K channels: two
//    16-byte records (16 bf16 or 8 float32), or all C where fewer, so G =
//    2 / 1 / 1 in bf16 and 4 / 2 / 1 in float32 for C = 32 / 16 / 8. Each
//    lane holds its channels of the reference pixel in registers. A block
//    covers a tile of 8 rows; a warp's pixels are neighbours in a row. The
//    group walks the hypotheses in rounds of G: lane l sets up hypothesis
//    d0 + l (the projection, the Z test, floors, clamps, validity and the
//    four corner weights) and the group takes the G samples in turn by
//    shuffles (the anchor's offset and the weights). A sample with no
//    corner on the plane costs a test; otherwise each lane loads its
//    records of the four corners and keeps one partial dot product per
//    sample. A transposing reduction by recursive halving (G - 1
//    shuffle-adds per lane) leaves lane l with hypothesis d0 + l.
//    K2/K6 divide it by C and write it. Their blocks hold one view each and
//    run the S views of a pixel tile one after another, so the tile's depth
//    and reference values are read from memory once.
//    K7's blocks hold one chunk of 8 hypotheses of a pixel tile each, and
//    run the chunks of a tile one after another. The group walks the S
//    views in turn, each view's weight, projection and records set up once
//    per chunk, and adds each round's total, weighted, to the lane's sum of
//    that hypothesis in a register. Lane l then divides its sums by C and
//    writes them. A view of weight zero takes its samples all the same, so
//    a NaN or Inf it samples reaches the output, as in the plain version
//    (0 * NaN). A warp's lanes work on one view at a time, so their samples
//    land on the source plane together, as K2's do; chunks, not views, give
//    the lanes that stage 2 needs, and no sum crosses lanes. The two bodies
//    are two kernels: one device body with a K7 flag compiled K6 at C = 16
//    ~2% slower on the H100 (PERF.md).
// The sample arithmetic (the projection, !(Z >= 1e-6) as invalid, NaN
// included, the floor, the clamp to [-2, size + 1], per-corner validity and
// weights) is that of the plain versions at every pixel, frame edges
// included, with one reciprocal of Z in place of two divisions (~2 ulp of
// the sample position). No atomics and a fixed order of sums: the results
// are bitwise repeatable from call to call, and match the plain versions
// within 1e-3*|p| + 1e-3*max|p|. No TPU-style row windows or one-hot
// matmuls: the kernels gather directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The body's layout: K channels (two 16-byte records, or all C where fewer)
// per lane, G lanes per (view, pixel), P pixels per block, which covers a
// tile of TH rows of TW pixels: a warp's groups are neighbouring pixels of
// a row.
template <typename T, int C>
struct Layout {
  static constexpr int K = 32 / (int)sizeof(T) < C ? 32 / (int)sizeof(T) : C;
  static constexpr int G = C / K;
  static constexpr int P = kThreads / G;
  static constexpr int TW = 32 / G;
  static constexpr int TH = P / TW;
  static_assert(C % K == 0 && 32 % G == 0 && P % TW == 0, "a pixel's channels fill whole lanes of a warp");
};

// Pixels per block of the channels-last copy: 2048 elements in shared memory.
__host__ __device__ constexpr int copy_tile(int C) { return 2048 / C; }

// src [N, C, HW] -> src_cl, the N views' [HW, C] records, each view between
// two pads of `pad` records of zeros: [pad][view 0][pad][view 1]...[pad].
// Block (tile, n). E is an unsigned integer of the features' size: the copy
// moves bits. A pixel's C channels are 16-128 bytes, so src_cl is written
// in 16-byte stores; src is read in 16-byte loads where H*W allows.
template <typename E, int C>
__device__ __forceinline__ void to_channels_last(const E* __restrict__ src, E* __restrict__ src_cl,
                                                 long long HW, int pad) {
  constexpr int kTile = copy_tile(C);
  constexpr int kPer = 16 / sizeof(E);  // elements per 16-byte load or store
  static_assert(C % kPer == 0, "a pixel's channels fill whole 16-byte stores");
  __shared__ __align__(16) E tile[C][kTile + kPer];
  const long long n = blockIdx.y, p0 = (long long)blockIdx.x * kTile;
  const int np = (int)min((long long)kTile, HW - p0);
  const E* in = src + n * C * HW + p0;
  if (HW % kPer == 0 && reinterpret_cast<size_t>(src) % 16 == 0) {  // then np is a multiple of kPer too
    for (int e = threadIdx.x; e < C * kTile / kPer; e += kThreads) {
      const int c = e / (kTile / kPer), i = e % (kTile / kPer) * kPer;
      if (i < np) *reinterpret_cast<uint4*>(&tile[c][i]) = *reinterpret_cast<const uint4*>(in + c * HW + i);
    }
  } else {
    for (int e = threadIdx.x; e < C * kTile; e += kThreads) {
      const int c = e / kTile, i = e % kTile;
      if (i < np) tile[c][i] = in[c * HW + i];
    }
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(src_cl + (pad + n * (HW + pad) + p0) * C);
  for (int k = threadIdx.x; k < np * C / kPer; k += kThreads) {
    union {
      uint4 u;
      E e[kPer];
    } pack;
#pragma unroll
    for (int j = 0; j < kPer; ++j) pack.e[j] = tile[(k * kPer + j) % C][(k * kPer + j) / C];
    out[k] = pack.u;
  }
  if (blockIdx.x == 0) {  // the pad before the view, and after the last one
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    uint4* before = reinterpret_cast<uint4*>(src_cl + n * (HW + pad) * C);
    for (int k = threadIdx.x; k < pad * C / kPer; k += kThreads) before[k] = zero;
    if (n == gridDim.y - 1) {
      uint4* after = reinterpret_cast<uint4*>(src_cl + (n + 1) * (HW + pad) * C);
      for (int k = threadIdx.x; k < pad * C / kPer; k += kThreads) after[k] = zero;
    }
  }
}

// One 16-byte record of channels as floats.
__device__ __forceinline__ void load_record(const float* p, float v[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void load_record(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address holds the lower half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A sample as a group shares it: the offset of its anchor corner (x0, y0)
// in records from the start of the view's padded run (its own W + 1
// records before the view included), and the weights of the corners
// (y0 + c/2, x0 + c%2), zero for a corner off the plane. A sample that adds
// nothing (Z < 1e-6 or NaN, or no corner on the plane) has zero weights.
struct Sample {
  unsigned at;
  float w[4];
};

__device__ __forceinline__ Sample setup(float X, float Y, float Z, int H, int W) {
  Sample s{0u, {0.f, 0.f, 0.f, 0.f}};
  if (!(Z >= 1e-6f)) return s;
  // One reciprocal (within 2 ulp), not two divisions: the positions move by
  // ~1e-4 px at most, inside the kernels' gate.
  const float iz = __fdividef(1.f, Z);
  const float px = X * iz, py = Y * iz;
  // Clamp before the int cast; beyond [-2, size+1] every corner is zero.
  const float fx = floorf(px), fy = floorf(py);
  const int x0 = (int)fminf(fmaxf(fx, -2.f), (float)W + 1.f);
  const int y0 = (int)fminf(fmaxf(fy, -2.f), (float)H + 1.f);
  const float wx = px - fx, wy = py - fy;
  const bool vy0 = (unsigned)y0 < (unsigned)H, vy1 = (unsigned)(y0 + 1) < (unsigned)H;
  const bool vx0 = (unsigned)x0 < (unsigned)W, vx1 = (unsigned)(x0 + 1) < (unsigned)W;
  if (!((vy0 || vy1) && (vx0 || vx1))) return s;
  s.at = (unsigned)((y0 + 1) * W + x0 + 1);  // x0, y0 >= -1 here
  s.w[0] = (vy0 && vx0) ? (1.f - wx) * (1.f - wy) : 0.f;
  s.w[1] = (vy0 && vx1) ? wx * (1.f - wy) : 0.f;
  s.w[2] = (vy1 && vx0) ? (1.f - wx) * wy : 0.f;
  s.w[3] = (vy1 && vx1) ? wx * wy : 0.f;
  return s;
}

// sum over the lane's K channels (whole 16-byte records) of
// bilinear(sample) * refv; sb points at the lane's channels of the view's
// padded run of [C] records: W + 1 records of zeros, the view's H*W, W + 1
// of zeros, so that every corner of a sample with a corner on the plane is
// in bounds (a corner off the plane has zero weight).
template <typename T, int C, int K>
__device__ __forceinline__ float sample_dot(const T* sb, const float (&refv)[K], const Sample& s, int W) {
  if (s.w[0] + s.w[1] + s.w[2] + s.w[3] == 0.f) return 0.f;  // weights are >= 0
  constexpr int kRecord = 16 / sizeof(T);  // channels per 16-byte record
  const T* row0 = sb + s.at * C;
  const T* row1 = sb + (s.at + W) * C;
  float a[4][K];
#pragma unroll
  for (int m = 0; m < K; m += kRecord) {
    load_record(row0 + m, a[0] + m);
    load_record(row0 + C + m, a[1] + m);
    load_record(row1 + m, a[2] + m);
    load_record(row1 + C + m, a[3] + m);
  }
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) dot = fmaf(a[c][k], refv[k], dot);
    acc = fmaf(s.w[c], dot, acc);
  }
  return acc;
}

// p[j] holds this lane's part of hypothesis j of the round; returns the
// group's total of hypothesis `lane` (recursive halving: at each step a
// lane keeps the half of the hypotheses its bit selects and adds its
// partner's part of them).
template <int G>
__device__ __forceinline__ float transpose_sum(float (&p)[G], int lane) {
#pragma unroll
  for (int h = G / 2; h >= 1; h /= 2) {
    const bool upper = lane & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? p[i] : p[i + h];
      const float keep = upper ? p[i + h] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, h);
    }
  }
  return p[0];
}

// A view's projection of a reference pixel: [X Y Z] = b * z + t.
struct Proj {
  float bx, by, bz, tx, ty, tz;
};

__device__ __forceinline__ Proj projection(const float* __restrict__ rel, int n, float fx, float fy) {
  float r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = __ldg(rel + n * 12 + i);
  return {r[0] * fx + r[1] * fy + r[2], r[4] * fx + r[5] * fy + r[6], r[8] * fx + r[9] * fy + r[10],
          r[3], r[7], r[11]};
}

// One round of a group on one view: lane l sets up hypothesis d0 + l at
// depth zd where `on`, the group takes the G samples in turn by shuffles,
// and the transposing reduction leaves lane l with the group's sum over
// the C channels of hypothesis d0 + l. Every lane of the warp calls it.
template <typename T, int C, int K, int G>
__device__ __forceinline__ float round_total(const T* sb, const float (&refv)[K], const Proj& p, float zd,
                                             bool on, int lane, int H, int W) {
  Sample mine{0u, {0.f, 0.f, 0.f, 0.f}};
  if (on) mine = setup(p.bx * zd + p.tx, p.by * zd + p.ty, p.bz * zd + p.tz, H, W);
  float part[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    Sample s = mine;
    if (G > 1) {
      s.at = __shfl_sync(0xffffffffu, s.at, j, G);
#pragma unroll
      for (int c = 0; c < 4; ++c) s.w[c] = __shfl_sync(0xffffffffu, s.w[c], j, G);
    }
    part[j] = sample_dot<T, C, K>(sb, refv, s, W);
  }
  return transpose_sum<G>(part, lane);
}

// K2/K6's two kernels.
template <typename E, int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_fwd_to_channels_last(
    const E* __restrict__ src, E* __restrict__ src_cl, long long HW, int pad) {
  to_channels_last<E, C>(src, src_cl, HW, pad);
}

// K2/K6's body. Block (a tile of TH x TW pixels of view n), blockIdx.x =
// tile * N + n: the group walks the hypotheses G at a time, lane l setting
// up hypothesis d0 + l, and writes out [B*S, D, H, W].
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_fwd_main(
    const T* __restrict__ src_cl,       // the views' [H, W, C] records, padded
    const T* __restrict__ ref,          // [B, C, H, W]
    const float* __restrict__ rel,      // [B*S, 3, 4]
    const float* __restrict__ depth,    // [B, D, H, W]
    float* __restrict__ out,            // [B*S, D, H, W]
    int N, int S, int D, int H, int W) {
  using L = Layout<T, C>;
  constexpr int K = L::K, G = L::G;
  const int lane = threadIdx.x % G;
  const long long HW = (long long)H * W;
  const int n = blockIdx.x % N;
  const int tile = blockIdx.x / N, tiles_x = (W + L::TW - 1) / L::TW;
  const int g = threadIdx.x / G;
  const int tx = (tile % tiles_x) * L::TW + g % L::TW, ty = (tile / tiles_x) * L::TH + g / L::TW;
  // Every lane of a warp walks all the hypotheses (the groups exchange
  // samples by shuffles); an inactive group's samples add nothing.
  const bool active = tx < W && ty < H;
  const int x = active ? tx : 0, y = active ? ty : 0;
  const long long pa = (long long)y * W + x;
  const int b = n / S;
  const float fx = (float)x, fy = (float)y;
  const Proj p = projection(rel, n, fx, fy);

  float refv[K];
  const T* rb = ref + ((long long)b * C + lane * K) * HW + pa;
#pragma unroll
  for (int k = 0; k < K; ++k) refv[k] = load(rb + k * HW);

  // The view's padded run starts W + 1 records before its first pixel.
  const T* sb = src_cl + n * (HW + W + 1) * C + lane * K;
  const float* zb = depth + (long long)b * D * HW + pa + lane * HW;
  float* ob = out + (long long)n * D * HW + pa + lane * HW;
  float z = active && lane < D ? *zb : 0.f;
  for (int d0 = 0; d0 < D; d0 += G, zb += G * HW, ob += G * HW) {
    // Lane l sets up hypothesis d0 + l, after reading its next depth.
    const int d = d0 + lane;
    const float zd = z;
    z = active && d + G < D ? zb[G * HW] : 0.f;
    const float total = round_total<T, C, K, G>(sb, refv, p, zd, active && d < D, lane, H, W);
    if (active && d < D) *ob = total * (1.f / (float)C);
  }
}

// K7's two kernels (bf16 features).
template <int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_wsum_fwd_to_channels_last(
    const unsigned short* __restrict__ src, unsigned short* __restrict__ src_cl, long long HW, int pad) {
  to_channels_last<unsigned short, C>(src, src_cl, HW, pad);
}

// Hypotheses per chunk of K7 (a multiple of G): a lane keeps its sums of
// a chunk in registers while it walks the views.
constexpr int kChunk = 8;

// K7's body. Block (a tile of TH x TW pixels of unit u), blockIdx.x = tile
// * U + u, u = b * ceil(D / kChunk) + c: the group takes hypotheses
// c * kChunk, ... of batch b, lane l hypothesis c * kChunk + l of each of
// the chunk's rounds of G. For each view in turn (its weight, projection
// and records set up once) it adds the weighted totals of the rounds to
// sums in registers, then writes them to out [B, D, H, W].
template <int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_wsum_fwd_main(
    const __nv_bfloat16* __restrict__ src_cl,  // the views' [H, W, C] records, padded
    const __nv_bfloat16* __restrict__ ref,     // [B, C, H, W]
    const float* __restrict__ rel,             // [B*S, 3, 4]
    const float* __restrict__ depth,           // [B, D, H, W]
    const float* __restrict__ vw,              // [B, S, H, W]
    float* __restrict__ out,                   // [B, D, H, W]
    int U, int S, int D, int H, int W) {
  using T = __nv_bfloat16;
  using L = Layout<T, C>;
  constexpr int K = L::K, G = L::G;
  constexpr int R = kChunk / G;  // rounds per chunk
  static_assert(kChunk % G == 0, "a chunk holds whole rounds");
  const int lane = threadIdx.x % G;
  const long long HW = (long long)H * W;
  const int u = blockIdx.x % U;
  const int tile = blockIdx.x / U, tiles_x = (W + L::TW - 1) / L::TW;
  const int g = threadIdx.x / G;
  const int tx = (tile % tiles_x) * L::TW + g % L::TW, ty = (tile / tiles_x) * L::TH + g / L::TW;
  // Every lane of a warp walks all the views and rounds (the groups
  // exchange samples by shuffles); an inactive group's samples add nothing.
  const bool active = tx < W && ty < H;
  const int x = active ? tx : 0, y = active ? ty : 0;
  const long long pa = (long long)y * W + x;
  const int nc = (D + kChunk - 1) / kChunk;
  const int b = u / nc;
  const int d0 = u % nc * kChunk + lane;  // the lane's hypothesis of round 0
  const float fx = (float)x, fy = (float)y;

  float refv[K];
  const T* rb = ref + ((long long)b * C + lane * K) * HW + pa;
#pragma unroll
  for (int k = 0; k < K; ++k) refv[k] = load(rb + k * HW);

  float z[R], sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = d0 + r * G;
    z[r] = active && d < D ? depth[((long long)b * D + d) * HW + pa] : 0.f;
    sum[r] = 0.f;
  }
  for (int s = 0; s < S; ++s) {
    // View s, weighted by w. Its padded run starts W + 1 records before its
    // first pixel.
    const int n = b * S + s;
    const float w = active ? __ldg(vw + n * HW + pa) : 0.f;
    const Proj p = projection(rel, n, fx, fy);
    const T* sb = src_cl + n * (HW + W + 1) * C + lane * K;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool on = active && d0 + r * G < D;
      sum[r] = fmaf(w, round_total<T, C, K, G>(sb, refv, p, z[r], on, lane, H, W), sum[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = d0 + r * G;
    if (active && d < D) out[((long long)b * D + d) * HW + pa] = sum[r] * (1.f / (float)C);
  }
}

template <typename T, int C>
cudaError_t launch(const void* src, const void* ref, const void* rel, const void* depth,
                   void* out, int N, int S, int D, int H, int W, cudaStream_t stream, void* src_cl) {
  using E = std::conditional_t<sizeof(T) == 2, unsigned short, unsigned>;
  const long long HW = (long long)H * W;
  const dim3 copy_grid((unsigned)((HW + copy_tile(C) - 1) / copy_tile(C)), (unsigned)N);
  warp_correlate_fwd_to_channels_last<E, C><<<copy_grid, kThreads, 0, stream>>>(
      static_cast<const E*>(src), static_cast<E*>(src_cl), HW, W + 1);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  using L = Layout<T, C>;
  const unsigned blocks = (unsigned)((W + L::TW - 1) / L::TW) * ((H + L::TH - 1) / L::TH) * N;
  warp_correlate_fwd_main<T, C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(src_cl), static_cast<const T*>(ref), static_cast<const float*>(rel),
      static_cast<const float*>(depth), static_cast<float*>(out), N, S, D, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const void* src, const void* ref, const void* rel, const void* depth,
                     void* out, int N, int S, int D, int H, int W, cudaStream_t s, void* src_cl) {
  switch (C) {
    case 8: return launch<T, 8>(src, ref, rel, depth, out, N, S, D, H, W, s, src_cl);
    case 16: return launch<T, 16>(src, ref, rel, depth, out, N, S, D, H, W, s, src_cl);
    case 32: return launch<T, 32>(src, ref, rel, depth, out, N, S, D, H, W, s, src_cl);
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t launch_wsum(const void* src, const void* ref, const void* rel, const void* depth,
                        const void* vw, void* out, int B, int S, int D, int H, int W,
                        cudaStream_t stream, void* src_cl) {
  const long long HW = (long long)H * W;
  const dim3 copy_grid((unsigned)((HW + copy_tile(C) - 1) / copy_tile(C)), (unsigned)(B * S));
  warp_correlate_wsum_fwd_to_channels_last<C><<<copy_grid, kThreads, 0, stream>>>(
      static_cast<const unsigned short*>(src), static_cast<unsigned short*>(src_cl), HW, W + 1);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  using L = Layout<__nv_bfloat16, C>;
  const int U = B * ((D + kChunk - 1) / kChunk);
  const unsigned blocks = (unsigned)((W + L::TW - 1) / L::TW) * ((H + L::TH - 1) / L::TH) * U;
  warp_correlate_wsum_fwd_main<C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(src_cl), static_cast<const __nv_bfloat16*>(ref),
      static_cast<const float*>(rel), static_cast<const float*>(depth), static_cast<const float*>(vw),
      static_cast<float*>(out), U, S, D, H, W);
  return cudaGetLastError();
}

}  // namespace

// K2/K6. src and ref are bf16 when bf16 != 0, else float32; scratch
// src_cl [N, H, W, C] in the features' dtype, 16-byte aligned, after the
// stream (an earlier build of this entry point took none and ignores it).
// Returns a cudaError_t code: 0 on success, else the first launch's error.
extern "C" int warp_correlate_forward(const void* src, const void* ref, const void* rel,
                                      const void* depth, void* out, int N, int S, int C,
                                      int D, int H, int W, int bf16, void* stream, void* src_cl) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)dispatch<__nv_bfloat16>(C, src, ref, rel, depth, out, N, S, D, H, W, s, src_cl);
  return (int)dispatch<float>(C, src, ref, rel, depth, out, N, S, D, H, W, s, src_cl);
}

// K7: bf16 src and ref, float32 rel, depth and vw; out [B, D, H, W];
// scratch src_cl as K2's, after the stream (an earlier build of this entry
// point took none and ignores it). Returns a cudaError_t code: 0 on
// success, else the first launch's error.
extern "C" int warp_correlate_wsum_forward(const void* src, const void* ref, const void* rel,
                                           const void* depth, const void* vw, void* out, int B,
                                           int S, int C, int D, int H, int W, void* stream,
                                           void* src_cl) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return (int)launch_wsum<8>(src, ref, rel, depth, vw, out, B, S, D, H, W, s, src_cl);
    case 16: return (int)launch_wsum<16>(src, ref, rel, depth, vw, out, B, S, D, H, W, s, src_cl);
    case 32: return (int)launch_wsum<32>(src, ref, rel, depth, vw, out, B, S, D, H, W, s, src_cl);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* warp_correlate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
