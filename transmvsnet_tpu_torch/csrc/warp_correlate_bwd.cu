// Plane-sweep warp-correlation backward: gradients of the source and
// reference features (and of the view weights), float32, from float32 or
// bf16 features.
//
// Replaces two TPU kernels, which the JAX package computes with one Pallas
// kernel body (_bwd_kernel):
//   transmvsnet_tpu/ops/pallas/warp_bwd.py::warp_correlate_bwd (the S = 1,
//     unit-view-weight case; bf16 there): warp_correlate_bwd_kernel with
//     kWsum = false, K4. Its float32 instantiation serves the float32 path,
//     where the JAX package differentiates warp_rowsweep.py by autodiff of
//     the XLA warp (ops/pallas/vjp.py, pallas_bwd=None): the same gradient.
//   transmvsnet_tpu/ops/pallas/warp_bwd.py::warp_correlate_wsum_bwd (bf16):
//     the same kernel with kWsum = true, K8.
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
// and K8 also
//   dvw[n, p]     = sum_d g[b, d, p] * sim[n, d, p].
// Projections and depth hypotheses get no gradient: the sample grid is
// built without one in the reference.
//
// What bounds it on an H100: per (view, hypothesis, pixel) it gathers 4*C
// feature values and scatters 4*C float32 atomics into dsrc; its unique traffic
// is one depth and one cotangent read, so by the roofline it is bound by
// bytes, in practice by the atomics and the gathers.
//
// Design: one thread per (view, pixel), looping over the D hypotheses as the
// forward kernel does. It keeps the C reference values, the projected ray
// and C dref sums in registers, gathers the four corners directly (no
// TPU-style row windows or one-hot matmuls) and scatters into dsrc with
// atomicAdd, skipping corners of zero weight. At the end it adds its C dref
// sums into dref with one atomic each, so the S views of a batch sum there.
// The per-hypothesis cotangent is formed in one place (gd below), where K8
// multiplies in the view weight; K8's dvw sum belongs to the thread's own
// (view, pixel), so it is written once, without an atomic. K8 still samples
// where vw = 0 (its dvw needs sim there) but scatters nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// kWsum = false (K4): g is [B*S, D, H, W], vw and dvw are unused.
// kWsum = true (K8): g is [B, D, H, W], shared by the S views.
template <typename T, int C, bool kWsum>
__global__ void __launch_bounds__(kThreads) warp_correlate_bwd_kernel(
    const T* __restrict__ src,              // [B*S, C, H, W]
    const T* __restrict__ ref,              // [B, C, H, W]
    const float* __restrict__ rel,          // [B*S, 3, 4]
    const float* __restrict__ depth,        // [B, D, H, W]
    const float* __restrict__ vw,           // [B*S, H, W] (K8)
    const float* __restrict__ g,            // [B*S or B, D, H, W]
    float* __restrict__ dsrc,               // [B*S, C, H, W], zeroed by the caller
    float* __restrict__ dref,               // [B, C, H, W], zeroed by the caller
    float* __restrict__ dvw,                // [B*S, H, W] (K8)
    int N, int S, int D, int H, int W) {
  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)N * HW) return;
  const int n = (int)(p / HW);
  const int b = n / S;
  const long long pix = p - (long long)n * HW;
  const int y = (int)(pix / W);
  const int x = (int)(pix - (long long)y * W);

  float r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = __ldg(rel + n * 12 + i);
  const float fx = (float)x, fy = (float)y;
  const float bx = r[0] * fx + r[1] * fy + r[2];
  const float by = r[4] * fx + r[5] * fy + r[6];
  const float bz = r[8] * fx + r[9] * fy + r[10];

  float refv[C], dr[C];
  const T* rb = ref + (long long)b * C * HW + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    refv[c] = load(rb + c * HW);
    dr[c] = 0.f;
  }

  const T* sb = src + (long long)n * C * HW;
  float* db = dsrc + (long long)n * C * HW;
  const float* zb = depth + (long long)b * D * HW + pix;
  const float* gb = g + (long long)(kWsum ? b : n) * D * HW + pix;
  const float wv = kWsum ? vw[(long long)n * HW + pix] : 1.f;
  const float inv_c = 1.f / (float)C;
  float dv = 0.f;
  for (int d = 0; d < D; ++d) {
    const float gv = gb[d * HW];
    const float gd = kWsum ? gv * wv * inv_c : gv * inv_c;
    const float z = zb[d * HW];
    const float X = bx * z + r[3];
    const float Y = by * z + r[7];
    const float Z = bz * z + r[11];
    if (!(Z >= 1e-6f) || (kWsum ? gv : gd) == 0.f) continue;
    const float px = X / Z, py = Y / Z;
    // Clamp before the int cast; beyond [-2, size+1] every corner is zero.
    const float x0f = fminf(fmaxf(floorf(px), -2.f), (float)W + 1.f);
    const float y0f = fminf(fmaxf(floorf(py), -2.f), (float)H + 1.f);
    const float wx = px - floorf(px), wy = py - floorf(py);
    const int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
    const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
    if (!((vy0 || vy1) && (vx0 || vx1))) continue;
    const float w00 = (vy0 && vx0) ? (1.f - wx) * (1.f - wy) : 0.f;
    const float w01 = (vy0 && vx1) ? wx * (1.f - wy) : 0.f;
    const float w10 = (vy1 && vx0) ? (1.f - wx) * wy : 0.f;
    const float w11 = (vy1 && vx1) ? wx * wy : 0.f;
    const int cy0 = min(max(y0, 0), H - 1), cy1 = min(max(y1, 0), H - 1);
    const int cx0 = min(max(x0, 0), W - 1), cx1 = min(max(x1, 0), W - 1);
    const long long i00 = (long long)cy0 * W + cx0, i01 = (long long)cy0 * W + cx1;
    const long long i10 = (long long)cy1 * W + cx0, i11 = (long long)cy1 * W + cx1;
    const bool scatter = !kWsum || gd != 0.f;
    float sim = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T* sc = sb + c * HW;
      const float v = w00 * load(sc + i00) + w01 * load(sc + i01) + w10 * load(sc + i10) +
                      w11 * load(sc + i11);
      if (kWsum) sim = fmaf(v, refv[c], sim);
      dr[c] = fmaf(v, gd, dr[c]);
      const float s = refv[c] * gd;
      float* dc = db + c * HW;
      if (scatter) {
        if (w00 != 0.f) atomicAdd(dc + i00, s * w00);
        if (w01 != 0.f) atomicAdd(dc + i01, s * w01);
        if (w10 != 0.f) atomicAdd(dc + i10, s * w10);
        if (w11 != 0.f) atomicAdd(dc + i11, s * w11);
      }
    }
    if (kWsum) dv = fmaf(gv, sim * inv_c, dv);
  }
  float* drb = dref + (long long)b * C * HW + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(drb + c * HW, dr[c]);
  if (kWsum) dvw[(long long)n * HW + pix] = dv;
}

template <typename T, int C, bool kWsum>
cudaError_t launch(const void* src, const void* ref, const void* rel, const void* depth,
                   const void* vw, const void* g, void* dsrc, void* dref, void* dvw, int N, int S,
                   int D, int H, int W, cudaStream_t stream) {
  const long long n = (long long)N * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  warp_correlate_bwd_kernel<T, C, kWsum><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref),
      static_cast<const float*>(rel), static_cast<const float*>(depth),
      static_cast<const float*>(vw), static_cast<const float*>(g), static_cast<float*>(dsrc),
      static_cast<float*>(dref), static_cast<float*>(dvw), N, S, D, H, W);
  return cudaGetLastError();
}

template <typename T, bool kWsum>
cudaError_t dispatch(int C, const void* src, const void* ref, const void* rel, const void* depth,
                     const void* vw, const void* g, void* dsrc, void* dref, void* dvw, int N,
                     int S, int D, int H, int W, cudaStream_t s) {
  switch (C) {
    case 8: return launch<T, 8, kWsum>(src, ref, rel, depth, vw, g, dsrc, dref, dvw, N, S, D, H, W, s);
    case 16: return launch<T, 16, kWsum>(src, ref, rel, depth, vw, g, dsrc, dref, dvw, N, S, D, H, W, s);
    case 32: return launch<T, 32, kWsum>(src, ref, rel, depth, vw, g, dsrc, dref, dvw, N, S, D, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// src and ref are bf16 when bf16 != 0, else float32. Returns a cudaError_t
// code: 0 on success, else the launch's error.
extern "C" int warp_correlate_bwd(const void* src, const void* ref, const void* rel,
                                  const void* depth, const void* g, void* dsrc, void* dref,
                                  int N, int S, int C, int D, int H, int W, int bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch<__nv_bfloat16, false>(C, src, ref, rel, depth, nullptr, g, dsrc, dref,
                                               nullptr, N, S, D, H, W, s);
  return (int)dispatch<float, false>(C, src, ref, rel, depth, nullptr, g, dsrc, dref, nullptr, N,
                                     S, D, H, W, s);
}

// K8: bf16 src and ref; float32 rel, depth, vw [B*S, H, W] and g [B, D, H, W];
// dsrc and dref zeroed by the caller, dvw [B*S, H, W] written in full.
// Returns a cudaError_t code: 0 on success, else the launch's error.
extern "C" int warp_correlate_wsum_bwd(const void* src, const void* ref, const void* rel,
                                       const void* depth, const void* vw, const void* g,
                                       void* dsrc, void* dref, void* dvw, int N, int S, int C,
                                       int D, int H, int W, void* stream) {
  return (int)dispatch<__nv_bfloat16, true>(C, src, ref, rel, depth, vw, g, dsrc, dref, dvw, N, S,
                                            D, H, W, static_cast<cudaStream_t>(stream));
}

extern "C" const char* warp_correlate_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
