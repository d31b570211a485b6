// Plane-sweep warp-correlation backward: gradients of the source and
// reference features, float32, from float32 or bf16 features.
//
// Replaces transmvsnet_tpu/ops/pallas/warp_bwd.py::warp_correlate_bwd (the
// S = 1, unit-view-weight case of the TPU kernel _bwd_kernel; bf16 there).
// Its float32 instantiation serves the float32 path, where the JAX package
// differentiates warp_rowsweep.py by autodiff of the XLA warp
// (ops/pallas/vjp.py, pallas_bwd=None): the same gradient. For the forward
// of warp_correlate.cu,
//   out[n, d, p] = mean_c bilinear(src[n, c], px, py) * ref[b, c, p]
// with (px, py) the projection of ref pixel p at depth[b, d, p] into source
// view n = b*S + s (invalid, contributing nothing, where its z < 1e-6), and
// the cotangent g[n, d, p], it returns
//   dref[b, c, p] = sum_s sum_d samp_c(n, d, p) * g[n, d, p] / C
//   dsrc[n, c]    = scatter of ref[b, c, p] * g[n, d, p] / C * w_corner
//                   into the four corners of every (d, p)
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
// The per-hypothesis cotangent is formed in one place (gd below): a view
// weight (the weighted view-sum kernel, row 8 of the port's kernel table)
// multiplies it there, and its own gradient sum_d g * sim would be a third
// output beside dref.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_bwd_kernel(
    const T* __restrict__ src,              // [B*S, C, H, W]
    const T* __restrict__ ref,              // [B, C, H, W]
    const float* __restrict__ rel,          // [B*S, 3, 4]
    const float* __restrict__ depth,        // [B, D, H, W]
    const float* __restrict__ g,            // [B*S, D, H, W]
    float* __restrict__ dsrc,               // [B*S, C, H, W], zeroed by the caller
    float* __restrict__ dref,               // [B, C, H, W], zeroed by the caller
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
  const float* gb = g + (long long)n * D * HW + pix;
  const float inv_c = 1.f / (float)C;
  for (int d = 0; d < D; ++d) {
    const float gd = gb[d * HW] * inv_c;
    const float z = zb[d * HW];
    const float X = bx * z + r[3];
    const float Y = by * z + r[7];
    const float Z = bz * z + r[11];
    if (!(Z >= 1e-6f) || gd == 0.f) continue;
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
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T* sc = sb + c * HW;
      const float v = w00 * load(sc + i00) + w01 * load(sc + i01) + w10 * load(sc + i10) +
                      w11 * load(sc + i11);
      dr[c] = fmaf(v, gd, dr[c]);
      const float s = refv[c] * gd;
      float* dc = db + c * HW;
      if (w00 != 0.f) atomicAdd(dc + i00, s * w00);
      if (w01 != 0.f) atomicAdd(dc + i01, s * w01);
      if (w10 != 0.f) atomicAdd(dc + i10, s * w10);
      if (w11 != 0.f) atomicAdd(dc + i11, s * w11);
    }
  }
  float* drb = dref + (long long)b * C * HW + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(drb + c * HW, dr[c]);
}

template <typename T, int C>
cudaError_t launch(const void* src, const void* ref, const void* rel, const void* depth,
                   const void* g, void* dsrc, void* dref, int N, int S, int D, int H, int W,
                   cudaStream_t stream) {
  const long long n = (long long)N * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  warp_correlate_bwd_kernel<T, C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref),
      static_cast<const float*>(rel), static_cast<const float*>(depth),
      static_cast<const float*>(g), static_cast<float*>(dsrc), static_cast<float*>(dref), N, S,
      D, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const void* src, const void* ref, const void* rel, const void* depth,
                     const void* g, void* dsrc, void* dref, int N, int S, int D, int H, int W,
                     cudaStream_t s) {
  switch (C) {
    case 8: return launch<T, 8>(src, ref, rel, depth, g, dsrc, dref, N, S, D, H, W, s);
    case 16: return launch<T, 16>(src, ref, rel, depth, g, dsrc, dref, N, S, D, H, W, s);
    case 32: return launch<T, 32>(src, ref, rel, depth, g, dsrc, dref, N, S, D, H, W, s);
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
    return (int)dispatch<__nv_bfloat16>(C, src, ref, rel, depth, g, dsrc, dref, N, S, D, H, W, s);
  return (int)dispatch<float>(C, src, ref, rel, depth, g, dsrc, dref, N, S, D, H, W, s);
}

extern "C" const char* warp_correlate_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
