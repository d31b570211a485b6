// Plane-sweep warp-correlation forward: float32 or bf16 features in,
// float32 similarity out; and its view-weighted sum over the source views.
//
// Replaces three TPU kernels:
//   transmvsnet_tpu/ops/pallas/warp_onehot.py::warp_correlate_onehot (bf16
//     features; warp_correlate_kernel's bf16 instantiation, K2),
//   transmvsnet_tpu/ops/pallas/warp_rowsweep.py::warp_correlate_rowsweep
//     (float32 features; its float instantiation, K6), and
//   transmvsnet_tpu/ops/pallas/warp_onehot.py::warp_correlate_wsum_onehot
//     (bf16 features; warp_correlate_wsum_kernel, K7).
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
// roofline it is bound by bytes. In practice the 4*C scattered gathers per
// sample (2 bytes each in bf16, 4 in float32) dominate: they are served by
// L1/L2 (a source plane of a stage fits in the 50 MB L2), so the real limit
// is load-instruction issue and gather latency.
//
// Design: K2/K6 run one thread per (view, pixel); K7 one thread per
// (batch, pixel), looping over the hypotheses outside and the views inside,
// with the batch's S projection rows in shared memory, so depth and the
// reference features are read once per (batch, hypothesis, pixel) and each
// output is written once, without atomics. Each thread keeps its C
// reference values in registers. Neighbouring threads project to
// neighbouring source pixels for a smooth depth map, so a warp's gathers
// fall into a few cache lines of each channel plane. No TPU-style row
// windows or one-hot matmuls: the kernels gather directly and match the
// plain versions at every pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Sum over the C channels of bilinear(src planes sb, X/Z, Y/Z) * refv[c];
// zero where Z < 1e-6 or every corner lies off the H x W plane.
template <typename T, int C>
__device__ __forceinline__ float correlate(const T* sb, const float* refv, float X, float Y,
                                           float Z, int H, int W) {
  float acc = 0.f;
  if (!(Z >= 1e-6f)) return acc;
  const long long HW = (long long)H * W;
  const float px = X / Z, py = Y / Z;
  // Clamp before the int cast; beyond [-2, size+1] every corner is zero.
  const float x0f = fminf(fmaxf(floorf(px), -2.f), (float)W + 1.f);
  const float y0f = fminf(fmaxf(floorf(py), -2.f), (float)H + 1.f);
  const float wx = px - floorf(px), wy = py - floorf(py);
  const int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
  if (!((vy0 || vy1) && (vx0 || vx1))) return acc;
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
    acc = fmaf(v, refv[c], acc);
  }
  return acc;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_kernel(
    const T* __restrict__ src,          // [B*S, C, H, W]
    const T* __restrict__ ref,          // [B, C, H, W]
    const float* __restrict__ rel,      // [B*S, 3, 4]
    const float* __restrict__ depth,    // [B, D, H, W]
    float* __restrict__ out,            // [B*S, D, H, W]
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

  float refv[C];
  const T* rb = ref + (long long)b * C * HW + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) refv[c] = load(rb + c * HW);

  const T* sb = src + (long long)n * C * HW;
  const float* db = depth + (long long)b * D * HW + pix;
  float* ob = out + (long long)n * D * HW + pix;
  for (int d = 0; d < D; ++d) {
    const float z = db[d * HW];
    const float acc = correlate<T, C>(sb, refv, bx * z + r[3], by * z + r[7], bz * z + r[11], H, W);
    ob[d * HW] = acc / (float)C;
  }
}

// Grid (pixel blocks, B); dynamic shared memory holds the batch's S x 12
// projection entries.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_wsum_kernel(
    const T* __restrict__ src,          // [B*S, C, H, W]
    const T* __restrict__ ref,          // [B, C, H, W]
    const float* __restrict__ rel,      // [B*S, 3, 4]
    const float* __restrict__ depth,    // [B, D, H, W]
    const float* __restrict__ vw,       // [B, S, H, W]
    float* __restrict__ out,            // [B, D, H, W]
    int S, int D, int H, int W) {
  extern __shared__ float rs[];  // [S, 12]
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < S * 12; i += blockDim.x) rs[i] = rel[(long long)b * S * 12 + i];
  __syncthreads();
  const long long HW = (long long)H * W;
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= HW) return;
  const int y = (int)(pix / W);
  const int x = (int)(pix - (long long)y * W);
  const float fx = (float)x, fy = (float)y;

  float refv[C];
  const T* rb = ref + (long long)b * C * HW + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) refv[c] = load(rb + c * HW);

  const T* sb = src + (long long)b * S * C * HW;
  const float* wb = vw + (long long)b * S * HW + pix;
  const float* db = depth + (long long)b * D * HW + pix;
  float* ob = out + (long long)b * D * HW + pix;
  for (int d = 0; d < D; ++d) {
    const float z = db[d * HW];
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* r = rs + s * 12;
      const float X = (r[0] * fx + r[1] * fy + r[2]) * z + r[3];
      const float Y = (r[4] * fx + r[5] * fy + r[6]) * z + r[7];
      const float Z = (r[8] * fx + r[9] * fy + r[10]) * z + r[11];
      const float sim = correlate<T, C>(sb + (long long)s * C * HW, refv, X, Y, Z, H, W) / (float)C;
      acc = fmaf(wb[s * HW], sim, acc);
    }
    ob[d * HW] = acc;
  }
}

template <typename T, int C>
cudaError_t launch(const void* src, const void* ref, const void* rel, const void* depth,
                   void* out, int N, int S, int D, int H, int W, cudaStream_t stream) {
  const long long n = (long long)N * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  warp_correlate_kernel<T, C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref), static_cast<const float*>(rel),
      static_cast<const float*>(depth), static_cast<float*>(out), N, S, D, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const void* src, const void* ref, const void* rel, const void* depth,
                     void* out, int N, int S, int D, int H, int W, cudaStream_t s) {
  switch (C) {
    case 8: return launch<T, 8>(src, ref, rel, depth, out, N, S, D, H, W, s);
    case 16: return launch<T, 16>(src, ref, rel, depth, out, N, S, D, H, W, s);
    case 32: return launch<T, 32>(src, ref, rel, depth, out, N, S, D, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t launch_wsum(const void* src, const void* ref, const void* rel, const void* depth,
                        const void* vw, void* out, int B, int S, int D, int H, int W,
                        cudaStream_t stream) {
  const long long hw = (long long)H * W;
  const dim3 grid((unsigned)((hw + kThreads - 1) / kThreads), (unsigned)B);
  const size_t smem = sizeof(float) * 12 * S;
  warp_correlate_wsum_kernel<__nv_bfloat16, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(ref),
      static_cast<const float*>(rel), static_cast<const float*>(depth),
      static_cast<const float*>(vw), static_cast<float*>(out), S, D, H, W);
  return cudaGetLastError();
}

}  // namespace

// src and ref are bf16 when bf16 != 0, else float32. Returns a cudaError_t
// code: 0 on success, else the launch's error.
extern "C" int warp_correlate_forward(const void* src, const void* ref, const void* rel,
                                      const void* depth, void* out, int N, int S, int C,
                                      int D, int H, int W, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)dispatch<__nv_bfloat16>(C, src, ref, rel, depth, out, N, S, D, H, W, s);
  return (int)dispatch<float>(C, src, ref, rel, depth, out, N, S, D, H, W, s);
}

// K7: bf16 src and ref, float32 rel, depth and vw; out [B, D, H, W].
// Returns a cudaError_t code: 0 on success, else the launch's error.
extern "C" int warp_correlate_wsum_forward(const void* src, const void* ref, const void* rel,
                                           const void* depth, const void* vw, void* out, int B,
                                           int S, int C, int D, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return (int)launch_wsum<8>(src, ref, rel, depth, vw, out, B, S, D, H, W, s);
    case 16: return (int)launch_wsum<16>(src, ref, rel, depth, vw, out, B, S, D, H, W, s);
    case 32: return (int)launch_wsum<32>(src, ref, rel, depth, vw, out, B, S, D, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* warp_correlate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
