// DCNv2 forward with given offsets and mask: float32 or bf16 activations.
//
// Replaces two TPU kernels that compute one function and differ only in
// the activation type:
//   transmvsnet_tpu/ops/pallas/dcn_rowsweep.py::deform_conv2d_rowsweep
//     (float32 throughout; the JAX package's float32 path), and
//   transmvsnet_tpu/ops/pallas/dcn_onehot.py::deform_conv2d_onehot
//     (bf16 activations, float32 offsets, mask and accumulation).
// For every output pixel p = (y, x),
//   out[o] = bias[o] + sum_k sum_c m_k * bilinear(x[c], y+k/3-1+dy_k, x+k%3-1+dx_k) * w[k, c, o]
// with per-corner zeros padding, accumulated in float32 and rounded once to
// the activation type (the bias is added before that rounding, as row 4's
// wrapper adds it in float32).
//
// What bounds it on an H100: per pixel it reads 27 float32 offset/mask
// values, gathers 36*C activations and does 9*C*C_out multiply-adds. At the
// float32 inference shapes that is ~6.6 GB (~2.0 ms at 3.35 TB/s) against
// ~2.8e11 float32 operations (~4.2 ms at the 67 TFLOP/s non-tensor peak), so
// by the roofline it is bound by operations; this simple version runs them
// on the float32 CUDA cores, one thread per pixel.
//
// Design: K1's (dcn_fused.cu) without its offset-conv prologue. One thread
// per output pixel; the block stages the [9*C, C_out] weight and the bias in
// shared memory as float32 (a broadcast: every thread of a warp reads the
// same word); each tap's four corners are gathered directly, with no
// TPU-style row windows (DR) or x-windows (XW), so the kernel matches the
// plain version at every pixel; C_out float32 sums stay in registers.
// Neighbouring threads read neighbouring offsets and, for smooth offsets,
// neighbouring source pixels of each channel plane, which L1/L2 serve.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int C, int COUT>
__global__ void __launch_bounds__(kThreads) dcn_kernel(
    const T* __restrict__ x,          // [N, C, H, W]
    const float* __restrict__ dy,     // [N, 9, H, W]
    const float* __restrict__ dx,     // [N, 9, H, W]
    const float* __restrict__ mask,   // [N, 9, H, W]
    const float* __restrict__ w,      // [9*C, COUT], row = tap*C + c
    const float* __restrict__ bias,   // [COUT]
    T* __restrict__ out,              // [N, COUT, H, W]
    int N, int H, int W) {
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_bias = s_w + kTaps * C * COUT;
  for (int i = threadIdx.x; i < kTaps * C * COUT; i += blockDim.x) s_w[i] = w[i];
  if (threadIdx.x < COUT) s_bias[threadIdx.x] = bias[threadIdx.x];
  __syncthreads();

  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)N * HW) return;
  const int n = (int)(p / HW);
  const long long pix = p - (long long)n * HW;
  const int oy = (int)(pix / W);
  const int ox = (int)(pix - (long long)oy * W);
  const T* xb = x + (long long)n * C * HW;
  const long long kofs = (long long)n * kTaps * HW + pix;

  float acc[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) acc[o] = 0.f;
  for (int t = 0; t < kTaps; ++t) {
    const float py = (float)(oy + t / 3 - 1) + dy[kofs + t * HW];
    const float px = (float)(ox + t % 3 - 1) + dx[kofs + t * HW];
    const float m = mask[kofs + t * HW];
    // Clamp before the int cast; anything beyond [-2, size+1] samples zero.
    const float y0f = fminf(fmaxf(floorf(py), -2.f), (float)H + 1.f);
    const float x0f = fminf(fmaxf(floorf(px), -2.f), (float)W + 1.f);
    const float wy = py - floorf(py);
    const float wx = px - floorf(px);
    const int y0 = (int)y0f, x0 = (int)x0f, y1 = y0 + 1, x1 = x0 + 1;
    const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
    if (!((vy0 || vy1) && (vx0 || vx1))) continue;
    const float w00 = (vy0 && vx0) ? (1.f - wx) * (1.f - wy) * m : 0.f;
    const float w01 = (vy0 && vx1) ? wx * (1.f - wy) * m : 0.f;
    const float w10 = (vy1 && vx0) ? (1.f - wx) * wy * m : 0.f;
    const float w11 = (vy1 && vx1) ? wx * wy * m : 0.f;
    const int cy0 = min(max(y0, 0), H - 1), cy1 = min(max(y1, 0), H - 1);
    const int cx0 = min(max(x0, 0), W - 1), cx1 = min(max(x1, 0), W - 1);
    const long long i00 = (long long)cy0 * W + cx0, i01 = (long long)cy0 * W + cx1;
    const long long i10 = (long long)cy1 * W + cx0, i11 = (long long)cy1 * W + cx1;
    const float* wr = s_w + t * C * COUT;
#pragma unroll 2
    for (int c = 0; c < C; ++c) {
      const T* xc = xb + c * HW;
      const float s = w00 * load(xc + i00) + w01 * load(xc + i01) + w10 * load(xc + i10) +
                      w11 * load(xc + i11);
#pragma unroll
      for (int o = 0; o < COUT; ++o) acc[o] = fmaf(s, wr[c * COUT + o], acc[o]);
    }
  }

  T* ob = out + (long long)n * COUT * HW + pix;
#pragma unroll
  for (int o = 0; o < COUT; ++o) store(ob + o * HW, acc[o] + s_bias[o]);
}

template <typename T, int C, int COUT>
cudaError_t launch(const void* x, const void* dy, const void* dx, const void* mask, const void* w,
                   const void* bias, void* out, int N, int H, int W, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kTaps * C * COUT + COUT);
  cudaError_t err = cudaFuncSetAttribute(dcn_kernel<T, C, COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n = (long long)N * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  dcn_kernel<T, C, COUT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dy), static_cast<const float*>(dx),
      static_cast<const float*>(mask), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), N, H, W);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t dispatch_cout(int cout, const void* x, const void* dy, const void* dx,
                          const void* mask, const void* w, const void* bias, void* out, int N,
                          int H, int W, cudaStream_t s) {
  switch (cout) {
    case 8: return launch<T, C, 8>(x, dy, dx, mask, w, bias, out, N, H, W, s);
    case 16: return launch<T, C, 16>(x, dy, dx, mask, w, bias, out, N, H, W, s);
    case 32: return launch<T, C, 32>(x, dy, dx, mask, w, bias, out, N, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int C, int cout, const void* x, const void* dy, const void* dx,
                     const void* mask, const void* w, const void* bias, void* out, int N, int H,
                     int W, cudaStream_t s) {
  switch (C) {
    case 8: return dispatch_cout<T, 8>(cout, x, dy, dx, mask, w, bias, out, N, H, W, s);
    case 16: return dispatch_cout<T, 16>(cout, x, dy, dx, mask, w, bias, out, N, H, W, s);
    case 32: return dispatch_cout<T, 32>(cout, x, dy, dx, mask, w, bias, out, N, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x and out are bf16 when bf16 != 0, else float32. Returns a cudaError_t
// code: 0 on success, else the launch's error.
extern "C" int dcn_forward(const void* x, const void* dy, const void* dx, const void* mask,
                           const void* w, const void* bias, void* out, int N, int C, int COUT,
                           int H, int W, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)dispatch<__nv_bfloat16>(C, COUT, x, dy, dx, mask, w, bias, out, N, H, W, s);
  return (int)dispatch<float>(C, COUT, x, dy, dx, mask, w, bias, out, N, H, W, s);
}

extern "C" const char* dcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
