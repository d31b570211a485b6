// Fused DCNv2 forward: 3x3 offset/mask conv + deformable 3x3 conv, bf16 in/out.
//
// Replaces transmvsnet_tpu/ops/pallas/dcn_onehot.py::deform_conv2d_onehot_fused
// (the TPU kernel _kernel_fused). Same function: for every output pixel,
//   off[27]  = conv3x3(x, k_off) + b_off          (zero padding)
//   dy_k = off[2k], dx_k = off[2k+1], m_k = sigmoid(off[18+k])
//   out[o]   = bias[o] + sum_k sum_c m_k * bilinear(x[c], y+k/3-1+dy_k, x+k%3-1+dx_k) * w[k, c, o]
// with per-corner zeros padding. The offsets never reach device memory.
//
// What bounds it on an H100: per pixel it reads 9*C input values for the
// offset conv and 36*C gathered values for the sampler, and does about
// 9*C*(27 + C_out) multiply-adds. At C = C_out = 32 that is ~17k FMAs per
// pixel against 128 bytes of unique input and 64 bytes of output, so the
// roofline is set by the arithmetic on the tensor cores and by the bytes
// about equally; this simple version runs the arithmetic on the float32
// CUDA cores instead, which makes it operation-bound.
//
// Design: one thread per output pixel. The block stages both weight
// matrices and the biases in shared memory as float32 (~67 KB at C = 32,
// dynamic shared memory); every thread of a warp reads the same weight
// word, a broadcast. Phase A keeps the 27 offset/mask sums in registers;
// phase B gathers the four corners of each tap directly (no TPU-style
// row windows or one-hot matmuls, so no lane truncation) and accumulates
// C_out float32 sums in registers. Gathers from neighbouring threads hit
// neighbouring addresses of each channel plane, which L1/L2 serve.
// Moving the contraction onto wgmma is left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 9;
constexpr int kOffCh = 27;
constexpr int kThreads = 256;

template <int C, int COUT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kTaps * C * kOffCh + kTaps * C * COUT + kOffCh + COUT);
}

template <int C, int COUT>
__global__ void __launch_bounds__(kThreads) dcn_fused_kernel(
    const __nv_bfloat16* __restrict__ x,  // [B, C, H, W]
    const float* __restrict__ woff,       // [9*C, 27], row = tap*C + c
    const float* __restrict__ boff,       // [27]
    const float* __restrict__ w,          // [9*C, COUT], row = tap*C + c
    const float* __restrict__ bias,       // [COUT]
    __nv_bfloat16* __restrict__ out,      // [B, COUT, H, W]
    int B, int H, int W) {
  extern __shared__ float smem[];
  float* s_woff = smem;
  float* s_w = s_woff + kTaps * C * kOffCh;
  float* s_boff = s_w + kTaps * C * COUT;
  float* s_bias = s_boff + kOffCh;
  for (int i = threadIdx.x; i < kTaps * C * kOffCh; i += blockDim.x) s_woff[i] = woff[i];
  for (int i = threadIdx.x; i < kTaps * C * COUT; i += blockDim.x) s_w[i] = w[i];
  if (threadIdx.x < kOffCh) s_boff[threadIdx.x] = boff[threadIdx.x];
  if (threadIdx.x < COUT) s_bias[threadIdx.x] = bias[threadIdx.x];
  __syncthreads();

  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)B * HW) return;
  const int b = (int)(p / HW);
  const long long pix = p - (long long)b * HW;
  const int oy = (int)(pix / W);
  const int ox = (int)(pix - (long long)oy * W);
  const __nv_bfloat16* xb = x + (long long)b * C * HW;

  // Phase A: the 27-channel offset/mask conv, zero padding.
  float off[kOffCh];
#pragma unroll
  for (int j = 0; j < kOffCh; ++j) off[j] = s_boff[j];
  for (int t = 0; t < kTaps; ++t) {
    const int iy = oy + t / 3 - 1;
    const int ix = ox + t % 3 - 1;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
    const __nv_bfloat16* xp = xb + (long long)iy * W + ix;
    const float* wr = s_woff + t * C * kOffCh;
    for (int c = 0; c < C; ++c) {
      const float v = __bfloat162float(xp[c * HW]);
#pragma unroll
      for (int j = 0; j < kOffCh; ++j) off[j] = fmaf(v, wr[c * kOffCh + j], off[j]);
    }
  }

  // Phase B: deformable bilinear sampling, masked, contracted with w.
  float acc[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) acc[o] = 0.f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float py = (float)(oy + t / 3 - 1) + off[2 * t];
    const float px = (float)(ox + t % 3 - 1) + off[2 * t + 1];
    const float m = 1.f / (1.f + expf(-off[2 * kTaps + t]));
    // Clamp before the int cast; anything beyond [-2, size+1] samples zero.
    const float y0f = fminf(fmaxf(floorf(py), -2.f), (float)H + 1.f);
    const float x0f = fminf(fmaxf(floorf(px), -2.f), (float)W + 1.f);
    const float wy = py - floorf(py);
    const float wx = px - floorf(px);
    const int y0 = (int)y0f, x0 = (int)x0f, y1 = y0 + 1, x1 = x0 + 1;
    const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
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
      const __nv_bfloat16* xc = xb + c * HW;
      const float s = w00 * __bfloat162float(xc[i00]) + w01 * __bfloat162float(xc[i01]) +
                      w10 * __bfloat162float(xc[i10]) + w11 * __bfloat162float(xc[i11]);
#pragma unroll
      for (int o = 0; o < COUT; ++o) acc[o] = fmaf(s, wr[c * COUT + o], acc[o]);
    }
  }

  __nv_bfloat16* ob = out + (long long)b * COUT * HW + pix;
#pragma unroll
  for (int o = 0; o < COUT; ++o) ob[o * HW] = __float2bfloat16(acc[o] + s_bias[o]);
}

template <int C, int COUT>
cudaError_t launch(const void* x, const void* woff, const void* boff, const void* w,
                   const void* bias, void* out, int B, int H, int W, cudaStream_t stream) {
  const size_t smem = smem_bytes<C, COUT>();
  cudaError_t err = cudaFuncSetAttribute(
      dcn_fused_kernel<C, COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n = (long long)B * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  dcn_fused_kernel<C, COUT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(woff),
      static_cast<const float*>(boff), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B, H, W);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_cout(int cout, const void* x, const void* woff, const void* boff,
                          const void* w, const void* bias, void* out, int B, int H, int W,
                          cudaStream_t s) {
  switch (cout) {
    case 8: return launch<C, 8>(x, woff, boff, w, bias, out, B, H, W, s);
    case 16: return launch<C, 16>(x, woff, boff, w, bias, out, B, H, W, s);
    case 32: return launch<C, 32>(x, woff, boff, w, bias, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code: 0 on success, else the launch's error.
extern "C" int dcn_fused_forward(const void* x, const void* woff, const void* boff,
                                 const void* w, const void* bias, void* out, int B, int C,
                                 int COUT, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return (int)dispatch_cout<8>(COUT, x, woff, boff, w, bias, out, B, H, W, s);
    case 16: return (int)dispatch_cout<16>(COUT, x, woff, boff, w, bias, out, B, H, W, s);
    case 32: return (int)dispatch_cout<32>(COUT, x, woff, boff, w, bias, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dcn_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
