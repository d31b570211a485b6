// DCNv2 backward: gradients of the deformable 3x3 conv for given offsets/mask,
// float32 or bf16 activations (gradients float32 either way).
//
// Replaces transmvsnet_tpu/ops/pallas/dcn_bwd.py::deform_conv2d_bwd (the TPU
// kernel _bwd_kernel; bf16 there). Its float32 instantiation serves the
// float32 path, where the JAX package differentiates dcn_rowsweep.py by
// autodiff of the floor-based XLA sampler (ops/pallas/vjp.py,
// pallas_bwd=None): the same gradient. Same function: for the forward
//   out[o, p] = sum_k sum_c m_k(p) * samp_kc(p) * w[k, c, o]
//   samp_kc(p) = bilinear(x[c], y + k/3 - 1 + dy_k(p), x + k%3 - 1 + dx_k(p))
// (zeros padding per corner) and the cotangent g[o, p], with
//   q_kc(p) = sum_o w[k, c, o] * g[o, p]
// it returns
//   dm_k   = sum_c q_kc * samp_kc
//   ddy_k  = m_k * sum_c q_kc * ((1 - wx) (v10 - v00) + wx (v11 - v01))
//   ddx_k  = m_k * sum_c q_kc * ((1 - wy) (v01 - v00) + wy (v11 - v10))
//   dx[c]  = scatter of q_kc * m_k * w_corner into the four corners
//   dw     = sum_p (m_k * samp_kc)(p) * g[o, p]
// where v_ab is the corner's value, zero off the image. The offset
// gradients follow the floor two-tap rule (v_hi - v_lo at floor(p)), not the
// derivative of the bilinear hat: the offset convs start at zero, every
// coordinate then lies on an integer, and there the hat's derivative would be
// zero and the offsets would never train.
//
// What bounds it on an H100: per pixel it reads 9*4*C gathered values,
// scatters as many float32 atomics into dx, and does 9*C*C_out multiply-adds
// for q plus as many again for dw. By the roofline (each input read once,
// each output written once) it is bound by bytes; in practice by the atomics
// into dx and the float32 multiply-adds on the CUDA cores.
//
// Design: two kernels. dcn_bwd_kernel runs one thread per output pixel, as
// the forward does: it keeps g[:, p] in registers, forms q_kc on the fly from
// w in shared memory (a broadcast: every thread of a warp reads the same
// word), gathers the four corners of each tap directly (no TPU-style row
// windows or one-hot matmuls, so nothing is truncated) and scatters into dx
// with atomicAdd, skipping corners of zero weight (three of four at integer
// coordinates). dcn_bwd_dw_kernel computes dw: each block walks over tiles
// of 32 pixels, stages the tile's masked samples [9*C, 32] and cotangents
// [C_out, 32] in shared memory, accumulates its share of the [9*C, C_out]
// sums in registers over all its tiles, and adds them into dw with one
// atomic per element per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;
constexpr int kTile = 32;           // pixels per tile of the dw kernel
constexpr int kStride = kTile + 1;  // padded tile row: no bank conflicts
constexpr int kDwBlocks = 528;      // 4 blocks per SM on 132 SMs

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// One bilinear sample: corner validity, fractional weights, clamped indices.
struct Sample {
  bool v00, v01, v10, v11;
  float wx, wy;
  long long i00, i01, i10, i11;
};

// Clamped before the int cast, as the forward kernel and the plain sampler
// are: anything beyond [-2, size+1] has no valid corner.
__device__ __forceinline__ Sample sample_at(float py, float px, int H, int W) {
  Sample s;
  const float fy = floorf(py), fx = floorf(px);
  s.wy = py - fy;
  s.wx = px - fx;
  const int y0 = (int)fminf(fmaxf(fy, -2.f), (float)H + 1.f);
  const int x0 = (int)fminf(fmaxf(fx, -2.f), (float)W + 1.f);
  const int y1 = y0 + 1, x1 = x0 + 1;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
  s.v00 = vy0 && vx0;
  s.v01 = vy0 && vx1;
  s.v10 = vy1 && vx0;
  s.v11 = vy1 && vx1;
  const int cy0 = min(max(y0, 0), H - 1), cy1 = min(max(y1, 0), H - 1);
  const int cx0 = min(max(x0, 0), W - 1), cx1 = min(max(x1, 0), W - 1);
  s.i00 = (long long)cy0 * W + cx0;
  s.i01 = (long long)cy0 * W + cx1;
  s.i10 = (long long)cy1 * W + cx0;
  s.i11 = (long long)cy1 * W + cx1;
  return s;
}

template <typename T, int C, int COUT>
__global__ void __launch_bounds__(kThreads) dcn_bwd_kernel(
    const T* __restrict__ x,              // [N, C, H, W]
    const float* __restrict__ dy,         // [N, 9, H, W]
    const float* __restrict__ dx,         // [N, 9, H, W]
    const float* __restrict__ mask,       // [N, 9, H, W]
    const float* __restrict__ w,          // [9*C, COUT], row = tap*C + c
    const float* __restrict__ g,          // [N, COUT, H, W]
    float* __restrict__ dx_s,             // [N, C, H, W], zeroed by the caller
    float* __restrict__ ddy,              // [N, 9, H, W]
    float* __restrict__ ddx,              // [N, 9, H, W]
    float* __restrict__ dm,               // [N, 9, H, W]
    int N, int H, int W) {
  extern __shared__ float s_w[];
  for (int i = threadIdx.x; i < kTaps * C * COUT; i += blockDim.x) s_w[i] = w[i];
  __syncthreads();

  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)N * HW) return;
  const int n = (int)(p / HW);
  const long long pix = p - (long long)n * HW;
  const int oy = (int)(pix / W);
  const int ox = (int)(pix - (long long)oy * W);

  float gv[COUT];
  const float* gb = g + (long long)n * COUT * HW + pix;
#pragma unroll
  for (int o = 0; o < COUT; ++o) gv[o] = gb[o * HW];

  const T* xb = x + (long long)n * C * HW;
  float* dxb = dx_s + (long long)n * C * HW;
  const long long kofs = (long long)n * kTaps * HW + pix;
  for (int k = 0; k < kTaps; ++k) {
    const float py = (float)(oy + k / 3 - 1) + dy[kofs + k * HW];
    const float px = (float)(ox + k % 3 - 1) + dx[kofs + k * HW];
    const float m = mask[kofs + k * HW];
    const Sample s = sample_at(py, px, H, W);
    const float w00 = (1.f - s.wx) * (1.f - s.wy), w01 = s.wx * (1.f - s.wy);
    const float w10 = (1.f - s.wx) * s.wy, w11 = s.wx * s.wy;
    // Scatter weights: zero for a corner off the image or of zero weight.
    const float a00 = s.v00 ? w00 : 0.f, a01 = s.v01 ? w01 : 0.f;
    const float a10 = s.v10 ? w10 : 0.f, a11 = s.v11 ? w11 : 0.f;
    const bool any = s.v00 || s.v01 || s.v10 || s.v11;
    float acc_m = 0.f, acc_y = 0.f, acc_x = 0.f;
    if (any) {
      const float* wr = s_w + k * C * COUT;
      for (int c = 0; c < C; ++c) {
        float q = 0.f;
#pragma unroll
        for (int o = 0; o < COUT; ++o) q = fmaf(wr[c * COUT + o], gv[o], q);
        const T* xc = xb + c * HW;
        const float v00 = s.v00 ? load(xc + s.i00) : 0.f;
        const float v01 = s.v01 ? load(xc + s.i01) : 0.f;
        const float v10 = s.v10 ? load(xc + s.i10) : 0.f;
        const float v11 = s.v11 ? load(xc + s.i11) : 0.f;
        acc_m = fmaf(q, w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11, acc_m);
        acc_y = fmaf(q, (1.f - s.wx) * (v10 - v00) + s.wx * (v11 - v01), acc_y);
        acc_x = fmaf(q, (1.f - s.wy) * (v01 - v00) + s.wy * (v11 - v10), acc_x);
        const float qm = q * m;
        float* dc = dxb + c * HW;
        if (a00 != 0.f) atomicAdd(dc + s.i00, qm * a00);
        if (a01 != 0.f) atomicAdd(dc + s.i01, qm * a01);
        if (a10 != 0.f) atomicAdd(dc + s.i10, qm * a10);
        if (a11 != 0.f) atomicAdd(dc + s.i11, qm * a11);
      }
    }
    dm[kofs + k * HW] = acc_m;
    ddy[kofs + k * HW] = m * acc_y;
    ddx[kofs + k * HW] = m * acc_x;
  }
}

template <int C, int COUT>
constexpr size_t dw_smem_bytes() {
  return sizeof(float) * (kTaps * C + COUT) * kStride;
}

template <typename T, int C, int COUT>
__global__ void __launch_bounds__(kThreads) dcn_bwd_dw_kernel(
    const T* __restrict__ x,              // [N, C, H, W]
    const float* __restrict__ dy,         // [N, 9, H, W]
    const float* __restrict__ dx,         // [N, 9, H, W]
    const float* __restrict__ mask,       // [N, 9, H, W]
    const float* __restrict__ g,          // [N, COUT, H, W]
    float* __restrict__ dw,               // [9*C, COUT], zeroed by the caller
    int N, int H, int W) {
  constexpr int kRows = kTaps * C;
  constexpr int kOut = kRows * COUT;
  constexpr int kPer = (kOut + kThreads - 1) / kThreads;
  static_assert(kThreads % COUT == 0, "a thread keeps one output column");
  extern __shared__ float smem[];
  float* s_cols = smem;                  // [9*C][kStride]: m * samp
  float* s_g = smem + kRows * kStride;   // [COUT][kStride]

  const long long HW = (long long)H * W;
  const long long P = (long long)N * HW;
  const long long tiles = (P + kTile - 1) / kTile;
  const int o = threadIdx.x % COUT;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * kTile;
    for (int i = threadIdx.x; i < COUT * kTile; i += blockDim.x) {
      const int oo = i / kTile, j = i % kTile;
      const long long p = p0 + j;
      float v = 0.f;
      if (p < P) {
        const int n = (int)(p / HW);
        v = g[((long long)n * COUT + oo) * HW + (p - (long long)n * HW)];
      }
      s_g[oo * kStride + j] = v;
    }
    for (int i = threadIdx.x; i < kTaps * kTile; i += blockDim.x) {
      const int k = i / kTile, j = i % kTile;
      const long long p = p0 + j;
      if (p >= P) {
        for (int c = 0; c < C; ++c) s_cols[(k * C + c) * kStride + j] = 0.f;
        continue;
      }
      const int n = (int)(p / HW);
      const long long pix = p - (long long)n * HW;
      const int oy = (int)(pix / W);
      const int ox = (int)(pix - (long long)oy * W);
      const long long at = ((long long)n * kTaps + k) * HW + pix;
      const float m = mask[at];
      const Sample s = sample_at((float)(oy + k / 3 - 1) + dy[at], (float)(ox + k % 3 - 1) + dx[at],
                                 H, W);
      const float a00 = s.v00 ? (1.f - s.wx) * (1.f - s.wy) * m : 0.f;
      const float a01 = s.v01 ? s.wx * (1.f - s.wy) * m : 0.f;
      const float a10 = s.v10 ? (1.f - s.wx) * s.wy * m : 0.f;
      const float a11 = s.v11 ? s.wx * s.wy * m : 0.f;
      const T* xb = x + (long long)n * C * HW;
      for (int c = 0; c < C; ++c) {
        const T* xc = xb + c * HW;
        s_cols[(k * C + c) * kStride + j] = a00 * load(xc + s.i00) + a01 * load(xc + s.i01) +
                                            a10 * load(xc + s.i10) + a11 * load(xc + s.i11);
      }
    }
    __syncthreads();
    float gj[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) gj[j] = s_g[o * kStride + j];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kOut) {
        const float* row = s_cols + (e / COUT) * kStride;
        float sum = acc[i];
#pragma unroll
        for (int j = 0; j < kTile; ++j) sum = fmaf(row[j], gj[j], sum);
        acc[i] = sum;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < kOut) atomicAdd(dw + e, acc[i]);
  }
}

template <typename T, int C, int COUT>
cudaError_t launch(const void* x, const void* dy, const void* dx, const void* mask,
                   const void* w, const void* g, void* dx_s, void* ddy, void* ddx, void* dm,
                   void* dw, int N, int H, int W, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kTaps * C * COUT;
  cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_kernel<T, C, COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const size_t smem_dw = dw_smem_bytes<C, COUT>();
  err = cudaFuncSetAttribute(dcn_bwd_dw_kernel<T, C, COUT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dw);
  if (err != cudaSuccess) return err;
  const long long n = (long long)N * H * W;
  const auto* xp = static_cast<const T*>(x);
  const auto* dyp = static_cast<const float*>(dy);
  const auto* dxp = static_cast<const float*>(dx);
  const auto* mp = static_cast<const float*>(mask);
  const auto* gp = static_cast<const float*>(g);
  dcn_bwd_kernel<T, C, COUT><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, smem, stream>>>(
      xp, dyp, dxp, mp, static_cast<const float*>(w), gp, static_cast<float*>(dx_s),
      static_cast<float*>(ddy), static_cast<float*>(ddx), static_cast<float*>(dm), N, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long tiles = (n + kTile - 1) / kTile;
  const unsigned blocks = (unsigned)(tiles < kDwBlocks ? tiles : kDwBlocks);
  dcn_bwd_dw_kernel<T, C, COUT><<<blocks, kThreads, smem_dw, stream>>>(
      xp, dyp, dxp, mp, gp, static_cast<float*>(dw), N, H, W);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t dispatch_cout(int cout, const void* x, const void* dy, const void* dx,
                          const void* mask, const void* w, const void* g, void* dx_s, void* ddy,
                          void* ddx, void* dm, void* dw, int N, int H, int W, cudaStream_t s) {
  switch (cout) {
    case 8: return launch<T, C, 8>(x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    case 16: return launch<T, C, 16>(x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    case 32: return launch<T, C, 32>(x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int C, int cout, const void* x, const void* dy, const void* dx,
                     const void* mask, const void* w, const void* g, void* dx_s, void* ddy,
                     void* ddx, void* dm, void* dw, int N, int H, int W, cudaStream_t s) {
  switch (C) {
    case 8:
      return dispatch_cout<T, 8>(cout, x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    case 16:
      return dispatch_cout<T, 16>(cout, x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    case 32:
      return dispatch_cout<T, 32>(cout, x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x is bf16 when bf16 != 0, else float32. Returns a cudaError_t code: 0 on
// success, else the first launch error.
extern "C" int dcn_bwd(const void* x, const void* dy, const void* dx, const void* mask,
                       const void* w, const void* g, void* dx_s, void* ddy, void* ddx, void* dm,
                       void* dw, int N, int C, int COUT, int H, int W, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch<__nv_bfloat16>(C, COUT, x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N,
                                        H, W, s);
  return (int)dispatch<float>(C, COUT, x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
}

extern "C" const char* dcn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
