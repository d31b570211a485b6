// Plane-sweep warp-correlation forward: bf16 features in, float32 similarity out.
//
// Replaces transmvsnet_tpu/ops/pallas/warp_onehot.py::warp_correlate_onehot
// (the TPU kernel _kernel / _correlate_strip). Same function: for source view
// n = b*S + s, hypothesis d and reference pixel (y, x),
//   [X Y Z] = rel[n] @ [x*z, y*z, z, 1],  z = depth[b, d, y, x]
//   invalid if Z < 1e-6 (sampled as zero), else (px, py) = (X/Z, Y/Z)
//   out[n, d, y, x] = mean_c bilinear(src[n, c], px, py) * ref[b, c, y, x]
// with per-corner zeros padding; rel = (P_src @ P_ref^-1)[:3] is computed by
// the wrapper in float32.
//
// What bounds it on an H100: per (view, hypothesis, pixel) it does ~10*C
// flops and moves 8 bytes of unique traffic (a depth read shared by the S
// views, one float32 write), so by the roofline it is bound by bytes. In
// practice the 4*C scattered 2-byte gathers per output dominate: they are
// served by L1/L2 (a source plane of a stage fits in the 50 MB L2), so the
// real limit is load-instruction issue and gather latency.
//
// Design: one thread per (view, pixel). It keeps its C reference values and
// the 12 projection entries in registers and loops over the D hypotheses,
// so the reference features are read once and the projected ray
// rel[:, :3] @ [x, y, 1] is formed once. Neighbouring threads project to
// neighbouring source pixels for a smooth depth map, so a warp's gathers
// fall into a few cache lines of each channel plane. No TPU-style row
// windows or one-hot matmuls: the kernel gathers directly and matches the
// plain version at every pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int C>
__global__ void __launch_bounds__(kThreads) warp_correlate_kernel(
    const __nv_bfloat16* __restrict__ src,  // [B*S, C, H, W]
    const __nv_bfloat16* __restrict__ ref,  // [B, C, H, W]
    const float* __restrict__ rel,          // [B*S, 3, 4]
    const float* __restrict__ depth,        // [B, D, H, W]
    float* __restrict__ out,                // [B*S, D, H, W]
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
  const __nv_bfloat16* rb = ref + (long long)b * C * HW + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) refv[c] = __bfloat162float(rb[c * HW]);

  const __nv_bfloat16* sb = src + (long long)n * C * HW;
  const float* db = depth + (long long)b * D * HW + pix;
  float* ob = out + (long long)n * D * HW + pix;
  for (int d = 0; d < D; ++d) {
    const float z = db[d * HW];
    const float X = bx * z + r[3];
    const float Y = by * z + r[7];
    const float Z = bz * z + r[11];
    float acc = 0.f;
    if (Z >= 1e-6f) {
      const float px = X / Z, py = Y / Z;
      // Clamp before the int cast; beyond [-2, size+1] every corner is zero.
      const float x0f = fminf(fmaxf(floorf(px), -2.f), (float)W + 1.f);
      const float y0f = fminf(fmaxf(floorf(py), -2.f), (float)H + 1.f);
      const float wx = px - floorf(px), wy = py - floorf(py);
      const int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
      const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
      const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
      if ((vy0 || vy1) && (vx0 || vx1)) {
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
          const __nv_bfloat16* sc = sb + c * HW;
          const float v = w00 * __bfloat162float(sc[i00]) + w01 * __bfloat162float(sc[i01]) +
                          w10 * __bfloat162float(sc[i10]) + w11 * __bfloat162float(sc[i11]);
          acc = fmaf(v, refv[c], acc);
        }
      }
    }
    ob[d * HW] = acc / (float)C;
  }
}

template <int C>
cudaError_t launch(const void* src, const void* ref, const void* rel, const void* depth,
                   void* out, int N, int S, int D, int H, int W, cudaStream_t stream) {
  const long long n = (long long)N * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  warp_correlate_kernel<C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(ref),
      static_cast<const float*>(rel), static_cast<const float*>(depth),
      static_cast<float*>(out), N, S, D, H, W);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 on success, else the launch's error.
extern "C" int warp_correlate_forward(const void* src, const void* ref, const void* rel,
                                      const void* depth, void* out, int N, int S, int C,
                                      int D, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return (int)launch<8>(src, ref, rel, depth, out, N, S, D, H, W, s);
    case 16: return (int)launch<16>(src, ref, rel, depth, out, N, S, D, H, W, s);
    case 32: return (int)launch<32>(src, ref, rel, depth, out, N, S, D, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* warp_correlate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
