// Depth-map fusion's disparity-consistency test, one reference view per
// launch: the role of the reference's CUDA fusibile (reference gipuma.py),
// as native/fuser/fuser.cpp computes it on the CPU (:296-346).
//
// Replaces no TPU kernel (no pl.pallas_call computes it): it takes the place
// of the C++ binary's OpenMP loop over reference pixels, so that
// `--filter_method native` runs on the card. For every reference pixel
// (y, x) with depth d, min_depth < d < max_depth and d > 0 (a NaN depth is
// rejected: the binary's own test lets it through to an out-of-bounds read):
//   X = R^T (d K^-1 [x y 1] - t)                       (fuser.cpp:155-164)
//   for each source s in order: project X (rejected where z <= 1e-6,
//     :166-178), sample its depth bilinearly (0 outside the image, the last
//     column and row clamped, :180-187; rejected where <= 0, :318), and call
//     it consistent where |fb/z - fb/dsv| < disp_threshold, fb = the
//     source's fx times the distance between the camera centres (:191-194,
//     :320); a consistent source adds its own unprojected surface point.
//   count = 1 + #consistent; point = (X + sum of those points) / count.
// Rejected pixels get count 0 and point 0. The wrapper keeps the pixels with
// count >= num_consistent.
//
// Every product, sum and quotient is rounded on its own (__fmul_rn and the
// rest, which nvcc does not contract into fused multiply-adds), in the
// binary's expression order: the plain version (ops/native_fuse.py) rounds
// the same way, so the two agree bit for bit. The binary itself is built
// with contraction (g++ -O3 -march=native), so it may differ from both by
// an ulp.
//
// What bounds it on an H100: per reference pixel it reads one depth and
// writes a count and a point (20 bytes), and per source four taps (16
// bytes) and ~50 flops in float32: bound by the bytes (the taps, served
// mostly from L2: a source map of 1152x864 is 4 MB). Design: one thread per
// reference pixel, 256 to a block, the sources walked in a loop; the
// cameras (30 floats each) and the per-source fb stay in global memory,
// read through the cache by every thread alike. A simple kernel: making it
// fast is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Per view, float32: R (9, row-major), t (3), K (9), K^-1 (9).
constexpr int kCam = 30;
constexpr int kT = 9, kK = 12, kKinv = 21;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }

struct Vec3 {
  float x, y, z;
};

// X_cam = depth * K^-1 [u v 1]; X_world = R^T (X_cam - t)  (fuser.cpp:155-164)
__device__ __forceinline__ Vec3 unproject(const float* cam, float u, float v, float depth) {
  const float* R = cam;
  const float* t = cam + kT;
  const float* Ki = cam + kKinv;
  const float xc = mul(depth, add(add(mul(Ki[0], u), mul(Ki[1], v)), Ki[2]));
  const float yc = mul(depth, add(add(mul(Ki[3], u), mul(Ki[4], v)), Ki[5]));
  const float zc = mul(depth, add(add(mul(Ki[6], u), mul(Ki[7], v)), Ki[8]));
  const float dx = sub(xc, t[0]), dy = sub(yc, t[1]), dz = sub(zc, t[2]);
  return {add(add(mul(R[0], dx), mul(R[3], dy)), mul(R[6], dz)),
          add(add(mul(R[1], dx), mul(R[4], dy)), mul(R[7], dz)),
          add(add(mul(R[2], dx), mul(R[5], dy)), mul(R[8], dz))};
}

// (fuser.cpp:166-178); false where the point is not in front of the camera.
__device__ __forceinline__ bool project(const float* cam, Vec3 X, float* u, float* v, float* z) {
  const float* R = cam;
  const float* t = cam + kT;
  const float* K = cam + kK;
  const float xc = add(add(add(mul(R[0], X.x), mul(R[1], X.y)), mul(R[2], X.z)), t[0]);
  const float yc = add(add(add(mul(R[3], X.x), mul(R[4], X.y)), mul(R[5], X.z)), t[1]);
  const float zc = add(add(add(mul(R[6], X.x), mul(R[7], X.y)), mul(R[8], X.z)), t[2]);
  if (zc <= 1e-6f) return false;
  const float uu = add(add(mul(K[0], xc), mul(K[1], yc)), mul(K[2], zc));
  const float vv = add(add(mul(K[3], xc), mul(K[4], yc)), mul(K[5], zc));
  *u = quot(uu, zc);
  *v = quot(vv, zc);
  *z = zc;
  return true;
}

// (fuser.cpp:180-187): 0 outside [0, w-1] x [0, h-1] (a NaN coordinate
// included), the +1 taps clamped to the last column and row.
__device__ __forceinline__ float sample_bilinear(const float* img, int h, int w, float x, float y) {
  if (!(x >= 0.f && y >= 0.f && x <= static_cast<float>(w - 1) && y <= static_cast<float>(h - 1)))
    return 0.f;
  const int x0 = static_cast<int>(x), y0 = static_cast<int>(y);
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  const float wx = sub(x, static_cast<float>(x0)), wy = sub(y, static_cast<float>(y0));
  const float ax = sub(1.f, wx), ay = sub(1.f, wy);
  const int64_t r0 = static_cast<int64_t>(y0) * w, r1 = static_cast<int64_t>(y1) * w;
  return add(add(add(mul(mul(__ldg(img + r0 + x0), ax), ay), mul(mul(__ldg(img + r0 + x1), wx), ay)),
                 mul(mul(__ldg(img + r1 + x0), ax), wy)),
             mul(mul(__ldg(img + r1 + x1), wx), wy));
}

__global__ void __launch_bounds__(kThreads)
    native_fuse_kernel(const float* __restrict__ depths, const int64_t* __restrict__ offsets,
                       const int* __restrict__ sizes, const float* __restrict__ cams, int ref, int H,
                       int W, const int* __restrict__ srcs, const float* __restrict__ fbs, int S,
                       float min_depth, float max_depth, float disp_threshold, int* __restrict__ count,
                       float* __restrict__ xyz) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= H * W) return;
  const float d = __ldg(depths + offsets[ref] + p);
  float* out = xyz + 3 * static_cast<int64_t>(p);
  if (!(d > min_depth && d < max_depth && d > 0.f)) {
    count[p] = 0;
    out[0] = out[1] = out[2] = 0.f;
    return;
  }
  const int y = p / W, x = p - y * W;
  const Vec3 X = unproject(cams + kCam * ref, static_cast<float>(x), static_cast<float>(y), d);
  Vec3 acc = X;
  int n = 1;
  for (int s = 0; s < S; ++s) {
    const int sv = srcs[s];
    const float* cam = cams + kCam * sv;
    float u, v, z;
    if (!project(cam, X, &u, &v, &z)) continue;
    const float dsv = sample_bilinear(depths + offsets[sv], sizes[2 * sv], sizes[2 * sv + 1], u, v);
    if (dsv <= 0.f) continue;
    const float fb = fbs[s];
    if (fabsf(sub(quot(fb, z), quot(fb, dsv))) < disp_threshold) {
      const Vec3 Xs = unproject(cam, u, v, dsv);
      acc = {add(acc.x, Xs.x), add(acc.y, Xs.y), add(acc.z, Xs.z)};
      ++n;
    }
  }
  const float fn = static_cast<float>(n);
  count[p] = n;
  out[0] = quot(acc.x, fn);
  out[1] = quot(acc.y, fn);
  out[2] = quot(acc.z, fn);
}

}  // namespace

// One reference view. depths: every loaded view's float32 depth map,
// row-major, one after another; offsets int64 [V] (view v's first element);
// sizes int32 [V, 2] (h, w); cams float32 [V, 30]; srcs int32 [S] (loaded
// views), fbs float32 [S]; count int32 [H, W], xyz float32 [H, W, 3] with
// (H, W) the reference's size. Returns a cudaError_t code: 0 on success,
// else the launch's error.
extern "C" int native_fuse_forward(const void* depths, const void* offsets, const void* sizes,
                                   const void* cams, int ref, int H, int W, const void* srcs,
                                   const void* fbs, int S, float min_depth, float max_depth,
                                   float disp_threshold, void* count, void* xyz, void* stream) {
  const int n = H * W;
  if (n == 0) return 0;
  native_fuse_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depths), static_cast<const int64_t*>(offsets),
      static_cast<const int*>(sizes), static_cast<const float*>(cams), ref, H, W,
      static_cast<const int*>(srcs), static_cast<const float*>(fbs), S, min_depth, max_depth,
      disp_threshold, static_cast<int*>(count), static_cast<float*>(xyz));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* native_fuse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
