// Fused DCNv2 forward: 3x3 offset/mask conv + deformable 3x3 conv, bf16 in/out.
//
// Replaces transmvsnet_tpu/ops/pallas/dcn_onehot.py::deform_conv2d_onehot_fused
// (the TPU kernel _kernel_fused). Same function: for every output pixel,
//   off[27]  = conv3x3(x, k_off) + b_off          (zero padding)
//   dy_k = off[2k], dx_k = off[2k+1], m_k = sigmoid(off[18+k])
//   out[o]   = bias[o] + sum_k sum_c m_k * bilinear(x[c], y+k/3-1+dy_k, x+k%3-1+dx_k) * w[k, c, o]
// with per-corner zeros padding. The offsets never reach device memory.
//
// What bounds it on an H100. Per pixel it reads C bf16 values and writes
// C_out, and does 9 C (27 + C_out) multiply-adds: at C = C_out = 32, ~17k
// against 128 bytes, so by the roofline (989 TFLOP/s bf16, 3.35 TB/s) the
// bytes and the arithmetic weigh about alike. What held the first design
// (one thread per pixel) some 70x above that bound was all of the arithmetic
// on the float32 CUDA cores, every weight read from shared memory per
// multiply-add, and each x value fetched 9 times by the offset conv and up to
// 36 times by the sampler from C channel planes H*W apart.
//
// Design: the tiled body of dcn_fwd.cuh (read its note), with the offset conv
// as its first phase. x around the 8 x 32 tile is copied with cp.async during
// the tile before; the 27-channel conv is an implicit GEMM on the tensor
// cores, x (exact in bf16) times the conv weights split into bf16 head and
// tail, two products and float32 sums: the offsets come out exact to ~2^-17,
// as the float32 conv that the backward (ops/vjp.py) recomputes for K3, so
// floors agree between the two. The offsets and masks stay in shared memory;
// the box their corners span is staged channels-innermost; the contraction
// runs in 3xBF16 (samples and weights each split into head and tail, three
// products): one bf16 product, the TPU kernel's rounding, misses this
// kernel's gate (2^-7 |p| + 1e-3 max|p| against the float32 plain
// version), three products meet it (tests/test_torch_dcn_split.py). Both
// weight matrices are split once per block. Shared memory per block: the two
// split weight matrices (36,864 bytes each at C = C_out = 32), offsets
// (33,280), the planar x copy (25,600), and about 99.6 KB of staged cells
// (1,244 at C = 32). One block of 16 warps per SM.

#include "dcn_fwd.cuh"

// Returns a cudaError_t code: 0 on success, else the launch's error.
extern "C" int dcn_fused_forward(const void* x, const void* woff, const void* boff,
                                 const void* w, const void* bias, void* out, int B, int C,
                                 int COUT, int H, int W, void* stream) {
  return (int)dcn_fwd::dispatch<__nv_bfloat16, true>(C, COUT, x, woff, boff, nullptr, nullptr, nullptr,
                                                     w, bias, out, B, H, W,
                                                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* dcn_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
