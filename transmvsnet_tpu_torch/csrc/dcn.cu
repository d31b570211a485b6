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
// What bounds it on an H100. Per pixel it reads 27 float32 offset/mask
// values and C activations, writes C_out, and does 9 C C_out multiply-adds
// plus ~4 per (tap, channel) for the bilinear sample. At the float32
// inference shapes that is ~6.6 GB (~2.0 ms at 3.35 TB/s) against the
// contraction in 3xTF32 (~1.7 ms at 495 TFLOP/s) and the sampling (~0.7 ms at
// 67 TFLOP/s float32): bound by the bytes. What held the first design (one
// thread per pixel) 5x above the operations bound was the contraction on the
// float32 CUDA cores, every weight read from shared memory per multiply-add,
// and the gathers from C channel planes H*W apart.
//
// Design: K1's tiled body (dcn_fwd.cuh, read its note) without its offset
// conv. The tile's 27 offset/mask planes are copied with cp.async during
// the tile before (two buffers), the box the corners span is staged
// channels-innermost, and the contraction runs on the tensor cores with
// split operands: float32 in 3xTF32 (K3's bit-mask split; one TF32 product
// keeps ~2^-11 and misses the 1e-4 gate), bf16 in 3xBF16 (one bf16 product,
// the TPU kernel's rounding, misses the 2^-7 |p| + 1e-3 max|p| gate; three
// meet it: tests/test_torch_dcn_split.py). The weights are split once per
// block (float32: kept whole and split in registers). Shared memory per
// block at C = C_out = 32: weights 36,864 bytes, offsets 2 x 33,280, staged
// cells the rest (894 float32 cells, 1,609 bf16). One block of 16 warps per
// SM.

#include "dcn_fwd.cuh"

// x and out are bf16 when bf16 != 0, else float32. Returns a cudaError_t
// code: 0 on success, else the launch's error.
extern "C" int dcn_forward(const void* x, const void* dy, const void* dx, const void* mask,
                           const void* w, const void* bias, void* out, int N, int C, int COUT,
                           int H, int W, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dcn_fwd::dispatch<__nv_bfloat16, false>(C, COUT, x, nullptr, nullptr, dy, dx, mask, w,
                                                        bias, out, N, H, W, s);
  return (int)dcn_fwd::dispatch<float, false>(C, COUT, x, nullptr, nullptr, dy, dx, mask, w, bias, out,
                                              N, H, W, s);
}

extern "C" const char* dcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
