"""The split arithmetic of the DCN forward kernels (``csrc/dcn_fwd.cuh``),
emulated in torch on the CPU and held to the float32 plain versions.

The kernels run the contraction [pixels x 9C] . [9C x C_out] on the tensor
cores with split operands: bf16 activations in 3xBF16 (the float32 samples
and the weights each split into a bf16 head and tail; s_hi w_hi + s_hi w_lo
+ s_lo w_hi), float32 activations in 3xTF32 (heads by the bit mask that
clears the low 13 bits; the tensor core cuts the tails to TF32 in turn). K1's
offset conv multiplies x, exact in bf16, by the conv weights split into bf16
head and tail: two products. Products of bf16 or TF32 values are exact in
float32; the emulation sums them in float64, which leaves only the split's
own error. Each is held to ``chip_smoke.py``'s gate for the kernel (bf16:
|d| <= 2^-7 |p| + 1e-3 max|p| after both round to bf16; float32: 1e-4 and
1e-4), and the offsets to 1e-5 of the largest offset.
"""

import numpy as np
import pytest
import torch

from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d_plain
from transmvsnet_tpu_torch.ops.dcn import offset_conv, split_offsets
from transmvsnet_tpu_torch.ops.sampling import bilinear_gather


def bf16_split(v: torch.Tensor):
    hi = v.to(torch.bfloat16).double()
    return hi, (v.double() - hi).float().to(torch.bfloat16).double()


def tf32_head(v: torch.Tensor) -> torch.Tensor:
    return (v.float().view(torch.int32) & -8192).view(torch.float32).double()  # low 13 bits cleared


def tf32_split(v: torch.Tensor):
    hi = tf32_head(v)
    return hi, tf32_head((v.double() - hi).float())


def samples(x, dy, dx, mask):
    """The float32 samples times the mask, per tap: [9][B, C, H*W]."""
    B, C, H, W = x.shape
    gy = torch.arange(H, dtype=torch.float32)[:, None] - 1
    gx = torch.arange(W, dtype=torch.float32)[None, :] - 1
    out = []
    for k in range(9):
        py = (gy + k // 3 + dy[:, k]).reshape(B, -1)
        px = (gx + k % 3 + dx[:, k]).reshape(B, -1)
        out.append(bilinear_gather(x.float(), px, py) * mask[:, k].reshape(B, 1, -1))
    return out


def contract(s, weight, bias, products, split):
    """sum_k S_k . W_k from the split operands, in float64, plus the bias."""
    out = 0.0
    for k, sk in enumerate(s):
        s_hi, s_lo = split(sk)
        w_hi, w_lo = split(weight[k])
        terms = {"s_hi w_hi": (s_hi, w_hi), "s_hi w_lo": (s_hi, w_lo), "s_lo w_hi": (s_lo, w_hi)}
        for name in products:
            a, b = terms[name]
            out = out + torch.einsum("bcm,co->bom", a, b)
    return out + bias.double()[None, :, None]


def inputs(seed, C, C_out, H=11, W=19, B=2):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32))
    k_off = torch.from_numpy((rng.randn(27, C, 3, 3) * 0.12).astype(np.float32))
    b_off = torch.from_numpy((rng.randn(27) * 0.5).astype(np.float32))
    weight = torch.from_numpy((rng.randn(9, C, C_out) * 0.1).astype(np.float32))
    bias = torch.from_numpy((rng.randn(C_out) * 0.1).astype(np.float32))
    return x, k_off, b_off, weight, bias


def outside(got, want, rtol, atol_scale):
    tol = rtol * want.abs() + atol_scale * want.abs().max()
    return int(((got - want).abs() > tol).sum())


ALL3 = ("s_lo w_hi", "s_hi w_lo", "s_hi w_hi")


@pytest.mark.parametrize("C,C_out", [(32, 32), (32, 8), (16, 16), (8, 32)])
def test_3xbf16_contraction_within_the_bf16_gate(C, C_out):
    x, k_off, b_off, weight, bias = inputs(C * 10 + C_out, C, C_out)
    xb = x.to(torch.bfloat16)  # the activations are bf16: corners exact
    dy, dx, mask = split_offsets(offset_conv(xb.float(), k_off, b_off))
    want = deform_conv2d_plain(xb, dy, dx, mask, weight, bias).float()
    s = samples(xb, dy, dx, mask)
    B, _, H, W = x.shape
    full = contract(s, weight, bias, ALL3, bf16_split).reshape(B, C_out, H, W)
    got = full.float().to(torch.bfloat16).float()
    assert outside(got, want, 2.0**-7, 1e-3) == 0
    # The split is what keeps it there: one bf16 product (the TPU kernel's
    # rounding) is ~2^-8 off before the final rounding, three products
    # about float32's rounding.
    exact = contract(s, weight, bias, (), bf16_split)  # bias only
    exact = exact + sum(torch.einsum("bcm,co->bom", sk.double(), weight[k].double()) for k, sk in enumerate(s))
    one = contract(s, weight, bias, ("s_hi w_hi",), bf16_split)
    scale = exact.abs().max()
    assert (full.reshape_as(exact) - exact).abs().max() < 1e-5 * scale
    assert (one - exact).abs().max() > 1e-4 * scale


@pytest.mark.parametrize("C,C_out", [(32, 32), (32, 16), (16, 8), (8, 8)])
def test_3xtf32_contraction_within_the_float32_gate(C, C_out):
    x, k_off, b_off, weight, bias = inputs(C * 10 + C_out + 1, C, C_out)
    rng = np.random.RandomState(C + C_out)
    B, _, H, W = x.shape
    dy = torch.from_numpy((rng.randn(B, 9, H, W) * 1.5).astype(np.float32))
    dx = torch.from_numpy((rng.randn(B, 9, H, W) * 1.5).astype(np.float32))
    mask = torch.from_numpy(rng.rand(B, 9, H, W).astype(np.float32))
    want = deform_conv2d_plain(x, dy, dx, mask, weight, bias)
    s = samples(x, dy, dx, mask)
    got = contract(s, weight, bias, ALL3, tf32_split).reshape(B, C_out, H, W).float()
    assert outside(got, want, 1e-4, 1e-4) == 0
    one = contract(s, weight, bias, ("s_hi w_hi",), tf32_split).reshape(B, C_out, H, W).float()
    assert outside(one, want, 1e-4, 1e-4) > 0  # a single TF32 product misses the gate


@pytest.mark.parametrize("C", [32, 16, 8])
def test_two_product_offset_conv_matches_float32(C):
    """x (exact in bf16) times the conv weights' bf16 head and tail, summed
    exactly, against the float32 conv that K3's backward recomputes."""
    x, k_off, b_off, _, _ = inputs(C, C, 8, H=13, W=21)
    xb = x.to(torch.bfloat16).float()
    want = offset_conv(xb, k_off, b_off)  # float32, as ops/vjp.py recomputes it
    k_hi, k_lo = bf16_split(k_off)
    got = (torch.nn.functional.conv2d(xb.double(), k_hi, padding=1)
           + torch.nn.functional.conv2d(xb.double(), k_lo, padding=1) + b_off.double()[None, :, None, None])
    err = (got.float() - want).abs().max()
    assert err <= 1e-5 * want.abs().max(), (err, want.abs().max())
    one = torch.nn.functional.conv2d(xb.double(), k_hi, padding=1) + b_off.double()[None, :, None, None]
    assert (one.float() - want).abs().max() > 1e-4 * want.abs().max()  # the tail is needed
