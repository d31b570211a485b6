"""Differentiable calls of the DCN and the warp-correlation.

Each is a ``torch.autograd.Function`` whose forward is a forward kernel
(K1 ``dcn_fused``, K5 ``dcn.deform_conv2d``, K2/K6 ``warp_correlate``, K7
``warp_correlate_wsum``) and whose backward is a backward kernel (K3
``dcn_bwd``, K4 ``warp_correlate_bwd``, each in the forward's activation
type; K8 ``warp_correlate_wsum_bwd``). A CPU tensor takes each kernel's
plain version through the same Function, so the glue below runs on the
CPU too. Ported from ``transmvsnet_tpu/ops/pallas/vjp.py``
(``deform_conv2d_fused_with_vjp``, ``deform_conv2d_with_vjp``,
``warp_correlate_with_vjp``, ``warp_correlate_wsum_with_vjp``).

- Fused DCN (bf16 activations; K1 with K3): the backward recomputes the
  27-channel offset/mask conv in float32 (the arithmetic of K1's own
  offset conv; TF32 is switched off around it whatever the global
  setting, or floors near integers would flip between forward and
  backward), splits the interleaved channels (dy_k = 2k, dx_k = 2k + 1,
  mask_k = sigmoid(18 + k)), runs K3, re-interleaves (ddy, ddx), pushes
  d(mask) through the sigmoid, takes the conv's VJP for dx, d(k_off) and
  d(b_off), and adds the two dx paths. d(bias) is the sum of the
  cotangent.
- DCN with given offsets and mask (the float32 path; K5 with K3): the
  forward saves the offsets and mask it was given, so nothing is
  recomputed; the backward returns K3's gradients for x, the offsets,
  the mask and the weight, and the sum of the cotangent for the bias.
  Autograd carries the offset and mask gradients on through the caller's
  offset conv.
- Warp-correlation: gradients flow to the source and reference features
  only; projections and depth hypotheses get none (the reference builds
  the sample grid without a gradient).
- The view-weighted warp-correlation sum (bf16 features; K7 with K8):
  as the warp-correlation, plus the view weights' gradient, which K8
  computes beside dsrc and dref only when the weights need one (the model
  passes detached weights, so its steps take K8's instantiation without
  it).
"""

from __future__ import annotations

import torch

from transmvsnet_tpu_torch.ops.cuda import dcn
from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd
from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused
from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate, warp_correlate_wsum
from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
    warp_correlate_bwd,
    warp_correlate_wsum_bwd,
)
from transmvsnet_tpu_torch.ops.dcn import offset_conv


def _offset_conv_f32(x, k_off, b_off):
    """``offset_conv`` in full float32: cuDNN's TF32 off for this call only."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return offset_conv(x, k_off, b_off)


class _DCNFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k_off, b_off, weight, bias):
        ctx.save_for_backward(x, k_off, b_off, weight)
        ctx.bias_dtype = bias.dtype
        return dcn_fused(x, k_off, b_off, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, k_off, b_off, weight = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_() for t in (x, k_off, b_off)]
            off = _offset_conv_f32(*leaves)
        K = off.shape[1] // 3
        o = off.detach()
        mask = torch.sigmoid(o[:, 2 * K :])
        dx_s, ddy, ddx, dm, dw = dcn_bwd(x, o[:, 0 : 2 * K : 2], o[:, 1 : 2 * K : 2], mask, weight, g)
        dcat = torch.stack([ddy, ddx], dim=2).reshape(ddy.shape[0], 2 * K, *ddy.shape[2:])
        doff = torch.cat([dcat, dm * mask * (1.0 - mask)], dim=1)
        dx_c, dk_off, db_off = torch.autograd.grad(off, leaves, doff)
        dbias = g.float().sum(dim=(0, 2, 3))
        return (
            (dx_s + dx_c).to(x.dtype),
            dk_off.to(k_off.dtype),
            db_off.to(b_off.dtype),
            dw.to(weight.dtype),
            dbias.to(ctx.bias_dtype),
        )


class _DCN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset_y, offset_x, mask, weight, bias):
        ctx.save_for_backward(x, offset_y, offset_x, mask, weight)
        ctx.bias_dtype = bias.dtype
        return dcn.deform_conv2d(x, offset_y, offset_x, mask, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, offset_y, offset_x, mask, weight = ctx.saved_tensors
        dx, ddy, ddx, dm, dw = dcn_bwd(x, offset_y, offset_x, mask, weight, g)
        dbias = g.float().sum(dim=(0, 2, 3))
        return (
            dx.to(x.dtype),
            ddy.to(offset_y.dtype),
            ddx.to(offset_x.dtype),
            dm.to(mask.dtype),
            dw.to(weight.dtype),
            dbias.to(ctx.bias_dtype),
        )


class _WarpCorrelate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, ref, src_proj, ref_proj, depth):
        ctx.save_for_backward(src, ref, src_proj, ref_proj, depth)
        return warp_correlate(src, ref, src_proj, ref_proj, depth)

    @staticmethod
    def backward(ctx, g):
        src, ref, src_proj, ref_proj, depth = ctx.saved_tensors
        dsrc, dref = warp_correlate_bwd(src, ref, src_proj, ref_proj, depth, g)
        return dsrc.to(src.dtype), dref.to(ref.dtype), None, None, None


class _WarpCorrelateWsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, ref, src_proj, ref_proj, depth, vw):
        ctx.save_for_backward(src, ref, src_proj, ref_proj, depth, vw)
        return warp_correlate_wsum(src, ref, src_proj, ref_proj, depth, vw)

    @staticmethod
    def backward(ctx, g):
        src, ref, src_proj, ref_proj, depth, vw = ctx.saved_tensors
        need_dvw = ctx.needs_input_grad[5]
        dsrc, dref, dvw = warp_correlate_wsum_bwd(src, ref, src_proj, ref_proj, depth, vw, g,
                                                  need_dvw=need_dvw)
        dvw = dvw.to(vw.dtype) if need_dvw else None
        return dsrc.to(src.dtype), dref.to(ref.dtype), None, None, None, dvw


def dcn_fused_with_vjp(
    x: torch.Tensor,
    k_off: torch.Tensor,
    b_off: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """``dcn_fused`` with its gradient: K1 forward, K3 backward on CUDA.
    x [B, C, H, W]; k_off [27, C, 3, 3]; b_off [27]; weight [9, C, C_out]
    tap-major; bias [C_out]. Returns [B, C_out, H, W] in x's dtype."""
    return _DCNFused.apply(x, k_off, b_off, weight, bias)


def dcn_with_vjp(
    x: torch.Tensor,
    offset_y: torch.Tensor,
    offset_x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """``ops.cuda.dcn.deform_conv2d`` with its gradient: K5 forward, K3
    backward on CUDA, in x's dtype (float32 or bf16). x [B, C, H, W];
    offsets and mask [B, 9, H, W]; weight [9, C, C_out] tap-major; bias
    [C_out]. Returns [B, C_out, H, W] in x's dtype."""
    return _DCN.apply(x, offset_y, offset_x, mask, weight, bias)


def warp_correlate_with_vjp(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
) -> torch.Tensor:
    """``warp_correlate`` with its gradient on CUDA: K2 forward (K6 for
    float32 features), K4 backward in the features' dtype. src
    [B, S, C, H, W]; ref [B, C, H, W]; fused projections [B, S, 4, 4] and
    [B, 4, 4]; depth [B, D, H, W]. Returns [B, S, D, H, W] float32."""
    return _WarpCorrelate.apply(src, ref, src_proj, ref_proj, depth)


def warp_correlate_wsum_with_vjp(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
    vw: torch.Tensor,
) -> torch.Tensor:
    """``warp_correlate_wsum`` with its gradient on CUDA: K7 forward, K8
    backward (bf16 features). src [B, S, C, H, W]; ref [B, C, H, W]; fused
    projections [B, S, 4, 4] and [B, 4, 4]; depth [B, D, H, W]; view
    weights vw [B, S, H, W] float32. Returns sum_s vw_s * sim_s as
    [B, D, H, W] float32 (the caller divides by the weights' sum)."""
    return _WarpCorrelateWsum.apply(src, ref, src_proj, ref_proj, depth, vw)
