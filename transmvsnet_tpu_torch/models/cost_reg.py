"""Cost-volume regularisation (3-D U-Net) and per-view visibility weights.

``CostRegNet`` is the reference's 3-level 3-D U-Net (reference
models/module.py:425-456): a stride-2 encoder (c -> 2c -> 4c -> 8c), a
transposed-conv decoder with additive skips and a bias-free 3x3x3 conv to
one channel. ``CostRegNetDense`` computes the same function in the same
submodules with the depth axis folded into the channels (the JAX
package's default, ``dense_cost_reg``). ``PixelwiseNet`` is the 1x1x1
visibility head (reference models/TransMVSNet.py:10-30). Volumes are
[B, C, D, H, W].
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from transmvsnet_tpu_torch.models.blocks import Conv3d, ConvBnReLU
from transmvsnet_tpu_torch.parallel.mesh import AXES


class CostRegNet(nn.Module):
    def __init__(self, in_channels: int = 1, base_channels: int = 8):
        super().__init__()
        c = base_channels

        def conv(i, o, stride=1):
            return ConvBnReLU(i, o, 3, stride, 1, ndim=3)

        def deconv(i, o):
            return ConvBnReLU(i, o, 3, 2, 1, ndim=3, transpose=True, output_padding=1)

        self.conv0 = conv(in_channels, c)
        self.conv1 = conv(c, c * 2, 2)
        self.conv2 = conv(c * 2, c * 2)
        self.conv3 = conv(c * 2, c * 4, 2)
        self.conv4 = conv(c * 4, c * 4)
        self.conv5 = conv(c * 4, c * 8, 2)
        self.conv6 = conv(c * 8, c * 8)
        self.conv7 = deconv(c * 8, c * 4)
        self.conv9 = deconv(c * 4, c * 2)
        self.conv11 = deconv(c * 2, c)
        self.prob = Conv3d(c, 1, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C_in, D, H, W] -> [B, 1, D, H, W]."""
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)


@functools.lru_cache(maxsize=64)
def _depth_band(D_in: int, mode: str, device: torch.device) -> torch.Tensor:
    """Depth coupling S[kd, d_in, d_out] of a kernel-3, padding-1 layer:
    1 where depth tap kd joins d_in to d_out, in torch's conventions.

    "same" (stride 1): d_in = d_out + kd - 1; "down" (stride 2): d_in =
    2·d_out + kd - 1; "up" (ConvTranspose3d, stride 2, output padding 1,
    torch's unflipped kernel): d_out = 2·d_in - 1 + kd. Zero padding in
    depth is the band's edges.
    """
    D_out = {"same": D_in, "down": (D_in + 1) // 2, "up": 2 * D_in}[mode]
    stride = 2 if mode == "down" else 1
    S = torch.zeros(3, D_in, D_out)
    for kd in range(3):
        for d_in in range(D_in):
            if mode == "up":
                d_out = 2 * d_in - 1 + kd
            elif (d_in - kd + 1) % stride == 0:
                d_out = (d_in - kd + 1) // stride
            else:
                continue
            if 0 <= d_out < D_out:
                S[kd, d_in, d_out] = 1.0
    return S.to(device)


def _dense_conv(conv: nn.Module, x: torch.Tensor, mode: str) -> torch.Tensor:
    """``conv`` (a bias-free 3x3x3 Conv3d, or the stride-2 ConvTranspose3d
    for "up": CostRegNet's convs all feed a BatchNorm or are bias-free) on
    x [B, D·C_in, H, W], channels ordered d·C + c, as one 2-D conv whose
    block-banded weight is built from the 3-D weight by an einsum with the
    depth band (gradients reach the 3-D weight through it) and cast to the
    activation dtype."""
    w = conv.weight
    c_in = w.shape[1] if mode != "up" else w.shape[0]
    S = _depth_band(x.shape[1] // c_in, mode, x.device).to(w.dtype)
    D_in, D_out = S.shape[1:]
    if mode == "up":  # torch's transposed layout [I, O, kd, kh, kw]
        w2 = torch.einsum("iokhw,kde->dieohw", w, S).reshape(D_in * w.shape[0], D_out * w.shape[1], 3, 3)
    else:  # [O, I, kd, kh, kw]
        w2 = torch.einsum("oikhw,kde->eodihw", w, S).reshape(D_out * w.shape[0], D_in * w.shape[1], 3, 3)
    w2 = w2.to(x.dtype)
    if mode == "up":
        return F.conv_transpose2d(x, w2, stride=2, padding=1, output_padding=1)
    return F.conv2d(x, w2, stride=2 if mode == "down" else 1, padding=1)


def _dense_layer(layer: ConvBnReLU, x: torch.Tensor, mode: str) -> torch.Tensor:
    """One ConvBnReLU in the depth-as-channels layout. BatchNorm runs on
    the free view [B, C, D, H, W] of the conv's [B, D·C, H, W] output, so
    its statistics are the 3-D layer's: per channel over B·D·H·W."""
    y = _dense_conv(layer.conv, x, mode)
    if layer.bn is not None:
        C = layer.bn.weight.shape[0]
        y = layer.bn(y.unflatten(1, (-1, C)).transpose(1, 2)).transpose(1, 2).flatten(1, 2)
    return F.relu(y) if layer.relu else y


class CostRegNetDense(CostRegNet):
    """``CostRegNet`` with the depth axis folded into the channels (the JAX
    package's ``CostRegNetDense``, ``transmvsnet_tpu/models/cost_reg.py``).

    The same submodules, parameters and buffers as ``CostRegNet`` (so the
    same state dict keys and seeded initialisation); each layer runs as a
    2-D conv over [B, D·C, H, W] with a block-banded weight built from its
    3-D weight at every call, which realises the 3-D conv exactly, depth
    padding included: D_in/3 times the 3-D conv's multiply-adds, in
    channel counts (D·C = 384 at stage 1) that suit cuDNN's tensor-core
    kernels. Activations stay NCHW through the U-Net, which takes the
    cascade's similarity as a view: channels-last was ~15% faster in the
    forward and ~6% slower in the train step on an H100, and the CPU's
    float32 channels-last conv backward loses digits.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C_in, D, H, W] -> [B, 1, D, H, W]."""
        B, C_in, D, H, W = x.shape
        # With C_in = 1 (the cascade's similarity) a view, no copy.
        x = x.transpose(1, 2).reshape(B, D * C_in, H, W).contiguous()
        conv0 = _dense_layer(self.conv0, x, "same")
        conv2 = _dense_layer(self.conv2, _dense_layer(self.conv1, conv0, "down"), "same")
        conv4 = _dense_layer(self.conv4, _dense_layer(self.conv3, conv2, "down"), "same")
        x = _dense_layer(self.conv6, _dense_layer(self.conv5, conv4, "down"), "same")
        x = conv4 + _dense_layer(self.conv7, x, "up")
        x = conv2 + _dense_layer(self.conv9, x, "up")
        x = conv0 + _dense_layer(self.conv11, x, "up")
        return _dense_conv(self.prob, x, "same").contiguous().unsqueeze(1)


class PixelwiseNet(nn.Module):
    """[B, 1, D, H, W] similarity -> [B, H, W] visibility weight: 1x1x1
    convs, sigmoid, max over D.

    On a mesh each process holds its views' share of B and its slab of
    D, so the BatchNorms reduce over every axis of the mesh and the
    caller takes the maximum over the depth axis."""

    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(1, 16, 1, 1, 0, ndim=3)
        self.conv1 = ConvBnReLU(16, 8, 1, 1, 0, ndim=3)
        self.conv2 = Conv3d(8, 1, 1, 1, 0, bias=True)
        for layer in (self.conv0, self.conv1):
            layer.bn.stats_axes = AXES

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.conv2(self.conv1(self.conv0(x))))
        return y[:, 0].amax(dim=1)
