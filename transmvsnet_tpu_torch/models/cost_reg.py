"""Cost-volume regularisation (3-D U-Net) and per-view visibility weights.

``CostRegNet`` is the reference's 3-level 3-D U-Net (reference
models/module.py:425-456): a stride-2 encoder (c -> 2c -> 4c -> 8c), a
transposed-conv decoder with additive skips and a bias-free 3x3x3 conv to
one channel. ``PixelwiseNet`` is the 1x1x1 visibility head (reference
models/TransMVSNet.py:10-30). Volumes are [B, C, D, H, W].
"""

from __future__ import annotations

import torch
from torch import nn

from transmvsnet_tpu_torch.models.blocks import Conv3d, ConvBnReLU


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


class PixelwiseNet(nn.Module):
    """[B, 1, D, H, W] similarity -> [B, H, W] visibility weight: 1x1x1
    convs, sigmoid, max over D."""

    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(1, 16, 1, 1, 0, ndim=3)
        self.conv1 = ConvBnReLU(16, 8, 1, 1, 0, ndim=3)
        self.conv2 = Conv3d(8, 1, 1, 1, 0, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.conv2(self.conv1(self.conv0(x))))
        return y[:, 0].amax(dim=1)
