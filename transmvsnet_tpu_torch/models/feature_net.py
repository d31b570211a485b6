"""Feature pyramid with deformable-conv output heads (ARF), NCHW.

The reference FeatureNet (reference models/module.py:343-422): a 3-level
conv pyramid (8 -> 16 -> 32 channels, two stride-2 levels), an FPN top-down
pathway with 1x1 lateral adds, and per-stage heads of three modulated
deformable convolutions. Outputs for base_channels=8: stage1
[B, 32, H/4, W/4], stage2 [B, 16, H/2, W/2], stage3 [B, 8, H, W].
"""

from __future__ import annotations

import math

import torch
from torch import nn

from transmvsnet_tpu_torch.models.blocks import BatchNorm, Conv2d, ConvBnReLU
from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused, dcn_fused_plain
from transmvsnet_tpu_torch.ops.sampling import upsample_nearest_2x


class DCN(nn.Module):
    """Modulated deformable 3x3 conv with its learned offset/mask conv.

    ``weight`` keeps the reference layout [C_out, C_in, 3, 3]; the op takes
    it tap-major. ``plain`` forces the plain PyTorch version on any device
    (for holding the kernel path against it on the card).
    """

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv_offset_mask = Conv2d(in_ch, 27, 3, 1, 1, bias=True)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.plain = False
        with torch.no_grad():
            self.conv_offset_mask.weight.zero_()
            self.conv_offset_mask.bias.zero_()
            bound = 1.0 / math.sqrt(in_ch * 9)
            self.weight.uniform_(-bound, bound)
            self.bias.uniform_(-bound, bound)

    def reset_parameters_from(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1] * 9)
        with torch.no_grad():
            for p in (self.weight, self.bias):
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_taps = self.weight.permute(2, 3, 1, 0).reshape(9, self.weight.shape[1], -1)
        op = dcn_fused_plain if self.plain else dcn_fused
        # cuDNN may hand back a channels-last result; the kernel reads NCHW.
        return op(x.contiguous(), self.conv_offset_mask.weight, self.conv_offset_mask.bias, w_taps, self.bias)


def arf_head(in_ch: int, mid: int, out: int, lead_kernel: int = 3) -> nn.Sequential:
    """Lead conv + [DCN, BN, ReLU] x 2 + final DCN; indices 0..7 as the
    reference's Sequential (1/4/7 DCN, 2/5 BN)."""
    return nn.Sequential(
        ConvBnReLU(in_ch, mid, lead_kernel, 1, (lead_kernel - 1) // 2),
        DCN(mid, mid),
        BatchNorm(mid),
        nn.ReLU(),
        DCN(mid, mid),
        BatchNorm(mid),
        nn.ReLU(),
        DCN(mid, out),
    )


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8):
        super().__init__()
        bc = base_channels
        self.conv0 = nn.Sequential(ConvBnReLU(3, bc, 3, 1, 1), ConvBnReLU(bc, bc, 3, 1, 1))
        self.conv1 = nn.Sequential(
            ConvBnReLU(bc, bc * 2, 5, 2, 2),
            ConvBnReLU(bc * 2, bc * 2, 3, 1, 1),
            ConvBnReLU(bc * 2, bc * 2, 3, 1, 1),
        )
        self.conv2 = nn.Sequential(
            ConvBnReLU(bc * 2, bc * 4, 5, 2, 2),
            ConvBnReLU(bc * 4, bc * 4, 3, 1, 1),
            ConvBnReLU(bc * 4, bc * 4, 3, 1, 1),
        )
        self.out1 = arf_head(bc * 4, bc * 4, bc * 4, lead_kernel=1)
        self.out2 = arf_head(bc * 4, bc * 4, bc * 2)
        self.out3 = arf_head(bc * 4, bc * 4, bc)
        self.inner1 = Conv2d(bc * 2, bc * 4, 1, bias=True)
        self.inner2 = Conv2d(bc, bc * 4, 1, bias=True)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x [N, 3, H, W] -> {"stage1".."stage3": [N, C_s, h_s, w_s]}."""
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        out = {"stage1": self.out1(conv2)}
        intra = upsample_nearest_2x(conv2) + self.inner1(conv1)
        out["stage2"] = self.out2(intra)
        intra = upsample_nearest_2x(intra) + self.inner2(conv0)
        out["stage3"] = self.out3(intra)
        return out
