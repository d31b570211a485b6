"""Building blocks with the JAX package's numerics, NCHW.

Parameters stay float32; each layer casts its weights to the activation
dtype, as the JAX package does (``kernel.astype(x.dtype)``). BatchNorm and
LayerNorm compute in float32 and return the input dtype. Parameter names
are the reference checkpoint's (torch's own ``weight``/``bias``/
``running_*``), so a reference ``.ckpt`` state dict loads directly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller says CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return device


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class Conv3d(nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class ConvTranspose3d(nn.ConvTranspose3d):
    """torch's native [I, O, kd, kh, kw] layout; the JAX side stores the
    same kernel spatially flipped (its ``DeconvND``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose3d(
            x, self.weight.to(x.dtype), b, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
        )


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """eps 1e-5, computed in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """torch batch norm over channel dim 1, computed in float32.

    Train mode normalises with the biased batch variance and updates the
    running variance with the unbiased one, momentum 0.1 (the JAX
    package's ``blocks.BatchNorm``). Buffers carry torch's names, including
    ``num_batches_tracked``, so torch BatchNorm state dicts load as they are.
    """

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1, -1] + [1] * (x.ndim - 2)
        xf = x.float()
        if self.training:
            axes = [0] + list(range(2, x.ndim))
            mean = xf.mean(axes)
            var = (xf * xf).mean(axes) - mean * mean
            n = xf.numel() / xf.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1.0, 1.0)))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class ConvBnReLU(nn.Module):
    """conv -> BN -> ReLU (reference models/module.py:24-231); ``bn=False``
    gives the conv a bias, ``relu=False`` drops the activation."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 1,
        ndim: int = 2,
        transpose: bool = False,
        output_padding: int = 0,
        bn: bool = True,
        relu: bool = True,
    ):
        super().__init__()
        if transpose:
            assert ndim == 3
            self.conv = ConvTranspose3d(
                in_ch, out_ch, kernel_size, stride, padding,
                output_padding=output_padding, bias=not bn,
            )
        else:
            cls = Conv2d if ndim == 2 else Conv3d
            self.conv = cls(in_ch, out_ch, kernel_size, stride, padding, bias=not bn)
        self.bn = BatchNorm(out_ch) if bn else None
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(
            (torch.rand(t.shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound
        )


def init_parameters(module: nn.Module, gen: torch.Generator) -> None:
    """Re-initialise every parameter from ``gen``, on the CPU generator.

    torch's defaults (kaiming-uniform a=sqrt(5), i.e. U(+-1/sqrt(fan_in)),
    and the fan-in bias bound) for convs and linears; xavier-uniform for
    the FMT's linears; ones/zeros for the norms (set at construction).
    DCN offset convs start at zero, as the reference's do; a module with a
    ``reset_parameters_from(gen)`` method initialises its own parameters.
    """
    for name, m in module.named_modules():
        if name.endswith("conv_offset_mask"):
            with torch.no_grad():
                m.weight.zero_()
                m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
            w = m.weight
            fan_in = w.shape[1] * math.prod(w.shape[2:])
            xavier = isinstance(m, nn.Linear) and ".FMT." in f".{name}."
            if xavier:
                bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            else:
                bound = 1.0 / math.sqrt(fan_in)
            _uniform_(w, bound, gen)
            if m.bias is not None:
                b_fan = w.shape[1] if isinstance(m, nn.Linear) else fan_in
                _uniform_(m.bias, 1.0 / math.sqrt(b_fan), gen)
        elif hasattr(m, "reset_parameters_from") and m is not module:
            m.reset_parameters_from(gen)
