"""Building blocks with the JAX package's numerics, NCHW.

Parameters stay float32; each layer casts its weights to the activation
dtype, as the JAX package does (``kernel.astype(x.dtype)``). BatchNorm and
LayerNorm compute in float32 and return the input dtype. Parameter names
are the reference checkpoint's (torch's own ``weight``/``bias``/
``running_*``), so a reference ``.ckpt`` state dict loads directly.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from transmvsnet_tpu_torch.parallel import sharding


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
    """torch batch norm over channel dim 1, computed in float32 (float64
    input in float64).

    Train mode normalises with the biased batch variance and updates the
    running variance with the unbiased one, momentum 0.1 (the JAX
    package's ``blocks.BatchNorm``). Buffers carry torch's names, including
    ``num_batches_tracked``, so torch BatchNorm state dicts load as they are.

    In a process group of more than one process, train mode sums each
    channel's sum, sum of squares and element count over the processes of
    ``stats_axes`` (``parallel/sharding.py::reduction_group``: all of them
    without a mesh) with one differentiable all-reduce per call, and the
    running variance counts the elements of every process: BatchNorm over
    the global batch (the JAX package's batch arrays are global; the
    reference's SyncBatchNorm, reference train.py:363). A layer replicated
    over a mesh's view and depth axes reduces over ``data`` (the default);
    one whose input is split over them as well reduces over all three,
    and the true counts weigh unequal chunks right. ``torch.nn.
    SyncBatchNorm`` is not used: it refuses CPU tensors. With one process
    the statistics are the local batch's.

    While ``recomputing`` (``remat``'s backward reruns the layer) it
    rebuilds the batch statistics, their all-reduce included, but leaves
    the running statistics alone: they were updated by the forward.
    """

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.recomputing = False
        self.stats_axes: tuple[str, ...] = ("data",)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1, -1] + [1] * (x.ndim - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            axes = [0] + list(range(2, x.ndim))
            n = xf.numel() / xf.shape[1]
            group = sharding.reduction_group(self.stats_axes)
            if group is None:
                mean = xf.mean(axes)
                mean_sq = (xf * xf).mean(axes)
                unbias = n / max(n - 1.0, 1.0)
            else:
                sums = torch.cat([xf.sum(axes), (xf * xf).sum(axes), xf.new_full((1,), n)])
                sums = sharding.sum_over(sums, group, "batchnorm")
                n = sums[-1]
                mean, mean_sq = sums[:-1].unflatten(0, (2, -1)) / n
                unbias = n / (n - 1.0).clamp(min=1.0)
            var = mean_sq - mean * mean
            if not self.recomputing:
                self._update_running(mean, var, unbias)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor, unbias) -> None:
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean)
        self.running_var.mul_(1 - m).add_(m * var * unbias)
        self.num_batches_tracked.add_(1)


@contextlib.contextmanager
def _recomputing(module: nn.Module):
    """``module``'s BatchNorm layers marked as recomputing inside the block."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def remat(module: nn.Module, *args):
    """``module(*args)`` with its activations recomputed in the backward
    instead of kept (the JAX package's ``nn.remat``), BatchNorm's running
    statistics updated once. Nothing in the model draws random numbers,
    so the RNG state is not saved for the recompute."""
    return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recomputing(module)))


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
