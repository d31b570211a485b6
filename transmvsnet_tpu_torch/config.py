"""Model configuration (the reference's DTU recipe defaults).

Own copy of the JAX package's ``ModelConfig`` without its TPU-only knobs:
here the tensor's device picks the path (CUDA tensor -> hand-written
kernel, CPU tensor -> the kernel's plain PyTorch version).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    ndepths: Sequence[int] = (48, 32, 8)
    depth_interval_ratios: Sequence[float] = (4.0, 1.0, 0.5)
    cr_base_channels: Sequence[int] = (8, 8, 8)
    base_channels: int = 8
    fmt_d_model: int = 32
    fmt_nhead: int = 8
    fmt_layers: Sequence[str] = ("self", "cross") * 4
    # Final-depth clamp range; None keeps float depth unclamped.
    depth_clamp: tuple[float, float] | None = None
    # Run all views through FeatureNet as one batch. False runs it once
    # per view, so train-mode BatchNorm takes per-view statistics (as the
    # reference does) and updates its running statistics once per view.
    batch_views_jointly: bool = True
    # Activation dtype: "float32" or "bfloat16" (geometry, softmax and
    # depth stay float32 either way).
    compute_dtype: str = "float32"
    # Recompute FeatureNet, the FMT, PixelwiseNet and the cost regularisers
    # in the backward instead of keeping their activations
    # (torch.utils.checkpoint at module granularity, only while autograd
    # records). The training CLI turns it on unless --no_remat.
    remat: bool = False
    # Depth-as-channels cost regularisation (models/cost_reg.py::
    # CostRegNetDense): the 3-D U-Net's function in the same parameters,
    # as 2-D convs over D*C channels with block-banded weights. False runs
    # the 3-D convs.
    dense_cost_reg: bool = True
    # Accumulate the weighted view sum inside the warp kernel at stages
    # with precomputed view weights (2-3) when the features are bf16,
    # never materialising the [B, S, D, h, w] per-view volume (K7 forward,
    # K8 backward). Float32 stays on the per-view route either way.
    fused_view_sum: bool = False

    @property
    def num_stages(self) -> int:
        return len(self.ndepths)

    @property
    def stage_scales(self) -> Sequence[int]:
        return tuple(2 ** (self.num_stages - 1 - i) for i in range(self.num_stages))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process-mesh axis sizes: data × view × depth (the JAX package's
    ``MeshConfig``). ``data`` 0 means the processes left over by the
    other two axes (``parallel/mesh.py::make_mesh``)."""

    data: int = 1
    view: int = 1
    depth: int = 1
