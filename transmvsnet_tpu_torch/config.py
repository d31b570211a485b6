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
    # Activation dtype: "float32" or "bfloat16" (geometry, softmax and
    # depth stay float32 either way).
    compute_dtype: str = "float32"

    @property
    def num_stages(self) -> int:
        return len(self.ndepths)

    @property
    def stage_scales(self) -> Sequence[int]:
        return tuple(2 ** (self.num_stages - 1 - i) for i in range(self.num_stages))
