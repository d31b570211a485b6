"""The TransMVSNet cascade: features -> FMT -> 3-stage plane sweep.

The reference top module (reference models/TransMVSNet.py:33-226):
per-stage depth hypotheses, per-source-view warp + correlation weighted by
PixelwiseNet visibility (computed at stage 1, nearest-upsampled x2 for the
later stages), 3-D U-Net regularisation, softmax over depth, winner-take-
all depth with max-probability confidence. Views go through FeatureNet as
one batch; all source views of a stage go through one warp-correlation
launch. ``forward`` keeps the JAX package's channel-last input contract.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.models.blocks import init_parameters, resolve_device
from transmvsnet_tpu_torch.models.cost_reg import CostRegNet, PixelwiseNet
from transmvsnet_tpu_torch.models.feature_net import DCN, FeatureNet
from transmvsnet_tpu_torch.models.fmt import FMTWithPathway
from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate, warp_correlate_plain
from transmvsnet_tpu_torch.ops.geometry import (
    fuse_projection,
    initial_depth_samples,
    refine_depth_samples,
)
from transmvsnet_tpu_torch.ops.sampling import resize_bilinear, upsample_nearest_2x


def depth_wta(prob_volume: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """Winner-take-all depth, first maximum on ties. [B, D, H, W] -> [B, H, W]."""
    idx = torch.argmax(prob_volume, dim=1, keepdim=True)
    return torch.gather(depth_values.expand_as(prob_volume), 1, idx)[:, 0]


class _DepthNet(nn.Module):
    """Holds PixelwiseNet under the reference's ``DepthNet.pixel_wise_net`` key."""

    def __init__(self):
        super().__init__()
        self.pixel_wise_net = PixelwiseNet()


class TransMVSNet(nn.Module):
    """The cascade, built on ``device`` (CUDA unless the caller says CPU)
    with parameters drawn from ``generator`` (a CPU ``torch.Generator``;
    seed 0 if None)."""

    def __init__(
        self,
        cfg: ModelConfig = ModelConfig(),
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.feature = FeatureNet(cfg.base_channels)
        self.FMT_with_pathway = FMTWithPathway(
            cfg.base_channels, cfg.fmt_d_model, cfg.fmt_nhead, tuple(cfg.fmt_layers)
        )
        self.cost_regularization = nn.ModuleList(
            CostRegNet(1, c) for c in cfg.cr_base_channels
        )
        self.DepthNet = _DepthNet()
        self.plain_ops = False
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)
        self.to(device)

    def use_plain_ops(self, plain: bool) -> None:
        """Route both kernels' call sites to their plain PyTorch versions on
        any device (True), or back to the kernels (False)."""
        self.plain_ops = plain
        for m in self.modules():
            if isinstance(m, DCN):
                m.plain = plain

    def extract_features(self, imgs: torch.Tensor) -> dict[str, torch.Tensor]:
        """imgs [B, V, H, W, 3] -> {"stageN": [B, V, C, h, w]}."""
        B, V = imgs.shape[:2]
        x = imgs.to(self.dtype).permute(0, 1, 4, 2, 3).reshape(B * V, 3, *imgs.shape[2:4])
        feats = {k: v.unflatten(0, (B, V)) for k, v in self.feature(x).items()}
        feats = self.FMT_with_pathway(feats)
        return {k: v.to(self.dtype) for k, v in feats.items()}

    def depth_stage(
        self,
        features: torch.Tensor,
        proj: torch.Tensor,
        depth_values: torch.Tensor,
        cost_reg: CostRegNet,
        view_weights: torch.Tensor | None,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """One cascade stage (reference models/TransMVSNet.py:38-109).

        features [B, V, C, h, w] (view 0 the reference); proj [B, V, 2, 4, 4];
        depth_values [B, D, h, w]; view_weights [B, S, h, w] or None (stage 1
        computes them). Returns (outputs, view_weights).
        """
        B, V, C, h, w = features.shape
        S = V - 1
        D = depth_values.shape[1]
        fused = fuse_projection(proj.float())
        warp = warp_correlate_plain if self.plain_ops else warp_correlate
        sim = warp(
            features[:, 1:].contiguous(),
            features[:, 0].contiguous(),
            fused[:, 1:],
            fused[:, 0],
            depth_values.float().contiguous(),
        )  # [B, S, D, h, w] float32
        if view_weights is None:
            # Gradients flow through the weights used in this stage's sum;
            # later stages get the detached copy (reference
            # TransMVSNet.py:82-84,107).
            w_used = self.DepthNet.pixel_wise_net(sim.reshape(B * S, 1, D, h, w))
            w_used = w_used.reshape(B, S, h, w)
            view_weights = w_used.detach()
        else:
            w_used = view_weights
        wb = w_used[:, :, None]
        similarity = (sim * wb).sum(1) / (1e-5 + wb.sum(1))
        cost = cost_reg(similarity.to(self.dtype)[:, None])[:, 0]
        prob_volume = torch.softmax(cost.float(), dim=1)
        outputs = {
            "depth": depth_wta(prob_volume, depth_values),
            "photo_confidence": prob_volume.amax(dim=1).detach(),
            "prob_volume": prob_volume,
            "depth_values": depth_values,
        }
        return outputs, view_weights

    def forward(
        self,
        imgs: torch.Tensor,
        proj_matrices: dict[str, torch.Tensor],
        depth_values: torch.Tensor,
    ) -> dict[str, Any]:
        """imgs [B, V, H, W, 3], view 0 the reference; proj_matrices
        {"stage1".."stage3": [B, V, 2, 4, 4]}; depth_values [B, Dh] the
        dataset's hypothesis sweep. Returns {"stageN": {...}} plus the last
        stage's entries at the top level."""
        cfg = self.cfg
        B, V, H, W, _ = imgs.shape
        num_hyp = depth_values.shape[1]
        depth_interval = (depth_values[:, -1] - depth_values[:, 0]) / num_hyp
        features = self.extract_features(imgs)
        outputs: dict[str, Any] = {}
        prev_depth = None
        view_weights = None
        for i in range(cfg.num_stages):
            stage = f"stage{i + 1}"
            scale = cfg.stage_scales[i]
            h, w = H // scale, W // scale
            if prev_depth is None:
                samples = initial_depth_samples(depth_values, cfg.ndepths[i], (h, w))
            else:
                samples = refine_depth_samples(
                    prev_depth.detach(),
                    cfg.ndepths[i],
                    cfg.depth_interval_ratios[i] * depth_interval,
                    (h, w),
                    (H, W),
                )
            if i > 0:
                view_weights = upsample_nearest_2x(view_weights)
            stage_out, view_weights = self.depth_stage(
                features[stage],
                proj_matrices[stage],
                samples,
                self.cost_regularization[i],
                view_weights,
            )
            prev_depth = stage_out["depth"]
            if cfg.depth_clamp is not None:
                stage_out["depth"] = prev_depth.clamp(*cfg.depth_clamp)
            outputs[stage] = stage_out
        outputs.update(outputs[f"stage{cfg.num_stages}"])
        return outputs


def blended_confidence(outputs: dict[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
    """Final depth and confidence as the inference CLI writes them
    (reference test.py:93-144): stage-3 confidence times the bilinearly
    upsampled stage-1 and stage-2 confidences; depth zeroed below 0.01."""
    depth = outputs["stage3"]["depth"]
    H, W = depth.shape[-2:]
    conf = outputs["stage3"]["photo_confidence"]
    for s in ("stage1", "stage2"):
        c = outputs[s]["photo_confidence"][:, None]
        conf = conf * resize_bilinear(c, (H, W))[:, 0]
    depth = torch.where(conf < 0.01, torch.zeros_like(depth), depth)
    return depth, conf
