"""The TransMVSNet cascade: features -> FMT -> 3-stage plane sweep.

The reference top module (reference models/TransMVSNet.py:33-226):
per-stage depth hypotheses, per-source-view warp + correlation weighted by
PixelwiseNet visibility (computed at stage 1, nearest-upsampled x2 for the
later stages), 3-D U-Net regularisation, softmax over depth, winner-take-
all depth with max-probability confidence. Views go through FeatureNet as
one batch (``batch_views_jointly``) or one at a time; all source views of
a stage go through one warp-correlation launch (with ``fused_view_sum``
and bf16 features, stages 2-3 sum the views inside it). The cost
regulariser is ``CostRegNetDense`` or ``CostRegNet`` (``dense_cost_reg``);
with ``remat`` the four modules the JAX package rematerialises
(FeatureNet, the FMT, PixelwiseNet, each cost regulariser) recompute their
activations in the backward. ``forward`` keeps the JAX package's
channel-last input contract.

On a mesh (``parallel/sharding.py``, the JAX package's ``constrain``
points) each process sweeps its chunk of the source views (``view``)
against its contiguous slab of each stage's hypotheses (``depth``):
PixelwiseNet runs on that share and its maximum over depth becomes a max
all-reduce over ``depth``; the view-weighted numerator and the weight sum
are all-reduced over ``view``; the slabs of the similarity are gathered
over ``depth`` before the cost regulariser, which, with the softmax and
the WTA, runs replicated on every process. FeatureNet and the pathway
run replicated too, the FMT sequence parallel (``models/fmt.py``). The
fused view sum sums over views inside the kernel, so it is taken only
when the views are not split.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.models.blocks import init_parameters, remat, resolve_device
from transmvsnet_tpu_torch.models.cost_reg import CostRegNet, CostRegNetDense, PixelwiseNet
from transmvsnet_tpu_torch.models.feature_net import DCN, FeatureNet
from transmvsnet_tpu_torch.models.fmt import FMTWithPathway
from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
    warp_correlate_plain,
    warp_correlate_wsum_plain,
)
from transmvsnet_tpu_torch.ops.geometry import (
    fuse_projection,
    initial_depth_samples,
    refine_depth_samples,
)
from transmvsnet_tpu_torch.ops.sampling import resize_bilinear, upsample_nearest_2x
from transmvsnet_tpu_torch.ops.vjp import warp_correlate_with_vjp, warp_correlate_wsum_with_vjp
from transmvsnet_tpu_torch.parallel import sharding


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
        cost_reg_cls = CostRegNetDense if cfg.dense_cost_reg else CostRegNet
        self.cost_regularization = nn.ModuleList(
            cost_reg_cls(1, c) for c in cfg.cr_base_channels
        )
        self.DepthNet = _DepthNet()
        self.plain_ops = False
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)
        self.to(device)

    def use_plain_ops(self, plain: bool) -> None:
        """Route the DCN and warp-correlation call sites to their plain
        PyTorch forwards on any device, differentiated by autograd (True),
        or back to the kernels' autograd Functions (False)."""
        self.plain_ops = plain
        for m in self.modules():
            if isinstance(m, DCN):
                m.plain = plain

    def _call(self, module: nn.Module, *args):
        """``module(*args)``, rematerialised when ``cfg.remat`` and autograd
        records (inference under ``no_grad`` runs as without remat)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return remat(module, *args)
        return module(*args)

    def extract_features(self, imgs: torch.Tensor) -> dict[str, torch.Tensor]:
        """imgs [B, V, H, W, 3] -> {"stageN": [B, V, C, h, w]}."""
        B, V = imgs.shape[:2]
        # [B, V, 3, H, W], channel-last in memory: FeatureNet's convs run
        # in that layout.
        x = imgs.to(self.dtype).permute(0, 1, 4, 2, 3)
        if self.cfg.batch_views_jointly:
            feats = {k: v.unflatten(0, (B, V)) for k, v in self._call(self.feature, x.flatten(0, 1)).items()}
        else:
            per_view = [self._call(self.feature, x[:, v]) for v in range(V)]
            feats = {k: torch.stack([f[k] for f in per_view], 1) for k in per_view[0]}
        feats = self._call(self.FMT_with_pathway, feats)
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
        computes them; on a mesh S is this process's sources). Returns
        (outputs, view_weights).
        """
        B, V, C, h, w = features.shape
        D = depth_values.shape[1]
        fused = fuse_projection(proj.float())
        # This process's source views and hypothesis slab on a mesh.
        args = (
            sharding.split(features[:, 1:], 1, "view").contiguous(),
            features[:, 0].contiguous(),
            sharding.split(fused[:, 1:], 1, "view"),
            fused[:, 0],
            sharding.split(depth_values.float(), 1, "depth").contiguous(),
        )
        S, D_slab = args[0].shape[1], args[4].shape[1]
        if (view_weights is not None and self.cfg.fused_view_sum and features.dtype == torch.bfloat16
                and sharding.axis_size("view") == 1):
            # Stages 2-3 with bf16 features: the view-weighted sum inside
            # the warp kernel (K7/K8), as the JAX package's fused route
            # (transmvsnet_tpu/models/transmvsnet.py:156-189).
            wsum = warp_correlate_wsum_plain if self.plain_ops else warp_correlate_wsum_with_vjp
            weighted = wsum(*args, view_weights.float().contiguous())
            similarity = weighted / (1e-5 + view_weights.sum(1, keepdim=True))
        else:
            warp = warp_correlate_plain if self.plain_ops else warp_correlate_with_vjp
            sim = warp(*args)  # [B, S, D_slab, h, w] float32
            if view_weights is None:
                # Gradients flow through the weights used in this stage's
                # sum; later stages get the detached copy (reference
                # TransMVSNet.py:82-84,107).
                w_used = self._call(self.DepthNet.pixel_wise_net, sim.reshape(B * S, 1, D_slab, h, w))
                w_used = sharding.pmax(w_used, "depth", "pixelwise.max").reshape(B, S, h, w)
                view_weights = w_used.detach()
            else:
                w_used = view_weights
            wb = w_used[:, :, None]
            num, den = (sim * wb).sum(1), wb.sum(1)
            if sharding.axis_size("view") > 1:
                sums = sharding.psum(torch.cat([num, den], 1), ("view",), "similarity.view_sum")
                num, den = sums[:, :D_slab], sums[:, D_slab:]
            similarity = num / (1e-5 + den)
        similarity = sharding.gather(similarity, 1, "depth", D, "similarity.slabs")
        cost = self._call(cost_reg, similarity.to(self.dtype)[:, None])[:, 0]
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
