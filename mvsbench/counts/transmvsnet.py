"""TransMVSNet's work counted from shapes: floating-point operations (two
per multiply-add) and, for the deformable layers, the bytes they must move.

Each operation counts its own work once, whatever implements it: the cost
regulariser counts as the 3-D U-Net's convolutions in either of the
program's forms; a deformable layer as its offset/mask conv plus the
contraction, 2·9·C·C_out per pixel (not the three products of a 3xTF32
split); a warp sample its bilinear interpolation and the correlation
(10 operations per channel) only where it falls inside the source image.
Elementwise work (BatchNorm, activations, softmax) is not counted.
"""

from __future__ import annotations

import numpy as np


def _half(n: int) -> int:
    """Size after a 3-wide, stride-2, pad-1 conv."""
    return (n + 1) // 2


def conv_flops(pixels: int, cin: int, cout: int, k: int, ndim: int = 2) -> float:
    return 2.0 * pixels * cin * cout * k ** ndim


def dcn_layers(model: dict, N: int, H: int, W: int) -> list[dict]:
    """The nine deformable layers of FeatureNet at N images of H x W:
    name, pixels, C, C_out."""
    bc = model["base_channels"]
    out = []
    for head, (scale, c_last) in {"out1": (4, 4 * bc), "out2": (2, 2 * bc), "out3": (1, bc)}.items():
        pix = N * (H // scale) * (W // scale)
        for idx, cout in ((1, 4 * bc), (4, 4 * bc), (7, c_last)):
            out.append({"name": f"feature.{head}.{idx}", "pixels": pix, "C": 4 * bc, "C_out": cout})
    return out


def dcn_work(layer: dict, act_bytes: int) -> dict:
    """One deformable layer: operations (offset/mask conv and contraction)
    and bytes (its input read once, its output written once, weights)."""
    p, c, co = layer["pixels"], layer["C"], layer["C_out"]
    flops = 2.0 * p * 9 * c * (27 + co)
    nbytes = act_bytes * p * (c + co) + 4 * (9 * c * (27 + co) + 27 + co)
    return {"flops": flops, "bytes": nbytes}


def roofline_seconds(flops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time: operations over the peak or bytes over bandwidth,
    whichever is larger."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def feature_flops(model: dict, N: int, H: int, W: int) -> float:
    bc = model["base_channels"]
    p1, p2, p4 = N * H * W, N * (H // 2) * (W // 2), N * (H // 4) * (W // 4)
    f = conv_flops(p1, 3, bc, 3) + conv_flops(p1, bc, bc, 3)
    f += conv_flops(p2, bc, 2 * bc, 5) + 2 * conv_flops(p2, 2 * bc, 2 * bc, 3)
    f += conv_flops(p4, 2 * bc, 4 * bc, 5) + 2 * conv_flops(p4, 4 * bc, 4 * bc, 3)
    f += conv_flops(p4, 4 * bc, 4 * bc, 1) + conv_flops(p2, 4 * bc, 4 * bc, 3) + conv_flops(p1, 4 * bc, 4 * bc, 3)
    f += conv_flops(p2, 2 * bc, 4 * bc, 1) + conv_flops(p1, bc, 4 * bc, 1)
    return f + sum(dcn_work(layer, 4)["flops"] for layer in dcn_layers(model, N, H, W))


def fmt_flops(model: dict, B: int, V: int, H: int, W: int) -> float:
    """The eight encoder layers on the stage-1 tokens and the pathway's
    convs: per sequence of L tokens, four projections and the FFN (16
    L d^2) and linear attention (4 L d d_head + 2 L d)."""
    d, heads, bc = model["fmt_d_model"], model["fmt_nhead"], model["base_channels"]
    L = (H // 4) * (W // 4)
    per_seq = 16.0 * L * d * d + 4.0 * L * d * (d // heads) + 2.0 * L * d
    S = V - 1
    seqs = sum(B + B * S if kind == "self" else B * S for kind in model["fmt_layers"])
    N = B * V
    path = conv_flops(N * L, 4 * bc, 2 * bc, 1) + conv_flops(N * (H // 2) * (W // 2), 2 * bc, 2 * bc, 3)
    path += conv_flops(N * (H // 2) * (W // 2), 2 * bc, bc, 1) + conv_flops(N * H * W, bc, bc, 3)
    return seqs * per_seq + path


def cost_reg_flops(c: int, B: int, D: int, h: int, w: int) -> float:
    """The 3-D U-Net at [B, 1, D, h, w] with base channels c."""
    v0 = B * D * h * w
    v1 = B * _half(D) * _half(h) * _half(w)
    v2 = B * _half(_half(D)) * _half(_half(h)) * _half(_half(w))
    v3 = B * _half(_half(_half(D))) * _half(_half(_half(h))) * _half(_half(_half(w)))
    f = conv_flops(v0, 1, c, 3, 3) + conv_flops(v1, c, 2 * c, 3, 3) + conv_flops(v1, 2 * c, 2 * c, 3, 3)
    f += conv_flops(v2, 2 * c, 4 * c, 3, 3) + conv_flops(v2, 4 * c, 4 * c, 3, 3)
    f += conv_flops(v3, 4 * c, 8 * c, 3, 3) + conv_flops(v3, 8 * c, 8 * c, 3, 3)
    # Transposed convs: every input voxel meets every tap.
    f += conv_flops(v3, 8 * c, 4 * c, 3, 3) + conv_flops(v2, 4 * c, 2 * c, 3, 3) + conv_flops(v1, 2 * c, c, 3, 3)
    return f + conv_flops(v0, c, 1, 3, 3)


def stage_shapes(model: dict, H: int, W: int) -> list[tuple[int, int, int, int]]:
    """(D, h, w, C) of each stage."""
    bc = model["base_channels"]
    chans = (4 * bc, 2 * bc, bc)
    n = len(model["ndepths"])
    return [(model["ndepths"][i], H // 2 ** (n - 1 - i), W // 2 ** (n - 1 - i), chans[i]) for i in range(n)]


def sweep_flops(model: dict, B: int, V: int, H: int, W: int, in_bounds: list[float]) -> float:
    """Warp and correlation of the in-bounds samples, PixelwiseNet at stage
    1 (1 -> 16 -> 8 -> 1 per voxel) and the view-weighted sum."""
    S = V - 1
    f = 0.0
    for i, (D, h, w, C) in enumerate(stage_shapes(model, H, W)):
        voxels = B * S * D * h * w
        f += voxels * in_bounds[i] * 10.0 * C + 2.0 * voxels
        if i == 0:
            f += voxels * 2.0 * (16 + 16 * 8 + 8)
    return f


def forward_flops(model: dict, B: int, V: int, H: int, W: int, in_bounds: list[float]) -> dict:
    """Operations of one forward by layer, and their total."""
    out = {
        "feature": feature_flops(model, B * V, H, W),
        "fmt": fmt_flops(model, B, V, H, W),
        "cost_reg": sum(cost_reg_flops(c, B, D, h, w) for c, (D, h, w, _) in
                        zip(model["cr_base_channels"], stage_shapes(model, H, W))),
        "sweep": sweep_flops(model, B, V, H, W, in_bounds),
    }
    out["total"] = sum(out.values())
    return out


def in_bounds_shares(proj_matrices: dict, depth_values: np.ndarray, model: dict, H: int, W: int,
                     step: int = 4) -> list[float]:
    """Per stage, the share of warp samples inside the source image, over
    every source view and plane, on every ``step``-th pixel. Planes span
    the sweep's range at each stage (stages 2 and 3 centre theirs on the
    previous depth, which lies in it). proj_matrices {"stageN": [V, 2, 4,
    4]} of one sample; depth_values [num_hyp]."""
    shares = []
    for i, (D, h, w, _) in enumerate(stage_shapes(model, H, W)):
        p = proj_matrices[f"stage{i + 1}"].astype(np.float64)
        fused = np.concatenate([p[:, 1, :3, :3] @ p[:, 0, :3, :], p[:, 0, 3:, :]], axis=1)
        ys, xs = np.mgrid[0:h:step, 0:w:step]
        pix = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)])
        planes = np.linspace(depth_values[0], depth_values[-1], D)
        inside = total = 0
        for v in range(1, len(fused)):
            rel = fused[v] @ np.linalg.inv(fused[0])
            pts = (rel[:3, :3] @ pix)[:, None, :] * planes[None, :, None] + rel[:3, 3, None, None]
            z = pts[2]
            ok = z > 1e-6
            px = np.where(ok, pts[0] / np.where(ok, z, 1), -1)
            py = np.where(ok, pts[1] / np.where(ok, z, 1), -1)
            inside += int((ok & (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)).sum())
            total += z.size
        shares.append(inside / total)
    return shares
