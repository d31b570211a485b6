"""Geometric-consistency depth-map fusion into a point cloud, in torch on
the device (the JAX package's ``fusion/dynamic.py``, after the reference's
dynamic_fusion.py from AA-RMVSNet).

Each reference pixel is projected into every source view with its depth,
the source depth is sampled there, and the point is projected back. A
pixel is kept if its confidence passes ``photo_threshold`` and enough
sources agree:

- "dynamic": masks_i = (reprojection distance < i/4 px) and (relative
  depth difference < i/1300), i = 2..10; kept if #sources with masks_10
  >= thres_view, or for some i in [2, n - 1] #sources with masks_i >= i,
  n the number of views (reference dynamic_fusion.py:134-136, 221-228,
  253-264). Rungs stop at 10: with more than 9 sources the JAX package's
  ladder indexes past its last rung and raises.
- "normal": the fixed 1 px / 0.01 test over >= thres_view sources
  (reference README.md:149-152).

The kept depth is the mean over the agreeing views, unprojected into a
coloured world point.

All sources of one reference view go through together: one
``grid_sample`` over [S, 1, H, W]. The geometry runs in float64, as the
JAX fuser's numpy does once its integer pixel grids meet float32 depths;
the 3x3 and 4x4 matrices are inverted and multiplied in float32 on the
host as there, and the sampled depth, reprojected depth and coordinates
are rounded to float32 where the JAX fuser rounds them. Sampling is exact
bilinear with zeros outside the image (``align_corners=True``: pixel
centres); ``cv2.remap``, which the JAX fuser uses, rounds the sampling
position to 1/32 px, so near depth edges a few pixels at a threshold flip.
Non-finite source coordinates (zero depth, points behind a source camera)
read 0, as ``cv2.remap`` reads them.

On-disk contract per scan folder: depth_est/*.pfm, confidence/*.pfm,
cams/*_cam.txt (MVSNet format), images/*.jpg (or .png), pair.txt.
``fuse_scans`` fuses up to ``num_workers`` scans at once, each in a
spawned process of its own (the JAX fuser's process pool, reference
dynamic_fusion.py:291-301).
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent import futures
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from transmvsnet_tpu_torch.data.cams import read_pair_file
from transmvsnet_tpu_torch.data.image_io import read_image, resize_bilinear, write_png
from transmvsnet_tpu_torch.data.pfm import read_pfm
from transmvsnet_tpu_torch.fusion.ply import write_ply
from transmvsnet_tpu_torch.models.blocks import resolve_device

LADDER = range(2, 11)  # the dynamic rungs i = 2..10


@dataclass
class FusionParams:
    photo_threshold: float = 0.3
    thres_view: int = 3
    # Rung scales: the reference's i/4 px and i/1300 are tuned to DTU's
    # hypothesis spacing; coarser grids widen them. 1.0 = the reference.
    dist_scale: float = 1.0
    rel_diff_scale: float = 1.0
    # "dynamic" = the ladder above; "normal" = the fixed-threshold filter.
    mode: str = "dynamic"
    geo_pixel_thres: float = 1.0
    geo_depth_thres: float = 0.01


def _read_fusion_cam(path: str, scale: float, index: int, flag: int):
    """Camera for fusion: intrinsics rescaled to the confidence grid and
    shifted by the crop offset (reference dynamic_fusion.py:33-49)."""
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extr = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intr = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    intr[:2, :] *= scale
    if flag == 0:
        intr[0, 2] -= index
    else:
        intr[1, 2] -= index
    return intr, extr


def _homogeneous(m: np.ndarray, xyz: torch.Tensor) -> torch.Tensor:
    """(4x4 m) @ [xyz; 1] for xyz [..., 3, N], first three rows; m float32 on
    the host, applied in float64."""
    m = torch.from_numpy(m.astype(np.float64)).to(xyz.device)
    return m[:3, :3] @ xyz + m[:3, 3:4]


def _apply(m: np.ndarray, xyz: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(m.astype(np.float64)).to(xyz.device) @ xyz


def _pixel_grid(height: int, width: int, device: torch.device):
    y, x = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=device),
                          torch.arange(width, dtype=torch.float64, device=device), indexing="ij")
    return x.reshape(-1), y.reshape(-1)


def _sample(depth_src: torch.Tensor, x_src: torch.Tensor, y_src: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of depth_src [S, H, W] at pixel coordinates x_src,
    y_src [S, N] (float32 values), zeros outside; non-finite coordinates
    read 0. Returns [S, N] float32."""
    S, H, W = depth_src.shape
    gx = x_src.double() * (2.0 / (W - 1)) - 1.0
    gy = y_src.double() * (2.0 / (H - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)
    # Out of range (beyond 4 is more than a pixel outside, for W, H >= 2),
    # so every tap reads the zero padding.
    grid = torch.nan_to_num(grid, nan=-4.0, posinf=4.0, neginf=-4.0).clamp(-4.0, 4.0)
    out = F.grid_sample(depth_src[:, None].double(), grid[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[:, 0, 0].float()


def reproject_with_depth(depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src):
    """Ref -> src -> ref round trip of every reference pixel through each of S
    sources. depth_ref [H, W] and depth_src [S, H, W] float32 tensors on one
    device; intrinsics [3, 3] / [S, 3, 3] and extrinsics [4, 4] / [S, 4, 4]
    float32 numpy. Returns (depth_reprojected, x_reproj, y_reproj, x_src,
    y_src), each [S, H, W] float32."""
    S, height, width = depth_src.shape
    x_ref, y_ref = _pixel_grid(height, width, depth_ref.device)
    d_ref = depth_ref.reshape(-1).double()
    xyz_ref = _apply(np.linalg.inv(intr_ref), torch.stack([x_ref * d_ref, y_ref * d_ref, d_ref]))
    outs = []
    for s in range(S):
        xyz_src = _homogeneous(extr_src[s] @ np.linalg.inv(extr_ref), xyz_ref)
        k_xyz_src = _apply(intr_src[s], xyz_src)
        outs.append(k_xyz_src[:2] / k_xyz_src[2:3])
    xy_src = torch.stack(outs)  # [S, 2, N] float64
    x_src, y_src = xy_src[:, 0].float(), xy_src[:, 1].float()
    sampled = _sample(depth_src, x_src, y_src).double()  # [S, N]

    depth_reproj, x_reproj, y_reproj = [], [], []
    ones = torch.ones_like(x_ref)
    for s in range(S):
        pts = torch.stack([xy_src[s, 0], xy_src[s, 1], ones]) * sampled[s]
        xyz_src2 = _apply(np.linalg.inv(intr_src[s]), pts)
        xyz_reproj = _homogeneous(extr_ref @ np.linalg.inv(extr_src[s]), xyz_src2)
        k_xyz_reproj = _apply(intr_ref, xyz_reproj)
        xy_reproj = k_xyz_reproj[:2] / (k_xyz_reproj[2:3] + 1e-12)
        depth_reproj.append(xyz_reproj[2].float())
        x_reproj.append(xy_reproj[0].float())
        y_reproj.append(xy_reproj[1].float())
    shape = (S, height, width)
    return (torch.stack(depth_reproj).reshape(shape), torch.stack(x_reproj).reshape(shape),
            torch.stack(y_reproj).reshape(shape), x_src.reshape(shape), y_src.reshape(shape))


def _distances(depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src):
    """(reprojection distance float64, relative depth difference float32,
    reprojected depth), each [S, H, W]."""
    S, height, width = depth_src.shape
    depth_reproj, x_reproj, y_reproj, _, _ = reproject_with_depth(
        depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src)
    x_ref, y_ref = _pixel_grid(height, width, depth_ref.device)
    dist = torch.sqrt((x_reproj.double() - x_ref.reshape(height, width)) ** 2
                      + (y_reproj.double() - y_ref.reshape(height, width)) ** 2)
    relative = (depth_reproj - depth_ref).abs() / depth_ref.clamp_min(1e-12)
    return dist, relative, depth_reproj


def check_geometric_consistency(depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src,
                                dist_scale: float = 1.0, rel_diff_scale: float = 1.0):
    """The dynamic ladder for S sources at once. Returns (masks [9, S, H, W]
    for i = 2..10, the i = 10 mask [S, H, W], depth_reprojected [S, H, W]
    zeroed off that mask)."""
    dist, relative, depth_reproj = _distances(depth_ref, intr_ref, extr_ref, depth_src, intr_src,
                                              extr_src)
    masks = torch.stack([(dist < dist_scale * i / 4) & (relative < rel_diff_scale * i / 1300)
                         for i in LADDER])
    mask = masks[-1]
    return masks, mask, torch.where(mask, depth_reproj, torch.zeros_like(depth_reproj))


def check_geometric_consistency_fixed(depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src,
                                      pixel_thres: float = 1.0, depth_thres: float = 0.01):
    """The "normal" test for S sources at once: mask = (reprojection distance
    < pixel_thres px) and (relative depth difference < depth_thres). Returns
    (mask [S, H, W], depth_reprojected zeroed off the mask)."""
    dist, relative, depth_reproj = _distances(depth_ref, intr_ref, extr_ref, depth_src, intr_src,
                                              extr_src)
    mask = (dist < pixel_thres) & (relative < depth_thres)
    return mask, torch.where(mask, depth_reproj, torch.zeros_like(depth_reproj))


def _fit_image_to_grid(img: torch.Tensor, grid_hw: tuple[int, int]):
    """Rescale and centre-crop an image [H, W, 3] onto the confidence/depth
    grid, returning (image, scale, crop index, crop axis flag), with the
    reference's int() truncations (dynamic_fusion.py:162-176)."""
    gh, gw = grid_hw
    scale = float(gh) / img.shape[0]
    index = int((int(img.shape[1] * scale) - gw) / 2)
    index_p = (int(img.shape[1] * scale) - gw) - index
    flag = 0
    if gw / img.shape[1] > scale:
        scale = float(gw) / img.shape[1]
        index = int((int(img.shape[0] * scale) - gh) / 2)
        index_p = (int(img.shape[0] * scale) - gh) - index
        flag = 1
    img = resize_bilinear(img, (int(img.shape[0] * scale), int(img.shape[1] * scale)))
    if flag == 0:
        img = img[:, index : img.shape[1] - index_p, :]
    else:
        img = img[index : img.shape[0] - index_p, :, :]
    return img, scale, index, flag


def _read_depth(scan_folder: str, kind: str, view: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(read_pfm(os.path.join(scan_folder, f"{kind}/{view:0>8}.pfm"))[0].copy()).to(device)


def fuse_view(scan_folder: str, ref_view: int, src_views: list[int], params: FusionParams,
              device: torch.device, out_mask_folder: str | None = None):
    """One reference view's fused points on ``device``: (xyz [N, 3] float64,
    rgb [N, 3] uint8, the kept pixels [H, W] bool, row-major order of the
    points)."""
    ref_img_path = os.path.join(scan_folder, f"images/{ref_view:0>8}.jpg")
    if not os.path.exists(ref_img_path):
        ref_img_path = os.path.join(scan_folder, f"images/{ref_view:0>8}.png")
    ref_depth = _read_depth(scan_folder, "depth_est", ref_view, device)
    confidence = _read_depth(scan_folder, "confidence", ref_view, device)
    ref_img, scale, index, flag = _fit_image_to_grid(read_image(ref_img_path, device),
                                                     tuple(confidence.shape[:2]))
    intr_ref, extr_ref = _read_fusion_cam(
        os.path.join(scan_folder, f"cams/{ref_view:0>8}_cam.txt"), scale, index, flag)
    photo_mask = confidence > params.photo_threshold

    src_cams = [_read_fusion_cam(os.path.join(scan_folder, f"cams/{v:0>8}_cam.txt"), scale, index, flag)
                for v in src_views]
    intr_src = np.stack([c[0] for c in src_cams])
    extr_src = np.stack([c[1] for c in src_cams])
    depth_src = torch.stack([_read_depth(scan_folder, "depth_est", v, device) for v in src_views])
    args = (ref_depth, intr_ref, extr_ref, depth_src, intr_src, extr_src)
    n = len(src_views) + 1
    if params.mode == "normal":
        geo_masks, depth_reproj = check_geometric_consistency_fixed(
            *args, pixel_thres=params.geo_pixel_thres, depth_thres=params.geo_depth_thres)
    else:
        masks, geo_masks, depth_reproj = check_geometric_consistency(
            *args, dist_scale=params.dist_scale, rel_diff_scale=params.rel_diff_scale)
    geo_mask_sum = geo_masks.sum(dim=0, dtype=torch.int32)
    geo_mask = geo_mask_sum >= params.thres_view
    if params.mode != "normal":
        ladder_sums = masks.sum(dim=1, dtype=torch.int32)  # [rungs, H, W]
        for i in range(2, min(n, LADDER.stop)):
            geo_mask |= ladder_sums[i - 2] >= i
    depth_accum = torch.zeros_like(ref_depth)
    for s in range(len(src_views)):  # float32, in the JAX fuser's order
        depth_accum = depth_accum + depth_reproj[s]
    depth_avg = (depth_accum + ref_depth).double() / (geo_mask_sum + 1).double()
    final_mask = photo_mask & geo_mask

    if out_mask_folder:
        os.makedirs(out_mask_folder, exist_ok=True)
        for name, m in [("photo", photo_mask), ("geo", geo_mask), ("final", final_mask)]:
            write_png(os.path.join(out_mask_folder, f"{ref_view:0>8}_{name}.png"),
                      m.cpu().numpy().astype(np.uint8) * 255)

    height, width = depth_avg.shape
    x, y = _pixel_grid(height, width, device)
    valid = final_mask.reshape(-1)
    xv, yv, dv = x[valid], y[valid], depth_avg.reshape(-1)[valid]
    xyz_ref = _apply(np.linalg.inv(intr_ref), torch.stack([xv * dv, yv * dv, dv]))
    xyz_world = _homogeneous(np.linalg.inv(extr_ref), xyz_ref)
    color = (ref_img[final_mask] * 255).to(torch.uint8)
    return xyz_world.T, color, final_mask


def fuse_scan(
    scan_folder: str,
    out_ply: str,
    params: FusionParams = FusionParams(),
    pair_path: str | None = None,
    out_mask_folder: str | None = None,
    ref_views: list[int] | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Fuse one scan's depth maps into a coloured point cloud on ``device``.

    Args:
      scan_folder: folder with depth_est/, confidence/, cams/, images/.
      out_ply: output path ('' to skip writing).
      ref_views: optional subset of reference views.

    Returns: (xyz [N, 3] float64, rgb [N, 3] uint8), numpy.
    """
    device = resolve_device(device)
    pair_data = read_pair_file(pair_path or os.path.join(scan_folder, "pair.txt"))
    if ref_views is not None:
        keep = set(ref_views)
        pair_data = [(r, s) for r, s in pair_data if r in keep]
    vertexs, colors = [], []
    for ref_view, src_views in pair_data:
        xyz, rgb, _ = fuse_view(scan_folder, ref_view, src_views, params, device, out_mask_folder)
        vertexs.append(xyz.cpu().numpy())
        colors.append(rgb.cpu().numpy())
    xyz = np.concatenate(vertexs, axis=0) if vertexs else np.zeros((0, 3), np.float32)
    rgb = np.concatenate(colors, axis=0) if colors else np.zeros((0, 3), np.uint8)
    if out_ply:
        os.makedirs(os.path.dirname(out_ply) or ".", exist_ok=True)
        write_ply(out_ply, xyz, rgb)
    return xyz, rgb


def fuse_scans(
    testpath: str,
    scans: list[str],
    outdir: str,
    params: FusionParams = FusionParams(),
    dataset: str = "dtu",
    device: str | torch.device = "cuda",
    num_workers: int = 8,
) -> list[str]:
    """Fuse scans on ``device``, up to ``num_workers`` at once; returns the
    output paths in ``scans``' order. Each scan's arithmetic does not depend
    on the worker count, so its PLY is byte-identical at every count.

    Workers are spawned processes, each with its own interpreter and, on
    CUDA, its own context: threads hold one interpreter lock through the
    host's share of a scan (PFM reads, PLY writes, torch's dispatch), and
    so gained little. A process costs seconds to start (its imports and
    context), so one worker, or one scan, runs in this process. The
    parent builds the CUDA libraries before it spawns, and the children
    take its torch thread count. The first failing scan's exception is
    raised; the scans not yet handed to a worker are cancelled.

    DTU naming: mvsnet{scanid:03d}_l3.ply (the DTU evaluator's, reference
    DTU-MATLAB/BaseEvalMain_web.m:34); otherwise <scan>.ply."""
    from transmvsnet_tpu_torch.eval.dtu_eval import dtu_ply_name

    device = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    jobs = []
    for scan in scans:
        if dataset == "dtu" and scan.startswith("scan"):
            out_ply = os.path.join(outdir, dtu_ply_name(int(scan[4:])))
        else:
            out_ply = os.path.join(outdir, f"{scan}.ply")
        jobs.append((os.path.join(testpath, scan), out_ply, params, device))
    workers = min(num_workers, len(jobs))
    if workers <= 1:
        return [_fuse_job(job) for job in jobs]
    if device.type == "cuda":
        from transmvsnet_tpu_torch.ops.cuda import build

        build.build_all()
    with futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                     initializer=torch.set_num_threads,
                                     initargs=(torch.get_num_threads(),)) as pool:
        pending = [pool.submit(_fuse_job, job) for job in jobs]
        futures.wait(pending, return_when=futures.FIRST_EXCEPTION)
        failed = [f for f in pending if f.done() and f.exception() is not None]
        if failed:
            for f in pending:
                f.cancel()
            raise failed[0].exception()
        return [f.result() for f in pending]


def _fuse_job(job: tuple[str, str, FusionParams, torch.device]) -> str:
    scan_folder, out_ply, params, device = job
    fuse_scan(scan_folder, out_ply, params, device=device)
    return out_ply
