"""The native fuser (``--filter_method native``, the role of the
reference's CUDA fusibile, reference gipuma.py) on the device: the port's
counterpart of the JAX package's ``fusion/native.py`` and its C++ binary
``native/fuser/fuser.cpp``, with the binary's per-pixel loop as the CUDA
kernel ``csrc/native_fuse.cu`` (``ops/cuda/native_fuse.py``) and its plain
version (``ops/native_fuse.py``); here the scan's I/O, the compaction of
the kept pixels and the PLY.

For every reference pixel with depth d, min_depth < d < max_depth and d > 0,
the pixel is unprojected to a world point X; each source of pair.txt's
list projects X (rejected where its depth there is <= 1e-6), samples its
own depth map bilinearly there (``ops/native_fuse.sample_bilinear``: 0
outside the image, the last column and row clamped; rejected where <= 0)
and agrees where the
disparities f·b/z and f·b/d_sampled differ by less than disp_threshold (f
the source's fx, b the distance between the camera centres). An agreeing
source adds its own unprojected point; a pixel that at least
num_consistent views agree on (itself included) is emitted as the mean of
those points, coloured from its reference image (white without one).

Inputs per scan folder, the binary's: depth_est/NNNNNNNN.pfm, cams/
NNNNNNNN_cam.txt (extrinsic 4x4 and intrinsic 3x3, read raw), pair.txt
(entries without sources dropped), and images/NNNNNNNN.ppm where it exists.
A view lacking its PFM or its cam file is skipped as a reference and as a
source. Points come out in pair.txt's order, row-major within a reference
view (a reference listed twice emits its points twice). ``native_fuse_scans``
also takes the pipeline's images/NNNNNNNN.jpg or .png where no .ppm exists
(decoded in memory through ``data/image_io.read_image``), the role of the
JAX package's ``ensure_ppm_images``. A colour image is indexed at the depth
map's (y, x) with its own row stride, as the binary indexes it; one smaller
than its depth map raises.

Each scan's depth maps and cameras go to the device once. The camera
quantities are computed on the host in float32 in the binary's expression
order (K^-1 by ``invert3``'s cofactors, C = -R^T t); the per-pixel
arithmetic rounds every product and sum (the binary, built with g++ -O3
-march=native, may contract some into fused multiply-adds: an ulp apart).

One departure: a NaN reference depth passes the binary's range test and
reads out of bounds; here it is rejected, as any depth outside the range.
A NaN source depth agrees with nothing, in both.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np
import torch

from transmvsnet_tpu_torch.data.cams import read_pair_file
from transmvsnet_tpu_torch.data.image_io import read_image
from transmvsnet_tpu_torch.data.pfm import read_pfm
from transmvsnet_tpu_torch.fusion.ply import write_ply
from transmvsnet_tpu_torch.models.blocks import resolve_device
from transmvsnet_tpu_torch.ops.cuda.native_fuse import native_fuse
from transmvsnet_tpu_torch.ops.native_fuse import CAM_FLOATS

F32 = np.float32


# --- The binary's host side: cameras and images ---------------------------


def invert3(m: np.ndarray) -> np.ndarray:
    """3x3 inverse by cofactors in float32, in fuser.cpp's order (:110-125).
    m and the result: 9 float32, row-major."""
    a, b, c, d, e, ff, g, h, i = (F32(x) for x in m)
    det = a * (e * i - ff * h) - b * (d * i - ff * g) + c * (d * h - e * g)
    inv = F32(1.0) / det
    return np.array([(e * i - ff * h) * inv, (c * h - b * i) * inv, (b * ff - c * e) * inv,
                     (ff * g - d * i) * inv, (a * i - c * g) * inv, (c * d - a * ff) * inv,
                     (d * h - e * g) * inv, (b * g - a * h) * inv, (a * e - b * d) * inv], F32)


def read_native_cam(path: str) -> np.ndarray | None:
    """A cam file as fuser.cpp's ``read_cam`` reads it (:127-148): float32
    [30] = R (9), t (3), K (9), K^-1 (9), with no scaling; None where the
    file is missing or its "extrinsic"/"intrinsic" tags are not where they
    belong."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        tok = f.read().split()
    if len(tok) < 27 or tok[0] != "extrinsic" or tok[17] != "intrinsic":
        return None
    E = np.array([float(x) for x in tok[1:17]], F32).reshape(4, 4)
    K = np.array([float(x) for x in tok[18:27]], F32)
    return np.concatenate([E[:3, :3].reshape(-1), E[:3, 3], K, invert3(K)])


def camera_centre(cam: np.ndarray) -> np.ndarray:
    """C = -R^T t in float32 (fuser.cpp:143-146)."""
    R, t = cam[:9], cam[9:12]
    return np.array([-(R[r] * t[0] + R[3 + r] * t[1] + R[6 + r] * t[2]) for r in range(3)], F32)


def disparity_scale(ref_cam: np.ndarray, src_cam: np.ndarray) -> np.float32:
    """f·b of a source: its fx times the distance between the two camera
    centres, in float32 (fuser.cpp:191-194, :319-320)."""
    d = camera_centre(ref_cam) - camera_centre(src_cam)
    return src_cam[12] * np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


def read_ppm(path: str) -> np.ndarray | None:
    """A binary PPM (P6, 8-bit) as uint8 [H, W, 3], as fuser.cpp's
    ``read_ppm`` takes it (:91-108): magic, width, height and maxval split
    by whitespace, then one whitespace byte. None where the file is missing
    or not P6 (the binary then leaves the points white)."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    m = re.match(rb"\s*P6\s+(\d+)\s+(\d+)\s+(\d+)\s", data)
    if m is None:
        if re.match(rb"\s*P6\s", data):
            raise ValueError(f"{path}: malformed PPM header")
        return None
    w, h, maxval = (int(g) for g in m.groups())
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PPM (maxval {maxval}) is not read")
    return np.frombuffer(data, np.uint8, count=h * w * 3, offset=m.end()).reshape(h, w, 3)


def colour_bytes(img: torch.Tensor) -> torch.Tensor:
    """``read_image``'s float32 [0, 1] colours back to bytes as the binary
    writes them, (uint8)(v * 255.0f) (fuser.cpp:337-339): every byte
    unchanged."""
    return (img * 255.0).to(torch.uint8)


# --- Scans on the device --------------------------------------------------


@dataclass
class NativeScan:
    """One scan's loaded views on the device, indexed by view id: the
    arguments of ``native_fuse`` and, per pair.txt entry whose reference is
    loaded, its loaded sources and their f·b."""

    folder: str
    depths: torch.Tensor  # float32 [sum h*w]
    offsets: torch.Tensor  # int64 [V]
    sizes: torch.Tensor  # int32 [V, 2]
    cams: torch.Tensor  # float32 [V, CAM_FLOATS]
    hw: dict[int, tuple[int, int]]  # loaded view -> (h, w), on the host
    entries: list[tuple[int, torch.Tensor, torch.Tensor]]  # (ref, srcs int32 [S], fbs float32 [S])
    pipeline_images: bool  # also the pipeline's JPEGs and PNGs, where no PPM exists

    def colour(self, view: int) -> torch.Tensor | None:
        """The view's RGB bytes [H, W, 3] on the device, or None (white)."""
        device = self.depths.device
        ppm = read_ppm(os.path.join(self.folder, f"images/{view:0>8}.ppm"))
        if ppm is not None:
            return torch.from_numpy(ppm.copy()).to(device)
        if self.pipeline_images:
            for ext in (".jpg", ".png"):
                path = os.path.join(self.folder, f"images/{view:0>8}{ext}")
                if os.path.exists(path):
                    return colour_bytes(read_image(path, device))
        return None


def load_scan(scan_folder: str, device: str | torch.device, pipeline_images: bool = False) -> NativeScan:
    """pair.txt, and every view it names that has both its PFM and its cam
    file, on ``device`` at once (fuser.cpp:260-293)."""
    device = torch.device(device)
    pairs = read_pair_file(os.path.join(scan_folder, "pair.txt"))
    if not pairs:
        raise ValueError(f"{scan_folder}/pair.txt lists no view with sources")
    num_views = 1 + max(max(r, *s) for r, s in pairs)
    cams = np.zeros((num_views, CAM_FLOATS), F32)
    offsets = np.zeros(num_views, np.int64)
    sizes = np.zeros((num_views, 2), np.int32)
    maps, hw, total = [], {}, 0
    for v in range(num_views):
        pfm = os.path.join(scan_folder, f"depth_est/{v:0>8}.pfm")
        cam = read_native_cam(os.path.join(scan_folder, f"cams/{v:0>8}_cam.txt"))
        if cam is None or not os.path.exists(pfm):
            continue
        depth = read_pfm(pfm)[0]
        if depth.ndim == 3:  # a colour PFM: the binary reads its first channel
            depth = depth[..., 0]
        cams[v], offsets[v], sizes[v] = cam, total, depth.shape
        hw[v] = depth.shape
        maps.append(np.ascontiguousarray(depth, F32).reshape(-1))
        total += depth.size
    # Every entry's loaded sources and f·b in one table, copied to the
    # device once and cut per entry.
    refs, srcs_flat, fbs_flat, cut = [], [], [], [0]
    for ref, srcs in pairs:
        if ref in hw:
            loaded = [s for s in srcs if s in hw]
            refs.append(ref)
            srcs_flat += loaded
            fbs_flat += [disparity_scale(cams[ref], cams[s]) for s in loaded]
            cut.append(len(srcs_flat))
    srcs_dev = torch.tensor(srcs_flat, dtype=torch.int32, device=device)
    fbs_dev = torch.from_numpy(np.array(fbs_flat, F32)).to(device)
    entries = [(ref, srcs_dev[cut[i] : cut[i + 1]], fbs_dev[cut[i] : cut[i + 1]]) for i, ref in enumerate(refs)]
    depths = torch.from_numpy(np.concatenate(maps) if maps else np.zeros(0, F32))
    return NativeScan(scan_folder, depths.to(device), torch.from_numpy(offsets).to(device),
                      torch.from_numpy(sizes).to(device), torch.from_numpy(cams).to(device), hw, entries,
                      pipeline_images)


def fuse_entry(scan: NativeScan, ref: int, srcs: torch.Tensor, fbs: torch.Tensor, disp_threshold: float,
               num_consistent: int, min_depth: float, max_depth: float):
    """One reference view's kept points: (xyz float32 [N, 3], rgb uint8
    [N, 3]) on the scan's device, row-major."""
    h, w = scan.hw[ref]
    count, xyz = native_fuse(scan.depths, scan.offsets, scan.sizes, scan.cams, ref, (h, w), srcs, fbs,
                             min_depth, max_depth, disp_threshold)
    keep = (count >= max(num_consistent, 1)).reshape(-1).nonzero().squeeze(1)
    img = scan.colour(ref)
    if img is None:
        rgb = torch.full((len(keep), 3), 255, dtype=torch.uint8, device=keep.device)
    else:
        if img.shape[0] < h or img.shape[1] < w:
            raise ValueError(f"{scan.folder}: image {ref} is {tuple(img.shape[:2])}, smaller than its "
                             f"depth map {(h, w)}")
        rgb = img[:h, :w].reshape(-1, 3)[keep]
    return xyz.reshape(-1, 3)[keep], rgb


def _fuse_scan(scan_folder: str, out_ply: str, disp_threshold: float, num_consistent: int,
               min_depth: float, max_depth: float, device: torch.device, pipeline_images: bool) -> str:
    scan = load_scan(scan_folder, device, pipeline_images)
    points = [fuse_entry(scan, ref, srcs, fbs, disp_threshold, num_consistent, min_depth, max_depth)
              for ref, srcs, fbs in scan.entries]
    xyz = torch.cat([p[0] for p in points]).cpu().numpy() if points else np.zeros((0, 3), F32)
    rgb = torch.cat([p[1] for p in points]).cpu().numpy() if points else np.zeros((0, 3), np.uint8)
    os.makedirs(os.path.dirname(out_ply) or ".", exist_ok=True)
    write_ply(out_ply, xyz, rgb)
    return out_ply


def native_fuse_scan(
    scan_folder: str,
    out_ply: str,
    disp_threshold: float = 0.25,
    num_consistent: int = 3,
    min_depth: float = 0.0,
    max_depth: float = 1e9,
    device: str | torch.device = "cuda",
) -> str:
    """Fuse one scan into ``out_ply`` on ``device``, as the binary does
    (colours from images/*.ppm only). Returns out_ply."""
    return _fuse_scan(scan_folder, out_ply, disp_threshold, num_consistent, min_depth, max_depth,
                      resolve_device(device), pipeline_images=False)


def native_fuse_scans(
    testpath: str,
    scans: list[str],
    outdir: str,
    disp_threshold: float = 0.25,
    num_consistent: int = 3,
    dataset: str = "dtu",
    device: str | torch.device = "cuda",
) -> list[str]:
    """Fuse scans one after another on ``device`` (the gipuma_filter role,
    reference gipuma.py:14-21), colours also from the pipeline's JPEGs or
    PNGs. DTU naming: mvsnet{scanid:03d}_l3.ply; otherwise <scan>.ply."""
    from transmvsnet_tpu_torch.eval.dtu_eval import dtu_ply_name

    device = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    outputs = []
    for scan in scans:
        if dataset == "dtu" and scan.startswith("scan"):
            out_ply = os.path.join(outdir, dtu_ply_name(int(scan[4:])))
        else:
            out_ply = os.path.join(outdir, f"{scan}.ply")
        outputs.append(_fuse_scan(os.path.join(testpath, scan), out_ply, disp_threshold, num_consistent, 0.0,
                                  1e9, device, pipeline_images=True))
    return outputs
