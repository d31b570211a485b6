"""The native fuser's consistency test for one reference view in plain
PyTorch: the plain version of the CUDA kernel ``csrc/native_fuse.cu``
(``ops/cuda/native_fuse.py``), and the float32 camera and sampling steps
it is made of, each in the binary's expression order
(``native/fuser/fuser.cpp``).

A view's camera is 30 float32 (``CAM_FLOATS``): R (9, row-major), t (3),
K (9), K^-1 (9). Every product and sum is rounded on its own, as the kernel
rounds it, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

CAM_FLOATS = 30  # R (9, row-major), t (3), K (9), K^-1 (9), float32


def camera(cams: torch.Tensor, view: int):
    """View ``view``'s (R [9], t [3], K [9], K^-1 [9]) from a cams tensor
    [V, 30], float32 on its device."""
    c = cams[view]
    return c[0:9], c[9:12], c[12:21], c[21:30]


def unproject(cam, u: torch.Tensor, v: torch.Tensor, depth: torch.Tensor):
    """World points R^T (depth K^-1 [u v 1] - t) (fuser.cpp:155-164), in
    float32; cam as ``camera`` gives it."""
    R, t, _, Ki = cam
    xc = depth * (Ki[0] * u + Ki[1] * v + Ki[2])
    yc = depth * (Ki[3] * u + Ki[4] * v + Ki[5])
    zc = depth * (Ki[6] * u + Ki[7] * v + Ki[8])
    dx, dy, dz = xc - t[0], yc - t[1], zc - t[2]
    return (R[0] * dx + R[3] * dy + R[6] * dz, R[1] * dx + R[4] * dy + R[7] * dz,
            R[2] * dx + R[5] * dy + R[8] * dz)


def project(cam, X):
    """(u, v, z, in_front) of world points X in a camera (fuser.cpp:166-178):
    in_front is false where z <= 1e-6, and u, v are then meaningless."""
    R, t, K, _ = cam
    xc = R[0] * X[0] + R[1] * X[1] + R[2] * X[2] + t[0]
    yc = R[3] * X[0] + R[4] * X[1] + R[5] * X[2] + t[1]
    zc = R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + t[2]
    uu = K[0] * xc + K[1] * yc + K[2] * zc
    vv = K[3] * xc + K[4] * yc + K[5] * zc
    return uu / zc, vv / zc, zc, ~(zc <= 1e-6)


def bilinear_taps(h: int, w: int, x: torch.Tensor, y: torch.Tensor):
    """(inside, (i00, i01, i10, i11), wx, wy) of a bilinear sample of a
    row-major map [h*w] at x, y (fuser.cpp:180-187): inside is false
    wherever x < 0, y < 0, x > w - 1 or y > h - 1 (a NaN coordinate too),
    and its taps are then pixel 0; the +1 taps are clamped to the last
    column and row."""
    inside = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    x = torch.where(inside, x, torch.zeros_like(x))
    y = torch.where(inside, y, torch.zeros_like(y))
    x0, y0 = x.to(torch.int64), y.to(torch.int64)  # truncation, x, y >= 0
    x1, y1 = (x0 + 1).clamp_max(w - 1), (y0 + 1).clamp_max(h - 1)
    wx, wy = x - x0.to(torch.float32), y - y0.to(torch.float32)
    return inside, (y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1), wx, wy


def sample_bilinear(img: torch.Tensor, h: int, w: int, x: torch.Tensor, y: torch.Tensor):
    """(samples, inside) of a row-major float32 map [h*w] at x, y, with
    explicit gathers at ``bilinear_taps``: 0 wherever the sample is not
    inside. Unlike ``grid_sample``'s zeros padding, no partial taps beyond a
    border."""
    inside, (i00, i01, i10, i11), wx, wy = bilinear_taps(h, w, x, y)
    value = (img[i00] * (1 - wx) * (1 - wy) + img[i01] * wx * (1 - wy)
             + img[i10] * (1 - wx) * wy + img[i11] * wx * wy)
    return torch.where(inside, value, torch.zeros_like(value)), inside


def native_fuse_view_plain(
    depths: torch.Tensor,
    offsets: torch.Tensor,
    sizes: torch.Tensor,
    cams: torch.Tensor,
    ref: int,
    ref_hw: tuple[int, int],
    srcs: torch.Tensor,
    fbs: torch.Tensor,
    min_depth: float,
    max_depth: float,
    disp_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, arguments and results as
    ``ops/cuda/native_fuse.py::native_fuse``: vectorised over the reference
    pixels, a loop over the sources, float32 with every operation rounded
    in the binary's order."""
    h, w = ref_hw
    offs, hw = offsets.tolist(), sizes.tolist()
    dev = depths.device
    d = depths[offs[ref] : offs[ref] + h * w]
    lo, hi, thr = (torch.tensor(x, dtype=torch.float32).item() for x in (min_depth, max_depth, disp_threshold))
    valid = (d > lo) & (d < hi) & (d > 0)  # a NaN depth fails all three
    y, x = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    cam_ref = camera(cams, ref)
    X = unproject(cam_ref, x.reshape(-1).float(), y.reshape(-1).float(), d)
    acc = list(X)
    count = torch.ones(h * w, dtype=torch.int32, device=dev)
    for s, sv in enumerate(srcs.tolist()):
        cam = camera(cams, sv)
        u, v, z, in_front = project(cam, X)
        sh, sw = hw[sv]
        dsv, _ = sample_bilinear(depths[offs[sv] : offs[sv] + sh * sw], sh, sw, u, v)
        agree = in_front & ~(dsv <= 0) & ((fbs[s] / z - fbs[s] / dsv).abs() < thr)
        Xs = unproject(cam, u, v, dsv)
        acc = [torch.where(agree, a + b, a) for a, b in zip(acc, Xs)]
        count = count + agree.to(torch.int32)
    count = torch.where(valid, count, torch.zeros_like(count))
    point = torch.stack([a / count.float() for a in acc], dim=-1)
    point = torch.where(valid[:, None], point, torch.zeros_like(point))
    return count.reshape(h, w), point.reshape(h, w, 3)
