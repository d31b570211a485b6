"""The port's fuser (``fusion/dynamic.py``, torch, here on CPU tensors)
against the JAX package's ``fuse_scan`` on the same scan files, for the
"dynamic" ladder and the "normal" filter, and its PLY writer against the
JAX reader.

The scans: the synthetic scene of ``tests/test_fusion_eval.py`` (4 views,
64x96) with its true depth maps, and a "noisy" copy whose depths carry
0.4% noise (so the ladder's rungs decide), random confidences, and a
block of zero depth in every view (what infer writes below confidence
0.01), whose reprojection gives 0/0 source coordinates.

The JAX fuser samples the source depth with ``cv2.remap``, which in
OpenCV releases before 5 rounds the position to 1/32 px; the port samples
exactly. So the comparison is made twice: with ``cv2.remap`` patched, here
only, to exact bilinear sampling in numpy (masks equal, points equal to
float64 rounding), and against the unpatched fuser, where a stated share
of pixels may flip at the thresholds.
"""

import os
import shutil
import types

import cv2
import numpy as np
import pytest
import torch

from transmvsnet_tpu.data.cams import write_cam_file
from transmvsnet_tpu.data.pfm import save_pfm
from transmvsnet_tpu.data.synthetic import SyntheticScene
from transmvsnet_tpu.fusion import dynamic as jax_dynamic
from transmvsnet_tpu.fusion.ply import read_ply as jax_read_ply
from transmvsnet_tpu_torch.data.image_io import read_png
from transmvsnet_tpu_torch.fusion import dynamic
from transmvsnet_tpu_torch.fusion.ply import read_ply, write_ply

MODES = {
    "dynamic": dict(photo_threshold=0.3, thres_view=2),
    "normal": dict(photo_threshold=0.3, thres_view=2, mode="normal"),
}
# Unpatched cv2.remap: share of reference pixels whose accepted/rejected
# verdict may differ (1/32-px sampling near the thresholds). With OpenCV
# 5.0.0, whose remap interpolates float maps exactly, none of the noisy
# scan's 4 x 64 x 96 pixels differs in either mode.
UNPATCHED_FLIP_SHARE = 0.005


def _write_scan(root, noisy: bool):
    scene = SyntheticScene(num_views=4, height=64, width=96)
    rng = np.random.RandomState(5)
    for sub in ("depth_est", "confidence", "cams", "images"):
        os.makedirs(root / sub)
    for v in range(scene.V):
        img, depth = scene.render(v)
        conf = np.ones_like(depth)
        if noisy:
            depth = (depth * (1 + 0.004 * rng.randn(*depth.shape))).astype(np.float32)
            depth[20:30, 10 + 5 * v : 40 + 5 * v] = 0.0
            conf = rng.rand(*depth.shape).astype(np.float32)
        save_pfm(str(root / f"depth_est/{v:0>8}.pfm"), depth)
        save_pfm(str(root / f"confidence/{v:0>8}.pfm"), conf)
        pair = np.zeros((2, 4, 4), dtype=np.float32)
        pair[0] = scene.extrinsics[v]
        pair[1, :3, :3] = scene.K
        write_cam_file(str(root / f"cams/{v:0>8}_cam.txt"), pair, "1.0 0.01")
        cv2.imwrite(str(root / f"images/{v:0>8}.jpg"),
                    cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    with open(root / "pair.txt", "w") as f:
        f.write(f"{scene.V}\n")
        for v in range(scene.V):
            others = [o for o in range(scene.V) if o != v]
            f.write(f"{v}\n{len(others)} " + " ".join(f"{o} 10.0" for o in others) + "\n")
    return scene


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("fusion")
    for name in ("clean", "noisy"):
        _write_scan(root / name, noisy=name == "noisy")
    return root


def _exact_remap(src, map_x, map_y, interpolation):
    """cv2.remap's function without its 1/32-px rounding: bilinear in
    float64 at the float32 positions, zeros outside, 0 at non-finite
    positions."""
    H, W = src.shape
    x, y = map_x.astype(np.float64), map_y.astype(np.float64)
    bad = ~(np.isfinite(x) & np.isfinite(y))
    x, y = np.where(bad, -10.0, x), np.where(bad, -10.0, y)
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0
    out = np.zeros(x.shape)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = (x0 + dx).astype(np.int64), (y0 + dy).astype(np.int64)
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            out += wy * wx * np.where(inside, src[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)], 0.0)
    return out.astype(np.float32)


def _run_both(scan_dir, tmp_path, mode, patched, monkeypatch):
    """(port xyz, rgb, final mask per view; JAX the same)."""
    params = dict(MODES[mode])
    if patched:
        shim = types.SimpleNamespace(**{k: getattr(cv2, k) for k in dir(cv2) if not k.startswith("__")})
        shim.remap = _exact_remap
        monkeypatch.setattr(jax_dynamic, "cv2", shim)
    theirs = jax_dynamic.fuse_scan(str(scan_dir), "", jax_dynamic.FusionParams(**params),
                                   out_mask_folder=str(tmp_path / "jax_masks"))
    ours = dynamic.fuse_scan(str(scan_dir), "", dynamic.FusionParams(**params),
                             out_mask_folder=str(tmp_path / "masks"), device="cpu")
    masks = [np.stack([read_png(str(tmp_path / d / f"{v:0>8}_final.png")) for v in range(4)])
             for d in ("masks", "jax_masks")]
    return ours, theirs, masks


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("scan", ["clean", "noisy"])
def test_matches_jax_with_exact_remap(scans, tmp_path, monkeypatch, mode, scan):
    (xyz, rgb), (jxyz, jrgb), (mask, jmask) = _run_both(scans / scan, tmp_path, mode, True, monkeypatch)
    np.testing.assert_array_equal(mask, jmask)
    assert 0.2 < mask.mean() / 255 < 1.0
    assert xyz.shape == jxyz.shape and xyz.dtype == np.float64
    np.testing.assert_allclose(xyz, jxyz, rtol=1e-9, atol=1e-9)
    # Colours: the port decodes with PIL, the JAX fuser with cv2.imread
    # (both libjpeg; equal here), truncated after the same float product.
    assert np.abs(rgb.astype(int) - jrgb.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_matches_unpatched_jax_within_share(scans, tmp_path, monkeypatch, mode):
    (xyz, _), (jxyz, _), (mask, jmask) = _run_both(scans / "noisy", tmp_path, mode, False, monkeypatch)
    share = (mask != jmask).mean()
    assert share <= UNPATCHED_FLIP_SHARE, share
    assert abs(len(xyz) - len(jxyz)) <= UNPATCHED_FLIP_SHARE * mask.size


def test_true_depths_fuse_onto_the_plane(scans, tmp_path):
    scene = SyntheticScene(num_views=4, height=64, width=96)
    xyz, rgb = dynamic.fuse_scan(str(scans / "clean"), str(tmp_path / "f.ply"),
                                 dynamic.FusionParams(photo_threshold=0.5, thres_view=2), device="cpu")
    assert len(xyz) > 2000
    assert np.percentile(np.abs(xyz @ scene.n - scene.c), 95) < 1e-2
    back, back_rgb = jax_read_ply(str(tmp_path / "f.ply"))
    np.testing.assert_array_equal(back, xyz.astype(np.float32))
    np.testing.assert_array_equal(back_rgb, rgb)


def test_ply_bytes_read_back_with_the_jax_reader(tmp_path):
    rng = np.random.RandomState(0)
    xyz = rng.randn(50, 3)
    rgb = rng.randint(0, 256, (50, 3)).astype(np.uint8)
    write_ply(str(tmp_path / "a.ply"), xyz, rgb)
    for reader in (jax_read_ply, read_ply):
        back, back_rgb = reader(str(tmp_path / "a.ply"))
        np.testing.assert_array_equal(back, xyz.astype(np.float32))
        np.testing.assert_array_equal(back_rgb, rgb)


def test_non_finite_coordinates_sample_zero():
    depth = torch.arange(1.0, 21.0).reshape(1, 4, 5)
    x = torch.tensor([[float("nan"), float("inf"), -float("inf"), 1.5, 4.2, -0.5, 1e20]])
    y = torch.tensor([[1.0, 1, 1, 1.5, 1, 1, 1]])
    got = dynamic._sample(depth, x, y)
    want = cv2.remap(depth[0].numpy(), x.numpy(), y.numpy(), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert got[0, :3].eq(0).all() and got[0, -1] == 0


def test_zero_depth_reference_pixels_are_rejected(scans, tmp_path):
    """Zero-depth pixels project to 0/0 in every source: no NaN reaches the
    masks or the cloud, and none of them is kept."""
    scan = scans / "noisy"
    xyz, _ = dynamic.fuse_scan(str(scan), "", dynamic.FusionParams(photo_threshold=0.0, thres_view=1),
                               out_mask_folder=str(tmp_path), device="cpu")
    assert np.isfinite(xyz).all()
    for v in range(4):
        final = read_png(str(tmp_path / f"{v:0>8}_final.png"))
        assert not final[20:30, 10 + 5 * v : 40 + 5 * v].any()
        assert final.any()


def test_more_sources_than_rungs(scans, tmp_path):
    """Eleven sources (twelve views): the JAX ladder indexes past its last
    rung and raises; the port's stops at rung 10 and fuses as it does with
    rungs 2..10 for ten sources."""
    scan = tmp_path / "wide"
    shutil.copytree(scans / "clean", scan)
    for sub, suffix in (("depth_est", ".pfm"), ("confidence", ".pfm"), ("cams", "_cam.txt")):
        for v in range(4, 12):  # views 4..11 repeat views 0..3
            shutil.copy(scan / f"{sub}/{v % 4:0>8}{suffix}", scan / f"{sub}/{v:0>8}{suffix}")
    (scan / "pair.txt").write_text("1\n0\n11 " + " ".join(f"{v} 1.0" for v in range(1, 12)) + "\n")
    params = dict(photo_threshold=0.5, thres_view=2)
    with pytest.raises(IndexError):
        jax_dynamic.fuse_scan(str(scan), "", jax_dynamic.FusionParams(**params))
    xyz, _ = dynamic.fuse_scan(str(scan), "", dynamic.FusionParams(**params), device="cpu")
    assert len(xyz) > 1000 and np.isfinite(xyz).all()
