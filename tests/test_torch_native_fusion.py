"""The port's native fuser (``fusion/native.py``, here its plain version on
CPU tensors) against the C++ binary ``native/fuser`` that the JAX package
drives, and the port's ``tools/fuse.py --filter_method native`` against the
JAX CLI.

The scan: ``tests/test_native_fuser.py``'s synthetic scene (4 views, 64x96,
true depths, PPM images), and variants of it. The binary is built twice
from ``native/fuser``, each in a directory of this module's own (another
module builds the binary's default directory): as its CMake file builds it,
with g++ -O3 -march=native, which contracts multiply-adds into fused ones,
and with -ffp-contract=off. The port rounds every operation in the binary's
order, so it equals the second bit for bit; against the first, the points
are equal in number and order, the colours byte for byte, and xyz within
XYZ_TOL (an ulp or two of the fused multiply-adds; 1.4e-6 seen, with
coordinates up to 6.7). The data keep clear of the thresholds: no |Δdisp|
near disp_threshold, no projection within an ulp of an image border.
"""

import os
import pathlib
import shutil
import subprocess

import cv2
import numpy as np
import pytest
import torch

from transmvsnet_tpu.data.cams import write_cam_file
from transmvsnet_tpu.data.pfm import save_pfm
from transmvsnet_tpu.data.synthetic import SyntheticScene
from transmvsnet_tpu.fusion import native as jax_native
from transmvsnet_tpu.fusion.ply import read_ply as jax_read_ply
from transmvsnet_tpu.tools import fuse as jax_fuse_cli
from transmvsnet_tpu_torch.data.synthetic import SyntheticScene as TorchScene
from transmvsnet_tpu_torch.fusion import native
from transmvsnet_tpu_torch.fusion.ply import read_ply
from transmvsnet_tpu_torch.ops.cuda.native_fuse import native_fuse
from transmvsnet_tpu_torch.ops.native_fuse import sample_bilinear
from transmvsnet_tpu_torch.tools import fuse

ROOT = pathlib.Path(__file__).resolve().parents[1]
VIEWS, HEIGHT, WIDTH = 4, 64, 96
# xyz against the binary as CMake builds it, times the scene's depth range.
XYZ_TOL = 1e-5
# JPEG colours: the JAX package's fusion/native.py decodes with cv2, the
# port's CPU route with PIL (tests/test_torch_image_io.py holds it to PIL);
# both are libjpeg builds, equal on this scan, held within a level.
JPEG_LEVELS = 1


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six test workers share the CPUs: torch's intra-op threads would wait
    on one another at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """{"cmake": the binary as the JAX package builds it, "uncontracted":
    the same source with -ffp-contract=off}."""
    out = {}
    for name in ("cmake", "uncontracted"):
        d = tmp_path_factory.mktemp(f"fuser_{name}")
        for f in ("fuser.cpp", "CMakeLists.txt"):
            shutil.copy(ROOT / "native" / "fuser" / f, d / f)
        if name == "cmake":
            out[name] = jax_native.ensure_built(str(d))
        else:
            subprocess.run(["cmake", "-B", "build", "-S", ".", "-G", "Ninja",
                            "-DCMAKE_CXX_FLAGS=-ffp-contract=off"], cwd=d, check=True, capture_output=True)
            subprocess.run(["cmake", "--build", "build"], cwd=d, check=True, capture_output=True)
            out[name] = str(d / "build" / "tpu_fuser")
    return out


def _write_ppm(path, img):
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write((img * 255).astype(np.uint8).tobytes())


def _write_pair(root, entries):
    with open(root / "pair.txt", "w") as f:
        f.write(f"{len(entries)}\n")
        for ref, srcs in entries:
            f.write(f"{ref}\n{len(srcs)} " + " ".join(f"{o} 10.0" for o in srcs) + "\n")


def _all_pairs():
    return [(v, [o for o in range(VIEWS) if o != v]) for v in range(VIEWS)]


def _write_scan(root, images="ppm", confidence=False):
    """The binary test's scan; images as PPM, JPEG (written by cv2, as the
    JAX infer writes them), PNG or none."""
    scene = SyntheticScene(num_views=VIEWS, height=HEIGHT, width=WIDTH)
    for sub in ("depth_est", "cams", "images") + (("confidence",) if confidence else ()):
        os.makedirs(root / sub)
    for v in range(scene.V):
        img, depth = scene.render(v)
        save_pfm(str(root / f"depth_est/{v:0>8}.pfm"), depth)
        if confidence:
            save_pfm(str(root / f"confidence/{v:0>8}.pfm"), np.ones_like(depth))
        pair = np.zeros((2, 4, 4), dtype=np.float32)
        pair[0] = scene.extrinsics[v]
        pair[1, :3, :3] = scene.K
        write_cam_file(str(root / f"cams/{v:0>8}_cam.txt"), pair, "1.0 0.01")
        if images == "ppm":
            _write_ppm(str(root / f"images/{v:0>8}.ppm"), img)
        elif images in ("jpg", "png"):
            cv2.imwrite(str(root / f"images/{v:0>8}.{images}"),
                        cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    _write_pair(root, _all_pairs())
    return scene


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_scan")
    scene = _write_scan(root)
    depths = np.stack([scene.render(v)[1] for v in range(VIEWS)])
    return root, scene, float(depths.max() - depths.min())


def _variant(scan, tmp_path):
    root, _, _ = scan
    shutil.copytree(root, tmp_path / "scan")
    return tmp_path / "scan"


def _fuse_both(root, binaries, tmp_path, **kw):
    """(the binary's cloud, the uncontracted binary's, the port's), each
    (xyz, rgb)."""
    clouds = []
    for name in ("cmake", "uncontracted"):
        out = str(tmp_path / f"{name}.ply")
        jax_native.native_fuse_scan(str(root), out, binary=binaries[name], **kw)
        clouds.append(jax_read_ply(out))
    out = native.native_fuse_scan(str(root), str(tmp_path / "port.ply"), device="cpu", **kw)
    clouds.append(read_ply(out))
    return clouds


def _assert_matches_binary(clouds, depth_range):
    (want_xyz, want_rgb), (exact_xyz, exact_rgb), (xyz, rgb) = clouds
    assert xyz.shape == want_xyz.shape and len(xyz) > 0
    np.testing.assert_array_equal(rgb, want_rgb)
    np.testing.assert_allclose(xyz, want_xyz, rtol=0, atol=XYZ_TOL * depth_range)
    np.testing.assert_array_equal(xyz, exact_xyz)
    np.testing.assert_array_equal(rgb, exact_rgb)
    return xyz, rgb


@pytest.mark.parametrize("num_consistent", [2, 3, 4])
def test_matches_the_binary(scan, binaries, tmp_path, num_consistent):
    root, scene, depth_range = scan
    xyz, rgb = _assert_matches_binary(_fuse_both(root, binaries, tmp_path, num_consistent=num_consistent),
                                      depth_range)
    assert len(xyz) > 3000
    assert np.percentile(np.abs(xyz @ scene.n - scene.c), 95) < 1e-2  # on the plane
    assert rgb.std() > 5  # colours from the PPMs, not white


def test_fewer_points_as_more_views_must_agree(scan, tmp_path):
    root, _, _ = scan
    counts = [len(read_ply(native.native_fuse_scan(str(root), str(tmp_path / f"{n}.ply"), num_consistent=n,
                                                   device="cpu"))[0]) for n in (1, 2, 3, 4, 5)]
    assert counts == sorted(counts, reverse=True) and counts[0] == VIEWS * HEIGHT * WIDTH and counts[-1] == 0


def test_rejects_an_inconsistent_view(scan, binaries, tmp_path):
    """tests/test_native_fuser.py's case: view 0's depths doubled."""
    root = _variant(scan, tmp_path)
    _, scene, depth_range = scan
    save_pfm(str(root / "depth_est/00000000.pfm"), scene.render(0)[1] * 2.0)
    xyz, _ = _assert_matches_binary(_fuse_both(root, binaries, tmp_path), depth_range)
    assert np.percentile(np.abs(xyz @ scene.n - scene.c), 95) < 2e-2


def test_depth_range_cuts_the_scene(scan, binaries, tmp_path):
    root, scene, depth_range = scan
    depths = np.concatenate([scene.render(v)[1].ravel() for v in range(VIEWS)])
    lo, hi = (float(np.percentile(depths, q)) for q in (20, 70))
    full = _fuse_both(root, binaries, tmp_path)[2][0]
    xyz, _ = _assert_matches_binary(_fuse_both(root, binaries, tmp_path, min_depth=lo, max_depth=hi),
                                    depth_range)
    assert len(xyz) < 0.6 * len(full)


@pytest.mark.parametrize("missing", ["depth_est/00000002.pfm", "cams/00000002_cam.txt"])
def test_a_view_without_its_files_is_skipped(scan, binaries, tmp_path, missing):
    root = _variant(scan, tmp_path)
    os.remove(root / missing)
    _assert_matches_binary(_fuse_both(root, binaries, tmp_path), scan[2])


def test_a_reference_listed_twice_emits_its_points_twice(scan, binaries, tmp_path):
    root = _variant(scan, tmp_path)
    _write_pair(root, [(1, [0, 2])])
    once = len(read_ply(native.native_fuse_scan(str(root), str(tmp_path / "once.ply"), num_consistent=2,
                                                device="cpu"))[0])
    _write_pair(root, [(1, [0, 2]), (3, [2, 1, 0]), (1, [0, 2]), (2, [])])  # (2, []) is dropped
    xyz, rgb = _assert_matches_binary(_fuse_both(root, binaries, tmp_path, num_consistent=2), scan[2])
    assert once > 1000 and len(xyz) > 2 * once
    np.testing.assert_array_equal(xyz[:once], xyz[-once:])
    np.testing.assert_array_equal(rgb[:once], rgb[-once:])


def test_depth_maps_of_unequal_sizes(scan, binaries, tmp_path):
    """View 3 at 48x72 with its intrinsics scaled: sources of another size
    than their reference, and a reference of another size than its
    sources."""
    root = _variant(scan, tmp_path)
    big = TorchScene(num_views=VIEWS, height=HEIGHT, width=WIDTH)
    small = TorchScene(num_views=VIEWS, height=48, width=72, focal=120.0 * 0.75)
    np.testing.assert_array_equal(small.extrinsics[3], big.extrinsics[3])
    save_pfm(str(root / "depth_est/00000003.pfm"), small.render(3)[1])
    pair = np.zeros((2, 4, 4), dtype=np.float32)
    pair[0] = small.extrinsics[3]
    pair[1, :3, :3] = small.K
    write_cam_file(str(root / "cams/00000003_cam.txt"), pair, "1.0 0.01")
    xyz, _ = _assert_matches_binary(_fuse_both(root, binaries, tmp_path), scan[2])
    assert len(xyz) > 3000


def test_white_points_without_images(scan, binaries, tmp_path):
    root = _variant(scan, tmp_path)
    shutil.rmtree(root / "images")
    _, rgb = _assert_matches_binary(_fuse_both(root, binaries, tmp_path), scan[2])
    assert (rgb == 255).all()


def test_an_image_smaller_than_its_depth_map_raises(scan, tmp_path):
    root = _variant(scan, tmp_path)
    _write_ppm(str(root / "images/00000001.ppm"), np.zeros((HEIGHT, WIDTH - 1, 3), np.float32))
    with pytest.raises(ValueError, match="smaller than its depth map"):
        native.native_fuse_scan(str(root), str(tmp_path / "x.ply"), device="cpu")


def test_a_nan_reference_depth_is_rejected(scan, tmp_path):
    """The binary's range test lets a NaN through to an out-of-bounds read;
    the port rejects it. As a source, a NaN agrees with nothing. Not run
    through the binary."""
    root = _variant(scan, tmp_path)
    _, scene, _ = scan
    depth = scene.render(0)[1]
    depth[10, 20] = np.nan
    save_pfm(str(root / "depth_est/00000000.pfm"), depth)
    loaded = native.load_scan(str(root), "cpu")
    clean = native.load_scan(str(scan[0]), "cpu")
    ref, srcs, fbs = loaded.entries[0]
    args = (ref, (HEIGHT, WIDTH), srcs, fbs, 0.0, 1e9, 0.25)
    count, xyz = native_fuse(loaded.depths, loaded.offsets, loaded.sizes, loaded.cams, *args)
    count_clean, xyz_clean = native_fuse(clean.depths, clean.offsets, clean.sizes, clean.cams, *args)
    assert count[10, 20] == 0 and count_clean[10, 20] > 1
    off = torch.ones_like(count, dtype=torch.bool)
    off[10, 20] = False
    assert torch.equal(count[off], count_clean[off]) and torch.equal(xyz[off], xyz_clean[off])
    assert torch.isfinite(xyz).all()
    points, _ = read_ply(native.native_fuse_scan(str(root), str(tmp_path / "nan.ply"), device="cpu"))
    assert np.isfinite(points).all()


@pytest.mark.parametrize("images", ["jpg", "png"])
def test_cli_matches_the_jax_cli(tmp_path, monkeypatch, binaries, images):
    """``tools/fuse.py --filter_method native --device cpu`` against the JAX
    CLI on a pipeline-style scan (depth_est, confidence, cams, images as the
    JAX infer writes them). The JAX package converts the images to PPM in
    the scan folder, so each CLI gets its own copy."""
    monkeypatch.setattr(jax_native, "ensure_built", lambda: binaries["cmake"])
    scene = _write_scan(tmp_path / "a" / "scan1", images=images, confidence=True)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    (tmp_path / "list.txt").write_text("scan1\n")
    common = ["--testlist", str(tmp_path / "list.txt"), "--filter_method", "native", "--num_consistent", "2",
              "--disp_threshold", "0.2"]
    fuse.main(["--testpath", str(tmp_path / "a"), "--outdir", str(tmp_path / "port"), "--device", "cpu", *common])
    jax_fuse_cli.main(["--testpath", str(tmp_path / "b"), "--outdir", str(tmp_path / "jax"), *common])
    assert not list((tmp_path / "a" / "scan1" / "images").glob("*.ppm"))  # decoded in memory
    xyz, rgb = read_ply(str(tmp_path / "port" / "mvsnet001_l3.ply"))
    want_xyz, want_rgb = jax_read_ply(str(tmp_path / "jax" / "mvsnet001_l3.ply"))
    assert xyz.shape == want_xyz.shape and len(xyz) > 3000
    depths = np.stack([scene.render(v)[1] for v in range(VIEWS)])
    np.testing.assert_allclose(xyz, want_xyz, rtol=0, atol=XYZ_TOL * float(depths.max() - depths.min()))
    levels = np.abs(rgb.astype(int) - want_rgb.astype(int)).max()
    assert levels == 0 if images == "png" else levels <= JPEG_LEVELS
    assert rgb.std() > 5


def test_colour_bytes_round_trip():
    """The binary stores byte / 255.0f and writes (uint8)(v * 255.0f): in
    float32 every byte comes back unchanged, so the port's bytes through
    ``read_image``'s floats are the binary's."""
    b = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(native.colour_bytes(b.float() / 255.0), b)
    v = np.arange(256, dtype=np.float32) / np.float32(255.0)
    np.testing.assert_array_equal((v * np.float32(255.0)).astype(np.uint8), np.arange(256))


def test_camera_quantities_are_float32_in_the_binarys_order():
    K = np.array([[120.5, 0.25, 48.0], [0.0, 119.75, 32.5], [0.0, 0.0, 1.0]], np.float32)
    inv = native.invert3(K.reshape(-1)).reshape(3, 3)
    assert inv.dtype == np.float32
    np.testing.assert_allclose(inv, np.linalg.inv(K.astype(np.float64)), rtol=1e-6, atol=1e-7)
    E = TorchScene(num_views=3).extrinsics[2]
    cam = np.concatenate([E[:3, :3].reshape(-1), E[:3, 3], K.reshape(-1), inv.reshape(-1)]).astype(np.float32)
    np.testing.assert_allclose(native.camera_centre(cam), -E[:3, :3].T @ E[:3, 3], rtol=1e-6, atol=1e-6)


def test_sample_bilinear_is_zero_past_the_borders():
    """Unlike grid_sample's zeros padding: no partial taps beyond the last
    pixel, the +1 taps clamped at the last column and row."""
    img = torch.arange(1.0, 13.0).reshape(-1)  # 3 x 4
    x = torch.tensor([0.0, 3.0, 3.0, 2.5, -1e-6, 3.0001, 1.5, float("nan")])
    y = torch.tensor([0.0, 2.0, 1.5, 2.0, 0.0, 0.0, 2.0000002, 1.0])
    got, inside = sample_bilinear(img, 3, 4, x, y)
    assert inside.tolist() == [True, True, True, True, False, False, False, False]
    torch.testing.assert_close(got, torch.tensor([1.0, 12.0, 10.0, 11.5, 0, 0, 0, 0]))


def test_surface_points_match_the_jax_scene():
    for kw in ({}, {"num_views": 3, "height": 40, "width": 56, "seed": 3}):
        want = SyntheticScene(**kw).surface_points(stride=2)
        np.testing.assert_array_equal(TorchScene(**kw).surface_points(stride=2), want)


def test_the_wrapper_refuses_other_devices():
    m = torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        native_fuse(torch.empty(8, device=m), torch.zeros(1, dtype=torch.int64, device=m),
                    torch.zeros(1, 2, dtype=torch.int32, device=m), torch.empty(1, 30, device=m), 0, (2, 4),
                    torch.zeros(0, dtype=torch.int32, device=m), torch.empty(0, device=m), 0.0, 1e9, 0.25)
