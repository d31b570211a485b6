"""``tools/fuse.py --num_workers``: scans fused concurrently
(``fusion/dynamic.py::fuse_scans``) write the PLYs of a one-worker run,
byte for byte, in testlist order, and agree with the JAX package's
``fuse_scans``; a failing scan fails the CLI; the DTU recipe's fusion
command line with the flag parses.

Three 4-view 64x96 scans of ``test_torch_fusion.py``'s noisy scene, each
with depth noise and confidences of its own seed, so that every scan
keeps other points and a PLY written under the wrong name would show.
"""

import contextlib
import io
import os
import pathlib
import shlex
import shutil

import numpy as np
import pytest
import torch

from test_torch_fusion import MODES, _exact_remap, _write_scan
from transmvsnet_tpu.data.pfm import read_pfm, save_pfm
from transmvsnet_tpu.fusion import dynamic as jax_dynamic
from transmvsnet_tpu.fusion.ply import read_ply as jax_read_ply
from transmvsnet_tpu_torch.fusion import dynamic
from transmvsnet_tpu_torch.fusion.ply import read_ply
from transmvsnet_tpu_torch.tools import fuse

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCANS = ("scan1", "scan2", "scan3")
PLYS = ("mvsnet001_l3.ply", "mvsnet002_l3.ply", "mvsnet003_l3.ply")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six test workers share the CPUs: torch's intra-op threads would wait
    on one another at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def testpath(tmp_path_factory):
    root = tmp_path_factory.mktemp("fuse_workers")
    for seed, scan in enumerate(SCANS):
        _write_scan(root / scan, noisy=True)
        rng = np.random.RandomState(100 + seed)
        for v in range(4):
            depth_path = str(root / scan / f"depth_est/{v:0>8}.pfm")
            depth = read_pfm(depth_path)[0]
            save_pfm(depth_path, (depth * (1 + 0.002 * rng.randn(*depth.shape))).astype(np.float32))
            save_pfm(str(root / scan / f"confidence/{v:0>8}.pfm"), rng.rand(*depth.shape).astype(np.float32))
    (root / "list.txt").write_text("".join(f"{s}\n" for s in SCANS))
    return root


def run_cli(testpath, outdir, *extra, out=None) -> list[str]:
    """tools/fuse.main on the CPU; the paths it printed."""
    out = io.StringIO() if out is None else out
    with contextlib.redirect_stdout(out):
        fuse.main(["--testpath", str(testpath), "--testlist", str(testpath / "list.txt"), "--outdir", str(outdir),
                   "--device", "cpu", "--thres_view", "2", *extra])
    return [line.split(" ", 1)[1] for line in out.getvalue().splitlines() if line.startswith("wrote ")]


@pytest.fixture(scope="module")
def fused(testpath, tmp_path_factory):
    """(outdir, printed paths) of the CLI per method and worker count, each
    run once: a pool of processes takes seconds to start."""
    runs = {}

    def run(method: str, workers: str):
        if (method, workers) not in runs:
            out = tmp_path_factory.mktemp(f"{method}_workers{workers}")
            photo = ["--photo_threshold", str(MODES[method]["photo_threshold"])] if method in MODES else []
            runs[method, workers] = out, run_cli(testpath, out, "--filter_method", method, "--num_workers",
                                                 workers, *photo)
        return runs[method, workers]

    return run


@pytest.mark.parametrize("method", ["dynamic", "normal", "native"])
def test_workers_write_the_serial_plys_in_testlist_order(fused, method):
    """native takes the flag and ignores it, as the JAX CLI does."""
    written = {}
    for workers in ("1", "3"):
        out, paths = fused(method, workers)
        assert paths == [str(out / p) for p in PLYS]
        written[workers] = [pathlib.Path(p).read_bytes() for p in paths]
    assert written["1"] == written["3"]
    assert len(set(written["1"])) == len(SCANS)  # the scans differ


@pytest.mark.parametrize("method", ["dynamic", "normal"])
def test_three_workers_match_jax(testpath, tmp_path, fused, monkeypatch, method):
    """The JAX fuser with cv2.remap patched to exact bilinear sampling, as
    in test_torch_fusion.py, at one worker: forking a process that has JAX
    loaded can hang."""
    import types

    import cv2

    shim = types.SimpleNamespace(**{k: getattr(cv2, k) for k in dir(cv2) if not k.startswith("__")})
    shim.remap = _exact_remap
    monkeypatch.setattr(jax_dynamic, "cv2", shim)
    jax_params = jax_dynamic.FusionParams(**{**MODES[method], "thres_view": 2})
    theirs = jax_dynamic.fuse_scans(str(testpath), list(SCANS), str(tmp_path / "jax"), jax_params, num_workers=1)
    _, ours = fused(method, "3")
    assert [os.path.basename(p) for p in theirs] == [os.path.basename(p) for p in ours] == list(PLYS)
    for mine, jax_ply in zip(ours, theirs):
        xyz, rgb = read_ply(mine)
        jxyz, jrgb = jax_read_ply(jax_ply)
        assert xyz.shape == jxyz.shape and len(xyz) > 0
        np.testing.assert_allclose(xyz, jxyz, rtol=1e-9, atol=1e-9)
        assert np.abs(rgb.astype(int) - jrgb.astype(int)).max() <= 1


def test_one_worker_or_one_scan_runs_in_process(testpath, tmp_path, monkeypatch):
    """A process would cost seconds to start for nothing: one worker, or one
    scan at any count, fuses here; more workers than scans start one
    process per scan. Every PLY is the one-worker run's."""
    from concurrent import futures

    params = dynamic.FusionParams(photo_threshold=0.3, thres_view=2)
    serial = dynamic.fuse_scans(str(testpath), list(SCANS), str(tmp_path / "serial"), params, device="cpu",
                                num_workers=1)
    started = []

    class Pool(futures.ProcessPoolExecutor):
        def __init__(self, workers, **kwargs):
            started.append(workers)
            super().__init__(workers, **kwargs)

    monkeypatch.setattr(dynamic.futures, "ProcessPoolExecutor", Pool)
    (one,) = dynamic.fuse_scans(str(testpath), ["scan2"], str(tmp_path / "one"), params, device="cpu",
                                num_workers=8)
    assert started == [] and pathlib.Path(one).read_bytes() == pathlib.Path(serial[1]).read_bytes()
    paths = dynamic.fuse_scans(str(testpath), list(SCANS), str(tmp_path / "many"), params, device="cpu",
                               num_workers=8)
    assert started == [len(SCANS)]
    assert paths == [str(tmp_path / "many" / p) for p in PLYS]
    assert [pathlib.Path(p).read_bytes() for p in paths] == [pathlib.Path(p).read_bytes() for p in serial]


def test_a_failing_scan_fails_the_cli(testpath, tmp_path):
    broken = tmp_path / "broken"
    shutil.copytree(testpath, broken)
    os.remove(broken / "scan2" / "depth_est" / "00000001.pfm")
    out = io.StringIO()
    with pytest.raises(FileNotFoundError, match="00000001.pfm"):
        run_cli(broken, tmp_path / "plys", "--num_workers", "3", out=out)
    assert "wrote" not in out.getvalue()


def test_the_dtu_recipe_with_num_workers_parses():
    """scripts/test_dtu.sh's fusion command, ``--num_workers 8`` added."""
    script = (ROOT / "scripts" / "test_dtu.sh").read_text().replace("\\\n", " ")
    line = next(l for l in script.splitlines() if "transmvsnet_tpu.tools.fuse" in l)
    argv = shlex.split(line)
    argv = argv[argv.index("transmvsnet_tpu.tools.fuse") + 1:]
    args = fuse.parse_args([*argv, "--num_workers", "8"])
    assert (args.num_workers, args.filter_method, args.thres_view, args.test_dataset) == (8, "dynamic", 3, "dtu")
    assert fuse.parse_args(argv).num_workers == 8  # the JAX default


def test_the_timing_tool_runs_distinct_scans(tmp_path):
    """``tools/time_fusion_workers.py`` at a tiny size on the CPU: every run
    writes the first run's PLYs, which differ from scan to scan (the tool
    raises otherwise), and the profile's parts fit in its total."""
    from transmvsnet_tpu_torch.tools import time_fusion_workers

    r = time_fusion_workers.main(["--device", "cpu", "--scans", "3", "--views", "5", "--height", "48", "--width",
                                  "64", "--runs", "1,2,threads2", "--profile", "--workdir", str(tmp_path / "work")])
    assert [x["run"] for x in r["runs"]] == ["1", "2", "threads2"] and r["plys_byte_identical"]
    assert set(r["median_ms_per_scan"]) == {"1", "2", "threads2"} and r["ply_bytes"] > 0
    profile = r["profile_one_scan_one_worker"]
    assert 0 < sum(profile["parts_s"].values()) <= profile["total_s"]
    assert profile["parts_s"]["read_pfm"] > 0 and profile["parts_s"]["write_ply"] > 0
    assert not (tmp_path / "work").exists()
