"""Time ``tools/fuse.py`` (``dynamic``) over a testlist of distinct scans at
several worker counts, in turns, on one card: by default the DTU
evaluation's shape (22 scans of 49 views, depth maps and images at
1152x864, 10 source views per reference view).

    python -m transmvsnet_tpu_torch.tools.time_fusion_workers \\
        [--scans 22] [--views 49] [--runs 1,8,threads8,threads8,8,1] [--profile] [--out result.json]

The scans are synthetic, made from ``--seed``: the synthetic plane
(``data/synthetic.py``) seen by a near-square grid of cameras, whose
images, cams and pair.txt (each view's 10 nearest cameras) all scans
share, and per scan depth maps with noise of its own (x(1 + 0.002 N(0,1)))
and uniform confidences of its own, so that every scan writes another PLY.
They are written under ``build/fusion_workers`` and read warm from the
page cache.

Each entry of ``--runs`` fuses every scan once:

- ``N``: ``tools/fuse.main --num_workers N`` (``fuse_scans``: N spawned
  processes, or this process at N = 1), the process start counted;
- ``threadsN``: N threads in this process, each scan under a CUDA stream
  of its own, each calling ``fuse_scan``: the design that the processes
  replaced, kept here to compare.

Each run reports its wall time and the peak device memory in use by all
processes (``torch.cuda.mem_get_info`` sampled every 5 ms, above the
level before the run).

Every run's PLYs are held byte for byte against the first run's. With
``--profile``, one scan fused at one worker under cProfile gives the host
time by part: PFM reads, image reads, camera parsing, ``np.linalg.inv``,
host-to-device copies, ``.cpu()`` (the wait for the device and the copy)
and the PLY write; the rest holds the device work that the host waits for
elsewhere (boolean-mask indexing).
Prints one JSON line; ``--out`` writes it to a file as well.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import math
import os
import pathlib
import pstats
import queue
import shutil
import threading
import time
from concurrent import futures

import numpy as np
import torch

from transmvsnet_tpu_torch.data.cams import write_cam_file
from transmvsnet_tpu_torch.data.image_io import write_jpeg
from transmvsnet_tpu_torch.data.pfm import save_pfm
from transmvsnet_tpu_torch.data.synthetic import BASELINE, FOCAL, PLANE_OFFSET, SyntheticScene
from transmvsnet_tpu_torch.eval.dtu_eval import dtu_ply_name
from transmvsnet_tpu_torch.fusion.dynamic import FusionParams, fuse_scan
from transmvsnet_tpu_torch.models.blocks import resolve_device
from transmvsnet_tpu_torch.tools import fuse

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCES = 10  # DTU's pair.txt: ten source views per reference view
PHOTO_THRESHOLD, THRES_VIEW = 0.3, 3  # tools/fuse.py's DTU defaults (scripts/test_dtu.sh)
# cProfile's function names for each part of one scan's host time, counted
# where fusion/dynamic.py calls them.
PARTS = {
    "read_pfm": "read_pfm",
    "read_image": "read_image",
    "read_cams": "_read_fusion_cam",
    "linalg_inv": "inv",
    "to_device": "<method 'to' of 'torch._C.TensorBase' objects>",
    "cpu_copies": "<method 'cpu' of 'torch._C.TensorBase' objects>",
    "write_ply": "write_ply",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scans", type=int, default=22)
    p.add_argument("--views", type=int, default=49)
    p.add_argument("--height", type=int, default=864)
    p.add_argument("--width", type=int, default=1152)
    p.add_argument("--runs", default="1,8,threads8,threads8,8,1",
                   help="comma-separated worker counts; threadsN for N threads in this process")
    p.add_argument("--profile", action="store_true", help="one scan at one worker under cProfile")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default=str(ROOT / "build" / "fusion_workers"))
    p.add_argument("--out", default="", help="also write the JSON result here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def grid_scene(views: int, height: int, width: int, seed: int) -> SyntheticScene:
    """The synthetic plane seen from a near-square grid of ``views``
    cameras, spaced as the scene's ring and turned to keep the plane
    centred, as DTU's cameras look at the table from a cap."""
    scene = SyntheticScene(views, height, width, seed=seed, focal=FOCAL * width / 96)
    cols = math.ceil(math.sqrt(views))
    scene.extrinsics = []
    for v in range(views):
        tx = BASELINE * (v % cols - (cols - 1) / 2)
        ty = BASELINE * (v // cols - (cols - 1) / 2)
        a, b = -tx / PLANE_OFFSET, ty / PLANE_OFFSET
        ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
        e = np.eye(4)
        e[:3, :3] = ry @ rx
        e[:3, 3] = [tx, ty, 0.0]
        scene.extrinsics.append(e)
    return scene


def write_scans(root: pathlib.Path, args, device: torch.device) -> list[str]:
    """The shared scene under ``root/shared`` and ``args.scans`` scans that
    link to it, each with depth maps and confidences of its own."""
    scene = grid_scene(args.views, args.height, args.width, args.seed)
    shared = root / "shared"
    for sub in ("cams", "images"):
        (shared / sub).mkdir(parents=True)
    depths = []
    for v in range(scene.V):
        img, depth = scene.render(v)
        depths.append(depth)
        pair = np.zeros((2, 4, 4), dtype=np.float32)
        pair[0] = scene.extrinsics[v]
        pair[1, :3, :3] = scene.K
        write_cam_file(str(shared / f"cams/{v:0>8}_cam.txt"), pair, "1.0 0.01")
        write_jpeg(str(shared / f"images/{v:0>8}.jpg"), torch.from_numpy((img * 255).astype(np.uint8)).to(device))
    centres = np.stack([-e[:3, :3].T @ e[:3, 3] for e in scene.extrinsics])
    with open(shared / "pair.txt", "w") as f:
        f.write(f"{scene.V}\n")
        for v in range(scene.V):
            dist = np.linalg.norm(centres - centres[v], axis=1)
            near = [int(o) for o in np.argsort(dist, kind="stable") if o != v][:SOURCES]
            f.write(f"{v}\n{len(near)} " + " ".join(f"{o} {100.0 / (1.0 + dist[o]):.3f}" for o in near) + "\n")
    scans = [f"scan{i}" for i in range(1, args.scans + 1)]
    for i, scan in enumerate(scans):
        rng = np.random.default_rng([args.seed, i])
        folder = root / scan
        for sub in ("depth_est", "confidence"):
            (folder / sub).mkdir(parents=True)
        for sub in ("cams", "images", "pair.txt"):
            os.symlink(shared / sub, folder / sub)
        for v, depth in enumerate(depths):
            noise = rng.standard_normal(depth.shape, dtype=np.float32)
            save_pfm(str(folder / f"depth_est/{v:0>8}.pfm"), depth * (1 + np.float32(0.002) * noise))
            save_pfm(str(folder / f"confidence/{v:0>8}.pfm"), rng.random(depth.shape, dtype=np.float32))
    return scans


class DeviceMemory:
    """The peak device memory in use by all processes while the block runs,
    above the level at its start: ``torch.cuda.mem_get_info`` sampled every
    5 ms from a thread. ``peak_bytes`` stays None on the CPU."""

    def __init__(self, device: torch.device):
        self.device, self.peak_bytes = device, None

    def _used(self) -> int:
        free, total = torch.cuda.mem_get_info(self.device)
        return total - free

    def _sample(self) -> None:
        while not self._stop.wait(0.005):
            self._peak = max(self._peak, self._used())

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            self._base = self._peak = self._used()
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._stop.set()
            self._thread.join()
            self.peak_bytes = max(self._peak, self._used()) - self._base


def run_cli(root: pathlib.Path, testlist: pathlib.Path, outdir: pathlib.Path, workers: int,
            device: torch.device) -> dict:
    buf = io.StringIO()
    with DeviceMemory(device) as memory, contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        fuse.main(["--testpath", str(root), "--testlist", str(testlist), "--outdir", str(outdir),
                   "--filter_method", "dynamic", "--photo_threshold", str(PHOTO_THRESHOLD),
                   "--thres_view", str(THRES_VIEW), "--num_workers", str(workers), "--device", str(device)])
        wall = time.perf_counter() - t0
    wrote = [line.split(" ", 1)[1] for line in buf.getvalue().splitlines() if line.startswith("wrote ")]
    return {"wall_s": wall, "peak_device_memory_bytes": memory.peak_bytes, "plys": wrote}


def run_threads(root: pathlib.Path, scans: list[str], outdir: pathlib.Path, workers: int,
                device: torch.device) -> dict:
    """``workers`` threads, each scan under one of their CUDA streams."""
    outdir.mkdir(parents=True)
    streams = queue.SimpleQueue()
    for _ in range(workers):
        streams.put(torch.cuda.Stream(device) if device.type == "cuda" else None)
    params = FusionParams(photo_threshold=PHOTO_THRESHOLD, thres_view=THRES_VIEW)

    def fuse_one(scan: str) -> str:
        out_ply = str(outdir / dtu_ply_name(int(scan[4:])))
        stream = streams.get()
        try:
            with torch.cuda.stream(stream):  # a no-op for None (the CPU)
                fuse_scan(str(root / scan), out_ply, params, device=device)
        finally:
            streams.put(stream)
        return out_ply

    with DeviceMemory(device) as memory:
        t0 = time.perf_counter()
        with futures.ThreadPoolExecutor(workers) as pool:
            wrote = list(pool.map(fuse_one, scans))
        wall = time.perf_counter() - t0
    return {"wall_s": wall, "peak_device_memory_bytes": memory.peak_bytes, "plys": wrote}


def profile_scan(folder: str, out_ply: str, device: torch.device) -> dict:
    """One scan at one worker under cProfile: seconds by part (the parts'
    cumulative time in calls from fusion/dynamic.py) and in all."""
    profiler = cProfile.Profile()
    t0 = time.perf_counter()
    profiler.enable()
    fuse_scan(folder, out_ply, FusionParams(photo_threshold=PHOTO_THRESHOLD, thres_view=THRES_VIEW), device=device)
    profiler.disable()
    total = time.perf_counter() - t0
    stats = pstats.Stats(profiler).stats
    parts = {name: sum(ct for (_, _, fn), (*_, callers) in stats.items() if fn == target
                       for (caller, _, _), (_, _, _, ct) in callers.items()
                       if caller.endswith(os.path.join("fusion", "dynamic.py")))
             for name, target in PARTS.items()}
    return {"total_s": total, "parts_s": parts, "rest_s": total - sum(parts.values())}


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    root = pathlib.Path(args.workdir)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    scans = write_scans(root / "scans", args, device)
    testlist = root / "list.txt"
    testlist.write_text("".join(f"{s}\n" for s in scans))
    # The first fusion builds and loads the libraries (nvJPEG) before any clock runs.
    fuse_scan(str(root / "scans" / scans[0]), "", FusionParams(photo_threshold=PHOTO_THRESHOLD,
                                                               thres_view=THRES_VIEW), device=device)
    result = {"scans": args.scans, "views": args.views, "height": args.height, "width": args.width,
              "sources": SOURCES, "seed": args.seed, "setup_s": time.perf_counter() - t0,
              "data_bytes": sum(f.stat().st_size for f in (root / "scans").rglob("*.pfm")), "runs": []}
    first = None
    for turn, run in enumerate(args.runs.split(",")):
        outdir = root / f"plys_{turn}"
        if run.startswith("threads"):
            r = run_threads(root / "scans", scans, outdir, int(run[7:]), device)
        else:
            r = run_cli(root / "scans", testlist, outdir, int(run), device)
        want = [str(outdir / dtu_ply_name(int(s[4:]))) for s in scans]
        if r.pop("plys") != want:
            raise AssertionError(f"run {run} did not return the testlist's order")
        plys = [pathlib.Path(p).read_bytes() for p in want]
        if first is None:
            first = plys
            if len(set(plys)) != len(plys):
                raise AssertionError("two scans wrote the same PLY: the check could not see a swapped scan")
            result["ply_bytes"] = sum(len(b) for b in plys)
        elif plys != first:
            raise AssertionError(f"run {run} wrote PLYs that differ from run {args.runs.split(',')[0]}'s")
        shutil.rmtree(outdir)
        r.update({"run": run, "ms_per_scan": 1e3 * r["wall_s"] / len(scans)})
        result["runs"].append(r)
        print(json.dumps(r), flush=True)
    by_run = {}
    for r in result["runs"]:
        by_run.setdefault(r["run"], []).append(r["ms_per_scan"])
    result["median_ms_per_scan"] = {k: float(np.median(v)) for k, v in by_run.items()}
    result["plys_byte_identical"] = True
    if args.profile:
        result["profile_one_scan_one_worker"] = profile_scan(str(root / "scans" / scans[0]),
                                                             str(root / "profile.ply"), device)
    shutil.rmtree(root)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()
