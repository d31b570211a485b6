"""Inference CLI: depth maps and confidence over evaluation scans.

    python -m transmvsnet_tpu_torch.tools.infer --datapath <DTU_TEST> \\
        --testlist lists/dtu/test.txt --outdir ./out [--loadckpt model.ckpt]

The reference test.py save_depth contract (reference test.py:69-158) with
float PFM output. Per reference view it writes, under outdir/<scan>/:
  depth_est/NNNNNNNN.pfm     float depth, zeroed where confidence < 0.01
  confidence/NNNNNNNN.pfm    stage1 * stage2 * stage3 confidence
  cams/NNNNNNNN_cam.txt      MVSNet cam at model resolution
  images/NNNNNNNN.jpg        the (resized) reference image
and copies each scan's pair.txt, ready for fusion (``tools/fuse.py``).
Runs on CUDA unless ``--device cpu``: images are decoded, resized and
written on that device (nvJPEG on the card; PIL and cv2 on the CPU).
``--loadckpt`` takes a torch state dict in the reference's ``.ckpt``
layout. ``--batch_size`` samples go through the model at once, built by
the loader's threads.

Tanks and Temples (reference scripts/test_tnt.sh):

    python -m transmvsnet_tpu_torch.tools.infer --dataset tnt --datapath <TNT> \\
        --testlist lists/tnt/intermediate.txt --outdir ./out --num_view 11 \\
        --inverse_depth [--bucket_hw 1056,1920]
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np
import torch

from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.data.cams import write_cam_file
from transmvsnet_tpu_torch.data.datasets import GeneralEvalDataset, TnTEvalDataset, read_scan_list
from transmvsnet_tpu_torch.data.image_io import write_jpeg
from transmvsnet_tpu_torch.data.loader import ShardedLoader
from transmvsnet_tpu_torch.data.pfm import save_pfm
from transmvsnet_tpu_torch.data.registry import EVALUATION, get_dataset
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet, blended_confidence


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="TransMVSNet inference (PyTorch/CUDA)")
    p.add_argument("--dataset", default="general_eval", choices=sorted(EVALUATION))
    p.add_argument("--datapath", required=True)
    p.add_argument("--testlist", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--loadckpt", default="")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_view", type=int, default=5)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--max_h", type=int, default=864)
    p.add_argument("--max_w", type=int, default=1152)
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--depth_inter_r", default="4,1,0.5")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="activation dtype: float32 (the reference's numerics) or "
                        "bfloat16 (the faster path)")
    p.add_argument("--inverse_depth", action="store_true",
                   help="TnT: hypotheses uniform in inverse depth (reference "
                        "datasets/tnt_eval.py:174-182)")
    p.add_argument("--bucket_hw", default="",
                   help="TnT: resize every scene to one 'H,W' (default: per-scene native sizes)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference-layout state dict (optionally under "model" or
    "state_dict", keys optionally prefixed "module.")."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    sd = {
        k.removeprefix("module."): v for k, v in sd.items() if ".pos_encoding." not in k
    }
    model.load_state_dict(sd, strict=True)


def save_outputs(outdir, filename_tpl, depth, confidence, cam_pair, img):
    """One reference view's files; img is its float [H, W, 3] image as a
    tensor, whose device encodes the JPEG."""

    def path(kind, suffix):
        p = os.path.join(outdir, filename_tpl.format(kind, suffix))
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    save_pfm(path("depth_est", ".pfm"), depth.astype(np.float32))
    save_pfm(path("confidence", ".pfm"), confidence.astype(np.float32))
    write_cam_file(path("cams", "_cam.txt"), cam_pair)
    write_jpeg(path("images", ".jpg"), (img * 255.0).clamp(0, 255).to(torch.uint8))


def build_dataset(args, scans):
    cls = get_dataset(args.dataset)
    kwargs = dict(
        datapath=args.datapath,
        listfile=scans,
        nviews=args.num_view,
        ndepths=args.numdepth,
        interval_scale=args.interval_scale,
        device=args.device,
    )
    if cls is GeneralEvalDataset:
        kwargs.update(max_h=args.max_h, max_w=args.max_w)
    if cls is TnTEvalDataset:
        kwargs.update(inverse_depth=args.inverse_depth)
        if args.bucket_hw:
            h, w = (int(x) for x in args.bucket_hw.split(","))
            kwargs.update(bucket_hw=(h, w))
    return cls(**kwargs)


def main(argv=None) -> list[float]:
    """Runs inference; returns each batch's wall seconds (loader wait,
    forward, outputs written)."""
    args = parse_args(argv)
    scans = read_scan_list(args.testlist)
    dataset = build_dataset(args, scans)
    loader = ShardedLoader(dataset, args.batch_size, num_workers=2)

    cfg = ModelConfig(
        ndepths=tuple(int(x) for x in args.ndepths.split(",")),
        depth_interval_ratios=tuple(float(x) for x in args.depth_inter_r.split(",")),
        compute_dtype=args.dtype,
    )
    model = TransMVSNet(cfg, device=args.device)
    if args.loadckpt:
        load_checkpoint(model, args.loadckpt)
        print(f"loaded {args.loadckpt}")
    model.eval()
    dev = next(model.parameters()).device

    seconds = []
    t0 = time.perf_counter()
    for i, raw in enumerate(loader):
        imgs = torch.from_numpy(raw["imgs"]).to(dev)
        with torch.no_grad():
            out = model(
                imgs,
                {k: torch.from_numpy(v).to(dev) for k, v in raw["proj_matrices"].items()},
                torch.from_numpy(raw["depth_values"]).to(dev),
            )
            depth, conf = blended_confidence(out)
        depth, conf = depth.cpu().numpy(), conf.cpu().numpy()
        for b, filename in enumerate(raw["filename"]):
            save_outputs(args.outdir, filename, depth[b], conf[b],
                         raw["proj_matrices"]["stage3"][b, 0], imgs[b, 0])
        seconds.append(time.perf_counter() - t0)
        print(f"iter {i + 1}/{len(loader)} time {seconds[-1]:.3f}s res {depth.shape}")
        t0 = time.perf_counter()

    # Make each scan folder self-contained for fusion: copy pair.txt.
    for scan in scans:
        src = os.path.join(args.datapath, scan, "pair.txt")
        dst = os.path.join(args.outdir, scan, "pair.txt")
        if os.path.exists(src) and not os.path.exists(dst):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(src, dst)
    return seconds


if __name__ == "__main__":
    main()
