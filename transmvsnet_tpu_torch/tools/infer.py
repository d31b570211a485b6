"""Inference CLI: depth maps and confidence over evaluation scans.

    python -m transmvsnet_tpu_torch.tools.infer --datapath <DTU_TEST> \\
        --testlist lists/dtu/test.txt --outdir ./out [--loadckpt model.ckpt]

The reference test.py save_depth contract (reference test.py:69-158) with
float PFM output. Per reference view it writes, under outdir/<scan>/:
  depth_est/NNNNNNNN.pfm     float depth, zeroed where confidence < 0.01
  confidence/NNNNNNNN.pfm    stage1 * stage2 * stage3 confidence
  cams/NNNNNNNN_cam.txt      MVSNet cam at model resolution
  images/NNNNNNNN.jpg        the (resized) reference image
and copies each scan's pair.txt, ready for fusion. Runs on CUDA unless
``--device cpu``. ``--loadckpt`` takes a torch state dict in the
reference's ``.ckpt`` layout.
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
from transmvsnet_tpu_torch.data.datasets import GeneralEvalDataset, read_scan_list
from transmvsnet_tpu_torch.data.pfm import save_pfm
from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet, blended_confidence

DATASETS = {"general_eval": GeneralEvalDataset, "synthetic": SyntheticDataset}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="TransMVSNet inference (PyTorch/CUDA)")
    p.add_argument("--dataset", default="general_eval", choices=sorted(DATASETS))
    p.add_argument("--datapath", required=True)
    p.add_argument("--testlist", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--loadckpt", default="")
    p.add_argument("--num_view", type=int, default=5)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--max_h", type=int, default=864)
    p.add_argument("--max_w", type=int, default=1152)
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--depth_inter_r", default="4,1,0.5")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                   help="activation dtype; the CUDA kernels take bfloat16, so float32 "
                        "runs only with --device cpu")
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
    import cv2

    def path(kind, suffix):
        p = os.path.join(outdir, filename_tpl.format(kind, suffix))
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    save_pfm(path("depth_est", ".pfm"), depth.astype(np.float32))
    save_pfm(path("confidence", ".pfm"), confidence.astype(np.float32))
    write_cam_file(path("cams", "_cam.txt"), cam_pair)
    img_u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    cv2.imwrite(path("images", ".jpg"), cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR))


def main(argv=None):
    args = parse_args(argv)
    scans = read_scan_list(args.testlist)
    kwargs = dict(
        datapath=args.datapath,
        listfile=scans,
        nviews=args.num_view,
        ndepths=args.numdepth,
        interval_scale=args.interval_scale,
    )
    if args.dataset == "general_eval":
        kwargs.update(max_h=args.max_h, max_w=args.max_w)
    dataset = DATASETS[args.dataset](**kwargs)

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

    for i in range(len(dataset)):
        t0 = time.time()
        sample = dataset[i]
        with torch.no_grad():
            out = model(
                torch.from_numpy(sample["imgs"][None]).to(dev),
                {k: torch.from_numpy(v[None]).to(dev) for k, v in sample["proj_matrices"].items()},
                torch.from_numpy(sample["depth_values"][None]).to(dev),
            )
            depth, conf = blended_confidence(out)
        depth, conf = depth[0].cpu().numpy(), conf[0].cpu().numpy()
        print(f"iter {i + 1}/{len(dataset)} time {time.time() - t0:.3f}s res {depth.shape}")
        save_outputs(
            args.outdir,
            sample["filename"],
            depth,
            conf,
            sample["proj_matrices"]["stage3"][0],
            sample["imgs"][0],
        )

    # Make each scan folder self-contained for fusion: copy pair.txt.
    for scan in scans:
        src = os.path.join(args.datapath, scan, "pair.txt")
        dst = os.path.join(args.outdir, scan, "pair.txt")
        if os.path.exists(src) and not os.path.exists(dst):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(src, dst)


if __name__ == "__main__":
    main()
