"""Fusion CLI: depth maps -> point clouds, on the device (reference
dynamic_fusion.py CLI).

    python -m transmvsnet_tpu_torch.tools.fuse --testpath out/ --testlist list.txt \\
        --outdir plys/ --test_dataset dtu --photo_threshold 0.3 --thres_view 3

The JAX CLI's flags and routing, plus ``--device``. ``--num_workers``
(default 8) fuses that many scans at once with ``dynamic`` and ``normal``
(``fusion/dynamic.py::fuse_scans``: spawned processes, as the JAX CLI's
process pool has; one worker or one scan runs in this process); each PLY
is byte-identical to a one-worker run's and the "wrote" lines follow the
testlist. As in the JAX CLI, ``native`` takes the flag and ignores it.
``--filter_method native``
is the fusibile role (``fusion/native.py``: the C++ binary's consistency
test as the CUDA kernel ``csrc/native_fuse.cu``), with ``--disp_threshold``
and ``--num_consistent``. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from transmvsnet_tpu_torch.fusion.dynamic import FusionParams, fuse_scans
from transmvsnet_tpu_torch.fusion.native import native_fuse_scans


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Depth-map fusion (PyTorch/CUDA)")
    p.add_argument("--testpath", required=True, help="per-scan outputs root")
    p.add_argument("--testlist", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--filter_method", default="dynamic", choices=["dynamic", "normal", "native"],
                   help="dynamic = the vote ladder (reference dynamic_fusion.py); normal = the "
                        "fixed-threshold filter (reference README.md:149-152; 1 px / 0.01 "
                        "relative depth over >= thres_view views); native = the disparity test of "
                        "the C++ tpu_fuser binary as a CUDA kernel (the fusibile role, reference "
                        "gipuma.py)")
    p.add_argument("--photo_threshold", type=float, default=None)
    p.add_argument("--thres_view", type=int, default=3)
    p.add_argument("--dist_scale", type=float, default=1.0)
    p.add_argument("--rel_diff_scale", type=float, default=1.0)
    p.add_argument("--geo_pixel_thres", type=float, default=1.0)
    p.add_argument("--geo_depth_thres", type=float, default=0.01)
    p.add_argument("--disp_threshold", type=float, default=0.25)
    p.add_argument("--num_consistent", type=int, default=3)
    p.add_argument("--test_dataset", default="dtu", choices=["dtu", "tnt"])
    p.add_argument("--num_workers", type=int, default=8,
                   help="scans fused at once (dynamic, normal); native ignores it, as the JAX CLI does")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    with open(args.testlist) as f:
        scans = [line.rstrip() for line in f if line.strip()]
    if args.filter_method == "native":
        outputs = native_fuse_scans(args.testpath, scans, args.outdir, disp_threshold=args.disp_threshold,
                                    num_consistent=args.num_consistent, dataset=args.test_dataset,
                                    device=args.device)
    else:
        # Per-dataset confidence default: 0.3 DTU / 0.18 TnT for the dynamic
        # ladder (reference dynamic_fusion.py:182, scripts/test_tnt.sh:30);
        # the normal filter's is the MVSNet family's 0.9.
        photo = args.photo_threshold
        if photo is None:
            if args.filter_method == "normal":
                photo = 0.9
            else:
                photo = 0.18 if args.test_dataset == "tnt" else 0.3
        params = FusionParams(
            photo_threshold=photo,
            thres_view=args.thres_view,
            dist_scale=args.dist_scale,
            rel_diff_scale=args.rel_diff_scale,
            mode=args.filter_method,
            geo_pixel_thres=args.geo_pixel_thres,
            geo_depth_thres=args.geo_depth_thres,
        )
        outputs = fuse_scans(args.testpath, scans, args.outdir, params, dataset=args.test_dataset,
                             device=args.device, num_workers=args.num_workers)
    for o in outputs:
        print("wrote", o)


if __name__ == "__main__":
    main()
