"""DTU benchmark CLI — the MATLAB BaseEvalMain/ComputeStat replacement.

  python -m transmvsnet_tpu_torch.tools.eval_dtu --plydir plys/ \
      --gtpath /data/dtu_eval   # official Points/stl + ObsMask layout
"""

from __future__ import annotations

import argparse
import json

from transmvsnet_tpu_torch.eval.dtu_eval import DTU_EVAL_SETS, evaluate_dtu


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DTU acc/comp evaluation")
    p.add_argument("--plydir", required=True)
    p.add_argument("--gtpath", required=True)
    p.add_argument(
        "--scans", default="", help="comma-separated scan ids (default: the 22)"
    )
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    scan_ids = (
        [int(s) for s in args.scans.split(",")] if args.scans else DTU_EVAL_SETS
    )
    result = evaluate_dtu(args.plydir, args.gtpath, scan_ids)
    per_scan = result.pop("per_scan")
    for sid, r in per_scan.items():
        print(
            f"scan{sid}: acc {r['acc_mean']:.4f} comp {r['comp_mean']:.4f} "
            f"overall {r['overall']:.4f}"
        )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
