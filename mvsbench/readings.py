"""The numbers that decide ``correct`` over many seeds in one process, to
set the limits from (see PERF.md): the program as the configuration
states, its bf16 control, or the program with a fault planted.

    python -m mvsbench.readings --workload dtu_infer --seeds 1,2,3 \\
        [--seconds 3] [--dtype bfloat16] [--fault half_batch] [--cudnn-tf32 0] [--out readings.jsonl]

One JSON line per seed, each from one ``harness.run`` at the cell's own
size with a short window; the kernels are built once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from mvsbench import faults, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--dtype", default=None, help="activation dtype in place of the configuration's")
    p.add_argument("--fault", default=None, choices=faults.FAULTS)
    p.add_argument("--cudnn-tf32", type=int, choices=[0, 1], default=None,
                   help="in place of the configuration's (0: a witness in full float32)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.load_cell(args.workload, args.seconds)
        if args.cudnn_tf32 is not None:
            cell.config["precision"]["cudnn_tf32"] = bool(args.cudnn_tf32)
        explain: dict = {}
        try:
            out = harness.run(args.workload, seed, args.seconds, False, "cuda:0", t0, args.dtype, cell,
                              args.fault, explain)
            checks = {k: c["value"] for k, c in out["checks"].items()}
            count, correct = out["attempted"], out["correct"]
        except RuntimeError as e:  # a control that crashes gives no number
            checks, count, correct = {"error": str(e)[:300]}, None, False
        leaves = {k: explain.pop(k, None) for k in ("grad", "update")}
        line = {"workload": args.workload, "seed": seed, "dtype": args.dtype, "fault": args.fault,
                "cudnn_tf32": cell.config["precision"]["cudnn_tf32"], "count": count, "correct": correct,
                "seconds": time.perf_counter() - t0, "checks": checks,
                "worst_leaves": {k: sorted(v.items(), key=lambda kv: -kv[1])[:4] for k, v in leaves.items() if v},
                **explain}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps({**line, "leaves": leaves}) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
