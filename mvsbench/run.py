"""Run one cell of BENCHMARK.json once and print its result line.

    python -m mvsbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and scenes from the seed, the program's kernels built or
loaded from build/kernels/, the cell's shapes warmed), the window of
``--seconds``, with ``--trace 1`` a profiled slice after it, then the
check against the plain reference. The last line of standard output is
the result as JSON; the numbers compared, each beside its limit, are the
last lines of standard error and the result's last key. Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result and
exits 2; if JAX, Flax or the JAX package is loaded once the window has
closed, it exits 3.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from mvsbench import harness

    cell = harness.load_cell(args.workload, args.seconds)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", STARTED, cell=cell)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        limit = "not compared" if c["limit"] is None else f"limit {c['limit']!r}"
        print(f"check {name}: {c['value']!r} ({limit})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
