#!/usr/bin/env python3
"""Readings for the limits of a cell's comparison: the program's and the
control's, seed by seed, in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --calls <n>

For each seed it runs the cell's set-up and `--calls` calls of its window
(as many as a run compares, at the cell's own sizes) through the program,
then through the control that the configuration names (controls/), and
prints one JSON line per run with the numbers that the comparison reads.
The program's runs give the lower readings, the control's the upper.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--calls", type=int, required=True)
    args = p.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    _, config, _ = harness.cell_files(args.workload)
    control = importlib.import_module(f"perfbench.controls.{config['control']}")
    runs = [(int(s), "program", None) for s in args.seeds.split(",") if s]
    runs += [(int(s), "control", control) for s in args.control_seeds.split(",") if s]
    for seed, side, api in runs:
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, float("inf"), False, device="cuda", api=api,
                          max_calls=args.calls, cold=False)
        checks = harness.check(res, "cuda")
        print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                          "correct": harness.passed(checks), "calls": len(res["window"].latencies_s),
                          "seconds": time.perf_counter() - t0,
                          "checks": {k: v["value"] for k, v in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
