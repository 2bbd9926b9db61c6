#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--traced-seeds 4,5,6] [--seconds 8]

In one process, for each seed: one run of the cell (``run.execute``,
with a short window at the cell's own load, traced for the traced
seeds), whose compared numbers are the program's readings; and, for
each control seed, the control's readings on the same inputs: the fp8
reference's logits and first choices at the served prompts and tokens
(``judge.control_gap``).  Prints one JSON line per seed, and last the
largest reading of the program and the smallest of the control, per
number.
"""
from __future__ import annotations

import gc
import json
import sys
import time

import run as harness  # noqa: E402  (portbench/run.py, this directory)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--traced-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--root", default=str(harness.ROOT),
                    help="the checkout whose BENCHMARK.json and portbench/ "
                         "are read")
    args = ap.parse_args(argv)
    harness._env()
    import torch
    from portbench import judge, spec
    bench = spec.Bench(args.root)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    traced = {int(s) for s in args.traced_seeds.split(",") if s}
    prog_max, ctrl_min = {}, {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = harness.context(bench, args.workload, seed, args.seconds,
                              seed in traced, args.device)
        ctx.t_start = time.time()
        out = harness.execute(ctx)
        line = {"seed": seed, "correct": out["correct"],
                "program": dict(ctx.readings),
                "metrics": {k: m["value"] for k, m in out["metrics"].items()}}
        for k, v in line["program"].items():
            prog_max[k] = max(prog_max.get(k, v), v)
        if seed in controls:
            line["control"] = judge.control_gap(
                ctx, ctx.judged_rows, int(ctx.mix["pad_to"]))
            for k, v in line["control"].items():
                ctrl_min[k] = min(ctrl_min.get(k, v), v)
        print(json.dumps(line), flush=True)
        del ctx, out
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    print(json.dumps({"program_max": prog_max, "control_min": ctrl_min}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
