#!/usr/bin/env python3
"""How far a serve cell's trial cost spreads on one GPU.

    python3 scripts/serve_cell_spread.py [--cell SPEC] [--trials N]
        [--replays 1 3 5] [--delta KNOB=VALUE ...]

Runs the trial of ``--cell`` (default ``serve:smollm-135m:poisson_card``)
under the tuner's baseline config (``launch/tune.py``), changed by each
``--delta``, ``--trials`` times back to back for each replay count of
``--replays``, through the serve evaluator the campaign uses
(``serving/evaluator.ServeEvaluator``; a trial's cost is its median
replay's).  Prints one JSON line per replay count: every trial's cost,
every replay's cost, the trial costs' median and spread ((max - min) /
median, which the walk's 5 % threshold has to clear), the seconds a
trial held the card and the garbage collector's pauses in each trial;
then the card's name and power limit.  Runs on
the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _value(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return {"True": True, "False": False}.get(text, text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="serve:smollm-135m:poisson_card")
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--replays", type=int, nargs="+", default=[1, 3, 5])
    ap.add_argument("--delta", nargs="*", default=[],
                    help="KNOB=VALUE changes to the baseline config")
    ap.add_argument("--device", default="cuda",
                    help="cpu: a quick check at a *_tiny trace")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("serve_cell_spread: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    from chip_smoke import GcPauses
    from repro_torch.core.campaign import parse_cells
    from repro_torch.launch.tune import _baseline
    from repro_torch.serving.evaluator import ServeEvaluator
    wl = parse_cells(args.cell)[0].workload()
    rt = _baseline().replace(**{k: _value(v) for k, v in
                                (kv.split("=", 1) for kv in args.delta)})
    ev = ServeEvaluator(device=args.device)
    for replays in args.replays:
        costs, runs, held, pauses = [], [], [], []
        for _ in range(args.trials):
            with GcPauses() as gc_pauses:
                stats = ev.replay(wl, rt, replays=replays)
            costs.append(ev.cost_of(stats))
            runs.append(stats.get("replay_costs", [costs[-1]]))
            held.append(stats["held_s"])
            pauses.append(gc_pauses.summary())
        med = statistics.median(costs)
        print(json.dumps({
            "cell": args.cell, "delta": args.delta, "replays": replays,
            "trial_costs_s": costs, "replay_costs_s": runs,
            "median_s": med, "spread": (max(costs) - min(costs)) / med,
            "held_s": held, "gc": pauses}), flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
