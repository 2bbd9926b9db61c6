#!/usr/bin/env python3
"""How far a step cell's trial cost spreads on one GPU.

    python3 scripts/step_cell_spread.py [--arch ARCH] [--shapes S ...]
        [--trials N] [--min-sample-s T ...] [--config KNOB=VALUE ...]
        [--deltas D ...]

For each shape of ``--shapes`` (default the card cells ``decode_card``,
``prefill_card``, ``train_card``) and each sample length of
``--min-sample-s``, runs ``--trials`` rounds; a round times one trial of
the tuner's baseline config (``launch/tune.py``) changed by ``--config``
(default bf16 compute, the incumbent when the walk reaches the sharding
stage) and then one trial of each ``--deltas`` change of it, in turn,
through the measured step evaluator the walks use
(``core/trial.WallClockEvaluator``, ``core/kernel_cell.STEP_REPEATS``
samples, no timing cache).  A delta is ``KNOB=VALUE[,KNOB=VALUE]``;
``-`` is the config itself.  Prints one JSON line per shape and sample
length: every trial's cost and peak device memory by delta, each
delta's median and spread ((max - min) / median), the spread of the
trials pooled over the deltas that run the same program on one device
(``-`` and the knobs of ``runtime/stepfn.ONE_DEVICE_NO_OPS``), and the
largest gap between two such deltas' medians — what the walk's 5 %
threshold has to clear; then the card's name and power limit.  Runs on
the card unless ``--device cpu`` is given (the arch's reduced config at
a small shape of each kind: a quick check).
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


def _value(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return {"True": True, "False": False}.get(text, text)


def _changes(text: str) -> dict:
    if text == "-":
        return {}
    return {k: _value(v) for k, v in (kv.split("=", 1)
                                      for kv in text.split(","))}


def _spread(xs) -> float:
    return (max(xs) - min(xs)) / statistics.median(xs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--shapes", nargs="+",
                    default=["decode_card", "prefill_card", "train_card"])
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--min-sample-s", type=float, nargs="+",
                    default=[0.0, 0.25, 1.0])
    ap.add_argument("--config", nargs="*",
                    default=["compute_dtype=bfloat16"],
                    help="KNOB=VALUE changes to the baseline config")
    ap.add_argument("--deltas", nargs="*",
                    default=["-", "shard_strategy=fsdp",
                             "shard_strategy=tp", "donate_buffers=False"])
    ap.add_argument("--device", default="cuda",
                    help="cpu: a quick check at the reduced config")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("step_cell_spread: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import trial
    from repro_torch.core.kernel_cell import STEP_REPEATS
    from repro_torch.launch.tune import _baseline
    from repro_torch.runtime.stepfn import ONE_DEVICE_NO_OPS
    if args.device == "cpu":
        from repro_torch.configs import get_reduced
        small = {"train": (32, 4), "prefill": (64, 2), "decode": (64, 2)}
        real = trial.get_shape
        trial.get_config = get_reduced
        trial.get_shape = lambda s: type(real(s))(
            s, *small[real(s).kind], real(s).kind)
    base = _baseline().replace(**_changes(",".join(args.config) or "-"))
    same = [d for d in args.deltas
            if set(_changes(d)) <= set(ONE_DEVICE_NO_OPS)]
    for shape in args.shapes:
        wl = trial.Workload(args.arch, shape)
        for min_s in args.min_sample_s:
            ev = trial.WallClockEvaluator(None, STEP_REPEATS, args.device,
                                          min_s)
            costs = {d: [] for d in args.deltas}
            peaks = {d: [] for d in args.deltas}
            for _ in range(args.trials):
                for d in args.deltas:
                    res = ev(wl, base.replace(**_changes(d)))
                    if res.crashed:
                        raise SystemExit(f"{shape} {d}: {res.error}")
                    costs[d].append(res.cost_s)
                    peaks[d].append(res.peak_bytes)
                    if args.device == "cuda":
                        torch.cuda.empty_cache()
            medians = {d: statistics.median(c) for d, c in costs.items()}
            pooled = [c for d in same for c in costs[d]]
            print(json.dumps({
                "arch": args.arch, "shape": shape, "config": args.config,
                "min_sample_s": min_s, "repeats": STEP_REPEATS,
                "trial_costs_s": costs, "peak_bytes": peaks,
                "median_s": medians,
                "spread": {d: _spread(c) for d, c in costs.items()},
                "same_program": same,
                "same_program_spread": _spread(pooled),
                "same_program_median_gap": (
                    max(medians[d] for d in same)
                    - min(medians[d] for d in same))
                / statistics.median(pooled)}), flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
