"""Apply the paper's trial-and-error methodology to workload cells, on
the card.

    PYTHONPATH=src python -m repro_torch.launch.tune \\
        --arch smollm-135m --shape decode_card
    PYTHONPATH=src python -m repro_torch.launch.tune \\
        --cells serve:smollm-135m:poisson_card,kernel:rmsnorm:tiny
    PYTHONPATH=src python -m repro_torch.launch.tune \\
        --cells smollm-135m:prefill_card,smollm-135m:train_card
    PYTHONPATH=src python -m repro_torch.launch.tune --device cpu \\
        --cells serve:smollm-135m:poisson_tiny --fresh --checkpoint-dir DIR

This is the PyTorch port of the reference's ``launch/tune.py``.  Every
trial is a measured run on ``--device`` (default ``cuda``; with no card
this raises unless ``--device cpu`` is given).

Single-cell mode (``--arch/--shape``) walks one step cell with the
measured step evaluator (core/trial.WallClockEvaluator: the median of
real steps), where the reference's single-cell mode is roofline-only;
its report goes to ``results/torch/tuning/`` (``<checkpoint
dir>/reports/`` with ``--checkpoint-dir``).  Campaign mode (``--cells``)
runs a batch of cells in one concurrent campaign (core/campaign.py);
every cell's cursor interleaves over one shared executor, per-cell state
checkpoints under ``results/torch/campaign/`` (or ``--checkpoint-dir``),
an interrupted campaign resumes without re-paying completed trials, and
per-cell reports go to ``results/torch/tuning/`` (``<checkpoint
dir>/reports/`` with ``--checkpoint-dir``).  ``arch:shape`` step cells
time the model step (the same evaluator), ``kernel:<name>:<shape>``
cells one hand-written kernel (core/kernel_cell.py),
``serve:<arch>:<trace>`` cells replay a traffic trace through the port's
scheduler (serving/evaluator.py).  The card-sized step shapes
(``train_card``, ``prefill_card``, ``decode_card``; configs/base.py)
are reached by name; ``decode_card`` decodes at its last row
(``ShapeConfig.cache_filled``).

``--strategy`` picks the search procedure (core/strategy.py): ``tree``
(default, the paper's Fig.-4 ≤10-trial tuning tree), ``short``,
``sensitivity`` (``--sweep-knobs``), ``random`` and ``model``
(``--budget``, ``--seed``, ``--model-min-records``, ``--model-top-k``).
``--warm-start``, ``--prioritize``, the trial hardening flags
(``--trial-timeout``, ``--max-retries``, ``--strike-threshold``), the
measured re-rank (``--measure-top-k``), the serving guard and promotion
(``--slo-ttft``, ``--promote``) and telemetry (``--trace``,
``--trace-out``) behave as in the reference.

Not ported yet (ROADMAP.md queue A, slice 6), each raising
``NotImplementedError`` that names its slice: the fabric, worker and
intake flags (``--worker``, ``--workers``, ``--coordinate``,
``--add-cells``, ``--status``, ``--stop``, ``--watch``, ``--all``,
``--evaluator``, ``--measured-evaluator``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

from repro_torch.core import report
from repro_torch.core.params import SENSITIVITY_SWEEP, default_config

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "torch" / "tuning"

SLICE_6 = "ROADMAP.md queue A, slice 6: the fleet"
# the reference's fabric, worker and intake flags: switches, then flags
# that take a value
FLEET_SWITCHES = ("--all", "--watch", "--status", "--stop", "--worker",
                  "--coordinate", "--json")
FLEET_VALUES = ("--workers", "--add-cells", "--dir", "--evaluator",
                "--measured-evaluator")


def _baseline(overrides=None):
    # attn_impl=pallas is infrastructure (the hand-written kernels), not
    # one of the 12 tunables; shard_strategy reaches nothing on one device
    return default_config(shard_strategy="fsdp_tp", attn_impl="pallas",
                          **(overrides or {}))


def _strategy_options(strategy, sweep_knobs=None, budget=None, seed=None,
                      model_min_records=None, model_top_k=None):
    """CLI flags -> the strategy's cursor-factory options."""
    if strategy in ("sensitivity",) and sweep_knobs:
        names = [k.strip() for k in sweep_knobs.split(",") if k.strip()]
        unknown = [k for k in names if k not in SENSITIVITY_SWEEP]
        if unknown:
            raise ValueError(
                f"--sweep-knobs: {', '.join(unknown)} not in the "
                f"sensitivity sweep ({', '.join(SENSITIVITY_SWEEP)})")
        return {"knobs": {k: SENSITIVITY_SWEEP[k] for k in names}}
    if strategy in ("random", "model"):
        opts = {}
        if budget is not None:
            opts["budget"] = budget
        if seed is not None:
            opts["seed"] = seed
        if strategy == "model":
            if model_min_records is not None:
                opts["min_records"] = model_min_records
            if model_top_k is not None:
                opts["top_k"] = model_top_k
        return opts
    return {}


def _save_cell_report(rep, strategy: str = "tree",
                      out_dir: pathlib.Path = None) -> None:
    # non-tree strategies write under <dir>/<strategy>/ so two strategies
    # on the same cell never clobber each other's report
    out_dir = out_dir or RESULTS_DIR
    if strategy != "tree":
        out_dir = out_dir / strategy
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{rep.workload}.json").write_text(
        json.dumps(dataclasses.asdict(rep), indent=1, default=str))
    (out_dir / f"{rep.workload}.md").write_text(
        report.cell_markdown(rep))


def tune_cell(arch: str, shape: str, multi_pod: bool = False,
              threshold: float = 0.05, baseline_overrides=None,
              strategy: str = "tree", strategy_options=None,
              device="cuda", evaluator=None, timing_dir=None,
              out_dir=None):
    """Single-cell mode: one strategy walk over one step cell, every
    trial a measured step on ``device`` (the campaign's step evaluator,
    :func:`~repro_torch.core.kernel_cell.step_evaluator`, unless one is
    given), one trial at a time.
    The report goes to ``out_dir`` (default ``results/torch/tuning``)."""
    from repro_torch.core.executor import SweepExecutor
    from repro_torch.core.kernel_cell import step_evaluator
    from repro_torch.core.strategy import drive, make_cursor
    from repro_torch.core.trial import TrialRunner, Workload
    from repro_torch.models.model import resolve_device
    resolve_device(device)
    wl = Workload(arch, shape, multi_pod)
    evaluator = evaluator or step_evaluator(device, timing_dir)
    baseline = _baseline(baseline_overrides)
    with SweepExecutor(evaluator, max_workers=1) as executor:
        runner = TrialRunner(wl, executor.evaluator)
        cursor = make_cursor(strategy, runner, baseline,
                             threshold=threshold, options=strategy_options)
        rep = drive(cursor, executor=executor)
    _save_cell_report(rep, strategy, out_dir)
    return rep


def _print_cell_summary(rep) -> None:
    if hasattr(rep, "speedup"):
        print(f"\nspeedup: x{rep.speedup:.2f} in {rep.n_trials} trials")
    else:
        top = max(rep.impacts, key=lambda i: i.mean_abs_pct)
        print(f"\ntop knob: {top.knob} ({top.mean_abs_pct:.1f}% mean "
              f"|deviation|) in {rep.n_trials} trials")


def campaign_dir(strategy: str = "tree", override=None) -> pathlib.Path:
    """The per-strategy campaign directory: checkpoints and the trial
    history live here.  Non-tree strategies get a subdirectory so two
    strategies on the same cells never clobber each other's state."""
    from repro_torch.core.campaign import CAMPAIGN_DIR
    if override:
        return pathlib.Path(override)
    return CAMPAIGN_DIR if strategy == "tree" else CAMPAIGN_DIR / strategy


def fresh_campaign_dir(ckpt: pathlib.Path, cells) -> None:
    """``--fresh``: discard the cells' checkpoints, the *whole* intake
    (a stale submission must not re-admit a foreign cell into the fresh
    campaign) and stale cross-cell summaries.  The trial history is
    deliberately kept (``--warm-start``).  The port has no fabric, so
    there are no leases to clear."""
    from repro_torch.core.schedule import clear_intake
    for spec in cells:
        path = ckpt / f"{spec.key()}.json"
        if path.exists():
            path.unlink()
    clear_intake(ckpt)
    for name in ("campaign.md", "campaign_stats.json"):
        if (ckpt / name).exists():
            (ckpt / name).unlink()


def _serving_board_markdown(ckpt: pathlib.Path) -> str:
    """The promotion-board section of the campaign summary ('' when the
    directory has no serving board yet)."""
    from repro_torch.serving.canary import PromotionBoard
    board = PromotionBoard(ckpt)
    live = {p.stem: board.live(p.stem)
            for p in sorted(board.live_dir.glob("*.json"))}
    history = board.history()
    if not live and not history:
        return ""
    return report.serving_markdown(live, history)


def _write_campaign_summary(ckpt: pathlib.Path, reports, stats) -> None:
    from repro_torch.core import telemetry as _telemetry
    ckpt.mkdir(parents=True, exist_ok=True)
    text = report.strategy_markdown(reports, queue=stats.get("queue"))
    serving = _serving_board_markdown(ckpt)
    if serving:
        text = text.rstrip("\n") + "\n\n" + serving + "\n"
    metrics = _telemetry.load_metrics(ckpt)
    if metrics:                          # untraced output unchanged
        text = text.rstrip("\n") + "\n\n" \
            + report.telemetry_markdown(metrics) + "\n"
    (ckpt / "campaign.md").write_text(text)
    (ckpt / "campaign_stats.json").write_text(
        json.dumps(stats, indent=1))


def tune_campaign(cells, threshold: float = 0.05, baseline_overrides=None,
                  fresh: bool = False, checkpoint_dir=None,
                  strategy: str = "tree", strategy_options=None,
                  evaluator=None, warm_start: bool = False,
                  prioritize: str = "arch", intake: bool = True,
                  trial_timeout_s=None, max_retries: int = 0,
                  strike_threshold=None, measure_top_k: int = 0,
                  measured_evaluator=None, slo_ttft=None,
                  promote: bool = False, trace: bool = False,
                  device="cuda", timing_dir=None):
    """Run a strategy over a batch of cells in one concurrent campaign
    on ``device``; returns ``{cell_key: report}`` plus the campaign's
    throughput stats.  The default evaluators are the dispatch stack
    and, with ``measure_top_k > 0``, the measured tier, both on
    ``device`` (which must exist: with no card, ``"cuda"`` raises),
    with their timing caches in ``timing_dir`` (default: the port's
    ``results/torch/trials/timings``).  They time one trial at a time
    on the device, so the campaign then walks its cells with one
    worker."""
    from repro_torch.core.campaign import Campaign
    from repro_torch.core.kernel_cell import DispatchEvaluator
    from repro_torch.models.model import resolve_device
    resolve_device(device)
    ckpt = campaign_dir(strategy, checkpoint_dir)
    if fresh:
        fresh_campaign_dir(ckpt, cells)
    if trace:
        # observability only — the campaign's decisions are
        # bit-identical with tracing on or off
        from repro_torch.core import telemetry as _telemetry
        ckpt.mkdir(parents=True, exist_ok=True)
        _telemetry.install(_telemetry.Telemetry(ckpt))
    own_evaluator = evaluator is None
    if own_evaluator:
        evaluator = DispatchEvaluator(slo_ttft=slo_ttft, device=device,
                                      cache_dir=timing_dir)
    if measured_evaluator is None and measure_top_k:
        from repro_torch.core.measure import default_measured_evaluator
        measured_evaluator = default_measured_evaluator(
            cache_dir=timing_dir, device=device)
    camp = Campaign(
        cells, strategy=strategy, strategy_options=strategy_options,
        threshold=threshold, checkpoint_dir=ckpt, evaluator=evaluator,
        warm_start=warm_start, prioritize=prioritize, intake=intake,
        trial_timeout_s=trial_timeout_s, max_retries=max_retries,
        strike_threshold=strike_threshold,
        measure_top_k=measure_top_k,
        measured_evaluator=measured_evaluator,
        max_workers=1 if own_evaluator else None,
        baseline_factory=lambda spec: _baseline(baseline_overrides))
    reports = camp.run()
    if trace:
        from repro_torch.core import telemetry as _telemetry
        _telemetry.publish_metrics(ckpt)
    out_dir = ckpt / "reports" if checkpoint_dir else None
    for rep in reports.values():
        _save_cell_report(rep, strategy, out_dir)
    if promote:
        from repro_torch.serving.canary import promote_winners
        promote_winners(ckpt, reports, source=f"campaign:{strategy}")
    _write_campaign_summary(ckpt, reports, camp.last_stats)
    return reports, camp.last_stats


def run_trace_out(args) -> int:
    """``--trace-out``: fold the campaign directory's recorded event
    stream into Chrome-trace/Perfetto JSON, then exit."""
    from repro_torch.core import telemetry as _telemetry
    ckpt = campaign_dir(args.strategy, args.checkpoint_dir)
    n = _telemetry.export_chrome_trace(ckpt, args.trace_out)
    src = ckpt / _telemetry.EVENTS_NAME
    if not n:
        print(f"no events recorded in {src} (run with --trace); "
              f"wrote an empty trace to {args.trace_out}")
        return 1
    print(f"wrote {n} trace event(s) from {src} -> {args.trace_out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", help="single-cell mode: arch id")
    ap.add_argument("--shape", help="single-cell mode: shape id "
                                    "(a reference shape or *_card)")
    ap.add_argument("--cells",
                    help="campaign mode: comma-separated cell specs "
                         "(arch:shape[:pod|multipod], "
                         "kernel:<name>:<shape>, serve:<arch>:<trace>)")
    ap.add_argument("--device", default="cuda",
                    help="device every trial runs on (default cuda; "
                         "cpu runs the kernels' plain versions)")
    ap.add_argument("--checkpoint-dir",
                    help="campaign directory: checkpoints, history, "
                         "telemetry, campaign.md and the per-cell "
                         "reports (default: results/torch/campaign/ "
                         "per strategy)")
    ap.add_argument("--strategy", default="tree",
                    choices=["tree", "short", "sensitivity", "random",
                             "model"],
                    help="search strategy (core/strategy.py registry)")
    ap.add_argument("--sweep-knobs",
                    help="sensitivity strategy: comma-separated knob "
                         "subset (default: the full SENSITIVITY_SWEEP)")
    ap.add_argument("--budget", type=int,
                    help="random/model strategies: trial budget "
                         "(default 10)")
    ap.add_argument("--seed", type=int,
                    help="random/model strategies: sampling seed "
                         "(default 0)")
    ap.add_argument("--model-min-records", type=int, default=None,
                    metavar="N",
                    help="model strategy: below N usable same-kind "
                         "history records the cell falls back to the "
                         "tree walk (default 24)")
    ap.add_argument("--model-top-k", type=int, default=None, metavar="K",
                    help="model strategy: predicted configs proposed "
                         "per batch (default 3)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--threshold", type=float, default=0.05)
    ap.add_argument("--fresh", action="store_true",
                    help="discard the cells' checkpoints and intake "
                         "submissions, re-tune (the trial history is "
                         "kept)")
    ap.add_argument("--prioritize", default="arch",
                    choices=["arch", "history"],
                    help="cell scheduling order (core/schedule.py)")
    ap.add_argument("--warm-start", action="store_true",
                    help="seed fresh cells from the best configs of "
                         "the nearest already-tuned cells in the trial "
                         "history")
    ap.add_argument("--trial-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="per-trial evaluation deadline (default: none)")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="re-evaluate transient failures up to N times "
                         "(default 0)")
    ap.add_argument("--strike-threshold", type=int, default=None,
                    help="quarantine a config after this many strikes "
                         "(default 3)")
    ap.add_argument("--measure-top-k", type=int, default=0, metavar="K",
                    help="after each cell's walk, re-evaluate its top-K "
                         "surviving configs and publish the measured "
                         "winner (default 0: off)")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    metavar="FACTOR",
                    help="SLO guardrail for serve cells: abort any "
                         "candidate whose TTFT or queue delay exceeds "
                         "FACTOR x the incumbent's (default: off)")
    ap.add_argument("--promote", action="store_true",
                    help="publish each serve cell's surviving winner to "
                         "the campaign directory's live-config board")
    ap.add_argument("--trace", action="store_true",
                    help="record telemetry (events.jsonl, metrics.json) "
                         "in the campaign directory; decisions are "
                         "bit-identical with tracing on or off")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="export the campaign directory's recorded "
                         "events as Chrome-trace/Perfetto JSON, then exit")
    unported = ap.add_argument_group(
        "not ported yet (each raises NotImplementedError)")
    for flag in FLEET_SWITCHES:
        unported.add_argument(flag, action="store_true",
                              help=f"fabric/intake ({SLICE_6})")
    for flag in FLEET_VALUES:
        unported.add_argument(flag, help=f"fabric/intake ({SLICE_6})")
    args = ap.parse_args(argv)

    fleet = [flag for flag in FLEET_SWITCHES + FLEET_VALUES
             if getattr(args, flag[2:].replace("-", "_"))]
    if fleet:
        raise NotImplementedError(
            f"{', '.join(fleet)}: the fabric, worker and intake flags are "
            f"not ported yet ({SLICE_6})")
    if args.trace_out:
        if args.cells or args.fresh or args.trace:
            ap.error("--trace-out is a standalone export; drop "
                     "--cells/--fresh/--trace or run it separately")
        return run_trace_out(args)
    if args.sweep_knobs and args.strategy != "sensitivity":
        ap.error("--sweep-knobs only applies to --strategy sensitivity")
    if (args.budget is not None or args.seed is not None) \
            and args.strategy not in ("random", "model"):
        ap.error("--budget/--seed only apply to --strategy random/model")
    if (args.model_min_records is not None
            or args.model_top_k is not None) and args.strategy != "model":
        ap.error("--model-min-records/--model-top-k only apply to "
                 "--strategy model")
    if args.measure_top_k < 0:
        ap.error("--measure-top-k must be >= 0")
    if args.slo_ttft is not None and args.slo_ttft <= 0:
        ap.error("--slo-ttft is a multiplier over the incumbent's "
                 "replay stats; it must be > 0 (e.g. 3.0)")
    options = _strategy_options(
        args.strategy, args.sweep_knobs, args.budget, args.seed,
        model_min_records=args.model_min_records,
        model_top_k=args.model_top_k)
    if not args.cells:
        return _single_cell(ap, args, options)
    from repro_torch.core.campaign import parse_cells
    cells = parse_cells(args.cells, default_multi_pod=args.multi_pod)
    reports, stats = tune_campaign(
        cells, threshold=args.threshold, fresh=args.fresh,
        checkpoint_dir=args.checkpoint_dir, strategy=args.strategy,
        strategy_options=options, warm_start=args.warm_start,
        prioritize=args.prioritize, trial_timeout_s=args.trial_timeout,
        max_retries=args.max_retries,
        strike_threshold=args.strike_threshold,
        measure_top_k=args.measure_top_k, slo_ttft=args.slo_ttft,
        promote=args.promote, trace=args.trace, device=args.device)
    print(report.strategy_markdown(reports, queue=stats.get("queue")))
    print(f"\n[{stats['strategy']}] {stats['cells']} cells in "
          f"{stats['wall_s']}s ({stats['cells_per_hour']} cells/h; "
          f"{stats['evaluated_trials']} trials evaluated, "
          f"{stats['replayed_trials']} replayed from checkpoint)")
    return 0


def _single_cell(ap, args, options) -> int:
    if not (args.arch and args.shape):
        ap.error("need --arch and --shape, or --cells")
    if args.measure_top_k:
        ap.error("--measure-top-k applies to campaign mode (--cells); "
                 "single-cell mode is already measured")
    if args.trace:
        ap.error("--trace records telemetry into the campaign directory; "
                 "it applies to campaign mode (--cells)")
    out_dir = pathlib.Path(args.checkpoint_dir) / "reports" \
        if args.checkpoint_dir else None
    rep = tune_cell(args.arch, args.shape, args.multi_pod, args.threshold,
                    strategy=args.strategy, strategy_options=options,
                    device=args.device, out_dir=out_dir)
    print(report.cell_markdown(rep))
    _print_cell_summary(rep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
