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
    PYTHONPATH=src python -m repro_torch.launch.tune --workers 2 \\
        --dir DIR --trace --fresh --cells kernel:rmsnorm:tiny,...

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
measured re-rank (``--measure-top-k``, ``--measured-evaluator``), the
serving guard and promotion (``--slo-ttft``, ``--promote``) and
telemetry (``--trace``, ``--trace-out``) behave as in the reference;
``--all`` walks every cell of ``campaign.enumerate_cells``.

The fleet (core/fabric.py) behaves as in the reference: ``--workers N``
(or ``--coordinate``) spawns N local workers over one shared directory
(``--dir``, the same as ``--checkpoint-dir``) and waits; ``--worker``
joins one as a single worker; ``--add-cells`` submits cells to a running
campaign or fabric, ``--watch`` keeps workers claiming them, ``--stop``
ends the watch, ``--status [--json]`` prints the queue view.  Workers
time their trials on ``--device``, which the coordinator forwards, and
keep their timing caches in the shared directory's ``timings/``; the
workers of one card take turns on it trial by trial through its file
lock (core/trial.hold_device).
"""
from __future__ import annotations

import time

# taken before the imports below, which load torch: a --watch worker
# ignores a STOP sentinel older than its process
# (core/schedule.stop_requested_since)
_START_TS = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

from repro_torch.core import report  # noqa: E402
from repro_torch.core.params import (SENSITIVITY_SWEEP,  # noqa: E402
                                     default_config)

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "torch" / "tuning"


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
    """``--fresh``: discard the cells' checkpoints AND their leases, the
    *whole* intake (every submission plus any STOP sentinel: a stale
    submission must not re-admit a foreign cell into the fresh
    campaign) and stale cross-cell summaries.  The trial history is
    deliberately kept (``--warm-start``)."""
    from repro_torch.core.fabric import LeaseBoard
    from repro_torch.core.schedule import clear_intake
    for spec in cells:
        path = ckpt / f"{spec.key()}.json"
        if path.exists():
            path.unlink()
    LeaseBoard(ckpt).clear([spec.key() for spec in cells])
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


def _load_measured(args):
    """Resolve --measured-evaluator (None -> the campaign's default
    measured tier on the device, built only when K > 0)."""
    if not args.measured_evaluator:
        return None
    from repro_torch.core.fabric import load_evaluator
    return load_evaluator(args.measured_evaluator)


def _reports_dir(args):
    """Where a run's per-cell reports go: ``<dir>/reports`` when a
    directory is given, else ``results/torch/tuning``."""
    return pathlib.Path(args.checkpoint_dir) / "reports" \
        if args.checkpoint_dir else None


def run_worker(args, cells, options) -> int:
    """``--worker``: one fabric worker over a shared directory, its
    trials on ``--device`` (which must exist)."""
    from repro_torch.core.fabric import TIMINGS_DIR, FabricWorker, \
        load_evaluator
    from repro_torch.models.model import resolve_device
    device = resolve_device(args.device)
    ckpt = campaign_dir(args.strategy, args.checkpoint_dir)
    evaluator = max_workers = None
    if args.evaluator:
        evaluator = load_evaluator(args.evaluator)
    elif args.slo_ttft is not None:
        # default dispatch stack with the serve tier's SLO guard armed
        from repro_torch.core.kernel_cell import DispatchEvaluator
        evaluator = DispatchEvaluator(slo_ttft=args.slo_ttft, device=device,
                                      cache_dir=ckpt / TIMINGS_DIR)
        max_workers = 1
    worker = FabricWorker(
        cells, ckpt, strategy=args.strategy, strategy_options=options,
        threshold=args.threshold,
        evaluator=evaluator,
        baseline_factory=lambda spec: _baseline(),
        worker_id=args.worker_id, ttl_s=args.worker_ttl,
        warm_start=args.warm_start, max_workers=max_workers,
        prioritize=args.prioritize, watch=args.watch,
        started_at=_START_TS,
        ready_file=pathlib.Path(args.ready_file)
        if args.ready_file else None,
        go_file=pathlib.Path(args.go_file) if args.go_file else None,
        trial_timeout_s=args.trial_timeout,
        max_retries=args.max_retries,
        strike_threshold=args.strike_threshold,
        measure_top_k=args.measure_top_k,
        measured_evaluator=_load_measured(args),
        promote=args.promote, trace=args.trace, device=device)
    stats = worker.run()
    print(json.dumps(stats, indent=1))
    return 0


def run_fabric(args, cells, options) -> int:
    """``--workers N`` / ``--coordinate``: spawn local workers over the
    per-strategy campaign directory, on ``--device``, wait, summarize."""
    from repro_torch.core.fabric import run_coordinator
    from repro_torch.models.model import resolve_device
    resolve_device(args.device)
    ckpt = campaign_dir(args.strategy, args.checkpoint_dir)
    if args.fresh:
        fresh_campaign_dir(ckpt, cells)
    n = args.workers or 2
    out = run_coordinator(
        cells, ckpt, workers=n, strategy=args.strategy,
        strategy_options=options,
        evaluator_spec=args.evaluator, ttl_s=args.worker_ttl,
        threshold=args.threshold, warm_start=args.warm_start,
        prioritize=args.prioritize, watch=args.watch,
        trial_timeout_s=args.trial_timeout,
        max_retries=args.max_retries,
        strike_threshold=args.strike_threshold,
        measure_top_k=args.measure_top_k,
        measured_evaluator_spec=args.measured_evaluator,
        slo_ttft=args.slo_ttft, promote=args.promote,
        trace=args.trace,
        extra_args=_worker_passthrough(args),
        log_dir=ckpt / "worker_logs", device=args.device)
    reports, stats = out["reports"], out["stats"]
    if args.trace:
        # final coordinator-side fold over every worker's events
        from repro_torch.core import telemetry as _telemetry
        _telemetry.publish_metrics(ckpt)
    for rep in reports.values():
        _save_cell_report(rep, args.strategy, _reports_dir(args))
    _write_campaign_summary(ckpt, reports, stats)
    print(report.strategy_markdown(reports))
    print(f"\n[fabric:{stats['strategy']}] {stats['cells']} cells, "
          f"{stats['workers']} workers, {stats['wall_s']}s "
          f"({stats['cells_per_hour']} cells/h)")
    return 0


def run_add_cells(args) -> int:
    """``--add-cells``: submit cells to a (possibly running) campaign
    directory's intake — a watching fabric or an in-flight campaign
    admits them between batches, no restart needed."""
    from repro_torch.core.campaign import parse_cells
    from repro_torch.core.schedule import submit_cells
    cells = parse_cells(args.add_cells,
                        default_multi_pod=args.multi_pod)
    ckpt = campaign_dir(args.strategy, args.checkpoint_dir)
    paths = submit_cells(ckpt, cells)
    for spec, path in zip(cells, paths):
        print(f"submitted {spec.key()} -> {path}")
    print(f"{len(cells)} cell(s) in intake of {ckpt}")
    return 0


def run_status(args, cells) -> int:
    """``--status``: the operator's queue view — pending/claimed/done
    depth, per-cell state (intake submissions included) and the live
    lease board (held/expired leases, no lease-file spelunking)."""
    from repro_torch.core import telemetry as _telemetry
    from repro_torch.core.schedule import queue_status
    ckpt = campaign_dir(args.strategy, args.checkpoint_dir)
    status = queue_status(ckpt, strategy=args.strategy, cells=cells)
    # live metrics: folded from the event stream right now, not the
    # last published metrics.json snapshot
    events = _telemetry.read_events(ckpt)
    metrics = _telemetry.fold_metrics(events) if events else None
    if args.json:
        print(json.dumps({"v": 1, "queue": status, "metrics": metrics},
                         indent=1, sort_keys=True))
        return 0
    depth = status["depth"]
    print(f"campaign dir: {status['dir']}")
    print(f"strategy:     {status['strategy']}")
    stop = ""
    if status["stop_requested"]:
        age = time.time() - (status["stop_requested_at"] or 0.0)
        stop = f"  [STOP requested {age:.0f}s ago — a watch worker " \
               "started since then ignores it]"
    print(f"queue depth:  {depth['pending']} pending / "
          f"{depth['claimed']} claimed / {depth['done']} done" + stop)
    for d in status["cells"]:
        state = "done" if d["done"] else (
            f"claimed by {d['claimed_by']}" if "claimed_by" in d
            else "pending")
        line = f"  {d['cell']:<40} {state:<28} ({d['source']})"
        health = d.get("health")
        if health:
            bits = [f"{n} {kind}" for kind, n in
                    sorted((health.get("failures") or {}).items())]
            if health.get("retries"):
                bits.append(f"{health['retries']} retried")
            if health.get("quarantined"):
                bits.append(f"{health['quarantined']} quarantined")
            if health.get("degraded"):
                bits.append("DEGRADED")
            line += "  [" + "; ".join(bits) + "]"
        print(line)
    if status["leases"]:
        print("leases:")
        for lease in status["leases"]:
            flag = "EXPIRED" if lease["expired"] else "live"
            print(f"  {lease['cell']:<40} {lease['worker']} "
                  f"@{lease['host']} hb {lease['age_s']}s/"
                  f"{lease['ttl_s']}s [{flag}]")
    else:
        print("leases: (none held)")
    quarantine = status.get("quarantine")
    if quarantine:
        print(f"quarantine:   {quarantine['intents']} intents / "
              f"{quarantine['completions']} completions, "
              f"{len(quarantine['quarantined'])} config(s) quarantined "
              f"(threshold {quarantine['strike_threshold']})")
        for key, n in quarantine["strikes"].items():
            mark = " QUARANTINED" if key in quarantine["quarantined"] \
                else ""
            print(f"  config {key}: {n} strike(s){mark}")
    if metrics:
        g = metrics["gauges"]
        a = metrics["attribution"]
        c = metrics["counters"]
        hit = g.get("cache_hit_rate")
        print(f"telemetry:    {metrics['events']} events / "
              f"{a['wall_s']}s wall — {g['trials_per_s']} trials/s, "
              f"cache hit {'—' if hit is None else format(hit, '.0%')}, "
              f"{c['lease_steals']} steal(s), "
              f"{c['quarantine_strikes']} strike(s), "
              f"{c['slo_aborts']} SLO abort(s)")
        for w, d in metrics["per_worker"].items():
            print(f"  {w:<40} {d['trials']} trial(s), busy "
                  f"{d['busy_s']}s ({format(d['utilization'], '.0%')})")
    return 0


def run_stop(args) -> int:
    """``--stop``: drop the STOP sentinel — ``--watch`` workers exit
    once every admitted cell is done."""
    from repro_torch.core.schedule import request_stop
    ckpt = campaign_dir(args.strategy, args.checkpoint_dir)
    path = request_stop(ckpt)
    print(f"stop requested: {path}")
    return 0


def _worker_passthrough(args) -> list:
    """Strategy options forwarded verbatim to spawned workers."""
    extra = []
    if args.sweep_knobs:
        extra += ["--sweep-knobs", args.sweep_knobs]
    if args.budget is not None:
        extra += ["--budget", str(args.budget)]
    if args.seed is not None:
        extra += ["--seed", str(args.seed)]
    if args.model_min_records is not None:
        extra += ["--model-min-records", str(args.model_min_records)]
    if args.model_top_k is not None:
        extra += ["--model-top-k", str(args.model_top_k)]
    return extra


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
    ap.add_argument("--all", action="store_true",
                    help="campaign mode: every applicable cell of the "
                         "assignment")
    ap.add_argument("--device", default="cuda",
                    help="device every trial runs on (default cuda; "
                         "cpu runs the kernels' plain versions); fabric "
                         "workers get it from the coordinator")
    ap.add_argument("--checkpoint-dir", "--dir", dest="checkpoint_dir",
                    help="campaign or shared fabric directory: "
                         "checkpoints, history, leases, intake, "
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
                    help="campaign/fabric mode: discard the cells' "
                         "checkpoints, leases and intake submissions, "
                         "re-tune (the trial history is kept)")
    online = ap.add_argument_group("online scheduler (core/schedule.py)")
    online.add_argument("--prioritize", default="arch",
                        choices=["arch", "history"],
                        help="cell scheduling order (core/schedule.py)")
    online.add_argument("--add-cells",
                        help="submit cells to the campaign directory's "
                             "intake (a running campaign/fabric admits "
                             "them live), then exit")
    online.add_argument("--watch", action="store_true",
                        help="fabric workers: keep re-scanning the "
                             "intake when the board is drained instead "
                             "of exiting (end with --stop)")
    online.add_argument("--status", action="store_true",
                        help="print the queue view (pending/claimed/"
                             "done cells, intake, lease board), then "
                             "exit")
    online.add_argument("--stop", action="store_true",
                        help="request watching workers to exit once "
                             "every admitted cell is done, then exit")
    fab = ap.add_argument_group("campaign fabric (core/fabric.py)")
    fab.add_argument("--workers", type=int,
                     help="fabric mode: spawn N local worker processes "
                          "over the shared per-strategy directory")
    fab.add_argument("--coordinate", action="store_true",
                     help="fabric mode with the default worker count "
                          "(2) — same as --workers 2")
    fab.add_argument("--worker", action="store_true",
                     help="join a shared directory as one fabric "
                          "worker (start any number, on any host)")
    fab.add_argument("--evaluator",
                     help="module:factory dotted path for the trial "
                          "evaluator (default: the measured dispatch "
                          "stack on --device; tests swap in synthetic "
                          "surfaces)")
    fab.add_argument("--worker-ttl", type=float, default=30.0,
                     help="lease TTL seconds: a lease whose heartbeat "
                          "is older than this is recovered (default 30)")
    fab.add_argument("--worker-id", help="explicit worker id")
    fab.add_argument("--warm-start", action="store_true",
                     help="seed fresh cells from the best configs of "
                          "the nearest already-tuned cells in the "
                          "trial history")
    fab.add_argument("--ready-file",
                     help="touch this file once initialized (benchmark "
                          "start barrier)")
    fab.add_argument("--go-file",
                     help="wait for this file before claiming cells "
                          "(benchmark start barrier)")
    hard = ap.add_argument_group(
        "trial hardening (core/executor.py + core/quarantine.py)")
    hard.add_argument("--trial-timeout", type=float, default=None,
                      metavar="SECONDS",
                      help="per-trial evaluation deadline (default: none)")
    hard.add_argument("--max-retries", type=int, default=0,
                      help="re-evaluate transient failures up to N times "
                           "(default 0)")
    hard.add_argument("--strike-threshold", type=int, default=None,
                      help="quarantine a config after this many strikes "
                           "(default 3)")
    meas = ap.add_argument_group("measured tier (core/measure.py)")
    meas.add_argument("--measure-top-k", type=int, default=0, metavar="K",
                      help="after each cell's walk, re-evaluate its "
                           "top-K surviving configs and publish the "
                           "measured winner (default 0: off)")
    meas.add_argument("--measured-evaluator",
                      help="module:factory dotted path for the "
                           "measured-tier evaluator (default: reduced "
                           "wall-clock proxy + kernel bench, behind "
                           "the disk timing cache)")
    serve = ap.add_argument_group("serving tuning loop (serving/)")
    serve.add_argument("--slo-ttft", type=float, default=None,
                       metavar="FACTOR",
                       help="SLO guardrail for serve cells: abort any "
                            "candidate whose TTFT or queue delay exceeds "
                            "FACTOR x the incumbent's (default: off)")
    serve.add_argument("--promote", action="store_true",
                       help="publish each serve cell's surviving winner "
                            "to the campaign directory's live-config "
                            "board")
    obs = ap.add_argument_group("observability (core/telemetry.py)")
    obs.add_argument("--trace", action="store_true",
                     help="record telemetry (events.jsonl, metrics.json) "
                          "in the campaign directory; decisions are "
                          "bit-identical with tracing on or off")
    obs.add_argument("--trace-out", metavar="PATH",
                     help="export the campaign directory's recorded "
                          "events as Chrome-trace/Perfetto JSON, then "
                          "exit")
    obs.add_argument("--json", action="store_true",
                     help="with --status: print the queue view plus "
                          "live telemetry metrics as one JSON object")
    args = ap.parse_args(argv)

    if args.sweep_knobs and args.strategy != "sensitivity":
        ap.error("--sweep-knobs only applies to --strategy sensitivity")
    if (args.budget is not None or args.seed is not None) \
            and args.strategy not in ("random", "model"):
        ap.error("--budget/--seed only apply to --strategy "
                 "random/model")
    if (args.model_min_records is not None
            or args.model_top_k is not None) \
            and args.strategy != "model":
        ap.error("--model-min-records/--model-top-k only apply to "
                 "--strategy model")
    if args.add_cells or args.stop:
        # standalone actions against a campaign directory: any other
        # mode flag would be silently ignored, so reject the combination
        # instead of letting the operator believe it took effect
        ignored = [flag for flag, on in (
            ("--arch", args.arch), ("--shape", args.shape),
            ("--cells", args.cells), ("--all", args.all),
            ("--fresh", args.fresh), ("--watch", args.watch),
            ("--status", args.status), ("--worker", args.worker),
            ("--workers", args.workers),
            ("--coordinate", args.coordinate),
            ("--warm-start", args.warm_start),
            ("--trial-timeout", args.trial_timeout is not None),
            ("--max-retries", bool(args.max_retries)),
            ("--strike-threshold",
             args.strike_threshold is not None),
            ("--measure-top-k", bool(args.measure_top_k)),
            ("--measured-evaluator",
             bool(args.measured_evaluator)),
            ("--slo-ttft", args.slo_ttft is not None),
            ("--promote", args.promote),
            ("--trace", args.trace),
            ("--trace-out", bool(args.trace_out)),
            ("--json", args.json)) if on]
        if args.add_cells and args.stop:
            ap.error("--add-cells and --stop are separate actions; "
                     "run them as two invocations")
        if ignored:
            action = "--add-cells" if args.add_cells else "--stop"
            ap.error(f"{action} is a standalone action; "
                     f"{', '.join(ignored)} would be ignored — "
                     "drop it or run it separately")
        return run_add_cells(args) if args.add_cells else run_stop(args)
    if args.json and not args.status:
        ap.error("--json is the machine-readable form of --status; "
                 "add --status or drop --json")
    if args.trace_out:
        # standalone export over an existing campaign directory: any
        # tuning-mode flag would be silently ignored — reject it
        ignored = [flag for flag, on in (
            ("--arch", args.arch), ("--shape", args.shape),
            ("--cells", args.cells), ("--all", args.all),
            ("--fresh", args.fresh), ("--watch", args.watch),
            ("--status", args.status), ("--worker", args.worker),
            ("--workers", args.workers),
            ("--coordinate", args.coordinate),
            ("--trace", args.trace)) if on]
        if ignored:
            ap.error("--trace-out is a standalone export; "
                     f"{', '.join(ignored)} would be ignored — "
                     "drop it or run it separately")
        return run_trace_out(args)
    if args.status:
        # read-only action: --cells/--all scope the view, but a fabric
        # or fresh flag would be silently ignored — reject it
        ignored = [flag for flag, on in (
            ("--arch", args.arch), ("--shape", args.shape),
            ("--fresh", args.fresh), ("--watch", args.watch),
            ("--worker", args.worker), ("--workers", args.workers),
            ("--coordinate", args.coordinate),
            ("--warm-start", args.warm_start),
            ("--trial-timeout", args.trial_timeout is not None),
            ("--max-retries", bool(args.max_retries)),
            ("--strike-threshold",
             args.strike_threshold is not None),
            ("--measure-top-k", bool(args.measure_top_k)),
            ("--measured-evaluator",
             bool(args.measured_evaluator)),
            ("--slo-ttft", args.slo_ttft is not None),
            ("--promote", args.promote),
            ("--trace", args.trace)) if on]
        if ignored:
            ap.error("--status is a read-only action; "
                     f"{', '.join(ignored)} would be ignored — "
                     "drop it or run it separately")
    options = _strategy_options(
        args.strategy, args.sweep_knobs, args.budget, args.seed,
        model_min_records=args.model_min_records,
        model_top_k=args.model_top_k)
    if args.measure_top_k < 0:
        ap.error("--measure-top-k must be >= 0")
    if args.measured_evaluator and not args.measure_top_k:
        ap.error("--measured-evaluator requires --measure-top-k > 0")
    fabric_mode = args.worker or args.coordinate or args.workers
    if args.trace and not (args.all or args.cells or fabric_mode):
        ap.error("--trace records telemetry into the campaign "
                 "directory; it applies to campaign/fabric modes "
                 "(--cells/--all/--worker/--workers)")
    if args.slo_ttft is not None and args.slo_ttft <= 0:
        ap.error("--slo-ttft is a multiplier over the incumbent's "
                 "replay stats; it must be > 0 (e.g. 3.0)")
    if args.slo_ttft is not None and args.evaluator:
        ap.error("--evaluator replaces the dispatch stack that carries "
                 "the SLO guard; drop --slo-ttft or arm the guard "
                 "inside the custom evaluator factory")
    if (args.slo_ttft is not None or args.promote) \
            and not (args.all or args.cells or fabric_mode):
        ap.error("--slo-ttft/--promote apply to campaign/fabric modes "
                 "over serve:<arch>:<trace> cells")
    if args.fresh and not (args.all or args.cells):
        ap.error("--fresh only applies to campaign/fabric modes")
    if args.worker and args.fresh:
        ap.error("--fresh is a coordinator/campaign action; workers "
                 "join shared state, they must not clear it")
    if args.watch and not fabric_mode:
        ap.error("--watch only applies to fabric modes (--worker / "
                 "--workers / --coordinate)")
    if fabric_mode and not (args.all or args.cells) \
            and not (args.worker and args.watch):
        ap.error("fabric modes need --cells or --all (a --watch "
                 "--worker may start empty and live off the intake)")
    if args.all or args.cells or (args.worker and args.watch) \
            or args.status:
        from repro_torch.core.campaign import enumerate_cells, parse_cells
        if args.cells:
            cells = parse_cells(args.cells,
                                default_multi_pod=args.multi_pod)
        elif args.all:
            cells = enumerate_cells(meshes=(args.multi_pod,))
        else:
            cells = []
        if args.status:
            return run_status(args, cells)
        if args.worker:
            return run_worker(args, cells, options)
        if args.coordinate or args.workers:
            return run_fabric(args, cells, options)
        reports, stats = tune_campaign(
            cells, threshold=args.threshold, fresh=args.fresh,
            checkpoint_dir=args.checkpoint_dir, strategy=args.strategy,
            strategy_options=options, warm_start=args.warm_start,
            prioritize=args.prioritize, trial_timeout_s=args.trial_timeout,
            max_retries=args.max_retries,
            strike_threshold=args.strike_threshold,
            measure_top_k=args.measure_top_k,
            measured_evaluator=_load_measured(args),
            slo_ttft=args.slo_ttft, promote=args.promote,
            trace=args.trace, device=args.device)
        print(report.strategy_markdown(reports, queue=stats.get("queue")))
        print(f"\n[{stats['strategy']}] {stats['cells']} cells in "
              f"{stats['wall_s']}s ({stats['cells_per_hour']} cells/h; "
              f"{stats['evaluated_trials']} trials evaluated, "
              f"{stats['replayed_trials']} replayed from checkpoint)")
        return 0
    return _single_cell(ap, args, options)


def _single_cell(ap, args, options) -> int:
    if not (args.arch and args.shape):
        ap.error("need --arch and --shape, or --cells/--all")
    if args.measure_top_k:
        ap.error("--measure-top-k applies to campaign/fabric modes "
                 "(--cells/--all); single-cell mode is already measured")
    rep = tune_cell(args.arch, args.shape, args.multi_pod, args.threshold,
                    strategy=args.strategy, strategy_options=options,
                    device=args.device, out_dir=_reports_dir(args))
    print(report.cell_markdown(rep))
    _print_cell_summary(rep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
