"""Markdown / CSV emission for EXPERIMENTS.md artifacts.

This is the PyTorch port's own copy of the reference's
``core/report.py``: its output is byte-identical to the reference's.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

from repro_torch.core.sensitivity import SensitivityReport
from repro_torch.core.tree import MAX_TRIALS, TuningReport


def sensitivity_markdown(reports: Dict[str, SensitivityReport]) -> str:
    """Table-2 analogue: rows = knobs, cols = workloads + average."""
    knobs = [i.knob for i in next(iter(reports.values())).impacts]
    lines = ["| knob (Spark analogue) | " +
             " | ".join(reports) + " | Average |",
             "|---" * (len(reports) + 2) + "|"]
    for k in knobs:
        row = [k]
        vals = []
        for rep in reports.values():
            imp = next(i for i in rep.impacts if i.knob == k)
            cell = f"{imp.mean_abs_pct:.1f}%"
            if imp.crashes:
                cell += f" ({imp.crashes} crash)"
            row.append(cell)
            vals.append(imp.mean_abs_pct)
        row.append(f"{sum(vals)/len(vals):.1f}%")
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def sensitivity_cell_markdown(rep: SensitivityReport) -> str:
    """One cell's OFAT matrix: rows = knobs, per-value deviations."""
    out = [f"### Sensitivity: `{rep.workload}`",
           "",
           f"* baseline cost: **{_fmt_s(rep.baseline_cost)}**",
           f"* trials used:   {rep.n_trials}",
           "",
           "| knob (Spark analogue) | values | deviation % | "
           "mean abs % | crashes |",
           "|---|---|---|---|---|"]
    for imp in rep.impacts:
        devs = ", ".join("crash" if d != d else f"{d:+.1f}"
                         for d in imp.deviations_pct)
        vals = ", ".join(str(v) for v in imp.values)
        out.append(f"| {imp.knob} ({imp.spark_name}) | {vals} | {devs} | "
                   f"{imp.mean_abs_pct:.1f}% | {imp.crashes} |")
    return "\n".join(out)


def sensitivity_csv(rep: SensitivityReport) -> str:
    lines = ["knob,value,deviation_pct,crashed"]
    for imp in rep.impacts:
        for v, d in zip(imp.values, imp.deviations_pct):
            lines.append(f"{imp.knob},{v},"
                         f"{'' if d != d else round(d, 2)},{d != d}")
    return "\n".join(lines)


def tuning_markdown(rep: TuningReport) -> str:
    out = [f"### Case study: `{rep.workload}`",
           "",
           f"* baseline cost: **{_fmt_s(rep.baseline_cost)}**",
           f"* final cost:    **{_fmt_s(rep.final_cost)}** "
           f"(speedup x{rep.speedup:.2f})",
           f"* trials used:   {rep.n_trials} (cap 10)",
           f"* accepted: {'; '.join(rep.accepted) or '(none)'}",
           "",
           "| # | stage | change | cost | vs incumbent | verdict |",
           "|---|---|---|---|---|---|"]
    prev = None
    for i, e in enumerate(rep.log):
        cost = e["result"].get("cost_s", float("nan"))
        crashed = e["result"].get("crashed")
        verdict = ("CRASH" if crashed else
                   "accept" if e.get("accepted") else "reject")
        if i == 0:
            verdict = "baseline"
        delta = ", ".join(f"{k}={v}" for k, v in e["delta"].items()) or "-"
        out.append(f"| {i} | {e['name']} | {delta} | {_fmt_s(cost)} | "
                   f"{e.get('note','')} | {verdict} |")
    md = getattr(rep, "measured", None)
    if isinstance(md, dict):             # model-only reports unchanged
        out += ["", measured_markdown(md)]
    pd = getattr(rep, "proposer", None)
    if isinstance(pd, dict):             # learned-proposer walks only
        out += ["", proposer_markdown(pd)]
    return "\n".join(out)


def measured_markdown(md: Dict) -> str:
    """The measured tier's re-rank table (``TuningReport.measured``,
    core/measure.py): the model's top-K surviving configs, each with
    its model-predicted and real median wall-clock cost, the measured
    winner, and whether measurement overturned the model ranking."""
    head = (f"**Measured re-rank** (top-{md.get('k')}, "
            f"{md.get('evaluations', 0)} evaluation(s))")
    rows = md.get("candidates") or []
    if not rows:
        return head + f": {md.get('note', 'no candidates')}"
    out = [head, "",
           "| rank (model) | candidate | model cost | measured | "
           "verdict |",
           "|---|---|---|---|---|"]
    winner = md.get("winner")
    for r in rows:
        if r.get("crashed"):
            verdict = f"CRASH ({r.get('failure', '?')})"
        elif winner is not None and r.get("config") == winner:
            verdict = "**winner**"
            if md.get("overturned"):
                verdict += " (overturned model choice)"
        else:
            verdict = "reject"
        cached = " (cached)" if r.get("cached") else ""
        out.append(
            f"| {r.get('rank')} | {r.get('name') or '—'} | "
            f"{_fmt_s(r.get('model_cost_s', float('nan')))} | "
            f"{_fmt_s(r.get('cost_s', float('nan')))}{cached} | "
            f"{verdict} |")
    if md.get("note"):
        out += ["", f"_{md['note']}_"]
    return "\n".join(out)


def proposer_markdown(pd: Dict) -> str:
    """The learned proposer's predicted-vs-actual table
    (``TuningReport.proposer``, core/proposer.py): the fit it rode
    (record counts + digest prefix) and, per proposed trial, the
    ridge model's predicted cost next to the evaluated one — the
    inspection surface for "is the model earning its trials"."""
    head = (f"**Learned proposer** (fit on {pd.get('records', 0)} of "
            f"{pd.get('raw', 0)} history records, "
            f"digest `{str(pd.get('digest', ''))[:12]}`)")
    rows = pd.get("rows") or []
    if not rows:
        return head + ": no model-proposed trials"
    out = [head, "",
           "| trial | predicted | actual | error |",
           "|---|---|---|---|"]
    for r in rows:
        pred = r.get("predicted_s", float("nan"))
        if r.get("crashed"):
            actual, err = "CRASH", "—"
        else:
            cost = r.get("cost_s", float("nan"))
            actual = _fmt_s(cost)
            err = (f"{(pred - cost) / cost * 100.0:+.1f}%"
                   if cost == cost and cost > 0 else "—")
        out.append(f"| {r.get('name') or '—'} | {_fmt_s(pred)} | "
                   f"{actual} | {err} |")
    return "\n".join(out)


def _health_cell(h: Optional[Dict]) -> str:
    """Compact per-cell failure/retry/quarantine summary (one table
    cell of :func:`queue_markdown`)."""
    if not h:
        return "—"
    parts = [f"{n} {kind}"
             for kind, n in sorted((h.get("failures") or {}).items())]
    if h.get("retries"):
        parts.append(f"{h['retries']} retried")
    if h.get("quarantined"):
        parts.append(f"{h['quarantined']} quarantined")
    if h.get("degraded"):
        parts.append("DEGRADED")
    return "; ".join(parts) or "—"


def queue_markdown(queue: Dict) -> str:
    """Admission / priority view of an online campaign (the
    ``Campaign.last_stats["queue"]`` snapshot, core/schedule.py, or a
    ``queue_status`` dict): one row per admitted cell — how it entered
    (seed vs intake), the priority score it was scheduled under (``—``
    = unknown → explore-first) and its final queue state.  When any
    cell carries failure accounting (``health``, core/campaign.py), a
    health column is added so an operator sees a degrading campaign
    before it finishes."""
    cells = queue.get("cells", [])
    with_health = any(d.get("health") for d in cells)
    lines = [f"### Queue: {queue.get('admitted', 0)} cells admitted "
             f"({queue.get('from_intake', 0)} via intake), "
             f"prioritize={queue.get('prioritize', 'arch')}",
             "",
             "| cell | admitted | priority | state |"
             + (" health |" if with_health else ""),
             "|---|---|---|---|" + ("---|" if with_health else "")]
    for d in cells:
        score = d.get("score")
        row = (f"| {d['cell']} | {d.get('source', '?')} | "
               f"{'—' if score is None else f'{score:.2f}'} | "
               f"{d.get('state', '?')} |")
        if with_health:
            row += f" {_health_cell(d.get('health'))} |"
        lines.append(row)
    return "\n".join(lines)


def campaign_markdown(reports: Dict[str, TuningReport],
                      queue: Optional[Dict] = None) -> str:
    """Cross-cell speedup matrix: rows = archs, cols = shape__mesh cells
    (the paper's case-study summary generalized to the full assignment).
    With ``queue`` (an online campaign's admission snapshot) the
    admission/priority table is appended."""
    parsed = []
    for key, rep in reports.items():
        arch, shape, mesh = key.split("__")
        parsed.append((arch, f"{shape}__{mesh}", rep))
    archs = list(dict.fromkeys(a for a, _, _ in parsed))
    cols = list(dict.fromkeys(c for _, c, _ in parsed))
    by_cell = {(a, c): r for a, c, r in parsed}
    lines = ["### Campaign: tuning-tree speedup per cell",
             "",
             "| arch | " + " | ".join(cols) + " |",
             "|---" * (len(cols) + 1) + "|"]
    for a in archs:
        row = [a]
        for c in cols:
            rep = by_cell.get((a, c))
            if rep is None:
                row.append("—")
            elif rep.final_cost != rep.final_cost \
                    or rep.final_cost == float("inf"):
                row.append("crash")
            elif rep.baseline_cost == float("inf"):
                # crashed baseline, viable candidate found: the ratio is
                # meaningless, the recovery is the result
                row.append(f"recovered ({rep.n_trials})")
            else:
                row.append(f"x{rep.speedup:.2f} ({rep.n_trials})")
        lines.append("| " + " | ".join(row) + " |")
    # the gmean covers cells with a finite, nonzero ratio: a crashed
    # final (speedup 0) or crashed baseline (speedup inf/nan) is
    # reported in its cell, not averaged into the headline number
    speedups = [r.speedup for r in reports.values()
                if r.speedup == r.speedup and r.speedup != float("inf")
                and r.speedup > 0]
    gmean = (float(math.prod(speedups)) ** (1.0 / len(speedups))) \
        if speedups else float("nan")
    lines += ["",
              f"* cells tuned: {len(reports)}",
              f"* total trials: {sum(r.n_trials for r in reports.values())}"
              f" (cap {MAX_TRIALS * len(reports)})",
              f"* accepted changes: "
              f"{sum(len(r.accepted) for r in reports.values())}",
              f"* geometric-mean speedup: x{gmean:.2f}",
              "",
              "Each cell: `x<speedup> (<trials used>)`."]
    measured = {k: r.measured for k, r in reports.items()
                if isinstance(getattr(r, "measured", None), dict)}
    if measured:                         # model-only output unchanged
        overturned = sorted(k for k, m in measured.items()
                            if m.get("overturned"))
        line = (f"* measured re-rank: {len(measured)} cell(s), "
                f"{sum(m.get('evaluations', 0) for m in measured.values())}"
                f" real evaluation(s), {len(overturned)} overturned")
        if overturned:
            line += " — " + ", ".join(f"`{c}`" for c in overturned)
        lines.insert(-2, line)
    fitted = {k: r.proposer for k, r in reports.items()
              if isinstance(getattr(r, "proposer", None), dict)}
    if fitted:                           # tree-only output unchanged
        lines.insert(-2, (
            f"* learned proposer: {len(fitted)} cell(s) fit "
            f"(on {sum(p.get('records', 0) for p in fitted.values())} "
            f"history records), "
            f"{sum(len(p.get('rows') or []) for p in fitted.values())} "
            f"model-proposed trial(s)"))
    degraded = sorted(d["cell"] for d in (queue or {}).get("cells", [])
                      if (d.get("health") or {}).get("degraded"))
    if degraded:                         # fault-free output unchanged
        lines.insert(-2, f"* degraded cells (partial results under "
                         f"faults): {len(degraded)} — "
                         + ", ".join(f"`{c}`" for c in degraded))
    if queue is not None:
        lines += ["", queue_markdown(queue)]
    return "\n".join(lines)


def serving_markdown(live: Dict[str, Optional[Dict]],
                     history: List[Dict]) -> str:
    """The serving promotion board (serving/canary.PromotionBoard):
    one row per serve cell's live config, plus the promotion/demotion
    history tail.  ``live`` maps cell key -> live-file dict (None =
    nothing promoted yet)."""
    lines = ["### Serving: promoted live configs",
             "",
             "| cell | live cost | promoted knobs | source |",
             "|---|---|---|---|"]
    for key in sorted(live):
        rec = live[key]
        if not rec:
            lines.append(f"| {key} | — (nothing promoted) | — | — |")
            continue
        cfg = rec.get("config") or {}
        knobs = ", ".join(
            f"{k}={cfg[k]}" for k in ("max_wave_size", "wave_admission",
                                      "kv_cache_dtype", "donate_buffers",
                                      "compute_dtype") if k in cfg)
        lines.append(f"| {key} | {_fmt_s(rec.get('cost_s', float('nan')))}"
                     f" | {knobs or '—'} | {rec.get('source') or '—'} |")
    promoted = sum(r.get("action") == "promoted" for r in history)
    kept = sum(r.get("action") == "kept-incumbent" for r in history)
    lines += ["",
              f"* promotion events: {promoted} promoted, {kept} kept "
              "the incumbent (the live file never regresses)"]
    demoted = [r for r in history
               if r.get("action") == "promoted" and r.get("demoted")]
    if demoted:
        lines += ["", "| demoted at | cell | old cost | new cost |",
                  "|---|---|---|---|"]
        for r in demoted[-10:]:
            lines.append(
                f"| {r.get('ts')} | {r.get('cell')} | "
                f"{_fmt_s((r['demoted'] or {}).get('cost_s', float('nan')))}"
                f" | {_fmt_s(r.get('cost_s', float('nan')))} |")
    return "\n".join(lines)


def telemetry_markdown(metrics: Dict) -> str:
    """The campaign's "where the time went" section, rendered from the
    telemetry aggregator's published ``metrics.json``
    (core/telemetry.fold_metrics).  Appended to the campaign summary
    only when the directory carries telemetry — untraced output is
    unchanged."""
    counters = metrics.get("counters") or {}
    gauges = metrics.get("gauges") or {}
    attr = metrics.get("attribution") or {}
    hit = gauges.get("cache_hit_rate")
    lines = [
        "### Telemetry: where the time went",
        "",
        f"* events: {metrics.get('events', 0)} over "
        f"{attr.get('wall_s', 0.0)}s wall, "
        f"{gauges.get('workers', 0)} worker(s), "
        f"{gauges.get('trials_per_s', 0.0)} trials/s",
        f"* compile-cache hit rate: "
        f"{'—' if hit is None else format(hit, '.0%')}; per-trial "
        f"rates: {gauges.get('retry_rate', 0)} retry, "
        f"{gauges.get('timeout_rate', 0)} timeout, "
        f"{gauges.get('quarantine_rate', 0)} quarantine, "
        f"{gauges.get('crash_rate', 0)} crash",
        f"* fleet: {counters.get('lease_claims', 0)} lease claim(s), "
        f"{counters.get('lease_steals', 0)} steal(s), "
        f"{counters.get('quarantine_strikes', 0)} strike(s), "
        f"{counters.get('slo_aborts', 0)} SLO abort(s)",
        "",
        "| where | seconds |",
        "|---|---|",
        f"| trials (total) | {attr.get('trial_s', 0.0)} |",
        f"| — compiles | {attr.get('compile_s', 0.0)} |",
        f"| — evaluation (net of compile) | {attr.get('eval_s', 0.0)} |",
        f"| measured tier | {attr.get('measure_s', 0.0)} |",
        f"| idle (worker-seconds) | {attr.get('idle_s', 0.0)} |",
    ]
    per_worker = metrics.get("per_worker") or {}
    if per_worker:
        lines += ["", "| worker | trials | busy | utilization |",
                  "|---|---|---|---|"]
        for w in sorted(per_worker):
            d = per_worker[w]
            lines.append(f"| {w} | {d.get('trials', 0)} | "
                         f"{d.get('busy_s', 0.0)}s | "
                         f"{format(d.get('utilization', 0.0), '.0%')} |")
    per_cell = metrics.get("per_cell") or {}
    if per_cell:
        lines += ["", "| cell | trials | best cost | "
                      "first improvement after |",
                  "|---|---|---|---|"]
        for c in sorted(per_cell):
            d = per_cell[c]
            best = d.get("best_cost_s")
            fi = d.get("first_improvement_s")
            lines.append(
                f"| {c} | {d.get('trials', 0)} | "
                f"{'—' if best is None else _fmt_s(best)} | "
                f"{'—' if fi is None else format(fi) + 's'} |")
    return "\n".join(lines)


def cell_markdown(rep) -> str:
    """Render one cell's report, whatever strategy produced it."""
    if isinstance(rep, SensitivityReport):
        return sensitivity_cell_markdown(rep)
    return tuning_markdown(rep)


def strategy_markdown(reports: Dict, queue: Optional[Dict] = None) -> str:
    """Render a campaign's cross-cell summary, whatever strategy
    produced it: tuning-style reports get the speedup matrix,
    sensitivity reports get the Table-2 impact matrix.  ``queue``
    (an online campaign's admission snapshot) appends the
    admission/priority table."""
    if all(isinstance(r, SensitivityReport) for r in reports.values()):
        md = ("### Campaign: sensitivity impact per cell (Table 2)\n\n"
              + sensitivity_markdown(reports))
        if queue is not None:
            md += "\n\n" + queue_markdown(queue)
        return md
    if all(isinstance(r, TuningReport) for r in reports.values()):
        return campaign_markdown(reports, queue=queue)
    raise TypeError("mixed report types in one campaign: "
                    + ", ".join(sorted({type(r).__name__
                                        for r in reports.values()})))


def _fmt_s(x: float) -> str:
    if x != x or x == float("inf") or x >= 1e29:
        return "crash"
    if x >= 1.0:
        return f"{x:.3f} s"
    return f"{x*1e3:.2f} ms"
