"""The port's campaign engine against the reference's, on the synthetic
surface: per-cell checkpoints and ``history.jsonl`` rows are
byte-identical, a killed campaign resumes bit-identically, intake and
priority order are the same, and a traced campaign equals an untraced
one.  Step, kernel and serve cells all walk here (the synthetic
evaluator stands in for each kind's timing)."""
import json
import threading

import pytest

from _torch_surface import PKGS, history_rows

SPECS = ("smollm-135m:train_4k,smollm-135m:prefill_32k,"
         "xlstm-1.3b:decode_32k,kernel:flash_attention:tiny,"
         "kernel:rmsnorm:tiny,serve:smollm-135m:poisson_tiny")


def _baseline(p):
    return lambda spec: p.params.default_config(shard_strategy="fsdp_tp",
                                                attn_impl="pallas")


def _campaign(p, ckpt, evaluator=None, **kw):
    return p.campaign.Campaign(
        p.campaign.parse_cells(kw.pop("specs", SPECS)),
        evaluator=evaluator or p.surface, baseline_factory=_baseline(p),
        checkpoint_dir=ckpt, max_workers=kw.pop("max_workers", 4), **kw)


def _files(ckpt):
    """Every checkpoint's bytes, and the history rows."""
    out = {p.name: p.read_text() for p in sorted(ckpt.glob("*.json"))}
    if (ckpt / "history.jsonl").exists():
        out["history.jsonl"] = history_rows(ckpt / "history.jsonl")
    return out


def _stats(camp):
    """The campaign's stats without the fields that follow the host's
    timing: wall clocks, and each cell's priority score, which is read
    from the history as it stood when the cell was handed out (pool
    threads append to it concurrently)."""
    stats = {k: v for k, v in camp.last_stats.items()
             if k not in ("wall_s", "cells_per_hour")}
    for cell in stats["queue"]["cells"]:
        cell.pop("admitted_at")
        cell.pop("score")
    return stats


def _measured(p):
    """A stand-in measured tier: the surface, 10 % slower for bf16."""
    def ev(wl, rt):
        res = p.surface(wl, rt)
        if rt.compute_dtype == "bfloat16":
            res.cost_s = round(res.cost_s * 1.1, 6)
        return res
    return ev


CASES = {
    "tree": {},
    "short": {"strategy": "short"},
    "sensitivity": {"strategy": "sensitivity"},
    "random": {"strategy": "random", "strategy_options": {"budget": 5}},
    "measured": {"measure_top_k": 2},
    "history-priority": {"prioritize": "history", "max_active_cells": 2},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_campaign_files_identical(case, tmp_path):
    out = {}
    for name, p in PKGS.items():
        kw = dict(CASES[case])
        if kw.get("measure_top_k"):
            kw["measured_evaluator"] = _measured(p)
        camp = _campaign(p, tmp_path / name, **kw)
        reports = camp.run()
        stats = _stats(camp)
        out[name] = (_files(tmp_path / name), list(reports), stats,
                     p.report.strategy_markdown(reports,
                                                queue=stats["queue"]))
    assert out["port"] == out["ref"]


def test_warm_started_campaign_identical(tmp_path):
    """A second campaign warm-started from the first one's history."""
    out = {}
    for name, p in PKGS.items():
        d = tmp_path / name
        _campaign(p, d / "cold").run()
        hist = p.history.TrialHistory(d / "cold" / "history.jsonl")
        camp = _campaign(p, d / "warm", history=hist, warm_start=True)
        camp.run()
        out[name] = (_files(d / "warm"), history_rows(hist.path),
                     camp.last_stats["warmstarted_cells"])
    assert out["ref"][2] >= 2
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("strategy", ["tree", "sensitivity"])
def test_kill_and_resume_identical(strategy, tmp_path):
    """Kill each package's campaign after the same number of
    evaluations and resume it: no absorbed trial is evaluated again,
    every checkpointed one is replayed, and the resumed run's files equal
    an uninterrupted run's, in both packages alike.  (Which trials were
    absorbed before the kill depends on the pool's timing.)"""
    out = {}
    for name, p in PKGS.items():
        d = tmp_path / name
        calls, lock = [], threading.Lock()

        def killer(wl, rt, p=p):
            with lock:
                calls.append(wl.key())
                if len(calls) > 9:
                    raise KeyboardInterrupt("simulated kill")
            return p.surface(wl, rt)

        with pytest.raises(KeyboardInterrupt):
            _campaign(p, d / "run", killer, strategy=strategy).run()
        absorbed = {(json.loads(text)["cell"], json.dumps(e["config"],
                                                          sort_keys=True))
                    for text in _files(d / "run").values()
                    if isinstance(text, str)
                    for e in json.loads(text)["log"]}
        assert absorbed                  # the kill landed mid-campaign
        resumed_calls = []

        def resumer(wl, rt, p=p):
            resumed_calls.append((wl.key(), json.dumps(rt.as_dict(),
                                                       sort_keys=True)))
            return p.surface(wl, rt)

        camp = _campaign(p, d / "run", resumer, strategy=strategy)
        camp.run()
        assert not absorbed & set(resumed_calls)     # nothing re-paid
        whole = _campaign(p, d / "whole", strategy=strategy)
        whole.run()
        files = {k: v for k, v in _files(d / "run").items()
                 if k != "history.jsonl"}
        assert files == {k: v for k, v in _files(d / "whole").items()
                         if k != "history.jsonl"}
        assert camp.last_stats["replayed_trials"] \
            + camp.last_stats["evaluated_trials"] \
            == whole.last_stats["evaluated_trials"]
        out[name] = files
    assert out["port"] == out["ref"]


def test_intake_order_identical(tmp_path):
    """Submissions are scanned oldest first, and a cell submitted while
    a campaign runs is admitted and tuned the same way."""
    out = {}
    for name, p in PKGS.items():
        d = tmp_path / name
        cells = p.campaign.parse_cells(SPECS)
        p.schedule.submit_cells(d / "inbox", list(reversed(cells)))
        scanned = [c.key() for c in p.schedule.scan_intake(d / "inbox")]
        late = p.campaign.parse_cells("glm4-9b:train_4k")
        submitted = threading.Event()

        def gated(wl, rt, p=p, late=late, d=d):
            if not submitted.is_set():
                p.schedule.submit_cells(d / "camp", late)
                submitted.set()
            return p.surface(wl, rt)

        camp = _campaign(p, d / "camp", gated, specs="smollm-135m:train_4k",
                         intake=True)
        reports = camp.run()
        snap = _stats(camp)["queue"]
        assert snap["from_intake"] == 1
        p.schedule.clear_intake(d / "inbox")
        out[name] = (scanned, list(reports), snap,
                     _files(d / "camp"),
                     p.schedule.scan_intake(d / "inbox"))
    assert out["port"] == out["ref"]


def test_traced_campaign_equals_untraced(tmp_path):
    """Telemetry observes and never decides: the port's traced campaign
    writes the files its untraced run writes (and the reference's), and
    records one trial span per evaluated trial."""
    p = PKGS["port"]
    plain = _campaign(p, tmp_path / "plain")
    plain.run()
    bus = p.telemetry.Telemetry(tmp_path / "traced", worker="w0")
    traced = _campaign(p, tmp_path / "traced", telemetry=bus)
    traced.run()
    events = p.telemetry.read_events(tmp_path / "traced")
    files = _files(tmp_path / "traced")
    assert files == _files(tmp_path / "plain")
    ref = PKGS["ref"]
    _campaign(ref, tmp_path / "ref").run()
    assert files == _files(tmp_path / "ref")
    trials = [e for e in events if e["kind"] == "trial"]
    assert len(trials) == plain.last_stats["evaluated_trials"]
    assert {e["kind"] for e in events} >= {"trial", "cell.activate",
                                           "cell.done"}
    metrics = p.telemetry.fold_metrics(events)
    assert metrics["counters"]["trials"] == len(trials)
    assert p.telemetry.read_events(tmp_path / "plain") == []
