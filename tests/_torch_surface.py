"""The tuner's two packages side by side on one deterministic surface.

``benchmarks/fabric_surface.surface_cost`` returns the reference's
``TrialResult``; :func:`port_surface` returns the port's from the same
cost, so the same walk can run through either package and their trial
logs, checkpoints and history rows be compared byte for byte.
``PKGS`` holds each package's tuner modules under one set of names.
"""
import dataclasses
import json
import types

from benchmarks.fabric_surface import surface_cost

import repro.core.campaign
import repro.core.executor
import repro.core.fabric
import repro.core.history
import repro.core.params
import repro.core.quarantine
import repro.core.report
import repro.core.schedule
import repro.core.sensitivity
import repro.core.strategy
import repro.core.telemetry
import repro.core.tree
import repro.core.trial
import repro_torch.core.campaign
import repro_torch.core.executor
import repro_torch.core.fabric
import repro_torch.core.history
import repro_torch.core.params
import repro_torch.core.quarantine
import repro_torch.core.report
import repro_torch.core.schedule
import repro_torch.core.sensitivity
import repro_torch.core.strategy
import repro_torch.core.telemetry
import repro_torch.core.tree
import repro_torch.core.trial

_MODULES = ("campaign", "executor", "fabric", "history", "params",
            "quarantine", "report", "schedule", "sensitivity", "strategy",
            "telemetry", "tree", "trial")


def _pkg(root, surface):
    ns = {m: getattr(root.core, m) for m in _MODULES}
    return types.SimpleNamespace(surface=surface, **ns)


def port_surface(wl, rt):
    """``surface_cost`` as the port's ``TrialResult``."""
    res = surface_cost(wl, rt)
    return repro_torch.core.trial.TrialResult(**dataclasses.asdict(res))


PKGS = {"ref": _pkg(repro, surface_cost),
        "port": _pkg(repro_torch, port_surface)}


def history_rows(path):
    """The rows of a ``history.jsonl`` without their wall-clock stamp,
    cell by cell in the order each cell appended them (how the cells'
    rows interleave depends on which pool thread finishes first).  Blank
    lines are skipped, as ``TrialHistory.records`` skips them: one is
    what the torn-tail heal of ``fsutil.append_jsonl`` leaves when an
    appender reads the last byte of another's write in flight."""
    rows = [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]
    for r in rows:
        r.pop("ts")
    return sorted(rows, key=lambda r: r["cell"])
