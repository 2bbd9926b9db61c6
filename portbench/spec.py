"""What a run reads from the checkout, found by name.

* ``BENCHMARK.json`` at the checkout's root: the cells and the metrics;
* ``portbench/configs/<config>.json``: a configuration (its arch, the
  knobs it is served with, its weight rules, its reference);
* ``portbench/mixes/<traffic>.json``: a traffic mix;
* ``portbench/limits/<cell>.json``: the limits of a cell's comparison;
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader, whose
  ``read(run)`` returns a number or None (nothing to read), and, where it
  reads a kernel wrapper's calls, ``KERNEL``: the wrapper
  (``repro_torch.kernels.<KERNEL>.ops.<KERNEL>``) that a traced run
  spans.

A later change adds a cell, a configuration, a mix or a metric as new
files and entries; nothing here needs an edit for it.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from typing import Any, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Bench:
    """One checkout's benchmark: ``root`` holds ``BENCHMARK.json`` and
    ``portbench/``."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.dir = self.root / "portbench"
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self._metrics: Dict[str, Any] = {}

    # ------------------------------------------------------------ lookups
    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def _json(self, sub: str, name: str) -> Dict[str, Any]:
        doc = json.loads((self.dir / sub / f"{name}.json").read_text())
        doc.setdefault("name", name)
        return doc

    def config(self, name: str) -> Dict[str, Any]:
        return self._json("configs", name)

    def mix(self, name: str) -> Dict[str, Any]:
        return self._json("mixes", name)

    def limits(self, cell: str) -> Dict[str, float]:
        return self._json("limits", cell)["limits"]

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        """The cell's end-to-end metrics (``--trace 0``)."""
        return [m for m in self.doc["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        """The cell's per-layer metrics (``--trace 1``): those that list
        it, and those without a list whose end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in mine)]

    def metric(self, name: str):
        """The module ``portbench/metrics/<name>.py`` (its ``read``, and
        ``KERNEL`` where it has one)."""
        if name not in self._metrics:
            path = self.dir / "metrics" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + re.sub(r"\W", "_", name), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._metrics[name] = mod
        return self._metrics[name]

    def reference(self, name: str):
        """The plain reference module ``portbench/reference/<name>.py``."""
        return importlib.import_module(f"portbench.reference.{name}")


def problems(doc: Dict[str, Any]) -> List[str]:
    """Names, units and cross-references of a BENCHMARK.json that break
    the benchmark's rules (empty when it keeps them)."""
    out = []
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in doc.get(key, []):
            names.append(e["name"])
            if not NAME.match(e["name"]):
                out.append(f"{key}: bad name {e['name']!r}")
            if "unit" in e and not UNIT.match(e["unit"]):
                out.append(f"{e['name']}: bad unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"{e['name']}: better is {e['better']!r}")
    for key in ("configs", "workloads"):
        seen = [e["name"] for e in doc.get(key, [])]
        if len(seen) != len(set(seen)):
            out.append(f"{key}: a name appears twice")
    metrics = [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    if len(metrics) != len(set(metrics)):
        out.append("metrics: a name appears twice")
    configs = {c["name"] for c in doc["configs"]}
    cells = {w["name"]: w for w in doc["workloads"]}
    for w in doc["workloads"]:
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                out.append(f"{w['name']}: bad {k} {w[k]!r}")
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
    for c in doc["configs"]:
        if not any(w["config"] == c["name"] for w in doc["workloads"]):
            out.append(f"config {c['name']} has no cell")
        for k in c.get("reduced", []):
            if not NAME.match(k):
                out.append(f"{c['name']}: bad reduced key {k!r}")
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in doc["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: end-to-end source {m['source']!r}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    for m in doc["per_layer"]:
        moved = e2e.get(m["moves"])
        if moved is None:
            out.append(f"{m['name']}: moves unknown {m['moves']!r}")
            continue
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"{m['name']}: unknown cell {cell!r}")
            elif cell not in moved.get("workloads", [cell]):
                out.append(f"{m['name']}: cell {cell} does not report "
                           f"{m['moves']}")
        if (m["name"].endswith("_roofline") or "mfu" in m["name"]) \
                and m["unit"] != "%":
            out.append(f"{m['name']}: a share of a peak is in %")
    for w in doc["workloads"]:
        got = [m for m in doc["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        if len(got) < 2:
            out.append(f"{w['name']}: fewer than two end-to-end metrics")
        if not any(w["name"] in m.get("workloads", []) or
                   ("workloads" not in m and m["moves"] in
                    {g["name"] for g in got}) for m in doc["per_layer"]):
            out.append(f"{w['name']}: no per-layer metric")
    return out


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                checks: Dict[str, Dict[str, float]],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The run's one JSON line; the compared numbers come last."""
    doc = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        doc["breakdown"] = breakdown
    doc["checks"] = checks
    return json.dumps(doc)
