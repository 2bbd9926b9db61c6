"""Structured campaign telemetry: span events, trace export, metrics.

The tuner generates far more evidence per campaign than the decision
path consumes — where wall-clock went (compile vs eval vs idle), how
the fleet behaved (claims, steals, strikes, SLO aborts), which cell
improved first.  This module captures that evidence as a stream of
structured events without ever being *part* of the decision path.

Three layers:

* **Event bus** (`Telemetry`) — every trial, compile, cache hit/miss,
  lease claim/steal, retry, timeout, quarantine strike, measured
  re-rank, and SLO abort appends one JSON line to a shared
  ``events.jsonl`` in the campaign directory, via the same
  torn-tolerant O_APPEND idiom as ``history.jsonl`` (fsutil.
  ``append_jsonl``): one write per line, self-healing tail, readers
  skip bad lines.  Multi-process safe on the fabric dir.  Span events
  carry a start timestamp plus duration and a per-process span id;
  nested spans link to their parent via a thread-local stack, so a
  compile event emitted inside a trial attempt records the trial as
  its parent.
* **Chrome-trace export** (`chrome_trace`) — folds the event stream
  into Chrome/Perfetto ``traceEvents`` JSON: one process track per
  worker, one thread track per pool thread, trials and compiles as
  duration slices, steals / strikes / SLO aborts / retries as instant
  events.  Load via ``chrome://tracing`` or https://ui.perfetto.dev.
* **Metrics** (`fold_metrics` / `publish_metrics`) — counters, gauges
  and histograms folded from the same stream (trials/s, compile-cache
  hit rate, retry/timeout/quarantine rates, per-worker utilization,
  time-to-first-improvement per cell, wall-clock attribution),
  published atomically as ``metrics.json`` (fsutil.atomic_publish).

**Hard invariant:** telemetry observes, never decides.  Nothing here
may feed tuning decisions, and a campaign with telemetry enabled must
be bit-identical (fingerprints, logs, budgets) to one without — the
regression tests in tests/test_telemetry.py enforce this.  When
disabled (the default), every hook is a no-op behind a plain
attribute check (``t.enabled``), and ``emit`` never lets an OSError
escape into the trial path.

A process-global *current* telemetry (``install`` / ``current``) lets
deep layers that predate this module (CompileCache, the timing cache,
the SLO guard) emit without threading a handle through every
constructor; components that do take a ``telemetry=`` kwarg
(SweepExecutor, Campaign, FabricWorker) default to ``current()``.

Also here: the leveled fleet `Logger` (``REPRO_LOG=debug|info|warn``),
worker-id-prefixed so interleaved multi-worker output is attributable.

This is the PyTorch port's own copy of the reference's
``core/telemetry.py``: its output is byte-identical to the reference's.
"""
from __future__ import annotations

import itertools
import json
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from .fsutil import append_jsonl, atomic_publish

EVENTS_NAME = "events.jsonl"
METRICS_NAME = "metrics.json"
SCHEMA_VERSION = 1

LOG_ENV = "REPRO_LOG"
_LOG_LEVELS = {"debug": 10, "info": 20, "warn": 30}


# --------------------------------------------------------------- logger
class Logger:
    """Tiny leveled logger for fleet processes.

    Level comes from ``REPRO_LOG`` (debug|info|warn, default info);
    every line is prefixed with the worker id so interleaved output
    from a multi-worker fabric stays attributable.  Writes to stderr —
    stdout is reserved for machine-readable CLI output (``--status
    --json``, report markdown).
    """

    def __init__(self, prefix: str = "", level: Optional[str] = None,
                 stream=None):
        if level is None:
            level = os.environ.get(LOG_ENV, "info")
        self.level = _LOG_LEVELS.get(str(level).lower(), 20)
        self.prefix = prefix
        self.stream = stream

    def _emit(self, level: str, msg: str) -> None:
        if _LOG_LEVELS[level] < self.level:
            return
        tag = f"[{self.prefix}] " if self.prefix else ""
        out = self.stream if self.stream is not None else sys.stderr
        try:
            print(f"[{level}] {tag}{msg}", file=out, flush=True)
        except (OSError, ValueError):
            pass                      # a dead log pipe never kills work

    def debug(self, msg: str) -> None:
        self._emit("debug", msg)

    def info(self, msg: str) -> None:
        self._emit("info", msg)

    def warn(self, msg: str) -> None:
        self._emit("warn", msg)


def get_logger(prefix: str = "", level: Optional[str] = None) -> Logger:
    return Logger(prefix=prefix, level=level)


# ------------------------------------------------------------ event bus
class _NullSpan:
    """No-op span: returned by a disabled Telemetry so hot paths pay a
    single attribute check and no allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **fields):
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """Context manager emitting one complete event on exit.

    The event's ``ts`` is the span start and ``dur_s`` its length, so
    a crash mid-span loses only that event — acceptable for telemetry,
    which is observability, not a correctness ledger.  ``note()``
    attaches fields learned during the span (cost, crash, cache
    state).  Entering pushes the span id on a thread-local stack so
    events emitted underneath record it as ``parent``.
    """

    __slots__ = ("_t", "kind", "fields", "id", "parent", "t0")

    def __init__(self, telemetry: "Telemetry", kind: str,
                 fields: Dict[str, Any]):
        self._t = telemetry
        self.kind = kind
        self.fields = fields
        self.id = telemetry._next_span()
        self.parent: Optional[str] = None
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.time()
        stack = self._t._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        return self

    def note(self, **fields):
        self.fields.update(fields)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = self._t._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        self._t.emit(self.kind, ts=self.t0,
                     dur_s=time.time() - self.t0,
                     span=self.id, parent=self.parent, **self.fields)
        return False


class Telemetry:
    """Append-only structured event bus over a campaign directory.

    Every record is one JSON line in ``<directory>/events.jsonl``:

        {"v": 1, "kind": "trial", "ts": <epoch s>, "worker": "...",
         "pid": 1234, "thread": "sweep-0", "span": "4d2.7",
         "parent": "4d2.3", "dur_s": 0.81, ...kind-specific fields}

    ``worker`` is the fabric worker id (or ``host-pid`` for
    single-process campaigns) and, with ``thread``, becomes the track
    in the Chrome-trace export.  Span ids are ``<pid hex>.<seq>`` —
    unique per process, cheap, and deliberately *not* random so
    telemetry shares no entropy source with the search.
    """

    def __init__(self, directory=None, worker: str = "",
                 enabled: bool = True):
        self.enabled = bool(enabled) and directory is not None
        self.path = (os.path.join(str(directory), EVENTS_NAME)
                     if directory is not None else None)
        self.directory = str(directory) if directory is not None else None
        if not worker:
            try:
                host = socket.gethostname().split(".")[0]
            except OSError:
                host = "host"
            worker = f"{host}-{os.getpid()}"
        self.worker = worker
        self._pid = os.getpid()
        self._seq = itertools.count(1)
        self._local = threading.local()

    # -- internals
    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_span(self) -> str:
        return f"{self._pid:x}.{next(self._seq)}"

    # -- emission
    def emit(self, kind: str, *, ts: Optional[float] = None,
             dur_s: Optional[float] = None, span: Optional[str] = None,
             parent: Optional[str] = None, **fields) -> None:
        """Append one event.  Never raises into the caller: a full or
        vanished disk costs telemetry lines, not trials."""
        if not self.enabled:
            return
        rec: Dict[str, Any] = {
            "v": SCHEMA_VERSION,
            "kind": kind,
            "ts": time.time() if ts is None else ts,
            "worker": self.worker,
            "pid": self._pid,
            "thread": threading.current_thread().name,
        }
        if dur_s is not None:
            rec["dur_s"] = round(float(dur_s), 6)
        if span is not None:
            rec["span"] = span
        if parent is None:
            stack = self._stack()
            if stack:
                rec["parent"] = stack[-1]
        else:
            rec["parent"] = parent
        rec.update(fields)
        try:
            append_jsonl(self.path, rec)
        except (OSError, TypeError, ValueError):
            pass

    def span(self, kind: str, **fields):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, kind, fields)


NULL = Telemetry(None, enabled=False)

_current: Telemetry = NULL
_current_lock = threading.Lock()


def install(t: Telemetry) -> Telemetry:
    """Make *t* the process-global telemetry returned by current()."""
    global _current
    with _current_lock:
        _current = t
    return t


def uninstall() -> None:
    install(NULL)


def current() -> Telemetry:
    return _current


# --------------------------------------------------------------- reader
def read_events(directory) -> List[Dict[str, Any]]:
    """All parseable events from <directory>/events.jsonl.

    Same tolerance contract as the history/quarantine readers: a torn
    or corrupt line (worker died mid-write on a non-atomic mount) is
    skipped, never fatal.
    """
    path = os.path.join(str(directory), EVENTS_NAME)
    out: List[Dict[str, Any]] = []
    try:
        with open(path, "r") as f:
            raw = f.read()
    except OSError:
        return out
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "kind" in rec:
            out.append(rec)
    return out


# -------------------------------------------------------------- metrics
_HIST_EDGES = ((0.001, "le_1ms"), (0.01, "le_10ms"), (0.1, "le_100ms"),
               (1.0, "le_1s"), (10.0, "le_10s"), (100.0, "le_100s"),
               (float("inf"), "gt_100s"))

_COUNTER_KINDS = {
    "trial": "trials",
    "compile": "compiles",
    "cache.hit": "cache_hits",
    "cache.miss": "cache_misses",
    "timing_cache.hit": "timing_cache_hits",
    "timing_cache.miss": "timing_cache_misses",
    "retry": "retries",
    "timeout": "timeouts",
    "quarantine.skip": "quarantine_skips",
    "quarantine.strike": "quarantine_strikes",
    "lease.claim": "lease_claims",
    "lease.steal": "lease_steals",
    "lease.lost": "lease_lost",
    "slo.abort": "slo_aborts",
    "measure.rerank": "measure_reranks",
    "cell.activate": "cells_activated",
    "cell.done": "cells_done",
}


def _bucket(dur: float) -> str:
    for edge, label in _HIST_EDGES:
        if dur <= edge:
            return label
    return _HIST_EDGES[-1][1]


def fold_metrics(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold an event stream into counters / gauges / histograms.

    Pure function of the records — callers decide freshness (live fold
    for ``--status``, atomic ``metrics.json`` publish at checkpoints).
    """
    counters = {name: 0 for name in _COUNTER_KINDS.values()}
    counters["crashes"] = 0
    per_worker: Dict[str, Dict[str, Any]] = {}
    per_cell: Dict[str, Dict[str, Any]] = {}
    hist: Dict[str, int] = {label: 0 for _, label in _HIST_EDGES}
    t0 = t1 = None
    eval_s = compile_s = measure_s = 0.0

    for rec in records:
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        dur = rec.get("dur_s") or 0.0
        t0 = ts if t0 is None else min(t0, ts)
        t1 = ts + dur if t1 is None else max(t1, ts + dur)
        kind = rec.get("kind")
        name = _COUNTER_KINDS.get(kind)
        if name:
            counters[name] += 1
        w = per_worker.setdefault(rec.get("worker") or "?",
                                  {"trials": 0, "busy_s": 0.0})
        if kind == "trial":
            w["trials"] += 1
            w["busy_s"] += dur
            eval_s += dur
            hist[_bucket(dur)] += 1
            if rec.get("crashed"):
                counters["crashes"] += 1
            cell = rec.get("cell")
            if cell:
                c = per_cell.setdefault(cell, {
                    "trials": 0, "best_cost_s": None,
                    "t_first": ts, "first_improvement_s": None,
                    "baseline_cost_s": None})
                c["trials"] += 1
                c["t_first"] = min(c["t_first"], ts)
                cost = rec.get("cost_s")
                if isinstance(cost, (int, float)):
                    if c["baseline_cost_s"] is None:
                        c["baseline_cost_s"] = cost
                    if c["best_cost_s"] is None or cost < c["best_cost_s"]:
                        c["best_cost_s"] = cost
                        if (cost < c["baseline_cost_s"]
                                and c["first_improvement_s"] is None):
                            c["first_improvement_s"] = round(
                                ts + dur - c["t_first"], 3)
        elif kind == "compile":
            compile_s += dur
        elif kind == "measure":
            measure_s += dur

    wall = max((t1 - t0), 0.0) if (t0 is not None and t1 is not None) else 0.0
    workers = sorted(per_worker)
    for w in per_worker.values():
        w["busy_s"] = round(w["busy_s"], 3)
        w["utilization"] = round(w["busy_s"] / wall, 3) if wall > 0 else 0.0
    for c in per_cell.values():
        c.pop("t_first", None)
        if c["best_cost_s"] is not None:
            c["best_cost_s"] = round(c["best_cost_s"], 6)
        if c["baseline_cost_s"] is not None:
            c["baseline_cost_s"] = round(c["baseline_cost_s"], 6)

    trials = counters["trials"]
    lookups = counters["cache_hits"] + counters["cache_misses"]
    rate = lambda n: round(n / trials, 4) if trials else 0.0  # noqa: E731
    gauges = {
        "trials_per_s": round(trials / wall, 3) if wall > 0 else 0.0,
        "cache_hit_rate": (round(counters["cache_hits"] / lookups, 4)
                           if lookups else None),
        "retry_rate": rate(counters["retries"]),
        "timeout_rate": rate(counters["timeouts"]),
        "quarantine_rate": rate(counters["quarantine_skips"]),
        "crash_rate": rate(counters["crashes"]),
        "workers": len(workers),
    }
    # wall-clock attribution: compile time is nested inside trial spans
    # when the cache compiles in-line, so "eval" here is trial time net
    # of compile; idle is whatever the busiest-track wall doesn't cover.
    busy = eval_s
    attribution = {
        "wall_s": round(wall, 3),
        "trial_s": round(eval_s, 3),
        "compile_s": round(compile_s, 3),
        "eval_s": round(max(eval_s - compile_s, 0.0), 3),
        "measure_s": round(measure_s, 3),
        "idle_s": round(max(wall * max(len(workers), 1) - busy, 0.0), 3),
    }
    return {
        "v": SCHEMA_VERSION,
        "window": {"t0": t0, "t1": t1, "wall_s": round(wall, 3)},
        "events": len(records),
        "counters": counters,
        "gauges": gauges,
        "attribution": attribution,
        "per_worker": {k: per_worker[k] for k in workers},
        "per_cell": {k: per_cell[k] for k in sorted(per_cell)},
        "histograms": {"trial_dur_s": hist},
    }


def publish_metrics(directory) -> Optional[Dict[str, Any]]:
    """Fold <dir>/events.jsonl and atomically publish metrics.json.

    Multi-process safe: each worker folds the *shared* event file, so
    last-writer-wins is convergent (the latest fold sees the most
    events).  Returns the metrics dict, or None when there are no
    events to fold.
    """
    records = read_events(directory)
    if not records:
        return None
    metrics = fold_metrics(records)
    try:
        atomic_publish(os.path.join(str(directory), METRICS_NAME),
                       json.dumps(metrics, indent=1), prefix=".metrics-")
    except OSError:
        return metrics
    return metrics


def load_metrics(directory) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(str(directory), METRICS_NAME), "r") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# --------------------------------------------------------- chrome trace
_TRACK_FIELDS = ("v", "kind", "ts", "worker", "pid", "thread", "dur_s",
                 "span", "parent")


def chrome_trace(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold events into Chrome-trace / Perfetto ``traceEvents`` JSON.

    Workers become process tracks (pid), their pool threads thread
    tracks (tid).  Events with a duration (trial, compile, cell,
    measure spans) become complete slices (``ph: "X"``); everything
    else (steals, strikes, retries, SLO aborts…) becomes an instant
    event (``ph: "i"``).  Timestamps are microseconds relative to the
    earliest event, which keeps the JSON small and Perfetto happy.
    """
    stamped = [r for r in records
               if isinstance(r.get("ts"), (int, float))]
    stamped.sort(key=lambda r: r["ts"])
    t0 = stamped[0]["ts"] if stamped else 0.0
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    events: List[Dict[str, Any]] = []
    for rec in stamped:
        worker = rec.get("worker") or "?"
        thread = rec.get("thread") or "main"
        if worker not in pids:
            pids[worker] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[worker], "tid": 0,
                           "args": {"name": worker}})
        track = (worker, thread)
        if track not in tids:
            tids[track] = sum(1 for t in tids if t[0] == worker) + 1
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pids[worker], "tid": tids[track],
                           "args": {"name": thread}})
        kind = rec.get("kind", "?")
        args = {k: v for k, v in rec.items()
                if k not in _TRACK_FIELDS and v is not None}
        name = kind
        if rec.get("cell"):
            name = f"{kind} {rec['cell']}"
        ev: Dict[str, Any] = {
            "name": name, "cat": kind,
            "pid": pids[worker], "tid": tids[track],
            "ts": round((rec["ts"] - t0) * 1e6, 1),
            "args": args,
        }
        if rec.get("span") is not None:
            ev["args"]["span"] = rec["span"]
            if rec.get("parent") is not None:
                ev["args"]["parent"] = rec["parent"]
        if rec.get("dur_s") is not None:
            ev["ph"] = "X"
            ev["dur"] = round(rec["dur_s"] * 1e6, 1)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(directory, out_path) -> int:
    """Write the Chrome-trace JSON for <dir>/events.jsonl to out_path.
    Returns the number of trace events written (excluding metadata)."""
    trace = chrome_trace(read_events(directory))
    payload = json.dumps(trace)
    out_path = str(out_path)
    parent = os.path.dirname(out_path) or "."
    os.makedirs(parent, exist_ok=True)
    atomic_publish(out_path, payload, prefix=".trace-")
    return sum(1 for e in trace["traceEvents"] if e.get("ph") != "M")
