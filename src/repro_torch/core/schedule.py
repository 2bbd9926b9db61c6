"""Online campaign scheduler — live cell admission + priority queue.

The campaign engine (core/campaign.py) and fabric (core/fabric.py) were
batch systems: the set of (arch, shape, mesh) cells was frozen when the
process started, and cells ran in first-seen-arch order.  A production
tuning service meets workloads as they *arrive* and should spend its
trial budget where the expected gain is highest (online tuning à la
2309.01901).  This module owns both halves of that:

  * **intake** — a campaign directory gains an ``intake/`` subdirectory;
    anyone (``launch/tune.py --add-cells``, another process, another
    host on a shared mount) submits a cell by atomically renaming a
    ``<cell-key>.cell`` JSON file into it (:func:`submit_cells`).  A
    running campaign or fabric worker re-scans the intake between
    batches / when idle (:meth:`CellQueue.scan_intake`) and admits the
    new cells without restarting.  An ``intake/STOP`` sentinel
    (:func:`request_stop`) tells ``--watch`` workers to exit once the
    board is drained;
  * **priority** — a pluggable :class:`CellPrioritizer` scores every
    pending cell; the :class:`CellQueue` hands cells out
    highest-expected-speedup first.  ``arch`` reproduces the historical
    first-seen-arch order bit-for-bit; ``history`` estimates each
    cell's expected speedup from the accumulated trial history
    (:meth:`~repro_torch.core.history.TrialHistory.expected_speedup` —
    best-of-nearest-cells via the history-fit similarity weights,
    falling back to the static registry-derived weights while the
    history is too thin to fit).  Cells
    the history knows nothing about sort *first* (explore-first: an
    unknown cell is where information is cheapest).  The first-seen-arch
    order survives as the tie-break, so same-arch calibration compiles
    still land adjacently in the shared compile cache.

Priority changes *scheduling order only*: each cell's search cursor is
a deterministic state machine, so a cold cell's decisions are
bit-identical to the static arch-ordered campaign whatever the
admission time or priority mode (regression-tested in
tests/test_schedule.py).  The one order-sensitive feature is
warm-start: seeds are resolved when a cell is handed out, so a
late-scheduled cell may be seeded by trials the same run already
appended — deliberate, and replay-exact via the checkpointed seeds.

This is the PyTorch port's copy of the reference's ``core/schedule.py``;
intake order, priorities and the queue view are identical.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    Sequence, runtime_checkable)

from repro_torch.core.campaign import CellSpec, parse_cells
from repro_torch.core.fsutil import atomic_publish

INTAKE_DIR = "intake"
INTAKE_SUFFIX = ".cell"
STOP_FILENAME = "STOP"
INTAKE_VERSION = 1

_UNSET = object()


# ---------------------------------------------------------------- intake
def intake_dir(directory: pathlib.Path) -> pathlib.Path:
    """The intake subdirectory of a campaign/fabric directory."""
    return pathlib.Path(directory) / INTAKE_DIR


def submit_cells(directory: pathlib.Path,
                 cells: Sequence[CellSpec]) -> List[pathlib.Path]:
    """Submit cells to a (possibly running) campaign directory.

    One ``intake/<cell-key>.cell`` JSON file per cell, published with a
    unique tempfile + atomic ``os.replace`` so a concurrent scanner
    never reads a torn submission.  Re-submitting a cell overwrites its
    file (idempotent — admission dedups by cell key anyway).  Returns
    the published paths.
    """
    inbox = intake_dir(directory)
    inbox.mkdir(parents=True, exist_ok=True)
    out = []
    base = time.time()
    for i, spec in enumerate(cells):
        # strictly increasing timestamps keep one call's cells in list
        # order under the scanner's (submitted_at, key) sort
        payload = {"v": INTAKE_VERSION, "cell": spec.spec(),
                   "submitted_at": round(base + i * 1e-4, 6)}
        path = inbox / f"{spec.key()}{INTAKE_SUFFIX}"
        atomic_publish(path, json.dumps(payload))
        out.append(path)
    return out


def scan_intake(directory: pathlib.Path) -> List[CellSpec]:
    """Parse every submission in the intake directory, oldest first
    (submission timestamp, then cell key — deterministic across
    processes scanning the same mount).  Torn/invalid files are skipped,
    never fatal: the submitter's atomic rename makes them either a
    foreign leftover or garbage.  Submissions stay on disk — they are
    the durable admission record every fabric worker must see — until
    ``--fresh`` clears them.
    """
    inbox = intake_dir(directory)
    if not inbox.is_dir():
        return []
    found = []
    for path in inbox.glob(f"*{INTAKE_SUFFIX}"):
        try:
            d = json.loads(path.read_text())
            spec = parse_cells(d["cell"])[0]
            ts = float(d.get("submitted_at") or 0.0)
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError):         # e.g. a non-string "cell"
            continue                     # torn or foreign file: skip
        found.append((ts, spec.key(), spec))
    found.sort(key=lambda t: (t[0], t[1]))
    return [spec for _, _, spec in found]


def clear_intake(directory: pathlib.Path,
                 cells: Optional[Sequence[CellSpec]] = None) -> None:
    """Remove intake submissions and any STOP sentinel — the
    ``--fresh`` companion to :func:`submit_cells`.  With ``cells=None``
    *every* submission goes (``--fresh`` must not let a stale
    ``--add-cells`` file silently re-admit a foreign cell into the
    supposedly fresh campaign); with an explicit list only those
    cells' files are removed."""
    inbox = intake_dir(directory)
    if cells is None:
        paths = list(inbox.glob(f"*{INTAKE_SUFFIX}")) \
            if inbox.is_dir() else []
    else:
        paths = [inbox / f"{spec.key()}{INTAKE_SUFFIX}"
                 for spec in cells]
    for path in paths:
        try:
            os.unlink(path)
        except OSError:
            pass
    try:
        os.unlink(inbox / STOP_FILENAME)
    except OSError:
        pass


def request_stop(directory: pathlib.Path) -> pathlib.Path:
    """Drop the STOP sentinel: ``--watch`` workers exit once every
    admitted cell is done (they finish the board first).

    A stop request is aimed at the workers watching *now*: each watch
    worker compares the sentinel's request time against its own
    process start (:func:`stop_requested_since`) and simply *ignores*
    an older one — nobody ever deletes the shared file on startup, so
    a new worker joining mid-drain can never cancel a live stop for
    the rest of the fabric.  The request time is stored in the payload
    (like intake submissions), so the comparison does not depend on
    filesystem mtime resolution; a stale sentinel is inert and is
    removed by ``--fresh`` or overwritten by the next stop."""
    inbox = intake_dir(directory)
    inbox.mkdir(parents=True, exist_ok=True)
    path = inbox / STOP_FILENAME
    # durable: a STOP that evaporates in a host crash leaves watch
    # workers draining a fabric the operator believes is stopping
    atomic_publish(path, json.dumps(
        {"v": 1, "requested_at": round(time.time(), 6)}),
        durable=True)
    return path


def _stop_requested_at(path: pathlib.Path) -> Optional[float]:
    """When the sentinel was dropped: the payload's own timestamp,
    falling back to mtime for a foreign/empty file; None if absent."""
    try:
        return float(json.loads(path.read_text())["requested_at"])
    except (OSError, ValueError, KeyError, TypeError):
        pass
    try:
        return path.stat().st_mtime
    except OSError:
        return None


def stop_requested(directory: pathlib.Path) -> bool:
    return (intake_dir(directory) / STOP_FILENAME).exists()


def stop_requested_since(directory: pathlib.Path,
                         since: float) -> bool:
    """True iff a STOP was requested at or after ``since`` (a watch
    worker passes its process start time): an older sentinel targets a
    *previous* session and is ignored — never deleted, so one worker's
    notion of stale can't cancel a stop that is live for the rest of
    the fabric.

    The comparison uses wall-clock timestamps from (possibly) two
    hosts, so multi-host watch fabrics need loosely synchronized
    clocks (NTP-level; skew larger than a worker's uptime makes a live
    stop read as stale — the remedy is re-issuing ``--stop``).  The
    same assumption already underpins the lease heartbeat TTLs
    (core/fabric.py)."""
    ts = _stop_requested_at(intake_dir(directory) / STOP_FILENAME)
    return ts is not None and ts >= since


# ----------------------------------------------------------- prioritizers
@runtime_checkable
class CellPrioritizer(Protocol):
    """Scores a pending cell's expected speedup.

    ``score`` returns the estimated speedup still to be had from tuning
    this cell (higher = schedule sooner), or ``None`` when the cell is
    unknown — unknown cells sort *first* (explore-first).  Scoring must
    be deterministic for a given history state: fabric workers on
    different hosts rank the same board identically.
    """

    name: str

    def score(self, spec: CellSpec) -> Optional[float]: ...


class ArchPrioritizer:
    """The historical order: no per-cell signal, every cell ties, and
    the queue's first-seen-arch + admission-order tie-break reproduces
    the static campaign's kickoff order bit-for-bit."""

    name = "arch"

    def score(self, spec: CellSpec) -> Optional[float]:
        return None


class HistoryPrioritizer:
    """Expected speedup from the accumulated trial history: the best
    observed speedup among the ``k_cells`` nearest already-tuned cells
    (signature similarity with weights *fit from the history itself*
    once it holds enough comparable cell pairs, else the static
    registry-derived weights — core/history.py).  A cell with no
    usable neighbours scores ``None`` → explore-first."""

    name = "history"

    def __init__(self, history, k_cells: int = 2):
        if history is None:
            raise ValueError("history prioritizer needs a trial history")
        self.history = history
        self.k_cells = k_cells

    def score(self, spec: CellSpec) -> Optional[float]:
        return self.history.expected_speedup(
            spec.arch, spec.shape, spec.multi_pod, k_cells=self.k_cells)


PRIORITIZERS: Dict[str, Callable[..., CellPrioritizer]] = {
    "arch": lambda history=None: ArchPrioritizer(),
    "history": lambda history=None: HistoryPrioritizer(history),
}


def get_prioritizer(name_or_instance, history=None) -> CellPrioritizer:
    """Resolve a prioritizer name (``arch`` / ``history``) or pass an
    instance through (custom prioritizers plug in like strategies)."""
    if not isinstance(name_or_instance, str):
        return name_or_instance
    if name_or_instance not in PRIORITIZERS:
        raise KeyError(f"unknown prioritizer {name_or_instance!r} "
                       f"(registered: {', '.join(sorted(PRIORITIZERS))})")
    return PRIORITIZERS[name_or_instance](history=history)


# ------------------------------------------------------------- the queue
@dataclasses.dataclass
class QueueEntry:
    """One admitted cell's scheduling state."""
    spec: CellSpec
    source: str                       # "seed" | "intake"
    admit_index: int
    admitted_at: float
    state: str = "pending"            # pending | active | done
    score: Optional[float] = None     # last priority query

    def as_dict(self) -> Dict[str, Any]:
        return {"cell": self.spec.key(), "source": self.source,
                "state": self.state, "score": self.score,
                "admitted_at": self.admitted_at}


class CellQueue:
    """Admission, ordering and completion tracking for an online
    campaign.

    Cells enter as construction-time *seeds* or through the intake
    directory (:meth:`scan_intake`), deduplicated by cell key.  Pending
    cells are handed out in priority order: unknown-first (explore),
    then expected speedup descending, with first-seen-arch grouping +
    admission order as the deterministic tie-break (compile-cache
    locality).  The queue is in-process state — in a fabric, every
    worker builds its own queue over the same directory and the lease
    board stays the sole claim arbiter; the queue only decides *which
    cell to try to claim next*.
    """

    def __init__(self, cells: Sequence[CellSpec] = (), *,
                 prioritizer="arch", history=None,
                 directory: Optional[pathlib.Path] = None):
        """``directory`` is the campaign/fabric directory whose
        ``intake/`` subdirectory this queue watches (None: no intake —
        a closed-world batch queue)."""
        self.prioritizer = get_prioritizer(prioritizer, history=history)
        self.directory = pathlib.Path(directory) \
            if directory is not None else None
        self._entries: Dict[str, QueueEntry] = {}
        self._arch_rank: Dict[str, int] = {}
        self.admit(cells, source="seed")

    # -------------------------------------------------------- admission
    def admit(self, cells: Sequence[CellSpec],
              source: str = "seed") -> List[CellSpec]:
        """Admit new cells (already-admitted keys are no-ops); returns
        the genuinely new ones in admission order."""
        fresh = []
        for spec in cells:
            key = spec.key()
            if key in self._entries:
                continue
            self._arch_rank.setdefault(spec.arch, len(self._arch_rank))
            self._entries[key] = QueueEntry(
                spec=spec, source=source, admit_index=len(self._entries),
                admitted_at=time.time())
            fresh.append(spec)
        return fresh

    def scan_intake(self) -> List[CellSpec]:
        """Admit every new submission in the directory's intake; returns
        the newly admitted cells (no directory → no-op)."""
        if self.directory is None:
            return []
        return self.admit(scan_intake(self.directory), source="intake")

    # --------------------------------------------------------- ordering
    def rank_key(self, key: str, gain=_UNSET) -> tuple:
        """The sort key of one admitted cell.  With ``gain`` (a live
        cursor-reported ``expected_gain``), that estimate replaces the
        prioritizer's static score — the campaign re-ranks in-flight
        cells between batches with it.  ``None`` (either source) sorts
        first: an unscored cell is an explore-first cell."""
        e = self._entries[key]
        if gain is _UNSET:
            e.score = self.prioritizer.score(e.spec)
            val = e.score
        else:
            val = gain
        return (0 if val is None else 1,
                -(val if val is not None else 0.0),
                self._arch_rank[e.spec.arch],
                e.admit_index)

    def order(self, states: Sequence[str] = ("pending",)
              ) -> List[CellSpec]:
        """Admitted cells in the given states, priority order
        (re-queries the prioritizer — history may have grown)."""
        keys = [k for k, e in self._entries.items() if e.state in states]
        keys.sort(key=self.rank_key)
        return [self._entries[k].spec for k in keys]

    def pop_next(self) -> Optional[CellSpec]:
        """Highest-priority pending cell, marked active; None if no
        cell is pending."""
        nxt = self.order()
        if not nxt:
            return None
        self.mark_active(nxt[0].key())
        return nxt[0]

    # ------------------------------------------------------ completion
    def _set_state(self, key: str, state: str) -> None:
        self._entries[key].state = state

    def mark_active(self, key: str) -> None:
        self._set_state(key, "active")

    def mark_done(self, key: str) -> None:
        self._set_state(key, "done")

    def state(self, key: str) -> str:
        return self._entries[key].state

    # --------------------------------------------------------- queries
    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def cells(self) -> List[CellSpec]:
        """Every admitted cell, admission order."""
        return [e.spec for e in self._entries.values()]

    def entries(self) -> List[QueueEntry]:
        return list(self._entries.values())

    def depth(self) -> Dict[str, int]:
        """Queue depth per state (the ``--status`` headline)."""
        out = {"pending": 0, "active": 0, "done": 0}
        for e in self._entries.values():
            out[e.state] += 1
        return out

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view for stats / reporting (re-scores pending
        cells so the recorded priorities are current)."""
        for key, e in self._entries.items():
            if e.state != "done":
                self.rank_key(key)       # refresh e.score
        return {
            "prioritize": self.prioritizer.name,
            "depth": self.depth(),
            "admitted": len(self._entries),
            "from_intake": sum(1 for e in self._entries.values()
                               if e.source == "intake"),
            "cells": [e.as_dict() for e in self._entries.values()],
        }


# --------------------------------------------------------------- status
def queue_status(directory: pathlib.Path, strategy: str = "tree",
                 cells: Optional[Sequence[CellSpec]] = None
                 ) -> Dict[str, Any]:
    """The operator's queue view (``launch/tune.py --status``): every
    cell known to a campaign directory — explicit ``cells``, checkpoint
    files and intake submissions — with its checkpoint state, plus the
    live lease board (:meth:`~repro_torch.core.fabric.LeaseBoard.held`) so
    claimed/expired cells are visible without reading lease files by
    hand.  Read-only: never claims, never evaluates."""
    from repro_torch.core.fabric import LeaseBoard, checkpoint_done
    directory = pathlib.Path(directory)
    known: Dict[str, Dict[str, Any]] = {}

    def note(key: str, **kw) -> Dict[str, Any]:
        d = known.setdefault(key, {"cell": key, "source": "checkpoint",
                                   "done": False})
        d.update(kw)
        return d

    for spec in (cells or []):
        note(spec.key(), source="seed")
    for spec in scan_intake(directory):
        entry = note(spec.key())
        if entry["source"] != "seed":
            entry["source"] = "intake"
    for path in sorted(directory.glob("*.json")):
        try:
            d = json.loads(path.read_text())
        except (OSError, ValueError):
            continue
        if isinstance(d, dict) and "cell" in d and "strategy" in d:
            # discovery only — done-ness is judged below by the one
            # shared criterion (checkpoint_done), so --status can never
            # call a cell done that a worker would re-tune
            entry = note(d["cell"])
            if isinstance(d.get("health"), dict):
                # per-cell failure/retry/quarantine counts so a
                # degrading campaign is visible before it finishes
                entry["health"] = d["health"]
    board = LeaseBoard(directory)
    leases, now = [], time.time()
    for st in board.held():
        leases.append({"cell": st.cell, "worker": st.worker,
                       "host": st.host,
                       "age_s": round(now - st.heartbeat_at, 1),
                       "ttl_s": st.ttl_s,
                       "expired": st.expired(now)})
        if st.cell not in known:
            note(st.cell, source="lease")
        if not st.expired(now):
            known[st.cell]["claimed_by"] = st.worker
    for key in known:
        known[key]["done"] = known[key]["done"] \
            or checkpoint_done(directory, key, strategy)
    pending = [k for k, d in known.items()
               if not d["done"] and "claimed_by" not in d]
    claimed = [k for k, d in known.items()
               if not d["done"] and "claimed_by" in d]
    # report the stop's request time, not just existence: the sentinel
    # is deliberately never deleted, so without the age an operator
    # can't tell a live drain from a stale leftover a newer watch
    # session is (correctly) ignoring
    stop_ts = _stop_requested_at(intake_dir(directory) / STOP_FILENAME)
    out = {
        "dir": str(directory),
        "strategy": strategy,
        "depth": {"pending": len(pending), "claimed": len(claimed),
                  "done": sum(d["done"] for d in known.values())},
        "stop_requested": stop_ts is not None,
        "stop_requested_at": stop_ts,
        "cells": sorted(known.values(), key=lambda d: d["cell"]),
        "leases": leases,
    }
    from repro_torch.core.quarantine import Quarantine
    q = Quarantine(directory)
    if q.path.exists():
        out["quarantine"] = q.summary()
    return out
