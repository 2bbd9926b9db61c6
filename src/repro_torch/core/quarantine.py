"""Fleet-wide poison-config quarantine (evaluation-intent ledger).

The failure mode this closes: a config that SIGKILLs its worker leaves
no trace — the fabric's lease-steal recovers the *cell*, the stealer
replays the checkpoint, the cursor re-proposes the same config, and the
fleet crash-loops on it forever.  The quarantine ledger makes the
evaluation itself observable across process death:

  * before evaluating, a worker appends an **intent** record (cell,
    config key, attempt id, worker, pid) to ``quarantine.jsonl``;
  * after the evaluation returns — crashed or not — it appends a
    **completion** for the same attempt;
  * a worker that claims a cell (fresh or stolen lease) first *reaps
    orphans*: any intent on that cell with neither a completion nor a
    strike marks an evaluation that died mid-flight, and earns the
    in-flight config a **strike**;
  * a config whose effective strikes reach ``strike_threshold`` (K) is
    quarantined fleet-wide: every executor path skips it, scoring it as
    a deterministic crash.  A worker-killing config is therefore
    evaluated at most K times across the whole fabric.

Effective strikes use a *completion-reset* rule: only strikes recorded
after the config's last **successful** completion count.  This absolves
benign batch-mates — when a poison config kills a worker mid-batch, the
other in-flight configs are orphaned too and struck on reap, but they
succeed on re-evaluation and their count resets to zero; the poison
config never completes, so its strikes only accumulate.

The ledger is append-only JSONL via the torn-tolerant O_APPEND idiom
(core/fsutil.append_jsonl) with per-record fsync (``durable=True``):
records are correctness signals across worker processes, so they must
survive the very crash they are recording.  Readers skip unparseable
lines; records are idempotent and dedup by attempt id, so two stealers
racing to strike the same orphan converge on one effective strike.

This is the PyTorch port's own copy of the reference's
``core/quarantine.py``: its output is byte-identical to the reference's.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import time
import uuid
from typing import Dict, List, Optional, Set

from repro_torch.core import telemetry as _telemetry
from repro_torch.core.fsutil import append_jsonl
from repro_torch.core.params import TunableConfig

QUARANTINE_FILENAME = "quarantine.jsonl"
DEFAULT_STRIKE_THRESHOLD = 3


def config_key(rt: TunableConfig) -> str:
    """Stable fleet-wide identity of a full config (all 12 knobs)."""
    blob = json.dumps(rt.as_dict(), sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


class Quarantine:
    """One shared evaluation-intent ledger over a campaign directory.

    Thread-safe for the executor's use (appends are single O_APPEND
    writes; reads re-parse on (size, mtime) change) and multi-process
    safe by construction of the ledger format.
    """

    def __init__(self, directory: pathlib.Path,
                 strike_threshold: int = DEFAULT_STRIKE_THRESHOLD,
                 worker: str = "", durable: bool = True):
        self.dir = pathlib.Path(directory)
        self.path = self.dir / QUARANTINE_FILENAME
        self.strike_threshold = strike_threshold
        self.worker = worker
        self.durable = durable
        self._cache_stat = None
        self._cache_records: List[Dict] = []

    # ------------------------------------------------------------ ledger
    def _append(self, rec: Dict) -> None:
        rec = dict(rec)
        rec.setdefault("v", 1)
        rec.setdefault("ts", round(time.time(), 3))
        rec.setdefault("worker", self.worker)
        rec.setdefault("pid", os.getpid())
        append_jsonl(self.path, rec, durable=self.durable)

    def records(self) -> List[Dict]:
        """All parseable ledger records, in append order.  Cached on
        (size, mtime_ns) so repeated guards during a sweep cost one
        stat; unparseable lines (torn tails) are skipped."""
        try:
            st = self.path.stat()
        except OSError:
            return []
        stat_key = (st.st_size, st.st_mtime_ns)
        if stat_key == self._cache_stat:
            return self._cache_records
        recs = []
        try:
            text = self.path.read_text()
        except OSError:
            return []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("type"):
                recs.append(rec)
        self._cache_stat = stat_key
        self._cache_records = recs
        return recs

    # ------------------------------------------------------- protocol
    def begin(self, cell: str, rt: TunableConfig) -> Dict:
        """Record the intent to evaluate ``rt`` on ``cell``.  Returns
        the token to pass to :meth:`complete`."""
        token = {"attempt": uuid.uuid4().hex[:12],
                 "key": config_key(rt), "cell": cell}
        self._append({"type": "intent", "config": rt.as_dict(), **token})
        return token

    def complete(self, token: Dict, crashed: bool,
                 note: str = "") -> None:
        """Record that the attempt returned (however it went)."""
        self._append({"type": "complete", "crashed": bool(crashed),
                      "note": note, **token})

    def strike(self, attempt: str, key: str, cell: str = "",
               reason: str = "") -> None:
        """Assign one strike to ``key`` for a died/hung ``attempt``
        (idempotent per attempt: effective counting dedups by id)."""
        for rec in self.records():
            if rec.get("type") == "strike" and rec.get("attempt") == attempt:
                return
        self._append({"type": "strike", "attempt": attempt, "key": key,
                      "cell": cell, "reason": reason})
        tel = _telemetry.current()
        if tel.enabled:
            tel.emit("quarantine.strike", config=key, cell=cell,
                     reason=reason,
                     strikes=self.effective_strikes(key),
                     threshold=self.strike_threshold)

    def reap_orphans(self, cell: Optional[str] = None) -> List[str]:
        """Strike every orphaned intent (no completion, no strike) —
        call after claiming a cell's lease, when no other worker can be
        legitimately mid-evaluation on it.  ``cell=None`` reaps across
        all cells (single-process campaign resume).  Returns the config
        keys struck."""
        recs = self.records()
        completed = {r.get("attempt") for r in recs
                     if r.get("type") == "complete"}
        struck = {r.get("attempt") for r in recs
                  if r.get("type") == "strike"}
        reaped = []
        for rec in recs:
            if rec.get("type") != "intent":
                continue
            if cell is not None and rec.get("cell") != cell:
                continue
            att = rec.get("attempt")
            if att in completed or att in struck:
                continue
            self.strike(att, rec.get("key", ""), rec.get("cell", ""),
                        reason="orphaned intent (worker died mid-trial)")
            struck.add(att)
            reaped.append(rec.get("key", ""))
        return reaped

    # ------------------------------------------------------- judgment
    def effective_strikes(self, key: str) -> int:
        """Distinct struck attempts for ``key`` recorded after its last
        *successful* completion (the completion-reset rule)."""
        last_success = -1
        strikes = {}                      # attempt -> ledger position
        for i, rec in enumerate(self.records()):
            if rec.get("key") != key:
                continue
            t = rec.get("type")
            if t == "complete" and not rec.get("crashed"):
                last_success = i
            elif t == "strike":
                strikes.setdefault(rec.get("attempt"), i)
        return sum(1 for pos in strikes.values() if pos > last_success)

    def is_quarantined(self, key: str) -> bool:
        return self.effective_strikes(key) >= self.strike_threshold

    def quarantined_keys(self) -> Set[str]:
        keys = {r.get("key") for r in self.records()
                if r.get("type") == "strike"}
        return {k for k in keys if k and self.is_quarantined(k)}

    def summary(self) -> Dict:
        """Operator-facing rollup for ``tune.py --status``."""
        recs = self.records()
        strikes: Dict[str, int] = {}
        for rec in recs:
            if rec.get("type") == "strike":
                k = rec.get("key", "")
                strikes[k] = self.effective_strikes(k)
        return {
            "records": len(recs),
            "intents": sum(r.get("type") == "intent" for r in recs),
            "completions": sum(r.get("type") == "complete" for r in recs),
            "strikes": {k: n for k, n in sorted(strikes.items()) if n},
            "quarantined": sorted(self.quarantined_keys()),
            "strike_threshold": self.strike_threshold,
        }
