"""Safe online serving tuning: SLO guardrails, shadow slices, promotion.

Per 2309.01901 (safe exploration on live Spark jobs), a candidate
config must never be allowed to ruin the stream it is being trialed on.
Three mechanisms, all riding the existing hardening machinery:

  * :class:`SLOGuard` — watches every request served during a candidate
    replay.  The first ``shadow_frac`` of the stream is the **shadow
    slice**: per-request checks, strictest, so a bad config is aborted
    within its first waves.  After the candidate graduates the shadow
    slice the guard keeps watching running means (a slow regression
    still aborts).  An abort raises :class:`SLOViolation`, a
    :class:`~repro_torch.core.trial.TrialError` pre-tagged
    ``deterministic`` — the evaluator scores the trial as a
    deterministic crash (cost inf), the quarantine ledger records the
    crashed completion, and the trace is never finished under the bad
    config.
  * thresholds are **relative to the incumbent**: ``slo_ttft`` is a
    multiplier over the incumbent's replay stats for the same trace
    (floored by the absolute constants below so a near-zero incumbent
    cannot make every candidate a violator).
  * :class:`PromotionBoard` — atomic winner promotion into a per-cell
    live-config file (core/fsutil.atomic_publish: readers never see a
    torn config) with an append-only promotions/demotions history.  A
    promotion only lands if it strictly improves on the incumbent's
    recorded cost — the live file never regresses.

This is the PyTorch port's own copy of the reference's
``serving/canary.py``: its output is byte-identical to the reference's.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Dict, List, Optional

from repro_torch.core import telemetry as _telemetry
from repro_torch.core.fsutil import append_jsonl, atomic_publish
from repro_torch.core.trial import FAILURE_DETERMINISTIC, TrialError

#: absolute floors (seconds) under the relative thresholds: an incumbent
#: that serves in microseconds must not turn measurement noise into
#: SLO violations
SLO_TTFT_FLOOR_S = 0.25
SLO_QDELAY_FLOOR_S = 0.25

SERVING_DIRNAME = "serving"
PROMOTIONS_FILENAME = "promotions.jsonl"


class SLOViolation(TrialError):
    """A candidate regressed TTFT / queue delay past the guardrail —
    pre-tagged deterministic so quarantine accounting applies."""

    def __init__(self, message: str):
        super().__init__(message, failure=FAILURE_DETERMINISTIC)


class SLOGuard:
    """Per-replay guardrail.  ``observe`` is called once per served
    request (serving/evaluator.ServeEvaluator.replay) and raises
    :class:`SLOViolation` to abort the replay mid-trace."""

    def __init__(self, slo_ttft: float, incumbent: Dict[str, float],
                 shadow_frac: float = 0.25):
        self.factor = float(slo_ttft)
        self.ttft_limit = self.factor * max(
            float(incumbent.get("mean_ttft_s", 0.0)), SLO_TTFT_FLOOR_S)
        self.qdelay_limit = self.factor * max(
            float(incumbent.get("p95_qdelay_s", 0.0)), SLO_QDELAY_FLOOR_S)
        self.shadow_frac = float(shadow_frac)
        self._sum_ttft = 0.0
        self._n = 0

    def observe(self, ttft_s: float, qdelay_s: float,
                served: int, total: int) -> None:
        self._n += 1
        self._sum_ttft += float(ttft_s)
        shadow_n = max(1, int(self.shadow_frac * max(1, total) + 0.999))
        in_shadow = served <= shadow_n
        # queue delay is a virtual-clock quantity — deterministic per
        # (config, trace) — so it is checked per-request everywhere
        if qdelay_s > self.qdelay_limit:
            self._abort("qdelay", qdelay_s, served, total, in_shadow,
                        f"slo-violation: queue delay {qdelay_s:.3f}s "
                        f"exceeds {self.qdelay_limit:.3f}s "
                        f"({self.factor:g}x incumbent) "
                        f"after {served}/{total} requests"
                        f"{' (shadow slice)' if in_shadow else ''}")
        ttft_signal = ttft_s if in_shadow else self._sum_ttft / self._n
        if ttft_signal > self.ttft_limit:
            kind = "TTFT" if in_shadow else "mean TTFT"
            self._abort("ttft", ttft_signal, served, total, in_shadow,
                        f"slo-violation: {kind} {ttft_signal:.3f}s "
                        f"exceeds {self.ttft_limit:.3f}s "
                        f"({self.factor:g}x incumbent) "
                        f"after {served}/{total} requests"
                        f"{' (shadow slice)' if in_shadow else ''}")

    def _abort(self, signal: str, value: float, served: int, total: int,
               in_shadow: bool, message: str) -> None:
        """Emit the SLO-abort telemetry event, then raise.  The event is
        observability only — the decision (abort, scored deterministic
        crash) is the exception, identical with telemetry on or off."""
        tel = _telemetry.current()
        if tel.enabled:
            tel.emit("slo.abort", signal=signal, value=round(value, 4),
                     served=served, total=total, shadow=in_shadow)
        raise SLOViolation(message)


# -------------------------------------------------------------- promotion
class PromotionBoard:
    """Per-cell live-config files + append-only promotion history under
    ``<campaign dir>/serving/``.  Multi-process safe by the same idioms
    as the rest of the fabric: atomic_publish for the live files (last
    complete writer wins, readers never torn), append_jsonl for the
    history."""

    def __init__(self, directory: pathlib.Path):
        self.dir = pathlib.Path(directory) / SERVING_DIRNAME
        self.live_dir = self.dir / "live"
        self.history_path = self.dir / PROMOTIONS_FILENAME

    def live_path(self, cell_key: str) -> pathlib.Path:
        return self.live_dir / f"{cell_key}.json"

    def live(self, cell_key: str) -> Optional[Dict]:
        """The currently promoted record for a cell (None if nothing
        has ever been promoted)."""
        try:
            return json.loads(self.live_path(cell_key).read_text())
        except (OSError, ValueError):
            return None

    def promote(self, cell_key: str, config: Dict[str, Any],
                cost_s: float, source: str = "",
                stats: Optional[Dict] = None) -> Dict:
        """Promote ``config`` as the cell's live config iff it strictly
        improves on the incumbent's recorded cost; the displaced
        incumbent goes to the demotion history.  Returns the history
        record (``action``: promoted | kept-incumbent)."""
        incumbent = self.live(cell_key)
        rec: Dict[str, Any] = {
            "v": 1, "ts": round(time.time(), 3), "cell": cell_key,
            "cost_s": float(cost_s), "source": source,
        }
        if incumbent is not None and \
                float(incumbent.get("cost_s", float("inf"))) <= float(cost_s):
            # never regress the live file: the incumbent stays
            rec.update(action="kept-incumbent",
                       incumbent_cost_s=incumbent.get("cost_s"))
            append_jsonl(self.history_path, rec)
            return rec
        live = {
            "v": 1, "cell": cell_key, "config": dict(config),
            "cost_s": float(cost_s), "promoted_ts": rec["ts"],
            "source": source,
        }
        if stats:
            live["stats"] = dict(stats)
        self.live_dir.mkdir(parents=True, exist_ok=True)
        atomic_publish(self.live_path(cell_key),
                       json.dumps(live, indent=1, sort_keys=True) + "\n",
                       prefix="live")
        rec.update(action="promoted", config=dict(config),
                   demoted=({"config": incumbent.get("config"),
                             "cost_s": incumbent.get("cost_s"),
                             "promoted_ts": incumbent.get("promoted_ts")}
                            if incumbent is not None else None))
        append_jsonl(self.history_path, rec)
        return rec

    def history(self) -> List[Dict]:
        out = []
        try:
            text = self.history_path.read_text()
        except OSError:
            return out
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out


def promote_winners(directory: pathlib.Path, reports: Dict[str, Any],
                    source: str = "") -> List[Dict]:
    """Promote every serve cell's surviving winner from a campaign's
    reports (cell key -> TuningReport).  Crashed finals (cost inf/nan)
    never promote; the measured-tier winner overrides the model winner
    when attached.  Returns the history records written."""
    from repro_torch.serving.evaluator import SERVE_ARCH_PREFIX
    board = PromotionBoard(directory)
    out = []
    for key, rep in sorted(reports.items()):
        if not key.startswith(SERVE_ARCH_PREFIX):
            continue
        config = dict(rep.final_config)
        cost = float(rep.final_cost)
        meas = getattr(rep, "measured", None)
        if meas and meas.get("winner"):
            config = dict(meas["winner"].get("config", config))
            cost = float(meas["winner"].get("cost_s", cost))
        if not (cost == cost) or cost == float("inf"):
            continue
        out.append(board.promote(key, config, cost, source=source))
    return out
