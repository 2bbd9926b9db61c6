"""Learned cost-model proposer — the ``model`` search strategy.

The paper's premise is that a near-optimal config can be found from a
*very small number of experimental runs*; after the compile cache and
the campaign fabric, the residual cost of a campaign is the number of
trials the cursor evaluates before it lands on the winner.  The trial
history (core/history.py) now holds every evaluated trial across
campaigns — enough signal for a lightweight learned cost model in the
spirit of learning-based tuners (1808.06008) and retrieval-augmented
config tuning (2503.03826): fit on the past, propose the predicted
winners, spend live trials confirming instead of exploring.

:class:`ModelCursor` is that model as a first-class
:class:`~repro_torch.core.strategy.SearchCursor`:

  * **fit** — a pure-numpy ridge regression of log-cost over the
    fixed feature layout of :func:`repro_torch.core.history.featurize`
    (knob one-hots, active-knob indicators, hashed arch/family
    buckets), trained on the *same-shape-kind* viable records of the
    history (gains do not transfer across kinds — the same rule the
    scheduler's expected-speedup uses).  Log-cost makes the surface's
    multiplicative knob effects additive, exactly what a linear model
    can represent;
  * **propose** — each round proposes the top-k predicted configs
    over the *observed support* of the cell's active knobs (values
    with no fit row are exploration, which stays the tree's job);
    because the fit is additive over one-hots its global argmin is
    the per-knob argmin, so large grids need only the argmin plus the
    best single-knob swaps while small grids are scored exhaustively;
    already-evaluated configs are skipped, within the same
    ≤ ``budget`` trials as the tree;
  * **absorb** — live results are appended to the fit rows (crashes
    imputed a worse-than-anything-observed cost, so the model steers
    away from them) and the model refit before the next round (online
    refinement), under the shared
    :func:`~repro_torch.core.tree.apply_accept_rule`;
  * **cold start** — with fewer than ``min_records`` usable same-kind
    records the cursor *delegates every decision* to an embedded
    :class:`~repro_torch.core.tree.TreeCursor`, so a thin-history campaign
    is bit-identical to ``--strategy tree`` (regression-tested);
  * **checkpointable fit state** — the campaign primes the cursor via
    :meth:`build_primer`/:meth:`prime` with a tiny state blob (the raw
    record count and a digest of the rows actually fit) persisted in
    the cell checkpoint.  Because the history is append-only, re-fitting
    on the stored record *prefix* reproduces the original fit exactly,
    so a killed campaign resumes replay-exact even after the history
    has grown underneath it.  A digest mismatch (rewritten history)
    raises, and the campaign falls back to a fresh fit + fresh walk.

Everything is deterministic: same history bytes + same seed ⇒ same
fit ⇒ same proposals, in any process (no wall-clock, no unseeded RNG —
ties break on the canonical config JSON).

This is the PyTorch port's own copy of the reference's
``core/proposer.py``: its output is byte-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import pathlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import telemetry as _telemetry
from repro_torch.core.history import (FEATURES_VERSION, TrialHistory, _viable,
                                cell_signature, config_from_dict,
                                feature_names, featurize)
from repro_torch.core.params import TunableConfig
from repro_torch.core.space import SPACE
from repro_torch.core.tree import (MAX_TRIALS, Candidate, Stage, TreeCursor,
                             TuningReport, absorb_baseline,
                             apply_accept_rule)
from repro_torch.core.trial import TrialResult, TrialRunner

MODEL_VERSION = 1

#: cold-start rule: fewer usable same-kind history rows than this and
#: the cursor delegates to the tree walk.  Roughly two finished
#: same-kind walks plus change — below that a 60+-feature ridge fit is
#: noise dressed as knowledge.
MIN_RECORDS = 24
RIDGE_LAMBDA = 1e-2
TOP_K = 3
#: active-knob grids up to this size are scored exhaustively; larger
#: spaces use the additive argmin + single-swap frontier instead.
POOL_SIZE = 256


def _fp(d: Dict[str, Any]) -> str:
    return json.dumps(d, sort_keys=True, default=str)


def fit_rows(history: Optional[TrialHistory], target_sig: Dict,
             limit: Optional[int] = None
             ) -> Tuple[List[Tuple[np.ndarray, float]], int, str]:
    """The (features, log-cost) rows of ``history`` a fit for
    ``target_sig``'s cell may use: viable, positive-cost, same shape
    kind, featurizable (old-space records are skipped, never crash —
    regression-tested).  ``limit`` restricts the scan to the first N
    raw records: the append-only prefix a checkpointed fit was built
    on.  Returns (rows, raw record count scanned, digest) where the
    digest commits to the feature layout and every row actually used,
    so two processes that fit the same bytes provably fit the same
    model."""
    recs: List[Dict] = history.records() if history is not None else []
    if limit is not None:
        recs = recs[:max(0, int(limit))]
    rows: List[Tuple[np.ndarray, float]] = []
    h = hashlib.sha1(f"features:v{FEATURES_VERSION}".encode())
    for rec in recs:
        if not _viable(rec):
            continue
        cost = float(rec["cost_s"])
        if not cost > 0.0:
            continue
        try:
            sig = cell_signature(rec.get("arch"), rec.get("shape"),
                                 rec.get("multi_pod", False))
            if sig["kind"] != target_sig["kind"]:
                continue                 # gains don't transfer kinds
            cfg = config_from_dict(rec["config"]).as_dict()
            x = featurize(cfg, sig)
        except Exception:
            continue                     # older space / foreign cell
        h.update(_fp([rec.get("cell"), cfg, cost]).encode())
        rows.append((x, math.log(cost)))
    return rows, len(recs), h.hexdigest()


class ModelCursor:
    """History-fit ridge proposer over one cell (see module docstring).

    Obeys the :class:`~repro_torch.core.strategy.SearchCursor` protocol; the
    campaign additionally primes it (``build_primer``/``prime``) with
    the checkpointable fit state.  An unprimed cursor primes itself
    from its ``history`` option on first use, so ``drive()`` and the
    single-cell CLI work without a campaign.
    """

    strategy_version = 1

    def __init__(self, runner: TrialRunner, baseline: TunableConfig,
                 threshold: float = 0.05, *, budget: int = MAX_TRIALS,
                 seed: int = 0, top_k: int = TOP_K,
                 min_records: int = MIN_RECORDS,
                 pool_size: int = POOL_SIZE,
                 ridge_lambda: float = RIDGE_LAMBDA,
                 stages: Optional[List[Stage]] = None,
                 history: Any = None):
        if budget < 1:
            raise ValueError("model strategy needs budget >= 1")
        if top_k < 1:
            raise ValueError("model strategy needs top_k >= 1")
        self.runner = runner
        self.baseline = baseline
        self.threshold = threshold
        self.budget = int(budget)
        self.seed = int(seed)
        self.top_k = int(top_k)
        self.min_records = int(min_records)
        self.pool_size = int(pool_size)
        self.ridge_lambda = float(ridge_lambda)
        wl = runner.workload
        self.cell_sig = cell_signature(wl.arch, wl.shape, wl.multi_pod)
        self._stages = stages
        self._history = (TrialHistory(pathlib.Path(history))
                         if isinstance(history, (str, pathlib.Path))
                         else history)
        # fit state (None until primed)
        self._state: Optional[Dict[str, Any]] = None
        self._tree: Optional[TreeCursor] = None   # cold-start delegate
        self._rows: List[Tuple[np.ndarray, float]] = []
        self._w: Optional[np.ndarray] = None
        # walk state (warm path)
        self.incumbent = baseline
        self.baseline_cost = float("nan")
        self.best_cost = float("nan")
        self.accepted: List[str] = []
        self._phase = 0                  # 0: baseline, 1: rounds, 2: done
        self._round = 0
        self._pending: Optional[List[Candidate]] = None
        self._pred_pending: List[float] = []
        self._seen: set = set()
        self._predictions: List[Dict[str, Any]] = []
        self._ws_seeds: Optional[List[TunableConfig]] = None

    # ------------------------------------------------------- fit state
    @property
    def cold(self) -> Optional[bool]:
        """Cold-start decision (None until primed)."""
        return None if self._state is None else bool(self._state["cold"])

    def build_primer(self, history: Any = None) -> Dict[str, Any]:
        """Snapshot the fit state for this cell from ``history``: the
        raw record count, the number of usable rows, and their digest.
        Tiny by construction — the checkpoint stores the *identity* of
        the fit, not the matrix; :meth:`prime` re-derives the fit from
        the history's record prefix, which the append-only store keeps
        stable."""
        rows, raw, digest = fit_rows(history if history is not None
                                     else self._history, self.cell_sig)
        return {"v": MODEL_VERSION, "cold": len(rows) < self.min_records,
                "records": len(rows), "raw": raw, "digest": digest}

    def prime(self, state: Dict[str, Any], history: Any = None) -> None:
        """Adopt a fit state (fresh from :meth:`build_primer` or stored
        in a checkpoint) and fit the model from the matching history
        prefix.  Raises ``ValueError`` when the stored state no longer
        matches the history bytes (rewritten/truncated store) — the
        campaign then rebuilds a fresh primer.  Must precede the first
        proposal; re-priming before it replaces the state."""
        if self._phase != 0 or self._pending is not None \
                or self.runner.n_trials:
            raise RuntimeError("prime must precede the first proposal")
        if not isinstance(state, dict) or state.get("v") != MODEL_VERSION:
            raise ValueError(f"unusable model state: {state!r}")
        hist = history if history is not None else self._history
        rows, raw, digest = fit_rows(hist, self.cell_sig,
                                     limit=state["raw"])
        if digest != state.get("digest") \
                or len(rows) != state.get("records"):
            raise ValueError("stored model state does not match the "
                             "history bytes")
        cold = len(rows) < self.min_records
        self._state = {"v": MODEL_VERSION, "cold": cold,
                       "records": len(rows), "raw": raw,
                       "digest": digest}
        self._tree = None
        if cold:
            self._tree = TreeCursor(self.runner, self.baseline,
                                    threshold=self.threshold,
                                    stages=self._stages)
            if self._ws_seeds is not None:
                self._tree.warm_start(self._ws_seeds)
        else:
            self._rows = rows
            self._refit()
        t = _telemetry.current()
        if t.enabled:
            t.emit("model.fit", cell=self.runner.workload.key(),
                   cold=cold, records=len(rows), raw=raw,
                   digest=digest)

    def _ensure_primed(self) -> None:
        if self._state is None:
            self.prime(self.build_primer(self._history), self._history)

    def _refit(self) -> None:
        x = np.stack([r[0] for r in self._rows])
        y = np.asarray([r[1] for r in self._rows], dtype=np.float64)
        a = x.T @ x + self.ridge_lambda * np.eye(x.shape[1])
        self._w = np.linalg.solve(a, x.T @ y)

    # ------------------------------------------------------- proposing
    def _active(self) -> List[str]:
        """The knobs the proposal space varies: the cell's active knobs
        that exist in today's registry with a non-trivial domain."""
        return [k for k in self.cell_sig.get("active_knobs") or []
                if k in SPACE.names() and len(SPACE[k].domain) > 1]

    def _predict(self, cfg: Dict[str, Any]) -> float:
        return float(featurize(cfg, self.cell_sig) @ self._w)

    def _observed(self, knob: str) -> List[Any]:
        """The values of ``knob`` with at least one fit row — the
        values the model has *evidence* about, in registry order."""
        names = feature_names()
        out = []
        for v in SPACE[knob].domain:
            ix = names.index(f"{knob}={v}")
            if any(r[0][ix] for r in self._rows):
                out.append(v)
        return out

    def _candidate_dicts(self) -> List[Dict[str, Any]]:
        """The configs one round may propose, deterministically.

        The proposal space is each active knob's *observed support*
        (plus the baseline's value): a never-observed value carries
        ridge weight 0, which an all-positive fit misreads as "best
        available" — proposing it is exploration, and exploration is
        the tree's job, not the model's.  Small support grids
        (≤ ``pool_size``) are enumerated outright.  Larger spaces
        exploit the fit's additivity: its global argmin is the
        per-knob argmin over the baseline, and the next-best
        predictions are that argmin's single-knob swaps — the exact
        top of the grid under an additive model, without materializing
        the grid."""
        base = self.baseline.as_dict()
        domains: Dict[str, List[Any]] = {}
        size = 1
        for k in self._active():
            allowed = set(self._observed(k)) | {base[k]}
            domains[k] = [v for v in SPACE[k].domain if v in allowed]
            size *= len(domains[k])
        active = list(domains)
        out: List[Dict[str, Any]] = []
        if size <= self.pool_size:
            for combo in itertools.product(
                    *(domains[k] for k in active)):
                d = dict(base)
                d.update({k: v for k, v in zip(active, combo)})
                out.append(d)
            return out
        argmin = dict(base)
        for k in active:
            best = min(domains[k],
                       key=lambda v: (self._knob_weight(k, v), str(v)))
            argmin[k] = best
        out.append(argmin)
        for k in active:
            for v in domains[k]:
                if v == argmin[k]:
                    continue
                d = dict(argmin)
                d[k] = v
                out.append(d)
        return out

    def _knob_weight(self, knob: str, value: Any) -> float:
        names = feature_names()
        return float(self._w[names.index(f"{knob}={value}")])

    def _topk(self, n: int) -> List[Candidate]:
        base = self.baseline.as_dict()
        scored: List[Tuple[float, str, Dict[str, Any]]] = []
        for d in self._candidate_dicts():
            fp = _fp(d)
            if fp in self._seen:
                continue
            scored.append((self._predict(d), fp, d))
        # deterministic: predicted cost asc, then canonical config json
        scored.sort(key=lambda t: (t[0], t[1]))
        cands: List[Candidate] = []
        self._pred_pending = []
        for pred, fp, d in scored[:n]:
            self._seen.add(fp)
            delta = {k: v for k, v in d.items() if base[k] != v}
            cands.append(Candidate(self.baseline.replace(**delta),
                                   f"model:{self._round + 1}."
                                   f"{len(cands) + 1}", delta))
            self._pred_pending.append(math.exp(pred))
        return cands

    # ------------------------------------------------------- protocol
    @property
    def done(self) -> bool:
        if self._state is None:
            return False
        if self._tree is not None:
            return self._tree.done
        return self._phase >= 2

    def warm_start(self, configs: Sequence[TunableConfig]) -> None:
        """Cold mode forwards the seeds to the embedded tree (keeping
        bit-identity with a warm-started ``tree`` walk); the warm path
        ignores them — the model already conditions on the *entire*
        history the seeds were retrieved from, so they are redundant
        and deliberately kept out of the signature."""
        self._ws_seeds = list(configs)
        if self._tree is not None:
            self._tree.warm_start(self._ws_seeds)

    def propose(self) -> List[Candidate]:
        self._ensure_primed()
        if self._tree is not None:
            return self._tree.propose()
        if self._pending is not None:
            raise RuntimeError("previous batch not absorbed yet")
        if self._phase == 0:
            self._pending = [Candidate(self.baseline, "baseline", {})]
            return list(self._pending)
        if self._phase != 1:
            return []
        n = min(self.top_k, self.budget - self.runner.n_trials)
        if n <= 0:
            self._phase = 2
            return []
        self._refit()                    # online: absorbed rows re-enter fit
        cands = self._topk(n)
        if not cands:
            self._phase = 2
            return []
        self._pending = cands
        t = _telemetry.current()
        if t.enabled:
            t.emit("model.propose", cell=self.runner.workload.key(),
                   round=self._round + 1, k=len(cands),
                   records=len(self._rows),
                   predicted_best_s=round(self._pred_pending[0], 6))
        return list(self._pending)

    def absorb(self, results: Sequence[TrialResult],
               indices: Sequence[int]) -> None:
        if self._tree is not None:
            self._tree.absorb(results, indices)
            return
        if self._pending is None:
            raise RuntimeError("no batch proposed")
        if len(results) != len(self._pending) \
                or len(indices) != len(self._pending):
            raise ValueError("results/indices do not match proposed batch")
        cands, self._pending = self._pending, None
        if self._phase == 0:
            self.best_cost = absorb_baseline(self.runner, results[0],
                                             indices[0])
            self.baseline_cost = self.best_cost
            self._seen.add(_fp(self.baseline.as_dict()))
            self._absorb_rows([cands[0]], [results[0]])
            self._phase = 1
            return
        won = apply_accept_rule(self.runner,
                                list(zip(cands, results, indices)),
                                self.best_cost, self.threshold)
        for cand, res, idx, pred in zip(cands, results, indices,
                                        self._pred_pending):
            self._predictions.append({
                "name": cand.name, "predicted_s": round(pred, 6),
                "cost_s": res.cost_s, "crashed": bool(res.crashed)})
            if not res.crashed and not self.runner.log[idx].note:
                self.runner.log[idx].note = \
                    f"model predicted {pred:.4f}s"
        self._absorb_rows(cands, results)
        self._pred_pending = []
        if won is not None:
            cand, cost = won
            self.incumbent = cand.config
            self.best_cost = cost
            self.accepted.append(f"model: {cand.delta}")
        self._round += 1

    def _absorb_rows(self, cands: Sequence[Candidate],
                     results: Sequence[TrialResult]) -> None:
        """Online refinement: every live result becomes a fit row for
        the next round's refit.  A crash is *information*, not a gap:
        an unseen knob value carries weight 0, which an all-positive
        fit reads as "best available", so a skipped crash would be
        re-proposed (with cosmetic swaps) every round.  Instead the
        crash is imputed a cost above everything observed, pushing its
        knob values out of the argmin deterministically."""
        for cand, res in zip(cands, results):
            if res.crashed or not res.cost_s > 0.0 \
                    or not math.isfinite(res.cost_s):
                if not self._rows:
                    continue
                y = max(r[1] for r in self._rows) + math.log(4.0)
            else:
                y = math.log(res.cost_s)
            x = featurize(cand.config.as_dict(), self.cell_sig)
            self._rows.append((x, y))

    def report(self) -> TuningReport:
        if self._tree is not None:
            # cold start: the tree's report, verbatim — bit-identical
            # decisions *and* bytes with --strategy tree
            return self._tree.report()
        return TuningReport(
            workload=self.runner.workload.key(),
            baseline_cost=self.baseline_cost,
            final_cost=self.best_cost,
            final_config=self.incumbent.as_dict(),
            n_trials=self.runner.n_trials,
            accepted=self.accepted,
            log=[dataclasses.asdict(e) for e in self.runner.log],
            proposer={
                "version": MODEL_VERSION,
                "cold": False,
                "records": self._state["records"],
                "raw": self._state["raw"],
                "digest": self._state["digest"],
                "rows": list(self._predictions),
            },
        )

    def expected_gain(self) -> Optional[float]:
        """Unknown before the baseline (explore-first); afterwards the
        share of the trial budget still unspent — each remaining trial
        is one more model-ranked chance to accept an improvement.
        Reported to the scheduler only; never feeds back into the
        cursor's own decisions."""
        if self._tree is not None:
            return self._tree.expected_gain()
        if self._phase >= 2:
            return 0.0
        if self._phase == 0:
            return None
        return max(0.0, (self.budget - self.runner.n_trials)
                   / max(1, self.budget))

    def signature_parts(self) -> list:
        parts: list = ["model", MODEL_VERSION, self.seed, self.budget,
                       self.top_k, self.min_records, self.pool_size,
                       self.ridge_lambda]
        if self._state is not None:
            parts.append({k: self._state[k]
                          for k in ("cold", "records", "raw", "digest")})
        if self._tree is not None:
            parts.append(self._tree.signature_parts())
        return parts
