"""Strategy API v1 — pluggable search cursors over one knob space.

The paper's methodology is two search procedures over the same knob
space: the Sec.-4 one-factor-at-a-time sensitivity sweep (Table 2) and
the Fig.-4 ≤10-trial tuning tree.  Both — plus any future procedure
(online cell prioritization à la 2309.01901, multi-granularity tuning à
la 2403.00995) — share one shape:

    propose() -> [Candidate]      # next batch of independent trials
    absorb(results, indices)      # apply outcomes, advance
    done                          # walk complete?
    report()                      # strategy-specific summary

That shape is the :class:`SearchCursor` protocol.  A strategy is a
named, versioned cursor factory in the :data:`STRATEGIES` registry; the
campaign engine (core/campaign.py) drives *any* registered strategy —
interleaved over the shared executor/compile cache, checkpointed and
resumable — without knowing which one it is.

Registered strategies:

  * ``tree``  — the Fig.-4 tuning tree (:class:`~repro_torch.core.tree
    .TreeCursor`), bit-identical logs/budget/decisions to the
    historical blocking walk;
  * ``short`` (alias ``short-tree``) — the paper's two-runs-shorter
    variant (omits the file.buffer stage);
  * ``sensitivity`` — the Table-2 OFAT matrix
    (:class:`~repro_torch.core.sensitivity.SensitivityCursor`), so the
    campaign schedules sensitivity cells concurrently;
  * ``random`` — a budget-matched random-search baseline
    (:class:`RandomCursor`): same ≤10-trial budget as the tree, purely
    random candidates, seeded per cell for determinism;
  * ``model`` — the learned cost-model proposer
    (:class:`~repro_torch.core.proposer.ModelCursor`): a ridge fit on the
    trial history proposes the top-k predicted configs per batch and
    refits online; thin histories fall back bit-identically to the
    ``tree`` walk (1808.06008, 2503.03826).

Adding a strategy = one cursor class + one ``register_strategy`` call.

This is the PyTorch port's own copy of the reference's
``core/strategy.py``: its output is byte-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    Sequence, runtime_checkable)

import numpy as np

from repro_torch.core.executor import SweepExecutor, run_trials
from repro_torch.core.params import DOMAINS, TunableConfig
from repro_torch.core.proposer import (MIN_RECORDS, POOL_SIZE, RIDGE_LAMBDA,
                                 TOP_K, ModelCursor)
from repro_torch.core.sensitivity import (KnobImpact, SensitivityCursor,
                                    SensitivityReport)
from repro_torch.core.tree import (MAX_TRIALS, Candidate, TreeCursor,
                             TuningReport, absorb_baseline,
                             apply_accept_rule, short_tree)
from repro_torch.core.trial import TrialResult, TrialRunner


# ------------------------------------------------------------- protocol
@runtime_checkable
class SearchCursor(Protocol):
    """The propose → absorb → done → report shape every strategy obeys.

    Invariants the campaign engine relies on:

      * calls alternate — every proposed batch is absorbed before the
        next ``propose()``; ``propose()`` returns ``[]`` iff the walk
        is complete;
      * a batch's candidates are mutually independent (safe to evaluate
        concurrently);
      * the cursor keeps no hidden result state — replaying recorded
        results through propose/absorb reconstructs the walk
        bit-identically (this is how checkpoint resume works);
      * ``strategy_version`` (class attribute) gates checkpoint
        compatibility, and ``signature_parts()`` returns a
        JSON-serializable description of everything that shapes the
        walk's decisions — including any warm-start seeds;
      * ``warm_start(configs)`` (called before the first proposal, if
        at all) offers the cursor full candidate configurations
        retrieved from the trial history (core/history.py) — the best
        configs of the nearest already-tuned cells.  A strategy is free
        to ignore them (the default no-op); one that uses them must
        fold them into ``signature_parts()`` so checkpoints stay
        replay-exact;
      * ``expected_gain()`` is a *live* estimate of the improvement
        still ahead of the walk (higher = more expected gain; ``None``
        = unknown, which the online scheduler treats as explore-first).
        It feeds the campaign's cell prioritizer (core/schedule.py)
        when in-flight cells are re-ranked between batches; it must
        never influence the cursor's own decisions, so reporting any
        estimate keeps walks bit-identical.
    """

    runner: TrialRunner
    strategy_version: int

    @property
    def done(self) -> bool: ...

    def propose(self) -> List[Candidate]: ...

    def absorb(self, results: Sequence[TrialResult],
               indices: Sequence[int]) -> None: ...

    def report(self) -> Any: ...

    def expected_gain(self) -> Optional[float]: ...

    def signature_parts(self) -> list: ...

    def warm_start(self, configs: Sequence[TunableConfig]) -> None: ...


# ------------------------------------------------------ random baseline
class RandomCursor:
    """Budget-matched random search — the control arm for the tree.

    Evaluates the baseline, then ``budget - 1`` uniformly random
    configurations over the tunable domains in one batch (random search
    is non-adaptive, so the whole budget exposes maximal parallelism).
    The accept rule mirrors the tree's: the cheapest viable candidate
    wins iff it clears the relative-improvement threshold.  Sampling is
    seeded per (seed, workload) so a cell's walk is deterministic and
    checkpoint-resumable.
    """

    strategy_version = 1

    def __init__(self, runner: TrialRunner, baseline: TunableConfig,
                 threshold: float = 0.05, budget: int = MAX_TRIALS,
                 seed: int = 0):
        if budget < 1:
            raise ValueError("random strategy needs budget >= 1")
        self.runner = runner
        self.baseline = baseline
        self.threshold = threshold
        self.budget = budget
        self.seed = seed
        self.incumbent = baseline
        self.baseline_cost = float("nan")
        self.best_cost = float("nan")
        self.accepted: List[str] = []
        self._phase = 0                  # 0: baseline, 1: sweep, 2: done
        self._pending: Optional[List[Candidate]] = None

    def _rng(self) -> np.random.RandomState:
        blob = f"{self.seed}:{self.runner.workload.key()}".encode()
        return np.random.RandomState(
            int.from_bytes(hashlib.sha1(blob).digest()[:4], "big"))

    def _sample(self, n: int) -> List[Candidate]:
        rng = self._rng()
        out = []
        base = self.baseline.as_dict()
        for i in range(n):
            draw = {k: dom[rng.randint(len(dom))]
                    for k, dom in DOMAINS.items()}
            delta = {k: v for k, v in draw.items() if base[k] != v}
            out.append(Candidate(self.baseline.replace(**draw),
                                 f"random:{i + 1}", delta))
        return out

    @property
    def done(self) -> bool:
        return self._phase >= 2

    def propose(self) -> List[Candidate]:
        if self._pending is not None:
            raise RuntimeError("previous batch not absorbed yet")
        if self._phase == 0:
            self._pending = [Candidate(self.baseline, "baseline", {})]
        elif self._phase == 1:
            n = self.budget - self.runner.n_trials
            if n <= 0:
                self._phase = 2
                return []
            self._pending = self._sample(n)
        else:
            return []
        return list(self._pending)

    def absorb(self, results: Sequence[TrialResult],
               indices: Sequence[int]) -> None:
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
            self._phase = 1
            return
        won = apply_accept_rule(self.runner,
                                list(zip(cands, results, indices)),
                                self.best_cost, self.threshold)
        if won is not None:
            cand, cost = won
            self.incumbent = cand.config
            self.best_cost = cost
            self.accepted.append(f"random: {cand.delta}")
        self._phase = 2

    def report(self) -> TuningReport:
        return TuningReport(
            workload=self.runner.workload.key(),
            baseline_cost=self.baseline_cost,
            final_cost=self.best_cost,
            final_config=self.incumbent.as_dict(),
            n_trials=self.runner.n_trials,
            accepted=self.accepted,
            log=[dataclasses.asdict(e) for e in self.runner.log],
        )

    def expected_gain(self) -> Optional[float]:
        """Unknown before the baseline; the whole (non-adaptive) budget
        while the sweep batch is pending; zero once absorbed."""
        if self._phase >= 2:
            return 0.0
        if self._phase == 0:
            return None
        return 1.0

    def signature_parts(self) -> list:
        return ["random", self.seed, self.budget]

    def warm_start(self, configs: Sequence[TunableConfig]) -> None:
        """No-op: random search is the budget-matched *control* arm —
        seeding it with history would make it adaptive."""


# ------------------------------------------------------------- registry
@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """One registered strategy: a versioned cursor factory plus the
    report (de)serializer the campaign's checkpoints need."""
    name: str
    version: int
    factory: Callable[..., "SearchCursor"]   # (runner, baseline,
    #                                          threshold, options) -> cursor
    load_report: Callable[[Dict], Any]       # checkpointed dict -> report
    description: str = ""
    #: whether the measured tier (core/measure.py) can re-rank this
    #: strategy's reports — requires a TuningReport-shaped report (a
    #: trial log of candidate configs plus a ``measured`` slot).  The
    #: sensitivity matrix reports knob impacts, not candidates, so the
    #: campaign's ``measure_top_k`` pass skips it.
    measurable: bool = True


STRATEGIES: Dict[str, StrategySpec] = {}
_ALIASES = {"short-tree": "short"}


def register_strategy(spec: StrategySpec) -> StrategySpec:
    if spec.name in STRATEGIES:
        raise ValueError(f"strategy {spec.name!r} already registered")
    STRATEGIES[spec.name] = spec
    return spec


def get_strategy(name: str) -> StrategySpec:
    key = _ALIASES.get(name, name)
    if key not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r} "
                       f"(registered: {', '.join(list_strategies())})")
    return STRATEGIES[key]


def list_strategies() -> List[str]:
    return sorted(STRATEGIES)


def make_cursor(name: str, runner: TrialRunner, baseline: TunableConfig,
                *, threshold: float = 0.05,
                options: Optional[Dict[str, Any]] = None) -> SearchCursor:
    """Instantiate a registered strategy's cursor for one cell."""
    return get_strategy(name).factory(runner, baseline, threshold,
                                      dict(options or {}))


def drive(cursor: SearchCursor,
          executor: Optional[SweepExecutor] = None) -> Any:
    """Blocking driver: propose/evaluate/absorb until done, return the
    report.  ``run_tuning`` and ``run_sensitivity`` are this loop
    specialized to their cursor."""
    runner = cursor.runner
    while True:
        batch = cursor.propose()
        if not batch:
            break
        pairs = run_trials(runner, [c.as_trial() for c in batch], executor)
        cursor.absorb([r for _, r in pairs], [i for i, _ in pairs])
    return cursor.report()


# -------------------------------------------------------- registrations
def _load_tuning_report(d: Dict) -> TuningReport:
    return TuningReport(**d)


def _load_sensitivity_report(d: Dict) -> SensitivityReport:
    return SensitivityReport(
        workload=d["workload"], baseline_cost=d["baseline_cost"],
        impacts=[KnobImpact(**i) for i in d["impacts"]],
        n_trials=d["n_trials"])


def _tree_factory(runner, baseline, threshold, options):
    return TreeCursor(runner, baseline, threshold=threshold,
                      stages=options.get("stages"))


def _short_factory(runner, baseline, threshold, options):
    stages = options.get("stages")
    if stages is None:
        stages = short_tree(runner.workload.shp.kind)
    return TreeCursor(runner, baseline, threshold=threshold, stages=stages)


def _sensitivity_factory(runner, baseline, threshold, options):
    return SensitivityCursor(runner, baseline, knobs=options.get("knobs"))


def _random_factory(runner, baseline, threshold, options):
    return RandomCursor(runner, baseline, threshold=threshold,
                        budget=options.get("budget", MAX_TRIALS),
                        seed=options.get("seed", 0))


def _model_factory(runner, baseline, threshold, options):
    return ModelCursor(
        runner, baseline, threshold=threshold,
        budget=options.get("budget", MAX_TRIALS),
        seed=options.get("seed", 0),
        top_k=options.get("top_k", TOP_K),
        min_records=options.get("min_records", MIN_RECORDS),
        pool_size=options.get("pool_size", POOL_SIZE),
        ridge_lambda=options.get("ridge_lambda", RIDGE_LAMBDA),
        stages=options.get("stages"),
        history=options.get("history"))


register_strategy(StrategySpec(
    "tree", TreeCursor.strategy_version, _tree_factory,
    _load_tuning_report,
    "the paper's Fig.-4 ≤10-trial tuning tree"))
register_strategy(StrategySpec(
    "short", TreeCursor.strategy_version, _short_factory,
    _load_tuning_report,
    "the paper's two-runs-shorter tree (omits file.buffer)"))
register_strategy(StrategySpec(
    "sensitivity", SensitivityCursor.strategy_version,
    _sensitivity_factory, _load_sensitivity_report,
    "the Sec.-4 OFAT sensitivity matrix (Table 2)",
    measurable=False))
register_strategy(StrategySpec(
    "random", RandomCursor.strategy_version, _random_factory,
    _load_tuning_report,
    "budget-matched random-search baseline"))


register_strategy(StrategySpec(
    "model", ModelCursor.strategy_version, _model_factory,
    _load_tuning_report,
    "history-fit ridge cost model proposing top-k predicted configs; "
    "falls back to the tree walk on thin history"))
