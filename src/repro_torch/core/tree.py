"""The paper's Fig. 4 — the trial-and-error tuning tree.

A tree stage tests one (or two *alternative*, correlated-pair) parameter
changes against the incumbent configuration.  A change is accepted iff it
improves the observed cost by more than ``threshold`` (relative, the
paper's 5-10%); accepted values propagate to every later stage.  At most
10 trial configurations are evaluated per application — against the
exhaustive grid of |domains| combinations (core/params.exhaustive_size()).

Stage map (Spark parameter -> TPU knob, DESIGN.md §2.1):
  1. serializer          -> compute_dtype=bf16
  2. shuffle.manager     -> shard_strategy alternatives, each with its
     documented companion (tungsten+lzf -> tp+f16 codec;
     hash+consolidateFiles -> fsdp+fused grad collectives)
  3. shuffle.compress    -> grad_comm_dtype=bf16          (train only)
  4. memoryFraction pair -> remat_policy dots / full alternatives
  5. spill.compress      -> remat_save_dtype=bf16
  6. reducer.maxSizeInFlight -> microbatches 2 / 4        (train only)
  7. rdd.compress        -> kv_cache_dtype=int8           (serving only)
  8. file.buffer         -> attn tile 256 (pallas path)

This is the PyTorch port's own copy of the reference's
``core/tree.py``: its output is byte-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.executor import SweepExecutor
from repro_torch.core.params import TunableConfig
from repro_torch.core.space import SPACE
from repro_torch.core.trial import TrialRunner, TrialResult, Workload


@dataclasses.dataclass
class Stage:
    name: str
    spark_name: str
    alternatives: Sequence[Dict[str, Any]]   # each alt: knob deltas
    kinds: Sequence[str] = ("train", "prefill", "decode")


def _stage(name: str, knob: str, alternatives: Sequence[Dict[str, Any]],
           kinds: Sequence[str] = ("train", "prefill", "decode")) -> Stage:
    """Build a stage whose spark_name comes from the knob registry and
    whose alternative deltas are validated against it — a stage can no
    longer reference a knob or value the space doesn't declare."""
    for alt in alternatives:
        SPACE.validate_delta(alt)
    return Stage(name, SPACE[knob].spark, alternatives, kinds)


def default_tree(kind: str = "train") -> List[Stage]:
    stages = [
        _stage("serializer", "compute_dtype",
               [dict(compute_dtype="bfloat16")]),
        _stage("shuffle.manager", "shard_strategy",
               [dict(shard_strategy="tp", comm_codec="float16"),
                dict(shard_strategy="fsdp", fuse_grad_collectives=True)]),
        _stage("shuffle.compress", "grad_comm_dtype",
               [dict(grad_comm_dtype="bfloat16")], kinds=("train",)),
        _stage("memoryFraction", "remat_policy",
               [dict(remat_policy="none"), dict(remat_policy="full")],
               kinds=("train",)),
        _stage("spill.compress", "remat_save_dtype",
               [dict(remat_save_dtype="bfloat16")], kinds=("train",)),
        _stage("maxSizeInFlight", "microbatches",
               [dict(microbatches=2)], kinds=("train",)),
        _stage("rdd.compress", "kv_cache_dtype",
               [dict(kv_cache_dtype="int8")], kinds=("prefill", "decode")),
        _stage("file.buffer", "attn_block_q",
               [dict(attn_block_q=256, attn_block_kv=256)]),
    ]
    return [s for s in stages if kind in s.kinds]


def short_tree(kind: str = "train") -> List[Stage]:
    """The paper's shorter variant: "a shorter version of our methodology
    with two required runs less, would omit it [file.buffer]"."""
    return [s for s in default_tree(kind) if s.name != "file.buffer"]


MAX_TRIALS = 10


@dataclasses.dataclass
class TuningReport:
    workload: str
    baseline_cost: float
    final_cost: float
    final_config: Dict[str, Any]
    n_trials: int
    accepted: List[str]
    log: List[Dict]
    #: measured-tier re-rank summary (core/measure.py), attached by the
    #: campaign when ``measure_top_k > 0``; None for model-only walks —
    #: and deliberately excluded from ``tuning_fingerprint``, so
    #: model-tier decisions stay bit-identical with or without it
    measured: Optional[Dict] = None
    #: learned-proposer fit summary + per-trial predicted-vs-actual
    #: rows (core/proposer.py); None for every other strategy *and*
    #: for the model strategy's cold-start fallback (whose report is
    #: the tree's, verbatim).  Excluded from ``tuning_fingerprint``
    #: like ``measured``.
    proposer: Optional[Dict] = None

    @property
    def speedup(self) -> float:
        if self.final_cost <= 0:
            return float("nan")
        return self.baseline_cost / self.final_cost


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One proposed trial: the config to evaluate plus its log labels."""
    config: TunableConfig
    name: str
    delta: Dict[str, Any]

    def as_trial(self) -> tuple:
        """The (config, name, delta) triple core/executor.run_trials takes."""
        return (self.config, self.name, self.delta)


def absorb_baseline(runner: TrialRunner, result: TrialResult,
                    index: int) -> float:
    """Record the baseline trial's outcome (shared by every
    TuningReport-shaped strategy): the log entry is marked accepted and
    the returned incumbent cost is inf for a crashed baseline, so any
    later viable candidate clears the relative threshold."""
    entry = runner.log[index]
    entry.accepted = True
    entry.note = "baseline (defaults after cluster-level config)"
    return result.cost_s if not result.crashed else float("inf")


def apply_accept_rule(runner: TrialRunner, batch, best_cost: float,
                      threshold: float):
    """The paper's accept/reject rule over one batch of alternatives
    (``batch``: (candidate, result, log index) triples).  Crashes are
    annotated (the paper's 0.1/0.7 sort-by-key outcome), the cheapest
    viable candidate wins iff it beats ``best_cost`` by more than
    ``threshold`` (any finite cost beats a crashed incumbent), and
    every other entry is rejected.  Returns the accepted
    (candidate, cost) or None.  Shared by the tree and random
    strategies so the rule can never silently diverge between them."""
    for _, res, idx in batch:
        if res.crashed:
            runner.log[idx].note = "crashed (exceeds per-chip HBM)"
            runner.log[idx].accepted = False
    viable = [(c, r, i) for c, r, i in batch if not r.crashed]
    accepted = None
    if viable:
        cand, res, idx = min(viable, key=lambda t: t[1].cost_s)
        improves = (best_cost == float("inf")
                    or res.cost_s < best_cost * (1.0 - threshold))
        runner.log[idx].accepted = bool(improves)
        if improves:
            accepted = (cand, res.cost_s)
        # non-winning alternatives are rejected
        for _, _, i in batch:
            if runner.log[i].accepted is None:
                runner.log[i].accepted = False
    return accepted


class TreeCursor:
    """Resumable state machine over the Fig.-4 tuning tree.

    The blocking tree walk is split into two halves so a scheduler can
    interleave many walks over one trial executor (core/campaign.py):

      * :meth:`propose` returns the next batch of trial candidates —
        first the baseline, then each stage's runnable alternatives —
        or ``[]`` once the walk is complete;
      * :meth:`absorb` takes the batch's results plus the log indices
        the runner recorded them at, applies the paper's accept/reject
        rule, annotates the log *by index* (no config-equality rescans)
        and advances to the next stage.

    Calls must alternate (every propose'd batch absorbed before the
    next propose).  The trial log, ≤10-run budget accounting and
    accept/reject decisions are identical to the historical blocking
    loop; ``run_tuning`` below is now a thin driver over this cursor.
    The cursor holds no results of its own beyond the incumbent/cost
    scalars, so a walk can be reconstructed (checkpoint resume) by
    replaying recorded trial results through propose/absorb.

    :meth:`warm_start` (the ``SearchCursor`` warm-start hook) seeds the
    walk with full candidate configurations — the best configs of the
    nearest already-tuned cells, retrieved from the trial history
    (core/history.py).  They are evaluated as one batch right after the
    baseline under the same accept rule as a tree stage; an adopted
    warm-start config moves the incumbent, so later stages whose
    alternative is already satisfied are skipped (that is where the
    trials-to-convergence saving comes from).  Warm-start trials count
    against the ≤10-run budget, and the seeded configs enter
    :meth:`signature_parts` so checkpointed walks replay bit-identically
    (a cold walk's signature is byte-identical to the pre-warm-start
    layout).

    This propose/absorb/done/report shape is the
    :class:`~repro_torch.core.strategy.SearchCursor` protocol — the campaign
    engine drives any registered strategy through it (the ``tree`` and
    ``short`` strategies are this class).
    """

    strategy_version = 1

    def __init__(self, runner: TrialRunner, baseline: TunableConfig,
                 threshold: float = 0.05,
                 stages: Optional[List[Stage]] = None):
        self.runner = runner
        self.baseline = baseline
        self.threshold = threshold
        kind = runner.workload.shp.kind
        self.stages = stages if stages is not None else default_tree(kind)
        self.incumbent = baseline
        self.baseline_cost = float("nan")
        self.best_cost = float("nan")
        self.accepted: List[str] = []
        self._stage_i = -1          # -1: baseline not yet evaluated
        self._pending: Optional[List[Candidate]] = None
        self._done = False
        self._warmstart: List[TunableConfig] = []
        self._warmstart_absorbed = False
        self._in_warmstart = False

    @property
    def done(self) -> bool:
        return self._done

    def warm_start(self, configs: Sequence[TunableConfig]) -> None:
        """Seed the walk with candidate configs evaluated right after
        the baseline (see class docstring).  Must be called before the
        first proposal; calling again before then replaces the seeds
        (the campaign retries with a re-queried list when a
        checkpoint's stored list turns out stale)."""
        if self._stage_i >= 0 or self._pending is not None:
            raise RuntimeError("warm_start must precede the first "
                               "proposal")
        seen, out = set(), []
        base = json.dumps(self.baseline.as_dict(), sort_keys=True,
                          default=str)
        for cfg in configs:
            fp = json.dumps(cfg.as_dict(), sort_keys=True, default=str)
            if fp == base or fp in seen:
                continue                 # no-op / duplicate seed
            seen.add(fp)
            out.append(cfg)
        self._warmstart = out

    def _warmstart_batch(self) -> List[Candidate]:
        base = self.baseline.as_dict()
        cands = [Candidate(cfg, "warmstart",
                           {k: v for k, v in cfg.as_dict().items()
                            if base[k] != v})
                 for cfg in self._warmstart]
        return cands[:max(0, MAX_TRIALS - self.runner.n_trials)]

    def propose(self) -> List[Candidate]:
        """Next batch of candidates to evaluate; [] when the walk is done."""
        if self._pending is not None:
            raise RuntimeError("previous batch not absorbed yet")
        if self._done:
            return []
        if self._stage_i < 0:
            self._pending = [Candidate(self.baseline, "baseline", {})]
            return list(self._pending)
        if self._warmstart and not self._warmstart_absorbed:
            batch = self._warmstart_batch()
            if batch:
                self._in_warmstart = True
                self._pending = batch
                return list(self._pending)
            self._warmstart_absorbed = True      # budget already spent
        while True:
            if (self._stage_i >= len(self.stages)
                    or self.runner.n_trials >= MAX_TRIALS):
                self._done = True
                return []
            stage = self.stages[self._stage_i]
            # skip alternatives that are no-ops on the incumbent; the run
            # budget admits only as many candidates as trials remain
            runnable = [alt for alt in stage.alternatives
                        if not all(getattr(self.incumbent, k) == v
                                   for k, v in alt.items())]
            runnable = runnable[:MAX_TRIALS - self.runner.n_trials]
            if not runnable:
                self._stage_i += 1
                continue
            self._pending = [Candidate(self.incumbent.replace(**alt),
                                       stage.name, alt)
                             for alt in runnable]
            return list(self._pending)

    def absorb(self, results: Sequence[TrialResult],
               indices: Sequence[int]) -> None:
        """Apply one batch's outcomes (results aligned with the proposed
        candidates; ``indices`` = their positions in ``runner.log``)."""
        if self._pending is None:
            raise RuntimeError("no batch proposed")
        if len(results) != len(self._pending) \
                or len(indices) != len(self._pending):
            raise ValueError("results/indices do not match proposed batch")
        cands, self._pending = self._pending, None
        if self._stage_i < 0:
            self.best_cost = absorb_baseline(self.runner, results[0],
                                             indices[0])
            self.baseline_cost = self.best_cost
            self._stage_i = 0
            return
        if self._in_warmstart:
            self._in_warmstart = False
            self._warmstart_absorbed = True
            won = apply_accept_rule(self.runner,
                                    list(zip(cands, results, indices)),
                                    self.best_cost, self.threshold)
            if won is not None:
                cand, cost = won
                self.incumbent = cand.config
                self.best_cost = cost
                self.accepted.append(f"warmstart: {cand.delta}")
            return
        stage = self.stages[self._stage_i]
        won = apply_accept_rule(self.runner,
                                list(zip(cands, results, indices)),
                                self.best_cost, self.threshold)
        if won is not None:
            cand, cost = won
            self.incumbent = cand.config
            self.best_cost = cost
            self.accepted.append(f"{stage.name}: {cand.delta}")
        self._stage_i += 1

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
        """Live estimate for the online scheduler (core/schedule.py):
        the share of the tree still ahead of the walk — each remaining
        stage is one more chance to accept an improvement.  ``None``
        before the baseline is absorbed (nothing observed yet:
        explore-first), ``0.0`` once the walk is done."""
        if self._done:
            return 0.0
        if self._stage_i < 0:
            return None
        total = max(1, len(self.stages))
        return max(0.0, (total - self._stage_i) / total)

    def signature_parts(self) -> list:
        """JSON-serializable description of everything that shapes this
        walk's decisions — part of the campaign checkpoint signature.
        The layout is byte-compatible with the version-1 checkpoint
        signature blob, so pre-Strategy-API tree checkpoints resume; a
        warm-started walk appends its seed configs (so cold checkpoints
        are never replayed into a differently-seeded walk)."""
        parts = [[s.name, s.spark_name, list(s.alternatives),
                  list(s.kinds)] for s in self.stages]
        if self._warmstart:
            parts.append(["warmstart",
                          [cfg.as_dict() for cfg in self._warmstart]])
        return parts


def run_tuning(runner: TrialRunner, baseline: TunableConfig,
               threshold: float = 0.05,
               stages: Optional[List[Stage]] = None,
               executor: Optional[SweepExecutor] = None) -> TuningReport:
    """Walk the tree: evaluate alternatives, keep what clears the threshold.

    A stage's alternatives are independent of each other (all derived
    from the same incumbent), so with an ``executor`` they evaluate
    concurrently; the trial log, run budget and accept/reject decisions
    are identical to the sequential walk.  This is a thin blocking
    driver over :class:`TreeCursor`."""
    from repro_torch.core.strategy import drive       # import cycle: call-time
    return drive(TreeCursor(runner, baseline, threshold=threshold,
                            stages=stages), executor)
