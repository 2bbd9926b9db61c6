"""Sec.-4 sensitivity analysis: one-factor-at-a-time sweeps + Table 2.

For each of the 12 knobs, every non-default value is evaluated against
the workload's baseline (values chosen by the paper's rules: binary ->
non-default, categorical -> all values, numeric -> neighbours).  The
impact statistic is the paper's: mean |% deviation| from the baseline
runtime, regardless of sign.  Crashes are recorded (sort-by-key 0.1/0.7
analogue) and excluded from the mean, as in the paper.

Since the Strategy API, the sweep is a :class:`SensitivityCursor` —
the same propose/absorb/done/report protocol the tuning tree uses
(core/strategy.SearchCursor) — so a :class:`~repro_torch.core.campaign
.Campaign` can schedule whole Table-2 matrices concurrently over the
shared executor/compile cache, with checkpoint/resume for free.
``run_sensitivity`` remains as a thin blocking driver over the cursor.

This is the PyTorch port's own copy of the reference's
``core/sensitivity.py``: its output is byte-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.executor import SweepExecutor
from repro_torch.core.params import (PARAM_DOCS, SENSITIVITY_SWEEP, TunableConfig)
from repro_torch.core.tree import Candidate
from repro_torch.core.trial import TrialResult, TrialRunner, Workload


@dataclasses.dataclass
class KnobImpact:
    knob: str
    spark_name: str
    values: List[Any]
    deviations_pct: List[float]        # one per tested value (nan = crash)
    crashes: int

    @property
    def mean_abs_pct(self) -> float:
        vals = [abs(d) for d in self.deviations_pct if d == d]
        return sum(vals) / len(vals) if vals else 0.0


@dataclasses.dataclass
class SensitivityReport:
    workload: str
    baseline_cost: float
    impacts: List[KnobImpact]
    n_trials: int

    def table(self) -> List[Dict]:
        return [{"knob": i.knob, "spark": i.spark_name,
                 "mean_abs_pct": round(i.mean_abs_pct, 1),
                 "crashes": i.crashes} for i in self.impacts]


class SensitivityCursor:
    """The Table-2 OFAT matrix as a :class:`SearchCursor` strategy.

    Two batches: the baseline, then every (knob, non-default value)
    candidate at once — the candidates are mutually independent, so one
    proposal exposes maximal parallelism to the campaign's shared
    executor.  The trial log, run count and KnobImpact table are
    identical to the historical blocking ``run_sensitivity`` loop.
    """

    strategy_version = 1

    def __init__(self, runner: TrialRunner, baseline: TunableConfig,
                 knobs: Optional[Dict[str, tuple]] = None):
        self.runner = runner
        self.baseline = baseline
        self.knobs = dict(knobs) if knobs is not None \
            else dict(SENSITIVITY_SWEEP)
        self.baseline_cost = float("nan")
        self.impacts: List[KnobImpact] = []
        self._spans: List[tuple] = []    # (knob, tested values)
        self._phase = 0                  # 0: baseline, 1: sweep, 2: done
        self._pending: Optional[List[Candidate]] = None

    @property
    def done(self) -> bool:
        return self._phase >= 2

    def propose(self) -> List[Candidate]:
        if self._pending is not None:
            raise RuntimeError("previous batch not absorbed yet")
        if self._phase == 0:
            self._pending = [Candidate(self.baseline, "baseline", {})]
        elif self._phase == 1:
            cands = []
            self._spans = []
            for knob, values in self.knobs.items():
                default = getattr(self.baseline, knob)
                tested = [v for v in values if v != default]
                self._spans.append((knob, tested))
                cands.extend(
                    Candidate(self.baseline.replace(**{knob: v}),
                              f"ofat:{knob}", {knob: v})
                    for v in tested)
            self._pending = cands
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
        self._pending = None
        if self._phase == 0:
            self.baseline_cost = results[0].cost_s
            self._phase = 1
            return
        it = iter(zip(results, indices))
        base_cost = self.baseline_cost
        for knob, tested in self._spans:
            devs, crashes = [], 0
            for _ in tested:
                res, idx = next(it)
                if res.crashed:
                    crashes += 1
                    devs.append(float("nan"))
                    self.runner.log[idx].note = "crashed"
                else:
                    devs.append(100.0 * (res.cost_s - base_cost)
                                / base_cost)
            self.impacts.append(KnobImpact(knob, PARAM_DOCS.get(knob, ""),
                                           tested, devs, crashes))
        self._phase = 2

    def report(self) -> SensitivityReport:
        return SensitivityReport(self.runner.workload.key(),
                                 self.baseline_cost, self.impacts,
                                 self.runner.n_trials)

    def expected_gain(self) -> Optional[float]:
        """The OFAT matrix is a fixed design: the whole sweep is one
        batch, so the gain estimate is all-or-nothing — unknown before
        the baseline, the full sweep while it is pending, zero after."""
        if self._phase >= 2:
            return 0.0
        if self._phase == 0:
            return None
        return 1.0

    def signature_parts(self) -> list:
        return [[k, list(v)] for k, v in self.knobs.items()]

    def warm_start(self, configs: Sequence[TunableConfig]) -> None:
        """No-op: the OFAT matrix is a fixed design — every (knob,
        value) deviation from the baseline is measured regardless of
        what other cells learned."""


def run_sensitivity(runner: TrialRunner, baseline: TunableConfig,
                    knobs: Optional[Dict[str, tuple]] = None,
                    executor: Optional[SweepExecutor] = None
                    ) -> SensitivityReport:
    """OFAT sweep.  With an ``executor`` the (mutually independent)
    candidate evaluations overlap; the report, trial log and run count
    are identical to the sequential path.  This is a thin blocking
    driver over :class:`SensitivityCursor`."""
    from repro_torch.core.strategy import drive       # import cycle: call-time
    return drive(SensitivityCursor(runner, baseline, knobs=knobs),
                 executor)
