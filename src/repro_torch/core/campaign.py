"""Campaign engine — run any search strategy over many cells at once.

The paper's deliverable is a *methodology* applied across a whole
workload matrix (its Table 2 grid and three case studies), not one tuned
application.  A :class:`Campaign` generalizes ``launch/tune.py`` from
one (arch, shape, mesh) cell per process to the full assignment, and —
since the Strategy API — from one hardcoded procedure to any registered
:class:`~repro_torch.core.strategy.SearchCursor` strategy (``tree``,
``short``, ``sensitivity``, ``random``, …):

  * **cell enumeration** — :func:`enumerate_cells` walks
    ``configs.list_archs() x SHAPES x meshes`` and keeps the applicable
    cells (same ``shape_applicable`` rule ``launch/dryrun.py`` uses);
  * **interleaved cursors** — every cell gets a cursor from the
    strategy registry; the scheduler keeps one proposed batch per cell
    in flight on a single shared
    :class:`~repro_torch.core.executor.SweepExecutor`, so the pool stays busy
    across cells while each cell's walk stays sequential.  Cells are
    kicked off grouped by arch, so same-arch calibration compiles land
    adjacently and hit the shared
    :class:`~repro_torch.core.trial.CompileCache` while it is warm;
  * **checkpoint / resume** — after every absorbed batch the cell's
    trial log is persisted as JSON under ``results/torch/campaign/``; an
    interrupted campaign replays the stored results through the cursor
    (no re-evaluation, bit-identical decisions) and only evaluates the
    remainder.  Checkpoints carry the strategy name + version; a
    stale-strategy checkpoint is discarded with a warning, and
    version-1 tree checkpoints are migrated in place;
  * **reporting** — per-cell reports identical to what the blocking
    per-cell driver (``run_tuning`` / ``run_sensitivity``) produces,
    plus the cross-cell matrix (``report.strategy_markdown``);
  * **history / warm-start** — every evaluated trial is appended to the
    shared ``history.jsonl`` trial store (core/history.py) by default,
    and with ``warm_start=True`` each cell's cursor is seeded with the
    best configs of the nearest already-tuned cells, so campaigns are
    cumulative: each run makes the next one cheaper.

The campaign fabric (core/fabric.py) runs one single-cell campaign per
leased cell, sharing this module's checkpoint, history and compile-cache
formats across worker processes.

Per-cell results are bit-identical to the sequential loop by
construction: the cursor is the same state machine the blocking driver
uses, and batches are recorded in proposal order.

This is the PyTorch port's copy of the reference's ``core/campaign.py``:
checkpoints, signatures and reports are byte-identical to the
reference's.  It differs in two places.  Its checkpoints default to a
directory of its own (``results/torch/campaign/``).  And the default
evaluator times every cell on one device (the card unless the CPU is
asked for).  The fabric's workers (core/fabric.py) run one such
campaign per leased cell.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import time
import warnings
from concurrent.futures import FIRST_COMPLETED, wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import SHAPES, get_config, get_shape, list_archs, \
    shape_applicable
from repro_torch.core import telemetry as _telemetry
from repro_torch.core.executor import SweepExecutor
from repro_torch.core.fsutil import atomic_publish
from repro_torch.core.history import (HISTORY_FILENAME, TrialHistory,
                                config_from_dict)
from repro_torch.core.params import TunableConfig, default_config
from repro_torch.core.strategy import SearchCursor, StrategySpec, get_strategy
from repro_torch.core.tree import Stage, TuningReport
from repro_torch.core.trial import TrialResult, TrialRunner, Workload

CAMPAIGN_DIR = pathlib.Path(__file__).resolve().parents[3] \
    / "results" / "torch" / "campaign"

CHECKPOINT_VERSION = 2


# ---------------------------------------------------------------- cells
@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One (arch, shape, mesh) cell of the assignment matrix."""
    arch: str
    shape: str
    multi_pod: bool = False

    def workload(self) -> Workload:
        return Workload(self.arch, self.shape, self.multi_pod)

    def key(self) -> str:
        return self.workload().key()

    def spec(self) -> str:
        """The ``arch:shape:mesh`` string :func:`parse_cells` accepts
        (the fabric coordinator rebuilds worker command lines from it)."""
        return f"{self.arch}:{self.shape}:" \
            + ("multipod" if self.multi_pod else "pod")


def enumerate_cells(archs: Optional[Sequence[str]] = None,
                    shapes: Optional[Sequence[str]] = None,
                    meshes: Sequence[bool] = (False,)) -> List[CellSpec]:
    """Every applicable cell of the assignment (dryrun's skip rule)."""
    out = []
    for arch in (archs or list_archs()):
        cfg = get_config(arch)
        for shape in (shapes or list(SHAPES)):
            ok, _ = shape_applicable(cfg, get_shape(shape))
            if not ok:
                continue
            for mp in meshes:
                out.append(CellSpec(arch, shape, mp))
    return out


def parse_cells(text: str,
                default_multi_pod: bool = False) -> List[CellSpec]:
    """Parse ``arch:shape[:pod|multipod]`` comma-separated cell specs;
    specs without an explicit mesh suffix use ``default_multi_pod``.
    ``kernel:<name>:<shape>`` specs become
    :class:`~repro_torch.core.kernel_cell.KernelCell` s (kernel tile-sweep
    cells), so every cell entry point — ``--cells``, ``--add-cells``
    intake, fabric worker command lines — accepts them."""
    cells = []
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        if parts[0] == "kernel":
            from repro_torch.core.kernel_cell import parse_kernel_cell
            cells.append(parse_kernel_cell(item))
            continue
        if parts[0] == "serve":
            from repro_torch.serving.evaluator import parse_serve_cell
            cells.append(parse_serve_cell(item))
            continue
        if len(parts) not in (2, 3):
            raise ValueError(f"bad cell spec {item!r} "
                             "(want arch:shape[:pod|multipod])")
        arch, shape = parts[0], parts[1]
        mp = default_multi_pod
        if len(parts) == 3:
            if parts[2] not in ("pod", "multipod"):
                raise ValueError(f"bad mesh {parts[2]!r} in {item!r}")
            mp = parts[2] == "multipod"
        cfg = get_config(arch)            # raises on unknown arch
        shp = get_shape(shape)            # raises on unknown shape
        ok, reason = shape_applicable(cfg, shp)
        if not ok:
            raise ValueError(f"cell {item!r} not applicable: {reason}")
        cells.append(CellSpec(arch, shape, mp))
    if not cells:
        raise ValueError("no cells in spec")
    return cells


def tuning_fingerprint(rep: TuningReport) -> Dict:
    """The deterministic projection of a report used for equality checks
    across runs with different cache states: everything except the
    wall-clock compile accounting fields of each log entry."""
    volatile = ("compile_s", "compiles", "cached", "retries")
    return {
        "workload": rep.workload,
        "baseline_cost": rep.baseline_cost,
        "final_cost": rep.final_cost,
        "final_config": rep.final_config,
        "n_trials": rep.n_trials,
        "accepted": list(rep.accepted),
        "log": [{**e, "result": {k: v for k, v in e["result"].items()
                                 if k not in volatile}}
                for e in rep.log],
    }


def cell_health(log) -> Dict:
    """Failure/retry accounting over a trial log (TrialLogEntry objects
    or their checkpointed dicts).  Empty for a fault-free cell.

    A cell is ``degraded`` when environment faults touched its walk —
    timeouts, worker deaths (incl. quarantine skips) or unrecovered
    transient failures.  Deterministic crashes are *not* degradation:
    a config that legitimately overflows HBM is normal tuning signal.
    Recovered transients leave only a ``retries`` count (the final
    result, and thus every decision, is the fault-free one)."""
    from repro_torch.core.trial import (FAILURE_TIMEOUT, FAILURE_TRANSIENT,
                                  FAILURE_WORKER_DEATH)
    failures: Dict[str, int] = {}
    retries = 0
    quarantined = 0
    for e in log:
        res = e.get("result", {}) if isinstance(e, dict) else e.result
        f = res.get("failure") or ""
        if res.get("crashed") and f:
            failures[f] = failures.get(f, 0) + 1
        retries += int(res.get("retries") or 0)
        if (res.get("error") or "").startswith("quarantined"):
            quarantined += 1
    out: Dict[str, Any] = {}
    if failures:
        out["failures"] = dict(sorted(failures.items()))
    if retries:
        out["retries"] = retries
    if quarantined:
        out["quarantined"] = quarantined
    if quarantined or any(k in failures for k in
                          (FAILURE_TRANSIENT, FAILURE_TIMEOUT,
                           FAILURE_WORKER_DEATH)):
        out["degraded"] = True
    return out


def _default_stages(spec: CellSpec) -> Optional[List[Stage]]:
    """The campaign's default stages factory: kernel cells walk their
    tile-sweep stage (core/kernel_cell.py), serve cells their serving
    tree (serving/evaluator.py); step cells return None so the strategy
    keeps its own default tree — bit-identical to the historical
    ``lambda spec: None``."""
    if str(spec.arch).startswith("kernel-"):
        from repro_torch.core.kernel_cell import kernel_stages
        return kernel_stages(spec)
    if str(spec.arch).startswith("serve-"):
        from repro_torch.serving.evaluator import serve_stages
        return serve_stages(spec)
    return None


# ------------------------------------------------------------- campaign
class _CellRun:
    """One cell's in-progress walk: runner + cursor + replay ledger."""

    def __init__(self, spec: CellSpec, runner: TrialRunner,
                 cursor: SearchCursor, signature: str):
        self.spec = spec
        self.runner = runner
        self.cursor = cursor
        self.signature = signature
        self.replay: List[Dict] = []     # checkpointed log entries
        self.replayed = 0                # trials served from checkpoint
        self.report: Optional[Any] = None
        self.warmstart: List[Dict] = []  # seed configs offered the cursor
        self.primer: Optional[Dict] = None   # learned-proposer fit state


class Campaign:
    """Run one strategy over a batch of cells concurrently on a shared
    executor.

    ``strategy`` names a registered search strategy (core/strategy.py);
    ``strategy_options`` are passed to its cursor factory (e.g.
    ``{"knobs": ...}`` for sensitivity, ``{"budget": ..., "seed": ...}``
    for random).  ``evaluator`` defaults to a fresh
    :class:`~repro_torch.core.kernel_cell.DispatchEvaluator` on the card
    (kernel and serve cells; it refuses step cells); pass a synthetic
    evaluator for tests.  With
    ``checkpoint_dir=None`` nothing is persisted.

    **Trial history / warm-start** — with the default ``history=None``
    every evaluated trial is appended to ``history.jsonl`` next to the
    checkpoints (campaigns are cumulative by default; pass
    ``history=False`` to opt out, or a :class:`~repro_torch.core.history
    .TrialHistory` to use a specific store).  With ``warm_start=True``
    each cell's cursor is additionally seeded (via the
    ``SearchCursor.warm_start`` hook) with the best configs of the
    ``warm_start_cells`` nearest already-tuned cells in the history.
    The seeds a cell actually used are persisted in its checkpoint and
    replayed on resume, so an interrupted warm-started campaign is
    immune to the history growing underneath it.

    **Online scheduling** (core/schedule.py) — ``prioritize`` names the
    cell prioritizer (``"arch"``: the historical first-seen-arch order;
    ``"history"``: expected speedup from the trial history, unknown
    cells explore-first; or a custom :class:`~repro_torch.core.schedule
    .CellPrioritizer` instance).  ``intake=True`` re-scans
    ``<checkpoint_dir>/intake/`` between batches so cells submitted
    while the campaign runs (``launch/tune.py --add-cells``) are
    admitted live.  ``max_active_cells`` bounds concurrent cells
    (None: all).  None of the three changes a cold cell's decisions —
    only scheduling order.  The one interaction: ``warm_start`` seeds
    are resolved when a cell is *handed out*, so in a bounded or
    intake campaign a late cell may be seeded by trials this same run
    appended — deliberate (the cumulative-history contract),
    deterministic given the history at activation, and replay-exact on
    resume because the checkpoint stores the seeds actually used.

    **Measured tier** (core/measure.py) — with ``measure_top_k=k > 0``
    each cell's finished walk is followed by a re-rank pass: its top-k
    surviving configs (by model cost) are re-evaluated with
    median-of-N *real* jitted timings on a dedicated single-worker
    executor (same deadline/retry/quarantine hardening), and the
    measured winner is published into the report's ``measured``
    section, the checkpoint and the trial history
    (``<strategy>+measured``).  The default ``0`` is a true no-op: no
    measured evaluator is ever constructed and the walk's
    logs/budgets/decisions are bit-identical to a model-only campaign
    — the pass only *re-ranks after* the walk, it never feeds back
    into it.  ``measured_evaluator`` overrides the measured tier's
    default (kernel bench / serve replay behind the disk timing
    cache).
    """

    def __init__(self, cells: Sequence[CellSpec], *,
                 strategy: str = "tree",
                 strategy_options: Optional[Dict[str, Any]] = None,
                 threshold: float = 0.05,
                 evaluator: Optional[Callable] = None,
                 baseline_factory: Optional[
                     Callable[[CellSpec], TunableConfig]] = None,
                 stages_factory: Optional[
                     Callable[[CellSpec], Optional[List[Stage]]]] = None,
                 checkpoint_dir: Optional[pathlib.Path] = CAMPAIGN_DIR,
                 executor: Optional[SweepExecutor] = None,
                 max_workers: Optional[int] = None,
                 history: Any = None,
                 warm_start: bool = False,
                 warm_start_cells: int = 2,
                 warm_start_per_cell: int = 1,
                 prioritize: Any = "arch",
                 intake: bool = False,
                 max_active_cells: Optional[int] = None,
                 trial_timeout_s: Optional[float] = None,
                 max_retries: int = 0,
                 quarantine: Any = None,
                 strike_threshold: Optional[int] = None,
                 measure_top_k: int = 0,
                 measured_evaluator: Optional[Callable] = None,
                 telemetry: Any = None):
        if not cells and not intake:
            raise ValueError("campaign needs at least one cell "
                             "(or intake admission)")
        if len(set(c.key() for c in cells)) != len(cells):
            raise ValueError("duplicate cells in campaign")
        self.cells = list(cells)
        self.strategy: StrategySpec = get_strategy(strategy)
        self.strategy_options = dict(strategy_options or {})
        self.threshold = threshold
        if executor is not None and evaluator is not None \
                and executor.evaluator is not evaluator:
            raise ValueError("executor wraps a different evaluator")
        if executor is not None:
            evaluator = executor.evaluator
        elif evaluator is None:
            # kernel cells time their kernel, serve cells replay their
            # trace, step cells time full-width steps
            from repro_torch.core.kernel_cell import DispatchEvaluator
            evaluator = DispatchEvaluator()
        self.evaluator = evaluator
        self.executor = executor
        self.max_workers = max_workers
        self.baseline_factory = baseline_factory or (
            lambda spec: default_config(shard_strategy="fsdp_tp",
                                        attn_impl="pallas"))
        self.stages_factory = stages_factory or _default_stages
        self.checkpoint_dir = pathlib.Path(checkpoint_dir) \
            if checkpoint_dir else None
        if history is None:              # default: cumulative campaigns
            self.history = TrialHistory(
                self.checkpoint_dir / HISTORY_FILENAME) \
                if self.checkpoint_dir else None
        elif history is False:
            self.history = None
        else:
            self.history = history
        self.warm_start = bool(warm_start)
        self.warm_start_cells = warm_start_cells
        self.warm_start_per_cell = warm_start_per_cell
        if self.warm_start and self.history is None:
            raise ValueError("warm_start needs a trial history "
                             "(checkpoint_dir or history=)")
        self.prioritize = prioritize
        if prioritize == "history" and self.history is None:
            raise ValueError("prioritize='history' needs a trial "
                             "history (checkpoint_dir or history=)")
        self.intake = bool(intake)
        if self.intake and self.checkpoint_dir is None:
            raise ValueError("intake admission needs a checkpoint_dir")
        if max_active_cells is not None and max_active_cells < 1:
            raise ValueError("max_active_cells must be >= 1")
        self.max_active_cells = max_active_cells
        # ------------------------------------------- trial hardening
        hardened = (trial_timeout_s is not None or max_retries
                    or quarantine not in (None, False)
                    or strike_threshold is not None)
        if executor is not None and hardened:
            raise ValueError("trial hardening (timeout/retries/"
                             "quarantine) configures the campaign's own "
                             "executor — configure the external "
                             "SweepExecutor directly instead")
        self.trial_timeout_s = trial_timeout_s
        self.max_retries = int(max_retries)
        if quarantine is False or (quarantine is None
                                   and self.checkpoint_dir is None):
            self.quarantine = None       # opted out / nowhere to persist
        elif quarantine is None:
            from repro_torch.core.quarantine import Quarantine
            self.quarantine = Quarantine(
                self.checkpoint_dir,
                **({"strike_threshold": strike_threshold}
                   if strike_threshold is not None else {}))
        else:
            self.quarantine = quarantine
            if strike_threshold is not None:
                self.quarantine.strike_threshold = strike_threshold
        # --------------------------------------------- measured tier
        self.measure_top_k = int(measure_top_k)
        if self.measure_top_k < 0:
            raise ValueError("measure_top_k must be >= 0")
        self.measured_evaluator = measured_evaluator
        self._measured_eval: Optional[Callable] = None
        # ------------------------------------------------- telemetry
        # Observability only (core/telemetry.py): the bus is handed to
        # the executors and fed cell lifecycle events, but nothing it
        # records feeds back into decisions — campaigns are
        # bit-identical with telemetry on or off (tests/test_telemetry).
        self.telemetry = (telemetry if telemetry is not None
                          else _telemetry.current())
        self.last_stats: Dict = {}

    # --------------------------------------------------------- per cell
    def _make_cursor(self, spec: CellSpec, runner: TrialRunner,
                     baseline: TunableConfig) -> SearchCursor:
        options = dict(self.strategy_options)
        stages = self.stages_factory(spec)
        if stages is not None:
            options["stages"] = stages
        return self.strategy.factory(runner, baseline, self.threshold,
                                     options)

    # ------------------------------------------------------ checkpoints
    def _ckpt_path(self, spec: CellSpec) -> pathlib.Path:
        return self.checkpoint_dir / f"{spec.key()}.json"

    def discard_checkpoints(self) -> None:
        """Forget persisted state for this campaign's cells (re-tune)."""
        if self.checkpoint_dir is None:
            return
        for spec in self.cells:
            path = self._ckpt_path(spec)
            if path.exists():
                path.unlink()

    def _signature(self, spec: CellSpec, baseline: TunableConfig,
                   cursor: SearchCursor) -> str:
        """Everything the cell's decisions depend on.  For the tree
        strategy the blob layout is byte-identical to the version-1
        checkpoint signature, so v1 checkpoints stay resumable."""
        blob = json.dumps(
            [spec.key(), self.threshold, baseline.as_dict(),
             cursor.signature_parts()],
            sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()

    def _read_checkpoint(self, spec: CellSpec) -> Optional[Dict]:
        """Read + version/strategy-validate a cell's checkpoint (stale
        strategies are discarded with a warning); signature validation
        happens later in :meth:`_apply_checkpoint`, once warm-start
        seeds are resolved."""
        if self.checkpoint_dir is None:
            return None
        path = self._ckpt_path(spec)
        if not path.exists():
            return None
        try:
            d = json.loads(path.read_text())
        except (OSError, ValueError):
            return None                  # unreadable: start fresh
        if not isinstance(d, dict):
            return None
        # migration shim: version-1 checkpoints predate the strategy
        # field but were always tree walks with today's signature blob
        if d.get("version") == 1 and "strategy" not in d:
            d["version"] = CHECKPOINT_VERSION
            d["strategy"] = "tree"
            d["strategy_version"] = 1
        if (d.get("version") != CHECKPOINT_VERSION
                or d.get("strategy") != self.strategy.name
                or d.get("strategy_version") != self.strategy.version):
            warnings.warn(
                f"discarding stale checkpoint {path.name}: "
                f"strategy {d.get('strategy')!r} "
                f"v{d.get('strategy_version')} (ckpt v{d.get('version')}) "
                f"!= {self.strategy.name!r} v{self.strategy.version}")
            return None
        return d

    def _apply_checkpoint(self, cr: _CellRun, d: Optional[Dict]) -> None:
        if d is None or d.get("signature") != cr.signature:
            return                       # stale walk/baseline: start fresh
        if d.get("done") and d.get("report"):
            cr.report = self.strategy.load_report(d["report"])
            cr.replayed = cr.report.n_trials
            return
        cr.replay = list(d.get("log") or [])

    def _resolve_warmstart(self, spec: CellSpec, baseline: TunableConfig,
                           cursor: SearchCursor,
                           ckpt: Optional[Dict]) -> List[Dict]:
        """Seed the cursor; returns the seed config dicts used.

        A valid checkpoint's stored seed list wins over a fresh history
        query (the history may have grown since the interrupted run —
        replay must see the walk the checkpoint recorded); the stored
        list is trusted only if re-seeding the cursor with it
        reproduces the checkpoint's signature."""
        if not self.warm_start:
            return []
        stored = (ckpt or {}).get("warmstart")
        if stored is not None:           # [] is a stored decision too
            try:
                cursor.warm_start([config_from_dict(d) for d in stored])
            except (ValueError, TypeError):
                pass                     # seeds from an older knob space
            else:
                if self._signature(spec, baseline, cursor) \
                        == ckpt.get("signature"):
                    return list(stored)
        ws = self.history.warmstart_configs(
            spec.arch, spec.shape, spec.multi_pod,
            k_cells=self.warm_start_cells,
            per_cell=self.warm_start_per_cell)
        cursor.warm_start([config_from_dict(d) for d in ws])
        return ws

    def _resolve_primer(self, cursor: SearchCursor,
                        ckpt: Optional[Dict]) -> Optional[Dict]:
        """Prime a history-fit cursor (core/proposer.py) with its
        checkpointable fit state; returns the state used (None for
        strategies without the prime/build_primer hooks).

        A checkpoint's stored state wins over a fresh fit — the history
        may have grown since the interrupted run, and replay must see
        the fit the checkpoint's walk was proposed from.  The stored
        state is self-validating: ``prime`` re-fits from the
        append-only history *prefix* it names and raises if the bytes
        no longer match (rewritten store), in which case a fresh fit is
        built and the stale checkpoint is discarded downstream by the
        signature check."""
        prime = getattr(cursor, "prime", None)
        build = getattr(cursor, "build_primer", None)
        if not callable(prime) or not callable(build):
            return None
        stored = (ckpt or {}).get("primer")
        if stored is not None:
            try:
                prime(stored, self.history)
            except (ValueError, TypeError, KeyError):
                pass                     # stale/foreign state: refit
            else:
                return dict(stored)
        state = build(self.history)
        prime(state, self.history)
        return state

    def cell_done(self, spec: CellSpec) -> bool:
        """Full-validation completion probe: True iff the cell's
        checkpoint is done under this campaign's *exact* parameters —
        strategy, version, threshold/baseline/walk signature and
        warm-start seeds all included.  Never evaluates a trial; the
        fabric's pre-claim check (a done checkpoint from different
        parameters reads as not-done, so the cell is claimed and
        re-tuned exactly as the single-process campaign would)."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # probe loops must not spam
            ckpt = self._read_checkpoint(spec)
        if not ckpt or not ckpt.get("done") or not ckpt.get("report"):
            return False
        if self.measure_top_k and self.strategy.measurable:
            # a finished walk that still owes its measured re-rank
            # reads as not-done, so the fabric claims it and runs just
            # the measure pass (the walk itself replays for free)
            md = (ckpt.get("report") or {}).get("measured")
            if not (isinstance(md, dict)
                    and md.get("k") == self.measure_top_k):
                return False
        baseline = self.baseline_factory(spec)
        runner = TrialRunner(spec.workload(), self.evaluator)
        cursor = self._make_cursor(spec, runner, baseline)
        self._resolve_primer(cursor, ckpt)
        self._resolve_warmstart(spec, baseline, cursor, ckpt)
        return ckpt.get("signature") \
            == self._signature(spec, baseline, cursor)

    def _save_checkpoint(self, cr: _CellRun) -> None:
        if self.checkpoint_dir is None:
            return
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        state = {
            "version": CHECKPOINT_VERSION,
            "strategy": self.strategy.name,
            "strategy_version": self.strategy.version,
            "cell": cr.spec.key(),
            "signature": cr.signature,
            "threshold": self.threshold,
            "done": cr.report is not None,
            "log": [dataclasses.asdict(e) for e in cr.runner.log],
            "report": dataclasses.asdict(cr.report)
            if cr.report is not None else None,
        }
        if self.warm_start:
            state["warmstart"] = cr.warmstart
        if cr.primer is not None:
            state["primer"] = cr.primer
        health = cell_health(cr.runner.log)
        if health:                       # fault-free checkpoints unchanged
            state["health"] = health
        # atomic publish: concurrent fabric workers racing on one cell
        # (a stolen-but-alive lease) each land a complete checkpoint,
        # never a torn one
        atomic_publish(self._ckpt_path(cr.spec),
                       json.dumps(state, indent=1, default=str))

    # -------------------------------------------------------- advancing
    def _advance(self, cr: _CellRun):
        """Drive the cursor forward, replaying checkpointed batches;
        returns the next batch that needs live evaluation, or None when
        the cell's walk is complete."""
        while True:
            batch = cr.cursor.propose()
            if not batch:
                cr.report = cr.cursor.report()
                self._save_checkpoint(cr)
                return None
            start = cr.runner.n_trials
            stored = cr.replay[start:start + len(batch)]
            if len(stored) == len(batch) and all(
                    s.get("config") == c.config.as_dict()
                    and s.get("name") == c.name
                    for s, c in zip(stored, batch)):
                # replay: record the stored results without evaluating
                results, indices = [], []
                for s, c in zip(stored, batch):
                    res = TrialResult(**s["result"])
                    cr.runner.record(c.config, c.name, res, c.delta,
                                     replayed=True)
                    results.append(res)
                    indices.append(cr.runner.n_trials - 1)
                cr.cursor.absorb(results, indices)
                cr.replayed += len(batch)
                continue
            cr.replay = cr.replay[:start]    # drop any stale tail
            return batch

    def _absorb(self, cr: _CellRun, batch, results) -> None:
        indices = []
        for c, res in zip(batch, results):
            cr.runner.record(c.config, c.name, res, c.delta)
            indices.append(cr.runner.n_trials - 1)
        cr.cursor.absorb(results, indices)
        self._save_checkpoint(cr)

    # ----------------------------------------------------- measured tier
    def _resolve_measured_evaluator(self) -> Callable:
        """The evaluator the re-rank pass times configs with: the
        injected one, else the measured tier's default (kernel bench /
        reduced wall-clock proxy behind the disk timing cache)."""
        if self._measured_eval is None:
            if self.measured_evaluator is not None:
                self._measured_eval = self.measured_evaluator
            else:
                from repro_torch.core.measure import default_measured_evaluator
                self._measured_eval = default_measured_evaluator()
        return self._measured_eval

    def _measured_pending(self, report: Any) -> bool:
        """Whether a finished walk still owes its measured re-rank."""
        if not self.measure_top_k or not self.strategy.measurable:
            return False
        md = getattr(report, "measured", None)
        return not (isinstance(md, dict)
                    and md.get("k") == self.measure_top_k)

    def _measure_batch(self, cr: _CellRun) -> Optional[List[Dict]]:
        """The cell's measured-tier candidates (top-k surviving configs
        of the finished walk, by model cost), or None when the pass is
        off / already published / has nothing to measure — in the last
        case an empty ``measured`` stamp is published so completion
        probes (``cell_done``) converge."""
        if not self._measured_pending(cr.report):
            return None
        from repro_torch.core.measure import select_top_k
        cands = select_top_k(getattr(cr.report, "log", None) or [],
                             self.measure_top_k)
        if not cands:
            cr.report.measured = {
                "k": self.measure_top_k, "evaluations": 0,
                "candidates": [], "winner": None,
                "note": "no surviving configs to measure"}
            self._save_checkpoint(cr)
            return None
        return cands

    def _absorb_measured(self, cr: _CellRun, cands: List[Dict],
                         results: List[TrialResult]) -> None:
        """Publish the measured re-rank: per-candidate model-vs-measured
        costs, the measured winner, and whether measurement overturned
        the model's own ranking choice (``candidates[0]``).  Every
        measured evaluation is also emitted to the trial history under
        ``<strategy>+measured``."""
        sink = self.history.sink(f"{self.strategy.name}+measured") \
            if self.history is not None else None
        rows: List[Dict] = []
        best: Optional[int] = None
        for rank, (c, res) in enumerate(zip(cands, results)):
            row = {"rank": rank, "name": c["name"],
                   "config": c["config"].as_dict(),
                   "model_cost_s": c["model_cost_s"],
                   "cost_s": res.cost_s, "crashed": bool(res.crashed)}
            if res.crashed:
                row["failure"] = res.failure
                row["error"] = res.error
            if res.cached:
                row["cached"] = True
            if res.compiles:
                row["compiles"] = res.compiles
            if res.retries:
                row["retries"] = int(res.retries)
            rows.append(row)
            if not res.crashed and (best is None
                                    or res.cost_s
                                    < results[best].cost_s):
                best = rank
            if sink is not None:
                sink(cr.runner.workload, c["config"],
                     f"measured:{c['name'] or rank}", res, {})
        md: Dict[str, Any] = {
            "k": self.measure_top_k,
            "evaluations": len(rows),
            "candidates": rows,
            "model_choice": rows[0]["config"],
        }
        if best is not None:
            md["winner"] = rows[best]["config"]
            md["winner_name"] = rows[best]["name"]
            md["winner_cost_s"] = rows[best]["cost_s"]
            md["overturned"] = best != 0
        else:
            md["winner"] = None
            md["note"] = ("every measured candidate crashed; "
                          "the model ranking stands")
        cr.report.measured = md
        self._save_checkpoint(cr)
        if self.telemetry.enabled:
            self.telemetry.emit(
                "measure.rerank", cell=cr.spec.key(),
                evaluations=len(rows),
                overturned=bool(md.get("overturned")),
                winner_cost_s=md.get("winner_cost_s"))

    # -------------------------------------------------------- activation
    def _activate(self, spec: CellSpec) -> _CellRun:
        """Build one cell's run state (cursor, checkpoint, warm-start)
        the moment the queue hands the cell out."""
        if self.quarantine is not None:
            # we own this cell now (queue hand-out / fabric lease), so
            # any intent on it without a completion is an evaluation
            # that died with its worker: strike the in-flight config
            self.quarantine.reap_orphans(spec.workload().key())
        baseline = self.baseline_factory(spec)
        runner = TrialRunner(
            spec.workload(), self.evaluator,
            history=self.history.sink(self.strategy.name)
            if self.history is not None else None)
        cursor = self._make_cursor(spec, runner, baseline)
        ckpt = self._read_checkpoint(spec)
        primer = self._resolve_primer(cursor, ckpt)
        warmstart = self._resolve_warmstart(spec, baseline, cursor, ckpt)
        cr = _CellRun(spec, runner, cursor,
                      self._signature(spec, baseline, cursor))
        cr.warmstart = warmstart
        cr.primer = primer
        self._apply_checkpoint(cr, ckpt)
        if self.telemetry.enabled:
            self.telemetry.emit("cell.activate", cell=spec.key(),
                                strategy=self.strategy.name,
                                warmstart=len(cr.warmstart),
                                replayed=cr.replayed or len(cr.replay))
        return cr

    # -------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        """Drain the cell queue: run the strategy on every admitted
        cell; returns ``{cell_key: report}`` in admission order.

        Cells start in queue-priority order (core/schedule.py — the
        default ``arch`` prioritizer reproduces the historical
        first-seen-arch kickoff, so same-arch trials stay adjacent in
        the executor queue; ``history`` starts the highest
        expected-speedup cells first).  With ``intake=True`` the
        checkpoint directory's ``intake/`` is re-scanned between
        batches, so cells submitted while the campaign runs are
        admitted, tuned and reported without a restart; priority is
        re-queried at every hand-out, and in-flight cells are re-ranked
        between batches by their cursor-reported ``expected_gain``.
        ``max_active_cells`` bounds how many cells are in flight at
        once (None: all — the batch behaviour); a bounded campaign is
        where priority shapes wall-clock-to-first-improvement most.
        Scheduling order never changes per-cell decisions: each cursor
        is a deterministic state machine.
        """
        from repro_torch.core.schedule import CellQueue
        t0 = time.time()
        queue = CellQueue(
            self.cells, prioritizer=self.prioritize,
            history=self.history,
            directory=self.checkpoint_dir if self.intake else None)
        runs: Dict[str, _CellRun] = {}
        own_executor = self.executor is None
        executor = self.executor or SweepExecutor(
            self.evaluator, self.max_workers,
            trial_timeout_s=self.trial_timeout_s,
            max_retries=self.max_retries,
            quarantine=self.quarantine,
            telemetry=self.telemetry)
        # key -> ("walk" | "measure", batch, futs)
        pending: Dict[str, Tuple[str, list, list]] = {}
        m_exec: Optional[SweepExecutor] = None

        def measured_executor() -> SweepExecutor:
            """Lazy single-worker executor for measured trials: real
            wall clocks must not time-share the host with each other
            (or with a batch of concurrent model trials racing CPU),
            and serializing bounds the extra cost at k evaluations per
            cell.  Same deadline/retry/quarantine hardening as the
            model executor."""
            nonlocal m_exec
            if m_exec is None:
                m_exec = SweepExecutor(
                    self._resolve_measured_evaluator(), max_workers=1,
                    trial_timeout_s=self.trial_timeout_s,
                    max_retries=self.max_retries,
                    quarantine=self.quarantine,
                    telemetry=self.telemetry)
            return m_exec

        try:
            def kick(cr: _CellRun) -> None:
                """Advance one cell: next walk batch if the walk is
                live, else the measured re-rank batch, else done."""
                if cr.report is None:
                    batch = self._advance(cr)
                    if batch is not None:
                        futs = [executor.submit(cr.runner.workload,
                                                c.config)
                                for c in batch]
                        pending[cr.spec.key()] = ("walk", batch, futs)
                        return
                cands = self._measure_batch(cr)
                if cands is None:
                    queue.mark_done(cr.spec.key())
                    if self.telemetry.enabled:
                        self.telemetry.emit(
                            "cell.done", cell=cr.spec.key(),
                            trials=cr.runner.n_trials,
                            replayed=cr.replayed)
                    return
                futs = [measured_executor().submit(cr.runner.workload,
                                                   c["config"])
                        for c in cands]
                pending[cr.spec.key()] = ("measure", cands, futs)

            def fill() -> None:
                """Admit live submissions, then start queued cells
                while cell slots are free (priority re-queried at
                every hand-out)."""
                queue.scan_intake()
                while (self.max_active_cells is None
                       or len(pending) < self.max_active_cells):
                    spec = queue.pop_next()
                    if spec is None:
                        return
                    cr = self._activate(spec)
                    runs[spec.key()] = cr
                    # a checkpoint-done cell may still owe its measured
                    # re-rank; kick() resolves both cases
                    kick(cr)

            def live_rank(key: str):
                """Re-rank ready cells by the cursor's own live gain
                estimate — the highest-expected-gain cell's next batch
                enters the executor queue first."""
                gain_fn = getattr(runs[key].cursor, "expected_gain",
                                  None)
                return queue.rank_key(
                    key, gain=gain_fn() if callable(gain_fn) else None)

            fill()
            while pending:
                outstanding = {f for _, _, fs in pending.values()
                               for f in fs if not f.done()}
                if outstanding:
                    wait(outstanding, return_when=FIRST_COMPLETED)
                ready = [k for k, (_, _, fs) in pending.items()
                         if all(f.done() for f in fs)]
                ready.sort(key=live_rank)
                for key in ready:
                    tag, batch, futs = pending.pop(key)
                    results = [f.result() for f in futs]
                    if tag == "measure":
                        self._absorb_measured(runs[key], batch, results)
                    else:
                        self._absorb(runs[key], batch, results)
                    kick(runs[key])
                fill()
        finally:
            if own_executor:
                executor.shutdown()
            if m_exec is not None:
                m_exec.shutdown()

        reports = {spec.key(): runs[spec.key()].report
                   for spec in queue.cells()}
        n_trials = sum(r.n_trials for r in reports.values())
        replayed = sum(cr.replayed for cr in runs.values())
        wall = time.time() - t0
        self.last_stats = {
            "strategy": self.strategy.name,
            "cells": len(queue),
            "trials": n_trials,
            "replayed_trials": replayed,
            "evaluated_trials": n_trials - replayed,
            "wall_s": round(wall, 1),
            "cells_per_hour": round(len(queue) / max(wall, 1e-9)
                                    * 3600.0, 1),
            "queue": queue.snapshot(),
        }
        if self.warm_start:
            self.last_stats["warmstarted_cells"] = sum(
                1 for cr in runs.values() if cr.warmstart)
        if self.measure_top_k:
            meas = {k: getattr(cr.report, "measured", None)
                    for k, cr in runs.items()}
            meas = {k: m for k, m in meas.items()
                    if isinstance(m, dict)}
            self.last_stats["measured"] = {
                "k": self.measure_top_k,
                "cells": len(meas),
                "evaluations": sum(m.get("evaluations", 0)
                                   for m in meas.values()),
                "cached": sum(1 for m in meas.values()
                              for c in m.get("candidates", [])
                              if c.get("cached")),
                "overturned": sorted(
                    k for k, m in meas.items() if m.get("overturned")),
            }
        health = {k: cell_health(cr.runner.log) for k, cr in runs.items()}
        health = {k: h for k, h in health.items() if h}
        if health:                       # fault-free stats unchanged
            self.last_stats["health"] = health
            for cd in self.last_stats["queue"].get("cells", []):
                if cd.get("cell") in health:
                    cd["health"] = health[cd["cell"]]
            self.last_stats["degraded_cells"] = sorted(
                k for k, h in health.items() if h.get("degraded"))
            ex_stats = executor.stats()
            self.last_stats["hardening"] = {
                k: ex_stats[k] for k in ("retries", "timeouts",
                                         "quarantined")}
        return reports
