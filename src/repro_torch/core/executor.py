"""Parallel trial execution for sweeps — the trial-throughput engine.

The tuner's outer loops (sensitivity sweeps, tree stage alternatives,
hillclimb lookahead, case-study batches) evaluate *independent*
candidate configurations; the expensive part of each evaluation is an
XLA lower+compile that releases the GIL, so a thread pool overlaps them
well on CPU-only infrastructure.  :class:`SweepExecutor` adds:

  * **in-flight deduplication** — two submissions of the same
    (cell, config) share one evaluation (on top of the evaluator's own
    compile-level dedup in core/trial.CompileCache);
  * **order-preserving gather** — ``map()`` returns results in
    submission order, so callers log trials deterministically and
    :class:`~repro_torch.core.trial.TrialRunner` accounting (the paper's
    <=10-runs budget) is byte-identical to the sequential path;
  * **speculative prefetch** — fire-and-forget cache warming for
    candidates a sequential driver will probably evaluate next
    (hillclimb lookahead); results land in the evaluator's caches, so
    a wrong guess costs only idle worker time, never correctness.

Evaluation faults surface as crashed TrialResults (cost = inf), exactly
like the sequential evaluator's behaviour — classified per the failure
taxonomy in core/trial.py.  Three hardening layers (all off by default;
fault-free accounting is bit-identical to the unhardened executor):

  * **deadlines** (``trial_timeout_s``) — an evaluation that exceeds
    the deadline is recorded as a ``timeout`` failure; its wedged
    thread is abandoned to a side pool of zombies (reaped opportunistically,
    never joined with a wait), so one hanging XLA compile cannot wedge
    the sweep;
  * **retry/backoff** (``max_retries``) — ``transient`` failures are
    re-evaluated with exponential backoff + deterministic jitter,
    inside the original submission (finished futures leave the
    in-flight table, so a fresh submit of a previously-crashed config
    never dedups onto the crashed Future);
  * **quarantine** (``quarantine=``, a core/quarantine.Quarantine) —
    each evaluation is bracketed by intent/completion ledger records,
    and configs quarantined fleet-wide are skipped outright, scored as
    deterministic crashes.

This is the PyTorch port's own copy of the reference's
``core/executor.py``: its output is byte-identical to the reference's.
One difference: a deadline counts a trial's time on its device, not its
wait for the device's lock (core/trial.TrialClock), up to one deadline.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import telemetry as _telemetry
from repro_torch.core.params import TunableConfig
from repro_torch.core.trial import (FAILURE_TIMEOUT, FAILURE_WORKER_DEATH,
                                    TrialClock, TrialResult, Workload,
                                    classify_exception, trial_clock)


def default_workers() -> int:
    """Worker count: REPRO_TRIAL_WORKERS env var, else min(8, cores-1),
    floored at 2 — compiles release the GIL, so even small boxes overlap
    one compile with one analytic recompute."""
    env = os.environ.get("REPRO_TRIAL_WORKERS")
    if env:
        return max(1, int(env))
    return max(2, min(8, (os.cpu_count() or 2) - 1))


def _trial_key(wl: Workload, rt: TunableConfig) -> Tuple:
    return (wl.key(), tuple(sorted(rt.as_dict().items())))


def _safe_eval(evaluator, wl: Workload, rt: TunableConfig) -> TrialResult:
    """Evaluator contract: never raise — a fault is a crashed trial."""
    try:
        return evaluator(wl, rt)
    except Exception as e:
        return TrialResult(cost_s=float("inf"), crashed=True,
                           error=f"{type(e).__name__}: {e}"[:500],
                           failure=classify_exception(e))


class SweepExecutor:
    """Evaluate independent (workload, config) candidates concurrently."""

    def __init__(self, evaluator: Callable[[Workload, TunableConfig],
                                           TrialResult],
                 max_workers: Optional[int] = None, *,
                 trial_timeout_s: Optional[float] = None,
                 max_retries: int = 0,
                 retry_backoff_s: float = 0.05,
                 quarantine=None,
                 telemetry=None):
        self.evaluator = evaluator
        self.max_workers = max_workers or default_workers()
        self.trial_timeout_s = trial_timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.quarantine = quarantine
        self.telemetry = (telemetry if telemetry is not None
                          else _telemetry.current())
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_workers,
            thread_name_prefix="sweep")
        self._lock = threading.Lock()
        self._inflight: Dict[Tuple, Future] = {}
        self._zombies: List[threading.Thread] = []
        # Counters are read by stats() as one consistent snapshot and
        # mutated from pool threads; every increment MUST go through
        # _count() (or an explicit `with self._lock` block) — the
        # concurrent-stress test in tests/test_executor.py enforces
        # exact totals under contention.
        self.n_evals = 0            # distinct evaluations actually run
        self.n_submitted = 0        # submissions incl. deduplicated ones
        self.n_retries = 0          # transient re-evaluations paid for
        self.n_timeouts = 0         # evaluations abandoned at the deadline
        self.n_quarantined = 0      # candidates skipped as quarantined

    def _count(self, name: str, n: int = 1) -> None:
        """Thread-safe counter increment (pool threads race on these)."""
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    # ------------------------------------------------------------ core
    def submit(self, wl: Workload, rt: TunableConfig) -> Future:
        """Schedule one evaluation; identical in-flight candidates are
        coalesced onto the same future."""
        self._reap_zombies()
        key = _trial_key(wl, rt)
        with self._lock:
            self.n_submitted += 1
            fut = self._inflight.get(key)
            if fut is not None:
                return fut
            fut = self._pool.submit(self._run, key, wl, rt)
            self._inflight[key] = fut
            self.n_evals += 1
            return fut

    def _run(self, key: Tuple, wl: Workload, rt: TunableConfig
             ) -> TrialResult:
        try:
            return self._evaluate(wl, rt)
        finally:
            with self._lock:
                self._inflight.pop(key, None)

    def _evaluate(self, wl: Workload, rt: TunableConfig) -> TrialResult:
        """One candidate, wrapped in a telemetry trial span.  The span
        observes the result after the fact — decisions are made by
        _evaluate_raw alone, so runs are bit-identical with telemetry
        on or off."""
        t = self.telemetry
        if not t.enabled:
            return self._evaluate_raw(wl, rt)
        from repro_torch.core.quarantine import config_key
        with t.span("trial", cell=wl.key(), config=config_key(rt)) as sp:
            res = self._evaluate_raw(wl, rt)
            note = {"crashed": res.crashed, "retries": res.retries}
            if res.cost_s == res.cost_s and res.cost_s != float("inf"):
                note["cost_s"] = round(res.cost_s, 6)
            if res.failure:
                note["failure"] = res.failure
            if res.cached:
                note["cached"] = True
            if res.compile_s:
                note["compile_s"] = round(res.compile_s, 6)
            sp.note(**note)
            return res

    def _evaluate_raw(self, wl: Workload, rt: TunableConfig) -> TrialResult:
        """One candidate through the full hardening stack: quarantine
        guard, then attempt + bounded transient retries."""
        t = self.telemetry
        q = self.quarantine
        if q is not None:
            from repro_torch.core.quarantine import config_key
            ck = config_key(rt)
            if q.is_quarantined(ck):
                self._count("n_quarantined")
                if t.enabled:
                    t.emit("quarantine.skip", cell=wl.key(), config=ck,
                           strikes=q.effective_strikes(ck))
                return TrialResult(
                    cost_s=float("inf"), crashed=True,
                    failure=FAILURE_WORKER_DEATH,
                    error=f"quarantined: config {ck} reached "
                          f"{q.effective_strikes(ck)} strikes "
                          f"(threshold {q.strike_threshold}) — "
                          "skipped fleet-wide, scored as a crash")
        res = self._attempt(wl, rt)
        attempt = 0
        while res.retryable and attempt < self.max_retries:
            attempt += 1
            self._count("n_retries")
            backoff = self._backoff(wl, rt, attempt)
            if t.enabled:
                t.emit("retry", cell=wl.key(), attempt=attempt,
                       backoff_s=round(backoff, 4), failure=res.failure)
            time.sleep(backoff)
            res = self._attempt(wl, rt)
        res.retries = attempt
        return res

    def _backoff(self, wl: Workload, rt: TunableConfig,
                 attempt: int) -> float:
        """Exponential backoff with *deterministic* jitter (hash of the
        candidate + attempt, not random): workers desynchronize without
        making campaign wall-time depend on RNG state."""
        blob = f"{_trial_key(wl, rt)}:{attempt}".encode()
        jitter = int(hashlib.sha1(blob).hexdigest()[:4], 16) / 0xffff
        return self.retry_backoff_s * (2 ** (attempt - 1)) * (1 + jitter)

    def _attempt(self, wl: Workload, rt: TunableConfig) -> TrialResult:
        """One evaluation bracketed by quarantine intent/completion; the
        deadline (if any) is enforced here.  An interrupt (BaseException,
        e.g. KeyboardInterrupt unwinding the pool) still writes the
        completion — only true process death leaves an orphaned intent."""
        q = self.quarantine
        token = q.begin(wl.key(), rt) if q is not None else None
        try:
            if self.trial_timeout_s is None:
                res = _safe_eval(self.evaluator, wl, rt)
            else:
                res = self._attempt_with_deadline(wl, rt)
        except BaseException:
            if token is not None:
                q.complete(token, crashed=True, note="interrupted")
            raise
        if token is not None:
            q.complete(token, crashed=res.crashed, note=res.failure)
            if res.failure == FAILURE_TIMEOUT:
                # a hang is as poisonous as a kill, just slower: strike
                # it so K timeouts fleet-wide quarantine the config
                q.strike(token["attempt"], token["key"], token["cell"],
                         reason="deadline exceeded")
        return res

    def _attempt_with_deadline(self, wl: Workload,
                               rt: TunableConfig) -> TrialResult:
        done = threading.Event()
        box: Dict[str, TrialResult] = {}
        clock = TrialClock()

        def work():
            with trial_clock(clock):
                box["res"] = _safe_eval(self.evaluator, wl, rt)
            done.set()

        t = threading.Thread(target=work, daemon=True,
                             name="sweep-trial")
        t.start()
        limit = self.trial_timeout_s
        t0 = time.monotonic()

        def deadline() -> float:
            # a wait for the device (core/trial.hold_device) is not the
            # trial's time, up to one deadline: the longest a trial that
            # is not wedged holds the device
            return t0 + limit + min(clock.waited_s(), limit)

        while not done.wait(max(0.0, deadline() - time.monotonic())):
            if time.monotonic() >= deadline():
                break
        if done.is_set():
            return box["res"]
        # the evaluation is wedged: abandon its thread to the zombie
        # side pool (reaped without waiting) so the sweep moves on; if
        # it still waits for its device, it will not start there
        clock.abandoned = True
        with self._lock:
            self._zombies.append(t)
            self.n_timeouts += 1
        tel = self.telemetry
        if tel.enabled:
            tel.emit("timeout", cell=wl.key(),
                     deadline_s=self.trial_timeout_s)
        return TrialResult(
            cost_s=float("inf"), crashed=True, failure=FAILURE_TIMEOUT,
            error=f"trial exceeded deadline of {self.trial_timeout_s}s "
                  "(evaluation abandoned)")

    def _reap_zombies(self) -> None:
        """Drop abandoned trial threads that have since finished.  Never
        blocks: a still-wedged zombie just stays in the pool (it is a
        daemon thread, so it cannot outlive the process)."""
        with self._lock:
            self._zombies = [t for t in self._zombies if t.is_alive()]

    def map(self, wl: Workload, configs: Sequence[TunableConfig]
            ) -> List[TrialResult]:
        """Evaluate candidates concurrently; results in input order."""
        futs = [self.submit(wl, rt) for rt in configs]
        return [f.result() for f in futs]

    def prefetch(self, wl: Workload, configs: Iterable[TunableConfig]
                 ) -> None:
        """Fire-and-forget warm-up of the evaluator caches (speculative
        lookahead); never blocks, never raises."""
        for rt in configs:
            self.submit(wl, rt)

    # ------------------------------------------------------- lifecycle
    def shutdown(self, wait: bool = True,
                 cancel_futures: bool = False) -> None:
        self._pool.shutdown(wait=wait, cancel_futures=cancel_futures)
        self._reap_zombies()

    def __enter__(self) -> "SweepExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"submitted": self.n_submitted, "evals": self.n_evals,
                    "deduped": self.n_submitted - self.n_evals,
                    "workers": self.max_workers,
                    "retries": self.n_retries,
                    "timeouts": self.n_timeouts,
                    "quarantined": self.n_quarantined,
                    "zombies": len(self._zombies)}


def run_trials(runner, candidates: Sequence[Tuple[TunableConfig, str,
                                                  Optional[dict]]],
               executor: Optional[SweepExecutor] = None
               ) -> List[Tuple[int, TrialResult]]:
    """Evaluate a batch of candidates for a TrialRunner.

    With an executor the evaluations overlap; the runner's log gains one
    entry per candidate *in input order* either way.  Both paths apply
    the same fault conversion (an evaluator exception = crashed trial),
    so run counting, log layout and results are identical regardless of
    how the batch was scheduled.

    Returns ``(log_index, result)`` per candidate: the exact position of
    the candidate's entry in ``runner.log``, so callers annotate entries
    directly instead of re-finding them by config equality (two identical
    configs from different stages would cross-annotate).
    """
    if executor is None:
        out = []
        for rt, name, delta in candidates:
            res = _safe_eval(runner.evaluator, runner.workload, rt)
            runner.record(rt, name, res, delta)
            out.append((len(runner.log) - 1, res))
        return out
    if executor.evaluator is not runner.evaluator:
        raise ValueError("executor wraps a different evaluator than the "
                         "runner — results would bypass the runner's "
                         "evaluator")
    futs = [executor.submit(runner.workload, rt)
            for rt, name, delta in candidates]
    results = [f.result() for f in futs]
    out = []
    for (rt, name, delta), res in zip(candidates, results):
        runner.record(rt, name, res, delta)
        out.append((len(runner.log) - 1, res))
    return out
