"""Black-box trial runner (the paper's "experimental run").

A trial = one configuration of the 12 knobs applied to one workload cell.
The application is a black box: the runner only observes a scalar cost.

This is the PyTorch port's copy of the reference's ``core/trial.py``
without the reference's device code: the failure taxonomy,
``TrialResult``, ``Workload``, the two-level ``CompileCache`` (which the
measured tier's timing cache builds on) and ``TrialRunner`` are the
same, so trial logs, checkpoints and history rows are byte-identical
between the packages.  The evaluators that time a model step come later
(ROADMAP.md, queue A): ``WallClockEvaluator`` with slice 4,
``RooflineEvaluator`` with slice 8; each raises ``NotImplementedError``
when it is built.  Kernel and serve cells are evaluated by
``core/kernel_cell.KernelBenchEvaluator`` and
``serving/evaluator.ServeEvaluator``, which take the card through
:func:`hold_device`; the executor's deadline counts a trial's time on
its device, not its wait for it (:class:`TrialClock`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import pathlib
import threading
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import telemetry as _telemetry
from repro_torch.core.params import TunableConfig

# the port's own directory: a timing the reference cached on its host is
# never replayed as a trial on the card
CACHE_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "torch" / "trials"

# ------------------------------------------------------- failure taxonomy
# Every crashed trial is classified so the layers above can react
# differently: deterministic failures stay memoized and scored
# (the config is genuinely bad), transient ones are retryable, timeouts
# come from the executor deadline, and worker-death is assigned post hoc
# by the quarantine ledger (the evaluation never returned at all).
FAILURE_DETERMINISTIC = "deterministic"
FAILURE_TRANSIENT = "transient"
FAILURE_TIMEOUT = "timeout"
FAILURE_WORKER_DEATH = "worker-death"

#: Environment faults that may succeed on retry.  TimeoutError and
#: ConnectionError are OSError subclasses, so disk/NFS hiccups, host
#: OOM and socket drops all land here; everything else (shape errors,
#: HBM overflow, XLA lowering failures) is deterministic per program.
_TRANSIENT_TYPES = (OSError, MemoryError)


def classify_exception(e: BaseException) -> str:
    """Map an evaluator exception to a failure class.  An exception that
    already carries a ``.failure`` attribute (e.g. :class:`TrialError`
    re-raised from a memoized entry) keeps its class."""
    tagged = getattr(e, "failure", "")
    if tagged:
        return tagged
    if isinstance(e, _TRANSIENT_TYPES):
        return FAILURE_TRANSIENT
    return FAILURE_DETERMINISTIC


class TrialError(RuntimeError):
    """An evaluator failure that carries its classification."""

    def __init__(self, message: str, failure: str = FAILURE_DETERMINISTIC):
        super().__init__(message)
        self.failure = failure


@dataclasses.dataclass
class TrialResult:
    cost_s: float                  # observed "runtime" (black-box metric)
    crashed: bool = False
    error: str = ""
    roofline: Optional[Dict] = None
    peak_bytes: Optional[float] = None
    fits_hbm: bool = True
    compile_s: float = 0.0
    cached: bool = False
    compiles: int = 0              # fresh XLA compiles this trial paid for
    failure: str = ""              # taxonomy class when crashed ("" if not)
    retries: int = 0               # transient retries this result absorbed

    @property
    def retryable(self) -> bool:
        return self.crashed and self.failure == FAILURE_TRANSIENT

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Workload:
    """One tunable application instance (cell)."""
    arch: str
    shape: str
    multi_pod: bool = False

    @property
    def cfg(self) -> ArchConfig:
        return get_config(self.arch)

    @property
    def shp(self) -> ShapeConfig:
        return get_shape(self.shape)

    def key(self) -> str:
        return f"{self.arch}__{self.shape}__" + \
            ("multipod" if self.multi_pod else "pod")


class CompileCache:
    """Two-level memo of measurements (in the port, the measured tier's
    timing cache, core/measure.TimingCache, is its one user).

    Level 1 is an in-memory LRU (per process); level 2 is the disk cache
    under ``results/torch/trials/compiles`` unless a directory is given.
    Keys are opaque strings.  Values are small JSON dicts — a
    measurement or ``{"error": ..., "failure": ...}`` for a program
    that failed to build or run.  Only *deterministic*
    failures are memoized like successes; a transient fault (classified
    via :func:`classify_exception` — e.g. an ``OSError`` from the disk
    cache or a host OOM under a parallel sweep) is returned to its
    waiters but never remembered, so the next lookup rebuilds.

    ``get_or_build`` is thread-safe with in-flight deduplication: when N
    executor threads ask for the same key, one runs the builder and the
    rest block on its result.

    The disk level is also multi-*process* safe (the campaign fabric,
    core/fabric.py, shares one cache directory across workers): every
    write goes to a uniquely-named tempfile in the cache directory and
    is published with an atomic ``os.replace``, so two workers building
    the same key concurrently each publish a complete entry (last
    writer wins — the values are deterministic per key, so both wrote
    the same bytes); a reader that still encounters a torn/corrupt
    entry (e.g. left behind by a pre-fabric writer that crashed
    mid-write) treats it as a miss and rebuilds, repairing the entry.
    """

    #: telemetry event prefix — subclasses with their own semantics
    #: (the measured tier's TimingCache) override, so the metrics
    #: aggregator can report compile-cache and timing-cache hit rates
    #: separately
    CACHE_KIND = "cache"

    def __init__(self, directory: Optional[pathlib.Path] = None,
                 mem_entries: int = 512, use_disk: bool = True):
        self.dir = pathlib.Path(directory) if directory else \
            CACHE_DIR / "compiles"
        self.mem_entries = mem_entries
        self.use_disk = use_disk
        self._mem: "collections.OrderedDict[str, Dict]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._inflight: Dict[str, threading.Event] = {}
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> pathlib.Path:
        return self.dir / f"{key}.json"

    def _mem_put(self, key: str, val: Dict) -> None:
        self._mem[key] = val
        self._mem.move_to_end(key)
        while len(self._mem) > self.mem_entries:
            self._mem.popitem(last=False)

    def _lookup(self, key: str) -> Optional[Dict]:
        """One locked probe of memory then disk (caller holds no lock)."""
        with self._lock:
            if key in self._mem:
                self._mem.move_to_end(key)
                return self._mem[key]
        if self.use_disk:
            p = self._path(key)
            try:
                val = json.loads(p.read_text())
            except (OSError, ValueError):
                # missing, or torn by a crashed writer / a concurrent
                # non-atomic producer: treat as a miss and rebuild
                return None
            if not isinstance(val, dict):
                return None
            with self._lock:
                self._mem_put(key, val)
            return val
        return None

    def _disk_put(self, key: str, val: Dict) -> None:
        """Publish one entry atomically (core/fsutil.atomic_publish),
        safe against concurrent writers in other processes."""
        from repro_torch.core.fsutil import atomic_publish
        self.dir.mkdir(parents=True, exist_ok=True)
        atomic_publish(self._path(key), json.dumps(val),
                       prefix=f".{key}.")

    def get_or_build(self, key: str, builder: Callable[[], Dict]) -> Dict:
        tel = _telemetry.current()
        while True:
            val = self._lookup(key)
            if val is not None:
                with self._lock:
                    self.hits += 1
                if tel.enabled:
                    tel.emit(f"{self.CACHE_KIND}.hit", key=key)
                return val
            with self._lock:
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    self.misses += 1
                    break
            ev.wait()       # another thread is compiling this program
        if tel.enabled:
            tel.emit(f"{self.CACHE_KIND}.miss", key=key)
        try:
            val = builder()
            # memoization policy by failure class: successes go to both
            # levels; deterministic build errors are memoized in-memory
            # only (persisting them would outlive the run that observed
            # them); transient faults are memoized NOWHERE — the caller
            # sees this one failure, and the next lookup of the same key
            # rebuilds instead of replaying a stale environment hiccup
            if self.use_disk and "error" not in val:
                self._disk_put(key, val)
            if val.get("failure") != FAILURE_TRANSIENT:
                with self._lock:
                    self._mem_put(key, val)
            return val
        finally:
            with self._lock:
                self._inflight.pop(key).set()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "mem_entries": len(self._mem)}


class RooflineEvaluator:
    """The reference's analytic evaluator (XLA ``cost_analysis`` of a
    production-mesh compile).  Not ported: it comes with slice 8."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "RooflineEvaluator is not ported yet (ROADMAP.md queue A, "
            "slice 8: the analytic evaluator)")


class WallClockEvaluator:
    """The paper's protocol over a model step: median of n repeats of
    the real step.  Not ported: it needs the step builders of slice 4."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "WallClockEvaluator is not ported yet (ROADMAP.md queue A, "
            "slice 4: training, and measured step cells)")


_DEVICE_LOCKS: Dict[str, threading.Lock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def device_lock(device) -> threading.Lock:
    """The one lock of a device.  Two timings on one card at once would
    each time the other's work, so every evaluator that runs on a device
    holds its lock (through :func:`hold_device`) around building,
    warming up and timing a trial, and the kernels' launch counters are
    touched only under it.  A campaign on a device walks its cells with
    one worker; the lock orders that worker against the measured
    re-rank's, which may time another cell at the same moment."""
    key = str(device)
    with _DEVICE_LOCKS_GUARD:
        lock = _DEVICE_LOCKS.get(key)
        if lock is None:
            lock = _DEVICE_LOCKS[key] = threading.Lock()
        return lock


class TrialClock:
    """What an executor's deadline counts of one trial.  The executor
    hands each trial it runs under a deadline a clock
    (:func:`trial_clock`); :func:`hold_device` stops it while the trial
    waits for its device, so the wait is not the trial's time, and a
    trial the executor has abandoned never starts on the device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._waited = 0.0
        self._since: Optional[float] = None
        self.abandoned = False

    def waited_s(self) -> float:
        """Seconds spent waiting for a device so far, the running wait
        included."""
        with self._lock:
            running = (time.monotonic() - self._since
                       if self._since is not None else 0.0)
            return self._waited + running

    def _wait(self, begin: bool) -> None:
        with self._lock:
            if begin:
                self._since = time.monotonic()
            elif self._since is not None:
                self._waited += time.monotonic() - self._since
                self._since = None


_CLOCK = threading.local()


@contextlib.contextmanager
def trial_clock(clock: TrialClock):
    """Run the calling thread's trial on ``clock``."""
    _CLOCK.clock = clock
    try:
        yield clock
    finally:
        _CLOCK.clock = None


@contextlib.contextmanager
def hold_device(device):
    """Hold ``device``'s lock for one trial.  The wait for it stops the
    trial's clock; a trial abandoned at its deadline while it waited
    fails as a timeout instead of running."""
    clock: Optional[TrialClock] = getattr(_CLOCK, "clock", None)
    lock = device_lock(device)
    if clock is not None:
        clock._wait(True)
    lock.acquire()
    if clock is not None:
        clock._wait(False)
    try:
        if clock is not None and clock.abandoned:
            raise TrialError("trial abandoned at its deadline before it "
                             "reached the device", FAILURE_TIMEOUT)
        yield
    finally:
        lock.release()


@dataclasses.dataclass
class TrialLogEntry:
    name: str
    delta: Dict[str, Any]
    config: Dict[str, Any]
    result: Dict[str, Any]
    accepted: Optional[bool] = None
    note: str = ""


class TrialRunner:
    """Counts and logs every run (the paper's <=10-runs budget is checked
    by tests against this counter).

    ``history`` is an optional emission hook ``(workload, rt, name,
    result, delta) -> None`` (see :meth:`~repro.core.history
    .TrialHistory.sink`): every *evaluated* trial is forwarded to it,
    so campaigns accumulate a persistent trial history; trials replayed
    from a checkpoint (``record(..., replayed=True)``) were already
    emitted by the run that evaluated them and are not re-emitted.
    """

    def __init__(self, workload: Workload, evaluator: Callable,
                 history: Optional[Callable] = None):
        self.workload = workload
        self.evaluator = evaluator
        self.history = history
        self.log: list[TrialLogEntry] = []

    @property
    def n_trials(self) -> int:
        return len(self.log)

    def run(self, rt: TunableConfig, name: str,
            delta: Dict[str, Any] = None) -> TrialResult:
        res = self.evaluator(self.workload, rt)
        self.record(rt, name, res, delta)
        return res

    def record(self, rt: TunableConfig, name: str, res: TrialResult,
               delta: Dict[str, Any] = None,
               replayed: bool = False) -> TrialResult:
        """Log an already-evaluated trial (parallel executor path).

        Exactly one log entry per evaluated configuration — the run
        budget counts evaluations, however they were scheduled."""
        self.log.append(TrialLogEntry(
            name=name, delta=delta or {}, config=rt.as_dict(),
            result={k: v for k, v in res.as_dict().items()
                    if k != "roofline"}))
        if self.history is not None and not replayed:
            self.history(self.workload, rt, name, res, delta or {})
        return res
