"""Black-box trial runner (the paper's "experimental run").

A trial = one configuration of the 12 knobs applied to one workload cell.
The application is a black box: the runner only observes a scalar cost.

This is the PyTorch port's copy of the reference's ``core/trial.py``:
the failure taxonomy, ``TrialResult``, ``Workload``, the two-level
``CompileCache`` (which the measured tier's timing cache builds on) and
``TrialRunner`` are the same, so trial logs, checkpoints and history
rows are byte-identical between the packages.  Step cells
(``arch:shape``) are evaluated by :class:`WallClockEvaluator`, the
median of real steps on one device; the analytic
``RooflineEvaluator`` comes with slice 8 of ROADMAP.md queue A and
raises ``NotImplementedError`` when it is built.  Kernel and serve cells
are evaluated by ``core/kernel_cell.KernelBenchEvaluator`` and
``serving/evaluator.ServeEvaluator``.  Every evaluator takes its device
through :func:`hold_device`; the executor's deadline counts a trial's
time on its device, not its wait for it (:class:`TrialClock`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
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
    """The paper's protocol: median of n repeats of the real step, on
    ``device``.

    Hardened to the same contract as the other evaluators (the measured
    tier, core/measure.py, runs it under the deadline/retry executor):
    exceptions are classified through :func:`classify_exception` — a
    :class:`TrialError` raised by a caching wrapper keeps its pre-tagged
    class, and a CUDA out-of-memory error is a deterministic crash of
    the config — and every result carries ``compiles``/``compile_s``
    accounting.  Tile knobs are validated against the cell's sequence
    length up front, so a non-dividing ``attn_block_q/kv`` is a clean
    deterministic-crash trial.

    The step comes from ``runtime/stepfn.build_step``.  ``make_args``
    ``(bundle, workload, config, device) -> args`` defaults to the
    bundle's ``measure_args``: zero-filled arguments of its shapes, as
    the reference's (so a reference decode cell's cache sits at position
    0), except that a shape marked ``cache_filled`` (the port's card
    decode cell) decodes at its last row from a seeded cache.  The first
    call (allocation, the kernels' build) is not timed and is reported
    as ``compile_s``; each timed call is the host's wall clock around
    the call and a synchronize of the device, the step's cost as a user
    pays it.  The cost is the median of ``repeats`` samples.  With
    ``min_sample_s`` > 0 a second untimed call sets a window: a sample
    is then the mean of as many back-to-back timed calls as make up
    ``min_sample_s`` (one for a step that long), so a short, host-bound
    step is not priced by a few milliseconds of the host's jitter.  As
    in the reference, a donating step's outputs are threaded into the
    next call: a train step's parameters and optimizer state, a decode
    step's cache (its position stays the first call's: a host integer
    here, so every timed call decodes at the depth the arguments give).
    The device's lock is held for the whole trial; ``peak_bytes`` is the
    device's peak allocation over it (``torch.cuda.max_memory_allocated``;
    None on the CPU).  The mesh factory of the reference has no
    counterpart: the port's steps run on one device."""

    def __init__(self, make_args: Optional[Callable] = None,
                 repeats: int = 5, device="cuda", min_sample_s: float = 0.0):
        self._make_args = make_args
        self.repeats = repeats
        self.device = device
        self.min_sample_s = min_sample_s

    def __call__(self, wl: Workload, rt: TunableConfig) -> TrialResult:
        import statistics

        import torch

        from repro_torch.core.space import SPACE
        from repro_torch.models.model import resolve_device
        from repro_torch.runtime.stepfn import build_step
        t0 = time.time()
        compile_s = 0.0
        compiles = 0
        try:
            SPACE.validate(rt, seq_len=wl.shp.seq_len)
            dev = resolve_device(self.device)
            cuda = dev.type == "cuda"

            def sync():
                if cuda:
                    torch.cuda.synchronize(dev)
            with hold_device(dev):
                t0 = time.time()
                if cuda:
                    torch.cuda.reset_peak_memory_stats(dev)
                bundle = build_step(wl.cfg, wl.shp, rt, None)
                args = self._make_args(bundle, wl, rt, dev) \
                    if self._make_args is not None \
                    else bundle.measure_args(dev)
                sync()
                c0 = time.perf_counter()
                out = bundle.fn(*args)
                sync()
                compile_s = round(time.perf_counter() - c0, 2)
                compiles = 1

                def timed():
                    nonlocal args, out
                    args = _thread_donated(bundle.kind, rt, args, out)
                    del out
                    t1 = time.perf_counter()
                    out = bundle.fn(*args)
                    sync()
                    return time.perf_counter() - t1
                window = 1
                if self.min_sample_s > 0:
                    window = max(1, math.ceil(self.min_sample_s / timed()))
                ts = [sum(timed() for _ in range(window)) / window
                      for _ in range(self.repeats)]
                peak = torch.cuda.max_memory_allocated(dev) if cuda else None
                del out, args
            return TrialResult(cost_s=float(statistics.median(ts)),
                               peak_bytes=peak, compiles=compiles,
                               compile_s=compile_s)
        except Exception as e:
            # TrialError already carries the stored "TypeName: msg"
            err = str(e) if isinstance(e, TrialError) \
                else f"{type(e).__name__}: {e}"
            return TrialResult(cost_s=float("inf"), crashed=True,
                               error=err[:500],
                               failure=classify_exception(e),
                               compiles=compiles,
                               compile_s=compile_s or
                               round(time.time() - t0, 2))


def _thread_donated(kind: str, rt: TunableConfig, args, out):
    """The next call's arguments: a donating step's updated state, as
    the reference threads it (``trial.py``), else the same arguments."""
    if rt.donate_buffers and kind == "train":
        return (out[0], out[1], args[2])
    if rt.donate_buffers and kind == "decode":
        return (args[0], dict(out[1], pos=args[1]["pos"]), args[2])
    return args


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
