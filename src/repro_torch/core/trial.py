"""Black-box trial runner (the paper's "experimental run").

A trial = one configuration of the 12 knobs applied to one workload cell.
The application is a black box: the runner only observes a scalar cost.

This is the PyTorch port's copy of the reference's ``core/trial.py``:
the failure taxonomy, ``TrialResult``, ``Workload``, the two-level
``CompileCache`` (which the measured tier's timing cache builds on) and
``TrialRunner`` are the same, so trial logs, checkpoints and history
rows are byte-identical between the packages.  Step cells
(``arch:shape``) are evaluated by :class:`WallClockEvaluator`, the
median of real steps on one device, or, where a caller names it
(``tune --evaluator repro_torch.core.trial:RooflineEvaluator``), by
:class:`RooflineEvaluator`: the calibrated roofline of the step counted
on fake tensors (``core/stepcount.count_cell``) for the production mesh
over a fake process group, or for one card.  Kernel and serve cells
are evaluated by ``core/kernel_cell.KernelBenchEvaluator`` and
``serving/evaluator.ServeEvaluator``.  Every evaluator takes its device
through :func:`hold_device`; the executor's deadline counts a trial's
time on its device, not its wait for it (:class:`TrialClock`).  On a
card, :func:`hold_device` also takes the card's file lock
(:func:`hold_card`), so processes that share one card time their trials
one at a time (the port's own: the reference's workers time nothing).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import fcntl
import hashlib
import json
import math
import os
import pathlib
import re
import tempfile
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
    """Two-level memo of measurements: :class:`RooflineEvaluator`'s
    calibration counts, and the measured tier's timing cache
    (core/measure.TimingCache) builds on it.

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
    """cost = calibrated analytic roofline seconds of the step on the H100.

    The reference's evaluator (``src/repro/core/trial.py``), on the
    port's counter: each calibration point's step is built for the mesh
    (by default the production mesh over a fake process group,
    ``launch/mesh.fake_production_mesh``; a factory that returns None
    gives one card) and counted once on fake tensors
    (``core/stepcount.count_cell``).  As in the reference, two small
    variants (1 and 3 layer-units) are counted and every term is
    extrapolated to the true depth (core/costmodel.calibration_points),
    which makes a trial far cheaper than counting the full stack.

    The calibration counts are memoized in a :class:`CompileCache` (its
    disk level under ``results/torch/trials/compiles``) keyed by
    ``TunableConfig.compile_key()`` — configs that differ only in
    analytic knobs share one set of counts — under the reference's keys.
    The reference compiles each point twice, unrolled for the compute
    and collective terms and scanned for the peak (buffer reuse shows
    only there); the port's layer loop is one eager program either way,
    so it counts each point once and reads all three terms from it:
    ``compiles`` is 2 where the reference's is 4.  Off every default
    path: ``tune --evaluator repro_torch.core.trial:RooflineEvaluator``
    names it.
    """

    def __init__(self, mesh_factory: Callable = None, use_cache: bool = True,
                 hbm_limit: float = None,
                 compile_cache: Optional[CompileCache] = None):
        from repro_torch.core import costmodel
        from repro_torch.launch.mesh import fake_production_mesh
        self._mesh_factory = mesh_factory or fake_production_mesh
        self.use_cache = use_cache
        self.hbm_limit = hbm_limit or costmodel.HW["hbm_per_chip"]
        self.compile_cache = compile_cache or \
            (CompileCache() if use_cache else
             CompileCache(use_disk=False, mem_entries=0))
        # per-trial accounting shared across threads
        self._acct = threading.local()
        self.total_compiles = 0
        self._count_lock = threading.Lock()

    # ------------------------------------------------------------- keys
    def _compile_id(self, wl: Workload, mesh, point_units: int,
                    rt_variant: TunableConfig) -> str:
        from repro_torch.launch.mesh import axis_sizes
        ck = rt_variant.compile_key(kind=wl.shp.kind, family=wl.cfg.family)
        # mesh axis ORDER matters for sharding — keep it in the key
        blob = json.dumps([wl.key(), point_units,
                           list(axis_sizes(mesh).items()),
                           ck], sort_keys=True, default=str)
        h = hashlib.sha1(blob.encode()).hexdigest()[:16]
        return f"{wl.key()}__u{point_units}__{h}"

    # --------------------------------------------------------- compiles
    def _count_at(self, cfg, shape, rt: TunableConfig, mesh) -> Dict:
        from repro_torch.core import costmodel, stepcount
        count, _ = stepcount.count_cell(cfg, shape, rt, mesh)
        rl = costmodel.roofline_of(count, compute_dtype=rt.compute_dtype)
        return {"roofline": rl.as_dict(),
                "square_free_peak": float(count.square_free_peak)}

    def _measured(self, wl: Workload, mesh, point_cfg, units_tag: int,
                  rt_variant: TunableConfig):
        """One memoized calibration count -> (Roofline, its peak without
        the (S, S) attention squares); raises the memoized error if this
        program deterministically fails."""
        from repro_torch.core import costmodel
        key = self._compile_id(wl, mesh, units_tag, rt_variant)
        built = []

        def build() -> Dict:
            built.append(True)
            with _telemetry.current().span("compile", cell=wl.key(),
                                           key=key) as sp:
                t0 = time.time()
                try:
                    entry = self._count_at(point_cfg, wl.shp, rt_variant,
                                           mesh)
                    entry["compile_s"] = round(time.time() - t0, 2)
                    return entry
                except Exception as e:
                    # classify BEFORE memoizing: only deterministic program
                    # failures may be remembered (the cache skips transient
                    # entries), so an OSError from the disk cache is not
                    # permanently recorded as a crashed program
                    sp.note(error=True)
                    return {"error": f"{type(e).__name__}: {e}"[:500],
                            "failure": classify_exception(e),
                            "compile_s": round(time.time() - t0, 2)}

        entry = self.compile_cache.get_or_build(key, build)
        acct = self._trial_acct()
        acct["cache_reads"] += 1
        if built:
            acct["compiles"] += 1
            acct["compile_s"] += entry.get("compile_s", 0.0)
            with self._count_lock:
                self.total_compiles += 1
        if "error" in entry:
            raise TrialError(entry["error"],
                             failure=entry.get("failure",
                                               FAILURE_DETERMINISTIC))
        return (costmodel.roofline_from_dict(entry["roofline"]),
                entry["square_free_peak"])

    def _trial_acct(self) -> Dict[str, Any]:
        if not hasattr(self._acct, "d"):
            self._acct.d = {"compiles": 0, "compile_s": 0.0,
                            "cache_reads": 0}
        return self._acct.d

    # ------------------------------------------------------------ trial
    def calibrated_roofline(self, wl: Workload, rt: TunableConfig):
        """Compute + collective terms and the PEAK memory from two small
        counts; the MEMORY term from the first-principles analytic
        traffic model (as in the reference).  Every knob (remat /
        microbatch / dtypes / donation) enters as in the reference; the
        flash kernel (``attn_impl="pallas"`` prefill) as the port runs
        it: in the compute term its causal half of the S x S products at
        its products' rate (``costmodel.flash_kernel_flops``), in the
        memory term its K/V read once (``costmodel.port_memory_bytes``),
        and in the peak the counted peak without the eager path's
        (S, S) squares.  A train step is priced with eager attention,
        which the port's runs."""
        from repro_torch.core import costmodel
        from repro_torch.launch.mesh import axis_sizes
        if wl.shp.kind == "train":
            # the port's train step runs the eager attention whatever the
            # config says (the kernels are forward-only: runtime/stepfn),
            # so no flash correction applies to it
            rt = rt.replace(attn_impl="xla")
        mesh = self._mesh_factory(multi_pod=wl.multi_pod)
        points, units = costmodel.calibration_points(wl.cfg)
        # the calibration counts run eager attention, as the reference's
        # compiles do; one count a point (the class docstring says why)
        rt_count = rt.replace(unroll_layers=True, attn_impl="xla")
        r1, sq1 = self._measured(wl, mesh, points[0][0], 1, rt_count)
        r3, sq3 = self._measured(wl, mesh, points[1][0], 3, rt_count)
        rl = costmodel.extrapolate_roofline(r1, r3, units)
        sizes = axis_sizes(mesh)
        data_size = 1
        for a in ("pod", "data"):
            data_size *= sizes.get(a, 1)
        model_size = sizes.get("model", 1)
        mem_bytes = costmodel.port_memory_bytes(
            wl.cfg, wl.shp, rt, data_size, model_size)
        flops, compute_s = rl.flops_per_chip, rl.compute_s
        peak = rl.peak_mem_bytes
        if rt.attn_impl == "pallas" and wl.shp.kind == "prefill":
            # the kernel path holds what the eager path held but its
            # (S, S) scores, probabilities and mask
            peak = costmodel.extrapolate(sq1, sq3, units)
            # the flash kernel computes the causal half of the S x S
            # products, at its products' rate
            eager, kernel = costmodel.flash_kernel_flops(
                wl.cfg, wl.shp, rt, data_size, model_size)
            bf16 = rt.compute_dtype != "float32"
            rate = costmodel.HW["flops_bf16" if bf16 else "flops_f32"]
            k_rate = costmodel.HW["flops_bf16" if bf16 else "flops_tf32x3"]
            flops = max(0.0, flops - eager) + kernel
            compute_s = max(0.0, compute_s - eager / rate) + kernel / k_rate
        return dataclasses.replace(
            rl, compute_s=compute_s, flops_per_chip=flops,
            memory_s=mem_bytes / costmodel.HW["hbm_bw"],
            bytes_per_chip=mem_bytes, peak_mem_bytes=peak)

    def __call__(self, wl: Workload, rt: TunableConfig) -> TrialResult:
        acct = self._trial_acct()
        acct["compiles"], acct["compile_s"] = 0, 0.0
        acct["cache_reads"] = 0
        try:
            rl = self.calibrated_roofline(wl, rt)
            peak = rl.peak_mem_bytes
            fits = peak is None or peak <= self.hbm_limit
            res = TrialResult(cost_s=rl.total_s, crashed=not fits,
                              roofline=rl.as_dict(), peak_bytes=peak,
                              fits_hbm=fits,
                              failure="" if fits else FAILURE_DETERMINISTIC)
        except Exception as e:
            # TrialError already carries the stored "TypeName: msg"
            err = str(e) if isinstance(e, TrialError) \
                else f"{type(e).__name__}: {e}"
            res = TrialResult(cost_s=float("inf"), crashed=True,
                              error=err[:500],
                              failure=classify_exception(e))
        res.compiles = acct["compiles"]
        res.compile_s = round(acct["compile_s"], 1)
        # "served from cache" requires the trial to have actually reached
        # a cache lookup — a trial that dies before any calibration
        # count (e.g. in the mesh factory) was not cached, it crashed
        res.cached = acct["compiles"] == 0 and acct["cache_reads"] > 0
        return res


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


def card_lock_path(device) -> Optional[pathlib.Path]:
    """The host-local file whose ``flock`` orders the processes that time
    trials on ``device``: one per card, under the system temp directory,
    named by the card's UUID (which ``CUDA_VISIBLE_DEVICES`` does not
    renumber, as it does the index).  None for a device that is not a
    card (or where no card is present): the CPU's trials of two
    processes run at the same time, as the reference's host workers
    do."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    name = re.sub(r"[^A-Za-z0-9_-]", "_", uuid)
    return pathlib.Path(tempfile.gettempdir()) / f"repro_torch-card-{name}.lock"


@contextlib.contextmanager
def hold_card(device):
    """Hold ``device``'s card across processes: an exclusive ``flock`` of
    :func:`card_lock_path`; yields that path, or None (and locks
    nothing) for a device that is not a card.  The OS drops it when its
    holder dies, even by SIGKILL, so a killed process never wedges the
    card."""
    path = card_lock_path(device)
    if path is None:
        yield None
        return
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o666)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield path
    finally:
        os.close(fd)                     # closing drops the lock


class TrialClock:
    """What an executor's deadline counts of one trial.  The executor
    hands each trial it runs a clock (:func:`trial_clock`);
    :func:`hold_device` stops it while the trial waits for its device,
    so the wait is not the trial's time, and a trial the executor has
    abandoned never starts on the device.  With ``telemetry``, each time
    the trial holds a card is a ``card`` span with ``fields``: the time
    it had the card to itself, which two processes' spans never share."""

    def __init__(self, telemetry=None, **fields):
        self._lock = threading.Lock()
        self._waited = 0.0
        self._since: Optional[float] = None
        self.abandoned = False
        self.telemetry = telemetry
        self.fields = fields

    def card_span(self, device):
        """The span of one hold of ``device``'s card (none without
        telemetry)."""
        t = self.telemetry
        if t is None or not t.enabled:
            return contextlib.nullcontext()
        return t.span("card", device=str(device), **self.fields)

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
    outer = getattr(_CLOCK, "clock", None)
    _CLOCK.clock = clock
    try:
        yield clock
    finally:
        _CLOCK.clock = outer


@contextlib.contextmanager
def hold_device(device):
    """Hold ``device``'s lock for one trial: the thread lock of this
    process (:func:`device_lock`), then, on a card, the card's file lock
    across processes (:func:`hold_card`).  The wait for both stops
    the trial's clock; a trial abandoned at its deadline while it waited
    fails as a timeout instead of running.  The time it holds a card is
    its clock's ``card`` span."""
    clock: Optional[TrialClock] = getattr(_CLOCK, "clock", None)
    lock = device_lock(device)
    if clock is not None:
        clock._wait(True)
    lock.acquire()
    try:
        with hold_card(device) as card:
            if clock is not None:
                clock._wait(False)
            if clock is not None and clock.abandoned:
                raise TrialError("trial abandoned at its deadline before "
                                 "it reached the device", FAILURE_TIMEOUT)
            with (clock.card_span(device) if clock is not None and card
                  else contextlib.nullcontext()):
                yield
    finally:
        if clock is not None:
            clock._wait(False)           # a failed wait ends it too
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
